// Banded Needleman-Wunsch + greedy traceback, one warp per (center, read) pair.
//
// Replaces the Pallas TPU kernel sicelore_tpu/ops/poa_tpu.py::_band_align_kernel
// together with the record decoding `extract_alignments` that followed it:
// per pair, the global alignment of the read against its molecule's center
// (match +5 / mismatch -4 / gap -8) inside a diagonal band of W = 32 or 64
// cells (cell b of column j is read position i = j + b - W/2), then one
// canonical optimal path walked back greedily (diag > vert > horiz). Outputs
// per pair: aligned [Lc+1] int8 (0..3 the read base on a diagonal move into
// column j at slot j-1, 4 deletion, 5 none), ins [Lc+1][K_INS][4] int8 (row
// j = insertions before center position j, offset counted from the run's
// end, a run longer than K_INS piling its excess into the last offset) and
// feasible (the end cell lies in the band and was reached on a valid path).
//
// What bounds it on the H100: integer ALU work, about 32 int32 operations a
// band cell over pairs x clen x W cells, issued as dependent shuffles (the
// bytes, 18 a center column, are an order of magnitude below that). The
// design is the simple one: lane = band cell (two cells a lane for W = 64),
// the column recurrence f[b] = max(f[b] + sub, f[b+1] + GAP) with one
// shuffle, the within-column gap closure as a log2(32)-step prefix maximum,
// all in int32 with the clamp at NEG so that the traceback's score
// equalities hold in the same cells as in the plain version. Instead of the
// score matrix, each column keeps two W-bit masks in shared memory (cells
// where the diagonal move holds, cells where the vertical move holds): the
// walk needs nothing else. The stop cell of a column is the highest set bit
// at or below the walk's cell (one clz); the cells in between are the
// horizontal run. The center and the read are staged in shared memory once;
// the center's buffer becomes the aligned row once the forward pass is done.
#include <stdint.h>

namespace {

constexpr int MATCH = 5, MISMATCH = -4, GAP = -8;
constexpr int NEG = -10000000;
constexpr int K_INS = 4;
constexpr int WARPS = 4;                 // pairs per block
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t MAX_SMEM = 232448;      // dynamic shared memory a block may ask

template <int CPL> struct BandMask;
template <> struct BandMask<1> { typedef uint32_t T; };
template <> struct BandMask<2> { typedef uint64_t T; };

__device__ __forceinline__ int top_bit(uint32_t x) { return 31 - __clz((int)x); }
__device__ __forceinline__ int top_bit(uint64_t x) {
  return 63 - __clzll((long long)x);
}

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// shared memory of one pair: two masks a column, the center / aligned row,
// the read
template <int CPL>
__host__ __device__ constexpr size_t warp_smem(int Lc) {
  return 2 * (size_t)Lc * sizeof(typename BandMask<CPL>::T) +
         round16((size_t)Lc + 1) + round16((size_t)Lc + 32 * CPL);
}

// The horizontal run of column j over band cells (bstop, be]: the read chars
// it consumed vote by offset from the run's end. One 16-byte row.
__device__ __forceinline__ int4 run_votes(const int8_t* rs, int rlen, int j,
                                          int bstop, int be, int W2) {
  unsigned w0 = 0, w1 = 0, w2 = 0, w3 = 0;
  for (int x = be; x > bstop; --x) {
    const int i = j + x - W2;
    const int ch = (i >= 1 && i <= rlen) ? min((int)rs[i - 1], 3) : 3;
    const unsigned one = 1u << (8 * ch);
    const int o = be - x;
    if (o == 0) w0 += one;
    else if (o == 1) w1 += one;
    else if (o == 2) w2 += one;
    else w3 += one;
  }
  return make_int4((int)w0, (int)w1, (int)w2, (int)w3);
}

template <int CPL>
__global__ void __launch_bounds__(WARPS * 32)
band_align_kernel(const int8_t* __restrict__ reads,    // [P, Lc + W]
                  const int* __restrict__ rlens,       // [P]
                  const int* __restrict__ mids,        // [P]
                  const int8_t* __restrict__ centers,  // [M, Lc]
                  const int* __restrict__ clens,       // [M]
                  int8_t* __restrict__ aligned,        // [P, Lc + 1]
                  int8_t* __restrict__ ins,            // [P, Lc + 1, K_INS, 4]
                  int* __restrict__ feasible,          // [P]
                  int P, int M, int Lc) {
  constexpr int W = 32 * CPL, W2 = W / 2;
  typedef typename BandMask<CPL>::T mask_t;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * WARPS + warp;
  if (p >= P) return;                    // the whole warp leaves together
  const int Lr = Lc + W;
  unsigned char* base = smem + (size_t)warp * warp_smem<CPL>(Lc);
  mask_t* dmask = (mask_t*)base;
  mask_t* vmask = dmask + Lc;
  int8_t* cs = (int8_t*)(vmask + Lc);    // center; later the aligned row
  int8_t* rs = cs + round16((size_t)Lc + 1);

  const int mid = mids[p];
  const bool mid_ok = mid >= 0 && mid < M;
  const int clen = mid_ok ? min(max(clens[mid], 0), Lc) : 0;
  const int rlen = min(max(rlens[p], 0), Lr);
  if (mid_ok) {
    const int4* src = (const int4*)(centers + (size_t)mid * Lc);
    for (int k = lane; k < Lc / 16; k += 32) ((int4*)cs)[k] = src[k];
  }
  {
    const int4* src = (const int4*)(reads + (size_t)p * Lr);
    for (int k = lane; k < Lr / 16; k += 32) ((int4*)rs)[k] = src[k];
  }
  __syncwarp();

  // ---- forward: lane holds cells b = lane + 32 c ----
  int f[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int i0 = lane + 32 * c - W2;
    f[c] = (i0 >= 0 && i0 <= rlen) ? i0 * GAP : NEG;
  }
  for (int j = 1; j <= clen; ++j) {
    const int cb = cs[j - 1];
    int up[CPL], s[CPL], fn[CPL], t[CPL];
    bool valid[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) up[c] = __shfl_down_sync(FULL, f[c], 1);
    if (CPL == 2) {
      const int hi0 = __shfl_sync(FULL, f[CPL - 1], 0);
      if (lane == 31) up[0] = hi0;
    }
    if (lane == 31) up[CPL - 1] = NEG;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int b = lane + 32 * c;
      const int i = j + b - W2;
      valid[c] = i >= 1 && i <= rlen;
      const int rb = valid[c] ? (int)rs[i - 1] : 0;
      s[c] = valid[c] ? ((cb == rb && cb < 4) ? MATCH : MISMATCH) : NEG;
      fn[c] = max(f[c] + s[c], up[c] + GAP);
      t[c] = fn[c] - b * GAP;
    }
    // closure f[b] = max_k<=b f[k] + (b - k) GAP: prefix maximum of t
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int v = __shfl_up_sync(FULL, t[c], d);
        if (lane >= d) t[c] = max(t[c], v);
      }
    }
    if (CPL == 2) {
      const int lo_all = __shfl_sync(FULL, t[0], 31);
      t[CPL - 1] = max(t[CPL - 1], lo_all);
    }
    unsigned dbits[CPL], vbits[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int b = lane + 32 * c;
      fn[c] = max(max(fn[c], t[c] + b * GAP), NEG);
      const bool dg = valid[c] && fn[c] == f[c] + s[c];
      const bool vt = !dg && b + 1 < W && fn[c] == up[c] + GAP;
      dbits[c] = __ballot_sync(FULL, dg);
      vbits[c] = __ballot_sync(FULL, vt);
      f[c] = fn[c];
    }
    if (lane == 0) {
      mask_t dm = dbits[0], vm = vbits[0];
      if (CPL == 2) {
        dm |= (mask_t)dbits[CPL - 1] << (8 * sizeof(mask_t) - 32);
        vm |= (mask_t)vbits[CPL - 1] << (8 * sizeof(mask_t) - 32);
      }
      dmask[j - 1] = dm;
      vmask[j - 1] = vm;
    }
  }

  // ---- feasibility: the end cell (clen, bt) ----
  const int bt = rlen - clen + W2;
  const int btc = min(max(bt, 0), W - 1);
  int total = __shfl_sync(FULL, f[0], btc & 31);
  if (CPL == 2) {
    const int t1 = __shfl_sync(FULL, f[CPL - 1], btc & 31);
    if (btc >= 32) total = t1;
  }
  const bool feas = mid_ok && bt >= 0 && bt < W && total > NEG / 2;

  // ---- outputs: defaults by the whole warp, the walk by one lane ----
  __syncwarp();
  int4* ins4 = (int4*)(ins + (size_t)p * (Lc + 1) * (K_INS * 4));
  for (int k = lane; k <= Lc; k += 32) {
    cs[k] = 5;
    ins4[k] = make_int4(0, 0, 0, 0);
  }
  __syncwarp();
  if (lane == 0) {
    feasible[p] = feas ? 1 : 0;
    if (feas) {
      int b = btc;
      bool frozen = false;
      for (int j = clen; j >= 1; --j) {
        const mask_t dm = dmask[j - 1], vm = vmask[j - 1];
        const mask_t below =
            b == W - 1 ? ~(mask_t)0 : (((mask_t)1 << (b + 1)) - 1);
        // the larger band cell wins; cell 0 stops the run whatever it holds
        const int bstop = top_bit((mask_t)((dm | vm | (mask_t)1) & below));
        const bool sd = (dm >> bstop) & 1, sv = (vm >> bstop) & 1;
        if (b > bstop) ins4[j] = run_votes(rs, rlen, j, bstop, b, W2);
        if (sd) {
          cs[j - 1] = (int8_t)min((int)rs[j + bstop - W2 - 1], 3);
        } else if (sv) {
          cs[j - 1] = 4;
        } else {                         // no move holds: the pair freezes
          frozen = true;
          break;
        }
        b = bstop + (sv ? 1 : 0);
      }
      // j = 0: the read prefix before the center's first base
      if (!frozen && b > W2) ins4[0] = run_votes(rs, rlen, 0, W2, b, W2);
    }
  }
  __syncwarp();
  int8_t* arow = aligned + (size_t)p * (Lc + 1);
  for (int k = lane; k <= Lc; k += 32) arow[k] = cs[k];
}

template <int CPL>
int launch(const void* reads, const void* rlens, const void* mids,
           const void* centers, const void* clens, void* aligned, void* ins,
           void* feasible, int P, int M, int Lc, cudaStream_t stream) {
  const size_t smem = WARPS * warp_smem<CPL>(Lc);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // above 48 KB a block's dynamic shared memory must be allowed first
  cudaError_t e = cudaFuncSetAttribute(
      band_align_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  band_align_kernel<CPL><<<(P + WARPS - 1) / WARPS, WARPS * 32, smem, stream>>>(
      (const int8_t*)reads, (const int*)rlens, (const int*)mids,
      (const int8_t*)centers, (const int*)clens, (int8_t*)aligned,
      (int8_t*)ins, (int*)feasible, P, M, Lc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bandalign_launch(const void* reads, const void* rlens,
                                const void* mids, const void* centers,
                                const void* clens, void* aligned, void* ins,
                                void* feasible, int P, int M, int Lc, int W,
                                void* stream) {
  if (Lc < 16 || Lc % 16 || (W != 32 && W != 64) || M < 1)
    return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  if (W == 32)
    return launch<1>(reads, rlens, mids, centers, clens, aligned, ins,
                     feasible, P, M, Lc, (cudaStream_t)stream);
  return launch<2>(reads, rlens, mids, centers, clens, aligned, ins, feasible,
                   P, M, Lc, (cudaStream_t)stream);
}
