// The UMI distance matrix of one group from the group's raw bytes: the
// global Levenshtein distance of every UMI (a pattern row of 1..32 nt)
// against every UMI (a text of any length), one launch a group.
//
// Replaces the device route of sicelore_tpu/core/umicluster.py::
// _pairwise_ed_device over sicelore_tpu/ops/editdist.py::
// myers_global_pairwise (a jitted lax.scan there, not a Pallas kernel),
// and the host's encoding and Peq build around it: the kernel reads bytes.
//
// Input: raw [S] uint8, the UMIs concatenated, and offs [K + 1] int32,
// their offsets (non-decreasing from 0 to S), both 16-byte aligned. Bytes
// map as utils/dna._ENC: A, C, G, T in either case are bases 0..3, every
// other byte is N, which matches nothing (N included). Output: d [K, K]
// int32, d[i, j] = the global distance of UMI i (pattern) against UMI j
// (text); an empty text gives m_i. A row whose pattern is outside 1..32
// nt is not this kernel's (its caller fills it on the host): it gets 0.
//
// What bounds it on the H100: operations. A pair is a chain of len(j)
// dependent Myers columns; 8,192 UMIs of 12 nt are 8.1e8 columns against
// a 268 MB matrix (0.08 ms of HBM). The design:
//   * The pattern in the word's top bits: bit 31 is its last base, the
//     row-0 carry enters at bit 32 - m. The bits below keep PV = 1, MV = 0
//     and add no carry, so the column needs no mask and no variable shift:
//     7 logic operations on the integer pipe, the add and the two shifts
//     multiply-adds on the FMA pipe. No score is kept a column: a lane
//     reads it once from the last column's vertical steps, len + the
//     pattern bits of PV less those of MV (two popc a pair).
//   * Peq by ballot: lane b of a warp holds byte b of a pattern row, the
//     four base masks are four ballots. A warp's R rows' masks go into a
//     table indexed by byte (256 x R words a warp, built through the
//     kernel's copy of _ENC), so a staged byte selects its R masks with
//     one shared load: no encoding pass over the texts.
//   * R pattern rows a thread: each byte, its two loads and the loop serve
//     R independent chains, so the column's dependent chain is hidden and a
//     text's fixed costs fall by R. R = 4 where the items fill every SM's
//     blocks; a smaller group (the 56-120 UMIs of assignumis' batched
//     groups) is bound by a block's serial latency and takes R = 2: twice
//     the blocks, half the work a thread (kernel_variants.py pairwise).
//   * Persistent blocks (BLOCKS_PER_SM an SM) over (row tile, text tile)
//     items: a block takes a contiguous run of items, rebuilding its table
//     only where the row tile changes. A text tile's offsets and its byte
//     span (contiguous in raw) go to shared memory with cp.async, 16 bytes
//     a copy, double buffered: the next tile's copies fly while the
//     current one is computed. No division anywhere but the item's split.
//   * A lane runs its own text's columns and stops (no snapshot); a warp
//     stores 32 consecutive entries of a row. A tile whose span does not
//     fit the buffer (texts far over 32 nt) reads its bytes from global
//     memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R_WIDE = 4;        // pattern rows a thread: items fill the card
constexpr int R_NARROW = 2;      // ... a group too small to fill it
constexpr int TT = 64;           // texts a tile
constexpr int NW = 8;            // warps a block
constexpr int NT = NW * 32;
constexpr int SPAN = TT * 32 + 32;   // staged bytes: texts of <= 32 nt fit
constexpr int BLOCKS_PER_SM = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;

static_assert(TT % 32 == 0 && SPAN % 16 == 0, "tile shape");

template <int N> struct VecOf;
template <> struct VecOf<1> { using T = unsigned; };
template <> struct VecOf<2> { using T = uint2; };
template <> struct VecOf<4> { using T = uint4; };
template <int R>
union EqRow {            // one byte's masks of a warp's R rows
  typename VecOf<R>::T v;
  unsigned w[R];
};

template <int R>
struct __align__(16) Smem {
  uint8_t raw[2][SPAN];          // a text tile's byte span
  int offs[2][TT + 4];           // its offsets (n + 1 of them)
  typename VecOf<R>::T tab[NW][256];   // [warp][byte]: its rows' masks
};

// (row tile of NW x R rows, text tile) items of a group of K
template <int R>
__host__ __device__ long long items_of(int K) {
  return (long long)((K + NW * R - 1) / (NW * R)) * ((K + TT - 1) / TT);
}

// utils/dna._ENC: A, C, G, T and a, c, g, t -> 0..3, every other byte 4.
// Byte c of BASES is base c in upper case; b & 0xDF clears bit 5 only, so
// it maps exactly the two cases together.
constexpr unsigned BASES = 'A' | 'C' << 8 | 'G' << 16 | 'T' << 24;

__device__ __forceinline__ int code_of(unsigned b) {
  const unsigned u = b & 0xDFu;
  return u == (BASES & 0xFFu)           ? 0
         : u == (BASES >> 8 & 0xFFu)    ? 1
         : u == (BASES >> 16 & 0xFFu)   ? 2
         : u == BASES >> 24             ? 3
                                        : 4;
}

__device__ __forceinline__ int clamp_to(int x, int S) {
  return min(max(x, 0), S);
}

// 16 bytes to shared memory, `bytes` (1..16) of them read, the rest zero
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One global Myers column with the pattern in the top bits; carry = 1 <<
// (32 - m) is the row-0 step. Ph * 2 has bit 32 - m clear (it comes from
// the zero bits below the pattern), so + carry sets it.
__device__ __forceinline__ void column(unsigned eq, unsigned& PV,
                                       unsigned& MV, unsigned carry) {
  const unsigned Xv = eq | MV;
  const unsigned Xh = (((eq & PV) + PV) ^ PV) | eq;
  const unsigned Ph = MV | ~(Xh | PV);
  const unsigned Mh = PV & Xh;
  const unsigned Ph1 = Ph * 2u + carry;
  const unsigned Mh1 = Mh * 2u;
  PV = Mh1 | ~(Xv | Ph1);
  MV = Ph1 & Xv;
}

// The columns of one text, its bytes at src (shared or global memory)
template <int R, bool GLOBAL>
__device__ __forceinline__ void text_columns(
    const uint8_t* src, int tl, const typename VecOf<R>::T* tab,
    unsigned (&PV)[R], unsigned (&MV)[R], const unsigned (&carry)[R]) {
#pragma unroll 4
  for (int t = 0; t < tl; ++t) {
    const unsigned b = GLOBAL ? __ldg(src + t) : src[t];
    EqRow<R> e;
    e.v = tab[b];
#pragma unroll
    for (int r = 0; r < R; ++r) column(e.w[r], PV[r], MV[r], carry[r]);
  }
}

template <int R>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
pairwise_kernel(const uint8_t* __restrict__ raw,
                const int* __restrict__ offs, int* __restrict__ out, int K,
                int S) {
  constexpr int RT = NW * R;       // pattern rows an item
  __shared__ Smem<R> sm;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  // a run of items a block, the first `extra` blocks one more (the
  // launcher keeps the item count under 2^31)
  const int ntt = (K + TT - 1) / TT;
  const int items = (int)items_of<R>(K);
  const int G = gridDim.x, blk = blockIdx.x, per = items / G;
  const int extra = items - per * G;
  const int k0 = blk * per + min(blk, extra);
  const int k1 = k0 + per + (blk < extra);
  if (k0 >= k1) return;

  // a text tile's offsets and byte span [sb, se) into buffer `buf`
  auto stage = [&](int tt, int sb, int se, int buf) {
    const int j0 = tt * TT, n = min(TT, K - j0);
    const int avail = (K + 1 - j0) * 4;          // bytes of offs from j0
    for (int c = tid; c < (n + 4) / 4; c += NT)
      cp_async16(&sm.offs[buf][4 * c], offs + j0 + 4 * c,
                 min(16, avail - 16 * c));
    const int a0 = sb & ~15;
    if (se - a0 <= SPAN)
      for (int c = a0 + 16 * tid; c < se; c += 16 * NT)
        cp_async16(&sm.raw[buf][c - a0], raw + c, min(16, S - c));
    cp_async_commit();
  };
  auto next_tt = [&](int t) { return t + 1 < ntt ? t + 1 : 0; };

  // this warp's R rows of row tile rt: their starts and lengths (loaded
  // before the first copies are issued: each copy's asm orders memory)
  int rb[R], rm[R], m[R];
  unsigned carry[R];
  auto load_rows = [&](int rt) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = rt * RT + w * R + r;
      rb[r] = i < K ? clamp_to(offs[i], S) : 0;
      rm[r] = i < K ? max(clamp_to(offs[i + 1], S) - rb[r], 0) : 0;
    }
  };
  // their masks by ballot, then the byte table: zeros, and lane l < 8
  // writes the masks of base l & 3 at its upper (l < 4) or lower case byte
  auto build_table = [&]() {
    unsigned eq[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = (rm[r] >= 1 && rm[r] <= 32) ? rm[r] : 0;
      carry[r] = m[r] ? 1u << (32 - m[r]) : 0u;
      const int c = lane < m[r] ? code_of(__ldg(raw + rb[r] + lane)) : 4;
#pragma unroll
      for (int q = 0; q < 4; ++q)     // m[r] is the warp's: all or none
        eq[r][q] = m[r] ? __ballot_sync(FULL, c == q) << (32 - m[r]) : 0u;
    }
    EqRow<R> e;
#pragma unroll
    for (int r = 0; r < R; ++r) e.w[r] = 0u;
    __syncwarp();                     // the old table is read by every lane
    for (int v = lane; v < 256; v += 32) sm.tab[w][v] = e.v;
    __syncwarp();
    if (lane < 8) {
      const int c = lane & 3;
#pragma unroll
      for (int r = 0; r < R; ++r)
        e.w[r] = c == 0 ? eq[r][0] : c == 1 ? eq[r][1]
               : c == 2 ? eq[r][2] : eq[r][3];
      sm.tab[w][(BASES >> 8 * c & 0xFFu) | (lane & 4) << 3] = e.v;
    }
    __syncwarp();
  };

  int rt = k0 / ntt, tt = k0 - rt * ntt;
  load_rows(rt);
  int sb = clamp_to(offs[tt * TT], S);
  int se = clamp_to(offs[min((tt + 1) * TT, K)], S);
  stage(tt, sb, se, 0);
  int nsb = 0, nse = 0;             // the next item's span, loaded ahead
  if (k0 + 1 < k1) {
    const int t1 = next_tt(tt);
    nsb = offs[t1 * TT];
    nse = offs[min((t1 + 1) * TT, K)];
  }
  int cur_rt = -1, buf = 0;
  for (int k = k0; k < k1; ++k) {
    if (rt != cur_rt) {
      if (cur_rt >= 0) load_rows(rt);
      build_table();
      cur_rt = rt;
    }
    cp_async_wait_all();
    __syncthreads();   // this tile's copies landed; the last tile is done
    const int csb = sb, cse = se, tn = next_tt(tt);
    if (k + 1 < k1) {
      sb = clamp_to(nsb, S);
      se = clamp_to(nse, S);
      stage(tn, sb, se, buf ^ 1);
      if (k + 2 < k1) {
        const int t2 = next_tt(tn);
        nsb = offs[t2 * TT];
        nse = offs[min((t2 + 1) * TT, K)];
      }
    }
    const int j0 = tt * TT, n = min(TT, K - j0);
    const int a0 = csb & ~15;
    const bool staged = cse - a0 <= SPAN;
    const int i0 = rt * RT + w * R;
    for (int g = 0; g < n && i0 < K; g += 32) {
      const int x = g + lane;
      int b = 0, tl = 0;
      if (x < n) {     // inside the tile's span whatever offs holds
        b = min(max(sm.offs[buf][x], csb), cse);
        tl = max(min(sm.offs[buf][x + 1], cse) - b, 0);
      }
      unsigned PV[R], MV[R];
#pragma unroll
      for (int r = 0; r < R; ++r) PV[r] = FULL, MV[r] = 0u;
      if (staged)
        text_columns<R, false>(&sm.raw[buf][b - a0], tl, sm.tab[w], PV, MV,
                               carry);
      else
        text_columns<R, true>(raw + b, tl, sm.tab[w], PV, MV, carry);
      // D[m][tl] = D[0][tl] + the vertical steps of the last column: the
      // pattern's bits of PV (+1 each) and of MV (-1 each; MV is 0 below)
      if (x < n) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (i0 + r < K)
            __stcs(out + (size_t)(i0 + r) * K + j0 + x,
                   m[r] ? tl + __popc(PV[r] & (0u - carry[r])) -
                              __popc(MV[r])
                        : 0);
      }
    }
    buf ^= 1;
    rt += tn == 0;
    tt = tn;
  }
}

}  // namespace

extern "C" int pairwise_launch(const void* raw, const void* offs, void* out,
                               int K, int S, void* stream) {
  if (K <= 0) return 0;
  if (((uintptr_t)raw & 15u) || ((uintptr_t)offs & 15u) || S < 0)
    return (int)cudaErrorInvalidValue;
  // the SM count of the current device (the wrapper makes the tensors'
  // device current), queried once a device
  static int sms_of[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // R_WIDE rows a thread where its items fill every SM's blocks, else
  // R_NARROW: twice the items, half the serial work a thread
  const long long cap = (long long)BLOCKS_PER_SM * sms_of[dev];
  const bool wide = items_of<R_WIDE>(K) >= cap;
  const long long items = wide ? items_of<R_WIDE>(K) : items_of<R_NARROW>(K);
  if (items > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < cap ? items : cap);
  if (wide)
    pairwise_kernel<R_WIDE><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)offs, (int*)out, K, S);
  else
    pairwise_kernel<R_NARROW><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)raw, (const int*)offs, (int*)out, K, S);
  return (int)cudaGetLastError();
}
