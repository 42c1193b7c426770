// Whitelist sweep: a (reads x barcode slices) grid, four interleaved Myers
// chains a thread, and a second small kernel that merges the slices.
//
// Replaces the Pallas TPU kernel sicelore_tpu/ops/bcsearch.py::_bc_sweep_kernel:
// the Myers semi-global edit distance of each read's BC window (W <= 32
// chars) against every used barcode (m <= 31), reduced as the barcodes are
// visited in ascending index to the best ED, its first argmin, the second-
// best ED (a tie makes it equal to the best) and the best match's end
// position (-1 unless track_pos). Barcodes j >= nvalid count as BIG.
// Output [4, B] int32.
//
// What bounds it on the H100: integer ALU work, B * N * W Myers columns
// (32k reads x 49k barcodes x 22 = 3.5e10), on 132 SMs x 4 schedulers whose
// ALU pipe takes one warp instruction every other cycle (the FMA pipe takes
// IMAD beside it). The list (16 B a barcode) is read once a block and is no
// load. So the design spends as few integer instructions a column as it can
// and keeps every scheduler supplied with independent ones:
//
//  * Grid (ceil(B / 128), S): blockIdx.y takes one slice of L barcodes, so a
//    launch has several waves of blocks whatever B is (the wrapper picks S
//    from B and N). A block writes its partial (b1, i1, b2, p1), with global
//    barcode indices, to scratch [S, 4, B]; bc_merge_kernel folds the slices
//    in ascending order by the rule the TPU kernel uses between its barcode
//    tiles, which keeps the first argmin and the tie rule exact. No atomics.
//    With S = 1 the block writes the result itself.
//  * CH = 4 barcodes a thread at a time, as four independent chains in
//    registers: a warp always has an instruction ready while a chain waits.
//  * The Peq select is one shared-memory load. A group of four barcodes is
//    staged as eight uint4 rows (code 0..3: the four barcodes' masks; 4..7:
//    zero, so N and PAD never match), and one 16-byte load at
//    [group][code] fetches the column's masks of all four chains: the 32
//    threads of a warp read inside one 128-byte line, on the load/store
//    pipe that is otherwise idle, in place of a compare/select chain.
//  * The pattern sits in the TOP m bits of the word (masks are shifted left
//    by 32 - m while they are staged; the low bits keep PV = 1, MV = 0 and
//    pass nothing up), so the score bit is the sign bit: score += Ph >> 31,
//    score += (int)Mh >> 31, no mask, no variable shift.
//  * track_pos is a template parameter. The inner loop tracks no position
//    at all; with track_pos the thread runs one more Myers pass over its
//    slice's winner only (1/L of the work) and takes the first column that
//    reaches the minimum, as `score < best` picked it.
//  * The window width is a template parameter WT in {16, 22, 32}; a window
//    of W columns runs at the next WT, filled up with PAD columns. A PAD
//    column matches nothing, and a column without a match never lowers the
//    bottom-row score below the column before it, so best and its first
//    column are those of the W columns. All loops over columns unroll and
//    the window lives in registers as byte offsets of its codes' rows.
//
// One column of one chain in the inner loop (SASS of the sm_90a build, WT =
// 22, no position: 1,169 instructions a trip of 88 columns, from
// `python -m sicelore_tpu_torch.utils.kernel_report bcsweep`): 13.3
// instructions, of which 6.7 LOP3, 2.1 LEA.HI (the two score updates) and
// 1.1 VIMNMX on the ALU pipe, 2.9 IMAD (the add and the two shifts, which
// the compiler moves to the FMA pipe) and a quarter of a 16-byte LDS, against
// the 18 that the bound counts. The ALU pipe, 16 lanes a scheduler, is what
// holds it: 9.9 of its instructions a column are ~20 cycles a warp, and the
// kernel runs at 22-23.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int MAXW = 32;
constexpr int CH = 4;            // chains (barcodes) a thread at a time
constexpr int NT = 256;          // barcodes per shared-memory tile (8 KB)
constexpr int THREADS = 128;
constexpr int CODE_ZERO = 4;     // row of a group that holds zero masks

// One Myers column, pattern in the top bits: the horizontal carry-in is 0
// (free text start), the score bit is bit 31.
__device__ __forceinline__ void myers_col(unsigned eq, unsigned& PV,
                                          unsigned& MV, int& score) {
  const unsigned Xh = (((eq & PV) + PV) ^ PV) | eq;
  const unsigned Ph = MV | ~(Xh | PV);
  const unsigned Mh = PV & Xh;
  score += (int)(Ph >> 31);
  score += (int)Mh >> 31;
  const unsigned Ph1 = Ph << 1, Mh1 = Mh << 1;
  const unsigned Xv = eq | MV;
  PV = Mh1 | ~(Xv | Ph1);
  MV = Ph1 & Xv;
}

template <int WT, bool TRACK>
__global__ void __launch_bounds__(THREADS)
bc_sweep_kernel(const uint8_t* __restrict__ wins,      // [W, B]
                const unsigned* __restrict__ peq,      // [4, N]
                int* __restrict__ dst,                 // [S, 4, B]
                int B, int W, int N, int nv, int m, int L) {
  __shared__ uint4 tile[NT / CH * 8];
  const int b = blockIdx.x * THREADS + threadIdx.x;
  const bool active = b < B;
  const int sh = 32 - m;
  // the window as byte offsets of its codes' rows inside a group
  int off[WT];
#pragma unroll
  for (int t = 0; t < WT; ++t) {
    int c = CODE_ZERO;
    if (active && t < W) c = min((int)wins[(size_t)t * B + b], CODE_ZERO);
    off[t] = c * (int)sizeof(uint4);
  }
  // rows 4..7 of every group stay zero
  for (int i = threadIdx.x; i < NT / CH * 4; i += THREADS)
    tile[(i >> 2) * 8 + 4 + (i & 3)] = make_uint4(0u, 0u, 0u, 0u);

  const int j_lo = blockIdx.y * L, j_hi = min(j_lo + L, nv);
  int b1 = BIG, i1 = 0, b2 = BIG;
  for (int j0 = j_lo; j0 < j_hi; j0 += NT) {
    const int nt = min(NT, j_hi - j0);
    const int ntp = (nt + CH - 1) / CH * CH;
    __syncthreads();
    unsigned* tw = (unsigned*)tile;
    for (int i = threadIdx.x; i < 4 * ntp; i += THREADS) {
      const int c = i / ntp, jj = i - c * ntp;
      const unsigned v = jj < nt ? peq[(size_t)c * N + j0 + jj] << sh : 0u;
      tw[((jj >> 2) * 8 + c) * 4 + (jj & 3)] = v;
    }
    __syncthreads();
    for (int g = 0; g < ntp / CH; ++g) {
      const char* rows = (const char*)(tile + g * 8);
      unsigned PV[CH], MV[CH];
      int sc[CH], best[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        PV[c] = 0xFFFFFFFFu;
        MV[c] = 0u;
        sc[c] = m;
        best[c] = m;
      }
#pragma unroll
      for (int t = 0; t < WT; ++t) {
        const uint4 e = *(const uint4*)(rows + off[t]);
        myers_col(e.x, PV[0], MV[0], sc[0]);
        myers_col(e.y, PV[1], MV[1], sc[1]);
        myers_col(e.z, PV[2], MV[2], sc[2]);
        myers_col(e.w, PV[3], MV[3], sc[3]);
#pragma unroll
        for (int c = 0; c < CH; ++c) best[c] = min(best[c], sc[c]);
      }
      // fold the four results in ascending barcode index
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int j = j0 + g * CH + c;
        const int ed = j < j_hi ? best[c] : BIG;
        if (ed < b1) {
          b2 = b1;
          b1 = ed;
          i1 = j;
        } else {
          b2 = min(b2, ed);
        }
      }
    }
  }
  if (!active) return;
  int p1 = -1;
  if (TRACK && b1 < BIG) {
    // the winner once more: the first column that reaches its minimum
    unsigned v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = peq[(size_t)c * N + i1] << sh;
    unsigned PV = 0xFFFFFFFFu, MV = 0u;
    int score = m, best = m;
#pragma unroll
    for (int t = 0; t < WT; ++t) {
      const int c = off[t] / (int)sizeof(uint4);
      const unsigned eq =
          c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : c == 3 ? v[3] : 0u;
      myers_col(eq, PV, MV, score);
      if (score < best) {
        best = score;
        p1 = t;
      }
    }
  }
  int* o = dst + (size_t)blockIdx.y * 4 * B;
  o[b] = b1;
  o[(size_t)B + b] = i1;
  o[2 * (size_t)B + b] = b2;
  o[3 * (size_t)B + b] = p1;
}

// Fold the S partials of a read in ascending slice order, by the rule of
// the TPU kernel between its barcode tiles: the earlier slice keeps a tie,
// and the second best is the least of the loser and both second bests.
__global__ void __launch_bounds__(256)
bc_merge_kernel(const int* __restrict__ parts,   // [S, 4, B]
                int* __restrict__ out,           // [4, B]
                int S, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int b1 = parts[b], i1 = parts[(size_t)B + b], b2 = parts[2 * (size_t)B + b],
      p1 = parts[3 * (size_t)B + b];
  for (int s = 1; s < S; ++s) {
    const int* q = parts + (size_t)s * 4 * B;
    const int nb1 = q[b], ni1 = q[(size_t)B + b], nb2 = q[2 * (size_t)B + b],
              np1 = q[3 * (size_t)B + b];
    b2 = min(max(b1, nb1), min(b2, nb2));
    if (nb1 < b1) {
      b1 = nb1;
      i1 = ni1;
      p1 = np1;
    }
  }
  out[b] = b1;
  out[(size_t)B + b] = i1;
  out[2 * (size_t)B + b] = b2;
  out[3 * (size_t)B + b] = p1;
}

template <int WT>
void launch_sweep(bool track, dim3 grid, cudaStream_t st, const uint8_t* wins,
                  const unsigned* peq, int* dst, int B, int W, int N, int nv,
                  int m, int L) {
  if (track)
    bc_sweep_kernel<WT, true><<<grid, THREADS, 0, st>>>(wins, peq, dst, B, W,
                                                        N, nv, m, L);
  else
    bc_sweep_kernel<WT, false><<<grid, THREADS, 0, st>>>(wins, peq, dst, B, W,
                                                         N, nv, m, L);
}

}  // namespace

// Slice s of S covers barcodes [s * L, min((s + 1) * L, min(nvalid, N))).
// scratch is [S, 4, B] int32 and is not touched when S == 1.
extern "C" int bcsweep_launch(const void* wins, const void* peq, void* out,
                              void* scratch, int B, int W, int N, int nvalid,
                              int m, int track_pos, int S, int L,
                              void* stream) {
  if (W < 1 || W > MAXW || m < 1 || m > 31 || N < 1 || S < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int nv = min(max(nvalid, 0), N);
  if ((long long)S * L < nv || S > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* dst = S == 1 ? (int*)out : (int*)scratch;
  const dim3 grid((B + THREADS - 1) / THREADS, S);
  const uint8_t* w = (const uint8_t*)wins;
  const unsigned* p = (const unsigned*)peq;
  if (W <= 16)
    launch_sweep<16>(track_pos != 0, grid, st, w, p, dst, B, W, N, nv, m, L);
  else if (W <= 22)
    launch_sweep<22>(track_pos != 0, grid, st, w, p, dst, B, W, N, nv, m, L);
  else
    launch_sweep<32>(track_pos != 0, grid, st, w, p, dst, B, W, N, nv, m, L);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  bc_merge_kernel<<<(B + 255) / 256, 256, 0, st>>>((const int*)scratch,
                                                   (int*)out, S, B);
  return (int)cudaGetLastError();
}

// The merge kernel alone: parts [S, 4, B] int32 -> out [4, B].
extern "C" int bcsweep_merge_launch(const void* parts, void* out, int S,
                                    int B, void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  bc_merge_kernel<<<(B + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const int*)parts, (int*)out, S, B);
  return (int)cudaGetLastError();
}
