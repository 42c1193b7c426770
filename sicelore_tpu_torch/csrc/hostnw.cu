// The host consensus engine's banded Needleman-Wunsch, one block a (center,
// read) pair: every pair of the molecules that the batched engine leaves to
// the host engine, aligned in one launch, each walked back into exactly the
// moves that sicelore_tpu_torch/ops/poa.py::nw_align_banded takes.
//
// Replaces no Pallas kernel. It is the device counterpart of
// sicelore_tpu/ops/poa.py::nw_align_banded, which the JAX package runs on the
// host (one NumPy row update a center base over a full (la+1) x (lb+1)
// matrix, then a Python walk-back) for the molecules of three or more reads
// that its batched engine does not take: a non-ACGT byte, a center over the
// largest bucket, no pair left in a bucket, an assembly longer than the
// device's output row. The center-star merge and the majority stay on the
// host (ops/hostnw_cuda.py) and read this kernel's moves.
//
// Contract (pairs[p] = a_off, la, b_off, lb, slab_off, mv_off, int64): a =
// seq[a_off, a_off + la), b = seq[b_off, b_off + lb), raw bytes (N matches N,
// lower case is its own byte); MATCH +5, MISMATCH -4, GAP -8; band =
// max(32, |la - lb| + max(la, lb) / 10); row i's window is [j0, j1] =
// [max(1, c - band), min(lb, c + band)] with c = round(i * (lb / la)) in
// double, half to even (rint); row 0 holds j GAP for j <= min(lb, band),
// column 0 holds i GAP, every other cell starts at NEG; inside a row the left
// moves close as the host's prefix maximum of best - j GAP. The walk starts
// at (la, lb) and takes the first move that holds (diagonal, up, left), else
// the host's out-of-band fallback. Out: moves[mv_off + t], t < n_moves[p],
// the walk's moves from the end (0 diagonal, 1 up: a center base against a
// gap, 2 left: a read base inserted); la == 0 gives lb left moves and lb == 0
// la up moves, the host's early returns. Every value the host holds lies
// within 1.1e9 of 0, so int32 is exact.
//
// What bounds it on the H100: not the card's throughput. A pair is ~650 rows
// of 200-300 band cells (2.1-2.3 kb centers: ~2,300 rows of ~600), and each
// row needs the one before it, so a pair is one chain of la dependent rows,
// and a launch holds only the ~170-250 pairs a Step 4b call sends here:
// their 2-3e7 band cells are under a hundredth of a millisecond of the
// card's integer rate. The time is the longest pair's chain. The design
// keeps that chain short:
//
//  * One block of 256 threads a pair, the row window over the threads in
//    contiguous runs of ceil(w / 256) cells. The previous row and the new
//    one sit in shared memory (two buffers of the pair's stride), so a row
//    costs two barriers: the left-move closure is a max-plus prefix scan, a
//    thread's run in registers, then a warp scan in shuffles and the warps'
//    totals through shared memory. A pair whose two rows do not fit the
//    block's shared memory (a stride over smem_rows / 2: reads of some 29 kb
//    and more, with a band as wide) reads its previous row from the slab,
//    where it writes each row anyway, and walks back on the slab directly.
//  * Each row's window goes to a per-pair int32 slab at a stride of
//    min(2 band + 1, lb): the walk reads back exactly the scores the host
//    compares, so the move priority and the fallback need no second rule
//    (a per-cell direction code could not answer the fallback's reads of
//    cells outside the band).
//  * The walk runs on one thread, but on shared memory: the block copies a
//    stripe of up to 256 rows of the slab back (coalesced, the cells past a
//    row's window filled with NEG), the thread walks until it needs a row
//    above the stripe, and the block copies the next one. A step is a few
//    shared-memory loads, so the walk's chain never waits on device memory.
//  * The pairs of a launch run side by side (one block each, ~6 blocks an
//    SM), so a call's time is its longest pair's, a few milliseconds at
//    most.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int MATCH = 5, MISMATCH = -4, GAP = -8;
constexpr int NEG = -1000000000;         // the host engine's NEG
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STRIPE = 256;          // rows of one walk stripe
constexpr int8_t DIAG = 0, UP = 1, LEFT = 2;
constexpr unsigned FULL = 0xffffffffu;

// the center of row i's window: Python's round(i * ratio), half to even
__device__ __forceinline__ int row_center(int i, double ratio) {
  return (int)rint((double)i * ratio);
}

// H[pi][j] as the host's matrix holds it, the row pi's window in pb
__device__ __forceinline__ int prev_value(int pi, int j, const int* pb,
                                          int pj0, int pw, int row0_max) {
  if (j == 0) return pi * GAP;
  if (pi == 0) return j <= row0_max ? j * GAP : NEG;
  const int k = j - pj0;
  return (k >= 0 && k < pw) ? pb[k] : NEG;
}

struct Stripe {
  const int* rows;    // rows lo.. of the slab, `stride` ints each
  const int* j0;      // first column of each
  int lo, stride, row0_max;

  // H[r][c] for a row of the stripe (or row 0)
  __device__ __forceinline__ int at(int r, int c) const {
    if (c == 0) return r * GAP;
    if (r == 0) return c <= row0_max ? c * GAP : NEG;
    const int k = c - j0[r - lo];
    return (k >= 0 && k < stride) ? rows[(r - lo) * stride + k] : NEG;
  }
};

// the whole slab of a pair too wide for shared memory: each row's window
// from its center, the cells outside it NEG
struct Slab {
  const int* H;
  int stride, row0_max, band, lb;
  double ratio;

  __device__ __forceinline__ int at(int r, int c) const {
    if (c == 0) return r * GAP;
    if (r == 0) return c <= row0_max ? c * GAP : NEG;
    const int m = row_center(r, ratio);
    const int j0 = max(1, m - band);
    return (c >= j0 && c <= min(lb, m + band))
               ? H[(int64_t)(r - 1) * stride + (c - j0)]
               : NEG;
  }
};

// walks back from (i, j) until the path needs a row above `lo` (row 0 and
// column 0 are always at hand) or reaches (0, 0); returns the moves so far
template <class Rows>
__device__ int walk(const Rows& S, const uint8_t* a, const uint8_t* b,
                    int lo, int& i, int& j, int n, int8_t* mv) {
  while (i > 0 || j > 0) {
    if (i >= 2 && i - 1 < lo) break;  // row i-1 lies above the rows at hand
    const int v = S.at(i, j);
    int8_t m;
    if (i > 0 && j > 0 &&
        v == S.at(i - 1, j - 1) + (a[i - 1] == b[j - 1] ? MATCH : MISMATCH))
      m = DIAG;
    else if (i > 0 && v == S.at(i - 1, j) + GAP)
      m = UP;
    else if (j > 0 && v == S.at(i, j - 1) + GAP)
      m = LEFT;
    else  // the host's out-of-band fallback
      m = (i > 0 && j > 0) ? DIAG : (i > 0 ? UP : LEFT);
    mv[n++] = m;
    if (m != LEFT) --i;
    if (m != UP) --j;
  }
  return n;
}

__global__ void __launch_bounds__(THREADS)
hostnw_kernel(const uint8_t* __restrict__ seq,
              const int64_t* __restrict__ pairs, int* __restrict__ slab,
              int8_t* __restrict__ moves, int* __restrict__ n_moves,
              int smem_rows) {
  extern __shared__ int smem[];
  __shared__ int wt[WARPS];
  __shared__ int s_i, s_j, s_n;
  const int64_t* pr = pairs + 6 * (int64_t)blockIdx.x;
  const uint8_t* a = seq + pr[0];
  const int la = (int)pr[1];
  const uint8_t* b = seq + pr[2];
  const int lb = (int)pr[3];
  int* H = slab + pr[4];
  int8_t* mv = moves + pr[5];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (la == 0 || lb == 0) {
    const int n = la == 0 ? lb : la;
    const int8_t m = la == 0 ? LEFT : UP;
    for (int k = tid; k < n; k += THREADS) mv[k] = m;
    if (tid == 0) n_moves[blockIdx.x] = n;
    return;
  }
  const int band = max(32, abs(la - lb) + max(la, lb) / 10);
  const int stride = min(2 * band + 1, lb);
  const int row0_max = min(lb, band);
  const double ratio = (double)lb / (double)la;
  // two rows over the block's shared memory: the rows live in the slab
  const bool wide = 2 * stride > smem_rows;

  // ---- forward: row i from row i-1, both in shared memory (or the slab) --
  int pj0 = 1, pw = 0;
  for (int i = 1; i <= la; ++i) {
    const int c = row_center(i, ratio);
    const int j0 = max(1, c - band), j1 = min(lb, c + band);
    const int w = j1 - j0 + 1;           // the host skips a row with w <= 0
    int* Hrow = H + (int64_t)(i - 1) * stride;
    int* nb = wide ? Hrow : smem + (i & 1) * stride;
    const int* pb = !wide ? smem + ((i - 1) & 1) * stride
                    : i >= 2 ? Hrow - stride : H;  // row 0: not read
    if (w > 0) {
      const int per = (w + THREADS - 1) / THREADS;
      const int k0 = min(w, tid * per), k1 = min(w, k0 + per);
      const uint8_t ai = a[i - 1];
      int run = INT_MIN;
      int dsrc = prev_value(i - 1, j0 + k0 - 1, pb, pj0, pw, row0_max);
      for (int k = k0; k < k1; ++k) {
        const int j = j0 + k;
        const int usrc = prev_value(i - 1, j, pb, pj0, pw, row0_max);
        int best = max(dsrc + (b[j - 1] == ai ? MATCH : MISMATCH),
                       usrc + GAP);
        if (j == 1) best = max(best, i * GAP + GAP);
        dsrc = usrc;
        nb[k] = best;
        run = max(run, best - j * GAP);
      }
      // prefix maximum of the tilted scores over the row: the thread's
      // run, a warp scan, then the totals of the warps before this one
      int incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl = max(incl, o);
      }
      if (lane == 31) wt[warp] = incl;
      int r = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) r = INT_MIN;
      __syncthreads();
      for (int x = 0; x < warp; ++x) r = max(r, wt[x]);
      for (int k = k0; k < k1; ++k) {
        const int j = j0 + k;
        const int best = nb[k];
        r = max(r, best - j * GAP);
        const int h = max(best, r + j * GAP);
        if (!wide) nb[k] = h;
        Hrow[k] = h;
      }
    }
    pj0 = j0;
    pw = w;
    __syncthreads();
  }

  // ---- walk-back, in stripes of rows copied back from the slab (a wide
  // pair: on the slab itself) ----
  if (wide) {
    if (tid == 0) {
      const Slab S{H, stride, row0_max, band, lb, ratio};
      int i = la, j = lb;
      n_moves[blockIdx.x] = walk(S, a, b, 1, i, j, 0, mv);
    }
    return;
  }
  const int R = min(MAX_STRIPE, smem_rows / stride);
  int* rows = smem;
  int* sj0 = smem + smem_rows;
  if (tid == 0) {
    s_i = la;
    s_j = lb;
    s_n = 0;
  }
  __syncthreads();
  while (s_i > 0 || s_j > 0) {
    const int hi = s_i, lo = max(1, hi - R + 1);
    for (int r = lo + tid; r <= hi; r += THREADS)
      sj0[r - lo] = max(1, row_center(r, ratio) - band);
    for (int r = lo + warp; r <= hi; r += WARPS) {
      const int c = row_center(r, ratio);
      const int w = min(lb, c + band) - max(1, c - band) + 1;
      const int* src = H + (int64_t)(r - 1) * stride;
      int* dst = rows + (r - lo) * stride;
      for (int k = lane; k < stride; k += 32) dst[k] = k < w ? src[k] : NEG;
    }
    __syncthreads();
    if (tid == 0) {
      const Stripe S{rows, sj0, lo, stride, row0_max};
      int i = s_i, j = s_j;
      s_n = walk(S, a, b, lo, i, j, s_n, mv);
      s_i = i;
      s_j = j;
    }
    __syncthreads();
  }
  if (tid == 0) n_moves[blockIdx.x] = s_n;
}

}  // namespace

// seq uint8 [S], pairs int64 [P, 6], slab int32 (the sum of la x stride),
// moves int8 (the sum of la + lb), n_moves int32 [P]; smem_rows: ints of
// shared memory a block keeps for its rows (a pair of a stride over half of
// it keeps its rows in the slab).
extern "C" int hostnw_launch(const void* seq, const void* pairs, void* slab,
                             void* moves, void* n_moves, int P,
                             int smem_rows, void* stream) {
  if (P <= 0) return 0;
  if (smem_rows < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(smem_rows + MAX_STRIPE) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      hostnw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  hostnw_kernel<<<P, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)seq, (const int64_t*)pairs, (int*)slab,
      (int8_t*)moves, (int*)n_moves, smem_rows);
  return (int)cudaGetLastError();
}
