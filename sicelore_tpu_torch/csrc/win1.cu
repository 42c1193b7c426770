// Single-pattern window search, one thread per window.
//
// Replaces the Pallas TPU kernel sicelore_tpu/ops/editdist.py::_win1_kernel:
// the Myers semi-global search of ONE pattern (m <= 32) over every row of a
// row-major [B, W] int8 code matrix (A,C,G,T,N,PAD = 0..5; N and PAD match
// nothing). A row reports its best edit distance and the 0-based column where
// that match ends: the first such column on ties, -1 (with ed = m) when no
// column improved on m. Output [2, B] int32: row 0 ed, row 1 end column.
//
// What bounds it on the H100: operations. A window is a chain of W dependent
// column updates; at the scans' shapes (65,536 x 110 is 7.2 MB) the card
// could read the bytes in 2 us and issue the 18-operation column steps in
// 4 us, and one wave of blocks holds the whole launch, so the time is the
// staging of the blocks' rows plus the chains' issue and latency. The design:
//   * Staging in one round: a block's ROWS windows are one contiguous span of
//     ROWS x W bytes. Every thread issues all of its 16-byte loads of the span
//     (ld.global.nc, at most NV a thread) into registers before the first
//     shared store, so one memory latency is paid a block, not one a staged
//     column. The span's start (b0 x W, and the tensor's own offset) need not
//     be 16-byte aligned: the up to 15 bytes before the first aligned
//     address and the tail are byte loads, and the span lands in shared
//     memory at the same offset modulo 16, so the aligned body stores whole.
//     W <= WMAX (every caller's default configuration) takes this path; a
//     wider W is staged in rounds of WMAX columns with byte loads.
//   * Each thread then reads its own row four codes a word (an aligned
//     shared word and a funnel shift, since a row starts at any byte) and
//     takes the match masks of two codes with one 8-byte load from a
//     64-entry pair table in shared memory.
//   * Fewer instructions a column: the pattern at the top of the word (the
//     score's step is a sign bit, no mask), and the best (score, first
//     column) as the minimum of one integer key, four columns at a time.
//     The chain's state stays in registers.
#include <stdint.h>

#include "myers.cuh"

namespace {

constexpr int ROWS = 128;               // threads a block, a window each
constexpr int WMAX = 160;               // widest window staged in one round
constexpr int CAP = ROWS * WMAX;        // staged bytes a round
constexpr int NV = (CAP / 16 + ROWS - 1) / ROWS;   // 16-byte loads a thread

constexpr unsigned KEY = 1u << 26;      // best = score x KEY + column

// The chain of one window. The pattern sits in the top m bits of the words:
// the low bits hold PV = 1, MV = 0, which no column changes (their match
// bits are 0, so they carry nothing into the pattern), and the score's step
// is the sign bit of Ph and Mh. `best` keys the least score and, on ties,
// the first column: the minimum of score x KEY + column; m x KEY (column 0
// at score m, which no column can undercut without improving) means none.
struct Chain {
  unsigned PV, MV;
  int score;
  unsigned best;
};

__device__ __forceinline__ unsigned col_step(unsigned eq, Chain& s) {
  sic::myers_step(eq, s.PV, s.MV, s.score, 31);
  return (unsigned)s.score * KEY;
}

// Columns [0, nc) of one staged row (its first code at byte `rb` of the
// staging buffer), column c0 + c of the window. `pair[a | b << 3]` holds the
// match masks of the codes a, b. The word after the row's last may be read
// (the buffer has 32 bytes of slack); its codes are not.
__device__ __forceinline__ void run_row(const uint8_t* sm, int rb, int nc,
                                        int c0, const uint2* pair,
                                        Chain& s) {
  const unsigned* w = reinterpret_cast<const unsigned*>(sm) + (rb >> 2);
  const unsigned sh = 8u * (rb & 3);
  unsigned lo = w[0];
  int c = 0;
  for (; c + 4 <= nc; c += 4) {
    const unsigned hi = w[(c >> 2) + 1];
    const unsigned x = __funnelshift_r(lo, hi, sh);   // codes c..c+3
    lo = hi;
    const uint2 e01 = pair[(x | (x >> 5)) & 63u];     // codes < 8
    const uint2 e23 = pair[((x >> 16) | (x >> 21)) & 63u];
    unsigned g = col_step(e01.x, s);
    g = min(g, col_step(e01.y, s) + 1u);
    g = min(g, col_step(e23.x, s) + 2u);
    g = min(g, col_step(e23.y, s) + 3u);
    s.best = min(s.best, g + (unsigned)(c0 + c));
  }
  const unsigned x = __funnelshift_r(lo, w[(c >> 2) + 1], sh);
  for (int u = 0; c + u < nc; ++u)
    s.best = min(s.best, col_step(pair[(x >> (8 * u)) & 7u].x, s)
                             + (unsigned)(c0 + c + u));
}

__global__ void __launch_bounds__(ROWS)
win1_kernel(const int8_t* __restrict__ wins,   // [B, W]
            int* __restrict__ out,             // [2, B]
            int B, int W, int m, sic::Peq4 pq) {
  __shared__ __align__(16) uint8_t sm[CAP + 32];
  __shared__ uint2 pair[64];
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, B - b0);
  if (t < 64) {                       // codes 4.. (N, PAD): no match
    const int a = t & 7, b = t >> 3, up = 32 - m;
    pair[t] = make_uint2(a < 4 ? pq.sel(a) << up : 0u,
                         b < 4 ? pq.sel(b) << up : 0u);
  }
  Chain s{0xFFFFFFFFu, 0u, m, (unsigned)m * KEY};

  if (W <= WMAX) {
    // ---- one round: the block's contiguous span, 16-byte loads ----
    const uint8_t* g = reinterpret_cast<const uint8_t*>(wins) + (size_t)b0 * W;
    const int n = nrows * W;
    const int off = (int)((uintptr_t)g & 15u);   // span byte i -> sm[off + i]
    const int head = min(n, (16 - off) & 15);
    const int nb = (n - head) >> 4;               // aligned 16-byte chunks
    const int tail0 = head + 16 * nb;
    const uint4* gv = reinterpret_cast<const uint4*>(g + head);
    uint4 v[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (t + j * ROWS < nb) v[j] = __ldg(gv + t + j * ROWS);
    uint8_t hb = 0, tb = 0;
    if (t < head) hb = __ldg(g + t);
    if (t < n - tail0) tb = __ldg(g + tail0 + t);
    uint4* sv = reinterpret_cast<uint4*>(sm + off + head);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (t + j * ROWS < nb) sv[t + j * ROWS] = v[j];
    if (t < head) sm[off + t] = hb;
    if (t < n - tail0) sm[off + tail0 + t] = tb;
    __syncthreads();
    if (t < nrows) run_row(sm, off + t * W, W, 0, pair, s);
  } else {
    // ---- a wider window: rounds of WMAX columns, rows at stride WMAX ----
    for (int c0 = 0; c0 < W; c0 += WMAX) {
      const int nc = min(WMAX, W - c0);
      __syncthreads();
      for (int i = t; i < nrows * nc; i += ROWS) {
        const int rr = i / nc, cc = i - rr * nc;
        sm[rr * WMAX + cc] = (uint8_t)wins[(size_t)(b0 + rr) * W + c0 + cc];
      }
      __syncthreads();
      if (t < nrows) run_row(sm, t * WMAX, nc, c0, pair, s);
    }
  }
  if (t < nrows) {
    const bool none = s.best == (unsigned)m * KEY;
    out[b0 + t] = none ? m : (int)(s.best / KEY);
    out[(size_t)B + b0 + t] = none ? -1 : (int)(s.best % KEY);
  }
}

}  // namespace

extern "C" int win1_launch(const void* wins, void* out, int B, int W, int m,
                           int peq_a, int peq_c, int peq_g, int peq_t,
                           void* stream) {
  if (W < 1 || W > (int)KEY || m < 1 || m > 32)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const sic::Peq4 pq{(unsigned)peq_a, (unsigned)peq_c, (unsigned)peq_g,
                     (unsigned)peq_t};
  win1_kernel<<<(B + ROWS - 1) / ROWS, ROWS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)wins, (int*)out, B, W, m, pq);
  return (int)cudaGetLastError();
}
