// Single-pattern window search, one thread per window.
//
// Replaces the Pallas TPU kernel sicelore_tpu/ops/editdist.py::_win1_kernel:
// the Myers semi-global search of ONE pattern (m <= 32) over every row of a
// row-major [B, W] int8 code matrix (A,C,G,T,N,PAD = 0..5; N and PAD match
// nothing). A row reports its best edit distance and the 0-based column where
// that match ends: the first such column on ties, -1 (with ed = m) when no
// column improved on m. Output [2, B] int32: row 0 ed, row 1 end column.
//
// What bounds it on the H100: neither bytes nor operations at the shapes the
// scans use (65,536 x 110 windows are 7 MB and 1.3e8 int32 operations, a few
// microseconds of either); a window is a chain of W dependent column updates,
// so the time is the chain's latency times the waves of blocks, plus the
// launch. The design keeps the chain's state in registers and spends its care
// on the loads: row-major int8 rows would make one-thread-a-row loads
// uncoalesced, so a block of ROWS windows stages CH columns at a time through
// shared memory (neighbouring threads read neighbouring bytes of a row), and
// each thread then reads its own row four codes a word. The row stride of 17
// words is odd, so the 32 threads of a warp hit 32 different banks.
#include <stdint.h>

#include "myers.cuh"

namespace {

constexpr int ROWS = 128;        // windows (threads) per block
constexpr int CH = 64;           // columns staged per step
constexpr int STRIDE = CH + 4;   // bytes per staged row (17 words)

__global__ void __launch_bounds__(ROWS)
win1_kernel(const int8_t* __restrict__ wins,   // [B, W]
            int* __restrict__ out,             // [2, B]
            int B, int W, int m, sic::Peq4 pq) {
  __shared__ __align__(16) int8_t tile[ROWS * STRIDE];
  const int b0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, B - b0);
  const int r = threadIdx.x;
  const bool active = r < nrows;
  const int hibit = m - 1;
  unsigned PV = sic::full_mask(m), MV = 0u;
  int score = m, best = m, bpos = -1;

  for (int c0 = 0; c0 < W; c0 += CH) {
    const int nc = min(CH, W - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < nrows * CH; i += ROWS) {
      const int rr = i / CH, cc = i % CH;
      if (cc < nc)
        tile[rr * STRIDE + cc] = wins[(size_t)(b0 + rr) * W + c0 + cc];
    }
    __syncthreads();
    if (!active) continue;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(tile + r * STRIDE);
    for (int c = 0; c < nc; c += 4) {
      const uint32_t word = row[c >> 2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c + u < nc) {
          const int code = (int)((word >> (8 * u)) & 0xFFu);
          sic::myers_step(pq.sel(code), PV, MV, score, hibit);
          if (score < best) {
            best = score;
            bpos = c0 + c + u;
          }
        }
      }
    }
  }
  if (active) {
    out[b0 + r] = best;
    out[(size_t)B + b0 + r] = bpos;
  }
}

}  // namespace

extern "C" int win1_launch(const void* wins, void* out, int B, int W, int m,
                           int peq_a, int peq_c, int peq_g, int peq_t,
                           void* stream) {
  if (W < 1 || m < 1 || m > 32) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const sic::Peq4 pq{(unsigned)peq_a, (unsigned)peq_c, (unsigned)peq_g,
                     (unsigned)peq_t};
  win1_kernel<<<(B + ROWS - 1) / ROWS, ROWS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)wins, (int*)out, B, W, m, pq);
  return (int)cudaGetLastError();
}
