// Whitelist sweep, one thread per read.
//
// Replaces the Pallas TPU kernel sicelore_tpu/ops/bcsearch.py::_bc_sweep_kernel:
// the Myers semi-global edit distance of each read's BC window (W <= 32
// chars) against every used barcode (m <= 31), reduced as the barcodes are
// visited in ascending index to the best ED, its first argmin, the second-
// best ED (a tie makes it equal to the best) and the best match's end
// position (-1 unless track_pos). Barcodes j >= nvalid count as BIG.
// Output [4, B] int32.
//
// What bounds it on the H100: integer ALU work, B * N * W Myers steps of
// about 20 ops (32k reads x 49k barcodes x 22 = 3.5e10 steps); the Peq list
// (16 B a barcode, 786 KB for 49k) is read once per block. The simple design
// keeps the window and all state in registers and stages the Peq list
// through shared memory in tiles of NT barcodes, read by every thread of the
// block at the same address (a broadcast), so the inner loop touches no
// global memory.
#include <stdint.h>

#include "myers.cuh"

namespace {

using sic::PAD;

constexpr int BIG = 1 << 30;
constexpr int MAXW = 32;
constexpr int NT = 1024;       // barcodes per shared-memory tile (16 KB)
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bc_sweep_kernel(const uint8_t* __restrict__ wins,      // [W, B]
                const unsigned* __restrict__ peq,      // [4, N]
                int* __restrict__ out,                 // [4, B]
                int B, int W, int N, int nvalid, int m, int track_pos) {
  __shared__ uint4 tile[NT];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < B;
  int wc[MAXW];
#pragma unroll
  for (int t = 0; t < MAXW; ++t)
    wc[t] = (active && t < W) ? (int)wins[(size_t)t * B + b] : PAD;

  const unsigned full = sic::full_mask(m);
  int b1 = BIG, i1 = 0, b2 = BIG, p1 = -1;
  for (int j0 = 0; j0 < N; j0 += NT) {
    const int nt = min(NT, N - j0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt; i += blockDim.x) {
      const int j = j0 + i;
      tile[i] = make_uint4(peq[j], peq[(size_t)N + j], peq[2 * (size_t)N + j],
                           peq[3 * (size_t)N + j]);
    }
    __syncthreads();
    if (!active) continue;
    for (int jj = 0; jj < nt; ++jj) {
      const uint4 q = tile[jj];
      const sic::Peq4 pq{q.x, q.y, q.z, q.w};
      unsigned PV = full, MV = 0u;
      int score = m, best = m, bpos = -1;
#pragma unroll
      for (int t = 0; t < MAXW; ++t) {
        if (t < W) {
          sic::myers_step(pq.sel(wc[t]), PV, MV, score, m - 1);
          if (score < best) {
            best = score;
            bpos = t;
          }
        }
      }
      const int j = j0 + jj;
      const int ed = j < nvalid ? best : BIG;
      if (ed < b1) {
        b2 = b1;
        b1 = ed;
        i1 = j;
        p1 = bpos;
      } else {
        b2 = min(b2, ed);
      }
    }
  }
  if (active) {
    out[b] = b1;
    out[(size_t)B + b] = i1;
    out[2 * (size_t)B + b] = b2;
    out[3 * (size_t)B + b] = track_pos ? p1 : -1;
  }
}

}  // namespace

extern "C" int bcsweep_launch(const void* wins, const void* peq, void* out,
                              int B, int W, int N, int nvalid, int m,
                              int track_pos, void* stream) {
  if (W > MAXW || m < 1 || m > 31) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  bc_sweep_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                    (cudaStream_t)stream>>>(
      (const uint8_t*)wins, (const unsigned*)peq, (int*)out, B, W, N, nvalid,
      m, track_pos);
  return (int)cudaGetLastError();
}
