// The UMI distance matrix of one group: the global Levenshtein distance of
// every pattern row against every text, one launch a group.
//
// Replaces the device route of sicelore_tpu/core/umicluster.py::
// _pairwise_ed_device over sicelore_tpu/ops/editdist.py::
// myers_global_pairwise (a jitted lax.scan there, not a Pallas kernel): the
// JAX package calls it once for each pattern length; this kernel takes a
// length for each row, so every length class of a group goes in one launch.
//
// Input: peq [4, K] (uint32 Peq bits: bit b of peq[c, i] set iff pattern i
// has base c at b), mlens [K] int32 (the pattern lengths), texts [K, L] int8
// codes (A,C,G,T,N,PAD = 0..5; N and PAD match nothing) and tlens [K] int32.
// Output: d [K, K] int32, d[i, j] = the global distance of pattern i against
// text j, the score after column tlens[j] (an empty text gives m_i). A row
// with m_i outside 1..32 is not this kernel's (its caller fills it on the
// host): it gets 0. A text length outside 0..L is taken as 0.
//
// What bounds it on the H100: operations. A pair is a chain of tlens[j]
// dependent Myers columns (18 operations each); at 288 UMIs of 12 nt that is
// ~2e7 operations, under a microsecond of the card, against the 0.33 MB
// matrix it writes: a launch of a real group is bound by its own latency and
// the host's call. The design keeps that call to one launch:
//   * One thread a (pattern row, text) pair, its state in 32-bit registers.
//     A block is 8 warps x 32 lanes: a warp holds one pattern row, its lanes
//     32 consecutive texts, so a warp's 32 results are one 128-byte store of
//     the row, and its lanes share the row's match masks (8 words in shared
//     memory, codes 4-7 zero) and read one staged column of 32 texts, 32
//     consecutive bytes (no bank conflict).
//   * The block's texts are staged column-major in rounds of CH columns, up
//     to the longest text of the block; a lane snapshots its score after its
//     own text's last column.
//   * A 2-D grid over (text tiles, row tiles) takes any K, a group of
//     thousands at the single-link threshold too.
#include <stdint.h>

#include "myers.cuh"

namespace {

constexpr int TX = 32;    // texts a block: a lane each
constexpr int RY = 8;     // pattern rows a block: a warp each
constexpr int CH = 64;    // text columns staged a round

__global__ void __launch_bounds__(TX * RY)
pairwise_kernel(const unsigned* __restrict__ peq,   // [4, K]
                const int* __restrict__ mlens,      // [K]
                const int8_t* __restrict__ texts,   // [K, L]
                const int* __restrict__ tlens,      // [K]
                int* __restrict__ out,              // [K, K]
                int K, int L) {
  __shared__ unsigned eq_s[RY][8];
  __shared__ uint8_t tx_s[CH][TX];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * TX + lane;
  const int j0 = blockIdx.x * TX, i0 = blockIdx.y * RY;
  const int j = j0 + lane, i = i0 + w;
  if (tid < RY * 8) {
    const int r = tid >> 3, c = tid & 7;
    eq_s[r][c] = (c < 4 && i0 + r < K) ? peq[(size_t)c * K + i0 + r] : 0u;
  }
  const int m = i < K ? mlens[i] : 0;
  const bool row_ok = m >= 1 && m <= 32;
  int tl = j < K ? tlens[j] : 0;
  tl = (tl < 0 || tl > L) ? 0 : tl;
  // the longest text of the block: every warp holds the same 32 texts
  int tmax = tl;
  for (int o = 16; o; o >>= 1)
    tmax = max(tmax, __shfl_xor_sync(0xFFFFFFFFu, tmax, o));
  const int hibit = row_ok ? m - 1 : 0;
  unsigned PV = 0xFFFFFFFFu, MV = 0u;
  int score = m, snap = m;
  for (int c0 = 0; c0 < tmax; c0 += CH) {
    const int nc = min(CH, tmax - c0);
    __syncthreads();
    for (int q = tid; q < TX * nc; q += TX * RY) {
      const int t = q / nc, cc = q - t * nc;   // along a text's row
      tx_s[cc][t] = j0 + t < K
          ? (uint8_t)texts[(size_t)(j0 + t) * L + c0 + cc] : sic::PAD;
    }
    __syncthreads();
    for (int cc = 0; cc < nc; ++cc) {
      sic::myers_step_global(eq_s[w][tx_s[cc][lane] & 7u], PV, MV, score,
                             hibit);
      if (c0 + cc + 1 == tl) snap = score;
    }
  }
  if (i < K && j < K) out[(size_t)i * K + j] = row_ok ? snap : 0;
}

}  // namespace

extern "C" int pairwise_launch(const void* peq, const void* mlens,
                               const void* texts, const void* tlens,
                               void* out, int K, int L, void* stream) {
  if (K <= 0) return 0;
  const dim3 grid((K + TX - 1) / TX, (K + RY - 1) / RY);
  if (L < 1 || grid.y > 65535) return (int)cudaErrorInvalidValue;
  pairwise_kernel<<<grid, dim3(TX, RY), 0, (cudaStream_t)stream>>>(
      (const unsigned*)peq, (const int*)mlens, (const int8_t*)texts,
      (const int*)tlens, (int*)out, K, L);
  return (int)cudaGetLastError();
}
