// Tiled internal/chimera scan, one thread per 1024-base tile.
//
// Replaces the Pallas TPU kernel sicelore_tpu/ops/tilescan_tpu.py::_tile_kernel
// and computes, per tile, what models/readscan.py::_make_internal_tile_inner
// computes: rolling A/T counts over the tile; the first K=3 polyA and polyT
// run starts inside the ownership span [own_lo, own_hi) and <= tlen - k;
// a complete-adapter Myers confirm in a 160-base window at each site
// (A-sites reverse-complemented, T-sites sense); the 50-base guard from
// both read ends on the global split position; the ordered dedup of the
// confirmed splits. Output [3, T] int32: n, split0, split1 (tile-local).
//
// Input: the nibble tile rows of build_tiles, text-major [TILE/2 + 16, T]
// (two 4-bit codes a byte, high nibble first, then 16 meta bytes). N and
// PAD are exact codes there, match no pattern base and count as neither A
// nor T, so no tile needs a second pass.
//
// What bounds it on the H100: integer ALU work, about 1024 run-scan steps
// plus six 160-column Myers confirms a tile; 528 bytes a tile are read from
// HBM. The simple design keeps all state in registers, one tile a thread;
// neighbouring threads load neighbouring bytes in the run scan.
#include <stdint.h>
#include <string.h>

#include "myers.cuh"

namespace {

using sic::PAD;

constexpr int TILE = 1024;
constexpr int NIB_ROWS = TILE / 2;
constexpr int K = 3;   // models/readscan.py K_TILE_SITES

struct TileParams {
  int k, mc, m_adc, edmax, Wi;
  unsigned peq[4];
};

struct TileRow {
  const uint8_t* rows;
  int T, t;
  __device__ __forceinline__ int byte(int r) const {
    return (int)rows[(size_t)r * T + t];
  }
  __device__ __forceinline__ int code(int c) const {
    const int v = byte(c >> 1);
    return (c & 1) ? (v & 15) : (v >> 4);
  }
};

// Semi-global search of the complete adapter in the Wi-base window at
// `start` (PAD outside [0, tlen)), reverse-complemented with rc.
__device__ void confirm(const TileRow& r, int tlen, int start, bool rc,
                        const TileParams& P, int& ed, int& pos) {
  const sic::Peq4 pq{P.peq[0], P.peq[1], P.peq[2], P.peq[3]};
  unsigned PV = sic::full_mask(P.m_adc), MV = 0u;
  int score = P.m_adc, best = P.m_adc, bpos = -1;
  for (int i = 0; i < P.Wi; ++i) {
    const int q = rc ? start + (P.Wi - 1 - i) : start + i;
    int c = (q >= 0 && q < tlen) ? r.code(q) : PAD;
    if (rc) c = sic::comp(c);
    sic::myers_step(pq.sel(c), PV, MV, score, P.m_adc - 1);
    if (score < best) {
      best = score;
      bpos = i;
    }
  }
  ed = best;
  pos = bpos;
}

__global__ void __launch_bounds__(128)
tile_scan_kernel(const uint8_t* __restrict__ rows, int* __restrict__ out,
                 int T, const __grid_constant__ TileParams P) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const TileRow r{rows, T, t};
  int mb[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) mb[i] = r.byte(NIB_ROWS + i);
  const int own_lo = mb[0] | (mb[1] << 8);
  const int own_hi = mb[2] | (mb[3] << 8);
  const int tlen = mb[4] | (mb[5] << 8);
  const int g0 = mb[8] | (mb[9] << 8) | (mb[10] << 16) | (mb[11] << 24);
  const int rlen = mb[12] | (mb[13] << 8) | (mb[14] << 16) | (mb[15] << 24);

  // ---- detection: starts of maximal passing stretches, per direction ----
  const int k = P.k;
  const unsigned kmask = (1u << k) - 1u;   // k <= 31
  int sA[K] = {-1, -1, -1}, sT[K] = {-1, -1, -1};
  int nA = 0, nT = 0;
  bool pokA = false, pokT = false;
  unsigned bA = 0u, bT = 0u;
  const int cend = min(TILE, own_hi + k - 1);   // last column any p < own_hi reads
  for (int c = 0; c < cend; ++c) {
    const int x = r.code(c);
    bA = (bA << 1) | (x == 0 ? 1u : 0u);
    bT = (bT << 1) | (x == 3 ? 1u : 0u);
    const int p = c - k + 1;
    if (p < 0) continue;
    const bool inown = p >= own_lo && p < own_hi && p <= tlen - k;
    const bool okA = inown && __popc(bA & kmask) >= P.mc;
    const bool okT = inown && __popc(bT & kmask) >= P.mc;
    if (okA && !pokA && nA < K) sA[nA++] = p;
    if (okT && !pokT && nT < K) sT[nT++] = p;
    pokA = okA;
    pokT = okT;
  }

  // ---- confirm each site; A-junction splits after the cassette, T-junction
  // splits at its start ----
  int spl[2 * K];
  bool okc[2 * K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    int ed = 0, pos = -1;
    okc[i] = false;
    spl[i] = 0;
    if (sA[i] >= 0) {
      confirm(r, tlen, sA[i], true, P, ed, pos);
      spl[i] = sA[i] + P.Wi - 1 - pos + P.m_adc;
      okc[i] = ed <= P.edmax;
    }
    okc[K + i] = false;
    spl[K + i] = 0;
    if (sT[i] >= 0) {
      confirm(r, tlen, sT[i] - P.Wi, false, P, ed, pos);
      spl[K + i] = sT[i] - P.Wi + pos - (P.m_adc - 1);
      okc[K + i] = ed <= P.edmax;
    }
  }
  // ---- 50-base guard + first two distinct confirmed splits ----
  int n = 0, s0 = -1, s1 = -1;
  bool taken[2 * K];
#pragma unroll
  for (int i = 0; i < 2 * K; ++i) {
    const int gp = g0 + spl[i];
    const bool ok = okc[i] && gp > 50 && gp < rlen - 50;
    bool dup = false;
#pragma unroll
    for (int j = 0; j < i; ++j) dup |= taken[j] && spl[j] == spl[i];
    taken[i] = ok && !dup;
    if (taken[i]) {
      if (n == 0) s0 = spl[i];
      if (n == 1) s1 = spl[i];
      ++n;
    }
  }
  out[t] = n;
  out[(size_t)T + t] = s0;
  out[2 * (size_t)T + t] = s1;
}

}  // namespace

extern "C" int tilescan_launch(const void* rows, void* out, const void* params,
                               int T, int nparams, void* stream) {
  if (nparams * (int)sizeof(int) != (int)sizeof(TileParams))
    return (int)cudaErrorInvalidValue;
  TileParams P;
  memcpy(&P, params, sizeof(TileParams));
  if (T <= 0) return 0;
  const int threads = 128;
  tile_scan_kernel<<<(T + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>((const uint8_t*)rows, (int*)out,
                                             T, P);
  return (int)cudaGetLastError();
}
