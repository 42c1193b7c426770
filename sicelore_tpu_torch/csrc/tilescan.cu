// Tiled internal/chimera scan: a warp a 1,024-base tile, 32 columns a lane.
//
// Replaces the Pallas TPU kernel
// sicelore_tpu/ops/tilescan_tpu.py::_tile_kernel and computes, per tile,
// what models/readscan.py::_make_internal_tile_inner computes: the
// k-windows with at least mc A (T) bases; the first K = 3 starts of maximal
// passing stretches inside the ownership span [own_lo, own_hi) and
// <= tlen - k, per direction; a complete-adapter Myers confirm in a
// 160-base window at each site (A-sites reverse-complemented, T-sites
// sense); the 50-base guard from both read ends on the global split
// position; the ordered dedup of the confirmed splits. Output [3, T] int32:
// n, split0, split1 (tile-local).
//
// Input: the nibble tile rows of build_tiles as they are, row-major
// [T, TILE/2 + 16] uint8 (two 4-bit codes a byte, high nibble first, then 16
// meta bytes). Codes are 0..5 (N and PAD count as neither A nor T and match
// no pattern base), so no tile needs a second pass.
//
// What bounds it on the H100: the integer issue rate. Testing a tile's
// windows takes ~210 operations a 32-column word in the word form below
// (the scalar form takes 384), over the words its ownership span needs,
// plus a 160-column confirm at each of the few sites found: 4.3 us for the
// 46,942 tiles of a 32,768-read chunk, against 3.2 us of HBM time for the
// bytes those words and windows hold. The kernel stages whole 528-byte
// rows (24.8 MB, 7.6 us of HBM time, overlapped across the blocks of an
// SM), and a warp's lanes issue the detection whatever a tile's span. The
// design:
//   * Staging: a block's TPB tiles are one contiguous span of TPB x 528 bytes
//     (528 = 33 x 16). Every thread issues all of its 16-byte loads into
//     registers, then stores them to shared memory, then one barrier. Lanes
//     later read the staged rows 16 bytes at a time (a warp reads one row's
//     512 contiguous bytes: no bank conflict at the row stride of 528).
//   * Detection in words, a warp a tile: lane w holds columns 32w..32w+31 as
//     an A mask and a T mask (three-input logic on the nibbles, then a bit
//     compaction). The window counts are bit-sliced: sums of 1, 2, 4, 8, 16
//     neighbouring columns by doubling, each plane extended past the lane's
//     32 columns by the next lane's plane (a shuffle and a funnel shift),
//     added at the offsets of k's binary digits and compared with mc through
//     a carry; for the default k = 15, mc = 11 these are compiled in and
//     every branch folds. Rising edges need the previous lane's top bit; the
//     first three sites of the tile come from a ballot and __ffs, walked
//     only in a tile that holds a rising edge (most tiles hold none).
//   * Confirms compacted across the block: the warps append their tiles'
//     sites to a list in shared memory; after a barrier each thread takes
//     one site and runs its 160-column Myers search on the staged tile, with
//     the complement folded into a second match-mask table. The per-tile
//     dedup and the 50-base guard then run one thread a tile, in the order
//     of the sites (A0..A2, T0..T2), as the reference does.
#include <stdint.h>
#include <string.h>

#include "myers.cuh"

namespace {

using sic::PAD;

constexpr int TILE = 1024;
constexpr int NIB_ROWS = TILE / 2;
constexpr int ROW = NIB_ROWS + 16;           // 528 bytes a tile row
constexpr int K = 3;                         // models/readscan.py K_TILE_SITES
constexpr int SITES = 2 * K;                 // site slots a tile: A0..2, T0..2
constexpr int TPB = 32;                      // tiles a block
constexpr int THREADS = 128;                 // 4 warps, 8 tiles each
constexpr int NV = (TPB * ROW / 16 + THREADS - 1) / THREADS;
constexpr int NONE = (int)0x80000000;        // slot without a confirmed split
constexpr unsigned FULL = 0xFFFFFFFFu;

struct TileParams {
  int k, mc, m_adc, edmax, Wi;
  unsigned peq[4];
};

// ---- word form of the detection ----

// The flags at bits 4n (nibble n of v) -> 8 bits in column order: byte b of
// v holds columns 2b (high nibble, n = 2b + 1) and 2b + 1 (low nibble).
__device__ __forceinline__ unsigned compact8(unsigned f) {
  f = ((f >> 4) | (f << 1)) & 0x03030303u;
  f = (f | (f >> 6)) & 0x000F000Fu;
  return (f | (f >> 12)) & 0xFFu;
}

// A and T masks of the 8 columns in v (codes 0..5: bit 3 of a nibble is 0).
__device__ __forceinline__ void masks8(unsigned v, unsigned& a, unsigned& t) {
  const unsigned v1 = v >> 1, v2 = v >> 2;
  a = compact8(~(v | v1 | v2) & 0x11111111u);    // nibble 0
  t = compact8(v & v1 & ~v2 & 0x11111111u);      // nibble 3
}

// Bit-sliced sums a lane: plane i holds bit i of the sum at each of the
// lane's 32 positions; `n` holds the next lane's planes (its positions are
// this lane's 32..63). The last lane's next planes are whatever the shuffle
// returns: no window that a valid start reads goes past column 1,023.
template <int N>
__device__ __forceinline__ void next_planes(const unsigned (&d)[N],
                                            unsigned (&n)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) n[i] = __shfl_down_sync(FULL, d[i], 1);
}

// r = d + (d >> s): the sums of twice as many neighbouring columns.
template <int N>
__device__ __forceinline__ void dbl(const unsigned (&d)[N],
                                    const unsigned (&n)[N], int s,
                                    unsigned (&r)[N + 1]) {
  unsigned c = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const unsigned x = d[i], y = __funnelshift_r(d[i], n[i], s);
    r[i] = x ^ y ^ c;
    c = (x & y) | (c & (x ^ y));
  }
  r[N] = c;
}

// acc (5 planes) += d at positions o..o+31.
template <int N>
__device__ __forceinline__ void acc_add(unsigned (&acc)[5],
                                        const unsigned (&d)[N],
                                        const unsigned (&n)[N], int o) {
  unsigned c = 0u;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const unsigned x = acc[i];
    const unsigned y = i < N ? __funnelshift_r(d[i], n[i], o) : 0u;
    acc[i] = x ^ y ^ c;
    c = (x & y) | (c & (x ^ y));
  }
}

// Bit i set iff columns i..i+k-1 (of this lane's 32 and the next lane's)
// hold >= mc set bits (k <= 31). KC, MC: k and mc when known at compile
// time (0: take kr, mcr); then every branch below folds away.
template <int KC, int MC>
__device__ __forceinline__ unsigned passing(unsigned x, int kr, int mcr) {
  const int k = KC ? KC : kr, mc = KC ? MC : mcr;
  if (mc <= 0) return FULL;
  if (mc > k) return 0u;
  unsigned d0[1] = {x}, n0[1], d1[2] = {}, n1[2] = {}, d2[3] = {},
           n2[3] = {}, d3[4] = {}, n3[4] = {}, d4[5] = {};
  next_planes(d0, n0);
  if (k >= 2) dbl(d0, n0, 1, d1);
  if (k >= 4) { next_planes(d1, n1); dbl(d1, n1, 2, d2); }
  if (k >= 8) { next_planes(d2, n2); dbl(d2, n2, 4, d3); }
  if (k >= 16) { next_planes(d3, n3); dbl(d3, n3, 8, d4); }
  unsigned acc[5] = {0u, 0u, 0u, 0u, 0u};
  int o = 0;
  if (k & 16) { acc_add(acc, d4, d4, 0); o = 16; }
  if (k & 8) {
    if (o) acc_add(acc, d3, n3, o); else acc_add(acc, d3, d3, 0);
    o += 8;
  }
  if (k & 4) {
    if (o) acc_add(acc, d2, n2, o); else acc_add(acc, d2, d2, 0);
    o += 4;
  }
  if (k & 2) {
    if (o) acc_add(acc, d1, n1, o); else acc_add(acc, d1, d1, 0);
    o += 2;
  }
  if (k & 1) acc_add(acc, d0, n0, o);
  // acc >= mc  <=>  acc + (32 - mc) carries out of five bits
  const int c = 32 - mc;
  unsigned carry = 0u;
#pragma unroll
  for (int i = 0; i < 5; ++i)
    carry = ((c >> i) & 1) ? (acc[i] | carry) : (acc[i] & carry);
  return carry;
}

// Bits i of word `lane` with lo <= 32 lane + i < hi.
__device__ __forceinline__ unsigned span_mask(int lo, int hi, int lane) {
  const int a = min(max(lo - 32 * lane, 0), 32);
  const int b = min(max(hi - 32 * lane, 0), 32);
  const unsigned below_b = b >= 32 ? FULL : ((1u << b) - 1u);
  const unsigned below_a = a >= 32 ? FULL : ((1u << a) - 1u);
  return below_b & ~below_a;
}

// The first K set bits of the tile's rising-edge words, in column order
// (warp-uniform); -1 where there are fewer.
__device__ __forceinline__ void first_sites(unsigned rs, int (&s)[K]) {
  unsigned bal = __ballot_sync(FULL, rs != 0u);
  unsigned r = 0u;
  int L = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (r == 0u && bal != 0u) {
      L = __ffs(bal) - 1;
      bal &= bal - 1u;
      r = __shfl_sync(FULL, rs, L);
    }
    s[i] = r ? 32 * L + __ffs(r) - 1 : -1;
    r &= r - 1u;
  }
}

__device__ __forceinline__ int code_at(const uint8_t* row, int q) {
  const int v = row[q >> 1];
  return (q & 1) ? (v & 15) : (v >> 4);
}

// Semi-global search of the complete adapter in the Wi-base window at
// `start` (PAD outside [0, tlen)), read backwards through the complement
// table when rc.
__device__ void confirm(const uint8_t* row, int tlen, int start, bool rc,
                        const unsigned* peq, int m, int Wi, int& ed,
                        int& pos) {
  unsigned PV = sic::full_mask(m), MV = 0u;
  int score = m, best = m, bpos = -1;
  for (int i = 0; i < Wi; ++i) {
    const int q = rc ? start + (Wi - 1 - i) : start + i;
    const int c = (q >= 0 && q < tlen) ? code_at(row, q) : PAD;
    sic::myers_step(peq[c & 7], PV, MV, score, m - 1);
    if (score < best) {
      best = score;
      bpos = i;
    }
  }
  ed = best;
  pos = bpos;
}

// KC, MC: k and mc of the default configuration compiled in (0: read P).
template <int KC, int MC>
__global__ void __launch_bounds__(THREADS)
tile_scan_kernel(const uint8_t* __restrict__ rows, int* __restrict__ out,
                 int T, const __grid_constant__ TileParams P) {
  __shared__ __align__(16) uint8_t sm[TPB * ROW];
  __shared__ int spos[TPB * SITES];       // site column of each slot, -1
  __shared__ int res[TPB * SITES];        // confirmed split, or NONE
  __shared__ unsigned short list[TPB * SITES];
  __shared__ unsigned peq[16];            // [0..7] sense, [8..15] complement
  __shared__ int nlist;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int t0 = blockIdx.x * TPB;
  const int ntl = min(TPB, T - t0);

  // ---- stage the block's span: all 16-byte loads, then the stores ----
  {
    const int nv = ntl * (ROW / 16);
    const uint4* g = reinterpret_cast<const uint4*>(rows + (size_t)t0 * ROW);
    uint4 v[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (t + j * THREADS < nv) v[j] = __ldg(g + t + j * THREADS);
    uint4* s = reinterpret_cast<uint4*>(sm);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (t + j * THREADS < nv) s[t + j * THREADS] = v[j];
  }
  if (t < 16) {
    const int c = t & 7;
    const int b = t < 8 ? c : (c < 4 ? 3 - c : c);
    peq[t] = b < 4 ? P.peq[b] : 0u;
  }
  for (int i = t; i < TPB * SITES; i += THREADS) {
    spos[i] = -1;
    res[i] = NONE;
  }
  if (t == 0) nlist = 0;
  __syncthreads();

  // ---- detection, a warp a tile ----
  const int k = KC ? KC : P.k;
  for (int lt = warp; lt < ntl; lt += THREADS / 32) {
    const uint8_t* row = sm + lt * ROW;
    const uint4 q = reinterpret_cast<const uint4*>(row)[lane];
    const unsigned* mw = reinterpret_cast<const unsigned*>(row + NIB_ROWS);
    const int own_lo = (int)(mw[0] & 0xFFFFu), own_hi = (int)(mw[0] >> 16);
    const int tlen = (int)(mw[1] & 0xFFFFu);
    unsigned a0, a1, a2, a3, t0m, t1m, t2m, t3m;
    masks8(q.x, a0, t0m);
    masks8(q.y, a1, t1m);
    masks8(q.z, a2, t2m);
    masks8(q.w, a3, t3m);
    const unsigned A = a0 | (a1 << 8) | (a2 << 16) | (a3 << 24);
    const unsigned Tm = t0m | (t1m << 8) | (t2m << 16) | (t3m << 24);
    const unsigned own = span_mask(own_lo, min(own_hi, tlen - k + 1), lane);
    const unsigned okA = passing<KC, MC>(A, k, P.mc) & own;
    const unsigned okT = passing<KC, MC>(Tm, k, P.mc) & own;
    unsigned pA = __shfl_up_sync(FULL, okA, 1) >> 31;
    unsigned pT = __shfl_up_sync(FULL, okT, 1) >> 31;
    if (lane == 0) pA = pT = 0u;
    const unsigned rsA = okA & ~((okA << 1) | pA);
    const unsigned rsT = okT & ~((okT << 1) | pT);
    if (!__any_sync(FULL, (rsA | rsT) != 0u)) continue;   // most tiles
    int sA[K], sT[K];
    first_sites(rsA, sA);
    first_sites(rsT, sT);
    if (lane == 0) {
      int n = 0;
#pragma unroll
      for (int i = 0; i < K; ++i) n += (sA[i] >= 0) + (sT[i] >= 0);
      const int at = atomicAdd(&nlist, n);
      int j = 0;
#pragma unroll
      for (int i = 0; i < SITES; ++i) {
        const int slot = lt * SITES + i;
        const int s = i < K ? sA[i] : sT[i - K];
        spos[slot] = s;
        if (s >= 0) list[at + j++] = (unsigned short)slot;
      }
    }
  }
  __syncthreads();

  // ---- confirms, a thread a site; A-junction splits after the cassette,
  // T-junction splits at its start ----
  const int nl = nlist;
  for (int j = t; j < nl; j += THREADS) {
    const int slot = list[j], lt = slot / SITES, i = slot - lt * SITES;
    const uint8_t* row = sm + lt * ROW;
    const unsigned* mw = reinterpret_cast<const unsigned*>(row + NIB_ROWS);
    const int tlen = (int)(mw[1] & 0xFFFFu);
    const int g0 = (int)mw[2], rlen = (int)mw[3];
    const int s = spos[slot];
    const bool rc = i < K;
    int ed, pos, spl;
    if (rc) {
      confirm(row, tlen, s, true, peq + 8, P.m_adc, P.Wi, ed, pos);
      spl = s + P.Wi - 1 - pos + P.m_adc;
    } else {
      confirm(row, tlen, s - P.Wi, false, peq, P.m_adc, P.Wi, ed, pos);
      spl = s - P.Wi + pos - (P.m_adc - 1);
    }
    const int gp = g0 + spl;
    if (ed <= P.edmax && gp > 50 && gp < rlen - 50) res[slot] = spl;
  }
  __syncthreads();

  // ---- first two distinct confirmed splits, in slot order ----
  if (t < ntl) {
    int n = 0, s0 = -1, s1 = -1;
    int v[SITES];
#pragma unroll
    for (int i = 0; i < SITES; ++i) v[i] = res[t * SITES + i];
#pragma unroll
    for (int i = 0; i < SITES; ++i) {
      bool dup = v[i] == NONE;
#pragma unroll
      for (int j = 0; j < i; ++j) dup |= v[j] != NONE && v[j] == v[i];
      if (!dup) {
        if (n == 0) s0 = v[i];
        if (n == 1) s1 = v[i];
        ++n;
      }
    }
    out[t0 + t] = n;
    out[(size_t)T + t0 + t] = s0;
    out[2 * (size_t)T + t0 + t] = s1;
  }
}

}  // namespace

extern "C" int tilescan_launch(const void* rows, void* out, const void* params,
                               int T, int nparams, void* stream) {
  if (nparams * (int)sizeof(int) != (int)sizeof(TileParams))
    return (int)cudaErrorInvalidValue;
  TileParams P;
  memcpy(&P, params, sizeof(TileParams));
  if (T <= 0) return 0;
  if (P.k < 1 || P.k > 31 || ((uintptr_t)rows & 15u))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T + TPB - 1) / TPB);
  const cudaStream_t st = (cudaStream_t)stream;
  if (P.k == 15 && P.mc == 11)        // models/readscan.py's defaults
    tile_scan_kernel<15, 11><<<grid, THREADS, 0, st>>>(
        (const uint8_t*)rows, (int*)out, T, P);
  else
    tile_scan_kernel<0, 0><<<grid, THREADS, 0, st>>>(
        (const uint8_t*)rows, (int*)out, T, P);
  return (int)cudaGetLastError();
}
