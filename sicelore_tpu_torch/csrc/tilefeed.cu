// Fused short-read tile feed: the tile rows of the reads that lie whole in
// the pass-1 two-half codes, built on the card from the rows pass 1 has
// already uploaded.
//
// Replaces the composite route into the Pallas TPU kernel
// sicelore_tpu/ops/tilescan_tpu.py::_tile_kernel: make_composite_tile_fn
// unpacks the pass-1 composite, shifts the right-aligned tail into place
// with log-step rolls and packs a tile row for each read before the tile
// kernel runs. Here that packing is its own kernel, and csrc/tilescan.cu
// scans what it writes, unchanged.
//
// Input: encode_two_half's rows as they are, [B, 2E] int8 (E = 304; head in
// columns [0, E), the read's last E bases right-aligned in [E, 2E), PAD
// outside the read), contiguous and 16-byte aligned, lens [B] int32, and
// idx [C] int32: the reads to feed (the host's `feed_covered` reads, in read
// order). Output: [C, 528] uint8 rows in models/readscan.py::build_tiles'
// layout, row i for read idx[i]. A read with min_len < L <= 2E (min_len = 2
// edge + k) gets the one tile build_tiles writes for it (g0 = 0): code j < E
// is codes[j], E <= j < L is codes[j + 2E - L], every j >= L is PAD, a PAD
// code inside the read (a NUL byte, which build_tiles encodes as N) is N;
// meta own_lo = edge, own_hi = max(L - edge - k + 1, 0), tlen = L, g0 = 0,
// rlen = L. An index of a read outside that range (or outside [0, B)) gets
// an inert row: PAD codes and zero meta, which the scan reports as n = 0.
//
// What bounds it on the H100: bytes. It computes nothing but addresses: the
// least time is the bytes over 3.35 TB/s, the fed reads' L code bytes, their
// index and length, and their rows written (~0.005 ms for the 16,602 covered
// reads of a 32,768-read chunk of chip_smoke.py's mix). The design:
//   * Only the covered reads are fed, so every row written is one the tile
//     scan needs, and every piece staged is one a row reads: a read's
//     columns [0, E) and [3E - L, 2E), in 16-byte pieces.
//   * A persistent grid (a few blocks an SM) walks over groups of RPB
//     reads. The pieces of the next group are copied into shared memory
//     with cp.async (16 bytes a copy, no register staging) while the
//     current group, double-buffered, is shifted and stored; the next
//     group's index is loaded an iteration ahead, so a group's copies wait
//     on one length load.
//   * A warp writes a row at a time, a lane a 32-bit output word (8 codes):
//     a word never straddles E (E is a multiple of 8), so its 8 codes are 8
//     contiguous staged bytes (head at j, tail at j + 2E - L), read as three
//     aligned shared words and two funnel shifts, mapped PAD -> N with a
//     byte compare, cut at L and packed two codes a byte with a byte
//     permutation. A warp's 32 words are 128 contiguous bytes of the
//     output, so every store fills whole sectors; the row's length and
//     cover test are read once a row.
#include <stdint.h>

namespace {

constexpr int E = 304;                  // ops/edgescan.py E
constexpr int E2 = 2 * E;               // 608 = 38 x 16 bytes a code row
constexpr int TILE = 1024;
constexpr int ROW = TILE / 2 + 16;      // 528 bytes a tile row
constexpr int WORDS = ROW / 4;          // 132 output words a row
constexpr int CODE_WORDS = TILE / 8;    // 128 of them hold codes
constexpr int PIECES = E2 / 16;         // 38 staged pieces a row
constexpr int RPB = 16;                 // reads a group
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 4;   // kernel_variants.py feed
constexpr uint32_t PAD4 = 0x05050505u;  // PAD in every byte
static_assert(E % 8 == 0, "a word of 8 codes must not straddle E");

__device__ __forceinline__ bool covered(int L, int min_len) {
  return L > min_len && L <= E2;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 codes (bytes 0..5) of the read -> PAD mapped to N, bytes from `n` on
// (n = valid codes, any int) set to PAD.
__device__ __forceinline__ uint32_t clean4(uint32_t x, int n) {
  x ^= __vcmpeq4(x, PAD4) & 0x01010101u;              // 5 -> 4
  const uint32_t keep = n >= 4 ? 0xFFFFFFFFu
                      : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
  return (x & keep) | (PAD4 & ~keep);
}

// Codes c0..c3 in bytes 0..3 of x -> (c0 << 4 | c1) in byte 0 and
// (c2 << 4 | c3) in byte 2.
__device__ __forceinline__ uint32_t pair_nibbles(uint32_t x) {
  return (x << 4) | (x >> 8);
}

struct Smem {
  uint4 raw[2][RPB * PIECES + 1];       // + 1: a word may read past a row
  int len[2][RPB];
  int src[2][RPB];
};

__global__ void __launch_bounds__(THREADS)
tile_feed_kernel(const int8_t* __restrict__ codes,
                 const int* __restrict__ lens, const int* __restrict__ idx,
                 uint8_t* __restrict__ out, int B, int C, int edge, int k) {
  __shared__ Smem sm;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int min_len = 2 * edge + k;
  const int ngroups = (C + RPB - 1) / RPB;
  const int G = gridDim.x;
  int g = blockIdx.x;
  if (g >= ngroups) return;

  // lanes t < RPB: the index of their read of a group, loaded a step ahead
  auto index_of = [&](int gg) {
    const int q = gg * RPB + t;
    return (t < RPB && gg < ngroups && q < C) ? idx[q] : -1;
  };
  auto fetch_meta = [&](int ri, int buf) {       // t < RPB only
    const bool ok = ri >= 0 && ri < B;
    const int L = ok ? lens[ri] : 0;
    sm.src[buf][t] = ok ? ri : -1;
    sm.len[buf][t] = L;
  };
  auto issue = [&](int gg, int buf) {
    const int nr = min(RPB, C - gg * RPB);
    for (int i = t; i < nr * PIECES; i += THREADS) {
      const int r = i / PIECES, c0 = 16 * (i - r * PIECES);
      const int L = sm.len[buf][r], ri = sm.src[buf][r];
      if (ri >= 0 && covered(L, min_len) &&
          (c0 < E || c0 + 16 > 3 * E - L))
        cp_async16(&sm.raw[buf][i], codes + (size_t)ri * E2 + c0);
    }
    cp_async_commit();
  };

  int nxt = index_of(g);
  if (t < RPB) fetch_meta(nxt, 0);
  nxt = index_of(g + G);
  __syncthreads();
  issue(g, 0);

  for (int it = 0; g < ngroups; ++it, g += G) {
    const int b = it & 1;
    if (g + G < ngroups) {
      if (t < RPB) fetch_meta(nxt, b ^ 1);
      nxt = index_of(g + 2 * G);
      __syncthreads();
      issue(g + G, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // shift and store group g from buffer b: a warp a row at a time, a
    // lane a word (the last 4 words of a row are its meta)
    const int nr = min(RPB, C - g * RPB);
    const uint32_t* rb = reinterpret_cast<const uint32_t*>(sm.raw[b]);
    for (int r = warp; r < nr; r += WARPS) {
      const int L = sm.len[b][r];
      const bool cov = sm.src[b][r] >= 0 && covered(L, min_len);
      const int tail = r * E2 + E2 - L;    // code j >= E: staged tail + j
      uint32_t* o = reinterpret_cast<uint32_t*>(
          out + ((size_t)g * RPB + r) * ROW);
      for (int w = lane; w < CODE_WORDS; w += 32) {
        const int j0 = 8 * w;
        uint32_t v = 0x55555555u;                // PAD | PAD in every byte
        if (cov && j0 < L) {
          const int off = j0 < E ? r * E2 + j0 : tail + j0;
          const uint32_t* q = rb + (off >> 2);
          const unsigned sh = 8u * (off & 3);
          const uint32_t x0 = __funnelshift_r(q[0], q[1], sh);
          const uint32_t x1 = __funnelshift_r(q[1], q[2], sh);
          v = __byte_perm(pair_nibbles(clean4(x0, L - j0)),
                          pair_nibbles(clean4(x1, L - j0 - 4)), 0x6420);
        }
        o[w] = v;
      }
      if (lane < WORDS - CODE_WORDS) {
        // meta: own_lo u16, own_hi u16 | tlen u16, pad u16 | g0 u32 | rlen
        const uint32_t own_hi = (uint32_t)max(L - edge - k + 1, 0);
        const uint32_t v = lane == 0 ? ((uint32_t)edge & 0xFFFFu) |
                                           (own_hi << 16)
                         : lane == 2 ? 0u : (uint32_t)L;
        o[CODE_WORDS + lane] = cov ? v : 0u;
      }
    }
    __syncthreads();      // buffer b is refilled two groups on
  }
}

}  // namespace

extern "C" int tilefeed_launch(const void* codes, const void* lens,
                               const void* idx, void* out, int B, int C,
                               int edge, int k, void* stream) {
  if (C <= 0) return 0;
  if (((uintptr_t)codes & 15u) || ((uintptr_t)out & 3u) || edge < 0 ||
      edge > 0xFFFF || k < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int ngroups = (C + RPB - 1) / RPB;
  const dim3 grid(ngroups < BLOCKS_PER_SM * sms ? ngroups
                                                : BLOCKS_PER_SM * sms);
  tile_feed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const int*)lens, (const int*)idx,
      (uint8_t*)out, B, C, edge, k);
  return (int)cudaGetLastError();
}
