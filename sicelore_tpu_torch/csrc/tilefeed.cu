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
// outside the read), contiguous and 16-byte aligned, and lens [B] int32.
// Output: [B, 528] uint8 rows in models/readscan.py::build_tiles' layout, one
// a read in read order. A read with min_len < L <= 2E (min_len = 2 edge + k)
// gets the one tile build_tiles writes for it (g0 = 0): code j < E is
// codes[j], E <= j < L is codes[j + 2E - L], every j >= L is PAD, a PAD code
// inside the read (a NUL byte, which build_tiles encodes as N) is N; meta
// own_lo = edge, own_hi = max(L - edge - k + 1, 0), tlen = L, g0 = 0,
// rlen = L. Every other read gets an inert row: PAD codes and zero meta, so
// the scan reports n = 0 for it.
//
// What bounds it on the H100: bytes. It computes nothing but addresses: the
// least time is the bytes over 3.35 TB/s, the covered reads' L code bytes
// and every length read, every output row written (~0.007 ms for a
// 32,768-read chunk of chip_smoke.py's mix). The design:
//   * A block takes RPB = 32 reads. It reads their lengths first, then
//     stages into shared memory, with 16-byte loads, only the 16-byte
//     pieces of their rows that a covered read's tile reads (an inert read
//     stages nothing, and the PAD middle of a covered read is skipped).
//   * The shift is applied in shared memory: each thread builds one 32-bit
//     output word (8 codes) at a time, reading code j of row r from the
//     staged row at j (head) or j + 2E - L (tail). A warp's 32 words are
//     128 contiguous bytes of the output, so every store fills whole
//     sectors, and its lanes read shared memory 8 bytes apart (two-way bank
//     conflicts, where a thread a 16-byte piece would read 32 apart).
#include <stdint.h>

namespace {

constexpr int E = 304;                  // ops/edgescan.py E
constexpr int E2 = 2 * E;               // 608 = 38 x 16 bytes a code row
constexpr int TILE = 1024;
constexpr int ROW = TILE / 2 + 16;      // 528 bytes a tile row
constexpr int WORDS = ROW / 4;          // 132 output words a row
constexpr int CODE_WORDS = TILE / 8;    // 128 of them hold codes
constexpr int PIECES = E2 / 16;         // 38 staged pieces a row
constexpr int RPB = 32;                 // reads a block
constexpr int THREADS = 256;
constexpr uint32_t N_CODE = 4, PAD = 5;

__device__ __forceinline__ bool covered(int L, int min_len) {
  return L > min_len && L <= E2;
}

__global__ void __launch_bounds__(THREADS)
tile_feed_kernel(const int8_t* __restrict__ codes,
                 const int* __restrict__ lens, uint8_t* __restrict__ out,
                 int B, int edge, int k) {
  __shared__ uint4 raw[RPB * PIECES];
  __shared__ int len_s[RPB];
  const int r0 = blockIdx.x * RPB;
  const int nr = min(RPB, B - r0);
  const int min_len = 2 * edge + k;
  if (threadIdx.x < nr) len_s[threadIdx.x] = lens[r0 + threadIdx.x];
  __syncthreads();

  // stage the pieces a covered read's tile reads: columns [0, min(L, E))
  // and [3E - L, 2E)
  const uint4* src = reinterpret_cast<const uint4*>(codes + (size_t)r0 * E2);
  for (int i = threadIdx.x; i < nr * PIECES; i += THREADS) {
    const int r = i / PIECES, c0 = 16 * (i - r * PIECES);
    const int L = len_s[r];
    if (covered(L, min_len) && (c0 < min(L, E) || c0 + 16 > 3 * E - L))
      raw[i] = src[i];
  }
  __syncthreads();

  const uint8_t* rb = reinterpret_cast<const uint8_t*>(raw);
  uint32_t* o = reinterpret_cast<uint32_t*>(out + (size_t)r0 * ROW);
  for (int q = threadIdx.x; q < nr * WORDS; q += THREADS) {
    const int r = q / WORDS, w = q - r * WORDS;
    const int L = len_s[r];
    const bool cov = covered(L, min_len);
    uint32_t v = 0;
    if (w < CODE_WORDS) {
      const int j0 = 8 * w;
      if (!cov || j0 >= L) {
        v = 0x55555555u;                       // PAD | PAD in every byte
      } else {
        const uint8_t* row = rb + r * E2;
        const int sh = E2 - L;                 // tail column - tile column
#pragma unroll
        for (int b = 0; b < 4; b++) {
          uint32_t byte = 0;
#pragma unroll
          for (int h = 0; h < 2; h++) {
            const int j = j0 + 2 * b + h;
            uint32_t c = PAD;
            if (j < L) {
              c = row[j < E ? j : j + sh];
              c = c == PAD ? N_CODE : c;
            }
            byte = (byte << 4) | c;            // high nibble first
          }
          v |= byte << (8 * b);                // little-endian bytes
        }
      }
    } else if (cov) {
      // meta: own_lo u16, own_hi u16 | tlen u16, pad u16 | g0 u32 | rlen u32
      const int m = w - CODE_WORDS;
      const uint32_t own_hi = (uint32_t)max(L - edge - k + 1, 0);
      v = m == 0 ? ((uint32_t)edge & 0xFFFFu) | (own_hi << 16)
        : m == 1 ? (uint32_t)L
        : m == 3 ? (uint32_t)L : 0u;
    }
    o[q] = v;
  }
}

}  // namespace

extern "C" int tilefeed_launch(const void* codes, const void* lens, void* out,
                               int B, int edge, int k, void* stream) {
  if (B <= 0) return 0;
  if (((uintptr_t)codes & 15u) || ((uintptr_t)out & 3u) || edge < 0 ||
      edge > 0xFFFF || k < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + RPB - 1) / RPB);
  tile_feed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const int*)lens, (uint8_t*)out, B, edge, k);
  return (int)cudaGetLastError();
}
