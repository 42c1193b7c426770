// Step 1's read encoding on the card: a chunk's raw sequence and quality
// bytes to the int8 rows the scans read, one launch a chunk (or a shard).
//
// Replaces the JAX main path's encoder route, which is not a Pallas
// kernel: the native host encoder under sicelore_tpu/ops/edgescan.py::
// encode_composite_tm (:81-98, native/hostenc) and the device decode
// unpack_tm (:147) inside the scan body; for the v1 scan,
// sicelore_tpu/models/readscan.py::encode_composite_2bit (:742) and
// unpack_2bit (:734). The host here only joins the bytes; nothing loops
// over a read's bytes there.
//
// Inputs (both entries): seq [S] uint8, the chunk's sequences joined, and
// soffs [B + 1] int64, their offsets (non-decreasing from 0 to S); qual [Q]
// uint8 and qoffs [B + 1] int64 the same for the qualities. The offsets are
// int64: a chunk of long reads can pass 2 GiB. L = soffs[r + 1] - soffs[r]
// is read r's length, Lq its quality string's. Bytes map through a table in
// shared memory, the kernel's copy of utils/dna._ENC with the NUL byte
// mapped to PAD (ops/edgescan.py _ENC_PAD0).
//
// encode_two_half_launch (the v2 passes) writes, byte for byte as
// ops/edgescan.py::encode_two_half:
//   codes [B, 2E] int8: head column c < E takes byte c when c < L; tail
//     column c >= E takes byte c + L - 2E when that is >= 0 (the read's last
//     min(L, E) bases end at column 2E - 1); every other cell is PAD.
//   qv2 [B, 2E] int8: the quality bytes placed the same way from Lq, each
//     (int8)(q - 33) when q >= 33 (wrapping above 160), else 0; 0 outside
//     the quality string.
//   qsum [B] int32: the signed sum of qv2 over the columns c < min(L, E)
//     or c >= 2E - max(L - E, 0), masked by the SEQUENCE's length.
// encode_composite_launch (the v1 scan_reads) writes codes and qv [B, 2E]
// as models/readscan.py::encode_composite: column c takes byte c, shifted
// by L - 2E in the second half of a read longer than 2E; PAD (codes) and 0
// (qv) past the read.
//
// What bounds it on the H100: bytes. It reads each read's first and last
// 2E bases and qualities at most and writes 2 x 2E + 4 bytes a read: for
// a 32,768-read chunk about 37 MB in and 40 MB out, 0.023 ms of HBM. The
// design (a simple kernel first):
//   * One warp a read, 8 reads a block. A lane takes the columns lane,
//     lane + 32, ...: neighbouring lanes read neighbouring bytes of the
//     read's head span, then of its tail span (coalesced byte loads, any
//     alignment), and map each through the block's byte table.
//   * The warp builds its read's two rows in shared memory, then stores
//     them with 16-byte stores (a row is 38 of them; rows are 16-byte
//     aligned because 2E is a multiple of 16 and the outputs are).
//   * qsum: each lane sums its columns, a warp shuffle adds the lanes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int E = 304;           // bases a half (ops/edgescan.py E)
constexpr int W2 = 2 * E;        // a row: 608 bytes
constexpr int VEC = W2 / 16;     // 16-byte words a row
constexpr int N_CODE = 4;        // utils/dna.N_CODE
constexpr int PAD = 5;           // utils/dna.PAD
constexpr int NW = 8;            // warps a block, a read each
constexpr unsigned FULL = 0xFFFFFFFFu;

static_assert(W2 % 16 == 0, "rows of whole 16-byte words");

// utils/dna._ENC: A, C, G, T and a, c, g, t -> 0..3, every other byte 4;
// the NUL byte is PAD, as ops/edgescan.py _ENC_PAD0. Byte c of BASES is
// base c in upper case; b & 0xDF clears bit 5 only, so it maps exactly the
// two cases together.
constexpr unsigned BASES = 'A' | 'C' << 8 | 'G' << 16 | 'T' << 24;

__device__ __forceinline__ uint8_t code_of(unsigned b) {
  if (b == 0u) return PAD;
  const unsigned u = b & 0xDFu;
  return u == (BASES & 0xFFu)           ? 0
         : u == (BASES >> 8 & 0xFFu)    ? 1
         : u == (BASES >> 16 & 0xFFu)   ? 2
         : u == BASES >> 24             ? 3
                                        : N_CODE;
}

// a quality byte as the phred int8 of qv2: (int8)(q - 33), 0 below '!'
__device__ __forceinline__ int8_t phred(unsigned q) {
  return q >= 33u ? (int8_t)(uint8_t)(q - 33u) : (int8_t)0;
}

struct __align__(16) Smem {
  uint8_t tab[256];              // byte -> code
  uint8_t row[NW][2][W2];        // each warp's read: codes, qualities
};

template <bool TWO_HALF>
__global__ void __launch_bounds__(NW * 32)
encode_kernel(const uint8_t* __restrict__ seq,
              const long long* __restrict__ soffs,
              const uint8_t* __restrict__ qual,
              const long long* __restrict__ qoffs,
              uint4* __restrict__ codes, uint4* __restrict__ qv,
              int* __restrict__ qsum, int B) {
  __shared__ Smem sm;
  for (int b = threadIdx.x; b < 256; b += blockDim.x) sm.tab[b] = code_of(b);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * NW + warp;
  if (r >= B) return;            // a whole warp: no barrier follows
  const long long s0 = soffs[r], L = soffs[r + 1] - s0;
  const long long q0 = qoffs[r], Lq = qoffs[r + 1] - q0;
  uint8_t* rc = sm.row[warp][0];
  uint8_t* rq = sm.row[warp][1];
  // qsum's columns: the head part of the read, and the tail columns of
  // the bases the head does not hold
  const long long hl = L < E ? L : E;
  const long long tail0 = W2 - (L > E ? L - E : 0);
  int acc = 0;
  for (int c = lane; c < W2; c += 32) {
    long long s, q;
    bool ok, qok;
    if (TWO_HALF) {
      s = c < E ? c : c + L - W2;
      q = c < E ? c : c + Lq - W2;
      ok = c < E ? c < L : s >= 0;
      qok = c < E ? c < Lq : q >= 0;
    } else {
      s = c + (c >= E && L > W2 ? L - W2 : 0);
      q = c + (c >= E && Lq > W2 ? Lq - W2 : 0);
      ok = c < L;
      qok = c < Lq;
    }
    rc[c] = ok ? sm.tab[__ldg(seq + s0 + s)] : (uint8_t)PAD;
    const int8_t v = qok ? phred(__ldg(qual + q0 + q)) : (int8_t)0;
    rq[c] = (uint8_t)v;
    if (TWO_HALF && (c < hl || c >= tail0)) acc += v;
  }
  __syncwarp();
  const uint4* wc = reinterpret_cast<const uint4*>(rc);
  const uint4* wq = reinterpret_cast<const uint4*>(rq);
  for (int t = lane; t < 2 * VEC; t += 32) {
    if (t < VEC)
      codes[r * VEC + t] = wc[t];
    else
      qv[r * VEC + t - VEC] = wq[t - VEC];
  }
  if (TWO_HALF) {
    for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (lane == 0) qsum[r] = acc;
  }
}

int launch(bool two_half, const void* seq, const void* soffs,
           const void* qual, const void* qoffs, void* codes, void* qv,
           void* qsum, int B, void* stream) {
  if (B <= 0) return 0;
  if (((uintptr_t)soffs & 7u) || ((uintptr_t)qoffs & 7u) ||
      ((uintptr_t)codes & 15u) || ((uintptr_t)qv & 15u) ||
      ((uintptr_t)qsum & 3u))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((B + NW - 1) / NW);
  if (two_half)
    encode_kernel<true><<<grid, NW * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)seq, (const long long*)soffs, (const uint8_t*)qual,
        (const long long*)qoffs, (uint4*)codes, (uint4*)qv, (int*)qsum, B);
  else
    encode_kernel<false><<<grid, NW * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)seq, (const long long*)soffs, (const uint8_t*)qual,
        (const long long*)qoffs, (uint4*)codes, (uint4*)qv, nullptr, B);
  return (int)cudaGetLastError();
}

}  // namespace

// codes [B, 2E] int8, qv2 [B, 2E] int8, qsum [B] int32 of the v2 passes
extern "C" int encode_two_half_launch(const void* seq, const void* soffs,
                                      const void* qual, const void* qoffs,
                                      void* codes, void* qv2, void* qsum,
                                      int B, void* stream) {
  if (qsum == nullptr) return (int)cudaErrorInvalidValue;
  return launch(true, seq, soffs, qual, qoffs, codes, qv2, qsum, B, stream);
}

// codes [B, 2E] int8, qv [B, 2E] int8 of the v1 composite scan
extern "C" int encode_composite_launch(const void* seq, const void* soffs,
                                       const void* qual, const void* qoffs,
                                       void* codes, void* qv, int B,
                                       void* stream) {
  return launch(false, seq, soffs, qual, qoffs, codes, qv, nullptr, B,
                stream);
}
