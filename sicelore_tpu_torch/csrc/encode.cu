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
// uint8 and qoffs [B + 1] int64 the same for the qualities. seq and qual
// may start at any address (they are views). The offsets are int64: a
// chunk of long reads can pass 2 GiB. L = soffs[r + 1] - soffs[r] is read
// r's length, Lq its quality string's. A byte's code is utils/dna._ENC's
// with the NUL byte mapped to PAD (ops/edgescan.py _ENC_PAD0).
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
// card needs ~2.3 MB in flight to run at that rate. The design:
//   * Persistent blocks: SMs x BLOCKS_PER_SM blocks of NW warps (the SM
//     count read once a device); warp w takes the reads w, w + the grid's
//     warps, ... Lane j holds the offsets of the warp's reads j, j + 32,
//     ..., loaded 32 reads before they are needed.
//   * A ring of STAGES stages a warp in shared memory, each with an
//     mbarrier: the read's spans (the whole read when L <= 2E, else its
//     first and last E bytes; the qualities likewise from Lq), widened to
//     16-byte aligned addresses, go in by cp.async.bulk, issued by the lane
//     that holds the read's offsets, so the next STAGES - 1 reads are in
//     flight while one is mapped (~1.1 KB a read).
//   * The map works on 4-byte words in registers, a lane a word of each
//     row (152 words a row): a word of the stage at any byte offset by a
//     funnel shift; codes by three PRMT lookups keyed on each byte's low
//     nibble (its slot's letter, case mask and code) and one zero test;
//     qualities by a borrow-free byte subtraction; qsum by dp4a of the
//     masked words and one warp reduction. Columns outside the read by a
//     byte mask from one clamped funnel shift (each half's columns inside
//     the read have one bound inside the half). A stream's word pointer
//     and shift are the same for every word of a half.
//   * Rows out as each lane's words (a warp stores 128 contiguous bytes)
//     or, with ENC_BULK_STORE, from a shared row by cp.async.bulk.
// Where trouble is likely, and what the code does about it:
//   * mbarrier phases: a stage's barrier completes once a use; the wait's
//     parity flips each time the ring wraps (`ph`).
//   * expect_tx must equal the bytes copied: the sum of the widened span
//     sizes that `plan` returns, the same numbers the copies are issued
//     with.
//   * A bulk copy's size is a multiple of 16 and above 0: a span of 0
//     bytes (L = 0 or Lq = 0) issues no copy; its barrier still gets the
//     arrival (expect_tx of the other stream's bytes, or of 0).
//   * Buffer edges: a widened span may begin before seq's first byte or
//     end after its last; an aligned 16-byte group holding one of the
//     tensor's bytes lies in its page, so it cannot fault; its other bytes
//     are never used. The stage has GUARD bytes on each side, so a word
//     that straddles the read's edge reads inside it; a word wholly outside
//     (masked) may point up to E - GUARD bytes below its buffer, and the
//     block's shared memory starts with PAD_BELOW bytes for the first.
//   * Fences: the issuing lane orders the warp's earlier reads of a stage
//     before the copies that overwrite it (fence.proxy.async, after the
//     warp's __syncwarp); with ENC_BULK_STORE every lane fences its shared
//     writes before the store reads them, and a shared row is rewritten
//     only after cp.async.bulk.wait_group.read says its store has read it.
//   * Dynamic shared memory is set with cudaFuncSetAttribute, whose
//     return is checked like the launch's.
//   * The placement rule lives here, in ops/encode_cuda.py::_placed and in
//     ops/edgescan.py::encode_two_half: the tail column c >= E takes byte c
//     + L - 2E when that is >= 0; qualities by Lq, qsum masked by L; int64
//     offsets; any B.
// ENC_* macros (kernel_variants.py encode builds other values): stages,
// warps a block, blocks an SM, the copy route (bulk, or 16-byte
// ld.global.nc by the lanes), the store route and the map (words, or byte
// by byte through a table in shared memory).
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ENC_STAGES
#define ENC_STAGES 2
#endif
#ifndef ENC_WARPS
#define ENC_WARPS 8
#endif
#ifndef ENC_BLOCKS
#define ENC_BLOCKS 4
#endif
#ifndef ENC_BULK_COPY
#define ENC_BULK_COPY 1
#endif
#ifndef ENC_BULK_STORE
#define ENC_BULK_STORE 0
#endif
#ifndef ENC_WORD_MAP
#define ENC_WORD_MAP 1
#endif

namespace {

constexpr int E = 304;           // bases a half (ops/edgescan.py E)
constexpr int W2 = 2 * E;        // a row: 608 bytes
constexpr int WORDS = W2 / 4;    // 4-byte words a row
constexpr int HALF_WORDS = E / 4;
constexpr int LANE_WORDS = (WORDS + 31) / 32;
constexpr int N_CODE = 4;        // utils/dna.N_CODE
constexpr int PAD = 5;           // utils/dna.PAD
constexpr int STAGES = ENC_STAGES;
constexpr int NW = ENC_WARPS;    // warps a block
constexpr int BLOCKS_PER_SM = ENC_BLOCKS;
constexpr int TAIL_AT = 320;     // the tail span's place in a stage
constexpr int SPAN = 2 * TAIL_AT;  // a stream's bytes in a stage
constexpr int GUARD = 16;
constexpr int SBUF = SPAN + 2 * GUARD;
// shared memory below the first stage: a word wholly outside a short
// read's tail may point up to 2E - E - GUARD bytes before its buffer
constexpr int PAD_BELOW = E;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned ONES = 0x01010101u;

static_assert(W2 % 16 == 0, "rows of whole 16-byte words");
static_assert(E % 16 == 0, "no 16-byte word straddles the halves");
static_assert(E + 16 <= TAIL_AT && W2 + 16 <= SPAN,
              "a widened span fits its place in the stage");
static_assert(STAGES >= 1 && STAGES <= 32, "the ring's owners are lanes");

// The word map's tables, indexed by a byte's low nibble n (a PRMT selector:
// n >= 8 gives the sign of table byte n & 7, 0x00 or 0xFF, instead).
// A, C, T and G are the only letters of their slots (low nibbles 1, 3, 4
// and 7); a byte is its slot's letter in either case when (byte ^ LETTER)
// & CASE is 0 (CASE 0xDF clears bit 5 only); slot 0 takes the NUL byte
// (LETTER 0, CASE 0xFF), which maps to PAD; every other byte is N_CODE.
// Every LETTER byte is below 0x80 and every CASE byte above: a selector
// of 8 or more gives LETTER 0 and CASE 0xFF, a nonzero byte, N_CODE.
constexpr unsigned LETTER_LO = 'A' << 8 | 'C' << 24;
constexpr unsigned LETTER_HI = 'T' | 'G' << 24;
constexpr unsigned CASE_LO = 0xDFFFDFFFu;
constexpr unsigned CASE_HI = 0xDFFFFFDFu;
constexpr unsigned CODE_LO = PAD | 0 << 8 | N_CODE << 16 | 1 << 24;
constexpr unsigned CODE_HI = 3 | N_CODE << 8 | N_CODE << 16 | 2 << 24;
static_assert(('A' & 15) == 1 && ('C' & 15) == 3 && ('T' & 15) == 4 &&
              ('G' & 15) == 7, "the letters' slots");

__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b,
                                         unsigned s) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// four bytes to their codes
__device__ __forceinline__ unsigned code_word(unsigned w) {
  // the bytes' low nibbles as one PRMT selector
  const unsigned sel =
      prmt((w & 0x0F0F0F0Fu) | (w >> 4 & 0xF0F0F0F0u), 0u, 0x0020u);
  const unsigned y = (w ^ prmt(LETTER_LO, LETTER_HI, sel)) &
                     prmt(CASE_LO, CASE_HI, sel);
  // 0x80 in each byte of y that is 0, then 0xFF
  const unsigned z = ~(((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y) & 0x80808080u;
  const unsigned eq = prmt(z, 0u, 0xBA98u);
  return (prmt(CODE_LO, CODE_HI, sel) & eq) | (N_CODE * ONES & ~eq);
}

// four quality bytes to qv2's: (int8)(q - 33) where q >= 33, else 0.
// (q | 0x80) - 33 borrows inside no byte; its bit 7 is q >= 33 for q < 0x80,
// and flipping bit 7 back where q had none gives q - 33 (a uint8 wrap).
__device__ __forceinline__ unsigned qual_word(unsigned q) {
  const unsigned d = (q | 0x80808080u) - 33u * ONES;
  const unsigned ge = prmt(d | q, 0u, 0xBA98u);
  return (d ^ (~q & 0x80808080u)) & ge;
}

// the bytes k of the word at column c with c + k >= lo, as 0xFF (a shift
// clamped to 32 by the funnel shift)
__device__ __forceinline__ unsigned from_col(int c, int lo) {
  return __funnelshift_lc(0u, FULL, (unsigned)max(8 * (lo - c), 0));
}

// the bytes k of the word at column c with c + k < hi, as 0xFF
__device__ __forceinline__ unsigned below_col(int c, int hi) {
  return ~from_col(c, hi);
}

// A stream's bytes of one read in its stage: half h's column c lies at
// stage index base_h + c, read as word c / 4 of p[h] (base_h rounded down
// to 4 bytes) shifted right by sh[h] bits. base_h + c < 0 only for a word
// wholly outside the read (masked), and never below -PAD_BELOW.
struct Stage {
  const unsigned* p[2];
  unsigned sh[2];
};

__device__ __forceinline__ Stage stage_of(const uint8_t* buf, int b0,
                                          int b1) {
  Stage g;
  g.p[0] = reinterpret_cast<const unsigned*>(buf + (b0 & ~3));
  g.p[1] = reinterpret_cast<const unsigned*>(buf + (b1 & ~3));
  g.sh[0] = 8u * (b0 & 3);
  g.sh[1] = 8u * (b1 & 3);
  return g;
}

__device__ __forceinline__ unsigned stage_word(const Stage& g, bool h,
                                               int t) {
  const unsigned* p = h ? g.p[1] : g.p[0];
  return __funnelshift_r(p[t], p[t + 1], h ? g.sh[1] : g.sh[0]);
}

#if !ENC_WORD_MAP
// the map byte by byte: utils/dna._ENC with NUL as PAD through a table
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

__device__ __forceinline__ unsigned code_word_bytes(const uint8_t* tab,
                                                    unsigned w) {
  return tab[w & 255u] | tab[w >> 8 & 255u] << 8 |
         tab[w >> 16 & 255u] << 16 | (unsigned)tab[w >> 24] << 24;
}

__device__ __forceinline__ unsigned qual_word_bytes(unsigned q) {
  unsigned v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned b = q >> 8 * k & 255u;
    v |= (b >= 33u ? (b - 33u) & 255u : 0u) << 8 * k;
  }
  return v;
}
#endif

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, unsigned long long src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

#if ENC_BULK_STORE
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}
#endif

// A stream's spans of one read: the whole read [x0, x0 + n) when n <= 2E,
// else its head [x0, x0 + E) and tail [x0 + n - E, x0 + n), each widened to
// 16-byte aligned addresses. Returns the read's stage key: min(n, 2E + 1),
// the head's offset in its first 16 bytes (bits 16-19) and the tail's
// (bits 20-23).
struct Spans {
  unsigned long long src[2];
  unsigned size[2];
};

__device__ __forceinline__ int plan(const uint8_t* buf, long long x0,
                                    long long n, Spans& s) {
  const unsigned long long a = (unsigned long long)(buf + x0);
  const unsigned oh = (unsigned)(a & 15u);
  s.src[0] = a - oh;
  if (n <= W2) {
    s.size[0] = n ? (unsigned)(((a + n + 15u) & ~15ull) - s.src[0]) : 0u;
    s.src[1] = 0;
    s.size[1] = 0;
    return (int)n | (int)(oh << 16);
  }
  const unsigned long long t = a + n - E;
  const unsigned ot = (unsigned)(t & 15u);
  s.size[0] = (unsigned)(((a + E + 15u) & ~15ull) - s.src[0]);
  s.src[1] = t - ot;
  s.size[1] = (unsigned)(((t + E + 15u) & ~15ull) - s.src[1]);
  return (W2 + 1) | (int)(oh << 16 | ot << 20);
}

struct __align__(16) Warp {
  uint8_t in[STAGES][2][SBUF];   // a read's sequence and quality bytes
#if ENC_BULK_STORE
  uint8_t out[2][2][W2];         // two reads' codes and qv rows
#endif
  unsigned long long bar[STAGES];
  int2 key[STAGES];              // plan's keys: sequence, qualities
};

// The offsets of the warp's reads that lane j stages: j, j + 32, ...
struct Offsets {
  long long s0, L, q0, Lq;
};

__device__ __forceinline__ void fetch(Offsets& o, long long n, long long nr,
                                      long long w0, long long gw,
                                      const long long* __restrict__ soffs,
                                      const long long* __restrict__ qoffs) {
  if (n >= nr) return;
  const long long r = w0 + n * gw;
  o.s0 = soffs[r];
  o.L = soffs[r + 1] - o.s0;
  o.q0 = qoffs[r];
  o.Lq = qoffs[r + 1] - o.q0;
}

// Stage the warp's read n (held by lane `owner`) into stage s. Every lane
// of the warp calls it.
__device__ __forceinline__ void stage(Warp& w, int s, int lane, int owner,
                                      Offsets& o, const uint8_t* seq,
                                      const uint8_t* qual) {
  Spans sp[2] = {};
  int2 key = make_int2(0, 0);
  if (lane == owner) {
    key.x = plan(seq, o.s0, o.L, sp[0]);
    key.y = plan(qual, o.q0, o.Lq, sp[1]);
    w.key[s] = key;
  }
#if ENC_BULK_COPY
  if (lane != owner) return;
  fence_proxy_async();
  bar_expect(&w.bar[s], sp[0].size[0] + sp[0].size[1] + sp[1].size[0] +
                            sp[1].size[1]);
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (sp[x].size[h])
        bulk_load(w.in[s][x] + GUARD + h * TAIL_AT, sp[x].src[h],
                  sp[x].size[h], &w.bar[s]);
#else
  // every lane copies 16-byte words of the owner's spans
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned long long src = __shfl_sync(FULL, sp[x].src[h], owner);
      const unsigned n = __shfl_sync(FULL, sp[x].size[h], owner);
      uint4* dst = reinterpret_cast<uint4*>(w.in[s][x] + GUARD + h * TAIL_AT);
      for (unsigned k = (unsigned)lane; k < n / 16; k += 32)
        dst[k] = __ldg(reinterpret_cast<const uint4*>(src) + k);
    }
  __syncwarp();
#endif
}

template <bool TWO_HALF>
__global__ void __launch_bounds__(NW * 32, BLOCKS_PER_SM)
encode_kernel(const uint8_t* __restrict__ seq,
              const long long* __restrict__ soffs,
              const uint8_t* __restrict__ qual,
              const long long* __restrict__ qoffs,
              unsigned* __restrict__ codes, unsigned* __restrict__ qv,
              int* __restrict__ qsum, int B) {
  extern __shared__ __align__(16) uint8_t smem[];
#if ENC_WORD_MAP
  Warp* warps = reinterpret_cast<Warp*>(smem + PAD_BELOW);
#else
  uint8_t* tab = smem + PAD_BELOW;
  for (int b = threadIdx.x; b < 256; b += blockDim.x) tab[b] = code_of(b);
  __syncthreads();
  Warp* warps = reinterpret_cast<Warp*>(smem + PAD_BELOW + 256);
#endif
  const int lane = threadIdx.x & 31;
  Warp& w = warps[threadIdx.x >> 5];
  const long long gw = (long long)gridDim.x * NW;
  const long long w0 = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  if (w0 >= B) return;               // a whole warp: no barrier follows
  const long long nr = (B - 1 - w0) / gw + 1;   // the warp's reads
  if (lane == 0) {
    for (int s = 0; s < STAGES; ++s) bar_init(&w.bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  Offsets o;
  fetch(o, lane, nr, w0, gw, soffs, qoffs);
  for (int n = 0; n < STAGES && n < nr; ++n) {
    stage(w, n, lane, n, o, seq, qual);
    if (lane == n) fetch(o, n + 32, nr, w0, gw, soffs, qoffs);
  }
  int s = 0;
  unsigned ph = 0;
#if ENC_BULK_STORE
  int ob = 0;
#endif
  for (long long n = 0; n < nr; ++n) {
    const long long r = w0 + n * gw;
#if ENC_BULK_COPY
    bar_wait(&w.bar[s], ph);
#endif
    const int2 key = w.key[s];
    // a stream's stage index of column c is base_h + c in half h; its
    // columns inside the read are [0, hi0) and [lo1, hi1)
    const int n_s = key.x & 0xFFFF, n_q = key.y & 0xFFFF;
    const int oh_s = key.x >> 16 & 15, ot_s = key.x >> 20 & 15;
    const int oh_q = key.y >> 16 & 15, ot_q = key.y >> 20 & 15;
    const int sb0 = GUARD + oh_s, qb0 = GUARD + oh_q;
    // half 0's columns inside the read: c < sc0; half 1's: c >= sc1 (two
    // half rows) or c < sc1 (composite rows); the qualities' likewise
    int sb1, qb1, sc1, qc1;
    if (TWO_HALF) {
      sb1 = n_s > W2 ? GUARD + TAIL_AT + ot_s - E : sb0 + n_s - W2;
      qb1 = n_q > W2 ? GUARD + TAIL_AT + ot_q - E : qb0 + n_q - W2;
      sc1 = max(E, W2 - n_s);
      qc1 = max(E, W2 - n_q);
    } else {
      sb1 = n_s > W2 ? GUARD + TAIL_AT + ot_s - E : sb0;
      qb1 = n_q > W2 ? GUARD + TAIL_AT + ot_q - E : qb0;
      sc1 = min(n_s, W2);
      qc1 = min(n_q, W2);
    }
    const int sc0 = min(n_s, E), qc0 = min(n_q, E);
    // qsum's columns: the head part of the read (half 0's columns), and
    // the tail columns of the bases the head does not hold (n_s is at most
    // 2E + 1)
    const int uc1 = max(E, 3 * E - n_s);
    const Stage sg = stage_of(w.in[s][0], sb0, sb1);
    const Stage qg = stage_of(w.in[s][1], qb0, qb1);
#if ENC_BULK_STORE
    if (lane == 0)
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncwarp();
    unsigned* oc = reinterpret_cast<unsigned*>(w.out[ob][0]);
    unsigned* oq = reinterpret_cast<unsigned*>(w.out[ob][1]);
#else
    unsigned* oc = codes + r * WORDS;
    unsigned* oq = qv + r * WORDS;
#endif
    int acc = 0;
#pragma unroll
    for (int k = 0; k < LANE_WORDS; ++k) {
      const int t = lane + 32 * k;
      if (t < WORDS) {
        const int c = 4 * t;
        const bool h = t >= HALF_WORDS;
        const unsigned sw = stage_word(sg, h, t);
        const unsigned qw = stage_word(qg, h, t);
        const unsigned sin = !h ? below_col(c, sc0)
                             : TWO_HALF ? from_col(c, sc1) : below_col(c, sc1);
        const unsigned qin = !h ? below_col(c, qc0)
                             : TWO_HALF ? from_col(c, qc1) : below_col(c, qc1);
#if ENC_WORD_MAP
        const unsigned cw = (code_word(sw) & sin) | (PAD * ONES & ~sin);
        const unsigned vw = qual_word(qw) & qin;
#else
        const unsigned cw =
            (code_word_bytes(tab, sw) & sin) | (PAD * ONES & ~sin);
        const unsigned vw = qual_word_bytes(qw) & qin;
#endif
        if (TWO_HALF)
          acc = __dp4a((int)(vw & (h ? from_col(c, uc1) : sin)), (int)ONES,
                       acc);
        oc[t] = cw;
        oq[t] = vw;
      }
    }
    if (TWO_HALF) {
      acc = __reduce_add_sync(FULL, acc);
      if (lane == 0) qsum[r] = acc;
    }
#if ENC_BULK_STORE
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      bulk_store(codes + r * WORDS, oc, W2);
      bulk_store(qv + r * WORDS, oq, W2);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    ob ^= 1;
#else
    __syncwarp();
#endif
    const long long nx = n + STAGES;   // into the stage just read
    if (nx < nr) {
      const int owner = (int)(nx & 31);
      stage(w, s, lane, owner, o, seq, qual);
      if (lane == owner) fetch(o, nx + 32, nr, w0, gw, soffs, qoffs);
    }
    if (++s == STAGES) {
      s = 0;
      ph ^= 1u;
    }
  }
#if ENC_BULK_STORE
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
#endif
}

constexpr size_t SMEM =
    PAD_BELOW + (ENC_WORD_MAP ? 0 : 256) + NW * sizeof(Warp);
static_assert(PAD_BELOW % 16 == 0, "stages on 16-byte boundaries");

// the SM count of the current device (the wrapper makes the tensors'
// device current), queried once a device
int sm_count(int* sms) {
  static int sms_of[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  *sms = sms_of[dev];
  return 0;
}

template <bool TWO_HALF>
int launch(const void* seq, const void* soffs, const void* qual,
           const void* qoffs, void* codes, void* qv, void* qsum, int B,
           void* stream) {
  if (B <= 0) return 0;
  if (((uintptr_t)soffs & 7u) || ((uintptr_t)qoffs & 7u) ||
      ((uintptr_t)codes & 15u) || ((uintptr_t)qv & 15u) ||
      ((uintptr_t)qsum & 3u))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  int e = sm_count(&sms);
  if (e) return e;
  const long long need = ((long long)B + NW - 1) / NW;
  const int grid = (int)(need < (long long)sms * BLOCKS_PER_SM
                             ? need
                             : (long long)sms * BLOCKS_PER_SM);
  auto kernel = encode_kernel<TWO_HALF>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NW * 32, SMEM, (cudaStream_t)stream>>>(
      (const uint8_t*)seq, (const long long*)soffs, (const uint8_t*)qual,
      (const long long*)qoffs, (unsigned*)codes, (unsigned*)qv, (int*)qsum,
      B);
  return (int)cudaGetLastError();
}

}  // namespace

// codes [B, 2E] int8, qv2 [B, 2E] int8, qsum [B] int32 of the v2 passes
extern "C" int encode_two_half_launch(const void* seq, const void* soffs,
                                      const void* qual, const void* qoffs,
                                      void* codes, void* qv2, void* qsum,
                                      int B, void* stream) {
  if (qsum == nullptr) return (int)cudaErrorInvalidValue;
  return launch<true>(seq, soffs, qual, qoffs, codes, qv2, qsum, B, stream);
}

// codes [B, 2E] int8, qv [B, 2E] int8 of the v1 composite scan
extern "C" int encode_composite_launch(const void* seq, const void* soffs,
                                       const void* qual, const void* qoffs,
                                       void* codes, void* qv, int B,
                                       void* stream) {
  return launch<false>(seq, soffs, qual, qoffs, codes, qv, nullptr, B,
                       stream);
}

// The warps of a full grid on the current device (SMs x BLOCKS_PER_SM x
// NW): a launch of more reads gives a warp several. A negative value is a
// cudaError.
extern "C" int encode_grid_warps(void) {
  int sms = 0;
  const int e = sm_count(&sms);
  return e ? -e : sms * BLOCKS_PER_SM * NW;
}

// The dynamic shared memory of a block, bytes.
extern "C" int encode_shared_bytes(void) { return (int)SMEM; }
