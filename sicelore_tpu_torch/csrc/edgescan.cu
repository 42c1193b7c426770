// Two-half edge scan: two threads a read, in two warps of one block.
//
// Replaces the Pallas TPU kernel sicelore_tpu/ops/edgescan_tpu.py::_edge_kernel
// and computes, per read, what the two-half body ops/edgescan.py::_edge_body
// computes, for 3p and for 5p chemistry: polyT head / polyA tail run
// detection and tightening; the sense adapter searches; the complete adapter
// search with its longest consecutive-match run; the TSO search with its
// two-best bailout; strand choice; half-local coordinates; the BC window and
// its 16-mer kmer. Output rows [n_rows, B] int32 (ops/edgescan.py ROW_*).
//
// Input: the rows of encode_two_half as they are, row-major [B, 2E] int8
// (head columns, then the right-aligned tail columns; codes 0..5, PAD
// outside the read), 16-byte aligned, and lens [B]. N and PAD match no
// pattern base, so reads with N need no second pass.
//
// What bounds it on the H100: the integer issue rate. A read needs its two
// run scans up to where they stop (a few 32-column words each), up to four
// Myers searches over the window columns inside the read (18 operations a
// column), the complete adapter's longest run and the TSO bailout's run
// thresholds: for 32,768 synthetic reads 7.5k (3p) and 12.4k (5p)
// operations a read, 0.0074 and 0.0122 ms at the card's 33.45 Tops/s,
// against ~0.004 ms of HBM time for the ~12.8 MB that work reads
// (chip_smoke.py BOUNDS). The design:
//   * Staging: a block's NR reads are one contiguous span of NR x 608 bytes
//     (608 = 38 x 16). Every thread issues its 16-byte loads into registers,
//     then stores them, then one barrier. The tail half lands reversed (the
//     read end first): every window of the edge scan is then a sense window
//     of the head or of the reversed tail (a tail window is complemented
//     through its own match-mask table), and the polyA scan of the tail is
//     the polyT scan of the head, mirrored. Rows sit at a stride of 624
//     bytes, so eight lanes' 16-byte loads of one column hit distinct banks.
//   * Two threads a read, in different warps (no divergence between them):
//     the REV side (warps 0..NR/32-1) scans the head for polyT and searches
//     the REV adapter window; the FWD side scans the reversed tail for polyA
//     and searches the FWD adapter window. One barrier exchanges the
//     results; both sides choose the strand; then the REV side runs the
//     complete adapter search with its longest run in one pass over the
//     chosen window, and the FWD side the TSO search with its bailout in one
//     pass. 32,768 reads are 2,048 warps: 16 warps an SM.
//   * Scans in words: 32 columns a word, the base mask from four codes a
//     32-bit load, the k-window counts bit-sliced (trailing sums of 1, 2, 4,
//     8, 16 columns by doubling, the previous word's planes shifted in),
//     walked word by word from the read end inward and stopped where the run
//     (or the search region) ends.
//   * Windows four codes a word: an aligned shared word and a funnel shift,
//     two codes' match masks from one 8-byte load of a 64-entry pair table,
//     the pattern in the top bits of the word (the score's step is a sign
//     bit), the best (score, first column) as one integer key. Only the
//     window columns inside the read are walked: a column outside holds PAD,
//     which before the first code leaves every state as it is and after the
//     last can lower no score, lengthen no run and reach no threshold.
//   * One match mask a column feeds both chains of a pass: the complete
//     adapter's longest run is a bit-sliced counter per pattern row (five
//     planes, reset where the column does not match), tested against the
//     best so far plus one (the best grows by at most one a column); the
//     TSO bailout keeps threshold words R_l (rows whose run reaches l, l <=
//     c1: R_l = eq & R_{l-1} << 1) and the first column of each pair's
//     second threshold.
#include <stdint.h>
#include <string.h>

#include "myers.cuh"

namespace {

using sic::PAD;

constexpr int E = 304;                  // ops/edgescan.py E
constexpr int ROWB = 2 * E;             // 608 bytes a read row
constexpr int RS = ROWB + 16;           // staged row stride (624 = 39 x 16)
constexpr int NR = 64;                  // reads a block
constexpr int THREADS = 2 * NR;         // two threads a read (one a side)
constexpr int NV = (NR * ROWB / 16 + THREADS - 1) / THREADS;
constexpr int NW = (E + 31) / 32;       // 32-column words a half
constexpr int BIG = 1000000000;
constexpr int ED_SENTINEL = 16384;
constexpr int MAXP = 16;                // bailout threshold pairs
constexpr int MAXL = 16;                // bailout threshold levels (c1 <= 16)
constexpr int NROW_META = 14;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned KEY = 1u << 16;      // best = score x KEY + column

// Field order is the int32 parameter array built by ops/edgescan_cuda.py.
struct EdgeParams {
  int E, k, mc, win_p, awin, twin, m_ad, m_adc, m_tso, mm_ad, mm_tso,
      off_tso, c1, npairs, pad, bc_len, bw, n_rows, is5p, c2;
  unsigned peq_ad[4], peq_adc[4], peq_tso[4];
  int pair_x[MAXP], pair_y[MAXP];
};

// ---- scans in words ----

// Bit n set iff byte n of v (a code < 8) differs from the base in every
// byte of base4.
__device__ __forceinline__ unsigned differs4(unsigned v, unsigned base4) {
  return ((((v ^ base4) + 0x7F7F7F7Fu) & 0x80808080u) * 0x00204081u) >> 28;
}

// Bits i of word w with lo <= 32 w + i < hi.
__device__ __forceinline__ unsigned span_mask(int lo, int hi, int w) {
  const int a = min(max(lo - 32 * w, 0), 32);
  const int b = min(max(hi - 32 * w, 0), 32);
  const unsigned below_b = b >= 32 ? FULL : ((1u << b) - 1u);
  const unsigned below_a = a >= 32 ? FULL : ((1u << a) - 1u);
  return below_b & ~below_a;
}

// The base mask of columns 32 w .. 32 w + 31 of a staged half, columns at
// or past hl cleared (the half's bytes past E are not its own).
__device__ __forceinline__ unsigned mask_word(const uint8_t* h, int w,
                                              unsigned base4, int hl) {
  const uint4* q = reinterpret_cast<const uint4*>(h + 32 * w);
  const uint4 a = q[0], b = q[1];
  const unsigned nz = differs4(a.x, base4) | differs4(a.y, base4) << 4 |
                      differs4(a.z, base4) << 8 | differs4(a.w, base4) << 12 |
                      differs4(b.x, base4) << 16 | differs4(b.y, base4) << 20 |
                      differs4(b.z, base4) << 24 | differs4(b.w, base4) << 28;
  return ~nz & span_mask(0, hl, w);
}

// r = d + d shifted up by s columns (the previous word's d below bit s).
template <int N>
__device__ __forceinline__ void dbl(const unsigned (&d)[N],
                                    const unsigned (&p)[N], int s,
                                    unsigned (&r)[N + 1]) {
  unsigned c = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const unsigned x = d[i], y = __funnelshift_l(p[i], d[i], s);
    r[i] = x ^ y ^ c;
    c = (x & y) | (c & (x ^ y));
  }
  r[N] = c;
}

// acc (5 planes) += d shifted up by o columns.
template <int N>
__device__ __forceinline__ void acc_add(unsigned (&acc)[5],
                                        const unsigned (&d)[N],
                                        const unsigned (&p)[N], int o) {
  unsigned c = 0u;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const unsigned x = acc[i];
    const unsigned y = i < N ? __funnelshift_l(p[i], d[i], o) : 0u;
    acc[i] = x ^ y ^ c;
    c = (x & y) | (c & (x ^ y));
  }
}

// The previous word's planes: trailing sums of 1, 2, 4, 8 columns.
struct Trail {
  unsigned p0[1], p1[2], p2[3], p3[4];
};

// Bit i set iff the k columns ending at column 32 w + i (this word's x and
// the previous words') hold >= mc set bits (k <= 31). KC, MC: k and mc when
// known at compile time (0: take kr, mcr); then every branch folds.
template <int KC, int MC>
__device__ __forceinline__ unsigned pass_end(unsigned x, Trail& T, int kr,
                                             int mcr) {
  const int k = KC ? KC : kr, mc = KC ? MC : mcr;
  unsigned d0[1] = {x}, d1[2] = {}, d2[3] = {}, d3[4] = {}, d4[5] = {};
  if (k >= 2) dbl(d0, T.p0, 1, d1);
  if (k >= 4) dbl(d1, T.p1, 2, d2);
  if (k >= 8) dbl(d2, T.p2, 4, d3);
  if (k >= 16) dbl(d3, T.p3, 8, d4);
  unsigned acc[5] = {0u, 0u, 0u, 0u, 0u};
  int o = 0;
  if (k & 16) { acc_add(acc, d4, d4, 0); o = 16; }
  if (k & 8) { acc_add(acc, d3, T.p3, o); o += 8; }
  if (k & 4) { acc_add(acc, d2, T.p2, o); o += 4; }
  if (k & 2) { acc_add(acc, d1, T.p1, o); o += 2; }
  if (k & 1) acc_add(acc, d0, T.p0, o);
  T.p0[0] = d0[0];
#pragma unroll
  for (int i = 0; i < 2; ++i) T.p1[i] = d1[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) T.p2[i] = d2[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) T.p3[i] = d3[i];
  // acc >= mc  <=>  acc + (32 - mc) carries out of five bits
  const int c = 32 - mc;
  unsigned carry = 0u;
#pragma unroll
  for (int i = 0; i < 5; ++i)
    carry = ((c >> i) & 1) ? (acc[i] | carry) : (acc[i] & carry);
  return carry;
}

// polyat_find of one staged half, read from its read end (the head as it
// is, for T; the reversed tail, for A): the FIRST window start p < win_p
// with >= mc base codes among its k columns and p <= hl - k, walked over
// the following passing starts, tightened to the first and last base code.
// first = last = -1 when there is none.
template <int KC, int MC>
__device__ void polyscan(const uint8_t* h, unsigned base4, int hl,
                         const EdgeParams& P, int& first, int& last) {
  const int k = KC ? KC : P.k;
  first = last = -1;
  const int lim_p = hl - k + 1;          // starts below it lie in the read
  if (lim_p <= 0) return;
  Trail T{};
  unsigned Mm1 = 0u, M0 = mask_word(h, 0, base4, hl);
  unsigned pe0 = pass_end<KC, MC>(M0, T, P.k, P.mc);
  int j = -1;
  for (int w = 0; w < NW; ++w) {
    const unsigned M1 = w + 1 < NW ? mask_word(h, w + 1, base4, hl) : 0u;
    const unsigned pe1 = pass_end<KC, MC>(M1, T, P.k, P.mc);
    const unsigned Pw = __funnelshift_r(pe0, pe1, k - 1) &
                        span_mask(0, lim_p, w);
    unsigned np;
    if (j < 0) {
      const unsigned cand = Pw & span_mask(0, P.win_p, w);
      if (cand == 0u) {
        if (32 * (w + 1) >= P.win_p) return;   // no run starts below win_p
        Mm1 = M0;
        M0 = M1;
        pe0 = pe1;
        continue;
      }
      const int jb = __ffs(cand) - 1;
      j = 32 * w + jb;
      const unsigned a = M0 & (FULL << jb);
      first = a ? 32 * w + __ffs(a) - 1 : 32 * (w + 1) + __ffs(M1) - 1;
      np = ~Pw & ((FULL << jb) << 1);
    } else {
      np = ~Pw;
    }
    if (np) {
      // the run's last passing start is the bit before; its window ends at
      // run_end + k - 1 (< hl), and its last base lies in words w-1..w+1
      const int end = 32 * w + __ffs(np) - 2 + k - 1;
      const int e1 = end - 32 * (w + 1), e0 = end - 32 * w;
      const unsigned c1 = e1 < 0 ? 0u : M1 & (FULL >> (31 - min(e1, 31)));
      const unsigned c0 = M0 & (FULL >> (31 - min(e0, 31)));
      last = c1 ? 32 * (w + 1) + 31 - __clz(c1)
           : c0 ? 32 * w + 31 - __clz(c0)
                : 32 * (w - 1) + 31 - __clz(Mm1);
      return;
    }
    Mm1 = M0;
    M0 = M1;
    pe0 = pe1;
  }
}

// ---- window passes ----

// One Myers chain, the pattern in the top m bits (win1.cu's form).
struct Chain {
  unsigned PV, MV;
  int score;
  unsigned best;
  __device__ __forceinline__ void init(int m) {
    PV = FULL;
    MV = 0u;
    score = m;
    best = (unsigned)m * KEY;
  }
  __device__ __forceinline__ unsigned step(unsigned eq) {
    sic::myers_step(eq, PV, MV, score, 31);
    return (unsigned)score * KEY;
  }
  __device__ __forceinline__ int ed(int m) const {
    return best == (unsigned)m * KEY ? m : (int)(best / KEY);
  }
  __device__ __forceinline__ int pos(int m) const {
    return best == (unsigned)m * KEY ? -1 : (int)(best % KEY);
  }
};

// Myers alone (the sense adapter searches).
struct SearchPass {
  Chain ch;
  __device__ __forceinline__ void cols(const unsigned (&eq)[4], int t) {
    unsigned g = ch.step(eq[0]);
    g = min(g, ch.step(eq[1]) + 1u);
    g = min(g, ch.step(eq[2]) + 2u);
    g = min(g, ch.step(eq[3]) + 3u);
    ch.best = min(ch.best, g + (unsigned)t);
  }
};

// Myers and the longest run (ops/scan.py match_run_stats' best): counter
// planes c0..c4 of every pattern row's run ending at this column, and the
// bits of 31 - best as all-ones / zero masks k0..k4.
struct RunPass {
  Chain ch;
  unsigned c0, c1, c2, c3, c4, k0, k1, k2, k3, k4;
  __device__ __forceinline__ void init(int m) {
    ch.init(m);
    c0 = c1 = c2 = c3 = c4 = 0u;
    k0 = k1 = k2 = k3 = k4 = FULL;
  }
  __device__ __forceinline__ void run(unsigned eq) {
    const unsigned s0 = c0 << 1, s1 = c1 << 1, s2 = c2 << 1, s3 = c3 << 1,
                   s4 = c4 << 1;
    unsigned cy = s0;
    c0 = eq & ~s0;
    c1 = eq & (s1 ^ cy);
    cy &= s1;
    c2 = eq & (s2 ^ cy);
    cy &= s2;
    c3 = eq & (s3 ^ cy);
    cy &= s3;
    c4 = eq & (s4 ^ cy);
    // some row's run >= best + 1  <=>  run + (31 - best) carries out
    unsigned g = c0 & k0;
    g = (c1 & k1) | (g & (c1 | k1));
    g = (c2 & k2) | (g & (c2 | k2));
    g = (c3 & k3) | (g & (c3 | k3));
    g = (c4 & k4) | (g & (c4 | k4));
    unsigned b = g ? FULL : 0u;        // best += 1: 31 - best -= 1
    k0 ^= b;
    b &= k0;
    k1 ^= b;
    b &= k1;
    k2 ^= b;
    b &= k2;
    k3 ^= b;
    b &= k3;
    k4 ^= b;
  }
  __device__ __forceinline__ int best_run() const {
    return 31 - (int)((k0 & 1u) | (k1 & 2u) | (k2 & 4u) | (k3 & 8u) |
                      (k4 & 16u));
  }
  __device__ __forceinline__ void cols(const unsigned (&eq)[4], int t) {
    unsigned g = ch.step(eq[0]);
    run(eq[0]);
    g = min(g, ch.step(eq[1]) + 1u);
    run(eq[1]);
    g = min(g, ch.step(eq[2]) + 2u);
    run(eq[2]);
    g = min(g, ch.step(eq[3]) + 3u);
    run(eq[3]);
    ch.best = min(ch.best, g + (unsigned)t);
  }
};

// Is y the second threshold of a bail_pairs(c1, c2) pair?
__host__ __device__ constexpr bool bail_y(int c1, int c2, int y) {
  for (int a = (c2 + 1) / 2; a < (c1 < c2 ? c1 : c2); ++a) {
    const int b = c2 - a;
    if (b >= 1 && (a == y || b == y)) return true;
  }
  return false;
}

// Myers and the TSO bailout (ops/scan.py run_bailout). R[l - 1]: rows whose
// run ending at this column reaches l. C1, C2: c1 and c2 compiled in (0:
// the general form, which counts the column's best run from the levels).
template <int C1, int C2>
struct BailPass {
  Chain ch;
  unsigned R[MAXL];
  int fge[MAXP];
  bool ok;
  __device__ __forceinline__ void init(int m) {
    ch.init(m);
#pragma unroll
    for (int l = 0; l < MAXL; ++l) R[l] = 0u;
#pragma unroll
    for (int q = 0; q < MAXP; ++q) fge[q] = BIG;
    ok = false;
  }
  __device__ __forceinline__ void bail(unsigned eq, int t,
                                       const EdgeParams& P) {
    constexpr int L = C1 ? C1 : MAXL;
#pragma unroll
    for (int l = L - 1; l >= 1; --l) R[l] = eq & (R[l - 1] << 1);
    R[0] = eq;
    if constexpr (C1 > 0) {
      // fge[y - 1]: the first column whose best run reached y
      ok |= R[C1 - 1] != 0u;
#pragma unroll
      for (int y = 1; y < C1; ++y)
        if (bail_y(C1, C2, y)) fge[y - 1] = min(fge[y - 1], R[y - 1] ? t : BIG);
#pragma unroll
      for (int a = (C2 + 1) / 2; a < (C1 < C2 ? C1 : C2); ++a) {
        const int b = C2 - a;
        if (b < 1) continue;
        ok |= R[a - 1] != 0u && fge[b - 1] <= t - a;
        if (b != a) ok |= R[b - 1] != 0u && fge[a - 1] <= t - b;
      }
    } else {
      // fge[q]: the first column whose best run reached pair q's y
      int be = 0;
#pragma unroll
      for (int l = 0; l < MAXL; ++l) be += R[l] != 0u;
      ok |= be >= P.c1;
#pragma unroll
      for (int q = 0; q < MAXP; ++q) {
        if (q < P.npairs) {
          ok |= be >= P.pair_x[q] && fge[q] <= t - P.pair_x[q];
          if (fge[q] == BIG && be >= P.pair_y[q]) fge[q] = t;
        }
      }
    }
  }
  __device__ __forceinline__ void cols(const unsigned (&eq)[4], int t,
                                       const EdgeParams& P) {
    unsigned g = ch.step(eq[0]);
    bail(eq[0], t, P);
    g = min(g, ch.step(eq[1]) + 1u);
    bail(eq[1], t + 1, P);
    g = min(g, ch.step(eq[2]) + 2u);
    bail(eq[2], t + 2, P);
    g = min(g, ch.step(eq[3]) + 3u);
    bail(eq[3], t + 3, P);
    ch.best = min(ch.best, g + (unsigned)t);
  }
};

// A sense window of W columns of one staged half: column t is byte s + t,
// PAD where s + t lies outside [0, lim).
struct Win {
  const uint8_t* h;
  int s, lim, W;
  __device__ __forceinline__ int lo() const { return max(0, -s); }
  __device__ __forceinline__ int hi() const { return min(W, lim - s); }
  __device__ __forceinline__ int at(int t) const {
    const int q = s + t;
    return (t >= 0 && t < W && q >= 0 && q < lim) ? (int)h[q] : PAD;
  }
};

// Feed the window's columns inside [lo, hi) to f, four a call: the match
// masks from the pair table `pair` (entry a | b << 3: codes a, b), the
// columns past hi as code 7 (no match). The bytes read past hi lie inside
// the staged row or its slack.
template <class F, class... A>
__device__ __forceinline__ void walk(const Win& wn, const uint2* pair, F& f,
                                     A&&... a) {
  const int t0 = wn.lo(), n = wn.hi() - t0;
  if (n <= 0) return;
  const int b = wn.s + t0;                       // first byte, >= 0
  const uint8_t* base = wn.h + b;
  const unsigned* w = reinterpret_cast<const unsigned*>(
      reinterpret_cast<uintptr_t>(base) & ~(uintptr_t)3);
  const unsigned sh = 8u * (unsigned)(reinterpret_cast<uintptr_t>(base) & 3);
  unsigned lo = w[0];
  for (int i = 0; i < n; i += 4) {
    const unsigned hi = w[(i >> 2) + 1];
    unsigned x = __funnelshift_r(lo, hi, sh);    // codes i..i+3
    lo = hi;
    if (n - i < 4) {
      const unsigned keep = (1u << (8 * (n - i))) - 1u;
      x = (x & keep) | (0x07070707u & ~keep);
    }
    const uint2 e01 = pair[(x | (x >> 5)) & 63u];
    const uint2 e23 = pair[((x >> 16) | (x >> 21)) & 63u];
    const unsigned eq[4] = {e01.x, e01.y, e23.x, e23.y};
    f.cols(eq, t0 + i, a...);
  }
}

// Pair tables in shared memory: pattern p (0 adapter, 1 complete adapter,
// 2 TSO), half (0 head, 1 reversed tail: codes complemented).
struct Tables {
  uint2 pair[3][2][64];
};

template <bool FIVE, int KC, int MC, int C1, int C2>
__global__ void __launch_bounds__(THREADS, 4)
edge_scan_kernel(const int8_t* __restrict__ codes,
                 const int* __restrict__ lens, int* __restrict__ out, int B,
                 const __grid_constant__ EdgeParams P) {
  __shared__ __align__(16) uint8_t sm[NR * RS];
  __shared__ Tables tab;
  __shared__ int xs[2][5][NR];       // side, (first, last, found, ed, pos)
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * NR;
  const int nr = min(NR, B - b0);

  // ---- stage the block's span: all 16-byte loads, then the stores; the
  // tail half reversed ----
  {
    const int nv = nr * (ROWB / 16);
    const uint4* g = reinterpret_cast<const uint4*>(codes + (size_t)b0 * ROWB);
    uint4 v[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (tid + j * THREADS < nv) v[j] = __ldg(g + tid + j * THREADS);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = tid + j * THREADS;
      if (i < nv) {
        const int r = i / (ROWB / 16), c = i - r * (ROWB / 16);
        uint4 x = v[j];
        int d = c;
        if (c >= E / 16) {                // tail chunk: mirrored, reversed
          d = E / 16 + (2 * E / 16 - 1 - c);
          x = make_uint4(__byte_perm(v[j].w, 0, 0x0123),
                         __byte_perm(v[j].z, 0, 0x0123),
                         __byte_perm(v[j].y, 0, 0x0123),
                         __byte_perm(v[j].x, 0, 0x0123));
        }
        *reinterpret_cast<uint4*>(sm + r * RS + 16 * d) = x;
      }
    }
  }
  for (int i = tid; i < 6 * 64; i += THREADS) {
    const int pt = i / 128, half = (i / 64) & 1, e = i & 63;
    const unsigned* pq = pt == 0 ? P.peq_ad : pt == 1 ? P.peq_adc : P.peq_tso;
    const int m = pt == 0 ? P.m_ad : pt == 1 ? P.m_adc : P.m_tso;
    int a = e & 7, b = e >> 3;
    if (half) {
      a = a < 4 ? 3 - a : a;
      b = b < 4 ? 3 - b : b;
    }
    tab.pair[pt][half][e] = make_uint2(a < 4 ? pq[a] << (32 - m) : 0u,
                                       b < 4 ? pq[b] << (32 - m) : 0u);
  }
  __syncthreads();

  const int awin = P.awin;
  // side 0: REV (polyT in the head), side 1: FWD (polyA in the tail)
  const int s = tid / NR, r = tid % NR;
  if (r < nr) {
    const uint8_t* row = sm + r * RS;
    const int hl = min(lens[b0 + r], E);
    int first, last;
    if (s == 0)
      polyscan<KC, MC>(row, 0x03030303u, hl, P, first, last);
    else
      polyscan<KC, MC>(row + E, 0u, hl, P, first, last);
    const bool found = first >= 0;
    SearchPass sp;
    sp.ch.init(P.m_ad);
    // (5p: the REV side's end column is ROW_AE of an unstranded read, so
    // its window is searched whether or not the head holds a polyT)
    if (found || (FIVE && s == 0)) {
      // 3p: the window before the run; 5p: the read's first awin bases on
      // the other half (the REV hypothesis reads the tail). A tail window
      // spans the whole tail half (lim E), as gather_window's does.
      const int half = FIVE ? 1 - s : s;
      const Win wn{row + half * E, FIVE ? 0 : first - awin,
                   half ? E : hl, awin};
      walk(wn, tab.pair[0][half], sp);
    }
    xs[s][0][r] = first;
    xs[s][1][r] = last;
    xs[s][2][r] = found;
    xs[s][3][r] = found ? sp.ch.ed(P.m_ad) : BIG;
    xs[s][4][r] = sp.ch.pos(P.m_ad);
  }
  __syncthreads();

  if (r < nr) {
    const int b = b0 + r;
    const uint8_t* row = sm + r * RS;
    const int hl = min(lens[b], E);
    const bool rev_found = xs[0][2][r], fwd_found = xs[1][2][r];
    const int ed_r = xs[0][3][r], ed_f = xs[1][3][r];
    const int pos_r = xs[0][4][r], pos_f = xs[1][4][r];
    const bool ok_f = fwd_found && ed_f <= P.mm_ad;
    const bool ok_r = rev_found && ed_r <= P.mm_ad;
    const bool stranded = ok_f || ok_r;
    const bool is_fwd = stranded ? (ok_f && (!ok_r || ed_f <= ed_r))
                                 : fwd_found;
    // the chosen side's adapter window (the half it lies on, its start)
    const int us = is_fwd ? 1 : 0;
    const int uhalf = FIVE ? 1 - us : us;
    const int ufirst = xs[us][0][r];
    const int ad_pos = is_fwd ? pos_f : pos_r;
    const Win wu{row + uhalf * E, FIVE ? 0 : ufirst - awin,
                 uhalf ? E : hl, awin};
    if (s == 0) {
      // ---- the complete adapter and its longest run, the BC window ----
      RunPass rp;
      rp.init(P.m_adc);
      walk(wu, tab.pair[1][uhalf], rp);
      out[(size_t)7 * B + b] = rp.ch.ed(P.m_adc);
      out[(size_t)8 * B + b] = rp.best_run();
      const int bcs = ad_pos + 1 - P.pad;
      unsigned kmer = 0u;
      bool kvalid = true;
      for (int i = 0; i < P.bw; ++i) {
        int c = wu.at(bcs + i);
        if (uhalf) c = sic::comp(c);
        out[(size_t)(NROW_META + i) * B + b] = c;
        if (i >= P.pad && i < P.pad + P.bc_len) {
          kvalid &= c < 4;
          kmer = (kmer << 2) | (unsigned)min(c, 3);
        }
      }
      out[(size_t)11 * B + b] = (int)(kmer & 0xFFFFu);
      out[(size_t)12 * B + b] = (int)(kmer >> 16);
      out[(size_t)13 * B + b] = kvalid;
    } else {
      // ---- the TSO and its bailout at the stranded read start (5p: after
      // the BC, from the stranded-masked ae) ----
      const int ae5 = stranded ? ad_pos : -1;
      const int t0 = FIVE ? ae5 + 1 + P.bc_len : 0;
      const int thalf = is_fwd ? 0 : 1;
      const Win wt{row + thalf * E, t0, thalf ? E : hl, P.twin};
      BailPass<C1, C2> bp;
      bp.init(P.m_tso);
      walk(wt, tab.pair[2][thalf], bp, P);
      const int tso_ed = bp.ch.ed(P.m_tso), tso_pos = bp.ch.pos(P.m_tso);
      const bool tso_found = tso_ed <= P.mm_tso || bp.ok;
      // ---- the meta rows, in half-local coordinates ----
      const int rev_ts = xs[0][0][r], rev_te = xs[0][1][r];
      const int fwd_ps = fwd_found ? E - 1 - xs[1][1][r] : -1;
      const int fwd_pe = fwd_found ? E - 1 - xs[1][0][r] : -1;
      const int ad_ed = is_fwd ? ed_f : ed_r;
      int ae_loc;
      if (FIVE)
        ae_loc = ad_pos;
      else
        ae_loc = is_fwd ? fwd_pe + awin - pos_f : rev_ts - awin + pos_r;
      out[b] = is_fwd;
      out[(size_t)1 * B + b] = stranded;
      out[(size_t)2 * B + b] = is_fwd ? fwd_found : rev_found;
      out[(size_t)3 * B + b] = is_fwd ? fwd_ps : rev_te;
      out[(size_t)4 * B + b] = is_fwd ? fwd_pe : rev_ts;
      out[(size_t)5 * B + b] = ae_loc;
      out[(size_t)6 * B + b] = stranded ? min(ad_ed, ED_SENTINEL)
                                        : ED_SENTINEL;
      out[(size_t)9 * B + b] = tso_found ? t0 + tso_pos + (P.off_tso - 1)
                                         : -1;
      out[(size_t)10 * B + b] = tso_ed;
    }
  }
}

template <bool FIVE>
int launch(const int8_t* codes, const int* lens, int* out, int B,
           const EdgeParams& P, cudaStream_t st) {
  const dim3 grid((B + NR - 1) / NR);
  // the default configuration (ops/edgescan.py edge_params of a default
  // PipelineConfig) compiled in: k = 15, mc = 12, c1 = 8, c2 = 12
  if (P.k == 15 && P.mc == 12 && P.c1 == 8 && P.c2 == 12)
    edge_scan_kernel<FIVE, 15, 12, 8, 12><<<grid, THREADS, 0, st>>>(
        codes, lens, out, B, P);
  else
    edge_scan_kernel<FIVE, 0, 0, 0, 0><<<grid, THREADS, 0, st>>>(
        codes, lens, out, B, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int edgescan_launch(const void* codes, const void* lens, void* out,
                               const void* params, int B, int nparams,
                               void* stream) {
  if (nparams * (int)sizeof(int) != (int)sizeof(EdgeParams))
    return (int)cudaErrorInvalidValue;
  EdgeParams P;
  memcpy(&P, params, sizeof(EdgeParams));
  if (B <= 0) return 0;
  if (P.E != E || P.k < 2 || P.k > 16 || P.c1 > MAXL || P.npairs > MAXP ||
      P.awin > 128 || P.twin > 160 || ((uintptr_t)codes & 15u))
    return (int)cudaErrorInvalidValue;
  const int8_t* c = (const int8_t*)codes;
  const cudaStream_t st = (cudaStream_t)stream;
  return P.is5p ? launch<true>(c, (const int*)lens, (int*)out, B, P, st)
                : launch<false>(c, (const int*)lens, (int*)out, B, P, st);
}
