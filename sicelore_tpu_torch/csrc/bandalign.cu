// Banded Needleman-Wunsch + greedy traceback: a group of lanes per (center,
// read) pair, four band cells a lane, several pairs a warp.
//
// Replaces the Pallas TPU kernel sicelore_tpu/ops/poa_tpu.py::_band_align_kernel
// together with the record decoding `extract_alignments` that followed it:
// per pair, the global alignment of the read against its molecule's center
// (match +5 / mismatch -4 / gap -8) inside a diagonal band of W = 32 or 64
// cells (cell b of column j is read position i = j + b - W/2), then one
// canonical optimal path walked back greedily (diag > vert > horiz). Outputs
// per pair: aligned [Lc+1] int8 (0..3 the read base on a diagonal move into
// column j at slot j-1, 4 deletion, 5 none), ins [Lc+1][K_INS][4] int8 (row
// j = insertions before center position j, offset counted from the run's
// end, a run longer than K_INS piling its excess into the last offset) and
// feasible (the end cell lies in the band and was reached on a valid path).
//
// What bounds it on the H100: integer ALU work over pairs x clen x W band
// cells, run as ONE dependent chain a pair (a column needs the column
// before it, and inside a column the gap closure is a prefix maximum over
// the band). The bytes are an order of magnitude below that. A kernel of
// this kind is slow for two reasons: cross-lane steps (a shuffle costs ~6
// ALU operations of latency and sits on the chain) and too few pairs in
// flight to hide that chain. The design works on both:
//
//  * G = W / 4 lanes (8 or 16) hold one pair, four consecutive band cells a
//    lane in registers; a warp holds 32 / G = 4 or 2 pairs. The column
//    recurrence fn[b] = max(f[b] + sub, f[b+1] + GAP) needs one shuffle (the
//    lane's top cell takes f of the next lane's bottom cell). The in-column
//    gap closure f[b] = max_k<=b fn[k] + (b - k) GAP is a running maximum
//    over the lane's four cells (plain max, no shuffle), one shuffle that
//    hands each lane its left neighbour's total, and a prefix maximum of
//    those totals across the G lanes in two shuffle levels of radix 4 (the
//    three shuffles of a level are independent; PERF.md has its time beside
//    that of log2(G) dependent levels).
//    Shuffles carry a width of G, so a lane below the shift gets its own
//    value back, which a maximum ignores: no predicates. max is exact in
//    int32, so every f, and with it every move bit, is the one the plain
//    version computes; the clamp at NEG is kept.
//  * No ballots: a lane packs the move bits of its four cells (diagonal
//    holds: low nibble; vertical holds: high nibble) into one byte and
//    stores it. A column of a pair is a slot of G bytes of shared memory,
//    the same two W-bit masks as before in another order, and the score
//    matrix still stays out. After the forward pass the whole warp turns
//    every slot, one column a lane, into the two masks in cell order
//    (`repack`), so that the walk's chain from one cell to the next is
//    shift, and, clz, shift, add.
//  * Shared memory holds the masks and nothing else (32 x Lc bytes a warp
//    whatever W is), so an SM holds 56 pairs at Lc 512 / W 32 and 14 at
//    Lc 1,024 / W 64 (the masks of 16 such pairs, 256 KB, exceed the 227 KB
//    an SM has). The read and the center are not staged: a lane keeps its
//    four read bases in one register, a window that slides by one byte a
//    column over aligned 4-byte words, and loads the next word of the read
//    and of the center a block of four columns ahead, from global memory
//    (each byte of either is read once a lane). The column loop unrolls by
//    four, so the window is one funnel shift with a constant.
//  * The scores are kept tilted, g[b] = f[b] - b GAP: the vertical move
//    adds the constant 2 GAP, the closure is a plain prefix maximum with no
//    term in b, and the clamp is a per-cell constant. Differences of scores
//    in one cell are unchanged, so every equality the walk tests holds in
//    the same cells.
//  * Warps are persistent: grid = what the card holds at once, each warp
//    takes pair sets in a stride, so a warp that ends early starts its next
//    set without waiting for its block.
//  * Inside the reads and the centers of all the warp's pairs (most
//    columns) no cell needs its read-position test and no column its
//    center-length test: blocks of four such columns run a body without
//    them (`band_column<.., INNER = true>`).
//  * The walk of each pair runs on the first lane of its group, 4 or 2
//    walks a warp side by side, and a step touches shared memory only: it
//    reads the column's masks (loaded one column ahead) and leaves in the
//    (dead) slot one word with the move, the stop cell and the cell it came
//    from. Then the whole warp, one column a lane, turns the words into
//    aligned codes (looking the read base of a diagonal move up), into the
//    votes of the insertion runs (`run_votes`) and the default 5, in one
//    coalesced pass where the loads of 32 lanes overlap. (A first version
//    looked the read base up and counted the runs on the walk: those global
//    loads on a serial chain were half of the kernel's time.)
//  * `ins` is zeroed by the whole warp in one coalesced pass BEFORE the
//    forward pass, so those stores (the bulk of the kernel's bytes) drain
//    while the recurrence runs; the few insertion rows are stored in the
//    copy-out pass.
//
// What holds it now (PERF.md has the numbers): instruction throughput, not
// the chain's latency. The recurrence alone spends ~18 instructions a cell
// (~25 outside the inner blocks) on a half-rate integer pipe where the bound
// counts 13; the walk, whose step costs a whole warp ~35 instructions for 4
// or 2 active lanes, the copy-out and the zero fill are a third of the time;
// the shuffles are a tenth at W 32 and a fifth at W 64.
//
// Kept as they were: the tie order, the freeze rule, the K_INS pile-up in
// run_votes, `feasible`, and walking every column.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MATCH = 5, MISMATCH = -4, GAP = -8;
constexpr int NEG = -10000000;
constexpr int NEGINF = -(1 << 30);       // below every score, far from overflow
constexpr int K_INS = 4;
constexpr int CPL = 4;                   // band cells a lane
constexpr int MAX_WARPS = 8;             // warps a block
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SM_SMEM = 233472;       // shared memory of an SM
constexpr size_t BLOCK_RESERVE = 1024;   // what the system keeps per block

// The horizontal run of column j over band cells (bstop, be]: the read chars
// it consumed vote by offset from the run's end. One 16-byte row.
__device__ __forceinline__ int4 run_votes(const int8_t* rs, int rlen, int j,
                                          int bstop, int be, int W2) {
  unsigned w0 = 0, w1 = 0, w2 = 0, w3 = 0;
  for (int x = be; x > bstop; --x) {
    const int i = j + x - W2;
    const int ch = (i >= 1 && i <= rlen) ? min((int)rs[i - 1], 3) : 3;
    const unsigned one = 1u << (8 * ch);
    const int o = be - x;
    if (o == 0) w0 += one;
    else if (o == 1) w1 += one;
    else if (o == 2) w2 += one;
    else w3 += one;
  }
  return make_int4((int)w0, (int)w1, (int)w2, (int)w3);
}

// A column's slot is G bytes. The forward pass leaves byte g with the move
// bits of cells 4g..4g+3 (diagonal holds: low nibble, vertical holds: high
// nibble); `repack` turns the slot in place into two W-bit masks in cell
// order (diagonal, then vertical), which is what the walk reads.
template <int G> struct BandMask;
template <> struct BandMask<8> { typedef uint32_t T; };
template <> struct BandMask<16> { typedef uint64_t T; };

__device__ __forceinline__ int top_bit(uint32_t x) { return 31 - __clz((int)x); }
__device__ __forceinline__ int top_bit(uint64_t x) {
  return 63 - __clzll((long long)x);
}

// the low nibbles of the eight bytes of x, packed into 32 bits
__device__ __forceinline__ uint32_t low_nibbles(uint64_t x) {
  x &= 0x0F0F0F0F0F0F0F0FULL;
  x = (x | (x >> 4)) & 0x00FF00FF00FF00FFULL;
  x = (x | (x >> 8)) & 0x0000FFFF0000FFFFULL;
  return (uint32_t)(x | (x >> 16));
}

template <int G>
__device__ __forceinline__ void repack(unsigned char* slot) {
  typedef typename BandMask<G>::T mask_t;
  uint64_t* w = (uint64_t*)slot;
  mask_t* m = (mask_t*)slot;
  if (G == 8) {
    const uint64_t x = w[0];
    const uint32_t d = low_nibbles(x), v = low_nibbles(x >> 4);
    m[0] = (mask_t)d;
    m[1] = (mask_t)v;
  } else {
    const uint64_t x0 = w[0], x1 = w[1];
    const uint64_t d = low_nibbles(x0) | ((uint64_t)low_nibbles(x1) << 32);
    const uint64_t v =
        low_nibbles(x0 >> 4) | ((uint64_t)low_nibbles(x1 >> 4) << 32);
    m[0] = (mask_t)d;
    m[1] = (mask_t)v;
  }
}

// The inclusive prefix maximum of y over the G lanes of a group. A shuffle
// with a width of G hands a lane below the shift its own value back, which a
// maximum ignores: no predicates.
template <int G>
__device__ __forceinline__ int group_prefix_max(int y) {
  const int a1 = __shfl_up_sync(FULL, y, 1, G);
  const int a2 = __shfl_up_sync(FULL, y, 2, G);
  const int a3 = __shfl_up_sync(FULL, y, 3, G);
  y = max(max(y, a1), max(a2, a3));
  if (G == 8) return max(y, __shfl_up_sync(FULL, y, 4, G));
  const int c1 = __shfl_up_sync(FULL, y, 4, G);
  const int c2 = __shfl_up_sync(FULL, y, 8, G);
  const int c3 = __shfl_up_sync(FULL, y, 12, G);
  return max(max(y, c1), max(c2, c3));
}

// One column of the recurrence for the lane's four cells, on tilted scores
// g[b] = f[b] - b GAP. win: the read bases of the cells (one a byte); cb: the
// center base; iv: read index i - 1 of the lane's cell 0. Returns the move
// bits (diagonal holds: bits 0..3, vertical holds: bits 4..7) and, if live,
// updates g. INNER: every cell is a read position and the column is live
// (the caller has checked it for the whole warp), so neither is tested.
template <int G, bool INNER>
__device__ __forceinline__ unsigned band_column(int (&g)[CPL],
                                                const int (&floor_g)[CPL],
                                                unsigned win, int cb, int gl,
                                                int iv, int rlen, bool live) {
  constexpr int W = CPL * G;
  const int s_eq = cb < 4 ? MATCH : MISMATCH;
  const unsigned diff = win ^ ((unsigned)(cb & 0xff) * 0x01010101u);
  int upn = __shfl_down_sync(FULL, g[0], 1, G);
  if (gl == G - 1) upn = NEG - W * GAP;    // no cell above the band
  int dsc[CPL], vsc[CPL], t[CPL];
  bool valid[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    valid[k] = INNER || (unsigned)(iv + k) < (unsigned)rlen;
    const bool eq = (diff & (0xffu << (8 * k))) == 0u;
    const int sub = valid[k] ? (eq ? s_eq : MISMATCH) : NEG;
    dsc[k] = g[k] + sub;
    vsc[k] = (k + 1 < CPL ? g[k + 1] : upn) + 2 * GAP;
    t[k] = max(dsc[k], vsc[k]);
  }
  // closure: a running maximum inside the lane, then the prefix maximum of
  // the lower lanes' totals
#pragma unroll
  for (int k = 1; k < CPL; ++k) t[k] = max(t[k], t[k - 1]);
  int y = __shfl_up_sync(FULL, t[CPL - 1], 1, G);
  if (gl == 0) y = NEGINF;
  y = group_prefix_max<G>(y);
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int gn = max(max(t[k], y), floor_g[k]);
    // the top cell's vertical score lies below its floor: no test for it
    const bool dg = valid[k] && gn == dsc[k];
    const bool vt = !dg && gn == vsc[k];
    bits |= dg ? (1u << k) : 0u;
    bits |= vt ? (16u << k) : 0u;
    if (INNER || live) g[k] = gn;
  }
  return bits;
}

template <int G>
__global__ void __launch_bounds__(MAX_WARPS * 32, 4)
band_align_kernel(const int8_t* __restrict__ reads,    // [P, Lc + W]
                  const int* __restrict__ rlens,       // [P]
                  const int* __restrict__ mids,        // [P]
                  const int8_t* __restrict__ centers,  // [M, Lc]
                  const int* __restrict__ clens,       // [M]
                  int8_t* __restrict__ aligned,        // [P, Lc + 1]
                  int4* __restrict__ ins4,             // [P, Lc + 1] rows
                  int* __restrict__ feasible,          // [P]
                  int P, int M, int Lc, int nsets) {
  constexpr int W = CPL * G, W2 = W / 2, PPW = 32 / G;
  typedef typename BandMask<G>::T mask_t;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int gl = lane % G, q = lane / G;
  const int Lr = Lc + W;
  unsigned char* wsm = smem + (size_t)warp * 32 * Lc;
  unsigned char* slots = wsm + (size_t)q * Lc * G;

  for (int set = blockIdx.x * wpb + warp; set < nsets;
       set += gridDim.x * wpb) {
    const int p0 = set * PPW;
    const int np = min(PPW, P - p0);
    const bool has = q < np;
    const int p = has ? p0 + q : p0;

    // ins defaults, the whole warp over its pairs' contiguous rows
    {
      int4* dst = ins4 + (size_t)p0 * (Lc + 1);
      const int n = np * (Lc + 1);
      for (int k = lane; k < n; k += 32) dst[k] = make_int4(0, 0, 0, 0);
    }
    const int mid = has ? mids[p] : -1;
    const bool mid_ok = mid >= 0 && mid < M;
    const int clen = mid_ok ? min(max(clens[mid], 0), Lc) : 0;
    const int rlen = has ? min(max(rlens[p], 0), Lr) : 0;
    const int8_t* rrow = reads + (size_t)p * Lr;
    const int8_t* crow = centers + (size_t)(mid_ok ? mid : 0) * Lc;
    // the longest center, the shortest center and the shortest read of
    // the warp's pairs (lanes without a pair do not count)
    int cmax = clen, cmin = has ? clen : Lc, rmin = has ? rlen : Lr;
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      cmax = max(cmax, __shfl_xor_sync(FULL, cmax, d));
      cmin = min(cmin, __shfl_xor_sync(FULL, cmin, d));
      rmin = min(rmin, __shfl_xor_sync(FULL, rmin, d));
    }

    // ---- forward: the lane holds cells b = 4 gl + k, as tilted scores
    // g[b] = f[b] - b GAP: the vertical move adds the constant 2 GAP, the
    // gap closure is a plain prefix maximum, and every equality the walk
    // tests holds in the same cells as for f ----
    int g[CPL], floor_g[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int b = CPL * gl + k, i0 = b - W2;
      floor_g[k] = NEG - b * GAP;          // the clamp at NEG, tilted
      g[k] = (i0 >= 0 && i0 <= rlen) ? -W2 * GAP : floor_g[k];
    }
    // The read bases of the lane's cells in column j are the bytes
    // rs[j + 4 gl - W2 - 1 + k]: a window that slides by one byte a column
    // over aligned words, loaded a block of four columns ahead.
    const int r0 = CPL * gl - W2;
    unsigned rw = r0 >= 0 ? *(const unsigned*)(rrow + r0) : 0u;
    unsigned nw = r0 + 4 >= 0 ? *(const unsigned*)(rrow + r0 + 4) : 0u;
    unsigned cw = clen > 0 ? *(const unsigned*)crow : 0u;
    unsigned char* sp = slots + gl;
    int iv = r0;                           // i - 1 of cell k = 0 in column j
    for (int j0 = 1; j0 <= cmax; j0 += CPL) {
      const bool more = j0 + CPL <= cmax;
      const int nx = r0 + j0 + 7;
      const unsigned nnw =
          (more && nx >= 0) ? *(const unsigned*)(rrow + nx) : 0u;
      const unsigned ncw =
          more ? *(const unsigned*)(crow + j0 + CPL - 1) : 0u;
      // Inside the reads and the centers of all the warp's pairs (the bulk
      // of the columns) every cell of the block is a read position and
      // every column is live: the body without those tests.
      if (j0 > W2 && j0 + W2 + 1 < rmin && j0 + CPL - 1 <= cmin) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const unsigned bits = band_column<G, true>(
              g, floor_g, c == 0 ? rw : __funnelshift_r(rw, nw, 8 * c),
              (int)(int8_t)(cw >> (8 * c)), gl, iv + c, rlen, true);
          sp[c * G] = (unsigned char)bits;
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const bool live = j0 + c <= clen;
          const unsigned bits = band_column<G, false>(
              g, floor_g, c == 0 ? rw : __funnelshift_r(rw, nw, 8 * c),
              (int)(int8_t)(cw >> (8 * c)), gl, iv + c, rlen, live);
          if (live) sp[c * G] = (unsigned char)bits;
        }
      }
      iv += CPL;
      sp += CPL * G;
      rw = nw;
      nw = nnw;
      cw = ncw;
    }

    // ---- feasibility: the end cell (clen, bt) ----
    const int bt = rlen - clen + W2;
    const int btc = min(max(bt, 0), W - 1);
    const int kk = btc & 3;
    const int mine = kk == 0 ? g[0] : kk == 1 ? g[1] : kk == 2 ? g[2] : g[3];
    const int total =
        __shfl_sync(FULL, mine, q * G + (btc >> 2)) + btc * GAP;
    const bool feas = has && mid_ok && bt >= 0 && bt < W && total > NEG / 2;
    __syncwarp();

    // ---- the slots into masks in cell order: one column a lane ----
    for (int qq = 0; qq < np; ++qq) {
      const int c_q = __shfl_sync(FULL, clen, qq * G);
      unsigned char* sl = wsm + (size_t)qq * Lc * G;
      for (int k = lane; k < c_q; k += 32) repack<G>(sl + (size_t)k * G);
    }
    __syncwarp();

    // ---- the walks, one lane a pair. A step touches shared memory only:
    // it leaves in the column's (dead) slot one word, code | stop cell << 8
    // | entry cell << 16, where code is 4 for a deletion, 0x80 for a
    // diagonal move and 5 where the pair froze. The read bases and the
    // insertion runs are looked up in the copy-out pass, where the loads of
    // 32 lanes overlap, not on this serial chain ----
    int jlow = clen + 1;                 // columns jlow..clen were walked
    int b0 = W2;                         // the walk's cell at column 0
    if (gl == 0 && has) {
      feasible[p] = feas ? 1 : 0;
      if (feas) {
        int b = btc, j = clen;
        const mask_t* mk = (const mask_t*)slots;
        mask_t dm = 0, vm = 0;
        if (j >= 1) {
          dm = mk[2 * (j - 1)];
          vm = mk[2 * (j - 1) + 1];
        }
        for (; j >= 1; --j) {
          // the next column's masks, ahead of this step's chain
          mask_t dn = dm, vn = vm;
          if (j >= 2) {
            dn = mk[2 * (j - 2)];
            vn = mk[2 * (j - 2) + 1];
          }
          // the larger band cell wins; cell 0 stops the run whatever it
          // holds. The chain from b to the next b: shift, and, clz, shift,
          // add (a vertical bit is never set beside a diagonal one).
          const mask_t below = ((mask_t)2 << b) - 1;     // cells <= b
          const int bstop = top_bit((mask_t)((dm | vm | (mask_t)1) & below));
          const unsigned sd = (unsigned)((dm >> bstop) & 1),
                         sv = (unsigned)((vm >> bstop) & 1);
          const unsigned code = sd ? 0x80u : sv ? 4u : 5u;
          *(unsigned*)(slots + (size_t)(j - 1) * G) =
              code | ((unsigned)bstop << 8) | ((unsigned)b << 16);
          if (!(sd | sv)) break;         // no move holds: the pair freezes
          b = bstop + (int)sv;
          dm = dn;
          vm = vn;
        }
        // a frozen column keeps its insertion run and the default code
        jlow = max(j, 1);
        b0 = j == 0 ? b : W2;            // j = 0: the read prefix's run
      }
    }
    __syncwarp();

    // ---- aligned rows and insertion runs, the whole warp: one column a
    // lane, defaults filled in ----
    for (int qq = 0; qq < np; ++qq) {
      const int c_q = __shfl_sync(FULL, clen, qq * G);
      const int jl_q = __shfl_sync(FULL, jlow, qq * G);
      const int b0_q = __shfl_sync(FULL, b0, qq * G);
      const int rl_q = __shfl_sync(FULL, rlen, qq * G);
      const unsigned char* sl = wsm + (size_t)qq * Lc * G;
      const int8_t* rq = reads + (size_t)(p0 + qq) * Lr;
      int8_t* arow = aligned + (size_t)(p0 + qq) * (Lc + 1);
      int4* irow = ins4 + (size_t)(p0 + qq) * (Lc + 1);
      for (int k = lane; k <= Lc; k += 32) {
        int code = 5;
        if (k >= jl_q - 1 && k < c_q) {  // column j = k + 1 was walked
          const unsigned rec = *(const unsigned*)(sl + (size_t)k * G);
          const int bstop = (rec >> 8) & 0xff, be = (rec >> 16) & 0xff;
          code = rec & 0xff;
          // diagonal into column j from cell bstop: read char i - 1
          if (code == 0x80) code = min((int)rq[k + bstop - W2], 3);
          if (be > bstop) irow[k + 1] = run_votes(rq, rl_q, k + 1, bstop, be, W2);
        }
        arow[k] = (int8_t)code;
      }
      if (lane == 0 && b0_q > W2)
        irow[0] = run_votes(rq, rl_q, 0, W2, b0_q, W2);
    }
    __syncwarp();                        // the masks are reused by the next set
  }
}

template <int G>
int launch(const void* reads, const void* rlens, const void* mids,
           const void* centers, const void* clens, void* aligned, void* ins,
           void* feasible, int P, int M, int Lc, cudaStream_t stream) {
  // the SM count of the current device (the wrapper makes the tensors'
  // device current), queried once a device
  static int sms_of[64] = {0};
  int dev = 0;
  {
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (sms_of[dev] == 0) {
      e = cudaDeviceGetAttribute(&sms_of[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return (int)e;
    }
  }
  const int sms = sms_of[dev];
  constexpr int PPW = 32 / G;
  const int nsets = (P + PPW - 1) / PPW;
  const size_t wbytes = 32 * (size_t)Lc;     // masks of one warp's pairs
  // warps an SM can hold, in blocks of at most MAX_WARPS warps
  int budget = (int)min((SM_SMEM - 4 * BLOCK_RESERVE) / wbytes, (size_t)32);
  if (budget < 1) return (int)cudaErrorInvalidValue;
  int wpb = budget / ((budget + MAX_WARPS - 1) / MAX_WARPS);
  // a small launch spreads over the SMs
  wpb = max(1, min(wpb, (nsets + sms - 1) / sms));
  const size_t smem = wpb * wbytes;
  const int per_sm = (int)min(SM_SMEM / (smem + BLOCK_RESERVE),
                              (size_t)(32 / wpb));
  const int grid = min((nsets + wpb - 1) / wpb, sms * max(per_sm, 1));
  auto kernel = band_align_kernel<G>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, wpb * 32, smem, stream>>>(
      (const int8_t*)reads, (const int*)rlens, (const int*)mids,
      (const int8_t*)centers, (const int*)clens, (int8_t*)aligned,
      (int4*)ins, (int*)feasible, P, M, Lc, nsets);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bandalign_launch(const void* reads, const void* rlens,
                                const void* mids, const void* centers,
                                const void* clens, void* aligned, void* ins,
                                void* feasible, int P, int M, int Lc, int W,
                                void* stream) {
  if (Lc < 16 || Lc % 16 || (W != 32 && W != 64) || M < 1)
    return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (W == 32)
    return launch<8>(reads, rlens, mids, centers, clens, aligned, ins,
                     feasible, P, M, Lc, st);
  return launch<16>(reads, rlens, mids, centers, clens, aligned, ins,
                    feasible, P, M, Lc, st);
}
