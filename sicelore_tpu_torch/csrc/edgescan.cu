// Two-half edge scan, one thread per read (3p chemistry).
//
// Replaces the Pallas TPU kernel sicelore_tpu/ops/edgescan_tpu.py::_edge_kernel
// and computes, per read, what make_edge_scan2_jnp (ops/edgescan.py) computes:
// polyT head / polyA tail run detection and tightening; sense and rc Myers
// searches for the short and complete adapter and the TSO; the complete-
// adapter consecutive-match run; the TSO two-best bailout; strand choice;
// half-local coordinates; the BC window and its 16-mer kmer. Output rows are
// [n_rows, B] int32 (ops/edgescan.py ROW_*).
//
// Input: text-major int8 codes [2E, B] (head columns, then right-aligned tail
// columns; PAD outside the read) and lens [B]. N and PAD match no pattern
// base, so reads with N need no second pass.
//
// What bounds it on the H100: integer ALU work, about 3k dependent ops a read
// (five Myers searches over 90-110 columns, two 32-row run DPs, two 304-column
// run scans); the 608 bytes a read are read once from HBM and then from L1/L2.
// The simple design gives each read its own thread with all state in
// registers (Myers words, a 32-entry run column, the bailout's first-seen
// columns), reads window characters straight from the text-major array
// (neighbouring threads load neighbouring bytes in the run scans) and never
// materialises a window. Shared-memory staging of the columns is later work.
#include <stdint.h>
#include <string.h>

#include "myers.cuh"

namespace {

using sic::Peq4;
using sic::PAD;

constexpr int BIG = 1000000000;
constexpr int ED_SENTINEL = 16384;
constexpr int MAXP = 16;   // bailout threshold pairs
constexpr int NROW_META = 14;

// Field order is the int32 parameter array built by ops/edgescan_cuda.py.
struct EdgeParams {
  int E, k, mc, win_p, awin, twin, m_ad, m_adc, m_tso, mm_ad, mm_tso,
      off_tso, c1, npairs, pad, bc_len, bw, n_rows;
  unsigned peq_ad[4], peq_adc[4], peq_tso[4];
  int pair_x[MAXP], pair_y[MAXP];
};

// Character i of gather_window(X, lim, s, W, rc): X[s + i] when inside
// [0, lim), PAD outside; with rc the window is reverse-complemented.
struct Win {
  const int8_t* X;   // column 0 of this half, text-major (stride B)
  int B, b, lim, s, W;
  bool rc;
  __device__ __forceinline__ int at(int i) const {
    int q = rc ? s + (W - 1 - i) : s + i;
    int c = (q >= 0 && q < lim) ? (int)X[(size_t)q * B + b] : PAD;
    return rc ? sic::comp(c) : c;
  }
};

__device__ __forceinline__ Peq4 peq4(const unsigned* p) {
  return Peq4{p[0], p[1], p[2], p[3]};
}

// Semi-global search of one pattern in a window: best ED and the first
// window position reaching it (-1 when no column beats m).
__device__ void myers_search(const Win& w, Peq4 pq, int m, int& ed,
                             int& pos) {
  unsigned PV = sic::full_mask(m), MV = 0u;
  int score = m, best = m, bpos = -1;
  for (int t = 0; t < w.W; ++t) {
    sic::myers_step(pq.sel(w.at(t)), PV, MV, score, m - 1);
    if (score < best) {
      best = score;
      bpos = t;
    }
  }
  ed = best;
  pos = bpos;
}

// Advance the run DP one window column: run[i] = pattern[i] == c ?
// run[i-1] (previous column) + 1 : 0. Returns the longest run ending here.
__device__ __forceinline__ int run_column(int run[32], unsigned e) {
  int be = 0;
#pragma unroll
  for (int i = 31; i >= 1; --i) {
    run[i] = ((e >> i) & 1u) ? run[i - 1] + 1 : 0;
    be = max(be, run[i]);
  }
  run[0] = (int)(e & 1u);
  return max(be, run[0]);
}

__device__ int longest_run(const Win& w, Peq4 pq) {
  int run[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) run[i] = 0;
  int best = 0;
  for (int t = 0; t < w.W; ++t) best = max(best, run_column(run, pq.sel(w.at(t))));
  return best;
}

// TSO bailout (ops/scan.py run_bailout): a run >= c1, or for some pair
// (x, y) a run >= x ending at column j while a run >= y ended at or before
// column j - x. fge[q] is the first column whose longest run reached y_q.
__device__ bool tso_bailout(const Win& w, Peq4 pq, const EdgeParams& P) {
  int run[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) run[i] = 0;
  int fge[MAXP];
#pragma unroll
  for (int q = 0; q < MAXP; ++q) fge[q] = BIG;
  bool ok = false;
  for (int t = 0; t < w.W; ++t) {
    int be = run_column(run, pq.sel(w.at(t)));
    ok |= be >= P.c1;
#pragma unroll
    for (int q = 0; q < MAXP; ++q) {
      if (q < P.npairs) {
        ok |= be >= P.pair_x[q] && fge[q] <= t - P.pair_x[q];
        if (fge[q] == BIG && be >= P.pair_y[q]) fge[q] = t;
      }
    }
  }
  return ok;
}

__global__ void __launch_bounds__(128)
edge_scan_kernel(const int8_t* __restrict__ codes,
                 const int* __restrict__ lens, int* __restrict__ out, int B,
                 const __grid_constant__ EdgeParams P) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int E = P.E, k = P.k;
  const int8_t* head = codes;
  const int8_t* tail = codes + (size_t)E * B;
  const int L = lens[b];
  const int hl = min(L, E);
  const int tail_start = E - hl;          // first in-read tail column
  const unsigned kmask = (1u << k) - 1u;  // k <= 16
  const int npos = E - k + 1;
#define HEAD(c) ((int)head[(size_t)(c) * B + b])
#define TAIL(c) ((int)tail[(size_t)(c) * B + b])

  // ---- polyT near the read start (REV): FIRST passing k-window starting
  // below win_p, walked right over passing windows, tightened to T's ----
  bool rev_found = false;
  int rev_ts = -1, rev_te = -1;
  {
    unsigned bits = 0u;
    int j = -1, run_end = npos - 1;
    for (int c = 0; c < E; ++c) {
      bits = (bits << 1) | (HEAD(c) == 3 ? 1u : 0u);
      const int p = c - k + 1;
      if (p < 0) continue;
      if (j < 0 && p >= P.win_p) break;
      const bool passing = __popc(bits & kmask) >= P.mc && p <= hl - k;
      if (j < 0) {
        if (passing) j = p;
      } else if (!passing) {
        run_end = p - 1;
        break;
      }
    }
    if (j >= 0) {
      const int end = min(run_end + k - 1, hl - 1);
      for (int c = j; c <= end; ++c) {
        if (HEAD(c) == 3) {
          if (!rev_found) rev_ts = c;
          rev_te = c;
          rev_found = true;
        }
      }
    }
  }

  // ---- polyA near the read end (FWD): LAST passing k-window whose end lies
  // in the last win_p tail columns, walked left, tightened to A's ----
  bool fwd_found = false;
  int fwd_ps = -1, fwd_pe = -1;
  {
    unsigned bits = 0u;
    int j = -1, rs = 0, last_np = -1;
    const int reg0 = E - P.win_p - k + 1;
    for (int c = 0; c < E; ++c) {
      bits = (bits << 1) | (TAIL(c) == 0 ? 1u : 0u);
      const int p = c - k + 1;
      if (p < 0) continue;
      const bool passing = __popc(bits & kmask) >= P.mc && p >= tail_start;
      if (!passing) {
        last_np = p;
      } else if (p >= reg0) {
        j = p;
        rs = last_np + 1;
      }
    }
    if (j >= 0) {
      const int end = min(j + k - 1, E - 1);
      for (int c = rs; c <= end; ++c) {
        if (TAIL(c) == 0) {
          if (!fwd_found) fwd_ps = c;
          fwd_pe = c;
          fwd_found = true;
        }
      }
    }
  }

  // ---- adapter search, sense-orientation windows ----
  const int awin = P.awin, twin = P.twin;
  const Win w_fwd{tail, B, b, E, fwd_pe + 1, awin, true};
  const Win w_rev{head, B, b, hl, rev_ts - awin, awin, false};
  const Peq4 pq_ad = peq4(P.peq_ad), pq_adc = peq4(P.peq_adc),
             pq_tso = peq4(P.peq_tso);
  int ed_f, pos_f, ed_r, pos_r;
  myers_search(w_fwd, pq_ad, P.m_ad, ed_f, pos_f);
  myers_search(w_rev, pq_ad, P.m_ad, ed_r, pos_r);
  if (!fwd_found) ed_f = BIG;
  if (!rev_found) ed_r = BIG;
  const bool ok_f = fwd_found && ed_f <= P.mm_ad;
  const bool ok_r = rev_found && ed_r <= P.mm_ad;
  const bool stranded = ok_f || ok_r;
  const bool is_fwd = stranded ? (ok_f && (!ok_r || ed_f <= ed_r)) : fwd_found;

  const bool has_pat = is_fwd ? fwd_found : rev_found;
  const int ps_loc = is_fwd ? fwd_ps : rev_te;
  const int pe_loc = is_fwd ? fwd_pe : rev_ts;
  const int ae_loc = is_fwd ? fwd_pe + awin - pos_f : rev_ts - awin + pos_r;
  const int ad_ed = is_fwd ? ed_f : ed_r;
  const int ad_pos = is_fwd ? pos_f : pos_r;
  const Win w_used = is_fwd ? w_fwd : w_rev;

  int edc, edc_pos;
  myers_search(w_used, pq_adc, P.m_adc, edc, edc_pos);
  const int ad_run = longest_run(w_used, pq_adc);

  // ---- TSO at the stranded read start (3p: t0 = 0) ----
  const Win w5 = is_fwd ? Win{head, B, b, hl, 0, twin, false}
                        : Win{tail, B, b, E, E - twin, twin, true};
  int tso_ed, tso_pos;
  myers_search(w5, pq_tso, P.m_tso, tso_ed, tso_pos);
  const bool bail = tso_bailout(w5, pq_tso, P);
  const bool tso_found = tso_ed <= P.mm_tso || bail;
  const int tso_end = tso_found ? tso_pos + (P.off_tso - 1) : -1;

  // ---- BC window (PAD outside the adapter window) + exact kmer ----
  const int bcs = ad_pos + 1 - P.pad;
  unsigned kmer = 0u;
  bool kvalid = true;
  for (int i = 0; i < P.bw; ++i) {
    const int q = bcs + i;
    const int c = (q >= 0 && q < awin) ? w_used.at(q) : PAD;
    out[(size_t)(NROW_META + i) * B + b] = c;
    if (i >= P.pad && i < P.pad + P.bc_len) {
      kvalid &= c < 4;
      kmer = (kmer << 2) | (unsigned)min(c, 3);
    }
  }

  int* o = out + b;
  o[0 * (size_t)B] = is_fwd;
  o[1 * (size_t)B] = stranded;
  o[2 * (size_t)B] = has_pat;
  o[3 * (size_t)B] = ps_loc;
  o[4 * (size_t)B] = pe_loc;
  o[5 * (size_t)B] = ae_loc;
  o[6 * (size_t)B] = stranded ? min(ad_ed, ED_SENTINEL) : ED_SENTINEL;
  o[7 * (size_t)B] = edc;
  o[8 * (size_t)B] = ad_run;
  o[9 * (size_t)B] = tso_end;
  o[10 * (size_t)B] = tso_ed;
  o[11 * (size_t)B] = (int)(kmer & 0xFFFFu);
  o[12 * (size_t)B] = (int)(kmer >> 16);
  o[13 * (size_t)B] = kvalid;
#undef HEAD
#undef TAIL
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
  const int threads = 128;
  edge_scan_kernel<<<(B + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const int*)lens, (int*)out, B, P);
  return (int)cudaGetLastError();
}
