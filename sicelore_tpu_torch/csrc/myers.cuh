// Shared device helpers of the scan kernels: base codes, Peq selection and
// the Hyyro/Myers bit-parallel column update (the semi-global search and
// the global distance).
//
// Base codes are int8 A,C,G,T,N,PAD = 0..5 (sicelore_tpu/utils/dna.py).
// N and PAD select an all-zero match mask, so they never match a pattern
// base, and complement to themselves.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace sic {

constexpr int PAD = 5;

__device__ __forceinline__ int comp(int c) { return c < 4 ? 3 - c : c; }

// Peq bitmasks of one pattern (bit i of v[c] set iff pattern[i] == c).
struct Peq4 {
  unsigned v0, v1, v2, v3;
  __device__ __forceinline__ unsigned sel(int c) const {
    return c == 0 ? v0 : c == 1 ? v1 : c == 2 ? v2 : c == 3 ? v3 : 0u;
  }
};

// One column of the Myers recurrence for a pattern of length m (hibit =
// m-1). The horizontal carry-in is the score's step along the text's row
// 0: 0 for the search (free text start, D[0][j] = 0), 1 for the global
// distance (D[0][j] = j). Bits above hibit may hold anything: every
// operation carries upward only, so they never reach the bits read.
template <unsigned CARRY>
__device__ __forceinline__ void myers_column(unsigned eq, unsigned& PV,
                                             unsigned& MV, int& score,
                                             int hibit) {
  unsigned Xv = eq | MV;
  unsigned Xh = (((eq & PV) + PV) ^ PV) | eq;
  unsigned Ph = MV | ~(Xh | PV);
  unsigned Mh = PV & Xh;
  score += (int)((Ph >> hibit) & 1u);
  score -= (int)((Mh >> hibit) & 1u);
  Ph = (Ph << 1) | CARRY;
  Mh <<= 1;
  PV = Mh | ~(Xv | Ph);
  MV = Ph & Xv;
}

// The semi-global search column (carry-in 0: free text start).
__device__ __forceinline__ void myers_step(unsigned eq, unsigned& PV,
                                           unsigned& MV, int& score,
                                           int hibit) {
  myers_column<0u>(eq, PV, MV, score, hibit);
}

// The global distance column (carry-in 1: D[0][j] = j).
__device__ __forceinline__ void myers_step_global(unsigned eq, unsigned& PV,
                                                  unsigned& MV, int& score,
                                                  int hibit) {
  myers_column<1u>(eq, PV, MV, score, hibit);
}

__device__ __forceinline__ unsigned full_mask(int m) {
  return m >= 32 ? 0xFFFFFFFFu : ((1u << m) - 1u);
}

}  // namespace sic
