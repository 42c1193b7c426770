"""Myers bit-parallel semi-global edit distance (plain PyTorch).

Port of `sicelore_tpu/ops/editdist.py` (`build_peq`, the Hyyrö column update,
`_eq_select`, `myers_sweep`, `best_two`). Patterns are Peq bitmasks: bit i of
Peq[c, n] is set iff pattern n position i equals base c. N and PAD text
characters select an all-zero mask, so they never match.

Bit vectors are carried in int64 tensors (torch has no general uint32
arithmetic). Only bits 0..m-1 (m <= 32) are read, and in two's-complement
wraparound arithmetic the low 32 bits of every add, shift, and, or, xor and
not equal the uint32 result, so the high bits need no masking.
"""
from __future__ import annotations

import numpy as np
import torch

INT_MAX = 2**31 - 1  # reference reports ed_sec=2147483647 when none found


def build_peq(patterns: np.ndarray) -> np.ndarray:
    """[N, m] int8 codes -> Peq uint32 [4, N]; bit i of Peq[c, n] set iff
    patterns[n, i] == c. m must be <= 32."""
    n, m = patterns.shape
    if m > 32:
        raise ValueError("pattern longer than 32 bases")
    peq = np.zeros((4, n), dtype=np.uint32)
    for i in range(m):
        for c in range(4):
            peq[c] |= ((patterns[:, i] == c).astype(np.uint32)) << np.uint32(i)
    return peq


def peq_tensor(peq: np.ndarray | torch.Tensor, device) -> torch.Tensor:
    """Peq [4, N] (uint32 numpy or int64 tensor) -> int64 [6, N] on device
    with two zero rows appended, so `eq_select` is one gather and N (4) and
    PAD (5) select no pattern bit."""
    if isinstance(peq, np.ndarray):
        peq = torch.from_numpy(peq.astype(np.int64))
    peq = peq.to(device=device, dtype=torch.int64)
    return torch.cat([peq, torch.zeros((2, peq.shape[1]), dtype=torch.int64,
                                       device=peq.device)], dim=0)


def eq_select(tc: torch.Tensor, peq6: torch.Tensor) -> torch.Tensor:
    """tc [...] codes 0..5, peq6 [6, N] -> eq [..., N] (0 for N/PAD)."""
    return peq6[tc.long()]


def hyyro_step(PV, MV, score, eq, hibit: int, carry_in: int):
    """One Hyyrö column update. carry_in=1 -> global distance (D[0][j] = j),
    carry_in=0 -> search with free text start (D[0][j] = 0)."""
    Xv = eq | MV
    Xh = (((eq & PV) + PV) ^ PV) | eq
    Ph = MV | ~(Xh | PV)
    Mh = PV & Xh
    score = score + ((Ph >> hibit) & 1).to(torch.int32)
    score = score - ((Mh >> hibit) & 1).to(torch.int32)
    Ph = (Ph << 1) | carry_in
    Mh = Mh << 1
    PV = Mh | ~(Xv | Ph)
    MV = Ph & Xv
    return PV, MV, score


def myers_sweep(windows: torch.Tensor, peq, m: int):
    """Semi-global ED of every pattern against every window.

    windows [B, W] int8 codes; peq [4, N] Peq (numpy uint32 or tensor).
    Returns ed [B, N] int32 and end_pos [B, N] int32: 0-based last text char
    of the best match, first position on ties, -1 when no column improved
    on m."""
    B, W = windows.shape
    peq6 = peq_tensor(peq, windows.device)
    N = peq6.shape[1]
    full = (1 << m) - 1
    PV = torch.full((B, N), full, dtype=torch.int64, device=windows.device)
    MV = torch.zeros_like(PV)
    score = torch.full((B, N), m, dtype=torch.int32, device=windows.device)
    best = score.clone()
    best_pos = torch.full_like(score, -1)
    for t in range(W):
        eq = eq_select(windows[:, t], peq6)
        PV, MV, score = hyyro_step(PV, MV, score, eq, m - 1, 0)
        improved = score < best
        best = torch.where(improved, score, best)
        best_pos = torch.where(improved, torch.full_like(best_pos, t),
                               best_pos)
    return best, best_pos


def best_two(ed: torch.Tensor):
    """Per row: (best_ed, best_idx, second_ed, second_idx) over axis 1.
    best_idx is the first argmin; second_ed is INT_MAX when N == 1."""
    B, N = ed.shape
    best, idx = torch.min(ed, dim=1)
    idx = idx.to(torch.int32)
    cols = torch.arange(N, device=ed.device)[None, :]
    masked = torch.where(cols == idx[:, None].long(),
                         torch.full_like(ed, INT_MAX), ed)
    second, second_idx = torch.min(masked, dim=1)
    return best, idx, second, second_idx.to(torch.int32)
