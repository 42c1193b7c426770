"""Read-scan ops in plain PyTorch: polyA/T run search, adapter search,
consecutive-match run statistics and the TSO bailout.

Port of `sicelore_tpu/ops/scan.py` (same policies; see that module for the
reference behaviour spec). All ops take [B, L] int8 code batches. With
`adapter_search_plain` they make up the plain bodies the scan kernels are
held to; with `adapter_search` (the window-search kernel on the card) they
make up the composed scan bodies.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sicelore_tpu_torch.utils import dna
from sicelore_tpu_torch.ops import editdist

NEG = -(10**9)


def _rolling_count(ind: torch.Tensor, k: int) -> torch.Tensor:
    """ind [B, L] 0/1 -> [B, L-k+1] window sums via cumulative sum."""
    cs = torch.cumsum(ind, dim=1)
    cs = F.pad(cs, (1, 0))            # cs[:, i] = sum of first i
    return cs[:, k:] - cs[:, :-k]


def polyat_find(seqs: torch.Tensor, lens: torch.Tensor, *, base: int, k: int,
                min_count: int, window: int, from_end: bool,
                start_min: torch.Tensor | None = None):
    """Find the polyA/T run nearest a read end.

    seqs [B, L] int8, lens [B] int32; from_end=True looks for the LAST
    passing k-window whose end lies within `window` of the read end (polyA
    near 3'), False for the FIRST passing window starting within `window`
    of the start (polyT near 5'). `start_min` [B]: window starts below it
    are out of the read (right-aligned tail halves). The run is walked over
    all passing windows and tightened to its first/last `base`.
    Returns found [B] bool, start [B] int32, end [B] int32 (-1 if none)."""
    B, L = seqs.shape
    dev = seqs.device
    if L < k:
        z = torch.full((B,), -1, dtype=torch.int32, device=dev)
        return torch.zeros(B, dtype=torch.bool, device=dev), z, z.clone()
    lens = lens.long()
    ind = (seqs == base).to(torch.int32)
    counts = _rolling_count(ind, k)
    npos = L - k + 1
    pos = torch.arange(npos, device=dev)[None, :]
    inread = pos <= (lens[:, None] - k)
    if start_min is not None:
        inread = inread & (pos >= start_min.long()[:, None])
    passing = (counts >= min_count) & inread
    if from_end:
        region = (pos + k - 1) >= (lens[:, None] - window)
    else:
        region = pos < window
    ok = passing & region
    if from_end:
        j = torch.where(ok, pos, NEG).max(dim=1).values
        found = j > NEG
        jc = j.clamp(min=0)
        lf = torch.cummax(torch.where(~passing, pos, NEG), dim=1).values
        run_start = lf.gather(1, jc[:, None])[:, 0] + 1
        start, end = run_start.clamp(min=0), jc + k - 1
    else:
        j = torch.where(ok, pos, -NEG).min(dim=1).values
        found = j < -NEG
        jc = j.clamp(0, npos - 1)
        nonpass = torch.where(~passing, pos, -NEG)
        rf = torch.flip(torch.cummin(torch.flip(nonpass, [1]), dim=1).values,
                        [1])
        run_end = (rf.gather(1, jc[:, None])[:, 0] - 1).clamp(max=npos - 1)
        start, end = jc, run_end + k - 1
    end = torch.minimum(end, lens - 1)
    cols = torch.arange(L, device=dev)[None, :]
    inseg = ((cols >= start[:, None]) & (cols <= end[:, None])
             & (seqs == base))
    first = torch.where(inseg, cols, -NEG).min(dim=1).values
    last = torch.where(inseg, cols, NEG).max(dim=1).values
    found = found & (last > NEG)
    start = torch.where(found, first, -1).to(torch.int32)
    end = torch.where(found, last, -1).to(torch.int32)
    return found, start, end


def internal_polyat(seqs: torch.Tensor, lens: torch.Tensor, *, base: int,
                    k: int, min_count: int, edge_exclusion: int):
    """Detect polyA/T runs away from both read ends (chimera evidence).

    Returns found [B] bool and the start position [B] int32 of the first
    internal passing window (-1 when none): a k-window with at least
    min_count `base` codes, inside the read and at least edge_exclusion
    bases from both ends."""
    B, L = seqs.shape
    dev = seqs.device
    if L < k:
        return (torch.zeros(B, dtype=torch.bool, device=dev),
                torch.full((B,), -1, dtype=torch.int32, device=dev))
    lens = lens.long()
    counts = _rolling_count((seqs == base).to(torch.int32), k)
    pos = torch.arange(L - k + 1, device=dev)[None, :]
    inread = pos <= (lens[:, None] - k)
    internal = ((pos >= edge_exclusion)
                & ((pos + k - 1) < (lens[:, None] - edge_exclusion)))
    ok = (counts >= min_count) & inread & internal
    j = torch.where(ok, pos, -NEG).min(dim=1).values
    found = j < -NEG
    return found, torch.where(found, j, -1).to(torch.int32)


def adapter_search_plain(windows: torch.Tensor, peq1, m: int):
    """One pattern (Peq [4, 1]) against each window row -> ed [B], end
    position [B] (int32; ties take the first position). Always the plain
    Myers sweep, on any device: the plain scan bodies that the kernels are
    compared with search through this one, never through a kernel."""
    ed, pos = editdist.myers_sweep(windows, peq1, m)
    return ed[:, 0], pos[:, 0]


def adapter_search(windows: torch.Tensor, peq1, m: int):
    """`adapter_search_plain`'s function by device: CPU tensors take the
    plain sweep, CUDA tensors the window-search kernel
    (`editdist.myers_win1`)."""
    return editdist.myers_win1(windows.contiguous(), peq1, m)


def _best_run_end(windows: torch.Tensor, pattern) -> torch.Tensor:
    """[B, W] longest co-linear exact match run of `pattern` ending at each
    window column: run[i, j] = pattern[i] == window[j] ? run[i-1, j-1] + 1
    : 0, maximised over i. N/PAD never match."""
    prev = torch.zeros(windows.shape, dtype=torch.int32, device=windows.device)
    best_end = prev.clone()
    for pc in np.asarray(pattern).tolist():
        eq = (windows == pc) & (pc < 4)
        cur = torch.where(eq, F.pad(prev[:, :-1], (1, 0)) + 1, 0)
        best_end = torch.maximum(best_end, cur)
        prev = cur
    return best_end


def match_run_stats(windows: torch.Tensor, pattern, m: int):
    """Longest and second-longest co-linear exact match runs of pattern in
    each window (TSO consecutive-match criteria); the second is taken off
    the window columns covered by the best run. Returns (best, second)."""
    B, W = windows.shape
    best_end = _best_run_end(windows, pattern)
    best, jbest = best_end.max(dim=1)
    cols = torch.arange(W, device=windows.device)[None, :]
    covered = (cols > (jbest - best)[:, None]) & (cols <= jbest[:, None])
    second = torch.where(covered, 0, best_end).max(dim=1).values
    return best, second


def bail_pairs(c1: int, c2: int) -> tuple[tuple[int, int], ...]:
    """Ordered (x, y) threshold pairs of the two-best bailout: a run >= x
    ending at least x columns after the end of a run >= y."""
    pairs = []
    for a in range((c2 + 1) // 2, min(c1, c2)):
        b = c2 - a
        if b < 1:
            continue
        for xy in {(a, b), (b, a)}:
            pairs.append(xy)
    return tuple(sorted(pairs))


def run_bailout(windows: torch.Tensor, pattern, m: int, c1: int, c2: int):
    """TSO consecutive-match bailout: True when the window holds an exact
    diagonal run >= c1, or two column-disjoint runs summing >= c2
    (decomposed into the threshold pairs of `bail_pairs`). Returns [B] bool."""
    if c2 < c1:
        raise ValueError("two-best threshold below single-run threshold")
    best_end = _best_run_end(windows, pattern)
    ok = (best_end >= c1).any(dim=1)
    for x, y in bail_pairs(c1, c2):
        ey = torch.cummax((best_end >= y).to(torch.int32), dim=1).values
        eyd = F.pad(ey[:, :-x], (x, 0))           # E_y at column j - x
        ok = ok | ((best_end >= x) & (eyd > 0)).any(dim=1)
    return ok


def peq_single(pattern: str | bytes | np.ndarray) -> tuple[np.ndarray, int]:
    """Build a [4, 1] Peq for a single ASCII pattern; returns (peq, m)."""
    codes = dna.encode(pattern) if isinstance(pattern, (str, bytes)) \
        else pattern
    return editdist.build_peq(codes[None, :]), len(codes)


def min_count_for(k: int, frac: float) -> int:
    """ceil(frac * k) as the integer pass threshold."""
    return int(np.ceil(frac * k - 1e-9))
