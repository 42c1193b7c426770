"""Myers bit-parallel edit distance: the semi-global sweep and the global
pairwise matrix in plain PyTorch, the single-pattern window search kernel
(csrc/win1.cu) and the UMI distance matrix kernel (csrc/pairwise.cu).

Port of `sicelore_tpu/ops/editdist.py` (`build_peq`, the Hyyrö column update,
`_eq_select`, `myers_sweep`, `best_two`, `myers_global_pairwise`,
`myers_win1_pallas`, and copies of its scalar numpy references
`levenshtein_np`, `semiglobal_ed_np`, `semiglobal_ed_np_batch`). Patterns are
Peq bitmasks: bit i of Peq[c, n] is set iff pattern n position i equals base
c. N and PAD text characters select an all-zero mask, so they never match.

Bit vectors are carried in int64 tensors (torch has no general uint32
arithmetic). Only bits 0..m-1 (m <= 32) are read, and in two's-complement
wraparound arithmetic the low 32 bits of every add, shift, and, or, xor and
not equal the uint32 result, so the high bits need no masking.
"""
from __future__ import annotations

import numpy as np
import torch

from sicelore_tpu_torch.ops import _build
from sicelore_tpu_torch.utils import dna

INT_MAX = 2**31 - 1  # reference reports ed_sec=2147483647 when none found
WIN1_MAX_W = 2**26   # csrc/win1.cu keys (score, column) in 32 bits


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


# ---------------------------------------------------------------------------
# Scalar numpy references
# ---------------------------------------------------------------------------

def levenshtein_np(a, b) -> int:
    """Plain Levenshtein distance between two code arrays / strings."""
    if isinstance(a, (str, bytes)):
        a = dna.encode(a)
    if isinstance(b, (str, bytes)):
        b = dna.encode(b)
    la, lb = len(a), len(b)
    prev = np.arange(lb + 1)
    for i in range(1, la + 1):
        cur = np.empty(lb + 1, dtype=np.int64)
        cur[0] = i
        for j in range(1, lb + 1):
            cost = 0 if (a[i - 1] == b[j - 1] and a[i - 1] < 4) else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return int(prev[lb])


def semiglobal_ed_np(pattern, text) -> tuple[int, int]:
    """Min ED of pattern vs any substring of text; returns (ed, end_pos).

    end_pos is the 0-based index of the last text char of the best match
    (first position on ties, matching the device kernel)."""
    if isinstance(pattern, (str, bytes)):
        pattern = dna.encode(pattern)
    if isinstance(text, (str, bytes)):
        text = dna.encode(text)
    m, w = len(pattern), len(text)
    col = np.arange(m + 1)  # D[i][0] = i
    best, best_pos = m, -1
    for j in range(1, w + 1):
        newcol = np.empty(m + 1, dtype=np.int64)
        newcol[0] = 0  # free text start
        for i in range(1, m + 1):
            cost = 0 if (pattern[i - 1] == text[j - 1]
                         and pattern[i - 1] < 4) else 1
            newcol[i] = min(col[i] + 1, newcol[i - 1] + 1, col[i - 1] + cost)
        col = newcol
        if col[m] < best:
            best, best_pos = int(col[m]), j - 1
    return best, best_pos


def semiglobal_ed_np_batch(patterns: np.ndarray, texts: np.ndarray):
    """Vectorized numpy reference of `myers_sweep`.

    patterns [N, m] int8, texts [B, W] int8 -> (ed [B, N], end_pos [B, N]).
    """
    N, m = patterns.shape
    B, W = texts.shape
    col = np.broadcast_to(np.arange(m + 1)[None, None, :],
                          (B, N, m + 1)).copy()
    best = np.full((B, N), m, dtype=np.int64)
    best_pos = np.full((B, N), -1, dtype=np.int64)
    for j in range(W):
        tc = texts[:, j][:, None, None]  # [B,1,1]
        match = ((patterns[None, :, :] == tc) & (patterns[None, :, :] < 4)
                 & (tc < 4))
        newcol = np.empty_like(col)
        newcol[:, :, 0] = 0
        for i in range(1, m + 1):
            newcol[:, :, i] = np.minimum(
                np.minimum(col[:, :, i] + 1, newcol[:, :, i - 1] + 1),
                col[:, :, i - 1] + (~match[:, :, i - 1]).astype(np.int64))
        col = newcol
        better = col[:, :, m] < best
        best_pos = np.where(better, j, best_pos)
        best = np.where(better, col[:, :, m], best)
    return best, best_pos


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


def myers_win1_plain(windows: torch.Tensor, peq1: np.ndarray, m: int):
    """Plain PyTorch single-pattern window search: `myers_sweep` with one
    pattern, sliced to it. windows [B, W] int8 -> (ed [B], end_pos [B])."""
    myers_win1_plain.launches += 1
    ed, pos = myers_sweep(windows, peq1, m)
    return ed[:, 0], pos[:, 0]


myers_win1_plain.launches = 0


def myers_win1(windows: torch.Tensor, peq1: np.ndarray, m: int):
    """Single-pattern semi-global search over each window row.

    windows [B, W] int8 codes 0..5 (any B >= 0, W >= 1; on the card W <=
    WIN1_MAX_W), peq1 [4, 1] uint32
    Peq (`build_peq`) of one pattern of 1 <= m <= 32 bases. Returns (ed [B]
    int32, end_pos [B] int32): the best edit distance and the 0-based column
    where that match ends, the first column on ties, (m, -1) when no column
    improved on m.
    CPU tensors take the plain version; CUDA tensors launch csrc/win1.cu."""
    if windows.dim() != 2 or windows.shape[1] < 1:
        raise ValueError(f"windows must be [B, W >= 1], "
                         f"got {tuple(windows.shape)}")
    if not 1 <= m <= 32:
        raise ValueError(f"pattern length must be 1..32, got {m}")
    if peq1.shape != (4, 1) or peq1.dtype != np.uint32:
        raise ValueError(f"peq1 must be uint32 [4, 1], got {peq1.dtype} "
                         f"{peq1.shape}")
    if windows.device.type == "cpu":
        return myers_win1_plain(windows, peq1, m)
    if windows.dtype != torch.int8 or not windows.is_contiguous():
        raise ValueError("windows must be contiguous int8")
    B, W = windows.shape
    if W > WIN1_MAX_W:
        raise ValueError(f"the kernel takes windows of up to {WIN1_MAX_W} "
                         f"columns, got {W}")
    out = torch.empty((2, B), dtype=torch.int32, device=windows.device)
    if B == 0:
        return out.unbind(0)
    a, c, g, t = peq1[:, 0].view(np.int32).tolist()
    fn = _build.bind("win1", "win1_launch", 2, 7)
    _build.launch(fn, "win1", windows.device, windows.data_ptr(),
                  out.data_ptr(), B, W, m, a, c, g, t)
    myers_win1.launches += 1
    return out.unbind(0)


myers_win1.launches = 0


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


def myers_global_pairwise(peq_g: np.ndarray, texts: torch.Tensor,
                          tlens: torch.Tensor, m: int) -> torch.Tensor:
    """Global Levenshtein of pattern i against text j for all pairs of each
    group: the UMI-clustering distance matrix.

    peq_g [G, 4, P] uint32 Peq of the P patterns of each group (`build_peq`
    per group), texts [G, K, L] int8 codes, tlens [G, K] true text
    lengths, m the patterns' length (1..32). Returns
    ed [G, P, K] int32, ed[g, i, j] = Levenshtein(pattern i, text j); the
    score is taken after column tlens[g, j], so entries of empty texts stay
    at m. N and PAD select no pattern bit: N matches nothing, N included.
    Plain PyTorch on either device (the JAX function is a jnp scan, not a
    Pallas kernel); `.launches` counts its calls."""
    if not 1 <= m <= 32:
        raise ValueError(f"pattern length must be 1..32, got {m}")
    if texts.dim() != 3 or tlens.shape != texts.shape[:2]:
        raise ValueError(f"texts must be [G, K, L] and tlens [G, K], got "
                         f"{tuple(texts.shape)} and {tuple(tlens.shape)}")
    myers_global_pairwise.launches += 1
    dev = texts.device
    peq_g = torch.from_numpy(peq_g.astype(np.int64)).to(dev)
    G, K, L = texts.shape
    P = peq_g.shape[2]
    # [G, 6, P]: rows 4 and 5 (N, PAD) select no bit
    peq6 = torch.cat([peq_g, torch.zeros((G, 2, P), dtype=torch.int64,
                                         device=dev)], dim=1)
    tl = tlens.to(device=dev, dtype=torch.int64)
    # the state is carried [G, K, P] (one gather a column) and transposed
    # at the end
    PV = torch.full((G, K, P), (1 << m) - 1, dtype=torch.int64, device=dev)
    MV = torch.zeros_like(PV)
    score = torch.full((G, K, P), m, dtype=torch.int32, device=dev)
    out = score.clone()
    tx = texts.to(torch.int64)
    for t in range(L):
        idx = tx[:, :, t, None].expand(G, K, P)
        eq = torch.gather(peq6, 1, idx)
        PV, MV, score = hyyro_step(PV, MV, score, eq, m - 1, 1)
        out = torch.where((tl == t + 1)[:, :, None], score, out)
    return out.transpose(1, 2).contiguous()


myers_global_pairwise.launches = 0


def pairwise_inputs(peq: np.ndarray, mlens: np.ndarray, texts: np.ndarray,
                    tlens: np.ndarray, device):
    """One group's inputs of `myers_global_rows` on `device` in one upload:
    peq [4, K] uint32, mlens [K], texts [K, L] int8 codes and tlens [K] are
    packed into one int32 buffer on the host, copied once, and returned as
    views of it (peq as int32 [4, K], mlens and tlens int32 [K], texts int8
    [K, L])."""
    K, L = texts.shape
    nw = (K * L + 3) // 4 + 1      # + 1: the texts' view is never empty
    buf = np.zeros(6 * K + nw, np.int32)
    buf[:4 * K] = np.ascontiguousarray(peq, np.uint32).view(np.int32).ravel()
    buf[4 * K:5 * K] = mlens
    buf[5 * K:6 * K] = tlens
    buf[6 * K:].view(np.int8)[:K * L] = np.ascontiguousarray(texts).ravel()
    t = torch.from_numpy(buf).to(device)
    return (t[:4 * K].view(4, K), t[4 * K:5 * K], t[6 * K:].view(
        torch.int8)[:K * L].view(K, L), t[5 * K:6 * K])


def myers_global_rows_plain(peq: torch.Tensor, mlens: torch.Tensor,
                            texts: torch.Tensor, tlens: torch.Tensor):
    """Plain version of `myers_global_rows`: one `myers_global_pairwise`
    call for each pattern length of 1..32 nt among the rows; the other rows
    stay 0."""
    myers_global_rows_plain.launches += 1
    K = texts.shape[0]
    d = torch.zeros((K, K), dtype=torch.int32, device=texts.device)
    peq_np = peq.cpu().numpy().view(np.uint32)
    ml = mlens.cpu().numpy()
    for m in np.unique(ml).tolist():
        if not 1 <= m <= 32:
            continue
        rows = np.nonzero(ml == m)[0]
        sub = np.ascontiguousarray(peq_np[:, rows])[None]
        out = myers_global_pairwise(sub, texts[None], tlens[None], m)
        d[torch.from_numpy(rows).to(d.device)] = out[0]
    return d


myers_global_rows_plain.launches = 0


def myers_global_rows(peq: torch.Tensor, mlens: torch.Tensor,
                      texts: torch.Tensor, tlens: torch.Tensor):
    """The UMI distance matrix of one group, every pattern length at once.

    peq [4, K] int32 (the uint32 Peq bits of `build_peq`, row i's pattern
    in column i), mlens [K] int32 the pattern lengths, texts [K, L] int8
    codes (L >= 1), tlens [K] int32 the true text lengths (0..L). Returns d
    [K, K] int32: d[i, j] = the global distance of pattern i against text
    j, as `myers_global_pairwise` gives it (N and PAD match nothing; the
    score after column tlens[j]); rows with mlens outside 1..32 are 0 (the
    caller's host rows). CPU tensors take the plain version; CUDA tensors
    launch csrc/pairwise.cu (all on one device, contiguous)."""
    if texts.dim() != 2 or texts.shape[1] < 1:
        raise ValueError(f"texts must be [K, L >= 1], "
                         f"got {tuple(texts.shape)}")
    K = texts.shape[0]
    if (peq.shape != (4, K) or mlens.shape != (K,)
            or tlens.shape != (K,)):
        raise ValueError(f"peq must be [4, K], mlens and tlens [K] for K = "
                         f"{K}, got {tuple(peq.shape)}, "
                         f"{tuple(mlens.shape)}, {tuple(tlens.shape)}")
    if texts.device.type == "cpu":
        return myers_global_rows_plain(peq, mlens, texts, tlens)
    if (peq.dtype, mlens.dtype, texts.dtype, tlens.dtype) != (
            torch.int32, torch.int32, torch.int8, torch.int32):
        raise ValueError("peq, mlens and tlens must be int32, texts int8")
    ts = (peq, mlens, texts, tlens)
    if any(t.device != texts.device or not t.is_contiguous() for t in ts):
        raise ValueError("the inputs must be contiguous, on one device")
    out = torch.empty((K, K), dtype=torch.int32, device=texts.device)
    if K == 0:
        return out
    fn = _build.bind("pairwise", "pairwise_launch", 5, 2)
    _build.launch(fn, "pairwise", texts.device, peq.data_ptr(),
                  mlens.data_ptr(), texts.data_ptr(), tlens.data_ptr(),
                  out.data_ptr(), K, texts.shape[1])
    myers_global_rows.launches += 1
    return out


myers_global_rows.launches = 0
