"""Myers bit-parallel edit distance: the semi-global sweep and the global
pairwise matrix in plain PyTorch, the single-pattern window search kernel
(csrc/win1.cu) and the UMI distance matrix kernel (csrc/pairwise.cu), which
takes a group's raw bytes.

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


def group_buffer(umis: list[bytes]) -> np.ndarray:
    """A UMI group as one int32 host buffer: its offsets (the cumulative
    sum of the lengths, K + 1 words padded to 16 bytes), then its UMIs
    joined. `group_views` cuts it into `myers_global_group`'s inputs."""
    K = len(umis)
    raw = b"".join(umis)
    no = (K + 4) // 4 * 4
    buf = np.zeros(no + (len(raw) + 3) // 4, np.int32)
    np.cumsum(np.fromiter(map(len, umis), np.int32, K), out=buf[1:K + 1])
    buf.view(np.uint8)[4 * no:4 * no + len(raw)] = np.frombuffer(raw,
                                                                 np.uint8)
    return buf


def group_views(buf: torch.Tensor, K: int, S: int):
    """(raw uint8 [S], offs int32 [K + 1]): views of a `group_buffer` of K
    UMIs of S bytes in all, on its device, both 16-byte aligned."""
    no = (K + 4) // 4 * 4
    return buf.view(torch.uint8)[4 * no:4 * no + S], buf[:K + 1]


def group_inputs(umis: list[bytes], device):
    """A UMI group's inputs of `myers_global_group` on `device` in one
    upload: (raw, offs) of its `group_buffer`, copied once, and the
    offsets on the host (host_offs), which the checks read."""
    buf = group_buffer(umis)
    K = len(umis)
    return (*group_views(torch.from_numpy(buf).to(device), K, int(buf[K])),
            buf[:K + 1])


def myers_global_rows_plain(peq: torch.Tensor, mlens: torch.Tensor,
                            texts: torch.Tensor, tlens: torch.Tensor):
    """The distance rows of a group, every pattern length at once: peq [4,
    K] int32 (the uint32 Peq bits of `build_peq`, row i's pattern in column
    i), mlens [K] the pattern lengths, texts [K, L] int8 codes and tlens
    [K] the text lengths. Returns d [K, K] int32, d[i, j] = the global
    distance of pattern i against text j: one `myers_global_pairwise` call
    for each pattern length of 1..32 nt among the rows; the other rows stay
    0. The oracle under `myers_global_group_plain`."""
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


def _group_sizes(raw: torch.Tensor, offs: torch.Tensor,
                 host_offs=None) -> tuple[int, int]:
    """(K, S) of `myers_global_group`'s inputs; raises ValueError on what
    it does not take. The offsets' values are checked in `host_offs` (the
    same offsets on the host, a numpy array or a CPU tensor; by default
    `offs` itself where it lies on the CPU): a CUDA call that read `offs`
    back would wait for the card."""
    if raw.dim() != 1 or raw.dtype != torch.uint8:
        raise ValueError(f"raw must be uint8 [S], got {raw.dtype} "
                         f"{tuple(raw.shape)}")
    if offs.dim() != 1 or offs.numel() < 1 or offs.dtype != torch.int32:
        raise ValueError(f"offs must be int32 [K + 1], got {offs.dtype} "
                         f"{tuple(offs.shape)}")
    if raw.device != offs.device:
        raise ValueError(f"raw and offs must be on one device, got "
                         f"{raw.device} and {offs.device}")
    if host_offs is None:
        if offs.device.type != "cpu":
            raise ValueError(f"offs on {offs.device} need host_offs, the "
                             f"same offsets on the host")
        host_offs = offs
    o = np.asarray(host_offs)
    if o.shape != tuple(offs.shape):
        raise ValueError(f"host_offs must be offs on the host, got shape "
                         f"{o.shape} for {tuple(offs.shape)}")
    S = raw.numel()
    falls = int((o[1:] < o[:-1]).sum())
    if o[0] != 0 or o[-1] != S or falls:
        raise ValueError(f"offs must rise from 0 to S = {S} without a "
                         f"fall, got {o[0]} .. {o[-1]} with {falls} falls")
    return offs.numel() - 1, S


def myers_global_group_plain(raw: torch.Tensor, offs: torch.Tensor,
                             host_offs=None):
    """Plain version of `myers_global_group`: the bytes mapped by
    `dna._ENC` as an index, Peq built with tensor ops, then
    `myers_global_rows_plain` (a `myers_global_pairwise` call a pattern
    length)."""
    myers_global_group_plain.launches += 1
    K, S = _group_sizes(raw, offs, host_offs)
    dev = raw.device
    o = offs.long()
    lens = o[1:] - o[:-1]
    L = max(1, int(lens.max())) if K else 1
    col = torch.arange(L, device=dev)
    inside = col[None, :] < lens[:, None]
    pos = (o[:-1, None] + col[None, :]).clamp(max=max(S - 1, 0))
    byte = raw[pos].long() if S else torch.zeros_like(pos)
    enc = torch.from_numpy(dna._ENC).to(dev)
    texts = torch.where(inside, enc[byte], dna.PAD)
    m32 = min(L, 32)
    hit = texts[:, :m32, None] == torch.arange(4, device=dev)
    peq = (hit.long() << col[:m32, None]).sum(1).T       # [4, K] uint32 bits
    peq = torch.where(peq >= 2**31, peq - 2**32, peq).to(torch.int32)
    return myers_global_rows_plain(peq, lens.int(), texts, lens.int())


myers_global_group_plain.launches = 0


def myers_global_group(raw: torch.Tensor, offs: torch.Tensor,
                       host_offs=None):
    """The UMI distance matrix of one group from its raw bytes.

    raw uint8 [S], the group's UMIs concatenated; offs int32 [K + 1], their
    offsets (from 0, non-decreasing, ending at S); host_offs, the same
    offsets on the host, which the checks read (needed where offs lies on
    the card; `group_inputs` gives all three). Bytes map as `dna._ENC` (A,
    C, G, T in either case to 0..3, every other byte to N, which matches
    nothing); texts of any length. Returns d [K, K] int32: d[i, j] = the
    global distance of UMI i as a pattern against UMI j as a text; rows
    whose pattern is outside 1..32 nt hold 0 (the caller's host rows).
    CPU tensors take the plain version; CUDA tensors launch
    csrc/pairwise.cu (contiguous, both 16-byte aligned), with no wait for
    the card."""
    if raw.device.type == "cpu":
        return myers_global_group_plain(raw, offs, host_offs)
    K, S = _group_sizes(raw, offs, host_offs)
    if not (raw.is_contiguous() and offs.is_contiguous()) or (
            raw.data_ptr() % 16 or offs.data_ptr() % 16):
        raise ValueError("raw and offs must be contiguous and 16-byte "
                         "aligned")
    out = torch.empty((K, K), dtype=torch.int32, device=raw.device)
    if K == 0:
        return out
    fn = _build.bind("pairwise", "pairwise_launch", 3, 2)
    _build.launch(fn, "pairwise", raw.device, raw.data_ptr(),
                  offs.data_ptr(), out.data_ptr(), K, S)
    myers_global_group.launches += 1
    return out


myers_global_group.launches = 0
