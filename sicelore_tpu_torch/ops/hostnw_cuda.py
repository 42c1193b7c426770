"""The host consensus engine's banded alignment on the card: the wrapper of
csrc/hostnw.cu, its plain PyTorch version, `align_pairs` (a batch of
(center, read) pairs up, aligned, their moves down) and `CenterStar`, which
builds the host engine's center-star MSAs from those moves.

The host engine (`ops.poa.consensus_reads`) aligns every read of a molecule
to its longest read with `poa.nw_align_banded`, merges the alignments into
the rows of `poa.msa_center_star` and votes with `poa.consensus_from_msa`.
The batched engine sends it the molecules of three or more reads it does not
take itself (a non-ACGT byte, a long center, no pair left, an assembly too
long). For those, `CenterStar` gives the same rows with the pairwise
alignments made in one launch: `host_nw` takes every pair of every such
molecule and returns, for each, exactly the moves `nw_align_banded` takes
(the contract is in csrc/hostnw.cu), and the rows are built from the moves
with NumPy indexing and cumulative sums. `poa.consensus_from_msa` then votes
on them unchanged, so every consensus and quality string is the host
engine's, byte for byte.

A pair table (`pair_table`) is int64 [P, 6]: a_off, la, b_off, lb (the
center and the read in the packed bytes), slab_off (the pair's int32 score
rows, la of them at a stride of min(2 band + 1, lb)) and mv_off (its moves,
la + lb bytes). Moves: DIAG 0, UP 1 (a center base against a gap), LEFT 2
(a read base inserted), stored from the end of the alignment.
"""
from __future__ import annotations

import numpy as np
import torch

from sicelore_tpu_torch.ops import _build, poa
from sicelore_tpu_torch.utils import trace

MATCH, MISMATCH, GAP, NEG = poa.MATCH, poa.MISMATCH, poa.GAP, poa.NEG
DIAG, UP, LEFT = 0, 1, 2
WALK_INTS = 8192          # shared-memory ints a block keeps for its walk
# the most shared-memory ints a block keeps for its rows (232,448 bytes a
# block at most, the walk's 256 row starts beside them): a pair whose two
# score rows (2 x min(2 band + 1, lb)) are wider keeps its rows in the slab
SMEM_INTS = 57_344
SLAB_BYTES = 1 << 31      # score rows of one launch; more pairs, more launches
_GAP_BYTE = ord("-")


def strides(la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    """Ints a score row of each pair: min(2 band + 1, lb), with the host's
    band max(32, |la - lb| + max(la, lb) // 10); 0 where la or lb is 0
    (the host returns before any matrix)."""
    la, lb = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    band = np.maximum(32, np.abs(la - lb) + np.maximum(la, lb) // 10)
    return np.where((la > 0) & (lb > 0), np.minimum(2 * band + 1, lb), 0)


def _exclusive(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x), np.int64)
    np.cumsum(x[:-1], out=out[1:])
    return out


def pair_table(a_off, la, b_off, lb) -> np.ndarray:
    """The pair table of the pairs (int64 [P, 6]: a_off, la, b_off, lb,
    slab_off, mv_off), the score rows and the moves laid out one pair after
    the other."""
    la, lb = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    return np.stack([np.asarray(a_off, np.int64), la,
                     np.asarray(b_off, np.int64), lb,
                     _exclusive(la * strides(la, lb)), _exclusive(la + lb)],
                    axis=1).reshape(-1, 6)


def _sizes(seq: torch.Tensor, table: torch.Tensor, host_table=None):
    """(P, S, slab ints, move bytes, widest stride) of `host_nw`'s inputs;
    raises ValueError on what it does not take. The table's values are
    checked in `host_table` (the same table on the host; by default `table`
    itself where it lies on the CPU): a check that read the card's copy
    back would wait for the card."""
    if seq.dim() != 1 or seq.dtype != torch.uint8 or seq.numel() < 1:
        raise ValueError(f"seq must be uint8 [S], S >= 1, got {seq.dtype} "
                         f"{tuple(seq.shape)}")
    if table.dim() != 2 or table.shape[1] != 6 or table.dtype != torch.int64:
        raise ValueError(f"table must be int64 [P, 6], got {table.dtype} "
                         f"{tuple(table.shape)}")
    if seq.device != table.device:
        raise ValueError(f"seq and table must be on one device, got "
                         f"{seq.device} and {table.device}")
    if host_table is None:
        if table.device.type != "cpu":
            raise ValueError(f"a table on {table.device} needs host_table, "
                             f"the same table on the host")
        host_table = table
    h = np.asarray(host_table)
    if h.shape != tuple(table.shape):
        raise ValueError(f"host_table must be the table on the host, got "
                         f"shape {h.shape} for {tuple(table.shape)}")
    S = seq.numel()
    a_off, la, b_off, lb = h[:, 0], h[:, 1], h[:, 2], h[:, 3]
    if ((a_off < 0) | (la < 0) | (b_off < 0) | (lb < 0) | (a_off + la > S)
            | (b_off + lb > S)).any():
        raise ValueError(f"every center and read must lie in seq (S = {S})")
    if not np.array_equal(h, pair_table(a_off, la, b_off, lb)):
        raise ValueError("slab_off and mv_off must be pair_table's layout")
    st = strides(la, lb)
    return (len(h), S, int((la * st).sum()), int((la + lb).sum()),
            int(st.max(initial=0)))


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU tests, and the yardstick the kernel is held to)
# ---------------------------------------------------------------------------

def host_nw_plain(seq: torch.Tensor, table: torch.Tensor, host_table=None):
    """`host_nw` in plain PyTorch. The pairs go in classes of centers of
    one bit length, each class at once: the forward pass a center row at a
    time over the pairs' windows (int32, the kernel's arithmetic) into the
    class's score rows, then the walk a move at a time over the pairs."""
    host_nw_plain.launches += 1
    P, _, _, n_bytes, _ = _sizes(seq, table, host_table)
    dev = seq.device
    a_off, la, b_off, lb, _, mv_off = table.long().unbind(1)
    moves = torch.zeros(n_bytes, dtype=torch.int8, device=dev)
    n = torch.zeros(P, dtype=torch.int32, device=dev)
    # the host's early returns: la == 0 -> lb left moves, lb == 0 -> la up
    early = (la == 0) | (lb == 0)
    if bool(early.any()):
        cnt = torch.where(la == 0, lb, la)[early]
        at = torch.repeat_interleave(mv_off[early], cnt)
        first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        step = torch.arange(at.numel(), device=dev) - first
        moves[at + step] = torch.repeat_interleave(
            torch.where(la == 0, LEFT, UP)[early], cnt).to(torch.int8)
        n[early] = cnt.int()
    bits = np.asarray(host_table if host_table is not None
                      else table)[:, 1].astype(np.int64)
    bits = np.where(~early.cpu().numpy(), np.floor(np.log2(np.maximum(
        bits, 1))).astype(np.int64), -1)
    for c in np.unique(bits[bits >= 0]):
        q = torch.from_numpy(np.nonzero(bits == c)[0]).to(dev)
        n[q] = _align_plain(seq, a_off[q], la[q], b_off[q], lb[q],
                            mv_off[q], moves)
    return moves, n


host_nw_plain.launches = 0


def _align_plain(seq, a_off, la, b_off, lb, mv_off, moves):
    """One class of pairs (la, lb > 0): writes their moves, returns their
    counts (int32)."""
    dev = seq.device
    S = seq.numel()
    i32 = torch.int32
    band = torch.clamp_min((la - lb).abs() + torch.maximum(la, lb) // 10, 32)
    row0 = torch.minimum(lb, band)
    ratio = lb.double() / la.double()
    Q, Lm = la.numel(), int(la.max())
    Wm = int(torch.minimum(2 * band + 1, lb).max())
    # every row's window: columns J0 .. J0 + WR - 1
    c = torch.round(ratio[:, None] * torch.arange(Lm + 1, device=dev)).long()
    J0 = torch.clamp_min(c - band[:, None], 1)
    WR = torch.minimum(lb[:, None], c + band[:, None]) - J0 + 1
    H = torch.full((Q, Lm + 1, Wm), NEG, dtype=i32, device=dev)  # row 0: none
    k = torch.arange(Wm, device=dev)
    kp = torch.arange(Wm + 1, device=dev)
    match = torch.tensor(MATCH, dtype=i32, device=dev)
    mismatch = torch.tensor(MISMATCH, dtype=i32, device=dev)
    low = torch.tensor(torch.iinfo(i32).min, dtype=i32, device=dev)

    # ---- forward: row i of every pair from its row i-1 ----
    for i in range(1, Lm + 1):
        j0 = J0[:, i]
        jp = j0[:, None] - 1 + kp[None, :]     # columns j0 - 1 .. j0 + Wm - 1
        if i == 1:
            pv = torch.where(jp <= row0[:, None], jp * GAP, NEG)
        else:
            kk = jp - J0[:, i - 1, None]
            inw = (kk >= 0) & (kk < WR[:, i - 1, None])
            pv = torch.where(inw, H[:, i - 1].gather(1, kk.clamp(0, Wm - 1)),
                             NEG)
        pv = torch.where(jp == 0, (i - 1) * GAP, pv).to(i32)
        j = jp[:, 1:]
        ai = seq[(a_off + i - 1).clamp(max=S - 1)]
        bj = seq[(b_off[:, None] + j - 1).clamp(0, S - 1)]
        sub = torch.where(bj == ai[:, None], match, mismatch)
        best = torch.maximum(pv[:, :-1] + sub, pv[:, 1:] + GAP)
        best = torch.where(j == 1, torch.clamp_min(best, i * GAP + GAP), best)
        jg = (j * GAP).to(i32)
        valid = k[None, :] < WR[:, i, None]
        run = torch.cummax(torch.where(valid, best - jg, low), 1).values
        H[:, i] = torch.where(valid, torch.maximum(best, run + jg), NEG)

    # ---- walk-back: one move a step for every pair ----
    qi = torch.arange(Q, device=dev)

    def at(r, cc):
        """H[r][cc] of every pair as the host's matrix holds it (r, cc:
        [..., Q])."""
        rc = r.clamp(0, Lm)
        kk = cc - J0[qi, rc]
        inw = (r >= 1) & (cc >= 1) & (kk >= 0) & (kk < Wm)
        v = torch.where(inw, H[qi, rc, kk.clamp(0, Wm - 1)].long(), NEG)
        v = torch.where(r == 0, torch.where(cc <= row0, cc * GAP, NEG), v)
        return torch.where(cc == 0, r * GAP, v)

    i, j = la.clone(), lb.clone()
    nq = torch.zeros(Q, dtype=torch.int64, device=dev)
    while True:
        live = (i > 0) | (j > 0)
        if not bool(live.any()):
            break
        im, jm = (i - 1).clamp(min=0), (j - 1).clamp(min=0)
        hi, hj = i > 0, j > 0
        # the cell and its diagonal, up and left neighbours in one lookup
        v, vd, vu, vl = at(torch.stack([i, im, im, i]),
                           torch.stack([j, jm, j, jm]))
        sub = torch.where(seq[(a_off + im).clamp(max=S - 1)]
                          == seq[(b_off + jm).clamp(max=S - 1)],
                          MATCH, MISMATCH)
        d = hi & hj & (v == vd + sub)
        u = ~d & hi & (v == vu + GAP)
        left = ~d & ~u & hj & (v == vl + GAP)
        fall = ~(d | u | left)        # the host's out-of-band fallback
        d = d | (fall & hi & hj)
        u = u | (fall & hi & ~hj)
        move = torch.where(d, DIAG, torch.where(u, UP, LEFT))
        moves[(mv_off + nq)[live]] = move[live].to(torch.int8)
        nq = nq + live.long()
        i = i - (live & (move != LEFT)).long()
        j = j - (live & (move != UP)).long()
    return nq.int()


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def host_nw(seq: torch.Tensor, table: torch.Tensor, host_table=None):
    """Align every pair of `table` as `poa.nw_align_banded(a, b)` does.

    seq uint8 [S] (S >= 1), the packed bytes; table int64 [P, 6], a
    `pair_table`; host_table, the same table on the host, which the checks
    and the sizes read (needed where table lies on the card). Returns
    (moves int8 [sum(la + lb)], n_moves int32 [P]): pair p's moves are
    moves[mv_off, mv_off + n_moves[p]), from the end of its alignment.
    CPU tensors take the plain version; CUDA tensors launch
    csrc/hostnw.cu once, with no wait for the card, or raise."""
    if seq.device.type == "cpu":
        return host_nw_plain(seq, table, host_table)
    P, S, slab_ints, n_bytes, widest = _sizes(seq, table, host_table)
    if not (seq.is_contiguous() and table.is_contiguous()):
        raise ValueError("seq and table must be contiguous")
    dev = seq.device
    moves = torch.empty(n_bytes, dtype=torch.int8, device=dev)
    n = torch.empty(P, dtype=torch.int32, device=dev)
    if P == 0:
        return moves, n
    slab = torch.empty(max(slab_ints, 1), dtype=torch.int32, device=dev)
    fn = _build.bind("hostnw", "hostnw_launch", 5, 2)
    _build.launch(fn, "hostnw", dev, seq.data_ptr(), table.data_ptr(),
                  slab.data_ptr(), moves.data_ptr(), n.data_ptr(), P,
                  min(max(2 * widest, WALK_INTS), SMEM_INTS))
    host_nw.launches += 1
    return moves, n


host_nw.launches = 0


def align_pairs(seq: np.ndarray, a_off, la, b_off, lb, device):
    """The moves of every pair on `device`: (moves int8, n_moves int32 [P],
    mv_off int64 [P]), pair p's moves at moves[mv_off[p], mv_off[p] +
    n_moves[p]) from the end of its alignment.

    seq: the packed bytes (uint8, writable). The pairs go up with the bytes,
    run in one call of `host_nw` (one more for each further SLAB_BYTES of
    score rows) and come down in one copy of each output: on a CUDA device
    a launch of csrc/hostnw.cu, on a CPU device the plain version.

    Traced (`utils.trace`): one `hostnw.align` span around the table, the
    upload, every call and every download (attributes `pairs`,
    `launches`), and for each call of `host_nw` the counters
    `hostnw.pairs`, `hostnw.band_cells` (the cells `nw_align_banded` fills:
    la x `strides` a pair) and `hostnw.move_bytes` (la + lb a pair: the
    bytes of seq its pairs read and of moves it writes)."""
    with trace.span("hostnw.align") as sp:
        device = torch.device(device)
        table = pair_table(a_off, la, b_off, lb)
        P = len(table)
        moves = np.zeros(int(table[:, 1].sum() + table[:, 3].sum()), np.int8)
        n = np.zeros(P, np.int32)
        cells = table[:, 1] * strides(table[:, 1], table[:, 3])
        if not len(seq):
            seq = np.zeros(1, np.uint8)
        seq_t = torch.from_numpy(seq).to(device)
        # launches of about SLAB_BYTES of score rows each
        cuts = np.unique(np.cumsum(cells * 4) // SLAB_BYTES,
                         return_index=True)[1][1:]
        groups = np.split(np.arange(P), cuts)
        for g in groups:
            sub = pair_table(*table[g, :4].T)
            mv, cnt = host_nw(seq_t, torch.from_numpy(sub).to(device), sub)
            if trace.ON:
                trace.count("hostnw.pairs", len(g))
                trace.count("hostnw.band_cells", int(cells[g].sum()))
                trace.count("hostnw.move_bytes",
                            int(sub[:, 1].sum() + sub[:, 3].sum()))
            mv, cnt = mv.cpu().numpy(), cnt.cpu().numpy()
            # the group's moves at the pairs' places in the whole layout
            shift = np.repeat(table[g, 5] - sub[:, 5], sub[:, 1] + sub[:, 3])
            moves[np.arange(len(mv)) + shift] = mv
            n[g] = cnt
        sp.set(pairs=P, launches=len(groups))
    return moves, n, table[:, 5]


# ---------------------------------------------------------------------------
# the center-star rows
# ---------------------------------------------------------------------------

class CenterStar:
    """The rows of `poa.msa_center_star` for each of a list of molecules of
    three or more reads, its pairwise alignments made on `device` by
    `align_pairs`.

    Each molecule's center is its longest read (the first of equal length)
    and every other read forms a pair with it. The reads go into one buffer
    with offsets, the pairs are aligned, and the rows are built from the
    moves of every pair at once: a diagonal or up move puts the read's base
    (or a gap) in its center position's column, a left move puts the read's
    base in the insertion columns before the center position it stands
    at, which are as many as the molecule's longest insertion there.
    `rows(m)` gives molecule m's rows in read order; `pair_mol` says each
    pair's molecule, `where` where the pairs were aligned (`card` on a CUDA
    device, else `host`). Traced, the row build is one `hostnw.rows` span
    (attributes `molecules`, `pairs`), after `align_pairs`' `hostnw.align`."""

    def __init__(self, mols: list[list[bytes]], device):
        M = len(mols)
        nreads = np.fromiter(map(len, mols), np.int64, M)
        if not M or nreads.min() < 3:
            raise ValueError("CenterStar takes one or more molecules of "
                             "three or more reads")
        reads = [s for m in mols for s in m]
        lens = np.fromiter(map(len, reads), np.int64, len(reads))
        seq = np.frombuffer(bytearray(b"".join(reads)), np.uint8)
        off, first = _exclusive(lens), _exclusive(nreads)
        mol_of = np.repeat(np.arange(M), nreads)
        N = len(reads)
        top = np.maximum.reduceat(lens, first)
        center = np.minimum.reduceat(np.where(lens == top[mol_of],
                                              np.arange(N), N), first)
        b_idx = np.nonzero(np.arange(N) != center[mol_of])[0]
        a_idx = center[mol_of[b_idx]]
        moves, n, mv_off = align_pairs(
            seq, off[a_idx], lens[a_idx], off[b_idx], lens[b_idx], device)
        self.pair_mol = mol_of[b_idx]
        self.where = "card" if torch.device(device).type == "cuda" else "host"
        # the rows, built from every pair's moves at once
        with trace.span("hostnw.rows", molecules=M, pairs=len(b_idx)):
            # every pair's moves in forward order, one after the other
            P = len(b_idx)
            pid = np.repeat(np.arange(P), n)
            start = _exclusive(n.astype(np.int64))
            t = np.arange(len(pid)) - start[pid]
            fwd = moves[mv_off[pid] + n[pid] - 1 - t]
            on_a, on_b = fwd != LEFT, fwd != UP
            ex_a = np.cumsum(on_a) - on_a
            ex_b = np.cumsum(on_b) - on_b
            pos = ex_a - ex_a[start[pid]]              # center bases before it
            bpos = ex_b - ex_b[start[pid]]             # read bases before it
            byte = np.where(on_b, seq[np.minimum(off[b_idx][pid] + bpos,
                                                 len(seq) - 1)], _GAP_BYTE)
            # insertion slots: slot s of a molecule stands before center base s
            lc = lens[center]
            slot0 = _exclusive(lc + 1)
            key = slot0[self.pair_mol[pid]] + pos
            k = np.arange(len(fwd))
            last = np.maximum.accumulate(np.where(on_a, k, start[pid] - 1))
            ins = k - last - 1                         # place in its insertion
            left = ~on_a
            width = np.zeros(int(slot0[-1] + lc[-1] + 1), np.int64)
            np.maximum.at(width, key[left], ins[left] + 1)
            # columns: each slot's insertion columns, then its center base
            slot_mol = np.repeat(np.arange(M), lc + 1)
            ex = _exclusive(width + 1)
            ins_start = ex - ex[slot0][slot_mol]
            base_col = ins_start + width
            self.ncol = np.add.reduceat(width, slot0) + lc
            self.nreads = nreads
            self.moff = _exclusive(nreads * self.ncol)
            mat = np.full(int(self.moff[-1] + nreads[-1] * self.ncol[-1]),
                          _GAP_BYTE, np.uint8)
            # the center rows
            cm = np.repeat(np.arange(M), lc)
            cp = np.arange(len(cm)) - _exclusive(lc)[cm]
            crow = center - first
            mat[self.moff[cm] + crow[cm] * self.ncol[cm]
                + base_col[slot0[cm] + cp]] = seq[off[center][cm] + cp]
            # every read's bases, gaps and insertions
            pm = self.pair_mol[pid]
            row = (b_idx - first[self.pair_mol])[pid]
            col = np.where(on_a, base_col[key], ins_start[key] + ins)
            mat[self.moff[pm] + row * self.ncol[pm] + col] = byte
            self.mat = mat

    def rows(self, m: int) -> list[bytes]:
        o, R, C = int(self.moff[m]), int(self.nreads[m]), int(self.ncol[m])
        return [r.tobytes() for r in self.mat[o:o + R * C].reshape(R, C)]
