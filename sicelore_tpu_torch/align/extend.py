"""Between-anchor gap alignment -> CIGAR, batched on the device.

Chains give exact-match anchors; the sequence between consecutive anchors
aligns as:

  * diagonal runs (ref gap == query gap) -> M
  * introns (ref gap - query gap >= MIN_INTRON) -> N, junction snapped to
    the closest GT..AG donor/acceptor within SNAP bp of the anchor bound
  * ordinary gaps -> banded NW through the SAME kernel as the consensus
    engine (ops/poa_cuda.band_align, csrc/bandalign.cu): the ref segment
    is the "center", the query segment the "read", each pair its own
    molecule, and the kernel's walk records decode into M/I/D runs
    (aligned: base=M, 4=D; per-column insertion counts). Gaps outside the
    band envelope, or with a base other than ACGT, emit plain I+D runs
    (rare; still valid SAM).

All gap pairs of a read batch ride one device call per length bucket
(Lc = max(64, the next power of two of the ref segment), W = w_for(Lc)):
int8 code rows built on the host, one upload, the insertion votes summed
on the device, one download.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from sicelore_tpu_torch import device as _device
from sicelore_tpu_torch.ops import poa_cuda

MIN_INTRON = 30
SNAP = 12
MAX_SEG = 1000          # device-aligned gap segment cap


def _merge(ops: list, op: str, n: int):
    if n <= 0:
        return
    if ops and ops[-1][0] == op:
        ops[-1][1] += n
    else:
        ops.append([op, n])


def cigar_from_alignment(aligned_row: np.ndarray, ins_sums: np.ndarray,
                         clen: int) -> list:
    """Kernel walk records -> M/I/D runs for one (ref=center, query) pair.

    aligned_row [Lc+1]: slot t describes center col t+1 (code<4 = M,
    4 = D); ins_sums [Lc+1]: row r counts query insertions between center
    col r and r+1 (row 0 = before the first). Vectorized RLE — the
    round-4 per-column Python loop was ~70% of noisy-batch wall."""
    a = np.asarray(aligned_row[:clen])
    ins = np.asarray(ins_sums[:clen + 1])
    ops: list = []
    _merge(ops, "I", int(ins[0]))
    if clen == 0:
        return ops
    hot = np.nonzero(ins[1:])[0]        # columns followed by insertions
    # M/D runs between insertion break points
    code = np.where(a < 4, 0, 1)        # 0 = M, 1 = D
    prev = 0
    bounds = list(hot.tolist()) + ([clen - 1] if (len(hot) == 0 or
                                                  hot[-1] != clen - 1)
                                   else [])
    for b in bounds:
        seg = code[prev:b + 1]
        if len(seg):
            # RLE of the M/D codes in this segment
            cuts = np.nonzero(np.diff(seg))[0]
            starts = np.concatenate([[0], cuts + 1])
            ends = np.concatenate([cuts + 1, [len(seg)]])
            for st, en in zip(starts.tolist(), ends.tolist()):
                _merge(ops, "M" if seg[st] == 0 else "D", en - st)
        _merge(ops, "I", int(ins[b + 1]))
        prev = b + 1
    return ops


def snap_junction(ref: bytes, jpos: int, intron: int) -> int:
    """Shift an intron start near jpos (global coords within `ref`) to the
    nearest GT..AG motif within +-SNAP bp; returns the snapped start."""
    best = jpos
    for d in range(-SNAP, SNAP + 1):
        s = jpos + d
        if s < 0 or s + intron + 2 > len(ref):
            continue
        if ref[s:s + 2] == b"GT" and ref[s + intron - 2:s + intron] == b"AG":
            if abs(d) < abs(best - jpos) or best == jpos:
                best = s
                if d == 0:
                    break
    return best


class GapBatcher:
    """Collects ordinary gap pairs across a read batch and aligns them in
    one device call per bucket through the consensus band kernel.

    `pairs_per_call` cuts a bucket into sub-batches of that many pairs (the
    results are those of one call: each pair is aligned alone)."""

    def __init__(self, device="cuda", pairs_per_call: int | None = None):
        self.device = _device.resolve(device)
        self.pairs_per_call = pairs_per_call
        self.jobs: dict[int, list] = defaultdict(list)  # Lc -> [(R, Q)]
        self.results: dict[int, tuple] = {}

    def feasible(self, R: bytes, Q: bytes) -> bool:
        if not (1 <= len(R) <= MAX_SEG and 1 <= len(Q) <= MAX_SEG):
            return False
        # segments with a base other than ACGT (assembly-gap N runs in the
        # reference genome) take the plain I+D path, as in the reference
        # package, whose 2-bit uploads cannot carry N
        if R.translate(None, poa_cuda._ACGT) or Q.translate(
                None, poa_cuda._ACGT):
            return False
        Lc = max(64, 1 << (len(R) - 1).bit_length())
        W = poa_cuda.w_for(Lc)
        return abs(len(R) - len(Q)) < W // 2 - 4

    def add(self, R: bytes, Q: bytes) -> int:
        Lc = max(64, 1 << (len(R) - 1).bit_length())
        jid = len(self.jobs[Lc])
        self.jobs[Lc].append((R, Q))
        return (Lc << 20) | jid

    def run(self):
        """Align all collected pairs; results retrievable via get()."""
        for Lc, pairs in self.jobs.items():
            W = poa_cuda.w_for(Lc)
            step = self.pairs_per_call or max(len(pairs), 1)
            parts = [self._align_bucket(*self._build_bucket(
                pairs[p0:p0 + step], Lc, W), Lc, W)
                for p0 in range(0, len(pairs), step)]
            self.results[Lc] = tuple(np.concatenate(x) for x in zip(*parts))

    def _build_bucket(self, pairs, Lc: int, W: int):
        """Host int8 code rows of one (sub-)batch, uploaded once: reads
        [P, Lc + W] (query segments, PAD after each), centers [P, Lc] (ref
        segments), their lengths."""
        from sicelore_tpu_torch.utils import dna
        P = len(pairs)
        reads = np.full((P, Lc + W), dna.PAD, np.int8)
        cent = np.full((P, Lc), dna.PAD, np.int8)
        lens = np.zeros((2, P), np.int32)
        for p, (R, Q) in enumerate(pairs):
            cent[p, :len(R)] = dna.encode(R)
            reads[p, :len(Q)] = dna.encode(Q)
            lens[0, p] = len(Q)
            lens[1, p] = len(R)
        lens_d = torch.from_numpy(lens).to(self.device)
        return (torch.from_numpy(reads).to(self.device), lens_d[0],
                torch.from_numpy(cent).to(self.device), lens_d[1])

    def _align_bucket(self, reads, rlens, cent, clens, Lc: int, W: int):
        """One band_align call (each pair its own molecule: mids =
        identity), the insertion votes summed over offsets and bases on the
        device (totals stay under the band width, so int8), one download:
        (aligned [P, Lc+1] int8, ins_sums [P, Lc+1] int8, feasible [P])."""
        P = reads.shape[0]
        mids = torch.arange(P, dtype=torch.int32, device=self.device)
        aligned, ins, feas = poa_cuda.band_align(reads, rlens, mids, cent,
                                                 clens, Lc, W)
        isum = ins.to(torch.int32).sum(dim=(2, 3)).to(torch.int8)
        out = torch.cat([aligned, isum, feas.to(torch.int8)[:, None]],
                        dim=1).cpu().numpy()
        return (out[:, :Lc + 1], out[:, Lc + 1:2 * (Lc + 1)],
                out[:, 2 * (Lc + 1)].astype(np.int32))

    def get(self, handle: int, R: bytes, Q: bytes) -> list:
        """CIGAR ops for a previously-added pair (fallback to plain I/D
        when the band alignment was infeasible)."""
        Lc, jid = handle >> 20, handle & 0xFFFFF
        aligned, ins_sums, feas = self.results[Lc]
        if not feas[jid]:
            return plain_gap_ops(len(R), len(Q))
        return cigar_from_alignment(aligned[jid], ins_sums[jid], len(R))


def plain_gap_ops(ref_len: int, q_len: int) -> list:
    """Coarse gap emission when banded alignment is not applicable."""
    ops: list = []
    m = min(ref_len, q_len)
    _merge(ops, "M", m)
    _merge(ops, "I", q_len - m)
    _merge(ops, "D", ref_len - m)
    return ops
