"""Multi-read consensus calling (spoa replacement) — host reference engine.

The reference forks `spoa -r 2` per molecule and derives per-column QVs from
the MSA (utils/Consensus.java:189-238, utils/ConsensusMsa.java:51-91; the
per-UMI fork+tempfile is its throughput bottleneck — README.md:1146-1147:
~600k UMIs/h on 20 cores). This module reimplements the consensus
computation natively:

  * center-star MSA: the longest read is the center; every other read is
    aligned to it with banded Needleman-Wunsch (spoa default scores:
    match +5, mismatch -4, gap -8) and the pairwise alignments are merged
    into MSA columns (center positions + per-gap insertion columns)
  * consensus = per-column majority (gaps vote; majority-gap columns are
    stripped), QV per column = agreement fraction f -> 33 + MAXPS if f == 1
    else 33 + round(-10*log10(1-f)) — exactly ConsensusMsa.process
  * 1 read -> the read itself; 2 reads -> the LONGEST read (the reference
    code takes longest, despite the README claiming best-de;
    Consensus.java:201-206); both get constant QV = MINPS

Note: consensus bytes are not guaranteed byte-identical to spoa's (different
MSA heuristic, same scoring); accuracy is validated against known truth in
tests. The batched device engine (ops/poa_cuda.py) reproduces THIS module's
semantics and is validated against it.
"""
from __future__ import annotations

import numpy as np

MATCH, MISMATCH, GAP = 5, -4, -8
NEG = -(10**9)


def nw_align_banded(a: bytes, b: bytes, band: int | None = None):
    """Global alignment of b against a (banded NW, linear gaps).

    Returns (a_row, b_row) aligned strings with b'-' gaps.
    Band is centered on the scaled diagonal; auto-sized to
    max(32, |len diff| + 10% of len)."""
    la, lb = len(a), len(b)
    if la == 0:
        return b"-" * lb, b
    if lb == 0:
        return a, b"-" * la
    if band is None:
        band = max(32, abs(la - lb) + max(la, lb) // 10)
    # DP over full matrix but restricted to |i*lb/la - j| <= band
    # rows: i over a (0..la), cols: j over b (0..lb)
    H = np.full((la + 1, lb + 1), NEG, dtype=np.int64)
    H[0, : min(lb, band) + 1] = np.arange(min(lb, band) + 1) * GAP
    H[:, 0] = np.arange(la + 1) * GAP
    ratio = lb / la
    aj = np.frombuffer(b, dtype=np.uint8)
    for i in range(1, la + 1):
        center = int(round(i * ratio))
        j0, j1 = max(1, center - band), min(lb, center + band)
        if j0 > j1:
            continue
        ai = a[i - 1]
        sub = np.where(aj[j0 - 1:j1] == ai, MATCH, MISMATCH)
        diag = H[i - 1, j0 - 1:j1] + sub
        up = H[i - 1, j0:j1 + 1] + GAP
        best = np.maximum(diag, up)
        if j0 == 1:
            best[0] = max(best[0], H[i, 0] + GAP)
        # left moves: prefix max of (best[k] + (j-k)*GAP)
        t = best - np.arange(j0, j1 + 1) * GAP
        t = np.maximum.accumulate(t)
        H[i, j0:j1 + 1] = np.maximum(best, t + np.arange(j0, j1 + 1) * GAP)
    # traceback
    i, j = la, lb
    ra, rb = bytearray(), bytearray()
    while i > 0 or j > 0:
        if i > 0 and j > 0 and H[i, j] == H[i - 1, j - 1] + (
                MATCH if a[i - 1] == b[j - 1] else MISMATCH):
            ra.append(a[i - 1]); rb.append(b[j - 1]); i -= 1; j -= 1
        elif i > 0 and H[i, j] == H[i - 1, j] + GAP:
            ra.append(a[i - 1]); rb.append(ord("-")); i -= 1
        elif j > 0 and H[i, j] == H[i, j - 1] + GAP:
            ra.append(ord("-")); rb.append(b[j - 1]); j -= 1
        else:  # out-of-band fallback: force diagonal
            if i > 0 and j > 0:
                ra.append(a[i - 1]); rb.append(b[j - 1]); i -= 1; j -= 1
            elif i > 0:
                ra.append(a[i - 1]); rb.append(ord("-")); i -= 1
            else:
                ra.append(ord("-")); rb.append(b[j - 1]); j -= 1
    return bytes(reversed(ra)), bytes(reversed(rb))


def msa_center_star(seqs: list[bytes]) -> list[bytes]:
    """Center-star MSA: rows aligned to common columns (b'-' gaps).

    Center = longest sequence. Insertions relative to the center open
    per-position insertion columns sized to the longest insertion there.
    """
    R = len(seqs)
    center_idx = max(range(R), key=lambda i: len(seqs[i]))
    center = seqs[center_idx]
    lc = len(center)
    aligns = []  # per read: (ins_lens[lc+1], aligned bases per center slot)
    # parse each pairwise alignment into: for center position p, the read
    # base aligned there ('-' if deleted), plus insertion strings between
    # center positions
    per_read = []
    for r in range(R):
        if r == center_idx:
            per_read.append((np.zeros(lc + 1, dtype=np.int64),
                             [bytes([c]) for c in center],
                             [b""] * (lc + 1)))
            continue
        ca, cb = nw_align_banded(center, seqs[r])
        pos = 0  # center position already consumed
        bases = [b"-"] * lc
        inserts = [b""] * (lc + 1)
        for x, y in zip(ca, cb):
            if x == ord("-"):
                inserts[pos] = inserts[pos] + bytes([y])
            else:
                bases[pos] = bytes([y])
                pos += 1
        ins_lens = np.array([len(s) for s in inserts], dtype=np.int64)
        per_read.append((ins_lens, bases, inserts))
    # column layout: for each gap g (0..lc): max insertion length; then the
    # center base column
    max_ins = np.zeros(lc + 1, dtype=np.int64)
    for ins_lens, _, _ in per_read:
        max_ins = np.maximum(max_ins, ins_lens)
    rows = []
    for ins_lens, bases, inserts in per_read:
        row = bytearray()
        for p in range(lc + 1):
            s = inserts[p]
            row += s + b"-" * int(max_ins[p] - len(s))
            if p < lc:
                row += bases[p]
        rows.append(bytes(row))
    return rows


def consensus_from_msa(rows: list[bytes], maxps: int = 20):
    """Majority consensus + per-column agreement QV
    (ConsensusMsa.process semantics; utils/ConsensusMsa.java:51-91)."""
    R = len(rows)
    mat = np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(R, -1)
    # majority char per column over the 5-letter alphabet -ACGT (+N rare)
    cons = np.zeros(mat.shape[1], dtype=np.uint8)
    counts_best = np.zeros(mat.shape[1], dtype=np.int64)
    for ch in b"ACGTN-":
        c = (mat == ch).sum(axis=0)
        better = c > counts_best
        cons = np.where(better, ch, cons)
        counts_best = np.where(better, c, counts_best)
    frac = counts_best / R
    keep = cons != ord("-")
    qv = np.where(frac >= 1.0, 33 + maxps,
                  33 + np.round(-10 * np.log10(
                      np.maximum(1.0 - frac, 1e-9))).astype(np.int64))
    qv = np.minimum(qv, 33 + maxps)
    return bytes(cons[keep]), bytes(qv[keep].astype(np.uint8))


def consensus_reads(seqs: list[bytes], minps: int = 3, maxps: int = 20):
    """Full dispatch per Consensus.call(): 1 read -> itself; 2 -> longest;
    >=3 -> MSA consensus. Returns (consensus, qv_phred33_bytes)."""
    if len(seqs) == 0:
        return b"", b""
    if len(seqs) == 1:
        s = seqs[0]
        return s, bytes([33 + minps]) * len(s)
    if len(seqs) == 2:
        s = seqs[0] if len(seqs[0]) > len(seqs[1]) else seqs[1]
        return s, bytes([33 + minps]) * len(s)
    rows = msa_center_star(seqs)
    return consensus_from_msa(rows, maxps)
