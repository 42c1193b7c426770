"""The plain reference of Step 4b: each consensus record held against the
molecule it names, from the generated molecules (no BAM parse) and
SiCeLoRe's documented rule (Consensus.call): a molecule's reads ordered by
their de (ties in record order), the first MAXREADS non-empty ones; one
read is its own consensus, two give the longer (the second on a tie), each
with the quality MINPS at every base; three or more give a multiple
alignment's majority, whose qualities are capped at MAXPS and reach it
where every read agrees. Nothing of the program is imported.

The numbers (`judge`):

  records_wrong       records whose name (BC-UMI-reads) names no molecule,
                      that come twice, whose qualities are not one a base,
                      and molecules with no record
  short_differing     molecules of one or two selected reads whose record
                      is not the rule's, to the byte
  qv_cap_differing    molecules of three or more whose qualities leave
                      [0, MAXPS] or never reach MAXPS
  errors_per_kb       edit distance of the consensus from the molecule's
                      true sequence, summed over the molecules of three or
                      more, per 1,000 true bases
  worst_error_pct     the largest such distance of one molecule, % of its
                      true length
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

def selected(reads, des, maxreads: int) -> list[bytes]:
    order = sorted(range(len(reads)), key=des.__getitem__)
    return [reads[i] for i in order[:maxreads] if reads[i]]


def fastq_records(path: Path):
    lines = path.read_bytes().split(b"\n")
    for i in range(0, len(lines) - 3, 4):
        yield lines[i][1:], lines[i + 1], lines[i + 3]


def edit_distance(a: bytes, b: bytes) -> int:
    """Levenshtein distance of a and b, by Myers' bit-parallel recurrence
    (a column of the table a Python integer, a bit a row of a)."""
    m = len(a)
    if m == 0:
        return len(b)
    peq: dict = {}
    for i, ch in enumerate(a):
        peq[ch] = peq.get(ch, 0) | (1 << i)
    full, top = (1 << m) - 1, 1 << (m - 1)
    pv, mv, score = full, 0, m
    for ch in b:
        eq = peq.get(ch, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = (mv | ~(xh | pv)) & full
        mh = pv & xh
        if ph & top:
            score += 1
        elif mh & top:
            score -= 1
        ph = ((ph << 1) | 1) & full
        mh = (mh << 1) & full
        pv = (mh | ~(xv | ph)) & full
        mv = ph & xv
    return score


def judge(path: Path, mols, c: dict) -> dict:
    """The numbers of one consensus fastq against the molecules."""
    label_of = {f"{b}-{u}-{len(r)}".encode(): m for m, (b, u, r) in
                enumerate(zip(mols.bcs, mols.umis, mols.reads))}
    got: dict = {}
    wrong = 0
    for name, seq, qual in fastq_records(path):
        m = label_of.get(name)
        if m is None or m in got or len(seq) != len(qual):
            wrong += 1
            continue
        got[m] = (seq, qual)
    wrong += len(label_of) - len(got)
    minq, maxq = 33 + c["minps"], 33 + c["maxps"]
    short = cap = 0
    deep_cons, deep_truth = [], []
    for m, (seq, qual) in got.items():
        sel = selected(mols.reads[m], mols.des[m], c["maxreads"])
        if len(sel) < 3:
            want = sel[0] if len(sel) == 1 else (
                sel[0] if len(sel[0]) > len(sel[1]) else sel[1])
            short += (seq, qual) != (want, bytes([minq]) * len(want))
            continue
        q = np.frombuffer(qual, np.uint8)
        cap += bool(len(q) == 0 or q.min() < 33 or q.max() != maxq)
        deep_cons.append(seq)
        deep_truth.append(mols.truths[m])
    ed = np.array([edit_distance(t, s) for t, s in zip(deep_truth,
                                                       deep_cons)], np.int64)
    lens = np.array([len(t) for t in deep_truth]) if deep_truth else \
        np.ones(1)
    return {
        "records_wrong": wrong,
        "short_differing": short,
        "qv_cap_differing": cap,
        "errors_per_kb": 1e3 * float(ed.sum()) / float(lens.sum()),
        "worst_error_pct": 100.0 * float((ed / lens[:len(ed)]).max())
        if len(ed) else 0.0,
    }
