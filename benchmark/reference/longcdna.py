"""The plain reference of Step 4b on full-length cDNA: the numbers of
`reference.consensus.judge`, and the same edit-distance numbers for two
length groups apart, so that a fault confined to one route of the program
cannot hide in the whole set's average:

  long_errors_per_kb, long_worst_error_pct   molecules of three or more
                                              reads whose truth is over
                                              2,048 nt
  mid_errors_per_kb, mid_worst_error_pct     those whose truth is 1,025 to
                                              2,048 nt

(`errors_per_kb`: edit distance of the consensus from the truth summed
over the group, per 1,000 true bases; `worst_error_pct`: the largest of one
molecule, % of its true length; 0 for a group with no molecule). The groups
go by truth length alone: the reference knows nothing of how the program
routes a molecule. Each molecule's edit distance is computed once. Nothing
of the program is imported."""
from __future__ import annotations

from pathlib import Path

import numpy as np

from benchmark.reference.consensus import (edit_distance, fastq_records,
                                           selected)

GROUPS = {"mid": (1025, 2048), "long": (2049, np.inf)}


def _errors(ed: np.ndarray, lens: np.ndarray) -> tuple[float, float]:
    """(errors_per_kb, worst_error_pct) of molecules with these edit
    distances and true lengths."""
    if not len(ed):
        return 0.0, 0.0
    return (1e3 * float(ed.sum()) / float(lens.sum()),
            100.0 * float((ed / lens).max()))


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
    ed, lens = [], []
    for m, (seq, qual) in got.items():
        sel = selected(mols.reads[m], mols.des[m], c["maxreads"])
        if len(sel) < 3:
            want = sel[0] if len(sel) == 1 else (
                sel[0] if len(sel[0]) > len(sel[1]) else sel[1])
            short += (seq, qual) != (want, bytes([minq]) * len(want))
            continue
        q = np.frombuffer(qual, np.uint8)
        cap += bool(len(q) == 0 or q.min() < 33 or q.max() != maxq)
        ed.append(edit_distance(mols.truths[m], seq))
        lens.append(len(mols.truths[m]))
    ed, lens = np.array(ed, np.int64), np.array(lens, np.int64)
    per_kb, worst = _errors(ed, lens)
    out = {"records_wrong": wrong, "short_differing": short,
           "qv_cap_differing": cap, "errors_per_kb": per_kb,
           "worst_error_pct": worst}
    for g, (lo, hi) in GROUPS.items():
        inside = (lens >= lo) & (lens <= hi)
        out[f"{g}_errors_per_kb"], out[f"{g}_worst_error_pct"] = _errors(
            ed[inside], lens[inside])
    return out
