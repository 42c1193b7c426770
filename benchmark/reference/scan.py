"""The plain reference of Step 1: each written record held against what the
generator knows of its read (`gen.reads.Truth`) and against the read's own
bytes, and the barcode list against the cells the reads were drawn from.
Nothing of the program is imported; SiCeLoRe's documented output is
parsed here:

  passed/<file>FWD.fastq   <read>[spN]_<FWD|REV>_PS=.._bc=<barcode>_ed=..
                           the read (a split part of it) stranded: as it
                           is (FWD) or reverse-complemented (REV)
  failed/<file>FAILED.fastq  <read>[spN], the read (part) as it came in
  BarcodeList.tsv          <barcode>\\t<count> a line, the used list

The numbers (`judge`):

  records_wrong        records whose name names no read of the input, that
                       come twice, or whose bases or qualities are not
                       their read's (a split part: a stretch of it)
  lost_pct             input reads with no record at all, % of the reads
  wrong_bc_per_10k     passed records whose barcode is not the cell their
                       molecule came from (garbage has none), a 10,000
  wrong_strand_per_10k passed records of one molecule whose strand is not
                       its own, a 10,000
  missed_pct           reads of one molecule that are not passed whole with
                       their cell's barcode, % of them
  unsplit_chimera_pct  chimeras of two molecules written without a second
                       part, % of them
  barcode_list_differing  barcodes in the list and not among the cells, or
                       the reverse
  ed_cap_differing     the largest edit distance of a passed record's
                       barcode (ed=) against the one the documented table
                       allows for the list's size (the distance of the two)
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_ACGT = b"ACGT"
_RC = bytes.maketrans(b"ACGTN", b"TGCAN")
_NAME = re.compile(rb"^([rxg])(\d+)(?:c\d+)?(?:sp(\d+))?"
                   rb"(?:_(FWD|REV)_PS=-?\d+_PE=-?\d+_AE=-?\d+(?:_T=-?\d+)?"
                   rb"_bc=([ACGTN]*)_ed=(\d+)_.*)?$")
# SiCeLoRe's bcMaxEditDistances.xml at 1% error: the largest barcode edit
# distance for a used list of up to n barcodes (16 nt), as (n, distance)
MAX_ED = ((83, 4), (1127, 3), (26362, 2), (100000, 1))


@dataclass
class Pool:
    """The input of a call: a file's reads by their index, with their
    truth, and the cells' barcodes as strings."""
    stems: list          # file stem a file ("run0")
    seqs: list           # list[bytes] a file
    quals: list          # list[bytes] a file
    truths: list         # gen.reads.Truth a file
    cells: list          # str a cell


def barcodes(codes: np.ndarray, k: int = 16) -> list[str]:
    """uint32 codes (2 bits a base, A C G T, first base on top) -> str."""
    out = []
    for w in np.asarray(codes, np.uint64).tolist():
        out.append("".join(chr(_ACGT[(w >> (2 * (k - 1 - j))) & 3])
                           for j in range(k)))
    return out


def fastq_records(path: Path):
    """(name, seq, qual) of every 4-line record of a fastq file."""
    lines = path.read_bytes().split(b"\n")
    for i in range(0, len(lines) - 3, 4):
        yield lines[i][1:], lines[i + 1], lines[i + 3]


def judge(out: Path, pool: Pool) -> dict:
    """The numbers of one call's outputs under out."""
    wrong = top_ed = 0
    seen: set = set()
    split_reads: set = set()
    passed = []         # (file, read, part, strand, bc, written whole)
    n_reads = sum(len(s) for s in pool.seqs)
    covered: set = set()
    for f, stem in enumerate(pool.stems):
        seqs, quals = pool.seqs[f], pool.quals[f]
        for kind, path in (("passed", out / "passed" / f"{stem}FWD.fastq"),
                           ("failed", out / "failed" / f"{stem}FAILED.fastq")):
            if not path.exists():
                continue
            for name, seq, qual in fastq_records(path):
                m = _NAME.match(name)
                i = int(m.group(2)) if m else -1
                part = int(m.group(3) or 1) if m else 1
                strand = m.group(4) if m else None
                if (not m or i >= len(seqs) or (kind == "passed")
                        != (strand is not None) or (f, i, part) in seen):
                    wrong += 1
                    continue
                seen.add((f, i, part))
                covered.add((f, i))
                if part > 1:
                    split_reads.add((f, i))
                if strand == b"REV":
                    whole, wq = seqs[i].translate(_RC)[::-1], quals[i][::-1]
                else:
                    whole, wq = seqs[i], quals[i]
                at = whole.find(seq) if len(seq) == len(qual) else -1
                if at < 0 or wq[at:at + len(seq)] != qual:
                    wrong += 1
                    continue
                if kind == "passed":
                    passed.append((f, i, part, strand, m.group(5).decode(),
                                   len(seq) == len(whole)))
                    top_ed = max(top_ed, int(m.group(6)))
    # a read that is not split is written whole
    parts = defaultdict(int)
    for f, i, part in seen:
        parts[(f, i)] += 1
    wrong_bc = wrong_strand = 0
    hit = set()
    for f, i, part, strand, bc, whole in passed:
        t = pool.truths[f]
        k = int(t.kind[i])
        if k == 3:
            wrong_bc += 1
            continue
        cell = int(t.cell2[i] if part > 1 else t.cell[i])
        if bc != pool.cells[cell]:
            wrong_bc += 1
        elif k < 2 and whole and parts[(f, i)] == 1:
            hit.add((f, i))
        if k < 2 and (strand == b"REV") != bool(t.rev[i]):
            wrong_strand += 1
    single = [(f, i) for f, t in enumerate(pool.truths)
              for i in np.nonzero(t.kind < 2)[0].tolist()]
    chimeras = [(f, i) for f, t in enumerate(pool.truths)
                for i in np.nonzero(t.kind == 2)[0].tolist()]
    listed = set()
    bl = out / "BarcodeList.tsv"
    if bl.exists():
        listed = {ln.split(b"\t")[0].decode()
                  for ln in bl.read_bytes().split(b"\n") if ln}
    n_passed = max(len(passed), 1)
    return {
        "records_wrong": wrong,
        "lost_pct": 100.0 * (n_reads - len(covered)) / n_reads,
        "wrong_bc_per_10k": 1e4 * wrong_bc / n_passed,
        "wrong_strand_per_10k": 1e4 * wrong_strand / n_passed,
        "missed_pct": 100.0 * (len(single) - len(hit)) / max(len(single), 1),
        "unsplit_chimera_pct": 100.0 * sum(
            c not in split_reads for c in chimeras) / max(len(chimeras), 1),
        "barcode_list_differing": len(listed ^ set(pool.cells)),
        "ed_cap_differing": abs(top_ed - next(
            (d for n, d in MAX_ED if len(listed) <= n), 1)),
    }
