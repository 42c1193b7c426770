"""Minimal BED parser with strand-aware nearest-feature distances.

Reimplements the reference's BEDParser (utils/BEDParser.java:27-119):
per-chromosome feature lists; getDistanceCage/getDistancePolyA return the
signed distance to the nearest same-strand feature anchor (feature start on
+ strand, end on -), sign-flipped on + strand per the reference convention.
Sorted-array + searchsorted instead of the reference's linear scan.
"""
from __future__ import annotations

import gzip
from collections import defaultdict
from pathlib import Path

import numpy as np

INT_MAX = 2**31 - 1


class BedModel:
    def __init__(self):
        # (chrom, strand) -> sorted anchor positions (1-based starts/ends)
        self._anchors: dict[tuple[str, str], np.ndarray] = {}
        self._tmp = defaultdict(list)
        self.entries = 0

    @classmethod
    def load(cls, path: str | Path) -> "BedModel":
        m = cls()
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(str(path), "rt") as fh:
            for line in fh:
                if not line.strip() or line.startswith(("#", "track",
                                                        "browser")):
                    continue
                f = line.rstrip("\n").split("\t")
                chrom, start0, end = f[0], int(f[1]), int(f[2])
                strand = f[5] if len(f) > 5 else "+"
                # htsjdk tribble BED: start is 1-based after conversion
                anchor = start0 + 1 if strand == "+" else end
                m._tmp[(chrom, strand)].append(anchor)
                m.entries += 1
        for k, v in m._tmp.items():
            m._anchors[k] = np.array(sorted(v), dtype=np.int64)
        m._tmp = None
        return m

    def distance(self, chrom: str, strand: str, pos: int) -> int:
        """Signed distance to the nearest same-strand anchor
        (BEDParser.getDistanceCage/getDistancePolyA semantics: min |pos-pp|,
        value = pos-pp, negated on + strand)."""
        arr = self._anchors.get((chrom, strand))
        if arr is None or len(arr) == 0:
            return INT_MAX
        i = int(np.searchsorted(arr, pos))
        best = None
        for j in (i - 1, i):
            if 0 <= j < len(arr):
                d = pos - int(arr[j])
                if best is None or abs(d) < abs(best):
                    best = d
        if strand == "+":
            best = -best
        return best
