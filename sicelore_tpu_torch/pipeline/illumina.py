"""Illumina-guided mode (legacy v1 workflow).

Reference: `parseillumina` subcommand + BamSerializer + Illumina
BC/UMI analyzers (jar com/rw/illuminabamparser/*, programs/
BamSerializer.java; config.xml:190-243 "USED ONLY FOR ILLUMINA GUIDED").
Unused in the 2.1 short-read-free workflow; provided for v1 parity:

  * parse_illumina_bam: serialize an Illumina 10x BAM (CB/UB cell/UMI
    tags, GX/GN gene tags) at BamSerializer depth: a {gene: {cell:
    [umis]}} table AND per-contig genomic-REGION maps (sorted 3'-end
    positions with their cell/UMI) for reads whose gene is absent from
    the Illumina table (config.xml:199-208 test_BC_Genomic_Regions,
    windowSizeForNanoporeMatching = 400)
  * GuidedUmiTable.snap: ED-snap a Nanopore UMI candidate to the nearest
    Illumina UMI of the same (gene, cell)
  * GuidedUmiTable.guided_bc: the tiered guided CELL-BC search — gene
    candidates, then region candidates, then every cell-associated BC
    (maxEDtoCheckBCAll10xBCs = 3) — with the cell_BC_bailout_after_ED
    early exit (config.xml:209-236)
"""
from __future__ import annotations

import gzip
import json
from collections import defaultdict
from pathlib import Path

from sicelore_tpu_torch.core.umicluster import myers_ed
from sicelore_tpu_torch.io.bam import BamReader


def parse_illumina_bam(in_bam, out_json_gz, cell_tag="CB", umi_tag="UB",
                       gene_tags=("GN", "GX")):
    """Illumina 10x BAM -> {gene: {cell: [umis]}} + per-contig region
    maps (sorted 3'-end positions with cell/UMI — the BamSerializer
    hashmaps, programs/BamSerializer.java)."""
    table: dict[str, dict[str, set]] = defaultdict(lambda: defaultdict(set))
    regions: dict[str, list] = defaultdict(list)
    n = 0
    with BamReader(in_bam) as rd:
        refs = [nm for nm, _ in rd.header.refs]
        for r in rd:
            bc = r.get_tag(cell_tag)
            umi = r.get_tag(umi_tag)
            gene = None
            for g in gene_tags:
                gene = r.get_tag(g)
                if gene:
                    break
            if not (bc and umi):
                continue
            bc = bc.replace("-1", "")
            if gene:
                table[gene][bc].add(umi)
            if not r.is_unmapped and 0 <= r.ref_id < len(refs):
                # 3' end: alignment end for +, start for − (the fragment
                # end the Nanopore read's polyA side matches)
                end3 = (r.pos if (r.flag & 16)
                        else r.pos + sum(nn for op, nn in r.cigar
                                         if op in ("M", "D", "N")))
                regions[refs[r.ref_id]].append((end3, bc, umi))
            n += 1
    out = {
        "genes": {g: {c: sorted(us) for c, us in cells.items()}
                  for g, cells in table.items()},
        "regions": {c: sorted(set(v)) for c, v in regions.items()},
    }
    with gzip.open(out_json_gz, "wt") as fh:
        json.dump(out, fh)
    return {"records_used": n, "genes": len(out["genes"]),
            "region_entries": sum(len(v) for v in out["regions"].values())}


class GuidedUmiTable:
    def __init__(self, path: str | Path):
        with gzip.open(path, "rt") as fh:
            raw = json.load(fh)
        if "genes" in raw:           # BamSerializer-depth format
            self.table = raw["genes"]
            self.regions = {}
            for c, rows in raw.get("regions", {}).items():
                import numpy as np
                self.regions[c] = (
                    np.asarray([p for p, _, _ in rows], np.int64),
                    [b for _, b, _ in rows], [u for _, _, u in rows])
        else:                        # round-3 gene-only format
            self.table = raw
            self.regions = {}
        # all cell-associated BCs (the maxEDtoCheckBCAll10xBCs tier)
        self.all_bcs = sorted({c for cells in self.table.values()
                               for c in cells})

    def region_candidates(self, contig: str, pos3: int,
                          window: int = 400):
        """Cell BCs whose Illumina 3' ends fall within +-window of the
        Nanopore read's 3' position (windowSizeForNanoporeMatching)."""
        reg = self.regions.get(contig)
        if reg is None:
            return []
        import numpy as np
        ps, bcs, umis = reg
        lo = int(np.searchsorted(ps, pos3 - window))
        hi = int(np.searchsorted(ps, pos3 + window, side="right"))
        return sorted({bcs[i] for i in range(lo, hi)})

    def guided_bc(self, umi_bc: bytes, gene: str | None = None,
                  contig: str | None = None, pos3: int | None = None,
                  max_ed: int = 2, bailout_after_ed: int = 2,
                  max_ed_all: int = 3, window: int = 400):
        """Tiered guided cell-BC search (config.xml:209-236): gene-
        expressing BCs first, then genomic-region BCs, then every cell-
        associated BC at max_ed_all; each tier scans edit distances in
        ascending order and bails out past `bailout_after_ed` once a
        match exists. Returns (bc, ed, tier) or None."""
        tiers = []
        if gene and gene in self.table:
            tiers.append(("gene", sorted(self.table[gene]), max_ed))
        if contig is not None and pos3 is not None:
            rc = self.region_candidates(contig, pos3, window)
            if rc:
                tiers.append(("region", rc, max_ed))
        tiers.append(("all", self.all_bcs, max_ed_all))
        for name, cands, lim in tiers:
            best, best_ed, nbest = None, lim + 1, 0
            for c in cands:
                ed = myers_ed(umi_bc, c.encode())
                if ed < best_ed:
                    best, best_ed, nbest = c, ed, 1
                elif ed == best_ed:
                    nbest += 1
                if best_ed == 0:
                    break
            if best is not None and nbest == 1:
                return best.encode(), best_ed, name
            if best is not None and best_ed <= bailout_after_ed:
                return None   # ambiguous at/under the bailout tier
        return None

    def snap(self, gene: str | None, cell: str, umi: bytes,
             max_ed: int = 2,
             reduced_by: int = 2) -> tuple[bytes, int, bool] | None:
        """Nearest Illumina UMI of (gene, cell) within max_ed, or None.

        Returns (illumina_umi, ed, reduced). If no candidate matches at
        full length, retries with the UMI truncated by `reduced_by` bases
        against equally-truncated candidates (the reference's
        "UMI_match_with_reduced_length" scan, flagged with the UR tag —
        Jar/config.xml:487-490); the returned UMI is still full-length.
        """
        if not gene:
            return None
        cands = self.table.get(gene, {}).get(cell)
        if not cands:
            return None
        best, best_ed = None, max_ed + 1
        for c in cands:
            ed = myers_ed(umi, c.encode())
            if ed < best_ed:
                best, best_ed = c, ed
        if best is not None:
            return best.encode(), best_ed, False
        if reduced_by > 0 and len(umi) > reduced_by:
            short = umi[:-reduced_by]
            for c in cands:
                ed = myers_ed(short, c.encode()[:len(short)])
                if ed < best_ed:
                    best, best_ed = c, ed
            if best is not None:
                return best.encode(), best_ed, True
        return None
