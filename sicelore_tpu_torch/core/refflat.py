"""UCSC refFlat transcript model.

Reimplements the reference's TranscriptRecord/UCSCRefFlatParser core
(reference: utils/TranscriptRecord.java:92-164 fromRefFlat — exons stored
1-based as (start+1, end), junctions = (prev_exon_end, next_exon_start);
utils/UCSCRefFlatParser.java:48-131 — gene -> transcript list map, select).

Columns: geneName transcriptName chrom strand txStart txEnd cdsStart cdsEnd
exonCount exonStarts exonEnds (starts/ends comma-terminated lists).
Junction arrays are kept as numpy for the vectorized isoform matcher.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class TranscriptRecord:
    gene_id: str
    transcript_id: str
    chrom: str
    strand: str
    tx_start: int
    tx_end: int
    cds_start: int
    cds_end: int
    exons: list[tuple[int, int]]          # 1-based (start+1, end)
    junctions: np.ndarray                  # [J, 2] int64 (end_i, start_{i+1})
    # CollapseModel extensions (reference TranscriptRecord.java:34-52)
    evidence: list = field(default_factory=list)
    categorie: str = "undef"
    subcategorie: str = "undef2"
    nb_umis: int = 0
    nb_cells: int = 0
    is_known: bool = True
    is_novel: bool = False
    novel_junctions: list = field(default_factory=list)
    junction_reads: int = 0
    is_valid_junction: bool = False
    dist_cage: int = 0
    is_valid_cage: bool = False
    dist_polya: int = 0
    is_valid_polya: bool = False
    is_valid: bool = False
    representative: bytes = b"A"

    @classmethod
    def from_refflat_fields(cls, f: list[str]) -> "TranscriptRecord":
        if len(f) < 11:
            raise ValueError(f"refFlat line needs >=11 fields, got {len(f)}")
        starts = [int(x) for x in f[9].rstrip(",").split(",") if x]
        ends = [int(x) for x in f[10].rstrip(",").split(",") if x]
        exons = [(s + 1, e) for s, e in zip(starts, ends)]
        juncs = np.array([[exons[i - 1][1], exons[i][0]]
                          for i in range(1, len(exons))],
                         dtype=np.int64).reshape(-1, 2)
        return cls(gene_id=f[0], transcript_id=f[1], chrom=f[2], strand=f[3],
                   tx_start=int(f[4]), tx_end=int(f[5]), cds_start=int(f[6]),
                   cds_end=int(f[7]), exons=exons, junctions=juncs)

    @property
    def n_exons(self) -> int:
        return len(self.exons)

    def cdna_length(self) -> int:
        return sum(e - s + 1 for s, e in self.exons)


class RefFlatModel:
    """gene -> [TranscriptRecord]; the isoform model for STRICT matching."""

    def __init__(self, transcripts_by_gene: dict[str, list[TranscriptRecord]]):
        self.by_gene = transcripts_by_gene

    @classmethod
    def load(cls, path: str | Path) -> "RefFlatModel":
        """Load a refFlat or GTF model (reference -a/--annotationFile accepts
        .refFlat/.refflat/.gtf, optionally gz; README.md:686-690)."""
        name = str(path).lower()
        if name.endswith((".gtf", ".gtf.gz")):
            return cls._load_gtf(path)
        opener = gzip.open if str(path).endswith(".gz") else open
        by_gene: dict[str, list[TranscriptRecord]] = {}
        with opener(str(path), "rt") as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                tr = TranscriptRecord.from_refflat_fields(line.split("\t"))
                by_gene.setdefault(tr.gene_id, []).append(tr)
        return cls(by_gene)

    @classmethod
    def _load_gtf(cls, path: str | Path) -> "RefFlatModel":
        """GTF exon lines -> transcripts (org.ipmc.common.gtf.GTFparser
        role). Gene key = gene_name attribute (gene_id fallback)."""
        import re
        opener = gzip.open if str(path).endswith(".gz") else open
        attr_re = re.compile(r'(\w+) "([^"]*)"')
        # (gene, transcript) -> [chrom, strand, [(start0, end)]]
        tx: dict[tuple[str, str], list] = {}
        with opener(str(path), "rt") as fh:
            for line in fh:
                if line.startswith("#"):
                    continue
                f = line.rstrip("\n").split("\t")
                if len(f) < 9 or f[2] != "exon":
                    continue
                attrs = dict(attr_re.findall(f[8]))
                gene = attrs.get("gene_name") or attrs.get("gene_id", "?")
                tid = attrs.get("transcript_id", "?")
                rec = tx.setdefault((gene, tid), [f[0], f[6], []])
                rec[2].append((int(f[3]) - 1, int(f[4])))  # 0-based start
        by_gene: dict[str, list[TranscriptRecord]] = {}
        for (gene, tid), (chrom, strand, exons) in tx.items():
            exons.sort()
            fields = [gene, tid, chrom, strand, str(exons[0][0]),
                      str(exons[-1][1]), str(exons[0][0]),
                      str(exons[-1][1]), str(len(exons)),
                      ",".join(str(s) for s, _ in exons) + ",",
                      ",".join(str(e) for _, e in exons) + ","]
            tr = TranscriptRecord.from_refflat_fields(fields)
            by_gene.setdefault(gene, []).append(tr)
        return cls(by_gene)

    def select(self, gene_ids) -> list[TranscriptRecord]:
        """All transcripts of the given genes (UCSCRefFlatParser.select)."""
        out = []
        for g in gene_ids:
            out.extend(self.by_gene.get(g, []))
        return out

    def select_one(self, gene_id: str, transcript_id: str) -> TranscriptRecord | None:
        for tr in self.by_gene.get(gene_id, []):
            if tr.transcript_id == transcript_id:
                return tr
        return None

    def genes(self):
        return self.by_gene.keys()

    def __len__(self):
        return sum(len(v) for v in self.by_gene.values())
