"""Steps 5 & 6: SNPMatrix (per-cell SNV matrix) + FusionDetector.

SNPMatrix (reference programs/SNPMatrix.java:95-215): per SNP descriptor
`chrom,pos[|pos2...],strand,name`, find molecules whose reads cover all
positions, extract the read base(s) + QVs (complemented on negative-strand
reads), filter MINRN/MINQV, and emit matrices keyed
"transcriptId" = `chrom:pos..bases` via the Matrix writers.

FusionDetector (reference programs/FusionDetector.java:54-113): molecules
with exactly two gene ids in valid cells become fusion events keyed
`geneA|geneB`; counts >= 10 logged; matrices via Matrix writers. MAXCLIP is
relaxed to 10000 and UMI is not mandatory at parse time.
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

from sicelore_tpu_torch.core.longread import LongreadParser, TagConfig
from sicelore_tpu_torch.core.matrix import Matrix, load_cell_list
from sicelore_tpu_torch.core.molecule import Molecule, MoleculeDataset
from sicelore_tpu_torch.io.bam import BamReader

_COMP = {"A": "T", "T": "A", "C": "G", "G": "C", "N": "N"}


def read_pos_at_ref(cigar, aln_start: int, ref_pos: int) -> int:
    """1-based read position aligned at 1-based ref_pos; 0 if none
    (htsjdk SAMRecord.getReadPositionAtReferencePosition semantics)."""
    rp = aln_start  # current ref pos (1-based) of next aligned base
    qp = 1
    for op, ln in cigar:
        if op in ("S", "I"):
            qp += ln
        elif op in ("M", "=", "X"):
            if rp <= ref_pos < rp + ln:
                return qp + (ref_pos - rp)
            rp += ln
            qp += ln
        elif op in ("D", "N"):
            if rp <= ref_pos < rp + ln:
                return 0  # deletion/skip at that position
            rp += ln
        # H, P consume nothing relevant
    return 0


def parse_snp_descriptors(path):
    """csv lines `chrom,pos[|pos2...],strand,name` -> list of dicts."""
    out = []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split(",")
        positions = [int(p) for p in tok[1].split("|")]
        out.append({"chrom": tok[0], "positions": positions,
                    "strand": tok[2], "gene": tok[3]})
    return out


def snp_matrix(in_bam, snp_csv, cell_csv, outdir, prefix="snp",
               minrn: int = 0, minqv: int = 0,
               tags: TagConfig | None = None):
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    cells = load_cell_list(cell_csv)
    matrix = Matrix(cells)
    snps = parse_snp_descriptors(snp_csv)
    by_chrom: dict[str, list] = defaultdict(list)
    for s in snps:
        by_chrom[s["chrom"]].append(s)
    tags = tags or TagConfig()
    stats = {"hits": 0, "lowRN": 0, "lowQV": 0}

    def process(r, s, chrom):
        ps = s["positions"]
        if ps[0] < r.pos + 1 or ps[-1] > r.reference_end():
            return
        # strand filter: read strand must equal SNP strand
        # (SNPMatrix.java:126)
        if (s["strand"] == "-") != r.is_reverse:
            return
        bc = r.get_tag(tags.cell)
        umi = r.get_tag(tags.umi)
        if bc is None:
            return
        rn = int(r.get_tag(tags.rn) or 1)
        read_pos = [read_pos_at_ref(r.cigar, r.pos + 1, p) for p in ps]
        if min(read_pos) <= 0 or len(r.seq) <= max(read_pos):
            return
        nucs, qvs = [], []
        for rp in read_pos:
            nucs.append(r.seq[rp - 1])
            qvs.append(r.qual[rp - 1] if r.qual else 0)
        if r.is_reverse:
            nucs = [_COMP.get(n, "N") for n in nucs]
        if rn < minrn:
            stats["lowRN"] += 1
            return
        if min(qvs) < minqv:
            stats["lowQV"] += 1
            return
        stats["hits"] += 1
        mol = Molecule(bc.replace("-1", ""), umi or "", rn)
        mol.gene_id = s["gene"]
        mol.transcript_id = (f"{chrom}:" + "|".join(str(p) for p in ps)
                             + ".." + "".join(nucs))
        mol.snp_phred = ",".join(str(q) for q in qvs)
        # one placeholder longread so n_reads()/metrics behave
        matrix.add_molecule(mol)

    # indexed per-SNP query when the BAM is coordinate-sorted (the
    # reference path: SNPMatrix.java:138-141 queryOverlapping per SNP);
    # full-stream fallback otherwise
    try:
        from sicelore_tpu_torch.io.bam import IndexedBamReader
        with IndexedBamReader(in_bam) as rd:
            for s in snps:
                for r in rd.fetch(s["chrom"], s["positions"][0] - 1,
                                  s["positions"][-1]):
                    if not r.is_unmapped:
                        process(r, s, s["chrom"])
    except (ValueError, OSError):  # unsorted BAM / unwritable .bai: stream
        with BamReader(in_bam) as rd:
            ref_names = [n for n, _ in rd.header.refs]
            for r in rd:
                if r.is_unmapped or r.ref_id < 0:
                    continue
                chrom = ref_names[r.ref_id]
                for s in by_chrom.get(chrom, ()):
                    process(r, s, chrom)
    if matrix.matrice:
        p = outdir / prefix
        matrix.write_isoform_matrix(f"{p}_snpmatrix.txt",
                                    f"{p}_snpmetrics.txt",
                                    f"{p}_snpmolinfos.txt", None)
    with open(outdir / f"{prefix}_snp.log", "w") as fh:
        json.dump(stats, fh, indent=1)
    return stats


def fusion_detector(in_bam, cell_csv, outdir, prefix="fus",
                    min_report: int = 10):
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    cells = load_cell_list(cell_csv)
    matrix = Matrix(cells)
    tags = TagConfig(max_clip=10000)  # FusionDetector.java:64
    parser = LongreadParser(in_bam, keep_mapqv0=False, load_sequence=False,
                            gene_mandatory=True, umi_mandatory=False,
                            tags=tags)
    dataset = MoleculeDataset(parser)
    counts: dict[str, int] = defaultdict(int)
    for mol in dataset.molecules.values():
        if (mol.barcode in matrix.cell_metrics and mol.umi
                and len(mol.gene_ids) == 2):
            key = "|".join(sorted(mol.gene_ids))
            counts[key] += 1
            mol.gene_id = key
            mol.transcript_id = key
            matrix.add_molecule(mol)
    reported = {k: c for k, c in sorted(counts.items(),
                                        key=lambda kv: -kv[1])
                if c >= min_report}
    p = outdir / prefix
    matrix.write_isoform_matrix(f"{p}_fusmatrix.txt", f"{p}_fusmetrics.txt",
                                f"{p}_fusmolinfos.txt", None)
    with open(outdir / f"{prefix}_fusions.log", "w") as fh:
        json.dump({"counts": dict(counts), "reported": reported}, fh,
                  indent=1)
    return {"fusions": len(counts), "reported": reported}
