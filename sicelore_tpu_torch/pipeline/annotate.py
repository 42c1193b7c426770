"""AnnotateModel, JunctionValidator, SNPMatrix3pend, AddIsoBam.

AnnotateModel (programs/AnnotateModel.java:56-188): re-validate a
CollapseModel txt against CAGE/polyA BEDs + a short-read BAM, appending
validation columns. Operates on this repo's CollapseModel txt format
(column 12 = novelJunctions).

JunctionValidator (programs/JunctionValidator.java): classify a junction
table against a refFlat model (known junction / known splice sites /
novel) with short-read support counts.

SNPMatrix3pend (programs/SNPMatrix3pend.java): spliced distance of SNV
positions to the molecule's isoform 3' end (TranscriptRecord.getDistanceTo3p,
TranscriptRecord.java:413-444).

AddIsoBam (programs/AddIsoBam.java:78-106): per-record STRICT isoform
re-assignment from a refFlat model -> IT tag.

Isobam (programs/Isobam.java:54-99): molinfos-table-driven record
filtering + IG/IT tagging.
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

from sicelore_tpu_torch.core.collapse import CollapsedModel, _is_in
from sicelore_tpu_torch.core.refflat import RefFlatModel, TranscriptRecord
from sicelore_tpu_torch.io.bam import BamReader, BamWriter
from sicelore_tpu_torch.io.bed import BedModel


def annotate_model(txt_path, short_bam, cage_bed, polya_bed, out_path,
                   delta: int = 0, cage_cutoff: int = 50,
                   polya_cutoff: int = 50, junc_cutoff: int = 1):
    cage = BedModel.load(cage_bed) if cage_bed else None
    polya = BedModel.load(polya_bed) if polya_bed else None
    juncs = (CollapsedModel._short_read_junctions(short_bam)
             if short_bam else {})
    n = 0
    with open(txt_path) as fh, open(out_path, "w") as os_:
        header = fh.readline().rstrip("\n")
        os_.write(header + "\tis_validated\tsupport_reads\tdist_cagepeak"
                  "\tdist_polya\n")
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            tok = line.split("\t")
            chrom, strand = tok[2], tok[3]
            start, end = int(tok[4]), int(tok[5])
            njuncs = tok[11] if len(tok) > 11 else "-"
            five = start if strand == "+" else end
            three = end if strand == "+" else start
            dist_cage = cage.distance(chrom, strand, five) if cage else 0
            dist_polya = polya.distance(chrom, strand, three) if polya else 0
            ok = (abs(dist_cage) <= cage_cutoff
                  and abs(dist_polya) <= polya_cutoff)
            support = 0
            if njuncs not in ("-", ""):
                for j in njuncs.split(","):
                    j = j.split("=")[-1].split(":")[-1]
                    a, b = j.split("-")
                    s = juncs.get((chrom, int(a), int(b)), 0)
                    support += s
                    if s < junc_cutoff:
                        ok = False
            os_.write(f"{line}\t{str(ok).lower()}\t{support}\t{dist_cage}"
                      f"\t{dist_polya}\n")
            n += 1
    return {"isoforms": n}


def junction_validator(junctions_tsv, refflat, out_tsv, short_bam=None,
                       delta: int = 2, chrom_col=1, start_col=4, end_col=5):
    """Classify junctions (e.g. SQANTI2 junctions.txt) vs a refFlat model."""
    model = RefFlatModel.load(refflat)
    by_chrom_juncs = defaultdict(list)
    by_chrom_sites = defaultdict(set)
    for trs in model.by_gene.values():
        for t in trs:
            for (a, b) in t.junctions.tolist():
                by_chrom_juncs[t.chrom].append((a, b))
                by_chrom_sites[t.chrom].update((a, b))
    support = (CollapsedModel._short_read_junctions(short_bam)
               if short_bam else {})
    counts = defaultdict(int)
    n = 0
    with open(junctions_tsv) as fh, open(out_tsv, "w") as os_:
        header = fh.readline().rstrip("\n")
        os_.write(header + "\tclassification\tshort_read_support\n")
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            tok = line.split("\t")
            chrom = tok[chrom_col]
            a, b = int(tok[start_col]), int(tok[end_col])
            if _is_in((a, b), by_chrom_juncs.get(chrom, []), delta):
                cls = "known_junction"
            elif (a in by_chrom_sites.get(chrom, set())
                  and b in by_chrom_sites.get(chrom, set())):
                cls = "known_splicesites"
            else:
                cls = "novel"
            counts[cls] += 1
            n += 1
            os_.write(f"{line}\t{cls}\t{support.get((chrom, a, b), 0)}\n")
    return {"junctions": n, **counts}


def snp_matrix_3pend(in_bam, snp_csv, refflat, out_tsv, it_tag="IT",
                     tags=None):
    """Distance of each SNV hit to its molecule's isoform 3' end."""
    from sicelore_tpu_torch.core.longread import TagConfig
    from sicelore_tpu_torch.pipeline.snp_fusion import (parse_snp_descriptors,
                                                  read_pos_at_ref)
    tags = tags or TagConfig()
    model = RefFlatModel.load(refflat)
    snps = parse_snp_descriptors(snp_csv)
    by_chrom = defaultdict(list)
    for s in snps:
        by_chrom[s["chrom"]].append(s)
    n = 0
    with BamReader(in_bam) as rd, open(out_tsv, "w") as os_:
        os_.write("read\tcellBC\tUMI\tgene\tposition\tbase\tisoform"
                  "\tdist_to_3p\n")
        ref_names = [x for x, _ in rd.header.refs]
        for r in rd:
            if r.is_unmapped or r.ref_id < 0:
                continue
            chrom = ref_names[r.ref_id]
            for s in by_chrom.get(chrom, []):
                pos = s["positions"][0]
                if not (r.pos + 1 <= pos <= r.reference_end()):
                    continue
                rp = read_pos_at_ref(r.cigar, r.pos + 1, pos)
                if rp <= 0 or rp > len(r.seq):
                    continue
                it = r.get_tag(it_tag)
                gene = s["gene"]
                tr = model.select_one(gene, it) if it else None
                dist = _distance_to_3p(tr, pos) if tr else -1
                os_.write(f"{r.qname}\t{r.get_tag(tags.cell)}\t"
                          f"{r.get_tag(tags.umi)}\t{gene}\t{pos}\t"
                          f"{r.seq[rp - 1]}\t{it or 'undef'}\t{dist}\n")
                n += 1
    return {"hits": n}


def _distance_to_3p(t: TranscriptRecord, pos: int) -> int:
    """Spliced distance from genomic pos to the transcript 3' end
    (TranscriptRecord.getDistanceTo3p, TranscriptRecord.java:413-444)."""
    dist = 0
    if t.strand == "-":
        for (s, e) in t.exons:
            if s < pos:
                dist += (pos - s) if e > pos else (e - s)
    else:
        for (s, e) in t.exons:
            if e > pos:
                dist += (e - pos) if s < pos else (e - s)
    return dist


def isobam(in_bam, molinfos_txt, out_bam, undef: bool = True,
           cell_tag="BC", umi_tag="U8", gene_tag="IG", iso_tag="IT"):
    """Isobam (programs/Isobam.java:54-99): molinfos-driven record
    FILTER + tagging. Load the `_molinfos.txt` table (cellBC, UMI,
    nbReads, nbSupportingReads, mappingPctId, snpPhredScore, geneId,
    transcriptId); only records whose `BC:U8` key appears are written,
    with GENETAG/ISOTAG set from the table. With undef=False, molecules
    whose transcriptId is "undef" are excluded from the table (and thus
    their records dropped)."""
    gene_ids: dict[str, str] = {}
    transcript_ids: dict[str, str] = {}
    with open(molinfos_txt) as fh:
        for line in fh:
            tmp = line.rstrip("\n").split("\t")
            if len(tmp) < 8:
                continue
            if undef or tmp[7] != "undef":
                key = tmp[0] + ":" + tmp[1]
                gene_ids[key] = tmp[6]
                transcript_ids[key] = tmp[7]
    n = kept = 0
    with BamReader(in_bam) as rd, BamWriter(out_bam, rd.header) as w:
        for r in rd:
            n += 1
            key = f"{r.get_tag(cell_tag)}:{r.get_tag(umi_tag)}"
            if key in gene_ids:
                r.set_tag(gene_tag, gene_ids[key], "Z")
                r.set_tag(iso_tag, transcript_ids[key], "Z")
                kept += 1
                w.write(r)
    return {"records": n, "kept": kept}


def add_isobam(in_bam, refflat, out_bam, delta: int = 2, max_clip: int = 150,
               tags=None, seed: int = 0):
    """AddIsoBam (programs/AddIsoBam.java:78-106): re-run STRICT isoform
    assignment per SAM record against the refFlat model (one single-read
    molecule per record) and write the result into the IT tag. Distinct
    from `isobam` (table-driven filter)."""
    from sicelore_tpu_torch.core.longread import Longread, LongreadRecord, TagConfig
    from sicelore_tpu_torch.core.molecule import Molecule, MoleculeDataset
    tags = tags or TagConfig(max_clip=max_clip)
    model = RefFlatModel.load(refflat)
    ds = MoleculeDataset.__new__(MoleculeDataset)
    ds.model = model
    from sicelore_tpu_torch.core.molecule import IsoformStats
    ds.stats = IsoformStats()
    import numpy as np
    rng = np.random.default_rng(seed)
    n = tagged = 0
    with BamReader(in_bam) as rd, BamWriter(out_bam, rd.header) as w:
        ref_names = [nm for nm, _ in rd.header.refs]
        for r in rd:
            n += 1
            rec = LongreadRecord.from_bam_record(r, ref_names, tags)
            it = "undef"
            if rec is not None:
                lr = Longread(rec.name)
                lr.add(rec)
                mol = Molecule(lr.barcode, lr.umi, 1)
                mol.add_longread(lr)
                ds._set_isoform_strict(mol, delta, rng)
                it = mol.transcript_id or "undef"
            r.set_tag("IT", it, "Z")
            if it != "undef":
                tagged += 1
            w.write(r)
    return {"records": n, "isoform_defined": tagged}
