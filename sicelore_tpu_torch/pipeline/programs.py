"""Step-4b helper programs + BAM utility programs.

Host-side stream-rewrite programs mirroring the reference's Picard CLI
programs (reference paths cited per function). All operate on the
package's own BAM codec (io/bam.py).
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

from sicelore_tpu_torch.core.genetag import GeneTagger
from sicelore_tpu_torch.core.refflat import RefFlatModel
from sicelore_tpu_torch.io import fastq
from sicelore_tpu_torch.io.bam import BamReader, BamWriter


def tag_bam_with_read(in_bam, out_bam, fastq_dir, seq_tag="US",
                      qual_tag="QS"):
    """tagbamwithread: copy full read sequence + QVs from the source fastq
    into BAM tags (reference jar com.rw.tagbamwithread.TagWithReadSequenceMain;
    README.md:1091-1133). The BAM's read names must match the fastq's."""
    lookup = fastq.load_fastq_dict(fastq_dir)
    n = hit = 0
    with BamReader(in_bam) as rd, BamWriter(out_bam, rd.header) as w:
        for r in rd:
            n += 1
            rec = lookup.get(r.qname.encode())
            if rec is not None:
                hit += 1
                r.set_tag(seq_tag, rec[0].decode(), "Z")
                r.set_tag(qual_tag, rec[1].decode(), "Z")
            w.write(r)
    return {"records": n, "tagged": hit}


def deduplicate_molecule(in_fastq, out_fastq, select: bool = True):
    """DeduplicateMolecule: drop molecules duplicated by per-chromosome
    splitting (pseudogenes) — keep max RN, ties -> longest consensus
    (reference programs/DeduplicateMolecule.java:200-217). Input reads are
    named `BC-U8-RN`."""
    best: dict[str, tuple[int, bytes, bytes, bytes]] = {}
    total = 0
    for chunk in fastq.read_fastq(in_fastq):
        for name, seq, qual in zip(chunk.names, chunk.seqs, chunk.quals):
            total += 1
            parts = name.replace(b"|", b"-").split(b"-")
            if len(parts) < 3:
                continue
            key = (parts[0] + parts[1]).decode()
            rn = int(parts[2])
            cur = best.get(key)
            if (cur is None or rn > cur[0]
                    or (rn == cur[0] and len(seq) > len(cur[1]))):
                best[key] = (rn, seq, qual, name)
    if not select:
        best = {}
    with fastq.FastqWriter(out_fastq) as w:
        for rn, seq, qual, name in best.values():
            w.write(name, seq, qual)
    return {"reads": total, "molecules": len(best)}


def add_bam_molecule_tags(in_bam, out_bam, cell_tag="BC", umi_tag="U8",
                          rn_tag="RN"):
    """AddBamMoleculeTags: read name `BC-U8-RN` (or |-separated) -> tags
    (reference programs/AddBamMoleculeTags.java:46-59)."""
    n = 0
    with BamReader(in_bam) as rd, BamWriter(out_bam, rd.header) as w:
        for r in rd:
            info = r.qname.split("-")
            if len(info) == 1:
                info = r.qname.split("|")
            if len(info) == 3:
                r.set_tag(cell_tag, info[0], "Z")
                r.set_tag(umi_tag, info[1], "Z")
                r.set_tag(rn_tag, int(info[2]), "i")
                n += 1
            w.write(r)
    return {"tagged": n}


def add_gene_name_tag(in_bam, out_bam, refflat, gene_tag="GE",
                      strand_tag="GS", function_tag="XF",
                      use_strand: bool = True):
    """AddGeneNameTag (programs/AddGeneNameTag.java:116-161): Drop-seq
    LocusFunction gene tagging — GE = comma-joined exon-consistent
    CODING/UTR genes (strand-filtered), GS = their strands, XF = the
    read's best LocusFunction over ALL overlapping genes."""
    tagger = GeneTagger(RefFlatModel.load(refflat))
    n = tagged = 0
    with BamReader(in_bam) as rd, BamWriter(out_bam, rd.header) as w:
        ref_names = [nm for nm, _ in rd.header.refs]
        for r in rd:
            n += 1
            if not r.is_unmapped and 0 <= r.ref_id < len(ref_names):
                strand = ("-" if r.is_reverse else "+") if use_strand else None
                # alignment blocks of the spliced alignment (M/=/X runs),
                # not the full span (AddGeneNameTag.java:196-224)
                blocks = []
                pos = r.pos + 1
                for op, ln in r.cigar:
                    if op in ("M", "=", "X"):
                        blocks.append((pos, pos + ln - 1))
                        pos += ln
                    elif op in ("N", "D"):
                        pos += ln
                ge, gs, xf = tagger.annotate(ref_names[r.ref_id], blocks,
                                             strand)
                r.set_tag(function_tag, xf, "Z")
                if ge is not None:
                    r.set_tag(gene_tag, ge, "Z")
                    r.set_tag(strand_tag, gs, "Z")
                    tagged += 1
            w.write(r)
    return {"records": n, "tagged": tagged}


# ---------------------------------------------------------------------------
# generic BAM utilities (reference one-liner programs)
# ---------------------------------------------------------------------------

def bam2fastq(in_bam, out_fastq, seq_tag: str | None = None,
              qual_tag: str | None = None):
    """Bam2Fastq (programs/Bam2Fastq.java): records -> fastq, optionally
    from US/QS tags instead of the aligned sequence."""
    n = 0
    with BamReader(in_bam) as rd, fastq.FastqWriter(out_fastq) as w:
        for r in rd:
            if r.is_secondary or r.is_supplementary:
                continue
            if seq_tag:
                seq = r.get_tag(seq_tag)
                qual = r.get_tag(qual_tag) if qual_tag else None
                if seq is None:
                    continue
                qb = (qual.encode() if qual else b"I" * len(seq))
                w.write(r.qname.encode(), seq.encode(), qb)
            else:
                seq = r.seq.encode()
                qb = (bytes(q + 33 for q in r.qual) if r.qual
                      else b"I" * len(seq))
                w.write(r.qname.encode(), seq, qb)
            n += 1
    return {"reads": n}


def filter_bam(in_bam, out_bam, drop_mapqv0=True, tag_required=None):
    """FilterBam (programs/FilterBam.java): drop mapqv==0 records and/or
    records missing a tag."""
    n = kept = 0
    with BamReader(in_bam) as rd, BamWriter(out_bam, rd.header) as w:
        for r in rd:
            n += 1
            if drop_mapqv0 and r.mapq == 0:
                continue
            if tag_required and r.get_tag(tag_required) is None:
                continue
            kept += 1
            w.write(r)
    return {"records": n, "kept": kept}


def filter_bam_dedup_umi(in_bam, out_bam, cell_tag="BC", umi_tag="U8"):
    """FilterBamDedupUMI (programs/FilterBamDedupUMI.java): one record per
    (cell, UMI) molecule — the first encountered."""
    seen = set()
    n = kept = 0
    with BamReader(in_bam) as rd, BamWriter(out_bam, rd.header) as w:
        for r in rd:
            n += 1
            bc, u8 = r.get_tag(cell_tag), r.get_tag(umi_tag)
            if bc is None or u8 is None:
                continue
            key = (bc, u8)
            if key in seen:
                continue
            seen.add(key)
            kept += 1
            w.write(r)
    return {"records": n, "kept": kept}


def split_bam_per_cell(in_bam, out_dir, cells_csv, cell_tag="BC",
                       prefix="cell"):
    """SplitBamPerCell (programs/SplitBamPerCell.java): one BAM per cell."""
    from sicelore_tpu_torch.core.matrix import load_cell_list
    cells = load_cell_list(cells_csv)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with BamReader(in_bam) as rd:
        writers = {c: BamWriter(out_dir / f"{prefix}_{c}.bam", rd.header)
                   for c in cells}
        n = 0
        for r in rd:
            bc = r.get_tag(cell_tag)
            if bc in writers:
                writers[bc].write(r)
                n += 1
        for w in writers.values():
            w.close()
    return {"written": n, "cells": len(cells)}


def export_clipped_reads(in_bam, out_fastq, min_clip=150, seq_tag="US",
                         qual_tag="QS", gene_tag="GE", cell_tag="BC",
                         umi_tag="U8"):
    """ExportClippedReads (programs/ExportClippedReads.java:64-96, Step 6a):
    reads clipped more than MINCLIP on either end exported as fastq from
    US/QS tags, renamed `read_GE_BC_U8`."""
    n = 0
    with BamReader(in_bam) as rd, fastq.FastqWriter(out_fastq) as w:
        for r in rd:
            if r.is_secondary or r.is_supplementary or r.is_unmapped:
                continue
            if max(r.clip_left(), r.clip_right()) < min_clip:
                continue
            us = r.get_tag(seq_tag)
            if us is None:
                continue
            qs = r.get_tag(qual_tag) or "I" * len(us)
            name = "_".join([r.qname, str(r.get_tag(gene_tag) or "undef"),
                             str(r.get_tag(cell_tag) or "null"),
                             str(r.get_tag(umi_tag) or "null")])
            w.write(name.encode(), us.encode(), qs.encode())
            n += 1
    return {"exported": n}


def add_bam_read_tags(in_bam, out_bam, gene_tag="GE", cell_tag="BC",
                      umi_tag="U8"):
    """AddBamReadTags (programs/AddBamReadTags.java:46-63, Step 6b):
    read name `read_GE_BC_U8` -> tags."""
    n = 0
    with BamReader(in_bam) as rd, BamWriter(out_bam, rd.header) as w:
        for r in rd:
            parts = r.qname.split("_")
            if len(parts) >= 4:
                umi, bc, gene = parts[-1], parts[-2], parts[-3]
                if gene != "undef":
                    r.set_tag(gene_tag, gene, "Z")
                if bc != "null":
                    r.set_tag(cell_tag, bc, "Z")
                if umi != "null":
                    r.set_tag(umi_tag, umi, "Z")
                n += 1
            w.write(r)
    return {"tagged": n}
