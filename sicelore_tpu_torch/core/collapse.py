"""CollapseModel engine — novel-isoform discovery/classification/validation.

Reimplements the reference's UCSCRefFlatParser CollapseModel machinery
(utils/UCSCRefFlatParser.java): loader (:138-208), collapser (:211-230,
collapse :639-671, isExactSameStructure :673-692), initialize
(TranscriptRecord.java:357-399), filter (:243-263, isPartOfLonger
:429-460), classifier/noveltyDetector (:266-276, 379-427), validator
(:279-366), statistics (:535-592), exportFiles (:595-637) with the exact
txt/refflat/gff output formats (TranscriptRecord.java:248-345).
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from sicelore_tpu_torch.core.longread import LongreadParser, LongreadRecord, TagConfig
from sicelore_tpu_torch.core.refflat import RefFlatModel, TranscriptRecord
from sicelore_tpu_torch.io.bam import BamReader
from sicelore_tpu_torch.io.bed import BedModel

CATEGORIES = ("undef", "undef2", "full_splice_match", "gencode",
              "novel_in_catalog", "novel_not_in_catalog",
              "combination_of_known_junctions",
              "combination_of_known_splicesites",
              "at_least_one_novel_splicesite")

_COLORS = {"gencode": "#014e8e",
           "combination_of_known_junctions": "#9dd122",
           "combination_of_known_splicesites": "#c594e1",
           "at_least_one_novel_splicesite": "#e65802"}


def _junctions(exons) -> list[tuple[int, int]]:
    return [(exons[i - 1][1], exons[i][0]) for i in range(1, len(exons))]


def _is_in(j, lst, delta) -> bool:
    return any(abs(a[0] - j[0]) <= delta and abs(a[1] - j[1]) <= delta
               for a in lst)


def _all_included(j1, j2, delta) -> bool:
    return all(_is_in(a, j2, delta) for a in j1)


class CollapsedModel:
    def __init__(self, refmodel: RefFlatModel, delta: int = 2,
                 min_evidence: int = 2, rn_min: int = 1):
        self.refmodel = refmodel
        self.delta = delta
        self.min_evidence = min_evidence
        self.rn_min = rn_min
        self.by_gene: dict[str, list[TranscriptRecord]] = {}
        self._novel_index = 1

    # -- loader (UCSCRefFlatParser.java:138-208) -------------------------

    def load_isobam(self, isobam, cells: set[str],
                    tags: TagConfig | None = None, gene_tag="IG",
                    isoform_tag="IT"):
        """Per-chromosome indexed pass when the isobam is coordinate-
        sorted (the reference's indexed per-chrom query,
        UCSCRefFlatParser.java:138-208); streaming fallback otherwise."""
        tags = tags or TagConfig()
        try:
            from sicelore_tpu_torch.io.bam import IndexedBamReader
            with IndexedBamReader(isobam) as rd:
                ref_names = [n for n, _ in rd.header.refs]
                for chrom, length in rd.header.refs:
                    for r in rd.fetch(chrom, 0, length):
                        self._load_record(r, ref_names, cells, tags,
                                          gene_tag, isoform_tag)
            return
        except (ValueError, OSError):
            pass
        with BamReader(isobam) as rd:
            ref_names = [n for n, _ in rd.header.refs]
            for r in rd:
                self._load_record(r, ref_names, cells, tags, gene_tag,
                                  isoform_tag)

    def _load_record(self, r, ref_names, cells, tags, gene_tag,
                     isoform_tag):
        bc = r.get_tag(tags.cell)
        it = r.get_tag(isoform_tag)
        ig = r.get_tag(gene_tag)
        rn = int(r.get_tag(tags.rn) or 1)
        lrr = LongreadRecord.from_bam_record(r, ref_names, tags,
                                             load_sequence=True)
        if (lrr is None or lrr.mapqv == 0 or lrr.is_chimeric
                or rn < self.rn_min or bc.replace("-1", "") not in cells):
            return
        if not ig or ig == "undef":
            return
        lst = self.by_gene.setdefault(ig, [])
        it = it or "undef"
        tr = None
        for t in lst:
            if t.transcript_id == it:
                tr = t
                break
        if tr is None:
            if it != "undef":
                tr = self.refmodel.select_one(ig, it)
            if tr is None:
                tr = TranscriptRecord(
                    gene_id=ig, transcript_id=it, chrom=lrr.chrom,
                    strand="+", tx_start=0, tx_end=0, cds_start=0,
                    cds_end=0, exons=[],
                    junctions=np.zeros((0, 2), np.int64))
                tr.is_known = it != "undef"
                tr.is_novel = not tr.is_known
            lst.append(tr)
        tr.evidence.append(lrr)

    # -- collapser (:211-230, 639-671) -----------------------------------

    def collapse(self):
        for gene, lst in self.by_gene.items():
            undef = next((t for t in lst if t.transcript_id == "undef"), None)
            if undef is None:
                continue
            novel: list[TranscriptRecord] = []
            for lrr in undef.evidence:
                jl = _junctions(lrr.exons)
                seen = False
                for t in novel:
                    if self._same_structure(jl, _junctions(t.exons)):
                        if not seen:
                            t.evidence.append(lrr)
                        seen = True
                if not seen and len(jl) > 0:
                    t = TranscriptRecord(
                        gene_id=gene,
                        transcript_id=f"Novel.{self._novel_index}",
                        chrom=lrr.chrom, strand="+", tx_start=0, tx_end=0,
                        cds_start=0, cds_end=0,
                        exons=[list(e) for e in lrr.exons],
                        junctions=np.zeros((0, 2), np.int64))
                    self._novel_index += 1
                    t.is_known = False
                    t.is_novel = True
                    t.evidence.append(lrr)
                    novel.append(t)
            lst.remove(undef)
            for t in novel:
                if len(t.evidence) >= self.min_evidence:
                    lst.append(t)

    def _same_structure(self, j_lrr, j_tr) -> bool:
        if not j_tr or len(j_tr) != len(j_lrr):
            return False
        return all(_is_in(j, j_lrr, self.delta) for j in j_tr)

    # -- initialize (TranscriptRecord.java:357-399) ----------------------

    def initialize(self):
        for lst in self.by_gene.values():
            for t in lst:
                if not t.evidence:
                    t.nb_umis = 0
                    t.nb_cells = 0
                    continue
                min_start = min(l.tx_start for l in t.evidence)
                max_end = max(l.tx_end for l in t.evidence)
                t.chrom = t.evidence[0].chrom
                t.strand = "-" if t.evidence[0].is_reverse else "+"
                rep = b"A"
                for l in t.evidence:
                    if l.cdna is not None and len(l.cdna) > len(rep):
                        rep = l.cdna
                t.representative = rep
                if t.is_novel:
                    t.categorie, t.subcategorie = "undef", "undef2"
                    t.exons[0] = [min_start, t.exons[0][1]]
                    t.exons[-1] = [t.exons[-1][0], max_end]
                    t.tx_start = t.cds_start = min_start
                    t.tx_end = t.cds_end = max_end
                else:
                    t.categorie, t.subcategorie = "full_splice_match", "gencode"
                t.nb_umis = len(t.evidence)
                t.nb_cells = len({l.barcode for l in t.evidence})

    # -- filter (:243-263, isPartOfLonger :429-460) ----------------------

    def filter(self):
        for gene, lst in self.by_gene.items():
            lst.sort(key=lambda t: -len(t.exons))
            keep: list[TranscriptRecord] = []
            model = self.refmodel.select([gene])
            for t in lst:
                if t.is_known:
                    keep.append(t)
                elif not self._part_of_longer(t, keep, model):
                    keep.append(t)
            self.by_gene[gene] = keep

    def _part_of_longer(self, t, kept, model) -> bool:
        jl = _junctions(t.exons)
        for other in kept:
            if _all_included(jl, _junctions(other.exons), self.delta):
                return True
        if t.is_novel:
            for other in model:
                if _all_included(jl, _junctions(other.exons), self.delta):
                    return True
        return False

    # -- classifier (:266-276, noveltyDetector :379-427) -----------------

    def classify(self):
        for gene, lst in self.by_gene.items():
            model = self.refmodel.select([gene])
            model_juncs = [j for m in model for j in _junctions(m.exons)]
            model_splice = {p for j in model_juncs for p in j}
            for t in lst:
                if not t.is_novel:
                    continue
                for j in _junctions(t.exons):
                    if _is_in(j, model_juncs, self.delta):
                        continue
                    if j[0] in model_splice and j[1] in model_splice:
                        if t.categorie == "undef":
                            t.categorie = "novel_in_catalog"
                            t.subcategorie = "combination_of_known_splicesites"
                        t.novel_junctions.append(j)
                    else:
                        t.categorie = "novel_not_in_catalog"
                        t.subcategorie = "at_least_one_novel_splicesite"
                        t.novel_junctions.append(j)
                if t.categorie == "undef":
                    t.categorie = "novel_in_catalog"
                    t.subcategorie = "combination_of_known_junctions"

    # -- validator (:279-366) --------------------------------------------

    def validate(self, cage: BedModel | None, polya: BedModel | None,
                 short_bam=None, cage_cutoff=50, polya_cutoff=50,
                 junc_cutoff=1):
        junc_support = {}
        short_juncs = None
        if short_bam is not None:
            short_juncs = self._short_read_junctions(short_bam)
        for lst in self.by_gene.values():
            for t in lst:
                five = t.tx_start if t.strand == "+" else t.tx_end
                three = t.tx_end if t.strand == "+" else t.tx_start
                if cage is not None:
                    t.dist_cage = cage.distance(t.chrom, t.strand, five)
                    t.is_valid_cage = abs(t.dist_cage) <= cage_cutoff
                if polya is not None:
                    t.dist_polya = polya.distance(t.chrom, t.strand, three)
                    t.is_valid_polya = abs(t.dist_polya) <= polya_cutoff
                ok = True
                total = 0
                for j in t.novel_junctions:
                    key = (t.chrom, j[0], j[1])
                    if key not in junc_support:
                        if short_juncs is None:
                            junc_support[key] = 0
                        else:
                            junc_support[key] = short_juncs.get(key, 0)
                    total += junc_support[key]
                    if junc_support[key] < junc_cutoff:
                        ok = False
                t.is_valid_junction = ok
                t.junction_reads = total
                t.is_valid = (t.is_valid_cage and t.is_valid_polya
                              and t.is_valid_junction)

    @staticmethod
    def _short_read_junctions(short_bam) -> dict:
        """Exact junction support counts from a (short-read) BAM
        (validator's per-junction query, no DELTA; :317-345)."""
        out: dict[tuple, int] = defaultdict(int)
        with BamReader(short_bam) as rd:
            ref_names = [n for n, _ in rd.header.refs]
            for r in rd:
                if r.is_unmapped:
                    continue
                chrom = ref_names[r.ref_id]
                pos = r.pos + 1
                prev_end = None
                for op, ln in r.cigar:
                    if op in ("M", "=", "X"):
                        if prev_end is not None:
                            out[(chrom, prev_end, pos)] += 1
                            prev_end = None
                        pos += ln
                    elif op == "N":
                        prev_end = pos - 1
                        pos += ln
                    elif op == "D":
                        pos += ln
        return dict(out)

    # -- statistics + export (:535-637) ----------------------------------

    def statistics(self) -> dict:
        stats = {f"{k}_{s}": 0 for k in CATEGORIES
                 for s in ("count", "evidences", "count_valid",
                           "evidences_valid")}
        total = {"genes": len(self.by_gene), "isoforms": 0, "evidences": 0,
                 "valid_isoforms": 0, "valid_evidences": 0}
        for lst in self.by_gene.values():
            for t in lst:
                n = len(t.evidence)
                stats[f"{t.categorie}_count"] += 1
                stats[f"{t.categorie}_evidences"] += n
                stats[f"{t.subcategorie}_count"] += 1
                stats[f"{t.subcategorie}_evidences"] += n
                total["isoforms"] += 1
                total["evidences"] += n
                if t.is_known or (t.is_novel and t.is_valid):
                    total["valid_isoforms"] += 1
                    total["valid_evidences"] += n
                    stats[f"{t.categorie}_count_valid"] += 1
                    stats[f"{t.categorie}_evidences_valid"] += n
                    stats[f"{t.subcategorie}_count_valid"] += 1
                    stats[f"{t.subcategorie}_evidences_valid"] += n
        stats.update(total)
        return stats

    def export(self, outdir, prefix="CollapseModel"):
        """txt + refflat x2 + gff x2 (exact reference formats)."""
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        p = outdir / prefix
        with open(f"{p}.txt", "w") as txt, \
             open(f"{p}.refflat.txt", "w") as flat, \
             open(f"{p}_valid.refflat.txt", "w") as flatv, \
             open(f"{p}.gff", "w") as gff, \
             open(f"{p}_valid.gff", "w") as gffv:
            txt.write("geneId\ttranscriptId\tchrom\tstrand\ttxStart\ttxEnd"
                      "\texons\tUMIs\tCells\tcategorie\tsubcategorie"
                      "\tnovelJunctions\tnovelJunctions_reads"
                      "\tis_valid_allNovelJunctions\tdist_cage"
                      "\tis_valid_cage\tdist_polya\tis_valid_polya"
                      "\tis_valid\n")
            for lst in self.by_gene.values():
                for t in lst:
                    txt.write(self._print_txt(t))
                    flat.write(self._print_refflat(t))
                    gff.write(self._print_gff(t))
                    if t.is_known or (t.is_novel and t.is_valid):
                        flatv.write(self._print_refflat(t))
                        gffv.write(self._print_gff(t))

    @staticmethod
    def _novel_junc_str(t) -> str:
        if not t.novel_junctions:
            return "-"
        return ",".join(f"{a}-{b}" for a, b in t.novel_junctions)

    def _print_txt(self, t) -> str:
        return (f"{t.gene_id}\t{t.transcript_id}\t{t.chrom}\t{t.strand}\t"
                f"{t.tx_start}\t{t.tx_end}\t{len(t.exons)}\t{t.nb_umis}\t"
                f"{t.nb_cells}\t{t.categorie}\t{t.subcategorie}\t"
                f"{self._novel_junc_str(t)}\t{t.junction_reads}\t"
                f"{str(t.is_valid_junction).lower()}\t{t.dist_cage}\t"
                f"{str(t.is_valid_cage).lower()}\t{t.dist_polya}\t"
                f"{str(t.is_valid_polya).lower()}\t"
                f"{str(t.is_valid).lower()}\n")

    @staticmethod
    def _print_refflat(t) -> str:
        starts = "".join(f"{s - 1}," for s, _ in t.exons)
        ends = "".join(f"{e}," for _, e in t.exons)
        return (f"{t.gene_id}\t{t.transcript_id}\t{t.chrom}\t{t.strand}\t"
                f"{t.tx_start}\t{t.tx_end}\t{t.cds_start}\t{t.cds_end}\t"
                f"{len(t.exons)}\t{starts}\t{ends}\n")

    def _print_gff(self, t) -> str:
        color = _COLORS.get(t.subcategorie, "#000000")
        s = (f"{t.chrom}\tsicelore\ttranscript\t{t.tx_start}\t{t.tx_end}"
             f"\t.\t{t.strand}\t.\tgene_id \"{t.gene_id}\"; transcript_id "
             f"\"{t.transcript_id}\"; category \"{t.categorie}\"; "
             f"subcategory \"{t.subcategorie}\"; UMIs \"{t.nb_umis}\"; "
             f"Cells \"{t.nb_cells}\"; novelJunctions "
             f"\"{self._novel_junc_str(t)}\"; supportingReads "
             f"\"{t.junction_reads}\"; CAGEdist \"{t.dist_cage}\"; "
             f"POLYAdist \"{t.dist_polya}\"; color \"{color}\";\n")
        for (es, ee) in t.exons:
            s += (f"{t.chrom}\tsicelore\texon\t{es}\t{ee}\t.\t{t.strand}"
                  f"\t.\tgene_id \"{t.gene_id}\"; transcript_id "
                  f"\"{t.transcript_id}\";\n")
        return s
