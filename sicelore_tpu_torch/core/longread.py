"""Long-read data model: BAM record -> exon/junction structure.

Reimplements the reference's LongreadRecord/Longread/LongreadParser
(reference: utils/LongreadRecord.java:71-195 — CIGAR to exons splitting at
N introns and D>20 (minimap2 short-intron deletions) after dropping I/S ops;
chimera = clip > MAXCLIP either end; cDNA from CS tag or US[TE..PS];
utils/Longread.java:42-60 — read = N SAM records, gene set, best = min de;
utils/LongreadParser.java:42-115 — filter cascade with counters).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from sicelore_tpu_torch.io.bam import BamReader, BamRecord, decode_record
from sicelore_tpu_torch.utils import trace


@dataclass
class TagConfig:
    """Configurable SAM tag names (reference setStaticParams,
    LongreadRecord.java:34-58; tag names are config, not constants)."""
    cell: str = "BC"
    umi: str = "U8"
    gene: str = "GE"
    tso_end: str = "TE"
    polya_start: str = "PS"
    us: str = "US"
    cdna: str = "CS"
    rn: str = "RN"
    max_clip: int = 150


class LongreadRecord:
    __slots__ = ("name", "barcode", "umi", "gene_id", "chrom", "tx_start",
                 "tx_end", "is_reverse", "mapqv", "de", "rn", "exons",
                 "junctions", "cdna", "cdna_source", "is_chimeric",
                 "is_secondary")

    @classmethod
    def from_bam_record(cls, r: BamRecord, ref_names: list[str],
                        tags: TagConfig, load_sequence: bool = False):
        """None if record lacks a barcode or is unmapped (reference
        fromSAMRecord early return, LongreadRecord.java:76-82).
        `cdna_source` names the tag the cDNA was taken from: `CS`, or `US`
        (cut at TE and PS); None where no cDNA was loaded."""
        rec = cls()
        rec.gene_id = r.get_tag(tags.gene)
        rec.barcode = r.get_tag(tags.cell)
        rec.umi = r.get_tag(tags.umi)
        rec.mapqv = r.mapq
        if rec.barcode is None or r.is_unmapped:
            return None
        rec.barcode = rec.barcode.replace("-1", "")
        rec.name = r.qname
        rec.chrom = ref_names[r.ref_id] if 0 <= r.ref_id < len(ref_names) else "*"
        rec.tx_start = r.pos + 1          # 1-based like htsjdk getAlignmentStart
        rec.tx_end = r.reference_end()    # 1-based inclusive end
        rec.is_reverse = r.is_reverse
        rec.is_secondary = r.is_secondary or r.is_supplementary
        de = r.get_tag("de")
        if de is None:
            de = r.get_tag("df")  # minimap2 2.10 fallback
        rec.de = float(de) if de is not None else 1.0
        rn = r.get_tag(tags.rn)
        rec.rn = int(rn) if rn is not None else 1

        clip_l, clip_r = r.clip_left(), r.clip_right()
        rec.is_chimeric = clip_l > tags.max_clip or clip_r > tags.max_clip

        rec.cdna = rec.cdna_source = None
        if load_sequence and not rec.is_chimeric:
            cs = r.get_tag(tags.cdna)
            if cs is not None:
                rec.cdna = cs.encode() if isinstance(cs, str) else cs
                rec.cdna_source = "CS"
            else:
                us = r.get_tag(tags.us)
                if us is not None:
                    tso_end = int(r.get_tag(tags.tso_end) or 0)
                    pa_start = int(r.get_tag(tags.polya_start) or 0)
                    start = tso_end if tso_end != 0 else 0
                    end = pa_start if (0 != pa_start < len(us) - 1) else len(us) - 1
                    rec.cdna = (us[start:end] if start < end else us).encode()
                    rec.cdna_source = "US"

        # CIGAR -> exons: walk M/D/N after conceptually dropping I and S;
        # split at N, and at D > 20 (minimap2 short-intron deletions)
        pos = r.pos + 1  # 1-based reference cursor
        exon_start = pos
        exon_end = pos
        starts, ends = [], []
        for op, n in r.cigar:
            if op in ("S", "H", "I", "P"):
                continue
            if op == "N" or (op == "D" and n > 20):
                starts.append(exon_start)
                ends.append(exon_end)
                pos += n
                exon_start = pos
            elif op == "D":
                pos += n
            else:  # M, =, X consume both
                exon_end = pos + n - 1
                pos += n
        starts.append(exon_start)
        ends.append(exon_end)
        rec.exons = list(zip(starts, ends))
        rec.junctions = np.array(
            [[ends[i - 1], starts[i]] for i in range(1, len(starts))],
            dtype=np.int64).reshape(-1, 2)
        return rec


class Longread:
    """One read (possibly several SAM records)."""
    __slots__ = ("name", "barcode", "umi", "rn", "records", "gene_ids")

    def __init__(self, name: str):
        self.name = name
        self.barcode = None
        self.umi = None
        self.rn = 1
        self.records: list[LongreadRecord] = []
        self.gene_ids: set[str] = set()

    def add(self, rec: LongreadRecord, genelist_sep: str = ","):
        if rec.gene_id:
            for g in rec.gene_id.split(genelist_sep):
                self.gene_ids.add(g)
        if rec.barcode:
            self.barcode = rec.barcode
        if rec.umi:
            self.umi = rec.umi
        self.rn = rec.rn
        self.records.append(rec)

    def best_record(self) -> LongreadRecord:
        return min(self.records, key=lambda r: r.de)


@dataclass
class ParseStats:
    total_records: int = 0
    valid_records: int = 0
    unvalid_records: int = 0
    null_records: int = 0
    chimeria_records: int = 0
    gene_unset: int = 0
    umi_unset: int = 0
    mapqv0_records: int = 0


class LongreadParser:
    """Stream a BAM into {read_name: Longread} with the reference's filter
    cascade (LongreadParser.java:96-115): null BC/unmapped -> chimeric ->
    missing gene (if mandatory) -> missing UMI (if mandatory) ->
    mapqv0-unless-primary (if not keep_mapqv0).

    While the program's tracer is on (`utils.trace`), a parse records once:
    counter `consensus.parse_ns` by `phase` (`decode`: `decode_record`, its
    tags included; `build`: `LongreadRecord.from_bam_record`), `bam.seq_bases`
    (each record's `l_seq`: SEQ is not spelled out) and `bam.cigar_ops` over
    the records decoded, `consensus.cdna` by the `source` of each kept
    record's cDNA (`CS`, `US`, `none`), and
    `consensus.records_dropped` by `reason` (`null`, `chimeric`, `no_gene`,
    `no_umi`, `mapq0`: the cascade's steps)."""

    def __init__(self, path: str | Path, keep_mapqv0: bool = False,
                 load_sequence: bool = False, gene_mandatory: bool = True,
                 umi_mandatory: bool = True, tags: TagConfig | None = None):
        self.tags = tags or TagConfig()
        self.stats = ParseStats()
        self.reads: dict[str, Longread] = {}
        self.multi_rec: set[str] = set()
        on = trace.ON
        clock = time.perf_counter_ns
        t_decode = t_build = bases = ops = 0
        sources = {"CS": 0, "US": 0, None: 0}
        with BamReader(path) as rd:
            self.header = rd.header
            ref_names = [n for n, _ in rd.header.refs]
            while (buf := rd.read_raw()) is not None:
                self.stats.total_records += 1
                if on:
                    t0 = clock()
                r = decode_record(buf)
                if on:
                    t1 = clock()
                rec = LongreadRecord.from_bam_record(r, ref_names, self.tags,
                                                     load_sequence)
                if on:
                    t_decode += t1 - t0
                    t_build += clock() - t1
                    bases += r.l_seq
                    ops += len(r.cigar)
                if rec is None:
                    self.stats.unvalid_records += 1
                    self.stats.null_records += 1
                    continue
                if rec.is_chimeric:
                    self.stats.unvalid_records += 1
                    self.stats.chimeria_records += 1
                    continue
                if gene_mandatory and (not rec.gene_id or rec.gene_id == "undef"):
                    self.stats.unvalid_records += 1
                    self.stats.gene_unset += 1
                    continue
                if umi_mandatory and rec.umi is None:
                    self.stats.unvalid_records += 1
                    self.stats.umi_unset += 1
                    continue
                if not keep_mapqv0 and rec.mapqv == 0 and rec.is_secondary:
                    self.stats.unvalid_records += 1
                    self.stats.mapqv0_records += 1
                    continue
                self.stats.valid_records += 1
                if on:
                    sources[rec.cdna_source] += 1
                lr = self.reads.get(rec.name)
                if lr is None:
                    lr = Longread(rec.name)
                    self.reads[rec.name] = lr
                else:
                    self.multi_rec.add(rec.name)
                lr.add(rec)
        if on:
            st = self.stats
            trace.count("consensus.parse_ns", t_decode, phase="decode")
            trace.count("consensus.parse_ns", t_build, phase="build")
            trace.count("bam.seq_bases", bases)
            trace.count("bam.cigar_ops", ops)
            for source, n in sources.items():
                trace.count("consensus.cdna", n, source=source or "none")
            for reason, n in (("null", st.null_records),
                              ("chimeric", st.chimeria_records),
                              ("no_gene", st.gene_unset),
                              ("no_umi", st.umi_unset),
                              ("mapq0", st.mapqv0_records)):
                trace.count("consensus.records_dropped", n, reason=reason)
