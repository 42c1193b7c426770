"""assignumis — Step 3: per-cell, per-region UMI clustering on a sorted BAM.

Reimplements the reference jar's UmiFinderMain / OneNanoporeSeqAnalyzer /
UmiClustering (binary only; behavior spec: the reference README.md:555-625,
Jar/config.xml:70-90,244-278):

  * stream the sorted BAM in chunks of sam_records_chunk_size, never
    splitting records of the same genomic region across chunks
  * per record: recover readscan metadata from the read name (the stage-1
    contract, pipeline.readname), extract the UMI candidate = stranded
    read sequence between the polyA end and the barcode end
  * gene tag (GE) from a refFlat model if given (Drop-seq
    TagReadWithGeneExonFunction role) unless the record already has one
  * group records by (cell, genomic 3'-end anchor within
    distance_from_read_end_for_grouping, region span
    max_GenomeDistance_forGrouping) and cluster UMIs (core.umicluster;
    groups of 48 unique UMIs or more take the batched distance route on
    the pipeline's `device`)
  * write BC/U8/U1/U2/UB/UE/U7/UC/UZ + readscan tags into the output BAM;
    emit genecounts.tsv + UMIdepths.tsv

Output SAM tags follow config.xml:297-492 (reconfigurable via
utils.config.DEFAULT_SAM_TAGS).
"""
from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

from sicelore_tpu_torch import device as _device
from sicelore_tpu_torch.core.genetag import GeneTagger
from sicelore_tpu_torch.core.refflat import RefFlatModel
from sicelore_tpu_torch.core.umicluster import cluster_group, myers_ed
from sicelore_tpu_torch.io.bam import BamReader, BamRecord, BamWriter
from sicelore_tpu_torch.pipeline import readname
from sicelore_tpu_torch.utils import dna
from sicelore_tpu_torch.utils.config import PipelineConfig

INT_MAX = 2**31 - 1


@dataclass
class UmiStats:
    total_records: int = 0
    no_scan_info: int = 0
    no_barcode: int = 0
    umi_too_short: int = 0
    umi_assigned: int = 0
    singletons: int = 0
    clustered: int = 0
    groups: int = 0
    umi_depth_hist: dict = field(default_factory=lambda: defaultdict(int))

    def to_json(self):
        d = dict(self.__dict__)
        d["umi_depth_hist"] = dict(self.umi_depth_hist)
        return d


class AssignUmisPipeline:
    def __init__(self, cfg: PipelineConfig | None = None,
                 refflat: str | Path | None = None,
                 chunk_size: int | None = None,
                 random_umi: bool = False, seed: int = 0,
                 illumina_table=None, device="cuda"):
        self.cfg = cfg or PipelineConfig()
        # the batched UMI distances of large groups run here: "cuda" without
        # a GPU raises, "cpu" runs the same torch body on the host
        self.device = _device.resolve(device)
        # Illumina-guided mode (legacy): snap cluster centers to the nearest
        # Illumina UMI of the same (gene, cell); pipeline.illumina
        self.illumina = illumina_table
        # -f/--randomUMI negative control: replace UMI candidates with
        # random bases to measure false clustering (README.md:747-751)
        self.random_umi = random_umi
        self._rng = __import__("numpy").random.default_rng(seed)
        self.chunk_size = chunk_size or self.cfg.barcode_umi_finder.sam_records_chunk_size
        self.tagger = None
        if refflat is not None:
            self.tagger = GeneTagger(RefFlatModel.load(refflat))
        self.stats = UmiStats()
        # gene x cell UMI sets for genecounts.tsv
        self.genecounts: dict[tuple[str, str], set] = defaultdict(set)

    # ------------------------------------------------------------------

    def _analyze(self, rec: BamRecord, ref_names: list[str]):
        """Per-record: scan info, UMI candidate window, gene tag.

        Returns (info, umi_seq, umi_qv, ub, ue) or None when the read name
        carries no scanfastq metadata."""
        info = readname.parse_name(rec.qname)
        if info is None or info.bc is None:
            return None
        # stranded read sequence: BAM seq is reference-forward; the original
        # (stranded) orientation is recovered via the reverse flag
        seq = rec.seq.encode()
        qual = rec.qual
        if rec.is_reverse:
            seq = dna.revcomp_bytes(seq)
            qual = qual[::-1] if qual else qual
        if (info.bc_start is not None and info.bc_end is not None
                and info.bc_start < info.bc_end):
            # 5' chemistry (ascending BC coords): UMI between the BC end and
            # the TSO start (config.xml:174-176)
            ub = info.bc_end + 1
            if info.tso_end is not None and info.tso_end > ub:
                tso_start = info.tso_end - (
                    len(self.cfg.tso5p.sequence) - 1)
                ue = max(tso_start - 1, ub)
            else:
                ue = ub + self.cfg.umis.umi_length - 1
        else:
            # 3' chemistry: UMI between polyA end and barcode end (stranded
            # coords): [PE+1, bcEnd-1]; bcEnd = AE - bc_len
            # (README.md:418-446 geometry)
            ub, ue = info.pe + 1, (info.bc_end or 0) - 1
        if ue <= ub or ue >= len(seq):
            self.stats.umi_too_short += 1
            return (info, b"", 0.0, ub, ue)
        umi = seq[ub:ue + 1]
        if self.random_umi:
            umi = bytes(b"ACGT"[i]
                        for i in self._rng.integers(0, 4, len(umi)))
        qv = 0.0
        if qual and ue < len(qual):
            qv = sum(qual[ub:ue + 1]) / max(len(umi), 1)
        return (info, umi, qv, ub, ue)

    def _flush_group(self, group: list, writer: BamWriter,
                     ref_names: list[str]):
        """Cluster one (cell, region) group and write its records."""
        if not group:
            return
        self.stats.groups += 1
        u = self.cfg.umis
        umis = [g[2] for g in group]
        quals = [g[3] for g in group]
        clusters = cluster_group(
            umis, quals,
            complete_link_ed=u.umi_completelink_clustering_ed,
            single_link_ed=u.umi_singlelink_clustering_ed,
            single_link_threshold=u.complexity_threshold_for_switch_to_single_link,
            max_complexity=u.max_complexity_for_umi_clustering,
            device=self.device)
        tags = self.cfg.sam_tags
        for cl in clusters:
            depth = len(cl.members)
            self.stats.umi_depth_hist[depth] += 1
            if cl.is_readseq:
                self.stats.singletons += 1
            else:
                self.stats.clustered += 1
            center = cl.center
            umi_reduced = False
            if self.illumina is not None and cl.members:
                rec0 = group[cl.members[0]][0]
                g0 = rec0.get_tag(self.cfg.barcode_umi_finder
                                  .gene_name_attribute)
                snapped = self.illumina.snap(g0, group[cl.members[0]][1].bc,
                                             center)
                if snapped is not None:
                    center = snapped[0]
                    umi_reduced = snapped[2]
            for i in cl.members:
                rec, info, umi, qv, ub, ue = group[i]
                rec.set_tag(tags["CELL_BC"], info.bc, "Z")
                rec.set_tag(tags["UMI_SEQ"], center.decode(), "Z")
                rec.set_tag(tags["UMI_READ_SEQ"], umi.decode(), "Z")
                ed = myers_ed(umi, center) if umi != center else 0
                rec.set_tag(tags["UMI_ED"], ed, "i")
                rec.set_tag(tags["UMI_ED_SECOND_BEST"], INT_MAX, "i")
                rec.set_tag(tags["UMI_START"], ub, "i")
                rec.set_tag(tags["UMI_END"], ue, "i")
                if cl.from_clustering:
                    rec.set_tag(tags["UMI_FROM_CLUSTERING"], 1, "i")
                if cl.is_readseq:
                    rec.set_tag(tags["UMI_IS_READSEQ"], 1, "i")
                if umi_reduced:
                    rec.set_tag(tags["UMI_REDUCED_LENGTH"], 1, "i")
                self.stats.umi_assigned += 1
                gene = rec.get_tag(self.cfg.barcode_umi_finder.gene_name_attribute)
                if gene:
                    self.genecounts[(gene, info.bc)].add(center)
                writer.write(rec)

    def run(self, in_bam: str | Path, out_bam: str | Path,
            genecounts_tsv=None, umidepths_tsv=None, log_json=None):
        cfg_bc = self.cfg.barcodes
        anchor_d = cfg_bc.distance_from_read_end_for_grouping
        region_d = cfg_bc.max_genome_distance_for_grouping
        gene_attr = self.cfg.barcode_umi_finder.gene_name_attribute
        tags = self.cfg.sam_tags
        with BamReader(in_bam) as rd:
            ref_names = [n for n, _ in rd.header.refs]
            out_bam = Path(out_bam)
            out_bam.parent.mkdir(parents=True, exist_ok=True)
            with BamWriter(out_bam, rd.header) as w:
                # several open groups per cell (fwd/rev anchors interleave at
                # one locus); a group closes once the sorted sweep position
                # passes anchor + grouping distance — no later record can
                # have an anchor that near (input must be coordinate-sorted)
                open_groups: dict[str, list[dict]] = defaultdict(list)
                last_ref = -1

                def flush_all():
                    for cell in list(open_groups):
                        for g in open_groups.pop(cell):
                            self._flush_group(g["recs"], w, ref_names)

                def flush_passed(cur_pos: int):
                    for cell in list(open_groups):
                        keep = []
                        for g in open_groups[cell]:
                            if g["a0"] + anchor_d < cur_pos:
                                self._flush_group(g["recs"], w, ref_names)
                            else:
                                keep.append(g)
                        if keep:
                            open_groups[cell] = keep
                        else:
                            del open_groups[cell]

                for rec in rd:
                    self.stats.total_records += 1
                    if rec.ref_id != last_ref:
                        flush_all()
                        last_ref = rec.ref_id
                    # gene tagging (before grouping, like GennameTagger):
                    # the jar routes both assignumis and addgenenametag
                    # through Drop-seq TagReadWithGeneExonFunction
                    # (Jar/config.xml:88-90), so use the LocusFunction
                    # annotate() path over the alignment M-blocks — the
                    # earlier exonic*1000 heuristic ranked overlapping
                    # genes differently from the reference GE
                    if self.tagger is not None and rec.get_tag(gene_attr) is None \
                            and not rec.is_unmapped:
                        chrom = ref_names[rec.ref_id] if rec.ref_id >= 0 else None
                        if chrom:
                            blocks = []
                            pos = rec.pos + 1
                            for op, ln in rec.cigar:
                                if op in ("M", "=", "X"):
                                    blocks.append((pos, pos + ln - 1))
                                    pos += ln
                                elif op in ("N", "D"):
                                    pos += ln
                            ge, _gs, _xf = self.tagger.annotate(
                                chrom, blocks or
                                [(rec.pos + 1, rec.reference_end())],
                                "-" if rec.is_reverse else "+")
                            if ge:
                                rec.set_tag(gene_attr, ge, "Z")
                    res = self._analyze(rec, ref_names)
                    if res is None:
                        self.stats.no_scan_info += 1
                        w.write(rec)
                        continue
                    info, umi, qv, ub, ue = res
                    if not umi:
                        # keep readscan info, no UMI
                        rec.set_tag(tags["CELL_BC"], info.bc, "Z")
                        rec.set_tag(tags["UMI_TOOSHORT"], 1, "i")
                        w.write(rec)
                        continue
                    # genomic 3'-end anchor: where the polyA side maps -
                    # alignment end on + strand, start on - strand
                    anchor = rec.pos + 1 if rec.is_reverse else rec.reference_end()
                    cell = info.bc
                    target = None
                    for g in open_groups[cell]:
                        if (abs(anchor - g["a0"]) <= anchor_d
                                and max(g["hi"], anchor)
                                - min(g["lo"], anchor) <= region_d):
                            target = g
                            break
                    if target is None:
                        target = {"a0": anchor, "lo": anchor, "hi": anchor,
                                  "recs": []}
                        open_groups[cell].append(target)
                    else:
                        target["lo"] = min(target["lo"], anchor)
                        target["hi"] = max(target["hi"], anchor)
                    target["recs"].append((rec, info, umi, qv, ub, ue))
                    flush_passed(rec.pos)
                flush_all()
        if genecounts_tsv:
            with open(genecounts_tsv, "w") as fh:
                fh.write("geneId\tcellBC\tnbUmis\n")
                for (gene, cell), s in sorted(self.genecounts.items()):
                    fh.write(f"{gene}\t{cell}\t{len(s)}\n")
        if umidepths_tsv:
            with open(umidepths_tsv, "w") as fh:
                fh.write("depth\tnbUmis\n")
                for depth in sorted(self.stats.umi_depth_hist):
                    fh.write(f"{depth}\t{self.stats.umi_depth_hist[depth]}\n")
        if log_json:
            with open(log_json, "w") as fh:
                json.dump(self.stats.to_json(), fh, indent=1)
        return self.stats
