"""Configuration system mirroring the reference's three config tiers.

The reference reads a JAXB-validated ``config.xml`` with sections
general / readscanner / barcodeUMIFinder / polyAT / adapters / TSO /
barcodes / umis / samFlags (see the Java reference, Jar/config.xml:9-493), plus
dynamic edit-distance XML tables (bcMaxEditDistances.xml,
umiMaxEditDistances.xml, umiClusteringEditDistances.xml) and per-program CLI
arguments. Here the same parameter surface is exposed as typed dataclasses,
loadable from the reference XML format so existing config files keep working.
SAM tag names are configuration, not constants, exactly as in the reference
(config.xml:297-492).
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class GeneralConfig:
    verbose_errors: bool = True
    n_threads: int | None = None


@dataclass
class ReadScannerConfig:
    min_read_length: int = 200
    merge_bcs_ed: int | None = None  # default: barcode search ED
    cells_with_reads_nfold_below_max_to_keep: int = 500
    running_as_demon: bool = False
    n_reads_analyze_first_pass: int = 20_000_000
    serialized_stat_file: str = "stats.json"
    test_plus_minus_pos: int = 2
    file_with_all_possible_tenx_barcodes: str = "3M-february-2018.txt.gz"
    # read-name metadata prefixes (the stage-1 -> stage-3 data contract,
    # reference README.md:396-459)
    pa_start_prefix: str = "PS="
    pa_end_prefix: str = "PE="
    adapter_pos_prefix: str = "AE="
    tso_pos_prefix: str = "T="
    seq_prefix: str = "X="
    qv_prefix: str = "Q="
    min_mean_bc_qv: float = 8.0
    min_mean_read_qv: float = 8.0
    min_adapter3p_matches: int = 8
    min_count_fold: int = 10
    bc_scan_test_til_ed: int | None = None
    nbases_of_adapter_seq_in_readname: int = 3


@dataclass
class BarcodeUMIFinderConfig:
    output_directory: str = "Nanopore_BC_UMIfinder"
    output_filesuffix: str = "BC_UMI"
    sam_records_chunk_size: int = 250_000
    lenient_input_bam_validation: bool = True
    genelist_separator: str = ","
    gene_name_attribute: str = "GE"
    tag_gene_name_function: str = "DefaultTagger"


@dataclass
class PolyATConfig:
    polyat_length: int = 15
    fraction_at_in_polyat: float = 0.75
    internal_pat_length: int = 15
    internal_fraction_at_in_polyat: float = 0.70
    internal_min_polyat_length_for_reporting: int = 20
    window_search_for_polya: int = 150


@dataclass
class AdapterConfig:
    """Adapter searched upstream of the cell barcode (Needleman-Wunsch)."""
    sequence: str = "CTTCCGATCT"
    sequence_complete: str = "CTACACGACGCTCTTCCGATCT"
    max_needleman_mismatches: int = 3
    max_complete_seq_needleman_mismatches: int = 5
    adapter_search_window: int = 110


@dataclass
class TSOConfig:
    sequence: str = "AACGCAGAGTACATGG"
    max_needleman_mismatches: int = 5
    min_tso_consecutive_matches: int = 8
    min_tso_two_best_consecutive_matches: int = 12
    window_for_tso_search: int = 90
    offset_tso_end: int = 1
    sequence_complete: str = "AAGCAGTGGTATCAACGCAGAGTACAT"
    max_complete_seq_needleman_mismatches: int = 6


@dataclass
class BarcodesConfig:
    cell_bc_length: int = 16
    edit_distance_xml: str = "bcMaxEditDistances.xml"
    bc_posplusminus: int = 2
    distance_from_read_end_for_grouping: int = 100
    max_genome_distance_for_grouping: int = 500
    cell_bc_bailout_after_ed: int | None = 2


@dataclass
class UMIConfig:
    umi_length: int = 12
    edit_distance_xml: str = "umiMaxEditDistances.xml"
    clustering_edit_distance_xml: str = "umiClusteringEditDistances.xml"
    umi_posplusminus: int = 2
    umi_completelink_clustering_ed: int = 2
    umi_singlelink_clustering_ed: int = 1
    max_complexity_for_umi_clustering: int = 100_000
    pregroup_for_clustering_threshold: int = 1_000
    complexity_threshold_for_switch_to_single_link: int = 3_000
    umi_bailout_after_ed: int | None = None


# Default SAM tag vocabulary — the de facto ABI between pipeline stages
# (reference Jar/config.xml:297-492). Keys are stable internal identifiers,
# values are 2-char SAM tags; all are reconfigurable.
DEFAULT_SAM_TAGS: dict[str, str] = {
    "READ_ID": "SX",
    "READ_REVERSED": "RE",
    "POLYAT_END": "PE",
    "POLYAT_START": "PS",
    "ADAPTER_END": "AE",
    "TSO_END": "TE",
    "BC_SEQ_READSCAN": "BU",
    "BC_SEQ_READSCAN_BEGIN": "BV",
    "BC_SEQ_READSCAN_END": "BE",
    "BC_SEQ_READSCAN_ED": "BW",
    "BC_SEQ_READSCAN_ED_SECOND": "BX",
    "NO_GENE_IN_NANOPORE_SAM": "BG",
    "POSTADAPTER_SEQ_TOOSHORT": "BS",
    "BC_MORE_THAN_ONE_MATCH": "BM",
    "BARCODE_ED": "B1",
    "BARCODE_ED_SECOND_BEST": "B2",
    "BARCODE_START": "BB",
    "BARCODE_END": "BF",
    "CELL_BC_FROM_READSCAN": "BZ",
    "CELL_BC_READSCAN_RANK": "BH",
    "CELL_BC": "BC",
    "UMI_MORE_THAN_ONE_MATCH": "U9",
    "UMI_TOOSHORT": "UT",
    "UMI_ED": "U1",
    "UMI_ED_SECOND_BEST": "U2",
    "UMI_START": "UB",
    "UMI_END": "UE",
    "UMI_SEQ": "U8",
    "UMI_READ_SEQ": "U7",
    "UMI_FROM_CLUSTERING": "UC",
    "UMI_IS_READSEQ": "UZ",
    "UMI_REDUCED_LENGTH": "UR",
    "GENE": "GE",
    "READ_COUNT": "RN",
    "READ_SEQ": "US",
    "READ_QUALS": "QS",
    "CDNA_SEQ": "CS",
    "ISOFORM_GENE": "IG",
    "ISOFORM_TRANSCRIPT": "IT",
}


@dataclass
class PipelineConfig:
    # "3p" (default) or "5p" barcoding chemistry (reference -h/--fivePbc;
    # 5': adapter-BC-UMI-TSO at the stranded read 5' start, config.xml:120-185)
    chemistry: str = "3p"
    general: GeneralConfig = field(default_factory=GeneralConfig)
    readscanner: ReadScannerConfig = field(default_factory=ReadScannerConfig)
    barcode_umi_finder: BarcodeUMIFinderConfig = field(default_factory=BarcodeUMIFinderConfig)
    polyat: PolyATConfig = field(default_factory=PolyATConfig)
    adapter3p: AdapterConfig = field(default_factory=AdapterConfig)
    adapter5p: AdapterConfig = field(default_factory=lambda: AdapterConfig(adapter_search_window=110))
    adapter5p_3prime: AdapterConfig = field(
        default_factory=lambda: AdapterConfig(
            sequence="AACGCAGAGTAC", sequence_complete="AAGCAGTGGTATCAACGCAGAGTAC"
        )
    )
    tso3p: TSOConfig = field(default_factory=TSOConfig)
    tso5p: TSOConfig = field(default_factory=TSOConfig)
    barcodes: BarcodesConfig = field(default_factory=BarcodesConfig)
    umis: UMIConfig = field(default_factory=UMIConfig)
    sam_tags: dict[str, str] = field(default_factory=lambda: dict(DEFAULT_SAM_TAGS))


# ---------------------------------------------------------------------------
# XML loading (reference-compatible format)
# ---------------------------------------------------------------------------

def _text(node: ET.Element | None, default=None):
    if node is None or node.text is None:
        return default
    t = node.text.strip()
    return default if t in ("", "null") else t


def _get(root: ET.Element, path: str, cast, default):
    v = _text(root.find(path))
    if v is None:
        return default
    if cast is bool:
        return v.lower() == "true"
    return cast(v)


def load_config_xml(path: str | Path) -> PipelineConfig:
    """Load a reference-format config.xml into a PipelineConfig.

    Unknown/Illumina-guided-only elements are ignored; missing elements keep
    their defaults — matching the reference's lenient JAXB behavior.
    """
    root = ET.parse(str(path)).getroot()
    cfg = PipelineConfig()

    g = cfg.general
    g.verbose_errors = _get(root, "general/verbose_errors", bool, g.verbose_errors)

    r = cfg.readscanner
    r.min_read_length = _get(root, "readscanner/minReadLength", int, r.min_read_length)
    r.merge_bcs_ed = _get(root, "readscanner/mergeBCsED", int, r.merge_bcs_ed)
    r.cells_with_reads_nfold_below_max_to_keep = _get(
        root, "readscanner/cellsWithReadsnFoldBelowMaxToKeep", int,
        r.cells_with_reads_nfold_below_max_to_keep)
    r.running_as_demon = _get(root, "readscanner/runningasdemon", bool, r.running_as_demon)
    r.n_reads_analyze_first_pass = _get(
        root, "readscanner/nReadsAnalyzeFirstPass", int, r.n_reads_analyze_first_pass)
    r.test_plus_minus_pos = _get(root, "readscanner/testPlusMinusPos", int, r.test_plus_minus_pos)
    r.file_with_all_possible_tenx_barcodes = _get(
        root, "readscanner/fileWithAllPossibleTenXbarcodes", str,
        r.file_with_all_possible_tenx_barcodes)
    for attr, tag in [("pa_start_prefix", "pa_start_prefix"), ("pa_end_prefix", "pa_end_prefix"),
                      ("adapter_pos_prefix", "adapter_pos_prefix"), ("tso_pos_prefix", "tso_pos_prefix"),
                      ("seq_prefix", "seq_prefix"), ("qv_prefix", "qv_prefix")]:
        setattr(r, attr, _get(root, f"readscanner/{tag}", str, getattr(r, attr)))
    r.min_mean_bc_qv = _get(root, "readscanner/minMeanBCqv", float, r.min_mean_bc_qv)
    r.min_mean_read_qv = _get(root, "readscanner/minMeanReadqv", float, r.min_mean_read_qv)
    r.min_adapter3p_matches = _get(root, "readscanner/minAdapter3pMatches", int, r.min_adapter3p_matches)
    r.min_count_fold = _get(root, "readscanner/minCountFold", int, r.min_count_fold)
    r.nbases_of_adapter_seq_in_readname = _get(
        root, "readscanner/nbasesOfAdapterSeqInReadname", int, r.nbases_of_adapter_seq_in_readname)

    b = cfg.barcode_umi_finder
    b.output_directory = _get(root, "barcodeUMIFinder/output_directory", str, b.output_directory)
    b.output_filesuffix = _get(root, "barcodeUMIFinder/output_filesuffix", str, b.output_filesuffix)
    b.sam_records_chunk_size = _get(root, "barcodeUMIFinder/sam_records_chunk_size", int,
                                    b.sam_records_chunk_size)
    b.genelist_separator = _get(root, "barcodeUMIFinder/nanoporeBAMgenelist_seperator", str,
                                b.genelist_separator)
    b.gene_name_attribute = _get(root, "barcodeUMIFinder/gene_name_attribute", str,
                                 b.gene_name_attribute)

    p = cfg.polyat
    p.polyat_length = _get(root, "polyAT/polyATlength", int, p.polyat_length)
    p.fraction_at_in_polyat = _get(root, "polyAT/fractionATInPolyAT", float, p.fraction_at_in_polyat)
    p.internal_pat_length = _get(root, "polyAT/internalpATlength", int, p.internal_pat_length)
    p.internal_fraction_at_in_polyat = _get(root, "polyAT/internalFractionATInPolyAT", float,
                                            p.internal_fraction_at_in_polyat)
    p.internal_min_polyat_length_for_reporting = _get(
        root, "polyAT/internalMinPolyATlengthForReporting", int,
        p.internal_min_polyat_length_for_reporting)
    p.window_search_for_polya = _get(root, "polyAT/windowSearchForPolyA", int, p.window_search_for_polya)

    def _adapter(section: str, dst: AdapterConfig):
        dst.sequence = _get(root, f"{section}/sequence", str, dst.sequence)
        dst.sequence_complete = _get(root, f"{section}/sequence_complete", str, dst.sequence_complete)
        dst.max_needleman_mismatches = _get(root, f"{section}/maxNeedlemanMismatches", int,
                                            dst.max_needleman_mismatches)
        dst.max_complete_seq_needleman_mismatches = _get(
            root, f"{section}/maxCompleteSeqNeedlemanMismatches", int,
            dst.max_complete_seq_needleman_mismatches)
        dst.adapter_search_window = _get(root, f"{section}/AdapterSearchWindow", int,
                                         dst.adapter_search_window)

    _adapter("adapter_for3pBarcoding", cfg.adapter3p)
    _adapter("fiveprimeadapter_for5pBarcoding", cfg.adapter5p)
    _adapter("threeprimeadapter_for5pBarcoding", cfg.adapter5p_3prime)

    def _tso(section: str, dst: TSOConfig):
        dst.sequence = _get(root, f"{section}/sequence", str, dst.sequence)
        dst.max_needleman_mismatches = _get(root, f"{section}/maxNeedlemanMismatches", int,
                                            dst.max_needleman_mismatches)
        dst.min_tso_consecutive_matches = _get(root, f"{section}/minTSO_NeedlemanConsecutiveMatches",
                                               int, dst.min_tso_consecutive_matches)
        dst.min_tso_two_best_consecutive_matches = _get(
            root, f"{section}/minTSO_TwoBestConsecutiveMatches", int,
            dst.min_tso_two_best_consecutive_matches)
        dst.window_for_tso_search = _get(root, f"{section}/windowForTSOsearch", int,
                                         dst.window_for_tso_search)
        dst.offset_tso_end = _get(root, f"{section}/offsetTSOend", int, dst.offset_tso_end)
        dst.sequence_complete = _get(root, f"{section}/sequence_complete", str, dst.sequence_complete)
        dst.max_complete_seq_needleman_mismatches = _get(
            root, f"{section}/maxCompleteSeqNeedlemanMismatches", int,
            dst.max_complete_seq_needleman_mismatches)

    _tso("tso_for3pBarcoding", cfg.tso3p)
    _tso("tso_for5pBarcoding", cfg.tso5p)

    bc = cfg.barcodes
    bc.cell_bc_length = _get(root, "barcodes/cell_bc_length", int, bc.cell_bc_length)
    bc.edit_distance_xml = _get(root, "barcodes/edit_distance_xml", str, bc.edit_distance_xml)
    bc.bc_posplusminus = _get(root, "barcodes/bc_posplusminus", int, bc.bc_posplusminus)
    bc.distance_from_read_end_for_grouping = _get(
        root, "barcodes/distance_from_read_end_for_grouping", int,
        bc.distance_from_read_end_for_grouping)
    bc.max_genome_distance_for_grouping = _get(
        root, "barcodes/max_GenomeDistance_forGrouping", int, bc.max_genome_distance_for_grouping)

    u = cfg.umis
    u.umi_length = _get(root, "umis/umi_length", int, u.umi_length)
    u.umi_posplusminus = _get(root, "umis/umi_posplusminus", int, u.umi_posplusminus)
    u.umi_completelink_clustering_ed = _get(root, "umis/umi_completelinkclusteringED", int,
                                            u.umi_completelink_clustering_ed)
    u.umi_singlelink_clustering_ed = _get(root, "umis/umi_singlelinkclusteringED", int,
                                          u.umi_singlelink_clustering_ed)
    u.max_complexity_for_umi_clustering = _get(root, "umis/maxComplexityForUMIclustering", int,
                                               u.max_complexity_for_umi_clustering)
    u.pregroup_for_clustering_threshold = _get(root, "umis/pregroup_for_clustering_threshold", int,
                                               u.pregroup_for_clustering_threshold)
    u.complexity_threshold_for_switch_to_single_link = _get(
        root, "umis/complexity_threshold_for_switch_to_single_link_clustering", int,
        u.complexity_threshold_for_switch_to_single_link)

    # samFlags: every leaf with a <samFlag> child remaps a tag by element name
    for section in root.findall("samFlags/*"):
        for entry in section:
            flag = _text(entry.find("samFlag"))
            if flag:
                _XML_TO_TAGKEY = {
                    "ReadId": "READ_ID", "ReadReversed": "READ_REVERSED",
                    "POLYAT_END": "POLYAT_END", "POLYAT_START": "POLYAT_START",
                    "ADAPTER_END": "ADAPTER_END", "TSO_END": "TSO_END",
                    "BC_SEQ_READSCAN": "BC_SEQ_READSCAN",
                    "BC_SEQ_READSCAN_BEGIN": "BC_SEQ_READSCAN_BEGIN",
                    "BC_SEQ_READSCAN_END": "BC_SEQ_READSCAN_END",
                    "BC_SEQ_READSCAN_ED": "BC_SEQ_READSCAN_ED",
                    "BC_SEQ_READSCAN_ED_SECOND": "BC_SEQ_READSCAN_ED_SECOND",
                    "NO_GENE_IN_NANOPORE_SAM": "NO_GENE_IN_NANOPORE_SAM",
                    "POSTADAPTER_SEQ_PLUS_POLYT_TOOSHORT": "POSTADAPTER_SEQ_TOOSHORT",
                    "MORE_THAN_ONE_MATCH": None,  # ambiguous between BC/UMI; use section
                    "BARCODE_ED": "BARCODE_ED",
                    "BARCODE_ED_SECOND_BEST_MATCH": "BARCODE_ED_SECOND_BEST",
                    "BARCODE_START": "BARCODE_START", "BARCODE_END": "BARCODE_END",
                    "CELL_BC_SEQ_FROM_READSCAN": "CELL_BC_FROM_READSCAN",
                    "CELL_BC_SEQ_FROM_READSCAN_RANK": "CELL_BC_READSCAN_RANK",
                    "CELL_BC": "CELL_BC",
                    "POSTBARCODE_SEQ_PLUS_POLYT_TOOSHORT": "UMI_TOOSHORT",
                    "UMI_EDIT_DISTANCE": "UMI_ED",
                    "UMI_EDIT_DISTANCE_SECOND_BEST_MATCH": "UMI_ED_SECOND_BEST",
                    "UMI_START": "UMI_START", "UMI_END": "UMI_END",
                    "UMI_sequence": "UMI_SEQ", "UMI_read_sequence": "UMI_READ_SEQ",
                    "UMI_IS_FROM_CLUSTERING": "UMI_FROM_CLUSTERING",
                    "UMI_IS_JUST_READSEQ": "UMI_IS_READSEQ",
                    "UMI_match_with_reduced_length": "UMI_REDUCED_LENGTH",
                }
                key = _XML_TO_TAGKEY.get(entry.tag)
                if key is None and entry.tag == "MORE_THAN_ONE_MATCH":
                    key = ("BC_MORE_THAN_ONE_MATCH" if section.tag == "barcodeFindingSAMtag"
                           else "UMI_MORE_THAN_ONE_MATCH")
                if key:
                    cfg.sam_tags[key] = flag.strip()
    return cfg


# ---------------------------------------------------------------------------
# Dynamic edit-distance tables (bcMaxEditDistances.xml format)
# ---------------------------------------------------------------------------

@dataclass
class DynamicEDTable:
    """max allowed ED as f(#candidates, error%, BC/UMI length).

    Mirrors com.rw.parameters.DynamicEditDistances semantics: for a given
    sequence length and assumed error percent, each entry gives the maximum
    candidate-set size for which a given ED is still safe (bounded
    false-assignment rate). Reference: Jar/bcMaxEditDistances.xml:7-35.
    """
    # table[length][error_percent] = sorted list of (ed, max_candidates)
    table: dict[int, dict[int, list[tuple[int, int]]]] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str | Path) -> "DynamicEDTable":
        root = ET.parse(str(path)).getroot()
        out = cls()
        for lennode in root.findall(".//dataForUMIlength"):
            length = int(_text(lennode.find("umiBCLength")))
            by_err = out.table.setdefault(length, {})
            for errnode in lennode.findall("dataForErr"):
                err = int(_text(errnode.find("errorpercent")))
                entries = []
                for ednode in errnode.findall("dataForED"):
                    entries.append((int(_text(ednode.find("editDistance"))),
                                    int(_text(ednode.find("maxBarcodes")))))
                by_err[err] = sorted(entries)
        return out

    def max_ed(self, length: int, error_percent: int, n_candidates: int) -> int:
        """Largest ED whose max-candidate bound admits n_candidates."""
        by_err = self.table.get(length)
        if not by_err:
            return 0
        entries = by_err.get(error_percent)
        if entries is None and by_err:
            # nearest available error percent
            k = min(by_err, key=lambda e: abs(e - error_percent))
            entries = by_err[k]
        best = 0
        for ed, max_cands in entries:
            if n_candidates <= max_cands:
                best = max(best, ed)
        return best


def asdict(cfg: PipelineConfig) -> dict:
    return dataclasses.asdict(cfg)
