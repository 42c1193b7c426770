"""sicelore_tpu_torch CLI: every command of `python -m sicelore_tpu`, with
the same flags and defaults, plus `env`.

  python -m sicelore_tpu_torch run -d <fastq dir> -r <genome fasta>
         -a <refFlat> -o <out> --whitelist <10x list> --nativeAlign
         [--consensus --collapse] [--device cuda|cpu]
  python -m sicelore_tpu_torch scanfastq -d <fastq dir|file,...> -o <out>
         --whitelist <10x list> [--device cuda|cpu] ...
  python -m sicelore_tpu_torch align -r <genome fasta> -d <fastq|dir>
         -O <sorted BAM> [--juncBed <bed>] [--keep-unmapped] [--device ...]
  python -m sicelore_tpu_torch assignumis -i <sorted BAM> -o <tagged BAM>
         [-a <refFlat>] [-f] [--illumina <table>] [--device cuda|cpu]
  python -m sicelore_tpu_torch computeconsensus -I <tagged BAM> -O <fastq>
         [--MAXREADS 20 --MINPS 3 --MAXPS 20 --refine --host-engine]
         [--device cuda|cpu] [--trace <trace.json>]
  python -m sicelore_tpu_torch precompile [--nbc 8192 --full]
         [--device cuda|cpu]
  python -m sicelore_tpu_torch isoformmatrix|collapsemodel|snpmatrix|...
  python -m sicelore_tpu_torch env

`--device` (default cuda: the hand-written kernels; cpu runs the plain
torch bodies; cuda without a GPU raises) is the one option the port adds,
on the six commands that reach the card: scanfastq (edge scan, whitelist
sweep, tile scan), align (the band kernel of its gap extension),
assignumis (the UMI distance matrices of large groups), computeconsensus
(the band kernel), run (all of these) and precompile (builds and launches
every kernel). Every other command is host code and takes no `--device`.
`run`'s consensus stage uses the host engine, as the reference package's
`run` does. `env` reports the torch/CUDA build, the GPU, and whether nvcc,
triton and the native host codecs are present. `computeconsensus --trace
PATH` runs with the program's tracer on (`utils/trace.py`) and writes its
spans, kernel launches and counters to PATH as Chrome trace-event JSON.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import sys
from pathlib import Path


def _add_scanfastq(sub):
    p = sub.add_parser("scanfastq", help="strand reads, split chimeras, "
                       "assign cell barcodes (reference scanfastq)")
    p.add_argument("-d", "--inDir", required=True,
                   help="comma-separated directories/files to search for fastq")
    p.add_argument("-o", "--outDir", required=True)
    p.add_argument("-b", "--bcEditDistance", type=int, default=1,
                   help="max edit distance for barcode assignment (default 1)")
    p.add_argument("-g", "--cellRangerBCs", default=None,
                   help="tsv of known cell barcodes; skips pass-1 discovery")
    p.add_argument("--whitelist", default=None,
                   help="10x whitelist file (3M-february-2018.txt.gz / 737K)")
    p.add_argument("-e", "--randomBarcode", action="store_true",
                   help="negative control: replace BC windows with random seq")
    p.add_argument("-5", "--fivePbc", action="store_true",
                   help="5' barcoding chemistry (reference -h/--fivePbc)")
    p.add_argument("--demon", action="store_true",
                   help="keep watching the input dirs for new fastq files "
                        "(reference runningasdemon)")
    p.add_argument("--pollInterval", type=float, default=30.0)
    p.add_argument("--idleTimeout", type=float, default=600.0)
    p.add_argument("-c", "--compress", action="store_true")
    p.add_argument("-v", "--pattern", default=r".{1,}\.(fastq|fq)(\.gz)?$")
    p.add_argument("--config", default=None, help="reference-format config.xml")
    p.add_argument("--chunkSize", type=int, default=50_000)
    p.add_argument("--errorPercent", type=int, default=1,
                   help="assumed read error %% for the dynamic ED table")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: the CUDA kernels; cpu: plain torch bodies")
    return p


def cmd_scanfastq(args) -> int:
    from sicelore_tpu_torch.utils.config import PipelineConfig, load_config_xml
    from sicelore_tpu_torch.pipeline.scanfastq import (ScanFastqPipeline,
                                                       load_whitelist)

    cfg = load_config_xml(args.config) if args.config else PipelineConfig()
    if args.fivePbc:
        cfg.chemistry = "5p"
    if args.cellRangerBCs:
        with open(args.cellRangerBCs) as fh:
            wl = [l.strip().split("-")[0] for l in fh if l.strip()]
    elif args.whitelist:
        wl = load_whitelist(args.whitelist)
    else:
        print("ERROR: provide --whitelist (10x barcode list) or "
              "-g/--cellRangerBCs", file=sys.stderr)
        return 2
    pipe = ScanFastqPipeline(cfg, whitelist=wl,
                             random_barcode=args.randomBarcode,
                             chunk_size=args.chunkSize,
                             error_percent=args.errorPercent,
                             user_max_ed=args.bcEditDistance,
                             known_cells=bool(args.cellRangerBCs),
                             compress=args.compress, device=args.device)
    inputs = [Path(s) for s in args.inDir.split(",")]
    if args.demon:
        stats = pipe.run_demon(inputs, args.outDir,
                               poll_interval=args.pollInterval,
                               idle_timeout=args.idleTimeout)
    else:
        stats = pipe.run(inputs, args.outDir)
    print(f"scanfastq done: {stats.total_reads} reads, "
          f"{stats.stranded} stranded, {stats.bc_assigned} BC-assigned "
          f"({stats.split_chimeric} chimera splits, "
          f"{stats.multi_chimeric_discarded} multi-chimeric discarded)")
    return 0


def _add_computeconsensus(sub):
    p = sub.add_parser("computeconsensus", help="per-molecule consensus "
                       "fastq (reference ComputeConsensus; native engine, "
                       "no spoa)")
    p.add_argument("-I", "--INPUT", required=True,
                   help="BC/U8-tagged BAM with US/CS sequence tags")
    p.add_argument("-O", "--OUTPUT", required=True, help="output fastq")
    p.add_argument("--MAXREADS", type=int, default=20)
    p.add_argument("--MINPS", type=int, default=3)
    p.add_argument("--MAXPS", type=int, default=20)
    p.add_argument("--host-engine", action="store_true",
                   help="the host consensus engine for every molecule")
    p.add_argument("--refine", action="store_true",
                   help="second alignment pass re-centered on the pass-1 "
                        "consensus (about twice the device time)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: the CUDA kernel; cpu: plain torch bodies")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="write the run's trace to PATH as Chrome "
                        "trace-event JSON (chrome://tracing, Perfetto): "
                        "host spans and kernel launches on one clock, "
                        "counters as C events")
    return p


def cmd_computeconsensus(args) -> int:
    from sicelore_tpu_torch.pipeline.consensus import compute_consensus
    from sicelore_tpu_torch.utils import trace

    engine = "host"
    if not args.host_engine:
        # a device or kernel that fails raises: the host engine never
        # stands in unasked
        from sicelore_tpu_torch.ops.poa_cuda import BatchedConsensusEngine
        engine = BatchedConsensusEngine(maxreads=args.MAXREADS,
                                        device=args.device)
        if args.refine:
            engine = functools.partial(engine, refine=True)
    if args.trace:
        trace.enable()
    try:
        stats = compute_consensus(args.INPUT, args.OUTPUT,
                                  maxreads=args.MAXREADS, minps=args.MINPS,
                                  maxps=args.MAXPS, engine=engine,
                                  log_json=str(args.OUTPUT) + ".log")
        if args.trace:
            trace.dump(trace.snapshot(), args.trace)
    finally:
        trace.disable()
    print(f"computeconsensus done: {stats['written']}/{stats['molecules']} "
          f"molecules")
    return 0


def _device_arg(p, help_text):
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help=help_text)


def _add_align(sub):
    p = sub.add_parser("align", help="spliced long-read alignment -> "
                       "sorted BAM+BAI (the minimap2 -ax splice role, "
                       "framework-native)")
    p.add_argument("-r", "--reference", required=True, help="genome fasta")
    p.add_argument("-d", "--fastq", required=True,
                   help="fastq file or directory")
    p.add_argument("-O", "--OUTPUT", required=True, help="output BAM")
    p.add_argument("--juncBed", default=None,
                   help="annotated junction BED (chrom/start/end), the "
                        "minimap2 --junc-bed role")
    p.add_argument("--keep-unmapped", action="store_true")
    _device_arg(p, "cuda: the band kernel for the gap extension; cpu: its "
                   "plain torch version")
    return p


def cmd_align(args) -> int:
    from sicelore_tpu_torch.align import NativeAligner

    aln = NativeAligner(args.reference, junc_bed=args.juncBed,
                        device=args.device)
    r = aln.align_fastq_to_bam(args.fastq, args.OUTPUT,
                               keep_unmapped=args.keep_unmapped)
    print(f"align done: {r['mapped']}/{r['reads']} reads mapped")
    return 0


def _add_assignumis(sub):
    p = sub.add_parser("assignumis", help="per-cell per-region UMI "
                       "clustering on a sorted BAM (reference assignumis)")
    p.add_argument("-i", "--inFileNanopore", required=True,
                   help="sorted Nanopore BAM (scanfastq read names)")
    p.add_argument("-o", "--outfile", required=True)
    p.add_argument("-a", "--annotationFile", default=None,
                   help="refFlat for GE gene tagging + genecounts")
    p.add_argument("-f", "--randomUMI", action="store_true",
                   help="negative control: random UMI sequences")
    p.add_argument("--illumina", default=None,
                   help="parseillumina table (json.gz) for guided mode")
    p.add_argument("--config", default=None)
    _device_arg(p, "cuda: the UMI distance matrices of large groups on the "
                   "card; cpu: the same torch body on the host")
    return p


def cmd_assignumis(args) -> int:
    from sicelore_tpu_torch.pipeline.assignumis import AssignUmisPipeline
    from sicelore_tpu_torch.utils.config import PipelineConfig, load_config_xml

    cfg = load_config_xml(args.config) if args.config else PipelineConfig()
    illum = None
    if args.illumina:
        from sicelore_tpu_torch.pipeline.illumina import GuidedUmiTable
        illum = GuidedUmiTable(args.illumina)
    pipe = AssignUmisPipeline(cfg, refflat=args.annotationFile,
                              random_umi=args.randomUMI,
                              illumina_table=illum, device=args.device)
    out = Path(args.outfile)
    stats = pipe.run(args.inFileNanopore, out,
                     genecounts_tsv=out.with_suffix("").with_name(
                         out.stem + ".genecounts.tsv"),
                     umidepths_tsv=out.with_suffix("").with_name(
                         out.stem + ".UMIdepths.tsv"),
                     log_json=str(out) + ".log")
    print(f"assignumis done: {stats.total_records} records, "
          f"{stats.umi_assigned} UMI-assigned "
          f"({stats.clustered} clusters, {stats.singletons} singletons)")
    return 0


def _add_isoformmatrix(sub):
    p = sub.add_parser("isoformmatrix", help="cell x isoform/gene/junction "
                       "UMI matrices (reference IsoformMatrix)")
    p.add_argument("-I", "--INPUT", required=True, help="BC/U8/GE-tagged BAM")
    p.add_argument("-R", "--REFFLAT", required=True)
    p.add_argument("-C", "--CSV", required=True, help="cell barcode csv")
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-P", "--PREFIX", default="sicelore")
    p.add_argument("--DELTA", type=int, default=2)
    p.add_argument("--METHOD", default="STRICT")
    p.add_argument("--AMBIGUOUS_ASSIGN", action="store_true")
    p.add_argument("--MAPQV0", action="store_true")
    p.add_argument("--ISOBAM", action="store_true")
    p.add_argument("--TOBULK", action="store_true")
    return p


def cmd_isoformmatrix(args) -> int:
    from sicelore_tpu_torch.pipeline.isoform import isoform_matrix

    log = isoform_matrix(args.INPUT, args.REFFLAT, args.CSV, args.OUTDIR,
                         prefix=args.PREFIX, delta=args.DELTA,
                         method=args.METHOD,
                         ambiguous_assign=args.AMBIGUOUS_ASSIGN,
                         mapqv0=args.MAPQV0, isobam=args.ISOBAM,
                         tobulk=args.TOBULK)
    print(f"isoformmatrix done: {log['molecules']} molecules, "
          f"{log['matrix_isoforms']} isoform rows, "
          f"{log['isoform_def']} defined / {log['isoform_undef']} undef")
    return 0


def _add_simple_programs(sub):
    """Host-side stream-rewrite programs (pipeline.programs, .snp_fusion),
    the workflow `run` and `precompile`."""
    p = sub.add_parser("tagbamwithread", help="add US/QS read-sequence tags "
                       "from fastq (reference tagbamwithread)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("-F", "--FASTQ", required=True, help="fastq file or dir")

    p = sub.add_parser("deduplicatemolecule",
                       help="dedup consensus fastq by (BC,U8), keep max RN")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("addbammoleculetags",
                       help="read name BC-U8-RN -> BC/U8/RN tags")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("addgenenametag", help="GE gene tag from refFlat "
                       "overlap (reference AddGeneNameTag)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("-R", "--REFFLAT", required=True)

    p = sub.add_parser("bam2fastq", help="BAM -> fastq (optionally from "
                       "US/QS tags)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--SEQTAG", default=None)
    p.add_argument("--QUALTAG", default=None)

    p = sub.add_parser("filterbam", help="drop mapqv0 / tag-missing records")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--TAG", default=None, help="required tag")

    p = sub.add_parser("snpmatrix", help="per-cell SNV matrix (reference "
                       "SNPMatrix)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-S", "--SNP", required=True,
                   help="csv: chrom,pos[|pos2..],strand,name")
    p.add_argument("-C", "--CSV", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-P", "--PREFIX", default="snp")
    p.add_argument("--MINRN", type=int, default=0)
    p.add_argument("--MINQV", type=int, default=0)

    p = sub.add_parser("fusiondetector", help="2-gene molecules -> fusion "
                       "matrix (reference FusionDetector)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-C", "--CSV", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-P", "--PREFIX", default="fus")

    p = sub.add_parser("exportclippedreads", help="export clipped reads as "
                       "fastq (reference ExportClippedReads)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--MINCLIP", type=int, default=150)

    p = sub.add_parser("addbamreadtags",
                       help="read name read_GE_BC_U8 -> tags")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("sortbam", help="coordinate-sort a BAM")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("selectvalidcellbarcode",
                       help="filter BarcodesAssigned.tsv -> barcodes.csv")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--MINUMI", type=int, default=1)
    p.add_argument("--ED0ED1RATIO", type=float, default=1.0)

    for nm, hlp in (("filterbammf", "cell-list filter + CB/UB 10x retag"),
                    ("cleanusuq", "blank US/UQ tags (kept, empty value)"),
                    ("exportumifoundrecords", "keep BC+U8 records"),
                    ("filtermoleculebam", "filter molecules on RN/isoform")):
        p = sub.add_parser(nm, help=hlp)
        p.add_argument("-I", "--INPUT", required=True)
        p.add_argument("-O", "--OUTPUT", required=True)
        if nm == "filtermoleculebam":
            p.add_argument("--MINRN", type=int, default=1)
            p.add_argument("--ISOONLY", action="store_true")
        if nm == "filterbammf":
            p.add_argument("-C", "--CSV", required=True,
                           help="valid cell barcodes csv")

    p = sub.add_parser("addlabel2barcode", help="BC -> BC-LABEL")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("-L", "--LABEL", required=True)

    p = sub.add_parser("splitbam",
                       help="yes.bam/no.bam by read-name-prefix id list")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True, help="output DIRECTORY")
    p.add_argument("--IDS", required=True)

    p = sub.add_parser("splitbampercell", help="one BAM per cell")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-C", "--CSV", required=True)

    p = sub.add_parser("splitbampercluster", help="one BAM per cluster "
                       "(csv: barcode,cluster)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-C", "--CSV", required=True)

    p = sub.add_parser("splitbamperstage", help="one BAM per stage "
                       "(csv: sample,stage; routed by BC '-sample' suffix)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-C", "--CSV", required=True)
    p.add_argument("--CELLTAG", default="BC")

    p = sub.add_parser("crisprstats", help="largest-deletion histogram "
                       "over a genomic window (CRISPR editing QC)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("--HISTO", required=True)
    p.add_argument("--DETAIL", required=True)
    p.add_argument("--MINSIZE", type=int, default=10)
    p.add_argument("--COORD", default="21:17608000-17610000")

    p = sub.add_parser("parsefastq", help="export cDNA slice of passed "
                       "fastq reads using read-name metadata")
    p.add_argument("-I", "--FASTQDIR", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("--offset", type=int, default=28)
    p.add_argument("--min_cdna", type=int, default=20)

    p = sub.add_parser("parsetr", help="Parse Biosciences polyT vs random"
                       "-hexamer priming stats per gene/cell")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-C", "--CSV", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("--CELLTAG_BC", default="CR")
    p.add_argument("--CELLTAG", default="CB")
    p.add_argument("--UMITAG", default="pN")
    p.add_argument("--GENETAG", default="GN")
    p.add_argument("--XF", default="XF")
    p.add_argument("--SAMPLE", default="pS")

    p = sub.add_parser("precompile", help="build every CUDA kernel and "
                       "launch each once at a pipeline run's shapes")
    p.add_argument("--nbc", type=int, default=8192,
                   help="used-barcode list size to warm the sweep for")
    p.add_argument("--full", action="store_true",
                   help="also warm tail chunks + the larger band buckets")
    _device_arg(p, "cuda: build and launch the kernels; cpu: nothing to "
                   "build")

    p = sub.add_parser("moleculecounter", help="count distinct (BC,U8)")
    p.add_argument("-I", "--INPUT", required=True)

    p = sub.add_parser("exportmetrics", help="per-molecule + per-cell "
                       "metrics from a tagged BAM (ExportMetrics)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-C", "--CSV", required=True, help="cell barcodes csv")
    p.add_argument("--OM", required=True, help="molecule metrics output")
    p.add_argument("--OC", required=True, help="cell metrics output")
    p.add_argument("--CELLTAG", default="CB")
    p.add_argument("--UMITAG", default="UB")
    p.add_argument("--GENETAG", default="GN")

    p = sub.add_parser("exportmoleculereads",
                       help="fastq of listed molecules' reads")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-C", "--CSV", required=True, help="csv: barcode,umi")
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("addreadstomolecules",
                       help="merge targeted reads into standard molecules")
    p.add_argument("-I", "--INPUT", required=True, help="standard BAM")
    p.add_argument("-T", "--TARGETED", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("haplotypecaller",
                       help="per-isoform evidence fasta export")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)

    p = sub.add_parser("mergescanstats", help="merge scanner stats / "
                       "BarcodesAssigned tables across runs (statmerger)")
    p.add_argument("-I", "--INPUTS", required=True,
                   help="comma-separated stats.json or tsv files")
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("parseillumina", help="serialize an Illumina 10x BAM "
                       "into a guided-mode table (reference parseillumina/"
                       "BamSerializer)")
    p.add_argument("-I", "--INPUT", required=True, help="Illumina BAM "
                   "(CB/UB/GN tags)")
    p.add_argument("-O", "--OUTPUT", required=True, help="table json.gz")

    p = sub.add_parser("annotatemodel",
                       help="re-validate a CollapseModel txt")
    p.add_argument("-M", "--MODEL", required=True, help="CollapseModel txt")
    p.add_argument("-I", "--INPUT", default=None, help="short-read BAM")
    p.add_argument("--CAGE", default=None)
    p.add_argument("--POLYA", default=None)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("junctionvalidator",
                       help="classify a junction table vs refFlat")
    p.add_argument("-I", "--INPUT", required=True, help="junction tsv")
    p.add_argument("-R", "--REFFLAT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--SHORT", default=None)

    p = sub.add_parser("snpmatrix3pend",
                       help="SNV distance to isoform 3' end")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-S", "--SNP", required=True)
    p.add_argument("-R", "--REFFLAT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("addisobam",
                       help="per-record STRICT isoform re-assignment -> IT")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-R", "--REFFLAT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--DELTA", type=int, default=2)
    p.add_argument("--MAXCLIP", type=int, default=150)

    p = sub.add_parser("isobam",
                       help="molinfos-driven record filter + IG/IT tags")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("--MOLINFOS", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--NOUNDEF", action="store_true",
                   help="drop molecules with transcriptId=undef")

    p = sub.add_parser("junctionannotate",
                       help="GT-AG donor/acceptor annotation from genome")
    p.add_argument("-R", "--REFFLAT", required=True)
    p.add_argument("-G", "--GENOME", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("samview", help="SAM <-> BAM conversion "
                       "(samtools-view role)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("run", help="full pipeline orchestrator "
                       "(reference sicelore-nf/quickrun)")
    p.add_argument("-d", "--fastqDir", required=True)
    p.add_argument("-r", "--reference", required=True, help="genome fasta")
    p.add_argument("-a", "--refflat", required=True)
    p.add_argument("-o", "--outDir", required=True)
    p.add_argument("--whitelist", default=None)
    p.add_argument("-g", "--cellRangerBCs", default=None)
    p.add_argument("-b", "--bcEditDistance", type=int, default=1)
    p.add_argument("--juncBed", default=None)
    p.add_argument("--minimap2", default=None)
    p.add_argument("-t", "--threads", type=int, default=4)
    p.add_argument("--consensus", action="store_true")
    p.add_argument("--collapse", action="store_true")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--nativeAlign", action="store_true",
                   help="use the framework's own spliced aligner instead "
                        "of the minimap2 subprocess (align/ package)")
    _device_arg(p, "cuda: scanfastq, the aligner's gap extension and "
                   "assignumis on the card; cpu: their plain torch bodies")

    p = sub.add_parser("histo", help="histogram programs (reference Histo*)")
    p.add_argument("KIND", choices=["readlength", "fastqmeanqv", "clipping",
                                    "moleculelength", "percentidentity",
                                    "umidepth"])
    p.add_argument("-I", "--INPUT", required=True, help="BAM or fastq")
    p.add_argument("-O", "--OUTPUT", required=True, help="output prefix")

    p = sub.add_parser("saturationcurve", help="sequencing saturation "
                       "(reference SaturationCurve)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True, help="output prefix")

    p = sub.add_parser("readbamstats", help="BAM counter dump")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", default=None, help="json output")

    p = sub.add_parser("exporteditdistances",
                       help="per-record BC/UMI ED tsv (reference EditDistance)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)

    p = sub.add_parser("bulk2fakesinglecell", help="constant-BC synthetic "
                       "reads (reference Bulk2FakeSingleCell)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    p.add_argument("--BARCODE", default="AAAACCCCGGGGTTTT")

    p = sub.add_parser("collapsemodel", help="novel-isoform discovery/"
                       "classification/validation (reference CollapseModel)")
    p.add_argument("-I", "--INPUT", required=True, help="isobam (IG/IT tags)")
    p.add_argument("-R", "--REFFLAT", required=True)
    p.add_argument("-C", "--CSV", required=True)
    p.add_argument("-O", "--OUTDIR", required=True)
    p.add_argument("-P", "--PREFIX", default="CollapseModel")
    p.add_argument("--DELTA", type=int, default=2)
    p.add_argument("--MINEVIDENCE", type=int, default=2)
    p.add_argument("--RNMIN", type=int, default=1)
    p.add_argument("--CAGE", default=None, help="CAGE peaks BED")
    p.add_argument("--POLYA", default=None, help="polyA sites BED")
    p.add_argument("--SHORT", default=None, help="short-read BAM")
    p.add_argument("--cageCo", type=int, default=50)
    p.add_argument("--polyaCo", type=int, default=50)
    p.add_argument("--juncCo", type=int, default=1)


def cmd_simple(args) -> int:
    from sicelore_tpu_torch.pipeline import programs, snp_fusion

    if args.cmd == "tagbamwithread":
        r = programs.tag_bam_with_read(args.INPUT, args.OUTPUT, args.FASTQ)
    elif args.cmd == "deduplicatemolecule":
        r = programs.deduplicate_molecule(args.INPUT, args.OUTPUT)
    elif args.cmd == "addbammoleculetags":
        r = programs.add_bam_molecule_tags(args.INPUT, args.OUTPUT)
    elif args.cmd == "addgenenametag":
        r = programs.add_gene_name_tag(args.INPUT, args.OUTPUT, args.REFFLAT)
    elif args.cmd == "bam2fastq":
        r = programs.bam2fastq(args.INPUT, args.OUTPUT, args.SEQTAG,
                               args.QUALTAG)
    elif args.cmd == "filterbam":
        r = programs.filter_bam(args.INPUT, args.OUTPUT,
                                tag_required=args.TAG)
    elif args.cmd == "snpmatrix":
        r = snp_fusion.snp_matrix(args.INPUT, args.SNP, args.CSV,
                                  args.OUTDIR, args.PREFIX, args.MINRN,
                                  args.MINQV)
    elif args.cmd == "fusiondetector":
        r = snp_fusion.fusion_detector(args.INPUT, args.CSV, args.OUTDIR,
                                       args.PREFIX)
    elif args.cmd == "exportclippedreads":
        r = programs.export_clipped_reads(args.INPUT, args.OUTPUT,
                                          min_clip=args.MINCLIP)
    elif args.cmd == "addbamreadtags":
        r = programs.add_bam_read_tags(args.INPUT, args.OUTPUT)
    elif args.cmd == "sortbam":
        from sicelore_tpu_torch.io.bam import sort_bam
        sort_bam(args.INPUT, args.OUTPUT)
        r = {"sorted": True}
    elif args.cmd == "selectvalidcellbarcode":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.select_valid_cell_barcode(args.INPUT, args.OUTPUT,
                                                args.MINUMI,
                                                args.ED0ED1RATIO)
    elif args.cmd == "filterbammf":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.filter_bam_mf(args.INPUT, args.OUTPUT, args.CSV)
    elif args.cmd == "filtermoleculebam":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.filter_molecule_bam(args.INPUT, args.OUTPUT,
                                          min_rn=args.MINRN,
                                          require_isoform=args.ISOONLY)
    elif args.cmd == "cleanusuq":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.clean_usuq(args.INPUT, args.OUTPUT)
    elif args.cmd == "exportumifoundrecords":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.export_umifound_records(args.INPUT, args.OUTPUT)
    elif args.cmd == "addlabel2barcode":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.add_label_to_barcode(args.INPUT, args.OUTPUT,
                                           args.LABEL)
    elif args.cmd == "splitbam":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.split_bam(args.INPUT, args.OUTPUT, args.IDS)
    elif args.cmd == "splitbampercell":
        from sicelore_tpu_torch.pipeline import programs
        r = programs.split_bam_per_cell(args.INPUT, args.OUTDIR, args.CSV)
    elif args.cmd == "splitbampercluster":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.split_bam_per_cluster(args.INPUT, args.OUTDIR,
                                            args.CSV)
    elif args.cmd == "splitbamperstage":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.split_bam_per_stage(args.INPUT, args.OUTDIR,
                                          args.CSV, args.CELLTAG)
    elif args.cmd == "crisprstats":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.crispr_stats(args.INPUT, args.HISTO, args.DETAIL,
                                   args.MINSIZE, args.COORD)
    elif args.cmd == "parsefastq":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.parse_fastq_cdna(args.FASTQDIR, args.OUTDIR,
                                       args.offset, args.min_cdna)
    elif args.cmd == "parsetr":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.parse_tr_stats(args.INPUT, args.CSV, args.OUTDIR,
                                     args.CELLTAG_BC, args.CELLTAG,
                                     args.UMITAG, args.GENETAG, args.XF,
                                     args.SAMPLE)
    elif args.cmd == "precompile":
        from sicelore_tpu_torch.utils import precompile
        r = precompile.warm(n_bc=args.nbc, full=args.full,
                            device=args.device)
    elif args.cmd == "moleculecounter":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.molecule_counter(args.INPUT)
    elif args.cmd == "exportmetrics":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.export_metrics(args.INPUT, args.CSV, args.OM, args.OC,
                                     args.CELLTAG, args.UMITAG, args.GENETAG)
    elif args.cmd == "exportmoleculereads":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.export_molecule_reads(args.INPUT, args.CSV,
                                            args.OUTPUT)
    elif args.cmd == "addreadstomolecules":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.add_reads_to_molecules(args.INPUT, args.TARGETED,
                                             args.OUTPUT)
    elif args.cmd == "haplotypecaller":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.haplotype_caller(args.INPUT, args.OUTDIR)
    elif args.cmd == "mergescanstats":
        from sicelore_tpu_torch.pipeline import mergestats
        files = args.INPUTS.split(",")
        if files[0].endswith(".json"):
            r = mergestats.merge_scanner_stats(files, args.OUTPUT)
            r = {"merged": len(files)}
        else:
            r = mergestats.merge_barcodes_assigned(files, args.OUTPUT)
    elif args.cmd == "parseillumina":
        from sicelore_tpu_torch.pipeline.illumina import parse_illumina_bam
        r = parse_illumina_bam(args.INPUT, args.OUTPUT)
    elif args.cmd == "annotatemodel":
        from sicelore_tpu_torch.pipeline import annotate
        r = annotate.annotate_model(args.MODEL, args.INPUT, args.CAGE,
                                    args.POLYA, args.OUTPUT)
    elif args.cmd == "junctionvalidator":
        from sicelore_tpu_torch.pipeline import annotate
        r = annotate.junction_validator(args.INPUT, args.REFFLAT,
                                        args.OUTPUT, short_bam=args.SHORT)
    elif args.cmd == "snpmatrix3pend":
        from sicelore_tpu_torch.pipeline import annotate
        r = annotate.snp_matrix_3pend(args.INPUT, args.SNP, args.REFFLAT,
                                      args.OUTPUT)
    elif args.cmd == "addisobam":
        from sicelore_tpu_torch.pipeline import annotate
        r = annotate.add_isobam(args.INPUT, args.REFFLAT, args.OUTPUT,
                                delta=args.DELTA, max_clip=args.MAXCLIP)
    elif args.cmd == "isobam":
        from sicelore_tpu_torch.pipeline import annotate
        r = annotate.isobam(args.INPUT, args.MOLINFOS, args.OUTPUT,
                            undef=not args.NOUNDEF)
    elif args.cmd == "junctionannotate":
        from sicelore_tpu_torch.pipeline import programs2
        r = programs2.junction_annotate(args.REFFLAT, args.GENOME,
                                        args.OUTPUT)
    elif args.cmd == "samview":
        from sicelore_tpu_torch.io import sam as _sam
        if str(args.INPUT).endswith(".bam"):
            n = _sam.bam_to_sam(args.INPUT, args.OUTPUT)
        else:
            n = _sam.sam_to_bam(args.INPUT, args.OUTPUT)
        r = {"records": n}
    elif args.cmd == "run":
        from sicelore_tpu_torch.pipeline.workflow import run_pipeline
        r = run_pipeline(
            args.fastqDir, args.reference, args.refflat, args.outDir,
            whitelist=args.whitelist, cells_csv=args.cellRangerBCs,
            bc_ed=args.bcEditDistance, junc_bed=args.juncBed,
            minimap2_path=args.minimap2, threads=args.threads,
            with_consensus=args.consensus, with_collapse=args.collapse,
            resume=not args.no_resume, native_align=args.nativeAlign,
            device=args.device)
        r = {k: "ok" for k in r}
    elif args.cmd == "histo":
        from sicelore_tpu_torch.pipeline import qc
        r = qc.histo(args.KIND, args.INPUT, args.OUTPUT)
    elif args.cmd == "saturationcurve":
        from sicelore_tpu_torch.pipeline import qc
        r = qc.saturation_curve(args.INPUT, args.OUTPUT)
    elif args.cmd == "readbamstats":
        from sicelore_tpu_torch.pipeline import qc
        r = qc.read_bam_stats(args.INPUT, args.OUTPUT)
    elif args.cmd == "exporteditdistances":
        from sicelore_tpu_torch.pipeline import qc
        r = qc.export_edit_distances(args.INPUT, args.OUTPUT)
    elif args.cmd == "bulk2fakesinglecell":
        from sicelore_tpu_torch.pipeline import qc
        r = qc.bulk2fake_single_cell(args.INPUT, args.OUTPUT,
                                     barcode=args.BARCODE)
    elif args.cmd == "collapsemodel":
        from sicelore_tpu_torch.pipeline.collapsemodel import collapse_model
        r = collapse_model(args.INPUT, args.REFFLAT, args.CSV, args.OUTDIR,
                           prefix=args.PREFIX, delta=args.DELTA,
                           min_evidence=args.MINEVIDENCE, rn_min=args.RNMIN,
                           cage_bed=args.CAGE, polya_bed=args.POLYA,
                           short_bam=args.SHORT, cage_cutoff=args.cageCo,
                           polya_cutoff=args.polyaCo,
                           junc_cutoff=args.juncCo)
        r = {k: v for k, v in r.items()
             if not str(k).endswith(("_evidences", "_evidences_valid"))
             and v}
    else:
        return 2
    print(f"{args.cmd} done: {r}")
    return 0


def cmd_env(args) -> int:
    import torch

    from sicelore_tpu_torch.io import native
    from sicelore_tpu_torch.ops import _build

    print(f"python {sys.version.split()[0]}")
    print(f"torch {torch.__version__} (CUDA build {torch.version.cuda})")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            print(f"gpu {i}: {torch.cuda.get_device_name(i)}")
    else:
        print("gpu: none (torch.cuda.is_available() is False)")
    print(f"nvcc: {_build.find_nvcc() or 'absent'}")
    print(f"triton: {'present' if importlib.util.find_spec('triton') else 'absent'}")
    print(f"hostenc: {'loaded' if native.get_hostenc() is not None else 'absent (numpy fallbacks)'}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sicelore_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_scanfastq(sub)
    _add_computeconsensus(sub)
    _add_align(sub)
    _add_assignumis(sub)
    _add_isoformmatrix(sub)
    _add_simple_programs(sub)
    sub.add_parser("env", help="report the torch/CUDA/kernel toolchain")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"scanfastq": cmd_scanfastq,
            "computeconsensus": cmd_computeconsensus,
            "align": cmd_align, "assignumis": cmd_assignumis,
            "isoformmatrix": cmd_isoformmatrix,
            "env": cmd_env}.get(args.cmd, cmd_simple)(args)


if __name__ == "__main__":
    sys.exit(main())
