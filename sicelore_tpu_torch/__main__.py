"""sicelore_tpu_torch CLI.

  python -m sicelore_tpu_torch scanfastq -d <fastq dir|file,...> -o <out>
         --whitelist <10x list> [--device cuda|cpu] ...
  python -m sicelore_tpu_torch computeconsensus -I <tagged BAM> -O <fastq>
         [--MAXREADS 20 --MINPS 3 --MAXPS 20 --refine --host-engine]
         [--device cuda|cpu]
  python -m sicelore_tpu_torch align -r <genome fasta> -d <fastq|dir>
         -O <sorted BAM> [--juncBed <bed>] [--keep-unmapped] [--device ...]
  python -m sicelore_tpu_torch assignumis -i <sorted BAM> -o <tagged BAM>
         [-a <refFlat>] [-f] [--illumina <table>] [--device cuda|cpu]
  python -m sicelore_tpu_torch parseillumina -I <Illumina BAM> -O <table>
  python -m sicelore_tpu_torch samview -I <BAM|SAM> -O <SAM|BAM>
  python -m sicelore_tpu_torch env

Every command takes the flags of the same command of `python -m
sicelore_tpu` plus `--device` (default cuda: the hand-written kernels;
cpu runs the plain torch bodies; cuda without a GPU raises). `align` runs
its gap extension through the band kernel, `assignumis` the UMI distance
matrices of large groups on the device; `parseillumina` and `samview` do
no device work and only check the choice. `env` reports the torch/CUDA
build, the GPU, and whether nvcc, triton and the native host codecs are
present.
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
    return p


def cmd_computeconsensus(args) -> int:
    from sicelore_tpu_torch.pipeline.consensus import compute_consensus

    engine = "host"
    if not args.host_engine:
        # a device or kernel that fails raises: the host engine never
        # stands in unasked
        from sicelore_tpu_torch.ops.poa_cuda import BatchedConsensusEngine
        engine = BatchedConsensusEngine(maxreads=args.MAXREADS,
                                        device=args.device)
        if args.refine:
            engine = functools.partial(engine, refine=True)
    stats = compute_consensus(args.INPUT, args.OUTPUT,
                              maxreads=args.MAXREADS, minps=args.MINPS,
                              maxps=args.MAXPS, engine=engine,
                              log_json=str(args.OUTPUT) + ".log")
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


def _add_host_commands(sub):
    host = "this command does no device work; the choice is only checked"
    p = sub.add_parser("parseillumina", help="serialize an Illumina 10x BAM "
                       "into a guided-mode table (reference parseillumina/"
                       "BamSerializer)")
    p.add_argument("-I", "--INPUT", required=True, help="Illumina BAM "
                   "(CB/UB/GN tags)")
    p.add_argument("-O", "--OUTPUT", required=True, help="table json.gz")
    _device_arg(p, host)
    p = sub.add_parser("samview", help="SAM <-> BAM conversion "
                       "(samtools-view role)")
    p.add_argument("-I", "--INPUT", required=True)
    p.add_argument("-O", "--OUTPUT", required=True)
    _device_arg(p, host)


def cmd_parseillumina(args) -> int:
    from sicelore_tpu_torch.pipeline.illumina import parse_illumina_bam

    r = parse_illumina_bam(args.INPUT, args.OUTPUT)
    print(f"parseillumina done: {r}")
    return 0


def cmd_samview(args) -> int:
    from sicelore_tpu_torch.io import sam

    if str(args.INPUT).endswith(".bam"):
        n = sam.bam_to_sam(args.INPUT, args.OUTPUT)
    else:
        n = sam.sam_to_bam(args.INPUT, args.OUTPUT)
    print(f"samview done: {{'records': {n}}}")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sicelore_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_scanfastq(sub)
    _add_computeconsensus(sub)
    _add_align(sub)
    _add_assignumis(sub)
    _add_host_commands(sub)
    sub.add_parser("env", help="report the torch/CUDA/kernel toolchain")
    args = ap.parse_args(argv)
    return {"scanfastq": cmd_scanfastq,
            "computeconsensus": cmd_computeconsensus,
            "align": cmd_align, "assignumis": cmd_assignumis,
            "parseillumina": cmd_parseillumina, "samview": cmd_samview,
            "env": cmd_env}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
