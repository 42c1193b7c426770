"""sicelore_tpu_torch CLI.

  python -m sicelore_tpu_torch scanfastq -d <fastq dir|file,...> -o <out>
         --whitelist <10x list> [--device cuda|cpu] ...
  python -m sicelore_tpu_torch computeconsensus -I <tagged BAM> -O <fastq>
         [--MAXREADS 20 --MINPS 3 --MAXPS 20 --refine --host-engine]
         [--device cuda|cpu]
  python -m sicelore_tpu_torch env

`scanfastq` and `computeconsensus` take the flags of the same commands of
`python -m sicelore_tpu` plus `--device` (default cuda: the hand-written
kernels; cpu runs the plain torch bodies). `env` reports the torch/CUDA
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
    sub.add_parser("env", help="report the torch/CUDA/kernel toolchain")
    args = ap.parse_args(argv)
    return {"scanfastq": cmd_scanfastq,
            "computeconsensus": cmd_computeconsensus,
            "env": cmd_env}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
