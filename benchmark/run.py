"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints the split of the set-up and each
number compared beside its limit on standard error, and one JSON line
(correct, attempted, failed, metrics, device, with --trace 1 breakdown,
then checks) as the last line of standard output. Needs as many CUDA cards
as the cell asks for; without them it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    from benchmark.harness import cell
    t_start = cell.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = cell.with_pending(cell.load_json(ROOT / "BENCHMARK.json"),
                              args.workload)
    chips = cell.find_workload(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = cell.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", t_start, bench)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    # caches at fixed paths inside the checkout (the port builds its kernels
    # into build/torch_kernels/ itself)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    sys.exit(main())
