"""The readings that the limits of `correct` are set from, at a cell's own
size, on the card:

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

For each seed, in one process: the cell's inputs, one call of the program
as the configuration states it, and one call of the control (the program
with a guarantee of the configuration broken: for Step 1 the barcode edit
distance one below the dynamic table's, for Step 4b the quality cap MAXPS
one lower), each judged by the plain reference as a run's calls are.
Prints one JSON line a seed with both sets of numbers and the limits. The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    from benchmark.harness import cell
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = cell.with_pending(cell.load_json(ROOT / "BENCHMARK.json"),
                              args.workload)
    _, config, traffic, drv = cell.load_cell(bench, args.workload)
    for seed in args.seeds:
        tmp = Path(tempfile.mkdtemp(prefix="bench-control-"))
        try:
            c = cell.Cell(args.workload, config, traffic["mix"], seed, tmp,
                          args.device)
            state = drv.setup(c)
            t = time.time()
            drv.call(state, tmp / "program")
            call_s = time.time() - t
            t = time.time()
            program = drv.judge(state, tmp / "program")
            judge_s = time.time() - t
            drv.control_call(state, tmp / "control")
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "call_s": call_s, "judge_s": judge_s,
                              "program": program,
                              "control": drv.judge(state, tmp / "control"),
                              "limits": traffic["limits"]}), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
