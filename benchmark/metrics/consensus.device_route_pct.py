"""Percent of the molecules of three or more reads whose consensus the
device route made (the program's `consensus.molecules` counter: route
`device` over every route but `short`, first pass)."""
from benchmark.metrics import _program

_program.arm()


def read(run):
    snap = _program.snapshot(run)
    if snap is None:
        return None
    by = {}
    for c in snap["counters"]:
        if c["name"] == "consensus.molecules" and "refine" not in c["attrs"]:
            by[c["attrs"]["route"]] = by.get(c["attrs"]["route"], 0) \
                + c["value"]
    deep = sum(v for r, v in by.items() if r != "short")
    return 100.0 * by.get("device", 0) / deep if deep else None
