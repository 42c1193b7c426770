"""Host ms of the interpreter's garbage collector per 1,000 molecules: the
program's counter `gc.ns`, summed over every generation, over the whole
traced window, so a collection that falls between calls or after a
call's end counts too. None where the program has no tracer."""
from benchmark.metrics import _program

_program.arm()


def read(run):
    snap = _program.snapshot(run)
    if snap is None or not run.units:
        return None
    ns = sum(c["value"] for c in snap["counters"] if c["name"] == "gc.ns")
    return ns / 1e6 * 1000 / run.units
