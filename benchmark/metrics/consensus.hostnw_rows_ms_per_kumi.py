"""Host ms in building the long route's center-star rows from the card's
moves per 1,000 molecules: the program's `hostnw.rows` spans
(`ops/hostnw_cuda.CenterStar`, after `align_pairs`). None where the program
has no such span."""
from benchmark.metrics import _program

_program.arm()


def read(run):
    snap = _program.snapshot(run)
    if snap is None or not any(s["name"] == "hostnw.rows"
                               for s in snap["spans"]):
        return None
    return _program.span_ms_per_k(run, "hostnw.rows")
