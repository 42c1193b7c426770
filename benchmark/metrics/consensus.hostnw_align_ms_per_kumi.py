"""Host ms in the long route's pairwise alignment per 1,000 molecules: the
program's `hostnw.align` spans (`ops/hostnw_cuda.align_pairs` for the
molecules of three or more reads that the host engine answers: the pair
table, the upload, every `host_nw` launch and every download). None where
the program has no such span."""
from benchmark.metrics import _program

_program.arm()


def read(run):
    snap = _program.snapshot(run)
    if snap is None or not any(s["name"] == "hostnw.align"
                               for s in snap["spans"]):
        return None
    return _program.span_ms_per_k(run, "hostnw.align")
