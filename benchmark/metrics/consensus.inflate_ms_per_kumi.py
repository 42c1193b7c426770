"""Host ms inflating the BAM's BGZF blocks (the program's `bam.inflate`
spans, the native codec's or zlib's) per 1,000 molecules."""
from benchmark.metrics import _program

_program.arm()


def read(run):
    return _program.span_ms_per_k(run, "bam.inflate")
