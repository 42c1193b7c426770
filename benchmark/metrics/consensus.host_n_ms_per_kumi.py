"""Host ms in the host engine on the molecules of three or more reads that
hold a non-ACGT byte (the program's `consensus.host` spans of route `n`)
per 1,000 molecules."""
from benchmark.metrics import _program

_program.arm()


def read(run):
    return _program.span_ms_per_k(run, "consensus.host", ("n",))
