"""Host ms the batched engine waits for the card (the program's
`consensus.wait` spans: the alignment's end, then the assembly's
downloads) per 1,000 molecules."""
from benchmark.metrics import _program

_program.arm()


def read(run):
    return _program.span_ms_per_k(run, "consensus.wait")
