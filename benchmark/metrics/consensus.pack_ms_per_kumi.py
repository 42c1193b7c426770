"""Host ms in packing the batched engine's buckets and sub-batches and
copying them to the card (the program's `consensus.pack` and
`consensus.upload` spans) per 1,000 molecules."""
from benchmark.metrics import _program

_program.arm()


def read(run):
    pack = _program.span_ms_per_k(run, "consensus.pack")
    upload = _program.span_ms_per_k(run, "consensus.upload")
    return None if pack is None else pack + upload
