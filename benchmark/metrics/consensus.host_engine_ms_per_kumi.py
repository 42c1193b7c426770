"""Host ms in the host consensus engine (ops/poa.py: one- and two-read
molecules, molecules with an N, long centers) per 1,000 molecules."""
from benchmark.metrics._common import per_k

SPANS = ("sicelore_tpu_torch.ops.poa:consensus_reads",)


def read(run):
    return per_k(run, SPANS)
