"""Host ms in the batched engine's call less the host engine inside it
(bucketing, packing, the device route, decoding) per 1,000 molecules."""
from benchmark.metrics._common import per_k

ENGINE = "sicelore_tpu_torch.ops.poa_cuda:BatchedConsensusEngine.__call__"
HOST = "sicelore_tpu_torch.ops.poa:consensus_reads"
SPANS = (ENGINE, HOST)


def read(run):
    if not run.units:
        return None
    return (per_k(run, (ENGINE,)) or 0.0) - (per_k(run, (HOST,)) or 0.0)
