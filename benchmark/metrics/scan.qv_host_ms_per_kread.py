"""Host ms in the read and barcode QVs worked out on the host per 1,000
input reads."""
from benchmark.metrics._common import per_k

SPANS = ("sicelore_tpu_torch.models.readscan:compute_qvs_np",
         "sicelore_tpu_torch.ops.edgescan:compute_qvs2_np")


def read(run):
    return per_k(run, SPANS)
