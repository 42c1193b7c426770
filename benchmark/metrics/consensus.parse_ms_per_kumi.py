"""Host ms in the BAM parse and the molecule grouping per 1,000 molecules."""
from benchmark.metrics._common import per_k

SPANS = ("sicelore_tpu_torch.pipeline.consensus:LongreadParser",
         "sicelore_tpu_torch.pipeline.consensus:MoleculeDataset")


def read(run):
    return per_k(run, SPANS)
