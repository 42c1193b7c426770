"""Host ms in the read encoding's host side (the chunk's bytes joined, staged
in pinned memory, uploaded) per 1,000 input reads."""
from benchmark.metrics._common import per_k

SPANS = ("sicelore_tpu_torch.ops.encode_cuda:join",
         "sicelore_tpu_torch.ops.encode_cuda:Staged.__init__",
         "sicelore_tpu_torch.ops.encode_cuda:Staged.upload")


def read(run):
    return per_k(run, SPANS)
