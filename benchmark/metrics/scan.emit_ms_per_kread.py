"""Host ms in the pass-2 emit (assignment rows to records, the fastq
writers) per 1,000 input reads."""
from benchmark.metrics._common import per_k

SPANS = ("sicelore_tpu_torch.pipeline.scanfastq:ScanFastqPipeline.pass2_emit",)


def read(run):
    return per_k(run, SPANS)
