"""Spliced long-read aligner (the minimap2 role) on PyTorch and CUDA.

The reference pipeline shells out to `minimap2 -ax splice -uf` for every
mapping step (sicelore-nf main.nf:64,200). This package replaces it for
locus/chromosome-scale references with the framework's own machinery:

  * index:  minimizer index (native sketch, numpy fallback; sorted-array
            probes)
  * chain:  minimap2-style anchor chaining with intron-tolerant gap costs
  * extend: between-anchor gap alignment batched on the device through
            the consensus engine's band kernel (ops/poa_cuda.band_align,
            csrc/bandalign.cu: walk records decode into CIGAR runs instead
            of votes), GT-AG junction snapping
  * aligner: fastq -> sorted+indexed BAM with the tags downstream stages
            consume (de divergence, NM/AS/MD/tp)
"""
from sicelore_tpu_torch.align.aligner import NativeAligner  # noqa: F401
