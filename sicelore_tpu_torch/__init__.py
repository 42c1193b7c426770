"""sicelore_tpu_torch — PyTorch/CUDA port of the sicelore_tpu engine.

The JAX package `sicelore_tpu` stays the reference: every module here is
held to its counterpart there on the same inputs (tests/test_torch_*.py).
This package imports `torch`, never `jax`, and nothing of `sicelore_tpu`:
it keeps its own copy of every jax-free module it needs (codecs, BAM, DNA
utils, config, read names, molecules, the host consensus engine, the HTML
report).

Each Pallas TPU kernel on a ported path has a hand-written CUDA C++ kernel
for Hopper (`csrc/*.cu`, built with nvcc at first use by `ops._build`)
beside a plain PyTorch version of the same function. A wrapper runs the
plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.

Subpackages mirror `sicelore_tpu`:
  ops       kernels + plain torch bodies (editdist, scan, edgescan, bcsearch,
            tilescan, poa_cuda) and the host consensus engine (poa)
  models    the read-scan model (pass bodies + async dispatch)
  pipeline  scanfastq (Step 1), consensus (Step 4b)
  io, core, utils, report   host-side codecs, records and fixtures
"""

__version__ = "0.1.0"
