"""The port imports without jax, reports its toolchain, and refuses a CUDA
device it does not have."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO))


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sicelore_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'sicelore_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print(len(mods))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO, env=ENV)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 10


def test_env_command():
    r = subprocess.run([sys.executable, "-m", "sicelore_tpu_torch", "env"],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO, env=ENV)
    assert r.returncode == 0, r.stderr
    for key in ("torch ", "nvcc:", "triton:", "hostenc:"):
        assert key in r.stdout


def test_cuda_request_without_gpu_raises():
    from sicelore_tpu_torch.device import resolve
    from sicelore_tpu_torch.models.readscan import ReadScanModel

    assert resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA request is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ReadScanModel(device="cuda")
