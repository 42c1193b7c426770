"""The port imports without jax, reports its toolchain, and refuses a CUDA
device it does not have."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO))


_NO_FOREIGN = (
    "bad = sorted(k for k in sys.modules if k == 'jax' or "
    "k.startswith('jax.') or k == 'sicelore_tpu' or "
    "k.startswith('sicelore_tpu.'))\n"
    "assert not bad, bad\n")


NEW_MODULES = ("io.bed", "core.collapse", "pipeline.isoform",
               "pipeline.collapsemodel", "pipeline.snp_fusion",
               "pipeline.annotate", "pipeline.programs2", "pipeline.qc",
               "pipeline.mergestats", "pipeline.workflow",
               "utils.precompile", "__main__")


def test_port_never_imports_jax():
    """Every module of the port (the workflow, the warm-up and the copies of
    the host programs among them), imported in a fresh process, leaves
    neither jax nor any module of the JAX package in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sicelore_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'sicelore_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        + _NO_FOREIGN +
        "print(' '.join(mods))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO, env=ENV)
    assert r.returncode == 0, r.stderr
    mods = set(r.stdout.split())
    assert len(mods) >= 57
    assert {f"sicelore_tpu_torch.{m}" for m in NEW_MODULES} <= mods


def test_chip_smoke_never_imports_jax_package():
    """chip_smoke.py imports inside its functions, so besides importing it
    as a module (calling nothing) its source is searched."""
    code = ("import importlib, sys\n"
            "importlib.import_module('chip_smoke')\n" + _NO_FOREIGN)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO, env=ENV)
    assert r.returncode == 0, r.stderr
    src = (REPO / "chip_smoke.py").read_text()
    hits = re.findall(
        r"sicelore_tpu\.|from sicelore_tpu |import sicelore_tpu\b|"
        r"\bimport jax\b|\bfrom jax\b", src)
    assert not hits, hits


def test_port_sources_name_no_jax_package_module():
    """No source file of the port spells an import of the JAX package."""
    for f in sorted((REPO / "sicelore_tpu_torch").rglob("*.py")):
        hits = re.findall(
            r"sicelore_tpu\.|from sicelore_tpu |import sicelore_tpu\b",
            f.read_text())
        assert not hits, (f.name, hits)


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


def test_port_has_no_statement_after_a_return():
    """No block of the port's Python (or of chip_smoke.py) goes on after a
    return, raise, break or continue: such lines never run (a wrapper once
    carried a second, unreachable launch after its return)."""
    import ast
    ends = (ast.Return, ast.Raise, ast.Break, ast.Continue)
    bad = []
    files = sorted((REPO / "sicelore_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            for field in ("body", "orelse", "finalbody"):
                block = getattr(node, field, None)
                if not isinstance(block, list):
                    continue
                for a, b in zip(block, block[1:]):
                    if isinstance(a, ends):
                        bad.append(f"{f.relative_to(REPO)}:{b.lineno}")
    assert len(files) > 50 and not bad, bad
