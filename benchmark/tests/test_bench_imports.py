"""What a run loads: no module of JAX or of the JAX package, whose name the
port's begins with (top-level names compared whole), and nothing of the
program in the reference. And a run without a card prints no result."""
import json
import os
import subprocess
import sys

from benchmark.harness.cell import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "sicelore_tpu")


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_drivers_metrics_load_no_jax():
    top = loaded_after(
        "from benchmark import run\n"
        "from benchmark.harness import cell, trace, work\n"
        "from benchmark.drivers import scan, consensus\n"
        "from benchmark.reference import scan as rs, consensus as rc\n"
        "import sicelore_tpu_torch.pipeline.scanfastq\n"
        "import sicelore_tpu_torch.pipeline.consensus\n"
        "import sicelore_tpu_torch.ops.poa_cuda\n"
        "from pathlib import Path\n"
        "for f in sorted(Path('benchmark/metrics').glob('*.py')):\n"
        "    cell.load_file_module(f, 'm_' + f.stem.replace('.', '_'))\n")
    assert "sicelore_tpu_torch" in top       # the program itself is loaded
    assert not top & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    top = loaded_after(
        "from benchmark.reference import scan, consensus\n"
        "from benchmark.gen import reads, molecules, bam\n")
    assert not top & (set(FORBIDDEN) | {"sicelore_tpu_torch"})


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "tenx3p_v3.scan",
         "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
