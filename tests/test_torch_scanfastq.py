"""The port's scanfastq (plain torch bodies on CPU) against the JAX pipeline:
every output file must be byte-identical, in cached, streaming and
known-cells modes."""
import gzip
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from sicelore_tpu.pipeline.scanfastq import ScanFastqPipeline as JaxPipeline
from sicelore_tpu.utils import synth
from sicelore_tpu.utils.config import PipelineConfig
from sicelore_tpu_torch.utils.config import PipelineConfig as TorchConfig
from sicelore_tpu_torch.pipeline.scanfastq import ScanFastqPipeline

REPO = Path(__file__).resolve().parents[1]


def _write_fastq(path, recs):
    with gzip.open(path, "wb") as fh:
        for n, s, q in recs:
            fh.write(b"@" + n + b"\n" + s + b"\n+\n" + q + b"\n")


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """tests/test_scanfastq.py's synthetic run: 644 reads in 2 files, 16
    cells from a 256-BC whitelist, ~6% error, mixed strands, chimeras,
    garbage and too-short reads."""
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("run")
    wl = synth.make_whitelist(rng, 256)
    cells = wl[:16]
    for fi in range(2):
        recs = []
        for i in range(300):
            r = synth.make_read(rng, cells[int(rng.integers(0, 16))],
                                cdna_len=int(rng.integers(150, 700)),
                                error_rate=0.06,
                                reverse=bool(rng.random() < 0.5))
            recs.append((f"f{fi}r{i}".encode(), r["seq"], r["qual"]))
        for i in range(20):
            s = synth.random_seq(rng, 400).encode()
            recs.append((f"f{fi}g{i}".encode(), s, b"I" * len(s)))
        ch = synth.make_chimera(rng, cells[0], cells[1], cdna_len=400)
        recs.append((f"f{fi}chim".encode(), ch["seq"], ch["qual"]))
        recs.append((f"f{fi}short".encode(), b"ACGT" * 10, b"I" * 40))
        _write_fastq(d / f"reads{fi}.fastq.gz", recs)
    return d, wl, cells


@pytest.fixture(scope="module")
def n_dir(tmp_path_factory):
    """One file whose reads carry N bases within 300 bases of both ends
    (and inside chimera tiles): the TPU path re-runs such reads on an exact
    fallback, the port scans them like any other read."""
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("nrun")
    wl = synth.make_whitelist(rng, 64)
    cells = wl[:8]
    recs = []
    for i in range(160):
        if i % 40 == 5:
            r = synth.make_chimera(rng, cells[i % 8], cells[(i + 1) % 8],
                                   cdna_len=450)
        else:
            r = synth.make_read(rng, cells[i % 8],
                                cdna_len=int(rng.integers(200, 600)),
                                error_rate=0.04, reverse=bool(i % 2))
        s = bytearray(r["seq"])
        if i % 3 == 0:
            for p in rng.integers(0, 300, 2).tolist() + \
                    (len(s) - 1 - rng.integers(0, 300, 2)).tolist():
                s[p] = ord("N")
        if i % 40 == 5:
            s[len(s) // 2] = ord("N")
        recs.append((f"n{i}".encode(), bytes(s), r["qual"]))
    _write_fastq(d / "nreads.fastq.gz", recs)
    return d, wl, cells


def _blobs(out: Path) -> dict:
    blobs = {}
    for sub in ("passed", "failed"):
        for f in sorted((out / sub).iterdir()):
            blobs[f"{sub}/{f.name}"] = f.read_bytes()
    for name in ("BarcodeList.tsv", "BarcodesAssigned.tsv",
                 "scanner_stats.json"):
        if (out / name).exists():
            blobs[name] = (out / name).read_bytes()
    return blobs


def _same_outputs(a_dir: Path, b_dir: Path, what: str) -> bool:
    a, b = _blobs(a_dir), _blobs(b_dir)
    assert set(a) == set(b), what
    for k in a:
        assert a[k] == b[k], f"{what}: {k} differs"
    return True


MODES = {
    "cached": dict(user_max_ed=2, cache_pass1=True),
    "streaming": dict(user_max_ed=2, cache_pass1=False),
    "known_cells": dict(user_max_ed=1, known_cells=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_scanfastq_byte_identical_to_jax(run_dir, tmp_path, mode):
    d, wl, cells = run_dir
    kw = dict(MODES[mode])
    whitelist = cells if kw.get("known_cells") else wl
    ref = JaxPipeline(PipelineConfig(), whitelist=whitelist, chunk_size=200,
                      **kw)
    ref_stats = ref.run([d], tmp_path / "jax")
    port = ScanFastqPipeline(TorchConfig(), whitelist=whitelist,
                             chunk_size=200, device="cpu", **kw)
    stats = port.run([d], tmp_path / "torch")
    assert _same_outputs(tmp_path / "jax", tmp_path / "torch", mode)
    assert stats.to_json() == ref_stats.to_json()
    assert stats.bc_assigned > 400 and stats.split_chimeric >= 1


def test_reads_with_n_byte_identical_to_jax(n_dir, tmp_path):
    """N-containing reads: the JAX streaming pipeline (exact fallback for
    dirty reads and tiles) against the port's streaming AND cached runs.
    JAX's own cached mode cannot take them under numpy 2 (ROADMAP.md
    Queue 3)."""
    d, wl, _ = n_dir
    JaxPipeline(PipelineConfig(), whitelist=wl, chunk_size=64, user_max_ed=2,
                cache_pass1=False).run([d], tmp_path / "jax")
    for cached in (False, True):
        out = tmp_path / f"torch{int(cached)}"
        stats = ScanFastqPipeline(TorchConfig(), whitelist=wl,
                                  chunk_size=64, user_max_ed=2,
                                  cache_pass1=cached, device="cpu").run(
            [d], out)
        assert _same_outputs(tmp_path / "jax", out, f"cached={cached}")
    assert stats.bc_assigned > 100 and stats.split_chimeric >= 1


def test_demon_mode_byte_identical_to_jax(tmp_path):
    """run_demon: a file dropped while the demon polls passes through pass
    2 against the established used list, in both packages alike."""
    rng = np.random.default_rng(0)
    wl = synth.make_whitelist(rng, 32)
    recs = [[(b"d%d" % (off + i), r["seq"], r["qual"]) for i, r in enumerate(
        synth.make_read(rng, wl[int(rng.integers(0, 4))], cdna_len=200,
                        error_rate=0.03, reverse=bool(i % 2))
        for i in range(n))] for off, n in ((0, 40), (100, 25))]
    outs = {}
    for name, cls, cfg_cls, kw in (
            ("jax", JaxPipeline, PipelineConfig, {}),
            ("torch", ScanFastqPipeline, TorchConfig, {"device": "cpu"})):
        d = tmp_path / f"run_{name}"
        d.mkdir()
        _write_fastq(d / "a.fastq.gz", recs[0])
        _write_fastq(tmp_path / f"b_{name}.part", recs[1])
        dropper = threading.Timer(      # appears whole, mid-poll
            0.8, os.replace, (tmp_path / f"b_{name}.part", d / "b.fastq.gz"))
        dropper.start()
        stats = cls(cfg_cls(), whitelist=wl, user_max_ed=1,
                    chunk_size=32, **kw).run_demon(
            [d], tmp_path / f"out_{name}", poll_interval=0.4,
            idle_timeout=2.5, log=lambda *a: None)
        dropper.join()
        assert stats.total_reads == 65 and stats.bc_assigned > 55
        outs[name] = tmp_path / f"out_{name}"
    assert _same_outputs(outs["jax"], outs["torch"], "demon")


def test_random_barcode_raises(run_dir, tmp_path):
    d, wl, _ = run_dir
    pipe = ScanFastqPipeline(TorchConfig(), whitelist=wl, chunk_size=200,
                             random_barcode=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipe.run([d], tmp_path / "neg")


def test_cli_scanfastq_cpu(run_dir, tmp_path):
    """`python -m sicelore_tpu_torch scanfastq --device cpu` on one file."""
    d, wl, _ = run_dir
    wl_path = tmp_path / "wl.txt"
    wl_path.write_text("\n".join(wl) + "\n")
    out = tmp_path / "cli"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "sicelore_tpu_torch", "scanfastq",
         "-d", str(d / "reads0.fastq.gz"), "-o", str(out),
         "--whitelist", str(wl_path), "-b", "2", "--chunkSize", "200",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    assert "scanfastq done: 322 reads" in r.stdout
    stats = json.loads((out / "scanner_stats.json").read_text())
    assert stats["bc_assigned"] > 200
    assert (out / "passed" / "reads0FWD.fastq").stat().st_size > 0
