"""The port's scanfastq (plain torch bodies on CPU) against the JAX pipeline:
every output file must be byte-identical, in cached, streaming and
known-cells modes, for 3p and 5p chemistry, and on the synchronous pass 2
(random-barcode negative control with one seed, empty used list)."""
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


@pytest.fixture(scope="module")
def run5p_dir(tmp_path_factory):
    """A 5p run (tests/test_5p_pipeline.py's reads, more of them): 2 files
    of 150 reads, 8 cells of a 96-BC whitelist, both strands, a few long
    reads, garbage and a too-short read."""
    rng = np.random.default_rng(4)
    d = tmp_path_factory.mktemp("run5p")
    wl = synth.make_whitelist(rng, 96)
    cells = wl[:8]
    for fi in range(2):
        recs = []
        for i in range(150):
            r = synth.make_read_5p(
                rng, cells[int(rng.integers(0, 8))],
                cdna_len=int(rng.integers(1500, 3000)) if i % 29 == 0
                else int(rng.integers(150, 600)),
                error_rate=0.04, reverse=bool(i % 2))
            recs.append((f"f{fi}m{i}".encode(), r["seq"], r["qual"]))
        for i in range(6):
            s = synth.random_seq(rng, 350).encode()
            recs.append((f"f{fi}g{i}".encode(), s, b"I" * len(s)))
        recs.append((f"f{fi}short".encode(), b"ACGT" * 10, b"I" * 40))
        _write_fastq(d / f"reads{fi}.fastq.gz", recs)
    return d, wl, cells


@pytest.fixture(scope="module")
def n5p_dir(tmp_path_factory):
    """5p reads with N bases within 300 bases of both ends."""
    rng = np.random.default_rng(70)
    d = tmp_path_factory.mktemp("nrun5p")
    wl = synth.make_whitelist(rng, 64)
    recs = []
    for i in range(120):
        r = synth.make_read_5p(rng, wl[i % 8],
                               cdna_len=int(rng.integers(200, 600)),
                               error_rate=0.04, reverse=bool(i % 2))
        s = bytearray(r["seq"])
        if i % 3 == 0:
            for p in rng.integers(0, 300, 2).tolist() + \
                    (len(s) - 1 - rng.integers(0, 300, 2)).tolist():
                s[p] = ord("N")
        recs.append((f"n{i}".encode(), bytes(s), r["qual"]))
    _write_fastq(d / "nreads.fastq.gz", recs)
    return d, wl


def _cfg5p():
    cfg, tcfg = PipelineConfig(), TorchConfig()
    cfg.chemistry = tcfg.chemistry = "5p"
    return cfg, tcfg


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


@pytest.mark.parametrize("cached", [True, False],
                         ids=["cached", "streaming"])
def test_5p_scanfastq_byte_identical_to_jax(run5p_dir, tmp_path, cached):
    from sicelore_tpu_torch.ops import editdist
    from sicelore_tpu_torch.ops import edgescan as eg

    d, wl, cells = run5p_dir
    cfg, tcfg = _cfg5p()
    kw = dict(user_max_ed=2, chunk_size=100, cache_pass1=cached)
    ref_stats = JaxPipeline(cfg, whitelist=wl, **kw).run([d],
                                                         tmp_path / "jax")
    before = editdist.myers_win1.launches
    stats = ScanFastqPipeline(tcfg, whitelist=wl, device="cpu", **kw).run(
        [d], tmp_path / "torch")
    assert _same_outputs(tmp_path / "jax", tmp_path / "torch", "5p")
    assert stats.to_json() == ref_stats.to_json()
    assert stats.bc_assigned > 250
    assert editdist.myers_win1.launches == before     # no kernel on the CPU
    assert eg.edge_params(tcfg).kernel_unsupported == ""  # fused on cuda


def test_5p_reads_with_n_byte_identical_to_jax(n5p_dir, tmp_path):
    """5p reads with N: the JAX streaming run (its cached mode cannot take
    them under numpy 2, ROADMAP.md Queue 3) against the port's streaming
    and cached runs."""
    d, wl = n5p_dir
    cfg, tcfg = _cfg5p()
    JaxPipeline(cfg, whitelist=wl, chunk_size=64, user_max_ed=2,
                cache_pass1=False).run([d], tmp_path / "jax")
    for cached in (False, True):
        out = tmp_path / f"torch{int(cached)}"
        stats = ScanFastqPipeline(tcfg, whitelist=wl, chunk_size=64,
                                  user_max_ed=2, cache_pass1=cached,
                                  device="cpu").run([d], out)
        assert _same_outputs(tmp_path / "jax", out, f"cached={cached}")
    assert stats.bc_assigned > 80


def test_random_barcode_raises(run_dir, tmp_path):
    """The random-barcode negative control (the name dates from when this
    path raised NotImplementedError): it raises nothing, draws the same
    windows as the JAX run from the same seed, so every output file is
    byte-identical, and assigns (falsely) far under 5% of the stranded
    reads."""
    d, wl, _ = run_dir
    kw = dict(user_max_ed=1, chunk_size=200, random_barcode=True, seed=12)
    ref_stats = JaxPipeline(PipelineConfig(), whitelist=wl, **kw).run(
        [d], tmp_path / "jax")
    pipe = ScanFastqPipeline(TorchConfig(), whitelist=wl, device="cpu", **kw)
    assert pipe._cache_decision([]) is False        # always streams
    stats = pipe.run([d], tmp_path / "torch")
    assert _same_outputs(tmp_path / "jax", tmp_path / "torch", "random")
    assert stats.to_json() == ref_stats.to_json()
    assert stats.stranded > 500 and stats.split_chimeric >= 1
    assert stats.bc_assigned / stats.stranded < 0.05


def test_random_barcode_seed_changes_the_windows(run_dir, tmp_path):
    """Another seed draws other windows: the stats may differ, the run
    stays a valid control; the same seed twice is reproducible."""
    d, wl, _ = run_dir
    outs = []
    for i, seed in enumerate((12, 12, 13)):
        ScanFastqPipeline(TorchConfig(), whitelist=wl, chunk_size=200,
                          user_max_ed=3, random_barcode=True, seed=seed,
                          device="cpu").run([d / "reads0.fastq.gz"],
                                            tmp_path / f"o{i}")
        outs.append(_blobs(tmp_path / f"o{i}"))
    assert outs[0] == outs[1]
    names = {n for o in (outs[0], outs[2]) for n in o}
    assert any(outs[0].get(n) != outs[2].get(n) for n in names)


@pytest.mark.parametrize("chem", ["3p", "5p"])
def test_empty_used_list_byte_identical_to_jax(run_dir, run5p_dir, tmp_path,
                                               chem):
    """A whitelist that shares no barcode with the reads: pass 1 finds
    nothing, pass 2 takes the synchronous path and assigns nothing."""
    d = (run_dir if chem == "3p" else run5p_dir)[0]
    other = synth.make_whitelist(np.random.default_rng(999), 40)
    cfg, tcfg = PipelineConfig(), TorchConfig()
    cfg.chemistry = tcfg.chemistry = chem
    ref_stats = JaxPipeline(cfg, whitelist=other, chunk_size=200,
                            user_max_ed=2).run([d], tmp_path / "jax")
    pipe = ScanFastqPipeline(tcfg, whitelist=other, chunk_size=200,
                             user_max_ed=2, device="cpu")
    stats = pipe.run([d], tmp_path / "torch")
    assert pipe.used_peq is None and not pipe.used_strs
    assert _same_outputs(tmp_path / "jax", tmp_path / "torch", "empty")
    assert stats.to_json() == ref_stats.to_json()
    assert stats.bc_assigned == 0 and stats.stranded > 200
    assert (tmp_path / "torch" / "BarcodeList.tsv").read_bytes() == b""


def test_pass_chunk_entry_points_match_jax(run_dir, tmp_path):
    """pass1_chunk, split_chimeras and pass2_chunk called directly, as a
    library user would: counts, the split chunk and the emitted records
    equal the JAX pipeline's."""
    from sicelore_tpu.io import fastq as jax_fastq
    from sicelore_tpu_torch.io import fastq

    d, wl, _ = run_dir
    f = d / "reads1.fastq.gz"
    ref = JaxPipeline(PipelineConfig(), whitelist=wl, user_max_ed=2)
    port = ScanFastqPipeline(TorchConfig(), whitelist=wl, user_max_ed=2,
                             device="cpu")
    for pipe, mod, name in ((ref, jax_fastq, "jax"), (port, fastq, "torch")):
        chunk = next(mod.read_fastq(f, 400))
        pipe.pass1_chunk(chunk)
        pipe.build_used_list()
        sub = pipe.split_chimeras(chunk)
        pipe.split_names = sub.names
        out = tmp_path / name
        with mod.FastqWriter(out / "passed" / "p.fastq") as pw, \
                mod.FastqWriter(out / "failed" / "f.fastq") as fw:
            pipe.pass2_chunk(chunk, pw, fw)
        mod.writer_barrier()
    np.testing.assert_array_equal(port.wl_counts, ref.wl_counts)
    assert port.used_strs == ref.used_strs and len(port.used_strs) == 16
    assert port.split_names == ref.split_names
    assert any(n.endswith(b"sp2") for n in port.split_names)
    assert _same_outputs(tmp_path / "jax", tmp_path / "torch", "chunks")
    assert port.stats.to_json() == ref.stats.to_json()
    assert port.stats.bc_assigned > 200


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


def _cli(args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "sicelore_tpu_torch", "scanfastq", *args],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_cli_scanfastq_5p_cpu(run5p_dir, tmp_path):
    """`scanfastq -5 --device cpu`: the 5p chemistry from the CLI."""
    d, wl, _ = run5p_dir
    (tmp_path / "wl.txt").write_text("\n".join(wl) + "\n")
    out = tmp_path / "cli5p"
    r = _cli(["-d", str(d / "reads0.fastq.gz"), "-o", str(out),
              "--whitelist", str(tmp_path / "wl.txt"), "-b", "2", "-5",
              "--chunkSize", "100", "--device", "cpu"])
    assert r.returncode == 0, r.stderr
    assert "scanfastq done: 157 reads" in r.stdout
    stats = json.loads((out / "scanner_stats.json").read_text())
    assert stats["bc_assigned"] > 120
    from sicelore_tpu_torch.io import fastq
    from sicelore_tpu_torch.pipeline import readname
    names = [n for ch in fastq.read_fastq(out / "passed" / "reads0FWD.fastq")
             for n in ch.names]
    infos = [readname.parse_name(n) for n in names]
    assert all(i.bc_start < i.bc_end for i in infos)   # ascending = 5p


def test_cli_scanfastq_random_barcode_cpu(run_dir, tmp_path):
    """`scanfastq -e --device cpu`: the negative control from the CLI."""
    d, wl, _ = run_dir
    (tmp_path / "wl.txt").write_text("\n".join(wl) + "\n")
    out = tmp_path / "clineg"
    r = _cli(["-d", str(d / "reads0.fastq.gz"), "-o", str(out),
              "--whitelist", str(tmp_path / "wl.txt"), "-b", "1", "-e",
              "--chunkSize", "200", "--device", "cpu"])
    assert r.returncode == 0, r.stderr
    assert "scanfastq done: 322 reads" in r.stdout
    stats = json.loads((out / "scanner_stats.json").read_text())
    assert stats["stranded"] > 250
    assert stats["bc_assigned"] < 0.05 * stats["stranded"]
    assert (out / "BarcodeList.tsv").stat().st_size > 0
