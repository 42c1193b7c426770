"""computeconsensus: the port's pipeline (engine on the CPU) against the JAX
package's (production Pallas route, interpret mode) on one tagged BAM:
output fastq and .log stats byte-identical, and the CLI once; a call holds
the interpreter's cyclic collector off and puts back the state it found."""
import gc
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from sicelore_tpu.ops.poa_tpu import BatchedConsensusEngine as JaxEngine
from sicelore_tpu.pipeline.consensus import compute_consensus as jax_consensus
from sicelore_tpu_torch.io.bam import BamHeader, BamRecord, BamWriter
from sicelore_tpu_torch.ops import poa_cuda
from sicelore_tpu_torch.pipeline.consensus import compute_consensus
from sicelore_tpu_torch.utils import synth, trace

REPO = Path(__file__).resolve().parents[1]
HDR = BamHeader("@SQ\tSN:chr1\tLN:100000\n", [("chr1", 100000)])


@pytest.fixture(scope="module")
def tagged_bam(tmp_path_factory):
    """12 molecules: five multi-read (one with an N), three 2-read, four
    1-read; plus a chimeric record (300-base clip), a record without U8 and
    an unmapped one, which the parser must drop."""
    rng = np.random.default_rng(12)
    mols, _ = synth.molecule_set(rng, 4, 5, 0.06, 180)
    n_mol, _ = synth.molecule_set(rng, 1, 4, 0.05, 200)
    s = bytearray(n_mol[0][2])
    s[60] = ord("N")
    n_mol[0][2] = bytes(s)
    two, _ = synth.molecule_set(rng, 3, 2, 0.05, 150)
    one, _ = synth.molecule_set(rng, 4, 1, 0.05, 120)
    mols = mols + n_mol + two + one
    recs = list(synth.tagged_records(mols, rng))
    bc = recs[0].get_tag("BC")
    cdna = synth.random_seq(rng, 100)
    recs.insert(3, BamRecord(
        qname="chimeric", flag=0, ref_id=0, pos=50, mapq=60,
        cigar=[("S", 300), ("M", 100)],
        tags=[("BC", "Z", bc), ("U8", "Z", "ACGTACGTACGT"),
              ("de", "f", 0.01), ("CS", "Z", cdna)]))
    recs.insert(9, BamRecord(
        qname="noumi", flag=0, ref_id=0, pos=60, mapq=60, cigar=[("M", 100)],
        tags=[("BC", "Z", bc), ("de", "f", 0.01), ("CS", "Z", cdna)]))
    recs.append(BamRecord(qname="unmapped", flag=4,
                          tags=[("BC", "Z", bc), ("U8", "Z", "TTTTACGTACGT"),
                                ("CS", "Z", cdna)]))
    path = tmp_path_factory.mktemp("cons") / "tagged.bam"
    with BamWriter(path, HDR) as w:
        for r in recs:
            w.write(r)
    return path, len(mols), len(recs)


@pytest.mark.parametrize("refine", [False, True])
def test_compute_consensus_byte_identical_to_jax(tagged_bam, tmp_path,
                                                 refine):
    import functools

    bam, n_mol, n_rec = tagged_bam
    ref_eng = JaxEngine(force="pallas-interpret")
    eng = poa_cuda.BatchedConsensusEngine(device="cpu")
    if refine:
        ref_eng = functools.partial(ref_eng, refine=True)
        eng = functools.partial(eng, refine=True)
    ref = jax_consensus(bam, tmp_path / "jax.fastq", engine=ref_eng,
                        log_json=tmp_path / "jax.fastq.log")
    before = poa_cuda.band_align_plain.launches
    got = compute_consensus(bam, tmp_path / "torch.fastq", engine=eng,
                            log_json=tmp_path / "torch.fastq.log")
    assert poa_cuda.band_align_plain.launches > before
    assert got == ref
    assert got["molecules"] == n_mol and got["written"] == n_mol
    assert got["total_records"] == n_rec
    assert got["valid_records"] == n_rec - 3
    assert (tmp_path / "torch.fastq").read_bytes() == \
        (tmp_path / "jax.fastq").read_bytes()
    assert (tmp_path / "torch.fastq.log").read_bytes() == \
        (tmp_path / "jax.fastq.log").read_bytes()


def test_host_engine_default_matches_jax(tagged_bam, tmp_path):
    """The host engine runs only when asked for (engine="host"); the JAX
    package's default is that engine."""
    bam, n_mol, _ = tagged_bam
    jax_consensus(bam, tmp_path / "jax.fastq", maxreads=3)
    got = compute_consensus(bam, tmp_path / "torch.fastq", maxreads=3,
                            engine="host")
    assert got["written"] == n_mol
    assert (tmp_path / "torch.fastq").read_bytes() == \
        (tmp_path / "jax.fastq").read_bytes()


def test_default_engine_is_the_device_engine(tagged_bam, tmp_path):
    """No engine given: the batched engine on `device`. On the CPU it is
    byte-equal to an engine passed in; the default device is cuda, which
    raises without a GPU instead of giving way to the host engine."""
    import torch

    bam, n_mol, _ = tagged_bam
    before = poa_cuda.band_align_plain.launches
    got = compute_consensus(bam, tmp_path / "dflt.fastq", device="cpu")
    assert poa_cuda.band_align_plain.launches > before
    assert got["written"] == n_mol
    compute_consensus(bam, tmp_path / "eng.fastq",
                      engine=poa_cuda.BatchedConsensusEngine(device="cpu"))
    assert (tmp_path / "dflt.fastq").read_bytes() == \
        (tmp_path / "eng.fastq").read_bytes()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            compute_consensus(bam, tmp_path / "none.fastq")


def test_cli_computeconsensus_cpu(tagged_bam, tmp_path):
    """`python -m sicelore_tpu_torch computeconsensus --device cpu`: the
    same bytes as the library call; without a GPU the default device
    raises instead of falling back to the host engine."""
    import torch

    bam, n_mol, _ = tagged_bam
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "sicelore_tpu_torch", "computeconsensus",
           "-I", str(bam), "-O", str(tmp_path / "cli.fastq")]
    r = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                       text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    assert f"computeconsensus done: {n_mol}/{n_mol} molecules" in r.stdout
    compute_consensus(bam, tmp_path / "lib.fastq",
                      engine=poa_cuda.BatchedConsensusEngine(device="cpu"))
    assert (tmp_path / "cli.fastq").read_bytes() == \
        (tmp_path / "lib.fastq").read_bytes()
    assert (tmp_path / "cli.fastq.log").exists()
    if not torch.cuda.is_available():
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                           cwd=REPO, env=env)
        assert r.returncode != 0 and "cuda" in r.stderr


# ---------------------------------------------------------------------------
# the collector held off across a call
# ---------------------------------------------------------------------------

@pytest.fixture
def collector():
    """The collector's thresholds as the test found them (its state and
    they are put back after it)."""
    was, thresholds = gc.isenabled(), gc.get_threshold()
    yield thresholds
    gc.set_threshold(*thresholds)
    (gc.enable if was else gc.disable)()


def _cpu_engine(seen):
    """The batched engine on the CPU, noting the collector's state each
    time it is called."""
    eng = poa_cuda.BatchedConsensusEngine(device="cpu")

    def run(jobs, **kw):
        seen.append(gc.isenabled())
        return eng(jobs, **kw)
    return run


@pytest.mark.parametrize("enabled", [True, False], ids=["on", "off"])
def test_call_puts_back_the_collectors_state(tagged_bam, tmp_path,
                                             collector, enabled):
    """Off inside the call; after it, on where it was on and off where the
    caller had switched it off."""
    bam, n_mol, _ = tagged_bam
    (gc.enable if enabled else gc.disable)()
    seen = []
    got = compute_consensus(bam, tmp_path / "c.fastq",
                            engine=_cpu_engine(seen))
    assert seen == [False]
    assert gc.isenabled() is enabled
    assert got["written"] == n_mol


def test_engine_that_raises_leaves_the_collector_enabled(tagged_bam,
                                                         tmp_path,
                                                         collector):
    bam, _, _ = tagged_bam
    gc.enable()
    seen = []

    def engine(jobs, **kw):
        seen.append(gc.isenabled())
        raise RuntimeError("engine failed")
    with pytest.raises(RuntimeError, match="engine failed"):
        compute_consensus(bam, tmp_path / "x.fastq", engine=engine)
    assert seen == [False]
    assert gc.isenabled()


def test_traced_call_counts_its_hold_and_no_collection(tagged_bam, tmp_path,
                                                       collector):
    """With a collection due at every tracked allocation (threshold 1):
    none starts between `consensus.call`'s start and end, the first comes
    once the hold ends, and the tracer counts one hold and the tracked
    objects the call left alive."""
    bam, n_mol, _ = tagged_bam
    eng = poa_cuda.BatchedConsensusEngine(device="cpu")
    starts = []

    def on_gc(phase, info):
        if phase == "start":
            starts.append(time.perf_counter_ns())
    gc.enable()
    gc.callbacks.append(on_gc)
    trace.enable()
    try:
        gc.set_threshold(1)
        got = compute_consensus(bam, tmp_path / "t.fastq", engine=eng)
        after = [[] for _ in range(3)]
    finally:
        gc.set_threshold(*collector)
        trace.disable()
        gc.callbacks.remove(on_gc)
    snap = trace.snapshot()
    trace.reset()
    assert got["written"] == n_mol and len(after) == 3
    call = next(s for s in snap["spans"] if s["name"] == "consensus.call")
    assert not [t for t in starts if call["start"] <= t <= call["end"]]
    assert [t for t in starts if t > call["end"]]
    assert not [s for s in snap["spans"]
                if s["name"] == "gc" and s["call"] == call["call"]]
    held = {c["name"]: c["value"] for c in snap["counters"]
            if c["name"] in ("gc.held", "gc.held_objects")}
    assert held["gc.held"] == 1 and held["gc.held_objects"] > 0


def test_held_call_writes_the_jax_packages_bytes(tagged_bam, tmp_path,
                                                 collector):
    """With the collector on at threshold 1 around the call, the fastq is
    the one `test_compute_consensus_byte_identical_to_jax` holds to the
    JAX package's."""
    bam, n_mol, _ = tagged_bam
    jax_consensus(bam, tmp_path / "jax.fastq",
                  engine=JaxEngine(force="pallas-interpret"))
    eng = poa_cuda.BatchedConsensusEngine(device="cpu")
    gc.enable()
    gc.set_threshold(1)
    try:
        got = compute_consensus(bam, tmp_path / "torch.fastq", engine=eng)
    finally:
        gc.set_threshold(*collector)
    assert got["written"] == n_mol
    assert (tmp_path / "torch.fastq").read_bytes() == \
        (tmp_path / "jax.fastq").read_bytes()
