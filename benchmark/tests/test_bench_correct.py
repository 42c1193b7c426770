"""`correct` on the CPU at a size a test run holds: a sound run of each
driver is correct, and the rest of a run with the timed path broken
underneath is not (half of the work left out, an answer altered where it is
produced, a step that returns its input unchanged, chimeras left unsplit),
nor is the control (the program with a guarantee of the configuration
broken) in the program's place. The harness's look for a card is skipped by
running on the CPU."""
import numpy as np
import pytest

from benchmark.harness import cell
from benchmark.reference import consensus as rc

SEED = 2**32 + 17
SMALL = {
    "tenx3p_v3.scan": {"config": {"whitelist_barcodes": 20000, "cells": 100,
                                  "reads_per_run": 2048, "files_per_run": 2,
                                  "chunk_size": 512}},
    "tenx3p_v3.consensus_wta": {"mix": {"molecules": 160}},
    "tenx3p_v3.consensus_deep": {"mix": {"molecules": 48}},
}


def run(workload, trace=False, seed=SEED):
    return cell.run_cell(workload, seed, 0.01, trace, device="cpu",
                         overrides=SMALL[workload], log=lambda *a, **k: None)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["records_wrong"]["value"] == 0


def test_traced_run_is_correct_and_reads_host_spans():
    r = run("tenx3p_v3.scan", trace=True)
    assert r["correct"]
    assert r["metrics"]["scan.emit_ms_per_kread"]["value"] > 0
    assert "scan_reads_per_s" not in r["metrics"]


def _scan(monkeypatch, attr, make):
    from sicelore_tpu_torch.pipeline.scanfastq import ScanFastqPipeline
    monkeypatch.setattr(ScanFastqPipeline, attr,
                        make(getattr(ScanFastqPipeline, attr)))


def _half_files(monkeypatch):
    _scan(monkeypatch, "run", lambda orig: lambda self, inputs, out: orig(
        self, inputs[:len(inputs) // 2], out))


def _altered_base(monkeypatch):
    """One base of one read changed in the records pass 2 writes."""
    def make(orig):
        def emit(self, chunk, *a, **kw):
            s = chunk.seqs[0]
            chunk.seqs[0] = s[:40] + (b"A" if s[40:41] != b"A" else b"C") \
                + s[41:]
            return orig(self, chunk, *a, **kw)
        return emit
    _scan(monkeypatch, "pass2_emit", make)


def _shifted_barcodes(monkeypatch):
    """Each assignment names the next barcode of the used list."""
    def make(orig):
        def emit(self, chunk, out, bc, *a, **kw):
            bc = dict(bc, idx=(np.asarray(bc["idx"]) + 1)
                      % len(self.used_strs))
            return orig(self, chunk, out, bc, *a, **kw)
        return emit
    _scan(monkeypatch, "pass2_emit", make)


def _unassigned(monkeypatch):
    """Pass 2 returns every read as it came: none assigned."""
    def make(orig):
        def emit(self, chunk, out, bc, *a, **kw):
            bc = dict(bc, ed=np.full_like(np.asarray(bc["ed"]), 99))
            return orig(self, chunk, out, bc, *a, **kw)
        return emit
    _scan(monkeypatch, "pass2_emit", make)


def _unsplit(monkeypatch):
    _scan(monkeypatch, "_finish_splits",
          lambda orig: lambda self, job, passed, failed: None)


def _engine(monkeypatch, fn):
    from sicelore_tpu_torch.ops.poa_cuda import BatchedConsensusEngine
    orig = BatchedConsensusEngine.__call__
    monkeypatch.setattr(BatchedConsensusEngine, "__call__",
                        lambda self, mols, **kw: fn(mols, orig(self, mols,
                                                               **kw)))


def _half_molecules(monkeypatch):
    _engine(monkeypatch, lambda mols, res: [
        r if i % 2 == 0 else (b"", b"") for i, r in enumerate(res)])


def _swapped_answer(monkeypatch):
    """One molecule of three or more reads gets the next one's consensus."""
    def alter(mols, res):
        i = next(i for i, m in enumerate(mols) if len(m) > 2)
        res[i] = res[i + 1]
        return res
    _engine(monkeypatch, alter)


def _altered_single(monkeypatch):
    """One base changed in the consensus of a molecule of one read."""
    def alter(mols, res):
        i = next(i for i, m in enumerate(mols) if len(m) == 1)
        cons, qv = res[i]
        res[i] = (cons[:5] + (b"A" if cons[5:6] != b"A" else b"C")
                  + cons[6:], qv)
        return res
    _engine(monkeypatch, alter)


def _unchanged(monkeypatch):
    """The engine returns each molecule's first read as its consensus."""
    from sicelore_tpu_torch.ops.poa_cuda import BatchedConsensusEngine
    monkeypatch.setattr(BatchedConsensusEngine, "__call__",
                        lambda self, mols, minps=3, maxps=20, **kw:
                        [(m[0], bytes([33 + maxps]) * len(m[0])) if m
                         else (b"", b"") for m in mols])


FAULTS = [("tenx3p_v3.scan", _half_files),
          ("tenx3p_v3.scan", _altered_base),
          ("tenx3p_v3.scan", _shifted_barcodes),
          ("tenx3p_v3.scan", _unassigned),
          ("tenx3p_v3.scan", _unsplit),
          ("tenx3p_v3.consensus_wta", _half_molecules),
          ("tenx3p_v3.consensus_wta", _altered_single),
          ("tenx3p_v3.consensus_wta", _swapped_answer),
          ("tenx3p_v3.consensus_deep", _swapped_answer),
          ("tenx3p_v3.consensus_deep", _unchanged)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    r = run(workload)
    assert not r["correct"]
    assert r["failed"] == r["attempted"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_is_not_correct(workload, monkeypatch):
    """The control's call in the program's place, judged as the program's
    calls are."""
    drv = cell.load_cell(cell.with_pending(
        cell.load_json(cell.ROOT / "BENCHMARK.json"), workload), workload)[3]
    real = drv.call

    def control(state, out, **kw):
        if kw:                          # the control's own call inside
            return real(state, out, **kw)
        drv.control_call(state, out)
        return 1
    monkeypatch.setattr(drv, "call", control)
    r = run(workload)
    assert not r["correct"]


def test_edit_distance_is_levenshtein():
    def lev(a, b):
        prev = list(range(len(b) + 1))
        for i in range(1, len(a) + 1):
            cur = [i] + [0] * len(b)
            for j in range(1, len(b) + 1):
                cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                             prev[j - 1] + (a[i - 1] != b[j - 1]))
            prev = cur
        return prev[-1]
    rng = np.random.default_rng(3)
    for t in range(200):
        a = rng.choice(list(b"ACGTN"), int(rng.integers(0, 90)))
        a = bytes(a.astype(np.uint8))
        b = bytes(rng.choice(list(b"ACGT"), int(rng.integers(0, 90)))
                  .astype(np.uint8)) if t % 3 == 0 else \
            a[:5] + b"GG" + a[9:] + b"T"
        assert rc.edit_distance(a, b) == lev(a, b)
