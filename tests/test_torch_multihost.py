"""Multi-process scan of the port: a 2-process gloo group on the CPU must
reproduce the JAX package's single-process run (tests/test_multihost.py's
run, there with jax.distributed). Each process owns files[pid::2]; the
pass-1 counts are summed so that both derive the same used list; process 0
writes the merged stats and BarcodesAssigned.tsv."""
import datetime
import gzip
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from sicelore_tpu.parallel import multihost as jax_multihost
from sicelore_tpu.pipeline.scanfastq import ScanFastqPipeline as JaxPipeline
from sicelore_tpu.utils import synth
from sicelore_tpu_torch.parallel import multihost

REPO = Path(__file__).resolve().parents[1]

# each worker imports the port alone (no jax, no sicelore_tpu)
WORKER = """
import datetime, json, sys
from pathlib import Path
sys.path.insert(0, {repo!r})
from sicelore_tpu_torch.parallel import multihost
multihost.init({coord!r}, 2, {pid}, timeout=datetime.timedelta(seconds=60))
from sicelore_tpu_torch.pipeline.scanfastq import ScanFastqPipeline
wl = json.loads(Path({wl_json!r}).read_text())
pipe = ScanFastqPipeline(whitelist=wl, user_max_ed=2, chunk_size=64,
                         device="cpu")
stats = pipe.run([{fq_dir!r}], {out_dir!r})
Path({out_dir!r}, f"proc{{multihost.process_index()}}.json").write_text(
    json.dumps({{"used": pipe.used_strs, "stats": stats.to_json(),
                 "jax": "jax" in sys.modules,
                 "sicelore_tpu": "sicelore_tpu" in sys.modules}}))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# what a rank prints when its store cannot take the port (another process
# took it after _free_port closed it, or rank 1's connect retries took it
# themselves: a TCP self-connect, which a port in the ephemeral range
# allows)
ADDRESS_IN_USE = ("address already in use", "eaddrinuse", "errno: 98")
LAUNCHES = 3        # the workers are relaunched on a fresh port at most twice


def _run_workers(tmp_path, fmt, timeout=120):
    """Start the two workers (WORKER.format(**fmt, coord=, pid=)) on a
    fresh port; a worker that exits with an error ends its peer at once
    (it would wait out the group's timeout). Relaunch on a new port, at
    most LAUNCHES times in all, only when a worker's stderr says the
    address is in use. -> ([returncode], [stderr text], seconds, tries)."""
    for attempt in range(1, LAUNCHES + 1):
        coord = f"localhost:{_free_port()}"
        procs, errs = [], []
        t0 = time.perf_counter()
        for pid in range(2):
            err = tmp_path / f"worker{pid}_try{attempt}.err"
            errs.append(err)
            with open(tmp_path / f"worker{pid}.out", "wb") as so, \
                    open(err, "wb") as se:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c",
                     WORKER.format(coord=coord, pid=pid, **fmt)],
                    cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(REPO)),
                    stdout=so, stderr=se))
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode for p in procs) or \
                        time.perf_counter() - t0 > timeout:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                p.kill()
                p.wait()
        secs = time.perf_counter() - t0
        texts = [e.read_text(errors="replace") for e in errs]
        rcs = [p.returncode for p in procs]
        if not any(rcs) or not any(m in t.lower() for t in texts
                                   for m in ADDRESS_IN_USE):
            return rcs, texts, secs, attempt
    return rcs, texts, secs, attempt


@pytest.mark.parametrize("pid,n", [(0, 2), (1, 2), (2, 3), (0, 1)])
def test_shard_files_as_jax(pid, n):
    files = [f"f{i}.fastq" for i in (3, 1, 4, 0, 5, 2, 6)]
    got = multihost.shard_files(files, pid, n)
    assert got == jax_multihost.shard_files(files, pid, n)
    assert got == sorted(files)[pid::n]


def test_one_process_collectives_are_identities():
    """Without a process group: rank 0 of 1, all files, counts and stats as
    they are (the JAX functions' single-process results)."""
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    files = ["b.fq", "a.fq"]
    assert multihost.shard_files(files) == jax_multihost.shard_files(files) \
        == ["a.fq", "b.fq"]
    counts = np.arange(5, dtype=np.int64)
    assert multihost.allreduce_counts(counts) is counts
    vals = {"b": 2, "a": np.int64(1)}
    merged = multihost.merge_scalar_stats(vals)
    assert merged == jax_multihost.merge_scalar_stats(vals) == vals
    assert merged is not vals


def test_init_without_a_group_to_join_raises(monkeypatch):
    """`init()` reads env:// (as torchrun sets it): with nothing set it
    raises rather than running on as one process."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="RANK"):
        multihost.init(timeout=datetime.timedelta(seconds=5))
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)


def test_two_process_run_matches_jax_single(tmp_path):
    """tests/test_multihost.py's run: rng 5, 64 barcodes, 4 files x 120
    reads, chunk 64."""
    rng = np.random.default_rng(5)
    wl = synth.make_whitelist(rng, 64)
    cells = wl[:6]
    fq_dir = tmp_path / "fastq"
    fq_dir.mkdir()
    k = 0
    for f in range(4):
        with gzip.open(fq_dir / f"part{f}.fastq.gz", "wb") as fh:
            for _ in range(120):
                cell = cells[int(rng.integers(0, len(cells)))]
                r = synth.make_read(rng, cell,
                                    cdna_len=int(rng.integers(120, 300)),
                                    error_rate=0.04,
                                    reverse=bool(rng.random() < 0.5))
                fh.write(b"@r%d\n" % k + r["seq"] + b"\n+\n"
                         + r["qual"] + b"\n")
                k += 1
    wl_json = tmp_path / "wl.json"
    wl_json.write_text(json.dumps(list(wl)))
    out_dir = tmp_path / "multi"
    rcs, errs, secs, tries = _run_workers(tmp_path, dict(
        repo=str(REPO), wl_json=str(wl_json), fq_dir=str(fq_dir),
        out_dir=str(out_dir)))
    for rc, se in zip(rcs, errs):
        assert rc == 0, f"after {secs:.1f} s, launch {tries}: " + se[-2000:]

    ref = JaxPipeline(whitelist=list(wl), user_max_ed=2, chunk_size=64)
    s_ref = ref.run([fq_dir], tmp_path / "one")
    d0, d1 = (json.loads((out_dir / f"proc{i}.json").read_text())
              for i in range(2))
    assert not any(d[k] for d in (d0, d1) for k in ("jax", "sicelore_tpu"))
    assert d0["used"] == d1["used"] == ref.used_strs
    # the stats are merged: both report the global numbers
    assert d0["stats"] == d1["stats"]
    assert d0["stats"]["bc_assigned"] == s_ref.bc_assigned > 300
    assert d0["stats"]["total_reads"] == s_ref.total_reads == 480
    one = json.loads((tmp_path / "one" / "scanner_stats.json").read_text())
    assert json.loads((out_dir / "scanner_stats.json").read_text()) == one
    for name in ("BarcodesAssigned.tsv", "BarcodeList.tsv"):
        assert (out_dir / name).read_bytes() == \
            (tmp_path / "one" / name).read_bytes(), name

    def files(d, sub):
        return {f.name: f.read_bytes() for f in (d / sub).iterdir()}
    for sub in ("passed", "failed"):
        assert files(out_dir, sub) == files(tmp_path / "one", sub)
    assert len(files(out_dir, "passed")) == 4
