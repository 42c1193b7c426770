"""Step 4b on full-length cDNA (`benchmark/gen/longcdna.py`: truths in
length bands): the port's `compute_consensus` on the CPU engine against the
JAX package's, byte for byte, on molecules of the Lc 2,048 bucket, the long
route (a center over 2,048) and the N route; the program's tracer on the
long route (`hostnw.align`, `hostnw.rows`, the `hostnw.*` counters) and on
the buckets (`consensus.pairs` by `Lc`) against the pair tables the
molecules give; `align_pairs` cut into several launches by a small slab;
and a traced CPU run of the benchmark's cell."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark.gen import longcdna as gen
from benchmark.gen.molecules import write_molecules
from benchmark.harness.cell import BENCH, load_json
from benchmark.reference import longcdna as ref
from sicelore_tpu.ops.poa_tpu import BatchedConsensusEngine as JaxEngine
from sicelore_tpu.pipeline.consensus import compute_consensus as jax_consensus
from sicelore_tpu_torch.ops import hostnw_cuda as hn
from sicelore_tpu_torch.ops import poa_cuda
from sicelore_tpu_torch.pipeline.consensus import compute_consensus
from sicelore_tpu_torch.utils import trace
from tools.trace_check import band_cells, expected_pairs

REPO = Path(__file__).resolve().parents[1]
CELL = "tenx3p_v3_longcdna.consensus_longcdna"
CONS = {"maxreads": 20, "minps": 3, "maxps": 20}
MIX = load_json(BENCH / "traffic" / "consensus_longcdna.json")["mix"]
# the smallest set the JAX engine's interpret mode takes in well under a
# minute: a molecule of the Lc 2,048 bucket, one of the long route and one
# with an N (the host engine); the Lc 1,024 bucket costs it ~50 s more, and
# tests/test_torch_poa.py holds that bucket to it already
JAX_SET = {**MIX, "molecules": 3, "depth_range": [3, 4], "n_share": 0.34,
           "bands": [[0.34, 400, 500], [0.33, 1100, 1300],
                     [0.33, 2100, 2200]]}
# every route and bucket of the cell: Lc 512, Lc 1,024 and Lc 2,048, the
# long route, an N molecule (the first, of band 0), at CPU sizes
ROUTES = {**MIX, "molecules": 8, "depth_range": [3, 5], "n_share": 0.125,
          "bands": [[0.5, 400, 700], [0.25, 1100, 1300],
                    [0.25, 2100, 2200]]}


def molecules(mix, seed):
    return gen.make_molecules(np.random.default_rng(seed), mix)


def test_compute_consensus_byte_identical_to_jax(tmp_path):
    mols = molecules(JAX_SET, 2**32 + 43)
    tops = sorted(max(map(len, r)) for r in mols.reads)
    assert tops[0] <= 512 < 1024 < tops[1] <= 2048 < tops[2]
    assert sum(any(b"N" in s for s in r) for r in mols.reads) == 1
    bam = tmp_path / "long.bam"
    write_molecules(bam, mols)
    want = jax_consensus(bam, tmp_path / "jax.fastq",
                         engine=JaxEngine(force="pallas-interpret"),
                         log_json=tmp_path / "jax.fastq.log")
    got = compute_consensus(bam, tmp_path / "torch.fastq",
                            engine=poa_cuda.BatchedConsensusEngine(
                                device="cpu"),
                            log_json=tmp_path / "torch.fastq.log")
    assert got == want
    assert got["molecules"] == got["written"] == 3
    for x in (".fastq", ".fastq.log"):
        assert (tmp_path / f"torch{x}").read_bytes() == \
            (tmp_path / f"jax{x}").read_bytes()


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(molecules, snapshot, output) of one traced call on the CPU engine
    over every route and bucket of the cell."""
    mols = molecules(ROUTES, 2**32 + 47)
    tmp = tmp_path_factory.mktemp("longcdna")
    write_molecules(tmp / "long.bam", mols)
    trace.enable()
    try:
        compute_consensus(tmp / "long.bam", tmp / "on.fastq",
                          engine=poa_cuda.BatchedConsensusEngine(
                              device="cpu"))
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    return mols, snap, tmp / "on.fastq"


def _count(snap, name, **attrs):
    return sum(c["value"] for c in snap["counters"] if c["name"] == name
               and all(c["attrs"].get(k) == v for k, v in attrs.items()))


def test_counters_are_the_pair_tables(traced):
    """The counters against the pair tables that the engine's rules give
    the molecules, worked out apart from the program
    (`tools/trace_check.expected_pairs`)."""
    mols, snap, out = traced
    buckets, host = expected_pairs(mols, CONS["maxreads"])
    assert set(buckets) == {512, 1024, 2048}
    got = {c["attrs"]["Lc"]: c["value"] for c in snap["counters"]
           if c["name"] == "consensus.pairs"}
    assert got == buckets
    assert host["pairs"] > 0
    for k, v in host.items():
        assert _count(snap, "hostnw." + k) == v, k
    assert _count(snap, "consensus.host_pairs") == host["pairs"]
    assert _count(snap, "consensus.molecules", route="long") == 2
    assert _count(snap, "consensus.molecules", route="n") == 1
    # the route's answers hold to the truths
    nums = ref.judge(out, mols, CONS)
    assert nums["records_wrong"] == nums["short_differing"] == \
        nums["qv_cap_differing"] == 0
    assert nums["long_errors_per_kb"] < 5 and nums["mid_errors_per_kb"] < 5


def test_spans_lie_inside_their_route(traced):
    """`hostnw.align` and then `hostnw.rows`, once each, children of the
    first host route's `consensus.host` span and inside it."""
    _, snap, _ = traced
    by_id = {s["id"]: s for s in snap["spans"]}
    (al,) = [s for s in snap["spans"] if s["name"] == "hostnw.align"]
    (rows,) = [s for s in snap["spans"] if s["name"] == "hostnw.rows"]
    for s in (al, rows):
        host = by_id[s["parent"]]
        assert host["name"] == "consensus.host"
        assert host["attrs"]["route"] == "n"
        assert host["start"] <= s["start"] <= s["end"] <= host["end"]
    assert al["end"] <= rows["start"]
    assert al["attrs"] == {"pairs": _count(snap, "hostnw.pairs"),
                           "launches": 1}
    assert rows["attrs"]["molecules"] == 3


def test_small_slab_makes_several_launches_with_the_same_moves(
        monkeypatch):
    """A slab budget of one pair's score rows cuts two molecules' pairs
    into launches; the moves are one launch's, and the counters add up
    over the launches to the pair table's."""
    mols = molecules({**ROUTES, "molecules": 2, "n_share": 0,
                      "depth_range": [5, 6],
                      "bands": [[0.5, 600, 650], [0.5, 700, 750]]},
                     2**32 + 53)
    reads = [s for r in mols.reads for s in r]
    lens = np.array([len(s) for s in reads])
    seq = np.frombuffer(bytearray(b"".join(reads)), np.uint8)
    off = np.cumsum(lens) - lens
    a = np.array([0, 0, 0, 0, 5, 5, 5, 5])
    b = np.array([1, 2, 3, 4, 6, 7, 8, 9])
    args = (seq, off[a], lens[a], off[b], lens[b])
    whole = hn.align_pairs(*args, "cpu")
    cells = [band_cells(int(lens[i]), int(lens[j])) for i, j in zip(a, b)]
    monkeypatch.setattr(hn, "SLAB_BYTES", 4 * max(cells) + 1)
    before = hn.host_nw_plain.launches
    trace.enable()
    try:
        split = hn.align_pairs(*args, "cpu")
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    launches = hn.host_nw_plain.launches - before
    assert launches >= 4
    for x, y in zip(whole, split):
        np.testing.assert_array_equal(x, y)
    (al,) = [s for s in snap["spans"] if s["name"] == "hostnw.align"]
    assert al["attrs"] == {"pairs": 8, "launches": launches}
    assert _count(snap, "hostnw.pairs") == 8
    assert _count(snap, "hostnw.band_cells") == sum(cells)
    assert _count(snap, "hostnw.move_bytes") == int((lens[a] + lens[b])
                                                    .sum())


def test_benchmark_traced_run_of_the_longcdna_cell():
    """A `--trace 1` run of the cell and of wta, shrunk for the CPU, is
    correct; the cell reports every per-layer metric wta reports, the new
    long-route spans among them. The roofline reads the card's launch
    records, so it is absent from both on the CPU. In a fresh process: the
    harness refuses to run where jax is loaded (tests/conftest.py)."""
    wta = {"molecules": 64, "length": [250, 450],
           "long": {"count": 1, "depth": 3, "length": [2100, 2101]}}
    code = (
        "import json\n"
        "from benchmark.harness import cell\n"
        "out = {}\n"
        f"for w, mix in (({CELL!r}, {ROUTES!r}),\n"
        f"               ('tenx3p_v3.consensus_wta', {wta!r})):\n"
        "    r = cell.run_cell(w, 2**32 + 59, 0.01, True, device='cpu',\n"
        "                      overrides={'mix': mix},\n"
        "                      log=lambda *a, **k: None)\n"
        "    out[w] = {'correct': r['correct'], 'metrics': r['metrics'],\n"
        "              'checks': r['checks']}\n"
        "print(json.dumps(out))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for w, res in out.items():
        assert res["correct"], (w, res["checks"])
        assert "consensus_umis_per_s" not in res["metrics"]
        assert "hostnw_roofline" not in res["metrics"]
    new, wta = out[CELL]["metrics"], out["tenx3p_v3.consensus_wta"]["metrics"]
    assert set(new) == set(wta) >= {"consensus.hostnw_align_ms_per_kumi",
                                    "consensus.hostnw_rows_ms_per_kumi",
                                    "consensus.parse_ms_per_kumi"}
    for m in ("consensus.hostnw_align_ms_per_kumi",
              "consensus.hostnw_rows_ms_per_kumi"):
        assert new[m]["value"] > 0 and wta[m]["value"] > 0
    assert set(out[CELL]["checks"]) == {
        "records_wrong", "short_differing", "qv_cap_differing",
        "errors_per_kb", "worst_error_pct", "mid_errors_per_kb",
        "mid_worst_error_pct", "long_errors_per_kb", "long_worst_error_pct"}
