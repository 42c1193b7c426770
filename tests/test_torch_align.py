"""The spliced aligner: the port's `NativeAligner(device="cpu")` (the band
kernel's plain version for the gap extension) against the JAX package's
`NativeAligner(use_device=False)` (the Pallas kernel in interpret mode) on
tests/test_align.py's cases, all in one batch: records equal field by
field. The JAX batch runs once for the module."""
import numpy as np
import pytest

from sicelore_tpu.align import NativeAligner as JaxAligner
from sicelore_tpu_torch.align import NativeAligner
from sicelore_tpu_torch.align import extend
from sicelore_tpu_torch.ops import poa_cuda
from sicelore_tpu_torch.utils import dna, synth

FIELDS = ("qname", "flag", "ref_id", "pos", "mapq", "cigar", "seq", "qual",
          "tags")


def make_genome():
    """tests/test_align.py's two contigs, and a third holding an N run (an
    assembly gap) that a read's gap crosses."""
    rng = np.random.default_rng(100)
    g = {"chrT": synth.random_seq(rng, 120_000).encode(),
         "chrU": synth.random_seq(rng, 40_000).encode()}
    n = bytearray(synth.random_seq(rng, 30_000).encode())
    n[12_000:12_006] = b"NNNNNN"
    g["chrN"] = bytes(n)
    return g


def case_reads(genome):
    """{case: [(name, read)]} for tests/test_align.py's cases."""
    g, u, nn = genome["chrT"], genome["chrU"], genome["chrN"]
    cases = {
        "exact": [(b"r1", g[10_000:10_800])],
        "reverse": [(b"r2", dna.revcomp_bytes(g[30_000:30_600]))],
        "second_contig": [(b"r3", u[5_000:5_500])],
    }
    s = 50_000
    cases["spliced"] = [(b"sp", g[s:s + 400] + g[s + 1_900:s + 2_200]
                         + g[s + 6_200:s + 6_550])]
    rng = np.random.default_rng(7)
    noisy = []
    for i in range(24):
        pos = int(rng.integers(1000, 100_000))
        read = synth.mutate(rng, g[pos:pos + int(rng.integers(400, 1200))]
                            .decode(), 0.05).encode()
        noisy.append((b"n%d" % i, dna.revcomp_bytes(read) if i % 2
                      else read))
    cases["noisy"] = noisy
    cases["garbage"] = [(b"g", synth.random_seq(np.random.default_rng(8),
                                                700).encode())]
    md = bytearray(g[s:s + 800])
    for p in (100, 333, 507):
        md[p] = b"ACGT"[(b"ACGT".index(md[p:p + 1]) + 1) % 4]
    cases["md_tag"] = [(b"md", bytes(md))]
    cases["supplementary"] = [(b"fus", g[20_000:20_900] + u[20_000:20_900])]
    # the read carries bases where the genome has the N run, and a 3-base
    # deletion beside it: its anchor gap holds N, so the JAX package
    # emits plain I+D runs there and never the band alignment
    ndel = nn[11_400:11_990] + nn[11_993:12_000] + b"ACGTAC" \
        + nn[12_006:12_700]
    cases["n_run_gap"] = [(b"nrun", ndel),
                          (b"nrun_rc", dna.revcomp_bytes(ndel))]
    return cases


@pytest.fixture(scope="module")
def genome():
    return make_genome()


@pytest.fixture(scope="module")
def batch(genome):
    """Every case in one batch through both aligners (one gap batch)."""
    cases = case_reads(genome)
    names = [n for v in cases.values() for n, _ in v]
    reads = [r for v in cases.values() for _, r in v]
    want = JaxAligner(genome, use_device=False).align_batch(names, reads)
    before = (poa_cuda.band_align_plain.launches,
              poa_cuda.band_align.launches)
    got = NativeAligner(genome, device="cpu").align_batch(names, reads)
    launches = (poa_cuda.band_align_plain.launches - before[0],
                poa_cuda.band_align.launches - before[1])
    return cases, want, got, launches


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.qname, []).append(r)
    return out


@pytest.mark.parametrize("case", ["exact", "reverse", "second_contig",
                                  "spliced", "noisy", "garbage", "md_tag",
                                  "supplementary", "n_run_gap"])
def test_records_equal_jax(batch, case):
    cases, want, got, _ = batch
    w, g = _by_name(want), _by_name(got)
    for name, _ in cases[case]:
        name = name.decode()
        assert len(g[name]) == len(w[name])
        for x, y in zip(g[name], w[name]):
            for f in FIELDS:
                assert getattr(x, f) == getattr(y, f), (name, f)
    first = g[cases[case][0][0].decode()]
    if case == "garbage":
        assert first[0].flag & 4
    elif case == "supplementary":
        assert any(r.flag & 0x800 for r in first)
    else:
        assert not first[0].flag & 4
    if case == "spliced":
        assert [op for op, _ in first[0].cigar].count("N") == 2


def test_gap_batch_ran_the_band_version(batch):
    """The CPU aligner ran the band kernel's plain version (one call a
    length bucket) and never the kernel wrapper's CUDA path."""
    _, _, _, (plain, kernel) = batch
    assert plain >= 1 and kernel == 0


def test_n_run_gap_takes_plain_ops(genome):
    """The N screen holds: the gap that holds N is never aligned by the
    band kernel (it would place the 3-base deletion elsewhere)."""
    cases = case_reads(genome)
    b = extend.GapBatcher("cpu")
    R = genome["chrN"][11_980:12_020]
    Q = cases["n_run_gap"][0][1][570:607]
    assert b"N" in R and not b.feasible(R, Q)
    assert b.feasible(R.replace(b"N", b"A"), Q)
