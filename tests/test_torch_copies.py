"""The port keeps its own copies of the JAX package's jax-free modules.
Each copy is held to its original on seeded inputs, so that the two cannot
drift apart unnoticed."""
import dataclasses

import numpy as np
import pytest

from sicelore_tpu.core import longread as j_longread
from sicelore_tpu.core import molecule as j_molecule
from sicelore_tpu.io import bam as j_bam
from sicelore_tpu.io import bgzf as j_bgzf
from sicelore_tpu.io import fastq as j_fastq
from sicelore_tpu.io import native as j_native
from sicelore_tpu.ops import poa as j_poa
from sicelore_tpu.pipeline import readname as j_readname
from sicelore_tpu.report import html as j_html
from sicelore_tpu.utils import config as j_config
from sicelore_tpu.utils import dna as j_dna
from sicelore_tpu.utils import synth as j_synth
from sicelore_tpu_torch.core import longread as t_longread
from sicelore_tpu_torch.core import molecule as t_molecule
from sicelore_tpu_torch.io import bam as t_bam
from sicelore_tpu_torch.io import bgzf as t_bgzf
from sicelore_tpu_torch.io import fastq as t_fastq
from sicelore_tpu_torch.io import native as t_native
from sicelore_tpu_torch.ops import poa as t_poa
from sicelore_tpu_torch.pipeline import readname as t_readname
from sicelore_tpu_torch.report import html as t_html
from sicelore_tpu_torch.utils import config as t_config
from sicelore_tpu_torch.utils import dna as t_dna
from sicelore_tpu_torch.utils import synth as t_synth


def _seqs(seed, n=20):
    rng = np.random.default_rng(seed)
    out = [j_synth.random_seq(rng, int(rng.integers(0, 90))).encode()
           for _ in range(n)]
    out.append(b"ACGTNNacgtnXY")
    return out


def _check_dna():
    seqs = _seqs(1)
    for s in seqs:
        np.testing.assert_array_equal(t_dna.encode(s), j_dna.encode(s))
        assert t_dna.revcomp_bytes(s) == j_dna.revcomp_bytes(s)
    a, la = t_dna.encode_batch(seqs, 64)
    b, lb = j_dna.encode_batch(seqs, 64)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(t_dna.revcomp(a), j_dna.revcomp(b))
    assert t_dna.decode(a[0]) == j_dna.decode(b[0])
    assert (t_dna.A, t_dna.T, t_dna.N_CODE, t_dna.PAD) == \
        (j_dna.A, j_dna.T, j_dna.N_CODE, j_dna.PAD)


def _check_config():
    assert dataclasses.asdict(t_config.PipelineConfig()) == \
        dataclasses.asdict(j_config.PipelineConfig())
    a, b = t_config.PipelineConfig(), j_config.PipelineConfig()
    a.chemistry = b.chemistry = "5p"
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert t_config.asdict(a) == j_config.asdict(b)
    table = {16: {1: [(1, 5000), (2, 300), (3, 10)], 3: [(1, 900)]}}
    ta, tb = t_config.DynamicEDTable(table), j_config.DynamicEDTable(table)
    for n in (1, 10, 11, 300, 301, 5000, 5001):
        for err in (1, 2, 3):
            assert ta.max_ed(16, err, n) == tb.max_ed(16, err, n)
    assert ta.max_ed(12, 1, 5) == tb.max_ed(12, 1, 5) == 0


def _check_synth():
    for seed in (3, 4):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        wa, wb = t_synth.make_whitelist(ra, 8), j_synth.make_whitelist(rb, 8)
        assert wa == wb
        for fn in ("make_read", "make_read_5p"):
            assert getattr(t_synth, fn)(ra, wa[0], cdna_len=200,
                                        error_rate=0.05, reverse=True) == \
                getattr(j_synth, fn)(rb, wb[0], cdna_len=200,
                                     error_rate=0.05, reverse=True)
        assert t_synth.make_chimera(ra, wa[1], wa[2], cdna_len=90) == \
            j_synth.make_chimera(rb, wb[1], wb[2], cdna_len=90)
        assert t_synth.mutate(ra, "ACGT" * 40, 0.1) == \
            j_synth.mutate(rb, "ACGT" * 40, 0.1)


def _check_readname():
    rng = np.random.default_rng(2)
    for split_part, tso_end in ((0, None), (2, 14)):
        kw = dict(is_fwd=bool(rng.integers(0, 2)), ps=int(rng.integers(900)),
                  pe=int(rng.integers(900)), ae=int(rng.integers(900)),
                  bc=j_synth.random_seq(rng, 16), ed=1, ed_sec=3,
                  bc_start=40, bc_end=56, rank=7,
                  x_seq=j_synth.random_seq(rng, 12).encode(), x_qv=17.25,
                  tso_end=tso_end, split_part=split_part)
        a = t_readname.encode_name(b"read_1", **kw)
        assert a == j_readname.encode_name(b"read_1", **kw)
        ia, ib = t_readname.parse_name(a), j_readname.parse_name(a)
        assert ia is not None and ia.is_split == (split_part >= 2)
        assert dataclasses.asdict(ia) == dataclasses.asdict(ib)
    assert t_readname.parse_name(b"plain") is None
    assert j_readname.parse_name(b"plain") is None


def _check_fastq(tmp_path):
    rng = np.random.default_rng(5)
    path = tmp_path / "r.fastq"
    with open(path, "wb") as fh:
        for i in range(37):
            s = j_synth.random_seq(rng, int(rng.integers(1, 200))).encode()
            fh.write(b"@r%d extra\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
    ca = list(t_fastq.read_fastq(path, 10))
    cb = list(j_fastq.read_fastq(path, 10))
    assert len(ca) == len(cb) == 4
    for x, y in zip(ca, cb):
        assert (x.names, x.seqs, x.quals) == (y.names, y.seqs, y.quals)


def _records(mod, rng):
    recs = []
    for i in range(40):
        n = int(rng.integers(1, 120))
        recs.append(mod.BamRecord(
            qname=f"q{i}", flag=16 * (i % 2), ref_id=0, pos=100 + 7 * i,
            mapq=int(rng.integers(0, 61)), cigar=[("S", 3), ("M", n)],
            seq=j_synth.random_seq(rng, n + 3), qual=bytes([20]) * (n + 3),
            tags=[("BC", "Z", "ACGT"), ("RN", "i", i),
                  ("de", "f", 0.015625 * i)]))
    return recs


def _check_bam(tmp_path):
    """BGZF/BAM round trip: each side's writer gives the same bytes, and
    each side's reader reads the other's file back."""
    hdr = ("@SQ\tSN:chr1\tLN:100000\n", [("chr1", 100000)])
    paths = {}
    for name, mod in (("t", t_bam), ("j", j_bam)):
        paths[name] = tmp_path / f"{name}.bam"
        with mod.BamWriter(paths[name], mod.BamHeader(*hdr)) as w:
            for r in _records(mod, np.random.default_rng(6)):
                w.write(r)
    assert paths["t"].read_bytes() == paths["j"].read_bytes()
    with t_bam.BamReader(paths["j"]) as ra, j_bam.BamReader(paths["t"]) as rb:
        a, b = list(ra), list(rb)
    assert len(a) == len(b) == 40
    for x, y in zip(a, b):
        for f in ("qname", "flag", "pos", "mapq", "cigar", "seq", "qual",
                  "tags"):
            assert getattr(x, f) == getattr(y, f), f
    blob = bytes(np.random.default_rng(7).integers(0, 256, 200_000,
                                                   dtype=np.uint8))
    for name, mod in (("t", t_bgzf), ("j", j_bgzf)):
        with mod.BGZFWriter(tmp_path / f"{name}.bgzf") as w:
            w.write(blob)
    assert (tmp_path / "t.bgzf").read_bytes() == \
        (tmp_path / "j.bgzf").read_bytes()
    with t_bgzf.BGZFReader(tmp_path / "j.bgzf") as r:
        assert r.read(len(blob) + 10) == blob


def _check_molecules(tmp_path):
    """LongreadParser + MoleculeDataset over one tagged BAM."""
    rng = np.random.default_rng(8)
    mols, _ = t_synth.molecule_set(rng, 5, 3, 0.05, 80)
    path = tmp_path / "m.bam"
    with t_bam.BamWriter(path, t_bam.BamHeader(
            "@SQ\tSN:chr1\tLN:100000\n", [("chr1", 100000)])) as w:
        for r in t_synth.tagged_records(mols, rng):
            w.write(r)
    out = []
    for lr_mod, mol_mod in ((t_longread, t_molecule),
                            (j_longread, j_molecule)):
        parser = lr_mod.LongreadParser(path, load_sequence=True,
                                       gene_mandatory=False)
        ds = mol_mod.MoleculeDataset(parser)
        out.append((dataclasses.asdict(parser.stats),
                    [(m.barcode, m.umi,
                      [lr.best_record().cdna for lr in m.longreads])
                     for m in ds.molecules.values()]))
    assert out[0] == out[1] and len(out[0][1]) == 5


def _check_poa():
    rng = np.random.default_rng(9)
    mols, _ = t_synth.molecule_set(rng, 2, 4, 0.08, 90)
    for seqs in mols + [mols[0][:2], mols[0][:1], []]:
        assert t_poa.consensus_reads(seqs, 3, 20) == \
            j_poa.consensus_reads(seqs, 3, 20)


def _check_native():
    assert (t_native.get_hostenc() is None) == (j_native.get_hostenc() is None)
    assert t_native._NATIVE_DIR == j_native._NATIVE_DIR
    assert (t_native._NATIVE_DIR / "Makefile").exists()


def _check_html():
    d = {"reads": 1234, "rate": 0.5, "name": "x<y"}
    assert t_html.stats_table(d) == j_html.stats_table(d)
    bars = (["a", "b", "c"], [3.0, 1.5, 0.0])
    assert t_html.svg_bars(*bars, title="t", ylabel="y") == \
        j_html.svg_bars(*bars, title="t", ylabel="y")
    counts = sorted(np.random.default_rng(10).integers(1, 5000, 300).tolist(),
                    reverse=True)
    assert t_html.knee_plot(counts) == j_html.knee_plot(counts)


CHECKS = {
    "dna": _check_dna, "config": _check_config, "synth": _check_synth,
    "readname": _check_readname, "fastq": _check_fastq, "bam": _check_bam,
    "molecules": _check_molecules, "poa": _check_poa,
    "native": _check_native, "html": _check_html,
}


@pytest.mark.parametrize("module", sorted(CHECKS))
def test_copy_matches_original(module, tmp_path):
    import inspect

    fn = CHECKS[module]
    if inspect.signature(fn).parameters:
        fn(tmp_path)
    else:
        fn()
