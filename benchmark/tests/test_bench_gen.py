"""The traffic generators: exact repeats from a seed, the mix's shares, the
packed whitelist, and the BAM writer read back by the port's reader."""
import numpy as np
import pytest

from benchmark.gen import molecules as gm
from benchmark.gen import reads as gr
from benchmark.harness.cell import BENCH, load_json

SCAN = load_json(BENCH / "traffic" / "scan.json")["mix"]


def _reads(seed, n=4000, with_truth=False):
    rng = np.random.default_rng(seed)
    cells = gr.whitelist(rng, 64)
    return gr.make_reads(rng, n, cells, SCAN, "3p", with_truth), cells


def test_reads_repeat_from_seed():
    a, _ = _reads(2**33 + 5)
    b, _ = _reads(2**33 + 5)
    c, _ = _reads(2**33 + 6)
    assert a == b
    assert a[1] != c[1]


def test_truth_is_what_the_names_say():
    (names, seqs, quals, t), cells = _reads(2**33 + 7, with_truth=True)
    assert (names, seqs, quals) == _reads(2**33 + 7)[0]
    for i, nm in enumerate(names):
        kind = "rrxg"[int(t.kind[i])]
        assert nm.startswith(kind.encode() + str(i).encode())
        if kind == "r":
            assert nm.endswith(b"c%d" % t.cell[i])
        assert (t.cell2[i] >= 0) == (kind == "x")
        assert not (t.rev[i] and kind in "xg")
    # a molecule read forward holds its cell's barcode reverse-complemented
    bc = gr.unpack(cells[t.cell])
    fwd = [i for i in range(len(names)) if t.kind[i] == 0 and not t.rev[i]]
    rc = [gr.revcomp(bc[i]).tobytes() for i in fwd]
    assert np.mean([r in seqs[i] for r, i in zip(rc, fwd)]) > 0.3


def test_other_chemistries_are_refused():
    rng = np.random.default_rng(1)
    with pytest.raises(ValueError):
        gr.make_reads(rng, 10, gr.whitelist(rng, 4), SCAN, "5p")


def test_reads_hit_the_mix():
    (names, seqs, quals), _ = _reads(7, n=20000)
    n = len(names)
    kinds = [nm[:1] for nm in names]
    assert abs(kinds.count(b"x") / n - SCAN["shares"]["chimera"]) < 0.005
    assert abs(kinds.count(b"g") / n - SCAN["shares"]["garbage"]) < 0.005
    lens = np.array([len(s) for s, k in zip(seqs, kinds) if k == b"r"])
    long_share = (lens > 1800).mean() * (1 - 0.04)
    assert abs(long_share - SCAN["shares"]["long"]) < 0.01
    assert all(len(s) == len(q) for s, q in zip(seqs, quals))
    with_n = np.mean([b"N" in s for s in seqs])
    assert 0.006 < with_n < 0.014
    # 3p molecules read forward start with the TSO, reversed ones with the
    # adapter's reverse complement's complement
    fwd = np.mean([s.startswith(gr.TSO[:10]) for s, k in zip(seqs, kinds)
                   if k == b"r"])
    assert 0.3 < fwd < 0.55


def test_whitelist_packing_matches_the_port():
    from sicelore_tpu_torch.utils import dna
    wl = gr.whitelist(np.random.default_rng(3), 5000)
    assert len(np.unique(wl)) == 5000 and (np.diff(wl.astype(np.int64)) > 0).all()
    asc = gr.unpack(wl[:50])
    for w, row in zip(wl[:50], asc):
        assert dna.unpack_kmer(int(w), 16) == row.tobytes().decode()


CONS = load_json(BENCH / "traffic" / "consensus_wta.json")["mix"]


def test_molecules_repeat_and_hit_the_mix():
    mix = {**CONS, "molecules": 4000}
    a = gm.make_molecules(np.random.default_rng(11), mix)
    b = gm.make_molecules(np.random.default_rng(11), mix)
    assert a == b
    depth = np.array([len(r) for r in a.reads])
    assert abs((depth == 1).mean() - 0.5) < 0.03
    assert abs((depth == 2).mean() - 0.2) < 0.03
    assert depth[-4:].tolist() == [3] * 4
    assert all(len(r[0]) > 1900 for r in a.reads[-4:])
    assert len(set(zip(a.bcs, a.umis))) == len(a.bcs)
    assert all(2100 <= len(t) < 2300 for t in a.truths[-4:])
    assert all(400 <= len(t) < 900 for t in a.truths[:-4])


def test_molecules_every_seed_the_same_work():
    mix = {**CONS, "molecules": 4000}

    def work(seed):
        m = gm.make_molecules(np.random.default_rng(seed), mix)
        return m, sorted((len(r), len(t), len(r) > 1 and b"N" in r[1])
                         for r, t in zip(m.reads, m.truths))
    (a, wa), (b, wb) = work(2**31 + 3), work(2**31 + 4)
    assert wa == wb
    assert a.truths != b.truths and a.reads != b.reads
    regular_deep = sum(d > 2 for d, *_ in wa) - CONS["long"]["count"]
    assert sum(n for *_, n in wa) == round(CONS["n_share"] * regular_deep)


def test_bam_reads_back_through_the_port(tmp_path):
    from sicelore_tpu_torch.core.longread import LongreadParser
    mix = {**CONS, "molecules": 300}
    mols = gm.make_molecules(np.random.default_rng(5), mix)
    gm.write_molecules(tmp_path / "t.bam", mols)
    p = LongreadParser(tmp_path / "t.bam", load_sequence=True,
                       gene_mandatory=False)
    assert p.stats.valid_records == mols.n_records
    for m in (0, 150, 299):
        for r, (seq, de) in enumerate(zip(mols.reads[m], mols.des[m])):
            lr = p.reads[f"m{m}r{r}"]
            assert (lr.barcode, lr.umi) == (mols.bcs[m], mols.umis[m])
            assert lr.best_record().cdna == seq
            assert lr.best_record().de == de
