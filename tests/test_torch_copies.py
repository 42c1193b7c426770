"""The port keeps its own copies of the JAX package's jax-free modules.
Each copy is held to its original on seeded inputs, so that the two cannot
drift apart unnoticed."""
import dataclasses

import numpy as np
import pytest

from sicelore_tpu.align import chain as j_chain
from sicelore_tpu.core import collapse as j_collapse
from sicelore_tpu.align import index as j_index
from sicelore_tpu.core import genetag as j_genetag
from sicelore_tpu.core import longread as j_longread
from sicelore_tpu.core import molecule as j_molecule
from sicelore_tpu.io import bam as j_bam
from sicelore_tpu.io import bed as j_bed
from sicelore_tpu.io import bgzf as j_bgzf
from sicelore_tpu.io import fastq as j_fastq
from sicelore_tpu.io import native as j_native
from sicelore_tpu.io import sam as j_sam
from sicelore_tpu.ops import editdist as j_editdist
from sicelore_tpu.ops import poa as j_poa
from sicelore_tpu.pipeline import annotate as j_annotate
from sicelore_tpu.pipeline import collapsemodel as j_collapsemodel
from sicelore_tpu.pipeline import illumina as j_illumina
from sicelore_tpu.pipeline import isoform as j_isoform
from sicelore_tpu.pipeline import mergestats as j_mergestats
from sicelore_tpu.pipeline import programs as j_programs
from sicelore_tpu.pipeline import programs2 as j_programs2
from sicelore_tpu.pipeline import qc as j_qc
from sicelore_tpu.pipeline import readname as j_readname
from sicelore_tpu.pipeline import snp_fusion as j_snp_fusion
from sicelore_tpu.report import html as j_html
from sicelore_tpu.utils import config as j_config
from sicelore_tpu.utils import dna as j_dna
from sicelore_tpu.utils import synth as j_synth
from sicelore_tpu_torch.align import chain as t_chain
from sicelore_tpu_torch.core import collapse as t_collapse
from sicelore_tpu_torch.align import index as t_index
from sicelore_tpu_torch.core import genetag as t_genetag
from sicelore_tpu_torch.core import longread as t_longread
from sicelore_tpu_torch.core import molecule as t_molecule
from sicelore_tpu_torch.io import bam as t_bam
from sicelore_tpu_torch.io import bed as t_bed
from sicelore_tpu_torch.io import bgzf as t_bgzf
from sicelore_tpu_torch.io import fastq as t_fastq
from sicelore_tpu_torch.io import native as t_native
from sicelore_tpu_torch.io import sam as t_sam
from sicelore_tpu_torch.ops import editdist as t_editdist
from sicelore_tpu_torch.ops import poa as t_poa
from sicelore_tpu_torch.pipeline import annotate as t_annotate
from sicelore_tpu_torch.pipeline import collapsemodel as t_collapsemodel
from sicelore_tpu_torch.pipeline import illumina as t_illumina
from sicelore_tpu_torch.pipeline import isoform as t_isoform
from sicelore_tpu_torch.pipeline import mergestats as t_mergestats
from sicelore_tpu_torch.pipeline import programs as t_programs
from sicelore_tpu_torch.pipeline import programs2 as t_programs2
from sicelore_tpu_torch.pipeline import qc as t_qc
from sicelore_tpu_torch.pipeline import readname as t_readname
from sicelore_tpu_torch.pipeline import snp_fusion as t_snp_fusion
from sicelore_tpu_torch.report import html as t_html
from sicelore_tpu_torch.utils import config as t_config
from sicelore_tpu_torch.utils import dna as t_dna
from sicelore_tpu_torch.utils import synth as t_synth
from test_torch_cli import host_inputs


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


def _genome(seed):
    rng = np.random.default_rng(seed)
    g = {"c1": j_synth.random_seq(rng, 30_000).encode(),
         "c2": j_synth.random_seq(rng, 8_000).encode()}
    reads = []
    for i in range(12):
        src = g["c1"] if i % 3 else g["c2"]
        p = int(rng.integers(0, len(src) - 900))
        r = j_synth.mutate(rng, src[p:p + int(rng.integers(200, 900))]
                           .decode(), 0.05).encode()
        reads.append(t_dna.revcomp_bytes(r) if i % 2 else r)
    reads.append(g["c1"][1000:1400] + g["c1"][5000:5400])   # spliced
    reads.append(b"ACGTN" * 40)
    return g, reads


def _without_hostenc(monkeypatch):
    monkeypatch.setattr(t_native, "get_hostenc", lambda: None)
    monkeypatch.setattr(j_native, "get_hostenc", lambda: None)


def _check_index(tmp_path, monkeypatch, native: bool = True):
    if not native:
        _without_hostenc(monkeypatch)
    g, reads = _genome(11)
    for s in reads + [g["c2"]]:
        for a, b in zip(t_index.minimizers(s), j_index.minimizers(s)):
            np.testing.assert_array_equal(a, b)
    ta, ja = t_index.MinimizerIndex(g), j_index.MinimizerIndex(g)
    for f in ("h", "p", "s", "offsets"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f))
    assert ta.contig_of(30_100 + t_index.GUARD) == \
        ja.contig_of(30_100 + j_index.GUARD)
    ta.save(tmp_path / "t.npz")
    tb = t_index.MinimizerIndex.load(tmp_path / "t.npz")
    for a, b in zip(tb.lookup(ja.h[:50]), ja.lookup(ja.h[:50])):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "g.fa").write_bytes(b">x desc\nacgtNN\nAC\n>y\nGG\n")
    assert t_index.load_fasta(tmp_path / "g.fa") == \
        j_index.load_fasta(tmp_path / "g.fa")


def _check_chain(monkeypatch, native: bool = True):
    if not native:
        _without_hostenc(monkeypatch)
    g, reads = _genome(12)
    ti, ji = t_index.MinimizerIndex(g), j_index.MinimizerIndex(g)
    for s in reads:
        a, b = t_chain.best_chains(s, ti), j_chain.best_chains(s, ji)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x[:3] == y[:3]
            np.testing.assert_array_equal(x[3], y[3])
            np.testing.assert_array_equal(x[4], y[4])
            assert t_chain.mapq(x[0], x[1]) == j_chain.mapq(y[0], y[1])
        for st, (q, gg) in t_chain.read_anchors(s, ti).items():
            f1, p1 = t_chain._chain_dp(q, gg, 15)
            f2, p2 = j_chain._chain_dp(q, gg, 15)
            np.testing.assert_array_equal(f1, f2)
            np.testing.assert_array_equal(p1, p2)
            assert [(c[0], c[1].tolist()) for c in
                    t_chain.extract_chains(f1, p1)] == \
                [(c[0], c[1].tolist()) for c in j_chain.extract_chains(f2, p2)]


def _refflat(tmp_path):
    p = tmp_path / "g.refflat"
    p.write_text(
        "GA\tTA1\tchr1\t+\t100\t900\t150\t800\t2\t100,500,\t300,900,\n"
        "GA\tTA2\tchr1\t+\t100\t900\t100\t100\t1\t100,\t900,\n"
        "GB\tTB\tchr1\t-\t600\t2000\t700\t1900\t2\t600,1500,\t"
        "1000,2000,\n"
        "GC\tTC\tchr2\t+\t10\t500\t10\t500\t1\t10,\t500,\n")
    return p


def _check_genetag(tmp_path):
    from sicelore_tpu.core.refflat import RefFlatModel as JModel
    from sicelore_tpu_torch.core.refflat import RefFlatModel as TModel
    p = _refflat(tmp_path)
    ta = t_genetag.GeneTagger(TModel.load(p))
    ja = j_genetag.GeneTagger(JModel.load(p))
    rng = np.random.default_rng(13)
    for _ in range(200):
        chrom = ("chr1", "chr2", "chr3")[int(rng.integers(0, 3))]
        s = int(rng.integers(1, 2100))
        blocks = [(s, s + int(rng.integers(1, 300)))]
        if rng.random() < 0.5:
            s2 = blocks[0][1] + int(rng.integers(50, 600))
            blocks.append((s2, s2 + int(rng.integers(1, 200))))
        strand = (None, "+", "-")[int(rng.integers(0, 3))]
        assert ta.annotate(chrom, blocks, strand) == \
            ja.annotate(chrom, blocks, strand)
        assert ta.tag(chrom, blocks, strand) == ja.tag(chrom, blocks, strand)


def _check_sam(tmp_path):
    hdr = ("@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:100000\n", [("chr1", 100000)])
    bam = tmp_path / "r.bam"
    with t_bam.BamWriter(bam, t_bam.BamHeader(*hdr)) as w:
        for r in _records(t_bam, np.random.default_rng(14)):
            w.write(r)
    assert t_sam.bam_to_sam(bam, tmp_path / "t.sam") == \
        j_sam.bam_to_sam(bam, tmp_path / "j.sam") == 40
    assert (tmp_path / "t.sam").read_bytes() == \
        (tmp_path / "j.sam").read_bytes()
    t_sam.sam_to_bam(tmp_path / "t.sam", tmp_path / "t2.bam")
    j_sam.sam_to_bam(tmp_path / "t.sam", tmp_path / "j2.bam")
    assert (tmp_path / "t2.bam").read_bytes() == \
        (tmp_path / "j2.bam").read_bytes()


def _check_illumina(tmp_path):
    hdr = t_bam.BamHeader("@SQ\tSN:chr1\tLN:100000\n", [("chr1", 100000)])
    p = tmp_path / "ill.bam"
    with t_bam.BamWriter(p, hdr) as w:
        for i, (cb, ub, gn, fl) in enumerate([
                ("CELL1-1", "AAACCCGGG", "GENEA", 0),
                ("CELL1-1", "TTTTTTTTT", "GENEA", 16),
                ("CELL2-1", "CCCCCCCCC", None, 0)]):
            tags = [("CB", "Z", cb), ("UB", "Z", ub)]
            if gn:
                tags.append(("GN", "Z", gn))
            w.write(t_bam.BamRecord(qname=f"i{i}", flag=fl, ref_id=0,
                                    pos=100 * i, mapq=60, cigar=[("M", 4)],
                                    seq="ACGT", qual=b"\x28" * 4, tags=tags))
    for name, mod in (("t", t_illumina), ("j", j_illumina)):
        (tmp_path / name).mkdir()
        mod.parse_illumina_bam(p, tmp_path / name / "tab.json.gz")
    ta = t_illumina.GuidedUmiTable(tmp_path / "t" / "tab.json.gz")
    ja = j_illumina.GuidedUmiTable(tmp_path / "j" / "tab.json.gz")
    for umi in (b"AAACCCGGT", b"AAACCCGTT", b"GGGGGGAAA"):
        assert ta.snap("GENEA", "CELL1", umi, max_ed=1) == \
            ja.snap("GENEA", "CELL1", umi, max_ed=1)
    for q in (b"CELL1", b"CELL2", b"CELLX"):
        assert ta.guided_bc(q, contig="chr1", pos3=150) == \
            ja.guided_bc(q, contig="chr1", pos3=150)


def _check_programs(tmp_path):
    """tagbamwithread, the step between assignumis and computeconsensus."""
    hdr = t_bam.BamHeader("@SQ\tSN:chr1\tLN:100000\n", [("chr1", 100000)])
    bam = tmp_path / "in.bam"
    recs = _records(t_bam, np.random.default_rng(15))
    with t_bam.BamWriter(bam, hdr) as w:
        for r in recs:
            w.write(r)
    (tmp_path / "fq").mkdir()
    with open(tmp_path / "fq" / "a.fastq", "wb") as fh:
        for r in recs[::2]:
            fh.write(b"@%s\n%s\n+\n%s\n" % (r.qname.encode(), r.seq.encode(),
                                             b"I" * len(r.seq)))
    a = t_programs.tag_bam_with_read(bam, tmp_path / "t.bam", tmp_path / "fq")
    b = j_programs.tag_bam_with_read(bam, tmp_path / "j.bam", tmp_path / "fq")
    assert a == b == {"records": 40, "tagged": 20}
    assert (tmp_path / "t.bam").read_bytes() == \
        (tmp_path / "j.bam").read_bytes()



# -- the copies of the host programs: inputs from a small run of the port
# (tests/test_torch_cli.py's host_inputs) --


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return host_inputs(tmp_path_factory.mktemp("host"))


class Out(str):
    """An output name, made a path under each package's own directory."""


def _tree(d):
    return {str(f.relative_to(d)): f.read_bytes()
            for f in sorted(d.rglob("*")) if f.is_file()}


def _same(tmp_path, tag, fn_t, fn_j, *args, **kw):
    """fn_t and fn_j on the same inputs, each writing its outputs (the Out
    arguments) under a directory of its own: the same return value and the
    same files, which must not be none unless the function writes none."""
    got = {}
    for side, fn in (("t", fn_t), ("j", fn_j)):
        d = tmp_path / tag / side
        d.mkdir(parents=True)

        def place(x, d=d):
            return d / x if isinstance(x, Out) else x
        res = fn(*[place(a) for a in args],
                 **{k: place(v) for k, v in kw.items()})
        got[side] = (res, _tree(d))
    assert got["t"] == got["j"], tag
    return got["t"]


def _check_bed(host):
    ta, ja = t_bed.BedModel.load(host["cage"]), j_bed.BedModel.load(
        host["cage"])
    tb, jb = t_bed.BedModel.load(host["polya"]), j_bed.BedModel.load(
        host["polya"])
    assert (ta.entries, tb.entries) == (ja.entries, jb.entries) != (0, 0)
    rng = np.random.default_rng(21)
    for _ in range(300):
        q = (("chr1", "chr2", "chr9")[int(rng.integers(0, 3))],
             "+-"[int(rng.integers(0, 2))], int(rng.integers(0, 240_000)))
        assert ta.distance(*q) == ja.distance(*q)
        assert tb.distance(*q) == jb.distance(*q)


def _check_collapse(host, tmp_path):
    """CollapsedModel step by step: collapse, initialize, filter, classify,
    validate against the CAGE and polyA BEDs and the short-read BAM,
    statistics, export."""
    from sicelore_tpu.core.matrix import load_cell_list
    from sicelore_tpu.core.refflat import RefFlatModel as JModel
    from sicelore_tpu_torch.core.refflat import RefFlatModel as TModel

    def run(mod, bed, refmodel, out):
        m = mod.CollapsedModel(refmodel.load(host["refflat"]), delta=2,
                               min_evidence=1, rn_min=1)
        m.load_isobam(host["isobam"], set(load_cell_list(host["cells"])))
        m.collapse()
        m.initialize()
        m.filter()
        m.classify()
        m.validate(bed.BedModel.load(host["cage"]),
                   bed.BedModel.load(host["polya"]), host["sorted"], 40, 40,
                   1)
        m.export(out, "cm")
        return m.statistics()
    stats, files = _same(tmp_path, "collapse",
                         lambda out: run(t_collapse, t_bed, TModel, out),
                         lambda out: run(j_collapse, j_bed, JModel, out),
                         Out("o"))
    assert stats["isoforms"] > 0 and len(files) >= 4


def _check_isoform(host, tmp_path):
    for tag, kw in (("iso", {"isobam": True}),
                    ("iso_opts", {"delta": 5, "ambiguous_assign": True,
                                  "mapqv0": True, "tobulk": True,
                                  "prefix": "p"})):
        log, files = _same(tmp_path, tag, t_isoform.isoform_matrix,
                           j_isoform.isoform_matrix, host["umi"],
                           host["refflat"], host["cells"], Out("o"), **kw)
        assert log["molecules"] > 0 and len(files) >= 8


def _check_collapsemodel(host, tmp_path):
    stats, files = _same(
        tmp_path, "cm", t_collapsemodel.collapse_model,
        j_collapsemodel.collapse_model, host["isobam"], host["refflat"],
        host["cells"], Out("o"), min_evidence=1, cage_bed=host["cage"],
        polya_bed=host["polya"], short_bam=host["sorted"])
    assert stats["isoforms"] > 0 and len(files) == 6


def _check_snp_fusion(host, tmp_path):
    assert t_snp_fusion.parse_snp_descriptors(host["snp"]) == \
        j_snp_fusion.parse_snp_descriptors(host["snp"])
    cigar = [("S", 5), ("M", 40), ("D", 3), ("M", 10), ("N", 200),
             ("I", 2), ("M", 30)]
    for ref_pos in range(95, 400, 3):
        assert t_snp_fusion.read_pos_at_ref(cigar, 100, ref_pos) == \
            j_snp_fusion.read_pos_at_ref(cigar, 100, ref_pos)
    r, _ = _same(tmp_path, "snp", t_snp_fusion.snp_matrix,
                 j_snp_fusion.snp_matrix, host["umi"], host["snp"],
                 host["cells"], Out("o"), "s", 1, 5)
    assert r["hits"] > 0
    r, _ = _same(tmp_path, "fus", t_snp_fusion.fusion_detector,
                 j_snp_fusion.fusion_detector, host["fusion"], host["cells"],
                 Out("o"), min_report=1)
    assert r["fusions"] > 0 and r["reported"]


def _check_annotate(host, tmp_path):
    cases = (
        ("model", "annotate_model", (host["model"], host["sorted"],
                                     host["cage"], host["polya"],
                                     Out("a.txt"))),
        ("junc", "junction_validator", (host["junctions"], host["refflat"],
                                        Out("j.tsv"), host["sorted"])),
        ("snp3p", "snp_matrix_3pend", (host["isobam"], host["snp"],
                                       host["refflat"], Out("s.tsv"))),
        ("isobam", "isobam", (host["umi"], host["molinfos"],
                              Out("i.bam"))),
        ("isobam_def", "isobam", (host["umi"], host["molinfos"],
                                  Out("i.bam"), False)),
        ("addisobam", "add_isobam", (host["umi"], host["refflat"],
                                     Out("a.bam"))))
    for tag, name, args in cases:
        r, files = _same(tmp_path, tag, getattr(t_annotate, name),
                         getattr(j_annotate, name), *args)
        assert files and r, tag


def _check_programs2(host, tmp_path):
    h = host
    cases = (
        ("select_valid_cell_barcode", (h["assigned"], Out("c.csv"), 2,
                                       0.5)),
        ("filter_bam_mf", (h["umi"], Out("o.bam"), h["cells"])),
        ("filter_molecule_bam", (h["named"], Out("o.bam"), 2)),
        ("filter_molecule_bam", (h["isobam"], Out("o.bam"), 1, True)),
        ("add_label_to_barcode", (h["umi"], Out("o.bam"), "LAB")),
        ("clean_usuq", (h["us"], Out("o.bam"))),
        ("split_bam", (h["umi"], Out("o"), h["ids"])),
        ("split_bam_per_cluster", (h["umi"], Out("o"), h["clusters"])),
        ("split_bam_per_stage", (h["stage"], Out("o"), h["stages"])),
        ("molecule_counter", (h["umi"],)),
        ("export_umifound_records", (h["umi"], Out("o.bam"))),
        ("export_molecule_reads", (h["us"], h["mols"], Out("o.fastq"))),
        ("export_metrics", (h["umi"], h["cells"], Out("m.txt"),
                            Out("c.txt"), "BC", "U8", "GE")),
        ("add_reads_to_molecules", (h["umi"], h["targeted"],
                                    Out("o.bam"))),
        ("haplotype_caller", (h["isobam"], Out("o"))),
        ("junction_annotate", (h["refflat"], h["genome"], Out("j.tsv"))),
        ("crispr_stats", (h["umi"], Out("h.txt"), Out("d.txt"), 1,
                          h["coord"])),
        ("parse_fastq_cdna", (h["passed"], Out("o"), 10, 5)),
        ("parse_tr_stats", (h["parse"], h["parse_csv"], Out("o"))))
    for i, (name, args) in enumerate(cases):
        r, files = _same(tmp_path, f"{i}_{name}", getattr(t_programs2, name),
                         getattr(j_programs2, name), *args)
        assert r, name


def _check_qc(host, tmp_path):
    h = host
    cases = [("histo", (k, h[src], Out("o"))) for k, src in (
        ("readlength", "passed_fq"), ("fastqmeanqv", "passed_fq"),
        ("readlength", "umi"), ("fastqmeanqv", "umi"), ("clipping", "umi"),
        ("moleculelength", "sorted"), ("percentidentity", "sorted"),
        ("umidepth", "named"))]
    cases += [("saturation_curve", (h["named"], Out("o"))),
              ("read_bam_stats", (h["umi"], Out("s.json"))),
              ("read_bam_stats", (h["sorted"],)),
              ("export_edit_distances", (h["umi"], Out("e.tsv"))),
              ("bulk2fake_single_cell", (h["passed_fq"], Out("o.fastq")))]
    for i, (name, args) in enumerate(cases):
        r, _ = _same(tmp_path, f"{i}_{name}", getattr(t_qc, name),
                     getattr(j_qc, name), *args)
        assert r, name


def _check_mergestats(host, tmp_path):
    _same(tmp_path, "json", t_mergestats.merge_scanner_stats,
          j_mergestats.merge_scanner_stats, [host["stats"], host["stats2"]],
          Out("s.json"))
    r, _ = _same(tmp_path, "tsv", t_mergestats.merge_barcodes_assigned,
                 j_mergestats.merge_barcodes_assigned,
                 [host["assigned"], host["assigned2"]], Out("a.tsv"))
    assert r["barcodes"] > 0

def _check_editdist():
    """The scalar numpy references of ops/editdist.py: strings, bytes and
    code arrays with N, empty sequences, and the batched sweep."""
    rng = np.random.default_rng(17)
    seqs = _seqs(17, 12) + ["ACGTN", "", b"acgtNN"]
    for a in seqs:
        for b in seqs[:6]:
            assert t_editdist.levenshtein_np(a, b) == \
                j_editdist.levenshtein_np(a, b)
            assert t_editdist.semiglobal_ed_np(b[:20], a) == \
                j_editdist.semiglobal_ed_np(b[:20], a)
    pats = rng.integers(0, 5, (5, 9)).astype(np.int8)
    texts = rng.integers(0, 6, (7, 40)).astype(np.int8)
    for got, want in zip(t_editdist.semiglobal_ed_np_batch(pats, texts),
                         j_editdist.semiglobal_ed_np_batch(pats, texts)):
        np.testing.assert_array_equal(got, want)


CHECKS = {
    "dna": _check_dna, "config": _check_config, "synth": _check_synth,
    "readname": _check_readname, "fastq": _check_fastq, "bam": _check_bam,
    "molecules": _check_molecules, "poa": _check_poa,
    "native": _check_native, "html": _check_html,
    "index": _check_index,
    "index_numpy": lambda tmp_path, monkeypatch: _check_index(
        tmp_path, monkeypatch, native=False),
    "chain": _check_chain,
    "chain_numpy": lambda monkeypatch: _check_chain(monkeypatch,
                                                    native=False),
    "genetag": _check_genetag, "sam": _check_sam,
    "illumina": _check_illumina, "programs": _check_programs,
    "bed": _check_bed, "collapse": _check_collapse,
    "isoform": _check_isoform, "collapsemodel": _check_collapsemodel,
    "snp_fusion": _check_snp_fusion, "annotate": _check_annotate,
    "programs2": _check_programs2, "qc": _check_qc,
    "mergestats": _check_mergestats, "editdist": _check_editdist,
}


@pytest.mark.parametrize("module", sorted(CHECKS))
def test_copy_matches_original(module, tmp_path, monkeypatch, request):
    import inspect

    fn = CHECKS[module]
    args = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{n: args[n] if n in args else request.getfixturevalue(n)
          for n, p in inspect.signature(fn).parameters.items()
          if p.default is p.empty})
