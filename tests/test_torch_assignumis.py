"""assignumis and parseillumina: the port's pipelines (UMI distances on the
CPU) against the JAX package's on one sorted BAM. The output BAM,
genecounts, UMIdepths, log and the guided-mode table are byte-identical;
one group is large enough to take the batched distance route."""
import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sicelore_tpu.pipeline.assignumis import AssignUmisPipeline as JaxUmis
from sicelore_tpu.pipeline.illumina import GuidedUmiTable as JaxTable
from sicelore_tpu.pipeline.illumina import parse_illumina_bam as jax_parse
from sicelore_tpu_torch.io.bam import BamHeader, BamRecord, BamWriter
from sicelore_tpu_torch.ops import editdist
from sicelore_tpu_torch.pipeline import readname
from sicelore_tpu_torch.pipeline.assignumis import AssignUmisPipeline
from sicelore_tpu_torch.pipeline.illumina import (GuidedUmiTable,
                                                  parse_illumina_bam)
from sicelore_tpu_torch.utils import dna

REPO = Path(__file__).resolve().parents[1]
ADAPTER = "CTACACGACGCTCTTCCGATCT"
HDR = BamHeader("@SQ\tSN:chr1\tLN:200000\n@SQ\tSN:chr2\tLN:50000\n",
                [("chr1", 200000), ("chr2", 50000)])
# (name, chrom index, strand, exons): one- and two-exon genes on both
# strands, two overlapping genes of opposite strands
GENES = [("GA", 0, "+", [(1000, 1600)]),
         ("GB", 0, "-", [(5000, 5400), (6000, 6500)]),
         ("GC", 0, "+", [(20000, 21000)]),
         ("GD", 0, "-", [(20500, 21500)]),
         ("GE1", 1, "+", [(2000, 2300), (2900, 3400)])]
CELLS = ["AAAACCCCGGGGTTTT", "TTTTGGGGCCCCAAAA", "ACGTACGTACGTACGT"]


def _scan_read(rng, bc, umi, cdna, umi_short=False):
    """Stranded read + scanfastq-style name; umi_short puts the barcode end
    right after the polyA (no room for a UMI)."""
    polya = 15
    u = "" if umi_short else umi
    seq = (cdna + "A" * polya + dna.revcomp_str(u) + dna.revcomp_str(bc)
           + dna.revcomp_str(ADAPTER))
    ps, pe = len(cdna), len(cdna) + polya - 1
    ae = len(cdna) + polya + len(u) + 16
    name = readname.encode_name(
        b"rd%d" % int(rng.integers(1e9)), is_fwd=True, ps=ps, pe=pe, ae=ae,
        bc=bc, ed=0, ed_sec=readname.INT_MAX, bc_start=ae - 1,
        bc_end=ae - 16, rank=1, x_seq=seq[ae - 40:ae + 3].encode(),
        x_qv=30.0)
    return name.decode(), seq


def _noisy_umi(rng, umi):
    r = rng.random()
    p = int(rng.integers(0, len(umi)))
    if r < 0.3:
        return umi[:p] + "ACGT"[int(rng.integers(0, 4))] + umi[p + 1:]
    if r < 0.38:
        return umi[:p] + umi[p + 1:]
    if r < 0.42:
        return umi[:p] + "N" + umi[p + 1:]
    return umi


def _records(seed):
    """Records of molecules of (cell, gene) groups: a large group (62
    molecules, >= 48 unique UMIs), small groups on every gene and strand,
    spliced records, a read too short for a UMI, a read without scan
    metadata and an unmapped one."""
    rng = np.random.default_rng(seed)
    genome = {c: "".join("ACGT"[i] for i in rng.integers(0, 4, n))
              for c, n in ((0, 200000), (1, 50000))}
    recs = []
    plan = [(0, 0, 62, 2)] + [(c, g, int(rng.integers(1, 6)), 3)
                              for g in range(len(GENES)) for c in range(3)]
    for ci, gi, n_mol, depth in plan:
        _, chrom, strand, exons = GENES[gi]
        tx = "".join(genome[chrom][a:b] for a, b in exons)
        for _ in range(n_mol):
            umi = "".join("ACGT"[i] for i in rng.integers(0, 4, 12))
            for _ in range(int(rng.integers(1, depth + 1))):
                cut = int(rng.integers(0, 120))  # 5'-truncated cDNA
                cdna = (tx[cut:] if strand == "+"
                        else dna.revcomp_str(tx)[cut:])
                name, seq = _scan_read(rng, CELLS[ci], _noisy_umi(rng, umi),
                                       cdna, umi_short=rng.random() < 0.02)
                rev = strand == "-"
                bam_seq = dna.revcomp_str(seq) if rev else seq
                tail = len(seq) - len(cdna)
                if len(exons) == 2 and not rev:
                    e0 = exons[0][1] - exons[0][0] - cut
                    cig = [("M", e0), ("N", exons[1][0] - exons[0][1]),
                           ("M", exons[1][1] - exons[1][0]), ("S", tail)]
                    pos = exons[0][0] + cut
                elif len(exons) == 2:
                    e1 = exons[1][1] - exons[1][0] - cut
                    cig = [("S", tail), ("M", exons[0][1] - exons[0][0]),
                           ("N", exons[1][0] - exons[0][1]), ("M", e1)]
                    pos = exons[0][0]
                else:
                    cig = ([("M", len(cdna)), ("S", tail)] if not rev
                           else [("S", tail), ("M", len(cdna))])
                    pos = exons[0][0] + (0 if rev else cut)
                pos += int(rng.integers(-3, 4))
                recs.append(BamRecord(
                    qname=name, flag=16 if rev else 0, ref_id=chrom,
                    pos=pos, mapq=60, cigar=cig, seq=bam_seq,
                    qual=bytes(rng.integers(18, 24, len(seq)).tolist()),
                    tags=[("de", "f", 0.03)]))
    recs.append(BamRecord(qname="plain_name", flag=0, ref_id=0, pos=1100,
                          mapq=60, cigar=[("M", 50)], seq="A" * 50,
                          qual=bytes([30]) * 50))
    recs.sort(key=lambda r: (r.ref_id, r.pos))
    recs.append(BamRecord(qname=recs[0].qname, flag=4, seq="ACGT",
                          qual=bytes([30]) * 4))
    return recs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("umis")
    bam = d / "sorted.bam"
    with BamWriter(bam, HDR) as w:
        for r in _records(31):
            w.write(r)
    rf = d / "genes.refflat"
    with open(rf, "w") as fh:
        for name, ci, strand, exons in GENES:
            s, e = exons[0][0], exons[-1][1]
            fh.write(f"{name}\tT{name}\tchr{ci + 1}\t{strand}\t{s}\t{e}\t"
                     f"{s}\t{e}\t{len(exons)}\t"
                     + "".join(f"{a}," for a, _ in exons) + "\t"
                     + "".join(f"{b}," for _, b in exons) + "\n")
    # an Illumina BAM: CB/UB/GN of every third record, its UMI window with
    # one substitution at times (guided mode snaps to it), on both
    # strands, every fifth without a gene
    rng = np.random.default_rng(32)
    ill = d / "illumina.bam"
    with BamWriter(ill, HDR) as w:
        for i, r in enumerate(_records(31)[::3]):
            info = readname.parse_name(r.qname)
            if info is None or r.flag & 4:
                continue
            seq = dna.revcomp_str(r.seq) if r.flag & 16 else r.seq
            umi = seq[info.pe + 1:info.bc_end] or "ACGTACGTACGT"
            if rng.random() < 0.3:
                umi = "T" + umi[1:]
            tags = [("CB", "Z", info.bc + "-1"), ("UB", "Z", umi)]
            if i % 5:
                gene = min((abs(ex[0][0] - r.pos), g)
                           for g, ci, _, ex in GENES if ci == r.ref_id)
                tags.append(("GN", "Z", gene[1]))
            w.write(BamRecord(qname=f"i{i}", flag=r.flag, ref_id=r.ref_id,
                              pos=r.pos, mapq=60, cigar=[("M", 90)],
                              seq="A" * 90, qual=bytes([40]) * 90,
                              tags=tags))
    return bam, rf, ill


def _run(pipe, bam, out_dir):
    out_dir.mkdir(parents=True, exist_ok=True)
    stats = pipe.run(bam, out_dir / "out.bam",
                     genecounts_tsv=out_dir / "genecounts.tsv",
                     umidepths_tsv=out_dir / "UMIdepths.tsv",
                     log_json=out_dir / "out.bam.log")
    return stats, {f.name: f.read_bytes() for f in sorted(out_dir.iterdir())}


def _tables(tmp_path):
    """Paths of the port's and the JAX package's table: one file name in
    two directories (gzip stores the name in its header)."""
    (tmp_path / "t").mkdir(exist_ok=True)
    (tmp_path / "j").mkdir(exist_ok=True)
    return tmp_path / "t" / "table.json.gz", tmp_path / "j" / "table.json.gz"


def _gz_equal(a: Path, b: Path):
    """gzip files equal byte for byte but for the header's mtime field."""
    x, y = a.read_bytes(), b.read_bytes()
    assert gzip.decompress(x) == gzip.decompress(y)
    assert x[:4] + x[8:] == y[:4] + y[8:]


@pytest.mark.parametrize("mode", ["plain", "refflat", "random_umi",
                                  "guided"])
def test_assignumis_byte_identical_to_jax(inputs, tmp_path, mode):
    bam, rf, ill = inputs
    kw = {}
    jkw = {}
    if mode in ("refflat", "guided"):
        kw["refflat"] = jkw["refflat"] = rf
    if mode == "random_umi":
        kw.update(random_umi=True, seed=7)
        jkw.update(random_umi=True, seed=7)
    if mode == "guided":
        tt, jt = _tables(tmp_path)
        parse_illumina_bam(ill, tt)
        jax_parse(ill, jt)
        _gz_equal(tt, jt)
        kw["illumina_table"] = GuidedUmiTable(tt)
        jkw["illumina_table"] = JaxTable(jt)
    want, jfiles = _run(JaxUmis(**jkw), bam, tmp_path / "jax")
    before = editdist.myers_global_pairwise.launches
    got, tfiles = _run(AssignUmisPipeline(device="cpu", **kw), bam,
                       tmp_path / "torch")
    assert editdist.myers_global_pairwise.launches > before
    assert got.to_json() == want.to_json()
    assert sorted(tfiles) == sorted(jfiles)
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name
    assert got.umi_too_short >= 1 and got.no_scan_info == 1
    if mode == "refflat":
        assert b"GA\tAAAACCCCGGGGTTTT" in tfiles["genecounts.tsv"]
    if mode == "guided":        # the snapping changed some centers
        _, plain = _run(AssignUmisPipeline(device="cpu", refflat=rf), bam,
                        tmp_path / "unguided")
        assert plain["out.bam"] != tfiles["out.bam"]


def test_parseillumina_table_identical(inputs, tmp_path):
    _, _, ill = inputs
    tt, jt = _tables(tmp_path)
    a = parse_illumina_bam(ill, tt)
    b = jax_parse(ill, jt)
    assert a == b and a["genes"] == len(GENES)
    _gz_equal(tt, jt)
    ta, tb = GuidedUmiTable(tt), JaxTable(jt)
    assert ta.all_bcs == tb.all_bcs
    for bc in CELLS:
        for umi in (b"ACGTACGTACGT", b"AAAACCCCGGGN"):
            assert ta.guided_bc(bc.encode()) == tb.guided_bc(bc.encode())
            for g, *_ in GENES:
                assert ta.snap(g, bc, umi) == tb.snap(g, bc, umi)


def test_cli_assignumis_and_parseillumina_cpu(inputs, tmp_path):
    """The CLI (assignumis on --device cpu; parseillumina, host-only, takes
    no --device) writes what the library writes."""
    bam, rf, ill = inputs
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = [sys.executable, "-m", "sicelore_tpu_torch"]
    r = subprocess.run(run + ["parseillumina", "-I", str(ill), "-O",
                              str(tmp_path / "t.json.gz")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    r = subprocess.run(run + ["assignumis", "-i", str(bam), "-o",
                              str(tmp_path / "cli" / "umi.bam"), "-a", str(rf),
                              "--illumina", str(tmp_path / "t.json.gz"),
                              "--device", "cpu"],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    assert "assignumis done" in r.stdout
    pipe = AssignUmisPipeline(refflat=rf, device="cpu",
                              illumina_table=GuidedUmiTable(
                                  tmp_path / "t.json.gz"))
    _, lib = _run(pipe, bam, tmp_path / "lib")
    cli = tmp_path / "cli"
    assert (cli / "umi.bam").read_bytes() == lib["out.bam"]
    assert (cli / "umi.genecounts.tsv").read_bytes() == lib["genecounts.tsv"]
    assert (cli / "umi.UMIdepths.tsv").read_bytes() == lib["UMIdepths.tsv"]
    assert (cli / "umi.bam.log").read_bytes() == lib["out.bam.log"]
