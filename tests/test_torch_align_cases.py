"""The aligner's file path and options: fastq -> sorted BAM + BAI with an
annotated junction BED, byte-identical to the JAX package's; the gap batch
cut into sub-batches; the `align` and `samview` commands; and both CLIs'
option strings for the commands the port has."""
import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sicelore_tpu import __main__ as j_main
from sicelore_tpu.align import NativeAligner as JaxAligner
from sicelore_tpu.io import sam as j_sam
from sicelore_tpu_torch import __main__ as t_main
from sicelore_tpu_torch.align import NativeAligner, extend
from sicelore_tpu_torch.io import sam as t_sam
from sicelore_tpu_torch.io.bam import BamReader
from sicelore_tpu_torch.utils import dna, synth

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A genome fasta, a junction BED, and a fastq of spliced (one across
    the annotated junction), noisy and garbage reads."""
    d = tmp_path_factory.mktemp("align")
    rng = np.random.default_rng(60)
    g = synth.random_seq(rng, 90_000).encode()
    u = synth.random_seq(rng, 30_000).encode()
    with open(d / "ref.fa", "w") as fh:
        for name, seq in (("chrA", g), ("chrB", u)):
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                fh.write(seq[i:i + 70].decode() + "\n")
    s, e1, ilen, e2 = 40_000, 420, 2_517, 380
    (d / "junc.bed").write_text(f"chrA\t{s + e1}\t{s + e1 + ilen}\tj1\n")
    reads = [(b"jb", g[s:s + e1] + g[s + e1 + ilen:s + e1 + ilen + e2]),
             (b"sp", g[10_000:10_500] + g[11_400:11_900])]
    for i in range(14):
        src = g if i % 3 else u
        pos = int(rng.integers(1_000, len(src) - 1_500))
        read = synth.mutate(rng, src[pos:pos + int(rng.integers(300, 1_200))]
                            .decode(), 0.06).encode()
        reads.append((b"n%d" % i, dna.revcomp_bytes(read) if i % 2
                      else read))
    reads.append((b"junk", synth.random_seq(rng, 500).encode()))
    with open(d / "reads.fastq", "wb") as fh:
        for name, seq in reads:
            qual = (rng.integers(10, 41, len(seq)) + 33).astype(np.uint8)
            fh.write(b"@%s\n%s\n+\n%s\n" % (name, seq, qual.tobytes()))
    return d


@pytest.fixture(scope="module")
def jax_bam(files, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_bam") / "out.bam"
    st = JaxAligner(files / "ref.fa", use_device=False,
                    junc_bed=files / "junc.bed").align_fastq_to_bam(
        files / "reads.fastq", out, keep_unmapped=True)
    return out, st


def test_fastq_to_bam_and_bai_byte_identical_to_jax(files, jax_bam,
                                                    tmp_path):
    want, st_j = jax_bam
    out = tmp_path / "out.bam"
    st = NativeAligner(files / "ref.fa", junc_bed=files / "junc.bed",
                       device="cpu").align_fastq_to_bam(
        files / "reads.fastq", out, keep_unmapped=True)
    assert st == st_j and st["reads"] == 17
    assert out.read_bytes() == want.read_bytes()
    bai = Path(str(out) + ".bai")
    assert bai.exists()
    assert bai.read_bytes() == Path(str(want) + ".bai").read_bytes()
    # the annotated junction is taken exactly
    with BamReader(out) as rd:
        recs = {r.qname: r for r in rd}
    assert ("N", 2_517) in [tuple(c) for c in recs["jb"].cigar]


def test_cli_align_and_samview_cpu(files, jax_bam, tmp_path):
    """`align --device cpu` writes the library's BAM; `samview` turns it
    into the JAX package's SAM text and back into the same records."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = [sys.executable, "-m", "sicelore_tpu_torch"]
    out = tmp_path / "cli.bam"
    r = subprocess.run(run + ["align", "-r", str(files / "ref.fa"), "-d",
                              str(files / "reads.fastq"), "-O", str(out),
                              "--juncBed", str(files / "junc.bed"),
                              "--keep-unmapped", "--device", "cpu"],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    assert "align done: 17/17" in r.stdout
    assert out.read_bytes() == jax_bam[0].read_bytes()
    r = subprocess.run(run + ["samview", "-I", str(out), "-O",
                              str(tmp_path / "cli.sam")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    j_sam.bam_to_sam(out, tmp_path / "jax.sam")
    assert (tmp_path / "cli.sam").read_bytes() == \
        (tmp_path / "jax.sam").read_bytes()
    n_t = t_sam.sam_to_bam(tmp_path / "cli.sam", tmp_path / "back_t.bam")
    n_j = j_sam.sam_to_bam(tmp_path / "cli.sam", tmp_path / "back_j.bam")
    assert n_t == n_j == 17
    assert (tmp_path / "back_t.bam").read_bytes() == \
        (tmp_path / "back_j.bam").read_bytes()


def test_gap_sub_batches_equal_one_call(files):
    """Cutting each length bucket into sub-batches of 5 pairs gives the
    CIGARs of one call a bucket."""
    from sicelore_tpu_torch.io import fastq

    al = NativeAligner(files / "ref.fa", device="cpu")
    chunk = next(fastq.read_fastq(files / "reads.fastq", 100))
    one = extend.GapBatcher("cpu")
    plans = [al._plan(s, one) for s in chunk.seqs]
    handles = [(seg[1], seg[2], seg[3]) for p in plans if p for pl in p
               for seg in pl["segs"] if seg[0] in ("gap", "lead", "tail")
               and seg[1] is not None]
    assert len(handles) > 10 and len(one.jobs) >= 2
    cut = extend.GapBatcher("cpu", pairs_per_call=5)
    cut.jobs = one.jobs
    one.run()
    cut.run()
    for h, R, Q in handles:
        assert one.get(h, R, Q) == cut.get(h, R, Q)
    for Lc in one.jobs:
        for a, b in zip(one.results[Lc], cut.results[Lc]):
            np.testing.assert_array_equal(a, b)


def _options(parser):
    """{option string: default} of a parser's optional arguments."""
    return {s: a.default for a in parser._actions
            for s in a.option_strings if s not in ("-h", "--help")}


def _subparsers(adders):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd")
    for add in adders:
        add(sub)
    return sub.choices


@pytest.mark.parametrize("cmd", ["align", "assignumis", "parseillumina",
                                 "samview", "scanfastq",
                                 "computeconsensus"])
def test_cli_options_match_jax(cmd):
    """Each port command has the JAX command's option strings and defaults,
    plus --device (default cuda) where it reaches the card; the host-only
    parseillumina and samview take no --device; computeconsensus also takes
    --trace (the program's tracer, off by default)."""
    j = _subparsers([j_main._add_scanfastq, j_main._add_assignumis,
                     j_main._add_computeconsensus,
                     j_main._add_simple_programs])[cmd]
    t = _subparsers([t_main._add_scanfastq, t_main._add_computeconsensus,
                     t_main._add_align, t_main._add_assignumis,
                     t_main._add_simple_programs])[cmd]
    jo, to = _options(j), _options(t)
    if cmd in ("parseillumina", "samview"):
        assert "--device" not in to
    else:
        assert to.pop("--device") == "cuda"
    if cmd == "computeconsensus":
        assert to.pop("--trace") is None
    assert to == jo
    pos = [a.dest for a in t._actions if not a.option_strings]
    assert pos == [a.dest for a in j._actions if not a.option_strings]
