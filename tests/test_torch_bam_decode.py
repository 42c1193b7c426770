"""The port's BAM record decode (`sicelore_tpu_torch/io/bam.py`), which keeps
SEQ as its packed nibbles until `seq` is read: held field for field to the
JAX package's decode, which spells SEQ out at once; decode then encode gives
the record's bytes back; and a Step 4b parse, which reads no SEQ, spells out
none (counter `bam.seq_decoded`)."""
import struct

import numpy as np
import pytest

from benchmark.gen import molecules as gen
from benchmark.gen import tagbam
from benchmark.harness.cell import BENCH, load_json
from sicelore_tpu.io import bam as j_bam
from sicelore_tpu_torch.io import bam as t_bam
from sicelore_tpu_torch.ops import poa_cuda
from sicelore_tpu_torch.pipeline.consensus import compute_consensus
from sicelore_tpu_torch.utils import trace

FIELDS = ("qname", "flag", "ref_id", "pos", "mapq", "cigar", "next_ref_id",
          "next_pos", "tlen", "seq", "qual", "tags")
EVERY_TAG = [("XA", "A", "q"), ("Xc", "c", -7), ("XC", "C", 200),
             ("Xs", "s", -300), ("XS", "S", 60000), ("Xi", "i", -70000),
             ("XI", "I", 4000000000), ("Xf", "f", 0.5), ("XZ", "Z", "ACGT-1"),
             ("XH", "H", "1AE301"), ("Bc", "Bc", [-1, 2, -3]),
             ("BC", "BC", [0, 255]), ("Bs", "Bs", [-2, 3]),
             ("BS", "BS", [65535]), ("Bi", "Bi", [-5, 6, 7]),
             ("BI", "BI", [4000000000, 1]), ("Bf", "Bf", [1.5, -0.25]),
             ("BE", "Bi", [])]
# an indel about every 50 bases over 48 ops: a spliced long read's CIGAR
LONG_CIGAR = [("S", 40)] + [(op, n) for i in range(23)
                            for op, n in (("M", 50 + i), ("ID"[i % 2], 2))] \
    + [("M", 30)]
ALL_NIBBLES = t_bam.SEQ_NIBBLE


def _record(name, seq, qual=None, cigar=None, tags=(), flag=0):
    return dict(qname=name, flag=flag, ref_id=0 if cigar else -1,
                pos=99 if cigar else -1, mapq=60 if cigar else 0,
                cigar=list(cigar or []), seq=seq,
                qual=bytes(i % 41 for i in range(len(seq))) if qual is None
                else qual,
                tags=list(tags), next_ref_id=0, next_pos=5, tlen=-31)


CASES = {
    "l_seq_0": _record("r0", "", cigar=[("M", 10)]),
    "l_seq_1": _record("r1", "G", cigar=[("M", 1)]),
    "l_seq_odd": _record("r2", ALL_NIBBLES + "ACGTA", cigar=[("M", 21)]),
    "l_seq_even_every_nibble": _record("r3", ALL_NIBBLES,
                                       cigar=[("S", 2), ("M", 14)]),
    "qual_absent": _record("r4", "ACGTN" * 7, qual=b"",
                           cigar=[("M", 35)]),
    "n_cigar_0": _record("r5", "ACGTTGCA", flag=4),
    "n_cigar_48": _record("r6", "ACGT" * 420, cigar=LONG_CIGAR),
    "every_tag_type": _record("r7", "NACGT", cigar=[("M", 5)],
                              tags=EVERY_TAG),
}


def _bytes(mod, fields) -> bytes:
    """The record's bytes as `decode_record` takes them (no block size)."""
    return mod.encode_record(mod.BamRecord(**fields))[4:]


def test_cases_cover_what_the_decode_branches_on():
    seqs = [len(c["seq"]) for c in CASES.values()]
    assert {0, 1} <= set(seqs) and any(n % 2 and n > 1 for n in seqs) \
        and any(n and not n % 2 for n in seqs)
    assert set(ALL_NIBBLES) <= set("".join(c["seq"] for c in CASES.values()))
    assert max(len(c["cigar"]) for c in CASES.values()) >= 40
    assert {t for _, t, _ in EVERY_TAG} == set("AcCsSiIfZH") | {
        "B" + s for s in "cCsSiIf"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_record_matches_jax(case):
    buf = _bytes(j_bam, CASES[case])
    got, want = t_bam.decode_record(buf), j_bam.decode_record(buf)
    assert got.l_seq == len(want.seq)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert type(got.seq) is str
    if case == "qual_absent":
        assert got.qual == b""


def test_odd_l_seq_reads_the_high_nibble_of_the_last_byte():
    """The last byte's low nibble pads an odd SEQ: whatever it holds, the
    decode takes the high nibble alone, as the JAX package's does."""
    buf = bytearray(_bytes(j_bam, CASES["l_seq_odd"]))
    end = 32 + buf[8] + 4 + (21 + 1) // 2
    assert buf[end - 1] & 0xF == 0
    buf[end - 1] |= 0xB
    got, want = t_bam.decode_record(bytes(buf)), j_bam.decode_record(
        bytes(buf))
    assert got.seq == want.seq == ALL_NIBBLES + "ACGTA"


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_gives_the_bytes_back(case):
    """decode then encode is the identity on the record's bytes, with SEQ
    left packed, after it was read, and after it was assigned."""
    buf = _bytes(j_bam, CASES[case])
    assert t_bam.encode_record(t_bam.decode_record(buf))[4:] == buf
    read = t_bam.decode_record(buf)
    assert read.seq == CASES[case]["seq"]
    assert t_bam.encode_record(read)[4:] == buf
    new = CASES[case]["seq"][::-1].replace("A", "T")
    rec = t_bam.decode_record(buf)
    rec.seq = new
    assert rec.l_seq == len(new)
    out = t_bam.encode_record(rec)
    assert out == j_bam.encode_record(j_bam.BamRecord(
        **{**CASES[case], "seq": new}))
    assert t_bam.decode_record(out[4:]).seq == new


def _counters(snap):
    return {c["name"]: c["value"] for c in snap["counters"]
            if c["name"].startswith("bam.seq")}


def test_step4b_parse_spells_out_no_seq(tmp_path):
    """Traced, a Step 4b call on a 64-molecule tagbam BAM (CPU engine)
    counts every record's l_seq and decodes no SEQ base; a record's `seq`
    read twice is decoded, and counted, once."""
    mix = {**load_json(BENCH / "traffic" / "consensus_wta_tagbam.json")[
        "mix"], "molecules": 64, "length": [250, 450]}
    tags = load_json(BENCH / "configs" / "tenx3p_v3_tagbam.json")[
        "pipeline"]["sam_tags"]
    rng = np.random.default_rng(2**33 + 5)
    mols = gen.make_molecules(rng, mix)
    bam = tmp_path / "step3.bam"
    tagbam.write_tagbam(bam, mols, rng, mix["schema"], tags)
    with t_bam.BamReader(bam) as rd:
        bufs = list(iter(rd.read_raw, None))
    l_seqs = [struct.unpack_from("<i", b, 16)[0] for b in bufs]
    first = next(i for i, n in enumerate(l_seqs) if n)
    trace.enable()
    try:
        compute_consensus(bam, tmp_path / "out.fastq",
                          engine=poa_cuda.BatchedConsensusEngine(
                              device="cpu"))
        parsed = _counters(trace.snapshot())
        trace.reset()
        rec = t_bam.decode_record(bufs[first])
        assert rec.seq == rec.seq == j_bam.decode_record(bufs[first]).seq
        read_twice = _counters(trace.snapshot())
    finally:
        trace.disable()
        trace.reset()
    assert parsed == {"bam.seq_bases": sum(l_seqs)}
    assert read_twice == {"bam.seq_decoded": l_seqs[first]}
