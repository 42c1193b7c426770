"""Synthetic 10x-3' Nanopore read generator (test/bench fixture).

Plays the role the reference's Bulk2FakeSingleCell program plays as a
synthetic-data source (the Java reference: programs/Bulk2FakeSingleCell.java —
constant BC + random UMIs), extended to emit full library-structure reads:

  stranded (FWD) layout:  TSO . cDNA . polyA . rc(UMI) . rc(BC) . rc(adapter)
  REV reads are the reverse complement of the whole molecule.

Error injection is uniform sub/ins/del at a configurable rate so edit-
distance paths and negative controls are exercisable.
"""
from __future__ import annotations

import numpy as np

from sicelore_tpu_torch.utils import dna

ADAPTER = "CTACACGACGCTCTTCCGATCT"   # complete 10x R1 adapter (config.xml:112-114)
TSO = "AACGCAGAGTACATGG"             # config.xml:158


def random_seq(rng: np.random.Generator, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def mutate(rng: np.random.Generator, seq: str, rate: float) -> str:
    """Uniform substitution/insertion/deletion noise."""
    if rate <= 0:
        return seq
    out = []
    for ch in seq:
        r = rng.random()
        if r < rate:
            kind = rng.integers(0, 3)
            if kind == 0:      # substitution
                out.append("ACGT"[rng.integers(0, 4)])
            elif kind == 1:    # insertion
                out.append(ch)
                out.append("ACGT"[rng.integers(0, 4)])
            # kind == 2: deletion (skip)
        else:
            out.append(ch)
    return "".join(out)


def make_whitelist(rng: np.random.Generator, n: int, bc_len: int = 16) -> list[str]:
    seen, out = set(), []
    while len(out) < n:
        bc = random_seq(rng, bc_len)
        if bc not in seen:
            seen.add(bc)
            out.append(bc)
    return out


def make_read(rng: np.random.Generator, bc: str, umi: str | None = None,
              cdna_len: int = 400, polya_len: int = 20, error_rate: float = 0.0,
              reverse: bool = False, with_tso: bool = True,
              qual_char: str = "I") -> dict:
    """Build one read; returns dict(name-parts, seq, qual, truth fields)."""
    umi = umi if umi is not None else random_seq(rng, 12)
    cdna = random_seq(rng, cdna_len)
    stranded = (
        (TSO if with_tso else "") + cdna + "A" * polya_len
        + dna.revcomp_str(umi) + dna.revcomp_str(bc) + dna.revcomp_str(ADAPTER)
    )
    stranded = mutate(rng, stranded, error_rate)
    seq = dna.revcomp_str(stranded) if reverse else stranded
    return {
        "seq": seq.encode(),
        "qual": (qual_char * len(seq)).encode(),
        "bc": bc, "umi": umi, "reverse": reverse,
        "polya_len": polya_len, "cdna_len": cdna_len,
    }


def make_read_5p(rng: np.random.Generator, bc: str, umi: str | None = None,
                 cdna_len: int = 400, polya_len: int = 20,
                 error_rate: float = 0.0, reverse: bool = False,
                 qual_char: str = "I") -> dict:
    """5' chemistry read: ADAPTER BC UMI TSO cDNA polyA rc(3'adapter)
    (config.xml:120-185)."""
    umi = umi if umi is not None else random_seq(rng, 12)
    cdna = random_seq(rng, cdna_len)
    stranded = (ADAPTER + bc + umi + TSO + cdna + "A" * polya_len
                + dna.revcomp_str("AAGCAGTGGTATCAACGCAGAGTAC"))
    stranded = mutate(rng, stranded, error_rate)
    seq = dna.revcomp_str(stranded) if reverse else stranded
    return {"seq": seq.encode(), "qual": (qual_char * len(seq)).encode(),
            "bc": bc, "umi": umi, "reverse": reverse}


def make_chimera(rng: np.random.Generator, bc1: str, bc2: str, **kw) -> dict:
    """Two molecules fused head-to-tail (split-candidate fixture)."""
    r1 = make_read(rng, bc1, reverse=False, **kw)
    r2 = make_read(rng, bc2, reverse=False, **kw)
    return {"seq": r1["seq"] + r2["seq"], "qual": r1["qual"] + r2["qual"],
            "bc": (bc1, bc2)}


def reads_to_batch(reads: list[dict], max_len: int | None = None):
    """Encode read dicts -> (seqs [B, L] int8, quals [B, L] int8, lens [B])."""
    seqs, lens = dna.encode_batch([r["seq"] for r in reads], max_len)
    L = seqs.shape[1]
    quals = np.zeros((len(reads), L), dtype=np.int8)
    for i, r in enumerate(reads):
        q = dna.phred_to_qual(r["qual"])[:L]
        quals[i, :len(q)] = q
    return seqs, quals, lens


# ---------------------------------------------------------------------------
# consensus fixtures: molecule sets for both engines, the padded pair arrays
# of the vote functions, and tagged BAM records for computeconsensus
# ---------------------------------------------------------------------------

_ACGT_U8 = np.frombuffer(b"ACGT", np.uint8)


def mutate_np(rng: np.random.Generator, seq: bytes, rate: float) -> bytes:
    """`mutate` for bulk generation: the same uniform sub/ins/del noise,
    vectorized over the sequence (another random stream than `mutate`)."""
    codes = np.frombuffer(seq, np.uint8)
    n = len(codes)
    hit = rng.random(n) < rate
    kind = rng.integers(0, 3, n)
    sub, ins, dele = (hit & (kind == k) for k in range(3))
    out = codes.copy()
    out[sub] = _ACGT_U8[rng.integers(0, 4, int(sub.sum()))]
    reps = np.where(dele, 0, np.where(ins, 2, 1))
    res = np.repeat(out, reps)
    res[np.cumsum(reps)[ins] - 1] = _ACGT_U8[rng.integers(0, 4,
                                                          int(ins.sum()))]
    return res.tobytes()


def molecule_set(rng: np.random.Generator, n_mol: int, depth: int,
                 rate: float, length: int):
    """n_mol molecules of `depth` noisy reads of one random truth each:
    (list[list[bytes]], truths)."""
    mols, truths = [], []
    for _ in range(n_mol):
        truth = random_seq(rng, length)
        mols.append([mutate(rng, truth, rate).encode()
                     for _ in range(depth)])
        truths.append(truth)
    return mols, truths


def pair_arrays(molecules: list[list[bytes]], Lc: int, W: int):
    """The padded arrays the vote functions take, for molecules whose
    longest read (the center) fits Lc: every other read forms a pair, cut
    to Lc + W. Returns (center [P, Lc] int8, clens [P] int32, reads
    [P, Lc+W] int8, rlens [P] int32, mol_ids [P] int32); pads are dna.PAD."""
    cs, rs, mids = [], [], []
    for m, seqs in enumerate(molecules):
        ci = max(range(len(seqs)), key=lambda i: len(seqs[i]))
        if len(seqs[ci]) > Lc:
            raise ValueError(f"molecule {m}: center longer than Lc={Lc}")
        for r, s in enumerate(seqs):
            if r != ci:
                cs.append(seqs[ci])
                rs.append(s[:Lc + W])
                mids.append(m)
    center, clens = dna.encode_batch(cs, Lc)
    reads, rlens = dna.encode_batch(rs, Lc + W)
    return center, clens, reads, rlens, np.asarray(mids, np.int32)


def tagged_records(molecules: list[list[bytes]], rng: np.random.Generator,
                   prefix: str = "m"):
    """One mapped BAM record per read, tagged as computeconsensus reads
    them: BC (a cell of 16 bases per 64 molecules), U8 (one UMI per
    molecule), de (random divergence) and CS (the cDNA). The record itself
    carries no sequence."""
    from sicelore_tpu_torch.io.bam import BamRecord

    for m, seqs in enumerate(molecules):
        if m % 64 == 0:
            bc = random_seq(rng, 16)
        umi = random_seq(rng, 12)
        for r, s in enumerate(seqs):
            yield BamRecord(
                qname=f"{prefix}{m}r{r}", flag=0, ref_id=0, pos=1000 + m,
                mapq=60, cigar=[("M", 100)],
                tags=[("BC", "Z", bc), ("U8", "Z", umi),
                      ("de", "f", float(rng.integers(0, 1000)) / 10000.0),
                      ("CS", "Z", s.decode())])
