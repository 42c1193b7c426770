"""DNA sequence encoding utilities (host side, numpy).

Reads are encoded as int8 code tensors: A=0, C=1, G=2, T=3, N/other=4.
Fixed-shape padded batches use PAD=5 so padding never matches any base.
16-mers (cell barcodes) pack into uint32 (2 bits/base) for exact hashing,
mirroring the role of the reference's TwoFourBitNucAcidLibrary
(the Java reference SURVEY: Jar 2-bit encode + ED mutation enumeration) — but
here packing is only used for host-side exact-match hashing; approximate
matching runs as a device kernel over the int8 codes.
"""
from __future__ import annotations

import numpy as np

A, C, G, T, N_CODE, PAD = 0, 1, 2, 3, 4, 5

# byte -> code lookup (uppercase + lowercase)
_ENC = np.full(256, N_CODE, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    _ENC[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _ENC[_b] = _i

_DEC = np.frombuffer(b"ACGTN.", dtype=np.uint8).copy()

# complement in code space: A<->T, C<->G; N->N, PAD->PAD
_COMP = np.array([T, G, C, A, N_CODE, PAD], dtype=np.int8)


def encode(seq: bytes | str) -> np.ndarray:
    """Encode an ASCII DNA sequence to int8 codes."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _ENC[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    """Decode int8 codes back to an ASCII string (PAD renders as '.')."""
    return _DEC[np.asarray(codes, dtype=np.int64)].tobytes().decode()


def encode_batch(seqs: list[bytes], max_len: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Encode a list of sequences into a padded [B, L] int8 batch + lengths."""
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    L = int(max_len if max_len is not None else (lens.max() if len(seqs) else 0))
    out = np.full((len(seqs), L), PAD, dtype=np.int8)
    for i, s in enumerate(seqs):
        n = min(len(s), L)
        out[i, :n] = encode(s[:n])
    return out, np.minimum(lens, L)


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement in code space (works on [..., L] arrays)."""
    return _COMP[codes][..., ::-1]


def revcomp_str(seq: str) -> str:
    return decode(revcomp(encode(seq)))


_COMP_BYTES = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")


def revcomp_bytes(seq: bytes) -> bytes:
    """Reverse-complement an ASCII sequence (host fast path for writers)."""
    return seq.translate(_COMP_BYTES)[::-1]


def pack_kmers(codes: np.ndarray, k: int = 16) -> np.ndarray:
    """Pack [..., k] int8 codes into uint32/uint64 2-bit words (A=0..T=3).

    Any N (code>=4) makes the k-mer invalid; caller should mask via
    `valid_kmers`. k<=16 packs to uint32, k<=32 to uint64.
    """
    assert codes.shape[-1] == k
    dt = np.uint32 if k <= 16 else np.uint64
    out = np.zeros(codes.shape[:-1], dtype=dt)
    c = np.minimum(codes, 3).astype(dt)
    for i in range(k):
        out = (out << dt(2)) | c[..., i]
    return out


def valid_kmers(codes: np.ndarray) -> np.ndarray:
    """Boolean mask: True where all bases are A/C/G/T (no N, no PAD)."""
    return (codes < 4).all(axis=-1)


def unpack_kmer(word: int, k: int = 16) -> str:
    out = []
    for i in range(k):
        out.append("ACGT"[(int(word) >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


def phred_to_qual(qline: bytes) -> np.ndarray:
    """fastq quality line -> int8 phred scores."""
    return (np.frombuffer(qline, dtype=np.uint8).astype(np.int16) - 33).astype(np.int8)


def qual_to_phred(quals: np.ndarray) -> bytes:
    return (np.asarray(quals, dtype=np.int16) + 33).astype(np.uint8).tobytes()
