"""The port's read encoding (ops/encode_cuda.py, csrc/encode.cu) against the
JAX package's encoders, byte for byte (tolerance: exact, integer rows): the
plain two-half rows against `encode_two_half_int8` and, on clean reads,
against `unpack_tm(encode_composite_tm(...))`; the plain composite rows
against `encode_composite`; the kernel's byte table against `_ENC`; the
wrappers' refusals; a mesh's rebased spans; and the scan passes with the
numpy encoders out of reach (no main-path caller is left)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sicelore_tpu.models import readscan as jax_readscan
from sicelore_tpu.ops import edgescan as jax_eg
from sicelore_tpu.utils import synth
from sicelore_tpu.utils.config import PipelineConfig
from sicelore_tpu_torch.models import readscan
from sicelore_tpu_torch.models.readscan import ReadScanModel
from sicelore_tpu_torch.ops import edgescan as eg
from sicelore_tpu_torch.ops import encode_cuda as enc
from sicelore_tpu_torch.utils import dna
from sicelore_tpu_torch.utils.config import PipelineConfig as TorchConfig

E = eg.E
SRC = Path(enc.__file__).parents[1] / "csrc" / "encode.cu"


def _synth_reads(rng, n=64, chem="3p"):
    """Reads of both strands and lengths from 40 to 4,000, a few with N
    near either end, qualities of their own length."""
    make = synth.make_read_5p if chem == "5p" else synth.make_read
    wl = synth.make_whitelist(rng, 16)
    seqs = []
    for i in range(n):
        clen = (int(rng.integers(1200, 4000)) if i % 7 == 3
                else int(rng.integers(40, 560)))
        s = bytearray(make(rng, wl[i % 16], cdna_len=clen, error_rate=0.05,
                           reverse=bool(i % 2))["seq"])
        if i % 6 == 1:
            s[int(rng.integers(0, 120))] = ord("N")
            s[len(s) - 1 - int(rng.integers(0, 120))] = ord("N")
        seqs.append(bytes(s))
    quals = [bytes(33 + int(x) for x in rng.integers(3, 40, len(s)))
             for s in seqs]
    return seqs, quals


def _nul_reads(rng):
    """ACGT reads with NUL, N and lowercase bytes at the first and last
    columns of each half, qualities with bytes below '!' and above 160 at
    the same places, of every length class."""
    seqs, quals = [], []
    for L in (1, 2, E - 1, E, E + 1, 2 * E - 1, 2 * E, 2 * E + 1, 1000):
        for pos in (0, E - 1, E, L - E, -1, L // 2):
            s = bytearray(synth.random_seq(rng, L).encode())
            q = bytearray(rng.integers(33, 75, L).astype(np.uint8).tobytes())
            for p, b, qb in ((pos, 0, 7), (-1 - pos, ord("N"), 200),
                             (L // 3, ord("g"), 32), (L - 2, 0, 161)):
                if -L <= p < L:
                    s[p], q[p] = b, qb
            seqs.append(bytes(s))
            quals.append(bytes(q))
    return seqs, quals


READ_SETS = {
    "edge": lambda: chip_smoke.encode_edge_reads(np.random.default_rng(1)),
    "synth3p": lambda: _synth_reads(np.random.default_rng(2)),
    "synth5p": lambda: _synth_reads(np.random.default_rng(3), chem="5p"),
    "nul": lambda: _nul_reads(np.random.default_rng(4)),
}


def _plain_two_half(seqs, quals):
    inp = enc.chunk_inputs(seqs, quals, "cpu")
    codes, qv2, qsum = enc.encode_two_half_dev(*inp)
    return inp, codes.numpy(), qv2.numpy(), qsum.numpy()


@pytest.mark.parametrize("name", sorted(READ_SETS))
def test_plain_two_half_equals_jax_int8(name):
    """codes = head || tail, qv2, the true lengths (from the offsets) and
    qsum equal encode_two_half_int8's (the JAX package's exact encoder)."""
    seqs, quals = READ_SETS[name]()
    before = enc.encode_two_half_plain.launches
    inp, codes, qv2, qsum = _plain_two_half(seqs, quals)
    assert enc.encode_two_half_plain.launches == before + 1
    head, tail, qv2_j, lens_j, qsum_j = jax_eg.encode_two_half_int8(seqs,
                                                                    quals)
    assert codes.dtype == np.int8 and qv2.dtype == np.int8
    assert qsum.dtype == np.int32
    np.testing.assert_array_equal(codes[:, :E], head)
    np.testing.assert_array_equal(codes[:, E:], tail)
    np.testing.assert_array_equal(qv2, qv2_j)
    np.testing.assert_array_equal(qsum, qsum_j)
    np.testing.assert_array_equal(inp.lens().numpy(), lens_j)
    np.testing.assert_array_equal(enc.join(seqs, quals).lens, lens_j)


def test_edge_set_covers_what_it_promises():
    """encode_edge_reads holds every length class, every byte value in
    sequences and qualities, NUL inside reads, qualities that wrap, and
    quality strings shorter and longer than their read."""
    seqs, quals = READ_SETS["edge"]()
    L = np.array([len(s) for s in seqs])
    Lq = np.array([len(q) for q in quals])
    for lo, hi in ((0, 0), (1, E - 1), (E, E), (E + 1, 2 * E - 1),
                   (2 * E, 2 * E), (2 * E + 1, 10**6)):
        assert ((L >= lo) & (L <= hi)).any(), (lo, hi)
    assert (Lq < L).any() and (Lq > L).any() and (Lq == 0).any()
    assert set(b"".join(seqs)) == set(range(256))
    assert set(b"".join(quals)) == set(range(256))
    assert any(0 in s[1:-1] for s in seqs)


@pytest.mark.parametrize("name", ["synth3p", "synth5p"])
def test_plain_two_half_equals_jax_tm_route_on_clean_reads(name):
    """On reads with no N in their halves the plain codes equal the JAX
    main path's unpack_tm(encode_composite_tm(...)) (PAD outside the read);
    qv2, the true lengths and qsum equal encode_composite_tm's, by whichever
    route (native or numpy) the JAX package takes."""
    seqs, quals = READ_SETS[name]()
    _, codes, qv2, qsum = _plain_two_half(seqs, quals)
    packed, qv2_j, lens_j, dirty, qsum_j = jax_eg.encode_composite_tm(
        seqs, quals)
    head, tail, lens_u = (np.asarray(a) for a in
                          jax_eg.unpack_tm(jnp.asarray(packed)))
    clean = ~dirty
    assert clean.sum() > 40 and dirty.any()
    np.testing.assert_array_equal(codes[clean, :E], head[clean])
    np.testing.assert_array_equal(codes[clean, E:], tail[clean])
    np.testing.assert_array_equal(qv2, qv2_j)
    np.testing.assert_array_equal(qsum, qsum_j)
    np.testing.assert_array_equal(enc.join(seqs, quals).lens, lens_j)
    np.testing.assert_array_equal(lens_u, lens_j)


@pytest.mark.parametrize("name", sorted(READ_SETS))
def test_plain_composite_equals_jax(name):
    """The v1 composite rows and qv equal the JAX encode_composite's; its
    composite and true lengths are the host offsets' min(L, 2E) and L."""
    seqs, quals = READ_SETS[name]()
    inp = enc.chunk_inputs(seqs, quals, "cpu")
    before = enc.encode_composite_plain.launches
    codes, qv = enc.encode_composite_dev(*inp)
    assert enc.encode_composite_plain.launches == before + 1
    ref = jax_readscan.encode_composite(seqs, quals)
    np.testing.assert_array_equal(codes.numpy(), ref[0])
    np.testing.assert_array_equal(qv.numpy(), ref[1])
    lens = enc.join(seqs, quals).lens
    np.testing.assert_array_equal(np.minimum(lens, 2 * E), ref[2])
    np.testing.assert_array_equal(lens, ref[3])
    # and the port's own numpy oracle
    for a, b in zip((codes.numpy(), qv.numpy()),
                    readscan.encode_composite(seqs, quals)):
        np.testing.assert_array_equal(a, b)


def _source_constants():
    """The integer constants of csrc/encode.cu (its `constexpr int` and
    `constexpr unsigned` lines), evaluated in order."""
    src = SRC.read_text()
    env = {}
    for kind, name, expr in re.findall(
            r"constexpr (int|unsigned) (\w+) = ([^;]+);", src):
        expr = re.sub(r"'(.)'", lambda m: str(ord(m.group(1))), expr)
        expr = re.sub(r"(0x[0-9A-Fa-f]+|\d+)u\b", r"\1", expr)
        expr = re.sub(r"ENC_\w+", "0", expr)     # the knobs: not modelled
        expr = expr.replace("/", "//")            # C's integer division
        env[name] = eval(expr, {"max": max, "min": min}, dict(env))
    return src, env


def _prmt(a, b, s):
    """PTX prmt.b32 (default mode): result byte i is byte s_i & 7 of b:a,
    or, when s_i >= 8, that byte's sign replicated."""
    pool = [(a >> 8 * i) & 255 for i in range(4)] + \
        [(b >> 8 * i) & 255 for i in range(4)]
    out = 0
    for i in range(4):
        n = (s >> 4 * i) & 15
        v = pool[n & 7]
        if n & 8:
            v = 255 if v & 128 else 0
        out |= v << 8 * i
    return out


def _kernel_code_of():
    """csrc/encode.cu's four-byte code map (`code_word`), modelled from its
    source: each byte's low nibble picks its slot's letter, case mask and
    code by PRMT; a zero test of (byte ^ letter) & case picks the code,
    else N_CODE."""
    src, k = _source_constants()
    flat = " ".join(src.split())
    for line in (
            "prmt((w & 0x0F0F0F0Fu) | (w >> 4 & 0xF0F0F0F0u), 0u, 0x0020u);",
            "const unsigned y = (w ^ prmt(LETTER_LO, LETTER_HI, sel)) & "
            "prmt(CASE_LO, CASE_HI, sel);",
            "const unsigned z = ~(((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y) & "
            "0x80808080u;",
            "const unsigned eq = prmt(z, 0u, 0xBA98u);",
            "return (prmt(CODE_LO, CODE_HI, sel) & eq) | "
            "(N_CODE * ONES & ~eq);"):
        assert line in flat, line
    M = 0xFFFFFFFF

    def code_word(w):
        sel = _prmt((w & 0x0F0F0F0F) | (w >> 4 & 0xF0F0F0F0), 0, 0x0020)
        y = (w ^ _prmt(k["LETTER_LO"], k["LETTER_HI"], sel)) & \
            _prmt(k["CASE_LO"], k["CASE_HI"], sel)
        z = ~(((y & 0x7F7F7F7F) + 0x7F7F7F7F) | y) & 0x80808080 & M
        eq = _prmt(z, 0, 0xBA98)
        return ((_prmt(k["CODE_LO"], k["CODE_HI"], sel) & eq)
                | (k["N_CODE"] * k["ONES"] & ~eq)) & M
    return code_word, k


def _qual_word_model():
    """csrc/encode.cu's four-byte quality map (`qual_word`), modelled from
    its source."""
    src, k = _source_constants()
    flat = " ".join(src.split())
    for line in ("const unsigned d = (q | 0x80808080u) - 33u * ONES;",
                 "const unsigned ge = prmt(d | q, 0u, 0xBA98u);",
                 "return (d ^ (~q & 0x80808080u)) & ge;"):
        assert line in flat, line
    M = 0xFFFFFFFF

    def qual_word(q):
        d = ((q | 0x80808080) - 33 * k["ONES"]) & M
        ge = _prmt(d | q, 0, 0xBA98)
        return (d ^ (~q & 0x80808080)) & ge & M
    return qual_word


def _words_with_every_byte_everywhere():
    """(words, their bytes [n, 4]): every byte value in every one of the
    four positions of a word, beside every other value."""
    rng = np.random.default_rng(13)
    b = np.concatenate([np.stack([np.roll(np.arange(256), r * j)
                                  for j in range(4)], 1)
                        for r in (1, 7, 64)]
                       + [rng.integers(0, 256, (4096, 4))]).astype(np.uint32)
    words = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24
    for pos in range(4):
        assert set(b[:, pos].tolist()) == set(range(256))
    return words.tolist(), b


def test_kernel_byte_table_is_enc_with_nul_as_pad():
    """The kernel's four-byte code map gives each byte of a word, in each of
    the four positions, all 256 values, the code `_ENC` gives it, with the
    NUL byte mapped to PAD (`_ENC_PAD0`); its E, PAD and N_CODE are the
    package's."""
    code_word, const = _kernel_code_of()
    want = dna._ENC.copy()
    want[0] = dna.PAD
    np.testing.assert_array_equal(want, eg._ENC_PAD0)
    words, b = _words_with_every_byte_everywhere()
    got = np.array([code_word(w) for w in words], np.uint32)
    for pos in range(4):
        np.testing.assert_array_equal((got >> 8 * pos) & 255,
                                      want[b[:, pos]], err_msg=str(pos))
    assert {k: const[k] for k in ("E", "PAD", "N_CODE")} == {
        "E": E, "PAD": dna.PAD, "N_CODE": dna.N_CODE}


def test_kernel_quality_map_wraps_as_int8():
    """The kernel's four-byte quality map gives each byte of a word, in each
    position, all 256 values, (int8)(q - 33) for q >= 33 (wrapping above
    160) and 0 below, as the plain version."""
    qual_word = _qual_word_model()
    words, b = _words_with_every_byte_everywhere()
    got = np.array([qual_word(w) for w in words], np.uint32)
    want = np.where(np.arange(256) >= 33, np.arange(256) - 33, 0) & 255
    for pos in range(4):
        np.testing.assert_array_equal((got >> 8 * pos) & 255,
                                      want[b[:, pos]], err_msg=str(pos))


def _from_col(c, lo):
    """csrc/encode.cu's `from_col`: 0xFF in byte j when c + j >= lo (a
    funnel shift, its count clamped to 32)."""
    M = 0xFFFFFFFF
    return (M << min(max(8 * (lo - c), 0), 32)) & M


def _below_col(c, hi):
    return ~_from_col(c, hi) & 0xFFFFFFFF


def _kernel_model(seqs, quals, two_half, seq_at, qual_at, rng):
    """csrc/encode.cu read by read as the card runs it: each stream's bytes
    at an address seq_at / qual_at past a 16-byte boundary amid junk; each
    read's spans (`plan`) widened to 16 bytes and copied into a stage full
    of junk at GUARD (+ TAIL_AT for a tail), PAD_BELOW bytes of junk
    below it; then the words of each row from the stage (`stage_word`),
    through the word maps and the masks of the read's key. Returns codes,
    qv [B, 2E] and qsum [B] as numpy."""
    _, k = _source_constants()
    code_word, _ = _kernel_code_of()
    qual_word = _qual_word_model()
    W2_, GUARD, TAIL_AT, SBUF = k["W2"], k["GUARD"], k["TAIL_AT"], k["SBUF"]
    ONES, PAD_ = k["ONES"], k["PAD"]
    assert k["SPAN"] == 2 * TAIL_AT and k["WORDS"] == W2_ // 4
    chunk = enc.join(seqs, quals)

    def memory(buf, at):
        mem = rng.integers(0, 256, at + len(buf) + 64).astype(np.uint8)
        mem[at:at + len(buf)] = buf
        return mem

    mems = (memory(chunk.seq, seq_at), memory(chunk.qual, qual_at))
    ats = (seq_at, qual_at)
    offs = (chunk.soffs, chunk.qoffs)

    def plan(x, r):
        x0, n = int(offs[x][r]), int(offs[x][r + 1] - offs[x][r])
        a = ats[x] + x0
        oh = a & 15
        if n <= W2_:
            size = (((a + n + 15) & ~15) - (a - oh)) if n else 0
            return [(a - oh, size)], n | oh << 16
        t = a + n - E
        ot = t & 15
        return [(a - oh, ((a + E + 15) & ~15) - (a - oh)),
                (t - ot, ((t + E + 15) & ~15) - (t - ot))], \
            (W2_ + 1) | oh << 16 | ot << 20

    PAD_BELOW = k["PAD_BELOW"]

    def stage_word(buf, i):
        """4 bytes at stage index i of a stage with PAD_BELOW bytes of junk
        before it (the shared memory below a warp's stage)."""
        assert i >= -PAD_BELOW and i + 8 <= SBUF
        j = PAD_BELOW + (i & ~3)
        w = buf[j:j + 8].view(np.uint64)[0]
        return int(w >> np.uint64(8 * (i & 3))) & 0xFFFFFFFF

    B = len(seqs)
    codes = np.zeros((B, W2_), np.uint8)
    qv = np.zeros((B, W2_), np.uint8)
    qsum = np.zeros(B, np.int32)
    for r in range(B):
        bufs, keys = [], []
        for x in range(2):
            spans, key = plan(x, r)
            buf = rng.integers(0, 256, PAD_BELOW + SBUF).astype(np.uint8)
            for h, (a, size) in enumerate(spans):
                if size == 0:           # L = 0: no copy
                    continue
                assert a % 16 == 0 and size % 16 == 0
                assert a >= 0 and a + size <= len(mems[x])
                at = PAD_BELOW + GUARD + h * TAIL_AT
                assert at + size <= PAD_BELOW + GUARD + k["SPAN"]
                buf[at:at + size] = mems[x][a:a + size]
            bufs.append(buf)
            keys.append(key)
        n_s, n_q = keys[0] & 0xFFFF, keys[1] & 0xFFFF
        oh_s, ot_s = keys[0] >> 16 & 15, keys[0] >> 20 & 15
        oh_q, ot_q = keys[1] >> 16 & 15, keys[1] >> 20 & 15
        sb0, qb0 = GUARD + oh_s, GUARD + oh_q
        if two_half:
            sb1 = GUARD + TAIL_AT + ot_s - E if n_s > W2_ else sb0 + n_s - W2_
            qb1 = GUARD + TAIL_AT + ot_q - E if n_q > W2_ else qb0 + n_q - W2_
            sc1, qc1 = max(E, W2_ - n_s), max(E, W2_ - n_q)
            tail = _from_col
        else:
            sb1 = GUARD + TAIL_AT + ot_s - E if n_s > W2_ else sb0
            qb1 = GUARD + TAIL_AT + ot_q - E if n_q > W2_ else qb0
            sc1, qc1 = min(n_s, W2_), min(n_q, W2_)
            tail = _below_col
        sc0, qc0 = min(n_s, E), min(n_q, E)
        uc1 = max(E, 3 * E - n_s)
        acc = 0
        for t in range(k["WORDS"]):
            c = 4 * t
            h = t >= k["HALF_WORDS"]
            sw = stage_word(bufs[0], (sb1 if h else sb0) + c)
            qw = stage_word(bufs[1], (qb1 if h else qb0) + c)
            sin = tail(c, sc1) if h else _below_col(c, sc0)
            qin = tail(c, qc1) if h else _below_col(c, qc0)
            cw = (code_word(sw) & sin) | (PAD_ * ONES & ~sin & 0xFFFFFFFF)
            vw = qual_word(qw) & qin
            um = _from_col(c, uc1) if h else sin
            acc += int(np.frombuffer(int(vw & um).to_bytes(4, "little"),
                                     np.int8).astype(np.int32).sum())
            codes[r, c:c + 4] = np.frombuffer(cw.to_bytes(4, "little"),
                                              np.uint8)
            qv[r, c:c + 4] = np.frombuffer(vw.to_bytes(4, "little"),
                                           np.uint8)
        qsum[r] = acc
    return codes.view(np.int8), qv.view(np.int8), qsum


def _model_reads():
    """The edge set's reads cut to one of each kind (every length class,
    qualities shorter and longer), the reads whose spans start and end at
    every offset in a 16-byte word, and L = 0 / Lq = 0 beside full reads."""
    seqs, quals = chip_smoke.encode_edge_reads(np.random.default_rng(21))
    seqs, quals = seqs[::5], quals[::5]
    more = chip_smoke.encode_shape_reads(np.random.default_rng(22))
    return seqs + more[0], quals + more[1]


@pytest.mark.parametrize("entry", ["two_half", "composite"])
@pytest.mark.parametrize("at", [(0, 0), (1, 15), (7, 3), (15, 8)])
def test_kernel_model_equals_plain(entry, at):
    """The kernel, modelled from its source (spans widened to 16-byte
    addresses into a stage of junk, words at any byte offset, the word
    maps, the masks of each read's key, qsum), gives the plain version's
    rows byte for byte, whatever the sequences' and qualities' addresses
    mod 16 (`at`)."""
    seqs, quals = _model_reads()
    rng = np.random.default_rng(at[0] * 16 + at[1])
    got = _kernel_model(seqs, quals, entry == "two_half", *at, rng)
    want = getattr(enc, f"encode_{entry}_plain")(
        *enc.chunk_inputs(seqs, quals, "cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def _inputs():
    seqs, quals = _synth_reads(np.random.default_rng(5), n=12)
    return enc.chunk_inputs(seqs, quals, "cpu")


def _falls(inp):
    o = inp.soffs.clone()
    o[2] = o[-1] + 1
    return inp._replace(soffs=o, host_soffs=o.numpy())


REFUSALS = {
    "seq_int8": lambda i: i._replace(seq=i.seq.view(torch.int8)),
    "qual_2d": lambda i: i._replace(qual=i.qual[None, :]),
    "soffs_int32": lambda i: i._replace(soffs=i.soffs.int()),
    "qoffs_empty": lambda i: i._replace(qoffs=i.qoffs[:0],
                                        host_qoffs=i.host_qoffs[:0]),
    "falls": _falls,
    "seq_shorter": lambda i: i._replace(seq=i.seq[:-1]),
    "qual_longer": lambda i: i._replace(qual=torch.cat([i.qual,
                                                        i.qual[:1]])),
    "b_differs": lambda i: i._replace(qoffs=i.qoffs[:-1],
                                      host_qoffs=i.host_qoffs[:-1]),
    "host_copy_shape": lambda i: i._replace(host_soffs=i.host_soffs[:-1]),
    "qoffs_from_one": lambda i: i._replace(qoffs=i.qoffs + 1,
                                           host_qoffs=i.host_qoffs + 1),
}


@pytest.mark.parametrize("entry", ["two_half", "composite"])
@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrappers_refuse(case, entry):
    """Wrong dtypes, offsets that fall or do not end at the bytes' size,
    soffs and qoffs of two lengths, a host copy that is not the offsets:
    ValueError, before anything runs."""
    fn = getattr(enc, f"encode_{entry}_dev")
    plain = getattr(enc, f"encode_{entry}_plain")
    bad = REFUSALS[case](_inputs())
    before = plain.launches
    with pytest.raises(ValueError):
        fn(*bad)
    assert plain.launches == before + 1      # it was the plain version's


def test_offsets_on_a_device_need_their_host_copy():
    """Off the CPU the checks read the host's copy of the offsets, never
    the device's: without it the wrapper refuses (before any launch)."""
    inp = _inputs()
    with pytest.raises(ValueError, match="host"):
        enc._sizes(*(t.to("meta") for t in inp[:4]))
    with pytest.raises(ValueError, match="one device"):
        enc._sizes(inp.seq, inp.soffs.to("meta"), inp.qual, inp.qoffs,
                   inp.host_soffs, inp.host_qoffs)
    assert enc._sizes(*inp) == 12


def test_join_refuses_unpaired_lists():
    with pytest.raises(ValueError):
        enc.join([b"ACGT"], [])


@pytest.mark.parametrize("spans", [[(0, 20)], [(0, 1), (1, 20)],
                                   [(0, 7), (7, 13), (13, 20)],
                                   [(0, 19), (19, 20)]])
@pytest.mark.parametrize("route", ["cpu", "staged"])
def test_spans_rebase_and_equal_one_launch(spans, route, monkeypatch):
    """Each span's upload holds its own bytes with offsets rebased to 0;
    the spans' rows, joined, are the whole chunk's. "staged" lays the
    regions out as for a card (offsets, sequence and quality bytes each
    16-byte aligned in one buffer a span) through the pageable route, the
    one a CPU can take."""
    seqs, quals = chip_smoke.encode_edge_reads(np.random.default_rng(6))
    seqs, quals = seqs[::3][:20], quals[::3][:20]
    chunk = enc.join(seqs, quals)
    if route == "staged":
        monkeypatch.setattr(enc, "STAGING_BYTES", 0)
    st = enc.Staged(chunk, spans, "cpu" if route == "cpu" else "cuda")
    assert st.ring_index is None
    whole = enc.encode_two_half_dev(*enc.chunk_inputs(seqs, quals, "cpu"))
    parts = []
    for a, b in spans:
        inp = st.upload(torch.device("cpu"), a, b)
        assert int(inp.soffs[0]) == 0 and int(inp.qoffs[0]) == 0
        assert bytes(inp.seq.numpy()) == b"".join(seqs[a:b])
        assert bytes(inp.qual.numpy()) == b"".join(quals[a:b])
        np.testing.assert_array_equal(inp.soffs.numpy(), inp.host_soffs)
        parts.append(enc.encode_two_half_dev(*inp))
    for w, p in zip(whole, zip(*parts)):
        assert torch.equal(w, torch.cat(p))


@pytest.mark.parametrize("spans", [[(0, 20)], [(0, 1), (1, 20)],
                                   [(0, 7), (7, 13), (13, 20)]])
def test_staged_regions_are_whole_words(spans, monkeypatch):
    """Each span's upload, laid out as for a card (the pageable route, the
    one a CPU can take), is whole 16-byte words: the four tensors lie in
    one buffer whose size is a multiple of 16, each starts on a 16-byte
    boundary of it, and the 16-byte word holding the qualities' last byte
    lies inside it, so the kernel's aligned copies of a span's edges never
    leave the upload."""
    seqs, quals = chip_smoke.encode_edge_reads(np.random.default_rng(6))
    seqs, quals = seqs[1::3][:20], quals[1::3][:20]
    monkeypatch.setattr(enc, "STAGING_BYTES", 0)
    st = enc.Staged(enc.join(seqs, quals), spans, "cuda")
    assert st.ring_index is None
    for a, b in spans:
        inp = st.upload(torch.device("cpu"), a, b)
        store = inp.seq.untyped_storage()
        base = store.data_ptr()
        assert store.nbytes() % 16 == 0
        for t in inp[:4]:
            assert t.untyped_storage().data_ptr() == base
            assert (t.data_ptr() - base) % 16 == 0
        end = inp.qual.data_ptr() - base + inp.qual.numel()
        assert (end + 15) // 16 * 16 <= store.nbytes()
        assert bytes(inp.qual.numpy()) == b"".join(quals[a:b])


class _DoneEvent:
    """A copy's event that has completed."""

    def synchronize(self):
        pass


@pytest.mark.parametrize("free", ["uploaded", "released"])
def test_ring_refuses_to_overwrite_spans_not_uploaded(free, monkeypatch):
    """The staging ring has two buffers: staging a third chunk while the
    first is alive with a span not uploaded raises, and works once that
    chunk has uploaded every span or is gone; an upload from a buffer a
    later chunk took raises. Pinned memory needs a card, so the ring's
    buffers here are pageable."""
    ring = enc._Ring()
    monkeypatch.setattr(ring, "_alloc",
                        lambda cap: torch.empty(cap, dtype=torch.uint8))
    monkeypatch.setattr(enc, "_ring", ring)
    seqs, quals = _synth_reads(np.random.default_rng(9), n=10)
    chunk = enc.join(seqs, quals)
    spans = [(0, 4), (4, 10)]
    first = enc.Staged(chunk, spans, "cuda")
    second = enc.Staged(chunk, spans, "cuda")
    assert (first.ring_index, second.ring_index) == (0, 1)
    with pytest.raises(RuntimeError, match="not uploaded"):
        enc.Staged(chunk, spans, "cuda")
    ring.upload(first.ring_index, first, spans[0], _DoneEvent)
    with pytest.raises(RuntimeError, match=r"\[\(4, 10\)\]"):
        enc.Staged(chunk, spans, "cuda")
    if free == "uploaded":
        ring.upload(first.ring_index, first, spans[1], _DoneEvent)
    else:
        del first
    third = enc.Staged(chunk, spans, "cuda")
    assert third.ring_index == 0
    if free == "uploaded":
        with pytest.raises(RuntimeError, match="taken by a later chunk"):
            ring.upload(0, first, spans[0], _DoneEvent)


def test_mesh_of_two_cpu_shards_equals_one_device():
    """A two-shard CPU mesh encodes each shard's span on its own and gives
    the one-device outputs in every v2 pass and the v1 scan."""
    seqs, quals = _synth_reads(np.random.default_rng(7), n=40)
    pats, _ = dna.encode_batch([w.encode() for w in
                                synth.make_whitelist(np.random.default_rng(7),
                                                     16)], 16)
    outs = []
    for mesh in (None, ["cpu", "cpu"]):
        m = ReadScanModel(TorchConfig(), device="cpu", mesh=mesh)
        m.prepare_search(pats, len(pats))
        before = enc.encode_two_half_plain.launches
        o = (m.finish_pass1(m.scan_pass1_async(seqs, quals)),
             m.finish_pass1_full(m.scan_pass1_full_async(seqs, quals))[:2],
             m.finish_search(m.scan_search_async(seqs, quals)),
             m.scan_reads(seqs, quals))
        assert enc.encode_two_half_plain.launches - before == \
            3 * (1 if mesh is None else 2)
        outs.append(o)
    _same(outs[0], outs[1])


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.fixture
def no_numpy_encoders(monkeypatch):
    """The numpy encoders raise: a pass that reached one would fail."""
    def boom(*a, **kw):
        raise AssertionError("a main-path caller reached a numpy encoder")
    monkeypatch.setattr(eg, "encode_two_half", boom)
    monkeypatch.setattr(readscan, "encode_composite", boom)


@pytest.fixture(scope="module")
def bound_pair():
    """The JAX model and the port's on the CPU over one used list, and
    reads of its barcodes."""
    rng = np.random.default_rng(11)
    wl = synth.make_whitelist(rng, 24)
    pats, _ = dna.encode_batch([w.encode() for w in wl], 16)
    seqs, quals = [], []
    for i in range(48):
        r = synth.make_read(rng, wl[i % 24],
                            cdna_len=int(rng.integers(100, 900)),
                            error_rate=0.04, reverse=bool(i % 2))
        seqs.append(r["seq"])
        quals.append(r["qual"])
    # no N: the JAX package's cached pass 1 redoes reads with N through a
    # path this numpy version refuses (an int8 clip to 255)
    seqs += [b"", b"ACGT", b"ACGT" * 175]
    quals += [b"", b"IIII", b"#" * 690]
    ref = jax_readscan.ReadScanModel(PipelineConfig())
    port = ReadScanModel(TorchConfig(), device="cpu")
    for m in (ref, port):
        m.prepare_search(pats, len(wl))
    return ref, port, seqs, quals


@pytest.mark.parametrize("method", ["pass1", "pass1_full", "search",
                                    "scan_reads"])
def test_passes_equal_jax_without_numpy_encoders(bound_pair,
                                                 no_numpy_encoders, method):
    """With the numpy encoders patched to raise, the CPU passes still give
    the JAX package's rows: they encode through encode_cuda's plain
    versions."""
    ref, port, seqs, quals = bound_pair
    n2, nc = (enc.encode_two_half_plain.launches,
              enc.encode_composite_plain.launches)
    if method == "pass1":
        got = port.finish_pass1(port.scan_pass1_async(seqs, quals))
        want = ref.finish_pass1(ref.scan_pass1_async(seqs, quals))
    elif method == "pass1_full":
        got = port.finish_pass1_full(port.scan_pass1_full_async(seqs,
                                                                quals))[:2]
        want = ref.finish_pass1_full(ref.scan_pass1_full_async(seqs,
                                                               quals))[:2]
    elif method == "search":
        got = port.finish_search(port.scan_search_async(seqs, quals))
        want = ref.finish_search(ref.scan_search_async(seqs, quals))
    else:
        got = port.scan_reads(seqs, quals)
        want = ref.scan_reads(seqs, quals)
    if method == "scan_reads":
        assert enc.encode_composite_plain.launches == nc + 1
    else:
        assert enc.encode_two_half_plain.launches == n2 + 1
    got_d = got if isinstance(got, dict) else got[0]
    want_d = want if isinstance(want, dict) else want[0]
    # the rows both packages name alike (their search rows are named
    # apart; the bc dicts below hold those)
    keys = set(got_d) & set(want_d)
    assert len(keys) >= 10 and {"ps", "pe", "ae", "read_qv"} & keys
    for k in keys:
        np.testing.assert_array_equal(np.asarray(got_d[k]),
                                      np.asarray(want_d[k]), err_msg=k)
    if method == "pass1_full":
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    if method == "search":
        for k in want[1]:
            np.testing.assert_array_equal(got[1][k], np.asarray(want[1][k]),
                                          err_msg=k)


def test_encode_bound_counts_the_bytes_a_row_takes():
    """chip_smoke.encode_bytes (the kernel's bound): each read's and each
    quality string's min(L, 2E) bytes, the two int64 offset arrays, the two
    [B, 2E] rows and, for the two-half entry, qsum."""
    seqs, quals = [b"", b"A" * 10, b"C" * 700], [b"I" * 5, b"", b"#" * 650]
    inp = enc.chunk_inputs(seqs, quals, "cpu")
    rows = 3 * 2 * 2 * E + 2 * 8 * 4
    want = (0 + 10 + 2 * E) + (5 + 0 + 2 * E) + rows
    assert chip_smoke.encode_bytes(inp, False) == want
    assert chip_smoke.encode_bytes(inp, True) == want + 4 * 3
