"""Variants of the hand-written kernels, timed on the card, and the host time
of two wrappers. A diagnostic beside chip_smoke.py, not part of the package:
nothing imports it.

    python3 kernel_variants.py band     # where the band kernel's time goes
    python3 kernel_variants.py win1     # window search: threads a block
    python3 kernel_variants.py tile     # tile scan: block shape, general path
    python3 kernel_variants.py edge     # edge scan: parts, general path, reads a block
    python3 kernel_variants.py feed     # tile feed: group size, blocks an SM
    python3 kernel_variants.py pairwise # UMI distances: rows a thread, tile
    python3 kernel_variants.py encode   # read encoding: stages, shape, routes
    python3 kernel_variants.py host [--root DIR]   # wrappers' host time
    python3 kernel_variants.py group [--root DIR]  # a UMI group call's time

band, win1, tile, edge, feed, pairwise and encode build a copy of
csrc/<kernel>.cu
once a variant, the variant made by exact text replacement (and nvcc -D
flags), so an edit of the kernel that moves a patched line makes this script
fail loudly instead of timing something else; all nvcc runs go in parallel.
Every
variant of win1 and tile computes the kernel's results and is checked
against the plain version first. Times: ms a launch, the least of three
bursts of REPS launches between two CUDA events; the base variant runs first
and again last (the least of both). One JSON line a shape: {"shape", "ms":
{variant: ms}}.

band: bandalign.cu with one part compiled out each, so these variants
compute WRONG results (only their time is read): nowalk (no traceback and
no copy-out lookups), nozero (no zero fill of `ins`), fwd = nowalk + nozero
(the forward pass and the repack alone), fwd_noshfl (fwd with every
shuffle an add), fwd_bare (fwd_noshfl without the mask stores and the
global loads: the recurrence's ALU work alone); logscan (the prefix maximum
in log2(G) dependent shuffle levels, same results); w1/w2/w4/w7 (one block
of that many warps an SM). At chip_smoke.py's band shapes.

win1: win1.cu with 128 (base) or 64 threads a block, at the shapes the 5p
edge body and the tile confirms give it.

tile: tilescan.cu with 32 tiles and 128 threads a block (base) or other
shapes (t<tiles>_w<warps>), and `general`, the kernel's general path (k
and mc read at run time) in place of the one with the default k = 15,
mc = 11 compiled in. Over chip_smoke.py's tiles of one 32,768-read 3p
chunk (46,942 tiles) and over its edge tiles (4,096, 11 times over), each
in three copies that launches rotate through (more than the L2 holds).

edge: edgescan.cu as it is (base), through its general path (`general`:
k, mc, c1 and c2 read at run time in place of the default k = 15, mc = 12,
c1 = 8, c2 = 12 compiled in), with 32 reads a block (nr32): these compute
the kernel's results and are checked first; and with one part compiled out
each, which compute WRONG results (only their time is read): l2stage
(every block stages the first block's reads, from the L2: the scan of
realistic reads without their HBM traffic), noscan (no polyA/T
scan: every read takes a fixed run), nosearch (no sense adapter search),
norun (the longest run's counter off: Myers alone in that pass), nobail
(the bailout's levels off: Myers alone in that pass). Over chip_smoke.py's
first 3p and 5p chunks (32,768 reads each), in three copies that launches
rotate through (more than the L2 holds).

feed: tilefeed.cu with 16 reads a group and 4 blocks an SM (base) or
other shapes (r<reads>_b<blocks>; fewer blocks an SM give each block more
groups to pipeline), checked against the plain version first. Over the
covered reads of chip_smoke.py's first 3p chunk (its fused route's index),
in three copies of the codes that launches rotate through.

pairwise: pairwise.cu with R = 1, 2 or 4 pattern rows a thread at every
group size and 64 or 128 texts a tile (r<R>_t<TT>; base: the source's
rule, R = 4 where the items fill the card and 2 elsewhere, at 64), checked
against the plain version first, at chip_smoke.py's 288-, 3,000- and
8,192-UMI groups; each line carries the group's bound
(chip_smoke.pairwise_work at this card's SMs and maximum SM clock).

encode: encode.cu (both entries) built with -D knobs: the base (2
stages a warp, 8 warps a block, 4 blocks an SM, bulk copies in, lanes'
words out, the four-byte map) against s1 / s3 (1 or 3 stages), w<warps>_b
<blocks> (other block shapes), ldg (the lanes copy each span into the
stage with 16-byte ld.global.nc: no copy in flight while a read is
mapped), bulk_store (rows out from shared memory by cp.async.bulk) and
byte_map (byte by byte through a table in shared memory), each checked
against encode_two_half_plain / encode_composite_plain first, over
chip_smoke.py's first 3p and 5p chunks (32,768 reads) in three copies
with fresh content that launches rotate through; each line carries the
bound (chip_smoke.encode_bytes), each variant's share of it and, as a
yardstick of the rate this card reaches, `copy_ms`: one device copy
(`Tensor.copy_`, three sources in turn) that moves as many bytes.

host: chip_smoke.py's `host_us` of each of its `host_calls` (one
`myers_win1`, one `tile_scan`, one 3p and one 5p `edge_scan2` call) against
the `sicelore_tpu_torch` under --root (default: this checkout; a tree whose
edge scan takes text-major [2E, B] codes gets its read transposed). To compare two trees on one card, unpack the
other into a directory that .gitignore lists (`git archive`) and run this
once with --root there and once without, in one command.

group: chip_smoke.py's `host_us` of one `umicluster._pairwise_ed_device`
call on the card (its groups of 288, 3,000 and 8,192 UMIs,
chip_smoke.GROUP_CALLS calls each) for the package under --root, the way
`host` compares two trees.

Needs a CUDA GPU (and nvcc for band, win1, tile, edge, feed, pairwise,
encode)."""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPS = 20

BAND_PATCHES = (
    ("namespace {\n\nconstexpr int MATCH",
     "#ifdef KNOB_NOSHFL\n"
     "#define __shfl_up_sync(m, v, d, w) ((v) + (d))\n"
     "#define __shfl_down_sync(m, v, d, w) ((v) - (d))\n"
     "#endif\nnamespace {\n\nconstexpr int MATCH"),
    ("          sp[c * G] = (unsigned char)bits;\n        }\n      } else {",
     "#ifndef KNOB_NOSTS\n          sp[c * G] = (unsigned char)bits;\n#else\n"
     "          if (bits == 0x12345u) sp[c * G] = 1;\n#endif\n"
     "        }\n      } else {"),
    ("      const unsigned nnw =\n"
     "          (more && nx >= 0) ? *(const unsigned*)(rrow + nx) : 0u;\n"
     "      const unsigned ncw =\n"
     "          more ? *(const unsigned*)(crow + j0 + CPL - 1) : 0u;",
     "#ifdef KNOB_NOLDG\n"
     "      const unsigned nnw = nw * 1664525u + 1013904223u;\n"
     "      const unsigned ncw = (cw * 22695477u + 1u) & 0x03030303u;\n"
     "#else\n"
     "      const unsigned nnw =\n"
     "          (more && nx >= 0) ? *(const unsigned*)(rrow + nx) : 0u;\n"
     "      const unsigned ncw =\n"
     "          more ? *(const unsigned*)(crow + j0 + CPL - 1) : 0u;\n"
     "#endif"),
    ("      for (int k = lane; k < n; k += 32) dst[k] = make_int4(0, 0, 0, 0);",
     "#ifndef KNOB_NOZERO\n"
     "      for (int k = lane; k < n; k += 32) dst[k] = make_int4(0, 0, 0, 0);"
     "\n#endif"),
    ("      if (feas) {\n        int b = btc, j = clen;",
     "#ifdef KNOB_NOWALK\n      if (false) {\n#else\n      if (feas) {\n#endif\n"
     "        int b = btc, j = clen;"),
    ("__device__ __forceinline__ int group_prefix_max(int y) {\n",
     "__device__ __forceinline__ int group_prefix_max(int y) {\n"
     "#ifdef KNOB_LOGSCAN\n"
     "#pragma unroll\n"
     "  for (int d = 1; d < G; d <<= 1)\n"
     "    y = max(y, __shfl_up_sync(FULL, y, d, G));\n"
     "  return y;\n"
     "#endif\n"),
    ("  const size_t smem = wpb * wbytes;",
     "#ifdef KNOB_WARPS\n  wpb = KNOB_WARPS;\n#endif\n"
     "  const size_t smem = wpb * wbytes;"),
    ("  const int grid = min((nsets + wpb - 1) / wpb, sms * max(per_sm, 1));",
     "#ifdef KNOB_WARPS\n"
     "  const int grid = min((nsets + wpb - 1) / wpb, sms);\n"
     "#else\n"
     "  const int grid = min((nsets + wpb - 1) / wpb, sms * max(per_sm, 1));\n"
     "#endif"),
)
FWD = ["-DKNOB_NOWALK", "-DKNOB_NOZERO"]
BAND_VARIANTS = {
    "base": [], "nowalk": ["-DKNOB_NOWALK"], "nozero": ["-DKNOB_NOZERO"],
    "fwd": FWD, "fwd_noshfl": FWD + ["-DKNOB_NOSHFL"],
    "fwd_bare": FWD + ["-DKNOB_NOSHFL", "-DKNOB_NOSTS", "-DKNOB_NOLDG"],
    "logscan": ["-DKNOB_LOGSCAN"],
    "w1": ["-DKNOB_WARPS=1"], "w2": ["-DKNOB_WARPS=2"],
    "w4": ["-DKNOB_WARPS=4"], "w7": ["-DKNOB_WARPS=7"],
}

WIN1_ROWS = "constexpr int ROWS = 128;"
WIN1_SHAPES = ((65_536, 110, 10), (32_768, 110, 22), (32_768, 90, 16),
               (281_652, 160, 22))

TILE_TPB = "constexpr int TPB = 32;"
TILE_THREADS = "constexpr int THREADS = 128;"
TILE_SPECIAL = "  if (P.k == 15 && P.mc == 11)"


def _tile_shape(tpb, threads):
    return [(TILE_TPB, f"constexpr int TPB = {tpb};"),
            (TILE_THREADS, f"constexpr int THREADS = {threads};")]


TILE_VARIANTS = {"base": [], "t16_w2": _tile_shape(16, 64),
                 "t8_w2": _tile_shape(8, 64), "t16_w4": _tile_shape(16, 128),
                 "t64_w8": _tile_shape(64, 256),
                 "general": [(TILE_SPECIAL, "  if (false)")]}


EDGE_NR = "constexpr int NR = 64;"
EDGE_SPECIAL = "  if (P.k == 15 && P.mc == 12 && P.c1 == 8 && P.c2 == 12)"
EDGE_PATCHES = (
    ("  const int lim_p = hl - k + 1;          // starts below it lie in the "
     "read\n",
     "  const int lim_p = hl - k + 1;          // starts below it lie in the "
     "read\n#ifdef KNOB_NOSCAN\n  first = 60;\n  last = 80;\n  return;\n"
     "#endif\n"),
    ("      walk(wn, tab.pair[0][half], sp);",
     "#ifndef KNOB_NOSEARCH\n      walk(wn, tab.pair[0][half], sp);\n"
     "#endif"),
    ("  __device__ __forceinline__ void run(unsigned eq) {\n",
     "  __device__ __forceinline__ void run(unsigned eq) {\n"
     "#ifdef KNOB_NORUN\n    return;\n#endif\n"),
    ("                                       const EdgeParams& P) {\n"
     "    constexpr int L",
     "                                       const EdgeParams& P) {\n"
     "#ifdef KNOB_NOBAIL\n    return;\n#endif\n    constexpr int L"),
    ("    const uint4* g = reinterpret_cast<const uint4*>(codes + (size_t)b0 "
     "* ROWB);",
     "#ifdef KNOB_L2STAGE\n"
     "    const uint4* g = reinterpret_cast<const uint4*>(codes);\n#else\n"
     "    const uint4* g = reinterpret_cast<const uint4*>(codes + (size_t)b0 "
     "* ROWB);\n#endif"),
)
EDGE_VARIANTS = {
    "base": ([], []),
    "general": ([(EDGE_SPECIAL, "  if (false)")], []),
    "nr32": ([(EDGE_NR, "constexpr int NR = 32;")], []),
    "l2stage": ([], ["-DKNOB_L2STAGE"]), "noscan": ([], ["-DKNOB_NOSCAN"]),
    "nosearch": ([], ["-DKNOB_NOSEARCH"]), "norun": ([], ["-DKNOB_NORUN"]),
    "nobail": ([], ["-DKNOB_NOBAIL"]),
}
EDGE_EXACT = ("base", "general", "nr32")


FEED_RPB = "constexpr int RPB = 16;"
FEED_BPS = "constexpr int BLOCKS_PER_SM = 4;"


def _feed_shape(rpb, bps):
    return [(FEED_RPB, f"constexpr int RPB = {rpb};"),
            (FEED_BPS, f"constexpr int BLOCKS_PER_SM = {bps};")]


FEED_VARIANTS = {"base": [], **{f"r{r}_b{b}": _feed_shape(r, b) for r, b in (
    (16, 2), (16, 8), (8, 8), (8, 16), (32, 4), (32, 8))}}


PAIR_R = ("constexpr int R_WIDE = 4;", "constexpr int R_NARROW = 2;")
PAIR_TT = "constexpr int TT = 64;"


def _pair_shape(r, tt):
    """R rows a thread at every group size, TT texts a tile."""
    return [(PAIR_R[0], f"constexpr int R_WIDE = {r};"),
            (PAIR_R[1], f"constexpr int R_NARROW = {r};"),
            (PAIR_TT, f"constexpr int TT = {tt};")]


PAIR_VARIANTS = {"base": [], **{f"r{r}_t{tt}": _pair_shape(r, tt)
                                for tt in (64, 128) for r in (1, 2, 4)}}


ENCODE_VARIANTS = {
    "base": [], "s1": ["-DENC_STAGES=1"], "s3": ["-DENC_STAGES=3"],
    "w4_b8": ["-DENC_WARPS=4", "-DENC_BLOCKS=8"],
    "w8_b2": ["-DENC_WARPS=8", "-DENC_BLOCKS=2"],
    "w8_b8": ["-DENC_WARPS=8", "-DENC_BLOCKS=8"],
    "w16_b2": ["-DENC_WARPS=16", "-DENC_BLOCKS=2"],
    "ldg": ["-DENC_BULK_COPY=0"], "bulk_store": ["-DENC_BULK_STORE=1"],
    "byte_map": ["-DENC_WORD_MAP=0"],
}


def patched(src: str, reps) -> str:
    for old, new in reps:
        if src.count(old) != 1:
            raise SystemExit(f"kernel_variants: the kernel source no longer "
                             f"holds exactly once:\n{old}")
        src = src.replace(old, new)
    return src


def build(stem, variants, entry, n_ptr, n_int, common=()):
    """csrc/<stem>.cu with `common` replacements, then once a variant with
    its own: variants {name: ([(old, new), ...], [nvcc flags])}. All nvcc
    runs in parallel; returns {name: the bound C entry}."""
    from sicelore_tpu_torch.ops import _build
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise SystemExit("kernel_variants: nvcc not found")
    src = patched((_build.CSRC / f"{stem}.cu").read_text(), common)
    out = _build.BUILD_DIR.parent / "kernel_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, (reps, flags) in variants.items():
        cu = out / f"{stem}_{k}.cu"
        cu.write_text(patched(src, reps))
        with open(cu.with_suffix(".log"), "w") as log:
            procs[k] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, *flags, f"-I{_build.CSRC}", "-o",
                 str(cu.with_suffix(".so")), str(cu)],
                stdout=log, stderr=subprocess.STDOUT)
    fns = {}
    for k, p in procs.items():
        if p.wait():
            raise SystemExit(f"kernel_variants: nvcc failed on {stem} {k}:\n"
                             + (out / f"{stem}_{k}.log").read_text())
        fns[k] = bind_built(out / f"{stem}_{k}.so", entry, n_ptr, n_int)
    return fns


def bind_built(lib: Path, entry, n_ptr, n_int):
    """C entry `entry` of a built variant library: n_ptr pointers, n_int
    ints and the stream, returning a cudaError_t as int."""
    f = getattr(ctypes.CDLL(str(lib)), entry)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def least_ms(launch, args) -> float:
    """ms a launch: the least of three bursts of REPS launches, launch i
    taking args[i % len(args)]."""
    import torch
    best = None
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        for i in range(REPS):
            launch(args[i % len(args)])
        b.record()
        torch.cuda.synchronize()
        t = a.elapsed_time(b) / REPS
        best = t if best is None else min(best, t)
    return best


def in_turns(names, launch, check, args) -> dict:
    """{variant: ms}, base first and again last; check(name) before timing."""
    ms = {}
    for k in [*names, "base"]:
        check(k)
        t = least_ms(lambda a: launch(k, a), args)
        ms[k] = min(t, ms.get(k, t))
    return ms


def run_band() -> None:
    import numpy as np
    import torch

    import chip_smoke
    from sicelore_tpu_torch.ops import _build
    fns = build("bandalign", {k: ([], f) for k, f in BAND_VARIANTS.items()},
                "bandalign_launch", 8, 4, common=BAND_PATCHES)
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = _build.stream_handle(dev)
    rng = np.random.default_rng(chip_smoke.SEED + 100)
    for Lc, W, n_pairs, lo, hi in chip_smoke.BAND_SHAPES:
        reads, rl, mids, cm, cl = chip_smoke.band_pairs(rng, Lc, W, n_pairs,
                                                        lo, hi, dev)
        P = reads.shape[0]
        al = torch.empty((P, Lc + 1), dtype=torch.int8, device=dev)
        ins = torch.empty((P, Lc + 1, 4, 4), dtype=torch.int8, device=dev)
        fe = torch.empty((P,), dtype=torch.int32, device=dev)
        # more shared memory than a block may ask: no such variant here
        names = [k for k in BAND_VARIANTS
                 if not (k[0] == "w" and int(k[1:]) * 32 * Lc > 232_448)]

        def launch(k, _):
            _build.check(fns[k](reads.data_ptr(), rl.data_ptr(),
                                mids.data_ptr(), cm.data_ptr(), cl.data_ptr(),
                                al.data_ptr(), ins.data_ptr(), fe.data_ptr(),
                                P, cm.shape[0], Lc, W, stream), k)
        print(json.dumps({"shape": [Lc, W, P], "ms": in_turns(
            names, launch, lambda k: None, [None])}), flush=True)


def run_win1() -> None:
    import numpy as np
    import torch

    from sicelore_tpu_torch.ops import _build, editdist
    fns = build("win1", {"base": ([], []),
                         "rows64": ([(WIN1_ROWS,
                                      "constexpr int ROWS = 64;")], [])},
                "win1_launch", 2, 7)
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = _build.stream_handle(dev)
    rng = np.random.default_rng(7)
    for B, W, m in WIN1_SHAPES:
        wins = torch.randint(0, 6, (B, W), dtype=torch.int8, device=dev)
        peq = editdist.build_peq(rng.integers(0, 4, m).astype(np.int8)[None])
        pq = peq[:, 0].view(np.int32).tolist()
        ref = torch.stack(editdist.myers_win1_plain(wins, peq, m)).int()
        res = torch.empty((2, B), dtype=torch.int32, device=dev)

        def launch(k, _):
            _build.check(fns[k](wins.data_ptr(), res.data_ptr(), B, W, m,
                                *pq, stream), k)

        def check(k):
            launch(k, None)
            if not torch.equal(res, ref):
                raise SystemExit(f"kernel_variants: win1 {k} differs from "
                                 f"the plain version at {B} x {W}")
        print(json.dumps({"shape": [B, W, m], "ms": in_turns(
            fns, launch, check, [None])}), flush=True)


def chunk_reads(chem: str = "3p"):
    """chip_smoke.py's first 3p or 5p chunk (same seeds)."""
    import numpy as np

    import chip_smoke
    from sicelore_tpu_torch.io import fastq
    from sicelore_tpu_torch.ops import _build
    from sicelore_tpu_torch.utils import synth
    rng = np.random.default_rng(chip_smoke.SEED)
    wl = synth.make_whitelist(rng, chip_smoke.N_WHITELIST)
    cells = [wl[i] for i in sorted(rng.choice(
        chip_smoke.N_WHITELIST, chip_smoke.N_CELLS, replace=False).tolist())]
    path = _build.BUILD_DIR.parent / "kernel_variants" / "reads0.fastq"
    path.parent.mkdir(parents=True, exist_ok=True)
    chip_smoke.make_file((str(path), chip_smoke.SEED + (301 if chem == "5p"
                                                        else 1), cells, chem))
    chunk = next(fastq.read_fastq(path, chip_smoke.READS_PER_FILE))
    path.unlink()
    return chunk


def chunk_tiles():
    """chip_smoke.py's tiles of its first 3p chunk (same seeds)."""
    from sicelore_tpu_torch.models import readscan
    from sicelore_tpu_torch.utils.config import PipelineConfig
    return readscan.build_tiles(chunk_reads().seqs, PipelineConfig())[0]


def run_edge() -> None:
    import torch

    import chip_smoke
    from sicelore_tpu_torch.ops import _build
    from sicelore_tpu_torch.ops import edgescan as eg
    from sicelore_tpu_torch.ops import edgescan_cuda as ec
    from sicelore_tpu_torch.utils.config import PipelineConfig
    fns = build("edgescan", EDGE_VARIANTS, "edgescan_launch", 4, 2,
                common=EDGE_PATCHES)
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = _build.stream_handle(dev)
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    for chem in ("3p", "5p"):
        chunk = chunk_reads(chem)
        codes, _, lens, _ = eg.encode_two_half(chunk.seqs, chunk.quals)
        p = eg.edge_params(PipelineConfig(chemistry=chem))
        prm = ec.kernel_params(p)
        B = codes.shape[0]
        ld = torch.from_numpy(lens).to(dev)
        copies = [torch.from_numpy(codes).to(dev)]
        ar = torch.arange(B, device=dev)
        for _ in range(2):              # one base a read changed
            c = copies[0].clone()
            col = torch.randint(0, 2 * eg.E, (B,), device=dev, generator=g)
            keep = c[ar, col] != 5
            c[ar[keep], col[keep]] = torch.randint(
                0, 4, (B,), device=dev, generator=g,
                dtype=torch.int8)[keep]
            copies.append(c)
        ref = eg.edge_scan2_plain(copies[0][:, :eg.E], copies[0][:, eg.E:],
                                  ld, p)
        res = torch.empty_like(ref)

        def launch(k, c):
            _build.check(fns[k](c.data_ptr(), ld.data_ptr(), res.data_ptr(),
                                prm.ctypes.data, B, prm.size, stream), k)

        def check(k):
            if k not in EDGE_EXACT:
                return
            launch(k, copies[0])
            if not torch.equal(res, ref):
                raise SystemExit(f"kernel_variants: edge {k} differs from "
                                 f"the plain version ({chem})")
        print(json.dumps({"shape": [chem, B], "ms": in_turns(
            fns, launch, check, copies)}), flush=True)


def run_tile() -> None:
    import torch

    import chip_smoke
    from sicelore_tpu_torch.ops import _build
    from sicelore_tpu_torch.ops import tilescan_cuda as ts
    from sicelore_tpu_torch.utils.config import PipelineConfig
    fns = build("tilescan", {k: (r, []) for k, r in TILE_VARIANTS.items()},
                "tilescan_launch", 3, 2)
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = _build.stream_handle(dev)
    tp = ts.tile_params(PipelineConfig())
    prm = ts.kernel_params(tp)
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    for name, rows in (("chunk", torch.from_numpy(chunk_tiles())),
                       ("edge", torch.from_numpy(
                           chip_smoke.tile_edge_rows(4096)).repeat(11, 1))):
        T = rows.shape[0]
        copies = [rows.to(dev)]
        for _ in range(2):              # one base a tile changed
            r = copies[0].clone()
            c = torch.randint(0, 256, (T,), device=dev, generator=g)
            r[torch.arange(T, device=dev), c] = torch.randint(
                0, 4, (T,), device=dev, generator=g, dtype=torch.uint8) * 17
            copies.append(r)
        ref = ts.tile_scan_plain(copies[0], tp)
        res = torch.empty((3, T), dtype=torch.int32, device=dev)

        def launch(k, r):
            _build.check(fns[k](r.data_ptr(), res.data_ptr(), prm.ctypes.data,
                                T, prm.size, stream), k)

        def check(k):
            launch(k, copies[0])
            if not torch.equal(res, ref):
                raise SystemExit(f"kernel_variants: tile {k} differs from "
                                 f"the plain version ({name} tiles)")
        print(json.dumps({"shape": [name, T], "ms": in_turns(
            fns, launch, check, copies)}), flush=True)


def run_feed() -> None:
    import torch

    import chip_smoke
    from sicelore_tpu_torch.ops import _build
    from sicelore_tpu_torch.ops import edgescan as eg
    from sicelore_tpu_torch.ops import tilescan_cuda as ts
    from sicelore_tpu_torch.utils.config import PipelineConfig
    fns = build("tilefeed", {k: (r, []) for k, r in FEED_VARIANTS.items()},
                "tilefeed_launch", 4, 4)
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = _build.stream_handle(dev)
    tp = ts.tile_params(PipelineConfig())
    chunk = chunk_reads()
    codes, _, lens, _ = eg.encode_two_half(chunk.seqs, chunk.quals)
    B = codes.shape[0]
    ld = torch.from_numpy(lens).to(dev)
    idx = chip_smoke.covered_index(lens, tp, dev)
    C = idx.shape[0]
    copies = [torch.from_numpy(codes).to(dev) for _ in range(3)]
    ref = ts.tile_feed_plain(copies[0], ld, idx, tp)
    res = torch.empty_like(ref)

    def launch(k, c):
        _build.check(fns[k](c.data_ptr(), ld.data_ptr(), idx.data_ptr(),
                            res.data_ptr(), B, C, tp.edge, tp.k, stream), k)

    def check(k):
        res.zero_()
        launch(k, copies[0])
        if not torch.equal(res, ref):
            raise SystemExit(f"kernel_variants: feed {k} differs from the "
                             f"plain version")
    print(json.dumps({"shape": ["covered", C, B], "ms": in_turns(
        fns, launch, check, copies)}), flush=True)


def run_pairwise() -> None:
    import torch

    import chip_smoke
    from sicelore_tpu_torch.ops import _build, editdist
    fns = build("pairwise", {k: (r, []) for k, r in PAIR_VARIANTS.items()},
                "pairwise_launch", 3, 2)
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = _build.stream_handle(dev)
    sm_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])
    int32_hz = (torch.cuda.get_device_properties(dev).multi_processor_count
                * chip_smoke.INT32_LANES_PER_SM * sm_hz)
    groups = chip_smoke.umi_groups()
    for name in ("g288", "g3000", "g8192"):
        umis = groups[name]
        raw, offs, ho = editdist.group_inputs(umis, dev)
        K, S = len(umis), raw.numel()
        ref = editdist.myers_global_group_plain(raw, offs, ho)
        res = torch.empty_like(ref)

        def launch(k, _):
            _build.check(fns[k](raw.data_ptr(), offs.data_ptr(),
                                res.data_ptr(), K, S, stream), k)

        def check(k):
            res.fill_(-1)
            launch(k, None)
            if not torch.equal(res, ref):
                raise SystemExit(f"kernel_variants: pairwise {k} differs "
                                 f"from the plain version ({name})")
        ops, nb = chip_smoke.pairwise_work([len(u) for u in umis])
        print(json.dumps({"shape": [name, K], "ms": in_turns(
            fns, launch, check, [None]), **chip_smoke.bound(
                nb, ops, int32_hz)}), flush=True)
        del ref, res


def run_encode() -> None:
    import torch

    import chip_smoke
    from sicelore_tpu_torch.ops import _build
    from sicelore_tpu_torch.ops import encode_cuda as enc
    two = build("encode", {k: ([], f) for k, f in ENCODE_VARIANTS.items()},
                "encode_two_half_launch", 7, 1)
    out = _build.BUILD_DIR.parent / "kernel_variants"
    comp = {k: bind_built(out / f"encode_{k}.so", "encode_composite_launch",
                          6, 1) for k in ENCODE_VARIANTS}
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = _build.stream_handle(dev)
    sm_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])
    int32_hz = (torch.cuda.get_device_properties(dev).multi_processor_count
                * chip_smoke.INT32_LANES_PER_SM * sm_hz)
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 1100)
    for chem in ("3p", "5p"):
        chunk = chunk_reads(chem)
        inp = enc.chunk_inputs(chunk.seqs, chunk.quals, dev)
        # three copies of the bytes (more than the L2 holds), each with
        # fresh content, that launches rotate through
        copies = [inp] + chip_smoke.encode_variants(inp, g, 2)
        B = len(chunk.seqs)
        for entry, fns in (("two_half", two), ("composite", comp)):
            plain = getattr(enc, f"encode_{entry}_plain")(*copies[0])
            got = [torch.empty_like(t) for t in plain]
            if entry == "composite":
                got.append(None)

            def launch(k, a):
                ptrs = [a.seq.data_ptr(), a.soffs.data_ptr(),
                        a.qual.data_ptr(), a.qoffs.data_ptr(),
                        *(t.data_ptr() for t in got if t is not None)]
                _build.check(fns[k](*ptrs, B, stream), f"encode {k}")

            def check(k):
                for t in got:
                    if t is not None:
                        t.fill_(-1)
                launch(k, copies[0])
                if not all(torch.equal(x, p) for x, p in zip(got, plain)):
                    raise SystemExit(f"kernel_variants: encode {k} differs "
                                     f"from the plain version ({chem}, "
                                     f"{entry})")
            ms = in_turns(fns, launch, check, copies)
            b = chip_smoke.bound(chip_smoke.encode_bytes(
                inp, entry == "two_half"), 0, int32_hz)
            # a yardstick: one device copy that moves as many bytes (half
            # read, half written), from three sources in turn
            srcs = [torch.empty(b["bytes"] // 2, dtype=torch.uint8,
                                device=dev) for _ in range(3)]
            dst = torch.empty_like(srcs[0])
            copy_ms = least_ms(dst.copy_, srcs)
            print(json.dumps({"shape": [chem, entry, B], "ms": ms, **b,
                              "share": {k: b["bound_ms"] / t
                                        for k, t in ms.items()},
                              "copy_ms": copy_ms,
                              "copy_share": b["bound_ms"] / copy_ms}),
                  flush=True)
            del srcs, dst
        del copies, inp
        torch.cuda.empty_cache()


def _package_under(root: Path):
    """chip_smoke (this checkout's) with the sicelore_tpu_torch under root
    first on the path."""
    import chip_smoke                      # puts HERE first on the path
    sys.path.insert(0, str(root))          # the package under test first
    import sicelore_tpu_torch
    if not Path(sicelore_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"kernel_variants: imported "
                         f"{sicelore_tpu_torch.__file__}, not the package "
                         f"under {root}")
    return chip_smoke


def run_group(root: Path) -> None:
    import torch
    chip_smoke = _package_under(root)
    from sicelore_tpu_torch.core import umicluster
    groups = chip_smoke.umi_groups()
    dev = torch.device("cuda")
    print(json.dumps({"root": str(root), "group_call_us": {
        g: chip_smoke.host_us(
            lambda u=groups[g]: umicluster._pairwise_ed_device(u, dev), n)
        for g, n in chip_smoke.GROUP_CALLS.items()}}), flush=True)


def run_host(root: Path) -> None:
    import torch
    chip_smoke = _package_under(root)
    calls = chip_smoke.host_calls(torch.device("cuda"))
    try:
        calls["edgescan"]()
    except ValueError:      # a tree whose edge scan takes text-major [2E, B]
        for key in ("edgescan", "edgescan_5p"):
            f = calls[key]
            calls[key] = functools.partial(f.func, f.args[0].t().contiguous(),
                                           *f.args[1:])
    print(json.dumps({"root": str(root), "host_us": {
        k: chip_smoke.host_us(fn) for k, fn in calls.items()}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("band", "win1", "tile", "edge", "feed",
                                     "pairwise", "encode", "host", "group"))
    ap.add_argument("--root", default=str(HERE),
                    help="host, group: the checkout whose package is timed")
    a = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    if a.what in ("host", "group"):
        {"host": run_host, "group": run_group}[a.what](
            Path(a.root).resolve())
    else:
        {"band": run_band, "win1": run_win1, "tile": run_tile,
         "edge": run_edge, "feed": run_feed, "pairwise": run_pairwise,
         "encode": run_encode}[a.what]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
