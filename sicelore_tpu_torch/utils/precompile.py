"""Build every CUDA kernel and launch each once at a scanfastq run's shapes.

The port compiles nothing per shape: eager PyTorch traces nothing, and the
hand-written kernels are built once from `csrc/*.cu` by `ops/_build.py`,
which keys each library by a hash of its sources, so a built kernel is
never built again (the role the reference package's on-disk compile cache
plays). What a first call still pays is the nvcc build, the library load
and the first launch of each kernel on the card. `warm` pays them up front:

  - builds every `csrc/*.cu` (`_build.build_all`, one nvcc a source, all in
    parallel);
  - launches the read encoding (both entries), the edge scan, the
    whitelist sweep (at `n_bc` barcodes), the tile feed (on the encoding's
    rows), the tile scan and the window search once each at a scanfastq
    chunk's shapes
    (CHUNK reads; with `full`, also the smaller tail chunks), the band
    aligner at the consensus buckets (Lc 256 and 512; with `full`, 1,024
    and 2,048) and at the aligner's gap buckets (Lc 64; with `full`, 128
    and 256), the host engine's alignment on molecules with an N (with
    `full`, also on a center over the largest bucket), and the UMI distance
    matrix at a group of 288 UMIs (with `full`, also one of 3,000);
  - returns {kernel: ms}, the wall time of each kernel's warm calls.

Each launch is checked by the wrapper's launch counter: a warm-up that did
not reach a kernel raises. Without a GPU, `device="cuda"` raises
(`device.resolve`), and without nvcc the build raises (`_build`). On
`device="cpu"` there is nothing to build: it says so and returns {}.

Usage: `python -m sicelore_tpu_torch precompile [--nbc N] [--full]
[--device cuda|cpu]`.
"""
from __future__ import annotations

import sys
import time

KERNELS = ("encode_two_half", "encode_composite", "edgescan", "bcsweep",
           "tilefeed", "tilescan", "win1", "bandalign", "hostnw", "pairwise")
CHUNK = 50_000    # reads a scanfastq chunk (ScanFastqPipeline's chunk_size)


def _counters():
    from sicelore_tpu_torch.ops import bcsearch, editdist, hostnw_cuda
    from sicelore_tpu_torch.ops import encode_cuda as enc
    from sicelore_tpu_torch.ops import poa_cuda
    from sicelore_tpu_torch.ops import tilescan_cuda as ts
    from sicelore_tpu_torch.ops.edgescan_cuda import edge_scan2
    return {"encode_two_half": enc.encode_two_half_dev,
            "encode_composite": enc.encode_composite_dev,
            "edgescan": edge_scan2, "bcsweep": bcsearch.bc_sweep,
            "tilefeed": ts.tile_feed, "tilescan": ts.tile_scan,
            "win1": editdist.myers_win1, "bandalign": poa_cuda.band_align,
            "hostnw": hostnw_cuda.host_nw,
            "pairwise": editdist.myers_global_group}


def _reads(rng, n: int, length: int) -> list[bytes]:
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    codes = acgt[rng.integers(0, 4, (n, length))]
    return [r.tobytes() for r in codes]


def jobs(dev, n_bc: int, full: bool, chunk: int) -> list:
    """[(name, kernel, fn)]: the warm calls on `dev`, each of which launches
    `kernel` at least once (on a CPU device they run the plain bodies)."""
    import numpy as np
    import torch

    from sicelore_tpu_torch.align.extend import GapBatcher
    from sicelore_tpu_torch.core import umicluster
    from sicelore_tpu_torch.models import readscan
    from sicelore_tpu_torch.ops import encode_cuda as enc
    from sicelore_tpu_torch.ops import tilescan_cuda as ts
    from sicelore_tpu_torch.ops.poa_cuda import BatchedConsensusEngine
    from sicelore_tpu_torch.utils import dna, synth
    from sicelore_tpu_torch.utils.config import PipelineConfig

    rng = np.random.default_rng(0)
    model = readscan.ReadScanModel(PipelineConfig(), device=dev)
    wl = synth.make_whitelist(rng, n_bc)
    pats, _ = dna.encode_batch([w.encode() for w in wl], 16)
    model.prepare_search(pats, len(wl), radius=2)

    # a cached run's pass 1 (edge scan) gives the BC windows its pass-2
    # sweep takes; the v1 composite scan (random-barcode control) runs the
    # window search
    wins = {}

    def pass1(seqs, quals):
        wins[len(seqs)] = model.finish_pass1_full(
            model.scan_pass1_full_async(seqs, quals))[1]

    def feed(seqs, quals):
        inp = enc.chunk_inputs(seqs, quals, dev)
        codes = enc.encode_two_half_dev(*inp)[0]
        idx = np.nonzero(ts.feed_covered(np.diff(inp.host_soffs),
                                         model._tile_params))[0]
        ts.tile_feed(codes, inp.lens(),
                     torch.from_numpy(idx.astype(np.int32)).to(dev),
                     model._tile_params)

    out = []
    for B in [chunk] + ([4_096, 256] if full else []):
        seqs = _reads(rng, B, 600)
        quals = [b"I" * 600] * B
        for entry in ("encode_two_half", "encode_composite"):
            out.append((f"{entry}_B{B}", entry,
                        lambda s=seqs, q=quals, e=entry: getattr(
                            enc, f"{e}_dev")(*enc.chunk_inputs(s, q, dev))))
        out.append((f"edgescan_B{B}", "edgescan",
                    lambda s=seqs, q=quals: pass1(s, q)))
        out.append((f"tilefeed_B{B}", "tilefeed",
                    lambda s=seqs, q=quals: feed(s, q)))
        out.append((f"bcsweep_B{B}_N{n_bc}", "bcsweep",
                    lambda B=B: model.finish_bc_sweep(
                        model.bc_sweep_async(wins[B]))))
        out.append((f"win1_B{B}", "win1",
                    lambda s=seqs, q=quals: model.scan_reads(s, q)))
    for T in [512] + ([64, 2_048] if full else []):
        long_seqs = _reads(rng, max(T // 3, 1), 3_000)
        out.append((f"tilescan_reads{len(long_seqs)}", "tilescan",
                    lambda s=long_seqs: model.finish_internal_tiles(
                        model.internal_tiles_async(s))))

    engine = BatchedConsensusEngine(device=dev)
    for lc in [256, 512] + ([1_024, 2_048] if full else []):
        mols = []
        for _ in range(8):
            t = _reads(rng, 1, lc - 8)[0]
            mols.append([synth.mutate_np(rng, t, 0.03) for _ in range(3)])
        out.append((f"bandalign_consensus_L{lc}", "bandalign",
                    lambda m=mols: engine(m)))
    for lc in [64] + ([128, 256] if full else []):
        def gaps(lc=lc):
            gb = GapBatcher(device=dev)
            for _ in range(256):
                R = _reads(rng, 1, lc - 8)[0]
                gb.add(R, synth.mutate_np(rng, R, 0.03)[:len(R) + 4])
            gb.run()
        out.append((f"bandalign_gap_L{lc}", "bandalign", gaps))
    # molecules the engine leaves to the host engine: an N (with `full`,
    # also centers over its largest bucket), their pairs in one launch
    for lc in [600] + ([2_200] if full else []):
        mols = []
        for _ in range(8):
            t = bytearray(_reads(rng, 1, lc)[0])
            t[lc // 2] = ord("N")
            mols.append([synth.mutate_np(rng, bytes(t), 0.03)
                         for _ in range(3)])
        out.append((f"hostnw_L{lc}", "hostnw", lambda m=mols: engine(m)))
    for K in [288] + ([3_000] if full else []):
        umis = [dna.decode(rng.integers(0, 4, 12)).encode()
                for _ in range(K)]
        out.append((f"pairwise_K{K}", "pairwise",
                    lambda u=umis: umicluster._pairwise_ed_device(u, dev)))

    return out


def warm(n_bc: int = 8192, full: bool = False, device="cuda",
         log=None) -> dict:
    """Build every kernel and launch each at production shapes; returns
    {kernel: ms} (see the module docstring)."""
    if log is None:
        def log(*a):
            print(*a, file=sys.stderr, flush=True)

    import torch

    from sicelore_tpu_torch.device import resolve
    from sicelore_tpu_torch.ops import _build

    dev = resolve(device)
    if dev.type == "cpu":
        log("precompile: nothing to build on cpu (the plain torch bodies "
            "compile nothing)")
        return {}
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {len(built)} kernels in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    counters = _counters()
    times = {k: 0.0 for k in KERNELS}
    for name, kernel, fn in jobs(dev, n_bc, full, CHUNK):
        before = counters[kernel].launches
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t) * 1e3
        if counters[kernel].launches == before:
            raise RuntimeError(f"precompile: {name} launched no {kernel} "
                               "kernel")
        times[kernel] += ms
        log(f"{name}: {ms:.1f} ms")
    return {k: round(v, 3) for k, v in times.items()}
