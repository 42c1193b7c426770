"""On-card smoke test of the PyTorch/CUDA port: `python3 chip_smoke.py`.

Needs one CUDA GPU, nvcc and the repository checkout around this file.
Phases (one JSON line each, with its seconds):

  env       nvidia-smi name and power limit, torch/CUDA/nvcc versions,
            whether the native host codecs loaded, the kernel build time.
  kernels   every CUDA kernel of the scanfastq path against its plain
            PyTorch version on the card, at the main path's shapes: the
            edge scan over a 32,768-read chunk, the whitelist sweep of its
            BC windows against 8,192 and 49,152 barcodes, the chimera scan
            over all tiles of the chunk. Tolerance: exact (integer outputs;
            mismatches must be 0). Median ms of each over >= 5 timed calls
            (CUDA events), each call on freshly mutated content.
  pipeline  `ScanFastqPipeline.run` on `cuda` over a synthetic run of
            131,072 reads in 4 fastq files (8,192 cells drawn from a
            65,536-barcode whitelist; 4% error, ~6% 2-8 kb reads, ~2%
            chimeras, ~2% garbage, ~1% with N near an end), cached pass 1,
            32,768-read chunks. Launch counts are zeroed just before and
            read just after: every kernel must have launched, no plain
            body may have run.
  parity    the same pipeline on a 4,096-read subset on `cuda` and on `cpu`
            (plain bodies): every output file byte-identical, and assigned
            barcodes agreeing with the generator's truth.

Then: the {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises: no ok line, exit != 0.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

N_FILES = 4
READS_PER_FILE = 32_768
N_WHITELIST = 65_536
N_CELLS = 8_192
SWEEP_LISTS = (8_192, 49_152)
N_PARITY = 4_096
TIMED_CALLS = 5
SEED = 20_240_601


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_file(args) -> int:
    """Write one synthetic fastq file (worker process). Read names carry
    the truth: r<i>c<cell index>, x<i> chimera, g<i> garbage."""
    path, seed, cells = args
    import numpy as np

    from sicelore_tpu.utils import synth
    rng = np.random.default_rng(seed)
    with open(path, "wb") as fh:
        for i in range(READS_PER_FILE):
            u = rng.random()
            ci = int(rng.integers(0, len(cells)))
            rev = bool(rng.random() < 0.5)
            if u < 0.06:
                name = f"r{i}c{ci}"
                r = synth.make_read(rng, cells[ci],
                                    cdna_len=int(rng.integers(2000, 8000)),
                                    error_rate=0.04, reverse=rev)
            elif u < 0.08:
                name = f"x{i}"
                r = synth.make_chimera(
                    rng, cells[ci], cells[int(rng.integers(0, len(cells)))],
                    cdna_len=int(rng.integers(300, 700)), error_rate=0.04)
            elif u < 0.10:
                name = f"g{i}"
                L = int(rng.integers(60, 900))
                r = {"seq": synth.random_seq(rng, L).encode(),
                     "qual": bytes(33 + int(x)
                                   for x in rng.integers(2, 30, L))}
            else:
                name = f"r{i}c{ci}"
                r = synth.make_read(rng, cells[ci],
                                    cdna_len=int(rng.integers(300, 700)),
                                    error_rate=0.04, reverse=rev)
            seq = bytearray(r["seq"])
            if rng.random() < 0.01 and len(seq) > 0:
                for _ in range(int(rng.integers(1, 4))):
                    p = int(rng.integers(0, min(304, len(seq))))
                    seq[p if rng.random() < 0.5 else len(seq) - 1 - p] = 78
            fh.write(b"@%s\n%s\n+\n%s\n" % (name.encode(), bytes(seq),
                                            r["qual"]))
    return READS_PER_FILE


def timed(fn, variants, sync):
    """Median ms of fn(v) over the variants, CUDA events around each call."""
    import torch
    ms, outs = [], []
    for v in variants:
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(v)
        b.record()
        sync()
        ms.append(a.elapsed_time(b))
        outs.append(out)
    return sorted(ms)[len(ms) // 2], outs


def compare(name, fn_k, fn_p, variants):
    """Kernel vs plain on every variant, alternating which runs first:
    total mismatches, max |kernel - plain|, median ms of each."""
    import torch
    sync = torch.cuda.synchronize
    fn_k(variants[0])
    fn_p(variants[0])              # warm both (library load, allocator)
    sync()
    ms = {"k": [], "p": []}
    mism = maxd = 0
    for i, v in enumerate(variants):
        res = {}
        for tag, fn in ((("p", fn_p), ("k", fn_k)) if i % 2 == 0
                        else (("k", fn_k), ("p", fn_p))):
            t, outs = timed(fn, [v], sync)
            ms[tag].append(t)
            res[tag] = outs[0]
        k, p = res["k"], res["p"]
        if k.shape != p.shape or k.dtype != p.dtype:
            raise SystemExit(f"{name}: kernel {tuple(k.shape)} {k.dtype} vs "
                             f"plain {tuple(p.shape)} {p.dtype}")
        mism += int((k != p).sum())
        if k.numel():
            maxd = max(maxd, int((k.long() - p.long()).abs().max()))
    med = {t: sorted(v)[len(v) // 2] for t, v in ms.items()}
    return {"mismatches": mism, "max_abs_err": maxd, "ms": med["k"],
            "plain_ms": med["p"], "calls": len(variants)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from sicelore_tpu.utils import synth

    # synthetic inputs and outputs (~0.5 GB): inside the checkout, removed
    # at the end
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    (work / "run").mkdir(parents=True)
    dev = torch.device("cuda")

    # ---- env (+ data generation in 4 worker processes meanwhile) ----
    rng = np.random.default_rng(SEED)
    wl = synth.make_whitelist(rng, N_WHITELIST)
    cells = [wl[i] for i in sorted(rng.choice(N_WHITELIST, N_CELLS,
                                              replace=False).tolist())]
    pool = mp.get_context("spawn").Pool(N_FILES)
    try:
        return _run(pool, wl, cells, work, dev)
    finally:
        pool.terminate()
        pool.join()
        shutil.rmtree(work, ignore_errors=True)


def _run(pool, wl, cells, work, dev) -> int:
    import numpy as np
    import torch

    from sicelore_tpu.io import fastq, native
    from sicelore_tpu.pipeline import readname
    from sicelore_tpu.utils import dna
    from sicelore_tpu.utils.config import PipelineConfig
    from sicelore_tpu_torch.models import readscan
    from sicelore_tpu_torch.ops import _build, bcsearch, editdist
    from sicelore_tpu_torch.ops import edgescan as eg
    from sicelore_tpu_torch.ops import tilescan_cuda as ts
    from sicelore_tpu_torch.ops.edgescan_cuda import edge_scan2
    from sicelore_tpu_torch.pipeline.scanfastq import ScanFastqPipeline

    t0 = time.time()
    gen = pool.map_async(make_file, [
        (str(work / "run" / f"reads{i}.fastq"), SEED + 1 + i, cells)
        for i in range(N_FILES)])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, timeout=60).stdout.strip(
                              ).splitlines()[-1] if nvcc else None
    _build.build_all()
    for stem in ("edgescan", "bcsweep", "tilescan"):
        _build.load(stem)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_ver,
          "gpu": torch.cuda.get_device_name(0),
          "hostenc": native.get_hostenc() is not None,
          "build_s": _build.build_seconds, "s": round(time.time() - t0, 2)})

    t0 = time.time()
    gen.get(timeout=900)
    emit({"phase": "data", "reads": N_FILES * READS_PER_FILE,
          "files": N_FILES, "whitelist": N_WHITELIST, "cells": N_CELLS,
          "s": round(time.time() - t0, 2)})

    # ---- kernels vs plain at the main path's shapes ----
    t0 = time.time()
    cfg = PipelineConfig()
    chunk = next(fastq.read_fastq(work / "run" / "reads0.fastq",
                                  READS_PER_FILE))
    B = len(chunk)
    codes, _, lens, _ = eg.encode_two_half(chunk.seqs, chunk.quals)
    codes_tm = torch.from_numpy(codes).to(dev).t().contiguous()
    lens_d = torch.from_numpy(lens).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def mutate_reads(ct):
        """One substituted base per read, inside the read (fresh content)."""
        ct = ct.clone()
        col = (torch.rand(B, device=dev, generator=g)
               * torch.clamp(lens_d, 1, eg.E)).long()
        col = torch.where(torch.rand(B, device=dev, generator=g) < 0.5, col,
                          2 * eg.E - 1 - col)
        val = torch.randint(0, 4, (B,), device=dev, generator=g,
                            dtype=torch.int8)
        keep = ct[col, torch.arange(B, device=dev)] != dna.PAD
        ct[col[keep], torch.arange(B, device=dev)[keep]] = val[keep]
        return ct

    ep = eg.edge_params(cfg)
    variants = [codes_tm] + [mutate_reads(codes_tm)
                             for _ in range(TIMED_CALLS)]
    results = {}
    results["edgescan"] = compare(
        "edgescan", lambda c: edge_scan2(c, lens_d, ep),
        lambda c: eg.edge_scan2_plain(c[:eg.E].t(), c[eg.E:].t(), lens_d, ep),
        variants)
    meta = edge_scan2(codes_tm, lens_d, ep)
    wins = meta[eg.ROW_BC0:].to(torch.uint8).contiguous()

    def mutate_wins(w):
        w = w.clone()
        r = torch.randint(0, w.shape[0], (B,), device=dev, generator=g)
        w[r, torch.arange(B, device=dev)] = torch.randint(
            0, 4, (B,), device=dev, generator=g, dtype=torch.uint8)
        return w

    wvars = [mutate_wins(wins) for _ in range(TIMED_CALLS)]
    m = cfg.barcodes.cell_bc_length
    cell_set = set(cells)
    others = [w for w in wl if w not in cell_set]
    for n_bc in SWEEP_LISTS:
        pats, _ = dna.encode_batch([s.encode() for s in
                                    (cells + others)[:n_bc]], m)
        peq = bcsearch.peq_device(editdist.build_peq(pats), dev)
        results[f"bcsweep_{n_bc}"] = compare(
            f"bcsweep[{n_bc}]",
            lambda w: bcsearch.bc_sweep(w, peq, n_bc, m, track_pos=True),
            lambda w: bcsearch.bc_sweep_plain(w, peq, n_bc, m,
                                              track_pos=True),
            wvars)
    rows, _, _ = readscan.build_tiles(chunk.seqs, cfg)
    rows_d = torch.tensor(rows, device=dev)
    tp = ts.tile_params(cfg)

    def mutate_tiles(r):
        r = r.clone()
        T = r.shape[0]
        c = torch.randint(0, 256, (T,), device=dev, generator=g)
        r[torch.arange(T, device=dev), c] = torch.randint(
            0, 4, (T,), device=dev, generator=g, dtype=torch.uint8) * 17
        return r

    results["tilescan"] = compare(
        "tilescan", lambda r: ts.tile_scan(r, tp),
        lambda r: ts.tile_scan_plain(r, tp),
        [rows_d] + [mutate_tiles(rows_d) for _ in range(TIMED_CALLS)])
    emit({"phase": "kernels", "reads": B, "tiles": int(rows.shape[0]),
          "tolerance": "exact", "results": results,
          "s": round(time.time() - t0, 2)})
    bad = {k: v["mismatches"] for k, v in results.items() if v["mismatches"]}
    if bad:
        raise SystemExit(f"kernel/plain mismatches: {bad}")
    del variants, wvars, rows_d, meta, wins, codes_tm
    torch.cuda.empty_cache()

    # ---- the main path: scanfastq on cuda ----
    counters = (edge_scan2, bcsearch.bc_sweep, ts.tile_scan,
                eg.edge_scan2_plain, bcsearch.bc_sweep_plain,
                ts.tile_scan_plain)
    t0 = time.time()
    pipe = ScanFastqPipeline(cfg, whitelist=wl, chunk_size=READS_PER_FILE,
                             user_max_ed=2, cache_pass1=True, device="cuda")
    for c in counters:
        c.launches = 0
    t_run = time.time()
    stats = pipe.run([work / "run"], work / "out_cuda")
    torch.cuda.synchronize()
    run_s = time.time() - t_run
    launches = {"edgescan": edge_scan2.launches,
                "bcsweep": bcsearch.bc_sweep.launches,
                "tilescan": ts.tile_scan.launches}
    plain = {"edgescan": eg.edge_scan2_plain.launches,
             "bcsweep": bcsearch.bc_sweep_plain.launches,
             "tilescan": ts.tile_scan_plain.launches}
    total = N_FILES * READS_PER_FILE
    emit({"phase": "pipeline", "reads": stats.total_reads,
          "used_list": len(pipe.used_strs), "run_s": round(run_s, 3),
          "reads_per_s": round(total / run_s, 1), "stats": stats.to_json(),
          "launches": launches, "plain_launches": plain,
          "s": round(time.time() - t0, 2)})
    if min(launches.values()) < 1 or any(plain.values()):
        raise SystemExit(f"main path launches {launches}, plain {plain}")
    if (stats.total_reads != total or stats.stranded < 0.8 * total
            or stats.bc_assigned < 0.6 * total
            or stats.split_chimeric < 1):
        raise SystemExit(f"implausible scan stats: {stats.to_json()}")

    # ---- parity: cuda vs cpu (plain bodies) on a subset ----
    t0 = time.time()
    sub = work / "parity_in"
    sub.mkdir()
    head = next(fastq.read_fastq(work / "run" / "reads0.fastq", N_PARITY))
    with open(sub / "subset.fastq", "wb") as fh:
        for n, s, q in zip(head.names, head.seqs, head.quals):
            fh.write(b"@%s\n%s\n+\n%s\n" % (n, s, q))
    blobs = {}
    for d in ("cuda", "cpu"):
        p = ScanFastqPipeline(cfg, whitelist=wl, chunk_size=1024,
                              user_max_ed=2, cache_pass1=True, device=d)
        p.run([sub], work / f"parity_{d}")
        out = work / f"parity_{d}"
        blobs[d] = {str(f.relative_to(out)): f.read_bytes()
                    for f in sorted(out.rglob("*")) if f.is_file()
                    and f.name != "ReadScanner.html"}
    same = sorted(k for k in blobs["cuda"]
                  if blobs["cpu"].get(k) == blobs["cuda"][k])
    n_ok = n_tot = 0
    for f in sorted((work / "parity_cuda" / "passed").iterdir()):
        for ch in fastq.read_fastq(f):
            for nm in ch.names:
                info = readname.parse_name(nm)
                if info is None:
                    raise SystemExit(f"unparsable passed name {nm!r}")
                o = info.orig_name
                if o.startswith("r") and "c" in o and "sp" not in o:
                    n_tot += 1
                    n_ok += info.bc == cells[int(o.split("c")[1])]
    emit({"phase": "parity", "reads": len(head), "files": len(blobs["cuda"]),
          "identical": len(same), "bc_truth_agree": n_ok, "bc_checked": n_tot,
          "s": round(time.time() - t0, 2)})
    if set(blobs["cuda"]) != set(blobs["cpu"]) or \
            len(same) != len(blobs["cuda"]):
        diff = sorted(set(blobs["cuda"]) ^ set(blobs["cpu"])
                      | (set(blobs["cuda"]) - set(same)))
        raise SystemExit(f"cuda/cpu outputs differ: {diff}")
    if n_tot < 1000 or n_ok < 0.97 * n_tot:
        raise SystemExit(f"barcode truth agreement {n_ok}/{n_tot}")

    src = {"edgescan": ("sicelore_tpu_torch/csrc/edgescan.cu",
                        "sicelore_tpu/ops/edgescan_tpu.py:87", "edgescan"),
           "bcsweep": ("sicelore_tpu_torch/csrc/bcsweep.cu",
                       "sicelore_tpu/ops/bcsearch.py:34",
                       f"bcsweep_{SWEEP_LISTS[0]}"),
           "tilescan": ("sicelore_tpu_torch/csrc/tilescan.cu",
                        "sicelore_tpu/ops/tilescan_tpu.py:51", "tilescan")}
    kernels = []
    for name, (source, replaces, key) in src.items():
        r = results[key]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"]}
        if name == "bcsweep":
            big = results[f"bcsweep_{SWEEP_LISTS[1]}"]
            entry.update({"n_barcodes": SWEEP_LISTS[0],
                          f"ms_n{SWEEP_LISTS[1]}": big["ms"],
                          f"plain_ms_n{SWEEP_LISTS[1]}": big["plain_ms"],
                          "max_abs_err": max(r["max_abs_err"],
                                             big["max_abs_err"])})
        kernels.append(entry)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
