"""Step 1, `ScanFastqPipeline.run`: fastq files in; pass 1, the used list,
pass 2; passed/, failed/, BarcodeList.tsv and the reports written. A call
is a whole run over the cell's pool of fastq files, made once in set-up
from the seed; it counts the pool's input reads."""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from benchmark.gen import reads as gen
from benchmark.harness.cell import Cell, apply_fields
from benchmark.reference import scan as ref

# spans that name what the host was doing in the breakdown's idle gaps
LABELS = (
    "sicelore_tpu_torch.pipeline.scanfastq:ScanFastqPipeline.run",
    "sicelore_tpu_torch.pipeline.scanfastq:ScanFastqPipeline._pass1_apply_cached",
    "sicelore_tpu_torch.pipeline.scanfastq:ScanFastqPipeline.build_used_list",
    "sicelore_tpu_torch.pipeline.scanfastq:ScanFastqPipeline._run_pass2_cached",
    "sicelore_tpu_torch.pipeline.scanfastq:ScanFastqPipeline.pass2_emit",
    "sicelore_tpu_torch.pipeline.scanfastq:ScanFastqPipeline._write_reports",
    "sicelore_tpu_torch.ops.encode_cuda:join",
)


@dataclass
class State:
    cell: Cell
    whitelist: np.ndarray
    files: list
    n_reads: int
    pipeline_cfg: object
    pool: ref.Pool


def setup(cell: Cell) -> State:
    """The whitelist (packed codes), the cells drawn from it, and the pool:
    files_per_run fastq files of reads_per_run reads in all."""
    from sicelore_tpu_torch.utils.config import PipelineConfig
    cfg, mix = cell.config, cell.mix
    t = time.time()
    seqs = np.random.SeedSequence(cell.seed).spawn(cfg["files_per_run"] + 1)
    rng = np.random.default_rng(seqs[0])
    wl = gen.whitelist(rng, cfg["whitelist_barcodes"])
    cells = rng.choice(wl, cfg["cells"], replace=False)
    src = cell.workdir / "fastq_pass"
    src.mkdir()
    per_file = cfg["reads_per_run"] // cfg["files_per_run"]
    files, nbytes = [], 0
    pool = ref.Pool([], [], [], [], ref.barcodes(cells))
    for i in range(cfg["files_per_run"]):
        names, s, q, truth = gen.make_reads(
            np.random.default_rng(seqs[i + 1]), per_file, cells, mix,
            cfg["chemistry"], with_truth=True)
        f = src / f"run{i}.fastq"
        nbytes += gen.write_fastq(f, names, s, q)
        files.append(f)
        for part, v in zip((pool.stems, pool.seqs, pool.quals, pool.truths),
                           (f.stem, s, q, truth)):
            part.append(v)
    cell.setup_parts["inputs_s"] = time.time() - t
    cell.setup_parts["input_bytes"] = nbytes
    return State(cell, wl, files, per_file * len(files),
                 apply_fields(PipelineConfig(), cfg["pipeline"]), pool)


def call(state: State, out, max_ed_cap: int | None = None) -> int:
    """One Step 1 run into out. max_ed_cap (the control only) caps the
    barcode edit distance below the configuration's dynamic table."""
    from sicelore_tpu_torch.pipeline.scanfastq import ScanFastqPipeline
    pipe = ScanFastqPipeline(state.pipeline_cfg, whitelist=state.whitelist,
                             chunk_size=state.cell.config["chunk_size"],
                             device=state.cell.device,
                             user_max_ed=max_ed_cap)
    pipe.run(state.files, out)
    return state.n_reads


def control_call(state: State, out) -> None:
    """The control: the program with a guarantee the configuration states
    broken, the barcode edit distance one below the dynamic table's value
    for the used list (`ScanFastqPipeline.max_ed` of a sound run)."""
    from sicelore_tpu_torch.pipeline.scanfastq import ScanFastqPipeline
    probe = ScanFastqPipeline(state.pipeline_cfg, whitelist=state.whitelist,
                              chunk_size=state.cell.config["chunk_size"],
                              device=state.cell.device)
    probe.run(state.files, out / "probe")
    call(state, out, max_ed_cap=probe.max_ed() - 1)


def judge(state: State, out) -> dict:
    return ref.judge(out, state.pool)
