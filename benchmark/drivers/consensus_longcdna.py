"""Step 4b, `pipeline.consensus.compute_consensus`, on full-length cDNA:
molecules whose truths lie in the traffic's length bands
(`gen/longcdna.py`), written as the consensus cells' tagged BAM. The call
and the control are the consensus driver's; the judgement holds each
length band apart as well (`reference/longcdna.py`)."""
from __future__ import annotations

import time

import numpy as np

from benchmark.drivers.consensus import (  # noqa: F401 (the harness's names)
    LABELS, State, call, control_call)
from benchmark.gen import longcdna as gen
from benchmark.gen.molecules import write_molecules
from benchmark.harness.cell import Cell
from benchmark.reference import longcdna as ref

make_molecules = gen.make_molecules


def setup(cell: Cell) -> State:
    t = time.time()
    mols = gen.make_molecules(np.random.default_rng(cell.seed), cell.mix)
    bam = cell.workdir / "tagged.bam"
    cell.setup_parts["input_bytes"] = write_molecules(bam, mols)
    cell.setup_parts["inputs_s"] = time.time() - t
    cell.setup_parts["records"] = mols.n_records
    return State(cell, mols, bam)


def judge(state: State, out) -> dict:
    return ref.judge(out / "consensus.fastq", state.mols,
                     state.cell.config["consensus"])
