"""Step 4b, `pipeline.consensus.compute_consensus`: a tagged BAM in (the
cell's molecules, made once in set-up from the seed), the consensus fastq
written. A call counts the molecules it read."""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from benchmark.gen import molecules as gen
from benchmark.harness.cell import Cell
from benchmark.reference import consensus as ref

LABELS = (
    "sicelore_tpu_torch.pipeline.consensus:compute_consensus",
    "sicelore_tpu_torch.pipeline.consensus:LongreadParser",
    "sicelore_tpu_torch.pipeline.consensus:MoleculeDataset",
    "sicelore_tpu_torch.ops.poa_cuda:BatchedConsensusEngine.__call__",
    "sicelore_tpu_torch.ops.poa:consensus_reads",
)


@dataclass
class State:
    cell: Cell
    mols: gen.Molecules
    bam: object


def setup(cell: Cell) -> State:
    t = time.time()
    mols = gen.make_molecules(np.random.default_rng(cell.seed), cell.mix)
    bam = cell.workdir / "tagged.bam"
    cell.setup_parts["input_bytes"] = gen.write_molecules(bam, mols)
    cell.setup_parts["inputs_s"] = time.time() - t
    cell.setup_parts["records"] = mols.n_records
    return State(cell, mols, bam)


def call(state: State, out, maxps: int | None = None) -> int:
    """One Step 4b run into out; maxps (the control only) in place of the
    configuration's."""
    from sicelore_tpu_torch.pipeline.consensus import compute_consensus
    c = state.cell.config["consensus"]
    out.mkdir(parents=True)
    stats = compute_consensus(state.bam, out / "consensus.fastq",
                              maxreads=c["maxreads"], minps=c["minps"],
                              maxps=c["maxps"] if maxps is None else maxps,
                              device=state.cell.device)
    return stats["molecules"]


def control_call(state: State, out) -> None:
    """The control: the program with a guarantee the configuration states
    broken, the quality cap MAXPS one lower."""
    call(state, out, maxps=state.cell.config["consensus"]["maxps"] - 1)


def judge(state: State, out) -> dict:
    return ref.judge(out / "consensus.fastq", state.mols,
                     state.cell.config["consensus"])
