"""ComputeConsensus — Step 4b.2: per-molecule consensus fastq.

Reimplements programs/ComputeConsensus.java:67-107 + MoleculeDataset
.callConsensus (utils/MoleculeDataset.java:659-743): parse the tagged BAM
(load_sequence=True, gene NOT mandatory, umi mandatory), group into
molecules, and emit one consensus fastq record per molecule named
`BC-U8-RN` (Molecule.getLabel). Per molecule the top-MAXREADS cDNAs by
minimap2 `de` feed the consensus engine (ops.poa host engine /
ops.poa_cuda batched device engine) — no spoa subprocess, no tempfiles.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from sicelore_tpu_torch.core.longread import LongreadParser, TagConfig
from sicelore_tpu_torch.core.molecule import MoleculeDataset
from sicelore_tpu_torch.ops import poa
from sicelore_tpu_torch.utils import trace


def compute_consensus(input_bam, output_fastq, maxreads: int = 20,
                      minps: int = 3, maxps: int = 20,
                      tags: TagConfig | None = None, engine=None,
                      log_json=None, device="cuda"):
    """engine: callable(list_of_molecule_seq_lists) -> list[(cons, qv)].
    None builds the batched device engine on `device` (cuda without a GPU
    raises); "host" asks for the host poa engine molecule-by-molecule.

    One call is one `consensus.call` of the program's tracer (`utils.trace`),
    with the spans `consensus.parse`, `consensus.group`, `consensus.select`,
    the engine's (`consensus.host` with route "asked" for the host engine)
    and `consensus.write` inside it.

    The interpreter's cyclic collector is held off from before the parse
    until the call's objects are freed (`trace.hold_gc`): they die by
    reference count, and a collection inside the call would rescan the
    parsed BAM's records, reads and molecules over and over."""
    with trace.hold_gc():
        return _compute_consensus(input_bam, output_fastq, maxreads, minps,
                                  maxps, tags, engine, log_json, device)


def _compute_consensus(input_bam, output_fastq, maxreads, minps, maxps,
                       tags, engine, log_json, device):
    with trace.call("consensus.call") as call:
        if engine is None:
            from sicelore_tpu_torch.ops.poa_cuda import BatchedConsensusEngine
            engine = BatchedConsensusEngine(maxreads=maxreads, device=device)
        with trace.span("consensus.parse") as sp:
            parser = LongreadParser(input_bam, keep_mapqv0=False,
                                    load_sequence=True, gene_mandatory=False,
                                    umi_mandatory=True, tags=tags)
            if trace.ON:
                sp.set(**dataclasses.asdict(parser.stats))
        with trace.span("consensus.group") as sp:
            dataset = MoleculeDataset(parser)
            sp.set(molecules=len(dataset.molecules))
        with trace.span("consensus.select") as sp:
            jobs = []  # (label, [cdna seqs])
            kept = 0
            for mol in dataset.molecules.values():
                label = f"{mol.barcode}-{mol.umi}-{len(mol.longreads)}"
                # best record per read, top-MAXREADS by ascending de
                # (Consensus ctor sorts evidence by de; Consensus.java:34-50)
                lrs = sorted(mol.longreads, key=lambda lr: lr.best_record().de)
                seqs = [lr.best_record().cdna for lr in lrs[:maxreads]
                        if lr.best_record().cdna]
                jobs.append((label, seqs))
                kept += len(seqs)
            sp.set(reads=kept)
        if engine == "host":
            with trace.span("consensus.host", route="asked",
                            molecules=len(jobs), reads=kept):
                results = [poa.consensus_reads(seqs, minps, maxps)
                           for _, seqs in jobs]
        else:
            results = engine([seqs for _, seqs in jobs], minps=minps,
                             maxps=maxps)
        out = Path(output_fastq)
        out.parent.mkdir(parents=True, exist_ok=True)
        n = 0
        with trace.span("consensus.write") as sp, open(out, "wb") as fh:
            for (label, _), (cons, qv) in zip(jobs, results):
                if not cons:
                    continue
                fh.write(b"@" + label.encode() + b"\n" + cons + b"\n+\n"
                         + qv + b"\n")
                n += 1
            sp.set(records=n, bytes=fh.tell())
        stats = {"molecules": len(jobs), "written": n,
                 "total_records": parser.stats.total_records,
                 "valid_records": parser.stats.valid_records}
        call.set(molecules=len(jobs), written=n)
        if log_json:
            with open(log_json, "w") as fh:
                json.dump(stats, fh, indent=1)
        return stats
