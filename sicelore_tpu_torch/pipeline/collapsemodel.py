"""CollapseModel / AnnotateModel programs — Step 7.

Reference programs/CollapseModel.java:151-193 orchestration:
loader -> collapser -> initialize -> filter -> classifier ->
[validator if CAGE+POLYA(+SHORT)] -> statistics -> exportFiles.
"""
from __future__ import annotations

import json
from pathlib import Path

from sicelore_tpu_torch.core.collapse import CollapsedModel
from sicelore_tpu_torch.core.longread import TagConfig
from sicelore_tpu_torch.core.matrix import load_cell_list
from sicelore_tpu_torch.core.refflat import RefFlatModel
from sicelore_tpu_torch.io.bed import BedModel


def collapse_model(isobam, refflat, csv, outdir, prefix="CollapseModel",
                   delta=2, min_evidence=2, rn_min=1,
                   cage_bed=None, polya_bed=None, short_bam=None,
                   cage_cutoff=50, polya_cutoff=50, junc_cutoff=1,
                   tags: TagConfig | None = None):
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    refmodel = RefFlatModel.load(refflat)
    model = CollapsedModel(refmodel, delta=delta, min_evidence=min_evidence,
                           rn_min=rn_min)
    cells = set(load_cell_list(csv))
    model.load_isobam(isobam, cells, tags=tags)
    model.collapse()
    model.initialize()
    model.filter()
    model.classify()
    if cage_bed or polya_bed or short_bam:
        cage = BedModel.load(cage_bed) if cage_bed else None
        polya = BedModel.load(polya_bed) if polya_bed else None
        model.validate(cage, polya, short_bam, cage_cutoff, polya_cutoff,
                       junc_cutoff)
    stats = model.statistics()
    model.export(outdir, prefix)
    with open(outdir / f"{prefix}_stats.json", "w") as fh:
        json.dump(stats, fh, indent=1)
    return stats
