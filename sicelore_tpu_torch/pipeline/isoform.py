"""IsoformMatrix program — Step 4: cell x isoform/gene/junction matrices.

Reimplements the reference's programs/IsoformMatrix.java:85-178: parse BAM
-> MoleculeDataset -> STRICT isoform assignment -> matrices + metrics
writers (+ optional ISOBAM pass re-writing the input with IG/IT tags).
"""
from __future__ import annotations

import json
from pathlib import Path

from sicelore_tpu_torch.core.longread import LongreadParser, TagConfig
from sicelore_tpu_torch.core.matrix import load_cell_list
from sicelore_tpu_torch.core.molecule import MoleculeDataset
from sicelore_tpu_torch.io.bam import BamReader, BamWriter


def isoform_matrix(input_bam, refflat, csv, outdir, prefix="sicelore",
                   delta=2, method="STRICT", ambiguous_assign=False,
                   mapqv0=False, isobam=False, tobulk=False,
                   tags: TagConfig | None = None, seed: int = 0):
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    cells = load_cell_list(csv)
    parser = LongreadParser(input_bam, keep_mapqv0=mapqv0,
                            load_sequence=False, gene_mandatory=True,
                            umi_mandatory=True, tags=tags)
    dataset = MoleculeDataset(parser)
    dataset.init_model(refflat)
    dataset.set_isoforms(delta, method, ambiguous_assign, seed=seed)
    matrix = dataset.produce_matrix(cells)

    p = outdir / prefix
    matrix.write_isoform_matrix(f"{p}_isomatrix.txt", f"{p}_isometrics.txt",
                                f"{p}_molinfos.txt", dataset.model)
    matrix.write_gene_matrix(f"{p}_genematrix.txt", f"{p}_genemetrics.txt")
    matrix.write_cell_metrics(f"{p}_cellmetrics.txt")
    matrix.write_junction_matrix(f"{p}_juncmatrix.txt",
                                 f"{p}_juncmetrics.txt")
    if tobulk:
        matrix.write_bulk(f"{p}_bulkgene.txt", f"{p}_bulkiso.txt",
                          dataset.model)

    log = {
        "total_records": parser.stats.total_records,
        "valid_records": parser.stats.valid_records,
        "chimeria_records": parser.stats.chimeria_records,
        "gene_unset": parser.stats.gene_unset,
        "umi_unset": parser.stats.umi_unset,
        "molecules": len(dataset.molecules),
        "total_reads": dataset.total_reads,
        "multi_ig": dataset.multi_ig,
        "monoexon": dataset.stats.monoexon,
        "onematch": dataset.stats.onematch,
        "ambiguous": dataset.stats.ambiguous,
        "nomatch": dataset.stats.nomatch,
        "total_junctions": dataset.stats.total_junctions,
        "matrix_cells": len(matrix.cell_metrics),
        "matrix_genes": len(matrix.gene_metrics),
        "matrix_isoforms": len(matrix.matrice),
        "matrix_junctions": len(matrix.matrice_junction),
        "isoform_def": matrix.total_isoform_def,
        "isoform_undef": matrix.total_isoform_undef,
    }
    with open(f"{p}.log", "w") as fh:
        json.dump(log, fh, indent=1)

    # HTML report (reference IsoformMatrix.java:236-289)
    from sicelore_tpu_torch.report import html as _html
    per_cell = sorted((cm.nb_umis for cm in matrix.cell_metrics.values()),
                      reverse=True)
    _html.write_html(
        f"{p}.html", "sicelore_tpu IsoformMatrix",
        [("UMIs per cell", _html.knee_plot(per_cell,
                                           title="UMIs per cell")),
         ("Isoform assignment", _html.svg_bars(
             ["monoexon", "onematch", "ambiguous", "nomatch"],
             [dataset.stats.monoexon, dataset.stats.onematch,
              dataset.stats.ambiguous, dataset.stats.nomatch],
             title="molecules per assignment outcome", ylabel="molecules")),
         ("Statistics", _html.stats_table(log))])

    if isobam:
        tagcfg = tags or TagConfig()
        with BamReader(input_bam) as rd, \
             BamWriter(outdir / f"{prefix}_isobam.bam", rd.header) as w:
            for r in rd:
                bc = r.get_tag(tagcfg.cell)
                u8 = r.get_tag(tagcfg.umi)
                mol = dataset.get_molecule(
                    f"{(bc or '').replace('-1', '')}:{u8}")
                if mol is not None:
                    r.set_tag("IG", mol.gene_id or "undef", "Z")
                    r.set_tag("IT", mol.transcript_id or "undef", "Z")
                else:
                    r.set_tag("IG", "undef", "Z")
                    r.set_tag("IT", "undef", "Z")
                w.write(r)
    return log
