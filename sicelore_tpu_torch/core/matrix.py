"""Cell x gene/isoform/junction UMI count matrices + writers.

Reimplements the reference's Matrix (utils/Matrix.java): three nested maps
keyed isoform/gene/junction -> cell -> UMI set, with the exact output file
formats of :158-386 (writeIsoformMatrix/_isometrics/_molinfos,
writeJunctionMatrix, writeGeneMatrix, writeCellMetrics, writeBulk).

Determinism policy (reference output column order follows Java hash
iteration; SURVEY §7): columns follow the CellList file order; rows follow
first-insertion order — stable and documented, compared order-insensitively
against reference outputs.
"""
from __future__ import annotations

from pathlib import Path

from sicelore_tpu_torch.core.molecule import Molecule
from sicelore_tpu_torch.core.refflat import RefFlatModel


class CellMetrics:
    __slots__ = ("isoform_known", "isoform_undef", "nb_reads", "genes",
                 "nb_umis")

    def __init__(self):
        self.isoform_known = 0
        self.isoform_undef = 0
        self.nb_reads = 0
        self.genes: set[str] = set()
        self.nb_umis = 0

    def add(self, gene_id: str, transcript_id: str, nb_reads: int):
        self.nb_umis += 1
        self.nb_reads += nb_reads
        self.genes.add(gene_id)
        if transcript_id == "undef":
            self.isoform_undef += 1
        else:
            self.isoform_known += 1


class GeneMetrics:
    __slots__ = ("known", "undef")

    def __init__(self):
        self.known = 0
        self.undef = 0

    def add(self, transcript_id: str):
        if transcript_id == "undef":
            self.undef += 1
        else:
            self.known += 1


class Matrix:
    def __init__(self, cells):
        self.cells: list[str] = list(cells)
        self.cell_metrics: dict[str, CellMetrics] = {
            c: CellMetrics() for c in self.cells}
        self.gene_metrics: dict[str, GeneMetrics] = {}
        # isokey "gene\ttranscript" -> cell -> set(umi)
        self.matrice: dict[str, dict[str, set]] = {}
        self.matrice_gene: dict[str, dict[str, set]] = {}
        self.matrice_junction: dict[str, dict[str, set]] = {}
        self.molecules: list[Molecule] = []
        self.total_count = 0
        self.total_isoform_def = 0
        self.total_isoform_undef = 0

    def add_molecule(self, mol: Molecule):
        """Matrix.addMolecule (:62-156): authorized cells only."""
        cm = self.cell_metrics.get(mol.barcode)
        if cm is None:
            return
        self.molecules.append(mol)
        gm = self.gene_metrics.setdefault(mol.gene_id, GeneMetrics())
        cm.add(mol.gene_id, mol.transcript_id, len(mol.longreads))
        gm.add(mol.transcript_id)
        if mol.transcript_id == "undef":
            self.total_isoform_undef += 1
        else:
            self.total_isoform_def += 1
        isokey = f"{mol.gene_id}\t{mol.transcript_id}"
        self.matrice.setdefault(isokey, {}).setdefault(
            mol.barcode, set()).add(mol.umi)
        self.matrice_gene.setdefault(mol.gene_id, {}).setdefault(
            mol.barcode, set()).add(mol.umi)
        for (js, je) in mol.junction_set:
            junckey = f"{mol.gene_id}:{js}-{je}"
            self.matrice_junction.setdefault(junckey, {}).setdefault(
                mol.barcode, set()).add(mol.umi)

    # -- writers (formats: Matrix.java:158-386) --------------------------

    def write_isoform_matrix(self, isomatrix, isometrics, molinfos,
                             model: RefFlatModel | None):
        with open(isomatrix, "w") as os, open(isometrics, "w") as os2, \
             open(molinfos, "w") as os3:
            os.write("geneId\ttranscriptId\tnbExons")
            os2.write("geneId\ttranscriptId\tnbExons\tnbUmis\n")
            for c in self.cells:
                os.write("\t" + c)
            os.write("\n")
            for isokey, bycell in self.matrice.items():
                gene, tr = isokey.split("\t")
                if model is not None:
                    trr = model.select_one(gene, tr)
                    nb_exon = len(trr.exons) if trr is not None else 0
                    os.write(f"{isokey}\t{nb_exon}")
                    os2.write(f"{isokey}\t{nb_exon}")
                else:
                    os.write(f"{isokey}\tna")
                    os2.write(f"{isokey}\tna")
                total = 0
                for c in self.cells:
                    s = bycell.get(c)
                    n = len(s) if s else 0
                    os.write(f"\t{n}")
                    total += n
                    self.total_count += n
                os.write("\n")
                os2.write(f"\t{total}\n")
            os3.write("cellBC\tUMI\tnbReads\tnbSupportingReads\t"
                      "mappingPctId\tsnpPhredScore\tgeneId\ttranscriptId\n")
            for m in self.molecules:
                os3.write(f"{m.barcode}\t{m.umi}\t{m.n_reads()}\t"
                          f"{m.supporting_reads}\t{m.pct_id}\t{m.snp_phred}\t"
                          f"{m.gene_id}\t{m.transcript_id}\n")

    def write_junction_matrix(self, juncmatrix, juncmetrics):
        with open(juncmatrix, "w") as os, open(juncmetrics, "w") as os2:
            os.write("junctionId")
            os2.write("junctionId\tnbUmis\n")
            for c in self.cells:
                os.write("\t" + c)
            os.write("\n")
            for junckey, bycell in self.matrice_junction.items():
                os.write(junckey)
                os2.write(junckey)
                total = 0
                for c in self.cells:
                    s = bycell.get(c)
                    n = len(s) if s else 0
                    os.write(f"\t{n}")
                    total += n
                os.write("\n")
                os2.write(f"\t{total}\n")

    def write_gene_matrix(self, genematrix, genemetrics):
        with open(genematrix, "w") as os:
            os.write("geneId")
            for c in self.cells:
                os.write("\t" + c)
            os.write("\n")
            for gene, bycell in self.matrice_gene.items():
                os.write(gene)
                for c in self.cells:
                    s = bycell.get(c)
                    os.write(f"\t{len(s) if s else 0}")
                os.write("\n")
        with open(genemetrics, "w") as os2:
            os2.write("geneId\tnbUmis\tnbIsoformSet\tnbIsoformNotSet\n")
            for gene, gm in self.gene_metrics.items():
                os2.write(f"{gene}\t{gm.known + gm.undef}\t{gm.known}\t"
                          f"{gm.undef}\n")

    def write_cell_metrics(self, path):
        with open(path, "w") as os:
            os.write("cellBC\tnbReads\tnbGenes\tnbUmis\tnbIsoformSet\t"
                     "nbIsoformNotSet\n")
            for c in self.cells:
                cm = self.cell_metrics[c]
                os.write(f"{c}\t{cm.nb_reads}\t{len(cm.genes)}\t{cm.nb_umis}"
                         f"\t{cm.isoform_known}\t{cm.isoform_undef}\n")

    def write_bulk(self, bulkgene, bulkiso, model: RefFlatModel | None):
        """writeBulk (:308-360): per-gene / per-isoform totals."""
        with open(bulkgene, "w") as os:
            os.write("geneId\tnbUmis\n")
            for gene, bycell in self.matrice_gene.items():
                total = sum(len(s) for s in bycell.values())
                os.write(f"{gene}\t{total}\n")
        with open(bulkiso, "w") as os:
            os.write("geneId\ttranscriptId\tnbUmis\n")
            for isokey, bycell in self.matrice.items():
                total = sum(len(s) for s in bycell.values())
                os.write(f"{isokey}\t{total}\n")


def load_cell_list(path: str | Path) -> list[str]:
    """csv -> barcodes, stripping -1 suffix (utils/CellList.java:22)."""
    out, seen = [], set()
    for line in open(path):
        bc = line.strip().split(",")[0].replace("-1", "")
        if bc and bc not in seen:
            seen.add(bc)
            out.append(bc)
    return out
