"""Molecule model + STRICT isoform assignment (the heart of steps 4a/4b).

Reimplements the reference's Molecule/MoleculeDataset
(utils/Molecule.java; utils/MoleculeDataset.java:60-98 grouping by
barcode:umi, :126-178 setIsoforms, :181-292 setIsoformStrictNew,
:594-618 map/isIn junction matching, :631-657 produceMatrix).

STRICT semantics (MoleculeDataset.java:595-618): a SAM record matches a
transcript iff the transcript has >= 1 junction, the record has exactly as
many junctions, and every transcript junction lies within DELTA of SOME
record junction (both coordinates). Candidate votes accumulate per record;
the unique max-vote transcript wins; ties are resolved by a (seeded here —
the reference uses an unseeded Random, MoleculeDataset.java:260) pick;
no candidates -> transcriptId="undef", gene = most frequent gene among the
candidate transcripts (:294-315). A single mono-exonic transcript model
auto-assigns (:194-200). Junction matching is vectorized with numpy over
the [records x transcripts x junctions] block per molecule.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from sicelore_tpu_torch.core.longread import Longread, LongreadParser
from sicelore_tpu_torch.core.refflat import RefFlatModel, TranscriptRecord


class Molecule:
    __slots__ = ("barcode", "umi", "rn", "longreads", "gene_ids",
                 "junction_set", "gene_id", "transcript_id",
                 "supporting_reads", "consensus", "consensus_qv", "pct_id",
                 "snp_phred")

    def __init__(self, barcode: str, umi: str, rn: int = 1):
        self.barcode = barcode
        self.umi = umi
        self.rn = rn
        self.longreads: list[Longread] = []
        self.gene_ids: set[str] = set()
        self.junction_set: set[tuple[int, int]] = set()
        self.gene_id: str | None = None
        self.transcript_id: str | None = None
        self.supporting_reads = 0
        self.consensus: bytes | None = None
        self.consensus_qv: bytes | None = None
        self.pct_id: float = 0.0
        self.snp_phred: str = ""

    def add_longread(self, lr: Longread):
        self.longreads.append(lr)
        if lr.records:
            self.pct_id = 1.0 - lr.records[0].de
        self.gene_ids |= lr.gene_ids

    def n_reads(self) -> int:
        """RN tag wins over list size (Molecule.java:107-112)."""
        return self.rn if self.rn > 1 else len(self.longreads)

    def records(self):
        for lr in self.longreads:
            yield from lr.records


@dataclass
class IsoformStats:
    monoexon: int = 0
    onematch: int = 0
    ambiguous: int = 0
    nomatch: int = 0
    total_junctions: int = 0


def _match_records_vs_transcripts(rec_juncs: list[np.ndarray],
                                  transcripts: list[TranscriptRecord],
                                  delta: int):
    """Vectorized STRICT matcher for one molecule.

    Returns (votes [T] int, matched_ref_junctions set). votes[t] = number of
    records matching transcript t; matched junction collection follows
    MoleculeDataset.map (:609-616): every transcript junction within DELTA
    of any record junction is collected, for ALL record/transcript pairs.
    """
    R, T = len(rec_juncs), len(transcripts)
    votes = np.zeros(T, dtype=np.int64)
    matched: set[tuple[int, int]] = set()
    if R == 0 or T == 0:
        return votes, matched
    jmax_r = max((len(j) for j in rec_juncs), default=0)
    jmax_t = max((len(t.junctions) for t in transcripts), default=0)
    if jmax_t == 0:
        return votes, matched
    BIGC = np.int64(1 << 40)
    rj = np.full((R, max(jmax_r, 1), 2), BIGC, dtype=np.int64)
    rn = np.zeros(R, dtype=np.int64)
    for i, j in enumerate(rec_juncs):
        rj[i, :len(j)] = j
        rn[i] = len(j)
    tj = np.full((T, jmax_t, 2), -BIGC, dtype=np.int64)
    tn = np.zeros(T, dtype=np.int64)
    for i, t in enumerate(transcripts):
        tj[i, :len(t.junctions)] = t.junctions
        tn[i] = len(t.junctions)
    # near[r, t, jt] = transcript junction jt is within DELTA of some
    # record-r junction (both coords)
    ds = np.abs(rj[:, None, :, None, 0] - tj[None, :, None, :, 0])
    de = np.abs(rj[:, None, :, None, 1] - tj[None, :, None, :, 1])
    close = (ds <= delta) & (de <= delta)          # [R, T, jr, jt]
    near = close.any(axis=2)                       # [R, T, jt]
    jt_idx = np.arange(jmax_t)
    covered = near | (jt_idx[None, None, :] >= tn[None, :, None])
    all_covered = covered.all(axis=2)              # [R, T]
    match = all_covered & (rn[:, None] == tn[None, :]) & (tn[None, :] > 0)
    votes = match.sum(axis=0)
    # junction collection (independent of full match)
    t_any, jt_any = np.nonzero(near.any(axis=0) & (jt_idx[None, :] < tn[:, None]))
    for t, j in zip(t_any, jt_any):
        matched.add((int(tj[t, j, 0]), int(tj[t, j, 1])))
    return votes, matched


class MoleculeDataset:
    def __init__(self, parser: LongreadParser):
        self.molecules: dict[str, Molecule] = {}
        self.by_gene: dict[str, list[Molecule]] = {}
        self.model: RefFlatModel | None = None
        self.stats = IsoformStats()
        self.total_reads = 0
        self.multi_ig = 0
        for name, lr in parser.reads.items():
            key = f"{lr.barcode}:{lr.umi}"
            mol = self.molecules.get(key)
            if mol is None:
                mol = Molecule(lr.barcode, lr.umi, lr.rn)
                self.molecules[key] = mol
            mol.add_longread(lr)
        for mol in self.molecules.values():
            self.total_reads += len(mol.longreads)
            if len(mol.gene_ids) > 1:
                self.multi_ig += 1

    def init_model(self, refflat_path):
        self.model = RefFlatModel.load(refflat_path)

    def set_isoforms(self, delta: int = 2, method: str = "STRICT",
                     ambiguous_assign: bool = False, seed: int = 0):
        assert method == "STRICT", "only STRICT supported (as in reference)"
        rng = np.random.default_rng(seed)
        for mol in self.molecules.values():
            self._set_isoform_strict(mol, delta, rng)
        for mol in self.molecules.values():
            if mol.gene_id is not None:
                self.by_gene.setdefault(mol.gene_id, []).append(mol)

    def _set_isoform_strict(self, mol: Molecule, delta: int,
                            rng: np.random.Generator):
        transcripts = self.model.select(sorted(mol.gene_ids))
        if len(transcripts) == 1 and len(transcripts[0].junctions) == 0:
            self.stats.monoexon += 1
            mol.transcript_id = transcripts[0].transcript_id
            mol.gene_id = transcripts[0].gene_id
            mol.supporting_reads = 1
            return
        rec_juncs = [r.junctions for r in mol.records()]
        self.stats.total_junctions += sum(len(j) for j in rec_juncs)
        votes, matched = _match_records_vs_transcripts(rec_juncs, transcripts,
                                                       delta)
        mol.junction_set |= matched
        if votes.max(initial=0) > 0:
            best = votes.max()
            cand = [i for i in range(len(transcripts)) if votes[i] == best]
            if len(cand) == 1:
                self.stats.onematch += 1
                pick = cand[0]
            else:
                self.stats.ambiguous += 1
                pick = cand[int(rng.integers(0, len(cand)))]
            mol.transcript_id = transcripts[pick].transcript_id
            mol.gene_id = transcripts[pick].gene_id
            mol.supporting_reads = int(best)
        elif transcripts:
            self.stats.nomatch += 1
            mol.transcript_id = "undef"
            # most frequent gene among candidate transcripts (:294-315)
            counts: dict[str, int] = {}
            for t in transcripts:
                counts[t.gene_id] = counts.get(t.gene_id, 0) + 1
            mol.gene_id = max(counts.items(), key=lambda kv: kv[1])[0]

    def select(self, gene: str) -> list[Molecule]:
        return self.by_gene.get(gene, [])

    def get_molecule(self, key: str) -> Molecule | None:
        return self.molecules.get(key)

    def produce_matrix(self, cells: list[str]):
        from sicelore_tpu_torch.core.matrix import Matrix
        matrix = Matrix(cells)
        for gene in self.model.genes():
            for mol in self.select(gene):
                matrix.add_molecule(mol)
        return matrix
