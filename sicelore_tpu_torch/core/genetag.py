"""Gene-name tagging from a refFlat model (GE/GS/XF tags).

Plays the role of the reference's gene taggers: the jar's DefaultTagger /
Drop-seq TagReadWithGeneExonFunction (config.xml:88-90; README.md:661) and
the Sicelore AddGeneNameTag program (programs/AddGeneNameTag.java — Drop-seq
port). Faithful semantics:

  * per gene, per alignment block, per base: LocusFunction over the gene's
    transcripts — CODING (exonic within [cdsStart, cdsEnd]) > UTR (exonic
    outside cds) > INTRONIC (within transcript span) > INTERGENIC — block
    function = max over bases, read function = max over blocks
    (AddGeneNameTag.java:276-293, 349-369 + Gene.Transcript
    .assignLocusFunctionForRange)
  * genes listed in GE: exon-consistent genes (>=1 block intersects an
    exon interval, ALLOW_MULTI_GENE_READS union, :196-224) whose read
    function is CODING or UTR (:127-133)
  * XF = max function over ALL overlapping genes (:135, 343-369)
  * USE_STRAND_INFO: keep same-strand genes; opposite-strand-only reads
    get no GE/GS (:162-194); multi-gene same-strand allowed (KL 21/04/2020)
  * GE/GS are comma-joined over the kept genes (:314-340); deterministic
    policy here: genomic span order (Java iterates a HashSet)
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from sicelore_tpu_torch.core.refflat import RefFlatModel

CODING, UTR, INTRONIC, INTERGENIC = 4, 3, 2, 1
_FNAME = {4: "CODING", 3: "UTR", 2: "INTRONIC", 1: "INTERGENIC"}


def _overlaps(intervals: np.ndarray, bs: int, be: int) -> bool:
    """Any 1-based inclusive [s, e] row overlapping [bs, be]?"""
    if not len(intervals):
        return False
    return bool(np.any((intervals[:, 0] <= be) & (intervals[:, 1] >= bs)))


class GeneTagger:
    def __init__(self, model: RefFlatModel):
        # chrom -> list of (gene, strand, span_s, span_e, exons [K,2],
        #                   transcripts [(tx_s1, tx_e1, cds_exons [K,2])])
        self.by_chrom: dict[str, list] = defaultdict(list)
        for gene, trs in model.by_gene.items():
            by_c = defaultdict(list)
            for tr in trs:
                by_c[(tr.chrom, tr.strand)].append(tr)
            for (chrom, strand), sub in by_c.items():
                span_s = min(t.tx_start for t in sub) + 1
                span_e = max(t.tx_end for t in sub)
                exons = sorted({(s, e) for t in sub for (s, e) in t.exons})
                txs = []
                for t in sub:
                    ex = np.array(t.exons, dtype=np.int64).reshape(-1, 2)
                    # exon pieces inside the CDS (refFlat cds is 0-based
                    # start / 1-based-inclusive end like txStart/txEnd)
                    cs1, ce1 = t.cds_start + 1, t.cds_end
                    if cs1 <= ce1 and len(ex):
                        cds = np.stack([np.maximum(ex[:, 0], cs1),
                                        np.minimum(ex[:, 1], ce1)], axis=1)
                        cds = cds[cds[:, 0] <= cds[:, 1]]
                    else:
                        cds = np.zeros((0, 2), np.int64)
                    txs.append((t.tx_start + 1, t.tx_end, cds))
                self.by_chrom[chrom].append(
                    (gene, strand, span_s, span_e,
                     np.array(exons, dtype=np.int64).reshape(-1, 2), txs))
        for lst in self.by_chrom.values():
            lst.sort(key=lambda x: x[2])

    # -- faithful AddGeneNameTag annotation --------------------------------

    def _read_function(self, entry, blocks) -> int:
        """Max LocusFunction priority of the read vs one gene entry."""
        _, _, ss, se, exons, txs = entry
        best = INTERGENIC
        for (bs, be) in blocks:
            f = INTERGENIC
            for (ts, te, cds) in txs:
                if te < bs or ts > be:
                    continue
                if _overlaps(cds, bs, be):
                    f = CODING
                    break
                f = max(f, INTRONIC)
            if f != CODING and _overlaps(exons, bs, be):
                f = UTR  # exonic base outside every cds -> UTR
            best = max(best, f)
            if best == CODING:
                return CODING
        return best

    def annotate(self, chrom: str, blocks: list[tuple[int, int]],
                 read_strand: str | None = None):
        """-> (ge, gs, xf) for one record's alignment blocks (1-based
        inclusive M/=/X runs). ge/gs are None when no gene qualifies; xf
        is always a LocusFunction name (INTERGENIC when nothing overlaps).
        """
        lst = self.by_chrom.get(chrom)
        if not lst or not blocks:
            return None, None, _FNAME[INTERGENIC]
        lo = min(s for s, _ in blocks)
        hi = max(e for _, e in blocks)
        funcs: list[tuple] = []   # (entry, read_function)
        for entry in lst:
            if entry[2] > hi:
                break
            if entry[3] < lo:
                continue
            funcs.append((entry, self._read_function(entry, blocks)))
        if not funcs:
            return None, None, _FNAME[INTERGENIC]
        xf = max(f for _, f in funcs)
        # exon-consistent genes (union over blocks, ALLOW_MULTI default)
        kept = []
        for entry, f in funcs:
            if f not in (CODING, UTR):
                continue
            if any(_overlaps(entry[4], bs, be) for (bs, be) in blocks):
                kept.append(entry)
        if read_strand is not None:
            same = [e for e in kept if e[1] == read_strand]
            if not same and len(kept) > len(same):
                kept = []   # wrong-strand read: no GE/GS
            else:
                kept = same
        if not kept:
            return None, None, _FNAME[xf]
        ge = ",".join(e[0] for e in kept)
        gs = ",".join(e[1] for e in kept)
        return ge, gs, _FNAME[xf]

    # -- best-single-gene ranking (assignumis gene tagger role) -----------

    def genes_for(self, chrom: str, blocks: list[tuple[int, int]],
                  strand: str | None = None) -> list[str]:
        """Genes whose exons overlap the given 1-based blocks, best first
        (exonic overlap outranks intronic; strand mismatch filtered unless
        it would remove every candidate)."""
        lst = self.by_chrom.get(chrom)
        if not lst or not blocks:
            return []
        lo = min(s for s, _ in blocks)
        hi = max(e for _, e in blocks)
        scores: dict[str, tuple[int, bool]] = {}
        for (gene, gstrand, ss, se, exons, _txs) in lst:
            if ss > hi:
                break
            if se < lo:
                continue
            exonic = intronic = 0
            for (bs, be) in blocks:
                if be < ss or bs > se:
                    continue
                ov = np.minimum(exons[:, 1], be) - np.maximum(exons[:, 0], bs) + 1
                exonic += int(np.maximum(ov, 0).sum())
                intronic += max(0, min(be, se) - max(bs, ss) + 1)
            if exonic + intronic > 0:
                same = (strand is None or strand == gstrand)
                scores[gene] = (exonic * 1000 + intronic, same)
        if not scores:
            return []
        stranded = {g: s for g, (s, same) in scores.items() if same}
        pool = stranded if stranded else {g: s for g, (s, _) in scores.items()}
        return [g for g, _ in sorted(pool.items(), key=lambda kv: -kv[1])]

    def tag(self, chrom: str, blocks, strand: str | None = None) -> str | None:
        g = self.genes_for(chrom, blocks, strand)
        return g[0] if g else None
