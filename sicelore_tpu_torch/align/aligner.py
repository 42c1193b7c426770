"""Spliced read -> BAM alignment driver (the `minimap2 -ax splice -uf`
role in the reference workflow, main.nf:64,200).

Two-phase batches: phase 1 chains every read and plans its CIGAR,
collecting ordinary gap segments into the device GapBatcher; phase 2 runs
ONE banded-alignment call per length bucket on the aligner's device (the
card's csrc/bandalign.cu, or its plain torch version on the CPU) and
assembles records.
Output is a coordinate-sorted BAM + BAI through the framework's own codec
(io/bam.py) with the tags downstream stages read (de, NM, AS, MD, tp),
secondary records (FLAG 0x100, tp:A:S) for near-tied distinct loci, and
supplementary records (FLAG 0x800 + reciprocal SA) for chimeric split
reads — the Step-6 FusionDetector's input contract (the reference
README.md:1489-1607).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from sicelore_tpu_torch import device as _device
from sicelore_tpu_torch.align import chain as chainmod
from sicelore_tpu_torch.align import extend as ext
from sicelore_tpu_torch.align import index as idx
from sicelore_tpu_torch.io.bam import BamRecord, BamWriter
from sicelore_tpu_torch.utils import dna


class NativeAligner:
    def __init__(self, reference, k: int = idx.K, w: int = idx.W,
                 junc_bed=None, device="cuda"):
        """`device`: where the gap extension's band kernel runs ("cuda"
        without a GPU raises; "cpu" runs the plain torch version)."""
        if isinstance(reference, (str, Path)):
            contigs = idx.load_fasta(reference)
        else:
            contigs = reference
        self.index = idx.MinimizerIndex(contigs, k, w)
        self.k = k
        # annotated introns per contig (minimap2 --junc-bed role): BED
        # rows chrom/start/end[/...]; junctions within SNAP of a detected
        # one take priority over GT-AG motif snapping
        self.junctions: dict[str, tuple] = {}
        if junc_bed:
            per: dict[str, list] = {}
            import gzip
            op = gzip.open if str(junc_bed).endswith(".gz") else open
            with op(str(junc_bed), "rt") as fh:
                for line in fh:
                    f = line.rstrip("\n").split("\t")
                    if len(f) < 3 or f[0].startswith(("#", "track")):
                        continue
                    per.setdefault(f[0], []).append(
                        (int(f[1]), int(f[2])))
            for c, lst in per.items():
                lst.sort()
                self.junctions[c] = (
                    np.array([a for a, _ in lst], np.int64),
                    np.array([b for _, b in lst], np.int64))
        self.device = _device.resolve(device)

    # ---- per-read planning ------------------------------------------------

    def _plan(self, seq: bytes, batcher: ext.GapBatcher):
        """-> None (unmapped) or [plan dicts] consumed by _finish: the
        primary first, then supplementary plans for chains covering a
        query span mostly disjoint from the primary (chimeric/fusion
        parts -> FLAG 0x800, reference Step 6 FusionDetector input) and
        secondary plans for near-tied chains elsewhere on the reference
        (FLAG 0x100, mapq 0, tp:A:S)."""
        chains = chainmod.best_chains(seq, self.index)
        if not chains:
            return None
        plans = [self._plan_chain(chains[0], seq, batcher)]
        if plans[0] is None:
            return None
        pq = chains[0][3]
        pspan = (int(pq[0]), int(pq[-1]) + self.k)
        pg = chains[0][4]
        for ch in chains[1:3]:
            score, second, strand, q, g = ch
            if score < 0.5 * chains[0][0]:
                break
            qlo, qhi = int(q[0]), int(q[-1]) + self.k
            ov = (min(qhi, pspan[1]) - max(qlo, pspan[0])) / max(
                qhi - qlo, 1)
            same_locus = abs(int(g[0]) - int(pg[0])) < 1_000_000
            if ov < 0.2:
                pl = self._plan_chain(ch, seq, batcher)
                if pl is not None:
                    pl["suppl"] = True
                    plans.append(pl)
            elif score >= 0.8 * chains[0][0] and not same_locus:
                pl = self._plan_chain(ch, seq, batcher)
                if pl is not None:
                    pl["secondary"] = True
                    plans.append(pl)
        return plans

    def _plan_chain(self, chain_t, seq: bytes, batcher: ext.GapBatcher):
        """One chain -> plan dict (None when degenerate)."""
        score, second, strand, q, g = chain_t
        query = dna.revcomp_bytes(seq) if strand else seq
        # non-overlapping match blocks on one diagonal walk
        blocks = []          # (qs, qe, gs, ge) exact-ish anchor cover
        qe = ge = -1
        for qi, gi in zip(q.tolist(), g.tolist()):
            if qe < 0:
                blocks.append([qi, qi + self.k, gi, gi + self.k])
            elif qi >= qe and gi >= ge:
                blocks.append([qi, qi + self.k, gi, gi + self.k])
            elif qi - blocks[-1][0] == gi - blocks[-1][2] and qi + self.k > qe:
                blocks[-1][1] = qi + self.k
                blocks[-1][3] = gi + self.k
            else:
                continue
            qe, ge = blocks[-1][1], blocks[-1][3]
        ci, _ = self.index.contig_of(int(blocks[0][2]))
        coff = int(self.index.offsets[ci])
        cseq = self.index.seqs[self.index.names[ci]]
        # exact end extension (the rest of the overhang soft-clips)
        qs, gs = blocks[0][0], blocks[0][2] - coff
        while qs > 0 and gs > 0 and query[qs - 1] == cseq[gs - 1]:
            qs -= 1
            gs -= 1
        blocks[0][0], blocks[0][2] = qs, gs + coff
        qe2, ge3 = blocks[-1][1], blocks[-1][3] - coff
        while qe2 < len(query) and ge3 < len(cseq) \
                and query[qe2] == cseq[ge3]:
            qe2 += 1
            ge3 += 1
        blocks[-1][1], blocks[-1][3] = qe2, ge3 + coff
        segs = []            # ("M", n) | ("gap", handle|None, R, Q) |
        #                      ("intron", n, jlocal, Q) per inter-block gap
        # leading overhang: banded-extend to the read start when the ref
        # has room (minimap2's end extension); else soft-clip
        q0 = blocks[0][0]
        gs0 = blocks[0][2] - coff
        if 0 < q0 <= ext.MAX_SEG and gs0 - q0 >= 0:
            R = cseq[gs0 - q0:gs0]
            Q = query[:q0]
            segs.append(("lead", batcher.add(R, Q)
                         if batcher.feasible(R, Q) else None, R, Q))
        else:
            segs.append(("S", q0))
        segs.append(("M", blocks[0][1] - blocks[0][0]))
        pending = 0     # query bases borrowed from the upcoming M block
        for b0, b1 in zip(blocks, blocks[1:]):
            mq = b1[1] - b1[0]
            Q = query[b0[1]:b1[0]]
            gs, ge2 = b0[3] - coff, b1[2] - coff
            R = cseq[gs:ge2]
            if len(R) - len(Q) >= ext.MIN_INTRON:
                # borrow a margin from the flanking M blocks: anchors can
                # overrun a junction by 1-2 chance-matching bases, which
                # would put the true split OUTSIDE the gap window (13% of
                # exact-read junctions placed +-1-2 bp before this)
                bl = (min(8, segs[-1][1] - 1)
                      if segs and segs[-1][0] == "M" else 0)
                br = min(8, mq - 1)
                if bl > 0:
                    segs[-1] = ("M", segs[-1][1] - bl)
                Q = query[b0[1] - bl:b1[0] + br]
                segs.append(("intron", len(R) - len(Q) + bl + br,
                             gs - bl, Q))
                pending = br
            elif len(R) == 0 and len(Q) == 0:
                pass
            elif len(R) == len(Q):
                # equal-length gap: aligned columns ARE the alignment
                # (CIGAR M covers mismatches; NW at +5/-4 vs -8 gaps
                # prefers mismatch runs over indel pairs) — no device
                segs.append(("M", len(R)))
            elif batcher.feasible(R, Q) and len(R) and len(Q):
                segs.append(("gap", batcher.add(R, Q), R, Q))
            else:
                segs.append(("gap", None, R, Q))
            segs.append(("M", mq - pending))
            pending = 0
        qt = len(query) - blocks[-1][1]
        ge4 = blocks[-1][3] - coff
        if 0 < qt <= ext.MAX_SEG and ge4 + qt <= len(cseq):
            R = cseq[ge4:ge4 + qt]
            Q = query[blocks[-1][1]:]
            segs.append(("tail", batcher.add(R, Q)
                         if batcher.feasible(R, Q) else None, R, Q))
        else:
            segs.append(("S", qt))
        return {"strand": strand, "query": query, "score": score,
                "second": second, "ci": ci, "pos": int(blocks[0][2]) - coff,
                "cseq": cseq, "segs": segs}

    def _finish_read(self, name: bytes, seq: bytes, qual: bytes, plans,
                     batcher: ext.GapBatcher) -> list[BamRecord]:
        if plans is None:
            return [BamRecord(qname=name.decode(), flag=4,
                              seq=seq.decode(),
                              qual=bytes(q - 33 for q in qual))]
        recs = [self._finish(name, seq, qual, p, batcher) for p in plans]
        if len(recs) > 1:   # SA tags link split parts (SAM 1.6 #1.4.8)
            sas = []
            for r, p in zip(recs, plans):
                nmv = next(v for t, ty, v in r.tags if t == "NM")
                cig = "".join(f"{n}{op}" for op, n in r.cigar)
                sas.append(f"{self.index.names[r.ref_id]},{r.pos + 1},"
                           f"{'-' if r.flag & 16 else '+'},{cig},"
                           f"{r.mapq},{nmv};")
            for i, (r, p) in enumerate(zip(recs, plans)):
                if p.get("secondary"):
                    continue
                others = "".join(sa for j, sa in enumerate(sas)
                                 if j != i and not plans[j].get(
                                     "secondary"))
                if others:
                    r.tags.append(("SA", "Z", others))
        return recs

    def _finish(self, name: bytes, seq: bytes, qual: bytes, plan,
                batcher: ext.GapBatcher) -> BamRecord:
        cseq = plan["cseq"]
        query = plan["query"]
        ops: list = []
        pos_shift = 0
        for seg in plan["segs"]:
            kind = seg[0]
            if kind in ("S", "M"):
                ext._merge(ops, kind, seg[1])
            elif kind in ("lead", "tail"):
                _, handle, R, Q = seg
                sub = (batcher.get(handle, R, Q) if handle is not None
                       else ext.plain_gap_ops(len(R), len(Q)))
                if kind == "lead":
                    # normalize: a leading D shifts pos right instead; a
                    # leading I becomes part of the soft clip; the aligned
                    # ref consumed shifts pos left
                    while sub and sub[0][0] in ("D", "I"):
                        op, n = sub.pop(0)
                        if op == "I":
                            ext._merge(ops, "S", n)
                    pos_shift -= sum(n for op, n in sub
                                     if op in ("M", "D"))
                else:
                    while sub and sub[-1][0] in ("D", "I"):
                        op, n = sub.pop()
                        if op == "I":
                            sub.append(["S", n])
                            break
                for op, n in sub:
                    ext._merge(ops, op, n)
            elif kind == "intron":
                _, intron, jlocal, Q = seg
                ann = self._annotated_junction(
                    plan["ci"], jlocal, len(Q), intron, len(Q) + intron)
                if ann is not None:
                    as_, ae_ = ann
                    left = as_ - jlocal
                    ext._merge(ops, "M", left)
                    ext._merge(ops, "N", ae_ - as_)
                    rest_q = len(Q) - left
                    rest_r = (len(Q) + intron) - (ae_ - as_) - left
                    if rest_q == rest_r:
                        ext._merge(ops, "M", rest_q)
                    else:
                        for op, n in ext.plain_gap_ops(rest_r, rest_q):
                            ext._merge(ops, op, n)
                    continue
                left, ilen = self._best_split(cseq, jlocal, intron, Q,
                                               plan["strand"])
                ext._merge(ops, "M", left)
                ext._merge(ops, "N", ilen)
                rest_q = len(Q) - left
                rest_r = rest_q + (intron - ilen)
                if rest_q == rest_r:
                    ext._merge(ops, "M", rest_q)
                else:
                    # exonic indel absorbed by the length correction
                    for op, nn in ext.plain_gap_ops(rest_r, rest_q):
                        ext._merge(ops, op, nn)
            else:
                _, handle, R, Q = seg
                sub = (batcher.get(handle, R, Q) if handle is not None
                       else ext.plain_gap_ops(len(R), len(Q)))
                for op, n in sub:
                    ext._merge(ops, op, n)
        # trailing/leading empty clips drop; compute NM/de over M runs
        ops = [(op, n) for op, n in ops if n > 0]
        qpos = 0
        gpos = plan["pos"] = plan["pos"] + pos_shift
        mm = gaps = matched = 0
        md: list[str] = []     # MD:Z per SAMtags spec: matches as counts,
        md_run = 0             # mismatches as ref base, deletions ^bases
        for op, n in ops:
            if op in ("S", "I"):
                if op == "I":
                    gaps += n
                qpos += n
            elif op in ("D", "N"):
                if op == "D":
                    gaps += n
                    md.append(str(md_run))
                    md.append("^" + cseq[gpos:gpos + n].decode())
                    md_run = 0
                gpos += n
            elif op == "M":
                a = np.frombuffer(query[qpos:qpos + n], np.uint8)
                b = np.frombuffer(cseq[gpos:gpos + n], np.uint8)
                neq = np.nonzero(a != b[:len(a)])[0]
                mm += len(neq)
                prev = 0
                for x in neq.tolist():
                    md.append(str(md_run + (x - prev)))
                    md.append(chr(b[x]))
                    md_run = 0
                    prev = x + 1
                md_run += n - prev
                matched += n
                qpos += n
                gpos += n
        md.append(str(md_run))
        nm = mm + gaps
        de = round(nm / max(matched + gaps, 1), 4)
        flag = 16 if plan["strand"] else 0
        if plan.get("secondary"):
            flag |= 0x100
        if plan.get("suppl"):
            flag |= 0x800
        qv = qual[::-1] if plan["strand"] else qual
        return BamRecord(
            qname=name.decode(), flag=flag, ref_id=plan["ci"],
            pos=plan["pos"],
            mapq=0 if plan.get("secondary") else chainmod.mapq(
                plan["score"], plan["second"]),
            cigar=[(op, n) for op, n in ops],
            seq=query.decode(),
            qual=bytes(q - 33 for q in qv),
            tags=[("NM", "i", nm), ("AS", "i", int(plan["score"])),
                  ("de", "f", de), ("MD", "Z", "".join(md)),
                  ("tp", "A", "S" if plan.get("secondary") else "P")])

    @staticmethod
    def _best_split(cseq: bytes, jlocal: int, intron: int, Q: bytes,
                    strand: int = 0) -> int:
        """Place the intron inside an anchor gap by maximizing matched
        query bases (minimap2's splice alignment in miniature): query
        index i left of the split aligns to ref jlocal+i, right of it to
        ref jlocal+intron+i, so split score = prefix + suffix match
        sums, and the intron length is re-estimated over canonical
        motif sites near the chain-derived estimate (exonic indels skew
        it). With stranded reads (`-uf`), a forward alignment means a
        +-strand gene (GT..AG in genome-forward coords) and a reverse
        alignment a −-strand gene (CT..AC). Returns (left, intron_len).
        """
        nq = len(Q)
        if nq == 0:
            return 0
        qa = np.frombuffer(Q, np.uint8)
        dl = np.frombuffer(cseq[jlocal:jlocal + nq], np.uint8)
        ar = np.frombuffer(cseq[jlocal + intron:jlocal + intron + nq],
                           np.uint8)
        pl = np.zeros(nq + 1, np.int32)
        pl[1:] = np.cumsum(qa[:len(dl)] == dl)[:nq] if len(dl) else 0
        sr = np.zeros(nq + 1, np.int32)
        if len(ar):
            eq = (qa[:len(ar)] == ar).astype(np.int32)
            sr[:len(eq)] = np.cumsum(eq[::-1])[::-1]
        score = pl + sr
        best = int(score.max())
        # exonic INDELS between the flanking anchors skew the intron-
        # length estimate len(R)-len(Q) by their size (measured: ~45% of
        # noisy-read junctions off by 1-4): search canonical motifs over
        # nearby lengths too, emitting the residual as a small I/D
        pairs = ([(b"GT", b"AG"), (b"CT", b"AC")] if strand == 0
                 else [(b"CT", b"AC"), (b"GT", b"AG")])
        best_m = None
        for L in range(max(30, intron - 6), intron + 7):
            arL = np.frombuffer(cseq[jlocal + L:jlocal + L + nq],
                                np.uint8)
            srL = np.zeros(nq + 1, np.int32)
            if len(arL):
                eqL = (qa[:len(arL)] == arL).astype(np.int32)
                srL[:len(eqL)] = np.cumsum(eqL[::-1])[::-1]
            scL = pl + srL
            for pi, (don, acc) in enumerate(pairs):
                for left in np.nonzero(scL >= best - 5)[0].tolist():
                    a = jlocal + left
                    if (cseq[a:a + 2] == don
                            and cseq[a + L - 2:a + L] == acc):
                        val = (int(scL[left]) * 2 - 2 * abs(L - intron)
                               - pi)   # strand-preferred pair wins ties
                        if best_m is None or val > best_m[0]:
                            best_m = (val, left, L)
        if best_m is not None:
            return int(best_m[1]), int(best_m[2])
        return int(np.nonzero(score == best)[0][0]), intron

    def _annotated_junction(self, ci: int, jlocal: int, qlen: int,
                            intron: int, rlen: int):
        """Closest annotated intron compatible with the detected one:
        start within the query-gap span, length within +-16 of the
        estimate, consistent with the ref segment. -> (start, end) local
        coords or None."""
        ann = self.junctions.get(self.index.names[ci])
        if ann is None:
            return None
        starts, ends = ann
        lo = np.searchsorted(starts, jlocal)
        hi = np.searchsorted(starts, jlocal + qlen + 1)
        best = None
        for i in range(lo, hi):
            as_, ae_ = int(starts[i]), int(ends[i])
            ilen = ae_ - as_
            left = as_ - jlocal
            if abs(ilen - intron) > 16 or not (0 <= left <= qlen):
                continue
            if left + ilen > rlen:
                continue
            d = abs(as_ - (jlocal + qlen))
            if best is None or d < best[0]:
                best = (d, as_, ae_)
        return (best[1], best[2]) if best else None

    # ---- batch / file APIs ------------------------------------------------

    def align_batch(self, names, seqs, quals=None) -> list[BamRecord]:
        quals = quals or [b"I" * len(s) for s in seqs]
        batcher = ext.GapBatcher(self.device)
        plans = [self._plan(s, batcher) for s in seqs]
        if any(v for v in batcher.jobs.values()):
            batcher.run()
        out: list[BamRecord] = []
        for n, s, q, p in zip(names, seqs, quals, plans):
            out.extend(self._finish_read(n, s, q, p, batcher))
        return out

    def align_fastq_to_bam(self, fastq, out_bam, chunk_size: int = 2048,
                           keep_unmapped: bool = False):
        """fastq (file/dir) -> coordinate-sorted BAM + .bai. `--sam-hit-only`
        semantics by default (the reference drops unmapped reads)."""
        from sicelore_tpu_torch.io import fastq as fqio
        recs: list[BamRecord] = []
        n_in = 0
        fq = Path(fastq)
        files = fqio.find_fastq_files(fq) if fq.is_dir() else [fq]
        for f in files:
            for chunk in fqio.read_fastq(f, chunk_size):
                n_in += len(chunk)
                for r in self.align_batch(chunk.names, chunk.seqs,
                                          chunk.quals):
                    if keep_unmapped or not (r.flag & 4):
                        recs.append(r)
        self._write_bam(recs, out_bam)
        return {"reads": n_in, "mapped": len(recs)}

    def _write_bam(self, recs: list[BamRecord], out_bam) -> None:
        """Coordinate-sort the records and write them as a BAM + .bai."""
        from sicelore_tpu_torch.io.bam import BamHeader, build_bai
        recs.sort(key=lambda r: (r.ref_id if r.ref_id >= 0 else 1 << 30,
                                 r.pos))
        hdr = BamHeader(text="@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{ln}\n"
            for n, ln in zip(self.index.names, self.index.lengths)),
            refs=[(n, int(ln)) for n, ln in zip(self.index.names,
                                                self.index.lengths)])
        w = BamWriter(out_bam, hdr)
        for r in recs:
            w.write(r)
        w.close()
        try:
            build_bai(out_bam)
        except Exception:
            pass
