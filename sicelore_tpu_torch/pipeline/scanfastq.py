"""scanfastq — Step 1: stranding, chimera split, two-pass cell-BC assignment,
on PyTorch (CUDA kernels on the card, plain torch bodies on the CPU).

Port of `sicelore_tpu/pipeline/scanfastq.py` (single process); the outputs
— passed/ and failed/ fastqs, BarcodeList.tsv, BarcodesAssigned.tsv,
scanner_stats.json — are byte-identical to the JAX pipeline's
(tests/test_torch_scanfastq.py). Pipeline:

  PASS 1 (used-barcode list): edge-scan every read; high-quality reads with
    an EXACT whitelist match at the adapter-predicted position are counted
    per whitelist barcode; ED1 neighbours with a >= minCountFold imbalance
    merge, barcodes far below the max drop -> used list + BarcodeList.tsv.
    With the pass-1 cache (inputs that fit the budget) this one edge scan
    also yields everything pass 2 emits from.
  PASS 2 (assignment): the tiled chimera scan splits single-junction reads
    (part 2 renamed `<name>sp2`) and discards multi-junction reads; every
    (sub)read's BC window sweeps the used list; assignment needs best ED <=
    the dynamic max ED and strictly better than the second best. With the
    cache on one CUDA device (`readscan.fused_tiles_route`) pass 1 already
    scanned the interiors of the reads with min_len < L <= 2E from its own
    upload (the tile feed) and dispatched the host tiles of the rest, so
    pass 2 only merges the two (`finish_tiles_merged`).

Negative control: `random_barcode` replaces each read's BC window with random
bases (reference -e/--randomBarcode) to measure the false-assignment rate; it
and a run whose pass 1 finds no barcode take the synchronous pass 2
(`pass2_chunk`: `split_chimeras`, the v1 composite scan `scan_reads`, then
`bc_search`), chunk by chunk.

Multi-GPU: `mesh` (a list of devices) splits both scan passes' rows
across its devices (`ReadScanModel(mesh=)`). Multi-process: under a
torch.distributed group (`parallel.multihost.init`, world size > 1) every
process scans `sorted(files)[rank::world_size]`, the pass-1 whitelist
counts are summed across processes so that all derive the same used list,
each writes the passed/ and failed/ files of its own inputs, and process 0
writes the merged stats and reports. Both write what one device in one
process writes (tests/test_torch_multichip.py, test_torch_multihost.py).
"""
from __future__ import annotations

import gzip
import json
from collections import defaultdict, deque
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from sicelore_tpu_torch.io import fastq
from sicelore_tpu_torch.pipeline import readname
from sicelore_tpu_torch.utils import dna
from sicelore_tpu_torch.utils.config import DynamicEDTable, PipelineConfig
from sicelore_tpu_torch.models import readscan
from sicelore_tpu_torch.ops import bcsearch, editdist
from sicelore_tpu_torch.parallel import multihost, shard

BIG = 10**9


def load_whitelist(path: str | Path) -> np.ndarray:
    """10x whitelist -> sorted packed uint32 array (one 16-mer per line,
    optional -1 suffix, optionally gzipped)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    bcs = []
    with opener(str(path), "rb") as fh:
        for line in fh:
            s = line.strip().split(b"-")[0]
            if s:
                bcs.append(s)
    codes, _ = dna.encode_batch(bcs, 16)
    packed = dna.pack_kmers(codes, 16)
    return np.unique(packed[dna.valid_kmers(codes)])


@dataclass
class ScanStats:
    total_reads: int = 0
    too_short: int = 0
    stranded: int = 0
    fwd: int = 0
    rev: int = 0
    split_chimeric: int = 0
    multi_chimeric_discarded: int = 0
    bc_assigned: int = 0
    bc_ambiguous: int = 0
    unassigned: int = 0
    pass1_reads_used: int = 0
    ed_hist: dict = field(default_factory=lambda: defaultdict(int))

    def to_json(self) -> dict:
        d = dict(self.__dict__)
        d["ed_hist"] = dict(self.ed_hist)
        return d


def _stem(f: Path) -> str:
    stem = f.name
    for suf in (".gz", ".fastq", ".fq"):
        stem = stem[:-len(suf)] if stem.endswith(suf) else stem
    return stem


def _chunks_prefetched(files, chunk_size):
    """Flattened (file, chunk) iterator with one chunk of read-ahead on a
    background thread — the fastq parse overlaps the device work of the
    previous chunk's scan."""
    from concurrent.futures import ThreadPoolExecutor

    def gen():
        for f in files:
            for chunk in fastq.read_fastq(f, chunk_size):
                yield f, chunk

    it = gen()
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(next, it, None)
        while True:
            item = fut.result()
            if item is None:
                return
            fut = pool.submit(next, it, None)
            yield item


class ScanFastqPipeline:
    def __init__(self, cfg: PipelineConfig | None = None,
                 whitelist: np.ndarray | list[str] | None = None,
                 bc_max_ed_table: DynamicEDTable | None = None,
                 error_percent: int = 1,
                 random_barcode: bool = False,
                 chunk_size: int = 50_000,
                 seed: int = 0,
                 user_max_ed: int | None = None,
                 known_cells: bool = False,
                 compress: bool = False,
                 device="cuda",
                 mesh=None,
                 model: "readscan.ReadScanModel | None" = None,
                 cache_pass1: bool | None = None,
                 cache_budget_bytes: int = 4 << 30):
        """`device`: "cuda" (the kernels) or "cpu" (plain torch bodies).
        `mesh`: a list of devices of that type (["cuda:0", "cuda:1"]; a
        device may repeat) that both scan passes split their rows across;
        the outputs are those of one device.
        `model`: share an existing ReadScanModel (it carries its own cfg,
        device and mesh) across pipeline runs."""
        if model is not None:
            # a shared model carries its own cfg and mesh: a diverging one
            # beside it would split the host logic from the device path
            if not (mesh is None or shard.resolve_mesh(mesh) == model.mesh):
                raise ValueError(
                    "model= and mesh= conflict; build the model with the mesh")
            if not (cfg is None or cfg is model.cfg):
                raise ValueError(
                    "model= and cfg= conflict; build the model with the cfg")
            self.cfg = model.cfg
        else:
            self.cfg = cfg or PipelineConfig()
        self.model = model if model is not None else \
            readscan.ReadScanModel(self.cfg, device=device, mesh=mesh)
        if whitelist is None:
            raise ValueError("whitelist required (10x barcode list)")
        if isinstance(whitelist, (list, tuple)):
            codes, _ = dna.encode_batch([w.encode() if isinstance(w, str) else w
                                         for w in whitelist], 16)
            self.whitelist = np.unique(dna.pack_kmers(codes, 16))
        else:
            self.whitelist = np.asarray(whitelist)
        self.ed_table = bc_max_ed_table
        self.error_percent = error_percent
        self.random_barcode = random_barcode
        self.chunk_size = chunk_size
        self.user_max_ed = user_max_ed
        self.known_cells = known_cells  # -g/--cellRangerBCs: skip pass 1
        self.compress = compress
        self.rng = np.random.default_rng(seed)   # random_barcode windows
        self.stats = ScanStats()
        # pass-1 state
        self.wl_counts = np.zeros(len(self.whitelist), dtype=np.int64)
        # used-list state (set by build_used_list)
        self.used_packed: np.ndarray | None = None
        self.used_strs: list[str] = []
        self.used_counts: np.ndarray | None = None
        self.used_peq: np.ndarray | None = None
        self.ranks: np.ndarray | None = None
        # pass-2 per-barcode assignment histograms {bc_idx: [n_ed0, ...]}
        self.assigned_hist: dict[int, np.ndarray] = {}
        # pass-1 result cache (auto when the input fits cache_budget_bytes):
        # pass 1 runs the FULL edge scan once, pass 2 runs the whitelist
        # sweep alone on the cached windows
        self.cache_pass1 = cache_pass1
        self.cache_budget_bytes = cache_budget_bytes
        # (file, chunk, out, windows_tm, the fused route's tile handle)
        self._p1_cache: list[tuple] = []

    # ------------------------------------------------------------------
    # PASS 1
    # ------------------------------------------------------------------

    def pass1_chunk(self, chunk: fastq.FastqChunk):
        self._pass1_apply(self.model.scan_pass1(chunk.seqs, chunk.quals))

    def _cache_decision(self, files) -> bool:
        """Pass-1 cache policy: explicit cache_pass1 wins; auto enables it
        when the estimated in-memory footprint (raw fastq bytes, gz at a
        ~3x expansion estimate) fits cache_budget_bytes. Random-BC runs
        always stream (they bypass the fused path)."""
        if self.random_barcode or self.known_cells:
            return False
        if self.cache_pass1 is not None:
            return bool(self.cache_pass1)
        try:
            est = sum(f.stat().st_size * (3 if str(f).endswith(".gz") else 1)
                      for f in files)
        except OSError:
            return False
        return est * 2 <= self.cache_budget_bytes

    def _pass1_apply_cached(self, pending):
        """Force one FULL pass-1 chunk: count exact matches for the used
        list AND store the chunk's pass-2 inputs. On the fused route the
        host tile scan of the residue (reads with an interior the feed did
        not cover) is dispatched now, so pass 2 only waits for it."""
        chunk, f, h = pending
        out, wins, tiles3 = self.model.finish_pass1_full(h)
        self._pass1_apply(out)
        th = None
        if tiles3 is not None:
            # N-safe codes: no read is dirty
            covered, need = self.model.tiles_fused_mask(
                out["true_lens"], np.zeros(len(chunk), bool))
            need_idx = np.nonzero(need)[0]
            th = ("fused", tiles3, covered, self.model.internal_tiles_async(
                [chunk.seqs[i] for i in need_idx]), need_idx)
        self._p1_cache.append((f, chunk, out, wins, th))

    def _run_pass2_cached(self, out_dir, ext):
        """Pass 2 over the pass-1 cache: per chunk, launch the tiled chimera
        scan + the sweep-only whitelist search (double-buffered), then emit
        from the CACHED edge rows — output-identical to the streaming path."""
        writers: dict = {}
        pending: deque = deque()
        split_job = None   # (sub, handle, pw, fw)

        def get_writers(f):
            w = writers.get(f)
            if w is None:
                w = (fastq.FastqWriter(
                        out_dir / "passed" / f"{_stem(f)}FWD{ext}"),
                     fastq.FastqWriter(
                        out_dir / "failed" / f"{_stem(f)}FAILED{ext}"))
                writers[f] = w
            return w

        def drain_one():
            nonlocal split_job
            chunk, out, th, sh, pw, fw = pending.popleft()
            nj = self._finish_chunk_cached(chunk, out, th, sh, pw, fw)
            if split_job is not None:
                self._finish_splits(split_job[0:2], split_job[2],
                                    split_job[3])
            split_job = (nj[0], nj[1], pw, fw) if nj is not None else None

        try:
            for f, chunk, out, wins, th0 in self._p1_cache:
                pw, fw = get_writers(f)
                self.stats.total_reads += len(chunk)
                # fused route: the tiles were dispatched in pass 1
                th = th0 if th0 is not None else \
                    self.model.internal_tiles_async(chunk.seqs)
                sh = self.model.bc_sweep_async(wins)
                pending.append((chunk, out, th, sh, pw, fw))
                if len(pending) > 2:
                    drain_one()
            while pending:
                drain_one()
            if split_job is not None:
                self._finish_splits(split_job[0:2], split_job[2],
                                    split_job[3])
        finally:
            self._p1_cache.clear()
            for pw, fw in writers.values():
                pw.close(wait=False)
                fw.close(wait=False)

    def _finish_chunk_cached(self, chunk, out, th, sh, pw, fw):
        """Cached-mode chunk finisher: chimera splits from the tile scan
        (merged with the fused route's), bc from the sweep-only search,
        emit from cached pass-1 rows. Returns the deferred split-rescan job
        (see _finish_chunk)."""
        if isinstance(th, tuple) and th[0] == "fused":
            splits, discard = self.model.finish_tiles_merged(*th[1:])
        else:
            splits, discard = self.model.finish_internal_tiles(th)
        bc = self.model.finish_bc_sweep(sh)
        self.stats.multi_chimeric_discarded += len(discard)
        self.stats.split_chimeric += len(splits)
        skip = discard | set(splits)
        self.pass2_emit(chunk, out, bc, pw, fw, skip=skip)
        if splits:
            sub = self._split_parts_chunk(chunk, splits)
            return sub, self.model.scan_search_async(sub.seqs, sub.quals)
        return None

    def _pass1_apply(self, out: dict):
        r = self.cfg.readscanner
        ok = (out["stranded"]
              & (out["true_lens"] >= r.min_read_length)
              & (out["adapter_run"] >= r.min_adapter3p_matches)
              & (out["read_qv"] >= r.min_mean_read_qv)
              & (out["bc_qv"] >= r.min_mean_bc_qv)
              & out["bc_kmer_valid"])
        if not ok.any():
            return
        packed = out["bc_kmer"][ok]
        idx = np.searchsorted(self.whitelist, packed)
        idx = np.clip(idx, 0, len(self.whitelist) - 1)
        hits = self.whitelist[idx] == packed
        np.add.at(self.wl_counts, idx[hits], 1)
        self.stats.pass1_reads_used += int(hits.sum())

    def build_used_list(self):
        """Merge/filter pass-1 counts -> used-BC list + ranks.

        A barcode ED1 (= Hamming 1 at equal length) away from another with
        >= minCountFold more reads is dropped; barcodes
        cellsWithReadsnFoldBelowMaxToKeep-fold below the max are dropped."""
        r = self.cfg.readscanner
        nz = np.nonzero(self.wl_counts)[0]
        packed = self.whitelist[nz]
        counts = self.wl_counts[nz]
        order = {int(w): i for i, w in enumerate(packed)}
        drop = np.zeros(len(packed), dtype=bool)
        fold = r.min_count_fold
        self.neighbor_info: dict[int, list[tuple[int, int]]] = defaultdict(list)
        for i, w in enumerate(packed):
            w = int(w)
            for pos in range(16):
                for delta in (1, 2, 3):
                    nb = w ^ (delta << (2 * pos))
                    j = order.get(nb)
                    if j is not None and j != i:
                        self.neighbor_info[i].append((j, int(counts[j])))
                        if counts[j] >= fold * counts[i]:
                            drop[i] = True
        max_count = counts.max() if len(counts) else 0
        drop |= counts * r.cells_with_reads_nfold_below_max_to_keep < max_count
        keep = ~drop
        kept_packed = packed[keep]
        kept_counts = counts[keep]
        order_desc = np.argsort(-kept_counts, kind="stable")
        self.used_packed = kept_packed[order_desc]
        self.used_counts = kept_counts[order_desc]
        self.used_strs = [dna.unpack_kmer(int(w), 16) for w in self.used_packed]
        self.ranks = np.arange(1, len(self.used_packed) + 1)
        pats, _ = dna.encode_batch([s.encode() for s in self.used_strs], 16)
        self.used_pats = pats
        self.used_peq = editdist.build_peq(pats) if len(pats) else None
        self._pass1_packed, self._pass1_counts, self._pass1_keep = \
            packed, counts, keep

    def use_fixed_list(self):
        """Use the provided barcode list directly as the used list
        (reference -g/--cellRangerBCs: no pass-1 discovery)."""
        self.used_packed = np.asarray(self.whitelist)
        self.used_counts = np.zeros(len(self.used_packed), dtype=np.int64)
        self.used_strs = [dna.unpack_kmer(int(w), 16) for w in self.used_packed]
        self.ranks = np.arange(1, len(self.used_packed) + 1)
        pats, _ = dna.encode_batch([s.encode() for s in self.used_strs], 16)
        self.used_pats = pats
        self.used_peq = editdist.build_peq(pats) if len(pats) else None

    def write_barcode_list(self, path: str | Path):
        """BarcodeList.tsv: bc, exact-match count, ED1 neighbors(count)."""
        with open(path, "w") as fh:
            for i in np.argsort(-self._pass1_counts, kind="stable"):
                if not self._pass1_keep[i]:
                    continue
                nbs = " ".join(
                    f"{dna.unpack_kmer(int(self._pass1_packed[j]), 16)}({c})"
                    for j, c in self.neighbor_info.get(i, []))
                fh.write(f"{dna.unpack_kmer(int(self._pass1_packed[i]), 16)}\t"
                         f"{self._pass1_counts[i]}\t{nbs}\n")

    # ------------------------------------------------------------------
    # PASS 2
    # ------------------------------------------------------------------

    def max_ed(self) -> int:
        """User bcEditDistance capped by the dynamic table."""
        n = len(self.used_packed)
        if self.ed_table is not None:
            cap = self.ed_table.max_ed(self.cfg.barcodes.cell_bc_length,
                                       self.error_percent, n)
        else:
            # built-in default = reference bcMaxEditDistances.xml @1% error
            cap = 1
            for ed, c in ((4, 83), (3, 1127), (2, 26362), (1, 100000)):
                if n <= c:
                    cap = ed
                    break
        return min(self.user_max_ed, cap) if self.user_max_ed is not None else cap

    def split_chimeras(self, chunk: fastq.FastqChunk):
        """Detect + split chimeric reads; returns a new chunk in read order
        (synchronous wrapper over the tiled device scan). Split parts keep
        the original name (part 1) / get `sp2`, `sp3`... (later parts);
        reads with more than one confirmed junction are discarded."""
        handle = self.model.internal_tiles_async(chunk.seqs)
        splits, discard = self.model.finish_internal_tiles(handle)
        self.stats.multi_chimeric_discarded += len(discard)
        self.stats.split_chimeric += len(splits)
        keep = {i: splits.get(i, []) for i in range(len(chunk))
                if i not in discard}
        return self._split_parts_chunk(chunk, keep)

    def _split_parts_chunk(self, chunk: fastq.FastqChunk,
                           splits: dict[int, list[int]]):
        """Build a chunk of the reads in `splits` cut at their split
        positions (part 1 keeps the name, later parts get `sp2`, `sp3`,
        ...; a read with no position passes whole)."""
        names, comments, seqs, quals = [], [], [], []
        for i in sorted(splits):
            cuts = [0] + splits[i] + [len(chunk.seqs[i])]
            for part in range(len(cuts) - 1):
                nm = chunk.names[i] + (b"" if part == 0
                                       else b"sp%d" % (part + 1))
                names.append(nm)
                comments.append(chunk.comments[i])
                seqs.append(chunk.seqs[i][cuts[part]:cuts[part + 1]])
                quals.append(chunk.quals[i][cuts[part]:cuts[part + 1]])
        return fastq.FastqChunk(names, comments, seqs, quals)

    def _finish_chunk(self, chunk, th, sh, passed, failed,
                      defer_splits=False):
        """Force one pipelined chunk: merge the tiled chimera results with
        the fused scan+search results. Unsplit reads emit straight from the
        batch; split reads' parts re-scan through the same fused path. With
        defer_splits the rescan is only launched and a (sub_chunk, handle)
        job is returned for _finish_splits."""
        splits, discard = self.model.finish_internal_tiles(th)
        out, bc = self.model.finish_search(sh)
        self.stats.multi_chimeric_discarded += len(discard)
        self.stats.split_chimeric += len(splits)
        skip = discard | set(splits)
        self.pass2_emit(chunk, out, bc, passed, failed, skip=skip)
        if splits:
            sub = self._split_parts_chunk(chunk, splits)
            s_h = self.model.scan_search_async(sub.seqs, sub.quals)
            if defer_splits:
                return sub, s_h
            s_out, s_bc = self.model.finish_search(s_h)
            self.pass2_emit(sub, s_out, s_bc, passed, failed)
        return None

    def _finish_splits(self, job, passed, failed):
        """Force a deferred split-part rescan and emit its parts."""
        if job is None:
            return
        sub, s_h = job
        s_out, s_bc = self.model.finish_search(s_h)
        self.pass2_emit(sub, s_out, s_bc, passed, failed)

    def pass2_chunk(self, chunk: fastq.FastqChunk,
                    passed: fastq.FastqWriter, failed: fastq.FastqWriter):
        """Synchronous pass 2 (random-BC negative control / empty used
        list)."""
        self.stats.total_reads += len(chunk)
        chunk = self.split_chimeras(chunk)
        out = self.model.scan_reads(chunk.seqs, chunk.quals)
        n = len(chunk)
        if self.used_peq is None:
            # empty used-barcode list (e.g. wrong chemistry / no pass-1
            # hits): nothing can be assigned
            bc = {"ed": np.full(n, BIG, np.int64),
                  "idx": np.zeros(n, np.int64),
                  "ed2": np.full(n, editdist.INT_MAX, np.int64)}
            self.pass2_emit(chunk, out, bc, passed, failed)
            return
        wins = out["bc_windows"]
        if self.random_barcode:
            wins = self.rng.integers(0, 4, wins.shape).astype(np.int8)
        bc = bcsearch.bc_search(wins, self.used_peq, len(self.used_strs),
                                self.cfg.barcodes.cell_bc_length,
                                device=self.model.device)
        self.pass2_emit(chunk, out, bc, passed, failed)

    def pass2_emit(self, chunk: fastq.FastqChunk, out: dict, bc: dict,
                   passed: fastq.FastqWriter, failed: fastq.FastqWriter,
                   skip: set[int] | None = None):
        """Apply assignment rules + write outputs for one scanned chunk.

        `skip`: read indices excluded entirely (chimera-discarded reads and
        reads whose split parts re-emit separately). Record assembly runs in
        the native emitter when the hostenc extension is present."""
        r = self.cfg.readscanner
        bc_len = self.cfg.barcodes.cell_bc_length
        n = len(chunk)
        keep = np.ones(n, dtype=bool)
        if skip:
            keep[list(skip)] = False
        too_short = (out["true_lens"] < r.min_read_length) & keep
        stranded = out["stranded"] & ~too_short & keep
        self.stats.too_short += int(too_short.sum())
        self.stats.stranded += int(stranded.sum())
        self.stats.fwd += int((stranded & out["is_fwd"]).sum())
        self.stats.rev += int((stranded & ~out["is_fwd"]).sum())

        max_ed = self.max_ed()
        ok = stranded & (bc["ed"] <= max_ed) & (bc["ed2"] > bc["ed"])
        amb = stranded & (bc["ed"] <= max_ed) & ~ok
        self.stats.bc_ambiguous += int(amb.sum())
        assigned = ok
        bc_idx, bc_ed = bc["idx"], bc["ed"]
        # ed_sec beyond the dynamic search radius reports INT_MAX (the
        # reference's enumeration bails out at the radius)
        bc_ed2 = np.where(bc["ed2"] > max_ed, editdist.INT_MAX, bc["ed2"])

        n_assigned = int(assigned.sum())
        self.stats.bc_assigned += n_assigned
        self.stats.unassigned += int((keep & ~assigned).sum())
        eds_raw = bc_ed[assigned].astype(np.int64)
        for e, c in zip(*np.unique(eds_raw, return_counts=True)):
            self.stats.ed_hist[int(e)] += int(c)
        # assigned_hist rows are fixed 8-wide; clamp only there
        eds = np.minimum(eds_raw, 7)
        bis = bc_idx[assigned].astype(np.int64)
        if len(bis):
            keys = np.bincount(bis * 8 + eds)
            hot = np.nonzero(keys)[0]
            for bi_u in np.unique(hot >> 3):
                hist = self.assigned_hist.setdefault(
                    int(bi_u), np.zeros(8, dtype=np.int64))
                lo = int(bi_u) * 8
                row = keys[lo:lo + 8]
                hist[:len(row)] += row

        is5p = self.cfg.chemistry == "5p"
        ae = out["ae"].astype(np.int64)
        bc_start = np.where(is5p, ae + 1, ae - 1)
        bc_end = np.where(is5p, ae + bc_len, ae - bc_len)
        if self._emit_records(chunk, keep, assigned, out, bc_idx, bc_ed,
                              bc_ed2, bc_start, bc_end, passed, failed):
            return
        # pure-Python fallback emitter
        for i in range(n):
            if not keep[i]:
                continue
            name, seq, qual = chunk.names[i], chunk.seqs[i], chunk.quals[i]
            if not assigned[i]:
                failed.write(name, seq, qual, chunk.comments[i])
                continue
            is_fwd = bool(out["is_fwd"][i])
            if is_fwd:
                sseq, squal = seq, qual
            else:
                sseq = dna.revcomp_bytes(seq)
                squal = qual[::-1]
            xs_t, xe_t = int(out["x_start"][i]), int(out["x_end"][i])
            x_seq = sseq[max(xs_t, 0):xe_t + 1]
            nm = readname.encode_name(
                name, is_fwd=is_fwd,
                ps=int(out["ps"][i]), pe=int(out["pe"][i]), ae=int(ae[i]),
                bc=self.used_strs[int(bc_idx[i])], ed=int(bc_ed[i]),
                ed_sec=int(bc_ed2[i]),
                bc_start=int(bc_start[i]), bc_end=int(bc_end[i]),
                rank=int(self.ranks[int(bc_idx[i])]),
                x_seq=x_seq, x_qv=float(out["x_qv"][i]),
                tso_end=int(out["tso_end"][i]) if out["tso_end"][i] >= 0 else None,
                split_part=0)
            passed.write(nm, sseq, squal, chunk.comments[i])

    def _emit_records(self, chunk, keep, assigned, out, bc_idx, bc_ed,
                      bc_ed2, bc_start, bc_end, passed, failed) -> bool:
        """Native batch emitter (hostenc.emit_records); False -> caller
        falls back to the Python loop."""
        from sicelore_tpu_torch.io import native as _native
        ext = _native.get_hostenc()
        if ext is None or not hasattr(ext, "emit_records"):
            return False
        n = len(chunk)
        idx = bc_idx.astype(np.int32)
        ranks = np.asarray(self.ranks, dtype=np.int32)
        rank_arr = ranks[np.clip(idx, 0, max(len(ranks) - 1, 0))] \
            if len(ranks) else np.zeros(n, np.int32)
        bc_blob = ("".join(self.used_strs)).encode() if self.used_strs \
            else b""
        flags = (keep.astype(np.uint8)
                 | (assigned.astype(np.uint8) << 1)
                 | (out["is_fwd"].astype(np.uint8) << 2))
        pb, fb = ext.emit_records(
            chunk.names, chunk.comments, chunk.seqs, chunk.quals,
            flags.tobytes(),
            out["ps"].astype(np.int32).tobytes(),
            out["pe"].astype(np.int32).tobytes(),
            out["ae"].astype(np.int32).tobytes(),
            out["tso_end"].astype(np.int32).tobytes(),
            bc_ed.astype(np.int32).tobytes(),
            bc_ed2.astype(np.int32).tobytes(),
            bc_start.astype(np.int32).tobytes(),
            bc_end.astype(np.int32).tobytes(),
            rank_arr.astype(np.int32).tobytes(),
            out["x_start"].astype(np.int32).tobytes(),
            out["x_end"].astype(np.int32).tobytes(),
            out["x_qv"].astype(np.float32).tobytes(),
            idx.tobytes(), bc_blob,
            self.cfg.barcodes.cell_bc_length)
        passed.write_raw(bytes(pb))
        failed.write_raw(bytes(fb))
        return True

    # ------------------------------------------------------------------

    def write_barcodes_assigned(self, path: str | Path):
        """BarcodesAssigned.tsv: bc, n_reads, reads per ED."""
        max_ed_seen = 4
        with open(path, "w") as fh:
            fh.write("barcode\tnReads\t" +
                     "\t".join(f"ED{e}" for e in range(max_ed_seen + 1)) + "\n")
            items = sorted(self.assigned_hist.items(),
                           key=lambda kv: -int(kv[1].sum()))
            for bi, hist in items:
                fh.write(f"{self.used_strs[bi]}\t{int(hist.sum())}\t"
                         + "\t".join(str(int(hist[e]))
                                     for e in range(max_ed_seen + 1)) + "\n")

    def _write_reports(self, out_dir: Path):
        self.write_barcodes_assigned(out_dir / "BarcodesAssigned.tsv")
        with open(out_dir / "scanner_stats.json", "w") as fh:
            json.dump(self.stats.to_json(), fh, indent=1)
        self.write_report(out_dir / "ReadScanner.html")

    def _pass2_file(self, f: Path, out_dir: Path, ext: str, use_fused: bool):
        """Streaming pass 2 of one file. Fused scan+sweep, double-buffered
        (the device works on chunk i+1 while the host writes chunk i), with
        split-part rescans deferred one chunk; or, without a bound used
        list, the synchronous `pass2_chunk`."""
        pw = fastq.FastqWriter(out_dir / "passed" / f"{_stem(f)}FWD{ext}")
        fw = fastq.FastqWriter(out_dir / "failed" / f"{_stem(f)}FAILED{ext}")
        try:
            if not use_fused:
                for chunk in fastq.read_fastq(f, self.chunk_size):
                    self.pass2_chunk(chunk, pw, fw)
                return
            pending, split_job = None, None
            for chunk in fastq.read_fastq(f, self.chunk_size):
                self.stats.total_reads += len(chunk)
                th = self.model.internal_tiles_async(chunk.seqs)
                sh = self.model.scan_search_async(chunk.seqs, chunk.quals)
                if pending is not None:
                    nj = self._finish_chunk(*pending, pw, fw,
                                            defer_splits=True)
                    self._finish_splits(split_job, pw, fw)
                    split_job = nj
                pending = (chunk, th, sh)
            if pending is not None:
                nj = self._finish_chunk(*pending, pw, fw, defer_splits=True)
                self._finish_splits(split_job, pw, fw)
                split_job = nj
            self._finish_splits(split_job, pw, fw)
        finally:
            # async close: disk writes overlap the next file's compute
            pw.close(wait=False)
            fw.close(wait=False)

    def run(self, inputs: list[str | Path], out_dir: str | Path):
        """Run over fastq files and/or directories, in one process or in
        each process of a torch.distributed group (see the module
        docstring)."""
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        files = []
        for p in inputs:
            p = Path(p)
            files.extend(fastq.find_fastq_files(p) if p.is_dir() else [p])
        nproc = multihost.process_count()
        first = multihost.process_index() == 0
        if nproc > 1:
            files = multihost.shard_files(files)
        # PASS 1 (skipped when a known cell-BC list was provided)
        caching = self._cache_decision(files)
        if self.known_cells:
            self.use_fixed_list()
        elif caching:
            # FULL pass 1 (edge rows + BC windows cached per chunk), depth-2
            # double buffering + a 1-ahead reader thread
            p1_q: deque = deque()
            for f, chunk in _chunks_prefetched(files, self.chunk_size):
                h = self.model.scan_pass1_full_async(chunk.seqs, chunk.quals)
                p1_q.append((chunk, f, h))
                if len(p1_q) > 2:
                    self._pass1_apply_cached(p1_q.popleft())
            while p1_q:
                self._pass1_apply_cached(p1_q.popleft())
            self.wl_counts = multihost.allreduce_counts(self.wl_counts)
            self.build_used_list()
            if first:
                self.write_barcode_list(out_dir / "BarcodeList.tsv")
        else:
            # double-buffered: the device scans chunk i+1 while the host
            # counts chunk i's exact matches
            p1_pending = None
            for f in files:
                for chunk in fastq.read_fastq(f, self.chunk_size):
                    h = self.model.scan_pass1_async(chunk.seqs, chunk.quals)
                    if p1_pending is not None:
                        self._pass1_apply(self.model.finish_pass1(p1_pending))
                    p1_pending = h
            if p1_pending is not None:
                self._pass1_apply(self.model.finish_pass1(p1_pending))
            self.wl_counts = multihost.allreduce_counts(self.wl_counts)
            self.build_used_list()
            if first:
                self.write_barcode_list(out_dir / "BarcodeList.tsv")
        # PASS 2
        ext = ".fastq.gz" if self.compress else ".fastq"
        use_fused = not self.random_barcode and self.used_peq is not None
        if use_fused:
            self.model.prepare_search(self.used_pats, len(self.used_strs),
                                      radius=self.max_ed())
        if caching and use_fused and not self.known_cells:
            self._run_pass2_cached(out_dir, ext)
        else:
            for f in files:
                self._pass2_file(f, out_dir, ext, use_fused)
            self._p1_cache.clear()   # unused when use_fused fell through
        fastq.writer_barrier()
        if nproc > 1:
            self._merge_multihost()
        if first:
            self._write_reports(out_dir)
        return self.stats

    def _merge_multihost(self):
        """Sum the scan stats, the ED histogram and the per-barcode
        assignment histograms across processes (the MergeReadScannerStats
        role, live), as the JAX pipeline merges them: its int fields, the ED
        histogram in 8 bins (the last holding 7 and over), and the
        histograms of the barcodes that have assignments, in used-list
        order."""
        scalars = {k: v for k, v in self.stats.__dict__.items()
                   if isinstance(v, int)}
        for k, v in multihost.merge_scalar_stats(scalars).items():
            setattr(self.stats, k, v)
        ed = np.zeros(8, np.int64)
        for e, c in self.stats.ed_hist.items():
            ed[min(int(e), 7)] += c
        ed = multihost.allreduce_counts(ed)
        self.stats.ed_hist = defaultdict(
            int, {e: int(c) for e, c in enumerate(ed) if c})
        n = len(self.used_strs)
        hist = np.zeros((n, 8), np.int64)
        for bi, h in self.assigned_hist.items():
            hist[bi] = h
        hist = multihost.allreduce_counts(hist.ravel()).reshape(n, 8)
        self.assigned_hist = {bi: hist[bi] for bi in range(n)
                              if hist[bi].any()}

    def run_demon(self, inputs: list[str | Path], out_dir: str | Path,
                  poll_interval: float = 30.0, idle_timeout: float = 600.0,
                  log=print):
        """Demon mode (reference <runningasdemon>): run once, then keep
        polling the inputs; newly appearing fastq files pass through pass 2
        against the established used list, and stats and reports are
        rewritten. Stops after `idle_timeout` seconds without new files."""
        import time

        out_dir = Path(out_dir)
        # snapshot BEFORE the initial run: files appearing mid-run must be
        # picked up by the next poll, not silently skipped
        seen = set()
        for p in inputs:
            p = Path(p)
            seen.update(fastq.find_fastq_files(p) if p.is_dir() else [p])
        self.run(inputs, out_dir)
        ext = ".fastq.gz" if self.compress else ".fastq"
        use_fused = not self.random_barcode and self.used_peq is not None
        last_new = time.time()
        while time.time() - last_new < idle_timeout:
            time.sleep(poll_interval)
            fresh = []
            for p in inputs:
                p = Path(p)
                for f in (fastq.find_fastq_files(p) if p.is_dir() else [p]):
                    if f not in seen:
                        seen.add(f)
                        fresh.append(f)
            if not fresh:
                continue
            last_new = time.time()
            log(f"[demon] {len(fresh)} new file(s)")
            for f in fresh:
                with fastq.FastqWriter(
                        out_dir / "passed" / f"{_stem(f)}FWD{ext}") as pw, \
                     fastq.FastqWriter(
                        out_dir / "failed" / f"{_stem(f)}FAILED{ext}") as fw:
                    for chunk in fastq.read_fastq(f, self.chunk_size):
                        if not use_fused:
                            self.pass2_chunk(chunk, pw, fw)
                            continue
                        self.stats.total_reads += len(chunk)
                        th = self.model.internal_tiles_async(chunk.seqs)
                        sh = self.model.scan_search_async(chunk.seqs,
                                                          chunk.quals)
                        self._finish_chunk(chunk, th, sh, pw, fw)
            self._write_reports(out_dir)
        return self.stats

    def write_report(self, path):
        """Knee plot + scan statistics HTML (reference ReadScanner.html)."""
        from sicelore_tpu_torch.report import html
        assigned = sorted((int(h.sum()) for h in self.assigned_hist.values()),
                          reverse=True)
        sections = [("Knee plot", html.knee_plot(assigned))]
        if self.used_counts is not None and len(self.used_counts):
            sections.append(
                ("Pass-1 exact-match counts",
                 html.knee_plot(sorted((int(c) for c in self.used_counts),
                                       reverse=True),
                                title="Pass-1 reads per barcode")))
        ed_hist = dict(sorted(self.stats.ed_hist.items()))
        sections.append(("Barcode ED distribution",
                         html.svg_bars([str(k) for k in ed_hist],
                                       list(ed_hist.values()),
                                       title="reads per assignment ED",
                                       ylabel="reads")))
        sections.append(("Statistics", html.stats_table(
            {k: v for k, v in self.stats.to_json().items()
             if k != "ed_hist"})))
        html.write_html(path, "sicelore_tpu read scan", sections)
