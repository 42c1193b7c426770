"""End-to-end workflow orchestrator (Nextflow main.nf / quickrun role).

Drives the full pipeline with file-granular resume semantics (a stage is
skipped when its output already exists — the reference's `-resume` /
checkpoint-per-file model, sicelore-nf/main.nf:5-19, quickrun-2.1.sh):

  1. scanfastq           stranding + chimera split + cell BC assignment
  2. minimap2 (wrapped)  spliced alignment -> sorted BAM
  3. assignumis          UMI clustering + gene tags
  4a. isoformmatrix      molecule matrices (+ isobam)
  4b. consensus chain    computeconsensus -> deduplicate
  7. collapsemodel       novel isoforms (optional)

`device` ("cuda" or "cpu") goes to every stage that reaches the card:
scanfastq (edge scan, whitelist sweep, tile scan), the native aligner (the
band kernel of its gap extension) and assignumis (the batched UMI
distances). `cuda` without a GPU raises at the first of them; nothing falls
back to the plain bodies. The consensus stage runs the host engine
(`ops/poa.py`), as the reference package's `run` does, so that `run` writes
the same bytes; `computeconsensus` is where the device engine runs.

minimap2 is an external native tool in the reference too (README.md:545-
548); here it is subprocess-wrapped when present on PATH, with a clear
error otherwise.
"""
from __future__ import annotations

import json
import shutil
import subprocess
from pathlib import Path

from sicelore_tpu_torch.io import sam
from sicelore_tpu_torch.io.bam import sort_bam


class Minimap2Aligner:
    """Subprocess wrapper for minimap2 -ax splice -uf --sam-hit-only."""

    def __init__(self, path: str | None = None, threads: int = 4,
                 junc_bed: str | None = None, extra: list[str] | None = None):
        self.exe = path or shutil.which("minimap2")
        self.threads = threads
        self.junc_bed = junc_bed
        self.extra = extra or []

    def available(self) -> bool:
        return self.exe is not None

    def align(self, ref_fa, fastqs: list, out_bam, sort: bool = True):
        if not self.available() or shutil.which(str(self.exe)) is None:
            raise RuntimeError(
                "minimap2 not found on PATH — install it or provide an "
                "aligned BAM (reference pipeline step 2, README.md:545)")
        out_bam = Path(out_bam)
        sam_path = out_bam.with_suffix(".sam")
        cmd = [self.exe, "-ax", "splice", "-uf", "--sam-hit-only",
               "-t", str(self.threads)]
        if self.junc_bed:
            cmd += ["--junc-bed", str(self.junc_bed)]
        cmd += self.extra + [str(ref_fa)] + [str(f) for f in fastqs]
        with open(sam_path, "w") as fh:
            subprocess.run(cmd, stdout=fh, check=True)
        unsorted = out_bam.with_suffix(".unsorted.bam")
        n = sam.sam_to_bam(sam_path, unsorted if sort else out_bam)
        sam_path.unlink()
        if sort:
            sort_bam(unsorted, out_bam)
            unsorted.unlink()
        return n


def run_pipeline(fastq_dir, ref_fa, refflat, outdir, whitelist=None,
                 cells_csv=None, bc_ed: int = 1, junc_bed=None,
                 minimap2_path=None, threads: int = 4,
                 with_consensus: bool = False, with_collapse: bool = False,
                 min_umi: int = 1, resume: bool = True, log=print,
                 native_align: bool = False, device="cuda"):
    """Full pipeline; every stage output is a resume checkpoint."""
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    results = {}

    def stage(name, target, fn):
        target = Path(target)
        if resume and target.exists():
            log(f"[{name}] resume: {target} exists, skipping")
            return target
        log(f"[{name}] running...")
        fn(target)
        return target

    # 1. scanfastq
    scan_dir = out / "readscan"

    def _scan(_):
        from sicelore_tpu_torch.pipeline.scanfastq import (ScanFastqPipeline,
                                                           load_whitelist)
        from sicelore_tpu_torch.utils.config import PipelineConfig
        if cells_csv:
            with open(cells_csv) as fh:
                wl = [l.strip().split("-")[0] for l in fh if l.strip()]
            pipe = ScanFastqPipeline(PipelineConfig(), whitelist=wl,
                                     user_max_ed=bc_ed, known_cells=True,
                                     device=device)
        else:
            pipe = ScanFastqPipeline(PipelineConfig(),
                                     whitelist=load_whitelist(whitelist),
                                     user_max_ed=bc_ed, device=device)
        results["scan"] = pipe.run([Path(fastq_dir)], scan_dir).to_json()

    stage("scanfastq", scan_dir / "BarcodesAssigned.tsv", _scan)

    # 2. minimap2 + sort
    bam = out / "passed.sorted.bam"

    def _align(target):
        fastqs = sorted((scan_dir / "passed").glob("*.fastq*"))
        use_native = native_align
        if not use_native and (minimap2_path or "minimap2") == "minimap2":
            if shutil.which("minimap2") is None:
                # minimap2 absent and not explicitly requested: the
                # native aligner is the pipeline's self-contained
                # fallback. An explicit --minimap2 path that is missing
                # still errors.
                log("minimap2 not found; using the native spliced aligner")
                use_native = True
        if use_native:
            # the package's own spliced aligner (align/, the minimap2 role)
            from sicelore_tpu_torch.align import NativeAligner
            aln2 = NativeAligner(ref_fa, junc_bed=junc_bed, device=device)
            st = aln2.align_fastq_to_bam(scan_dir / "passed", target)
            results["aligned_records"] = st["mapped"]
        else:
            aln = Minimap2Aligner(minimap2_path, threads, junc_bed)
            results["aligned_records"] = aln.align(ref_fa, fastqs, target)

    stage("minimap2", bam, _align)

    # 3. assignumis
    umi_bam = out / "umi.bam"

    def _umi(target):
        from sicelore_tpu_torch.pipeline.assignumis import AssignUmisPipeline
        pipe = AssignUmisPipeline(refflat=refflat, device=device)
        results["umi"] = pipe.run(
            bam, target, genecounts_tsv=out / "genecounts.tsv",
            umidepths_tsv=out / "UMIdepths.tsv",
            log_json=out / "umi.log.json").to_json()

    stage("assignumis", umi_bam, _umi)

    # 4. cell list + isoform matrix
    cells = out / "barcodes.csv"

    def _cells(target):
        # SelectValidCellBarcode role: barcodes with >= min_umi UMIs
        from collections import defaultdict
        from sicelore_tpu_torch.io.bam import BamReader
        umis = defaultdict(set)
        with BamReader(umi_bam) as rd:
            for r in rd:
                bc, u8 = r.get_tag("BC"), r.get_tag("U8")
                if bc and u8:
                    umis[bc].add(u8)
        with open(target, "w") as fh:
            for bc, s in sorted(umis.items(), key=lambda kv: -len(kv[1])):
                if len(s) >= min_umi:
                    fh.write(bc + "-1\n")

    stage("barcodes", cells, _cells)

    iso_dir = out / "isomatrix"

    def _iso(_):
        from sicelore_tpu_torch.pipeline.isoform import isoform_matrix
        results["isoform"] = isoform_matrix(
            umi_bam, refflat, cells, iso_dir, prefix="sicelore",
            isobam=with_collapse)

    stage("isoformmatrix", iso_dir / "sicelore_isomatrix.txt", _iso)

    # 4b. consensus chain (optional)
    if with_consensus:
        cons = out / "consensus.fastq"

        def _cons(target):
            # the host engine: the reference package's run computes its
            # consensus there, and its bytes differ from the device engine's
            from sicelore_tpu_torch.pipeline.consensus import compute_consensus
            results["consensus"] = compute_consensus(umi_bam, target,
                                                     engine="host")

        stage("computeconsensus", cons, _cons)
        dedup = out / "molecules.fastq"

        def _dedup(target):
            from sicelore_tpu_torch.pipeline.programs import \
                deduplicate_molecule
            results["dedup"] = deduplicate_molecule(cons, target)

        stage("deduplicate", dedup, _dedup)

    # 7. collapse model (optional, needs isobam)
    if with_collapse:
        cm = out / "collapse"

        def _cm(_):
            from sicelore_tpu_torch.pipeline.collapsemodel import \
                collapse_model
            results["collapse"] = collapse_model(
                iso_dir / "sicelore_isobam.bam", refflat, cells, cm)

        stage("collapsemodel", cm / "CollapseModel.txt", _cm)

    with open(out / "pipeline_results.json", "w") as fh:
        json.dump(results, fh, indent=1, default=str)
    return results
