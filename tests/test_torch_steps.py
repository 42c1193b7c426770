"""Steps 1 -> 2 -> 3 -> 4b chained: a small synthetic run (chip_smoke.py's
generator: a genome with one- and two-exon genes, 3p reads of (cell, gene)
groups, one group large enough for the batched UMI distances; short genes
keep the Pallas interpret runs small) through the port's scanfastq ->
align -> assignumis -> tagbamwithread -> computeconsensus on the CPU and
through the same steps of the JAX package: every output file
byte-identical."""
import numpy as np
import pytest

import chip_smoke as cs

SCAN_FILES = ("BarcodeList.tsv", "BarcodesAssigned.tsv", "scanner_stats.json")


def jax_chain(fastq_dir, ref, refflat, wl, out):
    """The JAX package's five steps, as chip_smoke.chain_steps runs the
    port's (the band kernels in Pallas interpret mode); returns {relative
    path: bytes} of every output file but the HTML scan report."""
    from sicelore_tpu.align import NativeAligner
    from sicelore_tpu.ops.poa_tpu import BatchedConsensusEngine
    from sicelore_tpu.pipeline import programs
    from sicelore_tpu.pipeline.assignumis import AssignUmisPipeline
    from sicelore_tpu.pipeline.consensus import compute_consensus
    from sicelore_tpu.pipeline.scanfastq import ScanFastqPipeline
    from sicelore_tpu.utils.config import PipelineConfig
    passed = out / "scan" / "passed"
    ScanFastqPipeline(PipelineConfig(), whitelist=wl, chunk_size=8_192).run(
        [fastq_dir], out / "scan")
    NativeAligner(ref, use_device=False).align_fastq_to_bam(
        passed, out / "aligned.bam")
    AssignUmisPipeline(refflat=refflat).run(
        out / "aligned.bam", out / "umi.bam",
        genecounts_tsv=out / "umi.genecounts.tsv",
        umidepths_tsv=out / "umi.UMIdepths.tsv", log_json=out / "umi.bam.log")
    programs.tag_bam_with_read(out / "umi.bam", out / "umi_us.bam", passed)
    compute_consensus(out / "umi_us.bam", out / "consensus.fastq",
                      engine=BatchedConsensusEngine(force="pallas-interpret"),
                      log_json=out / "consensus.fastq.log")
    return {str(f.relative_to(out)): f.read_bytes()
            for f in sorted(out.rglob("*")) if f.is_file()
            and f.name != "ReadScanner.html"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("chain")
    rng = np.random.default_rng(77)
    from sicelore_tpu_torch.utils import synth
    wl = synth.make_whitelist(rng, 64)
    contigs, genes = cs.chain_genome(rng, 2, 120_000, 24,
                                     exon_len=(90, 180))
    cs.write_chain_refs(contigs, genes, d / "ref.fa", d / "ref.refflat")
    reads, _ = cs.chain_reads(rng, contigs, genes, wl[:4], 150, 1,
                              big_mols=(52, 56), big_depth=(1, 1))
    (d / "fq").mkdir()
    cs.write_reads(d / "fq" / "reads.fastq", reads)
    return d, wl, genes


def test_steps_1_to_4b_byte_identical_to_jax(run):
    d, wl, genes = run
    want = jax_chain(d / "fq", d / "ref.fa", d / "ref.refflat", wl, d / "jax")
    steps, got = cs.chain_steps("cpu", d / "fq", d / "ref.fa",
                                d / "ref.refflat", wl, d / "torch")
    # the CPU path: plain bodies only, the gap extension in the aligner
    # and the batched UMI distances in assignumis
    assert set(steps["align"]["launches"]) == {"plain_bandalign"}
    assert set(steps["assignumis"]["launches"]) == {"plain_pairwise",
                                                    "myers_global_pairwise"}
    assert not any(k in ("edgescan", "bcsweep", "tilescan", "win1",
                         "bandalign") for st in steps.values()
                   for k in st["launches"])
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    for name in ("aligned.bam", "aligned.bam.bai", "umi.bam",
                 "consensus.fastq", *(f"scan/{f}" for f in SCAN_FILES)):
        assert got[name], name
    # the generator's truth: reads land in their gene and carry it as GE
    n_prim, n_map, n_ge = cs.chain_truth(d / "torch" / "aligned.bam",
                                         d / "torch" / "umi.bam", genes)
    assert n_prim >= 140 and n_map >= 0.97 * n_prim and n_ge >= 0.97 * n_prim
