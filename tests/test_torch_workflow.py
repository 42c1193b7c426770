"""The workflow `run`: the port's `run_pipeline` (and its CLI `run`) against
the JAX package's on the CPU, every file under the output directory byte
for byte (no file carries a wall time, so nothing is stripped); resume, the
explicit-minimap2 error and the CUDA request without a GPU behave as the
JAX package's do; and chip_smoke.py's `run` phase has a CPU twin."""
import json
import shutil

import numpy as np
import pytest
import torch

import chip_smoke as cs
from sicelore_tpu import __main__ as j_main
from sicelore_tpu.pipeline import workflow as j_workflow
from sicelore_tpu_torch.pipeline import workflow as t_workflow
from sicelore_tpu_torch.utils import dna, synth

STAGES = ["scanfastq", "minimap2", "assignumis", "barcodes",
          "isoformmatrix", "computeconsensus", "deduplicate",
          "collapsemodel"]


def align_inputs(d):
    """The inputs of tests/test_align.py::test_native_align_full_pipeline:
    a 60 kb genome of two genes (one of two exons), 400 3p reads of 12
    cells at 4% noise, a third reversed."""
    rng = np.random.default_rng(50)
    genome = synth.random_seq(rng, 60_000)
    gene1 = (10_000, 11_200)
    g2e1, g2e2 = (30_000, 30_500), (31_300, 31_900)
    wl = synth.make_whitelist(rng, 12)
    with open(d / "ref.fa", "w") as fh:
        fh.write(">chrS\n")
        for i in range(0, len(genome), 80):
            fh.write(genome[i:i + 80] + "\n")
    (d / "ref.refflat").write_text(
        f"G1\tT1\tchrS\t+\t{gene1[0]}\t{gene1[1]}\t{gene1[0]}\t{gene1[1]}\t"
        f"1\t{gene1[0]},\t{gene1[1]},\n"
        f"G2\tT2\tchrS\t+\t{g2e1[0]}\t{g2e2[1]}\t{g2e1[0]}\t{g2e2[1]}\t2\t"
        f"{g2e1[0]},{g2e2[0]},\t{g2e1[1]},{g2e2[1]},\n")
    (d / "wl.txt").write_text("\n".join(wl))
    (d / "fq").mkdir()
    with open(d / "fq" / "reads.fastq", "wb") as fh:
        for i in range(400):
            cdna = (genome[gene1[0]:gene1[1]] if i % 2 == 0 else
                    genome[g2e1[0]:g2e1[1]] + genome[g2e2[0]:g2e2[1]])
            umi = synth.random_seq(rng, 12)
            stranded = (synth.TSO + cdna + "A" * 20 + dna.revcomp_str(umi)
                        + dna.revcomp_str(wl[i % 12])
                        + dna.revcomp_str(synth.ADAPTER))
            stranded = synth.mutate(rng, stranded, 0.04)
            seq = (dna.revcomp_str(stranded) if i % 3 == 0
                   else stranded).encode()
            fh.write(b"@rd%d\n" % i + seq + b"\n+\n" + b"I" * len(seq)
                     + b"\n")
    return d / "fq", d / "ref.fa", d / "ref.refflat", d / "wl.txt"


def chain_inputs(d):
    """chip_smoke.py's generator of the chained and run phases at
    tests/test_torch_steps.py's size: two 120 kb contigs, 24 genes, 150
    reads of 4 cells, one group of 52-56 molecules (the batched UMI
    distances). Returns (fastq dir, fasta, refFlat, whitelist file, genes)."""
    rng = np.random.default_rng(77)
    wl = synth.make_whitelist(rng, 64)
    contigs, genes = cs.chain_genome(rng, 2, 120_000, 24, exon_len=(90, 180))
    cs.write_chain_refs(contigs, genes, d / "ref.fa", d / "ref.refflat")
    reads, _ = cs.chain_reads(rng, contigs, genes, wl[:4], 150, 1,
                              big_mols=(52, 56), big_depth=(1, 1))
    (d / "fq").mkdir()
    cs.write_reads(d / "fq" / "reads.fastq", reads)
    (d / "wl.txt").write_text("".join(w + "\n" for w in wl))
    return d / "fq", d / "ref.fa", d / "ref.refflat", d / "wl.txt", genes


def tree(out):
    return {str(f.relative_to(out)): f.read_bytes()
            for f in sorted(out.rglob("*")) if f.is_file()}


def _quiet(*a):
    pass


@pytest.fixture(scope="module")
def align_runs(tmp_path_factory):
    """Both packages' run_pipeline(nativeAlign, consensus, collapse) on
    align_inputs; the port's on the CPU."""
    d = tmp_path_factory.mktemp("wf")
    inputs = align_inputs(d)
    fq, ref, rf, wlf = inputs
    kw = dict(whitelist=wlf, bc_ed=2, native_align=True, with_consensus=True,
              with_collapse=True, log=_quiet)
    res_j = j_workflow.run_pipeline(fq, ref, rf, d / "jax", **kw)
    counters = cs.path_counters()
    for c in counters.values():
        c.launches = 0
    res_t = t_workflow.run_pipeline(fq, ref, rf, d / "torch", device="cpu",
                                    **kw)
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    return d, inputs, res_j, res_t, launches


def test_run_pipeline_byte_identical_to_jax(align_runs):
    d, _, res_j, res_t, launches = align_runs
    want, got = tree(d / "jax"), tree(d / "torch")
    assert sorted(got) == sorted(want)
    assert len(want) >= 30
    for name in want:
        assert got[name] == want[name], name
    assert json.dumps(res_t, default=str) == json.dumps(res_j, default=str)
    assert list(res_t) == ["scan", "aligned_records", "umi", "isoform",
                           "consensus", "dedup", "collapse"]
    # the CPU run: plain bodies only (the consensus stage runs the host
    # engine, so the band body launches in the aligner alone)
    assert {"plain_edgescan", "plain_bcsweep", "plain_tilescan",
            "plain_bandalign"} <= set(launches)
    assert not set(launches) & {"edgescan", "bcsweep", "tilescan", "win1",
                                "bandalign"}
    # the reads land in their genes (test_align's own check)
    rows = (d / "torch" / "isomatrix" / "sicelore_genematrix.txt"
            ).read_text().splitlines()
    assert {r.split("\t")[0] for r in rows[1:]} == {"G1", "G2"}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_rerun_resumes_every_stage(align_runs, tmp_path, pkg):
    """A second call on a finished output directory skips every stage:
    empty results, no launch, every stage output unchanged."""
    d, (fq, ref, rf, wlf), *_ = align_runs
    out = tmp_path / "out"
    shutil.copytree(d / pkg, out)
    before = tree(out)
    lines = []
    counters = cs.path_counters()
    for c in counters.values():
        c.launches = 0
    kw = dict(whitelist=wlf, bc_ed=2, native_align=True, with_consensus=True,
              with_collapse=True, log=lines.append)
    if pkg == "jax":
        res = j_workflow.run_pipeline(fq, ref, rf, out, **kw)
    else:
        res = t_workflow.run_pipeline(fq, ref, rf, out, device="cpu", **kw)
    assert res == {}
    assert not any(c.launches for c in counters.values())
    assert [l[1:l.index("]")] for l in lines] == STAGES
    assert all("] resume: " in l for l in lines)
    after = tree(out)
    assert after.pop("pipeline_results.json") == b"{}"
    before.pop("pipeline_results.json")
    assert after == before


def test_explicit_missing_minimap2_raises(align_runs, tmp_path):
    """An explicit --minimap2 path that does not exist fails the align
    stage in both packages (the native fallback is for the default tool
    name only); the scan resumes from its finished output."""
    d, (fq, ref, rf, wlf), *_ = align_runs
    for pkg, run, kw in (("jax", j_workflow.run_pipeline, {}),
                         ("torch", t_workflow.run_pipeline,
                          {"device": "cpu"})):
        out = tmp_path / pkg
        shutil.copytree(d / pkg / "readscan", out / "readscan")
        with pytest.raises(RuntimeError, match="minimap2 not found"):
            run(fq, ref, rf, out, whitelist=wlf, log=_quiet,
                minimap2_path=str(tmp_path / "no-such-minimap2"), **kw)
        assert not (out / "passed.sorted.bam").exists()


def test_cuda_without_gpu_raises(align_runs, tmp_path):
    """`device` defaults to cuda: without a GPU the first stage raises, and
    no stage writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA request is valid here")
    d, (fq, ref, rf, wlf), *_ = align_runs
    with pytest.raises(RuntimeError, match="cuda"):
        t_workflow.run_pipeline(fq, ref, rf, tmp_path / "o", whitelist=wlf,
                                bc_ed=2, native_align=True, log=_quiet)
    assert not (tmp_path / "o" / "readscan").exists()


def test_chip_smoke_run_phase_cpu_twin(tmp_path, capsys):
    """chip_smoke.run_workflow (the port's CLI `run -b 2 --nativeAlign
    --collapse --consensus`, in process) on the CPU over the smoke's
    generator, and the JAX CLI's `run` with the same flags: every file and
    every printed line the same."""
    fq, ref, rf, wlf, genes = chain_inputs(tmp_path)
    got = cs.run_workflow("cpu", fq, ref, rf, wlf, tmp_path / "torch",
                          consensus=True)
    assert got["rc"] == 0
    assert list(got["stage_s"]) == STAGES and not got["resumed"]
    assert {"plain_edgescan", "plain_bcsweep", "plain_tilescan",
            "plain_bandalign", "myers_global_pairwise"} <= set(
                got["launches"])
    assert not set(got["launches"]) & {"edgescan", "bcsweep", "tilescan",
                                       "win1", "bandalign"}
    capsys.readouterr()
    assert j_main.main(["run", "-d", str(fq), "-r", str(ref), "-a", str(rf),
                        "-o", str(tmp_path / "jax"), "--whitelist", str(wlf),
                        "-b", "2", "--nativeAlign", "--collapse",
                        "--consensus"]) == 0
    assert capsys.readouterr().out.splitlines() == got["printed"]
    want = tree(tmp_path / "jax")
    assert sorted(got["files"]) == sorted(want)
    for name in want:
        assert got["files"][name] == want[name], name
    n_prim, n_map, n_ge = cs.chain_truth(
        tmp_path / "torch" / "passed.sorted.bam",
        tmp_path / "torch" / "umi.bam", genes)
    assert n_prim >= 130 and n_map >= 0.97 * n_prim and n_ge >= 0.97 * n_prim
