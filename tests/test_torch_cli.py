"""The port's CLI against the JAX package's: the same 51 subcommands with
the same option strings, defaults, choices and required flags (the port
adds `--device` on the six commands that reach the card, and `env`), and
every host-only subcommand run through both CLIs' `main([...])` on one
small set of inputs: the same printed line and the same output files.

The inputs are a small run of the port (chip_smoke.py's generator through
`run --nativeAlign --consensus --collapse` on the CPU, which
tests/test_torch_workflow.py holds to the JAX package's run byte for byte)
and files derived from it: tagged BAMs (BC/U8/GE, US/QS, IG/IT), the cell
csv, the refFlat, the genome, fastqs, a SNP csv, BED files, id lists. The
one gzip output (parseillumina's table) is compared decompressed: its
header carries the time it was written."""
import argparse
import gzip
import shutil

import numpy as np
import pytest

from sicelore_tpu import __main__ as j_main
from sicelore_tpu_torch import __main__ as t_main
from sicelore_tpu_torch.io.bam import BamReader, BamWriter
from sicelore_tpu_torch.pipeline import programs
from sicelore_tpu_torch.pipeline import workflow as t_workflow
from sicelore_tpu_torch.pipeline.consensus import compute_consensus
from test_torch_workflow import chain_inputs

COMMANDS = (
    "scanfastq", "assignumis", "isoformmatrix", "computeconsensus",
    "tagbamwithread", "deduplicatemolecule", "addbammoleculetags",
    "addgenenametag", "bam2fastq", "filterbam", "snpmatrix",
    "fusiondetector", "exportclippedreads", "addbamreadtags", "sortbam",
    "selectvalidcellbarcode", "filterbammf", "cleanusuq",
    "exportumifoundrecords", "filtermoleculebam", "addlabel2barcode",
    "splitbam", "splitbampercell", "splitbampercluster", "splitbamperstage",
    "crisprstats", "parsefastq", "parsetr", "precompile", "moleculecounter",
    "exportmetrics", "exportmoleculereads", "addreadstomolecules",
    "haplotypecaller", "mergescanstats", "parseillumina", "annotatemodel",
    "junctionvalidator", "snpmatrix3pend", "addisobam", "isobam",
    "junctionannotate", "samview", "run", "align", "histo",
    "saturationcurve", "readbamstats", "exporteditdistances",
    "bulk2fakesinglecell", "collapsemodel")
DEVICE_COMMANDS = {"scanfastq", "align", "assignumis", "computeconsensus",
                   "run", "precompile"}


def _jax_parser():
    """The JAX CLI's parser, built as its main() builds it."""
    ap = argparse.ArgumentParser(prog="sicelore_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for add in (j_main._add_scanfastq, j_main._add_assignumis,
                j_main._add_isoformmatrix, j_main._add_computeconsensus,
                j_main._add_simple_programs):
        add(sub)
    return ap


def _commands(ap):
    return next(a for a in ap._actions
                if isinstance(a, argparse._SubParsersAction)).choices


def _spec(parser):
    """{option strings or positional dest: (default, choices, required,
    nargs, type, action class)} of a subcommand's arguments."""
    return {tuple(a.option_strings) or a.dest:
            (a.default, tuple(a.choices) if a.choices else None, a.required,
             a.nargs, a.type, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_same_subcommands():
    j, t = _commands(_jax_parser()), _commands(t_main.build_parser())
    assert len(COMMANDS) == 51
    assert sorted(j) == sorted(COMMANDS)
    assert sorted(t) == sorted(COMMANDS + ("env",))


@pytest.mark.parametrize("cmd", COMMANDS)
def test_subcommand_options_match_jax(cmd):
    """Option strings, defaults, choices, required; --device (cuda or cpu,
    default cuda) only where the command reaches the card, and --trace
    (the program's tracer, off by default) on computeconsensus only."""
    j = _spec(_commands(_jax_parser())[cmd])
    t = _spec(_commands(t_main.build_parser())[cmd])
    dev = t.pop(("--device",), None)
    if cmd in DEVICE_COMMANDS:
        assert dev is not None and dev[:3] == ("cuda", ("cuda", "cpu"), False)
    else:
        assert dev is None
    tr = t.pop(("--trace",), None)
    if cmd == "computeconsensus":
        assert tr is not None and tr[:3] == (None, None, False)
    else:
        assert tr is None
    assert t == j


def _quiet(*a):
    pass


def _write(path, header, recs):
    with BamWriter(path, header) as w:
        for r in recs:
            w.write(r)


def host_inputs(d):
    """The small run and the files derived from it: {name: path}."""
    fq, ref, rf, wlf, _ = chain_inputs(d)
    run = d / "run"
    t_workflow.run_pipeline(fq, ref, rf, run, whitelist=wlf, bc_ed=2,
                            native_align=True, with_consensus=True,
                            with_collapse=True, log=_quiet, device="cpu")
    iso, scan = run / "isomatrix", run / "readscan"
    p = {"umi": run / "umi.bam", "sorted": run / "passed.sorted.bam",
         "isobam": iso / "sicelore_isobam.bam",
         "molinfos": iso / "sicelore_molinfos.txt",
         "cells": run / "barcodes.csv", "refflat": rf, "genome": ref,
         "passed": scan / "passed", "passed_fq": scan / "passed" /
         "readsFWD.fastq", "assigned": scan / "BarcodesAssigned.tsv",
         "stats": scan / "scanner_stats.json",
         "model": run / "collapse" / "CollapseModel.txt"}
    with BamReader(p["umi"]) as rd:
        header, recs = rd.header, list(rd)
    tagged = [r for r in recs if r.get_tag("BC") and r.get_tag("U8")]
    rng = np.random.default_rng(3)

    p["us"] = d / "us.bam"
    programs.tag_bam_with_read(p["umi"], p["us"], p["passed"])
    # `run`'s own consensus.fastq is empty (its consensus stage reads a BAM
    # without US/CS tags, as the reference package's run does): the
    # deduplicate input is the consensus of the US-tagged BAM
    p["consensus"] = d / "consensus.fastq"
    compute_consensus(p["us"], p["consensus"], engine="host")

    def derived(name, edit, pick=tagged):
        with BamReader(p["umi"]) as rd:
            fresh = {r.qname + str(r.pos): r for r in rd}
        out = []
        for i, r0 in enumerate(pick):
            r = fresh[r0.qname + str(r0.pos)]
            if edit(i, r) is not False:
                out.append(r)
        p[name] = d / f"{name}.bam"
        _write(p[name], header, out)

    derived("named", lambda i, r: [
        setattr(r, "qname",
                f"{r.get_tag('BC')}-{r.get_tag('U8')}-{i % 3 + 1}"),
        r.set_tag("RN", i % 3 + 1, "i")])
    derived("readnamed", lambda i, r: setattr(
        r, "qname", f"{r.qname}_{r.get_tag('GE') or 'undef'}_"
                    f"{r.get_tag('BC')}_{r.get_tag('U8')}"))
    derived("stage", lambda i, r: r.set_tag(
        "BC", f"{r.get_tag('BC')}-s{i % 3}", "Z"))
    derived("illumina", lambda i, r: [
        r.set_tag("CB", r.get_tag("BC") + "-1", "Z"),
        r.set_tag("UB", r.get_tag("U8"), "Z"),
        r.get_tag("GE") and r.set_tag("GN", r.get_tag("GE"), "Z")])
    primers = ["AACGTGAT", "AAACATCG", "ATGCCTAA", "AGTGGTCA"]
    (d / "parse.csv").write_text(
        "bci,sequence,uid,well,type\n" + "".join(
            f"{i},{s},u{i},A{i},{'TR'[i % 2]}\n"
            for i, s in enumerate(primers)))
    p["parse_csv"] = d / "parse.csv"
    derived("parse", lambda i, r: [
        r.set_tag("CR", f"{primers[i % 4]}_x_y", "Z"),
        r.set_tag("CB", r.get_tag("BC"), "Z"),
        r.set_tag("pN", r.get_tag("U8"), "Z"),
        r.set_tag("GN", r.get_tag("GE") or "none", "Z"),
        r.set_tag("XF", ("CODING", "UTR", "INTRONIC")[i % 3], "Z"),
        r.set_tag("pS", f"sample{i % 2}", "Z")])
    # fusions: every third record takes the molecule of a record of
    # another gene in the same cell
    first = {}
    for r in tagged:
        first.setdefault((r.get_tag("BC"), r.get_tag("GE")), r)

    def fuse(i, r):
        if i % 3:
            return
        for (bc, ge), o in first.items():
            if bc == r.get_tag("BC") and ge and ge != r.get_tag("GE"):
                r.set_tag("U8", o.get_tag("U8"), "Z")
                return
    derived("fusion", fuse)
    derived("unsorted", lambda i, r: None, pick=tagged[::-1])
    derived("targeted", lambda i, r: None if i % 2 else False)

    genes = [r for r in tagged if r.get_tag("GE")]
    seen, snps = set(), []
    for r in genes:
        if r.get_tag("GE") not in seen and len(snps) < 6:
            seen.add(r.get_tag("GE"))
            chrom = header.refs[r.ref_id][0]
            a, b = r.pos + 31, r.pos + 57
            snps.append(f"{chrom},{a}|{b},+,{r.get_tag('GE')}" if len(snps)
                        % 2 else f"{chrom},{a},+,{r.get_tag('GE')}")
    (d / "snp.csv").write_text("\n".join(snps) + "\n")
    p["snp"] = d / "snp.csv"
    (d / "ids.txt").write_text("".join(
        f"@{r.qname.split('_')[0]}\n" for r in recs[:: 4]))
    p["ids"] = d / "ids.txt"
    cells = [l.strip().split("-")[0] for l in open(p["cells"]) if l.strip()]
    (d / "clusters.csv").write_text("".join(
        f"{c},cluster{i % 2}\n" for i, c in enumerate(cells)))
    p["clusters"] = d / "clusters.csv"
    (d / "stages.csv").write_text('s0,"early stage"\ns1,late\ns2,late\n')
    p["stages"] = d / "stages.csv"
    (d / "mols.csv").write_text("".join(
        f"{r.get_tag('BC')},{r.get_tag('U8')}\n" for r in tagged[:: 7]))
    p["mols"] = d / "mols.csv"
    junc = ["id\tchrom\tstrand\tx\tstart\tend"]
    cage, polya = [], []
    for k, line in enumerate(open(rf)):
        f = line.rstrip("\n").split("\t")
        chrom, strand = f[2], f[3]
        s = [int(x) for x in f[9].rstrip(",").split(",")]
        e = [int(x) for x in f[10].rstrip(",").split(",")]
        for a, b in zip(e[:-1], s[1:]):
            junc.append(f"j{k}\t{chrom}\t{strand}\t.\t{a}\t{b + 1}")
            junc.append(f"n{k}\t{chrom}\t{strand}\t.\t{a + 7}\t{b + 1}")
        five, three = (int(f[4]), int(f[5])) if strand == "+" else (
            int(f[5]), int(f[4]))
        off = int(rng.integers(-60, 60))
        cage.append(f"{chrom}\t{five + off}\t{five + off + 1}\tc{k}\t0\t"
                    f"{strand}")
        polya.append(f"{chrom}\t{three - off}\t{three - off + 1}\tp{k}\t0\t"
                     f"{strand}")
    (d / "junctions.tsv").write_text("\n".join(junc) + "\n")
    (d / "cage.bed").write_text("\n".join(cage) + "\n")
    (d / "polya.bed").write_text("track name=polya\n" + "\n".join(polya)
                                 + "\n")
    p.update(junctions=d / "junctions.tsv", cage=d / "cage.bed",
             polya=d / "polya.bed")
    shutil.copy(p["stats"], d / "stats2.json")
    shutil.copy(p["assigned"], d / "assigned2.tsv")
    p.update(stats2=d / "stats2.json", assigned2=d / "assigned2.tsv")
    chrom = header.refs[0][0]
    p["coord"] = f"{chrom}:1-{header.refs[0][1]}"
    return p


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return host_inputs(tmp_path_factory.mktemp("cli"))


# (case id, argv); {name} is an input path, out* names are outputs
HOST_CASES = [
    ("isoformmatrix", "isoformmatrix -I {umi} -R {refflat} -C {cells} "
                      "-O out -P iso --ISOBAM"),
    ("isoformmatrix_options", "isoformmatrix -I {umi} -R {refflat} -C "
     "{cells} -O out --DELTA 5 --METHOD STRICT --AMBIGUOUS_ASSIGN "
     "--MAPQV0 --TOBULK"),
    ("tagbamwithread", "tagbamwithread -I {umi} -O out.bam -F {passed}"),
    ("deduplicatemolecule", "deduplicatemolecule -I {consensus} "
                            "-O out.fastq"),
    ("addbammoleculetags", "addbammoleculetags -I {named} -O out.bam"),
    ("addgenenametag", "addgenenametag -I {sorted} -O out.bam -R {refflat}"),
    ("bam2fastq", "bam2fastq -I {umi} -O out.fastq"),
    ("bam2fastq_tags", "bam2fastq -I {us} -O out.fastq --SEQTAG US "
                       "--QUALTAG QS"),
    ("filterbam", "filterbam -I {umi} -O out.bam --TAG GE"),
    ("snpmatrix", "snpmatrix -I {umi} -S {snp} -C {cells} -O out"),
    ("snpmatrix_min", "snpmatrix -I {umi} -S {snp} -C {cells} -O out "
                      "-P s --MINRN 1 --MINQV 10"),
    ("fusiondetector", "fusiondetector -I {fusion} -C {cells} -O out"),
    ("exportclippedreads", "exportclippedreads -I {us} -O out.fastq "
                           "--MINCLIP 1"),
    ("addbamreadtags", "addbamreadtags -I {readnamed} -O out.bam"),
    ("sortbam", "sortbam -I {unsorted} -O out.bam"),
    ("selectvalidcellbarcode", "selectvalidcellbarcode -I {assigned} "
                               "-O out.csv --MINUMI 2 --ED0ED1RATIO 0.5"),
    ("filterbammf", "filterbammf -I {umi} -O out.bam -C {cells}"),
    ("cleanusuq", "cleanusuq -I {us} -O out.bam"),
    ("exportumifoundrecords", "exportumifoundrecords -I {umi} "
                              "-O out.bam"),
    ("filtermoleculebam", "filtermoleculebam -I {named} -O out.bam "
                          "--MINRN 2"),
    ("filtermoleculebam_iso", "filtermoleculebam -I {isobam} -O out.bam "
                              "--ISOONLY"),
    ("addlabel2barcode", "addlabel2barcode -I {umi} -O out.bam -L LAB"),
    ("splitbam", "splitbam -I {umi} -O out --IDS {ids}"),
    ("splitbampercell", "splitbampercell -I {umi} -O out -C {cells}"),
    ("splitbampercluster", "splitbampercluster -I {umi} -O out "
                           "-C {clusters}"),
    ("splitbamperstage", "splitbamperstage -I {stage} -O out -C {stages}"),
    ("crisprstats", "crisprstats -I {umi} --HISTO h.txt --DETAIL d.txt "
                    "--MINSIZE 1 --COORD {coord}"),
    ("parsefastq", "parsefastq -I {passed} -O out --offset 10 "
                   "--min_cdna 5"),
    ("parsetr", "parsetr -I {parse} -C {parse_csv} -O out"),
    ("moleculecounter", "moleculecounter -I {umi}"),
    ("exportmetrics", "exportmetrics -I {umi} -C {cells} --OM m.txt "
                      "--OC c.txt --CELLTAG BC --UMITAG U8 --GENETAG GE"),
    ("exportmoleculereads", "exportmoleculereads -I {us} -C {mols} "
                            "-O out.fastq"),
    ("addreadstomolecules", "addreadstomolecules -I {umi} -T {targeted} "
                            "-O out.bam"),
    ("haplotypecaller", "haplotypecaller -I {isobam} -O out"),
    ("mergescanstats_json", "mergescanstats -I {stats},{stats2} "
                            "-O out.json"),
    ("mergescanstats_tsv", "mergescanstats -I {assigned},{assigned2} "
                           "-O out.tsv"),
    ("parseillumina", "parseillumina -I {illumina} -O out.json.gz"),
    ("annotatemodel", "annotatemodel -M {model} -O out.txt"),
    ("annotatemodel_all", "annotatemodel -M {model} -I {sorted} --CAGE "
                          "{cage} --POLYA {polya} -O out.txt"),
    ("junctionvalidator", "junctionvalidator -I {junctions} -R {refflat} "
                          "-O out.tsv --SHORT {sorted}"),
    ("snpmatrix3pend", "snpmatrix3pend -I {isobam} -S {snp} -R {refflat} "
                       "-O out.tsv"),
    ("addisobam", "addisobam -I {umi} -R {refflat} -O out.bam --DELTA 4 "
                  "--MAXCLIP 100"),
    ("isobam", "isobam -I {umi} --MOLINFOS {molinfos} -O out.bam"),
    ("isobam_noundef", "isobam -I {umi} --MOLINFOS {molinfos} -O out.bam "
                       "--NOUNDEF"),
    ("junctionannotate", "junctionannotate -R {refflat} -G {genome} "
                         "-O out.tsv"),
    ("samview_bam", "samview -I {umi} -O out.sam"),
    *[(f"histo_{k}", f"histo {k} -I {{{src}}} -O out")
      for k, src in (("readlength", "passed_fq"), ("fastqmeanqv", "passed_fq"),
                     ("clipping", "umi"), ("moleculelength", "sorted"),
                     ("percentidentity", "sorted"), ("umidepth", "named"))],
    ("histo_readlength_bam", "histo readlength -I {umi} -O out"),
    ("saturationcurve", "saturationcurve -I {umi} -O out"),
    ("readbamstats", "readbamstats -I {umi} -O out.json"),
    ("readbamstats_stdout", "readbamstats -I {sorted}"),
    ("exporteditdistances", "exporteditdistances -I {umi} -O out.tsv"),
    ("bulk2fakesinglecell", "bulk2fakesinglecell -I {passed_fq} "
                            "-O out.fastq --BARCODE ACGTACGTACGTACGT"),
    ("collapsemodel", "collapsemodel -I {isobam} -R {refflat} -C {cells} "
                      "-O out"),
    ("collapsemodel_validate", "collapsemodel -I {isobam} -R {refflat} "
     "-C {cells} -O out -P cm --DELTA 3 --MINEVIDENCE 1 --RNMIN 1 --CAGE "
     "{cage} --POLYA {polya} --SHORT {sorted} --cageCo 40 --polyaCo 40 "
     "--juncCo 1"),
]


def test_host_cases_cover_every_host_command():
    host = {c for c in COMMANDS if c not in DEVICE_COMMANDS}
    assert {argv.split()[0] for _, argv in HOST_CASES} == host


def _jax_cli(args):
    """The JAX CLI's main. Its dispatch leaves `exportmetrics` (and `align`)
    out of the set it hands to cmd_simple, so there it stops with "unknown
    command"; that command runs its cmd_simple branch directly (a quirk of
    the reference that the port does not keep)."""
    if args[0] == "exportmetrics":
        return j_main.cmd_simple(_jax_parser().parse_args(args))
    return j_main.main(args)


def _files(d):
    out = {}
    for f in sorted(d.rglob("*")):
        if f.is_file():
            b = f.read_bytes()
            out[str(f.relative_to(d))] = (gzip.decompress(b)
                                          if f.suffix == ".gz" else b)
    return out


@pytest.mark.parametrize("case,argv", HOST_CASES,
                         ids=[c for c, _ in HOST_CASES])
def test_host_command_matches_jax(inputs, case, argv, tmp_path, monkeypatch,
                                  capsys):
    """Both CLIs, each in its own working directory with the same relative
    output names: the same printed line, the same files."""
    args = argv.format(**{k: str(v) for k, v in inputs.items()}).split()
    got = {}
    for name, main in (("jax", _jax_cli), ("torch", t_main.main)):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        capsys.readouterr()
        assert main(args) == 0
        got[name] = (capsys.readouterr().out, _files(work))
    (out_j, files_j), (out_t, files_t) = got["jax"], got["torch"]
    assert out_t == out_j
    assert out_t.startswith(f"{args[0]} done") or args[0] == "isoformmatrix"
    assert sorted(files_t) == sorted(files_j)
    assert files_j or args[0] == "moleculecounter" or \
        case == "readbamstats_stdout"
    for f in files_j:
        assert files_t[f] == files_j[f], f


def test_precompile_jobs_reach_every_kernel_body():
    """The warm-up's calls, on the CPU at a small size, each reach the plain
    body of the kernel they warm (on the card the wrapper's counter must
    move, or warm raises)."""
    import torch

    import chip_smoke as cs
    from sicelore_tpu_torch.utils import precompile

    counters = cs.path_counters()
    jobs = precompile.jobs(torch.device("cpu"), 64, True, 300)
    assert {k for _, k, _ in jobs} == set(precompile.KERNELS)
    for name, kernel, fn in jobs:
        for c in counters.values():
            c.launches = 0
        fn()
        moved = {k for k, c in counters.items() if c.launches}
        assert f"plain_{kernel}" in moved, (name, moved)
        assert not moved & set(precompile.KERNELS), name


def test_precompile_cpu_says_nothing_to_build(capsys):
    assert t_main.main(["precompile", "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    assert "nothing to build" in cap.err
    assert cap.out == "precompile done: {}\n"


def test_precompile_cuda_without_gpu_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA request is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        t_main.main(["precompile"])
