"""QC / diagnostic programs: Histo*, SaturationCurve, ReadBamStats,
EditDistance export, Bulk2FakeSingleCell.

Reference programs (one histogram program each, JFreeChart HTML +
tsv): HistoReadLength, HistoFastqMeanQV, HistoClipping,
HistoMoleculeLength, HistoPercentIdentity, HistoUMIDepth (81-194 LoC each);
SaturationCurve (Monte-Carlo RN subsampling, programs/SaturationCurve.java
:38-118); ReadBamStats (counter dump); EditDistance (per-molecule B1/U1 ED
export); Bulk2FakeSingleCell (constant BC + random UMI synthetic generator,
programs/Bulk2FakeSingleCell.java:38-73).
"""
from __future__ import annotations

import json
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np

from sicelore_tpu_torch.io import fastq
from sicelore_tpu_torch.io.bam import BamReader, BamWriter
from sicelore_tpu_torch.report import html


def _write_histo(values, out_prefix, title, xlabel, bins=50, log=False):
    values = np.asarray(values, dtype=np.float64)
    p = Path(str(out_prefix))
    p.parent.mkdir(parents=True, exist_ok=True)
    if len(values) == 0:
        Path(f"{p}.tsv").write_text(f"{xlabel}\tcount\n")
        html.write_html(f"{p}.html", title, [(title, "<p>no data</p>")])
        return {"n": 0}
    counts, edges = np.histogram(values, bins=bins)
    with open(f"{p}.tsv", "w") as fh:
        fh.write(f"{xlabel}\tcount\n")
        for c, e in zip(counts, edges):
            fh.write(f"{e:g}\t{c}\n")
    labels = [f"{e:.0f}" for e in edges[:-1]]
    html.write_html(
        f"{p}.html", title,
        [(title, html.svg_bars(labels, counts.tolist(), title=title,
                               ylabel="count")),
         ("Summary", html.stats_table({
             "n": len(values), "mean": f"{values.mean():.2f}",
             "median": f"{np.median(values):.2f}",
             "min": f"{values.min():g}", "max": f"{values.max():g}"}))])
    return {"n": int(len(values)), "mean": float(values.mean()),
            "median": float(np.median(values))}


def histo(kind: str, in_path, out_prefix, tag_defaults=None):
    """kind: readlength | fastqmeanqv | clipping | moleculelength |
    percentidentity | umidepth."""
    vals = []
    if kind in ("readlength", "fastqmeanqv") and not str(in_path).endswith(
            (".bam",)):
        for chunk in fastq.read_fastq(in_path):
            for s, q in zip(chunk.seqs, chunk.quals):
                if kind == "readlength":
                    vals.append(len(s))
                else:
                    qv = np.frombuffer(q, np.uint8)
                    vals.append(float(qv.mean()) - 33 if len(qv) else 0)
    else:
        with BamReader(in_path) as rd:
            for r in rd:
                if kind == "readlength":
                    vals.append(len(r.seq))
                elif kind == "clipping":
                    vals.append(max(r.clip_left(), r.clip_right()))
                elif kind == "moleculelength":
                    vals.append(len(r.seq))
                elif kind == "percentidentity":
                    de = r.get_tag("de")
                    if de is not None:
                        vals.append(100.0 * (1.0 - float(de)))
                elif kind == "umidepth":
                    rn = r.get_tag("RN")
                    if rn is not None:
                        vals.append(int(rn))
                elif kind == "fastqmeanqv":
                    if r.qual:
                        vals.append(float(np.frombuffer(r.qual, np.uint8)
                                          .mean()))
    titles = {"readlength": ("Read length", "length"),
              "fastqmeanqv": ("Mean read QV", "QV"),
              "clipping": ("Max clipping", "clipped bases"),
              "moleculelength": ("Molecule length", "length"),
              "percentidentity": ("Percent identity", "% identity"),
              "umidepth": ("UMI depth (RN)", "reads per UMI")}
    t, x = titles[kind]
    return _write_histo(vals, out_prefix, t, x)


def saturation_curve(in_bam, out_prefix, points: int = 20, seed: int = 0,
                     cell_tag="BC", umi_tag="U8", rn_tag="RN"):
    """Monte-Carlo read-subsampling saturation (SaturationCurve.java:38-118):
    at each sampled fraction of total reads, the expected number of distinct
    molecules observed; saturation % = 1 - unique/total at full depth."""
    rng = np.random.default_rng(seed)
    rn = []
    with BamReader(in_bam) as rd:
        seen = set()
        for r in rd:
            bc, u8 = r.get_tag(cell_tag), r.get_tag(umi_tag)
            if bc is None or u8 is None:
                continue
            key = (bc, u8)
            if key in seen:
                continue
            seen.add(key)
            rn.append(int(r.get_tag(rn_tag) or 1))
    rn = np.asarray(rn, dtype=np.int64)
    total_reads = int(rn.sum())
    fractions = np.linspace(0, 1, points + 1)[1:]
    umis = []
    for f in fractions:
        # P(molecule observed) = 1 - (1-f)^rn
        p = 1.0 - np.power(1.0 - f, rn)
        umis.append(float(p.sum()))
    p = Path(str(out_prefix))
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(f"{p}.tsv", "w") as fh:
        fh.write("fraction_reads\treads\tumis\n")
        for f, u in zip(fractions, umis):
            fh.write(f"{f:.3f}\t{int(f * total_reads)}\t{u:.1f}\n")
    sat = 1.0 - (len(rn) / max(total_reads, 1))
    html.write_html(
        f"{p}.html", "Saturation curve",
        [("Saturation", html.svg_xy(
            [("UMIs", (fractions * total_reads).tolist(), umis, "#4878a8")],
            title=f"saturation = {100*sat:.1f}%", xlabel="reads",
            ylabel="distinct UMIs"))])
    return {"molecules": int(len(rn)), "reads": total_reads,
            "saturation": sat}


def read_bam_stats(in_bam, out_json=None):
    """ReadBamStats: counter dump over records/tags."""
    c = Counter()
    lens = []
    with BamReader(in_bam) as rd:
        for r in rd:
            c["records"] += 1
            if r.is_unmapped:
                c["unmapped"] += 1
            if r.is_secondary:
                c["secondary"] += 1
            if r.is_supplementary:
                c["supplementary"] += 1
            if r.mapq == 0:
                c["mapqv0"] += 1
            for tag in ("BC", "U8", "GE", "IG", "IT"):
                if r.get_tag(tag) is not None:
                    c[f"with_{tag}"] += 1
            lens.append(len(r.seq))
    out = dict(c)
    if lens:
        out["mean_length"] = float(np.mean(lens))
        out["median_length"] = float(np.median(lens))
    if out_json:
        Path(out_json).write_text(json.dumps(out, indent=1))
    return out


def export_edit_distances(in_bam, out_tsv, tags=("B1", "B2", "U1", "U2")):
    """EditDistance program: per-record barcode/UMI ED export."""
    n = 0
    with BamReader(in_bam) as rd, open(out_tsv, "w") as fh:
        fh.write("read\t" + "\t".join(tags) + "\n")
        for r in rd:
            vals = [r.get_tag(t) for t in tags]
            if all(v is None for v in vals):
                continue
            fh.write(r.qname + "\t"
                     + "\t".join("" if v is None else str(v)
                                 for v in vals) + "\n")
            n += 1
    return {"exported": n}


def bulk2fake_single_cell(in_fastq, out_fastq, barcode="AAAACCCCGGGGTTTT",
                          umi_len: int = 12, seed: int = 0):
    """Bulk2FakeSingleCell: constant BC + random UMI appended as scanfastq-
    style metadata — synthetic-data generator (Bulk2FakeSingleCell.java)."""
    from sicelore_tpu_torch.pipeline import readname
    rng = np.random.default_rng(seed)
    n = 0
    with fastq.FastqWriter(out_fastq) as w:
        for chunk in fastq.read_fastq(in_fastq):
            for name, s, q in zip(chunk.names, chunk.seqs, chunk.quals):
                umi = "".join("ACGT"[i]
                              for i in rng.integers(0, umi_len * 0 + 4,
                                                    umi_len))
                ae = len(s)
                nm = readname.encode_name(
                    name, is_fwd=True, ps=max(len(s) - umi_len - 20, 0),
                    pe=max(len(s) - umi_len - 1, 0), ae=ae, bc=barcode,
                    ed=0, ed_sec=readname.INT_MAX, bc_start=ae - 1,
                    bc_end=ae - 16, rank=1, x_seq=s[-43:], x_qv=30.0)
                w.write(nm, s, q)
                n += 1
    return {"reads": n}
