"""Remaining reference utility programs (second batch).

Host-side stream-rewrite programs completing the reference's program
inventory (reference paths cited per function; all are Picard-CLI one-
screeners in the reference's src/main/java/org/ipmc/sicelore/programs/).
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

from sicelore_tpu_torch.io import fastq
from sicelore_tpu_torch.io.bam import BamReader, BamWriter


def select_valid_cell_barcode(input_tsv, output_csv, min_umi: int = 1,
                              ed0ed1_ratio: float = 1.0):
    """SelectValidCellBarcode (programs/SelectValidCellBarcode.java:40-87):
    filter BarcodesAssigned.tsv on nUMI >= MINUMI and ED0/ED1 >= ratio.
    NOTE: the reference computes ED0/ED1 with Java INTEGER division before
    the >= compare — reproduced here deliberately."""
    total = kept = 0
    with open(output_csv, "w") as os_:
        with open(input_tsv) as fh:
            next(fh, None)  # header
            for line in fh:
                line = line.replace(",", "").rstrip("\n")
                if not line:
                    continue
                tab = line.split("\t")
                total += 1
                total_umi = int(tab[1])
                ed0 = int(tab[2]) if len(tab) > 2 and tab[2] else 0
                ed1 = int(tab[3]) if len(tab) > 3 and tab[3] else 0
                if ed1 == 0:
                    ed1 = 1
                if total_umi >= min_umi and (ed0 // ed1) >= ed0ed1_ratio:
                    kept += 1
                    os_.write(tab[0] + "\n")
    return {"total_barcodes": total, "kept_barcodes": kept}


def filter_bam_mf(in_bam, out_bam, cells_csv, cell_tag="BC", umi_tag="U8"):
    """FilterBamMF (programs/FilterBamMF.java:40-66): keep records whose
    cell tag is in the cell list; retag for 10x-tool compatibility —
    CB = BC + "-1", UB = U8 — and truncate the read name at the first "="
    (name.split("=")[0])."""
    from sicelore_tpu_torch.core.matrix import load_cell_list
    cells = set(load_cell_list(cells_csv))
    n = kept = 0
    with BamReader(in_bam) as rd, BamWriter(out_bam, rd.header) as w:
        for r in rd:
            n += 1
            bc = r.get_tag(cell_tag)
            if bc not in cells:
                continue
            kept += 1
            r.set_tag("CB", bc + "-1", "Z")
            r.set_tag("UB", r.get_tag(umi_tag), "Z")
            r.qname = r.qname.split("=")[0]
            w.write(r)
    return {"records": n, "kept": kept}


def filter_molecule_bam(in_bam, out_bam, min_rn: int = 1,
                        require_isoform: bool = False, rn_tag="RN",
                        it_tag="IT"):
    """FilterMoleculeBam: keep molecules by UMI depth (RN >= MINRN) and
    optionally only isoform-defined records (IT != undef)."""
    n = kept = 0
    with BamReader(in_bam) as rd, BamWriter(out_bam, rd.header) as w:
        for r in rd:
            n += 1
            rn = int(r.get_tag(rn_tag) or 1)
            if rn < min_rn:
                continue
            if require_isoform and (r.get_tag(it_tag) in (None, "undef")):
                continue
            kept += 1
            w.write(r)
    return {"records": n, "kept": kept}


def add_label_to_barcode(in_bam, out_bam, label: str, cell_tag="BC"):
    """AddLabel2Barcode (programs/AddLabel2Barcode.java:60-61):
    BC -> "BC-LABEL" (sample multiplexing; label appended after a dash)."""
    n = 0
    with BamReader(in_bam) as rd, BamWriter(out_bam, rd.header) as w:
        for r in rd:
            bc = r.get_tag(cell_tag)
            # Java string concat renders a missing tag as "null"
            r.set_tag(cell_tag, f"{bc if bc is not None else 'null'}-{label}",
                      "Z")
            n += 1
            w.write(r)
    return {"relabeled": n}


def clean_usuq(in_bam, out_bam, us_tag="US", uq_tag="UQ"):
    """CleanUSUQ (programs/CleanUSUQ.java:45-47): blank the bulky read
    sequence/quality tags — set them to the EMPTY STRING (the tags stay
    present in the record, matching the reference bytes out)."""
    n = 0
    with BamReader(in_bam) as rd, BamWriter(out_bam, rd.header) as w:
        for r in rd:
            r.set_tag(us_tag, "", "Z")
            r.set_tag(uq_tag, "", "Z")
            n += 1
            w.write(r)
    return {"records": n}


def split_bam(in_bam, out_dir, read_ids_file):
    """SplitBam (programs/SplitBam.java:49-77): route records to
    OUTPUT/yes.bam or OUTPUT/no.bam by membership of the read-name PREFIX
    (name.split("_")[0]) in the id list ("@" stripped from list lines)."""
    ids = {l.strip().replace("@", "") for l in open(read_ids_file)
           if l.strip()}
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = kept = 0
    with BamReader(in_bam) as rd, \
            BamWriter(out_dir / "yes.bam", rd.header) as yes, \
            BamWriter(out_dir / "no.bam", rd.header) as no:
        for r in rd:
            n += 1
            if r.qname.split("_")[0] in ids:
                kept += 1
                yes.write(r)
            else:
                no.write(r)
    return {"records": n, "yes": kept, "no": n - kept}


def split_bam_per_cluster(in_bam, out_dir, cluster_csv, cell_tag="BC",
                          prefix="cluster"):
    """SplitBamPerCluster: csv `barcode,cluster` -> one BAM per cluster."""
    clusters: dict[str, str] = {}
    for line in open(cluster_csv):
        line = line.strip()
        if not line:
            continue
        parts = line.replace("-1", "").split(",")
        if len(parts) >= 2:
            clusters[parts[0]] = parts[1]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with BamReader(in_bam) as rd:
        writers: dict[str, BamWriter] = {}
        n = 0
        for r in rd:
            bc = (r.get_tag(cell_tag) or "").replace("-1", "")
            cl = clusters.get(bc)
            if cl is None:
                continue
            if cl not in writers:
                writers[cl] = BamWriter(out_dir / f"{prefix}_{cl}.bam",
                                        rd.header)
            writers[cl].write(r)
            n += 1
        for w in writers.values():
            w.close()
    return {"written": n, "clusters": len(writers)}


def molecule_counter(in_bam, cell_tag="BC", umi_tag="U8"):
    """MoleculeCounter: distinct (cellBC, UMI) pairs."""
    seen = set()
    n = 0
    with BamReader(in_bam) as rd:
        for r in rd:
            n += 1
            bc, u8 = r.get_tag(cell_tag), r.get_tag(umi_tag)
            if bc and u8:
                seen.add((bc, u8))
    return {"records": n, "molecules": len(seen)}


def export_umifound_records(in_bam, out_bam, cell_tag="BC", umi_tag="U8"):
    """ExportUMIFoundRecords: keep records with both BC and U8 set."""
    n = kept = 0
    with BamReader(in_bam) as rd, BamWriter(out_bam, rd.header) as w:
        for r in rd:
            n += 1
            if r.get_tag(cell_tag) is not None and \
                    r.get_tag(umi_tag) is not None:
                kept += 1
                w.write(r)
    return {"records": n, "kept": kept}


def export_molecule_reads(in_bam, molecules_csv, out_fastq, cell_tag="BC",
                          umi_tag="U8", seq_tag="US", qual_tag="QS"):
    """ExportMoleculeReads: fastq of the reads of listed (BC,U8) molecules."""
    wanted = set()
    for line in open(molecules_csv):
        parts = line.strip().replace("-1", "").split(",")
        if len(parts) >= 2:
            wanted.add((parts[0], parts[1]))
    n = 0
    with BamReader(in_bam) as rd, fastq.FastqWriter(out_fastq) as w:
        for r in rd:
            key = (r.get_tag(cell_tag), r.get_tag(umi_tag))
            if key in wanted:
                seq = r.get_tag(seq_tag) or r.seq
                qual = r.get_tag(qual_tag)
                qb = (qual.encode() if qual
                      else (bytes(q + 33 for q in r.qual) if r.qual
                            else b"I" * len(seq)))
                w.write(f"{r.qname}_{key[0]}_{key[1]}".encode(),
                        seq.encode() if isinstance(seq, str) else seq, qb)
                n += 1
    return {"exported": n}


def export_metrics(in_bam, cells_csv, out_molecules, out_cells,
                   cell_tag="CB", umi_tag="UB", gene_tag="GN"):
    """ExportMetrics (programs/ExportMetrics.java:53-128): per-molecule and
    per-cell metrics from any tagged BAM (illumina CB/UB/GN or long-read
    BC/U8/IG defaults selectable). Molecule rows `cell\\tumi\\tgene\\t
    nb_read` (gene = last gene tag seen for the molecule, "nogene" when
    missing); cell rows `cell\\tnb_read\\tnb_umi` where nb_read counts
    DISTINCT read names across the cell's molecules (the reference unions
    the per-UMI read-name sets)."""
    from sicelore_tpu_torch.core.matrix import load_cell_list
    cells = set(load_cell_list(cells_csv))
    mamap: dict[str, dict[str, set]] = defaultdict(lambda: defaultdict(set))
    mygene: dict[tuple, str] = {}
    with BamReader(in_bam) as rd:
        for r in rd:
            bc = r.get_tag(cell_tag)
            if bc is not None:
                bc = bc.replace("-1", "")
            u8 = r.get_tag(umi_tag)
            ig = r.get_tag(gene_tag) or "nogene"
            if bc in cells and u8 is not None:
                mamap[bc][u8].add(r.qname)
                mygene[(bc, u8)] = ig
    total_umis = total_reads = 0
    with open(out_molecules, "w") as fh:
        fh.write("cell\tumi\tgene\tnb_read\n")
        for bc, umis in mamap.items():
            for u8, reads in umis.items():
                fh.write(f"{bc}\t{u8}\t{mygene[(bc, u8)]}\t{len(reads)}\n")
    with open(out_cells, "w") as fh:
        fh.write("cell\tnb_read\tnb_umi\n")
        for bc, umis in mamap.items():
            all_reads = set()
            for reads in umis.values():
                all_reads |= reads
            fh.write(f"{bc}\t{len(all_reads)}\t{len(umis)}\n")
            total_umis += len(umis)
            total_reads += len(all_reads)
    return {"cells": len(mamap), "umis": total_umis, "reads": total_reads}


def add_reads_to_molecules(std_bam, targeted_bam, out_bam, cell_tag="BC",
                           umi_tag="U8"):
    """AddReadsToMolecules: merge targeted-experiment records into the
    molecules present in the standard-experiment BAM."""
    molecules = set()
    with BamReader(std_bam) as rd:
        header = rd.header
        for r in rd:
            bc, u8 = r.get_tag(cell_tag), r.get_tag(umi_tag)
            if bc and u8:
                molecules.add((bc, u8))
    n = added = 0
    with BamWriter(out_bam, header) as w:
        with BamReader(std_bam) as rd:
            for r in rd:
                w.write(r)
                n += 1
        with BamReader(targeted_bam) as rd:
            for r in rd:
                key = (r.get_tag(cell_tag), r.get_tag(umi_tag))
                if key in molecules:
                    w.write(r)
                    added += 1
    return {"standard": n, "added_targeted": added}


def haplotype_caller(in_bam, outdir, cell_tag="BC", umi_tag="U8",
                     ig_tag="IG", it_tag="IT", seq_tag="CS", min_rn=1):
    """HaplotypeCaller (programs/HaplotypeCaller.java:95-136): export per-
    isoform molecule-evidence fasta for downstream phasing (no calling in
    the reference either)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    by_iso: dict[str, list] = defaultdict(list)
    with BamReader(in_bam) as rd:
        for r in rd:
            ig, it = r.get_tag(ig_tag), r.get_tag(it_tag)
            if not ig or not it or it == "undef":
                continue
            seq = r.get_tag(seq_tag) or r.seq
            if not seq:
                continue
            name = f"{r.get_tag(cell_tag)}-{r.get_tag(umi_tag)}"
            by_iso[f"{ig}_{it}"].append((name, seq))
    n = 0
    for iso, entries in by_iso.items():
        safe = iso.replace("/", "_")
        with open(outdir / f"{safe}.fa", "w") as fh:
            for name, seq in entries:
                fh.write(f">{name}\n{seq}\n")
                n += 1
    return {"isoforms": len(by_iso), "sequences": n}


def junction_annotate(refflat_or_junctions, genome_fa, out_tsv, delta=0):
    """JunctionAnnotate (programs/JunctionAnnotate.java): donor/acceptor
    dinucleotides (GT..AG canonical) from the genome fasta for every
    junction of a refFlat model."""
    from sicelore_tpu_torch.core.refflat import RefFlatModel
    genome = _load_fasta(genome_fa)
    model = RefFlatModel.load(refflat_or_junctions)
    n = canonical = 0
    with open(out_tsv, "w") as fh:
        fh.write("geneId\ttranscriptId\tchrom\tjunction\tdonor\tacceptor"
                 "\tcanonical\n")
        for gene, trs in model.by_gene.items():
            for t in trs:
                seq = genome.get(t.chrom)
                if seq is None:
                    continue
                for (d, a) in t.junctions.tolist():
                    # intron = [d+1 .. a-1] 1-based; donor = first 2 intron
                    # bases, acceptor = last 2
                    donor = seq[d:d + 2].upper()
                    acceptor = seq[a - 3:a - 1].upper()
                    if t.strand == "-":
                        donor, acceptor = (_rc(acceptor), _rc(donor))
                    is_can = donor == "GT" and acceptor == "AG"
                    canonical += is_can
                    n += 1
                    fh.write(f"{gene}\t{t.transcript_id}\t{t.chrom}\t"
                             f"{d}-{a}\t{donor}\t{acceptor}\t"
                             f"{str(bool(is_can)).lower()}\n")
    return {"junctions": n, "canonical": canonical}


def _rc(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _load_fasta(path) -> dict[str, str]:
    import gzip
    opener = gzip.open if str(path).endswith(".gz") else open
    out: dict[str, str] = {}
    name, chunks = None, []
    with opener(str(path), "rt") as fh:
        for line in fh:
            if line.startswith(">"):
                if name is not None:
                    out[name] = "".join(chunks)
                name = line[1:].split()[0].strip()
                chunks = []
            else:
                chunks.append(line.strip())
    if name is not None:
        out[name] = "".join(chunks)
    return out


def split_bam_per_stage(in_bam, out_dir, stage_csv, cell_tag="BC"):
    """SplitBamPerStage (programs/SplitBamPerStage.java:38-98): csv lines
    `sample,stage` (quotes stripped, spaces -> underscores); each record is
    routed by the *sample* suffix of its cell tag (`BARCODE-SAMPLE`) to
    `{input_stem}-{stage}.bam`. One writer per stage is opened up front
    (so every stage named in the csv yields a file, even if empty)."""
    name = Path(in_bam).name.replace(".bam", "")
    sample2stage: dict[str, str] = {}
    stages: list[str] = []
    for line in open(stage_csv):
        line = line.strip()
        if not line:
            continue
        line = line.replace('"', "").replace(" ", "_")
        parts = line.split(",")
        if len(parts) < 2:
            continue
        sample2stage[parts[0]] = parts[1]
        if parts[1] not in stages:
            stages.append(parts[1])
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    with BamReader(in_bam) as rd:
        writers = {st: BamWriter(out_dir / f"{name}-{st}.bam", rd.header)
                   for st in stages}
        for r in rd:
            bc = r.get_tag(cell_tag)
            if not bc or "-" not in bc:
                continue
            stage = sample2stage.get(bc.split("-")[1])
            if stage is not None:
                writers[stage].write(r)
                n += 1
        for w in writers.values():
            w.close()
    return {"written": n, "stages": len(writers)}


def crispr_stats(in_bam, histo_out, detail_out, min_size: int = 10,
                 coord: str = "21:17608000-17610000"):
    """CrispRstats (programs/CrispRstats.java:54-156): for reads
    overlapping COORD, find the largest CIGAR deletion; DETAIL gets
    `read_name  start_of_deletion  size`, HISTO gets a `length\\tnumber`
    table of deletion sizes 0..max. Deviation from the reference
    (documented policy): the reference gates the detail/histo rows on the
    running *global* maximum (`MAX >= MINSIZE`, CrispRstats.java:125), so
    after the first large deletion every read is recorded regardless of
    its own deletion size; we gate on the per-read maximum instead."""
    chrom, rng = coord.split(":")
    start, end = (int(x) for x in rng.split("-"))
    histo: dict[int, int] = {}
    max_seen = 0
    n = 0
    with BamReader(in_bam) as rd, open(detail_out, "w") as det:
        ref_names = [nm for nm, _ in rd.header.refs]
        for r in rd:
            if r.is_unmapped or r.ref_id < 0 or ref_names[r.ref_id] != chrom:
                continue
            pos1 = r.pos + 1                      # 1-based leftmost
            if pos1 > end or r.reference_end() < start:
                continue
            n += 1
            maxdel = 0
            del_start = 0
            ref = pos1
            for op, ln in r.cigar:
                if op == "D" and ln > maxdel:
                    maxdel = ln
                    del_start = ref               # first deleted base
                if op in "MDN=X":
                    ref += ln
            max_seen = max(max_seen, maxdel)
            if maxdel >= min_size:
                det.write(f"{r.qname}\t{del_start}\t{maxdel}\n")
                histo[maxdel] = histo.get(maxdel, 0) + 1
    with open(histo_out, "w") as fh:
        fh.write("length\tnumber\n")
        for i in range(max_seen + 1):
            fh.write(f"{i}\t{histo.get(i, 0)}\n")
    return {"records": n, "max_deletion": max_seen}


def parse_fastq_cdna(fastq_dir, out_dir, offset: int = 28,
                     min_cdna: int = 20):
    """ParseFastq (programs/ParseFastq.java:33-98): for every fastq in
    FASTQDIR, slice the cDNA out of each read using the read-name metadata
    (polyA start / adapter end): cDNA = seq[AEnd+offset : PAst-1] when both
    are > 0 and the slice exceeds min_cdna, else the whole read. Output
    records reproduce the reference byte format `@name\\ncDNA\\n+\\n\\n`
    (empty quality line — ParseFastq.java:83). Accepts both the v1 keys
    (PAst/AEnd) the reference parses and this framework's scanfastq keys
    (PS/AE, pipeline/readname.py)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = reads = sliced = 0
    for f in sorted(Path(fastq_dir).iterdir()):
        if not f.is_file():
            continue
        files += 1
        with open(out_dir / f.name, "w") as os_:
            for chunk in fastq.read_fastq(f):
                for name, seq in zip(chunk.names, chunk.seqs):
                    reads += 1
                    token = name.decode()
                    pa_st = a_end = 0
                    for part in token.split("_"):
                        kv = part.split("=")
                        if len(kv) > 1:
                            if kv[0] in ("PAst", "PS"):
                                pa_st = int(kv[1])
                            elif kv[0] in ("AEnd", "AE"):
                                a_end = int(kv[1])
                    if pa_st > 0 and a_end > 0 and \
                            pa_st - 1 - (a_end + offset) > min_cdna:
                        cdna = seq[a_end + offset:pa_st - 1].decode()
                        sliced += 1
                    else:
                        cdna = seq.decode()
                    os_.write(f"@{token}\n{cdna}\n+\n\n")
    return {"files": files, "reads": reads, "sliced": sliced}


def parse_tr_stats(in_bam, csv_path, out_dir, celltag_bc="CR",
                   cell_tag="CB", umi_tag="pN", gene_tag="GN",
                   xf_tag="XF", sample_tag="pS"):
    """ParseTR (programs/ParseTR.java:62-197): Parse Biosciences
    polyA-vs-random-hexamer priming stats. CSV rows
    `bci,sequence,uid,well,type` map the BC1 barcode sequence to priming
    type T (polyT) / R (random hexamer); per gene and per cell, count
    distinct UMIs per `{XF}_{type}` key over the 8 fixed columns; write
    gene_stats.txt and cell_stats.txt. Records missing any required tag
    are skipped (the reference NPEs on them)."""
    keys = ["CODING_T", "CODING_R", "UTR_T", "UTR_R",
            "INTRONIC_T", "INTRONIC_R", "INTERGENIC_T", "INTERGENIC_R"]
    bc2type: dict[str, str] = {}
    for line in open(csv_path):
        parts = line.strip().split(",")
        if len(parts) >= 5:
            bc2type[parts[1]] = parts[4]
    gene_matrix: dict[str, dict[str, set]] = defaultdict(
        lambda: defaultdict(set))
    cell_matrix: dict[str, dict[str, set]] = defaultdict(
        lambda: defaultdict(set))
    bc2cond: dict[str, str] = {}
    n = used = 0
    with BamReader(in_bam) as rd:
        for r in rd:
            n += 1
            bc123 = r.get_tag(celltag_bc)
            cell = r.get_tag(cell_tag)
            umi = r.get_tag(umi_tag)
            gene = r.get_tag(gene_tag)
            sample = r.get_tag(sample_tag)
            where = r.get_tag(xf_tag)
            if not (bc123 and cell and umi and gene and where):
                continue
            priming = bc2type.get(bc123.split("_")[0])
            if priming is None:
                continue
            used += 1
            bc2cond[cell] = sample or ""
            key = f"{where}_{priming}"
            gene_matrix[gene][key].add(umi)
            cell_matrix[cell][key].add(umi)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "gene_stats.txt", "w") as fh:
        fh.write("gene" + "".join("\t" + k for k in keys) + "\n")
        for gene, m in gene_matrix.items():
            fh.write(gene + "".join(f"\t{len(m.get(k, ()))}" for k in keys)
                     + "\n")
    with open(out_dir / "cell_stats.txt", "w") as fh:
        fh.write("cell\tcondition" + "".join("\t" + k for k in keys) + "\n")
        for cell, m in cell_matrix.items():
            fh.write(f"{cell}\t{bc2cond.get(cell, '')}"
                     + "".join(f"\t{len(m.get(k, ()))}" for k in keys)
                     + "\n")
    return {"records": n, "used": used, "genes": len(gene_matrix),
            "cells": len(cell_matrix)}
