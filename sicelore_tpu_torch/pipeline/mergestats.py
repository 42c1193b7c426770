"""Scan-stats merging across runs (reference statmerger role).

The reference serializes scan statistics (`stats.pojo`, config.xml:32-33)
and merges them across demon-mode runs (jar stats/statmerger/
MergeReadScannerStats, MergeBarcodeFinderStats). Here stats are json and
BarcodesAssigned tables are tsv; this module merges any number of them.
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path


def merge_scanner_stats(stat_files: list, out_json):
    """Sum counter fields + ed histograms of several scanner_stats.json."""
    total: dict = {}
    hist: dict = defaultdict(int)
    for f in stat_files:
        d = json.loads(Path(f).read_text())
        for k, v in d.items():
            if k == "ed_hist":
                for e, c in v.items():
                    hist[e] += c
            elif isinstance(v, (int, float)):
                total[k] = total.get(k, 0) + v
    total["ed_hist"] = dict(hist)
    Path(out_json).write_text(json.dumps(total, indent=1))
    return total


def merge_barcodes_assigned(tsv_files: list, out_tsv):
    """Sum per-barcode read counts + per-ED columns across tables."""
    agg: dict[str, list[int]] = {}
    width = 0
    for f in tsv_files:
        lines = Path(f).read_text().strip().split("\n")
        for line in lines[1:]:
            parts = line.split("\t")
            bc = parts[0]
            vals = [int(x) if x else 0 for x in parts[1:]]
            width = max(width, len(vals))
            cur = agg.setdefault(bc, [0] * len(vals))
            if len(cur) < len(vals):
                cur.extend([0] * (len(vals) - len(cur)))
            for i, v in enumerate(vals):
                cur[i] += v
    with open(out_tsv, "w") as fh:
        fh.write("barcode\tnReads\t"
                 + "\t".join(f"ED{e}" for e in range(max(width - 1, 0)))
                 + "\n")
        for bc, vals in sorted(agg.items(), key=lambda kv: -kv[1][0]):
            fh.write(bc + "\t" + "\t".join(str(v) for v in vals) + "\n")
    return {"barcodes": len(agg)}
