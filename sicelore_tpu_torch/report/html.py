"""Self-contained HTML/SVG reports (JFreeChart/knee-plot replacement).

The reference emits HTML reports with JFreeChart plots (readscan knee plot,
README.md:384; per-program charts, programs/IsoformMatrix.java:236-289,
Histo*). Here: dependency-free inline-SVG charts in a single HTML file.
"""
from __future__ import annotations

import math
from pathlib import Path

W, H, PAD = 640, 420, 54


def _axis_ticks(lo: float, hi: float, log: bool):
    if log:
        lo = max(lo, 1e-12)
        a, b = math.floor(math.log10(lo)), math.ceil(math.log10(max(hi, lo * 10)))
        return [10 ** e for e in range(int(a), int(b) + 1)]
    span = max(hi - lo, 1e-12)
    step = 10 ** math.floor(math.log10(span / 4))
    for m in (1, 2, 5, 10):
        if span / (step * m) <= 6:
            step *= m
            break
    t0 = math.ceil(lo / step) * step
    out = []
    while t0 <= hi + 1e-9:
        out.append(t0)
        t0 += step
    return out


def svg_xy(series: list[tuple[str, list[float], list[float], str]],
           title="", xlabel="", ylabel="", xlog=False, ylog=False) -> str:
    """Line chart. series: (name, xs, ys, css color)."""
    allx = [x for _, xs, _, _ in series for x in xs if not xlog or x > 0]
    ally = [y for _, _, ys, _ in series for y in ys if not ylog or y > 0]
    if not allx or not ally:
        return f"<p>{title}: no data</p>"
    x0, x1 = min(allx), max(allx)
    y0, y1 = min(ally), max(ally)
    if xlog:
        x0, x1 = max(x0, 1e-12), max(x1, x0 * 10)
    if ylog:
        y0, y1 = max(y0, 1e-12), max(y1, y0 * 10)

    def sx(x):
        if xlog:
            return PAD + (math.log10(max(x, x0)) - math.log10(x0)) / (
                math.log10(x1) - math.log10(x0) + 1e-12) * (W - 2 * PAD)
        return PAD + (x - x0) / (x1 - x0 + 1e-12) * (W - 2 * PAD)

    def sy(y):
        if ylog:
            f = (math.log10(max(y, y0)) - math.log10(y0)) / (
                math.log10(y1) - math.log10(y0) + 1e-12)
        else:
            f = (y - y0) / (y1 - y0 + 1e-12)
        return H - PAD - f * (H - 2 * PAD)

    parts = [f'<svg width="{W}" height="{H}" '
             f'xmlns="http://www.w3.org/2000/svg" '
             f'style="font-family:sans-serif;font-size:11px">']
    parts.append(f'<text x="{W/2}" y="18" text-anchor="middle" '
                 f'font-size="14">{title}</text>')
    parts.append(f'<rect x="{PAD}" y="{PAD}" width="{W-2*PAD}" '
                 f'height="{H-2*PAD}" fill="none" stroke="#999"/>')
    for t in _axis_ticks(x0, x1, xlog):
        if x0 <= t <= x1:
            parts.append(f'<line x1="{sx(t):.1f}" y1="{H-PAD}" '
                         f'x2="{sx(t):.1f}" y2="{H-PAD+4}" stroke="#555"/>'
                         f'<text x="{sx(t):.1f}" y="{H-PAD+16}" '
                         f'text-anchor="middle">{t:g}</text>')
    for t in _axis_ticks(y0, y1, ylog):
        if y0 <= t <= y1:
            parts.append(f'<line x1="{PAD-4}" y1="{sy(t):.1f}" x2="{PAD}" '
                         f'y2="{sy(t):.1f}" stroke="#555"/>'
                         f'<text x="{PAD-7}" y="{sy(t):.1f}" '
                         f'text-anchor="end" dy="4">{t:g}</text>')
    for name, xs, ys, color in series:
        pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys)
                       if (not xlog or x > 0) and (not ylog or y > 0))
        parts.append(f'<polyline points="{pts}" fill="none" '
                     f'stroke="{color}" stroke-width="1.6"/>')
    y_leg = PAD + 6
    for name, _, _, color in series:
        parts.append(f'<rect x="{W-PAD-120}" y="{y_leg}" width="12" '
                     f'height="4" fill="{color}"/>'
                     f'<text x="{W-PAD-102}" y="{y_leg+6}">{name}</text>')
        y_leg += 16
    parts.append(f'<text x="{W/2}" y="{H-8}" text-anchor="middle">'
                 f'{xlabel}</text>')
    parts.append(f'<text x="14" y="{H/2}" text-anchor="middle" '
                 f'transform="rotate(-90 14 {H/2})">{ylabel}</text>')
    parts.append("</svg>")
    return "".join(parts)


def svg_bars(labels: list[str], values: list[float], title="", ylabel="",
             color="#4878a8") -> str:
    if not values:
        return f"<p>{title}: no data</p>"
    y1 = max(values) or 1
    n = len(values)
    bw = (W - 2 * PAD) / max(n, 1)
    parts = [f'<svg width="{W}" height="{H}" '
             f'xmlns="http://www.w3.org/2000/svg" '
             f'style="font-family:sans-serif;font-size:11px">',
             f'<text x="{W/2}" y="18" text-anchor="middle" '
             f'font-size="14">{title}</text>',
             f'<rect x="{PAD}" y="{PAD}" width="{W-2*PAD}" '
             f'height="{H-2*PAD}" fill="none" stroke="#999"/>']
    for t in _axis_ticks(0, y1, False):
        fy = H - PAD - t / y1 * (H - 2 * PAD)
        parts.append(f'<text x="{PAD-7}" y="{fy:.1f}" text-anchor="end" '
                     f'dy="4">{t:g}</text>')
    step = max(1, n // 20)
    for i, (lab, v) in enumerate(zip(labels, values)):
        bh = v / y1 * (H - 2 * PAD)
        parts.append(f'<rect x="{PAD+i*bw:.1f}" y="{H-PAD-bh:.1f}" '
                     f'width="{max(bw-1,1):.1f}" height="{bh:.1f}" '
                     f'fill="{color}"/>')
        if i % step == 0:
            parts.append(f'<text x="{PAD+(i+.5)*bw:.1f}" y="{H-PAD+14}" '
                         f'text-anchor="middle">{lab}</text>')
    parts.append(f'<text x="14" y="{H/2}" text-anchor="middle" '
                 f'transform="rotate(-90 14 {H/2})">{ylabel}</text></svg>')
    return "".join(parts)


def write_html(path, title: str, sections: list[tuple[str, str]]):
    """sections: (heading, html body — svg or table markup)."""
    body = "".join(f"<h2>{h}</h2>\n{c}\n" for h, c in sections)
    Path(path).write_text(
        f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{title}</title></head>"
        f"<body style='font-family:sans-serif'><h1>{title}</h1>\n"
        f"{body}</body></html>")


def stats_table(d: dict) -> str:
    rows = "".join(f"<tr><td>{k}</td><td style='text-align:right'>{v}</td>"
                   f"</tr>" for k, v in d.items())
    return (f"<table border='1' cellspacing='0' cellpadding='4'>"
            f"{rows}</table>")


def knee_plot(counts_desc: list[int], title="Reads per cell barcode") -> str:
    """log-log knee plot (reference readscan HTML, README.md:384)."""
    xs = list(range(1, len(counts_desc) + 1))
    return svg_xy([("cells", xs, [max(c, 1) for c in counts_desc],
                    "#4878a8")],
                  title=title, xlabel="barcode rank", ylabel="reads",
                  xlog=True, ylog=True)
