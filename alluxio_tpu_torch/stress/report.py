"""Single-file HTML report for stress-suite results (a copy of
``alluxio_tpu/stress/report.py``).

Re-design of the reference's stress graph generation
(``stress/common/.../graph/*`` — it renders JSON summaries to HTML
graphs): ``render_report`` turns the ``BENCH_SUITE.json`` records into
one self-contained page — a KPI row of headline numbers, one
horizontal bar chart per unit group (one axis per chart; magnitudes in
a single hue with direct end labels), and the full metric table.
No external assets; light/dark via CSS custom properties.
"""

from __future__ import annotations

import html
from typing import Dict, List, Sequence, Tuple

#: headline metric per bench family: (metrics key, unit label)
_HEADLINE = (
    ("gb_per_s", "GB/s"),
    ("mb_per_s", "MB/s"),
    ("ingest_mb_per_s", "MB/s"),
    ("projection_mb_per_s", "MB/s"),
    ("ops_per_s", "ops/s"),
)

_CSS = """
.viz-root {
  color-scheme: light;
  --surface-1: #fcfcfb; --text-primary: #0b0b0b;
  --text-secondary: #52514e; --series-1: #2a78d6;
  --grid: #e4e3df;
  background: var(--surface-1); color: var(--text-primary);
  font-family: system-ui, sans-serif; margin: 0; padding: 2rem;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --text-primary: #ffffff;
    --text-secondary: #c3c2b7; --series-1: #3987e5;
    --grid: #3a3936;
  }
}
h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 1.6rem; }
.kpis { display: flex; flex-wrap: wrap; gap: 1rem; margin: 1rem 0; }
.tile { border: 1px solid var(--grid); border-radius: 6px;
        padding: .7rem 1rem; min-width: 10rem; }
.tile .v { font-size: 1.5rem; font-weight: 600; }
.tile .u { color: var(--text-secondary); font-size: .8rem; }
.tile .n { color: var(--text-secondary); font-size: .8rem;
           margin-bottom: .2rem; }
table { border-collapse: collapse; margin: .6rem 0; }
td, th { border: 1px solid var(--grid); padding: .25rem .6rem;
         font-size: .85rem; text-align: left; }
svg text { font-family: system-ui, sans-serif; }
"""


def _headline_of(rec: dict) -> "Tuple[str, float] | None":
    m = rec.get("metrics", {})
    for key, unit in _HEADLINE:
        if key in m:
            return unit, float(m[key])
    return None


def _bar_chart(unit: str, rows: Sequence[Tuple[str, float]]) -> str:
    """Horizontal bars, one hue, 4px rounded data ends, direct labels."""
    bar_h, gap, left, width = 22, 8, 230, 620
    h = len(rows) * (bar_h + gap) + gap
    vmax = max(v for _, v in rows) or 1.0
    parts = [f'<svg role="img" width="{width + 130}" height="{h}" '
             f'aria-label="{html.escape(unit)} by bench">']
    for i, (name, v) in enumerate(rows):
        y = gap + i * (bar_h + gap)
        w = max(2, int((width - left) * v / vmax))
        label = html.escape(name)
        parts.append(
            f'<text x="{left - 8}" y="{y + bar_h * 0.72}" '
            f'text-anchor="end" font-size="12" '
            f'fill="var(--text-secondary)">{label}</text>')
        parts.append(
            f'<rect x="{left}" y="{y}" width="{w}" height="{bar_h}" '
            f'rx="4" fill="var(--series-1)">'
            f'<title>{label}: {v:,.2f} {html.escape(unit)}</title>'
            f'</rect>')
        parts.append(
            f'<text x="{left + w + 6}" y="{y + bar_h * 0.72}" '
            f'font-size="12" fill="var(--text-primary)">'
            f'{v:,.2f}</text>')
    parts.append("</svg>")
    return "".join(parts)


def render_report(results: List[dict], *, title: str = "alluxio-tpu "
                  "stress suite") -> str:
    by_unit: Dict[str, List[Tuple[str, float]]] = {}
    tiles, tables = [], []
    for rec in results:
        name = rec.get("bench", "?")
        head = _headline_of(rec)
        if head is not None:
            unit, value = head
            by_unit.setdefault(unit, []).append((name, value))
            tiles.append(
                f'<div class="tile"><div class="n">{html.escape(name)}'
                f'</div><div class="v">{value:,.1f}</div>'
                f'<div class="u">{html.escape(unit)}</div></div>')
        metrics = rec.get("metrics", {})
        rows = "".join(
            f"<tr><td>{html.escape(str(k))}</td>"
            f"<td>{html.escape(str(v))}</td></tr>"
            for k, v in sorted(metrics.items()))
        tables.append(
            f"<h2>{html.escape(name)}</h2>"
            f"<table><tr><th>metric</th><th>value</th></tr>{rows}"
            f"</table>")
    charts = "".join(
        f"<h2>{html.escape(unit)}</h2>" + _bar_chart(unit, rows)
        for unit, rows in sorted(by_unit.items())
        if rows)
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title>"
            f"<style>{_CSS}</style></head>"
            f"<body class='viz-root'><h1>{html.escape(title)}</h1>"
            f"<div class='kpis'>{''.join(tiles)}</div>"
            f"{charts}"
            f"{''.join(tables)}"
            f"</body></html>")


def _load_results(path: str) -> List[dict]:
    """Accept BOTH result shapes: a JSON array (``bench.py --suite``'s
    BENCH_SUITE.json) and JSONL (``stress suite`` stdout redirected to
    a file — one record per line, possibly interleaved with log
    lines)."""
    import json

    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
        return data if isinstance(data, list) else [data]
    except json.JSONDecodeError:
        out = []
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        if not out:
            raise
        return out


def write_report(input_path: str, out_path: str) -> int:
    """Single entry used by both CLIs (``stress report`` and the
    standalone module)."""
    import json
    import sys

    try:
        results = _load_results(input_path)
    except (OSError, json.JSONDecodeError) as e:
        print(f"cannot read suite results {input_path!r}: {e}",
              file=sys.stderr)
        return 1
    with open(out_path, "w") as f:
        f.write(render_report(results))
    print(f"wrote {out_path} ({len(results)} benches)", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="stress report")
    p.add_argument("--input", default="BENCH_SUITE.json",
                   help="suite results (JSON array or JSONL)")
    p.add_argument("--out", default="BENCH_REPORT.html")
    args = p.parse_args(argv)
    return write_report(args.input, args.out)
