"""Shared single-file HTML status-page renderer for the master/worker
web endpoints (a copy of ``alluxio_tpu/utils/statuspage.py``; stand-in
for the reference's webui-* SPAs, with no build step): common CSS + JS
helpers, per-process sections and render code.
"""

from __future__ import annotations

from typing import Sequence, Tuple

_CSS = """
 body{font-family:system-ui,sans-serif;margin:2rem;color:#222}
 h1{font-size:1.3rem} h2{font-size:1.05rem;margin-top:1.5rem}
 table{border-collapse:collapse;margin:.5rem 0}
 td,th{border:1px solid #ccc;padding:.25rem .6rem;font-size:.9rem;
       text-align:left}
 code{background:#f4f4f4;padding:0 .3rem}
 #err{color:#b00}
"""

_HELPERS = """
const gb = n => (n/2**30).toFixed(2)+' GiB';
const row = (t, cells, th) => {
  const tr = document.createElement('tr');
  for (const c of cells) {
    const el = document.createElement(th ? 'th' : 'td');
    el.textContent = c; tr.appendChild(el);
  }
  t.appendChild(tr);
  return tr;
};
async function j(p){ const r = await fetch(API + p);
                     if(!r.ok) throw new Error(p+': '+r.status);
                     return r.json(); }
"""


def render(title: str, api_prefix: str,
           sections: Sequence[Tuple[str, str]],
           raw_routes: Sequence[str], js_body: str) -> bytes:
    """Build the page: ``sections`` are (heading, table-element-id);
    ``js_body`` is an async function body using the shared helpers
    (``j``/``row``/``gb``) and ``API``."""
    section_html = "".join(
        f"<h2>{heading}</h2><table id=\"{tid}\"></table>"
        for heading, tid in sections)
    routes = " ".join(f"<code>{r}</code>" for r in raw_routes)
    return (f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>{_CSS}</style></head><body>
<h1>{title}</h1>
<div id="err"></div>
{section_html}
<p>Raw: {routes} <code>/metrics</code> (Prometheus)</p>
<script>
const API = '{api_prefix}';
{_HELPERS}
(async () => {{
  try {{
{js_body}
  }} catch (e) {{
    document.getElementById('err').textContent = e;
  }}
}})();
</script></body></html>
""").encode()
