"""Journal inspection tool (a copy of ``alluxio_tpu/journal/tool.py``).

Re-design of ``core/server/master/.../master/journal/tool/JournalTool.java:77``
(+ ``UfsJournalDumper``): human-readable dump of a journal directory —
latest checkpoint summary and every entry of every segment, without
needing a running master.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, TextIO

import msgpack

from alluxio_tpu_torch.journal.format import JournalEntry
from alluxio_tpu_torch.journal.system import (
    CKPT_DIR, LOG_DIR, latest_checkpoint_name, sorted_segments,
)


def _fmt_payload(payload: dict, max_len: int = 160) -> str:
    s = repr(payload)
    return s if len(s) <= max_len else s[:max_len] + "...}"


def dump_journal(folder: str, out: Optional[TextIO] = None, *,
                 start_seq: int = 0,
                 end_seq: Optional[int] = None) -> int:
    """Print checkpoint + entries in [start_seq, end_seq]; returns the
    number of entries printed."""
    out = out if out is not None else sys.stdout  # late-bind: honor redirects
    ckpt_dir = os.path.join(folder, CKPT_DIR)
    log_dir = os.path.join(folder, LOG_DIR)
    printed = 0
    if os.path.isdir(ckpt_dir):
        cks = sorted(f for f in os.listdir(ckpt_dir)
                     if f.endswith(".ckpt"))
        for ck in cks:
            with open(os.path.join(ckpt_dir, ck), "rb") as f:
                snap = msgpack.unpackb(f.read(), raw=False,
                                       strict_map_key=False)
            comps = ", ".join(sorted(snap.get("components", {})))
            print(f"checkpoint {ck}: sequence={snap.get('sequence')} "
                  f"components=[{comps}]", file=out)
    if not os.path.isdir(log_dir):
        return printed
    segs = sorted(
        (f for f in os.listdir(log_dir) if f.endswith(".log")),
        key=lambda f: (1 << 62) if f.startswith("current")
        else int(f.split("-")[0], 16))
    for seg in segs:
        print(f"segment {seg}:", file=out)
        with open(os.path.join(log_dir, seg), "rb") as f:
            for entry in JournalEntry.decode_stream(f):
                if entry.sequence < start_seq:
                    continue
                if end_seq is not None and entry.sequence > end_seq:
                    continue
                print(f"  #{entry.sequence} {entry.type} "
                      f"{_fmt_payload(entry.payload)}", file=out)
                printed += 1
    return printed
