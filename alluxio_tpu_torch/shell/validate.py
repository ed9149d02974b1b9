"""validateConf: sanity-check configuration before a process boots.

A copy of ``alluxio_tpu/shell/validate.py``.

Re-design of ``shell/src/main/java/alluxio/cli/ValidateConf.java``:
validates a raw site-properties FILE (``--site path``, default the
ATPU_SITE_PROPERTIES location) — the surface where misspelled keys and
unparseable values actually enter, since ``load_site_properties``
deliberately skips unknown keys at boot — plus semantic cross-checks on
the effective configuration. Exit 0 = clean, 1 = errors (warnings pass).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from alluxio_tpu_torch.conf import Configuration, Keys
from alluxio_tpu_torch.conf.property_key import REGISTRY


def validate_site_file(path: str) -> Tuple[List[str], List[str]]:
    """Check every key/value in a java-properties-style file."""
    errors: List[str] = []
    warns: List[str] = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                warns.append(f"{path}:{lineno}: not key=value: {line!r}")
                continue
            k, _, v = line.partition("=")
            k, v = k.strip(), v.strip()
            pk = REGISTRY.get(k)
            if pk is None:
                if REGISTRY.is_valid(k):
                    continue  # template instance (tier levels etc.)
                if k.startswith("atpu."):
                    errors.append(
                        f"{path}:{lineno}: unknown property {k!r} — "
                        "misspelled key? (boot silently ignores it)")
                else:
                    warns.append(
                        f"{path}:{lineno}: non-framework property "
                        f"{k!r} ignored")
                continue
            try:
                pk.parse(v)
            except Exception as e:  # noqa: BLE001 — report, keep going
                errors.append(f"{path}:{lineno}: {k}={v!r}: "
                              f"{type(e).__name__}: {e}")
    return errors, warns


def cross_checks(conf: Configuration) -> Tuple[List[str], List[str]]:
    """Semantic checks on the EFFECTIVE configuration."""
    errors: List[str] = []
    warns: List[str] = []
    lo = conf.get_ms(Keys.MASTER_EMBEDDED_JOURNAL_ELECTION_TIMEOUT_MIN)
    hi = conf.get_ms(Keys.MASTER_EMBEDDED_JOURNAL_ELECTION_TIMEOUT_MAX)
    if lo >= hi:
        errors.append("embedded journal election timeout min >= max "
                      f"({lo}ms >= {hi}ms)")
    hb = conf.get_ms(Keys.MASTER_EMBEDDED_JOURNAL_HEARTBEAT_INTERVAL)
    if hb * 2 > lo:
        warns.append(
            f"journal heartbeat interval {hb}ms is more than half the "
            f"minimum election timeout {lo}ms — spurious elections "
            "under load")
    if conf.get_bytes(Keys.WORKER_RAMDISK_SIZE) <= 0:
        errors.append("worker ramdisk (MEM tier) size must be positive")
    levels = conf.get_int(Keys.WORKER_TIERED_STORE_LEVELS)
    if not 1 <= levels <= 3:
        errors.append(f"tiered store levels must be 1..3, got {levels}")
    if conf.get(Keys.USER_FILE_WRITE_TYPE_DEFAULT) == "THROUGH":
        warns.append("default write type THROUGH keeps no cached copy — "
                     "every read goes to the UFS")
    return errors, warns


def validate(conf: Configuration,
             site_path: Optional[str] = None
             ) -> Tuple[List[str], List[str]]:
    errors: List[str] = []
    warns: List[str] = []
    if site_path and os.path.exists(site_path):
        e, w = validate_site_file(site_path)
        errors += e
        warns += w
    e, w = cross_checks(conf)
    return errors + e, warns + w


def main(argv=None, conf: Configuration = None, out=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(prog="alluxio-tpu validateConf")
    ap.add_argument("--site", default=None)
    args = ap.parse_args(argv or [])
    out = out or sys.stdout
    conf = conf or Configuration()
    site = args.site or os.environ.get(
        "ATPU_SITE_PROPERTIES", "/etc/alluxio_tpu/site.properties")
    errors, warns = validate(conf, site_path=site)
    if args.site and not os.path.exists(args.site):
        # an EXPLICIT path that doesn't exist must not silently report
        # clean — that is exactly the typo this tool exists to catch
        errors.append(f"--site {args.site}: file does not exist")
    for w in warns:
        print(f"WARN  {w}", file=out)
    for e in errors:
        print(f"ERROR {e}", file=out)
    print(f"validateConf: {len(errors)} error(s), {len(warns)} "
          f"warning(s)", file=out)
    return 0 if not errors else 1
