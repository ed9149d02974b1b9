"""``alluxio-tpu format`` — wipe journal and worker storage dirs.

A copy of ``alluxio_tpu/shell/format.py``.

Re-design of ``core/server/common/src/main/java/alluxio/cli/Format.java:45,80``:
``format master`` clears the journal folder; ``format worker`` clears every
configured tier directory. Refuses to touch paths outside the configured
locations.
"""

from __future__ import annotations

import os
import shutil
import sys

from alluxio_tpu_torch.conf import Configuration, Keys, Templates


def _wipe_dir(path: str, out) -> None:
    if os.path.isdir(path):
        for name in os.listdir(path):
            full = os.path.join(path, name)
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
            else:
                try:
                    os.unlink(full)
                except OSError:
                    pass
        print(f"Formatting {path}", file=out)
    else:
        os.makedirs(path, exist_ok=True)
        print(f"Created {path}", file=out)


def format_master(conf: Configuration, out=None) -> None:
    # out=None late-binds: print(file=None) writes to the CURRENT sys.stdout.
    _wipe_dir(conf.get(Keys.MASTER_JOURNAL_FOLDER), out)


def format_worker(conf: Configuration, out=None) -> None:
    levels = conf.get_int(Keys.WORKER_TIERED_STORE_LEVELS)
    for lvl in range(levels):
        for p in conf.get_list(Templates.WORKER_TIER_DIRS_PATH.format(lvl)):
            _wipe_dir(p, out)
    data_folder = conf.get(Keys.WORKER_DATA_FOLDER)
    if data_folder:
        _wipe_dir(data_folder, out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    target = argv[0] if argv else "all"
    conf = Configuration()
    if target in ("master", "all"):
        format_master(conf)
    if target in ("worker", "all"):
        format_worker(conf)
    if target not in ("master", "worker", "all"):
        print(f"Usage: alluxio-tpu format [master|worker|all]",
              file=sys.stderr)
        return 1
    return 0
