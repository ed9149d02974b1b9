"""Can this host serve a FUSE mount of the port?

Prints what a mount needs (``/dev/fuse``, ``libfuse.so.2`` in the linker
cache, ``fusermount``), then mounts an in-process ``LocalCluster`` of the
port at a scratch directory with ``AlluxioFuseMount``, lists and reads a
file through the kernel, and unmounts. The last line is one JSON object
with each answer; the exit code is 0 when the mount worked.

    python3 tools/fuse_probe.py
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(argv) -> str:
    try:
        return subprocess.run(argv, capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{type(e).__name__}: {e}"


def main() -> int:
    sys.path.insert(0, ROOT)
    from alluxio_tpu_torch.fuse.process import AlluxioFuseMount, fuse_available
    from alluxio_tpu_torch.minicluster import LocalCluster

    out = {
        "dev_fuse": _run(["ls", "-l", "/dev/fuse"]),
        "libfuse_so_2": [line.strip() for line in
                         _run(["ldconfig", "-p"]).splitlines()
                         if "libfuse.so.2" in line],
        "fusermount": shutil.which("fusermount") or "",
        "fuse_available": fuse_available(),
    }
    ok = False
    if not out["fuse_available"]:
        out["mount_ok"] = ok
        print(json.dumps(out), flush=True)
        return 1
    base = tempfile.mkdtemp(prefix="atpu-fuse-probe-")
    try:
        with LocalCluster(os.path.join(base, "cluster"), num_workers=1) as c:
            fs = c.file_system()
            fs.write_all("/probe.bin", b"mounted")
            mnt = os.path.join(base, "mnt")
            m = AlluxioFuseMount(fs, mnt)
            try:
                m.mount()
                out["listing"] = sorted(os.listdir(mnt))
                with open(os.path.join(mnt, "probe.bin"), "rb") as f:
                    out["read"] = f.read().decode()
                ok = out["read"] == "mounted"
            except Exception as e:  # noqa: BLE001 - the answer is the probe
                out["mount_error"] = f"{type(e).__name__}: {e}"
            finally:
                m.unmount()
            out["unmounted"] = not os.path.ismount(mnt)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    out["mount_ok"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
