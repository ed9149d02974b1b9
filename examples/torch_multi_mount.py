#!/usr/bin/env python
"""Multi-mount namespace: copy data between two under-storages through
one namespace of the PyTorch port's cluster.

The port's counterpart of ``examples/multi_mount.py``, step for step.
Analogue of the reference's ``examples/.../MultiMount.java:37`` (which
mounts S3 + HDFS and copies between them): here two local directories
stand in for the external systems — swap the URIs for
``s3://``/``gcs://``/``webhdfs://`` on a real deployment; the copy
code does not change, which is the point of the unified namespace.

    python examples/torch_multi_mount.py [--master host:19998]

(--master assumes a same-host cluster: the stand-in stores are local
directories, which master and worker must also be able to reach.)
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile

# runnable from anywhere: the library lives at the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(fs, workdir: str) -> None:
    from alluxio_tpu_torch.client.streams import WriteType

    # stand-in external stores (swap for s3://bucket, webhdfs://nn,
    # ...): plain local directories, so an out-of-process same-host
    # cluster sees the same data
    src = os.path.join(workdir, "example-src")
    dst = os.path.join(workdir, "example-dst")
    os.makedirs(src, exist_ok=True)
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(src, "input.csv"), "wb") as f:
        f.write(b"day,requests\nmon,12\ntue,34\n")

    fs.create_directory("/mnt", allow_exists=True, recursive=True)
    fs.mount("/mnt/src", src)
    fs.mount("/mnt/dst", dst)
    print("mounted:", [m.alluxio_path for m in fs.get_mount_points()
                       if m.alluxio_path.startswith("/mnt")])

    # one namespace: read from one store, persist into the other
    data = fs.read_all("/mnt/src/input.csv")
    fs.write_all("/mnt/dst/input.csv", data,
                 write_type=WriteType.CACHE_THROUGH)
    st = fs.get_status("/mnt/dst/input.csv")
    with open(os.path.join(dst, "input.csv"), "rb") as f:
        assert f.read() == data  # really landed in the other store
    print(f"copied {st.length} B across stores; persisted="
          f"{st.persisted}")
    fs.unmount("/mnt/src")
    fs.unmount("/mnt/dst")
    print("unmounted; done.")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--master", default=None)
    args = ap.parse_args(argv)
    with contextlib.ExitStack() as stack:
        if args.master:
            from alluxio_tpu_torch.client.file_system import FileSystem

            fs = stack.enter_context(
                contextlib.closing(FileSystem(args.master)))
            workdir = stack.enter_context(tempfile.TemporaryDirectory())
        else:
            from alluxio_tpu_torch.minicluster import LocalCluster

            d = stack.enter_context(tempfile.TemporaryDirectory())
            cluster = stack.enter_context(
                LocalCluster(d, num_workers=1))
            fs = stack.enter_context(
                contextlib.closing(cluster.file_system()))
            workdir = d
        run(fs, workdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
