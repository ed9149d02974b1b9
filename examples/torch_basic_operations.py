#!/usr/bin/env python
"""Basic filesystem operations against the PyTorch port's cluster.

The port's counterpart of ``examples/basic_operations.py``, step for
step (reference: the ``BasicOperations``-style entry points in
``examples/src/main/java/alluxio/examples/``): write a file with a
chosen WriteType, read it back, stat it, list the parent — the
five-minute smoke a new user runs first.

Run against a live cluster (``bin/alluxio-tpu-torch-start.sh local``):
    python examples/torch_basic_operations.py --master host:19998
or self-contained (boots an in-process cluster):
    python examples/torch_basic_operations.py
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
import time


def run(fs) -> None:
    from alluxio_tpu_torch.client.streams import WriteType

    path = "/examples/basic"
    payload = b"hello alluxio-tpu " * 1000
    t0 = time.monotonic()
    fs.create_directory("/examples", allow_exists=True, recursive=True)
    fs.write_all(path, payload, write_type=WriteType.MUST_CACHE)
    print(f"wrote {len(payload)} B in "
          f"{(time.monotonic() - t0) * 1000:.1f} ms")
    t0 = time.monotonic()
    got = fs.read_all(path)
    assert got == payload
    print(f"read it back in {(time.monotonic() - t0) * 1000:.1f} ms")
    st = fs.get_status(path)
    print(f"status: length={st.length} blocks={len(st.block_ids)} "
          f"in_memory={st.in_memory_percentage}%")
    names = [i.name for i in fs.list_status("/examples")]
    print(f"listing /examples -> {names}")
    fs.delete(path)
    print("deleted; done.")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--master", default=None, help="host:port; omit to "
                    "boot an in-process cluster")
    args = ap.parse_args(argv)
    with contextlib.ExitStack() as stack:
        if args.master:
            from alluxio_tpu_torch.client.file_system import FileSystem

            fs = stack.enter_context(
                contextlib.closing(FileSystem(args.master)))
        else:
            from alluxio_tpu_torch.minicluster import LocalCluster

            d = stack.enter_context(tempfile.TemporaryDirectory())
            cluster = stack.enter_context(
                LocalCluster(d, num_workers=1))
            fs = stack.enter_context(
                contextlib.closing(cluster.file_system()))
        run(fs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
