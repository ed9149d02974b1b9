"""runOperation: perform one metadata/IO operation N times over T
threads against a live cluster.

A copy of ``alluxio_tpu/shell/run_operation.py``.

Env-adapted analogue of the reference's ``shell/.../cli/
RunOperation.java:37`` (ops CreateFile / CreateEmptyFile /
CreateAndDeleteEmptyFile / ListStatus; ``-n`` total across threads,
``-t`` threads, ``-d`` base dir, ``-s`` file size): the quick
sanity/smoke loop operators run before reaching for the full stress
suite.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

from alluxio_tpu_torch.conf import Configuration, Keys

OPERATIONS = ("CreateFile", "CreateEmptyFile",
              "CreateAndDeleteEmptyFile", "ListStatus")


def _worker(fs, op: str, base: str, size: int, counter, times: int,
            thread_id: int, errors: List[str]) -> None:
    data = b"\x5a" * size
    while True:
        # itertools.count.__next__ is atomic in CPython — safe to share
        n = next(counter)
        if n >= times:
            return
        path = f"{base}/op-{thread_id}-{n}"
        try:
            if op == "CreateFile":
                fs.write_all(path, data)
            elif op == "CreateEmptyFile":
                fs.write_all(path, b"")
            elif op == "CreateAndDeleteEmptyFile":
                fs.write_all(path, b"")
                fs.delete(path)
            elif op == "ListStatus":
                fs.list_status(base)
        except Exception as e:  # noqa: BLE001 report, keep going
            errors.append(f"{path}: {type(e).__name__}: {e}")


def run(op: str, *, times: int = 1, threads: int = 1,
        directory: str = "/RunOperationDir", size: int = 4096,
        conf: Optional[Configuration] = None) -> dict:
    from alluxio_tpu_torch.client.file_system import FileSystem

    if threads < 1:
        raise ValueError(f"threads must be >= 1, got {threads}")
    conf = conf or Configuration()
    host = conf.get(Keys.MASTER_HOSTNAME) or "localhost"
    address = f"{host}:{conf.get_int(Keys.MASTER_RPC_PORT)}"

    shared = itertools.count()
    errors: List[str] = []
    # one client per thread: mirrors real concurrent-client load and
    # avoids serializing on one connection
    clients = [FileSystem(address, conf=conf) for _ in range(threads)]
    try:
        clients[0].create_directory(directory, allow_exists=True)
        ts = [threading.Thread(
            target=_worker,
            args=(clients[i], op, directory, size, shared, times, i,
                  errors),
            name=f"run-operation-{i}") for i in range(threads)]
        t0 = time.monotonic()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.monotonic() - t0
    finally:
        for c in clients:
            c.close()
    done = times - len(errors)
    return {"operation": op, "requested": times, "succeeded": done,
            "errors": errors[:10], "error_count": len(errors),
            "seconds": round(wall, 3),
            "ops_per_s": round(done / wall, 1) if wall > 0 else 0.0}


def main(argv=None, conf: Optional[Configuration] = None,
         out=None) -> int:
    import argparse
    import sys

    out = out or sys.stdout
    ap = argparse.ArgumentParser(prog="alluxio-tpu runOperation")
    ap.add_argument("-op", "--operation", required=True,
                    choices=OPERATIONS)
    ap.add_argument("-n", "--num", type=int, default=1,
                    help="total operations across all threads")
    ap.add_argument("-t", "--threads", type=int, default=1)
    ap.add_argument("-d", "--dir", default="/RunOperationDir")
    ap.add_argument("-s", "--size", type=int, default=4096)
    args = ap.parse_args(argv)
    try:
        result = run(args.operation, times=args.num,
                     threads=args.threads, directory=args.dir,
                     size=args.size, conf=conf)
    except ValueError as e:
        print(f"runOperation: {e}", file=out)
        return 2
    for e in result["errors"]:
        print(f"error: {e}", file=out)
    print(f"{result['operation']}: {result['succeeded']}/"
          f"{result['requested']} ok in {result['seconds']}s "
          f"({result['ops_per_s']} op/s)", file=out)
    return 0 if result["error_count"] == 0 else 1
