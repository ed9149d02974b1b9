"""journalCrashTest: hammer the master with metadata ops while
repeatedly SIGKILLing it, then verify every acknowledged op survived
journal replay (a copy of ``alluxio_tpu/shell/journal_crash.py``; its
masters are the port's, each in its own process).

Env-adapted analogue of the reference's ``shell/.../cli/
JournalCrashTest.java:43``: client threads run CREATE_FILE /
CREATE_DELETE_FILE / CREATE_RENAME_FILE loops counting acknowledged
successes; a supervisor bounds each master's lifetime (``--max-alive``)
by hard-killing and restarting it until ``--total-time`` elapses; the
final check reconnects and asserts the exact acknowledged state is
reproduced by replay (exit 0/1). Reconciliation on retry mirrors the
journal's at-least-once reality: an op that raised after the crash may
still have committed (ack lost), so a retry that finds the op's
outcome already in place counts it succeeded rather than spinning on
AlreadyExists forever.
"""

from __future__ import annotations

import itertools
import shutil
import sys
import tempfile
import threading
import time
from typing import List, Optional

from alluxio_tpu_torch.utils.exceptions import (
    FileAlreadyExistsError, FileDoesNotExistError, NotFoundError,
)

_GONE = (FileDoesNotExistError, NotFoundError)

CREATE = "create"
CREATE_DELETE = "create_delete"
CREATE_RENAME = "create_rename"


class _OpThread(threading.Thread):
    def __init__(self, cluster, kind: str, workdir: str,
                 op_sleep_s: float = 0.02) -> None:
        super().__init__(name=f"crash-{kind}", daemon=True)
        self._cluster = cluster
        self.kind = kind
        self.workdir = workdir
        self.success = 0
        self._sleep = op_sleep_s
        self._halt = threading.Event()

    def stop(self) -> None:
        self._halt.set()

    def run(self) -> None:  # noqa: C901 — one small op state machine
        fs = self._cluster.file_system()
        try:
            while not self._halt.is_set():
                path = f"{self.workdir}{self.success}"
                try:
                    if self.kind == CREATE:
                        try:
                            fs.write_all(path, b"")
                        except FileAlreadyExistsError:
                            pass  # committed before a lost ack
                    elif self.kind == CREATE_DELETE:
                        try:
                            fs.write_all(path, b"")
                        except FileAlreadyExistsError:
                            pass
                        try:
                            fs.delete(path)
                        except _GONE:
                            pass  # delete committed, ack lost
                    elif self.kind == CREATE_RENAME:
                        try:
                            fs.write_all(path, b"")
                        except FileAlreadyExistsError:
                            pass
                        try:
                            fs.rename(path, path + "-rename")
                        except _GONE + (FileAlreadyExistsError,):
                            # src gone or dst taken: committed with a
                            # lost ack IF the renamed file is there —
                            # e.g. a crash-retry recreated src, then
                            # rename found dst from the committed op
                            if not fs.exists(path + "-rename"):
                                raise
                except Exception:  # noqa: BLE001 — master mid-crash;
                    time.sleep(0.2)  # keep requesting (reference)
                    continue
                self.success += 1
                time.sleep(self._sleep)
        finally:
            try:
                fs.close()
            except Exception:  # noqa: BLE001
                pass


def _verify(fs, threads: List[_OpThread], log) -> bool:
    ok = True
    for t in threads:
        log(f"expect: kind={t.kind} workdir={t.workdir} "
            f"acked={t.success}")
        for s in range(t.success):
            path = f"{t.workdir}{s}"
            if t.kind == CREATE and not fs.exists(path):
                log(f"FAILED: {path} missing after replay")
                ok = False
            elif t.kind == CREATE_DELETE and fs.exists(path):
                log(f"FAILED: {path} still exists after replay")
                ok = False
            elif t.kind == CREATE_RENAME and \
                    not fs.exists(path + "-rename"):
                log(f"FAILED: {path}-rename missing after replay")
                ok = False
    return ok


def run_crash_test(*, total_time_s: float = 20.0,
                   max_alive_s: float = 5.0,
                   creates: int = 1, create_deletes: int = 1,
                   create_renames: int = 1,
                   journal_type: str = "LOCAL", num_masters: int = 1,
                   base_dir: Optional[str] = None,
                   test_dir: str = "/crash-test",
                   kill: str = "all",
                   log=None) -> bool:
    """``kill``: "all" SIGKILLs every master each cycle (cold restart +
    replay — the reference tool's shape); "leader" kills only the
    serving primary, so a multi-master quorum must keep accepting
    writes through failover while the victim restarts and catches up."""
    from alluxio_tpu_torch.minicluster import MultiProcessCluster

    if kill not in ("all", "leader"):
        raise ValueError(f"kill must be 'all' or 'leader', got {kill!r}")
    log = log or (lambda *a: print(*a, file=sys.stderr))
    base = base_dir or tempfile.mkdtemp(prefix="atpu_crash_")
    own_base = base_dir is None
    try:
        with MultiProcessCluster(base, num_masters=num_masters,
                                 num_workers=0,
                                 journal_type=journal_type) as cluster:
            fs = cluster.file_system()
            fs.create_directory(test_dir, recursive=True,
                                allow_exists=True)
            threads: List[_OpThread] = []
            counter = itertools.count()
            for kind, n in ((CREATE, creates),
                            (CREATE_DELETE, create_deletes),
                            (CREATE_RENAME, create_renames)):
                for _ in range(n):
                    t = _OpThread(cluster, kind,
                                  f"{test_dir}/{kind}-{next(counter)}-")
                    threads.append(t)
                    t.start()
            deadline = time.monotonic() + total_time_s
            crashes = 0
            while time.monotonic() < deadline:
                time.sleep(min(max_alive_s,
                               max(0.0, deadline - time.monotonic())))
                if time.monotonic() >= deadline:
                    break
                if kill == "leader":
                    li = cluster.primary_index()
                    cluster.masters[li].kill()
                    crashes += 1
                    log(f"crash #{crashes}: leader m{li} SIGKILLed, "
                        "restarting it (quorum keeps serving)")
                    cluster.start_master(li)
                else:
                    # hard-kill every living master (LOCAL: the one
                    # primary; EMBEDDED: leader + followers too)
                    for i, m in enumerate(cluster.masters):
                        if m.alive:
                            m.kill()
                    crashes += 1
                    log(f"crash #{crashes}: all masters SIGKILLed, "
                        "restarting")
                    for i in range(len(cluster.masters)):
                        cluster.start_master(i)
                cluster.wait_for_primary()
            for t in threads:
                t.stop()
            for t in threads:
                t.join(timeout=30)
            log(f"ran {crashes} crash cycle(s); "
                f"acks: {[t.success for t in threads]}")
            # final replay check on a fresh client against the
            # post-crash primary
            cluster.wait_for_primary()
            fs2 = cluster.file_system()
            ok = _verify(fs2, threads, log)
            fs2.close()
            fs.close()
            if not any(t.success for t in threads):
                log("FAILED: no operation was ever acknowledged — "
                    "the test exercised nothing")
                ok = False
            return ok
    finally:
        if own_base:
            shutil.rmtree(base, ignore_errors=True)


def main(argv=None, out=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="alluxio-tpu journalCrashTest")
    ap.add_argument("--total-time", type=float, default=20.0,
                    help="seconds to run the whole test")
    ap.add_argument("--max-alive", type=float, default=5.0,
                    help="max seconds any master stays alive")
    ap.add_argument("--creates", type=int, default=1)
    ap.add_argument("--create-deletes", type=int, default=1)
    ap.add_argument("--create-renames", type=int, default=1)
    ap.add_argument("--journal", default="LOCAL",
                    choices=["LOCAL", "EMBEDDED"])
    ap.add_argument("--masters", type=int, default=1)
    ap.add_argument("--kill", default="all", choices=["all", "leader"])
    ap.add_argument("--dir", default="/crash-test")
    args = ap.parse_args(argv)
    stream = out or sys.stderr

    def log(*a):
        print(*a, file=stream, flush=True)

    ok = run_crash_test(
        total_time_s=args.total_time, max_alive_s=args.max_alive,
        creates=args.creates, create_deletes=args.create_deletes,
        create_renames=args.create_renames, journal_type=args.journal,
        num_masters=args.masters, test_dir=args.dir, kill=args.kill,
        log=log)
    log("journalCrashTest: " + ("PASSED" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
