"""Run scenarios in gloo process groups of spawned CPU workers.

A test module names module-level scenario functions
``fn(rank, world, out_dir) -> picklable``; :func:`run_groups` starts
one spawned process per rank for every group at once, each joins its
own gloo group (``init_process_group(..., timeout=60 s)``), calls the
function and writes its result to ``out_dir``. The parent waits until
a deadline: a worker still running then is killed and the call fails,
so a stuck collective fails the test instead of hanging it. The
workers import only torch, numpy and the module that holds the
scenario (which must not import JAX at module level).
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import pickle
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Tuple

#: seconds a collective may wait before it raises
GROUP_TIMEOUT_S = 60
#: seconds all the groups of one call may take, start-up included
DEADLINE_S = 150


def _worker(rank: int, world: int, store: str, module: str, fn: str,
            out_dir: str, tag: str) -> None:
    # below the test processes beside it: a burst of workers importing
    # torch must not starve their timing (elections, heartbeats)
    os.nice(10)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = Path(out_dir)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            result = getattr(importlib.import_module(module), fn)(
                rank, world, out_dir)
            (out / f"{tag}-{rank}.pkl").write_bytes(pickle.dumps(result))
            dist.barrier()  # no rank closes its pairs under a peer's op
        finally:
            dist.destroy_process_group()
    except BaseException:
        (out / f"{tag}-{rank}.err").write_text(traceback.format_exc())
        raise
    # the work is done and written: skip the interpreter's teardown, where
    # torch's static destructors can meet a live thread and abort
    # ("terminate called without an active exception") when many workers
    # exit at once
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_groups(module: str, groups: Dict[str, Tuple[int, str]],
               out_dir) -> Dict[str, List]:
    """Run ``groups`` (tag -> (world size, scenario function name in
    ``module``)) at the same time; returns tag -> the per-rank results.
    Raises ``AssertionError`` with the workers' tracebacks if any
    failed or missed the deadline."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for tag, (world, fn) in groups.items():
        store = str(out_dir / f"{tag}.store")
        for rank in range(world):
            p = ctx.Process(target=_worker, args=(
                rank, world, store, module, fn, str(out_dir), tag),
                daemon=True)
            p.start()
            procs.append(p)
    deadline = time.monotonic() + DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join(10)
    errors = sorted(out_dir.glob("*.err"))
    if late or errors or any(p.exitcode != 0 for p in procs):
        details = "\n".join(f"--- {e.name}\n{e.read_text()}"
                            for e in errors)
        raise AssertionError(
            f"{len(late)} worker(s) missed the {DEADLINE_S} s deadline; "
            f"exit codes {[p.exitcode for p in procs]}\n{details}")
    return {tag: [pickle.loads((out_dir / f"{tag}-{r}.pkl").read_bytes())
                  for r in range(world)]
            for tag, (world, _fn) in groups.items()}


def cpu_group(path) -> None:
    """A world-1 gloo group in this process (for tests that need the
    parent's objects, such as a cluster client); pair with
    ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{os.fspath(path)}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
