"""Phase 2c of ``chip_smoke.py`` from two trees, back to back on one card.

Each run is a process of its own that imports ``chip_smoke`` from its
tree, builds the kernels, drives that tree's main path at full size (and
stops its cluster, where the tree has one) and then runs phase 2c alone,
so that two commits' worker numbers are read on the same host. The runs
go in the order given; give the trees as parent, change, change, parent:

    mkdir -p build/ab/parent
    git archive <parent commit> | tar -x -C build/ab/parent
    python3 tools/ab_worker_phase.py [--logs DIR] parent=build/ab/parent \\
        change=. change=. parent=build/ab/parent

Each run's whole output goes to ``DIR/<n>-<label>.log`` (``build/ab`` by
default); the lines that 2c's comparison reads are printed, with the
card's name and power limit first. Exits non-zero if any run failed.
"""

import os
import shutil
import subprocess
import sys
import threading
import time

KEEP = ("host->device ceiling", "main path: epoch 1", "worker prefetch",
        "worker cold UFS", "worker coalescing", "threads before 2c",
        "run total", "Error")


def child(tree: str) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cs.setup()
    workdir = cs.block_dir(2 * cs.NUM_BLOCKS * cs.BLOCK_BYTES + (256 << 20)
                           + cs.PAGE_CACHE_BYTES)
    main = None
    try:
        main = cs.main_path(device, workdir, cs.NUM_BLOCKS, cs.BLOCK_BYTES,
                            cs.K)
        if hasattr(cs, "stop_cluster"):
            cs.stop_cluster(main)
        names = sorted(t.name for t in threading.enumerate())
        print(f"threads before 2c: {len(names)} {names}", flush=True)
        cs.worker_phase(device, workdir, main, cs.K)
    finally:
        if main is not None and hasattr(cs, "stop_cluster"):
            cs.stop_cluster(main)
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"run total {time.perf_counter() - t0:.1f} s", flush=True)


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1])
        return 0
    out = os.path.join("build", "ab")
    if argv[:1] == ["--logs"]:
        out, argv = argv[1], argv[2:]
    runs = [a.split("=", 1) for a in argv]
    if not runs or any(len(r) != 2 for r in runs):
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    os.makedirs(out, exist_ok=True)
    failed = 0
    for i, (label, tree) in enumerate(runs, 1):
        log = os.path.join(out, f"{i}-{label}.log")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--child", tree], stdout=f,
                                stderr=subprocess.STDOUT, timeout=600
                                ).returncode
        failed += rc != 0
        print(f"== {i} {label} ({tree}) rc={rc}", flush=True)
        with open(log) as f:
            for line in f:
                if any(k in line for k in KEEP):
                    print(line.rstrip()[:600], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
