"""A master's boot and phase 2h d of ``chip_smoke.py`` from two trees, on
one host.

For each tree, in the order given: ``--boots`` fresh interpreters each
import the port's master, boot a ``MasterProcess`` over a local root UFS
and stop it, printing the seconds from the interpreter's first line to
the imports done and to ``start()`` returned, the number of modules
loaded and which of ``requests`` and ``pyarrow`` were; then, with
``--suite``, a process of its own runs that tree's 2h d (the stress
suite with chip_smoke's cuts), which needs no card. Give the trees as
parent, change, change, parent:

    mkdir -p build/ab/parent
    git archive <parent commit> | tar -x -C build/ab/parent
    python3 tools/ab_master_boot.py [--logs DIR] [--boots N] [--suite] \\
        parent=build/ab/parent change=. change=. parent=build/ab/parent

Each run's whole output goes to ``DIR/<n>-<label>.log`` (``build/ab`` by
default), and the card's name and power limit to ``DIR/card.txt``; one
JSON line per tree sums up the boots (in its log too), the suite's lines
are printed, with the card's line first. Exits non-zero if any run
failed.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

#: a master booted and stopped in a fresh interpreter; argv: tree, dir
BOOT_CHILD = (
    "import time\n"
    "t0 = time.perf_counter()\n"
    "import json, os, sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from alluxio_tpu_torch.conf import Configuration, Keys\n"
    "from alluxio_tpu_torch.master.process import MasterProcess\n"
    "t_import = time.perf_counter() - t0\n"
    "base = sys.argv[2]\n"
    "conf = Configuration(load_env=False)\n"
    "conf.set(Keys.HOME, base)\n"
    "conf.set(Keys.MASTER_JOURNAL_FOLDER, os.path.join(base, 'journal'))\n"
    "conf.set(Keys.MASTER_RPC_PORT, 0)\n"
    "conf.set(Keys.MASTER_FASTPATH_ENABLED, False)\n"
    "master = MasterProcess(conf, root_ufs_uri=os.path.join(base, 'ufs'))\n"
    "master.start()\n"
    "t_boot = time.perf_counter() - t0\n"
    "master.stop()\n"
    "print(json.dumps({'import_s': t_import, 'boot_s': t_boot,\n"
    "                  'modules': len(sys.modules),\n"
    "                  'heavy': sorted(m for m in ('requests', 'pyarrow')\n"
    "                                  if m in sys.modules)}))\n")

KEEP = ("2h d:", "Error", "error")


def boots(tree: str, n: int, log) -> dict:
    """``n`` boots of a master from ``tree``, each in a fresh
    interpreter: the medians, the range and what was loaded."""
    rows, walls = [], []
    for _ in range(n):
        base = tempfile.mkdtemp(prefix="atpu-boot-")
        try:
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-c", BOOT_CHILD,
                                  os.path.abspath(tree), base],
                                 capture_output=True, text=True, timeout=120,
                                 cwd=base)
            walls.append(time.perf_counter() - t0)
        finally:
            shutil.rmtree(base, ignore_errors=True)
        log.write(out.stdout + out.stderr)
        if out.returncode != 0:
            raise RuntimeError(f"boot exited {out.returncode}: "
                               f"{out.stderr[-2000:]}")
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
    summary = {"boots": n, "heavy": sorted({m for r in rows
                                            for m in r["heavy"]}),
               "modules": statistics.median(r["modules"] for r in rows)}
    for key, values in (("import_s", [r["import_s"] for r in rows]),
                        ("boot_s", [r["boot_s"] for r in rows]),
                        ("process_s", walls)):
        summary[key] = {"median": statistics.median(values),
                        "min": min(values), "max": max(values)}
    return summary


def suite(tree: str, log) -> int:
    """That tree's 2h d in a process of its own; its lines go to ``log``."""
    code = ("import os, shutil, sys, tempfile\n"
            "sys.path.insert(0, sys.argv[1])\n"
            "import chip_smoke as cs\n"
            "workdir = tempfile.mkdtemp(prefix='atpu-suite-')\n"
            "try:\n"
            "    cs.suite_phase(workdir)\n"
            "finally:\n"
            "    shutil.rmtree(workdir, ignore_errors=True)\n")
    log.flush()
    return subprocess.run([sys.executable, "-c", code,
                           os.path.abspath(tree)], stdout=log,
                          stderr=subprocess.STDOUT, timeout=900,
                          cwd=os.path.abspath(tree)).returncode


def main(argv) -> int:
    out, n, with_suite = os.path.join("build", "ab"), 10, False
    while argv[:1] and argv[0].startswith("--"):
        if argv[0] == "--logs":
            out, argv = argv[1], argv[2:]
        elif argv[0] == "--boots":
            n, argv = int(argv[1]), argv[2:]
        elif argv[0] == "--suite":
            with_suite, argv = True, argv[1:]
        else:
            print(__doc__, file=sys.stderr)
            return 2
    runs = [a.split("=", 1) for a in argv]
    if not runs or any(len(r) != 2 for r in runs):
        print(__doc__, file=sys.stderr)
        return 2
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except FileNotFoundError:
        card = "no nvidia-smi: no card on this host"
    print(card, flush=True)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "card.txt"), "w") as f:
        f.write(card + "\n")
    failed = 0
    for i, (label, tree) in enumerate(runs, 1):
        path = os.path.join(out, f"{i}-{label}.log")
        with open(path, "w") as log:
            try:
                summary = boots(tree, n, log)
            except (RuntimeError, subprocess.TimeoutExpired) as e:
                summary = {"error": str(e)[-600:]}
                failed += 1
            line = json.dumps({"run": i, "label": label, "tree": tree,
                               "master_boot": summary})
            print(line, flush=True)
            log.write(line + "\n")
            if with_suite:
                rc = suite(tree, log)
                failed += rc != 0
                print(f"== {i} {label} 2h d rc={rc}", flush=True)
        if with_suite:
            with open(path) as f:
                for line in f:
                    if any(k in line for k in KEEP):
                        print(line.rstrip()[:600], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
