"""The controls of the comparison that decides ``correct``, on the card at
a cell's own size: for each seed, one short window of the program, then
its outputs compared with the reference, and the reference computed in
the next precision down (the control) put in the program's place and
compared the same way. Prints one JSON line a seed. The benchmark's own
runs do not run this.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 --seconds 3
"""

import time


import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import harness  # noqa: E402


def readings(bench, cell, seeds, seconds, device):
    """One ``{"seed", "program", "control", "samples_per_s"}`` a seed."""
    for seed in seeds:
        res = harness.run_cell(bench, cell, seed=seed, seconds=seconds,
                               trace=False, device=device,
                               t0=time.perf_counter(), control=True)
        run = res["run"]
        yield {"workload": cell["name"], "seed": seed,
               "program": {k: v for k, (v, _) in res["checks"].items()},
               "control": {k: v for k, (v, _) in res["control"].items()},
               "limits": {k: lim for k, (_, lim) in res["checks"].items()},
               "samples_per_s": run.samples / run.window_s}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_bench()
    cell = harness.find_cell(bench, args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in readings(bench, cell, seeds, args.seconds, device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
