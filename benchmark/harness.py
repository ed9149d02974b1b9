"""One cell of the benchmark, run once: set-up, the measured window, the
comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic mix, consumer,
dataset format or metric sits in a file of its own beside this module
and is found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment (its ``format``, ``consumer``,
  sizes, ``source``, ``reduced`` and ``assumed``);
- ``traffic/<mix>.json``: order, device-tier share and the port's
  configuration keys;
- ``formats/<format>.py``: ``make(cfg, seed, device) -> Dataset``;
- ``consumers/<consumer>.py``: ``Consumer(ctx)`` with ``epoch``,
  ``finish`` and ``check``;
- ``metrics/<metric>.py``: ``read(run) -> float | None``.

The program under test is ``alluxio_tpu_torch``: a ``LocalCluster``
(master and one worker, its MEM tier inside the worker's SHM directory
under ``TMPDIR``), ``write_all(MUST_CACHE)``, and the window driven
through ``DeviceBlockLoader.epoch()``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from benchmark import devtrace
from benchmark.reference.compare import block_order

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: the traced slice: the last seconds of a ``--trace 1`` window
TRACE_SECONDS = 2.0
#: top-level modules that may not be loaded in the process that prints
#: the result: JAX and the JAX package (compared whole: the port's own
#: name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "alluxio_tpu")
#: the device tier's room beyond the dataset when it holds all of it
TIER_SLACK = 64 << 20
#: the worker's MEM tier beyond the dataset
WORKER_SLACK = 256 << 20
#: epochs before the window: the first fills the device tier
WARMUP_EPOCHS = 1
#: steps the consumer leaves unfinished on the device
MAX_INFLIGHT = 2


# -- finding things by name ---------------------------------------------------
def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def find_file(kind: str, name: str, suffix: str,
              bases: Sequence[Path] = (HERE,)) -> Path:
    """``<base>/<kind>/<name><suffix>`` in the first of ``bases`` that
    has it."""
    for base in bases:
        path = Path(base) / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind} file {name}{suffix} under "
                            f"{', '.join(map(str, bases))}")


def load_config(name: str, bases: Sequence[Path] = (HERE,)) -> dict:
    cfg = _json(find_file("configs", name, ".json", bases))
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself "
                         f"{cfg.get('name')!r}")
    return cfg


def load_traffic(name: str, bases: Sequence[Path] = (HERE,)) -> dict:
    mix = _json(find_file("traffic", name, ".json", bases))
    if mix.get("order") not in ("static", "shuffled"):
        raise ValueError(f"traffic {name}: order must be static or "
                         f"shuffled")
    if mix.get("device_tier") not in ("all", "deployment"):
        raise ValueError(f"traffic {name}: device_tier must be all or "
                         f"deployment")
    return mix


def plugin(kind: str, name: str, bases: Sequence[Path] = (HERE,)):
    """``<base>/<kind>/<name>.py`` as a module."""
    path = find_file(kind, name, ".py", bases)
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def deployment_share(cfg: dict) -> float:
    """The device tier's share of the published dataset."""
    record = cfg.get("stored_record_bytes", cfg["record_length_bytes"])
    full = (cfg["published"]["num_files_train"] * cfg["num_samples_per_file"]
            * record)
    return min(1.0, cfg["device_tier_bytes"] / full)


def tier_bytes(cfg: dict, mix: dict, nbytes: int) -> int:
    if mix["device_tier"] == "all":
        return nbytes + TIER_SLACK
    return int(nbytes * deployment_share(cfg))


# -- the window's instruments -------------------------------------------------
@dataclass
class Ctx:
    """What a consumer is given: the cell's files, the seed, the device
    and the generated dataset."""

    cfg: dict
    mix: dict
    seed: int
    device: object
    data: object
    _orders: Dict[int, list] = field(default_factory=dict)

    def block_order(self, epoch: int) -> list:
        """Static block indices in the order epoch ``epoch`` visits them,
        worked out from the traffic and the seed."""
        if epoch not in self._orders:
            self._orders[epoch] = block_order(
                self.mix["order"], self.seed, epoch, len(self.data.blocks))
        return self._orders[epoch]


class Waits:
    """Wraps an iterator: the host time spent in each ``next()``, under a
    ``bench.wait`` range, summed while ``on``."""

    def __init__(self) -> None:
        self.on = False
        self.total = 0.0

    def __call__(self, it):
        import torch

        while True:
            t = time.perf_counter()
            with torch.profiler.record_function("bench.wait"):
                try:
                    item = next(it)
                except StopIteration:
                    return
            if self.on:
                self.total += time.perf_counter() - t
            yield item


class Steps:
    """A completion mark after each step's consumer work: a CUDA event on
    the current stream (the host clock on the CPU), with at most
    ``max_inflight`` steps left unfinished on the device."""

    def __init__(self, device, max_inflight: int) -> None:
        self._cuda = device.type == "cuda"
        self._max = max(1, max_inflight)
        self._marks: list = []
        self._inflight: deque = deque()

    def mark(self) -> None:
        if not self._cuda:
            self._marks.append(time.perf_counter())
            return
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._marks.append(ev)
        self._inflight.append(ev)
        while len(self._inflight) > self._max:
            self._inflight.popleft().synchronize()

    def __len__(self) -> int:
        return len(self._marks)

    def intervals_ms(self, upto: Optional[int] = None) -> List[float]:
        """Intervals between consecutive completions among the first
        ``upto`` marks, or all (after a sync)."""
        m = self._marks[:upto]
        if self._cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


@dataclass
class Run:
    """One window, as the metric readers see it."""

    cfg: dict
    setup_s: float
    window_s: float
    samples: int
    steps: int
    wait_s: float
    #: step completion intervals before the traced slice (all of them in
    #: an untraced window)
    intervals_ms: List[float]
    counters: Dict[str, float]
    events: Optional[List[dict]]
    #: the device memory the program held at its peak (the allocator's
    #: count from after the dataset was generated)
    peak_bytes: int = 0


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _counters() -> Dict[str, float]:
    from alluxio_tpu_torch.metrics import metrics

    return {k: v for k, v in metrics().snapshot().items()
            if isinstance(v, (int, float))}


# -- one run ------------------------------------------------------------------
def run_cell(bench: dict, cell: dict, *, seed: int, seconds: float,
             trace: bool, device, t0: float,
             bases: Sequence[Path] = (HERE,), control: bool = False) -> dict:
    """Set up the cell, measure one window, compare with the reference.
    Returns the pieces of the result line (and, with ``control``, the
    control's compared numbers)."""
    import torch

    entered = time.perf_counter()
    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.minicluster import LocalCluster
    from alluxio_tpu_torch.prefetch import PrefetchService

    cfg = load_config(cell["config"], bases)
    mix = load_traffic(cell["traffic"], bases)
    fmt = plugin("formats", cfg["format"], bases)
    consumer_mod = plugin("consumers", cfg["consumer"], bases)
    workdir = tempfile.mkdtemp(prefix="atpu-bench-")
    cluster = fs = svc = loader = None
    phases = {"start": entered - t0,
              "import_port": time.perf_counter() - entered}
    mark = time.perf_counter()

    def phase(name: str) -> None:
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    try:
        data = fmt.make(cfg, seed, device)
        _sync(device)
        phase("generate")
        if device.type == "cuda":
            # the peak of the program's run, not of the generator's
            torch.cuda.reset_peak_memory_stats(device)
        cluster = LocalCluster(
            os.path.join(workdir, "cluster"), num_workers=1,
            block_size=cfg["block_size_bytes"],
            worker_mem_bytes=data.nbytes + WORKER_SLACK,
            conf_overrides=mix.get("conf") or {},
            start_worker_heartbeats=True).start()
        fs = cluster.file_system()
        phase("cluster")
        for path, arr in zip(data.paths, data.host):
            fs.write_all(path, arr, write_type=WriteType.MUST_CACHE)
        phase("write")
        svc = PrefetchService.from_conf(cluster.conf, fs, data.paths,
                                        seed=seed)
        if (svc is not None) != (mix["order"] == "shuffled"):
            raise ValueError("a shuffled order is the prefetch service's "
                             "(atpu.prefetch.enabled), a static one the "
                             "loader's own")
        tier = tier_bytes(cfg, mix, data.nbytes)
        loader = DeviceBlockLoader(fs, data.paths, device=device,
                                   hbm_bytes=tier,
                                   dtype=consumer_mod.Consumer.dtype,
                                   prefetch_service=svc)
        if svc is not None:
            svc.start()
        consumer = consumer_mod.Consumer(Ctx(cfg, mix, seed, device, data))
        phase("loader")
        wait = Waits()
        for e in range(WARMUP_EPOCHS):
            for _ in consumer.epoch(loader, e, wait, keep=False):
                pass
        _sync(device)
        phase("warmup")
        tracer = None
        if trace:
            devtrace.Slice.warm_up(device)
            tracer = devtrace.Slice(workdir)
            phase("profiler")
        steps = Steps(device, MAX_INFLIGHT)
        before = _counters()
        wait.on = True
        samples = n_steps = 0
        epoch, done, traced = WARMUP_EPOCHS, False, False
        untraced = None
        t_start = time.perf_counter()
        cpu_start = time.process_time()
        deadline = t_start + seconds
        trace_at = t_start + max(0.0, seconds - TRACE_SECONDS)
        while not done:
            gen = consumer.epoch(loader, epoch, wait, keep=True)
            for n in gen:
                steps.mark()
                samples += n
                n_steps += 1
                now = time.perf_counter()
                if tracer is not None and not traced and now >= trace_at:
                    untraced = len(steps)
                    tracer.start(device)
                    traced = True
                if now >= deadline:
                    done = True
                    break
            gen.close()
            epoch += 1
        _sync(device)
        t_end = time.perf_counter()
        cpu_s = time.process_time() - cpu_start
        wait.on = False
        events = tracer.stop(device) if traced else None
        after = _counters()
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
        run = Run(cfg=cfg, setup_s=t_start - t0,
                  window_s=t_end - t_start, samples=samples, steps=n_steps,
                  wait_s=wait.total,
                  intervals_ms=steps.intervals_ms(untraced),
                  counters={k: v - before.get(k, 0)
                            for k, v in after.items()},
                  events=events, peak_bytes=peak)
        consumer.finish()
    finally:
        if svc is not None:
            svc.close()
        if loader is not None:
            loader.close()
        if fs is not None:
            fs.close()
        if cluster is not None:
            cluster.stop()
        shutil.rmtree(workdir, ignore_errors=True)
    del loader, svc, fs, cluster
    if device.type == "cuda":
        torch.cuda.empty_cache()
    phases["window"] = run.window_s
    # the process's CPU seconds over the window, every thread's
    phases["window_cpu"] = cpu_s
    mark = time.perf_counter()
    checks, _, wrong = consumer.check()
    phase("check")
    out = {"run": run, "checks": checks, "wrong": wrong, "peak": peak,
           "phases": phases}
    if control:
        out["control"] = consumer.check(control=True)[0]
    return out


def result_line(bench: dict, cell: dict, res: dict, *, trace: bool,
                device, bases: Sequence[Path] = (HERE,)) -> dict:
    """The last line of standard output."""
    import torch

    run = res["run"]
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell["name"], section):
        value = plugin("metrics", m["name"], bases).read(run)
        if value is None:
            # on the card every end-to-end metric is read; without one, a
            # device metric has nothing to read and is left out
            if section == "end_to_end" and device.type == "cuda":
                raise RuntimeError(f"{m['name']}: the run gave nothing to "
                                   f"read")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": int(res["peak"])}
    line = {"correct": all(v <= lim for v, lim in res["checks"].values()),
            "attempted": run.steps, "failed": res["wrong"],
            "metrics": metrics, "device": dev}
    if trace and run.events is not None:
        b = devtrace.bounds(run.events)
        if b is not None:
            dev["busy_s"] = devtrace.busy_us(run.events, *b) / 1e6
            dev["window_s"] = (b[1] - b[0]) / 1e6
        bd = devtrace.breakdown(run.events)
        if bd is not None:
            line["breakdown"] = bd
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in res["checks"].items()}
    return line


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def main(argv: List[str], t0: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_bench()
    cell = find_cell(bench, args.workload)

    import torch

    imported = time.perf_counter() - t0
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = run_cell(bench, cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device=device, t0=t0)
    line = result_line(bench, cell, res, trace=bool(args.trace),
                       device=device)
    # read after the window, so that set-up does not pay for it
    print(f"benchmark: {args.workload} seed {args.seed} on "
          f"{power_limit()}, torch {torch.__version__}", file=sys.stderr)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    print(f"benchmark: seconds by phase import_torch {imported:.3f} " +
          " ".join(f"{k} {v:.3f}" for k, v in res["phases"].items()),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
