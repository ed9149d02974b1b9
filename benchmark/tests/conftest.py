"""A tiny configuration and throwaway traffic mixes written to a
temporary directory, found by the harness ahead of the benchmark's own
files, and a benchmark description whose cells use them: the harness
runs on the CPU at these sizes, over every order and device-tier share
its mixes can state."""

import json

import pytest

from benchmark import harness

#: tiny stand-ins for each configuration: the same keys, small sizes
TINY = {
    "tinyimg": ("resnet50", {
        "num_files_train": 3, "num_samples_per_file": 50, "height": 8,
        "width": 8, "stored_record_bytes": 196, "block_size_bytes": 4096,
        "batch_size": 16, "device_tier_bytes": 3000,
        "published": {"num_files_train": 3}}),
}
#: throwaway mixes beside the benchmark's own: the device tier holding
#: every block, and the prefetch oracle's shuffled order with the
#: prefetch loop placing blocks ahead or (budget 0) bypassed
PREFETCH = {"atpu.prefetch.enabled": "true",
            "atpu.prefetch.lookahead.blocks": "16",
            "atpu.prefetch.hbm.fraction": "0.25",
            "atpu.prefetch.heartbeat.interval.ms": "100ms"}
MIXES = {
    "warm": {"why": "tiny: the tier holds every block", "order": "static",
             "device_tier": "all", "conf": {}},
    "shuffle": {"why": "tiny: shuffled, nothing placed ahead",
                "order": "shuffled", "device_tier": "deployment",
                "conf": dict(PREFETCH, **{"atpu.prefetch.budget.bytes": "0"})},
    "prefetch": {"why": "tiny: shuffled, placed ahead",
                 "order": "shuffled", "device_tier": "deployment",
                 "conf": dict(PREFETCH,
                              **{"atpu.prefetch.budget.bytes": "64KB"})},
}
#: tiny cell -> the benchmark cell whose metrics it takes (None: only the
#: metrics every cell reports)
CELLS = {"tinyimg.stream": "resnet50.stream", "tinyimg.warm": None,
         "tinyimg.shuffle": None, "tinyimg.prefetch": None}


@pytest.fixture
def tiny_base(tmp_path):
    (tmp_path / "configs").mkdir()
    for name, (real, over) in TINY.items():
        cfg = harness.load_config(real)
        cfg.update(over, name=name)
        (tmp_path / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic").mkdir()
    for name, mix in MIXES.items():
        (tmp_path / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    return tmp_path


@pytest.fixture
def tiny_bench():
    """BENCHMARK.json with its cells swapped for tiny ones, one for each
    traffic mix: the benchmark's and the throwaway ones."""
    bench = harness.load_bench()
    bench["workloads"] = [
        {"name": t, "config": t.split(".")[0], "traffic": t.split(".")[1],
         "chips": 1, "why": f"tiny {t}"} for t, r in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [t for t, r in CELLS.items()
                              if r in m["workloads"]]
    return bench


def run_tiny(bench, base, cell_name, *, seconds=0.5, trace=False,
             control=False, seed=2**31 + 77):
    import time

    import torch

    cell = harness.find_cell(bench, cell_name)
    res = harness.run_cell(bench, cell, seed=seed, seconds=seconds,
                           trace=trace, device=torch.device("cpu"),
                           t0=time.perf_counter(),
                           bases=(base, harness.HERE), control=control)
    line = harness.result_line(bench, cell, res, trace=trace,
                               device=torch.device("cpu"),
                               bases=(base, harness.HERE))
    return res, line
