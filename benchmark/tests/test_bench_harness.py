"""The harness finds everything by name, meets the benchmark's contract,
refuses to run without a card, imports nothing of JAX, and decides
``correct`` from the comparison: true on the program, false under each
fault a cell can have."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS, run_tiny

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files_by_name():
    bench = harness.load_bench()
    for cell in bench["workloads"]:
        cfg = harness.load_config(cell["config"])
        mix = harness.load_traffic(cell["traffic"])
        harness.plugin("formats", cfg["format"])
        harness.plugin("consumers", cfg["consumer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.plugin("metrics", m["name"]).read)


def test_a_throwaway_config_and_mix_are_found_without_an_edit(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    cfg = dict(harness.load_config("resnet50"), name="scratchcfg")
    (tmp_path / "configs" / "scratchcfg.json").write_text(json.dumps(cfg))
    mix = dict(harness.load_traffic("stream"), device_tier="all")
    (tmp_path / "traffic" / "scratchmix.json").write_text(json.dumps(mix))
    bases = (tmp_path, harness.HERE)
    assert harness.load_config("scratchcfg", bases)["name"] == "scratchcfg"
    assert harness.load_traffic("scratchmix", bases)["device_tier"] == "all"
    # the benchmark's own files stay reachable behind the throwaway ones
    assert harness.load_traffic("stream", bases)["device_tier"] == \
        "deployment"
    with pytest.raises(FileNotFoundError):
        harness.load_config("scratchcfg")


def test_benchmark_json_meets_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        on_file = json.loads((ROOT / c["file"]).read_text())
        assert on_file["source"] == c["source"]
        assert on_file["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        used.add(w["config"])
        reports = [m for m in bench["end_to_end"]
                   if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in bench["per_layer"])
    assert used == set(configs)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_run_exits_non_zero_and_prints_nothing_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "resnet50.stream",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_and_the_reference_nothing_of_the_port():
    for path in harness.HERE.rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "alluxio_tpu"}, path
        if "reference" in path.relative_to(harness.HERE).parts:
            assert not tops & {"alluxio_tpu_torch", "torch"}, path


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_cpu_run_is_correct_and_reads_its_metrics(tiny_base, tiny_bench,
                                                    cell):
    res, line = run_tiny(tiny_bench, tiny_base, cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    want = {m["name"] for m in harness.cell_metrics(tiny_bench, cell,
                                                    "end_to_end")}
    # the device's memory has nothing to read on the CPU
    assert set(line["metrics"]) == want - {"device_memory_peak_gb"}
    assert list(line)[-1] == "checks"
    assert not harness.forbidden_modules()


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_control_fails_the_comparison(tiny_base, tiny_bench, cell):
    res, line = run_tiny(tiny_bench, tiny_base, cell, control=True)
    assert line["correct"]
    assert any(v > lim for v, lim in res["control"].values()), \
        res["control"]


def _alter_one_answer(monkeypatch):
    """A wrong answer where it is produced: one label of every fifth
    decoded batch."""
    import alluxio_tpu_torch.ops.decode as dec

    calls = {"n": 0}
    real = dec.decode_image_records

    def decode(*a, **k):
        imgs, labels = real(*a, **k)
        calls["n"] += 1
        if calls["n"] % 5 == 3:
            labels = labels.clone()
            labels[1] += 1
        return imgs, labels
    monkeypatch.setattr(dec, "decode_image_records", decode)


def _drop_half_the_batch(monkeypatch):
    """Half of each batch left out."""
    import alluxio_tpu_torch.ops.decode as dec

    real = dec.decode_image_records
    monkeypatch.setattr(
        dec, "decode_image_records",
        lambda recs, **k: real(recs[: recs.shape[0] // 2], **k))


def _flip_a_byte_in_the_copy(monkeypatch):
    """A block's bytes altered on their way to the device."""
    import alluxio_tpu_torch.client.torch_io as tio

    real = tio.host_to_device

    def h2d(host, device):
        out = real(host, device)
        flat = out.view(-1)
        flat[len(flat) // 3] += 1
        return out
    monkeypatch.setattr(tio, "host_to_device", h2d)


@pytest.mark.parametrize("fault", [_alter_one_answer, _drop_half_the_batch,
                                   _flip_a_byte_in_the_copy])
@pytest.mark.parametrize("cell", ["tinyimg.stream", "tinyimg.shuffle"])
def test_a_broken_timed_path_reads_not_correct(tiny_base, tiny_bench,
                                               monkeypatch, fault, cell):
    fault(monkeypatch)
    res, line = run_tiny(tiny_bench, tiny_base, cell)
    assert not line["correct"], line["checks"]
    assert line["failed"] > 0
