"""The port's stress CLI against the JAX package's, on the CPU.

- ``build_parser()`` has JAX's subcommands and options, without the
  benches the port refuses (``qos``, ``ha``); each of those is refused
  with exit code 1 and the ROADMAP item that brings it; ``SUITE`` is
  JAX's without those benches' rows; each suite row of the ``obs``,
  ``health`` and ``selfheal`` benches reaches its bench function with
  the keyword arguments JAX's CLI passes;
- ``make_tfrecord_shard`` gives the same bytes for one seed, and
  ``render_report`` the same HTML for the same records;
- ``run_suite`` runs each row in a child process of the port's CLI, keeps
  JAX's isolation (``os.sync`` and a 4 s sleep between rows), records a
  failed row with its child's stderr tail and exits 1;
- the CLI attaches to a live cluster with ``--master`` (through the shell
  too, as ``--master=host:port``);
- the metadata bench's capacity child runs at a tiny namespace with no
  cap and prints JAX's keys, and the capacity row at a small namespace
  under a cap sees HEAP run out of memory and LSM finish.
"""

import importlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
JAX, PORT = PACKAGES
REFUSED = {"qos": "Admission and audit", "ha": "HA"}
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _cli(pkg):
    return _mod(pkg, "stress.__main__")


def _subparsers(parser):
    import argparse

    (action,) = [a for a in parser._actions
                 if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _options(sub):
    return [(tuple(a.option_strings), a.dest, a.default, a.choices,
             getattr(a.type, "__name__", a.type), a.nargs, a.const,
             a.required, a.metavar, a.help, type(a).__name__)
            for a in sub._actions]


# -- parser, suite and refusals -------------------------------------------------
def test_parser_is_jax_minus_the_refused_benches():
    jax_subs = _subparsers(_cli(JAX).build_parser())
    port_parser = _cli(PORT).build_parser()
    port_subs = _subparsers(port_parser)
    assert port_parser.prog == _cli(JAX).build_parser().prog
    assert list(port_subs) == [n for n in jax_subs if n not in REFUSED]
    assert set(REFUSED) <= set(jax_subs)
    for name, sub in port_subs.items():
        assert _options(sub) == _options(jax_subs[name]), name


def test_suite_is_jax_minus_the_refused_rows():
    jax_suite = _cli(JAX).SUITE
    port_suite = _cli(PORT).SUITE
    assert port_suite == tuple(row for row in jax_suite
                               if row[1][0] not in REFUSED)
    assert {row[1][0] for row in jax_suite} - {
        row[1][0] for row in port_suite} == set(REFUSED)
    assert _cli(PORT)._NOT_PORTED == REFUSED
    assert _cli(PORT).HOST_CALIBRATION_BENCH == \
        _cli(JAX).HOST_CALIBRATION_BENCH


@pytest.mark.parametrize("bench", sorted(REFUSED))
def test_refused_bench_names_its_roadmap_item(bench, capsys):
    assert _cli(PORT).main([bench, "--row", "x"]) == 1
    err = capsys.readouterr().err
    item = re.search(r"ROADMAP item '([^']+)'", err).group(1)
    assert err.startswith(f"{bench}: not ported yet")
    assert item == REFUSED[bench]
    assert item in open(os.path.join(ROOT, "ROADMAP.md")).read()


#: the suite rows of the benches this slice ported, with the module and
#: function each dispatches to
OBS_ROWS = {"obs-tracing-overhead": ("obs_bench", "run"),
            "obs-profile-overhead": ("obs_bench", "run_profile_overhead"),
            "obs-critical-path": ("obs_bench", "run_critical_path"),
            "health-ingest-overhead": ("health_bench", "run"),
            "selfheal-remediation": ("selfheal_bench", "run")}


@pytest.mark.parametrize("row", sorted(OBS_ROWS))
def test_ported_bench_row_dispatches_like_jax(row, monkeypatch, capsys):
    """The suite row's arguments reach the same bench function with the
    same keyword arguments in both CLIs (the function is replaced by one
    that records them)."""
    module, fn = OBS_ROWS[row]
    (argv,) = [a for name, a in _cli(JAX).SUITE if name == row]
    got = {}
    for pkg in PACKAGES:
        base = _mod(pkg, "stress.base")

        def record(_pkg=pkg, _base=base, **kw):
            got[_pkg] = kw
            return _base.BenchResult(bench=row, params={}, metrics={},
                                     errors=0, duration_s=0.0)

        monkeypatch.setattr(_mod(pkg, f"stress.{module}"), fn, record)
        assert _cli(pkg).main(list(argv)) == 0
    assert got[PORT] == got[JAX]
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line)["bench"] for line in lines] == [row, row]


def test_table_master_is_refused(capsys):
    assert _cli(PORT).main(["table", "--master", "h:1"]) == 2
    assert "in-process only" in capsys.readouterr().err


# -- byte parity ---------------------------------------------------------------
@pytest.mark.parametrize("seed,size,record", [(0, 1 << 20, 12 << 10),
                                              (1, 300_001, 1024),
                                              (2, 64 << 10, 100_000)])
def test_tfrecord_shard_equal(seed, size, record):
    shards = [_mod(pkg, "stress.worker_bench").make_tfrecord_shard(
        np.random.default_rng(seed), size, record_bytes=record)
        for pkg in PACKAGES]
    assert shards[1] == shards[0]
    assert len(shards[0]) == size


def _records(seed: int) -> list:
    rng = np.random.default_rng(seed)
    keys = ("gb_per_s", "mb_per_s", "ops_per_s", "projection_mb_per_s",
            "p50_us", "p99_us", "speedup", "gate_ok", "note")
    out = []
    for i in range(int(rng.integers(3, 12))):
        metrics = {}
        for k in rng.choice(keys, size=int(rng.integers(1, 6)),
                            replace=False):
            metrics[str(k)] = (bool(rng.random() < 0.5) if k == "gate_ok"
                               else "<b>&" if k == "note"
                               else float(rng.uniform(0, 1e4)))
        metrics["nested"] = {"1": float(rng.random())}
        out.append({"bench": f"bench-{i}<x>", "errors": int(rng.random()
                                                             < 0.2),
                    "params": {"threads": int(rng.integers(1, 9))},
                    "metrics": metrics,
                    "duration_s": float(rng.uniform(0, 10))})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_render_report_equal(seed):
    recs = _records(seed)
    pages = [_mod(pkg, "stress.report").render_report(recs)
             for pkg in PACKAGES]
    assert pages[1] == pages[0]
    assert "<svg" in pages[0] or not any(
        "_per_s" in k for r in recs for k in r["metrics"])


def test_report_main_reads_array_and_jsonl(tmp_path):
    recs = _records(5)
    src = tmp_path / "suite.json"
    src.write_text(json.dumps(recs))
    jsonl = tmp_path / "suite.jsonl"
    jsonl.write_text("[suite] running x ...\n" + "\n".join(
        json.dumps(r) for r in recs))
    pages = []
    for pkg in PACKAGES:
        for i, path in enumerate((src, jsonl)):
            out = tmp_path / f"{pkg}-{i}.html"
            assert _mod(pkg, "stress.report").main(
                ["--input", str(path), "--out", str(out)]) == 0
            pages.append(out.read_text())
    assert len(set(pages)) == 1
    assert _cli(PORT).main(["report", "--input", str(tmp_path / "none"),
                            "--out", str(tmp_path / "x.html")]) == 1


# -- the suite -----------------------------------------------------------------
def test_run_suite_keeps_jax_isolation_and_records_failures(monkeypatch,
                                                            tmp_path):
    """Two toy rows and a row whose child fails: each row runs in a
    child process of the port's CLI from any working directory, the rows
    are separated by ``os.sync`` and a 4 s sleep, the failed row carries
    its child's stderr tail, and ``main(["suite"])`` exits 1."""
    import time

    cli = _cli(PORT)
    monkeypatch.setattr(cli, "SUITE", (
        ("worker-random-4k", ["worker", "--mode", "random", "--threads",
                              "1", "--duration", "0.2", "--shard-mb", "1",
                              "--num-shards", "1"]),
        ("metadata-broken", ["metadata", "--row", "no-such-row"]),
        ("master-GetStatus", ["master", "--op", "GetStatus", "--threads",
                              "1", "--duration", "0.2",
                              "--fixed-count", "5"]),
    ))
    sleeps, syncs = [], []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    monkeypatch.setattr(os, "sync", lambda: syncs.append(1))
    monkeypatch.chdir(tmp_path)
    results = cli.run_suite()
    assert [r.bench for r in results] == [
        cli.HOST_CALIBRATION_BENCH, "worker-random", "metadata-broken",
        "master-GetStatus"]
    assert results[0].metrics["python_10m_adds_ms"] > 0
    assert [r.errors for r in results] == [0, 0, 1, 0]
    assert "invalid choice" in results[2].metrics["child_stderr_tail"]
    assert sleeps == [4, 4] and len(syncs) == 2
    assert os.listdir(tmp_path) == []
    monkeypatch.setattr(cli, "run_suite", lambda: results)
    assert cli.main(["suite"]) == 1


# -- a live cluster ------------------------------------------------------------
def test_cli_attaches_to_a_live_cluster(tmp_path, capsys):
    """``--master`` gives the bench a client of the live cluster (the
    params say so) instead of an in-process cluster; through the shell
    the option is written ``--master=host:port``, since the shell's own
    generic ``--master`` takes the next argument."""
    from alluxio_tpu_torch.minicluster import LocalCluster
    from alluxio_tpu_torch.shell import main as shell

    with LocalCluster(str(tmp_path), num_workers=1, block_size=1 << 20,
                      worker_mem_bytes=16 << 20) as cluster:
        addr = cluster.master.address
        assert _cli(PORT).main(["master", "--op", "GetStatus", "--master",
                                addr, "--threads", "2", "--duration", "0.3",
                                "--fixed-count", "5"]) == 0
        assert shell.main(["stress", "worker", f"--master={addr}",
                           "--threads", "1", "--duration", "0.3",
                           "--shard-mb", "1", "--num-shards", "2"]) == 0
        rows = [json.loads(line) for line in
                capsys.readouterr().out.strip().splitlines()]
        fs = cluster.file_system()
        try:
            listed = sorted(i.name for i in fs.list_status("/stress-worker"))
        finally:
            fs.close()
    assert [r["bench"] for r in rows] == ["master-GetStatus",
                                          "worker-random"]
    assert all(r["params"]["master"] == addr for r in rows)
    assert all(r["errors"] == 0 and r["metrics"]["ops_per_s"] > 0
               for r in rows)
    assert listed == ["shard-00000.tfrecord", "shard-00001.tfrecord"]


# -- the capacity child --------------------------------------------------------
def _capacity_child(pkg, tmp_path, kind):
    import resource

    code = ("import sys; "
            f"from {pkg}.stress.metadata_bench import _capacity_child; "
            "_capacity_child(); "
            "print(sorted(m for m in ('torch', 'jax', 'numpy') "
            "if m in sys.modules))")
    d = tmp_path / f"{pkg}-{kind}"
    proc = subprocess.run(
        [sys.executable, "-c", code, kind, str(d), "2500",
         str(resource.RLIM_INFINITY), "100", "300", "7"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    row, loaded = proc.stdout.strip().splitlines()
    return json.loads(row), loaded


@pytest.mark.parametrize("kind", ["HEAP", "LSM"])
def test_capacity_child_prints_the_jax_keys(tmp_path, kind):
    rows = {}
    for pkg in PACKAGES:
        rows[pkg], loaded = _capacity_child(pkg, tmp_path, kind)
        if pkg == PORT:
            assert loaded == "[]"  # no torch, no jax, not even numpy
    assert set(rows[PORT]) == set(rows[JAX])
    assert set(rows[PORT]["store"]) == set(rows[JAX]["store"])
    for key in ("kind", "ok", "oom", "built", "edges", "missing"):
        assert rows[PORT][key] == rows[JAX][key], key
    assert rows[PORT]["ok"] and rows[PORT]["built"] == 2500


def test_lsm_capacity_row_heap_runs_out_and_lsm_finishes():
    """The row's gate at a small namespace: under a 256 MiB address-space
    cap HEAP runs out of memory before 350 000 inodes and LSM (its hot
    set capped at 100 000 inodes) builds, walks and stats all of them."""
    from alluxio_tpu_torch.stress.metadata_bench import run

    r = run(row="lsm-capacity", inodes=350_000, cap_mb=256, sample=2000)
    m = r.metrics
    assert r.errors == 0, r.json_line()
    assert m["heap_oom"] and m["lsm_ok"] and m["gate_ok"]
    assert 0 < m["heap_built_before_oom"] < 350_000
    assert m["lsm_flushes"] > 0 and m["lsm_runs"] > 0
