"""The port's static lint (``alluxio_tpu_torch/lint/``) against the JAX
package's, on the CPU:

- ``python -m alluxio_tpu_torch.lint`` exits 0 on the tree inside its
  30 s budget with an empty baseline: the eleven keys it once held as
  dead (FUSE, the proxy, the log server, the stripe budget) are read;
- every seeded fixture under ``tests/testutils/lint_fixtures/`` gives the
  same ``(rule, line, anchor)`` sets under both packages' analyzers;
- a seeded violation written under ``tmp_path`` exits 1, its clean twin 0;
- the budget gate exits 2; the port's lint opens nothing under ``docs/``
  (nor ``README.md`` or ``ROADMAP.md``);
- ``native-abi`` diffs the port's own library: ``exported_symbols``
  names the ``_PROTOTYPES`` set, as JAX's names its own.
"""

import builtins
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

ROOT = Path(__file__).resolve().parents[1]
FX = "tests/testutils/lint_fixtures"
FIXTURES = sorted(p.name for p in (ROOT / FX).glob("fx_*.py"))
PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
BASELINE = ROOT / "alluxio_tpu_torch/lint/baseline.json"
#: the keys the baseline once held as dead, until their readers (FUSE,
#: the proxy, the log server, the stripe budget) were ported
DEAD_UNTIL_5D = (
    "atpu.fuse.fs.root", "atpu.fuse.mount.options", "atpu.fuse.mount.point",
    "atpu.logserver.bind.host", "atpu.logserver.hostname",
    "atpu.logserver.logs.dir", "atpu.logserver.port",
    "atpu.proxy.bind.host", "atpu.proxy.s3.root", "atpu.proxy.web.port",
    "atpu.user.qos.stripe.limit")


def _lint(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.lint.{name}")


def _cli(*argv, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "-m", "alluxio_tpu_torch.lint", *argv], cwd=cwd,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)})


def _triples(findings):
    return sorted((f.rule, f.line, f.anchor) for f in findings)


# -- the shipped tree ----------------------------------------------------------
def test_port_lint_exits_zero_within_its_budget():
    r = _cli()
    assert r.returncode == 0, r.stdout + r.stderr
    m = re.search(r"lint: (\d+) new finding\(s\) \[none\], (\d+) suppressed, "
                  r"(\d+) baselined, (\d+) stale baseline entr\(ies\) in "
                  r"([0-9.]+)s", r.stdout)
    assert m, r.stdout
    new, _, baselined, stale, seconds = m.groups()
    assert (int(new), int(baselined), int(stale)) == (0, 0, 0)
    assert float(seconds) < 30.0


def test_baseline_is_only_the_item_5d_dead_keys():
    """The baseline held only the eleven keys of the serving surfaces;
    with their readers ported it holds nothing, and none of the eleven
    is dead."""
    assert json.loads(BASELINE.read_text())["entries"] == []
    report = _lint(PACKAGES[1], "runner").run_lint(
        str(ROOT), analyzers=["conf-keys"])
    dead = {f.anchor for f in report.findings if f.rule == "conf-dead-key"}
    assert dead.isdisjoint(DEAD_UNTIL_5D), sorted(dead)


def test_full_tree_reports_nothing_new():
    report = _lint(PACKAGES[1], "runner").run_lint(
        str(ROOT), baseline_path=str(BASELINE))
    assert report.ok, "\n".join(f.render() for f in
                                report.new + report.bad_suppressions)
    assert report.stale_baseline == []
    assert report.baselined == []
    # every cataloged phase has an emit site: the three repaired phases
    assert not [f for f in report.findings if f.rule.startswith("phase-")]
    # a copied suppression stands only where JAX has the same one
    jax_supp = {(f.rule, f.path.replace("alluxio_tpu/", ""), f.anchor)
                for f in _lint(PACKAGES[0], "runner").run_lint(
                    str(ROOT), analyzers=["metric-names", "exceptions"])
                .suppressed}
    for f in report.suppressed:
        assert (f.rule, f.path.replace("alluxio_tpu_torch/", ""),
                f.anchor) in jax_supp, f.render()


# -- fixtures: both packages alike ---------------------------------------------
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_findings_equal_jax(name):
    path = f"{FX}/{name}"
    got = {}
    for pkg in PACKAGES:
        rep = _lint(pkg, "runner").run_lint(
            str(ROOT), only_paths={path}, extra_py=[path])
        got[pkg] = (_triples(rep.new), _triples(rep.suppressed),
                    _triples(rep.bad_suppressions))
    assert got[PACKAGES[1]] == got[PACKAGES[0]]
    new, suppressed, bad = got[PACKAGES[1]]
    assert new or bad, f"{name} seeds no finding"


def test_fixture_rule_counts_match_the_jax_tests():
    """The exact counts ``tests/test_lint.py`` pins, on the port."""
    run = _lint(PACKAGES[1], "runner").run_lint

    def rules(name, analyzer):
        path = f"{FX}/{name}"
        rep = run(str(ROOT), analyzers=[analyzer], only_paths={path},
                  extra_py=[path])
        return sorted(f.anchor for f in rep.new), len(rep.suppressed)

    assert rules("fx_conf_keys.py", "conf-keys") == \
        (["atpu.master.rpcc.port"], 1)
    assert rules("fx_metrics.py", "metric-names") == \
        (["Client.PrefetchFixtureHitz",
          "Worker.CompletelyUnregisteredSeries"], 0)
    anchors, supp = rules("fx_locks.py", "lock-discipline")
    assert sorted(a.split(":")[-1] for a in anchors) == \
        ["channel.call", "fut.result", "time.sleep"] and supp == 1
    anchors, supp = rules("fx_excepts.py", "exceptions")
    assert len(anchors) == 1 and anchors[0].startswith("bad_silent")


# -- the command line ----------------------------------------------------------
SEEDED = '''import threading
import time

_lock = threading.Lock()
KEY = "atpu.master.rpcc.port"


def hold_and_sleep():
    with _lock:
        time.sleep(1)
'''
CLEAN = '''import threading

_lock = threading.Lock()
KEY = "atpu.master.rpc.port"


def hold_briefly():
    with _lock:
        return 1
'''


def test_seeded_violation_exits_one(tmp_path):
    (tmp_path / "seeded.py").write_text(SEEDED)
    (tmp_path / "clean.py").write_text(CLEAN)
    r = _cli("--root", str(tmp_path), "--no-baseline", "seeded.py")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "[lock-blocking-call]" in r.stdout
    assert "[conf-unknown-key]" in r.stdout
    r = _cli("--root", str(tmp_path), "--no-baseline", "clean.py")
    assert r.returncode == 0, r.stdout + r.stderr


def test_budget_gate_exits_two():
    r = _cli("--budget-s", "0.000001", "--rule", "lock-discipline",
             "--no-baseline", f"{FX}/fx_excepts.py")
    assert r.returncode == 2
    assert "BUDGET EXCEEDED" in r.stderr
    assert _lint(PACKAGES[1], "runner").DEFAULT_BUDGET_S == 30.0


def test_baseline_round_trip_equals_jax(tmp_path):
    path = f"{FX}/fx_locks.py"
    texts = []
    for pkg in PACKAGES:
        run = _lint(pkg, "runner").run_lint
        rep = run(str(ROOT), analyzers=["lock-discipline"],
                  only_paths={path}, extra_py=[path])
        out = tmp_path / f"{pkg}.json"
        _lint(pkg, "findings").Baseline.write(str(out), rep.new, "frozen")
        again = run(str(ROOT), analyzers=["lock-discipline"],
                    only_paths={path}, extra_py=[path],
                    baseline_path=str(out))
        assert again.ok and len(again.baselined) == 3
        texts.append(out.read_text())
    assert texts[1] == texts[0]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"entries": [{"id": "x:y:z",
                                            "justification": " "}]}))
    with pytest.raises(ValueError, match="justification"):
        _lint(PACKAGES[1], "findings").Baseline.load(str(bad))


def test_port_lint_reads_no_docs(monkeypatch):
    opened = []
    real_open, real_walk = builtins.open, os.walk

    def spy_open(file, *a, **kw):
        opened.append(os.path.abspath(os.fspath(file))
                      if isinstance(file, (str, os.PathLike)) else file)
        return real_open(file, *a, **kw)

    def spy_walk(top, *a, **kw):
        opened.append(os.path.abspath(os.fspath(top)))
        return real_walk(top, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy_open)
    monkeypatch.setattr(os, "walk", spy_walk)
    rep = _lint(PACKAGES[1], "runner").run_lint(
        str(ROOT), baseline_path=str(BASELINE))
    monkeypatch.undo()
    assert rep.ok
    paths = [p for p in opened if isinstance(p, str)]
    assert any(p.endswith("alluxio_tpu_torch/master/file_master.py")
               for p in paths)
    docs = str(ROOT / "docs")
    assert not [p for p in paths if p == docs or p.startswith(docs + os.sep)
                or p.endswith(("README.md", "ROADMAP.md"))]
    assert not [p for p in paths if p.startswith(str(ROOT / "alluxio_tpu")
                                                 + os.sep)]


# -- native ABI ----------------------------------------------------------------
def test_exported_symbols_name_the_prototypes():
    """Where g++ exists, each package's library exports exactly its
    prototypes, and the port's set equals JAX's; where it does not, the
    loader reports no symbols and the rule stays silent."""
    got = {}
    for pkg in PACKAGES:
        native = importlib.import_module(f"{pkg}.native")
        got[pkg] = (native.exported_symbols(), sorted(native._PROTOTYPES))
    port_syms, port_protos = got[PACKAGES[1]]
    if shutil.which("g++") is None:
        assert port_syms is None
    else:
        assert port_syms == port_protos
        assert got[PACKAGES[1]] == got[PACKAGES[0]]
    report = _lint(PACKAGES[1], "runner").run_lint(
        str(ROOT), analyzers=["native-abi"])
    assert report.findings == []


def test_native_rule_flags_drift(monkeypatch):
    """The rule diffs what the library exports against the prototypes:
    a missing and an undeclared symbol are each a finding."""
    from alluxio_tpu_torch import native

    monkeypatch.setattr(native, "exported_symbols", lambda path=None: sorted(
        set(native._PROTOTYPES) - {"atpu_crc32"} | {"atpu_extra"}))
    report = _lint(PACKAGES[1], "runner").run_lint(
        str(ROOT), analyzers=["native-abi"])
    by_rule = {f.rule: f for f in report.findings}
    assert sorted((r, f.anchor) for r, f in by_rule.items()) == [
        ("native-abi-missing-symbol", "atpu_crc32"),
        ("native-abi-undeclared-symbol", "atpu_extra")]
    # the missing symbol points at its prototype's line
    line = by_rule["native-abi-missing-symbol"].line
    text = (ROOT / "alluxio_tpu_torch/native/__init__.py").read_text()
    assert '"atpu_crc32"' in text.splitlines()[line - 1]
