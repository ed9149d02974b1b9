"""The port's update checker against the JAX package's, on the CPU.

Mirrors JAX's ``tests/test_update_check.py`` on both packages: version
parsing, a newer release seen and an equal one quiet against a local
release document (``tests/testutils/torch_update_check.py``), a failing
endpoint ignored, and the check off by default. Besides, the master
wiring: with the check on and no URL the master warns and builds no
checker, in both packages, and the port's ``Master.UpdateCheck``
heartbeat has JAX's name.
"""

import importlib
import logging

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.testutils.torch_update_check import FakeReleases  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")


def _uc(pkg):
    return importlib.import_module(f"{pkg}.master.update_check")


@pytest.mark.parametrize("pair", [("0.10.0", "0.9.9"), ("1.0.0rc1", "1"),
                                  ("2", "1.9"), ("1.0", "1.0.0"),
                                  ("x.y", "0"), ("3.2.1.9", "3.2.1")])
def test_version_parse_matches_jax(pair):
    for v in pair:
        assert _uc("alluxio_tpu_torch")._parse_version(v) == \
            _uc("alluxio_tpu")._parse_version(v)
    port = _uc("alluxio_tpu_torch")._parse_version
    assert port("0.10.0") > port("0.9.9")
    assert port("1.0.0rc1") == (1, 0, 0, 0)
    assert port("1.0") == port("1.0.0")


def test_newer_release_detected_and_equal_is_quiet():
    seen = []
    with FakeReleases("9.9.9") as srv:
        for pkg in PACKAGES:
            srv.latest = "9.9.9"
            c = _uc(pkg).UpdateChecker(srv.url, current_version="0.1.0")
            c.heartbeat()
            first = (c.update_available, c.latest_version)
            srv.latest = "0.1.0"
            c.heartbeat()
            seen.append((first, c.update_available, c.latest_version))
    assert seen[1] == seen[0] == ((True, "9.9.9"), False, "0.1.0")


def test_endpoint_failure_is_ignored():
    for pkg in PACKAGES:
        c = _uc(pkg).UpdateChecker("http://127.0.0.1:1/",
                                   current_version="0.1.0")
        c.heartbeat()  # connection refused: no raise
        assert c.latest_version is None and not c.update_available


def test_disabled_by_default_in_both():
    for pkg in PACKAGES:
        conf_mod = importlib.import_module(f"{pkg}.conf")
        conf = conf_mod.Configuration(load_env=False)
        assert conf.get_bool(conf_mod.Keys.MASTER_UPDATE_CHECK_ENABLED) \
            is False
        assert conf.get(conf_mod.Keys.MASTER_UPDATE_CHECK_URL) is None
        assert conf.get_duration_s(
            conf_mod.Keys.MASTER_UPDATE_CHECK_INTERVAL) == 86400.0


def test_heartbeat_name_matches_jax():
    from alluxio_tpu.heartbeat import HeartbeatContext as Jax
    from alluxio_tpu_torch.heartbeat import HeartbeatContext as Port

    assert Port.MASTER_UPDATE_CHECK == Jax.MASTER_UPDATE_CHECK == \
        "Master.UpdateCheck"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_enabled_without_url_warns_and_builds_no_checker(pkg, tmp_path,
                                                         caplog):
    conf_mod = importlib.import_module(f"{pkg}.conf")
    Keys = conf_mod.Keys
    conf = conf_mod.Configuration(load_env=False)
    conf.set(Keys.HOME, str(tmp_path))
    conf.set(Keys.MASTER_JOURNAL_FOLDER, str(tmp_path / "journal"))
    conf.set(Keys.MASTER_RPC_PORT, 0)
    conf.set(Keys.MASTER_FASTPATH_ENABLED, False)
    conf.set(Keys.MASTER_UPDATE_CHECK_ENABLED, True)
    process = importlib.import_module(f"{pkg}.master.process")
    master = process.MasterProcess(conf, root_ufs_uri=str(tmp_path / "ufs"))
    with caplog.at_level(logging.WARNING, logger=f"{pkg}.master.process"):
        master.start()
        try:
            assert master.update_checker is None
        finally:
            master.stop()
    assert "update checking is a no-op" in caplog.text
