"""The port's site-properties configuration against the JAX package's.

- One seeded site file (comments, blank lines, lines without ``=``,
  unknown keys, a templated key, padded values) loaded by both packages'
  ``Configuration.load_site_properties``, then a value at every other
  ``Source`` (the environment, the cluster defaults, a path default, a
  runtime set, a mount option), gives the same ``items()`` and the same
  ``to_map()`` at every source floor.
- ``validate()`` raises on the same bad values in both, with the same
  exception type, and passes the same good file.
- ``global_configuration()`` reads the file that ``ATPU_SITE_PROPERTIES``
  names, in both, and ``reset_global_configuration()`` drops it.
"""

import numpy as np
import pytest

from alluxio_tpu.conf import configuration as jcfg  # noqa: E402
from alluxio_tpu.conf import property_key as jpk  # noqa: E402
from alluxio_tpu_torch.conf import configuration as tcfg  # noqa: E402
from alluxio_tpu_torch.conf import property_key as tpk  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

PACKAGES = ((jcfg, jpk), (tcfg, tpk))
GOOD = {"int": "42", "float": "0.25", "bool": "true", "bytes": "64MB",
        "duration": "5s", "list": "a,b", "string": "x"}


def _site_file(path, seed: int) -> list:
    """A seeded site file; returns the keys it sets."""
    rng = np.random.default_rng(seed)
    keys = sorted(jpk.REGISTRY.all_keys().values(), key=lambda k: k.name)
    picked = [keys[i] for i in rng.choice(len(keys), 40, replace=False)]
    lines = ["# site properties", ""]
    for pk in picked:
        if pk.key_type is jpk.KeyType.ENUM:
            value = pk.choices[int(rng.integers(len(pk.choices)))].lower()
        else:
            value = GOOD[pk.key_type.value]
        pad = " " * int(rng.integers(3))
        lines.append(f"{pad}{pk.name}{pad}={pad}{value}{pad}")
        if rng.random() < 0.2:
            lines.append("   # a comment between keys")
        if rng.random() < 0.2:
            lines.append("")
    lines += ["atpu.no.such.key=1", "not a property line",
              "atpu.worker.tieredstore.level3.alias = NVME",
              "atpu.worker.tieredstore.level0.watermark.high.ratio=0.9"]
    path.write_text("\n".join(lines) + "\n")
    return [pk.name for pk in picked]


def _layered(cfg, site: str, keys: list):
    """The site file, then a value at each other source: over a key the
    file set (a lower source loses to it) and over keys it did not."""
    conf = cfg.Configuration(load_env=True)
    conf.load_site_properties(site)
    S = cfg.Source
    unset = [n for n in sorted(jpk.REGISTRY.all_keys()) if n not in keys]
    conf.merge({keys[0]: "c", unset[0]: "c", "atpu.unknown": "1"},
               S.CLUSTER_DEFAULT)
    conf.set(keys[1], "p", S.PATH_DEFAULT)
    conf.set(keys[2], "r")
    conf.set(keys[3], "m", S.MOUNT_OPTION)
    conf.set(keys[4], "d", S.DEFAULT)
    conf.set(unset[1], "d", S.DEFAULT)
    return conf


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_site_file_and_every_source_equal_jax(seed, tmp_path, monkeypatch):
    site = tmp_path / "site.properties"
    keys = _site_file(site, seed)
    monkeypatch.setenv("ATPU_MASTER_HOSTNAME", "envhost")
    monkeypatch.setenv("ATPU_NOT_A_KEY", "1")
    out = []
    for cfg, _ in PACKAGES:
        conf = _layered(cfg, str(site), keys)
        out.append((
            [(n, v, s.name) for n, v, s in conf.items()],
            {s.name: conf.to_map(s) for s in cfg.Source},
            conf.hash()))
    assert out[1] == out[0]
    sources = {s for _, _, s in out[0][0]}
    assert sources == {s.name for s in jcfg.Source}


@pytest.mark.parametrize("key,bad,raises", [
    ("atpu.worker.rpc.port", "not-a-port", True),
    ("atpu.worker.rpc.port", "0x1G", True),
    ("atpu.user.block.size.bytes.default", "12XB", True),
    ("atpu.user.rpc.retry.duration", "5 parsecs", True),
    ("atpu.trace.sample.rate", "half", True),
    ("atpu.user.file.writetype.default", "NOPE", True),
    # a templated key is not in the registry until it is read: validate
    # passes it over in both (a level no test reads)
    ("atpu.worker.tieredstore.level9.watermark.high.ratio", "high", False),
])
def test_validate_raises_alike(tmp_path, key, bad, raises):
    site = tmp_path / "site.properties"
    site.write_text(f"# bad value\n{key} = {bad}\n")
    outcome = []
    for cfg, _ in PACKAGES:
        conf = cfg.Configuration(load_env=False)
        conf.load_site_properties(str(site))
        try:
            conf.validate()
            outcome.append(None)
        except Exception as err:  # noqa: BLE001 - the type is compared
            outcome.append(type(err).__name__)
    assert outcome[1] == outcome[0]
    assert (outcome[0] is not None) == raises


def test_validate_checks_a_templated_key_once_minted(tmp_path):
    site = tmp_path / "site.properties"
    site.write_text("atpu.worker.tieredstore.level8.watermark.low.ratio"
                    " = low\n")
    raised = []
    for cfg, pk in PACKAGES:
        pk.Templates.WORKER_TIER_LOW_WATERMARK.format(8)
        conf = cfg.Configuration(load_env=False)
        conf.load_site_properties(str(site))
        with pytest.raises(ValueError) as err:
            conf.validate()
        raised.append(str(err.value))
    assert raised[1] == raised[0]


def test_validate_passes_a_good_file(tmp_path):
    site = tmp_path / "site.properties"
    _site_file(site, 7)
    for cfg, _ in PACKAGES:
        conf = cfg.Configuration(load_env=False)
        conf.load_site_properties(str(site))
        conf.validate()


def test_global_configuration_reads_the_named_site_file(tmp_path,
                                                        monkeypatch):
    site = tmp_path / "site.properties"
    _site_file(site, 9)
    monkeypatch.setenv("ATPU_SITE_PROPERTIES", str(site))
    maps = []
    for cfg, _ in PACKAGES:
        cfg.reset_global_configuration()
        try:
            g = cfg.global_configuration()
            assert cfg.global_configuration() is g
            maps.append(g.to_map(cfg.Source.SITE_PROPERTY))
            cfg.reset_global_configuration()
            assert cfg.global_configuration() is not g
        finally:
            cfg.reset_global_configuration()
    assert maps[1] == maps[0] and maps[0]
    monkeypatch.setenv("ATPU_SITE_PROPERTIES", str(tmp_path / "absent"))
    for cfg, _ in PACKAGES:
        try:
            assert cfg.global_configuration().to_map(
                cfg.Source.SITE_PROPERTY) == {}
        finally:
            cfg.reset_global_configuration()
