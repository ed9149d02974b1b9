"""The port installs whole: every file of ``alluxio_tpu_torch/`` that is
not Python source (the CUDA kernels, the native layer's C++, the lint's
baseline) matches a package-data glob of ``pyproject.toml``, and the
port's shell has a console script beside JAX's."""

import fnmatch
import tomllib
from pathlib import Path

from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "alluxio_tpu_torch"


def _pyproject() -> dict:
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def _shipped(path: Path, package_data: dict) -> bool:
    """True when a package-data glob of the package that holds ``path``
    (its nearest directory with an ``__init__.py``) matches it."""
    d = path.parent
    while not (d / "__init__.py").exists():
        d = d.parent
    package = ".".join(d.relative_to(ROOT).parts)
    rel = path.relative_to(d).as_posix()
    return any(fnmatch.fnmatch(rel, g)
               for g in package_data.get(package, []))


def test_every_non_python_file_of_the_port_is_package_data():
    data = _pyproject()["tool"]["setuptools"]["package-data"]
    files = [p for p in PKG.rglob("*") if p.is_file()
             and p.suffix not in (".py", ".pyc")
             and "__pycache__" not in p.parts]
    assert files, "the port has no data files"
    missing = [str(p.relative_to(ROOT)) for p in files
               if not _shipped(p, data)]
    assert not missing, f"not package data: {missing}"


def test_the_port_has_a_console_script():
    scripts = _pyproject()["project"]["scripts"]
    assert scripts["alluxio-tpu-torch"] == \
        "alluxio_tpu_torch.shell.main:main"
    assert scripts["alluxio-tpu"] == "alluxio_tpu.shell.main:main"
