"""The port's package re-exports: a program written against the JAX
package's package-level imports runs on the port by changing the package
name.

- Every name a JAX package's ``__init__.py`` re-exports (by import, by
  ``__all__`` or by its lazy table), but for the allowlisted JAX idioms
  of ``tests/test_torch_surface.py``, resolves on the port's package and
  IS the object at the port's module path where JAX defines it.
- Importing the packages loads no torch: ``client``, ``worker``,
  ``rpc``, ``qos``, ``conf``, ``metrics`` and ``utils`` (used by the
  role processes), and ``ops``, ``models`` and ``parallel``, whose
  re-exports load on first use.
- As in JAX, ``alluxio_tpu_torch.parallel.ring_attention`` is the
  function, whether or not the submodule of that name was imported
  first.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_torch_surface import ALLOWLIST
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "alluxio_tpu"


def _reexports():
    """(JAX package, name, JAX module that binds it) for every
    re-export of a JAX ``__init__.py``."""
    out = []
    for init in sorted(JAX.rglob("__init__.py")):
        rel = str(init.relative_to(JAX))
        pkg = ".".join(("alluxio_tpu",) + init.parent.relative_to(
            JAX).parts)
        tree = ast.parse(init.read_text())
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                    node.module and node.module.startswith("alluxio_tpu"):
                for a in node.names:
                    name = a.asname or a.name
                    if f"{rel}::{name}" not in ALLOWLIST:
                        out.append((pkg, name, node.module, a.name))
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.targets[0], ast.Name) and \
                    node.targets[0].id == "_LAZY":
                for k, v in zip(node.value.keys, node.value.values):
                    out.append((pkg, k.value, v.value, k.value))
    return out


REEXPORTS = _reexports()


def _port(name: str) -> str:
    return "alluxio_tpu_torch" + name[len("alluxio_tpu"):]


@pytest.mark.parametrize("pkg,name,module,attr", REEXPORTS,
                         ids=[f"{p}.{n}" for p, n, _, _ in REEXPORTS])
def test_reexport_is_the_object_at_its_module_path(pkg, name, module,
                                                    attr):
    port_pkg = importlib.import_module(_port(pkg))
    got = getattr(port_pkg, name)
    target = importlib.import_module(_port(module))
    want = getattr(target, attr) if hasattr(target, attr) else \
        importlib.import_module(f"{_port(module)}.{attr}")
    assert got is want
    ns = {}
    exec(f"from {_port(pkg)} import {name} as got", ns)  # noqa: S102
    assert ns["got"] is want


def test_the_reexport_table_covers_the_ten_packages():
    pkgs = {p for p, _, _, _ in REEXPORTS}
    assert {"alluxio_tpu", "alluxio_tpu.client", "alluxio_tpu.worker",
            "alluxio_tpu.rpc", "alluxio_tpu.utils", "alluxio_tpu.conf",
            "alluxio_tpu.metrics", "alluxio_tpu.ops", "alluxio_tpu.models",
            "alluxio_tpu.parallel"} <= pkgs
    # qos defines its names in its own __init__ and lists them in
    # __all__: the port's lists the same
    from alluxio_tpu import qos as jqos
    from alluxio_tpu_torch import qos as tqos

    assert tqos.__all__ == jqos.__all__
    assert all(hasattr(tqos, n) for n in tqos.__all__)


def _child(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_packages_import_loads_no_torch():
    pkgs = ("client", "worker", "rpc", "qos", "conf", "metrics", "utils",
            "ops", "models", "parallel")
    code = ("import sys\n"
            + "".join(f"import alluxio_tpu_torch.{p}\n" for p in pkgs)
            + "from alluxio_tpu_torch.utils import AlluxioURI, exceptions\n"
            "from alluxio_tpu_torch.conf import global_configuration\n"
            "from alluxio_tpu_torch.metrics import Meter, reset_metrics\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'alluxio_tpu')))\n")
    assert _child(code) == "[]"


@pytest.mark.parametrize("first", ["package", "submodule"])
def test_parallel_ring_attention_is_the_function(first):
    """Whichever is imported first, the package's ``ring_attention`` is
    the function, as JAX's is; the submodule stays reachable through
    ``importlib``."""
    code = (
        "import importlib, types\n"
        + ("import alluxio_tpu_torch.parallel as p\n"
           "f = p.ring_attention\n"
           if first == "package" else
           "importlib.import_module("
           "'alluxio_tpu_torch.parallel.ring_attention')\n"
           "import alluxio_tpu_torch.parallel as p\n"
           "f = p.ring_attention\n")
        + "from alluxio_tpu_torch.parallel import ring_attention as g\n"
        "m = importlib.import_module("
        "'alluxio_tpu_torch.parallel.ring_attention')\n"
        "import alluxio_tpu.parallel as jp\n"
        "print(callable(f) and not isinstance(f, types.ModuleType), "
        "f is g is m.ring_attention, isinstance(m, types.ModuleType), "
        "not isinstance(jp.ring_attention, types.ModuleType))\n")
    assert _child(code) == "True True True True"
