"""The port stands alone: no module of ``alluxio_tpu_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and its entry points
run on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "alluxio_tpu_torch"


def _module_names():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "alluxio_tpu")


def test_importing_every_module_loads_no_jax():
    mods = list(_module_names())
    assert "alluxio_tpu_torch.ops.reduce_kernel" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'alluxio_tpu'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_package_import_loads_no_torch():
    code = ("import sys, alluxio_tpu_torch\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("path", sorted(
    [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and getattr(node.func, "attr",
                            getattr(node.func, "id", "")) \
                in ("import_module", "__import__") \
                and _forbidden(node.args[0].value):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from alluxio_tpu_torch.client.cache.hbm_store import HbmPageStore
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader
    from alluxio_tpu_torch.convert import hbm_store_from_numpy

    with pytest.raises(RuntimeError, match="device='cpu'"):
        HbmPageStore(1024)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceBlockLoader(object(), [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hbm_store_from_numpy({}, capacity_bytes=1024)
    # asked for explicitly, the CPU is fine
    assert HbmPageStore(1024, device="cpu").device.type == "cpu"
