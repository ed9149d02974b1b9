"""The port's examples and deployment assets, on the CPU.

- ``examples/torch_basic_operations.py``, ``torch_multi_mount.py`` and
  ``torch_training_pipeline.py --device cpu`` run self-contained (each
  boots its own in-process cluster) and print what their JAX
  counterparts print.
- The training pipeline's per-epoch losses equal those of
  ``examples/jax_training_pipeline.py``'s ``run()`` on JAX's CPU, same
  seed and sizes, within ``LOSS_RTOL`` (relative): both train a
  linear-softmax model from zero weights with plain SGD at 1e-2 on the
  same decoded batches; the JAX epoch is one scanned jit, the port's a
  loop, so float32 sums may round apart.
- Without a card and without ``--device cpu`` the pipeline raises.
- ``deploy/torch/Dockerfile``'s ``COPY`` sources exist, the compose
  file's build context and ``dockerfile`` resolve to it, and every YAML
  asset parses with ``yaml.safe_load_all``.
- No port asset (``bin/`` scripts of the port, ``deploy/torch/``,
  ``examples/torch_*.py``) names the JAX package as a module, the JAX
  launcher ``bin/alluxio-tpu`` or ``jax``.
"""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import yaml

from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
#: the per-epoch losses of the port's pipeline against JAX's, relative
LOSS_RTOL = 1e-4
_EPOCH = re.compile(r"^epoch (\d): loss ([\d.]+) in [\d.]+s", re.M)


def port_assets() -> list:
    files = sorted(ROOT.glob("bin/alluxio-tpu-torch*"))
    files.append(ROOT / "bin" / "cluster-fanout-torch.sh")
    files += sorted(p for p in (ROOT / "deploy" / "torch").rglob("*")
                    if p.is_file() and "dist" not in p.parts)
    files += sorted(EXAMPLES.glob("torch_*.py"))
    return files


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _child(script: str, *args, env=None):
    env = dict(os.environ if env is None else env)
    return subprocess.run(
        [sys.executable, str(EXAMPLES / script), *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)


@pytest.mark.parametrize("script,args,last", [
    ("torch_basic_operations.py", (), "deleted; done."),
    ("torch_multi_mount.py", (), "unmounted; done."),
    ("torch_training_pipeline.py", ("--device", "cpu"),
     "loader HBM stats: {'hbm_bytes': 3149824, 'hbm_pages': 2}"),
])
def test_example_runs_self_contained(script, args, last):
    r = _child(script, *args)
    assert r.returncode == 0, r.stderr[-1500:]
    assert r.stdout.rstrip().splitlines()[-1] == last
    if script == "torch_training_pipeline.py":
        assert [int(m.group(1)) for m in _EPOCH.finditer(r.stdout)] == \
            [0, 1, 2]
        assert "cached 2 shards x 512 records" in r.stdout


def test_training_pipeline_raises_without_a_card():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    r = _child("torch_training_pipeline.py")
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr


@pytest.fixture(scope="module")
def port_losses():
    from alluxio_tpu_torch.minicluster import LocalCluster

    example = _load(EXAMPLES / "torch_training_pipeline.py",
                    "torch_training_pipeline")
    with tempfile.TemporaryDirectory() as d, \
            LocalCluster(d, num_workers=1, block_size=8 << 20,
                         worker_mem_bytes=256 << 20) as cluster, \
            contextlib.closing(cluster.file_system()) as fs, \
            contextlib.redirect_stdout(io.StringIO()):
        return example.run(fs, "cpu")


def test_training_pipeline_losses_match_jax(port_losses, monkeypatch):
    """The JAX example's ``run()`` with its own cluster, its per-epoch
    loss taken from the jitted epoch's third output (it prints four
    decimals only)."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("optax")
    jax_example = _load(EXAMPLES / "jax_training_pipeline.py",
                        "jax_training_pipeline")
    losses = []
    real_jit = jax.jit

    def jit(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)
        if getattr(fn, "__name__", "") != "train_epoch":
            return jitted

        def epoch(*a):
            out = jitted(*a)
            losses.append(float(out[2]))
            return out

        return epoch

    monkeypatch.setattr(jax, "jit", jit)
    from alluxio_tpu.minicluster import LocalCluster

    with tempfile.TemporaryDirectory() as d, \
            LocalCluster(d, num_workers=1, block_size=8 << 20,
                         worker_mem_bytes=256 << 20) as cluster, \
            contextlib.closing(cluster.file_system()) as fs, \
            contextlib.redirect_stdout(io.StringIO()):
        jax_example.run(fs)
    assert len(losses) == len(port_losses) == 3
    assert port_losses[0] > port_losses[1] > port_losses[2]
    for got, want in zip(port_losses, losses):
        assert abs(got - want) <= LOSS_RTOL * abs(want), (port_losses,
                                                          losses)


def test_dockerfile_and_compose_resolve():
    dockerfile = ROOT / "deploy" / "torch" / "Dockerfile"
    lines = dockerfile.read_text().splitlines()
    copies = [line.split()[1:-1] for line in lines
              if line.startswith("COPY ")]
    sources = [s for srcs in copies for s in srcs]
    assert sources == ["alluxio_tpu_torch/", "bin/", "pyproject.toml"]
    for src in sources:
        assert (ROOT / src).exists(), src
    text = dockerfile.read_text()
    assert 'ENTRYPOINT ["python", "-m", "alluxio_tpu_torch.shell.main"]' \
        in text
    # the kernels and the native layer are built into the image
    assert "_build.build()" in text and "n.lib() is not None" in text
    jax_expose = [line for line in (ROOT / "deploy" / "Dockerfile")
                  .read_text().splitlines() if line.startswith("EXPOSE")]
    assert [line for line in lines if line.startswith("EXPOSE")] == \
        jax_expose
    compose_path = ROOT / "deploy" / "torch" / "docker-compose.yml"
    compose = yaml.safe_load(compose_path.read_text())
    jax_compose = yaml.safe_load(
        (ROOT / "deploy" / "docker-compose.yml").read_text())
    assert list(compose["services"]) == list(jax_compose["services"])
    for name, svc in compose["services"].items():
        build = svc["build"]
        context = (compose_path.parent / build["context"]).resolve()
        assert context == ROOT
        assert (context / build["dockerfile"]).resolve() == \
            dockerfile.resolve()
        assert svc["image"] == "alluxio-tpu-torch:latest"
        jax_svc = dict(jax_compose["services"][name])
        jax_svc.pop("build")
        assert {k: v for k, v in svc.items()
                if k not in ("build", "image")} == jax_svc


@pytest.mark.parametrize("path", [
    p for p in port_assets() if p.suffix in (".yaml", ".yml")],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_yaml_assets_parse(path):
    docs = [d for d in yaml.safe_load_all(path.read_text()) if d] \
        if "templates" not in path.parts else []
    if "templates" in path.parts:
        # a template is YAML once rendered (tests/test_torch_helm_chart.py)
        assert "{{" in path.read_text()
    else:
        assert docs


_NAMES_JAX = [re.compile(r"\balluxio_tpu[.\s]"),
              re.compile(r"bin/alluxio-tpu "),
              re.compile(r"\bjax\b")]


@pytest.mark.parametrize("path", port_assets(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_asset_names_no_jax(path):
    text = path.read_text()
    bad = [m.group(0) for pat in _NAMES_JAX for m in pat.finditer(text)]
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"
