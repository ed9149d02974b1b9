"""The port stands alone: no module of ``alluxio_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, optax, ml_dtypes or the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

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
    return top in FORBIDDEN


FORBIDDEN = ("jax", "jaxlib", "optax", "ml_dtypes", "alluxio_tpu")


def test_importing_every_module_loads_no_jax():
    mods = list(_module_names())
    for m in ("ops.reduce_kernel", "parallel.ring_attention",
              "parallel.moe", "parallel.mesh", "parallel.tensor_parallel",
              "parallel.ici_store", "parallel.pipeline", "utils.wire",
              "models.transformer", "models.train", "models.checkpoint",
              "heartbeat", "heartbeat.core", "prefetch", "prefetch.oracle",
              "prefetch.scheduler", "prefetch.agent", "prefetch.service",
              "client.cache", "client.cache.meta",
              "client.cache.page_store", "client.cache.manager",
              "client.cache.stream", "client.cache.hbm_store",
              "client.cache.evictor", "client.block_streams",
              "utils.exceptions", "utils.ids", "utils.retry", "utils.locks",
              "utils.fingerprint", "conf", "conf.configuration",
              "conf.property_key", "qos", "underfs", "underfs.base",
              "underfs.local", "underfs.registry", "worker", "worker.meta",
              "worker.lock_manager", "worker.allocator", "worker.annotator",
              "worker.tiered_store", "worker.ufs_io", "worker.master_sync",
              "worker.ufs_manager", "worker.process", "rpc", "rpc.core",
              "rpc.worker_service", "rpc.clients", "native", "shm",
              "worker.shm_store", "client.fastpath", "client.shm_transport",
              "utils.striping", "client.remote_read", "client.policy",
              "client.block_store", "worker.ufs_fetch", "worker.management",
              "worker.web", "metrics.sinks", "utils.faults",
              "utils.pause_monitor", "utils.statuspage", "security",
              "security.user", "security.authentication", "utils.uri",
              "utils.clock", "security.authorization", "journal",
              "journal.format", "journal.system", "master", "master.inode",
              "master.metastore", "master.metastore.base",
              "master.metastore.heap", "master.ttl", "master.inode_tree",
              "master.mount_table", "master.invalidation",
              "master.block_master", "master.sync",
              "master.path_properties", "master.integrity",
              "master.file_master", "master.process", "rpc.master_service",
              "rpc.fastpath", "client.streams", "client.file_system",
              "minicluster", "minicluster.local_cluster", "job",
              "job.wire", "job.plan", "job.plans", "job.plans.load",
              "job.plans.persist", "job.plans.replicate",
              "job.plans.migrate", "job.master", "job.worker",
              "job.process", "rpc.job_service", "master.replication",
              "master.persistence", "stress", "stress.base",
              "stress.cluster", "stress.write_bench", "stress.tpu_suite",
              "table", "table.plan", "table.reader", "table.udb",
              "table.master", "rpc.table_service", "job.plans.transform",
              "stress.table_bench", "stress.prefetch_bench", "shell",
              "shell.main", "shell.launch", "minicluster.multi_process",
              "master.metastore.encoding", "master.metastore.wal",
              "master.metastore.sstable", "master.metastore.lsm",
              "master.metastore.sqlite", "master.metastore.caching",
              "stress.worker_bench", "stress.master_bench",
              "job.plans.stressbench", "stress.metadata_bench",
              "stress.smallread_bench", "stress.ufs_cold_bench",
              "stress.remote_read_bench", "stress.report",
              "stress.__main__", "metrics.history",
              "master.metrics_master", "utils.profiler",
              "utils.critical_path", "master.health",
              "master.remediation", "master.web", "utils.weblog",
              "utils.trace_fanout", "stress.obs_bench",
              "stress.health_bench", "stress.selfheal_bench",
              "qos.admission", "security.audit", "stress.qos_bench",
              "journal.ha", "journal.raft", "journal.migrate",
              "journal.tool", "master.backup", "minicluster.ha_cluster",
              "stress.ha_bench", "shell.journal_crash", "shell.command",
              "shell.fs_shell", "shell.fsadmin_shell", "shell.job_shell",
              "shell.table_shell", "shell.validate", "shell.validate_env",
              "shell.run_operation", "shell.format",
              "master.update_check", "utils.race", "lint", "lint.findings",
              "lint.model", "lint.collect", "lint.conf_analyzer",
              "lint.metrics_analyzer", "lint.phases_analyzer",
              "lint.locks_analyzer", "lint.exceptions_analyzer",
              "lint.native_analyzer", "lint.runner", "lint.__main__",
              "lint.pytest_lockaudit", "utils.httperr",
              "underfs.object_base", "underfs.web", "underfs.s3",
              "underfs.s3_compat", "underfs.vendor_native", "underfs.gcs",
              "underfs.azure", "underfs.swift", "underfs.ozone",
              "underfs.hdfs", "underfs.webhdfs", "underfs.delegating",
              "utils.collections", "client.arrow_fs", "client.fsspec_fs",
              "yarn", "yarn.allocator", "yarn.client", "yarn.am",
              "yarn.__main__", "operator", "operator.controller"):
        assert f"alluxio_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
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


def test_role_launchers_load_no_torch():
    """The role processes are host-only: the shell, the launchers, the
    multi-process and HA clusters, every module the four launchers build
    their roles from (the HA master's Raft journal, tailer and backup
    among them), the journal tools, the HA drills, the operator's
    shells, the update check, the serving surfaces (the proxy, the
    log server, FUSE, the Hive and Glue under-databases), and the
    deployment modules (the YARN client, allocator, application master
    and CLI, the Kubernetes dataset operator) import no torch."""
    code = ("import sys\n"
            "import alluxio_tpu_torch.shell.main, "
            "alluxio_tpu_torch.shell.launch, "
            "alluxio_tpu_torch.minicluster.multi_process, "
            "alluxio_tpu_torch.master.process, "
            "alluxio_tpu_torch.master.metrics_master, "
            "alluxio_tpu_torch.master.health, "
            "alluxio_tpu_torch.master.remediation, "
            "alluxio_tpu_torch.master.web, "
            "alluxio_tpu_torch.master.integrity, "
            "alluxio_tpu_torch.master.sync, "
            "alluxio_tpu_torch.qos.admission, "
            "alluxio_tpu_torch.security.audit, "
            "alluxio_tpu_torch.worker.process, "
            "alluxio_tpu_torch.rpc.worker_service, "
            "alluxio_tpu_torch.worker.ufs_manager, "
            "alluxio_tpu_torch.security.authentication, "
            "alluxio_tpu_torch.job.process, "
            "alluxio_tpu_torch.journal.ha, "
            "alluxio_tpu_torch.journal.raft, "
            "alluxio_tpu_torch.journal.migrate, "
            "alluxio_tpu_torch.journal.tool, "
            "alluxio_tpu_torch.master.backup, "
            "alluxio_tpu_torch.minicluster.ha_cluster, "
            "alluxio_tpu_torch.stress.ha_bench, "
            "alluxio_tpu_torch.shell.journal_crash, "
            "alluxio_tpu_torch.shell.command, "
            "alluxio_tpu_torch.shell.fs_shell, "
            "alluxio_tpu_torch.shell.fsadmin_shell, "
            "alluxio_tpu_torch.shell.job_shell, "
            "alluxio_tpu_torch.shell.table_shell, "
            "alluxio_tpu_torch.shell.validate, "
            "alluxio_tpu_torch.shell.validate_env, "
            "alluxio_tpu_torch.shell.run_operation, "
            "alluxio_tpu_torch.shell.format, "
            "alluxio_tpu_torch.master.update_check, "
            "alluxio_tpu_torch.proxy.process, "
            "alluxio_tpu_torch.logserver.process, "
            "alluxio_tpu_torch.fuse.process, "
            "alluxio_tpu_torch.fuse.libfuse, "
            "alluxio_tpu_torch.table.thrift_proto, "
            "alluxio_tpu_torch.table.hive, "
            "alluxio_tpu_torch.table.glue, "
            "alluxio_tpu_torch.yarn, "
            "alluxio_tpu_torch.yarn.allocator, "
            "alluxio_tpu_torch.yarn.client, "
            "alluxio_tpu_torch.yarn.am, "
            "alluxio_tpu_torch.yarn.__main__, "
            "alluxio_tpu_torch.operator, "
            "alluxio_tpu_torch.operator.controller, "
            "alluxio_tpu_torch.qos\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'alluxio_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_lint_loads_no_torch_and_no_jax(tmp_path):
    """The port's lint is host-only: a child that runs every analyzer
    over a seeded file, native ABI check included, has loaded neither
    torch nor JAX nor the JAX package when it is done."""
    (tmp_path / "seeded.py").write_text(
        "import threading, time\n_lock = threading.Lock()\n"
        "def f():\n    with _lock:\n        time.sleep(1)\n")
    code = ("import sys\n"
            "from alluxio_tpu_torch.lint.runner import run_lint\n"
            "from alluxio_tpu_torch import native\n"
            "native.exported_symbols()\n"
            f"rep = run_lint({str(tmp_path)!r}, only_paths={{'seeded.py'}},"
            " extra_py=['seeded.py'])\n"
            "assert [f.rule for f in rep.new] == ['lock-blocking-call']\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'alluxio_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_shell_child_loads_no_torch():
    """An operator's shell builds no CUDA context: a child that
    dispatches every ported shell command through ``shell.main`` (each
    shell's help, ``validateConf``, ``format``'s usage and
    ``validateHms`` against an address that refuses) has loaded
    neither torch nor JAX when it is done."""
    code = ("import sys\n"
            "from alluxio_tpu_torch.shell.main import main\n"
            "for argv in (['fs', 'help'], ['fsadmin', 'help'], "
            "['job', 'help'], ['table', 'help'], ['validateConf'], "
            "['format', 'usage'], ['validateHms', '-m', "
            "'thrift://127.0.0.1:1', '--no-fs']):\n"
            "    main(argv)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'alluxio_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("module", [
    "alluxio_tpu_torch.stress.metadata_bench",
    "alluxio_tpu_torch.master.metastore.lsm",
    "alluxio_tpu_torch.master.metastore",
    "alluxio_tpu_torch.stress.__main__",
])
def test_metastore_and_capacity_bench_load_no_torch(module):
    """The metadata bench's capacity child runs under an address-space
    cap that a torch import alone would exceed: the bench, the CLI and
    the metastore it builds import neither torch nor JAX."""
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'alluxio_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_connectors_and_adapters_load_no_torch():
    """The UFS connectors, the client adapters and the collections are
    host code that every role process may load through the registry: a
    child that imports them all (the registry's optional connectors
    registered) has loaded neither torch nor JAX."""
    code = ("import sys\n"
            "import alluxio_tpu_torch.underfs.registry as r\n"
            "import alluxio_tpu_torch.client.arrow_fs, "
            "alluxio_tpu_torch.client.fsspec_fs, "
            "alluxio_tpu_torch.utils.collections, "
            "alluxio_tpu_torch.underfs.delegating\n"
            "assert {'s3', 'gs', 'wasb', 'webhdfs', 'mem'} <= "
            "set(r.supported_schemes())\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'alluxio_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


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
    from alluxio_tpu_torch.convert import (hbm_store_from_numpy,
                                           transformer_params_from_numpy)
    from alluxio_tpu_torch.models.train import make_train_state
    from alluxio_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from alluxio_tpu_torch.parallel.moe import init_moe_params

    with pytest.raises(RuntimeError, match="device='cpu'"):
        HbmPageStore(1024)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceBlockLoader(object(), [])
    from alluxio_tpu_torch.client.cache.manager import LocalCacheManager
    from alluxio_tpu_torch.client.cache.page_store import MemPageStore

    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalCacheManager(MemPageStore(), hbm_store=HbmPageStore(1024))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hbm_store_from_numpy({}, capacity_bytes=1024)
    cfg = TransformerConfig(vocab_or_patch_dim=8, d_model=8, n_heads=2,
                            d_ff=8, n_layers=1, n_classes=2, max_len=2)
    for entry in (lambda: Transformer(cfg), lambda: make_train_state(cfg),
                  lambda: transformer_params_from_numpy({}, cfg),
                  lambda: init_moe_params(torch.Generator(), n_experts=2,
                                          d_model=8, d_ff=8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    # asked for explicitly, the CPU is fine
    assert HbmPageStore(1024, device="cpu").device.type == "cpu"
    assert Transformer(cfg, device="cpu").embed.device.type == "cpu"
    assert init_moe_params(torch.Generator(), n_experts=2, d_model=8,
                           d_ff=8, device="cpu")["gate"].device.type == "cpu"


def test_mesh_entry_points_do_not_fall_back(tmp_path):
    """No group: ``make_mesh`` raises. Under a gloo group and no card, a
    mesh (and so a sharded model or train state) must ask for the CPU;
    with ``device_type="cpu"`` it runs there, and a model cannot be put
    on another device than its mesh's."""
    import torch.distributed as dist

    from alluxio_tpu_torch.models.train import make_sharded_train_state
    from alluxio_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from alluxio_tpu_torch.parallel.mesh import make_mesh
    from tests.testutils.torch_dist import cpu_group

    sizes = {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(sizes)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default mesh is valid")
    cfg = TransformerConfig(vocab_or_patch_dim=8, d_model=8, n_heads=2,
                            d_ff=8, n_layers=1, n_classes=2, max_len=2)
    cpu_group(tmp_path / "store")
    try:
        for entry in (lambda: make_mesh(sizes),
                      lambda: Transformer(cfg, mesh=make_mesh(sizes)),
                      lambda: make_sharded_train_state(cfg,
                                                       make_mesh(sizes))):
            with pytest.raises(RuntimeError, match="device_type='cpu'"):
                entry()
        with pytest.raises(RuntimeError, match="nccl"):
            make_mesh(sizes, device_type="cuda")
        mesh = make_mesh(sizes, device_type="cpu")
        assert Transformer(cfg, mesh=mesh).embed.device.type == "cpu"
        with pytest.raises(ValueError, match="mesh"):
            Transformer(cfg, mesh=mesh, device="cuda")
    finally:
        dist.destroy_process_group()
