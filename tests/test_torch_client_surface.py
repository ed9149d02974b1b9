"""The client and model parameters of the port against the JAX package's.

- ``save_pytree``/``save_train_state(write_type=)``: a checkpoint the
  port writes into its ``LocalCluster`` with each write type leaves
  every file in the persistence state that the JAX package's checkpoint
  of the same train state leaves in JAX's cluster, and the JAX loader,
  through a JAX client of the port's cluster, reads it back bit for bit.
- ``ShmBlockInStream.memoryview``: the SHM block's bytes with no copy
  (the buffer address of ``numpy_view``), through both packages'
  transports against the port's worker; ``LocalBlockInStream.memoryview``
  over the lease's mmap likewise.
- ``BlockInStream.memoryview`` is None and ``.source`` raises in the
  base class, in both.
- ``ReadPlan.execute(host=)``: the fault injector's scope decides by the
  host, in both.
- ``tpu_suite.run_all(row_extra=)``: every row carries the extra keys,
  which are gone after the run, in both.
- ``BlockStoreClient.block_master``, ``LocalPageStore.close`` and
  ``create_job_id`` (the same ids from the same seed) in both.
"""

import importlib
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from alluxio_tpu.models import checkpoint as jck  # noqa: E402
from alluxio_tpu_torch.models import checkpoint as tck  # noqa: E402
from alluxio_tpu_torch.utils.pytree import tree_leaves  # noqa: E402
from tests.test_torch_checkpoint import (jax_state, port_state,  # noqa: E402
                                         raw)
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

KB = 1024
BLOCK = 64 * KB
PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
WRITE_TYPES = ("MUST_CACHE", "CACHE_THROUGH", "THROUGH", "ASYNC_THROUGH")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    from alluxio_tpu.minicluster import LocalCluster as JaxCluster
    from alluxio_tpu_torch.minicluster import LocalCluster

    port = LocalCluster(str(tmp_path_factory.mktemp("port")), num_workers=1,
                        block_size=BLOCK, worker_mem_bytes=64 * BLOCK)
    jaxc = JaxCluster(str(tmp_path_factory.mktemp("jax")), num_workers=1,
                      block_size=BLOCK, worker_mem_bytes=64 * BLOCK)
    with port, jaxc:
        fss = {"alluxio_tpu_torch": port.file_system(),
               "alluxio_tpu": jaxc.file_system()}
        yield {"port": port, "fs": fss}
        for fs in fss.values():
            fs.close()


def _states(fs, base: str) -> dict:
    """Path -> persistence state of every file under ``base``."""
    out = {}
    for info in fs.list_status(base):
        path = f"{base}/{info.name}"
        if info.folder:
            out.update(_states(fs, path))
        else:
            out[path] = fs.get_status(path).persistence_state
    return out


def _jax_client(port_cluster):
    from alluxio_tpu.client.file_system import FileSystem as JaxFileSystem
    from alluxio_tpu.conf import Configuration as JaxConfiguration
    from alluxio_tpu.conf import Keys as JaxKeys
    from alluxio_tpu_torch.conf import Keys

    conf = JaxConfiguration(load_env=False)
    conf.set(JaxKeys.MASTER_FASTPATH_DIR,
             port_cluster.conf.get(Keys.MASTER_FASTPATH_DIR))
    return JaxFileSystem(port_cluster.master.address, conf=conf)


@pytest.mark.parametrize("wt", WRITE_TYPES)
def test_checkpoint_write_types_persist_like_jax(clusters, wt):
    params, opt = jax_state("bfloat16")
    model, state = port_state(params, opt, "bfloat16")
    base = f"/ckpt-{wt.lower()}"
    tfs, jfs = clusters["fs"]["alluxio_tpu_torch"], clusters["fs"][
        "alluxio_tpu"]
    tck.save_train_state(
        tfs, f"{base}/step-2", model.param_tree(), state, step=2,
        write_type=getattr(_mod("alluxio_tpu_torch",
                                "client.streams").WriteType, wt))
    jck.save_train_state(
        jfs, f"{base}/step-2", params, opt, step=2,
        write_type=getattr(_mod("alluxio_tpu", "client.streams").WriteType,
                           wt))
    got, want = _states(tfs, base), _states(jfs, base)
    assert got == want and len(got) > 3
    assert set(got.values()) == {
        "MUST_CACHE": {"NOT_PERSISTED"}, "CACHE_THROUGH": {"PERSISTED"},
        "THROUGH": {"PERSISTED"},
        "ASYNC_THROUGH": {"TO_BE_PERSISTED"}}[wt]
    reader = _jax_client(clusters["port"])
    try:
        like_p, like_o = jax_state("bfloat16")
        like_p = jax.tree.map(jax.numpy.zeros_like, like_p)
        got_p, got_o, step = jck.load_train_state(
            reader, f"{base}/step-2", like_params=like_p, like_opt=like_o)
    finally:
        reader.close()
    assert step == 2
    leaves = jax.tree_util.tree_leaves((got_p, got_o))
    ours = tree_leaves((model.param_tree(), state))
    assert len(leaves) == len(ours)
    for g, w in zip(leaves, ours):
        assert raw(g) == raw(w)


def test_save_pytree_passes_the_write_type(clusters):
    tfs = clusters["fs"]["alluxio_tpu_torch"]
    wt = _mod("alluxio_tpu_torch", "client.streams").WriteType
    tree = {"a": torch.arange(6, dtype=torch.float32), "b": torch.ones(3)}
    assert tck.save_pytree(tfs, "/tree-through", tree,
                           write_type=wt.THROUGH) == 2
    assert set(_states(tfs, "/tree-through").values()) == {"PERSISTED"}


# -- zero-copy views -----------------------------------------------------------
def _address(arr) -> int:
    return arr.__array_interface__["data"][0]


def test_shm_memoryview_is_the_block_with_no_copy(clusters):
    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.utils import ids

    port = clusters["port"]
    tfs = clusters["fs"]["alluxio_tpu_torch"]
    data = np.random.default_rng(40).integers(
        0, 256, BLOCK, dtype=np.uint8).tobytes()
    tfs.write_all("/mv/a", data, write_type=WriteType.MUST_CACHE)
    bid = tfs.get_status("/mv/a").block_ids[0]
    seen = []
    for pkg in PACKAGES:
        client = _mod(pkg, "rpc.clients").WorkerClient(
            port.workers[0].address)
        transport = _mod(pkg, "client.shm_transport").ShmTransport(
            ids.create_session_id())
        try:
            s = transport.open_stream(client, bid)
            mv = s.memoryview()
            view = s.numpy_view()
            seen.append((type(s).__name__, bytes(mv) == data,
                         _address(np.frombuffer(mv, np.uint8))
                         == _address(view), mv.readonly))
            del mv, view
        finally:
            transport.close()
    assert seen[1] == seen[0] == ("ShmBlockInStream", True, True, True)


def test_local_block_memoryview_is_the_mmap(clusters):
    from alluxio_tpu_torch.client.streams import WriteType
    from alluxio_tpu_torch.utils import ids

    port = clusters["port"]
    tfs = clusters["fs"]["alluxio_tpu_torch"]
    data = np.random.default_rng(41).integers(
        0, 256, BLOCK, dtype=np.uint8).tobytes()
    tfs.write_all("/mv/b", data, write_type=WriteType.MUST_CACHE)
    bid = tfs.get_status("/mv/b").block_ids[0]
    seen = []
    for pkg in PACKAGES:
        client = _mod(pkg, "rpc.clients").WorkerClient(
            port.workers[0].address)
        session = ids.create_session_id()
        s = _mod(pkg, "client.block_streams").LocalBlockInStream(
            client, session, bid)
        try:
            mv = s.memoryview()
            view = s.numpy_view()
            seen.append((s.source, bytes(mv) == data,
                         _address(np.frombuffer(mv, np.uint8))
                         == _address(view)))
            del mv, view
        finally:
            s.close()
            client.cleanup_session(session)
    assert seen[1] == seen[0] == ("LOCAL", True, True)


def test_base_stream_has_no_view_and_no_source():
    for pkg in PACKAGES:
        s = _mod(pkg, "client.block_streams").BlockInStream(1, 10)
        assert s.memoryview() is None
        with pytest.raises(NotImplementedError):
            s.source


# -- the remaining parameters and functions ------------------------------------
def test_read_plan_execute_scopes_faults_by_host():
    got = []
    for pkg in PACKAGES:
        fastpath = _mod(pkg, "client.fastpath")
        faults = _mod(pkg, "utils.faults")
        src = np.arange(4096, dtype=np.uint8)
        plan = fastpath.ReadPlan()
        plan.add_copy(src, 100, 1000, 0)
        plan.add_copy(src, 3000, 500, 1000)
        dest = np.zeros(1500, dtype=np.uint8)
        faults.injector().set(native_exec_error_rate=1.0, scope="shm")
        try:
            n = plan.execute(dest, host="remote")
            ok = dest.tobytes() == src[100:1100].tobytes() + \
                src[3000:3500].tobytes()
            try:
                plan.execute(dest, host="shm")
                shm = "no error"
            except fastpath.NativeExecError:
                shm = "NativeExecError"
            got.append((n, ok, shm,
                        faults.injector().injected["native_exec_error"]))
        finally:
            faults.injector().reset()
    assert got[1] == got[0] == (1500, True, "NativeExecError", 1)


def test_run_all_labels_every_row(monkeypatch, capsys):
    got = []
    for pkg in PACKAGES:
        suite = _mod(pkg, "stress.tpu_suite")

        def stage(*_a, _suite=suite, _name="s", **_kw):
            return _suite._row(_name, "metric", 1.0, "unit", 2.0, k=1)

        for name in ("config2_random_4k", "config3_prefetch",
                     "config4_projection", "config5_write_eviction"):
            monkeypatch.setattr(suite, name, stage)
        args = ((None,) if pkg == "alluxio_tpu" else ()) + ("fs", "cpu")
        rows = suite.run_all(*args, shard_bytes=1 << 20,
                             cold_write_rate=1e9,
                             row_extra={"host_fallback": True})
        got.append((rows, suite._ROW_EXTRA))
    assert got[1] == got[0]
    rows, after = got[0]
    assert len(rows) == 4 and after == {}
    assert all(r["host_fallback"] is True and r["k"] == 1 for r in rows)
    err = capsys.readouterr().err
    assert err.count('"host_fallback": true') == 8


def test_block_store_client_names_its_block_master():
    for pkg in PACKAGES:
        bm = object()
        client = _mod(pkg, "client.block_store").BlockStoreClient(bm)
        try:
            assert client.block_master is bm
        finally:
            client.close()


def test_local_page_store_close(tmp_path):
    for pkg in PACKAGES:
        ps = _mod(pkg, "client.cache.page_store")
        meta = _mod(pkg, "client.cache.meta")
        store = ps.LocalPageStore(str(tmp_path / pkg))
        store.put(meta.PageId("f", 0), b"abc")
        store.close()
        assert store.get(meta.PageId("f", 0)) == b"abc"


def test_create_job_id_from_the_same_seed():
    seqs = []
    for pkg in PACKAGES:
        ids = _mod(pkg, "utils.ids")
        old = ids._rng
        ids._rng = random.Random(17)
        try:
            seqs.append([ids.create_job_id() for _ in range(50)])
        finally:
            ids._rng = old
    assert seqs[1] == seqs[0]
    assert all(0 < i < (1 << 31) and i % 2 == 1 for i in seqs[0])
