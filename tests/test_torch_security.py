"""The port's authentication against the JAX package's, on the CPU (the
counterparts of ``TestAuthentication``'s unit cases in
``tests/test_security.py``).

- NOSASL, SIMPLE and CUSTOM authentication and the impersonation
  allowlist resolve the same metadata to the same user (or refuse it with
  the same error) in both packages; ``client_metadata`` and
  ``worker_authenticator`` agree.
- The port's worker with QoS on authenticates every RPC: it sees the
  ``atpu-user`` of a JAX client and of a port client, hands it to the
  cold fetch and the async cache as their tenant, and refuses a call
  that names no user. With QoS off the server reads no metadata.
"""

import threading

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu.conf import Configuration as JaxConfiguration  # noqa: E402
from alluxio_tpu.security import authentication as jax_auth  # noqa: E402
from alluxio_tpu_torch.conf import Configuration  # noqa: E402
from alluxio_tpu_torch.security import authentication as auth  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

USER_KEY = "atpu-user"


def reject_bob_provider(user: str, token: str) -> None:
    if user == "bob":
        raise ValueError("bob is not welcome")


def _authenticators(values):
    return {"jax": jax_auth.Authenticator(
                JaxConfiguration(values, load_env=False)),
            "port": auth.Authenticator(Configuration(values,
                                                     load_env=False))}


def _outcome(authenticator, md):
    try:
        u = authenticator.authenticate(md)
    except Exception as e:  # noqa: BLE001 - compared by class name
        return type(e).__name__
    return None if u is None else (u.name, u.groups, u.connection_user)


def _same(values, mds):
    a = _authenticators(values)
    got = {n: [_outcome(x, md) for md in mds] for n, x in a.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def test_nosasl_binds_no_user():
    assert _same({"atpu.security.authentication.type": "NOSASL"},
                 [{USER_KEY: "alice"}, {}]) == [None, None]


def test_simple_takes_the_asserted_user_and_refuses_none():
    got = _same({}, [{USER_KEY: "alice"}, {}, {USER_KEY: ""}])
    assert got[0][0] == "alice" and got[0][2] is None
    assert got[1:] == ["UnauthenticatedError"] * 2


def test_custom_provider():
    got = _same({"atpu.security.authentication.type": "CUSTOM",
                 "atpu.security.authentication.custom.provider":
                     "tests.test_torch_security:reject_bob_provider"},
                [{USER_KEY: "alice", "atpu-token": "ok"},
                 {USER_KEY: "bob", "atpu-token": "ok"}])
    assert got[0][0] == "alice" and got[1] == "UnauthenticatedError"
    with pytest.raises(ValueError, match="custom.provider"):
        auth.Authenticator(Configuration(
            {"atpu.security.authentication.type": "CUSTOM"},
            load_env=False))


def test_impersonation_allowlist():
    got = _same({"atpu.master.security.impersonation.proxyd.users":
                     "alice,carol"},
                [{USER_KEY: "proxyd", "atpu-impersonate": "alice"},
                 {USER_KEY: "proxyd", "atpu-impersonate": "mallory"},
                 {USER_KEY: "otherd", "atpu-impersonate": "alice"},
                 {USER_KEY: "proxyd", "atpu-impersonate": "proxyd"}])
    assert got[0][0] == "alice" and got[0][2] == "proxyd"
    assert got[1] == got[2] == "PermissionDeniedError"
    assert got[3][0] == "proxyd" and got[3][2] is None


def test_wildcard_impersonation():
    got = _same({"atpu.master.security.impersonation.superproxy.users": "*"},
                [{USER_KEY: "superproxy", "atpu-impersonate": "anyone"}])
    assert got[0][:1] == ("anyone",) and got[0][2] == "superproxy"


def test_client_metadata_and_worker_authenticator_match_jax():
    values = {"atpu.security.login.username": "alice",
              "atpu.security.login.impersonation.username": "bob",
              "atpu.security.login.token": "t0k"}
    assert auth.client_metadata(Configuration(values, load_env=False)) == \
        jax_auth.client_metadata(JaxConfiguration(values, load_env=False))
    assert auth.client_metadata()[0][0] == USER_KEY
    for on in (False, True):
        v = {"atpu.worker.qos.enabled": str(on).lower()}
        mine = auth.worker_authenticator(Configuration(v, load_env=False))
        theirs = jax_auth.worker_authenticator(
            JaxConfiguration(v, load_env=False))
        assert (mine is None) == (theirs is None) == (not on)
        if on:
            assert mine.auth_type == theirs.auth_type == "SIMPLE"


# -- the port's worker on the wire ---------------------------------------------
def _worker(tmp_path, qos: bool):
    """The port's worker with its block files as the UFS (mount 1) behind
    a port ``RpcServer`` carrying ``worker_authenticator``; the tenants
    its async cache and cold fetches are handed are recorded."""
    from alluxio_tpu_torch.conf import Keys, Templates
    from alluxio_tpu_torch.rpc.core import RpcServer
    from alluxio_tpu_torch.rpc.worker_service import worker_service
    from alluxio_tpu_torch.underfs.registry import UfsManager
    from alluxio_tpu_torch.worker.process import BlockWorker

    from tests.testutils.torch_worker import StandInMaster

    conf = Configuration(load_env=False)
    conf.set(Keys.WORKER_TIERED_STORE_LEVELS, 1)
    conf.set(Templates.WORKER_TIER_DIRS_PATH.format(0), str(tmp_path / "mem"))
    conf.set(Templates.WORKER_TIER_DIRS_QUOTA.format(0), str(1 << 20))
    conf.set(Keys.WORKER_QOS_ENABLED, qos)
    ufs = UfsManager()
    ufs.add_mount(1, str(tmp_path))
    worker = BlockWorker(conf, StandInMaster(), ufs_manager=ufs)
    seen = []
    lock = threading.Lock()
    fetch, submit = worker.open_ufs_fetch, worker.async_cache.submit

    def open_ufs_fetch(desc, **kw):
        with lock:
            seen.append(("fetch", kw.get("tenant")))
        return fetch(desc, **kw)

    def async_submit(desc, **kw):
        with lock:
            seen.append(("async", kw.get("tenant")))
        return submit(desc, **kw)

    worker.open_ufs_fetch = open_ufs_fetch
    worker.async_cache.submit = async_submit
    server = RpcServer(bind_host="127.0.0.1", port=0,
                       authenticator=auth.worker_authenticator(conf))
    server.add_service(worker_service(worker))
    worker.address.rpc_port = server.start()
    worker.register_with_master()
    return worker, server, seen


def _clients(address, user):
    from alluxio_tpu.rpc.clients import WorkerClient as JaxWorkerClient
    from alluxio_tpu_torch.rpc.clients import WorkerClient

    md = ((USER_KEY, user),) if user is not None else ()
    return {"jax": JaxWorkerClient(address, metadata=md),
            "port": WorkerClient(address, metadata=md)}


@pytest.mark.parametrize("qos", [True, False])
def test_port_worker_sees_both_clients_principals(tmp_path, qos):
    data = np.random.default_rng(12).integers(
        0, 256, 8192, dtype=np.uint8).tobytes()
    (tmp_path / "blk").write_bytes(data)
    worker, server, seen = _worker(tmp_path, qos)
    address = f"127.0.0.1:{worker.address.rpc_port}"
    ufs = {"ufs_path": str(tmp_path / "blk"), "offset": 0, "length": 8192,
           "mount_id": 1}
    try:
        for i, (side, user) in enumerate((("jax", "alice"),
                                          ("port", "bob"))):
            client = _clients(address, user)[side]
            got = client.read_block_bytes(10 + i, ufs=ufs)
            assert got == data
            assert client.async_cache(20 + i, ufs["ufs_path"], 0, 8192,
                                      mount_id=1)
        assert worker.async_cache.wait_idle()
        want = ["alice", "alice", "bob", "bob"] if qos else [""] * 4
        assert seen == list(zip(["fetch", "async"] * 2, want))
        for side, client in _clients(address, None).items():
            if qos:
                with pytest.raises(Exception) as e:
                    client.read_block_bytes(10, ufs=ufs)
                assert type(e.value).__name__ == "UnauthenticatedError", \
                    side
            else:
                assert client.read_block_bytes(10, ufs=ufs) == data
    finally:
        server.stop()
        worker.stop()
