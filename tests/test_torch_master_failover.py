"""The master clients' failover against the JAX package's, on the CPU.

Both packages' ``FsMasterClient`` get the same comma-separated master
lists over the same small servers, and what each sees must be equal: the
answer or the error type, the master the client ends on, the masters it
knows, the calls each server took, and its ``Client.FailoverRedirects``
and ``Client.FailoverRotations`` counts.

- rotation: the first master refuses connections (a port that is bound
  but never listens), the second answers;
- leader hint: the first master names the primary in a
  ``NotPrimaryError``, the client goes there at once, also when the
  primary is not in its list;
- a hint-less ``NotPrimaryError`` rotates to the next master;
- two masters that each name the other give up with the typed error;
- the retry policy: three leader hints a call are retried at once, later
  ones and connection losses back off, with the same sleeps as JAX's.
"""

import importlib
import random
import socket
import threading

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class _Master:
    """A port RPC server holding the FS service's ``get_status``: it
    answers with a fixed ``FileInfo``, or raises ``NotPrimaryError``
    naming ``leader`` (set after start, so two can name each other)."""

    def __init__(self, primary: bool) -> None:
        core = _mod("alluxio_tpu_torch", "rpc.core")
        ms = _mod("alluxio_tpu_torch", "rpc.master_service")
        self.primary = primary
        self.leader = None
        self.calls = 0
        self._lock = threading.Lock()
        svc = core.ServiceDefinition(ms.FS_SERVICE)
        svc.unary("get_status", self._get_status)
        self._server = core.RpcServer("127.0.0.1", 0)
        self._server.add_service(svc)
        self.address = f"127.0.0.1:{self._server.start()}"

    def _get_status(self, req):
        exc = _mod("alluxio_tpu_torch", "utils.exceptions")
        wire = _mod("alluxio_tpu_torch", "utils.wire")
        with self._lock:
            self.calls += 1
        if not self.primary:
            raise exc.NotPrimaryError("not the primary", leader=self.leader)
        return wire.FileInfo(file_id=7, name="f", path=req["path"],
                             length=42, completed=True).to_wire()

    def stop(self):
        self._server.stop(0)


@pytest.fixture
def dead_address():
    """An address whose port is taken but refuses every connection."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    yield f"127.0.0.1:{s.getsockname()[1]}"
    s.close()


def _observe(pkg, address, masters, budget_s):
    clients = _mod(pkg, "rpc.clients")
    reg = _mod(pkg, "metrics").metrics()
    names = ("Client.FailoverRedirects", "Client.FailoverRotations")
    before = [reg.counter(n).count for n in names]
    for m in masters:
        m.calls = 0
    c = clients.FsMasterClient(address, fastpath=False,
                               retry_duration_s=budget_s, base_sleep_s=0.01,
                               max_sleep_s=0.05)
    try:
        out = c.get_status("/a").to_wire()
    except Exception as e:  # noqa: BLE001 - the type is the observation
        out = type(e).__name__
    return {"out": out,
            "active": c._addresses[c._active],
            "known": list(c._addresses),
            "calls": [m.calls for m in masters],
            "counters": [reg.counter(n).count - b
                         for n, b in zip(names, before)]}


def _both(address, masters, keys=("out", "active", "known", "calls",
                                   "counters"), budget_s=5.0):
    obs = [_observe(pkg, address, masters, budget_s) for pkg in PACKAGES]
    assert [obs[1][k] for k in keys] == [obs[0][k] for k in keys]
    return obs[1]


def test_rotation_past_a_dead_master_matches_jax(dead_address):
    primary = _Master(True)
    try:
        obs = _both(f"{dead_address},{primary.address}", [primary])
    finally:
        primary.stop()
    assert obs["active"] == primary.address
    assert obs["out"]["length"] == 42 and obs["calls"] == [1]
    assert obs["counters"] == [0, 1]


@pytest.mark.parametrize("listed", [True, False])
def test_leader_hint_matches_jax(listed):
    primary, standby = _Master(True), _Master(False)
    standby.leader = primary.address
    masters = [standby, primary]
    address = ",".join(m.address for m in (masters if listed
                                           else masters[:1]))
    try:
        obs = _both(address, masters)
    finally:
        for m in masters:
            m.stop()
    assert obs["active"] == primary.address
    assert obs["known"] == [standby.address, primary.address]
    assert obs["calls"] == [1, 1] and obs["counters"] == [1, 0]


def test_hintless_refusal_rotates_like_jax():
    primary, standby = _Master(True), _Master(False)
    masters = [standby, primary]
    try:
        obs = _both(",".join(m.address for m in masters), masters)
    finally:
        for m in masters:
            m.stop()
    assert obs["active"] == primary.address
    assert obs["calls"] == [1, 1] and obs["counters"] == [0, 1]


def test_masters_naming_each_other_give_up_like_jax():
    a, b = _Master(False), _Master(False)
    a.leader, b.leader = b.address, a.address
    masters = [a, b]
    try:
        # how often they bounce before the budget ends is timing
        obs = _both(a.address, masters, keys=("out", "known"),
                    budget_s=0.5)
    finally:
        for m in masters:
            m.stop()
    assert obs["out"] == "NotPrimaryError"
    assert obs["known"] == [a.address, b.address]


def test_leader_hints_retry_at_once_like_jax():
    obs = []
    for pkg in PACKAGES:
        rt, exc = _mod(pkg, "utils.retry"), _mod(pkg, "utils.exceptions")
        sleeps = []
        policy = rt.ExponentialTimeBoundedRetry(
            10.0, 0.1, 1.0, time_fn=lambda: 0.0, sleep_fn=sleeps.append,
            rng=random.Random(0))
        errors = iter([exc.NotPrimaryError(leader="h:1")] * 5
                      + [exc.UnavailableError("down")] * 2)

        def fn(errors=errors):
            e = next(errors, None)
            if e is not None:
                raise e
            return "ok"

        obs.append((rt.retry(fn, policy), sleeps, policy.attempt_count))
    assert obs[1] == obs[0]
    assert len(obs[1][1]) == 4 and obs[1][2] == 5
