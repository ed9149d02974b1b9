"""The port's retry policies against the JAX package's: with the sleep
recorded and the jitter drawn from one seeded ``random.Random``, each
policy gives the same sequence of attempts and sleeps in both packages,
on its own and under ``retry()`` (a call that fails a seeded number of
times with a retryable error, then succeeds or runs the policy out)."""

import random

import pytest

from alluxio_tpu.utils import exceptions as jexc  # noqa: E402
from alluxio_tpu.utils import retry as jretry  # noqa: E402
from alluxio_tpu_torch.utils import exceptions as texc  # noqa: E402
from alluxio_tpu_torch.utils import retry as tretry  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

PACKAGES = ((jretry, jexc), (tretry, texc))


def _policy(mod, name: str, sleeps: list, seed: int):
    rng = random.Random(seed)
    if name == "NoRetryPolicy":
        return mod.NoRetryPolicy()
    if name == "CountingRetry":
        return mod.CountingRetry(3)
    if name == "SleepingRetry":
        return mod.SleepingRetry(4, 0.25, sleep_fn=sleeps.append)
    return mod.ExponentialBackoffRetry(0.1, 1.5, 6, sleep_fn=sleeps.append,
                                       rng=rng)


POLICIES = ("NoRetryPolicy", "CountingRetry", "SleepingRetry",
            "ExponentialBackoffRetry")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", POLICIES)
def test_attempts_and_sleeps_equal_jax(name, seed):
    out = []
    for mod, _ in PACKAGES:
        sleeps = []
        policy = _policy(mod, name, sleeps, seed)
        attempts = []
        for _ in range(12):
            attempts.append((policy.attempt(), policy.attempt_count))
        out.append((attempts, sleeps))
    assert out[1] == out[0]
    assert any(ok for ok, _ in out[0][0])


@pytest.mark.parametrize("failures", [0, 2, 20])
@pytest.mark.parametrize("name", POLICIES)
def test_retry_helper_equal_jax(name, failures):
    out = []
    for mod, exc in PACKAGES:
        sleeps, calls = [], []

        def fn():
            calls.append(len(calls))
            if len(calls) <= failures:
                raise exc.UnavailableError(f"try {len(calls)}")
            return "done"

        policy = _policy(mod, name, sleeps, 5)
        try:
            got = mod.retry(fn, policy)
        except exc.UnavailableError as e:
            got = f"raised {e}"
        out.append((got, len(calls), sleeps, policy.attempt_count))
    assert out[1] == out[0]


def test_default_jitter_draws_from_random(monkeypatch):
    """Without ``rng``, ``ExponentialBackoffRetry`` draws from a fresh
    ``random.Random()``: patched to a seeded one, both packages sleep
    alike."""
    out = []
    for mod, _ in PACKAGES:
        monkeypatch.setattr(random, "Random",
                            lambda *a, _r=random.Random: _r(11))
        sleeps = []
        policy = mod.ExponentialBackoffRetry(0.2, 2.0, 5,
                                             sleep_fn=sleeps.append)
        while policy.attempt():
            pass
        monkeypatch.undo()
        out.append(sleeps)
    assert out[1] == out[0] and len(out[0]) == 5
