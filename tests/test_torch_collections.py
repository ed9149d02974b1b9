"""The port's ``utils/collections.py`` against the JAX package's.

Mirrors the collections cases of JAX's ``tests/test_foundation.py``:
``IndexedSet`` with unique and non-unique ``FieldIndex``es, the
``DirectedAcyclicGraph`` and ``PrefixList``. One seeded sequence of calls
goes through each package's classes, and every outcome (value or
exception) must be equal.
"""

from __future__ import annotations

import random
import sys
import threading

import pytest

from tests.test_torch_underfs_connectors import _outcomes
from tests.testutils import torch_ufs as tu
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

JAX, PORT = tu.JAX, tu.PORT


def _both(script, seed):
    got = {}
    for pkg in tu.PACKAGES:
        trace = tu.Trace()
        script(tu.mod(pkg, "utils.collections"), random.Random(seed), trace)
        got[pkg] = trace.rows
    assert got[PORT] == got[JAX]
    return got[PORT]


def _indexed_set(c, rng, trace):
    s = c.IndexedSet(c.FieldIndex("id", lambda w: w[0], unique=True),
                     c.FieldIndex("host", lambda w: w[1]))
    for step in range(300):
        op = rng.randrange(6)
        wid, host = rng.randrange(40), f"h{rng.randrange(6)}"
        if op in (0, 1):
            trace(f"{step} add", s.add, (wid, host))
        elif op == 2:
            trace(f"{step} remove", s.remove, (wid, host))
        elif op == 3:
            trace(f"{step} get_by", lambda: sorted(s.get_by("host", host)))
        elif op == 4:
            trace(f"{step} first", s.get_first_by, "id", wid)
            trace(f"{step} contains", s.contains_by, "host", host)
        else:
            trace(f"{step} remove_by", s.remove_by, "host", host)
        trace(f"{step} len", len, s)
    trace("items", lambda: sorted(s))
    trace("no index", c.IndexedSet)


@pytest.mark.parametrize("seed", range(3))
def test_indexed_set_matches_jax(seed):
    rows = _both(_indexed_set, seed)
    assert any(r[1] == "raise" and r[2] == "ValueError" for r in rows)


def test_indexed_set_cases_of_the_jax_test():
    for pkg in tu.PACKAGES:
        c = tu.mod(pkg, "utils.collections")
        s = c.IndexedSet(c.FieldIndex("id", lambda w: w[0], unique=True),
                         c.FieldIndex("host", lambda w: w[1]))
        w1, w2 = (1, "h1"), (2, "h1")
        assert s.add(w1) and s.add(w2)
        assert s.get_first_by("id", 1) == w1
        assert s.get_by("host", "h1") == {w1, w2}
        with pytest.raises(ValueError):
            s.add((1, "h2"))  # unique id taken: the set is untouched
        assert len(s) == 2 and (1, "h2") not in s
        assert s.remove_by("host", "h1") == 2 and len(s) == 0


def _dag(c, rng, trace):
    d = c.DirectedAcyclicGraph()
    nodes = []
    for step in range(200):
        op = rng.randrange(5)
        if op in (0, 1, 2) or not nodes:
            node = f"n{rng.randrange(60)}"
            parents = rng.sample(nodes, min(len(nodes), rng.randrange(3)))
            if rng.random() < 0.1:
                parents.append("ghost")
            trace(f"{step} add", d.add, node, parents)
            if node in d and node not in nodes:
                nodes.append(node)
        elif op == 3:
            node = rng.choice(nodes)
            trace(f"{step} remove", d.remove, node)
            if node not in d:
                nodes.remove(node)
        else:
            node = rng.choice(nodes)
            trace(f"{step} edges", lambda: (sorted(d.parents(node)),
                                            sorted(d.children(node))))
        trace(f"{step} roots", lambda: sorted(d.roots()))
    trace("order", d.topological_order)
    trace("len", len, d)


@pytest.mark.parametrize("seed", range(3))
def test_dag_matches_jax(seed):
    rows = _both(_dag, seed)
    order = _outcomes(rows)["order"][1]
    assert len(order) == _outcomes(rows)["len"][1]


def test_dag_rejects_cycles_and_duplicates():
    for pkg in tu.PACKAGES:
        c = tu.mod(pkg, "utils.collections")
        d = c.DirectedAcyclicGraph()
        d.add("a")
        d.add("b", ["a"])
        d.add("c", ["a", "b"])
        assert d.roots() == ["a"]
        order = d.topological_order()
        assert order.index("a") < order.index("b") < order.index("c")
        with pytest.raises(ValueError):
            d.add("a")
        with pytest.raises(ValueError):
            d.remove("a")  # still has children


def test_prefix_list_matches_jax():
    rng = random.Random(5)
    paths = [rng.choice(["/tmp/", "/data/raw", "/data/other", "/x", ""]) +
             f"{rng.randrange(9)}" for _ in range(200)]

    def script(c, _rng, trace):
        p = c.PrefixList(["/tmp/", " /data/raw ", "", "  "])
        for path in paths:
            trace(path, lambda: (p.in_list(path), p.out_list(path)))

    seen = _outcomes(_both(script, 0))
    for path in paths:
        inside = path.startswith(("/tmp/", "/data/raw"))
        assert seen[path] == ("ok", (inside, not inside))
    assert any(v[1][0] for v in seen.values())


def test_indexed_set_under_threads():
    """Eight threads add and remove disjoint items with a short switch
    interval: no item is lost or duplicated in either index."""
    c = tu.mod(PORT, "utils.collections")
    s = c.IndexedSet(c.FieldIndex("id", lambda w: w[0], unique=True),
                     c.FieldIndex("host", lambda w: w[1]))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def work(t):
        for i in range(400):
            item = (t * 1000 + i, f"h{i % 3}")
            s.add(item)
            if i % 2:
                s.remove(item)

    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(s) == 8 * 200
    assert sum(len(s.get_by("host", f"h{h}")) for h in range(3)) == len(s)
