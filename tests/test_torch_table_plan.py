"""The port's Parquet footer/range planner against the JAX package's, on
the CPU.

On seeded Parquet bytes (a few row groups, mixed types, a small
``row_group_size``), each written once and fed to both packages in one
process: ``read_footer`` (one tail read, or a second exact one when the
footer outgrows the guess), ``coalesce`` (seeded and hypothesis-drawn
range lists and slacks), ``plan_row_groups`` for several projections
(none, a subset, a nested root, an unknown name) and the
``FooterCache`` bound and eviction order give equal results, compared as
tuples; a file that is not Parquet raises ``ParquetPlanError`` in both.
"""

import importlib
import io

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

pytest.importorskip("torch")
pytest.importorskip("jax")

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")


def _plan(pkg: str):
    return importlib.import_module(f"{pkg}.table.plan")


@pytest.fixture(autouse=True)
def _fresh_caches():
    for pkg in PACKAGES:
        _plan(pkg).footer_cache().clear()
        _plan(pkg)._PLAN_CACHE.clear()
    yield


def _parquet(seed: int, rows: int = 600, row_group_size: int = 128,
             compression: str = "snappy") -> bytes:
    """Mixed types: ints, floats, strings with a dictionary, a bool, a
    nested struct and a list column."""
    rng = np.random.default_rng(seed)
    t = pa.table({
        "i64": rng.integers(0, 1 << 40, size=rows, dtype=np.int64),
        "i32": rng.integers(-1000, 1000, size=rows, dtype=np.int32),
        "f32": rng.standard_normal(rows).astype(np.float32),
        "name": [f"n{int(v)}" for v in rng.integers(0, 17, size=rows)],
        "flag": rng.random(rows) < 0.5,
        "point": pa.StructArray.from_arrays(
            [pa.array(rng.standard_normal(rows)),
             pa.array(rng.integers(0, 9, size=rows))], names=["x", "y"]),
        "tags": [[int(v)] * int(v % 3) for v in
                 rng.integers(0, 50, size=rows)],
    })
    sink = io.BytesIO()
    pq.write_table(t, sink, row_group_size=row_group_size,
                   compression=compression)
    return sink.getvalue()


def _footer_tuple(f) -> tuple:
    md = f.metadata
    return (f.tail_offset, f.tail, md.num_rows, md.num_row_groups,
            md.num_columns, md.serialized_size)


def _plan_tuple(plans) -> list:
    return [(p.index, p.num_rows, [tuple(r) for r in p.ranges],
             [tuple(r) for r in p.reads], p.projected_bytes)
            for p in plans]


# -- read_footer ---------------------------------------------------------------
@pytest.mark.parametrize("guess", [64 << 10, 256, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_read_footer_equal(seed, guess):
    data = _parquet(seed)
    got = []
    for pkg in PACKAGES:
        calls = []

        def pread(off, n):
            calls.append((off, n))
            return data[off:off + n]

        f = _plan(pkg).read_footer(pread, len(data), guess_bytes=guess)
        got.append((_footer_tuple(f), calls))
    assert got[0] == got[1]
    footer_len = int.from_bytes(data[-8:-4], "little")
    # one tail read when the footer fits the guess, else one more exact
    assert len(got[1][1]) == (1 if footer_len + 8 <= max(8, guess) else 2)


@pytest.mark.parametrize("junk", [b"x" * 64, b"PAR1" * 3, b"abc",
                                  b"\x00" * 60 + b"\xff\xff\x00\x00PAR1"])
def test_unplannable_file_raises_in_both(junk):
    errors = []
    for pkg in PACKAGES:
        with pytest.raises(Exception) as e:
            _plan(pkg).read_footer(lambda o, n: junk[o:o + n], len(junk))
        assert type(e.value).__name__ == "ParquetPlanError"
        errors.append(str(e.value).split(":")[0])
    assert errors[0] == errors[1]


# -- coalesce ------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_coalesce_equal_on_seeded_ranges(seed):
    rng = np.random.default_rng(seed)
    ranges = [(int(o), int(n)) for o, n in zip(
        rng.integers(0, 10_000, size=40), rng.integers(0, 500, size=40))]
    for slack in (0, 1, 64, 4096):
        got = [_plan(pkg).coalesce(ranges, slack=slack)
               for pkg in PACKAGES]
        assert got[0] == got[1]


@settings(max_examples=60, deadline=None)
@given(ranges=st.lists(st.tuples(st.integers(0, 1 << 20),
                                 st.integers(0, 1 << 12)), max_size=30),
       slack=st.integers(0, 1 << 14))
def test_coalesce_equal_hypothesis(ranges, slack):
    got = [_plan(pkg).coalesce(ranges, slack=slack) for pkg in PACKAGES]
    assert got[0] == got[1]
    merged = got[1]
    # ascending, non-overlapping, gaps above the slack, every byte covered
    for (o1, n1), (o2, _n2) in zip(merged, merged[1:]):
        assert o2 - (o1 + n1) > slack
    for off, n in ranges:
        if n > 0:
            assert any(o <= off and off + n <= o + m for o, m in merged)


# -- plan_row_groups -----------------------------------------------------------
PROJECTIONS = (None, ["i32"], ["f32", "name"], ["point"], ["point.x", "i64"],
               ["tags", "flag"], ["nope"], ["i32", "nope"], [])


@pytest.mark.parametrize("columns", PROJECTIONS, ids=lambda c: repr(c))
@pytest.mark.parametrize("slack", [0, 256 << 10])
def test_plan_row_groups_equal(columns, slack):
    data = _parquet(3)
    md = pq.read_metadata(pa.BufferReader(data))
    got = [_plan_tuple(_plan(pkg).plan_row_groups(md, columns, slack=slack))
           for pkg in PACKAGES]
    assert got[0] == got[1]
    assert len(got[1]) == md.num_row_groups == 5


def test_plan_subset_of_row_groups_equal():
    md = pq.read_metadata(pa.BufferReader(_parquet(4)))
    got = [_plan_tuple(_plan(pkg).plan_row_groups(md, ["i64", "name"],
                                                  row_groups=[3, 1]))
           for pkg in PACKAGES]
    assert got[0] == got[1]
    assert [p[0] for p in got[1]] == [3, 1]


def test_unknown_column_plans_nothing_in_both():
    """An unknown name plans no range in either package (neither raises
    ``ParquetPlanError`` for it: the name is left to pyarrow's decode,
    as on the legacy path; ``tests/test_torch_table_reads.py`` holds the
    readers' results equal)."""
    data = _parquet(5)
    md = pq.read_metadata(pa.BufferReader(data))
    got = [_plan_tuple(_plan(pkg).plan_row_groups(md, ["nope"]))
           for pkg in PACKAGES]
    assert got[0] == got[1]
    assert all(p[2] == [] and p[3] == [] for p in got[1])


def test_cached_plan_keys_on_version_and_projection():
    data = _parquet(6)
    md = pq.read_metadata(pa.BufferReader(data))

    class Info:
        file_id, length, last_modification_time_ms = 7, len(data), 1000

    got = []
    for pkg in PACKAGES:
        mod = _plan(pkg)
        a = mod.cached_plan("/p", Info, md, ["i32"])
        b = mod.cached_plan("/p", Info, md, ["i32"])
        c = mod.cached_plan("/p", Info, md, ["i32"], slack=1)
        got.append((a is b, a is c, _plan_tuple(a), mod._PLAN_CACHE.size()))
    assert got[0] == got[1]
    assert got[1][:2] == (True, False) and got[1][3] == 2


# -- FooterCache ---------------------------------------------------------------
@pytest.mark.parametrize("cap", [1, 2, 5])
def test_footer_cache_bound_and_eviction_order(cap):
    """The same seeded script of puts, gets and a re-configure leaves the
    same keys, in the same LRU order, in both packages' caches."""
    rng = np.random.default_rng(cap)
    script = [(("put", "get")[int(rng.integers(0, 2))],
               int(rng.integers(0, 8))) for _ in range(60)]
    got = []
    for pkg in PACKAGES:
        c = _plan(pkg).FooterCache(max_entries=cap)
        trace = []
        for op, k in script:
            if op == "put":
                c.put((k,), f"v{k}")
            else:
                trace.append(c.get((k,)))
            trace.append((c.size(), list(c._entries)))
        c.configure(1)
        trace.append(list(c._entries))
        got.append(trace)
    assert got[0] == got[1]
    assert max(t[0] for t in got[1] if isinstance(t, tuple)) == cap


def test_cached_footer_hits_and_misses_alike():
    data = _parquet(7)

    class Info:
        file_id, length, last_modification_time_ms = 3, len(data), 1000

    class Rewritten(Info):
        last_modification_time_ms = 2000

    got = []
    for pkg in PACKAGES:
        reads = []

        def pread(off, n):
            reads.append(n)
            return data[off:off + n]

        mod = _plan(pkg)
        f1 = mod.cached_footer(pread, "/p", Info)
        f2 = mod.cached_footer(pread, "/p", Info)
        mod.cached_footer(pread, "/p", Rewritten)
        got.append((f1 is f2, reads, _footer_tuple(f1),
                    mod.metadata_version(Rewritten)))
    assert got[0] == got[1]
    assert got[1][0] and len(got[1][1]) == 2
