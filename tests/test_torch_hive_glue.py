"""The port's Hive and Glue under-databases (``alluxio_tpu_torch/table/
{thrift_proto,hive,glue}.py``) against the JAX package's, on the CPU.

JAX's ``tests/test_hive_udb.py`` and ``tests/test_glue_udb.py``, each
scenario run through both packages:

- the thrift binary protocol writes the same bytes and reads them back to
  the same values, and the metastore URI parses alike;
- each package's ``HiveMetastoreClient`` asks the fake metastore
  (``tests/testutils/fake_hms.py``) through a recording relay, buffered
  and framed: the answers are equal and so are the bytes each client
  sent;
- the path translator and the Hive snapshot translate alike, and
  ``mount_translations`` reads each package's mount table: a table whose
  location is a UFS URI under a mount comes back as the same cluster
  path;
- each package's ``GlueClient`` against ``fake_glue.py`` through
  ``tests/testutils/torch_ufs.py``'s ``run_both`` (signer clocks
  pinned): the same answers and errors, and the same requests, SigV4
  headers included;
- ``table attachdb hive`` and ``attachdb glue`` through each package's
  table master snapshot the same catalog, and a projection read of the
  translated location returns the same rows.
"""

import importlib
import io
import os

import numpy as np
import pytest

pytest.importorskip("pyarrow")
pytest.importorskip("jax")

from tests.testutils import torch_serving as sv  # noqa: E402
from tests.testutils import torch_ufs as tu  # noqa: E402
from tests.testutils.fake_glue import FakeGlueServer, GlueTable  # noqa: E402
from tests.testutils.fake_hms import FakeHmsServer, HmsTable  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

PACKAGES = sv.PACKAGES


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _outcome(fn, *a, **kw):
    try:
        return ("ok", tu.norm(fn(*a, **kw)))
    except Exception as e:  # noqa: BLE001 - the outcome is the record
        return ("raise", type(e).__name__, str(e))


# -- the thrift protocol -----------------------------------------------------------
def _thrift_values(tp):
    return [
        (tp.BOOL, True), (tp.I32, -42), (tp.I64, 1 << 40),
        (tp.STRING, "héllo"), (tp.LIST, (tp.I32, [1, 2, 3])),
        (tp.MAP, (tp.STRING, tp.STRING, {"a": "b"})),
        (tp.STRUCT, [(1, tp.STRING, "nested")]),
    ]


def _thrift_script(pkg):
    tp = _mod(pkg, "table.thrift_proto")
    w = tp.Writer()
    w.write_value(tp.STRUCT, [(i + 1, t, v) for i, (t, v)
                              in enumerate(_thrift_values(tp))])
    scalar = w.data()
    m = tp.Writer().message("get_table", 1, 7)
    m.write_value(tp.STRUCT, [(1, tp.STRING, "db")])
    r = tp.Reader(m.data())
    unknown = tp.Writer()
    unknown.write_value(tp.STRUCT, [(99, tp.STRING, "future"),
                                    (1, tp.I32, 5)])
    hive = _mod(pkg, "table.hive")
    return (scalar, tp.Reader(scalar).struct(), m.data(),
            (r.message(), r.struct()), tp.Reader(unknown.data()).struct(),
            [_outcome(hive.parse_thrift_uri, u) for u in
             ("thrift://h:9083", "h:9083", "http://h:9083",
              "thrift://justhost")])


def test_thrift_protocol_like_jax():
    got = [_thrift_script(pkg) for pkg in PACKAGES]
    assert got[1] == got[0]
    decoded = got[1][1]
    assert decoded[1] is True and decoded[3] == 1 << 40
    assert decoded[5] == [1, 2, 3] and decoded[7] == {1: "nested"}
    assert got[1][3] == (("get_table", 1, 7), {1: "db"})
    assert got[1][5][0] == ("ok", ("h", 9083))
    assert got[1][5][2][0] == "raise"


# -- the metastore client -------------------------------------------------------------
def _orders():
    return HmsTable(
        "orders", "hdfs://nn/warehouse/orders",
        cols=[("id", "bigint"), ("qty", "int")], partition_keys=["ds"],
        partitions={f"ds=2024-01-0{d}":
                    f"hdfs://nn/warehouse/orders/ds=2024-01-0{d}"
                    for d in (1, 2)})


def _hms_script(pkg, port, framed):
    hive = _mod(pkg, "table.hive")
    out = []
    with hive.HiveMetastoreClient("127.0.0.1", port, framed=framed) as c:
        out.append(_outcome(c.get_all_databases))
        out.append(_outcome(c.get_database, "sales_db"))
        out.append(_outcome(c.get_database, "nope"))
        out.append(_outcome(c.get_all_tables, "sales_db"))
        out.append(_outcome(c.get_table, "sales_db", "orders"))
        out.append(_outcome(c.get_partitions, "sales_db", "orders"))
        out.append(_outcome(c.get_table, "sales_db", "nope"))
        for _ in range(20):  # many calls, one connection
            out.append(_outcome(c.get_all_tables, "sales_db"))
    return out


@pytest.mark.parametrize("framed", [False, True],
                         ids=["buffered", "framed"])
def test_metastore_client_sends_the_bytes_jax_sends(framed):
    got, sent = [], []
    with FakeHmsServer() as hms:
        hms.add_table("sales_db", _orders())
        for pkg in PACKAGES:
            relay = sv.HmsRelay(hms.port, framed=framed)
            try:
                got.append(_hms_script(pkg, relay.port, framed))
            finally:
                relay.close()
            sent.append(bytes(relay.sent))
        calls = list(hms.state.calls)
    assert got[1] == got[0]
    assert sent[1] == sent[0] and sent[1]
    assert calls[:len(calls) // 2] == calls[len(calls) // 2:]
    assert got[1][0] == ("ok", ["sales_db"])
    table = got[1][4][1]
    assert table[1] == "orders" and table[7][2] == \
        "hdfs://nn/warehouse/orders"
    assert len(got[1][5][1]) == 2
    assert got[1][6][:2] == ("raise", "NotFoundError")


# -- translation and the snapshot ---------------------------------------------------
def _translate_script(pkg, uri):
    hive = _mod(pkg, "table.hive")
    t = hive.PathTranslator({"hdfs://nn/warehouse": "/mnt/w",
                             "hdfs://nn/warehouse/hot": "/hot",
                             "s3://bucket": "/s3"})
    out = [t.translate(u) for u in (
        "hdfs://nn/warehouse/t1", "hdfs://nn/warehouse/hot/t2",
        "s3://bucket/a/b", "gs://other/x", "hdfs://nn/warehouse")]
    out.append(_outcome(lambda: hive.HiveUnderDatabase(
        None, "thrift://h:9083").database_name()))
    udb = hive.HiveUnderDatabase(
        None, uri, "db1",
        {"path_translations": "hdfs://nn/warehouse=/mnt/w"})
    out.append(_outcome(udb.table_names))
    out.append(_outcome(udb.get_table, "t1"))
    out.append(_outcome(udb.get_table, "t"))
    out.append(_outcome(udb.get_table, "absent"))
    return out


def test_translation_and_snapshot_like_jax():
    with FakeHmsServer() as hms:
        hms.add_table("db1", HmsTable(
            "t1", "hdfs://nn/warehouse/t1",
            cols=[("id", "bigint"), ("name", "string")],
            partition_keys=["year"],
            partitions={f"year={y}": f"hdfs://nn/warehouse/t1/year={y}"
                        for y in (2019, 2020)}))
        hms.add_table("db1", HmsTable("t", "s3://elsewhere/t",
                                      cols=[("a", "int")]))
        got = [_translate_script(pkg, hms.uri) for pkg in PACKAGES]
    assert got[1] == got[0]
    assert got[1][:5] == ["/mnt/w/t1", "/hot/t2", "/s3/a/b", None,
                          "/mnt/w"]
    assert got[1][5][:2] == ("raise", "NotFoundError")
    assert got[1][6] == ("ok", ["t", "t1"])
    assert "/mnt/w/t1/year=2019" in str(got[1][7])
    assert "s3://elsewhere/t" in str(got[1][8])


# -- the clusters -------------------------------------------------------------------------
def _parquet_bytes(rows, seed):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    t = pa.table({
        "id": rng.integers(0, 1 << 30, size=rows, dtype=np.int64),
        "qty": rng.integers(0, 100, size=rows, dtype=np.int32),
    })
    sink = io.BytesIO()
    pq.write_table(t, sink)
    return sink.getvalue()


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    """One warehouse directory on local disk that both packages' clusters
    mount at ``/mnt/wh``: its UFS URI is the same in both mount tables."""
    wh = tmp_path_factory.mktemp("warehouse")
    for year in (2019, 2020):
        d = wh / "sales" / f"year={year}"
        os.makedirs(d)
        (d / "part-0.parquet").write_bytes(_parquet_bytes(50, seed=year))
    clusters = {}
    try:
        for pkg in PACKAGES:
            c = _mod(pkg, "minicluster.local_cluster").LocalCluster(
                str(tmp_path_factory.mktemp(pkg.split("_")[-1])),
                num_workers=1, start_worker_heartbeats=True).start()
            clusters[pkg] = c
            fs = c.file_system()
            fs.create_directory("/mnt", allow_exists=True)
            fs.mount("/mnt/wh", str(wh))
        yield str(wh), clusters
    finally:
        for c in clusters.values():
            c.stop()


def test_mount_translations_read_the_mount_table(warehouse):
    """A Hive location that is a UFS URI under a mount comes back as the
    cluster path JAX gives."""
    wh, clusters = warehouse
    got = []
    for pkg in PACKAGES:
        hive = _mod(pkg, "table.hive")
        fs = clusters[pkg].file_system()
        mapping = hive.mount_translations(fs)
        t = hive.PathTranslator(mapping)
        got.append((mapping.get(wh), t.translate(f"{wh}/sales/year=2019"),
                    t.translate("hdfs://elsewhere/x")))
    assert got[1] == got[0] == ("/mnt/wh", "/mnt/wh/sales/year=2019", None)


def _attach(pkg, cluster, udb_type, uri, db, options):
    from_reader = _mod(pkg, "table.reader").read_columns
    tc = _mod(pkg, "rpc.table_service").TableMasterClient(
        cluster.master.address)
    name = tc.attach_database(udb_type, uri, db, options=options)
    t = tc.get_table(db, "sales")
    cols = from_reader(cluster.file_system(),
                       ["/mnt/wh/sales/year=2019/part-0.parquet"], ["qty"])
    return (name, tc.get_all_tables(db), t["location"],
            sorted((p["spec"], p["location"]) for p in t["partitions"]),
            t["schema"], cols.column("qty").to_pylist())


def test_attachdb_hive_like_jax(warehouse):
    wh, clusters = warehouse
    got, sent = [], []
    with FakeHmsServer() as hms:
        hms.add_table("salesdb", HmsTable(
            "sales", "hdfs://nn/wh/sales",
            cols=[("id", "bigint"), ("qty", "int")],
            partition_keys=["year"],
            partitions={f"year={y}": f"hdfs://nn/wh/sales/year={y}"
                        for y in (2019, 2020)}))
        for pkg in PACKAGES:
            relay = sv.HmsRelay(hms.port)
            try:
                got.append(_attach(
                    pkg, clusters[pkg], "hive", relay.uri, "salesdb",
                    {"path_translations": "hdfs://nn/wh=/mnt/wh"}))
            finally:
                relay.close()
            sent.append(bytes(relay.sent))
    assert got[1] == got[0]
    assert sent[1] == sent[0] and sent[1]
    name, tables, location, parts, schema, qty = got[1]
    assert (name, tables, location) == ("salesdb", ["sales"],
                                        "/mnt/wh/sales")
    assert [p[0] for p in parts] == ["year=2019", "year=2020"]
    assert {c["name"] for c in schema} == {"id", "qty"} and len(qty) == 50


# -- Glue ----------------------------------------------------------------------------------
def _sales_table(location="s3://wh/sales"):
    return GlueTable(
        "sales", location, cols=[("id", "bigint"), ("qty", "int")],
        partition_keys=["year"],
        partitions={f"year={y}": f"{location}/year={y}"
                    for y in (2019, 2020)})


def _glue_script(pkg, srv, trace):
    glue = _mod(pkg, "table.glue")
    for i in range(5):
        srv.add_table("paged", GlueTable(f"t{i}", f"s3://wh/t{i}"))
    srv.add_table("db1", _sales_table())
    srv.add_table("db1", GlueTable("flat", "s3://wh/flat",
                                   cols=[("a", "int")]))
    signed = glue.GlueClient(region="us-east-1", endpoint=srv.endpoint,
                             access_key="AKIATEST", secret_key="s3cr3t",
                             catalog_id="123456789012")
    unsigned = glue.GlueClient(region="", endpoint=srv.endpoint)
    trace("db", signed.get_database, "db1")
    trace("missing db", signed.get_database, "nope")
    trace("tables", signed.get_tables, "db1")
    trace("paged", signed.get_tables, "paged")
    trace("table", signed.get_table, "db1", "sales")
    trace("partitions", signed.get_partitions, "db1", "sales")
    trace("unsigned", unsigned.get_tables, "db1")
    trace("no region", glue.GlueClient, region="")
    udb = glue.GlueUnderDatabase(
        None, srv.endpoint, "db1",
        options={"path_translations": "s3://wh=/mnt/wh",
                 "aws.accesskey": "AKIATEST", "aws.secretkey": "s3cr3t"})
    trace("udb tables", udb.table_names)
    trace("udb sales", udb.get_table, "sales")
    trace("udb flat", udb.get_table, "flat")
    trace("udb no name", glue.GlueUnderDatabase(
        None, srv.endpoint, "", options={}).table_names)


def test_glue_client_sends_the_requests_jax_sends():
    runs = tu.run_both(FakeGlueServer, _glue_script,
                       {"access_key": "AKIATEST", "page_size": 2})
    jax, port = runs[sv.JAX], runs[sv.PORT]
    assert port.observed == jax.observed
    assert port.requests == jax.requests
    rows = {r[0]: r[1:] for r in port.observed}
    assert rows["db"] == ("ok", {"Name": "db1"})
    assert rows["missing db"][:2] == ("raise", "NotFoundError")
    assert rows["unsigned"][:2] == ("raise", "UnavailableError")
    assert rows["no region"][:2] == ("raise", "ValueError")
    assert sorted(t["Name"] for t in rows["paged"][1]) == \
        [f"t{i}" for i in range(5)]
    assert port.server.requests.count("AWSGlue.GetTables") == 2 + 3 + 1
    assert "/mnt/wh/sales/year=2019" in str(rows["udb sales"])
    assert any(k == "Authorization" and "/glue/aws4_request" in v
               for _m, _p, hdrs in port.requests for k, v in hdrs)


def test_attachdb_glue_like_jax(warehouse):
    wh, clusters = warehouse
    got = []
    with FakeGlueServer() as srv:
        srv.add_table("gluedb", _sales_table("s3://glue-wh/sales"))
        for pkg in PACKAGES:
            got.append(_attach(
                pkg, clusters[pkg], "glue", srv.endpoint, "gluedb",
                {"path_translations": "s3://glue-wh=/mnt/wh"}))
    assert got[1] == got[0]
    name, tables, location, parts, schema, qty = got[1]
    assert (name, tables, location) == ("gluedb", ["sales"],
                                        "/mnt/wh/sales")
    assert [p[1] for p in parts] == ["/mnt/wh/sales/year=2019",
                                     "/mnt/wh/sales/year=2020"]
    assert len(qty) == 50
