"""The port's cloud object-store connectors against the JAX package's.

Mirrors JAX's ``tests/test_{gcs_connector,azure_ozone,swift_vendors,
vendor_native}.py``: GCS's JSON API, Azure's Blob and ADLS Gen2 dialects
with SharedKey, Ozone over its S3 gateway, Swift's Keystone dialect, and
the native OSS, COS and Kodo wire auth. Each case runs one seeded script
through both packages, each against its own instance of the fake on one
port with the clocks pinned (``tests/testutils/torch_ufs.py``): results,
request lines, headers and signatures must be equal, and the fakes that
recompute signatures must have rejected none.
"""

from __future__ import annotations

import base64

import pytest
import requests

from tests.test_torch_underfs_connectors import (
    _assert_parity, _outcomes, _read_from, contract,
)
from tests.testutils import torch_ufs as tu
from tests.testutils.fake_azure import FakeAzureServer
from tests.testutils.fake_gcs import FakeGcsServer
from tests.testutils.fake_s3 import FakeS3Server
from tests.testutils.fake_swift import FakeSwiftServer
from tests.testutils.fake_vendors import (
    FakeCosServer, FakeKodoServer, FakeOssServer,
)
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

JAX, PORT = tu.JAX, tu.PORT
KEY_B64 = base64.b64encode(b"k" * 32).decode()
CREDS = {"swift.user": "u", "swift.password": "pw", "swift.project": "proj"}


# -- GCS --------------------------------------------------------------------------
def _gcs(pkg, srv, **props):
    return tu.mod(pkg, "underfs.gcs").GcsJsonClient(
        srv.bucket, {"gcs.endpoint": srv.endpoint, **props})


def test_gcs_client_matches_jax():
    """Put, ranged gets (416 as empty), head, a copy through three
    rewrite rounds, a paginated listing and deletes."""
    def script(pkg, srv, trace):
        c = _gcs(pkg, srv)
        trace("put", c.put, "d/obj.bin", b"payload-123")
        trace("get", c.get, "d/obj.bin")
        trace("range", c.get, "d/obj.bin", 3, 4)
        trace("tail", c.get, "d/obj.bin", 8)
        trace("past end", c.get, "d/obj.bin", 99, 2)
        trace("head", c.head, "d/obj.bin")
        trace("copy", c.copy, "d/obj.bin", "d/dst")
        trace("copy ghost", c.copy, "ghost", "d/x")
        for i in range(8):
            c.put(f"p/k{i}", b"x")
        trace("list", c.list_prefix, "p/")
        trace("delete", c.delete, "d/obj.bin")
        trace("gone", c.get, "d/obj.bin")
        trace("head gone", c.head, "d/obj.bin")

    runs = tu.run_both(FakeGcsServer, script,
                       {"rewrite_rounds": 3, "page_size": 3})
    seen = _outcomes(_assert_parity(runs))
    assert seen["range"] == ("ok", b"load")
    assert seen["past end"] == ("ok", b"")
    assert seen["copy"] == ("ok", True) and seen["copy ghost"] == ("ok", False)
    assert seen["list"] == ("ok", [f"p/k{i}" for i in range(8)])
    assert runs[PORT].server.requests == runs[JAX].server.requests
    assert sum("rewriteTo" in r for r in runs[PORT].server.requests) == 4


def test_gcs_bearer_token_matches_jax():
    def script(pkg, srv, trace):
        trace("good put", _gcs(pkg, srv, **{"gcs.token": "tok-abc"}).put,
              "a", b"1")
        trace("good get", _gcs(pkg, srv, **{"gcs.token": "tok-abc"}).get,
              "a")
        trace("bad put", _gcs(pkg, srv, **{"gcs.token": "wrong"}).put,
              "b", b"2")

    seen = _outcomes(_assert_parity(tu.run_both(
        FakeGcsServer, script, {"required_token": "tok-abc"})))
    assert seen["good get"] == ("ok", b"1")
    assert seen["bad put"][0] == "raise"


def test_gcs_ufs_contract_matches_jax():
    def script(pkg, srv, trace):
        ufs = tu.mod(pkg, "underfs.gcs").GcsUnderFileSystem(
            f"gs://{srv.bucket}/root", {"gcs.endpoint": srv.endpoint})
        contract(pkg, ufs, f"gs://{srv.bucket}/root", trace, 21)

    _assert_parity(tu.run_both(FakeGcsServer, script))


# -- Azure ------------------------------------------------------------------------
def _azure_runs(script, verify=True):
    runs = tu.run_both(FakeAzureServer, script,
                       {"verify_key_b64": KEY_B64} if verify else {})
    for run in runs.values():
        assert run.server.state.auth_failures == 0
    return runs


def _wasb(pkg, srv):
    return tu.mod(pkg, "underfs.azure").WasbUnderFileSystem(
        "wasb://cont@acct.blob.core.windows.net/",
        {"azure.endpoint": srv.endpoint, "azure.account.key": KEY_B64})


def _abfs(pkg, srv):
    return tu.mod(pkg, "underfs.azure").AdlsUnderFileSystem(
        "abfs://fsys@acct.dfs.core.windows.net/",
        {"azure.endpoint": srv.endpoint, "azure.account.key": KEY_B64})


def test_wasb_contract_matches_jax():
    """The Blob dialect, every request SharedKey-signed and re-verified
    by the fake."""
    def script(pkg, srv, trace):
        contract(pkg, _wasb(pkg, srv), "wasb://cont@a/x", trace, 31)
        trace("deep list", _ls_names, _wasb(pkg, srv), "wasb://cont@a/x")

    runs = _azure_runs(script)
    _assert_parity(runs)
    assert runs[PORT].server.state.auth_checked > 0


def test_abfs_contract_matches_jax():
    """The ADLS Gen2 dialect: create, append and flush; native rename;
    the JSON listing."""
    def script(pkg, srv, trace):
        contract(pkg, _abfs(pkg, srv), "abfs://fsys@a/p", trace, 32)

    _assert_parity(_azure_runs(script))


def test_azure_shared_store_and_dispatch_match_jax():
    """A blob written through wasb reads through the DFS dialect of the
    same container; the registry dispatches both schemes; a wrong key is
    rejected."""
    def script(pkg, srv, trace):
        azure = tu.mod(pkg, "underfs.azure")
        tu.write(_wasb(pkg, srv), "wasb://cont@a/shared.bin", b"both")
        both = azure.AdlsUnderFileSystem(
            "abfs://cont@acct.dfs.core.windows.net/",
            {"azure.endpoint": srv.endpoint})
        trace("dfs read", both.read_range, "abfs://cont@a/shared.bin", 0, 4)
        ufs = tu.mod(pkg, "underfs.registry").create_ufs(
            "wasb://c@acct.blob.core.windows.net/",
            {"azure.endpoint": srv.endpoint})
        trace("type", ufs.get_underfs_type)
        bad = azure.AzureBlobClient(
            "cont", "acct", "",
            {"azure.endpoint": srv.endpoint,
             "azure.account.key": base64.b64encode(b"wrong" * 8).decode()})
        trace("bad put", bad.put, "nope", b"x")
        trace("failures", lambda: srv.state.auth_failures)
        srv.state.auth_failures = 0

    seen = _outcomes(_assert_parity(_azure_runs(script)))
    assert seen["dfs read"] == ("ok", b"both")
    assert seen["type"] == ("ok", "wasb")
    assert seen["bad put"][0] == "raise" and seen["failures"] == ("ok", 1)


def test_shared_key_signature_matches_jax():
    key = base64.b64encode(b"secret-key-material").decode()
    signed = {}
    for pkg in tu.PACKAGES:
        s = tu.mod(pkg, "underfs.azure")._SharedKey("acct", key)
        signed[pkg] = [s.sign(m, u, {"x-ms-date": "Wed, 01 Jan 2025 "
                                                  "00:00:00 GMT",
                                     "x-ms-version": "2021-08-06", **h})
                       for m, u, h in (
                           ("GET", "https://acct.blob.core.windows.net/c/k",
                            {}),
                           ("PUT", "https://acct.blob.core.windows.net/c/"
                            "a%20b?comp=block&blockid=QUJD", {
                                "Content-Length": "3",
                                "x-ms-blob-type": "BlockBlob"}),
                           ("GET", "https://acct.blob.core.windows.net/c?"
                            "restype=container&comp=list&prefix=d%2F", {}))]
    assert signed[PORT] == signed[JAX]
    assert all(a.startswith("SharedKey acct:") for a in signed[PORT])


def _ls_names(ufs, path):
    return sorted(s.name for s in ufs.list_status(path) or [])


# -- Ozone ------------------------------------------------------------------------
def test_ozone_matches_jax():
    def script(pkg, srv, trace):
        ozone = tu.mod(pkg, "underfs.ozone")
        trace("bucket o3fs", ozone._bucket_of, "o3fs://bkt.vol.om:9862/warm")
        trace("bucket ofs", ozone._bucket_of, "ofs://om:9862/vol/bkt/warm")
        trace("bucket bad", ozone._bucket_of, "ofs://om:9862/onlyvolume")
        ufs = ozone.OzoneUnderFileSystem(
            "o3fs://bkt.vol.om/", {"ozone.endpoint": srv.endpoint,
                                   "ozone.access.key": "ak",
                                   "ozone.secret.key": "sk"})
        contract(pkg, ufs, "o3fs://bkt.vol.om/w", trace, 41)
        ofs = ozone.OzoneUnderFileSystem(
            "ofs://om:9862/vol/bkt", {"ozone.endpoint": srv.endpoint})
        trace("ofs key", ofs._key, "ofs://om:9862/vol/bkt/d/f")
        trace("type", ofs.get_underfs_type)

    seen = _outcomes(_assert_parity(tu.run_both(FakeS3Server, script)))
    assert seen["bucket ofs"] == ("ok", "bkt")
    assert seen["bucket bad"][1] == "ValueError"
    assert seen["ofs key"] == ("ok", "d/f")


# -- Swift (Keystone) ---------------------------------------------------------------
def _native(pkg, srv, container="cont"):
    return tu.mod(pkg, "underfs.swift").SwiftNativeUnderFileSystem(
        f"swift://{container}/", {"swift.auth.url": srv.auth_url, **CREDS})


def test_swift_native_contract_matches_jax():
    """Keystone token and catalog, the object API, an expired token that
    re-authenticates, and the same tokens (seeded) in both runs."""
    def script(pkg, srv, trace):
        swift = tu.mod(pkg, "underfs.swift")
        ks = swift.KeystoneSession(srv.auth_url, "u", "pw", "proj")
        trace("credentials", ks.credentials)
        trace("cached", ks.credentials)
        trace("auth count", lambda: srv.state.auth_count)
        bad = swift.KeystoneSession(srv.auth_url, "u", "WRONG", "proj")
        trace("bad credentials", bad.credentials)
        ufs = _native(pkg, srv)
        contract(pkg, ufs, "swift://cont/d", trace, 51)
        tu.write(ufs, "swift://cont/a", b"1")
        srv.expire_all_tokens()
        trace("after expiry", ufs.read_range, "swift://cont/a", 0, 1)
        trace("auths", lambda: (srv.state.auth_count,
                                srv.state.bad_auth_count >= 1))

    seen = _outcomes(_assert_parity(tu.run_both(FakeSwiftServer, script)))
    assert seen["after expiry"] == ("ok", b"1")
    assert seen["bad credentials"][0] == "raise"


def test_swift_listing_paginates_matches_jax():
    def script(pkg, srv, trace):
        with srv.state.lock:
            for i in range(1005):
                srv.state.objects[f"cont/p/{i:05d}"] = b"x"
        names = _native(pkg, srv)._client.list_prefix("p/")
        trace("count", len, names)
        trace("names", lambda: names[::100])

    seen = _outcomes(_assert_parity(tu.run_both(FakeSwiftServer, script)))
    assert seen["count"] == ("ok", 1005)


def test_swift_dialect_dispatch_matches_jax():
    def script(pkg, srv, trace):
        swift = tu.mod(pkg, "underfs.swift")
        native = swift.create_swift_ufs(
            "swift://c/", {"swift.auth.url": srv.auth_url, **CREDS})
        gateway = swift.create_swift_ufs(
            "swift://c/", {"swift.endpoint": "http://gw:9000",
                           "swift.access.key": "a",
                           "swift.secret.key": "s"})
        trace("classes", lambda: (type(native).__module__.split(".", 1)[1],
                                  type(native).__name__,
                                  type(gateway).__module__.split(".", 1)[1],
                                  type(gateway).__name__))
        ufs = tu.mod(pkg, "underfs.registry").create_ufs(
            "swift://cont/", {"swift.auth.url": srv.auth_url, **CREDS})
        trace("type", ufs.get_underfs_type)

    seen = _outcomes(_assert_parity(tu.run_both(FakeSwiftServer, script)))
    assert seen["classes"] == ("ok", ("underfs.swift",
                                      "SwiftNativeUnderFileSystem",
                                      "underfs.s3_compat",
                                      "SwiftUnderFileSystem"))


# -- the native vendor dialects -----------------------------------------------------
def _xml_contract(client, srv, trace):
    trace("put", client.put, "d/a.bin", b"native-payload-42")
    trace("get", client.get, "d/a.bin")
    trace("range", client.get, "d/a.bin", 7, 7)
    trace("head", client.head, "d/a.bin")
    trace("head missing", client.head, "d/nope")
    trace("copy", client.copy, "d/a.bin", "d/b.bin")
    trace("get copy", client.get, "d/b.bin")
    for i in range(5):
        client.put(f"d/p-{i}", b"x")
    trace("list", client.list_prefix, "d/p-")
    trace("delete", client.delete, "d/b.bin")
    trace("gone", client.get, "d/b.bin")
    trace("auth failures", lambda: srv.auth_failures)


_XML_VENDORS = [
    ("oss", FakeOssServer, "OssNativeClient", "oss-ak", "oss-sk"),
    ("cos", FakeCosServer, "CosNativeClient", "cos-ak", "cos-sk"),
]


@pytest.mark.parametrize("vendor,fake,client,ak,sk", _XML_VENDORS,
                         ids=[v[0] for v in _XML_VENDORS])
def test_native_xml_vendor_matches_jax(vendor, fake, client, ak, sk):
    """The vendor's own header signature, recomputed by the fake: the
    op contract, a wrong secret, and a write past the part size that
    ships as signed parts."""
    data = tu.payload(61, 256 << 10)

    def script(pkg, srv, trace):
        vn = tu.mod(pkg, "underfs.vendor_native")
        c = getattr(vn, client)("bkt", srv.endpoint, ak, sk,
                                path_style=True, multipart_size=64 << 10)
        _xml_contract(c, srv, trace)
        writer = tu.mod(pkg, "underfs.object_base").MultipartWriter
        with writer(c, "big/obj") as w:
            for i in range(0, len(data), 10_000):
                w.write(data[i:i + 10_000])
        trace("multipart", c.get, "big/obj")
        trace("dangling", lambda: dict(srv.store.uploads))
        wrong = getattr(vn, client)("bkt", srv.endpoint, ak, "WRONG",
                                    path_style=True)
        trace("wrong secret", wrong.put, "k", b"v")

    seen = _outcomes(_assert_parity(tu.run_both(fake, script)))
    assert seen["range"] == ("ok", b"payload")
    assert seen["auth failures"] == ("ok", 0)
    assert seen["multipart"] == ("ok", data)
    assert seen["dangling"] == ("ok", {})
    assert seen["wrong secret"][1] == "HTTPError"


def test_native_multipart_abort_matches_jax():
    def script(pkg, srv, trace):
        c = tu.mod(pkg, "underfs.vendor_native").OssNativeClient(
            "bkt", srv.endpoint, "oss-ak", "oss-sk", path_style=True,
            multipart_size=1 << 10)
        writer = tu.mod(pkg, "underfs.object_base").MultipartWriter

        def broken():
            with writer(c, "broken") as w:
                w.write(b"z" * 4096)
                raise RuntimeError("writer died")

        trace("broken", broken)
        trace("object", c.get, "broken")
        trace("uploads", lambda: dict(srv.store.uploads))
        with writer(c, "small") as w:
            w.write(b"tiny")
        trace("small", c.get, "small")

    seen = _outcomes(_assert_parity(tu.run_both(FakeOssServer, script)))
    assert seen["object"] == ("ok", None) and seen["uploads"] == ("ok", {})
    assert seen["small"] == ("ok", b"tiny")


def test_native_kodo_matches_jax():
    """QBox tokens, upload tokens and private download URLs, each checked
    by the fake against the known secret."""
    def script(pkg, srv, trace):
        vn = tu.mod(pkg, "underfs.vendor_native")
        hosts = dict(rs_host=srv.endpoint, rsf_host=srv.endpoint,
                     up_host=srv.endpoint, download_host=srv.endpoint)
        c = vn.KodoNativeClient("bkt", "kodo-ak", "kodo-sk", **hosts)
        trace("put", c.put, "d/a.bin", b"kodo-bytes-123")
        trace("get", c.get, "d/a.bin")
        trace("range", c.get, "d/a.bin", 5, 5)
        trace("head", c.head, "d/a.bin")
        trace("head missing", c.head, "d/nope")
        trace("copy", c.copy, "d/a.bin", "d/b.bin")
        for i in range(5):
            c.put(f"d/p-{i}", b"x")
        trace("list", c.list_prefix, "d/p-")
        trace("delete", c.delete, "d/b.bin")
        trace("gone", c.get, "d/b.bin")
        bad = vn.KodoNativeClient("bkt", "kodo-ak", "WRONG", **hosts)
        trace("bad put", bad.put, "k", b"v")
        trace("bad get", bad.get, "d/a.bin")
        trace("bad head", bad.head, "d/a.bin")
        trace("failures", lambda: srv.auth_failures)
        trace("no download host", vn.KodoNativeClient, "bkt", "ak", "sk")

    seen = _outcomes(_assert_parity(tu.run_both(FakeKodoServer, script)))
    assert seen["range"] == ("ok", b"bytes")
    assert seen["list"] == ("ok", [f"d/p-{i}" for i in range(5)])
    assert seen["failures"] == ("ok", 3)
    assert seen["no download host"][1] == "ValueError"


_DIALECTS = [
    ("oss", FakeOssServer, {"oss.endpoint": None, "oss.path.style": "true",
                            "oss.access.key": "oss-ak",
                            "oss.secret.key": "oss-sk"}),
    ("cos", FakeCosServer, {"cos.endpoint": None, "cos.path.style": "true",
                            "cos.access.key": "cos-ak",
                            "cos.secret.key": "cos-sk",
                            "cos.multipart.size": str(32 << 10)}),
    ("kodo", FakeKodoServer, {"kodo.access.key": "kodo-ak",
                              "kodo.secret.key": "kodo-sk",
                              "kodo.rs.host": None, "kodo.rsf.host": None,
                              "kodo.up.host": None,
                              "kodo.download.host": None}),
    ("oss-s3-names", FakeOssServer, {"s3.endpoint": None,
                                     "s3.path.style": "true",
                                     "s3.access.key": "oss-ak",
                                     "s3.secret.key": "oss-sk"}),
]


@pytest.mark.parametrize("name,fake,props", _DIALECTS,
                         ids=[d[0] for d in _DIALECTS])
def test_native_dialect_through_registry_matches_jax(name, fake, props):
    """``<vendor>.dialect=native`` through the registry: the UFS contract
    over the vendor's own auth (the ``s3.*`` names as fallbacks)."""
    scheme = name.split("-")[0]

    def script(pkg, srv, trace):
        ufs = tu.mod(pkg, "underfs.registry").create_ufs(
            f"{scheme}://bkt/", {
                f"{scheme}.dialect": "native",
                **{k: srv.endpoint if v is None else v
                   for k, v in props.items()}})
        trace("class", lambda: type(ufs.client).__name__
              if hasattr(ufs, "client") else type(ufs._client).__name__)
        contract(pkg, ufs, f"{scheme}://bkt/n", trace, 71)
        big = tu.payload(72, 128 << 10)
        tu.write(ufs, f"{scheme}://bkt/large", big)
        trace("large", _read_from, ufs, f"{scheme}://bkt/large", 0)
        trace("failures", lambda: srv.auth_failures)

    seen = _outcomes(_assert_parity(tu.run_both(fake, script)))
    assert seen["failures"] == ("ok", 0)
    assert seen["large"] == ("ok", tu.payload(72, 128 << 10))


def test_dialect_defaults_and_errors_match_jax():
    got = {}
    for pkg in tu.PACKAGES:
        create_ufs = tu.mod(pkg, "underfs.registry").create_ufs
        trace = tu.Trace()
        trace("default", lambda: type(create_ufs(
            "oss://bkt/", {"oss.endpoint": "http://127.0.0.1:1"})).__name__)
        trace("no credentials", create_ufs, "oss://bkt/",
              {"oss.dialect": "native"})
        got[pkg] = trace.rows
    assert got[PORT] == got[JAX]
    seen = _outcomes(got[PORT])
    assert seen["default"] == ("ok", "OssUnderFileSystem")
    assert seen["no credentials"][1] == "ValueError" and \
        "empty credentials" in seen["no credentials"][2]


def test_requests_errors_are_the_same_class():
    """Both packages raise ``requests``' own HTTPError (one class)."""
    with FakeOssServer() as srv:
        c = tu.mod(PORT, "underfs.vendor_native").OssNativeClient(
            "bkt", srv.endpoint, "oss-ak", "WRONG", path_style=True)
        with pytest.raises(requests.HTTPError):
            c.put("k", b"v")
        assert srv.auth_failures == 1
