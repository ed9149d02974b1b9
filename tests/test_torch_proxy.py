"""The port's REST and S3 proxy (``alluxio_tpu_torch/proxy/``) against the
JAX package's, on the CPU.

JAX's ``tests/test_s3_proxy.py`` and ``tests/test_rest_proxy.py``, each
case one script of raw HTTP calls run against both packages' proxies,
each over its own package's ``LocalCluster``. The answers (status, body
and the protocol headers, with times, upload ids and file-id ETags
masked) must be equal, and the script's own checks (JAX's assertions)
hold on both. Each case has its own S3 root and its own namespace
prefix, so the two clusters serve the whole module.
"""

import json
import re
import xml.etree.ElementTree as ET

import pytest

pytest.importorskip("jax")

from tests.testutils import torch_serving as sv  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)


def _mod(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    out = {}
    try:
        for pkg in sv.PACKAGES:
            c = _mod(pkg, "minicluster.local_cluster").LocalCluster(
                str(tmp_path_factory.mktemp(pkg.split("_")[-1])),
                num_workers=1)
            out[pkg] = c.start()
        yield out
    finally:
        for c in out.values():
            c.stop()


@pytest.fixture()
def proxies(clusters, request):
    """One proxy per package for this case, rooted at its own S3 root."""
    tag = re.sub(r"[^a-z0-9]+", "-", request.node.name.lower()).strip("-")
    started = {}
    try:
        for pkg in sv.PACKAGES:
            keys = _mod(pkg, "conf").Keys
            conf = clusters[pkg].conf.copy()
            conf.set(keys.PROXY_WEB_PORT, 0)
            conf.set(keys.PROXY_S3_ROOT, f"/s3-{tag}")
            p = _mod(pkg, "proxy.process").ProxyProcess(
                conf, fs=clusters[pkg].file_system())
            p.start()
            started[pkg] = p
        yield {pkg: sv.Recorder(p.port) for pkg, p in started.items()}, \
            f"/{tag}"
    finally:
        for p in started.values():
            p.stop()


def _run(proxies, script):
    """``script(req, prefix)`` once per package; the answers must agree."""
    recorders, prefix = proxies
    for pkg in sv.PACKAGES:
        script(recorders[pkg], prefix)
    assert recorders[sv.PORT].rows == recorders[sv.JAX].rows
    assert recorders[sv.PORT].rows


def _names(body, tag, field):
    return [e.findtext(field) for e in ET.fromstring(body).iter(tag)]


# -- JAX's TestBucketsObjects ----------------------------------------------------------
def s3_bucket_lifecycle(r, _):
    assert r("PUT", "/mybucket")[0] == 200
    code, body, _h = r("GET", "/")
    assert code == 200 and _names(body, "Bucket", "Name") == ["mybucket"]
    assert r("DELETE", "/mybucket")[0] == 204
    assert not _names(r("GET", "/")[1], "Bucket", "Name")


def s3_object_put_get_head_delete(r, _):
    r("PUT", "/b")
    code, _b, hdrs = r("PUT", "/b/dir/obj.bin", data=b"hello s3")
    assert code == 200 and hdrs.get("ETag")
    assert r("GET", "/b/dir/obj.bin")[:2] == (200, b"hello s3")
    assert r("HEAD", "/b/dir/obj.bin")[0] == 200
    assert r("DELETE", "/b/dir/obj.bin")[0] == 204
    assert r("GET", "/b/dir/obj.bin")[0] == 404


def s3_overwrite(r, _):
    r("PUT", "/b")
    r("PUT", "/b/k", data=b"v1")
    r("PUT", "/b/k", data=b"version-two")
    assert r("GET", "/b/k")[1] == b"version-two"


def s3_range_get(r, _):
    r("PUT", "/b")
    r("PUT", "/b/r", data=bytes(range(100)))
    code, body, hdrs = r("GET", "/b/r", headers={"Range": "bytes=10-19"})
    assert code == 206 and body == bytes(range(10, 20))
    assert hdrs["Content-Range"] == "bytes 10-19/100"
    assert r("GET", "/b/r", headers={"Range": "bytes=-5"})[1] == \
        bytes(range(95, 100))


def s3_copy_object(r, _):
    r("PUT", "/b")
    r("PUT", "/b/src", data=b"copy me")
    code, body, _h = r("PUT", "/b/dst",
                       headers={"x-amz-copy-source": "/b/src"})
    assert code == 200 and b"CopyObjectResult" in body
    assert r("GET", "/b/dst")[1] == b"copy me"


def s3_list_objects_v2(r, _):
    r("PUT", "/b")
    for k in ("a/1.txt", "a/2.txt", "b/3.txt", "top.txt"):
        r("PUT", f"/b/{k}", data=b"x")
    everything = ["a/1.txt", "a/2.txt", "b/3.txt", "top.txt"]
    assert _names(r("GET", "/b?list-type=2")[1], "Contents", "Key") == \
        everything
    assert _names(r("GET", "/b?list-type=2&prefix=a/")[1], "Contents",
                  "Key") == ["a/1.txt", "a/2.txt"]
    body = r("GET", "/b?list-type=2&delimiter=/")[1]
    assert _names(body, "Contents", "Key") == ["top.txt"]
    assert _names(body, "CommonPrefixes", "Prefix") == ["a/", "b/"]
    body = r("GET", "/b?list-type=2&max-keys=2")[1]
    assert ET.fromstring(body).findtext("IsTruncated") == "true"
    keys = _names(body, "Contents", "Key")
    more = _names(r("GET", f"/b?list-type=2&start-after={keys[-1]}")[1],
                  "Contents", "Key")
    assert keys + more == everything


# -- JAX's TestProtocolDetails ---------------------------------------------------------
def s3_head_reports_real_length(r, _):
    r("PUT", "/b")
    r("PUT", "/b/sized", data=b"x" * 1234)
    code, _b, hdrs = r("HEAD", "/b/sized")
    assert code == 200 and hdrs["Content-Length"] == "1234"


def s3_range_beyond_eof_is_416(r, _):
    r("PUT", "/b")
    r("PUT", "/b/small", data=b"abc")
    assert r("GET", "/b/small", headers={"Range": "bytes=5-9"})[0] == 416


def s3_pagination_emits_continuation_token(r, _):
    r("PUT", "/b")
    for i in range(5):
        r("PUT", f"/b/k{i}", data=b"x")
    root = ET.fromstring(r("GET", "/b?list-type=2&max-keys=2")[1])
    assert root.findtext("IsTruncated") == "true"
    assert root.findtext("NextContinuationToken") == "k1"
    root = ET.fromstring(r("GET", "/b?list-type=2&max-keys=5")[1])
    assert root.findtext("IsTruncated") == "false"
    assert root.findtext("NextContinuationToken") is None


def s3_put_to_missing_bucket_is_404(r, _):
    code, body, _h = r("PUT", "/typo-bucket/key", data=b"x")
    assert code == 404 and b"NoSuchBucket" in body
    assert not _names(r("GET", "/")[1], "Bucket", "Name")


def s3_common_prefixes_count_toward_max_keys(r, _):
    r("PUT", "/b")
    for d in range(4):
        r("PUT", f"/b/dir{d}/f", data=b"x")
    r("PUT", "/b/top.txt", data=b"x")
    body = r("GET", "/b?list-type=2&delimiter=/&max-keys=3")[1]
    root = ET.fromstring(body)
    assert _names(body, "CommonPrefixes", "Prefix") == \
        ["dir0/", "dir1/", "dir2/"]
    assert root.findtext("KeyCount") == "3"
    assert root.findtext("IsTruncated") == "true"
    token = root.findtext("NextContinuationToken")
    assert token == "dir2/"
    body = r("GET", "/b?list-type=2&delimiter=/&max-keys=3"
                    f"&continuation-token={token}")[1]
    assert _names(body, "CommonPrefixes", "Prefix") == ["dir3/"]
    assert _names(body, "Contents", "Key") == ["top.txt"]
    assert ET.fromstring(body).findtext("IsTruncated") == "false"


# -- JAX's TestMultipart -----------------------------------------------------------------
def s3_multipart_roundtrip(r, _):
    r("PUT", "/b")
    code, body, _h = r("POST", "/b/big.bin?uploads")
    assert code == 200
    upload_id = ET.fromstring(body).findtext("UploadId")
    parts = [b"A" * 1000, b"B" * 1000, b"C" * 500]
    for n, data in enumerate(parts, start=1):
        code, _b, hdrs = r(
            "PUT", f"/b/big.bin?partNumber={n}&uploadId={upload_id}",
            data=data)
        assert code == 200 and hdrs.get("ETag")
    code, body, _h = r("POST", f"/b/big.bin?uploadId={upload_id}")
    assert code == 200 and b"CompleteMultipartUploadResult" in body
    assert r("GET", "/b/big.bin")[1] == b"".join(parts)
    assert _names(r("GET", "/b?list-type=2")[1], "Contents", "Key") == \
        ["big.bin"]


def s3_complete_after_bucket_delete_is_404(r, _):
    r("PUT", "/b")
    upload_id = ET.fromstring(r("POST", "/b/x?uploads")[1]) \
        .findtext("UploadId")
    r("PUT", f"/b/x?partNumber=1&uploadId={upload_id}", data=b"zzz")
    r("DELETE", "/b")
    assert r("POST", f"/b/x?uploadId={upload_id}")[0] == 404
    assert not _names(r("GET", "/")[1], "Bucket", "Name")


def s3_abort_multipart(r, _):
    r("PUT", "/b")
    upload_id = ET.fromstring(r("POST", "/b/x?uploads")[1]) \
        .findtext("UploadId")
    r("PUT", f"/b/x?partNumber=1&uploadId={upload_id}", data=b"zzz")
    assert r("DELETE", f"/b/x?uploadId={upload_id}")[0] == 204
    assert r("PUT", f"/b/x?partNumber=2&uploadId={upload_id}",
             data=b"q")[0] == 404


# -- JAX's TestRestPaths ------------------------------------------------------------------
def rest_full_lifecycle(r, p):
    api = f"/api/v1/paths{p}"
    assert r("POST", f"{api}/data/sub/create-directory?recursive=true"
             )[0] == 200
    code, body, _h = r("POST", f"{api}/data/sub/f.bin/upload",
                       data=b"rest payload")
    assert code == 200 and json.loads(body)["bytes"] == 12
    st = json.loads(r("GET", f"{api}/data/sub/f.bin/get-status")[1])
    assert st["length"] == 12 and not st["folder"]
    assert r("GET", f"{api}/data/sub/f.bin/download")[:2] == \
        (200, b"rest payload")
    assert [e["name"] for e in json.loads(
        r("GET", f"{api}/data/sub/list-status")[1])] == ["f.bin"]
    assert r("POST", f"{api}/data/sub/f.bin/rename"
                     f"?dst={p}/data/moved.bin")[0] == 200
    assert json.loads(r("POST", f"{api}/data/moved.bin/exists")[1]) is True
    assert r("POST", f"{api}/data/moved.bin/delete")[0] == 200
    assert json.loads(r("POST", f"{api}/data/moved.bin/exists")[1]) \
        is False


def rest_errors(r, p):
    api = f"/api/v1/paths{p}"
    code, body, _h = r("GET", f"{api}/nope/get-status")
    assert code == 404 and "error" in json.loads(body)
    r("POST", f"{api}/d/create-directory?recursive=true")
    r("POST", f"{api}/d/x/upload", data=b"1")
    assert r("POST", f"{api}/d/delete")[0] == 409
    assert r("GET", f"{api}/d/x/frobnicate")[0] == 404


def rest_api_prefix_reserved_on_every_verb(r, _):
    for method in ("PUT", "DELETE"):
        code = r(method, "/api/v1/data.bin",
                 data=b"x" if method == "PUT" else None)[0]
        assert code in (404, 405)
    assert b"api" not in r("GET", "/")[1]


def rest_s3_dialect_still_served(r, _):
    assert b"ListAllMyBucketsResult" in r("GET", "/")[1]


SCRIPTS = [s3_bucket_lifecycle, s3_object_put_get_head_delete, s3_overwrite,
           s3_range_get, s3_copy_object, s3_list_objects_v2,
           s3_head_reports_real_length, s3_range_beyond_eof_is_416,
           s3_pagination_emits_continuation_token,
           s3_put_to_missing_bucket_is_404,
           s3_common_prefixes_count_toward_max_keys,
           s3_multipart_roundtrip, s3_complete_after_bucket_delete_is_404,
           s3_abort_multipart, rest_full_lifecycle, rest_errors,
           rest_api_prefix_reserved_on_every_verb,
           rest_s3_dialect_still_served]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__)
def test_proxy_answers_like_jax(proxies, script):
    _run(proxies, script)


def test_launched_proxy_reads_what_the_port_wrote(clusters, tmp_path):
    """``ProxyProcess(conf)`` with no client builds its own
    ``FileSystem`` from the conf's master address, as the launcher does:
    what the port's client wrote reads back through it, ranged."""
    from alluxio_tpu_torch.conf import Keys
    from alluxio_tpu_torch.proxy.process import ProxyProcess

    c = clusters[sv.PORT]
    fs = c.file_system()
    fs.create_directory("/own-fs/b", recursive=True, allow_exists=True)
    data = bytes(range(256)) * 64
    fs.write_all("/own-fs/b/obj", data)
    conf = c.conf.copy()
    conf.set(Keys.PROXY_WEB_PORT, 0)
    conf.set(Keys.PROXY_S3_ROOT, "/own-fs")
    conf.set(Keys.MASTER_HOSTNAME, "localhost")
    conf.set(Keys.MASTER_RPC_PORT, c.master.rpc_port)
    p = ProxyProcess(conf)
    p.start()
    try:
        code, body, hdrs = sv.http(p.port, "GET", "/b/obj",
                                   headers={"Range": "bytes=100-4195"})
    finally:
        p.stop()
    assert code == 206 and body == data[100:4196]
    assert hdrs["Content-Range"] == f"bytes 100-4195/{len(data)}"
