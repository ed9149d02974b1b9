"""The port's ``fs`` shell against the JAX package's, on the CPU.

Mirrors JAX's ``tests/test_shell.py`` (its fs cases, the late-bound
streams and the formatting helpers): one seeded script of ``fs``
commands runs through each package's shell against that package's
``LocalCluster`` (one worker, the job service, worker heartbeats), one
package after the other in the same directory, and every command's exit
code, stdout and stderr must be equal once times, cluster ids, ports,
uptimes and the host's name are masked (``tests/testutils/
torch_shell.py``). The clusters write MUST_CACHE by default, so that no
asynchronous persist job takes a job id at a moment the script does not
set (the distributed commands print theirs). Steps marked ``cross`` also
run through the other package's shell against the same cluster. A step
marked ``settle`` first waits until the master's used bytes equal the
workers' own (``settle_used_bytes``): they move with the heartbeats.
"""

import importlib
import io
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.testutils import torch_shell as ts  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

PORT, JAX = "alluxio_tpu_torch", "alluxio_tpu"
LOCAL = np.random.default_rng(16).integers(
    0, 256, 3000, dtype=np.uint8).tobytes()


def _files(pkg, cluster, fs):
    fs.write_all("/d/f1", b"abc")
    fs.write_all("/d/f2", b"defgh")
    fs.write_all("/f", b"hello world")
    for name in ("x1", "x2", "y1"):
        fs.write_all(f"/g/{name}", b"d")
    fs.write_all("/src/f", b"data" * 100)
    fs.write_all("/attr", b"x")
    fs.write_all("/loc", b"z" * 1000)
    fs.write_all("/warm", b"w" * 4096, write_type="CACHE_THROUGH")
    for i in range(3):
        fs.write_all(f"/dist/f{i}", b"d" * 256)
    with open(os.path.join(cluster._base, "local.bin"), "wb") as f:
        f.write(LOCAL)
    ext = os.path.join(cluster._base, "extufs")
    os.makedirs(ext)
    with open(os.path.join(ext, "a.txt"), "wb") as f:
        f.write(b"from the ufs")


def _copied_out(pkg, cluster, fs):
    with open(os.path.join(cluster._base, "out.bin"), "rb") as f:
        return f.read() == LOCAL


def _namespace(pkg, cluster, fs):
    """What the attribute, cp/mv and distributed commands left."""
    def walk(path):
        for info in sorted(fs.list_status(path), key=lambda i: i.path):
            yield (info.path, info.folder, info.length, info.pinned,
                   info.ttl, oct(info.mode), info.owner, info.group,
                   info.replication_min)
            if info.folder:
                yield from walk(info.path)

    return list(walk("/"))


def _reads(pkg, cluster, fs):
    return [fs.read_all(p) for p in ("/warm", "/dist3/f1", "/moved/f",
                                     "/in")]


SETUPS = {"files": _files, "copied_out": _copied_out,
          "namespace": _namespace, "reads": _reads}


def _local(name):
    return os.path.join(ts.BASE, name)


SCRIPT = [
    ("py", "files"),
    ("fs", ["mkdir", "/a/b"]),
    ("fs", ["ls", "/a"], "cross"),
    ("fs", ["rm", "-R", "/a"]),
    ("fs", ["ls", "/a"]),
    ("fs", ["cat", "/f"], "cross"),
    ("fs", ["head", "-c", "5", "/f"]),
    ("fs", ["tail", "-c", "5", "/f"]),
    ("fs", ["touch", "/empty"]),
    ("fs", ["stat", "-f", "%z", "/empty"]),
    ("fs", ["ls", "/g/x*"], "cross"),
    ("fs", ["ls", "-h", "/d"], "cross"),
    ("fs", ["ls", "-R", "/g"]),
    ("fs", ["cp", "-R", "/src", "/cp"]),
    ("fs", ["mv", "/cp", "/moved"]),
    ("fs", ["ls", "/moved"]),
    ("fs", ["copyFromLocal", _local("local.bin"), "/in"]),
    ("fs", ["copyToLocal", "/in", _local("out.bin")]),
    ("py", "copied_out"),
    ("fs", ["stat", "/d/f1"], "cross"),
    ("fs", ["stat", "-f", "%z", "/d/f1"]),
    ("fs", ["test", "-f", "/d/f1"]),
    ("fs", ["test", "-d", "/d/f1"]),
    ("fs", ["test", "-e", "/nope"]),
    ("fs", ["checksum", "/d/f1"], "cross"),
    ("fs", ["count", "/d"], "cross"),
    ("fs", ["du", "/d"], "cross"),
    ("fs", ["du", "-s", "-h", "/d"]),
    ("fs", ["pin", "/attr"]),
    ("fs", ["unpin", "/attr"]),
    ("fs", ["setTtl", "/attr", "60000"]),
    ("fs", ["unsetTtl", "/attr"]),
    ("fs", ["chmod", "600", "/attr"]),
    ("fs", ["chown", "alice:team", "/attr"]),
    ("fs", ["setReplication", "--min", "1", "/attr"]),
    ("fs", ["chgrp", "staff", "/attr"]),
    ("fs", ["setfacl", "-m", "user:bob:r-x", "/attr"]),
    ("fs", ["getfacl", "/attr"], "cross"),
    ("fs", ["persist", "/loc"]),
    ("fs", ["mount", "/ext", os.path.join(ts.BASE, "extufs")]),
    ("fs", ["ls", "/ext"]),
    ("fs", ["cat", "/ext/a.txt"]),
    ("fs", ["startSync", "/ext"]),
    ("fs", ["getSyncPathList"], "cross"),
    ("fs", ["stopSync", "/ext"]),
    ("fs", ["unmount", "/ext"]),
    ("fs", ["getCapacityBytes"], "cross"),
    ("fs", ["getUsedBytes"], "settle"),
    ("fs", ["location", "/loc"], "cross"),
    ("fs", ["free", "/warm"]),
    ("fs", ["load", "/warm"]),
    ("fs", ["distributedCp", "/dist", "/dist2"]),
    ("fs", ["distributedMv", "/dist2", "/dist3"]),
    ("fs", ["distributedLoad", "/dist3"]),
    ("fs", ["mount"], "cross"),
    ("fs", ["masterInfo"], "cross"),
    ("fs", ["leader"]),
    ("fs", ["getSyncPathList"]),
    ("fs", []),
    ("fs", ["frobnicate"]),
    ("fs", ["help", "ls"]),
    ("py", "namespace"),
    ("py", "reads"),
]

#: the exit code each step must give in both packages, where the JAX
#: test asserts one (parity alone would pass two equal failures)
EXPECT = {"fs ls /a": None, "fs test -d /d/f1": 1, "fs test -e /nope": 1,
          "fs frobnicate": 1}


def _ids(cross: bool = False):
    out = []
    for i, step in enumerate(SCRIPT):
        if step[0] == "py" and step[1] in ("files",):
            continue
        if cross and "cross" not in step[2:]:
            continue
        out.append(ts.step_id(i, step))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("shfs") / "c")
    return {pkg: ts.run_script(
        pkg, base, SCRIPT, SETUPS,
        cluster_kwargs={"conf_overrides": {
            "atpu.user.file.writetype.default": "MUST_CACHE"}})
        for pkg in ts.PACKAGES}


def _sid(sid: str) -> str:
    return sid.split(" ", 1)[1]


@pytest.mark.parametrize("sid", _ids())
def test_fs_step_matches_jax(runs, sid):
    port, jax = runs[PORT][sid], runs[JAX][sid]
    assert port == jax
    if isinstance(jax, tuple):
        want = EXPECT.get(_sid(sid), 0)
        if want is not None:
            assert jax[0] == want, jax


@pytest.mark.parametrize("pkg", ts.PACKAGES)
@pytest.mark.parametrize("sid", _ids(cross=True))
def test_other_shell_against_this_cluster(runs, sid, pkg):
    """The other package's shell, against this package's cluster, prints
    what this package's own shell prints."""
    assert runs[pkg]["cross " + sid] == runs[pkg][sid]


def test_script_did_what_the_jax_test_checks(runs):
    """The JAX test's own checks, on the port's run."""
    got = {_sid(k): v for k, v in runs[PORT].items()}
    assert got["fs cat /f"][1] == "hello world"
    assert got["fs head -c 5 /f"][1] == "hello"
    assert got["fs tail -c 5 /f"][1] == "world"
    assert got["fs ls /a"][0] == 1 and "DoesNotExist" in got["fs ls /a"][2]
    assert "/g/x1" in got["fs ls /g/x*"][1] and \
        "/g/y1" not in got["fs ls /g/x*"][1]
    assert "900150983cd24fb0d6963f7d28e17f72" in \
        got["fs checksum /d/f1"][1]
    assert got["py copied_out"] is True
    assert got["py reads"] == [b"w" * 4096, b"d" * 256, b"data" * 100,
                               LOCAL]
    attr = [row for row in got["py namespace"] if row[0] == "/attr"][0]
    assert attr[3:] == (False, -1, oct(0o600), "alice", "staff", 1)
    assert got["fs cat /ext/a.txt"][1] == "from the ufs"
    assert "user:bob:r-x" in got["fs getfacl /attr"][1]
    assert "COMPLETED" in got["fs distributedLoad /dist3"][1]
    assert "not a valid command" in got["fs frobnicate"][2]


# -- the command framework (shell/command.py) ---------------------------------
def _command(pkg):
    return importlib.import_module(f"{pkg}.shell.command")


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1536, 10 << 20, 3 << 30,
                               5 << 50, 7 << 60, -2048])
def test_human_size_matches_jax(n):
    assert _command(PORT).human_size(n) == _command(JAX).human_size(n)


@pytest.mark.parametrize("values", [[], [1.0], [2, 2, 2], [0, 1, 2, 3, 8],
                                    list(range(100)), [5, -1, 3.5]])
def test_sparkline_matches_jax(values):
    assert _command(PORT).sparkline(values) == \
        _command(JAX).sparkline(values)


@pytest.mark.parametrize("folder,mode", [(False, 0o644), (True, 0o755),
                                         (False, 0o600), (True, 0o1777)])
def test_mode_string_and_ls_line_match_jax(folder, mode):
    lines = []
    for pkg in ts.PACKAGES:
        wire = importlib.import_module(f"{pkg}.utils.wire")
        info = wire.FileInfo(path="/p/x", name="x", folder=folder,
                             length=12345, mode=mode, owner="o", group="g",
                             last_modification_time_ms=1_700_000_000_000,
                             in_memory_percentage=50)
        cmd = _command(pkg)
        lines.append((cmd.mode_string(info),
                      cmd.format_ls_line(info),
                      cmd.format_ls_line(info, human=True)))
    assert lines[0] == lines[1]


@pytest.mark.parametrize("swap", [True, False])
def test_context_streams_match_jax(swap):
    """A default-constructed ``ShellContext`` follows a runtime swap of
    ``sys.stdout``/``sys.stderr``; explicit streams win (JAX's
    ``TestLateBoundStreams``)."""
    import sys

    seen = []
    for pkg in ts.PACKAGES:
        conf = importlib.import_module(f"{pkg}.conf").Configuration(
            load_env=False)
        explicit = io.StringIO()
        ctx = _command(pkg).ShellContext(
            conf, out=None if swap else explicit)
        buf_out, buf_err = io.StringIO(), io.StringIO()
        old_out, old_err = sys.stdout, sys.stderr
        sys.stdout, sys.stderr = buf_out, buf_err
        try:
            ctx.print("to-out")
            ctx.eprint("to-err")
        finally:
            sys.stdout, sys.stderr = old_out, old_err
        seen.append((buf_out.getvalue(), buf_err.getvalue(),
                     explicit.getvalue()))
    assert seen[0] == seen[1]
    assert seen[0][1] == "to-err\n"
    assert seen[0][0 if swap else 2] == "to-out\n"
