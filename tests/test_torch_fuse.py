"""The port's FUSE adapter (``alluxio_tpu_torch/fuse/``) against the JAX
package's, on the CPU.

JAX's ``tests/test_fuse.py``, each scenario run through both packages,
each over its own package's ``LocalCluster``:

- ``TestFuseFsCallbacks``: the operation handlers called directly (no
  kernel). Each scenario runs under its own root in both clusters; what
  every call returns (errno codes, handles, bytes; times masked) and
  what the namespace holds afterwards must be equal;
- ``TestKernelMount``: each package mounts its own cluster at its own
  mountpoint through ``/dev/fuse`` and the same plain ``os`` calls drive
  both; the results must be equal. Each mount is unmounted in a
  ``finally``. Skipped where the environment cannot mount, as JAX's is;
- unmounting with a descriptor the application never closed returns in
  both packages and leaves no mount behind.
"""

import errno
import importlib
import os
import re
import stat as stat_mod

import pytest

pytest.importorskip("jax")

from tests.testutils.torch_serving import PACKAGES  # noqa: E402
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    out = {}
    try:
        for pkg in PACKAGES:
            out[pkg] = _mod(pkg, "minicluster.local_cluster").LocalCluster(
                str(tmp_path_factory.mktemp(pkg.split("_")[-1])),
                num_workers=1).start()
        yield out
    finally:
        for c in out.values():
            c.stop()


@pytest.fixture()
def root(request):
    return "/" + re.sub(r"[^a-z0-9]+", "-",
                        request.node.name.lower()).strip("-")


def _tree(fs, path):
    """The namespace under ``path``: (relative path, folder, bytes)."""
    out = []
    for st in sorted(fs.list_status(path), key=lambda s: s.path):
        rel = st.path[len(path):]
        if st.folder:
            out.append((rel, True, None))
            out += [(rel + r, f, b) for r, f, b in _tree(fs, st.path)]
        else:
            out.append((rel, False, bytes(fs.read_all(st.path))))
    return out


def _run(clusters, root, script):
    """``script(impl, fs, p)`` once per package, ``impl`` a ``FuseFs``
    rooted at ``root``; the calls' results and the tree must agree."""
    got = []
    for pkg in PACKAGES:
        fs = clusters[pkg].file_system()
        fs.create_directory(root, recursive=True, allow_exists=True)
        impl = _mod(pkg, "fuse.fs").FuseFs(fs, root)
        calls = []

        def rec(value):
            if isinstance(value, tuple) and len(value) == 4:
                value = (value[0], value[1], "<T>", value[3])
            calls.append(value)
            return value

        try:
            script(impl, fs, root, rec)
        finally:
            impl.close_all()
        got.append((calls, _tree(fs, root)))
    assert got[1] == got[0]
    return got[1]


def cb_getattr_file_and_dir(impl, fs, p, rec):
    fs.write_all(f"{p}/f.bin", b"12345")
    mode, size, _, nlink = rec(impl.getattr("/f.bin"))
    assert stat_mod.S_ISREG(mode) and size == 5 and nlink == 1
    mode, _, _, nlink = rec(impl.getattr("/"))
    assert stat_mod.S_ISDIR(mode) and nlink == 2
    assert rec(impl.getattr("/nope")) == -errno.ENOENT


def cb_write_then_read_via_handles(impl, fs, p, rec):
    fh = rec(impl.create("/w.bin"))
    assert fh > 0
    assert rec(impl.write(fh, b"hello ", 0)) == 6
    assert rec(impl.write(fh, b"fuse", 6)) == 4
    assert rec(impl.write(fh, b"x", 99)) == -errno.EOPNOTSUPP
    assert rec(impl.flush(fh)) == 0
    assert rec(fs.read_all(f"{p}/w.bin")) == b"hello fuse"
    assert rec(impl.release(fh)) == 0
    rfh = rec(impl.open("/w.bin", write=False))
    assert rec(impl.read(rfh, 4, 6)) == b"fuse"
    assert rec(impl.release(rfh)) == 0


def cb_readdir_and_namespace_ops(impl, fs, p, rec):
    fs.write_all(f"{p}/d/a", b"1")
    fs.write_all(f"{p}/d/b", b"2")
    assert sorted(rec(impl.readdir("/d"))) == ["a", "b"]
    assert rec(impl.mkdir("/d/sub")) == 0
    assert rec(impl.rename("/d/a", "/d/sub/a")) == 0
    assert rec(impl.unlink("/d/sub/a")) == 0
    assert rec(impl.rmdir("/d/sub")) == 0
    assert rec(impl.readdir("/nope")) == -errno.ENOENT


def cb_truncate_semantics(impl, fs, p, rec):
    fs.write_all(f"{p}/t.bin", b"abcdef")
    assert rec(impl.truncate("/t.bin", 6)) == 0
    assert rec(impl.truncate("/t.bin", 0)) == 0
    assert rec(fs.get_status(f"{p}/t.bin").length) == 0
    fs.write_all(f"{p}/t2.bin", b"abcdef")
    assert rec(impl.truncate("/t2.bin", 3)) == -errno.EOPNOTSUPP
    assert rec(impl.truncate("/nope", 0)) == -errno.ENOENT


def cb_writable_open_without_trunc_preserves_content(impl, fs, p, rec):
    fs.write_all(f"{p}/keep.bin", b"precious")
    fh = rec(impl.open("/keep.bin", write=True))
    assert fh > 0
    assert rec(impl.flush(fh)) == 0 and rec(impl.release(fh)) == 0
    assert rec(fs.read_all(f"{p}/keep.bin")) == b"precious"
    fh = rec(impl.open("/keep.bin", write=True))
    assert rec(impl.read(fh, 4, 0)) == b"prec"
    assert rec(impl.write(fh, b"newdata", 0)) == 7
    assert rec(impl.flush(fh)) == 0 and rec(impl.release(fh)) == 0
    assert rec(fs.read_all(f"{p}/keep.bin")) == b"newdata"
    fh = rec(impl.open("/keep.bin", write=True))
    assert rec(impl.write(fh, b"x", 3)) == -errno.EOPNOTSUPP
    rec(impl.release(fh))
    assert rec(fs.read_all(f"{p}/keep.bin")) == b"newdata"


def cb_bad_handles(impl, fs, p, rec):
    assert rec(impl.read(999, 1, 0)) == -errno.EBADF
    assert rec(impl.write(999, b"x", 0)) == -errno.EBADF
    assert rec(impl.release(999)) == 0


CALLBACKS = [cb_getattr_file_and_dir, cb_write_then_read_via_handles,
             cb_readdir_and_namespace_ops, cb_truncate_semantics,
             cb_writable_open_without_trunc_preserves_content,
             cb_bad_handles]


@pytest.mark.parametrize("script", CALLBACKS, ids=lambda f: f.__name__)
def test_callbacks_answer_like_jax(clusters, root, script):
    calls, _ = _run(clusters, root, script)
    assert calls


# -- the kernel mount -------------------------------------------------------------------
def _mount(pkg, fs, mountpoint, root="/"):
    proc = _mod(pkg, "fuse.process")
    if not proc.fuse_available():
        pytest.skip("no FUSE in this environment")
    m = proc.AlluxioFuseMount(fs, mountpoint, root=root)
    try:
        m.mount()
    except (OSError, TimeoutError) as e:
        pytest.skip(f"cannot mount here: {e}")
    return m


def _kernel_cycle(fs, p, mnt):
    fs.write_all(f"{p}/seed.txt", b"seeded")
    out = [sorted(os.listdir(mnt))]
    with open(os.path.join(mnt, "seed.txt"), "rb") as f:
        out.append(f.read())
    with open(os.path.join(mnt, "out.bin"), "wb") as f:
        f.write(b"kernel-written")
    out.append(bytes(fs.read_all(f"{p}/out.bin")))
    out.append(os.stat(os.path.join(mnt, "out.bin")).st_size)
    os.mkdir(os.path.join(mnt, "kd"))
    os.rename(os.path.join(mnt, "out.bin"),
              os.path.join(mnt, "kd", "moved.bin"))
    out.append(fs.exists(f"{p}/kd/moved.bin"))
    with open(os.path.join(mnt, "kd", "moved.bin"), "rb") as f:
        f.seek(7)
        out.append(f.read(4))
    os.remove(os.path.join(mnt, "kd", "moved.bin"))
    os.rmdir(os.path.join(mnt, "kd"))
    out.append(fs.exists(f"{p}/kd"))
    return out


def test_kernel_mount_cycle_like_jax(clusters, root, tmp_path):
    """Each package mounts its own cluster at its own mountpoint; the
    same ``os`` calls give the same results."""
    got = []
    for pkg in PACKAGES:
        fs = clusters[pkg].file_system()
        fs.create_directory(root, recursive=True, allow_exists=True)
        mnt = str(tmp_path / f"mnt-{pkg}")
        m = _mount(pkg, fs, mnt, root=root)
        try:
            got.append(_kernel_cycle(fs, root, mnt))
        finally:
            m.unmount()
        assert not os.path.ismount(mnt)
    assert got[1] == got[0]
    assert got[1] == [["seed.txt"], b"seeded", b"kernel-written", 14, True,
                      b"writ", False]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_unmount_survives_leaked_fd(pkg, clusters, root, tmp_path):
    """An fd the application never closed must not crash or hang the
    unmount (JAX's regression), in either package."""
    fs = clusters[pkg].file_system()
    fs.write_all(f"{root}/leak.txt", b"leak me")
    mp = str(tmp_path / "mnt2")
    m = _mount(pkg, fs, mp, root=root)
    leaked = None
    try:
        leaked = open(os.path.join(mp, "leak.txt"), "rb")
        assert leaked.read() == b"leak me"
    finally:
        m.unmount()  # the fd is still open: must return
    assert not os.path.ismount(mp)
    try:
        leaked.close()
    except OSError:
        pass
