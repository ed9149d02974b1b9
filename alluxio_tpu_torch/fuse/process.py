"""FUSE mount lifecycle (a copy of ``alluxio_tpu/fuse/process.py``):
bridge ``FuseFs`` into ``fuse_operations`` and drive the kernel loop.

Re-design of ``integration/fuse/src/main/java/alluxio/fuse/
{AlluxioFuse.java,AlluxioFuseFileSystem.java:52}``: ``AlluxioFuseMount``
mounts the namespace at a local path so ANY process (shell tools, numpy
``mmap``, torch ``DataLoader``) reads cached data through the kernel.

The loop runs on a daemon thread (libfuse single-threaded mode: every
callback re-enters Python under the GIL anyway, so ``fuse_loop_mt``
would only add contention); ``unmount()`` wakes it via
``fuse_unmount``.
"""

from __future__ import annotations

import ctypes
import errno
import logging
import os
import threading
import time
from typing import Optional

from alluxio_tpu_torch.fuse import libfuse as lf
from alluxio_tpu_torch.fuse.fs import FuseFs

LOG = logging.getLogger(__name__)


def fuse_available() -> bool:
    """True when the host can serve a mount (lib + device present)."""
    try:
        lf.load()
    except OSError:
        return False
    return os.path.exists("/dev/fuse")


class AlluxioFuseMount:
    """One kernel mount of the namespace."""

    def __init__(self, fs, mountpoint: str, *, root: str = "/",
                 options: str = "") -> None:
        self._ops_impl = FuseFs(fs, root)
        self.mountpoint = os.path.abspath(mountpoint)
        base = "fsname=alluxio-tpu,subtype=atpu,default_permissions"
        self._options = f"{base},{options}" if options else base
        self._chan: Optional[int] = None
        self._fuse: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._ops = self._build_ops()  # keepalive: kernel holds pointers

    # -- callback bridge -----------------------------------------------------
    def _build_ops(self) -> lf.FuseOperations:
        impl = self._ops_impl

        def _dec(p: bytes) -> str:
            return p.decode("utf-8", "surrogateescape")

        def c_getattr(path, stbuf):
            r = impl.getattr(_dec(path))
            if isinstance(r, int):
                return r
            mode, size, mtime_ms, nlink = r
            st = stbuf.contents
            ctypes.memset(ctypes.byref(st), 0, ctypes.sizeof(st))
            st.st_mode = mode
            st.st_nlink = nlink
            st.st_size = size
            st.st_uid = os.getuid()
            st.st_gid = os.getgid()
            st.st_blksize = 4096
            st.st_blocks = (size + 511) // 512
            sec, ms = divmod(mtime_ms, 1000)
            for pfx in ("st_atime", "st_mtime", "st_ctime"):
                setattr(st, pfx + "_sec", sec)
                setattr(st, pfx + "_nsec", ms * 1_000_000)
            return 0

        def c_readdir(path, buf, filler, _offset, _fi):
            r = impl.readdir(_dec(path))
            if isinstance(r, int):
                return r
            for name in [".", ".."] + r:
                # surrogateescape round-trips non-UTF-8 names that
                # _dec() admitted; strict encode would EIO the whole
                # directory listing over one bad name
                if filler(buf, name.encode("utf-8", "surrogateescape"),
                          None, 0):
                    break
            return 0

        def c_open(path, fi):
            flags = fi.contents.flags
            write = flags & (os.O_WRONLY | os.O_RDWR | os.O_APPEND)
            fh = impl.open(_dec(path), bool(write))
            if fh < 0:
                return fh
            fi.contents.fh = fh
            return 0

        def c_create(path, _mode, fi):
            fh = impl.create(_dec(path))
            if fh < 0:
                return fh
            fi.contents.fh = fh
            return 0

        def c_read(path, buf, size, offset, fi):
            data = impl.read(fi.contents.fh, size, offset)
            if isinstance(data, int):
                return data
            n = min(len(data), size)
            ctypes.memmove(buf, data, n)
            return n

        def c_write(path, buf, size, offset, fi):
            data = ctypes.string_at(buf, size)
            return impl.write(fi.contents.fh, data, offset)

        def c_release(path, fi):
            return impl.release(fi.contents.fh)

        def c_flush(path, fi):
            return impl.flush(fi.contents.fh)

        def c_truncate(path, length):
            return impl.truncate(_dec(path), length)

        def c_mkdir(path, _mode):
            return impl.mkdir(_dec(path))

        def c_unlink(path):
            return impl.unlink(_dec(path))

        def c_rmdir(path):
            return impl.rmdir(_dec(path))

        def c_rename(src, dst):
            return impl.rename(_dec(src), _dec(dst))

        def c_chmod(_path, _mode):
            return 0  # accepted, not persisted (matches reference default)

        def c_chown(_path, _uid, _gid):
            return 0

        def c_utimens(_path, _times):
            return 0

        def c_access(_path, _mask):
            return 0

        def c_fsync(_path, _datasync, _fi):
            return 0

        def guard(fn, name):
            def wrapped(*a):
                try:
                    return fn(*a)
                except Exception:  # noqa: BLE001 - never unwind into C
                    LOG.exception("fuse %s failed", name)
                    return -errno.EIO
            return wrapped

        ops = lf.FuseOperations()
        ops.getattr = lf.getattr_t(guard(c_getattr, "getattr"))
        ops.readdir = lf.readdir_t(guard(c_readdir, "readdir"))
        ops.open = lf.open_t(guard(c_open, "open"))
        ops.create = lf.create_t(guard(c_create, "create"))
        ops.read = lf.read_t(guard(c_read, "read"))
        ops.write = lf.write_t(guard(c_write, "write"))
        ops.release = lf.open_t(guard(c_release, "release"))
        ops.flush = lf.open_t(guard(c_flush, "flush"))
        ops.truncate = lf.truncate_t(guard(c_truncate, "truncate"))
        ops.mkdir = lf.mkdir_t(guard(c_mkdir, "mkdir"))
        ops.unlink = lf.path_t(guard(c_unlink, "unlink"))
        ops.rmdir = lf.path_t(guard(c_rmdir, "rmdir"))
        ops.rename = lf.path2_t(guard(c_rename, "rename"))
        ops.chmod = lf.chmod_t(guard(c_chmod, "chmod"))
        ops.chown = lf.chown_t(guard(c_chown, "chown"))
        ops.utimens = lf.utimens_t(guard(c_utimens, "utimens"))
        ops.access = lf.access_t(guard(c_access, "access"))
        ops.fsync = lf.fsync_t(guard(c_fsync, "fsync"))
        return ops

    # -- lifecycle -----------------------------------------------------------
    def mount(self, *, timeout_s: float = 10.0) -> None:
        lib = lf.load()
        os.makedirs(self.mountpoint, exist_ok=True)
        # mount options go to fuse_mount only; fuse_new takes NULL args
        # (it rejects fuse_mount's chewed remainder otherwise)
        mount_args = lf.make_args(self._options)
        self._args = mount_args  # keepalive
        mp = self.mountpoint.encode()
        chan = lib.fuse_mount(mp, ctypes.byref(mount_args))
        if not chan:
            raise OSError("fuse_mount failed (no permission for /dev/fuse"
                          " in this environment?)")
        fuse = lib.fuse_new_versioned(chan, None, ctypes.byref(self._ops),
                                      ctypes.sizeof(self._ops), None)
        if not fuse:
            lib.fuse_unmount(mp, chan)
            raise OSError("fuse_new failed")
        self._chan, self._fuse = chan, fuse
        self._thread = threading.Thread(
            target=lib.fuse_loop, args=(fuse,), name="fuse-loop",
            daemon=True)
        self._thread.start()
        # the mount is live once the kernel answers a stat of the root
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                st = os.stat(self.mountpoint)
                if os.path.ismount(self.mountpoint):
                    self._conn_dev = st.st_dev
                    LOG.info("fuse: %s mounted", self.mountpoint)
                    return
            except OSError:
                pass
            time.sleep(0.05)
        self.unmount()
        raise TimeoutError(f"mount of {self.mountpoint} did not come up")

    def _abort_connection(self) -> None:
        """Force-abort the kernel connection (sysfs knob) so in-flight
        and straggler requests — e.g. a FLUSH from an fd the caller
        leaked past unmount — fail with ENOTCONN instead of racing
        libfuse2's teardown (intermittent SIGSEGV otherwise)."""
        dev = getattr(self, "_conn_dev", None)
        if dev is None:
            return
        path = f"/sys/fs/fuse/connections/{dev}/abort"
        try:
            with open(path, "w") as f:
                f.write("1")
        except OSError:  # pragma: no cover - sysfs unavailable
            LOG.debug("fuse abort knob unavailable: %s", path)

    def unmount(self) -> None:
        lib = lf.load()
        if self._fuse is not None:
            lib.fuse_exit(self._fuse)
        if self._thread is not None:
            # the loop thread is blocked in fuse_chan_receive; freeing
            # the channel under it (fuse_unmount) is a use-after-free
            # (GPF in libfuse observed). Wake the read so the loop
            # observes the exit flag and returns FIRST. The poke must
            # be a LOOKUP of a name the kernel has never seen — a plain
            # stat of the root is served from the attribute cache and
            # wakes nothing.
            # poke from side threads: if the loop exited between pokes,
            # a stat against the reader-less connection blocks in
            # uninterruptible sleep — the later fuse_unmount aborts the
            # connection and frees any stuck poke thread.
            def _poke(n: int) -> None:
                try:
                    os.stat(os.path.join(
                        self.mountpoint, f".__wake_{n}__"))
                except OSError:
                    pass

            for attempt in range(100):
                threading.Thread(target=_poke, args=(attempt,),
                                 daemon=True).start()
                self._thread.join(timeout=0.1)
                if not self._thread.is_alive():
                    break
            else:  # pragma: no cover - wedged callback
                LOG.warning("fuse loop did not exit; forcing unmount")
            self._thread = None
        self._abort_connection()
        if self._chan is not None:
            lib.fuse_unmount(self.mountpoint.encode(), self._chan)
            self._chan = None
        if self._fuse is not None:
            lib.fuse_destroy(self._fuse)
            self._fuse = None
        self._ops_impl.close_all()

    def __enter__(self) -> "AlluxioFuseMount":
        self.mount()
        return self

    def __exit__(self, *exc) -> bool:
        self.unmount()
        return False
