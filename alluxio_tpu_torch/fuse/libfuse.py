"""ctypes binding to libfuse 2.9 (the high-level API, FUSE_USE_VERSION
26); a copy of ``alluxio_tpu/fuse/libfuse.py``.

The image ships ``libfuse.so.2`` but no Python binding, so the adapter
binds the four calls it needs (``fuse_mount`` / ``fuse_new`` /
``fuse_loop`` / ``fuse_unmount`` + teardown) and the ``fuse_operations``
callback table directly. x86_64 Linux ABI only (struct stat layout).
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

c_off_t = ctypes.c_longlong
c_mode_t = ctypes.c_uint
c_dev_t = ctypes.c_ulonglong
c_uid_t = ctypes.c_uint
c_gid_t = ctypes.c_uint


class Stat(ctypes.Structure):
    """``struct stat`` (x86_64 glibc layout)."""

    _fields_ = [
        ("st_dev", ctypes.c_ulong),
        ("st_ino", ctypes.c_ulong),
        ("st_nlink", ctypes.c_ulong),
        ("st_mode", ctypes.c_uint),
        ("st_uid", ctypes.c_uint),
        ("st_gid", ctypes.c_uint),
        ("__pad0", ctypes.c_uint),
        ("st_rdev", ctypes.c_ulong),
        ("st_size", ctypes.c_long),
        ("st_blksize", ctypes.c_long),
        ("st_blocks", ctypes.c_long),
        ("st_atime_sec", ctypes.c_long),
        ("st_atime_nsec", ctypes.c_long),
        ("st_mtime_sec", ctypes.c_long),
        ("st_mtime_nsec", ctypes.c_long),
        ("st_ctime_sec", ctypes.c_long),
        ("st_ctime_nsec", ctypes.c_long),
        ("__glibc_reserved", ctypes.c_long * 3),
    ]


class Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


class FuseFileInfo(ctypes.Structure):
    """``struct fuse_file_info`` (libfuse 2.9)."""

    _fields_ = [
        ("flags", ctypes.c_int),
        ("fh_old", ctypes.c_ulong),
        ("writepage", ctypes.c_int),
        ("bits", ctypes.c_uint),  # direct_io/keep_cache/... bitfield
        ("fh", ctypes.c_uint64),
        ("lock_owner", ctypes.c_uint64),
    ]


class FuseArgs(ctypes.Structure):
    _fields_ = [
        ("argc", ctypes.c_int),
        ("argv", ctypes.POINTER(ctypes.c_char_p)),
        ("allocated", ctypes.c_int),
    ]


class FuseContext(ctypes.Structure):
    _fields_ = [
        ("fuse", ctypes.c_void_p),
        ("uid", c_uid_t),
        ("gid", c_gid_t),
        ("pid", ctypes.c_int),
        ("private_data", ctypes.c_void_p),
        ("umask", c_mode_t),
    ]


# int (*fuse_fill_dir_t)(void *buf, const char *name,
#                        const struct stat *stbuf, off_t off)
fill_dir_t = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_char_p, ctypes.POINTER(Stat),
                              c_off_t)

_CB = ctypes.CFUNCTYPE
_p = ctypes.POINTER

getattr_t = _CB(ctypes.c_int, ctypes.c_char_p, _p(Stat))
readlink_t = _CB(ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
                 ctypes.c_size_t)
mknod_t = _CB(ctypes.c_int, ctypes.c_char_p, c_mode_t, c_dev_t)
mkdir_t = _CB(ctypes.c_int, ctypes.c_char_p, c_mode_t)
path_t = _CB(ctypes.c_int, ctypes.c_char_p)
path2_t = _CB(ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)
chmod_t = _CB(ctypes.c_int, ctypes.c_char_p, c_mode_t)
chown_t = _CB(ctypes.c_int, ctypes.c_char_p, c_uid_t, c_gid_t)
truncate_t = _CB(ctypes.c_int, ctypes.c_char_p, c_off_t)
open_t = _CB(ctypes.c_int, ctypes.c_char_p, _p(FuseFileInfo))
read_t = _CB(ctypes.c_int, ctypes.c_char_p, _p(ctypes.c_char),
             ctypes.c_size_t, c_off_t, _p(FuseFileInfo))
write_t = _CB(ctypes.c_int, ctypes.c_char_p, _p(ctypes.c_char),
              ctypes.c_size_t, c_off_t, _p(FuseFileInfo))
readdir_t = _CB(ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
                fill_dir_t, c_off_t, _p(FuseFileInfo))
create_t = _CB(ctypes.c_int, ctypes.c_char_p, c_mode_t,
               _p(FuseFileInfo))
utimens_t = _CB(ctypes.c_int, ctypes.c_char_p, _p(Timespec))
access_t = _CB(ctypes.c_int, ctypes.c_char_p, ctypes.c_int)
fsync_t = _CB(ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
              _p(FuseFileInfo))


class FuseOperations(ctypes.Structure):
    """``struct fuse_operations`` field order for FUSE_USE_VERSION 26
    (libfuse 2.9 ``fuse.h``). Unimplemented slots stay NULL."""

    _fields_ = [
        ("getattr", getattr_t),
        ("readlink", readlink_t),
        ("getdir", ctypes.c_void_p),  # deprecated
        ("mknod", mknod_t),
        ("mkdir", mkdir_t),
        ("unlink", path_t),
        ("rmdir", path_t),
        ("symlink", path2_t),
        ("rename", path2_t),
        ("link", path2_t),
        ("chmod", chmod_t),
        ("chown", chown_t),
        ("truncate", truncate_t),
        ("utime", ctypes.c_void_p),  # superseded by utimens
        ("open", open_t),
        ("read", read_t),
        ("write", write_t),
        ("statfs", ctypes.c_void_p),
        ("flush", open_t),
        ("release", open_t),
        ("fsync", fsync_t),
        ("setxattr", ctypes.c_void_p),
        ("getxattr", ctypes.c_void_p),
        ("listxattr", ctypes.c_void_p),
        ("removexattr", ctypes.c_void_p),
        ("opendir", open_t),
        ("readdir", readdir_t),
        ("releasedir", open_t),
        ("fsyncdir", ctypes.c_void_p),
        ("init", ctypes.c_void_p),
        ("destroy", ctypes.c_void_p),
        ("access", access_t),
        ("create", create_t),
        ("ftruncate", ctypes.c_void_p),
        ("fgetattr", ctypes.c_void_p),
        ("lock", ctypes.c_void_p),
        ("utimens", utimens_t),
        ("bmap", ctypes.c_void_p),
        ("flags_", ctypes.c_uint),  # nullpath_ok/nopath/... bitfield
        ("ioctl", ctypes.c_void_p),
        ("poll", ctypes.c_void_p),
        ("write_buf", ctypes.c_void_p),
        ("read_buf", ctypes.c_void_p),
        ("flock", ctypes.c_void_p),
        ("fallocate", ctypes.c_void_p),
    ]


_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """Load and prototype libfuse.so.2; raises OSError when absent."""
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("fuse") or "libfuse.so.2"
    lib = ctypes.CDLL(name, use_errno=True)
    lib.fuse_mount.restype = ctypes.c_void_p  # struct fuse_chan *
    lib.fuse_mount.argtypes = [ctypes.c_char_p, _p(FuseArgs)]
    # fuse_new MUST be the versioned FUSE_2.6 symbol: the library also
    # exports an UNVERSIONED compat shim (first arg ``int fd``) that
    # plain dlsym prefers — it truncates the chan pointer to an fd and
    # every later channel read fails with EBADF
    libc = ctypes.CDLL(None, use_errno=True)
    libc.dlvsym.restype = ctypes.c_void_p
    libc.dlvsym.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_char_p]
    addr = libc.dlvsym(lib._handle, b"fuse_new", b"FUSE_2.6")
    if not addr:  # pragma: no cover - other libfuse2 builds
        addr = ctypes.cast(lib.fuse_new, ctypes.c_void_p).value
    lib.fuse_new_versioned = ctypes.CFUNCTYPE(
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        _p(FuseOperations), ctypes.c_size_t, ctypes.c_void_p)(addr)
    lib.fuse_loop.restype = ctypes.c_int
    lib.fuse_loop.argtypes = [ctypes.c_void_p]
    lib.fuse_exit.restype = None
    lib.fuse_exit.argtypes = [ctypes.c_void_p]
    lib.fuse_unmount.restype = None
    lib.fuse_unmount.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.fuse_destroy.restype = None
    lib.fuse_destroy.argtypes = [ctypes.c_void_p]
    lib.fuse_get_context.restype = _p(FuseContext)
    lib.fuse_get_context.argtypes = []
    _lib = lib
    return lib


def make_args(options: str) -> FuseArgs:
    """Build ``struct fuse_args`` for ``-o <options>`` (keep a reference
    to the returned object alive for the duration of the mount)."""
    argv_list = [b"alluxio-tpu-fuse"]
    if options:
        argv_list += [b"-o", options.encode()]
    argv = (ctypes.c_char_p * (len(argv_list) + 1))(*argv_list, None)
    args = FuseArgs(len(argv_list), argv, 0)
    args._argv_keepalive = argv  # noqa: SLF001 - GC anchor
    return args
