"""Native (C++) host runtime: the port of ``alluxio_tpu/native/``.

The C++ sources here are copies of the JAX package's (``framing.cpp``:
the page pre-fault, the CRC32 and the journal-frame scanner;
``plan_exec.cpp``: the small-read plan executor). They are built with
``g++`` at first use, never at import, into ``build/torch_native/``
under the checkout (named by a hash of the sources and the flags, so an
edited source is rebuilt), and loaded with ``ctypes.CDLL``, which
releases the GIL for every foreign call.

``lib()`` returns the loaded library, or ``None`` when there is no
``g++`` or the build failed: callers then take their plain Python path,
which gives the same bytes. Every time a pre-fault or a plan takes that
plain path it is counted (:func:`plain_calls`), and every pre-fault is
counted with its bytes (:func:`prefault_calls`), so a run that must not
fall back (the card's smoke run) can check :func:`loaded` and the
counts. All four entry points are bound: ``atpu_prefault``,
``atpu_plan_exec``, and the journal's ``atpu_scan_frames`` and
``atpu_crc32``, whose plain paths are counted the same way.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import struct
import threading
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

LOG = logging.getLogger(__name__)

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
#: the JAX package's compile line (``alluxio_tpu/native/__init__.py``)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-Wall", "-Werror")

_PROTOTYPES: "Dict[str, Tuple[list, object]]" = {
    "atpu_crc32": (
        [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32],
        ctypes.c_uint32),
    "atpu_scan_frames": (
        [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
         ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
         ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64)],
        ctypes.c_size_t),
    "atpu_prefault": (
        [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t],
        ctypes.c_uint64),
    "atpu_plan_exec": (
        [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
         ctypes.c_size_t],
        ctypes.c_int64),
}

_lock = threading.Lock()
_lib: "ctypes.CDLL | None | bool" = None  # None=untried, False=failed
_plain = {"prefault": 0, "plan": 0, "scan": 0, "crc": 0}
_prefaults = [0, 0]  # calls, bytes


def _sources():
    return sorted(SRC_DIR.glob("*.cpp"))


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libatpu_native-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """Compile the library unless this source set is built already.
    The compiler writes a temp file that is then renamed, so processes
    building at once never load a half-written library."""
    so = _lib_path()
    if so.exists():
        return so
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
    except OSError:
        LOG.debug("native build dir unavailable", exc_info=True)
        return None
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
        if r.returncode == 0:
            os.replace(tmp, so)
            return so
        LOG.warning("native build failed: %s", r.stderr.decode()[:500])
    except (OSError, subprocess.SubprocessError):
        LOG.debug("native build unavailable", exc_info=True)
    os.unlink(tmp)
    return None


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; ``None`` when it cannot
    be built or loaded (callers take their plain path)."""
    global _lib
    if _lib is not None:
        return _lib or None
    with _lock:
        if _lib is not None:
            return _lib or None
        so = _build()
        try:
            handle = ctypes.CDLL(str(so)) if so is not None else None
            if handle is not None:
                for name, (argtypes, restype) in _PROTOTYPES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
        except (OSError, AttributeError):
            LOG.warning("native library %s unusable", so, exc_info=True)
            handle = None
        _lib = handle if handle is not None else False
        return handle


def loaded() -> bool:
    """True when the library built and loaded."""
    return lib() is not None


def note_plain(kind: str) -> None:
    """Count one call that took the plain path (``prefault``, ``plan``,
    ``scan`` or ``crc``)."""
    with _lock:
        _plain[kind] += 1


def plain_calls() -> Dict[str, int]:
    """Calls that took the plain path since :func:`reset_counts`."""
    with _lock:
        return dict(_plain)


def prefault_calls() -> Tuple[int, int]:
    """(calls, bytes) of :func:`prefault`, native or plain, since
    :func:`reset_counts`."""
    with _lock:
        return _prefaults[0], _prefaults[1]


def reset_counts() -> None:
    with _lock:
        for k in _plain:
            _plain[k] = 0
        _prefaults[:] = [0, 0]


def _buffer_address(view) -> "Tuple[int, int, object] | None":
    """(address, nbytes, keepalive) of a buffer WITHOUT copying,
    readonly or not — hold ``keepalive`` for the duration of the native
    call. None when no zero-copy address is obtainable."""
    data_attr = getattr(view, "ctypes", None)
    if data_attr is not None and hasattr(data_attr, "data"):
        if not view.flags.c_contiguous:
            return None
        return data_attr.data, view.nbytes, view
    if isinstance(view, bytes):
        return (ctypes.cast(view, ctypes.c_void_p).value or 0,
                len(view), view)
    mv = memoryview(view)
    if not mv.c_contiguous:
        return None
    if not mv.readonly:
        buf = (ctypes.c_char * mv.nbytes).from_buffer(mv)
        return ctypes.addressof(buf), mv.nbytes, buf
    # readonly memoryview or mmap: a numpy view exposes the address
    # without requiring writability (native code only reads)
    arr = np.frombuffer(mv.cast("B"), dtype=np.uint8)
    return arr.ctypes.data, arr.nbytes, (arr, mv)


def _bytes_of(view) -> np.ndarray:
    """A zero-copy ``uint8`` view of a C-contiguous buffer."""
    if isinstance(view, np.ndarray):
        return np.ascontiguousarray(view).reshape(-1).view(np.uint8)
    return np.frombuffer(memoryview(view).cast("B"), dtype=np.uint8)


def prefault(view, stride: int = 4096) -> int:
    """Touch one byte per ``stride`` BYTES of ``view`` (the first of
    each stride) and its last byte, so a later sequential copy finds
    every page mapped. Natively the touch runs with the GIL released;
    the plain path touches the same bytes and is counted. Returns the
    sum of the touched bytes (``atpu_prefault``'s checksum), which keeps
    the touch from being optimised away and shows what was touched."""
    stride = stride or 4096
    handle = lib()
    loc = _buffer_address(view) if handle is not None else None
    with _lock:
        _prefaults[0] += 1
        _prefaults[1] += loc[1] if loc is not None else _bytes_of(view).size
    if loc is not None:
        addr, n, keepalive = loc
        out = handle.atpu_prefault(addr, n, stride) if n else 0
        del keepalive
        return int(out)
    note_plain("prefault")
    b = _bytes_of(view)
    if not b.size:
        return 0
    total = int(b[::stride].sum(dtype=np.uint64)) + int(b[-1])
    return total & 0xFFFFFFFFFFFFFFFF


# ------------------------------------------------------------ journal frames

_HEADER = struct.Struct("<II")  # length, crc32
_SCAN_CHUNK = 65536  # frames per native call: bounds the offset arrays


def scan_frames(view) -> "Tuple[List[Tuple[int, int]], int]":
    """Scan ``[u32 len][u32 crc32][body]`` frames over a buffer
    (bytes, bytearray, ndarray or mmap) with no copy of the data.
    Returns ``([(body_off, body_len), ...], end_off)``: ``end_off`` is
    the truncation point after the last valid frame. The scan stops at
    the torn tail (a short header or body, a zero length, a CRC
    mismatch). Natively it runs in bounded chunks with the GIL
    released; without the library (or a zero-copy address) the plain
    path gives the same frames and is counted."""
    handle = lib()
    loc = _buffer_address(view) if handle is not None else None
    if loc is None:
        note_plain("scan")
        return _scan_frames_plain(view)
    addr, n, keepalive = loc
    if n == 0:
        return [], 0
    offs = (ctypes.c_uint64 * _SCAN_CHUNK)()
    lens = (ctypes.c_uint32 * _SCAN_CHUNK)()
    end = ctypes.c_uint64(0)
    frames: List[Tuple[int, int]] = []
    start = 0
    while True:
        got = handle.atpu_scan_frames(addr, n, start, offs, lens,
                                      _SCAN_CHUNK, ctypes.byref(end))
        frames.extend((offs[i], lens[i]) for i in range(got))
        start = end.value
        if got < _SCAN_CHUNK:
            break
    del keepalive
    return frames, end.value


def _scan_frames_plain(view) -> "Tuple[List[Tuple[int, int]], int]":
    frames: List[Tuple[int, int]] = []
    pos = 0
    # the views are released before return: an mmap whose buffer is
    # still exported cannot be closed
    with memoryview(view) as mv, mv.cast("B") as data:
        n = len(data)
        while pos + _HEADER.size <= n:
            length, crc = _HEADER.unpack_from(data, pos)
            start = pos + _HEADER.size
            with data[start:start + length] as body:
                if length == 0 or len(body) < length or \
                        zlib.crc32(body) != crc:
                    break
            frames.append((start, length))
            pos = start + length
    return frames, pos


def crc32(data: bytes, seed: int = 0) -> int:
    """zlib's CRC-32 of ``data`` continued from ``seed``; natively with
    the GIL released, else (counted) through ``zlib.crc32``."""
    handle = lib()
    if handle is None:
        note_plain("crc")
        return zlib.crc32(data, seed)
    return int(handle.atpu_crc32(data, len(data), seed))


# ---------------------------------------------------------------- plan exec

# Mirrors struct AtpuPlanOp in plan_exec.cpp exactly: 48 bytes,
# little-endian, naturally aligned (u32+i32 then five u64) — no
# padding, so a C-contiguous structured array IS the C op table.
OP_COPY = 0
OP_PREAD = 1
OP_DTYPE_FIELDS = [
    ("kind", "<u4"), ("fd", "<i4"), ("src", "<u8"), ("src_off", "<u8"),
    ("src_len", "<u8"), ("dst_off", "<u8"), ("len", "<u8"),
]


def op_dtype() -> np.dtype:
    dt = np.dtype(OP_DTYPE_FIELDS)
    if dt.itemsize != 48:
        raise RuntimeError("op dtype drifted from plan_exec.cpp")
    return dt


def exec_plan(ops, dest) -> Optional[int]:
    """Run a packed op table (a C-contiguous structured array of
    ``op_dtype()`` records) against ``dest`` (a writable buffer) in ONE
    native call, the GIL released for the whole batch. Returns the
    executor's result (total bytes written >= 0, or ``-(i+1)`` when op
    ``i`` failed), or ``None`` when the library or a zero-copy address
    of ``dest`` is unavailable (the caller takes its plain path)."""
    handle = lib()
    if handle is None:
        return None
    nops = len(ops)
    if nops == 0:
        return 0
    dst = _buffer_address(dest)
    if dst is None:
        return None
    dst_addr, dst_len, dst_keep = dst
    ops = np.ascontiguousarray(ops, dtype=op_dtype())
    rc = handle.atpu_plan_exec(ops.ctypes.data, nops, dst_addr, dst_len)
    del dst_keep
    return int(rc)
