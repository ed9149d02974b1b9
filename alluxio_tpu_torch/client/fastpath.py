"""Native fastpath: execute an assembled small-read plan outside the GIL
(the port of ``alluxio_tpu/client/fastpath.py``).

``choose_route`` (``client/remote_read.py``) stays the planner; this
module is the bridge to the engine (``native/plan_exec.cpp``). A caller
packs its batch — SHM segment copies, ``read_many`` response scatter,
stripe commits — into ONE numpy op table (48-byte records mirroring
``struct AtpuPlanOp``), and :func:`execute_table` hands the whole table
across the ctypes boundary in a single call, which runs with the GIL
released.

Fallback contract: any native problem — library missing, bounds
rejection, I/O error — surfaces as :exc:`NativeExecError` after counting
``Client.NativeFallbacks`` and a plain plan (``native.plain_calls``),
and the caller re-runs the same batch through its Python path, which
gives the same bytes. Deterministic chaos rides
``atpu.debug.fault.native.exec.error.rate``: a taken fault poisons ONE
op mid-table, so the drill exercises a real partial-write batch.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from alluxio_tpu_torch import native
from alluxio_tpu_torch.metrics import metrics
from alluxio_tpu_torch.utils import faults

OP_COPY = native.OP_COPY
OP_PREAD = native.OP_PREAD

#: direct stripe-chunk commits below this ride the plain memoryview
#: copy: a one-op table costs a few microseconds to build, which only
#: pays for itself once the GIL-free memcpy is big enough to matter
MIN_COPY_BYTES = 64 << 10

#: an op kind plan_exec.cpp does not know — the mid-table poison the
#: fault injector plants to drill genuine partial-write fallbacks
_POISON_KIND = 0xDEAD


class NativeExecError(Exception):
    """A native batch did not complete; the caller falls back to the
    byte-identical Python path."""


def available() -> bool:
    """True when the compiled library is loadable."""
    return native.loaded()


def op_table(nops: int) -> np.ndarray:
    """A zeroed op table ready for vectorized column fills."""
    return np.zeros(nops, dtype=native.op_dtype())


def note_unavailable() -> None:
    """The caller asked for the fastpath but the library is missing:
    count the fallback."""
    metrics().counter("Client.NativeFallbacks").inc()
    native.note_plain("plan")


def _maybe_poison(ops, host: str):
    """Fault hook: when ``atpu.debug.fault.native.exec.error.rate``
    takes this batch, poison one op in the MIDDLE of a copy of the
    table — the native executor writes everything before it, then
    rejects, so the fallback drill covers a genuinely partial buffer."""
    if not faults.armed() or \
            not faults.injector().take_native_exec_error(host):
        return ops
    ops = ops.copy()
    ops["kind"][len(ops) // 2] = _POISON_KIND
    return ops


def execute_table(ops, dest, *, host: str = "") -> int:
    """Run a packed op table against ``dest`` in one GIL-free native
    call. Returns the bytes written; raises :exc:`NativeExecError`
    (after counting the fallback) when the library is unavailable or
    any op fails. ``dest`` may hold partial results after a failure; the
    fallback overwrites every planned byte. ``host`` is the call site's
    scope for the fault injector."""
    nops = len(ops)
    if nops == 0:
        return 0
    ops = _maybe_poison(ops, host)
    rc = native.exec_plan(ops, dest)
    if rc is None or rc < 0:
        note_unavailable()
        raise NativeExecError(
            f"native plan exec failed (rc={rc}, ops={nops})")
    m = metrics()
    m.counter("Client.NativeBatches").inc()
    m.counter("Client.NativeBatchOps").inc(nops)
    m.counter("Client.NativeBatchBytes").inc(rc)
    return rc


def slice_out(dest, bounds: Sequence[int]) -> List[bytes]:
    """Cut ``dest`` into per-op ``bytes`` at ``bounds`` (len N+1,
    monotone) — the List[bytes] surface ``pread_many`` promises."""
    mv = memoryview(dest)
    return [bytes(mv[a:b]) for a, b in zip(bounds, bounds[1:])]


def copy_into(dest, dst_off: int, src, *, host: str = "") -> bool:
    """One GIL-free memcpy of ``src`` into ``dest[dst_off:]`` — the
    stripe-commit form. True when the native path ran; False (library
    missing, no zero-copy address, injected fault, bounds rejection)
    means the caller does the plain Python copy, which gives the same
    bytes."""
    if not available():
        note_unavailable()
        return False
    loc = native._buffer_address(src)
    if loc is None:
        note_unavailable()
        return False
    addr, n, keep = loc
    if n == 0:
        return True
    ops = op_table(1)
    ops[0] = (OP_COPY, -1, addr, 0, n, dst_off, n)
    try:
        execute_table(ops, dest, host=host)
    except NativeExecError:
        return False
    finally:
        del keep
    return True


class ReadPlan:
    """Incremental plan builder for mixed-source batches. ``add_copy``
    pins a zero-copy address of each source buffer; :meth:`execute`
    runs the packed table natively and :meth:`execute_python` is the
    Python reference interpreter the native engine is held to."""

    __slots__ = ("_rows", "_keep")

    def __init__(self) -> None:
        #: (kind, fd, src_obj, src_addr, src_off, src_len, dst_off, len)
        self._rows: list = []
        self._keep: list = []

    def __len__(self) -> int:
        return len(self._rows)

    def add_copy(self, src, src_off: int, length: int,
                 dst_off: int) -> bool:
        """Plan ``dest[dst_off:dst_off+length] = src[src_off:...]``.
        False when ``src`` yields no zero-copy address (caller keeps
        that op on its Python path)."""
        loc = native._buffer_address(src)
        if loc is None:
            return False
        addr, n, keep = loc
        self._keep.append(keep)
        self._rows.append((OP_COPY, -1, src, addr, src_off, n,
                           dst_off, length))
        return True

    def add_pread(self, fd: int, file_off: int, length: int,
                  dst_off: int) -> None:
        """Plan ``dest[dst_off:dst_off+length] = pread(fd, file_off)``."""
        self._rows.append((OP_PREAD, fd, None, 0, file_off, 0,
                           dst_off, length))

    def table(self) -> np.ndarray:
        ops = op_table(len(self._rows))
        for i, (kind, fd, _src, addr, soff, slen, doff, ln) in \
                enumerate(self._rows):
            ops[i] = (kind, fd, addr, soff, slen, doff, ln)
        return ops

    def execute(self, dest) -> int:
        return execute_table(self.table(), dest)

    def execute_python(self, dest) -> int:
        """The reference interpreter: identical semantics to
        ``atpu_plan_exec`` (same bounds checks, same in-order overlap
        resolution, same error positions), one Python frame per op."""
        mv = memoryview(dest).cast("B")
        total = 0
        for i, (kind, fd, src, _addr, soff, slen, doff, ln) in \
                enumerate(self._rows):
            if ln == 0:
                continue
            if doff > len(mv) or ln > len(mv) - doff:
                raise NativeExecError(f"python plan exec failed at op {i}")
            if kind == OP_COPY:
                if src is None or soff > slen or ln > slen - soff:
                    raise NativeExecError(
                        f"python plan exec failed at op {i}")
                smv = memoryview(src).cast("B")
                mv[doff:doff + ln] = smv[soff:soff + ln]
            elif kind == OP_PREAD:
                data = os.pread(fd, ln, soff)
                if len(data) != ln:
                    raise NativeExecError(
                        f"python plan exec failed at op {i}")
                mv[doff:doff + ln] = data
            else:
                raise NativeExecError(f"python plan exec failed at op {i}")
            total += ln
        return total
