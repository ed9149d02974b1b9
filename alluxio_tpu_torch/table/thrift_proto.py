"""Minimal Thrift binary protocol, hand-rolled (a copy of
``alluxio_tpu/table/thrift_proto.py``).

The Hive metastore speaks TBinaryProtocol over a buffered (optionally
framed) socket. The reference's ``table/server/underdb/hive`` pulls the
whole hive-metastore client jar for this; the TPU build needs only the
read-side subset (call + reply, generic struct decode), so these ~200
lines replace that dependency. Protocol layout per the Thrift spec:

  message  = i32 (VERSION_1 | type) + string name + i32 seqid + struct
  struct   = { i8 field-type, i16 field-id, value }* , i8 STOP
  string   = i32 length + bytes
  list/set = i8 elem-type + i32 count + elems
  map      = i8 ktype + i8 vtype + i32 count + pairs

Decoded structs come back as ``{field_id: value}`` dicts — the callers
(``table/hive.py``) name the ids they need; unknown fields decode and
drop, which is exactly the forward-compat contract generated Thrift code
provides.
"""

from __future__ import annotations

import socket
import struct
from io import BytesIO
from typing import Any, Dict, Optional, Tuple

VERSION_1 = 0x80010000

CALL, REPLY, EXCEPTION, ONEWAY = 1, 2, 3, 4

STOP, VOID, BOOL, BYTE, DOUBLE = 0, 1, 2, 3, 4
I16, I32, I64, STRING, STRUCT = 6, 8, 10, 11, 12
MAP, SET, LIST = 13, 14, 15

_i8 = struct.Struct("!b")
_i16 = struct.Struct("!h")
_i32 = struct.Struct("!i")
_i64 = struct.Struct("!q")
_dbl = struct.Struct("!d")


class ThriftError(Exception):
    pass


# ---------------------------------------------------------------- writing
class Writer:
    def __init__(self) -> None:
        self._b = BytesIO()

    def data(self) -> bytes:
        return self._b.getvalue()

    def i8(self, v: int) -> "Writer":
        self._b.write(_i8.pack(v))
        return self

    def i16(self, v: int) -> "Writer":
        self._b.write(_i16.pack(v))
        return self

    def i32(self, v: int) -> "Writer":
        self._b.write(_i32.pack(v))
        return self

    def i64(self, v: int) -> "Writer":
        self._b.write(_i64.pack(v))
        return self

    def double(self, v: float) -> "Writer":
        self._b.write(_dbl.pack(v))
        return self

    def string(self, v: "str | bytes") -> "Writer":
        raw = v.encode() if isinstance(v, str) else v
        self.i32(len(raw))
        self._b.write(raw)
        return self

    def field(self, ftype: int, fid: int) -> "Writer":
        return self.i8(ftype).i16(fid)

    def stop(self) -> "Writer":
        return self.i8(STOP)

    def message(self, name: str, mtype: int, seqid: int) -> "Writer":
        # the version word has the sign bit set; write its signed-i32
        # two's-complement value
        self.i32(((VERSION_1 | mtype) & 0xFFFFFFFF) - (1 << 32))
        self.string(name)
        self.i32(seqid)
        return self

    def write_value(self, ftype: int, v: Any) -> "Writer":
        """Encode a python value as ``ftype``. Structs are passed as
        ``[(fid, ftype, value), ...]`` tuples; lists as
        ``(elem_type, [values])``; maps as ``(ktype, vtype, dict)``."""
        if ftype == BOOL:
            return self.i8(1 if v else 0)
        if ftype == BYTE:
            return self.i8(v)
        if ftype == I16:
            return self.i16(v)
        if ftype == I32:
            return self.i32(v)
        if ftype == I64:
            return self.i64(v)
        if ftype == DOUBLE:
            return self.double(v)
        if ftype == STRING:
            return self.string(v)
        if ftype == STRUCT:
            for fid, ft, fv in v:
                self.field(ft, fid).write_value(ft, fv)
            return self.stop()
        if ftype in (LIST, SET):
            et, items = v
            self.i8(et).i32(len(items))
            for item in items:
                self.write_value(et, item)
            return self
        if ftype == MAP:
            kt, vt, d = v
            self.i8(kt).i8(vt).i32(len(d))
            for k, val in d.items():
                self.write_value(kt, k)
                self.write_value(vt, val)
            return self
        raise ThriftError(f"cannot write thrift type {ftype}")


# ---------------------------------------------------------------- reading
class Reader:
    def __init__(self, data: "bytes | memoryview") -> None:
        self._d = memoryview(data)
        self._pos = 0

    def _take(self, n: int) -> memoryview:
        if self._pos + n > len(self._d):
            raise ThriftError("truncated thrift payload")
        v = self._d[self._pos:self._pos + n]
        self._pos += n
        return v

    def i8(self) -> int:
        return _i8.unpack(self._take(1))[0]

    def i16(self) -> int:
        return _i16.unpack(self._take(2))[0]

    def i32(self) -> int:
        return _i32.unpack(self._take(4))[0]

    def i64(self) -> int:
        return _i64.unpack(self._take(8))[0]

    def double(self) -> float:
        return _dbl.unpack(self._take(8))[0]

    def string(self) -> str:
        n = self.i32()
        return bytes(self._take(n)).decode("utf-8", "replace")

    def message(self) -> Tuple[str, int, int]:
        head = self.i32()
        if head & 0xFFFF0000 == VERSION_1 & 0xFFFFFFFF or head < 0:
            mtype = head & 0xFF
            name = self.string()
            seqid = self.i32()
        else:  # old-style unversioned message
            name = bytes(self._take(head)).decode()
            mtype = self.i8()
            seqid = self.i32()
        return name, mtype, seqid

    def value(self, ftype: int) -> Any:
        if ftype == BOOL:
            return self.i8() != 0
        if ftype == BYTE:
            return self.i8()
        if ftype == I16:
            return self.i16()
        if ftype == I32:
            return self.i32()
        if ftype == I64:
            return self.i64()
        if ftype == DOUBLE:
            return self.double()
        if ftype == STRING:
            return self.string()
        if ftype == STRUCT:
            return self.struct()
        if ftype in (LIST, SET):
            et = self.i8()
            n = self.i32()
            return [self.value(et) for _ in range(n)]
        if ftype == MAP:
            kt, vt = self.i8(), self.i8()
            n = self.i32()
            return {self.value(kt): self.value(vt) for _ in range(n)}
        raise ThriftError(f"cannot read thrift type {ftype}")

    def struct(self) -> Dict[int, Any]:
        """Generic struct decode: {field_id: python value}. Unknown
        fields decode fine (type information is inline)."""
        out: Dict[int, Any] = {}
        while True:
            ftype = self.i8()
            if ftype == STOP:
                return out
            fid = self.i16()
            out[fid] = self.value(ftype)


# --------------------------------------------------------------- transport
class ThriftClient:
    """Buffered (default) or framed TBinaryProtocol client connection."""

    def __init__(self, host: str, port: int, *, framed: bool = False,
                 timeout_s: float = 30.0) -> None:
        self._addr = (host, port)
        self._framed = framed
        self._timeout = timeout_s
        self._sock: Optional[socket.socket] = None
        self._seq = 0

    def connect(self) -> None:
        if self._sock is not None:
            return
        s = socket.create_connection(self._addr, timeout=self._timeout)
        s.settimeout(self._timeout)
        self._sock = s

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self) -> "ThriftClient":
        self.connect()
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ThriftError("metastore closed the connection")
            buf += chunk
        return buf

    def call(self, method: str,
             args: "list[tuple[int, int, Any]]") -> Dict[int, Any]:
        """One RPC: returns the decoded RESULT struct ({0: success,
        k>0: declared exceptions}). Raises ThriftError on transport or
        TApplicationException."""
        self.connect()
        self._seq += 1
        w = Writer().message(method, CALL, self._seq)
        w.write_value(STRUCT, args)
        payload = w.data()
        if self._framed:
            self._sock.sendall(_i32.pack(len(payload)) + payload)
        else:
            self._sock.sendall(payload)
        if self._framed:
            (n,) = _i32.unpack(self._recv_exact(4))
            data = self._recv_exact(n)
        else:
            # buffered transport: read the message incrementally — pull
            # the version+name+seq head, then the result struct. We read
            # greedily in chunks and retry decode on truncation.
            data = b""
            while True:
                try:
                    r = Reader(data)
                    r.message()
                    r.struct()
                    break
                except ThriftError:
                    self._sock.settimeout(self._timeout)
                    chunk = self._sock.recv(1 << 16)
                    if not chunk:
                        raise ThriftError(
                            "metastore closed mid-reply") from None
                    data += chunk
        r = Reader(data)
        name, mtype, _seq = r.message()
        if mtype == EXCEPTION:
            exc = r.struct()
            raise ThriftError(
                f"{method}: TApplicationException "
                f"{exc.get(2)}: {exc.get(1)}")
        result = r.struct()
        return result
