"""The port's journal against the JAX package's, on the CPU.

- ``iter_frames`` over seeded logs that end in each kind of torn tail (a
  short header, a short body, a zero length, a bad CRC) gives the JAX
  scanner's body offsets, on the port's native scanner
  (``atpu_scan_frames``) and on its plain path, which is counted;
  ``native.crc32`` gives the JAX library's CRC on the same seeded bytes.
- A journal that one package's ``LocalJournalSystem`` writes (a seeded
  metadata script with segment rotation, a checkpoint in the middle, and
  the group-commit flusher in one case) replays in the other package's
  into the state the writer held (every journaled component's snapshot)
  and into the namespace (``list_status``/``get_status`` wire dicts) the
  writer's own package replays. Block locations are soft state that the
  workers re-register, so a replayed namespace is compared with a
  replayed one.
"""

import os
import struct
import zlib

import msgpack
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu import native as jax_native  # noqa: E402
from alluxio_tpu.journal import format as jax_format  # noqa: E402
from alluxio_tpu_torch import native  # noqa: E402
from alluxio_tpu_torch.journal import format as port_format  # noqa: E402
from tests.testutils.torch_master import (  # noqa: E402
    Masters, make_script, resolve,
)
from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: E402,F401
    port_lock_order_audit, port_lockaudit_install,
)

TAILS = ("clean", "short_header", "short_body", "zero_length", "bad_crc")


def _log(seed: int, tail: str) -> bytes:
    """Seeded frames of random sizes, then the torn tail."""
    rng = np.random.default_rng(seed)
    out = b""
    for _ in range(int(rng.integers(20, 60))):
        body = rng.integers(0, 256, int(rng.integers(1, 300)),
                            dtype=np.uint8).tobytes()
        out += struct.pack("<II", len(body), zlib.crc32(body)) + body
    body = b"torn-tail-body"
    if tail == "short_header":
        out += struct.pack("<II", len(body), zlib.crc32(body))[:5]
    elif tail == "short_body":
        out += struct.pack("<II", len(body), zlib.crc32(body)) + body[:4]
    elif tail == "zero_length":
        out += bytes(64)  # zero padding past the last frame
    elif tail == "bad_crc":
        out += struct.pack("<II", len(body), zlib.crc32(body) ^ 1) + body
    # a valid frame after the tear must never be reached
    out += struct.pack("<II", 3, zlib.crc32(b"abc")) + b"abc"
    return out


@pytest.fixture()
def plain(monkeypatch):
    """The port's library made unavailable: every call takes the plain
    path."""
    monkeypatch.setattr(native, "_lib", False)
    native.reset_counts()
    yield
    native.reset_counts()


def _jax_offsets(data: bytes):
    frames = list(jax_format.iter_frames(data))
    lib = jax_native.scan_frames(data)
    if lib is not None:  # the JAX library, when it builds
        assert lib[0] == frames
    return frames


@pytest.mark.parametrize("tail", TAILS)
def test_iter_frames_native_matches_jax(tail):
    data = _log(TAILS.index(tail) + 7, tail)
    assert native.loaded()
    native.reset_counts()
    want = _jax_offsets(data)
    assert list(port_format.iter_frames(data)) == want
    assert native.scan_frames(data) == (want, want[-1][0] + want[-1][1])
    assert native.plain_calls()["scan"] == 0


@pytest.mark.parametrize("tail", TAILS)
def test_iter_frames_plain_matches_jax(plain, tail):
    data = _log(TAILS.index(tail) + 7, tail)
    want = _jax_offsets(data)
    assert list(port_format.iter_frames(data)) == want
    assert native.scan_frames(bytearray(data))[0] == want
    assert native.plain_calls()["scan"] == 2


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_crc32_matches_jax(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, int(rng.integers(1, 5000)),
                        dtype=np.uint8).tobytes()
    start = int(rng.integers(0, 1 << 32))
    want = zlib.crc32(data, start)
    if jax_native.lib() is not None:
        assert jax_native.crc32(data, start) == want
    native.reset_counts()
    assert native.crc32(data, start) == want
    assert native.plain_calls()["crc"] == 0


def test_crc32_plain_path_is_counted(plain):
    data = bytes(range(256)) * 3
    assert native.crc32(data, 5) == zlib.crc32(data, 5)
    assert native.plain_calls()["crc"] == 1


def test_decode_stream_reads_a_jax_log(tmp_path):
    """Entries a JAX journal frames decode in the port, torn tail and
    all, from a file (the mmap path)."""
    path = tmp_path / "current.log"
    entries = [jax_format.JournalEntry(i + 1, "add", {"n": i, "b": b"x" * i})
               for i in range(50)]
    path.write_bytes(b"".join(e.encode() for e in entries) + b"\x07\x00")
    with open(path, "rb") as f:
        got = [(e.sequence, e.type, e.payload)
               for e in port_format.JournalEntry.decode_stream(f)]
    assert got == [(e.sequence, e.type, e.payload) for e in entries]


# -- a journal written by one package replays in the other --------------------
def _norm(obj):
    return msgpack.unpackb(msgpack.packb(
        obj, use_bin_type=True,
        default=lambda o: sorted(o) if isinstance(o, (set, frozenset))
        else o), raw=False, strict_map_key=False)


def _components(m: Masters) -> dict:
    return m.norm(_norm({name: comp.snapshot() for name, comp in
                         sorted(m.journal._components.items())}))


def _replay(pkg: str, base: str, seed: int) -> dict:
    """Replay ``base``'s journal in ``pkg``: its components' state and
    the namespace it serves."""
    r = Masters(pkg, base, seed=seed)
    r.journal.start()
    r.journal.gain_primacy()  # the checkpoint, then the segments
    r.fsm.start(os.path.join(r.ufs_root, "root"))
    try:
        obs = r.observe()
        return {"components": _components(r),
                "namespace": {k: obs[k] for k in
                              ("root", "listing", "statuses", "mounts")}}
    finally:
        r.stop()


@pytest.mark.parametrize("checkpoint", (False, True),
                         ids=("rotation", "rotation+checkpoint"))
@pytest.mark.parametrize("writer,reader", (
    ("alluxio_tpu", "alluxio_tpu_torch"),
    ("alluxio_tpu_torch", "alluxio_tpu")))
def test_journal_replays_in_the_other_package(tmp_path, writer, reader,
                                              checkpoint):
    base = str(tmp_path / "cluster")
    w = Masters(writer, base, seed=11, max_log_size=2048).start()
    seen = []
    for i, op in enumerate(make_script(11, 120)):
        seen.append(w.run(resolve(op, seen)))
        if checkpoint and i == 60:
            w.journal.checkpoint()
    written = _components(w)
    w.stop()
    logs = os.listdir(os.path.join(base, "journal", "logs"))
    assert len(logs) > 3  # the segments rotated
    assert bool(os.listdir(os.path.join(base, "journal", "checkpoints"))) \
        == checkpoint
    own, other = _replay(writer, base, 11), _replay(reader, base, 11)
    assert other["components"] == written == own["components"]
    assert other["namespace"] == own["namespace"]


def test_group_commit_journal_replays_in_jax(tmp_path):
    """The port's dedicated flusher writes a journal the JAX package
    replays."""
    base = str(tmp_path / "cluster")
    w = Masters("alluxio_tpu_torch", base, seed=3).start()
    w.journal.start_group_commit(0.001)
    seen = []
    for op in make_script(3, 80):
        with w.journal.deferred_durability():
            seen.append(w.run(resolve(op, seen)))
    written = _components(w)
    w.stop()
    own, other = _replay("alluxio_tpu_torch", base, 3), \
        _replay("alluxio_tpu", base, 3)
    assert other["components"] == written == own["components"]
    assert other["namespace"] == own["namespace"]
