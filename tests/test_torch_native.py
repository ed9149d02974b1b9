"""The port's native host runtime (``alluxio_tpu_torch/native``) against
the JAX package's, on the CPU.

- ``prefault``: natively and on the plain path, the checksum of the bytes
  touched equals the JAX library's ``atpu_prefault`` on the same buffer —
  one byte per 4096 BYTES plus the last byte — for ``uint8``, ``int32``
  and ``float64`` views, and the plain path is counted.
- The loader's producer pre-faults every block it hands the consumer
  through ``native.prefault``, with the same checksum (it used to touch
  ``host[::4096]``, a stride of 4096 elements).
- ``exec_plan`` and ``ReadPlan`` on seeded op tables give the JAX
  library's bytes and return codes, failures at the same op included.
- The library builds into ``build/torch_native/``, never beside its
  sources, and without ``g++`` ``lib()`` is ``None``.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from alluxio_tpu import native as jax_native  # noqa: E402
from alluxio_tpu.client import fastpath as jax_fastpath  # noqa: E402
from alluxio_tpu_torch import native  # noqa: E402
from alluxio_tpu_torch.client import fastpath  # noqa: E402

KB = 1024
DTYPES = ("uint8", "int32", "float64")
#: byte sizes: under a page, a page, pages plus a tail, many pages
NBYTES = (8, 4096, 3 * 4096 + 24, 40 * 4096)


@pytest.fixture(scope="module")
def jax_lib():
    handle = jax_native.lib()
    if handle is None:
        pytest.skip("no native toolchain for the JAX library")
    return handle


@pytest.fixture()
def plain(monkeypatch):
    """The port's library made unavailable: every call takes the plain
    path."""
    monkeypatch.setattr(native, "_lib", False)
    native.reset_counts()
    yield
    native.reset_counts()


def _view(dtype: str, nbytes: int, seed: int) -> np.ndarray:
    raw = np.random.default_rng(seed).integers(1, 256, nbytes,
                                               dtype=np.uint8)
    return raw.view(np.dtype(dtype))


def _jax_checksum(jax_lib, view: np.ndarray) -> int:
    return int(jax_lib.atpu_prefault(view.ctypes.data, view.nbytes, 4096))


def _touched_sum(view: np.ndarray) -> int:
    """The bytes at ``range(0, nbytes, 4096)`` plus the last byte."""
    b = view.view(np.uint8)
    return sum(int(b[i]) for i in range(0, b.size, 4096)) + int(b[-1])


# -- prefault -----------------------------------------------------------------
@pytest.mark.parametrize("nbytes", NBYTES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefault_native_matches_jax(jax_lib, dtype, nbytes):
    view = _view(dtype, nbytes, nbytes)
    assert native.loaded()
    native.reset_counts()
    got = native.prefault(view)
    assert got == _jax_checksum(jax_lib, view) == _touched_sum(view)
    assert native.plain_calls()["prefault"] == 0
    assert native.prefault_calls() == (1, view.nbytes)


@pytest.mark.parametrize("nbytes", NBYTES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefault_plain_path_matches_jax(jax_lib, plain, dtype, nbytes):
    view = _view(dtype, nbytes, nbytes + 1)
    assert not native.loaded()
    assert native.prefault(view) == _jax_checksum(jax_lib, view)
    assert native.prefault(memoryview(view.view(np.uint8))) == \
        _jax_checksum(jax_lib, view)
    assert native.plain_calls() == {"prefault": 2, "plan": 0, "scan": 0,
                                    "crc": 0}
    assert native.prefault_calls() == (2, 2 * view.nbytes)


def _block_files(tmp_path, dtype: str, n: int = 3):
    files = {}
    for i in range(n):
        path = tmp_path / f"b{i}.blk"
        _view(dtype, NBYTES[-1] + 8 * i, 40 + i).tofile(path)
        files[f"/f{i}"] = str(path)
    return files


def _file_source(files: dict):
    from alluxio_tpu_torch.client.block_streams import LocalBlockInStream

    def open_file(path, info=None, max_open_streams=1):
        stream = LocalBlockInStream.from_path(files[path],
                                              os.path.getsize(files[path]))
        return SimpleNamespace(block_stream=lambda i: stream,
                               close=stream.close)

    names = list(files)
    return SimpleNamespace(
        get_status=lambda p: SimpleNamespace(file_id=names.index(p) + 1,
                                             block_ids=[names.index(p) + 1]),
        open_file=open_file)


@pytest.mark.parametrize("path", ["native", "plain"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_loader_producer_prefaults_every_page(jax_lib, request, tmp_path,
                                              monkeypatch, dtype, path):
    """Each block the producer hands over was pre-faulted through
    ``native.prefault``, and the touched bytes' checksum is the JAX
    library's on the file's bytes."""
    from alluxio_tpu_torch.client.torch_io import DeviceBlockLoader

    if path == "plain":
        request.getfixturevalue("plain")
    files = _block_files(tmp_path, dtype)
    seen = []
    real = native.prefault

    def spy(view, stride=4096):
        out = real(view, stride)
        seen.append((view.nbytes, out))
        return out

    monkeypatch.setattr(native, "prefault", spy)
    loader = DeviceBlockLoader(_file_source(files), list(files),
                               device="cpu", dtype=np.dtype(dtype))
    try:
        blocks = list(loader.epoch())
    finally:
        loader.close()
    want = []
    for block, f in zip(blocks, files.values()):
        data = np.fromfile(f, dtype=np.dtype(dtype))
        assert block.numpy().tobytes() == data.tobytes()
        want.append((data.nbytes, _jax_checksum(jax_lib, data)))
    assert seen == want
    assert native.plain_calls()["prefault"] == \
        (len(files) if path == "plain" else 0)


# -- plan executor -------------------------------------------------------------
def _op_rows(rng, dest_len: int, sources, fd: int, file_len: int,
             n_ops: int, bad: bool):
    """Seeded (kind, fd, source index, src_off, dst_off, len) rows: COPY
    from a source or PREAD from the file, overlapping destinations,
    zero-length ops, and with ``bad`` one op past its source or dest."""
    rows = []
    for _ in range(n_ops):
        ln = int(rng.choice([0, int(rng.integers(1, 3 * KB))]))
        dst_off = int(rng.integers(0, max(1, dest_len - ln + 1)))
        if rng.random() < 0.5:
            si = int(rng.integers(len(sources)))
            src_off = int(rng.integers(0, max(1, len(sources[si]) - ln + 1)))
            rows.append((0, -1, si, src_off, dst_off, ln))
        else:
            rows.append((1, fd, -1, int(rng.integers(
                0, max(1, file_len - ln + 1))), dst_off, ln))
    if bad:
        k = int(rng.integers(len(rows)))
        kind, f, si, so, do, _ = rows[k]
        rows[k] = (kind, f, si, so, do, 64 * KB)  # overruns both
    return rows


def _table(mod, rows, sources, keep):
    ops = np.zeros(len(rows), dtype=mod.op_dtype())
    for i, (kind, fd, si, so, do, ln) in enumerate(rows):
        addr, n = 0, 0
        if si >= 0:
            addr, n, k = mod._buffer_address(sources[si])
            keep.append(k)
        ops[i] = (kind, fd, addr, so, n, do, ln)
    return ops


@pytest.mark.parametrize("seed", range(6))
def test_exec_plan_matches_jax(jax_lib, tmp_path, seed):
    rng = np.random.default_rng(1000 + seed)
    file_data = rng.integers(0, 256, 32 * KB, dtype=np.uint8).tobytes()
    path = tmp_path / "src.bin"
    path.write_bytes(file_data)
    sources = [rng.integers(0, 256, 8 * KB, dtype=np.uint8).tobytes(),
               bytearray(rng.integers(0, 256, 8 * KB, dtype=np.uint8)),
               rng.integers(0, 256, 8 * KB, dtype=np.uint8)]
    fd = os.open(str(path), os.O_RDONLY)
    try:
        for case in range(10):
            dest_len = int(rng.integers(4 * KB, 16 * KB))
            rows = _op_rows(rng, dest_len, sources, fd, len(file_data),
                            int(rng.integers(1, 40)), bad=case % 3 == 2)
            keep = []
            dp, dj = bytearray(dest_len), bytearray(dest_len)
            rc_port = native.exec_plan(_table(native, rows, sources, keep),
                                       dp)
            rc_jax = jax_native.exec_plan(
                _table(jax_native, rows, sources, keep), dj)
            assert (rc_port, bytes(dp)) == (rc_jax, bytes(dj)), case
            assert (rc_port < 0) == (case % 3 == 2)
    finally:
        os.close(fd)


@pytest.mark.parametrize("seed", range(4))
def test_read_plan_matches_jax(jax_lib, tmp_path, seed):
    """``ReadPlan.execute`` (native) and ``execute_python`` of both
    packages: the same bytes, the same totals, a failure in all four."""
    rng = np.random.default_rng(2000 + seed)
    file_data = rng.integers(0, 256, 16 * KB, dtype=np.uint8).tobytes()
    path = tmp_path / "src.bin"
    path.write_bytes(file_data)
    sources = [rng.integers(0, 256, 6 * KB, dtype=np.uint8).tobytes(),
               rng.integers(0, 256, 6 * KB, dtype=np.uint8)]
    fd = os.open(str(path), os.O_RDONLY)
    try:
        for case in range(8):
            dest_len = int(rng.integers(4 * KB, 12 * KB))
            bad = case == 7
            rows = _op_rows(rng, dest_len, sources, fd, len(file_data),
                            int(rng.integers(1, 30)), bad=bad)
            results = []
            for mod in (fastpath, jax_fastpath):
                plan = mod.ReadPlan()
                for kind, f, si, so, do, ln in rows:
                    if kind == 0:
                        assert plan.add_copy(sources[si], so, ln, do)
                    else:
                        plan.add_pread(f, so, ln, do)
                for run in (plan.execute, plan.execute_python):
                    dest = bytearray(dest_len)
                    try:
                        results.append((run(dest), bytes(dest)))
                    except mod.NativeExecError:
                        results.append("error")
            if bad:
                assert results == ["error"] * 4
            else:
                assert all(r == results[0] for r in results), case
    finally:
        os.close(fd)


def test_copy_into_and_slice_out_match_jax(jax_lib):
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, 96 * KB, dtype=np.uint8).tobytes()
    dp, dj = bytearray(128 * KB), bytearray(128 * KB)
    assert fastpath.copy_into(dp, 5000, src)
    assert jax_fastpath.copy_into(dj, 5000, src)
    assert dp == dj
    bounds = [0, 3, 3, 4000, 128 * KB]
    assert fastpath.slice_out(dp, bounds) == \
        jax_fastpath.slice_out(dj, bounds)


def test_plain_plan_is_counted(plain):
    dest = bytearray(16)
    assert native.exec_plan(fastpath.op_table(1), dest) is None
    assert not fastpath.copy_into(dest, 0, b"abc")
    with pytest.raises(fastpath.NativeExecError):
        fastpath.execute_table(fastpath.op_table(2), dest)
    assert native.plain_calls() == {"prefault": 0, "plan": 2, "scan": 0,
                                    "crc": 0}


# -- build ---------------------------------------------------------------------
def test_library_builds_under_build_dir():
    assert native.loaded()
    so = native._lib_path()
    assert so.parent == native.BUILD_DIR and so.is_file()
    assert not list(native.SRC_DIR.glob("*.so"))


def test_no_compiler_means_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib_path",
                        lambda: tmp_path / "libatpu_native-test.so")
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native.lib() is None
    assert not native.loaded()
    assert not list(tmp_path.iterdir())  # no half-written library left
