"""The port's ``scaled_sum`` against the JAX Pallas kernel.

On the CPU the port's wrapper computes its plain version; the JAX kernel
runs in interpret mode. Both wrap in int32, so every comparison is exact
(tolerance 0). The kernel itself is held against the plain version on
the card by ``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from alluxio_tpu.ops import reduce_kernel as jax_rk  # noqa: E402
from alluxio_tpu_torch.ops import reduce_kernel as rk  # noqa: E402

_LANES, _ROWS = rk._LANES, rk._ROWS


def _both(x_np, scale, rows=_ROWS):
    want = int(jax_rk.scaled_sum(jnp.asarray(x_np), jnp.int32(scale),
                                 rows=rows, interpret=True))
    got = int(rk.scaled_sum(torch.from_numpy(x_np), scale, rows=rows))
    return got, want


class TestScaledSum:
    def test_matches_jax_kernel(self):
        rng = np.random.default_rng(7)
        x = rng.integers(-1000, 1000, size=_ROWS * _LANES * 3,
                         dtype=np.int32)
        for scale in (1, 3, -2):
            got, want = _both(x, scale)
            assert got == want

    def test_int32_wraparound_semantics(self):
        x = np.full((_ROWS * _LANES,), 2**30, dtype=np.int32)
        got, want = _both(x, 3)
        assert got == want

    def test_padding_is_reduction_neutral(self):
        rng = np.random.default_rng(11)
        y = rng.integers(-5, 5, size=123457, dtype=np.int32)
        p = rk.pad_to_kernel_shape(torch.from_numpy(y))
        jp = jax_rk.pad_to_kernel_shape(jnp.asarray(y))
        assert p.shape == jp.shape
        assert p.numel() % (_ROWS * _LANES) == 0
        got = int(rk.scaled_sum(p, 3))
        want = int(jax_rk.scaled_sum(jp, jnp.int32(3), interpret=True))
        assert got == want

    def test_exact_block_needs_no_padding(self):
        y = torch.ones((_ROWS * _LANES,), dtype=torch.int32)
        p = rk.pad_to_kernel_shape(y)
        assert p.numel() == y.numel()

    @pytest.mark.parametrize("rows", rk.CALIBRATION_ROWS)
    def test_block_height_variants_agree(self, rows):
        rng = np.random.default_rng(rows)
        y = rng.integers(-1000, 1000, size=rows * _LANES + 777,
                         dtype=np.int32)
        p = rk.pad_to_kernel_shape(torch.from_numpy(y), rows=rows)
        got = int(rk.scaled_sum(p, 2, rows=rows))
        jp = jax_rk.pad_to_kernel_shape(jnp.asarray(y), rows=rows)
        want = int(jax_rk.scaled_sum(jp, jnp.int32(2), rows=rows,
                                     interpret=True))
        assert got == want

    def test_non_multiple_raises(self):
        y = torch.ones((_ROWS * _LANES + 1,), dtype=torch.int32)
        with pytest.raises(ValueError):
            rk.scaled_sum(y, 1)


class TestPortContract:
    def test_reference_chunks_agree_with_numpy(self, monkeypatch):
        # full-range int32 over several reference chunks: exact against
        # numpy's wrapping int32 arithmetic
        monkeypatch.setattr(rk, "_REF_CHUNK", 1000)
        rng = np.random.default_rng(3)
        x = rng.integers(-2**31, 2**31 - 1, size=5555, dtype=np.int32)
        want = int(np.sum(x * np.int32(-7), dtype=np.int32))
        got = rk.scaled_sum_reference(torch.from_numpy(x), -7)
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == want

    def test_cpu_path_launches_no_kernel(self):
        before = rk.launches
        rk.scaled_sum(torch.ones(_ROWS * _LANES, dtype=torch.int32), 1)
        assert rk.launches == before

    def test_rejects_wrong_dtype_and_scale(self):
        with pytest.raises(TypeError):
            rk.scaled_sum(torch.ones(_ROWS * _LANES), 1)
        x = torch.ones(_ROWS * _LANES, dtype=torch.int32)
        with pytest.raises(ValueError):
            rk.scaled_sum(x, torch.ones(2, dtype=torch.int32))

    def test_scale_tensor_matches_int_scale(self):
        x = torch.arange(_ROWS * _LANES, dtype=torch.int32)
        s = torch.tensor(5, dtype=torch.int32)
        assert int(rk.scaled_sum(x, s)) == int(rk.scaled_sum(x, 5))

    def test_build_without_nvcc_raises(self):
        from alluxio_tpu_torch.ops import _build

        if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
            pytest.skip("nvcc is present: the build would succeed here")
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build(["reduce_kernel"])

