"""``scaled_sum``: the warm-tier scan over device-resident blocks.

The port of ``alluxio_tpu/ops/reduce_kernel.py``: read every cached byte
once, multiply by a scalar, reduce to an int32 with int32 wraparound. On
a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/reduce_kernel.cu`` (built with ``nvcc`` for ``sm_90a`` at first
use, see ``_build.py``); a build or launch failure raises. On a CPU
tensor it computes :func:`scaled_sum_reference`, the plain PyTorch
version of the same function. There is no other path.

The kernel is bound by device memory: it reads ``4 * n`` bytes and does
two integer operations per element. See the note in the CUDA source for
what its design does about that.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_LANES = 1024  # the JAX kernel's (rows, 1024) view of the flat input
_ROWS = 512
#: block heights the JAX kernel is calibrated over; every one gives the
#: same value, so the port keeps them for the size contract
CALIBRATION_ROWS = (512, 1024, 2048, 4096)

#: blocks per SM for the grid-stride launch: 8 x 256 threads fills an
#: H100 SM's 2048 thread slots
_BLOCKS_PER_SM = 8
#: elements per chunk of the plain version (bounds its int64 temporaries)
_REF_CHUNK = 1 << 24

#: kernel launches made by :func:`scaled_sum` (only where the kernel was
#: launched; the CPU path does not count)
launches = 0


def _check_size(x: torch.Tensor, rows: int) -> None:
    if x.numel() % (rows * _LANES):
        raise ValueError(
            f"input size {x.numel()} is not a multiple of "
            f"{rows * _LANES}; pad with pad_to_kernel_shape() — "
            f"flooring would silently drop the tail from the reduction")


def _as_scale(scale, device: torch.device) -> torch.Tensor:
    """``scale`` as a one-element int32 tensor on ``device``."""
    if not isinstance(scale, torch.Tensor):
        return torch.tensor([int(scale)], dtype=torch.int32, device=device)
    if scale.numel() != 1:
        raise ValueError(f"scale must hold one value, got {scale.numel()}")
    if scale.device != device:
        raise ValueError(f"scale on {scale.device}, x on {device}")
    return scale.reshape(1).to(torch.int32).contiguous()


def scaled_sum_reference(x: torch.Tensor, scale) -> torch.Tensor:
    """Plain PyTorch ``sum(x * scale)`` with int32 wraparound, as a 0-d
    int32 tensor on ``x``'s device.

    Each product is reduced mod 2^32 in int64, summed chunk by chunk (so
    no int64 copy of all of ``x`` is made and no int64 sum can
    overflow), and the total is reinterpreted as int32."""
    s = _as_scale(scale, x.device).to(torch.int64).reshape(())
    flat = x.reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for start in range(0, flat.numel(), _REF_CHUNK):
        part = flat[start:start + _REF_CHUNK].to(torch.int64)
        part.mul_(s).bitwise_and_(0xFFFFFFFF)
        total = (total + part.sum()).bitwise_and_(0xFFFFFFFF)
    return ((total + (1 << 31)).bitwise_and_(0xFFFFFFFF)
            - (1 << 31)).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _library():
    from alluxio_tpu_torch.ops import _build

    lib = _build.library("reduce_kernel")
    fn = lib.atpu_scaled_sum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def scaled_sum(x: torch.Tensor, scale, *, rows: int = _ROWS) -> torch.Tensor:
    """``sum(x * scale)`` for int32 ``x`` whose size is a multiple of
    ``rows * 1024`` (use :func:`pad_to_kernel_shape` otherwise — zeros
    are reduction-neutral), with int32 wraparound. ``scale`` is a
    one-element int32 tensor on ``x``'s device (or a Python int); the
    kernel reads it from device memory, so a scale computed on the
    device costs no host sync. Returns a 0-d int32 tensor."""
    global launches

    if x.dtype != torch.int32:
        raise TypeError(f"scaled_sum takes int32, got {x.dtype}")
    _check_size(x, rows)
    s = _as_scale(scale, x.device)
    if x.device.type == "cpu":
        return scaled_sum_reference(x, s)
    if x.device.type != "cuda":
        raise ValueError(f"scaled_sum runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("scaled_sum needs a contiguous input")
    fn = _library()
    out = torch.zeros(1, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), x.numel(), s.data_ptr(), out.data_ptr(),
                 sms * _BLOCKS_PER_SM, stream)
    if err != 0:
        raise RuntimeError(f"scaled_sum kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out.reshape(())


def pad_to_kernel_shape(arr: torch.Tensor, *, rows: int = _ROWS
                        ) -> torch.Tensor:
    """Zero-pad a flat int32 tensor up to the kernel's block multiple and
    view it as ``(-1, 1024)``."""
    block = rows * _LANES
    flat = arr.reshape(-1)
    rem = (-flat.numel()) % block
    if rem:
        flat = torch.cat([flat, flat.new_zeros(rem)])
    return flat.reshape(-1, _LANES)
