"""Device resolution shared by the port's entry points.

``None`` means the card: the port's entry points run on ``cuda`` unless
the caller asks for the CPU. With no card present and none asked for,
they raise instead of carrying on silently on the CPU.
"""

from __future__ import annotations


def resolve_device(device=None):
    """``torch.device`` for ``device``; ``None`` -> the current CUDA device.

    Raises ``RuntimeError`` when ``device`` is None and no CUDA device is
    available (pass ``device="cpu"`` to run on the CPU on purpose)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default — pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
