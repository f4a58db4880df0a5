"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`None` means the card: `cuda`, or an error when CUDA is absent.

    The port never falls back to the CPU by itself; a caller that wants the
    CPU (the tests) passes `device="cpu"`.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gamer_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def to_device(value, device) -> torch.Tensor:
    """A tensor moved to `device` (itself when it is there: a staged batch's
    buffers are never copied), anything else made a tensor there."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(value, device=device)
