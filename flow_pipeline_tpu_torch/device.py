"""Device selection for the port's entry points.

Every entry point takes a device and defaults to ``cuda``. Asking for
``cuda`` where no card is visible raises: the port never carries on on
the CPU behind the caller's back. ``cpu`` runs the plain PyTorch versions
of the kernels (the tests use it).
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """The torch.device for ``device``; raises when it is CUDA and no card
    is available, or when it is neither CUDA nor CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "(-device cpu) to run the plain PyTorch path")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {str(device)!r}")
    return dev
