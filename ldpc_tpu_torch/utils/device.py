"""Device selection for the port.

Every entry point takes ``device=``.  Left as ``None`` it means the card:
``default_device()`` returns ``cuda`` and raises when there is none, so a run
that meant to measure the GPU never carries on quietly on the CPU.  The tests
pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device", "device_info"]


def default_device() -> torch.device:
    """The CUDA device; raises ``RuntimeError`` without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``default_device()``."""
    return default_device() if device is None else torch.device(device)


def device_info() -> dict:
    """Name, compute capability and count of the visible CUDA devices."""
    dev = default_device()
    major, minor = torch.cuda.get_device_capability(dev)
    return {"name": torch.cuda.get_device_name(dev),
            "capability": f"sm_{major}{minor}",
            "count": torch.cuda.device_count()}
