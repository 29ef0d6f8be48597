"""The port's device rule.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Without a
GPU that default raises instead of carrying on on the host; the CPU is used
only when the caller asks for it (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device(device)``, raising ``RuntimeError`` for a CUDA device
    when no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA GPU; "
            "pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
