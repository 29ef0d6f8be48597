"""Shared layers of the port (the subset of ``repro.models.layers`` that the
re-ID tower uses).

Weights keep the JAX reference's layout: a linear weight is
``(d_in, d_out)`` and is applied as ``x @ w`` (JAX's ``kernel``), so
parameters carry across without a transpose.  Weights are drawn on the CPU
from an explicit ``torch.Generator`` and then moved, so one seed gives the
same tower on every device.  Products stay ``torch.matmul`` (the reference
leaves them to XLA, outside any Pallas kernel).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch._device import resolve_device

__all__ = ["init_linear", "init_norm", "linear", "rms_norm"]


def init_linear(
    d_in: int,
    d_out: int,
    *,
    generator: torch.Generator,
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float32,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``(d_in, d_out)`` weight, standard normal times ``scale`` (default
    ``1/sqrt(d_in)``), as the reference's ``init_linear``."""
    dev = resolve_device(device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32) * scale
    return w.to(device=dev, dtype=dtype)


def init_norm(
    d: int,
    *,
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """RMS-norm scale, all ones."""
    return torch.ones((d,), dtype=dtype, device=resolve_device(device))


def linear(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ weight`` with ``weight`` in the ``(d_in, d_out)`` layout."""
    return x @ weight.to(x.dtype)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale``, computed in f32."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dtype)
