"""Re-identification tower: the CR stage's embedding model.

A compact residual MLP mapping frame feature vectors to embeddings; matching
runs through the hand-written CUDA ``reid_match`` kernel on a GPU (its plain
version on the CPU).  The port's counterpart of ``repro.serving.reid``.

Weight layout is the reference's: every linear weight is ``(d_in, d_out)``
and is applied as ``x @ w``, so :func:`tower_from_jax` copies the JAX
pytree's ``kernel`` arrays as they are, without a transpose.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.kernels.reid_match.ops import reid_match
from repro_torch.models.layers import init_linear, init_norm, linear, rms_norm

__all__ = ["ReidTower", "embed_frames", "init_reid_tower", "match", "tower_from_jax"]

# Products are full f32, as the reference's: never TF32 on the card.
torch.backends.cuda.matmul.allow_tf32 = False


class _Block(nn.Module):
    def __init__(self, d_hidden: int, generator: torch.Generator, device: torch.device):
        super().__init__()
        self.norm = nn.Parameter(init_norm(d_hidden, device=device))
        self.w1 = nn.Parameter(init_linear(d_hidden, d_hidden, generator=generator, device=device))
        self.w2 = nn.Parameter(init_linear(d_hidden, d_hidden, generator=generator, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(self.norm, x)
        h = F.silu(linear(self.w1, h))
        return x + linear(self.w2, h)


class ReidTower(nn.Module):
    """``proj_in`` -> ``depth`` residual (RMS-norm, SiLU MLP) blocks ->
    ``proj_out``; weights ``(d_in, d_out)`` applied as ``x @ w``."""

    def __init__(
        self,
        d_in: int = 128,
        d_hidden: int = 256,
        d_embed: int = 64,
        depth: int = 2,
        *,
        generator: torch.Generator,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.proj_in = nn.Parameter(init_linear(d_in, d_hidden, generator=generator, device=dev))
        self.blocks = nn.ModuleList(_Block(d_hidden, generator, dev) for _ in range(depth))
        self.proj_out = nn.Parameter(init_linear(d_hidden, d_embed, generator=generator, device=dev))

    @property
    def device(self) -> torch.device:
        return self.proj_in.device

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = linear(self.proj_in, frames)
        for blk in self.blocks:
            x = blk(x)
        return linear(self.proj_out, x)


def init_reid_tower(
    generator: torch.Generator,
    d_in: int = 128,
    d_hidden: int = 256,
    d_embed: int = 64,
    depth: int = 2,
    *,
    device: Union[str, torch.device] = "cuda",
) -> ReidTower:
    """A tower with random weights drawn from ``generator`` (a CPU
    generator; weights are moved to ``device`` after drawing)."""
    return ReidTower(d_in, d_hidden, d_embed, depth, generator=generator, device=device)


def tower_from_jax(
    params: Mapping[str, Any], *, device: Union[str, torch.device] = "cuda"
) -> ReidTower:
    """The reference tower's pytree, given as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as a :class:`ReidTower`.  Each
    ``kernel`` is ``(d_in, d_out)`` in both packages and is copied as it is."""
    dev = resolve_device(device)
    d_in, d_hidden = np.shape(params["proj_in"]["kernel"])
    d_embed = np.shape(params["proj_out"]["kernel"])[1]
    depth = len(params["blocks"])
    tower = ReidTower(
        d_in, d_hidden, d_embed, depth, generator=torch.Generator().manual_seed(0), device=dev
    )

    with torch.no_grad():
        tower.proj_in.copy_(_on(dev, params["proj_in"]["kernel"]))
        tower.proj_out.copy_(_on(dev, params["proj_out"]["kernel"]))
        for blk, p in zip(tower.blocks, params["blocks"]):
            blk.norm.copy_(_on(dev, p["norm"]["scale"]))
            blk.w1.copy_(_on(dev, p["w1"]["kernel"]))
            blk.w2.copy_(_on(dev, p["w2"]["kernel"]))
    return tower


def _on(device: torch.device, x) -> torch.Tensor:
    """``x`` (a tensor, or anything numpy reads) as f32 on ``device``; host
    arrays are copied, so read-only buffers are never handed to torch."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def embed_frames(tower: ReidTower, frames) -> torch.Tensor:
    """frames: (N, d_in) array or tensor -> embeddings (N, d_embed) on the
    tower's device."""
    x = _on(tower.device, frames)
    with torch.no_grad():
        return tower(x)


def match(
    tower: ReidTower, frames, queries, threshold: float = 0.5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full CR stage: embed candidate frames, match them against the query
    embeddings through the re-ID kernel."""
    gallery = embed_frames(tower, frames)
    return reid_match(gallery, _on(tower.device, queries), threshold=threshold)
