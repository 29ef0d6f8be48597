"""Entry point of the re-ID matcher.

A CUDA tensor goes to the hand-written kernel (:mod:`.kernel`), which
launches or raises; a CPU tensor goes to the plain version (:mod:`.ref`).
There is no other route and no switch between them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel
from .ref import reid_match_ref

__all__ = ["reid_match"]


def reid_match(
    gallery: torch.Tensor,  # (N, D)
    queries: torch.Tensor,  # (Q, D)
    *,
    threshold: float = 0.5,
    nq: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(scores, best_query, is_match)`` per gallery row over the first
    ``nq`` (default all) query rows; outputs stay on the inputs' device."""
    if gallery.is_cuda:
        return kernel.reid_match_cuda(
            gallery.to(torch.float32).contiguous(),
            queries.to(torch.float32).contiguous(),
            nq=nq,
            threshold=threshold,
        )
    if gallery.device.type != "cpu" or queries.device.type != "cpu":
        raise ValueError(
            f"gallery on {gallery.device}, queries on {queries.device}: "
            "both must be on one CUDA device or both on the CPU"
        )
    return reid_match_ref(gallery, queries, threshold=threshold, nq=nq)
