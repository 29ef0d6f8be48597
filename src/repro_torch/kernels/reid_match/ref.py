"""Plain PyTorch version of the re-ID matcher.

Same function as the CUDA kernel (:mod:`.kernel`) and as the JAX
reference's ``reid_match_ref``: L2-normalise gallery and query rows with
``max(||x||, 1e-6)``, take ``sim = g @ q.T`` in f32, and return per gallery
row the best score, the first query index attaining it, and
``score >= threshold``.  Only the first ``nq`` query rows take part; the
rest are padding and can never win.  The tests hold this against the JAX
reference, and the kernel is held against this on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["normalize_rows", "reid_match_ref"]


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (f32) divided by ``max(||row||, 1e-6)``."""
    x = x.to(torch.float32)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-6)


def reid_match_ref(
    gallery: torch.Tensor,  # (N, D)
    queries: torch.Tensor,  # (Q, D)
    *,
    threshold: float = 0.5,
    nq: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(scores f32 (N,), best_query i32 (N,), is_match bool (N,))``."""
    Q = queries.shape[0]
    nq = Q if nq is None else int(nq)
    N = gallery.shape[0]
    if nq == 0:
        scores = torch.full((N,), -torch.inf, dtype=torch.float32, device=gallery.device)
        best = torch.zeros((N,), dtype=torch.int32, device=gallery.device)
        return scores, best, scores >= threshold
    g = normalize_rows(gallery)
    q = normalize_rows(queries[:nq])
    sim = g @ q.T  # (N, nq)
    scores, best = torch.max(sim, dim=-1)
    return scores, best.to(torch.int32), scores >= threshold
