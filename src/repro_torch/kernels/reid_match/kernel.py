"""ctypes binding of the CUDA re-ID matcher (``csrc/reid_match.cu``).

Replaces the TPU kernel ``reid_match_pallas``
(``src/repro/kernels/reid_match/kernel.py``).  The library is built from
the package's source with ``nvcc`` at first launch (:mod:`.._build`); a
failed build or launch raises.  :data:`LAUNCHES` counts launches of the
kernel and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .ref import normalize_rows

__all__ = ["LAUNCHES", "MAX_SMEM_BYTES", "launch", "reid_match_cuda"]

#: Number of times :func:`reid_match_cuda` launched the kernel.
LAUNCHES = 0

#: Shared memory a Hopper block may use (227 KB); the kernel stages 8 rows.
MAX_SMEM_BYTES = 232_448

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from .. import _build

        lib = ctypes.CDLL(_build.build("reid_match"))
        lib.reid_match_launch.argtypes = [
            ctypes.c_void_p,  # gallery
            ctypes.c_void_p,  # queries
            ctypes.c_int,  # n
            ctypes.c_int,  # d
            ctypes.c_int,  # nq
            ctypes.c_float,  # threshold
            ctypes.c_void_p,  # scores
            ctypes.c_void_p,  # best
            ctypes.c_void_p,  # match
            ctypes.c_void_p,  # stream
        ]
        lib.reid_match_launch.restype = ctypes.c_int
        lib.reid_match_smem_bytes.argtypes = [ctypes.c_int]
        lib.reid_match_smem_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def reid_match_cuda(
    gallery: torch.Tensor,  # (N, D) f32, contiguous, on a CUDA device
    queries: torch.Tensor,  # (Q, D) f32, contiguous, same device
    *,
    nq: Optional[int] = None,
    threshold: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``(scores f32, best_query i32, is_match bool)``,
    each ``(N,)``, over the first ``nq`` (default ``Q``) query rows."""
    global LAUNCHES
    for name, t in (("gallery", gallery), ("queries", queries)):
        if not t.is_cuda:
            raise ValueError(f"reid_match_cuda needs CUDA tensors; {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.device != gallery.device:
        raise ValueError(f"queries on {queries.device}, gallery on {gallery.device}")
    N, D = gallery.shape
    Q = queries.shape[0]
    if queries.shape[1] != D:
        raise ValueError(f"queries must be (Q, {D}), got {tuple(queries.shape)}")
    nq = Q if nq is None else int(nq)
    if not 0 <= nq <= Q:
        raise ValueError(f"nq must lie in [0, {Q}], got {nq}")
    if D < 1 or N >= 2**31 or Q * D >= 2**31:
        raise ValueError(f"unsupported shape gallery {tuple(gallery.shape)}, queries {tuple(queries.shape)}")
    if _lib().reid_match_smem_bytes(D) > MAX_SMEM_BYTES:
        raise ValueError(f"row width D={D} exceeds the kernel's shared-memory staging")
    dev = gallery.device
    scores = torch.empty((N,), dtype=torch.float32, device=dev)
    best = torch.empty((N,), dtype=torch.int32, device=dev)
    match = torch.empty((N,), dtype=torch.bool, device=dev)
    if N == 0:
        return scores, best, match
    # Queries are normalised once per call, outside the kernel, as the TPU
    # kernel's wrapper hoists them out of its grid.
    launch(gallery, normalize_rows(queries).contiguous(), nq, threshold, scores, best, match)
    LAUNCHES += 1
    return scores, best, match


def launch(
    gallery: torch.Tensor,
    queries_normalized: torch.Tensor,
    nq: int,
    threshold: float,
    scores: torch.Tensor,
    best: torch.Tensor,
    match: torch.Tensor,
) -> None:
    """The bare launch on the current stream, into preallocated outputs,
    with no checks and no count; :func:`reid_match_cuda` is the entry point
    (timing loops call this to measure the kernel alone)."""
    dev = gallery.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().reid_match_launch(
            gallery.data_ptr(), queries_normalized.data_ptr(),
            gallery.shape[0], gallery.shape[1], int(nq), float(threshold),
            scores.data_ptr(), best.data_ptr(), match.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"reid_match kernel launch failed with CUDA error {err}")
