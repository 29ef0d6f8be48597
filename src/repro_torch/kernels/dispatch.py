"""Bucket-accounted kernel dispatch (the scenario's analytics plane).

The port's counterpart of ``repro.kernels.dispatch``, cut to the re-ID
matcher.  The reference pads every batch dimension to a power-of-two
bucket so each jit specialization compiles once per bucket.  PyTorch runs
eagerly and the CUDA kernel takes any ``N``, so the gallery is not padded
here; :func:`bucket` and the :func:`stats` counters are kept exactly as the
reference keeps them, so both packages count the same calls, cache hits
and bucket shapes for the same run.

Two parts of the reference's contract remain:

* **first ``N`` rows, masked pad queries** — the query block is padded to
  its bucket and the kernel is told how many rows are real (``nq``), so pad
  rows never win the per-row maximum;
* **device-resident query blocks** — a long-lived host query array (the
  tracked entity's embedding) is padded and uploaded once per device and
  cached by host-array identity, weakly referenced so a dropped array
  frees its buffer.

The reference's ``dispatch.reid_match`` is plain jnp; the port's goes
through the hand-written CUDA kernel on a GPU (its plain version on the CPU).
"""

from __future__ import annotations

import weakref
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.clock import monotonic as _monotonic

from .reid_match.ops import reid_match as _reid_match_op

__all__ = ["BUCKET_MIN", "bucket", "profile", "reid_match", "reset_stats", "stats"]

BUCKET_MIN = 8

_STATS = {
    "reid_calls": 0,
    "reid_multi_calls": 0,
    "ball_calls": 0,
    "device_cache_hits": 0,
    "device_cache_misses": 0,
    "bucket_shapes": 0,
}
_SHAPES: set = set()

# Per-kernel distinct bucket shapes (the reference's per-shape compile
# count) and accumulated host wall inside the dispatch entry points;
# attribution only, never read by any scheduling decision.
_COMPILES: Dict[str, int] = {}
_DISPATCH_WALL: Dict[str, float] = {}


def bucket(n: int, minimum: int = BUCKET_MIN) -> int:
    """Smallest power-of-two >= ``n`` (and >= ``minimum``)."""
    if n < 1:
        raise ValueError(f"bucket size needs n >= 1, got {n}")
    return max(1 << (int(n) - 1).bit_length(), minimum)


def stats() -> Dict[str, int]:
    return dict(_STATS)


def reset_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0
    _SHAPES.clear()
    _COMPILES.clear()
    _DISPATCH_WALL.clear()


def profile() -> Dict[str, Dict[str, float]]:
    """Per-kernel distinct bucket-shape counts and the accumulated host
    wall spent inside the dispatch entry points."""
    return {
        "compiles": dict(_COMPILES),
        "dispatch_wall_s": dict(_DISPATCH_WALL),
    }


def _note_shape(key: Tuple) -> None:
    if key not in _SHAPES:
        _SHAPES.add(key)
        _STATS["bucket_shapes"] += 1
        name = str(key[0])
        _COMPILES[name] = _COMPILES.get(name, 0) + 1


def _note_wall(name: str, t0: float) -> None:
    _DISPATCH_WALL[name] = _DISPATCH_WALL.get(name, 0.0) + (_monotonic() - t0)


# --------------------------------------------------------------------- #
# Device-resident operand cache (weak, keyed by host-array identity)      #
# --------------------------------------------------------------------- #
# (id(array), device) -> (weakref to the host array, device tensor).  The
# weakref callback evicts the entry when the host array dies, which also
# guards against id() reuse.
_DEVICE_CACHE: Dict[Tuple[int, str], Tuple[weakref.ref, torch.Tensor]] = {}


def _device_resident(arr: np.ndarray, device: torch.device, transform=None) -> torch.Tensor:
    """``transform(arr)`` uploaded to ``device``, memoized on the identity
    of ``arr`` (``transform`` runs only on a miss)."""
    key = (id(arr), str(device))
    entry = _DEVICE_CACHE.get(key)
    if entry is not None and entry[0]() is arr:
        _STATS["device_cache_hits"] += 1
        return entry[1]
    _STATS["device_cache_misses"] += 1
    host = transform(arr) if transform is not None else arr
    dev = torch.from_numpy(np.ascontiguousarray(host)).to(device)

    def _evict(_ref, key=key):
        _DEVICE_CACHE.pop(key, None)

    _DEVICE_CACHE[key] = (weakref.ref(arr, _evict), dev)
    return dev


# --------------------------------------------------------------------- #
# Re-id matching                                                         #
# --------------------------------------------------------------------- #
def reid_match(
    gallery,
    queries,
    *,
    threshold: float = 0.5,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(scores, best_query, is_match)`` for the ``N`` gallery rows, as
    tensors on ``device``.

    The query block is padded to a power-of-two bucket and the kernel is
    given the number of real rows, so pad queries never win.  A host numpy
    query block is uploaded once per device and kept resident, keyed on its
    identity.  On a GPU the matcher is the CUDA kernel; on the CPU its
    plain version.
    """
    dev = resolve_device(device)
    _STATS["reid_calls"] += 1
    gallery = np.asarray(gallery, dtype=np.float32)
    if gallery.ndim != 2:
        raise ValueError(f"gallery must be (N, D), got {gallery.shape}")
    N, D = gallery.shape
    nb = bucket(N)

    queries_np = np.asarray(queries, dtype=np.float32)
    if queries_np.ndim != 2 or queries_np.shape[1] != D:
        raise ValueError(f"queries must be (Q, {D}), got {queries_np.shape}")
    Q = queries_np.shape[0]
    qb = bucket(Q)

    def _pad_queries(_q):
        q_pad = np.zeros((qb, D), dtype=np.float32)
        q_pad[:Q] = queries_np
        return q_pad

    if isinstance(queries, np.ndarray):
        q_dev = _device_resident(queries, dev, transform=_pad_queries)
    else:
        q_dev = torch.from_numpy(_pad_queries(queries_np)).to(dev)

    key = ("reid", nb, qb, D)
    _note_shape(key)
    t0 = _monotonic()
    g_dev = torch.from_numpy(np.ascontiguousarray(gallery)).to(dev)
    out = _reid_match_op(g_dev, q_dev, nq=Q, threshold=threshold)
    _note_wall("reid", t0)
    return out
