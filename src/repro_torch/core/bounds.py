"""Formal bounds under fixed conditions (paper §4.6.1).

Assumptions: constant input rate ``omega``, 1:1 selectivity, no pipelining,
``xi`` exact, static network/compute, temporally ordered events.

* **Stable batch size** ``m_i``: largest integer such that

      (m - 1) / omega + xi(m) <= beta - u          (fits the deadline)
      xi(m) <= (beta - u) / 2                      (stability: exec <= queue)

* **Max sustainable rate** ``omega_max`` and associated batch size when no
  ``m`` exists for the offered ``omega``; the **drop rate** is
  ``omega - omega_max``.

* **Batching latency overhead** vs streaming:
  ``(m - 1) / (2 omega) + xi(m) - xi(1)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

__all__ = [
    "stable_batch_size",
    "max_sustainable_rate",
    "drop_rate",
    "batching_latency_overhead",
]

CostModel = Callable[[int], float]


def stable_batch_size(
    xi: CostModel,
    omega: float,
    budget_headroom: float,
    m_max: int = 1 << 16,
) -> Optional[int]:
    """Largest stable ``m`` for input rate ``omega`` given
    ``budget_headroom = beta_i - u_1^i``; None if the rate is unsustainable."""
    if omega <= 0 or budget_headroom <= 0:
        return None
    best: Optional[int] = None
    m = 1
    while m <= m_max:
        queue_time = (m - 1) / omega
        fits = queue_time + xi(m) <= budget_headroom and xi(m) <= budget_headroom / 2.0
        # Throughput sustainability: while a batch of m executes for xi(m),
        # omega * xi(m) new events arrive; boundedness needs m >= omega*xi(m).
        # (Strengthens the paper's two inequalities, which admit rates the
        # single-server queue cannot actually sustain.)
        sustainable = m >= omega * xi(m)
        if fits:
            if sustainable:
                best = m
            m += 1
        else:
            # xi is monotone and queue_time grows with m: once the deadline
            # constraint fails it fails for all larger m.
            break
    return best


def max_sustainable_rate(
    xi: CostModel,
    budget_headroom: float,
    m_max: int = 4096,
) -> Tuple[float, int]:
    """Maximize ``omega_max`` (and report the batch size achieving it) such
    that a stable ``m`` exists (§4.6.1 Drop Rate).

    For a fixed ``m`` satisfying the stability constraint, the rate constraint
    gives ``omega >= (m - 1) / (headroom - xi(m))``; the largest sustainable
    rate for that ``m`` is the *service* rate ``m / max(xi(m), queue window)``.
    We search m in [1, m_max] for the best steady-state throughput whose
    queueing fits the headroom.
    """
    best_rate, best_m = 0.0, 1
    if budget_headroom <= 0:
        return best_rate, best_m
    for m in range(1, m_max + 1):
        ex = xi(m)
        if ex > budget_headroom / 2.0:
            break
        window = budget_headroom - ex  # time available to queue m events
        if window <= 0:
            continue
        # (m-1)/omega <= window  =>  omega can be as high as service allows;
        # steady state requires omega <= m / xi(m) (service rate) and
        # omega >= (m-1)/window is satisfiable for any omega above it.
        rate = min(m / max(ex, 1e-12), (m - 1) / window if m > 1 else math.inf)
        rate = m / max(ex, 1e-12) if m > 1 else 1.0 / max(ex, 1e-12)
        # The batch must be accumulable within the window:
        if m > 1 and (m - 1) / rate > window:
            rate = (m - 1) / window
        if rate > best_rate:
            best_rate, best_m = rate, m
    return best_rate, best_m


def drop_rate(
    xi: CostModel,
    omega: float,
    budget_headroom: float,
    m_max: int = 4096,
) -> Tuple[float, float, int]:
    """Returns ``(drops_per_sec, omega_max, m)`` for an offered rate ``omega``
    (0 drops if the rate is sustainable)."""
    if stable_batch_size(xi, omega, budget_headroom, m_max) is not None:
        m = stable_batch_size(xi, omega, budget_headroom, m_max)
        return 0.0, omega, int(m)
    omega_max, m = max_sustainable_rate(xi, budget_headroom, m_max)
    return max(omega - omega_max, 0.0), omega_max, m


def batching_latency_overhead(xi: CostModel, omega: float, m: int) -> float:
    """Average per-event latency added by batching vs streaming (§4.6.1)."""
    if omega <= 0:
        return 0.0
    return (m - 1) / (2.0 * omega) + xi(m) - xi(1)
