"""Batching strategies (paper §4.4 + §5.1 baselines).

* :class:`DynamicBatcher` — Anveshak's deadline-driven batcher.  The event at
  the head of the queue joins the current batch ``B_p`` (size ``m``) iff

      t + xi(m+1) <= min(Delta_p, delta_x)

  where ``delta_x = a_x^1 + beta`` is the event deadline and
  ``Delta_p = min(delta_1..delta_m)`` the batch deadline.  Otherwise the
  current batch is submitted and the event seeds a new batch.  Even with an
  empty queue, the batch auto-submits when the local clock reaches
  ``Delta_p - xi(m)``.

* :class:`StaticBatcher` — fixed batch size ``b`` (``b=1`` is streaming).
  There is no bound on the wait for the batch to fill (the paper's §5.2.1
  critique of static batching).

* :class:`NOBBatcher` — the Near-Optimal Baseline (§5.1): a lookup table from
  input rate to the smallest batch size sustaining that rate, built by prior
  benchmarking on the *stable* system; at runtime picks the entry closest to
  the currently observed rate.  Near-optimal under static conditions, brittle
  under variability (the paper's Fig. 7c/9b result).
"""

from __future__ import annotations

import bisect
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional, Sequence, Tuple

from .events import Event

__all__ = ["PendingEvent", "DynamicBatcher", "StaticBatcher", "NOBBatcher", "build_nob_table"]

CostModel = Callable[[int], float]


@dataclass(slots=True)
class PendingEvent:
    """A queued event together with the timestamps the batcher needs."""

    event: Event
    arrival: float        # a_k^i on the local clock
    deadline: float       # delta_k^i = a_k^1 + beta_i (local-effective)


class _BatcherBase:
    def __init__(self, xi: CostModel, m_max: int) -> None:
        self.xi = xi
        self.m_max = int(m_max)
        self._current: List[PendingEvent] = []

    # -- introspection -------------------------------------------------- #
    @property
    def current_size(self) -> int:
        return len(self._current)

    def take(self) -> List[PendingEvent]:
        batch, self._current = self._current, []
        return batch

    def next_due_time(self) -> float:
        return math.inf

    def offer(self, pe: PendingEvent, t_now: float) -> Optional[List[PendingEvent]]:
        raise NotImplementedError

    # Tolerance for the auto-submit comparison: without it, a sub-ulp gap
    # between the due time and the clock can make the timer re-arm with a
    # delay too small to advance float time — an infinite loop (surfaced by
    # the clock-skew property tests).  Submitting <=1us early is harmless.
    _DUE_EPS = 1e-6

    def flush_if_due(self, t_now: float) -> Optional[List[PendingEvent]]:
        if self._current and t_now >= self.next_due_time() - self._DUE_EPS:
            return self.take()
        return None


class DynamicBatcher(_BatcherBase):
    """Anveshak's dynamic deadline-driven batcher (§4.4)."""

    def __init__(self, xi: CostModel, m_max: int = 25) -> None:
        super().__init__(xi, m_max)
        self._batch_deadline = math.inf  # Delta_p

    def take(self) -> List[PendingEvent]:
        batch = super().take()
        self._batch_deadline = math.inf
        return batch

    def next_due_time(self) -> float:
        """Auto-submit time ``Delta_p - xi(m)`` for the current batch."""
        if not self._current:
            return math.inf
        return self._batch_deadline - self.xi(len(self._current))

    def offer(self, pe: PendingEvent, t_now: float) -> Optional[List[PendingEvent]]:
        """Consider the head-of-queue event for the current batch.

        Returns a batch to submit for execution if the event could not join
        (or the batch hit ``m_max``); the event always ends up in a batch
        (possibly the freshly started one).
        """
        m = len(self._current)
        fits = t_now + self.xi(m + 1) <= min(self._batch_deadline, pe.deadline)
        submitted: Optional[List[PendingEvent]] = None
        if m > 0 and not fits:
            submitted = self.take()
        self._current.append(pe)
        self._batch_deadline = min(self._batch_deadline, pe.deadline)
        if len(self._current) >= self.m_max:
            full = self.take()
            if submitted is None:
                submitted = full
            else:  # both: flush the earlier batch first, keep order
                submitted = submitted + full
        return submitted


class StaticBatcher(_BatcherBase):
    """Fixed batch size; ``b=1`` is the streaming configuration (SB-1)."""

    def __init__(self, xi: CostModel, batch_size: int) -> None:
        super().__init__(xi, m_max=batch_size)
        self.batch_size = int(batch_size)

    def offer(self, pe: PendingEvent, t_now: float) -> Optional[List[PendingEvent]]:
        self._current.append(pe)
        if len(self._current) >= self.batch_size:
            return self.take()
        return None


def build_nob_table(
    xi: CostModel,
    m_max: int,
    rates: Sequence[float] = tuple(range(1, 1001, 10)),
) -> List[Tuple[float, int]]:
    """Prior benchmarking for NOB (§5.1): for each input rate ``omega`` the
    smallest batch size whose steady-state service rate ``b / xi(b)`` sustains
    it.  Falls back to ``m_max`` when no size suffices."""
    table: List[Tuple[float, int]] = []
    for omega in rates:
        chosen = m_max
        for b in range(1, m_max + 1):
            if b / max(xi(b), 1e-12) >= omega:
                chosen = b
                break
        table.append((float(omega), chosen))
    return table


class NOBBatcher(_BatcherBase):
    """Near-Optimal Baseline batcher driven by an input-rate lookup table."""

    def __init__(
        self,
        xi: CostModel,
        m_max: int = 25,
        table: Optional[List[Tuple[float, int]]] = None,
        rate_window: int = 32,
    ) -> None:
        super().__init__(xi, m_max)
        self.table = table if table is not None else build_nob_table(xi, m_max)
        self._arrivals: Deque[float] = deque(maxlen=rate_window)
        # The lookup runs once per arrival; for the (usual) strictly
        # increasing rate grid a bisect replaces the O(|table|) scan.  Tie
        # handling matches ``min()``'s first-minimum semantics exactly.
        self._rates: List[float] = [kv[0] for kv in self.table]
        self._batches: List[int] = [kv[1] for kv in self.table]
        self._rates_increasing = all(
            a < b for a, b in zip(self._rates, self._rates[1:])
        )

    def observed_rate(self) -> float:
        if len(self._arrivals) < 2:
            return 1.0
        span = self._arrivals[-1] - self._arrivals[0]
        if span <= 0:
            return float(len(self._arrivals))
        return (len(self._arrivals) - 1) / span

    def target_batch(self) -> int:
        rate = self.observed_rate()
        if not self._rates_increasing:
            best = min(self.table, key=lambda kv: abs(kv[0] - rate))
            return best[1]
        rates = self._rates
        i = bisect.bisect_left(rates, rate)
        if i == 0:
            return self._batches[0]
        if i == len(rates):
            return self._batches[-1]
        # rates[i-1] < rate <= rates[i]; on an exact tie min() keeps the
        # earlier (lower-rate) entry, hence <=.
        if rate - rates[i - 1] <= rates[i] - rate:
            return self._batches[i - 1]
        return self._batches[i]

    def offer(self, pe: PendingEvent, t_now: float) -> Optional[List[PendingEvent]]:
        self._arrivals.append(pe.arrival)
        self._current.append(pe)
        if len(self._current) >= self.target_batch():
            return self.take()
        return None
