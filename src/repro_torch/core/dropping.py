"""The three drop points (paper §4.3).

An event ``e_k^i`` is *stale* at task ``tau_i`` once ``u_k^i + pi_k^i``
exceeds the completion budget ``beta_i``.  Since the processing duration
``pi = q + xi(b)`` is only fully known after execution, the staleness test is
applied three times with progressively better information:

1. **Before queuing** — optimistic: assumes zero queuing and streaming
   execution ``xi(1)``.  Drops only events that cannot possibly make it.
2. **Before execution** — the batch is formed: queuing time ``q`` and batch
   execution estimate ``xi(b)`` are known.
3. **Before transmit** — the actual processing time ``pi`` has been spent;
   also the point where the partitioner has fixed the *destination* task, so
   the per-downstream budget (§4.3.4) applies.

Events flagged ``avoid_drop`` (positive detections) and probes always pass.
All comparisons use the upstream time ``u = a_i - a_1`` and are clock-skew
resilient (§4.6.2): a device skew ``sigma_i`` enters both sides and cancels.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

from .events import Event

__all__ = [
    "drop_before_queuing",
    "drop_before_exec",
    "drop_before_transmit",
]


def drop_before_queuing(
    source_arrival: float,
    arrival: float,
    xi1: float,
    beta: float,
    *,
    avoid_drop: bool = False,
) -> bool:
    """Drop point 1 (§4.3.1).  True => drop.

    Parameters mirror the paper: ``u = arrival - source_arrival`` and the
    event is dropped iff ``u + xi_i(1) > beta_i``.
    """
    if avoid_drop:
        return False
    u = arrival - source_arrival
    return u + xi1 > beta


def drop_before_exec(
    batch: Sequence[Tuple[float, float, float, Event]],
    xi_b: float,
    beta: float,
) -> Tuple[List[Event], List[Event]]:
    """Drop point 2 (§4.3.2), applied to a formed batch.

    ``batch`` holds ``(a_k^1, a_k^i, q_k^i, event)`` tuples; ``xi_b`` is the
    execution estimate for the *current* batch size.  Returns
    ``(retained, dropped)``.  Note the paper keeps ``xi_i(b)`` for the full
    batch even while filtering — the drop decision is per-event but the batch
    estimate is not re-shrunk mid-test (conservative).
    """
    retained: List[Event] = []
    dropped: List[Event] = []
    for a1, ai, q, ev in batch:
        if ev.header.avoid_drop or ev.header.is_probe:
            retained.append(ev)
            continue
        u = ai - a1
        if u + q + xi_b <= beta:
            retained.append(ev)
        else:
            dropped.append(ev)
    return retained, dropped


def drop_before_transmit(
    source_arrival: float,
    arrival: float,
    pi: float,
    beta: float,
    *,
    avoid_drop: bool = False,
) -> bool:
    """Drop point 3 (§4.3.3).  True => drop.

    ``pi = q + xi(b)`` is the realized processing duration; ``beta`` is the
    budget *for the destination chosen by the partitioner* (§4.3.4).
    """
    if avoid_drop:
        return False
    u = arrival - source_arrival
    return u + pi > beta
