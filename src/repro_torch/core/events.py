"""Event model for the Anveshak dataflow (paper §2.2, §4.2).

Every event entering a pipeline at the source task ``tau_1`` gets a unique ID
``k``; with 1:1 task selectivity, the pair ``(k, i)`` uniquely identifies the
causal event ``e_k^i`` input to task ``tau_i``.  Events carry a small header
with the *source arrival time* ``a_k^1`` (measured on the source clock) plus
the running sums of upstream execution time (``xi_bar``) and queuing delay
(``q_bar``) used by the budget-update protocol (paper §4.5).

Performance note: headers and events sit on the runtime's per-event hot path
(a 1000-camera scenario creates one header per frame per task hop), so both
carry ``__slots__`` and ``advanced()`` avoids :func:`dataclasses.replace`,
drawing recycled header objects from a small free-list pool instead.  Code
that provably ends an event's life inside the runtime (drop points, sink)
may return its header via :func:`release_header`; everything else can simply
let headers be garbage collected.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, List, Optional

__all__ = [
    "EventHeader",
    "Event",
    "EventRecord",
    "RejectSignal",
    "AcceptSignal",
    "ProbeSignal",
    "new_event_id",
    "release_header",
    "source_header",
]

_id_counter = itertools.count()


def new_event_id() -> int:
    """Globally unique, monotonically increasing source-event ID ``k``."""
    return next(_id_counter)


class EventHeader:
    """Header propagated with every causal downstream event (paper §4.2, §4.5).

    Attributes
    ----------
    event_id:
        The source-event ID ``k``.
    source_arrival:
        ``a_k^1`` — the arrival time of the source event at the source task,
        measured on the *source device clock* kappa_1.  Propagated verbatim.
    xi_bar:
        ``sum_{j=1..i} xi_j(m_k^j)`` — total execution duration spent at the
        preceding tasks (durations; clock-skew free).
    q_bar:
        ``sum_{j=1..i} q_k^j`` — total queuing delay at the preceding tasks.
    avoid_drop:
        The user logic may flag an event (e.g. a positive detection) so the
        platform will not drop it even past its budget (paper §4.3.3).
    is_probe:
        Probe signals are forwarded downstream without drops to recover from
        budget collapse (paper §4.5.2).
    path:
        The task-path this event has traversed (its *pipeline*, §4.2):
        signals are delivered to the tasks on this path, not the whole DAG.
    """

    __slots__ = (
        "event_id",
        "source_arrival",
        "xi_bar",
        "q_bar",
        "avoid_drop",
        "is_probe",
        "path",
    )

    def __init__(
        self,
        event_id: int,
        source_arrival: float,
        xi_bar: float = 0.0,
        q_bar: float = 0.0,
        avoid_drop: bool = False,
        is_probe: bool = False,
        path: tuple = (),
    ) -> None:
        self.event_id = event_id
        self.source_arrival = source_arrival
        self.xi_bar = xi_bar
        self.q_bar = q_bar
        self.avoid_drop = avoid_drop
        self.is_probe = is_probe
        self.path = path

    def __repr__(self) -> str:  # keep the old dataclass ergonomics
        return (
            f"EventHeader(event_id={self.event_id!r}, "
            f"source_arrival={self.source_arrival!r}, xi_bar={self.xi_bar!r}, "
            f"q_bar={self.q_bar!r}, avoid_drop={self.avoid_drop!r}, "
            f"is_probe={self.is_probe!r}, path={self.path!r})"
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, EventHeader):
            return NotImplemented
        return (
            self.event_id == other.event_id
            and self.source_arrival == other.source_arrival
            and self.xi_bar == other.xi_bar
            and self.q_bar == other.q_bar
            and self.avoid_drop == other.avoid_drop
            and self.is_probe == other.is_probe
            and self.path == other.path
        )

    def advanced(self, xi: float, q: float, task: str = "") -> "EventHeader":
        """Header for the causal downstream event after this task."""
        h = _acquire_header()
        h.event_id = self.event_id
        h.source_arrival = self.source_arrival
        h.xi_bar = self.xi_bar + xi
        h.q_bar = self.q_bar + q
        h.avoid_drop = self.avoid_drop
        h.is_probe = self.is_probe
        h.path = self.path + (task,) if task else self.path
        return h

    def advance_in_place(self, xi: float, q: float, task: str = "") -> "EventHeader":
        """In-place variant of :meth:`advanced` for the common 1:1 case where
        the caller holds the only reference (no allocation at all)."""
        self.xi_bar += xi
        self.q_bar += q
        if task:
            self.path = self.path + (task,)
        return self


# Free-list pool for headers: ``advanced()`` is called once per event per task
# hop, which made header construction the single largest allocation site in
# the scenario engine.  The pool is bounded and purely an optimization —
# failing to release a header is always safe.
_HEADER_POOL: List[EventHeader] = []
_HEADER_POOL_MAX = 4096


def _acquire_header() -> EventHeader:
    if _HEADER_POOL:
        return _HEADER_POOL.pop()
    return EventHeader.__new__(EventHeader)


def release_header(header: Optional[EventHeader]) -> None:
    """Return a header to the pool.  Only call when the event is provably
    dead (dropped inside the runtime, or fully consumed at the sink)."""
    if header is not None and len(_HEADER_POOL) < _HEADER_POOL_MAX:
        _HEADER_POOL.append(header)


def source_header(event_id: int, source_arrival: float) -> EventHeader:
    """Pool-backed constructor for a fresh source-event header (the one
    allocation every sourced frame must make)."""
    h = _acquire_header()
    h.event_id = event_id
    h.source_arrival = source_arrival
    h.xi_bar = 0.0
    h.q_bar = 0.0
    h.avoid_drop = False
    h.is_probe = False
    h.path = ()
    return h


class Event:
    """A key-value event on a stream (paper §2.2.1).

    ``key`` is typically the camera ID; ``value`` the frame / detections.
    ``batch_slowest`` is set by the runtime on the slowest event of a batch
    so the sink can generate accept signals (§4.5.2).
    ``query_mask`` is the multi-query tenancy tag (``repro_torch.query``): a bit
    per live tracking query interested in this event at source time.  0 (the
    default everywhere outside a multi-query run) means "untagged"; the
    runtime's 1:1 fast paths reuse the event object, so the tag survives
    value transforms without any per-hop copying.
    """

    __slots__ = ("header", "key", "value", "batch_slowest", "query_mask")

    def __init__(self, header: EventHeader, key: Any, value: Any = None) -> None:
        self.header = header
        self.key = key
        self.value = value
        self.batch_slowest = False
        self.query_mask = 0

    def __repr__(self) -> str:
        return f"Event(header={self.header!r}, key={self.key!r}, value={self.value!r})"

    @property
    def event_id(self) -> int:
        return self.header.event_id


@dataclass(slots=True)
class EventRecord:
    """The 3-tuple ``<d_k^i, q_k^i, m_k^i>`` each task stores per processed
    event (paper §4.5), used when an accept/reject signal arrives later.

    ``departure`` is ``d_k^i = u_k^i + pi_k^i``; ``queuing`` is ``q_k^i``;
    ``batch_size`` is ``m_k^i``; ``xi`` is ``xi_i(m_k^i)`` kept for the
    accept-side proportionality term.
    """

    departure: float
    queuing: float
    batch_size: int
    xi: float


@dataclass(slots=True)
class RejectSignal:
    """Sent upstream when task ``tau_j`` drops event ``k`` (paper §4.5.1)."""

    event_id: int
    epsilon: float  # excess over the dropping task's budget
    q_bar: float  # sum of queuing delays upstream of the dropping task
    from_task: str = ""


@dataclass(slots=True)
class AcceptSignal:
    """Sent upstream when the sink sees the slowest event of a batch arrive
    more than ``epsilon_max`` early (paper §4.5.2)."""

    event_id: int
    epsilon: float  # early-arrival margin under gamma
    xi_bar: float  # sum of upstream execution times (excluding sink)
    from_task: str = ""


@dataclass(slots=True)
class ProbeSignal:
    """Every k-th dropped event is forwarded as a probe that cannot be
    dropped; if it reaches the sink within gamma an accept is generated so
    collapsed budgets can recover (paper §4.5.2)."""

    event_id: int
    source_arrival: float
    xi_bar: float = 0.0
    q_bar: float = 0.0
