"""Completion-budget maintenance (paper §4.5).

The completion budget ``beta_i`` of task ``tau_i`` is the duration allowed for
an arriving event to finish processing at this task, *including* its upstream
time since the source.  It is the single quantity that drives both the drop
points (§4.3) and the dynamic batcher (§4.4).

Updates
-------
* **Reject** (§4.5.1): event ``e_k`` dropped at ``tau_j`` with excess
  ``epsilon = d_k^j - beta_j``.  Every upstream task ``tau_i`` reduces:

      lam = min(epsilon * q_k^i / qbar_k^j,   xi_i(m_k^i) - xi_i(1))
      beta_i = min(d_k^i - lam, beta_i_old)

* **Accept** (§4.5.2): the slowest event of a batch reaches the sink
  ``epsilon = gamma - u_k^n`` early, with ``epsilon > epsilon_max``.  Every
  upstream task increases:

      lam = min(epsilon * xi_i(m_k^i) / xibar_k^{n-1},
                (m_max - m_k^i) * q_k^i / m_k^i + xi_i(m_max) - xi_i(m_k^i))
      beta_i = max(d_k^i + lam, beta_i_old)

* **Bootstrap**: no budget assigned (=> no drops, batch size 1) until the
  first signal, which sets the budget directly, ignoring ``beta_old``.

* **Probes**: for every ``probe_every``-th dropped event a probe is forwarded
  downstream un-droppably; reaching the sink within gamma triggers an accept
  so collapsed budgets recover.

The min/max against ``beta_old`` makes updates resilient to out-of-order
signals; using durations (not absolute times) plus the ``kappa_1 == kappa_n``
requirement makes them resilient to clock skew (§4.6.2).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from .events import AcceptSignal, EventRecord, RejectSignal

__all__ = ["BudgetState", "TaskBudget"]

# Cost model type: xi(b) -> expected execution duration for a batch of size b.
CostModel = Callable[[int], float]


@dataclass
class BudgetState:
    """Budget for one (task, downstream) pair (§4.3.4: one per downstream)."""

    value: Optional[float] = None  # None => unassigned (bootstrap: no drops)
    initialized: bool = False

    @property
    def effective(self) -> float:
        return math.inf if self.value is None else self.value


class TaskBudget:
    """Per-task budget bookkeeping: event records + signal handling.

    Parameters
    ----------
    xi:
        The task's batch cost model ``xi_i(b)``.
    m_max:
        The user-configured maximum batch size ``m^max``.
    record_capacity:
        Bounded LRU of per-event 3-tuples ``<d, q, m>`` (paper §4.5); old
        records are evicted — a late signal for an evicted event is ignored,
        which is safe because updates are clamped against ``beta_old``.
    """

    def __init__(
        self,
        name: str,
        xi: CostModel,
        m_max: int = 25,
        record_capacity: int = 4096,
    ) -> None:
        self.name = name
        self.xi = xi
        self.m_max = int(m_max)
        self._records: "OrderedDict[int, EventRecord]" = OrderedDict()
        self._capacity = int(record_capacity)
        self._budgets: Dict[str, BudgetState] = {}
        # Cached min over per-downstream budgets: ``min_budget`` is consulted
        # once per arriving event, so recomputing the min there is hot.
        self._min_cache: Optional[float] = None

    # ------------------------------------------------------------------ #
    # Records                                                            #
    # ------------------------------------------------------------------ #
    def record(self, event_id: int, rec: EventRecord) -> None:
        records = self._records
        if event_id in records:
            records.move_to_end(event_id)
        records[event_id] = rec
        if len(records) > self._capacity:
            records.popitem(last=False)

    def get_record(self, event_id: int) -> Optional[EventRecord]:
        return self._records.get(event_id)

    # ------------------------------------------------------------------ #
    # Budget access                                                      #
    # ------------------------------------------------------------------ #
    def state(self, downstream: str = "") -> BudgetState:
        if downstream not in self._budgets:
            self._budgets[downstream] = BudgetState()
        return self._budgets[downstream]

    def budget(self, downstream: str = "") -> float:
        """Effective budget (inf while unassigned — bootstrap semantics)."""
        return self.state(downstream).effective

    def min_budget(self) -> float:
        """Most conservative budget across downstream paths (used at drop
        points before the destination of an event is known)."""
        cached = self._min_cache
        if cached is not None:
            return cached
        if not self._budgets:
            value = math.inf
        else:
            value = min(s.effective for s in self._budgets.values())
        self._min_cache = value
        return value

    def set_budget(self, value: float, downstream: str = "") -> None:
        st = self.state(downstream)
        st.value = value
        st.initialized = True
        self._min_cache = None

    # ------------------------------------------------------------------ #
    # Signal handling (paper §4.5)                                       #
    # ------------------------------------------------------------------ #
    def on_reject(self, sig: RejectSignal, downstream: str = "") -> Optional[float]:
        """Reduce the budget toward ``downstream`` after a drop there.

        Returns the new budget, or None if the event record is unknown.
        """
        rec = self.get_record(sig.event_id)
        if rec is None:
            return None
        if sig.q_bar <= 0.0:
            # No queuing upstream => nothing attributable to this task.
            lam = 0.0
        else:
            lam = min(
                sig.epsilon * (rec.queuing / sig.q_bar),
                max(self.xi(rec.batch_size) - self.xi(1), 0.0),
            )
        st = self.state(downstream)
        candidate = rec.departure - lam
        if not st.initialized:
            st.value = candidate  # bootstrap: ignore beta_old
        else:
            st.value = min(candidate, st.effective)
        st.initialized = True
        self._min_cache = None
        return st.value

    def on_accept(self, sig: AcceptSignal, downstream: str = "") -> Optional[float]:
        """Increase the budget toward ``downstream`` after an early arrival."""
        rec = self.get_record(sig.event_id)
        if rec is None:
            return None
        if sig.xi_bar <= 0.0:
            share = 0.0
        else:
            share = sig.epsilon * (rec.xi / sig.xi_bar)
        m = max(rec.batch_size, 1)
        headroom = (self.m_max - m) * (rec.queuing / m) + self.xi(self.m_max) - self.xi(m)
        lam = min(share, max(headroom, 0.0))
        st = self.state(downstream)
        candidate = rec.departure + lam
        if not st.initialized:
            st.value = candidate  # bootstrap: ignore beta_old
        else:
            st.value = max(candidate, st.value if st.value is not None else -math.inf)
        st.initialized = True
        self._min_cache = None
        return st.value
