"""Task pipeline runtime (paper §3, §4.2 Fig. 4).

A pipeline is a DAG of :class:`Task` instances.  Each task owns a FIFO input
queue, a batcher (dynamic/static/NOB), a :class:`TaskBudget`, a cost model
``xi(b)``, a user logic callable and a partitioner that routes each output
event to a downstream task instance.  Pipelines are normally not wired by
hand: the app compiler (:mod:`repro_torch.core.compile`) lowers a
:class:`~repro_torch.core.dataflow.TrackingApp` onto this runtime.  Execution is single-server per task
(one batch at a time), matching one Executor process per module instance in
Anveshak.

The runtime is driven by a discrete-event scheduler (``sim``) that provides
``now`` (true time) and ``schedule(delay, fn, *args)``; each task reads time
through its own skewed :class:`Clock`, so the clock-skew resilience of the
drop / batch / budget logic (§4.6.2) is exercised for real.

Event life-cycle inside a task (Fig. 4):

    arrival --DP1--> queue --batcher--> batch --DP2--> execute --DP3-->
      partition --> transmit(network delay) --> downstream.on_arrival

Reject signals flow to *all upstream* tasks of the pipeline path; accept
signals originate at the sink for the slowest event of a batch arriving more
than ``epsilon_max`` early.  Probe events (every ``probe_every``-th drop) are
forwarded un-droppably to let collapsed budgets recover (§4.5.2).

Hot-path notes: this module runs ~10 times per source event in a full
scenario, so it avoids per-event closures (``schedule`` takes ``(fn, *args)``
instead), advances headers in place for the common 1:1-selectivity case, and
keeps the per-event bookkeeping (``_event_downstream``) in a bounded LRU so a
long run cannot grow memory without bound.
"""

from __future__ import annotations

import math
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

from .batching import DynamicBatcher, PendingEvent, StaticBatcher, _BatcherBase
from .budget import TaskBudget
from .clock import Clock
from .dropping import drop_before_exec, drop_before_queuing, drop_before_transmit
from .events import (
    AcceptSignal,
    Event,
    EventHeader,
    EventRecord,
    RejectSignal,
    release_header,
)

__all__ = ["Task", "SinkTask", "PipelineStats", "STAT_FIELDS", "Scheduler", "DP_FAULT"]

#: Drop-point index for fault losses (crashed host, exhausted retries across
#: a partition) — the fourth drop class next to DP1/DP2/DP3.  Charged through
#: the same ``on_drop_hook`` so per-query accounting reconciles exactly, but
#: it is *not* a §4.3 deadline decision: no reject signal, no probe.
DP_FAULT = 4

UserLogic = Callable[[List[Event], Dict[str, Any]], List[Event]]
Partitioner = Callable[[Event], str]


class Scheduler:
    """Protocol the tasks expect from the discrete-event engine."""

    @property
    def time(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def schedule(self, delay: float, fn: Callable[..., None], *args: Any) -> None:  # pragma: no cover
        raise NotImplementedError

    def transit_delay(self, src: str, dst: str, size_bytes: float) -> float:
        return 0.0

    # Task registry (name -> Task) for path-based signal delivery (§4.3.4).
    tasks: Dict[str, "Task"] = {}


@dataclass(slots=True)
class PipelineStats:
    """Counters a task accumulates (drives the §5 analyses)."""

    arrived: int = 0
    dropped_dp1: int = 0
    dropped_dp2: int = 0
    dropped_dp3: int = 0
    executed: int = 0
    batches: int = 0
    # Signal-plane counters (cold path: drops/signals only) sampled by the
    # dynamism telemetry alongside the drop points.
    probes: int = 0
    accepts_rx: int = 0
    rejects_rx: int = 0
    # Fault losses (DP_FAULT): events lost to a crashed host or to retries
    # exhausted across a partition.  Deliberately *not* in STAT_FIELDS — the
    # dynamism trace digests its columns, and fault losses are a different
    # phenomenon from the §4.3 deadline drops it tracks.
    dropped_fault: int = 0
    batch_sizes: List[int] = field(default_factory=list)

    @property
    def dropped(self) -> int:
        return (
            self.dropped_dp1
            + self.dropped_dp2
            + self.dropped_dp3
            + self.dropped_fault
        )


#: Telemetry field -> PipelineStats attribute for the cumulative counters a
#: dynamism trace samples per task.  Lives next to PipelineStats so the
#: per-task, aggregate (``FC*``) and serving
#: (:meth:`repro_torch.serving.scheduler.ServedStage.telemetry`) rows share one
#: mapping without the serving plane importing the sim package.
STAT_FIELDS = (
    ("dp1", "dropped_dp1"),
    ("dp2", "dropped_dp2"),
    ("dp3", "dropped_dp3"),
    ("probes", "probes"),
    ("accepts", "accepts_rx"),
    ("rejects", "rejects_rx"),
    ("batches", "batches"),
    ("executed", "executed"),
)


class Task:
    """One module instance (Executor) in the dataflow."""

    # Bounded size of the event-id -> downstream-name map used to attribute
    # late accept/reject signals (§4.3.4).  One entry per routed event was an
    # unbounded leak; signals for evicted (old) events are safely ignored
    # because budget updates clamp against ``beta_old``.
    EVENT_DOWNSTREAM_CAPACITY = 8192

    def __init__(
        self,
        name: str,
        sim: Scheduler,
        xi: Callable[[int], float],
        batcher: _BatcherBase,
        *,
        logic: Optional[UserLogic] = None,
        clock: Optional[Clock] = None,
        budget: Optional[TaskBudget] = None,
        partitioner: Optional[Partitioner] = None,
        drops_enabled: bool = True,
        probe_every: int = 16,
        node: str = "",
    ) -> None:
        self.name = name
        self.sim = sim
        self.xi = xi
        self.batcher = batcher
        self.logic = logic or (lambda events, state: list(events))
        self.clock = clock or Clock()
        self.budget = budget or TaskBudget(name, xi, m_max=getattr(batcher, "m_max", 25))
        self.partitioner = partitioner or (lambda ev: next(iter(self.downstream)))
        self.drops_enabled = drops_enabled
        self.probe_every = int(probe_every)
        self.node = node or name
        # Which dataflow module type this task lowers (FC/VA/CR/UV, set by
        # the app compiler); empty for hand-wired tasks.
        self.module: str = ""
        self.state: Dict[str, Any] = {}
        self.downstream: Dict[str, "Task"] = {}
        self.upstream: List["Task"] = []
        self.stats = PipelineStats()
        self._drop_count = 0
        self._busy = False
        self._run_queue: Deque[List[PendingEvent]] = deque()
        self._event_downstream: "OrderedDict[int, str]" = OrderedDict()
        self._timer_pending = False
        self._upstream_cache = None
        self._batcher_is_dynamic = isinstance(batcher, DynamicBatcher)
        self._batcher_is_static = type(batcher) is StaticBatcher
        # Streaming tasks (static batch of 1) skip the batcher entirely:
        # every arrival is its own batch, so ``offer``/timer bookkeeping is
        # pure overhead for them (FC sources are all in this regime).
        self._streaming = (
            isinstance(batcher, StaticBatcher) and getattr(batcher, "batch_size", 0) == 1
        )
        # Dynamism plane: optional (host, t) -> duration multiplier applied
        # to *actual* execution time (never to the xi estimates the drop /
        # batching decisions use — stragglers are unannounced).  None in
        # every undisturbed run: the hot path pays one attribute test.
        self._xi_mult = getattr(sim, "xi_multiplier", None)
        # Fault plane (repro_torch.sim.dynamism.FaultPlane) snapshotted like the
        # xi multiplier: None in every undisturbed run, so healthy transmits
        # pay one attribute test.  When present, every inter-task send goes
        # through the fault-checked `_send` path (timeout + retry + loss).
        self._faults = getattr(sim, "faults", None)
        # Fused streaming (opt-in, see ``fuse_streaming``): collapse the
        # execute->transmit pair into a single scheduled downstream arrival.
        self.fuse_streaming = False
        # Multi-query tenancy (repro_torch.query): optional observer invoked once
        # per dropped event as ``hook(ev, point, epsilon)`` with the drop
        # point (1/2/3) — lets the query plane charge a drop to every query
        # tagged on the event *before* the header is recycled.  None (the
        # default) costs a single attribute test on the drop cold path only.
        self.on_drop_hook: Optional[Callable[[Event, int, float], None]] = None
        # Observability plane (repro_torch.obs.tracing): duck-typed span tracer,
        # installed via ``CompiledApp.install_tracer``.  None in every
        # untraced run — arrivals pay a single attribute test, and the
        # pipeline never imports repro_torch.obs.
        self.tracer = None
        self._xi1 = xi(1)
        self._busy_until = -math.inf
        self._drain_pending = False
        # dst_name -> fixed transit delay, populated only while the
        # scheduler reports a time-invariant network (``transit_is_static``).
        self._transit_memo: Dict[str, float] = {}
        # Event sizes for network modelling: bytes per event leaving this task.
        self.output_event_bytes: float = 2900.0  # paper: 2.9 kB median JPG
        if not hasattr(sim, "tasks") or sim.tasks is Scheduler.tasks:
            sim.tasks = {}
        sim.tasks[name] = self

    # ------------------------------------------------------------------ #
    # Wiring                                                             #
    # ------------------------------------------------------------------ #
    def connect(self, downstream: "Task") -> "Task":
        self.downstream[downstream.name] = downstream
        downstream.upstream.append(self)
        downstream._upstream_cache = None
        return downstream

    def upstream_chain(self) -> List["Task"]:
        """All transitive upstream tasks (fallback when an event carries no
        path); cached, set-deduplicated."""
        if getattr(self, "_upstream_cache", None) is not None:
            return self._upstream_cache
        seen: Dict[int, Task] = {}
        frontier = list(self.upstream)
        while frontier:
            t = frontier.pop()
            if id(t) not in seen:
                seen[id(t)] = t
                frontier.extend(t.upstream)
        self._upstream_cache = list(seen.values())
        return self._upstream_cache

    def _path_tasks(self, path) -> List["Task"]:
        """Tasks along an event's traversed path (its pipeline, §4.2)."""
        if not path:
            return self.upstream_chain()
        reg = getattr(self.sim, "tasks", {})
        return [reg[n] for n in path if n in reg and reg[n] is not self]

    # ------------------------------------------------------------------ #
    # Arrival + drop point 1                                             #
    # ------------------------------------------------------------------ #
    def on_arrival(self, ev: Event) -> None:
        now_local = self.sim.time + self.clock.skew
        self.stats.arrived += 1
        header = ev.header
        if self.tracer is not None:
            self.tracer.on_arrival(self, header, self.sim.time)
        if not self.drops_enabled and (
            self._streaming
            # Budget-less dynamic batching is the paper's bootstrap regime:
            # batch size pinned to 1 (§4.5), i.e. streaming as well.
            or (self._batcher_is_dynamic and not self.batcher._current)
        ):
            # Streaming fast path: the event is immediately its own batch.
            busy = self._busy or now_local < self._busy_until
            if not busy:
                exec_dur = self._xi1
                if self._xi_mult is not None:
                    exec_dur *= self._xi_mult(self.node, self.sim.time)
                if self.fuse_streaming:
                    # Fused: run the logic now, mark the server busy for
                    # xi(1), and schedule the downstream arrival directly at
                    # exec-end + transit — one heap event instead of two.
                    # (Only enabled by callers whose logic may read state at
                    # arrival rather than completion time; identical whenever
                    # control updates are slower than xi(1).)
                    self._busy_until = now_local + exec_dur
                    # depart_at is absolute *simulation* time: durations are
                    # skew-free but now_local carries the device skew.
                    self._finish_streaming(
                        ev, now_local, exec_dur, depart_at=self.sim.time + exec_dur
                    )
                    return
                self._busy = True
                self.sim.schedule(exec_dur, self._finish_streaming_event, ev, now_local, exec_dur)
                return
            self._run_queue.append(
                [PendingEvent(event=ev, arrival=now_local, deadline=math.inf)]
            )
            if not self._busy and not self._drain_pending:
                # Busy via a fused execution that has no completion callback:
                # arrange a drain at its end.
                self._drain_pending = True
                self.sim.schedule(self._busy_until - now_local, self._drain_fused)
            return
        if self.drops_enabled:
            beta = self.budget.min_budget()
            if drop_before_queuing(
                header.source_arrival,
                now_local,
                self.xi(1),
                beta,
                avoid_drop=header.avoid_drop or header.is_probe,
            ):
                self.stats.dropped_dp1 += 1
                u = now_local - header.source_arrival
                self._on_drop(ev, epsilon=u + self.xi(1) - beta, point=1)
                return
            deadline = header.source_arrival + beta
        else:
            beta = math.inf
            deadline = math.inf
        pe = PendingEvent(event=ev, arrival=now_local, deadline=deadline)
        # Bootstrap (§4.5): until a budget is assigned the deadline is
        # unbounded; the paper fixes the batch size at b=1 in that regime so
        # dynamic batches cannot grow without an auto-submit deadline.
        if beta == math.inf and self._batcher_is_dynamic:
            open_batch = self.batcher.take() if self.batcher.current_size else []
            if open_batch:
                self._enqueue_batch(open_batch)
            self._enqueue_batch([pe])
            return
        if self._batcher_is_static:
            # Inline StaticBatcher.offer: append, submit when full.
            batcher = self.batcher
            cur = batcher._current
            cur.append(pe)
            if len(cur) >= batcher.batch_size:
                batcher._current = []
                self._enqueue_batch(cur)
            return
        submitted = self.batcher.offer(pe, now_local)
        if submitted:
            self._enqueue_batch(submitted)
        if self._batcher_is_dynamic:
            self._arm_timer()

    def _arm_timer(self) -> None:
        """Auto-submit the open batch at ``Delta_p - xi(m)`` (§4.4)."""
        if self._timer_pending:
            return
        due = self.batcher.next_due_time()
        if math.isinf(due):
            return
        self._timer_pending = True
        delay = max(due - self.clock.now(self.sim.time), 0.0)
        self.sim.schedule(delay, self._timer_fire)

    def _timer_fire(self) -> None:
        self._timer_pending = False
        batch = self.batcher.flush_if_due(self.clock.now(self.sim.time))
        if batch:
            self._enqueue_batch(batch)
        self._arm_timer()

    # ------------------------------------------------------------------ #
    # Execution: drop point 2, run, drop point 3                         #
    # ------------------------------------------------------------------ #
    def _enqueue_batch(self, batch: List[PendingEvent]) -> None:
        self._run_queue.append(batch)
        self._maybe_run()

    def _maybe_run(self) -> None:
        # Iterative (not mutually recursive with the finish callback): a long
        # run-queue of fully-dropped batches must not hit the recursion limit.
        if self._busy:
            return
        rq = self._run_queue
        while rq:
            batch = rq.popleft()
            now_local = self.sim.time + self.clock.skew
            if self.drops_enabled:
                b = len(batch)
                xi_b = self.xi(b)
                beta = self.budget.min_budget()
                tuples = [
                    (pe.event.header.source_arrival, pe.arrival, now_local - pe.arrival, pe.event)
                    for pe in batch
                ]
                retained_evs, dropped_evs = drop_before_exec(tuples, xi_b, beta)
                if dropped_evs:
                    pe_by_id = {pe.event.header.event_id: pe for pe in batch}
                    for ev in dropped_evs:
                        self.stats.dropped_dp2 += 1
                        pe = pe_by_id[ev.header.event_id]
                        u = pe.arrival - ev.header.source_arrival
                        q = now_local - pe.arrival
                        self._on_drop(ev, epsilon=u + q + xi_b - beta, point=2)
                    if not retained_evs:
                        continue
                    retained_pes = [pe_by_id[ev.header.event_id] for ev in retained_evs]
                else:
                    retained_pes = batch
            else:
                retained_pes = batch
            exec_dur = self.xi(len(retained_pes))
            if self._xi_mult is not None:
                exec_dur *= self._xi_mult(self.node, self.sim.time)
            self._busy = True
            self.sim.schedule(exec_dur, self._finish_and_continue, retained_pes, now_local, exec_dur)
            return

    def _finish_and_continue(
        self, batch: List[PendingEvent], exec_start: float, exec_dur: float
    ) -> None:
        self._finish_batch(batch, exec_start=exec_start, exec_dur=exec_dur)
        self._busy = False
        self._maybe_run()

    def _finish_streaming_event(self, ev: Event, arrival: float, exec_dur: float) -> None:
        self._finish_streaming(ev, arrival, exec_dur)
        self._busy = False
        self._maybe_run()

    def _drain_fused(self) -> None:
        self._drain_pending = False
        self._maybe_run()

    def _deliver_many(self, evs: List[Event]) -> None:
        """Arrival of a grouped same-destination transit (drops-off path)."""
        if (
            self._batcher_is_static
            and not self.drops_enabled
            and not self._streaming
            and self.tracer is None
        ):
            # Bulk arrival: replicate per-event on_arrival + StaticBatcher
            # offer without the per-event call overhead.  A tracer needs the
            # per-event path so every hop is observed.
            now_local = self.sim.time + self.clock.skew
            self.stats.arrived += len(evs)
            batcher = self.batcher
            cur = batcher._current
            size = batcher.batch_size
            inf = math.inf
            for ev in evs:
                cur.append(PendingEvent(event=ev, arrival=now_local, deadline=inf))
                if len(cur) >= size:
                    batcher._current = []
                    self._enqueue_batch(cur)
                    cur = batcher._current
            return
        arrive = self.on_arrival
        for ev in evs:
            arrive(ev)

    def _finish_streaming(
        self, ev: Event, arrival: float, exec_dur: float, depart_at: Optional[float] = None
    ) -> None:
        """Completion for the streaming (b=1, started-immediately) fast path:
        ``exec_start == arrival`` so ``q == 0`` exactly, and the single event
        is trivially its batch's slowest.

        Precondition: only reachable with ``drops_enabled`` False (both call
        sites gate on it), so budget records and path propagation — which
        exist solely for the drop/budget signal machinery — are skipped.
        """
        stats = self.stats
        stats.batches += 1
        stats.batch_sizes.append(1)
        h = ev.header
        outputs = self.logic([ev], self.state)
        u = arrival - h.source_arrival
        pi = 0.0 + exec_dur
        stats.executed += 1
        if len(outputs) == 1 and outputs[0].header is h:
            out = outputs[0]
            h.xi_bar += exec_dur
            out.batch_slowest = True
            self._route(out, u=u, pi=pi, depart_at=depart_at)
        else:
            outs = [o for o in outputs if o.header.event_id == h.event_id]
            sole = len(outs) == 1
            for out in outs:
                if sole and out.header is h:
                    out.header = h.advance_in_place(xi=exec_dur, q=0.0, task="")
                else:
                    out.header = h.advanced(xi=exec_dur, q=0.0, task="")
                out.batch_slowest = True
                self._route(out, u=u, pi=pi, depart_at=depart_at)

    def _finish_batch(
        self, batch: List[PendingEvent], exec_start: float, exec_dur: float
    ) -> None:
        stats = self.stats
        stats.batches += 1
        m = len(batch)
        stats.batch_sizes.append(m)
        if m == 1 and not batch[0].event.header.is_probe:
            # Single-event batch (streaming FCs, b=1 configs): it is trivially
            # the slowest of its batch; skip the generic passes.
            pe = batch[0]
            ev = pe.event
            h = ev.header
            outputs = self.logic([ev], self.state)
            u = pe.arrival - h.source_arrival
            q = exec_start - pe.arrival
            pi = q + exec_dur
            stats.executed += 1
            if self.drops_enabled:
                self.budget.record(
                    h.event_id,
                    EventRecord(departure=u + pi, queuing=q, batch_size=1, xi=exec_dur),
                )
            task = self.name if self.drops_enabled else ""
            if len(outputs) == 1 and outputs[0].header is h:
                out = outputs[0]
                h.xi_bar += exec_dur
                h.q_bar += q
                if task:
                    h.path = h.path + (task,)
                out.batch_slowest = True
                self._route(out, u=u, pi=pi)
            else:
                # Same contract as the general path: only outputs causally
                # tied to the input event (same id) are routed.
                outs = [o for o in outputs if o.header.event_id == h.event_id]
                sole = len(outs) == 1
                for out in outs:
                    if sole and out.header is h:
                        out.header = h.advance_in_place(xi=exec_dur, q=q, task=task)
                    else:
                        out.header = h.advanced(xi=exec_dur, q=q, task=task)
                    out.batch_slowest = True
                    self._route(out, u=u, pi=pi)
            return
        probes: List[Event] = []
        work: List[Event] = []
        for pe in batch:
            (probes if pe.event.header.is_probe else work).append(pe.event)
        outputs = self.logic(work, self.state)
        if probes:
            outputs = list(outputs) + probes
        # Track the slowest event of the batch for the sink's accept logic.
        slowest_id, slowest_d = None, -math.inf
        for pe in batch:
            h = pe.event.header
            u = pe.arrival - h.source_arrival
            q = exec_start - pe.arrival
            pi = q + exec_dur
            d = u + pi
            if d > slowest_d:
                slowest_d, slowest_id = d, h.event_id
        # Fast path: 1:1 selectivity with pass-through headers (the common
        # case — identity logics and per-event transforms that reuse the
        # incoming header object).  Headers advance in place: no allocation.
        paired = not probes and len(outputs) == m
        if paired:
            for out, pe in zip(outputs, batch):
                if out.header is not pe.event.header:
                    paired = False
                    break
        keep_records = self.drops_enabled
        budget_record = self.budget.record
        if paired and not keep_records and self.downstream and self._faults is None:
            # Drops-off fast path: no DP3, no records, and every output to
            # the same destination shares one transit — deliver each
            # destination's events with a single scheduled callback instead
            # of one heap event per event.
            partition = self.partitioner
            groups: Dict[str, List[Event]] = {}
            for out, pe in zip(outputs, batch):
                h = out.header
                q = exec_start - pe.arrival
                stats.executed += 1
                h.xi_bar += exec_dur
                h.q_bar += q
                if h.event_id == slowest_id:
                    out.batch_slowest = True
                dst_name = partition(out)
                g = groups.get(dst_name)
                if g is None:
                    groups[dst_name] = [out]
                else:
                    g.append(out)
            memo = self._transit_memo
            sim = self.sim
            static = getattr(sim, "transit_is_static", False)
            if memo and not static:
                memo.clear()  # network turned dynamic: cached delays are stale
            for dst_name, evs in groups.items():
                dst = self.downstream[dst_name]
                delay = memo.get(dst_name) if static else None
                if delay is None:
                    delay = sim.transit_delay(self.node, dst.node, self.output_event_bytes)
                    if static:
                        memo[dst_name] = delay
                sim.schedule(delay, dst._deliver_many, evs)
            return
        if paired:
            name = self.name if keep_records else ""
            route = self._route
            for out, pe in zip(outputs, batch):
                h = out.header
                u = pe.arrival - h.source_arrival
                q = exec_start - pe.arrival
                pi = q + exec_dur
                stats.executed += 1
                eid = h.event_id
                if keep_records:
                    budget_record(
                        eid, EventRecord(departure=u + pi, queuing=q, batch_size=m, xi=exec_dur)
                    )
                h.xi_bar += exec_dur
                h.q_bar += q
                if name:
                    h.path = h.path + (name,)
                if eid == slowest_id:
                    out.batch_slowest = True
                route(out, u=u, pi=pi)
            return
        out_by_id: Dict[int, List[Event]] = {}
        for out in outputs:
            out_by_id.setdefault(out.header.event_id, []).append(out)
        for pe in batch:
            ev = pe.event
            h = ev.header
            u = pe.arrival - h.source_arrival
            q = exec_start - pe.arrival
            pi = q + exec_dur
            stats.executed += 1
            if keep_records:
                budget_record(
                    h.event_id,
                    EventRecord(departure=u + pi, queuing=q, batch_size=m, xi=exec_dur),
                )
            outs = out_by_id.get(h.event_id, ())
            sole = len(outs) == 1
            task = self.name if keep_records else ""
            for out in outs:
                if sole and out.header is h:
                    out.header = h.advance_in_place(xi=exec_dur, q=q, task=task)
                else:
                    out.header = h.advanced(xi=exec_dur, q=q, task=task)
                if h.event_id == slowest_id:
                    out.batch_slowest = True
                self._route(out, u=u, pi=pi)

    def _route(
        self, ev: Event, u: float, pi: float, depart_at: Optional[float] = None
    ) -> None:
        if not self.downstream:
            return
        dst_name = self.partitioner(ev)
        dst = self.downstream[dst_name]
        if self.drops_enabled:
            # Remember where the event went so a late signal updates the
            # right per-downstream budget (only consulted when drops are on).
            eds = self._event_downstream
            eds[ev.header.event_id] = dst_name
            if len(eds) > self.EVENT_DOWNSTREAM_CAPACITY:
                eds.popitem(last=False)
            beta = self.budget.budget(dst_name)
            # DP3 test is u + pi > beta (§4.3.3); express via
            # drop_before_transmit with arrival reconstructed so that
            # arrival - source_arrival == u.
            if drop_before_transmit(
                0.0,
                u,
                pi,
                beta,
                avoid_drop=ev.header.avoid_drop or ev.header.is_probe,
            ):
                self.stats.dropped_dp3 += 1
                self._on_drop(ev, epsilon=u + pi - beta, downstream=dst_name, point=3)
                return
        if self._faults is not None:
            # Fault plane installed: every inter-task send is fault-checked
            # (src/dst liveness, partition, timeout + retry).  fuse_streaming
            # is never compiled in under faults, so depart_at is None here.
            self._send(dst, ev)
            return
        static = getattr(self.sim, "transit_is_static", False)
        delay = self._transit_memo.get(dst_name) if static else None
        if delay is None:
            if not static and self._transit_memo:
                self._transit_memo.clear()  # network turned dynamic mid-run
            delay = self.sim.transit_delay(self.node, dst.node, self.output_event_bytes)
            if static:
                self._transit_memo[dst_name] = delay
        if depart_at is None:
            self.sim.schedule(delay, dst.on_arrival, ev)
        else:
            # Fused streaming: the event departs at exec-end; the arrival
            # time (depart_at + delay) matches the unfused two-hop float
            # arithmetic exactly.
            self.sim.schedule_at(depart_at + delay, dst.on_arrival, ev)

    # ------------------------------------------------------------------ #
    # Fault-checked transmit (fault plane)                               #
    # ------------------------------------------------------------------ #
    def _send(self, dst: "Task", ev: Event, attempt: int = 0) -> None:
        """Transmit under a fault plane: a dead sender loses its output
        outright; a dead destination or a partitioned link times out and
        retries with seeded capped exponential backoff until
        ``max_retries``, after which the event is charged as ``dp_fault``."""
        fp = self._faults
        sim = self.sim
        now = sim.time
        if fp.host_down(self.node, now):
            # The sending host is inside a crash window: anything it was
            # holding (including a just-finished batch's outputs) is lost.
            self._fault_drop(ev)
            return
        if fp.send_blocked(self.node, dst.node, now):
            if attempt >= fp.retry.max_retries:
                self._fault_drop(ev)
                return
            fp.sends_blocked += 1
            fp.retries += 1
            if self.tracer is not None:
                self.tracer.on_retry(self, ev.header, now, attempt)
            sim.schedule(fp.retry_delay(attempt), self._send, dst, ev, attempt + 1)
            return
        delay = sim.transit_delay(self.node, dst.node, self.output_event_bytes)
        sim.schedule(delay, self._arrive_checked, dst, ev)

    def _arrive_checked(self, dst: "Task", ev: Event) -> None:
        """Delivery completion under a fault plane: a destination that died
        while the event was in transit loses it (in-flight loss)."""
        fp = self._faults
        if fp is not None and fp.host_down(dst.node, self.sim.time):
            dst._fault_drop(ev)
            return
        dst.on_arrival(ev)

    def _fault_drop(self, ev: Event) -> None:
        """Charge an event lost to a fault (crashed host, partition retries
        exhausted) as the ``dp_fault`` class.  Unlike the §4.3 drop points
        this is not a deadline decision: the query-plane hook still fires
        (point ``DP_FAULT``) so per-query books reconcile exactly, but no
        reject signal is sent — a fault says nothing about budgets — and no
        probe is re-injected."""
        header = ev.header
        if header is None:
            return  # already accounted (defensive: double flush)
        self.stats.dropped_fault += 1
        fp = self._faults
        if fp is not None:
            fp.fault_drops += 1
        hook = self.on_drop_hook
        if hook is not None:
            hook(ev, DP_FAULT, 0.0)
        if self.tracer is not None:
            self.tracer.on_drop(self, header, self.sim.time, DP_FAULT, 0.0)
        ev.header = None  # type: ignore[assignment]
        release_header(header)

    # ------------------------------------------------------------------ #
    # Signals (§4.5)                                                     #
    # ------------------------------------------------------------------ #
    def _on_drop(
        self, ev: Event, epsilon: float, downstream: str = "", point: int = 0
    ) -> None:
        self._drop_count += 1
        header = ev.header
        hook = self.on_drop_hook
        if hook is not None:
            # Fire while the event (and its header) is still intact; the
            # hook must not retain either — the header is recycled below.
            hook(ev, point, epsilon)
        if self.tracer is not None:
            # Drop causality as a span event (the span ends here).
            self.tracer.on_drop(self, header, self.sim.time, point, epsilon)
        sig = RejectSignal(
            event_id=header.event_id,
            epsilon=max(epsilon, 0.0),
            q_bar=header.q_bar,
            from_task=self.name,
        )
        for up in self._path_tasks(header.path):
            up.receive_reject(sig)
        # Probe every k-th dropped event: re-inject it as un-droppable so it
        # traverses the NORMAL path (including this task's own executor) —
        # each task along the way then has an event record for the accept
        # signal to act on, which is what lets a collapsed budget recover
        # (§4.5.2).
        if self.probe_every > 0 and self._drop_count % self.probe_every == 0:
            self.stats.probes += 1
            probe = Event(
                header=EventHeader(
                    event_id=header.event_id,
                    source_arrival=header.source_arrival,
                    xi_bar=header.xi_bar,
                    q_bar=header.q_bar,
                    is_probe=True,
                    path=header.path,
                ),
                key=ev.key,
                value=ev.value,
            )
            self.sim.schedule(0.0, self.on_arrival, probe)
        # The event dies here; its header can be recycled (see events.py).
        ev.header = None  # type: ignore[assignment]
        release_header(header)

    def receive_reject(self, sig: RejectSignal) -> None:
        self.stats.rejects_rx += 1
        downstream = self._event_downstream.get(sig.event_id, "")
        self.budget.on_reject(sig, downstream=downstream)

    def receive_accept(self, sig: AcceptSignal) -> None:
        self.stats.accepts_rx += 1
        downstream = self._event_downstream.get(sig.event_id, "")
        self.budget.on_accept(sig, downstream=downstream)


class SinkTask(Task):
    """The pipeline sink (UV): measures end-to-end latency, generates accept
    signals, and feeds detections to the TL callback."""

    def __init__(
        self,
        name: str,
        sim: Scheduler,
        gamma: float,
        *,
        epsilon_max: float = 1.0,
        on_event: Optional[Callable[[Event, float], None]] = None,
        clock: Optional[Clock] = None,
        node: str = "",
        learn_budgets: bool = True,
        recycle_headers: bool = False,
    ) -> None:
        super().__init__(
            name,
            sim,
            xi=lambda b: 0.0,
            batcher=DynamicBatcher(lambda b: 0.0, m_max=1),
            clock=clock,
            drops_enabled=False,
            node=node,
        )
        self.gamma = float(gamma)
        self.epsilon_max = float(epsilon_max)
        self.on_event = on_event
        # Accept signals exist to raise upstream completion budgets; when the
        # whole pipeline runs with drops disabled the budgets are never
        # consulted, so the scenario can turn signal generation off.
        self.learn_budgets = bool(learn_budgets)
        # Header recycling is an opt-in for owners whose ``on_event`` callback
        # provably does not retain the event (or its header): a retained
        # header would be overwritten when the pool reuses it.
        self.recycle_headers = bool(recycle_headers)
        self.latencies: List[Tuple[float, float]] = []  # (t_now, latency)
        self.delayed: int = 0
        self.on_time: int = 0
        #: Probe events that completed the full path to the sink (§4.5.2);
        #: reconciled against the tasks' emitted-probe counters by the
        #: pipeline invariant tests.
        self.probes_seen: int = 0
        self.budget.set_budget(self.gamma)

    def on_arrival(self, ev: Event) -> None:  # overrides Task
        now_local = self.sim.time + self.clock.skew
        self.stats.arrived += 1
        header = ev.header
        u = now_local - header.source_arrival  # kappa_1 == kappa_n (§4.6.2)
        if header.is_probe:
            self.probes_seen += 1
            if u <= self.gamma and self.learn_budgets:
                self._send_accept(ev, epsilon=self.gamma - u)
            return
        self.latencies.append((now_local, u))
        tr = self.tracer
        if tr is not None:
            # Terminal hop + span completion with the end-to-end latency.
            tr.on_arrival(self, header, self.sim.time)
            tr.on_sink(self, header, self.sim.time, u)
        if u <= self.gamma:
            self.on_time += 1
        else:
            self.delayed += 1
        # Accept only on the slowest event of an upstream batch (§4.5.2).
        if ev.batch_slowest and self.learn_budgets:
            epsilon = self.gamma - u
            if epsilon > self.epsilon_max:
                self._send_accept(ev, epsilon=epsilon)
        if self.on_event is not None:
            self.on_event(ev, now_local)
        # Flow ends here.  Recycling is only safe when the sink owner opted
        # in (``recycle_headers``): a user callback may have retained the
        # event, and we cannot detect that here.
        if self.recycle_headers and ev.header is header:
            ev.header = None  # type: ignore[assignment]
            release_header(header)

    def _send_accept(self, ev: Event, epsilon: float) -> None:
        sig = AcceptSignal(
            event_id=ev.header.event_id,
            epsilon=epsilon,
            xi_bar=ev.header.xi_bar,
            from_task=self.name,
        )
        for up in self._path_tasks(ev.header.path):
            up.receive_accept(sig)
