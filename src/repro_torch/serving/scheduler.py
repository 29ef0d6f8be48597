"""Anveshak-scheduled serving: the paper's runtime knobs in front of batched
model steps on the GPU.

The port's counterpart of ``repro.serving.scheduler``.  A
:class:`ServedStage` wraps one batched torch step (VA embedding, CR re-id,
...) with

* a **completion budget** (:class:`TaskBudget`) updated by accept/reject
  signals,
* the paper's **three drop points** around the device step, and
* the **dynamic deadline batcher** (§4.4) whose ``xi(b)`` cost model is
  *calibrated by timing the step* on the padding buckets — replacing the
  paper's empirical benchmarking table.

Batches are padded to the bucket sizes, as in the reference, so batch
shapes (and the calibrated cost model) stay the same in both packages.
A step's output is a tensor or a tuple of tensors; it is brought to the
host with ``.cpu()`` and each request gets its row.

Stages are the **serving lowering target of the app compiler**: a composed
:class:`~repro_torch.core.dataflow.TrackingApp` + a
:class:`~repro_torch.core.compile.DeploymentSpec` lower onto ServedStages via
:func:`lower_app_stages`, resolving the same per-module specs
(``m_max``, cost model, drops, ``gamma``) that
``repro_torch.core.compile.compile_app`` resolves for the discrete-event plane —
one application spec, two execution planes.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device

from repro_torch.core.batching import DynamicBatcher, PendingEvent
from repro_torch.core.budget import TaskBudget
from repro_torch.core.dropping import drop_before_exec, drop_before_queuing, drop_before_transmit
from repro_torch.core.events import Event, EventHeader, EventRecord, new_event_id

__all__ = [
    "StageRequest",
    "StageResult",
    "ServedStage",
    "calibrate_xi",
    "lower_stage",
    "lower_app_stages",
]


def _block_until_ready(out: Any) -> Any:
    """Wait for the device work behind a step's output (a tensor or a tuple
    of tensors): ``torch.cuda.synchronize`` on CUDA, nothing on the CPU."""
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
    return out


def _to_host(out: Any) -> Any:
    """``.cpu()`` of a tensor, or of each tensor of a tuple."""
    if isinstance(out, (tuple, list)):
        return tuple(t.cpu() for t in out)
    return out.cpu()


def _row(out: Any, idx: int) -> Any:
    if isinstance(out, tuple):
        return tuple(t[idx] for t in out)
    return out[idx]


@dataclass
class StageRequest:
    """One unit of work (e.g. a camera frame's features).

    ``query_id`` is the multi-query tenancy tag (None outside multi-query
    serving): requests carrying one are counted into the stage's per-query
    telemetry row, mirroring the sim plane's ``Event.query_mask``.
    """

    payload: np.ndarray
    source_time: float
    event_id: int = field(default_factory=new_event_id)
    avoid_drop: bool = False
    query_id: Optional[int] = None


@dataclass
class StageResult:
    event_id: int
    output: Any
    latency: float
    batch_size: int
    dropped: bool = False


# Counter keys of a per-query telemetry row (same keys as ServedStage.stats,
# minus nothing — signals are stage-level but the row shape stays uniform).
_ZERO_QUERY_ROW: Dict[str, int] = {
    "arrived": 0,
    "dropped": 0,
    "dropped_dp1": 0,
    "dropped_dp2": 0,
    "dropped_dp3": 0,
    "executed": 0,
    "batches": 0,
    "probes": 0,
    "accepts_rx": 0,
    "rejects_rx": 0,
}


def calibrate_xi(
    step_fn: Callable[[np.ndarray], Any],
    payload_shape: Sequence[int],
    buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
    repeats: int = 3,
) -> Callable[[int], float]:
    """Measure the compiled step on each bucket; return interpolating xi(b).

    Replaces the paper's offline benchmarking: a warm-up call per bucket,
    then a few timed calls, each waited for on the device.
    """
    times: List[Tuple[int, float]] = []
    for b in buckets:
        x = np.zeros((b, *payload_shape), np.float32)
        _block_until_ready(step_fn(x))  # warm-up
        t0 = time.perf_counter()
        for _ in range(repeats):
            _block_until_ready(step_fn(x))
        times.append((b, (time.perf_counter() - t0) / repeats))
    bs = np.array([b for b, _ in times], np.float64)
    ts = np.array([t for _, t in times], np.float64)

    def xi(b: int) -> float:
        return float(np.interp(b, bs, ts))

    return xi


class ServedStage:
    """One pipeline stage: budgeted, batched, droppable device step.

    ``device`` is where the query block of :meth:`set_queries` lives (the
    step itself owns where it computes)."""

    def __init__(
        self,
        name: str,
        step_fn: Callable[[np.ndarray], Any],  # batched device step
        xi: Callable[[int], float],
        *,
        gamma: float = 15.0,
        m_max: int = 32,
        buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
        drops_enabled: bool = True,
        clock: Callable[[], float] = time.monotonic,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.name = name
        self.step_fn = step_fn
        self.xi = xi
        self.gamma = float(gamma)
        self.buckets = tuple(buckets)
        self.drops_enabled = drops_enabled
        self.clock = clock
        self.budget = TaskBudget(name, xi, m_max=m_max)
        self.batcher = DynamicBatcher(xi, m_max=m_max)
        # "dropped" stays the total; the per-drop-point split feeds the same
        # telemetry surface the pipeline's dynamism trace samples (§4.3).
        # Counter keys use the PipelineStats attribute names so telemetry()
        # can be driven by repro_torch.core.pipeline.STAT_FIELDS directly.
        self.stats = {
            "arrived": 0,
            "dropped": 0,
            "dropped_dp1": 0,
            "dropped_dp2": 0,
            "dropped_dp3": 0,
            "executed": 0,
            "batches": 0,
            "probes": 0,  # serving has no probe re-injection (yet)
            "accepts_rx": 0,
            "rejects_rx": 0,
        }
        # Optional upstream stage: every drop here rejects into its budget
        # (the serving analogue of the pipeline's path-based reject signals,
        # §4.5; wired by lower_app_stages as VA <- CR).
        self.upstream: Optional["ServedStage"] = None
        # Multi-query tenancy: per-query counter rows (same keys as
        # ``stats``) and the event-id -> query-id attribution map for
        # requests currently in flight through the batcher.
        self._query_stats: Dict[int, Dict[str, int]] = {}
        self._query_of: Dict[int, int] = {}
        # Query-major fused step: a (Q, D) query-embedding block padded to a
        # power-of-two bucket (see set_queries); when present, the step is
        # invoked as ``step_fn(payloads, query_block, nq)``.
        self._query_block: Optional[Any] = None
        self._nq: int = 0

    # -- Anveshak signal hooks (downstream stages call these) ----------- #
    def on_reject(self, event_id: int, epsilon: float, q_bar: float) -> None:
        from repro_torch.core.events import RejectSignal

        self.stats["rejects_rx"] += 1
        self.budget.on_reject(RejectSignal(event_id, epsilon, q_bar))

    def on_accept(self, event_id: int, epsilon: float, xi_bar: float) -> None:
        from repro_torch.core.events import AcceptSignal

        self.stats["accepts_rx"] += 1
        self.budget.on_accept(AcceptSignal(event_id, epsilon, xi_bar))

    def telemetry(self, query_id: Optional[int] = None) -> Dict[str, float]:
        """One telemetry sample, shaped like the discrete-event plane's
        :data:`repro_torch.sim.dynamism.TRACE_FIELDS` row so a serving deployment
        can be traced on a cadence by the same tooling: current budget,
        queue depth, the three drop-point counters and the signal counters.
        Pure snapshot — no allocation on the request path.

        ``query_id`` selects the multi-query dimension: ``None`` returns the
        stage-wide row (historical behavior); a query id returns that
        query's row in the *same shape* — counters restricted to requests
        tagged with the id, queue depth to its pending requests, ``beta``
        the shared stage budget (the device is the shared resource) — so the
        serving and sim planes report identical per-query row shapes."""
        from repro_torch.core.pipeline import STAT_FIELDS

        if query_id is None:
            s = self.stats
            queue = self.batcher.current_size
        else:
            s = self._query_stats.get(query_id, _ZERO_QUERY_ROW)
            q_of = self._query_of
            queue = sum(
                1
                for pe in self.batcher._current
                if q_of.get(pe.event.event_id) == query_id
            )
        row: Dict[str, float] = {
            "beta": self.budget.min_budget(),
            "queue": queue,
        }
        for fld, attr in STAT_FIELDS:
            row[fld] = s[attr]
        return row

    def publish_metrics(self, registry) -> None:
        """Publish stage counters into an obs-plane metrics registry.  The
        observability plane has not been carried over to the port yet."""
        raise NotImplementedError(
            "publish_metrics needs the observability plane (obs), which the "
            "port has not carried over yet"
        )

    # -- Multi-query tenancy -------------------------------------------- #
    def query_ids(self) -> List[int]:
        """Query ids this stage has seen (sorted)."""
        return sorted(self._query_stats)

    def _qstat(self, query_id: int) -> Dict[str, int]:
        qs = self._query_stats.get(query_id)
        if qs is None:
            qs = self._query_stats[query_id] = dict(_ZERO_QUERY_ROW)
        return qs

    def set_queries(self, embeddings: np.ndarray) -> None:
        """Install a query-major fused step: the ``(Q, D)`` live-query
        embedding block is padded to a power-of-two query bucket (same
        bucketing rule as ``repro_torch.kernels.dispatch``) and kept on the
        stage's device as a tensor; ``step_fn`` is then invoked as
        ``step_fn(payloads, query_block, nq)`` with ``nq`` the number of
        real queries (pad rows to be masked by the step).  Pass an empty
        block to fall back to the single-query ``step_fn(payloads)``."""
        from repro_torch.kernels.dispatch import bucket

        emb = np.asarray(embeddings, dtype=np.float32)
        if emb.size == 0:
            self._query_block = None
            self._nq = 0
            return
        if emb.ndim != 2:
            raise ValueError(f"embeddings must be (Q, D), got {emb.shape}")
        Q, D = emb.shape
        qb = bucket(Q)
        pad = np.zeros((qb, D), dtype=np.float32)
        pad[:Q] = emb
        self._query_block = torch.from_numpy(pad).to(self.device)
        self._nq = Q

    def _reject_upstream(self, event_id: int, epsilon: float, q_bar: float) -> None:
        if self.upstream is not None:
            self.upstream.on_reject(event_id, max(epsilon, 0.0), q_bar)

    # -- Request path ---------------------------------------------------- #
    def submit(self, req: StageRequest) -> Optional[List[StageResult]]:
        """Drop point 1 + dynamic batching; returns results if a batch ran."""
        now = self.clock()
        self.stats["arrived"] += 1
        qs = self._qstat(req.query_id) if req.query_id is not None else None
        if qs is not None:
            qs["arrived"] += 1
        beta = self.budget.min_budget() if self.drops_enabled else math.inf
        if self.drops_enabled and drop_before_queuing(
            req.source_time, now, self.xi(1), beta, avoid_drop=req.avoid_drop
        ):
            self.stats["dropped"] += 1
            self.stats["dropped_dp1"] += 1
            if qs is not None:
                qs["dropped"] += 1
                qs["dropped_dp1"] += 1
            u = now - req.source_time
            self._reject_upstream(req.event_id, u + self.xi(1) - beta, 0.0)
            return [StageResult(req.event_id, None, u, 0, dropped=True)]
        if qs is not None:
            self._query_of[req.event_id] = req.query_id
        ev = Event(
            header=EventHeader(
                event_id=req.event_id,
                source_arrival=req.source_time,
                avoid_drop=req.avoid_drop,
            ),
            key=req.event_id,
            value=req.payload,
        )
        pe = PendingEvent(event=ev, arrival=now, deadline=req.source_time + beta)
        if math.isinf(beta):  # bootstrap: streaming (paper §4.5)
            return self._execute([pe])
        batch = self.batcher.offer(pe, now)
        if batch:
            return self._execute(batch)
        return None

    def flush(self) -> Optional[List[StageResult]]:
        """Submit the open batch if its auto-submit deadline passed."""
        batch = self.batcher.flush_if_due(self.clock())
        if batch:
            return self._execute(batch)
        return None

    def next_due_time(self) -> float:
        return self.batcher.next_due_time()

    # -- Execution: drop points 2/3 around the device step --------------- #
    def _execute(self, batch: List[PendingEvent]) -> List[StageResult]:
        now = self.clock()
        beta = self.budget.min_budget() if self.drops_enabled else math.inf
        b = len(batch)
        tuples = [
            (pe.event.header.source_arrival, pe.arrival, now - pe.arrival, pe.event)
            for pe in batch
        ]
        if self.drops_enabled:
            retained, dropped = drop_before_exec(tuples, self.xi(b), beta)
        else:
            retained, dropped = [t[3] for t in tuples], []
        results: List[StageResult] = []
        q_of = self._query_of
        for ev in dropped:
            self.stats["dropped"] += 1
            self.stats["dropped_dp2"] += 1
            qid = q_of.pop(ev.event_id, None)
            if qid is not None:
                qs = self._qstat(qid)
                qs["dropped"] += 1
                qs["dropped_dp2"] += 1
            u_total = now - ev.header.source_arrival
            self._reject_upstream(ev.event_id, u_total + self.xi(b) - beta, ev.header.q_bar)
            results.append(StageResult(ev.event_id, None, u_total, 0, dropped=True))
        if not retained:
            return results
        pe_by_id = {pe.event.event_id: pe for pe in batch}
        m = len(retained)
        # Pad to the bucket, as the reference does.
        bucket = next((x for x in self.buckets if m <= x), self.buckets[-1])
        payloads = np.stack([ev.value for ev in retained])
        if bucket > m:
            pad = np.zeros((bucket - m, *payloads.shape[1:]), payloads.dtype)
            payloads = np.concatenate([payloads, pad])
        if self._query_block is None:
            out = _to_host(self.step_fn(payloads))
        else:
            # Query-major fused step: every live query rides one device call
            # (the block is bucket-padded and device-resident; see
            # set_queries), the serving analogue of the sim plane's
            # cross-query reid_match_multi dispatch.
            out = _to_host(self.step_fn(payloads, self._query_block, self._nq))
        end = self.clock()
        exec_dur = end - now
        self.stats["executed"] += m
        self.stats["batches"] += 1
        batch_queries = set()
        executed_q: Dict[int, int] = {}
        for ev in retained:
            qid = q_of.pop(ev.event_id, None)
            if qid is not None:
                executed_q[ev.event_id] = qid
                qs = self._qstat(qid)
                qs["executed"] += 1
                if qid not in batch_queries:
                    batch_queries.add(qid)
                    qs["batches"] += 1
        for ev in retained:
            pe = pe_by_id[ev.event_id]
            u = pe.arrival - ev.header.source_arrival
            q = now - pe.arrival
            pi = q + exec_dur
            self.budget.record(
                ev.event_id, EventRecord(departure=u + pi, queuing=q, batch_size=m, xi=exec_dur)
            )
            idx = retained.index(ev)
            row = _row(out, idx)
            if self.drops_enabled and drop_before_transmit(
                0.0, u, pi, beta, avoid_drop=ev.header.avoid_drop
            ):
                self.stats["dropped"] += 1
                self.stats["dropped_dp3"] += 1
                qid = executed_q.get(ev.event_id)
                if qid is not None:
                    qst = self._qstat(qid)
                    qst["dropped"] += 1
                    qst["dropped_dp3"] += 1
                self._reject_upstream(ev.event_id, u + pi - beta, ev.header.q_bar)
                results.append(StageResult(ev.event_id, None, u + pi, m, dropped=True))
            else:
                results.append(StageResult(ev.event_id, row, u + pi, m))
        return results


# --------------------------------------------------------------------- #
# App-compiler lowering: TrackingApp + DeploymentSpec -> ServedStages    #
# --------------------------------------------------------------------- #
def lower_stage(
    module: str,
    app,
    deployment,
    step_fn: Callable[[np.ndarray], Any],
    *,
    payload_shape: Optional[Sequence[int]] = None,
    buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
    clock: Callable[[], float] = time.monotonic,
    device: Union[str, torch.device] = "cuda",
) -> ServedStage:
    """Lower one module (``"VA"`` or ``"CR"``) of ``app`` onto a
    :class:`ServedStage` wrapping ``step_fn``.

    The stage's knobs come from the same spec resolution the discrete-event
    compiler uses (``repro_torch.core.compile.resolve_module``): the app's
    per-module :class:`~repro_torch.core.dataflow.ModuleSpec` overrides merged
    over the :class:`~repro_torch.core.compile.DeploymentSpec` defaults.  The
    cost model priority is spec ``xi`` -> measured :func:`calibrate_xi`
    (requires ``payload_shape``) — calibration replaces the paper's offline
    benchmarking table.  Serving batches through the dynamic deadline
    batcher only; a spec pinning ``static``/``nob`` batching is rejected
    rather than silently ignored.
    """
    from repro_torch.core.compile import _zero_xi, resolve_module

    spec = resolve_module(app, deployment, module)
    if spec.batching != "dynamic":
        raise ValueError(
            f"serving lowers only dynamic batching; {module} spec pins "
            f"{spec.batching!r}"
        )
    xi = spec.xi
    if xi is _zero_xi:
        # Neither the app nor the deployment pinned a cost model (an
        # *explicit* zero xi is honored as "free"): measure the compiled
        # step itself.
        if payload_shape is None:
            raise ValueError(
                f"{module} spec carries no xi cost model; pass payload_shape "
                "so lower_stage can calibrate one from the compiled step"
            )
        xi = calibrate_xi(step_fn, payload_shape, buckets=buckets)
    return ServedStage(
        f"{app.name}/{module}",
        step_fn,
        xi,
        gamma=app.gamma,
        m_max=spec.m_max,
        buckets=buckets,
        drops_enabled=deployment.drops_enabled,
        clock=clock,
        device=device,
    )


def lower_app_stages(
    app,
    deployment,
    step_fns: Dict[str, Callable[[np.ndarray], Any]],
    *,
    payload_shapes: Optional[Dict[str, Sequence[int]]] = None,
    buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
    clock: Callable[[], float] = time.monotonic,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, "ServedStage"]:
    """Lower an app's compute modules onto serving stages.

    ``step_fns`` maps module names (``"VA"``/``"CR"``) to batched torch
    steps; the returned dict maps the same names to configured
    :class:`ServedStage` instances.  Downstream accept/reject signals are
    chained VA <- CR automatically (a CR-side drop rejects into the VA
    budget, mirroring the pipeline's path-based signal delivery).
    """
    payload_shapes = payload_shapes or {}
    stages = {
        module: lower_stage(
            module,
            app,
            deployment,
            fn,
            payload_shape=payload_shapes.get(module),
            buckets=buckets,
            clock=clock,
            device=device,
        )
        for module, fn in step_fns.items()
    }
    va, cr = stages.get("VA"), stages.get("CR")
    if va is not None and cr is not None:
        cr.upstream = va  # CR-side drops reject into the VA budget
    return stages
