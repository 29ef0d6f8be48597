"""App compiler: lower a :class:`~repro_torch.core.dataflow.TrackingApp` onto the
pipeline runtime (paper §2.3/§3 — "the platform does the wiring").

The paper's programming model makes the *application spec* the deployable
artifact: the user composes FC/VA/CR/TL/QF logics (plus per-module
:class:`~repro_torch.core.dataflow.ModuleSpec` overrides) and the platform turns
that into a placed, batched, budgeted pipeline.  This module is that
lowering for the discrete-event plane:

    compile_app(app, world, deployment, sim)  ->  CompiledApp

* **Spec resolution** — :func:`resolve_module` merges the app's per-module
  overrides over the :class:`DeploymentSpec` platform defaults (replicas,
  tier, batcher, ``m_max``, cost model), so both hand-written Table-1 apps
  and ``ScenarioConfig.to_app()`` presets flow through one path.
* **Task DAG** — VA/CR replicas are placed round-robin over the compute
  nodes (with per-node clock skews), FC tasks are materialized lazily per
  camera on edge hosts, and the UV sink closes the loop.  When the FC logic
  is the stateless ``fc_is_active`` (and drops are off, the network static,
  and the frame period exceeds ``xi_fc(1)``) the whole FC stage is *fused*
  into the source: the driver asks the compiled app for each frame's entry
  plan instead of paying a per-camera Task hop.
* **DSL adaptation** — user logics speak the keyed DSL signatures
  (``va(camera_id, frames, state) -> [(key, value)]``); Tasks speak
  ``logic(events, state) -> events``.  The adapters preserve event identity
  for 1:1 transforms (keeping the runtime's allocation-free header fast
  paths — and bit-identical trajectories for the scenario presets), group
  contiguous same-camera runs so batched analytics see per-camera frame
  lists without reordering the batch, and support fan-out/fan-in
  selectivity by positional matching.
* **QF feedback edge** (§2.2.5) — positive detections reaching the sink are
  fed to the app's QF logic; a fused query is pushed to every VA/CR task's
  ``state['entity_query']`` after one control-network latency, exactly like
  TL activation control.  Apps without QF compile to the identical DAG the
  scenario always built.

The serving plane shares the same spec resolution:
:func:`repro_torch.serving.scheduler.lower_app_stages` lowers VA/CR onto
jit-compiled :class:`~repro_torch.serving.scheduler.ServedStage`\\ s.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from .batching import DynamicBatcher, NOBBatcher, StaticBatcher
from .budget import TaskBudget
from .clock import Clock
from .dataflow import (
    BATCHING_STRATEGIES,
    CRLogic,
    FCLogic,
    ModuleSpec,
    QFLogic,
    TrackingApp,
    VALogic,
    fc_is_active,
)
from .events import Event
from .pipeline import Scheduler, SinkTask, Task
from .tracking import Detection

__all__ = [
    "DeploymentSpec",
    "ResolvedModule",
    "CompiledApp",
    "compile_app",
    "resolve_module",
    "linear_xi",
    "MODULES",
]

#: The fixed module universe of the dataflow (paper Fig. 2).  TL/UV have no
#: per-replica deployment: TL is the control plane, UV the singleton sink.
MODULES = ("FC", "VA", "CR", "QF", "UV")


def linear_xi(c0: float, c1: float) -> Callable[[int], float]:
    """Affine batch cost model ``xi(b) = c0 + c1 * b`` (monotone, amortizes
    the fixed model-invocation overhead — paper §2.2.2)."""

    def xi(b: int) -> float:
        return c0 + c1 * max(int(b), 0)

    return xi


def _zero_xi(b: int) -> float:
    return 0.0


# --------------------------------------------------------------------- #
# Deployment + spec resolution                                           #
# --------------------------------------------------------------------- #
@dataclass
class DeploymentSpec:
    """Platform-side deployment: everything the operator (not the app
    author) decides.  Absorbs the historical ``num_va`` / ``va_cost`` /
    ``batching`` scatter of ``ScenarioConfig`` into one declarative object.

    ``modules`` holds the platform *defaults* per module type; an app's own
    ``specs`` override them field-by-field (``None`` fields inherit).
    """

    num_nodes: int = 10
    modules: Dict[str, ModuleSpec] = field(default_factory=dict)
    drops_enabled: bool = False
    avoid_drop_positives: bool = False
    epsilon_max: float = 1.0
    node_clock_skews: Optional[Sequence[float]] = None

    def __post_init__(self) -> None:
        if int(self.num_nodes) < 1:
            raise ValueError(f"num_nodes must be >= 1, got {self.num_nodes!r}")
        for name in self.modules:
            if name not in MODULES:
                raise ValueError(f"unknown module {name!r}; expected one of {MODULES}")

    def skews(self) -> List[float]:
        out = list(self.node_clock_skews or [])
        if len(out) < self.num_nodes:
            out += [0.0] * (self.num_nodes - len(out))
        return out


# Global fallbacks applied when neither the app nor the deployment pins a
# field (tier per paper §2.2: FC at the edge, VA on fog nodes, CR in cloud).
_TIER_DEFAULT = {"FC": "edge", "VA": "fog", "CR": "cloud", "QF": "cloud", "UV": "cloud"}


@dataclass(frozen=True)
class ResolvedModule:
    """A fully-resolved module deployment: no ``None`` fields left."""

    name: str
    instances: int
    resource_tier: str
    m_max: int
    batching: str
    static_batch: int
    xi: Callable[[int], float]

    def make_batcher(self):
        if self.batching == "dynamic":
            return DynamicBatcher(self.xi, m_max=self.m_max)
        if self.batching == "static":
            return StaticBatcher(self.xi, batch_size=self.static_batch)
        if self.batching == "nob":
            return NOBBatcher(self.xi, m_max=self.m_max)
        raise ValueError(f"unknown batching {self.batching!r}")  # pragma: no cover


def _pick(*values):
    for v in values:
        if v is not None:
            return v
    return None


def resolve_module(
    app: TrackingApp, deployment: DeploymentSpec, module: str
) -> ResolvedModule:
    """Merge ``app.specs[module]`` over ``deployment.modules[module]`` over
    the global defaults, field by field (``None`` inherits)."""
    a = app.specs.get(module, ModuleSpec())
    d = deployment.modules.get(module, ModuleSpec())
    batching = _pick(a.batching, d.batching, "dynamic")
    if batching not in BATCHING_STRATEGIES:  # pragma: no cover - ModuleSpec validates
        raise ValueError(f"unknown batching {batching!r}")
    return ResolvedModule(
        name=module,
        instances=int(_pick(a.instances, d.instances, 1)),
        resource_tier=_pick(a.resource_tier, d.resource_tier, _TIER_DEFAULT.get(module, "fog")),
        m_max=int(_pick(a.m_max, d.m_max, 25)),
        batching=batching,
        static_batch=int(_pick(a.static_batch, d.static_batch, 1)),
        xi=_pick(a.xi, d.xi, _zero_xi),
    )


# --------------------------------------------------------------------- #
# DSL -> Task logic adapters                                             #
# --------------------------------------------------------------------- #
def _flag_avoid_drop_inputs(events: List[Event]) -> None:
    """Edge-side candidate filter (§4.3.3): ground-truth positives are
    flagged un-droppable when the deployment asks for it."""
    for ev in events:
        if getattr(ev.value, "has_entity", False):
            ev.header.avoid_drop = True


def _apply_keyed(
    logic_fn: Callable[[Any, Sequence[Any], Dict], List[Tuple[Any, Any]]],
    events: List[Event],
    state: Dict[str, Any],
) -> List[Event]:
    """Run a keyed DSL logic over a Task batch.

    Events are chunked into contiguous same-key runs (so the logic sees
    per-camera frame lists, per the VA/CR contract) **without reordering the
    batch** — order determines downstream arrival interleaving and any
    stateful randomness in the logic, and must survive the lowering intact.

    Output attribution is **positional, not causal** (the logic is opaque):
    a 1:1 pair list maps pair *i* onto input event *i*, reusing the event
    object (the runtime's allocation-free header path); when a value is
    *transformed* the upstream ``batch_slowest`` mark is cleared so the
    runtime re-marks this stage's slowest.  To *filter*, a logic emits
    ``None`` in an input's position (the event ends here, its header
    intact) — returning a compacted shorter list instead would silently
    marry the surviving values to the wrong events' headers.  Lists of any
    other length still match positionally: missing tails are filtered,
    surplus pairs are emitted as new events sharing the run's last header
    (the runtime forks headers for multi-output events).
    """
    outputs: List[Event] = []
    i, n = 0, len(events)
    while i < n:
        j = i + 1
        key = events[i].key
        while j < n and events[j].key == key:
            j += 1
        run = events[i:j]
        i = j
        pairs = logic_fn(key, [ev.value for ev in run], state)
        if pairs is None:
            continue
        if len(pairs) == len(run):
            for ev, pair in zip(run, pairs):
                if pair is None:  # filtered: this input's flow ends here
                    continue
                k, v = pair
                if v is not ev.value:
                    ev.batch_slowest = False
                ev.key = k
                ev.value = v
                outputs.append(ev)
        else:
            last = len(run) - 1
            for idx, (k, v) in enumerate(pairs):
                if idx <= last:
                    ev = run[idx]
                    if v is not ev.value:
                        ev.batch_slowest = False
                    ev.key = k
                    ev.value = v
                else:
                    ev = Event(header=run[last].header, key=k, value=v)
                    ev.batch_slowest = False
                outputs.append(ev)
    return outputs


def _adapt_fc(fc: FCLogic, avoid_drop_positives: bool):
    """``fc(frame, state) -> bool`` as Task logic: filter, then flag."""
    inner = _event_level(fc)

    def logic(events: List[Event], state: Dict[str, Any]) -> List[Event]:
        if inner is not None:
            out = inner(events, state)
        else:
            out = [ev for ev in events if fc(ev.value, state)]
        if avoid_drop_positives:
            _flag_avoid_drop_inputs(out)
        return out

    return logic


def _event_level(dsl_logic) -> Optional[Callable[[List[Event], Dict], List[Event]]]:
    """Lowering override: a DSL logic may carry a ``task_logic`` attribute —
    an event-level ``(events, state) -> events`` implementing the same
    transform without the keyed-adapter round trip.  The pipeline runs the
    module logic once per event on the hot path, so performance-critical
    logics (the scenario presets, custom kernels) supply one; everything
    else goes through :func:`_apply_keyed`.  The override owns event
    identity and ``batch_slowest`` hygiene exactly like a transform run
    through the adapter would."""
    return getattr(dsl_logic, "task_logic", None)


def _adapt_va(
    va: VALogic,
    avoid_drop_positives: bool,
    batch_hook: Optional[Callable[[List[Event], Dict], None]] = None,
):
    """``va(camera_id, frames, state)`` as Task logic.  ``batch_hook`` runs
    first over the whole Task batch (e.g. the scenario's bucket-batched
    re-ID instrumentation)."""
    inner = _event_level(va)

    def logic(events: List[Event], state: Dict[str, Any]) -> List[Event]:
        if batch_hook is not None:
            batch_hook(events, state)
        if avoid_drop_positives:
            _flag_avoid_drop_inputs(events)
        if inner is not None:
            return inner(events, state)
        return _apply_keyed(va, events, state)

    return logic


def _adapt_cr(cr: CRLogic, avoid_drop_positives: bool):
    """``cr(camera_id, values, state)`` as Task logic.  Avoid-drop is based
    on the *verdict* (``.positive`` outputs), matching §4.3.3: only frames
    the analytics judged positive are shielded from the drop points."""
    inner = _event_level(cr)

    def logic(events: List[Event], state: Dict[str, Any]) -> List[Event]:
        outputs = (
            inner(events, state)
            if inner is not None
            else _apply_keyed(cr, events, state)
        )
        if avoid_drop_positives:
            for ev in outputs:
                if _verdict_positive(ev.value):
                    ev.header.avoid_drop = True
        return outputs

    return logic


def _verdict_positive(value: Any) -> bool:
    """Is a CR output a positive sighting?  ``Detection`` values carry it
    explicitly; bare verdicts (``bool`` from ``make_cr``) are their own
    truth value — the same interpretation :func:`as_detection` applies at
    the sink, so the avoid-drop shield and the TL/QF planes agree."""
    positive = getattr(value, "positive", None)
    return bool(value) if positive is None else bool(positive)


def as_detection(ev: Event) -> Detection:
    """Coerce a sink event into a :class:`Detection` for the TL/QF planes.

    Scenario presets emit :class:`Detection` values directly; hand-written
    CR logics may emit bare verdicts (e.g. ``bool`` from ``make_cr``), which
    are interpreted against the event's camera key and source time.
    """
    v = ev.value
    if isinstance(v, Detection):
        return v
    return Detection(
        camera_id=ev.key,
        positive=_verdict_positive(v),
        timestamp=ev.header.source_arrival,
    )


# --------------------------------------------------------------------- #
# The compiled artifact                                                  #
# --------------------------------------------------------------------- #
class CompiledApp:
    """A :class:`TrackingApp` lowered onto a Task DAG (built by
    :func:`compile_app`; driven by ``repro_torch.sim.scenario.TrackingScenario``).

    Owns the module instances (``va_tasks`` / ``cr_tasks`` / lazy
    ``fc_tasks`` + the ``sink``), the FC activation mirror (``fc_active``),
    the fused-FC source plane, and the QF feedback edge.  The driver owns
    time: it sources frames, ticks TL, and reads results.
    """

    def __init__(
        self,
        app: TrackingApp,
        deployment: DeploymentSpec,
        sim: Scheduler,
        *,
        fps: float,
        camera_vertices: Dict[int, int],
        on_detection: Optional[Callable[[Event, float], None]] = None,
        va_batch_hook: Optional[Callable[[List[Event], Dict], None]] = None,
        sink_recycle_headers: bool = False,
    ) -> None:
        self.app = app
        self.deployment = deployment
        self.sim = sim
        self.fps = float(fps)
        self.camera_vertices = camera_vertices
        self.on_detection = on_detection
        self._va_batch_hook = va_batch_hook
        self._sink_recycle_headers = sink_recycle_headers

        self.fc_spec = resolve_module(app, deployment, "FC")
        self.va_spec = resolve_module(app, deployment, "VA")
        self.cr_spec = resolve_module(app, deployment, "CR")

        #: Activation mirror: the FC states that are *currently* active
        #: (control latency applied), kept O(active) for the source loop.
        self.fc_active: Set[int] = set()
        self.fc_tasks: Dict[int, Task] = {}
        self.va_tasks: List[Task] = []
        self.cr_tasks: List[Task] = []
        self.sink: Optional[SinkTask] = None

        # QF state (entity query + whatever the QF logic accumulates).
        self.qf_state: Dict[str, Any] = {"entity_query": app.entity_query}
        self.query_pushes = 0
        # Multi-query tenancy (repro_torch.query): one drop observer shared by
        # every task of the DAG — including FCs materialized after
        # install_drop_hook() was called (see make_fc).
        self._drop_hook: Optional[Callable[[Event, int, float], None]] = None
        # Observability plane: one duck-typed span tracer shared by every
        # task (incl. the sink and lazily-built FCs) — see install_tracer.
        self._tracer = None

        self._build()

    # ------------------------------------------------------------------ #
    def _control_latency(self) -> float:
        net = getattr(self.sim, "network", None)
        return getattr(net, "man_latency_s", 0.0) if net is not None else 0.0

    def _build(self) -> None:
        app, deployment, sim = self.app, self.deployment, self.sim
        skews = deployment.skews()
        num_nodes = deployment.num_nodes
        drops = deployment.drops_enabled

        on_event = self._on_sink_event if app.qf is not None else self.on_detection
        self.sink = SinkTask(
            "UV",
            sim,
            gamma=app.gamma,
            epsilon_max=deployment.epsilon_max,
            on_event=on_event,
            clock=Clock(0.0),  # kappa_n == kappa_1 (§4.6.2)
            node="head",
            # Budgets are only consulted by the drop points; skip the accept
            # machinery entirely in no-drop runs.
            learn_budgets=drops,
            # QF only ever sees Detection values (never the event or its
            # header), so recycling stays safe when the driver opted in.
            recycle_headers=self._sink_recycle_headers,
        )
        sim.host_of["UV"] = "head"

        cr_xi = self.cr_spec.xi
        cr_logic = _adapt_cr(app.cr, deployment.avoid_drop_positives)
        transit_static = getattr(sim, "transit_is_static", False)
        # Compute perturbations (dynamism plane) make actual execution
        # durations time-varying; the fused fast paths precompute them, so
        # fusion is only sound when xi is static too.  One predicate for
        # every fusion site, including the lazily-built FCs (make_fc).
        fuse_ok = self._fuse_ok = transit_static and getattr(sim, "xi_is_static", True)
        for i in range(self.cr_spec.instances):
            node = f"node{i % num_nodes}"
            t = Task(
                f"CR-{i}",
                sim,
                cr_xi,
                self.cr_spec.make_batcher(),
                logic=cr_logic,
                clock=Clock(skews[i % num_nodes]),
                budget=TaskBudget(f"CR-{i}", cr_xi, m_max=self.cr_spec.m_max),
                drops_enabled=drops,
                node=node,
            )
            t.module = "CR"
            t.output_event_bytes = 256.0  # metadata only (§2.2.3)
            t.connect(self.sink)
            t.partitioner = _constant_partitioner("UV")
            # CR logic has no completion-time state reads (control updates —
            # TL activation and QF query pushes — land one MAN latency after
            # their trigger, slower than xi(1)): safe to fuse its streaming
            # (b=1) executions with the outbound transit.
            t.fuse_streaming = not drops and fuse_ok
            t.state["entity_query"] = app.entity_query
            self.cr_tasks.append(t)
            sim.host_of[t.name] = node

        va_xi = self.va_spec.xi
        va_logic = _adapt_va(
            app.va, deployment.avoid_drop_positives, self._va_batch_hook
        )
        # Keys are camera ids, a small fixed universe: precompute the
        # routing table instead of formatting a string per event.
        self._cr_route = {
            cam: f"CR-{hash(cam) % self.cr_spec.instances}"
            for cam in self.camera_vertices
        }
        for i in range(self.va_spec.instances):
            node = f"node{i % num_nodes}"
            t = Task(
                f"VA-{i}",
                sim,
                va_xi,
                self.va_spec.make_batcher(),
                logic=va_logic,
                clock=Clock(skews[i % num_nodes]),
                budget=TaskBudget(f"VA-{i}", va_xi, m_max=self.va_spec.m_max),
                drops_enabled=drops,
                node=node,
            )
            t.module = "VA"
            for cr in self.cr_tasks:
                t.connect(cr)
            t.partitioner = _table_partitioner(self._cr_route)
            t.fuse_streaming = not drops and fuse_ok
            t.state["entity_query"] = app.entity_query
            self.va_tasks.append(t)
            sim.host_of[t.name] = node

        # FC tasks are created lazily: a 10k-camera scenario with a spotlight
        # TL only ever activates a small moving subset, so building a Task
        # (+ its budget, batcher, wiring) per camera upfront dominated
        # construction time.  `make_fc` is called on first activation or
        # first sourced frame.
        self._fc_xi = self.fc_spec.xi
        self.fc_xi1 = self._fc_xi(1)
        self._fc_logic = _adapt_fc(app.fc, deployment.avoid_drop_positives)
        # Full FC fusion: with a stateless pass-through FC logic, drops off,
        # a static network and a frame period longer than xi_fc(1), the FC
        # stage reduces exactly to "arrive at the VA at t + xi_fc(1) +
        # transit with xi_bar advanced" — the per-camera Task machinery is
        # bypassed wholesale.  Stateful FC logics (frame-rate subsampling)
        # and drops-enabled or dynamic-bandwidth deployments keep real FCs.
        self.fuse_fc = (
            app.fc is fc_is_active
            and not drops
            and fuse_ok
            and self.fps > 0
            and 1.0 / self.fps > self.fc_xi1
        )
        if self.fuse_fc:
            # All FC->VA transits are edge-host -> compute-node MAN hops with
            # the same payload size: one delay for every camera.
            net = getattr(sim, "network", None)
            if net is None:
                self.fuse_fc = False
            else:
                self.fc_transit = net.transit_delay("edge*", "node*", 2900.0, 0.0)
                self.va_of = {
                    cam: self.va_tasks[hash(cam) % self.va_spec.instances]
                    for cam in self.camera_vertices
                }

    # ------------------------------------------------------------------ #
    # FC plane                                                            #
    # ------------------------------------------------------------------ #
    def make_fc(self, cam: int) -> Task:
        sim = self.sim
        # FC co-located with the camera on an edge host; the downstream VA
        # is fixed by camera id (paper: FCs scheduled round-robin).
        fc_xi = self._fc_xi
        t = Task(
            f"FC-{cam}",
            sim,
            fc_xi,
            StaticBatcher(fc_xi, batch_size=1),  # FC logic is simple/edge
            logic=self._fc_logic,
            clock=Clock(0.0),  # source clock kappa_1
            budget=TaskBudget(f"FC-{cam}", fc_xi, m_max=1),
            drops_enabled=self.deployment.drops_enabled,
            node=f"edge{cam}",
        )
        t.module = "FC"
        for va in self.va_tasks:
            t.connect(va)
        # Each FC has a fixed key (its camera), so its destination VA is
        # a constant.
        t.partitioner = _constant_partitioner(
            f"VA-{hash(cam) % self.va_spec.instances}"
        )
        t.state["isActive"] = cam in self.fc_active
        # FC control updates land >= man_latency after a tick while xi(1) is
        # sub-millisecond, so arrival-time state reads match finish-time
        # reads: safe to fuse the execute+transmit hops (see pipeline.py).
        t.fuse_streaming = not self.deployment.drops_enabled and self._fuse_ok
        t.on_drop_hook = self._drop_hook
        t.tracer = self._tracer
        self.fc_tasks[cam] = t
        sim.host_of[t.name] = f"edge{cam}"
        return t

    def set_fc_active(self, cam: int, want: bool) -> None:
        """Control-event delivery (the driver schedules this one control
        latency after a TL tick)."""
        if self.fuse_fc:
            # Fused FC mode keeps no per-camera tasks; the mirror set is the
            # entire FC state.
            if want:
                self.fc_active.add(cam)
            else:
                self.fc_active.discard(cam)
            return
        if want:
            fc = self.fc_tasks.get(cam)
            if fc is None:
                self.fc_active.add(cam)  # make_fc reads the mirror
                self.make_fc(cam)
            else:
                fc.state["isActive"] = True
                self.fc_active.add(cam)
        else:
            fc = self.fc_tasks.get(cam)
            if fc is not None:
                fc.state["isActive"] = False
            self.fc_active.discard(cam)

    # ------------------------------------------------------------------ #
    # QF feedback edge (§2.2.5): CR -> QF -> VA/CR query update           #
    # ------------------------------------------------------------------ #
    def _on_sink_event(self, ev: Event, now: float) -> None:
        det = as_detection(ev)
        # Coerce once: downstream consumers (the driver's detection
        # bookkeeping, QF) all see the Detection view of the verdict.
        ev.value = det
        if self.on_detection is not None:
            self.on_detection(ev, now)
        if det.positive:
            fused = self.app.qf([det], self.qf_state)
            if fused is not None and fused is not self.qf_state.get("entity_query"):
                # Control push, same plane as TL activation: the new query
                # reaches every VA/CR instance one MAN latency later.
                self.sim.schedule(self._control_latency(), self._apply_query, fused)

    def _apply_query(self, query: Any) -> None:
        self.qf_state["entity_query"] = query
        self.query_pushes += 1
        for t in self.va_tasks:
            t.state["entity_query"] = query
        for t in self.cr_tasks:
            t.state["entity_query"] = query

    # ------------------------------------------------------------------ #
    # Multi-query tenancy: per-query drop charging                        #
    # ------------------------------------------------------------------ #
    def install_drop_hook(
        self, hook: Optional[Callable[[Event, int, float], None]]
    ) -> None:
        """Install ``hook(ev, point, epsilon)`` on every task of the DAG
        (and every FC materialized later), fired once per dropped event at
        each of the three drop points.  The query plane uses it to charge
        drops to each query tagged on the event's ``query_mask`` — per
        query, not globally.  Pass ``None`` to uninstall."""
        self._drop_hook = hook
        for t in self.all_tasks():
            t.on_drop_hook = hook

    # ------------------------------------------------------------------ #
    # Observability plane: span tracing                                   #
    # ------------------------------------------------------------------ #
    def install_tracer(self, tracer) -> None:
        """Install a duck-typed span tracer (``repro_torch.obs.tracing.
        EventTracer``-shaped) on every task of the DAG, the sink, and every
        FC materialized later — same propagation contract as
        ``install_drop_hook``.  Pass ``None`` to uninstall.  Tracing
        samples on the tracer's id stride, so the per-event cost with a
        tracer installed is one attribute test plus the sampled hook; with
        ``None`` (the default) the hot path is unchanged."""
        self._tracer = tracer
        for t in self.all_tasks():
            t.tracer = tracer
        if self.sink is not None:
            self.sink.tracer = tracer

    # ------------------------------------------------------------------ #
    # Telemetry (dynamism plane)                                          #
    # ------------------------------------------------------------------ #
    def sample_telemetry(self, trace) -> None:
        """Append one sample per VA/CR task (and the sink) to a
        ``repro_torch.sim.dynamism.DynamismTrace``-shaped recorder, plus one
        aggregate ``FC*`` row over the lazy FC plane (a per-camera series
        would be 10k columns).  Called by the driver's telemetry tick on a
        fixed cadence — never from the per-event hot path."""
        for t in self.va_tasks:
            trace.sample_task(t)
        for t in self.cr_tasks:
            trace.sample_task(t)
        trace.sample_task(self.sink)
        trace.sample_aggregate("FC*", self.fc_tasks.values())

    # ------------------------------------------------------------------ #
    # Results                                                             #
    # ------------------------------------------------------------------ #
    def all_tasks(self) -> List[Task]:
        return list(self.va_tasks) + list(self.cr_tasks) + list(self.fc_tasks.values())

    # ------------------------------------------------------------------ #
    # Serving-plane durability (repro_torch.serving.journal)                    #
    # ------------------------------------------------------------------ #
    _SNAP_STATS = (
        "arrived",
        "dropped_dp1",
        "dropped_dp2",
        "dropped_dp3",
        "dropped_fault",
        "executed",
        "batches",
        "probes",
        "accepts_rx",
        "rejects_rx",
    )

    def snapshot(self) -> Dict[str, float]:
        """Flat ``str -> float`` frontier of the compiled pipeline: every
        task's cumulative counters + its min completion budget, plus the
        sink's ledger.  Keys are deterministic for a deterministic run —
        lazily-materialized FCs appear exactly when a replay would
        materialize them — so two bit-identical runs produce bit-identical
        snapshots (the journal's restore contract)."""
        snap: Dict[str, float] = {}
        for t in self.all_tasks():
            s, p = t.stats, f"task::{t.name}"
            for name in self._SNAP_STATS:
                snap[f"{p}::{name}"] = float(getattr(s, name))
            snap[f"{p}::beta"] = float(t.budget.min_budget())
        sink = self.sink
        snap["sink::arrived"] = float(sink.stats.arrived)
        snap["sink::on_time"] = float(sink.on_time)
        snap["sink::delayed"] = float(sink.delayed)
        snap["sink::probes_seen"] = float(sink.probes_seen)
        snap["query_pushes"] = float(self.query_pushes)
        return snap

    def restore(self, snap: Dict[str, float]) -> "CompiledApp":
        """Verify this app's replayed state bit-matches ``snap``.

        The simulation is deterministic in (config, spec, seed), so restore
        is replay-based: the scenario rebuilds from inputs and re-runs to
        the snapshot's timestamp — this gate then proves the reconstructed
        frontier equals the journalled one exactly (``RestoreMismatch``
        lists every differing key otherwise) rather than silently trusting
        the replay."""
        raise NotImplementedError(
            "CompiledApp.restore needs the serving journal, which the port "
            "has not carried over yet (queued after the multi-query and "
            "mega-step slices)"
        )

    def drops_by_task(self) -> Dict[str, int]:
        return {t.name: t.stats.dropped for t in self.all_tasks() if t.stats.dropped}

    def batch_sizes(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {"VA": [], "CR": []}
        for t in self.va_tasks:
            out["VA"].extend(t.stats.batch_sizes)
        for t in self.cr_tasks:
            out["CR"].extend(t.stats.batch_sizes)
        return out


def _constant_partitioner(name: str) -> Callable[[Event], str]:
    def partition(ev: Event) -> str:
        return name

    return partition


def _table_partitioner(table: Dict) -> Callable[[Event], str]:
    def partition(ev: Event) -> str:
        return table[ev.key]

    return partition


# --------------------------------------------------------------------- #
# Front door                                                             #
# --------------------------------------------------------------------- #
def compile_app(
    app: TrackingApp,
    world: Any,
    deployment: Optional[DeploymentSpec] = None,
    sim: Optional[Scheduler] = None,
    *,
    cameras: Any = None,
    on_detection: Optional[Callable[[Event, float], None]] = None,
    va_batch_hook: Optional[Callable[[List[Event], Dict], None]] = None,
    sink_recycle_headers: bool = False,
    verify: Optional[bool] = None,
) -> CompiledApp:
    """Lower ``app`` onto a pipeline over ``world``'s cameras.

    ``world`` is a ``repro_torch.sim.world.WorldBundle`` (or anything exposing
    ``.cameras.camera_vertices`` and, optionally, ``.key.fps``); ``cameras``
    overrides the world's camera network (scenarios with stateful embedding
    RNGs rebuild theirs).  ``sim`` is the discrete-event scheduler the Tasks
    run on; the driver owning real time must supply it.  ``on_detection``
    receives every sink event; ``va_batch_hook`` runs over each VA batch
    before the app's VA logic (instrumentation, e.g. batched re-ID).
    ``compile_app`` performs no simulation itself — the returned
    :class:`CompiledApp` is driven by ``TrackingScenario`` (or any caller
    that sources frames and ticks TL).

    ``verify=True`` (or ``REPRO_ANALYSIS_VERIFY=1`` in the environment)
    runs the replay-safety graph verifier over the lowered DAG and raises
    :class:`repro_torch.analysis.GraphContractError` on a miswired app — the
    compile-time half of the bit-exactness contract.
    """
    if sim is None:
        raise ValueError(
            "compile_app needs a Scheduler (e.g. repro_torch.sim.DiscreteEventSimulator)"
        )
    deployment = deployment or DeploymentSpec()
    cams = cameras if cameras is not None else getattr(world, "cameras", None)
    if cams is None:
        raise ValueError("world must expose .cameras (or pass cameras=...)")
    key = getattr(world, "key", None)
    fps = float(getattr(key, "fps", 0.0) or getattr(cams, "fps", 0.0) or 0.0)
    compiled = CompiledApp(
        app,
        deployment,
        sim,
        fps=fps,
        camera_vertices=cams.camera_vertices,
        on_detection=on_detection,
        va_batch_hook=va_batch_hook,
        sink_recycle_headers=sink_recycle_headers,
    )
    if verify is None:
        # Cheap env probe (no analysis import unless the hook is on).
        verify = os.environ.get("REPRO_ANALYSIS_VERIFY", "") == "1"
    if verify:
        # The graph verifier lives in the analysis package, which the port
        # has not carried over yet; refuse rather than skip the check.
        raise NotImplementedError(
            "compile_app(verify=True) / REPRO_ANALYSIS_VERIFY=1 needs the "
            "replay-safety graph verifier, which the port has not carried "
            "over yet"
        )
    return compiled
