"""End-to-end tracking scenario: a thin driver over a compiled app.

The executable unit is a :class:`~repro_torch.core.dataflow.TrackingApp`: the app
compiler (:func:`repro_torch.core.compile.compile_app`) lowers it + a shared
:class:`~repro_torch.sim.world.WorldBundle` + a
:class:`~repro_torch.core.compile.DeploymentSpec` onto the Task DAG

    cameras --frames--> FC (one per camera, edge hosts)
      --> VA instances (hash by camera) --> CR instances --> UV sink
    UV --detections--> TL --(de)activate--> FC states      (feedback)
    UV --positives--> QF --fused query--> VA/CR states     (feedback)

and this module drives it: sources frames from the camera network, ticks
the TL control loop, applies activation/query control events after the
control-network latency, and assembles the :class:`ScenarioResult`.

:class:`ScenarioConfig` remains the historical knob surface (paper §5):
``to_app()`` turns it into the equivalent preset ``TrackingApp`` (FC
``isActive`` gate, pass-through VA, seeded-verdict CR, the ``tl:`` knob's
strategy) and ``deployment()`` into the matching ``DeploymentSpec`` —
``TrackingScenario(cfg)`` compiles and runs exactly the pipeline it always
did, bit-identically.  Custom apps run the same road:
``TrackingScenario(cfg, app=my_app, deployment=my_deployment)``.

Execution times are charged through each module's resolved ``xi(b)`` cost
model (calibrated to the paper: CR ~120 ms/event streaming for App 1, ~63%
more for App 2), network transits through :class:`NetworkModel`, and all of
the paper's knobs are exposed: batching strategy, drops on/off, TL
strategy, entity peak speed ``es``, bandwidth schedule, clock skews.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.compile import (
    CompiledApp,
    DeploymentSpec,
    as_detection,
    compile_app,
    linear_xi,
    resolve_module,
)
from repro_torch.core.dataflow import ModuleSpec, TrackingApp, fc_is_active
from repro_torch.core.events import Event, new_event_id, source_header
from repro_torch.core.pipeline import Task
from repro_torch._device import resolve_device
from repro_torch.core.tracking import (
    Detection,
    TLBFS,
    TLBase,
    TLProbabilistic,
    TLWBFS,
    TrackingLogic,
)
from .cameras import CameraNetwork, Frame
from .dynamism import DynamismSpec, DynamismTrace
from .simulator import DiscreteEventSimulator, NetworkModel
from .world import WorldBundle, WorldKey, get_world

__all__ = [
    "ScenarioConfig",
    "ScenarioResult",
    "TrackingScenario",
    "linear_xi",
    "make_scenario_cr",
    "va_passthrough",
]


# --------------------------------------------------------------------- #
# Preset module logics (the historical hard-wired scenario pipeline,     #
# now expressed in the DSL so ScenarioConfig is just an app factory)     #
# --------------------------------------------------------------------- #
def va_passthrough(camera_id, frames, state):
    """Preset VA: object detection with 1:1 selectivity — every frame
    yields its candidate boxes; the payload travels unchanged (the synthetic
    frames already carry ground truth + optional embeddings)."""
    return [(camera_id, frame) for frame in frames]


# Lowering override (see repro_torch.core.compile._event_level): pass-through VA
# is the identity at event level — the compiler's hot path must not pay a
# keyed-adapter round trip per event for a no-op transform.
va_passthrough.task_logic = lambda events, state: events


def make_scenario_cr(seed: int, p_true_positive: float):
    """Preset CR: cross-camera re-id verdict per frame, 1:1, with the
    per-instance RNG stream the scenario always used (seeded ``seed + 101``
    in each CR task's state; consumed only on entity frames so the random
    stream is identical across refactors).

    Carries a ``task_logic`` lowering override: the event-level transform
    is the pipeline's hottest user code (once per event), and the override
    is the historical ``_cr_logic`` loop verbatim — event objects reused,
    upstream ``batch_slowest`` marks cleared on transform.
    """

    def cr(camera_id, frames, state):
        rng = state.get("rng")
        if rng is None:
            rng = state["rng"] = np.random.default_rng(seed + 101)
        out = []
        for frame in frames:
            positive = bool(frame.has_entity) and (
                float(rng.uniform()) <= p_true_positive
            )
            out.append(
                (
                    camera_id,
                    Detection(
                        camera_id=frame.camera_id,
                        positive=positive,
                        timestamp=frame.timestamp,
                    ),
                )
            )
        return out

    def cr_task_logic(events, state):
        rng = state.get("rng")
        if rng is None:
            rng = state["rng"] = np.random.default_rng(seed + 101)
        for ev in events:
            frame: Frame = ev.value
            # NB: the rng is consumed only on entity frames (short-circuit),
            # keeping the random stream identical across refactors.
            positive = bool(frame.has_entity) and (
                float(rng.uniform()) <= p_true_positive
            )
            # 1:1 transform: reuse the event object, swap the frame payload
            # for the CR verdict.  Clear the slowest-of-batch mark from the
            # upstream stage — the runtime re-marks this stage's slowest.
            ev.batch_slowest = False
            ev.value = Detection(
                camera_id=frame.camera_id, positive=positive, timestamp=frame.timestamp
            )
        return events

    cr.task_logic = cr_task_logic
    return cr


@dataclass
class ScenarioConfig:
    # Workload (paper §5.1)
    num_cameras: int = 1000
    duration_s: float = 600.0
    fps: float = 1.0
    entity_speed_mps: float = 1.0
    fov_radius_m: float = 6.0
    seed: int = 0
    # Road-network size.  None keeps the paper's 1000-vertex/2817-edge OSM
    # statistics (and grows the graph proportionally once ``num_cameras``
    # exceeds the vertex count, so 5k/10k-camera sweeps have a vertex per
    # camera).
    road_vertices: Optional[int] = None
    # QoS
    gamma: float = 15.0
    epsilon_max: float = 1.0
    # Tracking logic knob
    tl: str = "bfs"  # base | bfs | wbfs | prob
    tl_peak_speed: float = 4.0  # es (m/s)
    tl_update_period: float = 1.0
    tl_min_radius_m: float = 0.0
    # Batching knob
    batching: str = "dynamic"  # dynamic | static | nob
    static_batch: int = 1
    m_max: int = 25
    # Dropping knob
    drops_enabled: bool = False
    avoid_drop_positives: bool = False
    # Deployment (paper: 10 VA + 10 CR on 10 compute nodes)
    num_va: int = 10
    num_cr: int = 10
    num_nodes: int = 10
    # Cost models: (c0, c1) of xi(b) = c0 + c1 b, seconds.
    fc_cost: Tuple[float, float] = (0.0002, 0.0008)
    va_cost: Tuple[float, float] = (0.020, 0.010)
    # CR streaming cost xi(1) = 0.067 + 0.053 = 120 ms/event (App 1, §5.2.1);
    # batched capacity ~19 events/s (§5.2.3).
    cr_cost: Tuple[float, float] = (0.067, 0.053)
    # Detection model
    p_true_positive: float = 0.9
    # Network dynamics (Fig. 9): t -> bandwidth multiplier.
    bandwidth_schedule: Optional[Callable[[float], float]] = None
    # Clock skew per compute node (§4.6.2); source/sink stay at skew 0.
    node_clock_skews: Optional[Sequence[float]] = None
    # Shared immutable world (road + walk + cameras + transit tables).  When
    # None the scenario fetches it from the process-wide world cache; sweep
    # runners attach a prebuilt bundle so concurrent configs share one build.
    world: Optional[WorldBundle] = field(default=None, repr=False, compare=False)
    # Frame embeddings: 0 keeps the synthetic boolean frames; > 0 attaches a
    # per-frame embedding so VA runs the batched re-ID matcher on real
    # tensors (through repro_torch.kernels.dispatch, on ``device``).
    embed_dim: int = 0
    reid_threshold: float = 0.5
    # Dynamism plane (§4.3–§4.5, Figs. 7/9): composable seeded perturbations
    # (bandwidth collapse, compute stragglers, input spikes, camera churn)
    # plus per-task telemetry + ground-truth tracking quality.  None keeps
    # the scenario bit-identical to its undisturbed trajectory.
    dynamism: Optional[DynamismSpec] = None
    # Execution engine for the per-tick hot loop.  "interpreted" drives the
    # discrete-event pipeline tick by tick (the reference semantics);
    # "megastep" lowers eligible configs to the fused device-resident tick
    # engine (`repro_torch.core.megastep`), which executes frames -> VA -> CR ->
    # TL spotlight -> budget update for all queries and K ticks per dispatch
    # and must be bit-identical.  Ineligible configs (faults, dynamism,
    # non-static xi, ...) silently fall back to the interpreted pipeline.
    engine: str = "interpreted"
    # Observability plane (repro_torch.obs): optional span tracer installed on the
    # compiled pipeline (EventTracer duck type — on_arrival/on_drop/on_retry/
    # on_sink hooks).  Excluded from repr/compare so WorldKey hashing and
    # config equality (goldens, journal identity) are unaffected.
    tracer: Optional[Any] = field(default=None, repr=False, compare=False)
    # Torch device the VA re-ID matcher runs on ("cuda" by default; "cpu"
    # runs its plain version).  Like ``tracer`` it is excluded from
    # repr/compare, so it never reaches WorldKey hashing or summaries.
    device: str = field(default="cuda", repr=False, compare=False)

    # ------------------------------------------------------------------ #
    # App-compiler factories: the config is a preset-app description      #
    # ------------------------------------------------------------------ #
    def make_tl(self, road, camera_vertices: Dict[int, int]) -> TrackingLogic:
        """Instantiate the ``tl:`` knob's strategy over a road network."""
        kw = dict(
            entity_speed=self.tl_peak_speed,
            min_radius_m=self.tl_min_radius_m,
        )
        if self.tl == "base":
            return TLBase(road, camera_vertices, **kw)
        if self.tl == "bfs":
            return TLBFS(road, camera_vertices, fixed_edge_length_m=84.5, **kw)
        if self.tl == "wbfs":
            return TLWBFS(road, camera_vertices, **kw)
        if self.tl == "prob":
            return TLProbabilistic(road, camera_vertices, **kw)
        raise ValueError(f"unknown tl strategy {self.tl!r}")

    def to_app(
        self,
        world: Optional[WorldBundle] = None,
        cameras: Optional[CameraNetwork] = None,
    ) -> TrackingApp:
        """The preset :class:`TrackingApp` equivalent to this config's
        historical hard-wired pipeline: ``isActive``-gated FC, pass-through
        VA, seeded-verdict CR, the ``tl:`` knob's strategy, no QF.  Module
        instance counts, batching and cost models ride along as per-module
        :class:`ModuleSpec` overrides, so compiling this app against
        ``self.deployment()`` reproduces the scenario bit-identically."""
        if world is None:
            world = get_world(WorldKey.from_config(self))
        cams = cameras if cameras is not None else world.cameras
        return TrackingApp(
            name=f"scenario-{self.tl}",
            fc=fc_is_active,
            va=va_passthrough,
            cr=make_scenario_cr(self.seed, self.p_true_positive),
            tl=self.make_tl(world.road, cams.camera_vertices),
            qf=None,
            specs={
                "FC": ModuleSpec(xi=linear_xi(*self.fc_cost), resource_tier="edge"),
                "VA": ModuleSpec(
                    instances=self.num_va,
                    resource_tier="fog",
                    xi=linear_xi(*self.va_cost),
                    batching=self.batching,
                    static_batch=self.static_batch,
                    m_max=self.m_max,
                ),
                "CR": ModuleSpec(
                    instances=self.num_cr,
                    resource_tier="cloud",
                    xi=linear_xi(*self.cr_cost),
                    batching=self.batching,
                    static_batch=self.static_batch,
                    m_max=self.m_max,
                ),
            },
            gamma=self.gamma,
        )

    def deployment(self) -> DeploymentSpec:
        """The platform-side knobs of this config as a ``DeploymentSpec``."""
        return DeploymentSpec(
            num_nodes=self.num_nodes,
            drops_enabled=self.drops_enabled,
            avoid_drop_positives=self.avoid_drop_positives,
            epsilon_max=self.epsilon_max,
            node_clock_skews=self.node_clock_skews,
        )


@dataclass
class ScenarioResult:
    config: ScenarioConfig
    active_timeline: List[Tuple[float, int]]
    latencies: List[Tuple[float, float]]  # (sink time, end-to-end latency)
    on_time: int
    delayed: int
    source_events: int
    dropped: int
    drops_by_task: Dict[str, int]
    batch_sizes: Dict[str, List[int]]
    positives_generated: int
    positives_completed: int
    positives_dropped: int
    detections_on_time: int
    reid_matched: int = 0
    query_pushes: int = 0
    # Dynamism plane outputs: the sampled telemetry trace and the
    # ground-truth quality report (both None for undisturbed runs, keeping
    # summary() — and the frozen goldens over it — unchanged).
    trace: Optional[DynamismTrace] = None
    quality: Optional[Dict[str, float]] = None

    @property
    def peak_active(self) -> int:
        return max((c for _, c in self.active_timeline), default=0)

    @property
    def median_latency(self) -> float:
        if not self.latencies:
            return 0.0
        return float(np.median([l for _, l in self.latencies]))

    @property
    def p99_latency(self) -> float:
        if not self.latencies:
            return 0.0
        return float(np.percentile([l for _, l in self.latencies], 99))

    @property
    def delayed_fraction(self) -> float:
        total = self.on_time + self.delayed
        return self.delayed / total if total else 0.0

    @property
    def dropped_fraction(self) -> float:
        return self.dropped / self.source_events if self.source_events else 0.0

    def summary(self) -> Dict[str, float]:
        out = {
            "source_events": self.source_events,
            "on_time": self.on_time,
            "delayed": self.delayed,
            "dropped": self.dropped,
            "delayed_frac": round(self.delayed_fraction, 4),
            "dropped_frac": round(self.dropped_fraction, 4),
            "median_latency_s": round(self.median_latency, 3),
            "p99_latency_s": round(self.p99_latency, 3),
            "peak_active": self.peak_active,
            "positives_generated": self.positives_generated,
            "positives_completed": self.positives_completed,
        }
        # Dynamism-plane extras ride along only when the run carried a spec,
        # so undisturbed summaries stay bit-identical to the frozen goldens.
        if self.trace is not None:
            out.update(self.trace.summary())
        elif self.quality is not None:
            out.update(self.quality)
        return out


class TrackingScenario:
    """Builds and runs one configured tracking experiment.

    ``config`` describes the workload (cameras, duration, entity walk, QoS)
    and — absent explicit ``app``/``deployment`` — the preset pipeline via
    ``config.to_app()`` / ``config.deployment()``.  ``app`` may be a
    :class:`TrackingApp` or a factory ``(world, cameras) -> TrackingApp``
    (sweep grids use factories so fork workers build JAX-touching apps in
    their own process).
    """

    def __init__(
        self,
        config: ScenarioConfig,
        app: Optional[Any] = None,
        deployment: Optional[DeploymentSpec] = None,
    ) -> None:
        self.cfg = config
        # Fail here, before any world is built, when the device is absent.
        self.device = resolve_device(config.device)
        t_init = time.perf_counter()
        # The scenario does not own world geometry: the road network, walk
        # and camera placement live in a shared immutable WorldBundle, built
        # once per key and reused by every config of a sweep.
        key = WorldKey.from_config(config)
        world = config.world
        if world is None:
            t0 = time.perf_counter()
            world = get_world(key)
            self.world_build_seconds = time.perf_counter() - t0
        else:
            if world.key != key:
                raise ValueError(
                    f"config.world was built for {world.key}, but this config "
                    f"needs {key}"
                )
            self.world_build_seconds = 0.0
        self.world = world
        self.road = world.road
        self.walk = world.walk
        if config.embed_dim:
            # Embedding draws consume the camera RNG, so an embedding-enabled
            # camera network is stateful and cannot be shared across
            # scenarios; rebuild it (road + walk still come from the bundle).
            self.cameras = CameraNetwork(
                self.road,
                self.walk,
                num_cameras=config.num_cameras,
                fov_radius_m=config.fov_radius_m,
                fps=config.fps,
                embed_dim=config.embed_dim,
                seed=config.seed + 13,
            )
        else:
            self.cameras = world.cameras

        # ---- the executable unit: app + deployment ------------------- #
        if callable(app) and not isinstance(app, TrackingApp):
            app = app(world, self.cameras)
        self.app: TrackingApp = app or config.to_app(world, self.cameras)
        self.deployment = deployment or config.deployment()
        self.tl: TrackingLogic = self.app.tl

        network = NetworkModel()
        spec = config.dynamism
        if spec is not None:
            # Compose the dynamism plane's bandwidth perturbations over any
            # explicit schedule the config carries (both may be None).
            schedule = spec.bandwidth_schedule(config.bandwidth_schedule)
        else:
            schedule = config.bandwidth_schedule
        if schedule is not None:
            network.bandwidth_schedule = schedule
        # The static (src, dst) -> (latency, over-network) classification
        # depends only on the deployment shape, so scenarios sharing a world
        # share the memoized table too.
        num_va = resolve_module(self.app, self.deployment, "VA").instances
        num_cr = resolve_module(self.app, self.deployment, "CR").instances
        self.sim = DiscreteEventSimulator(
            network,
            transit_cache=world.transit_table(
                num_va, num_cr, self.deployment.num_nodes
            ),
        )
        # Compute stragglers scale actual execution durations inside the
        # engine; installed before compile_app so every Task (and the
        # compiler's fusion decisions) sees the dynamic-xi regime.
        if spec is not None:
            self.sim.xi_multiplier = spec.xi_multiplier()
            # Fault plane (HostCrash / NetworkPartition): like the xi
            # multiplier it must exist before compile_app — tasks snapshot
            # it at construction, and its presence turns off the static
            # transit fast paths so every send is fault-checked.
            self.sim.faults = spec.fault_plane(config.seed)
        self._rate_mult = spec.rate_multiplier() if spec is not None else None
        # Rate-window edges: a slowdown (factor < 1) stretches the tick
        # interval, and an unclamped interval computed just before a window
        # closes would overshoot it — or the end of the run — stalling the
        # source clock for good.  Ticks are clamped to the next boundary.
        self._rate_boundaries: List[float] = []
        if self._rate_mult is not None:
            bounds = set()
            for p in spec.perturbations:
                if hasattr(p, "rate_multiplier") and hasattr(p, "window"):
                    for b in p.window():
                        if 0.0 < b < config.duration_s:
                            bounds.add(float(b))
            self._rate_boundaries = sorted(bounds)
        self._reid_enabled = config.embed_dim > 0
        self._reid_query = (
            self.cameras.entity_embedding[None, :] if self._reid_enabled else None
        )
        # Multi-query tenancy hooks (repro_torch.query.MultiQueryScenario): when
        # `_mask_of` is set (camera id -> live-query bitmask), sourced events
        # are tagged with it and zero-mask cameras (no live query interested)
        # are skipped; `_source_hook(frames, t)` observes each tick's sourced
        # frames for per-query accounting.  Both None in single-query runs —
        # the source loop pays one attribute test per tick.
        self._mask_of: Optional[Dict[int, int]] = None
        self._source_hook: Optional[Callable[[List[Frame], float], None]] = None

        # ---- lower the app onto the pipeline ------------------------- #
        self.compiled: CompiledApp = compile_app(
            self.app,
            world,
            self.deployment,
            self.sim,
            cameras=self.cameras,
            on_detection=self._on_sink_event,
            va_batch_hook=self._va_reid if self._reid_enabled else None,
            # _on_sink_event only reads ev.value/ev.header inline and never
            # retains the event, so recycling headers at the sink is safe.
            sink_recycle_headers=True,
        )
        self.sink = self.compiled.sink
        #: Observability plane: install the span tracer (if any) on every
        #: task of the compiled app.  Installing disables the bulk static
        #: delivery fast path so each hop is observed individually.
        self.tracer = config.tracer
        if self.tracer is not None:
            self.compiled.install_tracer(self.tracer)
        self._seed_tl()

        #: Simulation horizon: generation stops at duration_s; in-flight
        #: events (and telemetry) drain until here.
        self._horizon = config.duration_s + 3.0 * self.app.gamma
        self._ticks_scheduled = False
        self._stats_active: List[Tuple[float, int]] = []
        self._positives_generated = 0
        self._positives_completed = 0
        self._reid_matched = 0
        self._detections_on_time = 0
        self._pending_detections: List[Detection] = []
        self._source_events = 0

        # ---- dynamism plane: telemetry, quality, churn ---------------- #
        self._trace: Optional[DynamismTrace] = None
        if spec is not None and spec.telemetry_period_s > 0:
            self._trace = DynamismTrace(spec=spec, period_s=spec.telemetry_period_s)
        self._quality_on = spec is not None and spec.quality
        if self._quality_on:
            # Ground truth: every (camera, tick) pair where the entity is
            # inside the FOV — including cameras the TL left inactive, which
            # is exactly what separates *track* recall from drop accounting.
            self._truth_ids = np.arange(self.cameras.num_cameras, dtype=np.int64)
            self._truth_pairs: Set[Tuple[int, float]] = set()
            self._sink_positive_pairs: List[Tuple[int, float]] = []
        self._churns = []
        if spec is not None:
            for i, ch in enumerate(spec.churns()):
                rng = np.random.default_rng(ch.seed + 1009 * i + config.seed)
                self._churns.append((ch, rng))
        # Active-set mirrors so the per-tick loops are O(active cameras),
        # not O(all cameras): the compiled app's `fc_active` tracks the FC
        # states that are *currently* active (control latency applied);
        # `_ctrl_target` is the last activation set TL asked for (so ticks
        # only schedule control events for the delta).
        self.compiled.fc_active |= set(self.tl.active)
        self._ctrl_target: Set[int] = set(self.tl.active)
        #: Construction wall-time (world fetch + app lowering), split from
        #: run() wall-time so per-event rates aren't polluted by one-off
        #: builds (benchmarks record both).
        self.build_seconds = time.perf_counter() - t_init

    # ------------------------------------------------------------------ #
    def _seed_tl(self) -> None:
        """Point the TL at the query's last-seen location (Fig. 1: start
        with only the camera covering it active).  Apps that pre-seeded
        their TL keep their own state."""
        tl = self.tl
        if tl.last_seen_camera is not None:
            return  # the app brought its own warm-start state, active set incl.
        cams = self.cameras.camera_vertices
        cam_ids = list(cams)
        cam_pos = self.road.positions[np.fromiter(cams.values(), dtype=np.int64)]
        d = np.linalg.norm(
            cam_pos - self.road.positions[self.walk.vertices[0]], axis=1
        )
        tl.last_seen_camera = cam_ids[int(np.argmin(d))]
        tl.last_seen_time = 0.0
        tl.active = tl.spotlight(0.0)

    # ------------------------------------------------------------------ #
    # Driver-side instrumentation hooks                                   #
    # ------------------------------------------------------------------ #
    def _va_reid(self, events: List[Event], state: Dict) -> None:
        """Batched re-ID over the batch's frame embeddings: one
        ``reid_match`` call per VA batch, a launch of the CUDA matcher on a
        GPU (gallery = the frames' embeddings,
        query = the tracked entity's embedding).  Matches count toward
        ``ScenarioResult.reid_matched`` and — like the ground-truth candidate
        filter — flag avoid-drop when the config asks for it (§4.3.3)."""
        from repro_torch.kernels import dispatch

        embs = [getattr(ev.value, "embedding", None) for ev in events]
        idx = [i for i, e in enumerate(embs) if e is not None]
        if not idx:
            return
        gallery = np.stack([embs[i] for i in idx])
        _, _, matched = dispatch.reid_match(
            gallery, self._reid_query, threshold=self.cfg.reid_threshold,
            device=self.device,
        )
        matched = matched.cpu().numpy()
        avoid = self.deployment.avoid_drop_positives
        for j, i in enumerate(idx):
            if matched[j]:
                self._reid_matched += 1
                if avoid:
                    events[i].header.avoid_drop = True

    # ------------------------------------------------------------------ #
    # Sink + TL feedback                                                  #
    # ------------------------------------------------------------------ #
    def _on_sink_event(self, ev: Event, now: float) -> None:
        det = ev.value
        if not isinstance(det, Detection):
            det = as_detection(ev)
        if det.positive:
            self._positives_completed += 1
            if now - ev.header.source_arrival <= self.app.gamma:
                self._detections_on_time += 1
            if self._quality_on:
                self._sink_positive_pairs.append((det.camera_id, det.timestamp))
        self._pending_detections.append(det)

    def _tl_tick(self) -> None:
        now = self.sim.time
        dets, self._pending_detections = self._pending_detections, []
        new_active = self.tl.update(dets, now)
        self._stats_active.append((now, len(new_active)))
        # Control events to FCs (TL -> FC, §2.2.1) after a control latency.
        # Only the delta against the previously requested set is scheduled,
        # so a tick costs O(|changed|), not O(num_cameras).
        latency = self.sim.network.man_latency_s
        set_active = self.compiled.set_fc_active
        prev = self._ctrl_target
        for cam in new_active - prev:
            self.sim.schedule(latency, set_active, cam, True)
        for cam in prev - new_active:
            self.sim.schedule(latency, set_active, cam, False)
        self._ctrl_target = new_active
        if now + self.cfg.tl_update_period <= self.cfg.duration_s:
            self.sim.schedule(self.cfg.tl_update_period, self._tl_tick)

    # ------------------------------------------------------------------ #
    # Frame generation                                                    #
    # ------------------------------------------------------------------ #
    def _frame_tick(self) -> None:
        t = self.sim.time
        compiled = self.compiled
        fc_active = compiled.fc_active
        if self._quality_on:
            vis = self.cameras.visible_batch(self._truth_ids, t)
            for c in np.nonzero(vis)[0]:
                self._truth_pairs.add((int(c), t))
        if fc_active:
            # Batched sourcing: one position interpolation + one vectorized
            # FOV test for the whole active set (ascending camera order, same
            # as the old per-camera loop).
            ids = np.fromiter(fc_active, dtype=np.int64, count=len(fc_active))
            ids.sort()
            frames = self.cameras.frames_at(t, ids)
            mask_of = self._mask_of
            if mask_of is not None:
                # Multi-query mode: a camera still active only because a
                # cancelled query's control deltas are in flight sources
                # nothing — no live query would consume the frame.
                frames = [f for f in frames if mask_of.get(f.camera_id, 0)]
            n_pos = 0
            if compiled.fuse_fc:
                # FC stage fused into the source: identical arrival times and
                # headers, no per-camera Task hops (see CompiledApp).
                xi1 = compiled.fc_xi1
                avoid = self.deployment.avoid_drop_positives
                va_of = compiled.va_of
                groups: Dict[Task, List[Event]] = {}
                for frame in frames:
                    has = frame.has_entity
                    if has:
                        n_pos += 1
                    cam = frame.camera_id
                    header = source_header(new_event_id(), t)
                    header.xi_bar = xi1
                    if has and avoid:
                        header.avoid_drop = True
                    ev = Event(header=header, key=cam, value=frame)
                    if mask_of is not None:
                        ev.query_mask = mask_of[cam]
                    ev.batch_slowest = True  # a b=1 batch's sole event
                    va = va_of[cam]
                    g = groups.get(va)
                    if g is None:
                        groups[va] = [ev]
                    else:
                        g.append(ev)
                depart = t + xi1
                for va, evs in groups.items():
                    self.sim.schedule_at(
                        depart + compiled.fc_transit, va._deliver_many, evs
                    )
            else:
                fc_tasks = compiled.fc_tasks
                make_fc = compiled.make_fc
                for frame in frames:
                    if frame.has_entity:
                        n_pos += 1
                    cam = frame.camera_id
                    fc = fc_tasks.get(cam)
                    if fc is None:
                        fc = make_fc(cam)
                    header = source_header(new_event_id(), t)
                    ev = Event(header=header, key=cam, value=frame)
                    if mask_of is not None:
                        ev.query_mask = mask_of[cam]
                    fc.on_arrival(ev)
            self._positives_generated += n_pos
            self._source_events += len(frames)
            if self._source_hook is not None:
                self._source_hook(frames, t)
        if self._rate_mult is None:
            dt = 1.0 / self.cfg.fps
        else:
            # Input-rate spike: the source plane ticks faster while the
            # multiplier is > 1 (flash-crowd input at the FC sources).
            # Spec perturbations validate factor > 0; the floor guards
            # custom multiplier objects against a stalled/reversed clock.
            dt = 1.0 / (self.cfg.fps * max(self._rate_mult(t), 1e-9))
            # Never overshoot the next window edge: the multiplier sampled
            # *now* only holds until then (a sub-1 factor would otherwise
            # skip past its own window's end, or the run's).
            for b in self._rate_boundaries:
                if b > t + 1e-9:
                    if t + dt > b:
                        dt = b - t
                    break
        if t + dt <= self.cfg.duration_s:
            self.sim.schedule(dt, self._frame_tick)

    # ------------------------------------------------------------------ #
    # Dynamism plane ticks                                                #
    # ------------------------------------------------------------------ #
    def _sample_telemetry_now(self) -> None:
        trace = self._trace
        trace.times.append(self.sim.time)
        trace.active_cameras.append(len(self.compiled.fc_active))
        self.compiled.sample_telemetry(trace)

    def _telemetry_tick(self) -> None:
        self._sample_telemetry_now()
        # Keep sampling through the drain window (run() horizon) so budget
        # recovery after a perturbation closes is visible in the trace.
        if self.sim.time + self._trace.period_s <= self._horizon:
            self.sim.schedule(self._trace.period_s, self._telemetry_tick)

    def _churn_tick(self, idx: int) -> None:
        ch, rng = self._churns[idx]
        now = self.sim.time
        if ch.fraction > 0.0 and ch.t_start <= now < ch.t_end:
            # Candidates: cameras the TL currently wants AND that are up.
            target = sorted(self._ctrl_target & self.compiled.fc_active)
            if target:
                # Round up to one camera for any positive fraction;
                # fraction == 0 is the undisturbed baseline of a sweep axis.
                k = min(len(target), max(1, int(round(ch.fraction * len(target)))))
                picks = rng.choice(len(target), size=k, replace=False)
                for j in sorted(int(p) for p in picks):
                    cam = target[j]
                    self.compiled.set_fc_active(cam, False)
                    self.sim.schedule(ch.outage_s, self._churn_restore, cam)
        if now + ch.period_s <= min(ch.t_end, self.cfg.duration_s):
            self.sim.schedule(ch.period_s, self._churn_tick, idx)

    def _churn_restore(self, cam: int) -> None:
        # The camera comes back only if the TL still wants it (otherwise the
        # next TL delta would immediately deactivate it anyway).
        if cam in self._ctrl_target:
            self.compiled.set_fc_active(cam, True)

    def _quality_report(self) -> Dict[str, float]:
        truth = self._truth_pairs
        detected = set(self._sink_positive_pairs)
        tp = len(detected & truth)
        return {
            "truth_events": len(truth),
            "track_recall": round(tp / len(truth), 4) if truth else 1.0,
            "track_precision": round(tp / len(detected), 4) if detected else 1.0,
        }

    def _crash_flush(self, crash) -> None:
        """Crash onset: events queued or batching on the dying host are lost
        — they live in process memory, which the crash wipes.  An executing
        batch is allowed to finish (the GPU kernel ran), but its outputs hit
        the sender-down check in ``Task._send`` and are lost there too."""
        for t in self.sim.tasks.values():
            if not crash.matches(t.node):
                continue
            batcher = t.batcher
            if batcher._current:
                for pe in batcher.take():
                    t._fault_drop(pe.event)
            rq = t._run_queue
            while rq:
                for pe in rq.popleft():
                    t._fault_drop(pe.event)

    def _schedule_ticks(self) -> None:
        """Arm the periodic drivers (sources, TL, telemetry, churn, crash
        flushes).  Idempotent so ``run_until`` segments and a final ``run``
        over the same scenario never double-schedule a tick chain."""
        if self._ticks_scheduled:
            return
        self._ticks_scheduled = True
        cfg = self.cfg
        self.sim.schedule(0.0, self._frame_tick)
        self.sim.schedule(cfg.tl_update_period, self._tl_tick)
        if self._trace is not None:
            self.sim.schedule(0.0, self._telemetry_tick)
        for idx, (ch, _) in enumerate(self._churns):
            # First tick right at the window opening (not one period in), so
            # windows shorter than period_s still perturb and the trace's
            # pre/during split lines up with the first dropout.
            self.sim.schedule_at(ch.t_start, self._churn_tick, idx)
        spec = cfg.dynamism
        if spec is not None:
            for crash in spec.crashes():
                self.sim.schedule_at(crash.t_start, self._crash_flush, crash)

    def run_until(self, t: float) -> None:
        """Advance the simulation to ``t`` (capped at the drain horizon)
        without finalizing — the serving plane uses this to model a driver
        process that is killed mid-run, and ``run()`` continues from here."""
        self._schedule_ticks()
        self.sim.run(until=min(t, self._horizon))

    # ------------------------------------------------------------------ #
    def run(self) -> ScenarioResult:
        cfg = self.cfg
        self._schedule_ticks()
        # Allow in-flight events to drain past the generation horizon.
        self.sim.run(until=self._horizon)

        if self._trace is not None:
            # Final sample after the drain: cumulative counters (drops,
            # probes) now reconcile exactly with the ScenarioResult totals.
            # If the last periodic tick already sampled this timestamp,
            # replace it (same-time events may have processed *after* it)
            # rather than appending a zero-width duplicate interval.
            tr = self._trace
            if tr.times and tr.times[-1] == self.sim.time:
                tr.times.pop()
                tr.active_cameras.pop()
                for row in tr.series.values():
                    for col in row.values():
                        col.pop()
            self._sample_telemetry_now()
        quality = self._quality_report() if self._quality_on else None
        if self._trace is not None:
            self._trace.quality = quality
        compiled = self.compiled
        drops = compiled.drops_by_task()
        return ScenarioResult(
            config=cfg,
            active_timeline=self._stats_active,
            latencies=list(self.sink.latencies),
            on_time=self.sink.on_time,
            delayed=self.sink.delayed,
            source_events=self._source_events,
            dropped=sum(drops.values()),
            drops_by_task=drops,
            batch_sizes=compiled.batch_sizes(),
            positives_generated=self._positives_generated,
            positives_completed=self._positives_completed,
            positives_dropped=self._positives_generated - self._positives_completed,
            detections_on_time=self._detections_on_time,
            reid_matched=self._reid_matched,
            query_pushes=compiled.query_pushes,
            trace=self._trace,
            quality=quality,
        )

    def publish_metrics(self, registry, res: ScenarioResult) -> None:
        """Publish this run's telemetry into an obs-plane metrics registry.

        The observability plane has not been carried over to the port yet.
        """
        raise NotImplementedError(
            "publish_metrics needs the observability plane (obs), which the "
            "port has not carried over yet"
        )
