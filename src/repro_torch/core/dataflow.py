"""The domain-specific dataflow model (paper §2.2, Fig. 2).

The dataflow shape is *fixed* (like MapReduce): the user supplies only the
functional logic of six module types and the platform wires, parallelizes and
tunes them:

    FC --> VA --> CR --> { TL, QF, UV }
     ^______________________|   |
         (activation ctrl)      |--> VA/CR query update

* **FC** (Filter Controls): per-camera entry point; forwards a frame iff its
  local state says so (``isActive``, frame-rate).  Updated by TL control
  events.
* **VA** (Video Analytics): per-camera batched analytics (detection), may
  invoke external models; state updatable by QF.
* **CR** (Contention Resolution): cross-camera re-identification on grouped
  detections; heavier model, runs less often; state updatable by QF.
* **TL** (Tracking Logic): the paper's novel module — interprets detections,
  expands/contracts the spotlight, (de)activates FCs.
* **QF** (Query Fusion): fuses high-confidence detections into the entity
  query and pushes the new query to VA/CR.
* **UV** (User Visualization): sink; receives annotated detections.

This module defines the *interfaces* and the :class:`TrackingApp`
composition.  A composed app is the platform's **executable unit**: the app
compiler (:func:`repro_torch.core.compile.compile_app`) lowers a ``TrackingApp`` +
a world + a :class:`repro_torch.core.compile.DeploymentSpec` onto the
:mod:`repro_torch.core.pipeline` Task DAG (FC fan-in, VA/CR replicas, UV sink, the
TL control loop and the QF query-fusion feedback edge), and
:func:`repro_torch.serving.scheduler.lower_app_stages` lowers the same spec onto
jit-compiled :class:`~repro_torch.serving.scheduler.ServedStage` instances.  The
discrete-event simulator's :class:`~repro_torch.sim.scenario.TrackingScenario` is a
thin driver over the compiled app; ``ScenarioConfig.to_app()`` exposes the
simulator's historical knob presets as app factories.

Per-module deployment is declared with :class:`ModuleSpec`.  Every field is
optional: ``None`` means "inherit the platform default" from the
``DeploymentSpec`` the app is compiled against, so an app only pins what it
cares about (paper §2.3: the platform does the wiring, tuning and
placement).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Protocol, Sequence, Tuple

from .events import Event
from .tracking import Detection, TrackingLogic

__all__ = [
    "BATCHING_STRATEGIES",
    "RESOURCE_TIERS",
    "FCLogic",
    "VALogic",
    "CRLogic",
    "QFLogic",
    "ModuleSpec",
    "TrackingApp",
]


class FCLogic(Protocol):
    """``fc(frame, state) -> bool`` — forward the frame?  (paper Alg. 1)."""

    def __call__(self, frame: Any, state: Dict[str, Any]) -> bool: ...


class VALogic(Protocol):
    """``va(camera_id, frames, state) -> [(camera_id, value)]``.

    Receives a batch of frames grouped by camera; emits key-value pairs
    (e.g. bounding boxes with scores).  May read ``state['entity_query']``.

    Lowering contract (``repro_torch.core.compile``): output attribution is
    *positional* — pair ``i`` rides frame ``i``'s event.  Emit one pair per
    frame; to filter a frame out, put ``None`` in its position (do NOT
    return a compacted shorter list — the survivors would be matched to the
    wrong frames' events).
    """

    def __call__(
        self, camera_id: Any, frames: Sequence[Any], state: Dict[str, Any]
    ) -> List[Tuple[Any, Any]]: ...


class CRLogic(Protocol):
    """``cr(camera_id, values, state) -> [(camera_id, detection)]``.

    Cross-camera contention resolution / re-id on VA outputs.  Same
    positional lowering contract as :class:`VALogic`: one pair (or ``None``
    to filter) per input value, in input order.
    """

    def __call__(
        self, camera_id: Any, values: Sequence[Any], state: Dict[str, Any]
    ) -> List[Tuple[Any, Any]]: ...


class QFLogic(Protocol):
    """``qf(detections, state) -> new_query | None`` — query fusion (§2.2.5)."""

    def __call__(
        self, detections: Sequence[Detection], state: Dict[str, Any]
    ) -> Optional[Any]: ...


#: Valid values for :attr:`ModuleSpec.batching` / :attr:`ModuleSpec.resource_tier`.
BATCHING_STRATEGIES = ("dynamic", "static", "nob")
RESOURCE_TIERS = ("edge", "fog", "cloud")


@dataclass
class ModuleSpec:
    """Per-module deployment overrides (paper §3: Master/Scheduler).

    Every field defaults to ``None`` — "inherit the platform default" — so a
    :class:`TrackingApp` only pins the knobs it cares about and the compiler
    (:func:`repro_torch.core.compile.resolve_module`) fills in the rest from the
    :class:`~repro_torch.core.compile.DeploymentSpec`.  ``batching`` and
    ``resource_tier`` are validated at construction; ``xi`` (the expected
    execution duration, seconds, for a batch of ``b`` events) is a plain
    optional callable — the old shared default-``lambda`` sentinel made
    "no cost model" indistinguishable from "explicitly free" and was a
    mutable-default footgun shared across every spec instance.
    """

    instances: Optional[int] = None
    resource_tier: Optional[str] = None  # edge | fog | cloud
    m_max: Optional[int] = None
    batching: Optional[str] = None  # dynamic | static | nob
    static_batch: Optional[int] = None
    # xi(b): expected execution duration (seconds) for a batch of b events.
    xi: Optional[Callable[[int], float]] = None

    def __post_init__(self) -> None:
        if self.batching is not None and self.batching not in BATCHING_STRATEGIES:
            raise ValueError(
                f"unknown batching {self.batching!r}; expected one of {BATCHING_STRATEGIES}"
            )
        if self.resource_tier is not None and self.resource_tier not in RESOURCE_TIERS:
            raise ValueError(
                f"unknown resource_tier {self.resource_tier!r}; expected one of {RESOURCE_TIERS}"
            )
        for name in ("instances", "m_max", "static_batch"):
            value = getattr(self, name)
            if value is not None and int(value) < 1:
                raise ValueError(f"{name} must be >= 1, got {value!r}")
        if self.xi is not None and not callable(self.xi):
            raise ValueError("xi must be callable (b -> seconds) or None")


@dataclass
class TrackingApp:
    """A composed tracking application (paper Table 1).

    ``fc``/``va``/``cr``/``qf`` are the user logics; ``tl`` is a
    :class:`TrackingLogic` strategy instance.  ``specs`` gives per-module
    deployment/tuning overrides (merged over the ``DeploymentSpec`` by the
    compiler).  The app is executed by lowering it:
    ``repro_torch.core.compile.compile_app`` builds the discrete-event Task DAG
    (driven by ``repro_torch.sim.scenario.TrackingScenario``), and
    ``repro_torch.serving.scheduler.lower_app_stages`` builds the jit'd serving
    stages for the VA/CR compute.
    """

    name: str
    fc: FCLogic
    va: VALogic
    cr: CRLogic
    tl: TrackingLogic
    qf: Optional[QFLogic] = None
    specs: Dict[str, ModuleSpec] = field(default_factory=dict)
    entity_query: Any = None
    gamma: float = 15.0  # max tolerable latency (paper §5.1)

    def spec(self, module: str) -> ModuleSpec:
        return self.specs.get(module, ModuleSpec())


# --------------------------------------------------------------------- #
# Reference user logics (paper Alg. 1 / Table 1), analytics-agnostic:   #
# the actual detectors are injected (HoG / DNN / JAX model).            #
# --------------------------------------------------------------------- #
def fc_is_active(frame: Any, state: Dict[str, Any]) -> bool:
    """App 1/2/4 FC: forward iff the camera is active."""
    return bool(state.get("isActive", True))


# Lowering override (see ``repro_torch.core.compile``): the activation gate needs
# one state read per *batch*, not one call per event — and the compiler
# additionally recognizes this exact logic as fusable into the frame source.
fc_is_active.task_logic = (
    lambda events, state: events if state.get("isActive", True) else []
)


def fc_frame_rate(frame: Any, state: Dict[str, Any]) -> bool:
    """App 3 FC: subsample to the commanded frame-rate."""
    rate = max(int(state.get("frame_rate", 1)), 1)
    count = state.get("_count", 0)
    state["_count"] = count + 1
    return count % rate == 0


def make_va(detector: Callable[[Sequence[Any], Any], List[Any]]) -> VALogic:
    """Wrap a batched detector ``detector(frames, query) -> per-frame boxes``
    as VA logic (HoG in App 1/2, YOLO in App 3, small re-id in App 4)."""

    def va(camera_id, frames, state):
        boxes = detector(frames, state.get("entity_query"))
        return [(camera_id, (frame, bb)) for frame, bb in zip(frames, boxes)]

    return va


def make_cr(reid: Callable[[Sequence[Any], Any], List[bool]]) -> CRLogic:
    """Wrap a batched re-id matcher ``reid(crops, query) -> [bool]`` as CR."""

    def cr(camera_id, values, state):
        crops = [v for v in values]
        verdicts = reid(crops, state.get("entity_query"))
        return [(camera_id, bool(v)) for v in verdicts]

    return cr
