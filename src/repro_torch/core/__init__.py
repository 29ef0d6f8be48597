"""Anveshak core: the paper's contribution (dataflow model + runtime tuning).

Layout mirrors the paper:

* §2  dataflow model  -> :mod:`repro_torch.core.dataflow`, :mod:`repro_torch.core.events`
* §2.2.4 tracking     -> :mod:`repro_torch.core.tracking`, :mod:`repro_torch.core.roadnet`
* §4.3 dropping       -> :mod:`repro_torch.core.dropping`
* §4.4 batching       -> :mod:`repro_torch.core.batching`
* §4.5 budgets        -> :mod:`repro_torch.core.budget`
* §4.6 bounds/skew    -> :mod:`repro_torch.core.bounds`, :mod:`repro_torch.core.clock`
* §3  runtime         -> :mod:`repro_torch.core.pipeline`
"""

from .batching import DynamicBatcher, NOBBatcher, PendingEvent, StaticBatcher, build_nob_table
from .bounds import (
    batching_latency_overhead,
    drop_rate,
    max_sustainable_rate,
    stable_batch_size,
)
from .budget import BudgetState, TaskBudget
from .clock import Clock
from .compile import (
    CompiledApp,
    DeploymentSpec,
    ResolvedModule,
    compile_app,
    linear_xi,
    resolve_module,
)
from .dataflow import ModuleSpec, TrackingApp, fc_frame_rate, fc_is_active, make_cr, make_va
from .dropping import drop_before_exec, drop_before_queuing, drop_before_transmit
from .events import (
    AcceptSignal,
    Event,
    EventHeader,
    EventRecord,
    ProbeSignal,
    RejectSignal,
    new_event_id,
)
from .pipeline import PipelineStats, Scheduler, SinkTask, Task
from .roadnet import RoadNetwork, make_road_network
from .tracking import Detection, TLBFS, TLBase, TLProbabilistic, TLWBFS, TrackingLogic

__all__ = [
    "AcceptSignal", "BudgetState", "Clock", "CompiledApp", "DeploymentSpec",
    "Detection", "DynamicBatcher", "Event", "EventHeader", "EventRecord",
    "ModuleSpec", "NOBBatcher", "PendingEvent", "PipelineStats",
    "ProbeSignal", "RejectSignal", "ResolvedModule", "RoadNetwork",
    "Scheduler", "SinkTask", "StaticBatcher", "TLBFS", "TLBase",
    "TLProbabilistic", "TLWBFS", "Task", "TaskBudget", "TrackingApp",
    "TrackingLogic", "batching_latency_overhead", "build_nob_table",
    "compile_app", "drop_before_exec", "drop_before_queuing",
    "drop_before_transmit", "drop_rate", "fc_frame_rate", "fc_is_active",
    "linear_xi", "make_cr", "make_road_network", "make_va",
    "max_sustainable_rate", "new_event_id", "resolve_module",
    "stable_batch_size",
]
