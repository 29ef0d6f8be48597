"""Discrete-event simulation of the many-camera network (paper §5 setup).

The port's counterpart of ``repro.sim``.  The sweep engine and the
multi-query names it re-exports have not been carried over yet.
"""

from .cameras import CameraNetwork, EntityWalk, Frame
from .dynamism import (
    BandwidthCollapse,
    CameraChurn,
    ComputeSlowdown,
    DynamismSpec,
    DynamismTrace,
    FaultPlane,
    HostCrash,
    InputRateSpike,
    NetworkPartition,
    RetryPolicy,
    fig9_collapse,
)
from .scenario import (
    ScenarioConfig,
    ScenarioResult,
    TrackingScenario,
    linear_xi,
    make_scenario_cr,
    va_passthrough,
)
from .simulator import DiscreteEventSimulator, NetworkModel
from .world import WorldBundle, WorldKey, clear_world_cache, get_world, world_cache_stats

__all__ = [
    "BandwidthCollapse", "CameraChurn", "CameraNetwork", "ComputeSlowdown",
    "DiscreteEventSimulator", "DynamismSpec", "DynamismTrace", "EntityWalk",
    "FaultPlane", "Frame", "HostCrash", "InputRateSpike", "NetworkModel",
    "NetworkPartition", "RetryPolicy", "ScenarioConfig", "ScenarioResult",
    "TrackingScenario", "WorldBundle", "WorldKey", "clear_world_cache",
    "fig9_collapse", "get_world", "linear_xi", "make_scenario_cr",
    "va_passthrough", "world_cache_stats",
]
