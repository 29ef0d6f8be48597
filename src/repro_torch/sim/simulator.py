"""Discrete-event engine + WAN/MAN network model (paper §5.1 system setup).

The engine drives the :mod:`repro_torch.core.pipeline` tasks: a heap of
``(time, seq, fn, args)`` callbacks.  ``schedule`` takes ``(delay, fn,
*args)`` so hot-path callers never need to allocate a closure per event.
The network model charges ``latency + size/bandwidth`` per transit between
nodes; the bandwidth is a function of time so the paper's Fig. 9 experiment
(1 Gbps -> 30 Mbps midway) is expressible.  The per-(src, dst) latency
classification (IPC / LAN / MAN) is cached — topology is static while the
bandwidth multiplier is not.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.pipeline import Scheduler

__all__ = ["NetworkModel", "DiscreteEventSimulator"]


def _default_bandwidth_schedule(t: float) -> float:
    return 1.0


def _hop_latency_is_man(src_host: str, dst_host: str) -> bool:
    """Hop classification for *distinct* hosts (paper §5.1): only the
    compute cluster (``node*`` / ``head``) shares a LAN; edge hosts are
    separate sites, so any hop touching an edge host — including between
    two distinct edge hosts (``edge3`` -> ``edge7``) — crosses the MAN."""
    return src_host.startswith("edge") or dst_host.startswith("edge")


@dataclass
class NetworkModel:
    """Node-to-node transit: ``latency(src,dst) + bytes / bandwidth(t)``.

    ``node_of`` maps a task node-name to a host; transits within the same
    host use IPC and are charged ``ipc_latency`` only (paper §3: Sys V IPC
    between Worker and Executors).
    """

    lan_bandwidth_bps: float = 1e9  # 1 Gbps cluster links (paper §5.1)
    man_latency_s: float = 0.005
    lan_latency_s: float = 0.0005
    ipc_latency_s: float = 0.00005
    # time -> bandwidth multiplier (Fig. 9 drops this to 0.03 at t=300).
    bandwidth_schedule: Callable[[float], float] = _default_bandwidth_schedule

    def transit_delay(self, src_host: str, dst_host: str, size_bytes: float, t: float) -> float:
        if src_host == dst_host:
            return self.ipc_latency_s
        bw = self.lan_bandwidth_bps * max(self.bandwidth_schedule(t), 1e-9)
        latency = (
            self.man_latency_s
            if _hop_latency_is_man(src_host, dst_host)
            else self.lan_latency_s
        )
        return latency + size_bytes * 8.0 / bw


class DiscreteEventSimulator(Scheduler):
    """Minimal deterministic discrete-event scheduler."""

    def __init__(
        self,
        network: Optional[NetworkModel] = None,
        transit_cache: Optional[Dict[Tuple[str, str], Tuple[float, bool]]] = None,
    ) -> None:
        self._heap: List[Tuple[float, int, Callable[..., None], tuple]] = []
        self._seq = 0
        self._time = 0.0
        self.network = network or NetworkModel()
        self.host_of: Dict[str, str] = {}
        # Optional (host, t) -> execution-duration multiplier installed by
        # the dynamism plane (ComputeSlowdown).  Tasks consult it when
        # charging *actual* execution time; the runtime's xi(b) estimates
        # (drop decisions, batch deadlines) stay unscaled — a straggler is
        # unannounced and the budget protocol must adapt through signals.
        self._xi_multiplier: Optional[Callable[[str, float], float]] = None
        # Optional fault plane (repro_torch.sim.dynamism.FaultPlane) installed by
        # the scenario before the pipeline is built: host-down / link-blocked
        # predicates + the seeded retry schedule.  Tasks snapshot it at
        # construction (like the xi multiplier), and its presence disables
        # the static-transit fast paths so every send is fault-checked.
        self._faults: Optional[Any] = None
        # (src, dst) -> (fixed latency, charged over the network?).  Host
        # assignment is static once the pipeline is built, so the
        # classification (IPC vs LAN vs MAN) never changes.  A caller may
        # pass a shared table: entries depend only on task naming and the
        # (constant) latency tiers, so scenarios with the same deployment
        # shape can reuse one memoized table (the time-varying bandwidth
        # term is applied outside the cached entry).
        self._transit_cache = transit_cache if transit_cache is not None else {}

    # -- Scheduler protocol -------------------------------------------- #
    @property
    def time(self) -> float:
        return self._time

    def schedule(self, delay: float, fn: Callable[..., None], *args: Any) -> None:
        t = self._time + delay if delay > 0.0 else self._time
        self._seq = seq = self._seq + 1
        heapq.heappush(self._heap, (t, seq, fn, args))

    def schedule_at(self, t: float, fn: Callable[..., None], *args: Any) -> None:
        if t < self._time:
            t = self._time
        self._seq = seq = self._seq + 1
        heapq.heappush(self._heap, (t, seq, fn, args))

    @property
    def transit_is_static(self) -> bool:
        """True when node-to-node delays cannot vary over time, letting tasks
        memoize their per-destination transit delay.  A fault plane makes
        delivery itself conditional (crashed hosts, partitioned links), so
        it forces the dynamic path too."""
        return (
            self.network.bandwidth_schedule is _default_bandwidth_schedule
            and self._faults is None
        )

    @property
    def faults(self) -> Optional[Any]:
        return self._faults

    @faults.setter
    def faults(self, plane: Optional[Any]) -> None:
        # Same contract as xi_multiplier: tasks snapshot the plane at
        # construction, so installing one after the pipeline is built would
        # leave every existing task fault-blind — refuse loudly.
        if plane is not None and self.tasks and self.tasks is not Scheduler.tasks:
            raise RuntimeError(
                "install faults before building tasks on this simulator — "
                "tasks snapshot the fault plane at construction"
            )
        self._faults = plane

    @property
    def xi_is_static(self) -> bool:
        """True when execution durations cannot vary over time (no compute
        perturbation installed), letting the compiler keep its fused
        streaming / fused-FC fast paths."""
        return self._xi_multiplier is None

    @property
    def xi_multiplier(self) -> Optional[Callable[[str, float], float]]:
        return self._xi_multiplier

    @xi_multiplier.setter
    def xi_multiplier(self, fn: Optional[Callable[[str, float], float]]) -> None:
        # Tasks snapshot the multiplier at construction (hot-path: no
        # per-event indirection), so installing one after the pipeline is
        # built would silently scale nothing while xi_is_static flips —
        # refuse loudly instead.
        if fn is not None and self.tasks and self.tasks is not Scheduler.tasks:
            raise RuntimeError(
                "install xi_multiplier before building tasks on this "
                "simulator — tasks snapshot it at construction"
            )
        self._xi_multiplier = fn

    def transit_delay(self, src: str, dst: str, size_bytes: float) -> float:
        ent = self._transit_cache.get((src, dst))
        if ent is None:
            src_host = self.host_of.get(src, src)
            dst_host = self.host_of.get(dst, dst)
            net = self.network
            if src_host == dst_host:
                ent = (net.ipc_latency_s, False)
            else:
                latency = (
                    net.man_latency_s
                    if _hop_latency_is_man(src_host, dst_host)
                    else net.lan_latency_s
                )
                ent = (latency, True)
            self._transit_cache[(src, dst)] = ent
        latency, over_network = ent
        if not over_network:
            return latency
        net = self.network
        schedule = net.bandwidth_schedule
        if schedule is _default_bandwidth_schedule:
            bw = net.lan_bandwidth_bps
        else:
            bw = net.lan_bandwidth_bps * max(schedule(self._time), 1e-9)
        return latency + size_bytes * 8.0 / bw

    # -- Run loop -------------------------------------------------------- #
    def run(self, until: float = math.inf, max_events: int = 50_000_000) -> int:
        """Process events until the horizon; returns number processed."""
        n = 0
        heap = self._heap
        pop = heapq.heappop
        while heap and n < max_events:
            item = heap[0]
            if item[0] > until:
                break
            pop(heap)
            self._time = item[0]
            item[2](*item[3])
            n += 1
        self._time = max(self._time, min(until, self._time if not heap else until))
        return n
