"""Dynamism experiment plane: composable perturbation schedules + telemetry
(paper §4.3–§4.5, Figs. 7/9 — *responsiveness to dynamism*).

The paper's central claim is not raw throughput but adaptation: tunable
batching and dropping that trade tracking accuracy, real-time latency and
active-camera-set size as conditions vary.  This module makes each source
of variability a first-class, seeded, composable perturbation that attaches
to any ``ScenarioConfig`` (and therefore any ``AppCase``):

* :class:`BandwidthCollapse` — the Fig. 9 experiment (1 Gbps -> 30 Mbps at
  t = 300 s), generalized to a window ``[t_start, t_end)`` and any factor.
* :class:`ComputeSlowdown` — per-host straggler multipliers applied to the
  *actual* execution duration inside the discrete-event engine.  The
  runtime's cost model ``xi(b)`` is deliberately **not** scaled: a straggler
  is unannounced, so drop decisions and batch deadlines keep using the stale
  estimate and the budget protocol has to adapt through accept/reject
  signals — exactly the behavior under test (cf. DeepScale's online
  adaptation to compute variability).
* :class:`InputRateSpike` — frame-rate multiplier at the FC sources over a
  window (flash-crowd input).
* :class:`CameraChurn` — seeded periodic dropout of active cameras (sensing
  churn: a camera the TL wants goes dark for ``outage_s``).

A :class:`DynamismSpec` composes any number of perturbations (multipliers
multiply where they overlap) and additionally switches on the observation
side of the experiment:

* **telemetry** — per-task time series sampled on a fixed cadence into a
  :class:`DynamismTrace` (budget ``beta_i``, queue length, batch sizes,
  the three drop-point counters, probe/accept/reject counts, active-camera
  count).  Sampling walks the compiled tasks once per cadence, entirely off
  the per-event hot path; with no spec attached the scenario schedules
  nothing and the pipeline pays nothing.
* **quality** — ground-truth tracking metrics against the entity walk:
  track recall/precision over (camera, tick) visibility pairs, plus the
  latency percentiles and drop fractions the summary already carries.

Everything is deterministic in (config seed, spec): perturbation windows are
pure functions of time and the churn RNG is seeded, so a dynamism run is as
replayable as any other scenario — the golden-trace regression test freezes
a full :meth:`DynamismTrace.digest` and asserts bit-identical replay.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.pipeline import STAT_FIELDS

__all__ = [
    "BandwidthCollapse",
    "ComputeSlowdown",
    "InputRateSpike",
    "CameraChurn",
    "HostCrash",
    "NetworkPartition",
    "RetryPolicy",
    "FaultPlane",
    "DynamismSpec",
    "DynamismTrace",
    "fig9_collapse",
]

#: Fields sampled per task on every telemetry tick.  ``beta`` is the task's
#: most conservative completion budget; ``queue`` the events pending in the
#: batcher + run queue; the rest are the cumulative counters of
#: :data:`repro_torch.core.pipeline.STAT_FIELDS` (defined next to PipelineStats
#: so the per-task, aggregate and serving rows share one mapping).
TRACE_FIELDS = ("beta", "queue") + tuple(f for f, _ in STAT_FIELDS)


def _queue_depth(task) -> int:
    return sum(len(b) for b in task._run_queue) + task.batcher.current_size


# --------------------------------------------------------------------- #
# Perturbations                                                          #
# --------------------------------------------------------------------- #
def _in_window(t: float, t_start: float, t_end: float) -> bool:
    return t_start <= t < t_end


@dataclass(frozen=True)
class BandwidthCollapse:
    """Network bandwidth multiplied by ``factor`` over ``[t_start, t_end)``.

    ``factor=0.03`` with an open end reproduces Fig. 9 verbatim; the
    dynamism benchmarks use a transient window so budget *recovery* after
    the collapse is measurable.
    """

    t_start: float = 300.0
    t_end: float = math.inf
    factor: float = 0.03

    def __post_init__(self) -> None:
        if not self.factor > 0.0:
            raise ValueError(f"factor must be > 0, got {self.factor!r}")

    def bandwidth_multiplier(self, t: float) -> float:
        return self.factor if _in_window(t, self.t_start, self.t_end) else 1.0

    def window(self) -> Tuple[float, float]:
        return (self.t_start, self.t_end)


@dataclass(frozen=True)
class ComputeSlowdown:
    """Execution durations on matching hosts multiplied by ``factor`` over
    ``[t_start, t_end)``.  ``hosts=None`` slows every host; otherwise any
    host whose name starts with one of the given prefixes (``("node0",)``
    makes one straggler; ``("node",)`` slows the whole compute tier)."""

    t_start: float = 300.0
    t_end: float = math.inf
    factor: float = 4.0
    hosts: Optional[Tuple[str, ...]] = None

    def __post_init__(self) -> None:
        if not self.factor > 0.0:
            raise ValueError(f"factor must be > 0, got {self.factor!r}")

    def xi_multiplier(self, host: str, t: float) -> float:
        if not _in_window(t, self.t_start, self.t_end):
            return 1.0
        if self.hosts is not None and not host.startswith(self.hosts):
            return 1.0
        return self.factor

    def window(self) -> Tuple[float, float]:
        return (self.t_start, self.t_end)


@dataclass(frozen=True)
class InputRateSpike:
    """Source frame rate multiplied by ``factor`` over ``[t_start, t_end)``
    (the FC sources tick faster, raising the input rate everywhere)."""

    t_start: float = 300.0
    t_end: float = math.inf
    factor: float = 2.0

    def __post_init__(self) -> None:
        # A zero/negative rate would stall or reverse the source clock;
        # model an outage with CameraChurn (or a tiny positive factor).
        if not self.factor > 0.0:
            raise ValueError(f"factor must be > 0, got {self.factor!r}")

    def rate_multiplier(self, t: float) -> float:
        return self.factor if _in_window(t, self.t_start, self.t_end) else 1.0

    def window(self) -> Tuple[float, float]:
        return (self.t_start, self.t_end)


@dataclass(frozen=True)
class CameraChurn:
    """Every ``period_s`` inside ``[t_start, t_end)``, a seeded ``fraction``
    of the TL's currently-requested cameras goes dark for ``outage_s``
    (restored afterwards only if the TL still wants them)."""

    period_s: float = 10.0
    fraction: float = 0.25
    outage_s: float = 5.0
    t_start: float = 0.0
    t_end: float = math.inf
    seed: int = 0

    def __post_init__(self) -> None:
        if not self.period_s > 0.0:
            raise ValueError(f"period_s must be > 0, got {self.period_s!r}")
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {self.fraction!r}")
        if self.outage_s < 0.0:
            raise ValueError(f"outage_s must be >= 0, got {self.outage_s!r}")

    def window(self) -> Tuple[float, float]:
        return (self.t_start, self.t_end)


@dataclass(frozen=True)
class HostCrash:
    """Hosts matching ``hosts`` die over ``[t_start, t_start + outage_s)``
    and restart afterwards (fail-recover, WatchDog-style edge failures).

    While a host is down it accepts no deliveries: its queued and batching
    events are lost at crash onset (the scenario flushes them through the
    ``dp_fault`` drop class), outputs of an execution finishing during the
    outage are lost, and inter-host sends targeting it time out and retry
    with seeded backoff (see :class:`RetryPolicy`) — surviving if the host
    restarts within the retry horizon, charged as ``dp_fault`` otherwise.
    Prefix-matched like :class:`ComputeSlowdown`: ``("node0",)`` kills one
    compute node, ``("edge",)`` the whole edge tier.
    """

    hosts: Tuple[str, ...] = ("node0",)
    t_start: float = 300.0
    outage_s: float = 30.0

    def __post_init__(self) -> None:
        if not self.hosts:
            raise ValueError("hosts must name at least one host prefix")
        if not self.outage_s > 0.0:
            raise ValueError(f"outage_s must be > 0, got {self.outage_s!r}")

    def host_down(self, host: str, t: float) -> bool:
        return host.startswith(self.hosts) and _in_window(
            t, self.t_start, self.t_start + self.outage_s
        )

    def matches(self, host: str) -> bool:
        return host.startswith(self.hosts)

    def window(self) -> Tuple[float, float]:
        return (self.t_start, self.t_start + self.outage_s)


@dataclass(frozen=True)
class NetworkPartition:
    """LAN/MAN transits *between* the two host groups fail over
    ``[t_start, t_end)`` (both directions); transits within a group — and
    same-host IPC — are unaffected.  The default splits the compute cluster
    from the edge tier, the paper's wide-area failure mode."""

    group_a: Tuple[str, ...] = ("node", "head")
    group_b: Tuple[str, ...] = ("edge",)
    t_start: float = 300.0
    t_end: float = math.inf

    def __post_init__(self) -> None:
        if not self.group_a or not self.group_b:
            raise ValueError("both partition groups must be non-empty")
        if not self.t_end > self.t_start:
            raise ValueError(
                f"t_end must be > t_start, got [{self.t_start!r}, {self.t_end!r})"
            )

    def link_blocked(self, src_host: str, dst_host: str, t: float) -> bool:
        if src_host == dst_host or not _in_window(t, self.t_start, self.t_end):
            return False
        a, b = self.group_a, self.group_b
        return (src_host.startswith(a) and dst_host.startswith(b)) or (
            src_host.startswith(b) and dst_host.startswith(a)
        )

    def window(self) -> Tuple[float, float]:
        return (self.t_start, self.t_end)


@dataclass(frozen=True)
class RetryPolicy:
    """Inter-host send timeout + capped exponential backoff with seeded
    jitter.  Attempt ``k`` (0-based) that finds the link/host down waits
    ``timeout_s + min(cap_s, base_s * 2**k) * (1 + jitter * u)`` with
    ``u ~ U[0, 1)`` from the fault plane's seeded RNG, then retries; after
    ``max_retries`` failed attempts the event is charged as ``dp_fault``."""

    timeout_s: float = 0.05
    base_s: float = 0.1
    cap_s: float = 2.0
    jitter: float = 0.5
    max_retries: int = 5

    def __post_init__(self) -> None:
        if self.timeout_s < 0.0 or self.base_s <= 0.0 or self.cap_s <= 0.0:
            raise ValueError("timeout_s must be >= 0 and backoff terms > 0")
        if not 0.0 <= self.jitter:
            raise ValueError(f"jitter must be >= 0, got {self.jitter!r}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries!r}")


class FaultPlane:
    """Runtime fault state the engine and tasks consult: the composed
    host-down / link-blocked predicates of a spec's :class:`HostCrash` /
    :class:`NetworkPartition` perturbations plus the seeded retry schedule.

    Installed on the simulator (``sim.faults``) *before* the pipeline is
    built — tasks snapshot it at construction, like ``xi_multiplier`` — and
    its presence makes ``transit_is_static`` False, so every transit goes
    through the fault-aware send path (no fused/memoized shortcuts).

    Everything is deterministic in (spec, seed): the windows are pure
    functions of time and the jitter RNG is seeded and consumed in event
    order, so a faulted run replays bit-identically.
    """

    def __init__(
        self,
        crashes: Sequence[HostCrash],
        partitions: Sequence[NetworkPartition],
        retry: Optional[RetryPolicy] = None,
        seed: int = 0,
    ) -> None:
        import numpy as np

        self.crashes: Tuple[HostCrash, ...] = tuple(crashes)
        self.partitions: Tuple[NetworkPartition, ...] = tuple(partitions)
        self.retry = retry or RetryPolicy()
        self._rng = np.random.default_rng(seed + 0x5EED)
        # Fault-plane counters (cold path: only blocked sends touch them).
        self.sends_blocked = 0
        self.retries = 0
        self.fault_drops = 0

    # -- predicates ------------------------------------------------------ #
    def host_down(self, host: str, t: float) -> bool:
        for c in self.crashes:
            if c.host_down(host, t):
                return True
        return False

    def link_blocked(self, src_host: str, dst_host: str, t: float) -> bool:
        for p in self.partitions:
            if p.link_blocked(src_host, dst_host, t):
                return True
        return False

    def send_blocked(self, src_host: str, dst_host: str, t: float) -> bool:
        """Would a send attempted now fail?  (Destination dead, or the
        inter-group link partitioned — the *source* being dead is handled
        separately: a dead sender's outputs are lost, not retried.)"""
        return self.host_down(dst_host, t) or self.link_blocked(
            src_host, dst_host, t
        )

    def partition_active(self, t: float) -> bool:
        for p in self.partitions:
            s, e = p.window()
            if s <= t < e:
                return True
        return False

    # -- retry schedule -------------------------------------------------- #
    def retry_delay(self, attempt: int) -> float:
        r = self.retry
        backoff = min(r.cap_s, r.base_s * (2.0 ** attempt))
        return r.timeout_s + backoff * (1.0 + r.jitter * float(self._rng.uniform()))


# --------------------------------------------------------------------- #
# The composed spec                                                      #
# --------------------------------------------------------------------- #
@dataclass(frozen=True)
class DynamismSpec:
    """A bundle of perturbations + the observation cadence.

    Attach via ``ScenarioConfig(dynamism=DynamismSpec((...)))``; the
    scenario composes the perturbations onto the network model, the
    discrete-event engine and the source plane, schedules the telemetry
    tick, and returns the :class:`DynamismTrace` on its ``ScenarioResult``.
    """

    perturbations: Tuple = ()
    #: Telemetry sampling cadence in seconds; 0 disables the trace.
    telemetry_period_s: float = 5.0
    #: Compute ground-truth track recall/precision (costs one vectorized
    #: FOV test over *all* cameras per source tick — off by default only
    #: when you need raw engine throughput).
    quality: bool = True
    #: Retry schedule for inter-host sends while a fault perturbation holds
    #: (only consulted when the spec carries HostCrash/NetworkPartition;
    #: None uses the RetryPolicy defaults).
    retry: Optional[RetryPolicy] = None

    # -- composition ---------------------------------------------------- #
    def _with(self, method: str) -> List:
        return [p for p in self.perturbations if hasattr(p, method)]

    def bandwidth_schedule(
        self, base: Optional[Callable[[float], float]] = None
    ) -> Optional[Callable[[float], float]]:
        """Composed ``t -> bandwidth multiplier`` (product with ``base``);
        None when neither the spec nor ``base`` varies the bandwidth."""
        ps = self._with("bandwidth_multiplier")
        if not ps and base is None:
            return None
        if not ps:
            return base

        def schedule(t: float) -> float:
            m = base(t) if base is not None else 1.0
            for p in ps:
                m *= p.bandwidth_multiplier(t)
            return m

        return schedule

    def xi_multiplier(self) -> Optional[Callable[[str, float], float]]:
        """Composed ``(host, t) -> execution-duration multiplier``, or None
        when no compute perturbation is present (the hot path then keeps its
        static-xi fast paths — fusion, memoized transits)."""
        ps = self._with("xi_multiplier")
        if not ps:
            return None

        def mult(host: str, t: float) -> float:
            m = 1.0
            for p in ps:
                m *= p.xi_multiplier(host, t)
            return m

        return mult

    def rate_multiplier(self) -> Optional[Callable[[float], float]]:
        ps = self._with("rate_multiplier")
        if not ps:
            return None

        def mult(t: float) -> float:
            m = 1.0
            for p in ps:
                m *= p.rate_multiplier(t)
            return m

        return mult

    def churns(self) -> Tuple[CameraChurn, ...]:
        return tuple(p for p in self.perturbations if isinstance(p, CameraChurn))

    def crashes(self) -> Tuple[HostCrash, ...]:
        return tuple(p for p in self.perturbations if isinstance(p, HostCrash))

    def partitions(self) -> Tuple[NetworkPartition, ...]:
        return tuple(
            p for p in self.perturbations if isinstance(p, NetworkPartition)
        )

    def fault_plane(self, seed: int = 0) -> Optional[FaultPlane]:
        """The composed runtime :class:`FaultPlane`, or None when the spec
        carries no fault perturbation (the hot path then keeps every
        fused/memoized fast path)."""
        crashes, partitions = self.crashes(), self.partitions()
        if not crashes and not partitions:
            return None
        return FaultPlane(crashes, partitions, retry=self.retry, seed=seed)

    def windows(self) -> List[Tuple[float, float]]:
        """Perturbation windows, sorted by start (used by the recovery
        metric to split pre / during / post samples)."""
        return sorted(p.window() for p in self.perturbations if hasattr(p, "window"))


def fig9_collapse(
    t_start: float = 300.0, t_end: float = math.inf, factor: float = 0.03
) -> DynamismSpec:
    """The Fig.-9 bandwidth experiment as a spec (telemetry + quality on)."""
    return DynamismSpec((BandwidthCollapse(t_start, t_end, factor),))


# --------------------------------------------------------------------- #
# Telemetry trace                                                        #
# --------------------------------------------------------------------- #
@dataclass
class DynamismTrace:
    """Per-task time series sampled on a fixed cadence, plus the quality
    metrics computed against the ground-truth entity walk.

    ``series`` maps task name -> field -> samples; field names are
    :data:`TRACE_FIELDS`.  ``FC*`` is the aggregate over the (lazy) FC
    tasks.  Everything here is plain floats/ints so traces pickle through
    fork sweep workers and digest deterministically.
    """

    spec: DynamismSpec
    period_s: float
    times: List[float] = field(default_factory=list)
    active_cameras: List[int] = field(default_factory=list)
    series: Dict[str, Dict[str, List[float]]] = field(default_factory=dict)
    quality: Optional[Dict[str, float]] = None

    # -- recording (called by the scenario's telemetry tick) ------------- #
    def task_row(self, name: str) -> Dict[str, List[float]]:
        row = self.series.get(name)
        if row is None:
            row = self.series[name] = {f: [] for f in TRACE_FIELDS}
        return row

    def sample_task(self, task) -> None:
        """Append one sample for a pipeline Task (allocation-lean: appends
        onto preallocated lists, no per-sample objects)."""
        row = self.task_row(task.name)
        stats = task.stats
        row["beta"].append(task.budget.min_budget())
        row["queue"].append(_queue_depth(task))
        for fld, attr in STAT_FIELDS:
            row[fld].append(getattr(stats, attr))

    def sample_keyed(self, name: str, values: Dict[str, float]) -> None:
        """Append one sample for a *keyed* row that is not backed by a
        pipeline Task — the multi-query tenancy plane records one row per
        tracking query (``Q:<id>``) this way, with the same
        :data:`TRACE_FIELDS` shape as every task row.  Rows created
        mid-trace (queries submitted after sampling started) are backfilled
        (``beta`` with ``inf`` — no budget yet — and counters with 0) so
        every row stays aligned with ``times``."""
        row = self.task_row(name)
        n = len(self.times) - 1  # samples recorded before this one
        for f in TRACE_FIELDS:
            col = row[f]
            fill = math.inf if f == "beta" else 0.0
            if len(col) < n:
                col.extend([fill] * (n - len(col)))
            col.append(float(values.get(f, fill)))

    def sample_aggregate(self, name, tasks) -> None:
        """Append one sample aggregating ``tasks`` under one row ``name``
        (min budget, summed queue depths and counters) — used for the lazy
        per-camera FC plane, where a per-task series would be 10k columns."""
        tasks = list(tasks)
        row = self.task_row(name)
        row["beta"].append(
            min((t.budget.min_budget() for t in tasks), default=math.inf)
        )
        row["queue"].append(sum(_queue_depth(t) for t in tasks))
        for fld, attr in STAT_FIELDS:
            row[fld].append(sum(getattr(t.stats, attr) for t in tasks))

    # -- analysis -------------------------------------------------------- #
    def tasks(self, prefix: str = "") -> List[str]:
        return sorted(n for n in self.series if n.startswith(prefix))

    def min_beta(self, prefix: str = "CR") -> List[float]:
        """Min over the matching tasks' budgets at each sample time."""
        names = self.tasks(prefix)
        if not names:
            return []
        cols = [self.series[n]["beta"] for n in names]
        return [min(c[i] for c in cols) for i in range(len(self.times))]

    def mean_batch(self, prefix: str = "CR") -> List[float]:
        """Mean batch size within each sampling interval (executed/batches
        deltas over the matching tasks)."""
        names = self.tasks(prefix)
        out: List[float] = []
        prev_e = prev_b = 0.0
        for i in range(len(self.times)):
            e = sum(self.series[n]["executed"][i] for n in names)
            b = sum(self.series[n]["batches"][i] for n in names)
            de, db = e - prev_e, b - prev_b
            out.append(de / db if db else 0.0)
            prev_e, prev_b = e, b
        return out

    def dropped_total(self, task: str) -> int:
        row = self.series[task]
        if not row["dp1"]:
            return 0
        return int(row["dp1"][-1] + row["dp2"][-1] + row["dp3"][-1])

    def _total_drops_at(self, i: int) -> int:
        return int(
            sum(
                row["dp1"][i] + row["dp2"][i] + row["dp3"][i]
                for row in self.series.values()
            )
        )

    def dropped_between(self, t0: float, t1: float) -> int:
        """Drops (all tasks, all drop points) accumulated between the last
        samples at or before ``t0`` and ``t1`` — the drop *wave* a
        perturbation window causes, as opposed to the run totals."""

        def idx_at_or_before(t: float) -> int:
            k = -1
            for i, ts in enumerate(self.times):
                if ts <= t:
                    k = i
                else:
                    break
            return k

        a = idx_at_or_before(t0)
        b = idx_at_or_before(t1)
        start = self._total_drops_at(a) if a >= 0 else 0
        end = self._total_drops_at(b) if b >= 0 else 0
        return end - start

    def budget_recovery(
        self, prefix: str = "CR", until: Optional[float] = None
    ) -> Dict[str, float]:
        """Budget trajectory around the spec's perturbation windows, over
        the min-budget series of the ``prefix`` module.

        ``pre`` is the last finite sample before the first window opens;
        ``dip`` the lowest sample from the window opening to the end of the
        trace (budget damage lags the window via signal round trips);
        ``low`` the trace-wide minimum (a bootstrap-era collapse, §4.5,
        shows up here even when it predates the window); ``post`` the final
        sample; ``recovery = post / pre`` (nan without a finite pre).  The
        acceptance bar for an adaptive batcher is ``recovery >= 0.9``
        (§4.5.2: probes + accepts re-inflate a collapsed budget).

        ``until`` bounds the series: samples after it are ignored, so
        ``post`` becomes the last finite sample at or before ``until``.
        The multi-query admission benchmark passes the generation horizon
        here — once sourcing stops, the drain window always re-inflates
        budgets, which would mask "still overloaded while serving".

        Caveat: drops upstream of ``prefix`` shield it — a bandwidth
        collapse whose late events die at the VA drop points leaves the CR
        series flat.  Check where the wave landed with
        :meth:`dropped_between` / the per-task ``dp*`` columns before
        reading a flat series as "unaffected".
        """
        windows = self.windows_or_default()
        t0 = min(w[0] for w in windows)
        beta = self.min_beta(prefix)
        pre = dip = low = post = math.nan
        for t, b in zip(self.times, beta):
            if until is not None and t > until:
                break
            if math.isinf(b):
                continue
            low = b if math.isnan(low) else min(low, b)
            if t < t0:
                pre = b
            else:
                dip = b if math.isnan(dip) else min(dip, b)
            post = b
        recovery = post / pre if pre and not math.isnan(pre) else math.nan
        return {"pre": pre, "dip": dip, "low": low, "post": post, "recovery": recovery}

    def windows_or_default(self) -> List[Tuple[float, float]]:
        windows = self.spec.windows()
        if not windows:
            windows = [(0.0, 0.0)]
        # An open-ended window "ends" at the last sample for analysis.
        last = self.times[-1] if self.times else 0.0
        return [(s, e if not math.isinf(e) else last) for s, e in windows]

    def digest(self) -> str:
        """Deterministic fingerprint of the whole trace (times, active-set
        series, every per-task series, quality metrics).  Floats are
        round-tripped through ``repr`` so equal traces hash equal and any
        single-sample drift changes the digest — the golden-trace test
        freezes this value."""
        h = hashlib.sha256()
        h.update(repr(self.times).encode())
        h.update(repr(self.active_cameras).encode())
        for name in sorted(self.series):
            row = self.series[name]
            h.update(name.encode())
            for f in TRACE_FIELDS:
                h.update(repr(row[f]).encode())
        if self.quality is not None:
            h.update(repr(sorted(self.quality.items())).encode())
        return h.hexdigest()

    def summary(self) -> Dict[str, float]:
        """Compact, picklable view for benchmark records and sweep rows."""
        out: Dict[str, float] = {"samples": len(self.times)}
        if self.times:
            rec = self.budget_recovery("CR")
            # Keys with no data (nan — e.g. drops-off runs never initialize
            # a budget) are omitted rather than emitted as nan/None: nan
            # breaks dict equality (frozen-summary tests), None breaks
            # float() parsers downstream.
            for key, val in (
                ("beta_pre", rec["pre"]),
                ("beta_low", rec["low"]),
                ("beta_post", rec["post"]),
                ("beta_recovery", rec["recovery"]),
            ):
                if not math.isnan(val):
                    out[key] = round(val, 4)
            out.update(
                # Task rows only: a per-query ``Q:<id>`` row's "queue" is
                # that query's whole-pipeline in-flight count, not a task
                # queue depth — it would dominate the max and misreport
                # pipeline queue pressure in multi-query runs.
                peak_queue=max(
                    (
                        max(row["queue"])
                        for name, row in self.series.items()
                        if not name.startswith("Q:")
                    ),
                    default=0,
                ),
                probes=sum(
                    int(row["probes"][-1]) for row in self.series.values() if row["probes"]
                ),
            )
        if self.quality is not None:
            out.update(self.quality)
        return out
