"""Unit parity of the port's host core against ``repro.core``: Dijkstra
balls, budget signal sequences and the three batchers on seeded streams.
The host core is numpy and pure Python in both packages, so every result
is compared for equality."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batching as jb
from repro.core import budget as jbud
from repro.core import events as jev
from repro.core.roadnet import ResumableDijkstra as JaxDijkstra
from repro.core.roadnet import make_road_network as jax_make_road_network

from repro_torch.core import batching as tb
from repro_torch.core import budget as tbud
from repro_torch.core import events as tev
from repro_torch.core.roadnet import ResumableDijkstra, make_road_network

torch.set_num_threads(1)


def _xi(b):
    return 0.02 + 0.01 * b


@pytest.mark.parametrize("seed", [3, 17])
def test_resumable_dijkstra_balls_equal(seed):
    kw = dict(num_vertices=160, target_edges=450, mean_length_m=84.5, seed=seed)
    road_j, road_t = jax_make_road_network(**kw), make_road_network(**kw)
    np.testing.assert_array_equal(road_t.positions, road_j.positions)
    assert road_t.adjacency == road_j.adjacency
    for src in (0, 7, 101):
        dj, dt = JaxDijkstra(road_j, src), ResumableDijkstra(road_t, src)
        for radius in (0.0, 50.0, 300.0, 1200.0, 5000.0):
            assert dict(dt.ball(radius)) == dict(dj.ball(radius))
            assert dt.order == dj.order


def _budget_script(seed, n=400):
    """A seeded mix of records, rejects, accepts and explicit budgets over
    three downstream paths."""
    rng = np.random.default_rng(seed)
    ops = []
    for k in range(n):
        kind = rng.choice(["record", "reject", "accept", "set"], p=[0.5, 0.2, 0.2, 0.1])
        down = ["", "a", "b"][rng.integers(3)]
        eid = int(rng.integers(0, max(k, 1) + 5))
        vals = rng.uniform(0.0, 2.0, size=4).tolist()
        ops.append((str(kind), down, eid, vals, int(rng.integers(1, 25))))
    return ops


def _run_budget(mod, ev, ops):
    b = mod.TaskBudget("t", _xi, m_max=25, record_capacity=64)
    out = []
    for kind, down, eid, (v0, v1, v2, v3), m in ops:
        if kind == "record":
            b.record(eid, ev.EventRecord(departure=v0, queuing=v1, batch_size=m, xi=v2))
            r = None
        elif kind == "reject":
            r = b.on_reject(ev.RejectSignal(eid, v0 - 0.5, v1), down)
        elif kind == "accept":
            r = b.on_accept(ev.AcceptSignal(eid, v0, v3), down)
        else:
            b.set_budget(v3, down)
            r = None
        out.append((r, b.min_budget(), b.budget(down)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_task_budget_signal_sequences_equal(seed):
    ops = _budget_script(seed)
    got = _run_budget(tbud, tev, ops)
    want = _run_budget(jbud, jev, ops)
    assert got == want
    assert any(r is not None for r, _, _ in got)
    assert any(math.isfinite(m) for _, m, _ in got)


def _arrivals(seed, n=500):
    rng = np.random.default_rng(seed)
    # Bursty stream: exponential gaps at two rates, plus per-event slack.
    gaps = np.where(rng.uniform(size=n) < 0.3, rng.exponential(0.005, n), rng.exponential(0.08, n))
    return np.cumsum(gaps), rng.uniform(0.05, 0.6, n)


def _run_batcher(mod, ev, make, seed):
    batcher = make(mod)
    times, slack = _arrivals(seed)
    out = []
    for i, (t, s) in enumerate(zip(times.tolist(), slack.tolist())):
        due = batcher.flush_if_due(t)
        if due:
            out.append(("flush", t, [pe.event.key for pe in due]))
        e = ev.Event(header=ev.EventHeader(event_id=i, source_arrival=t), key=i, value=None)
        got = batcher.offer(mod.PendingEvent(event=e, arrival=t, deadline=t + s), t)
        if got:
            out.append(("offer", t, [pe.event.key for pe in got]))
        out.append(("due", batcher.next_due_time(), batcher.current_size))
    out.append(("take", [pe.event.key for pe in batcher.take()]))
    return out


BATCHERS = {
    "dynamic": lambda m: m.DynamicBatcher(_xi, m_max=25),
    "static": lambda m: m.StaticBatcher(_xi, batch_size=7),
    "nob": lambda m: m.NOBBatcher(_xi, m_max=25),
}


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("kind", sorted(BATCHERS))
def test_batchers_equal_on_seeded_stream(kind, seed):
    got = _run_batcher(tb, tev, BATCHERS[kind], seed)
    want = _run_batcher(jb, jev, BATCHERS[kind], seed)
    assert got == want
    assert sum(1 for row in got if row[0] in ("offer", "flush")) > 5


def test_nob_table_equal():
    assert tb.build_nob_table(_xi, 25) == jb.build_nob_table(_xi, 25)


def test_spotlight_kernel_seam_raises_until_its_slice():
    from repro_torch.core.tracking import TLProbabilistic, multi_source_spotlight

    road = make_road_network(num_vertices=60, target_edges=170, seed=2)
    with pytest.raises(NotImplementedError, match="spotlight_ball"):
        multi_source_spotlight(road, {0: 0}, [0], [100.0])
    tl = TLProbabilistic(road, {c: c for c in range(20)}, entity_speed=4.0)
    tl.track("e", 3, 0.0)
    assert tl.spotlight_multi(5.0)  # the Dijkstra path stays available
    with pytest.raises(NotImplementedError):
        tl.spotlight_multi(5.0, use_kernel=True)


def test_compile_verify_seam_raises(monkeypatch):
    from repro_torch.core.compile import compile_app
    from repro_torch.sim import ScenarioConfig, TrackingScenario

    scn = TrackingScenario(ScenarioConfig(num_cameras=20, duration_s=5.0, device="cpu"))
    with pytest.raises(NotImplementedError, match="verifier"):
        compile_app(scn.app, scn.world, scn.deployment, scn.sim, verify=True)
    monkeypatch.setenv("REPRO_ANALYSIS_VERIFY", "1")
    with pytest.raises(NotImplementedError, match="verifier"):
        TrackingScenario(ScenarioConfig(num_cameras=20, duration_s=5.0, device="cpu"))
    with pytest.raises(NotImplementedError, match="journal"):
        scn.compiled.restore({})
