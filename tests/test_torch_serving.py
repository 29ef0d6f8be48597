"""Serving plane: the re-ID tower carried across from the JAX reference,
matching through the port's ``match``, and ``ServedStage`` serving the same
seeded request stream as the reference's under an injected clock.

Tolerances: embeddings ``atol=1e-5`` (f32 products and RMS norms reduced in
another order); re-ID as in ``test_torch_reid_match``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.serving as jax_serving
from repro.core.compile import DeploymentSpec as JaxDeploymentSpec
from repro.core.compile import linear_xi as jax_linear_xi
from repro.core.dataflow import ModuleSpec as JaxModuleSpec
from repro.core.dataflow import TrackingApp as JaxTrackingApp
from repro.core.dataflow import fc_is_active as jax_fc_is_active
from repro.core.roadnet import make_road_network as jax_make_road_network
from repro.core.tracking import TLBase as JaxTLBase

import repro_torch.serving as torch_serving
from repro_torch.core.compile import DeploymentSpec, linear_xi
from repro_torch.core.dataflow import ModuleSpec, TrackingApp, fc_is_active
from repro_torch.core.roadnet import make_road_network
from repro_torch.core.tracking import TLBase
from repro_torch.kernels.reid_match import kernel as reid_kernel

from test_torch_reid_match import assert_reid_close

torch.set_num_threads(1)

D_IN, D_HIDDEN, D_EMBED, DEPTH = 128, 256, 64, 2


@pytest.fixture(scope="module")
def towers():
    params = jax_serving.init_reid_tower(
        jax.random.PRNGKey(0), d_in=D_IN, d_hidden=D_HIDDEN, d_embed=D_EMBED, depth=DEPTH
    )
    host = jax.tree.map(np.asarray, params)
    return params, torch_serving.tower_from_jax(host, device="cpu")


def test_tower_from_jax_embeds_allclose(towers):
    params, tower = towers
    frames = np.random.default_rng(1).normal(size=(37, D_IN)).astype(np.float32)
    want = np.asarray(jax_serving.embed_frames(params, frames))
    got = torch_serving.embed_frames(tower, frames)
    assert got.dtype == torch.float32 and got.shape == (37, D_EMBED)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_tower_layout_and_seeded_init():
    t1 = torch_serving.init_reid_tower(torch.Generator().manual_seed(3), device="cpu")
    t2 = torch_serving.init_reid_tower(torch.Generator().manual_seed(3), device="cpu")
    assert t1.proj_in.shape == (D_IN, D_HIDDEN) and t1.proj_out.shape == (D_HIDDEN, D_EMBED)
    assert len(t1.blocks) == DEPTH
    for a, b in zip(t1.parameters(), t2.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("threshold", [0.3, 0.9])
def test_match_agrees_with_reference(towers, threshold):
    params, tower = towers
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(50, D_IN)).astype(np.float32)
    frames[::7] = frames[3] + rng.normal(scale=0.05, size=(8, D_IN)).astype(np.float32)
    queries = np.asarray(jax_serving.embed_frames(params, frames[3:4]))
    want = jax_serving.match(params, frames, queries, threshold=threshold)
    got = torch_serving.match(tower, frames, queries, threshold=threshold)
    assert_reid_close(got, want, threshold)
    assert bool(np.asarray(want[2])[3])
    assert reid_kernel.LAUNCHES == 0  # CPU tensors take the plain version


class FakeClock:
    """Advances a fixed step per read; the loop sets it to each arrival."""

    def __init__(self, step=0.0007):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def _stream(seed, n=300):
    rng = np.random.default_rng(seed)
    payloads = rng.normal(size=(n, D_IN)).astype(np.float32)
    gaps = rng.exponential(0.02, n)
    ages = np.where(rng.uniform(size=n) < 0.2, rng.uniform(0.2, 1.5, n), rng.uniform(0, 0.05, n))
    avoid = rng.uniform(size=n) < 0.05
    signal = rng.choice(["none", "accept", "reject"], size=n, p=[0.8, 0.1, 0.1])
    return payloads, np.cumsum(gaps), ages, avoid, signal


def _serve(mod, step_fn, seed, drops):
    clock = FakeClock()
    xi = lambda b: 0.004 + 0.002 * b
    stage = mod.ServedStage(
        "CR", step_fn, xi, gamma=1.0, m_max=16, buckets=(1, 4, 16),
        drops_enabled=drops, clock=clock,
        **({"device": "cpu"} if mod is torch_serving else {}),
    )
    stage.budget.set_budget(0.6)
    payloads, times, ages, avoid, signal = _stream(seed)
    results, last_done = [], None
    for i in range(len(payloads)):
        clock.t = max(clock.t, float(times[i]))
        if signal[i] == "accept" and last_done is not None:
            stage.on_accept(last_done, epsilon=0.2, xi_bar=0.01)
        elif signal[i] == "reject" and last_done is not None:
            stage.on_reject(last_done, epsilon=0.1, q_bar=0.02)
        req = mod.StageRequest(
            payloads[i], source_time=clock.t - float(ages[i]), event_id=i,
            avoid_drop=bool(avoid[i]),
        )
        for r in (stage.submit(req) or []) + (stage.flush() or []):
            results.append(r)
            if not r.dropped:
                last_done = r.event_id
    clock.t += 10.0
    results += stage.flush() or []
    return stage, results


@pytest.mark.parametrize("drops", [True, False])
def test_served_stage_serves_the_same_stream(towers, drops):
    params, tower = towers
    jax_step = lambda x: jax_serving.embed_frames(params, x)
    torch_step = lambda x: torch_serving.embed_frames(tower, x)
    js, jr = _serve(jax_serving, jax_step, seed=11, drops=drops)
    ts, tr = _serve(torch_serving, torch_step, seed=11, drops=drops)
    key = lambda rs: [(r.event_id, r.dropped, r.batch_size, r.latency) for r in rs]
    assert key(tr) == key(jr)
    assert ts.stats == js.stats
    assert ts.stats["arrived"] == 300 and ts.stats["batches"] > 10
    if drops:
        assert ts.stats["dropped_dp1"] > 0 and ts.stats["dropped"] < 300
    assert ts.budget.min_budget() == js.budget.min_budget()
    for a, b in zip(tr, jr):
        if not a.dropped:
            assert isinstance(a.output, torch.Tensor) and a.output.shape == (D_EMBED,)
            np.testing.assert_allclose(a.output.numpy(), np.asarray(b.output), atol=1e-5, rtol=0)


def test_calibrate_xi_and_query_block(towers):
    _, tower = towers
    step = lambda x: torch_serving.embed_frames(tower, x)
    xi = torch_serving.calibrate_xi(step, (D_IN,), buckets=(1, 4), repeats=1)
    assert xi(1) > 0.0 and xi(2) > 0.0
    stage = torch_serving.ServedStage("CR", step, xi, device="cpu")
    stage.set_queries(np.ones((3, D_EMBED), np.float32))
    assert stage._query_block.shape == (8, D_EMBED) and stage._nq == 3
    assert stage._query_block.device.type == "cpu"
    stage.set_queries(np.zeros((0, D_EMBED), np.float32))
    assert stage._query_block is None
    with pytest.raises(NotImplementedError, match="obs"):
        stage.publish_metrics(None)


def _app(road_mod, tl_cls, spec_cls, app_cls, fc, xi_fn):
    road = road_mod(num_vertices=30, target_edges=84, seed=0)
    return app_cls(
        name="served", fc=fc,
        va=lambda c, f, s: [(c, x) for x in f],
        cr=lambda c, v, s: [(c, x) for x in v],
        tl=tl_cls(road, {0: 0}), gamma=0.75,
        specs={"VA": spec_cls(m_max=7, xi=xi_fn(0.01, 0.002)), "CR": spec_cls(m_max=5)},
    )


def test_lower_app_stages_resolves_like_reference():
    japp = _app(jax_make_road_network, JaxTLBase, JaxModuleSpec, JaxTrackingApp,
                jax_fc_is_active, jax_linear_xi)
    tapp = _app(make_road_network, TLBase, ModuleSpec, TrackingApp, fc_is_active, linear_xi)
    step = lambda x: torch.as_tensor(x)
    jdep, tdep = JaxDeploymentSpec(drops_enabled=False), DeploymentSpec(drops_enabled=False)
    jst = jax_serving.lower_app_stages(japp, jdep, {"VA": step, "CR": step},
                                       payload_shapes={"CR": (4,)})
    tst = torch_serving.lower_app_stages(tapp, tdep, {"VA": step, "CR": step},
                                         payload_shapes={"CR": (4,)}, device="cpu")
    assert sorted(tst) == sorted(jst) == ["CR", "VA"]
    for m in ("VA", "CR"):
        assert tst[m].name == jst[m].name
        assert tst[m].budget.m_max == jst[m].budget.m_max
        assert tst[m].gamma == jst[m].gamma
        assert tst[m].drops_enabled == jst[m].drops_enabled
    assert tst["VA"].xi(3) == jst["VA"].xi(3)
    assert tst["CR"].upstream is tst["VA"]
