"""Single-query tracking scenario: the port (``device="cpu"``) against the
live JAX reference, config for config.

Everything except re-ID scores is compared for equality: summaries,
``reid_matched``, the latency list, drops and batch sizes per task, the
active-camera timeline and, for a dynamism run, the trace digest.  The
reference gets a world built for the test (``build_world``), so its
process-wide world cache is left as it was found.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.sim as jax_sim
from repro.sim.world import build_world as jax_build_world

import repro_torch.sim as torch_sim
from repro_torch.kernels import dispatch

torch.set_num_threads(1)

BASE = dict(num_cameras=300, duration_s=150.0)


def _collapse(mod):
    return dict(
        drops_enabled=True,
        dynamism=mod.DynamismSpec(
            perturbations=(mod.BandwidthCollapse(t_start=40.0, t_end=90.0, factor=0.03),),
        ),
    )


CONFIGS = {
    "base-dynamic": dict(tl="base", num_cameras=200, duration_s=100.0),
    "bfs-dynamic": dict(tl="bfs"),
    "wbfs-dynamic": dict(tl="wbfs"),
    "prob-dynamic": dict(tl="prob"),
    "bfs-static20": dict(tl="bfs", batching="static", static_batch=20),
    "bfs-nob": dict(tl="bfs", batching="nob"),
    "bfs-drops": dict(tl="bfs", drops_enabled=True),
    "bfs-embed128": dict(tl="bfs", embed_dim=128),
    "bfs-embed128-drops-avoid": dict(
        tl="bfs", embed_dim=128, drops_enabled=True, avoid_drop_positives=True
    ),
    "bfs-bwcollapse": _collapse,
}


def _config(mod, name):
    spec = CONFIGS[name]
    kw = dict(BASE)
    kw.update(spec(mod) if callable(spec) else spec)
    return mod.ScenarioConfig(**kw)


def _observed(res):
    return dict(
        summary=res.summary(),
        reid_matched=res.reid_matched,
        peak_active=res.peak_active,
        latencies=res.latencies,
        drops_by_task=res.drops_by_task,
        batch_sizes=res.batch_sizes,
        active_timeline=res.active_timeline,
        detections_on_time=res.detections_on_time,
        query_pushes=res.query_pushes,
        digest=res.trace.digest() if res.trace is not None else None,
    )


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_scenario_equals_reference(name):
    jcfg = _config(jax_sim, name)
    jcfg = dataclasses.replace(jcfg, world=jax_build_world(jax_sim.WorldKey.from_config(jcfg)))
    want = _observed(jax_sim.TrackingScenario(jcfg).run())

    tcfg = dataclasses.replace(_config(torch_sim, name), device="cpu")
    before = dispatch.stats()["reid_calls"]
    got = _observed(torch_sim.TrackingScenario(tcfg).run())

    assert got == want
    assert want["summary"]["source_events"] > 0
    calls = dispatch.stats()["reid_calls"] - before
    if tcfg.embed_dim:
        assert want["reid_matched"] > 0 and calls > 0
    else:
        assert calls == 0
    if tcfg.dynamism is not None:
        assert want["digest"] is not None


def test_device_field_stays_out_of_keys_and_summaries():
    a = torch_sim.ScenarioConfig(num_cameras=20, duration_s=5.0, device="cpu")
    b = dataclasses.replace(a, device="cuda")
    assert a == b and "device" not in repr(a)
    assert torch_sim.WorldKey.from_config(a) == torch_sim.WorldKey.from_config(b)
    assert {f.name for f in dataclasses.fields(a)} - {"device"} == {
        f.name for f in dataclasses.fields(jax_sim.ScenarioConfig)
    }


def test_publish_metrics_seam_raises():
    scn = torch_sim.TrackingScenario(
        torch_sim.ScenarioConfig(num_cameras=20, duration_s=5.0, device="cpu")
    )
    res = scn.run()
    with pytest.raises(NotImplementedError, match="obs"):
        scn.publish_metrics(None, res)
