"""Re-ID matcher: the port's plain version and dispatch against the JAX
reference on the CPU, and the no-fallback routing rules.  On a GPU the
kernel is also held against the JAX reference here; its comparison with its
plain version lives in ``test_torch_cuda.py``, which imports no jax so that
it runs on a GPU machine without JAX.

Tolerances: scores ``atol=1e-6, rtol=1e-5`` (f32 products summed in another
order); ``best`` equal; ``match`` equal wherever the score is more than
``1e-5`` from the threshold.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.kernels import dispatch as jax_dispatch
from repro.kernels.reid_match.kernel import reid_match_pallas
from repro.kernels.reid_match.ref import reid_match_ref as jax_reid_match_ref

from repro_torch.kernels import _build
from repro_torch.kernels import dispatch
from repro_torch.kernels.reid_match import kernel as reid_kernel
from repro_torch.kernels.reid_match import ops as reid_ops
from repro_torch.kernels.reid_match.ref import reid_match_ref

torch.set_num_threads(1)

THRESHOLD = 0.1


def _inputs(N, Q, D, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    # Plant near-duplicates so some rows match well above the threshold.
    for i in range(0, N, 5):
        g[i] = q[i % Q] + rng.normal(scale=0.1, size=D).astype(np.float32)
    return g, q


def assert_reid_close(got, want, threshold):
    s1, b1, m1 = (np.asarray(x) for x in got)
    s2, b2, m2 = (np.asarray(x) for x in want)
    assert s1.shape == s2.shape and s1.dtype == np.float32
    np.testing.assert_allclose(s1, s2, atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(b1.astype(np.int32), b2.astype(np.int32))
    away = np.abs(s2 - threshold) > 1e-5
    np.testing.assert_array_equal(m1.astype(bool)[away], m2.astype(bool)[away])


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Q", [1, 3])
@pytest.mark.parametrize("N", [1, 7, 33, 1030])
def test_plain_version_matches_jax_ref_and_pallas(N, Q, D):
    g, q = _inputs(N, Q, D, seed=N * 100 + Q * 10 + D)
    got = reid_match_ref(torch.from_numpy(g), torch.from_numpy(q), threshold=THRESHOLD)
    assert got[0].dtype == torch.float32
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    want_ref = jax_reid_match_ref(g, q, threshold=THRESHOLD)
    want_pallas = reid_match_pallas(g, q, threshold=THRESHOLD, interpret=True)
    assert_reid_close(got, want_ref, THRESHOLD)
    assert_reid_close(got, want_pallas, THRESHOLD)


def test_plain_version_masks_pad_queries_and_handles_no_queries():
    g, q = _inputs(9, 3, 64, seed=5)
    pad = np.zeros((8, 64), np.float32)
    pad[:3] = q
    # A pad row that would beat every real query must still never win.
    pad[5] = g[0] * 10.0
    got = reid_match_ref(torch.from_numpy(g), torch.from_numpy(pad), threshold=THRESHOLD, nq=3)
    want = jax_reid_match_ref(g, q, threshold=THRESHOLD)
    assert_reid_close(got, want, THRESHOLD)
    s, b, m = reid_match_ref(torch.from_numpy(g), torch.from_numpy(pad), threshold=-1.0, nq=0)
    assert torch.all(torch.isneginf(s)) and torch.all(b == 0) and not torch.any(m)


def test_plain_version_first_index_wins_ties():
    q = np.eye(4, 64, dtype=np.float32)
    q[2] = q[0]  # queries 0 and 2 tie for every row
    g = q[[0, 1, 3]] * 3.0
    _, best, _ = reid_match_ref(torch.from_numpy(g), torch.from_numpy(q))
    assert best.tolist() == [0, 1, 3]


@pytest.mark.parametrize("D", [64, 128])
def test_dispatch_matches_jax_dispatch_with_padded_queries(D):
    """Q = 3 queries in a bucket of 8, several gallery sizes; the same call
    sequence moves both packages' counters alike."""
    rng = np.random.default_rng(D)
    queries = rng.normal(size=(3, D)).astype(np.float32)
    dispatch.reset_stats()
    before = jax_dispatch.stats()
    for N in (1, 2, 8, 11, 40):
        gallery = rng.normal(size=(N, D)).astype(np.float32)
        gallery[::3] = queries[N % 3] + 0.05 * gallery[::3]
        got = dispatch.reid_match(gallery, queries, threshold=THRESHOLD, device="cpu")
        assert all(t.device.type == "cpu" and t.shape == (N,) for t in got)
        want = jax_dispatch.reid_match(gallery, queries, threshold=THRESHOLD)
        assert_reid_close(got, want, THRESHOLD)
    after = jax_dispatch.stats()
    port = dispatch.stats()
    for k in ("reid_calls", "device_cache_hits", "device_cache_misses"):
        assert port[k] == after[k] - before[k], k
    assert port["reid_calls"] == 5
    # One upload of the long-lived query block, then hits.
    assert (port["device_cache_misses"], port["device_cache_hits"]) == (1, 4)
    # Buckets of N: 8 (N <= 8), 16, 64; the query bucket is 8.
    assert port["bucket_shapes"] == 3
    assert dispatch.profile()["compiles"] == {"reid": 3}


def test_dispatch_bucket_rounding_and_validation():
    assert [dispatch.bucket(n) for n in (1, 8, 9, 16, 17)] == [8, 8, 16, 16, 32]
    assert dispatch.bucket(3, minimum=1) == 4
    with pytest.raises(ValueError):
        dispatch.bucket(0)
    with pytest.raises(ValueError):
        dispatch.reid_match(np.zeros(4, np.float32), np.zeros((1, 4), np.float32), device="cpu")
    with pytest.raises(ValueError):
        dispatch.reid_match(np.zeros((2, 4), np.float32), np.zeros((1, 5), np.float32), device="cpu")


def test_dispatch_query_cache_is_weak_and_per_array():
    rng = np.random.default_rng(9)
    q = rng.normal(size=(1, 64)).astype(np.float32)
    g = rng.normal(size=(4, 64)).astype(np.float32)
    dispatch.reset_stats()
    dispatch.reid_match(g, q, device="cpu")
    dispatch.reid_match(g, q, device="cpu")
    assert dispatch.stats()["device_cache_hits"] == 1
    key = (id(q), "cpu")
    assert key in dispatch._DEVICE_CACHE
    del q
    assert key not in dispatch._DEVICE_CACHE


def test_cpu_tensors_never_touch_the_loader(monkeypatch):
    def _no_build(name):
        raise AssertionError(f"CPU path tried to build {name}")

    monkeypatch.setattr(_build, "build", _no_build)
    launches = reid_kernel.LAUNCHES
    g, q = _inputs(33, 3, 128, seed=1)
    reid_ops.reid_match(torch.from_numpy(g), torch.from_numpy(q))
    dispatch.reid_match(g, q, device="cpu")
    assert reid_kernel.LAUNCHES == launches == 0
    assert reid_kernel._LIB is None


def test_kernel_wrapper_raises_on_cpu_tensors():
    g, q = _inputs(4, 1, 64, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        reid_kernel.reid_match_cuda(torch.from_numpy(g), torch.from_numpy(q))


def test_entry_points_raise_without_a_gpu(monkeypatch):
    """``device`` defaults to "cuda"; with no GPU every entry point raises
    instead of carrying on on the CPU."""
    from repro_torch._device import resolve_device
    from repro_torch.serving import ServedStage, init_reid_tower
    from repro_torch.sim import ScenarioConfig, TrackingScenario

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, q = _inputs(4, 1, 64, seed=3)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dispatch.reid_match(g, q)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        init_reid_tower(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ServedStage("CR", lambda x: x, lambda b: 0.01)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TrackingScenario(ScenarioConfig(num_cameras=20, duration_s=5.0))
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.cuda
def test_cuda_kernel_matches_jax_reference_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    for N, Q, D in ((1, 1, 128), (33, 3, 64), (1030, 3, 128)):
        g, q = _inputs(N, Q, D, seed=N + Q + D)
        got = reid_ops.reid_match(
            torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda(), threshold=THRESHOLD
        )
        torch.cuda.synchronize()
        want = jax_reid_match_ref(g, q, threshold=THRESHOLD)
        assert_reid_close([t.cpu() for t in got], want, THRESHOLD)
