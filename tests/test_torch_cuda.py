"""Card-only tests of the port's CUDA kernel (marker ``cuda``).

The CUDA kernel has no CPU mode, so each test skips, with its reason, on a
host without a GPU.  This file imports torch and the port only (no jax),
so it runs on a GPU machine that has no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: scores ``atol=1e-6, rtol=1e-5`` against the plain version on
the same card (sums reduced in another order); ``best`` equal; ``match``
equal wherever the score is more than ``1e-5`` from the threshold.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch
from repro_torch.kernels.reid_match import kernel as reid_kernel
from repro_torch.kernels.reid_match import ops as reid_ops
from repro_torch.kernels.reid_match.ref import reid_match_ref

torch.set_num_threads(1)

THRESHOLD = 0.1
SKIP_REASON = "needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip(SKIP_REASON)
    return torch.device("cuda")


def _inputs(N, Q, D, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    for i in range(0, N, 5):
        g[i] = q[i % Q] + rng.normal(scale=0.1, size=D).astype(np.float32)
    return g, q


def _assert_close(got, want):
    s1, b1, m1 = (t.cpu().numpy() for t in got)
    s2, b2, m2 = (t.cpu().numpy() for t in want)
    np.testing.assert_allclose(s1, s2, atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(b1, b2)
    away = np.abs(s2 - THRESHOLD) > 1e-5
    np.testing.assert_array_equal(m1[away], m2[away])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 30])
@pytest.mark.parametrize("Q,nq", [(1, 1), (3, 3), (8, 1), (8, 5), (3, 0)])
@pytest.mark.parametrize("N", [1, 25, 32, 1000, 4097])
def test_kernel_matches_plain_version(card, N, Q, nq, D):
    g, q = _inputs(N, Q, D, seed=N + 10 * Q + D)
    gd, qd = torch.from_numpy(g).to(card), torch.from_numpy(q).to(card)
    launches = reid_kernel.LAUNCHES
    got = reid_ops.reid_match(gd, qd, nq=nq, threshold=THRESHOLD)
    torch.cuda.synchronize()
    assert reid_kernel.LAUNCHES == launches + 1
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert got[2].dtype == torch.bool and all(t.is_cuda for t in got)
    _assert_close(got, reid_match_ref(gd, qd, nq=nq, threshold=THRESHOLD))


@pytest.mark.cuda
def test_kernel_first_index_wins_ties(card):
    q = np.eye(4, 64, dtype=np.float32)
    q[2] = q[0]
    g = q[[0, 1, 3]] * 3.0
    _, best, _ = reid_ops.reid_match(torch.from_numpy(g).to(card), torch.from_numpy(q).to(card))
    assert best.tolist() == [0, 1, 3]


@pytest.mark.cuda
def test_kernel_wrapper_validates(card):
    g = torch.zeros((4, 64), device=card)
    q = torch.zeros((2, 64), device=card)
    with pytest.raises(TypeError):
        reid_kernel.reid_match_cuda(g.double(), q)
    with pytest.raises(ValueError, match="contiguous"):
        reid_kernel.reid_match_cuda(torch.zeros((64, 4), device=card).T, q)
    with pytest.raises(ValueError):
        reid_kernel.reid_match_cuda(g, q, nq=3)
    with pytest.raises(ValueError):
        reid_kernel.reid_match_cuda(g, torch.zeros((2, 32), device=card))
    with pytest.raises(ValueError):
        reid_ops.reid_match(g, q.cpu())


@pytest.mark.cuda
def test_dispatch_on_the_card_equals_the_cpu(card):
    rng = np.random.default_rng(7)
    queries = rng.normal(size=(3, 128)).astype(np.float32)
    launches = reid_kernel.LAUNCHES
    for N in (1, 9, 25):
        gallery = rng.normal(size=(N, 128)).astype(np.float32)
        got = dispatch.reid_match(gallery, queries, threshold=THRESHOLD, device="cuda")
        assert all(t.is_cuda for t in got)
        want = dispatch.reid_match(gallery, queries, threshold=THRESHOLD, device="cpu")
        _assert_close(got, want)
    assert reid_kernel.LAUNCHES == launches + 3
