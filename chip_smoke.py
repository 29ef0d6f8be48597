"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the ``track_person`` flow, through the entry
points a user calls: the re-ID tower served through a budgeted, batched
``ServedStage``, matching through the hand-written CUDA ``reid_match``
kernel, then the single-query tracking scenario at 1000 cameras, whose VA
re-ID goes through the same kernel.  Phases:

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: the CUDA kernel from this checkout's sources;
3. kernel against its plain PyTorch version at the listed shapes, and its
   time beside the plain version's, a library yardstick's and its bound;
4. serve: 300 requests through ``ServedStage``, outputs held against the
   same tower on the CPU, matches through the kernel;
5. track: the 1000-camera scenario on the card, held equal to the same run
   on the CPU.

Every phase asserts.  The kernel's launch count is set to 0 just before
the main path (phases 4-5) and read just after.  The last two lines are a
``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``; any
failure exits non-zero before them.  Without CUDA the script exits non-zero
and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

# Reid path shapes: one VA batch of N frames against the tracked entity's
# query block, padded to its bucket of 8 with one real row, at D = 128.
PATH_N, PATH_Q, PATH_NQ, PATH_D = 1, 8, 1, 128
THRESHOLD = 0.1
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, *, warmup=20, iters=200, repeats=5) -> float:
    """Median over ``repeats`` of CUDA-event time per call of ``fn``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def reid_bound_ms(N: int, nq: int, D: int):
    """Least time for the matcher's work on these inputs: each gallery row
    and each used query row read once, 9 bytes per row written; f32 flops
    for the norm (2*D), the division (D) and nq dot products (2*D each)."""
    bytes_moved = N * D * 4 + nq * D * 4 + 9 * N
    flops = N * D * (3 + 2 * nq)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_reid(got, want, threshold):
    """Max |score error|; asserts best equal and match equal off-threshold."""
    s1, b1, m1 = (t.cpu().numpy() for t in got)
    s2, b2, m2 = (t.cpu().numpy() for t in want)
    finite = np.isfinite(s2)
    assert np.array_equal(np.isfinite(s1), finite), "score finiteness differs"
    assert np.allclose(s1[finite], s2[finite], atol=1e-6, rtol=1e-5), "scores differ"
    assert np.array_equal(b1, b2), "best query differs"
    away = np.abs(s2 - threshold) > 1e-5
    assert np.array_equal(m1[away], m2[away]), "match differs"
    return float(np.max(np.abs(s1[finite] - s2[finite]), initial=0.0))


def phase_environment():
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        out = smi.stdout.strip() if smi.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    log(out.splitlines()[0] if out else "nvidia-smi: not available")
    name = torch.cuda.get_device_name(0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()} tf32_matmul {torch.backends.cuda.matmul.allow_tf32}")
    return name


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build("reid_match")
    info = _build.build_log("reid_match")
    log(f"[build] reid_match.cu -> {os.path.relpath(info['path'], ROOT)} "
        f"in {time.perf_counter() - t0:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def phase_kernel(dev):
    from repro_torch.kernels.reid_match import kernel as K
    from repro_torch.kernels.reid_match.ref import normalize_rows, reid_match_ref

    rng = np.random.default_rng(0)
    max_err = 0.0
    n_checked = 0
    for N in (1, 25, 32, 1000, 4097):
        for Q, nq in ((1, 1), (3, 3), (3, 2), (8, 8), (8, 1), (8, 0)):
            for D in (64, 128):
                g = rng.normal(size=(N, D)).astype(np.float32)
                q = rng.normal(size=(Q, D)).astype(np.float32)
                g[::4] = q[0] + 0.1 * g[::4]
                gd, qd = torch.from_numpy(g).to(dev), torch.from_numpy(q).to(dev)
                got = K.reid_match_cuda(gd, qd, nq=nq, threshold=THRESHOLD)
                torch.cuda.synchronize()
                want = reid_match_ref(gd, qd, nq=nq, threshold=THRESHOLD)
                max_err = max(max_err, compare_reid(got, want, THRESHOLD))
                n_checked += 1
    log(f"[kernel] {n_checked} shapes agree with the plain version, max |score err| {max_err:.3e}")

    timings = []
    for N in (PATH_N, 32, 4097, 262144):
        g = torch.randn((N, PATH_D), device=dev)
        q = torch.zeros((PATH_Q, PATH_D), device=dev)
        q[:PATH_NQ] = torch.randn((PATH_NQ, PATH_D), device=dev)
        qn = normalize_rows(q).contiguous()
        outs = (torch.empty(N, device=dev), torch.empty(N, dtype=torch.int32, device=dev),
                torch.empty(N, dtype=torch.bool, device=dev))
        ms = cuda_time_ms(lambda: K.launch(g, qn, PATH_NQ, THRESHOLD, *outs))
        wrapper_ms = cuda_time_ms(lambda: K.reid_match_cuda(g, q, nq=PATH_NQ, threshold=THRESHOLD))
        plain_ms = cuda_time_ms(lambda: reid_match_ref(g, q, nq=PATH_NQ, threshold=THRESHOLD))

        def library():
            gn = torch.nn.functional.normalize(g, dim=-1, eps=1e-6)
            qv = torch.nn.functional.normalize(q[:PATH_NQ], dim=-1, eps=1e-6)
            s, b = torch.max(gn @ qv.T, dim=-1)
            return s, b, s >= THRESHOLD

        library_ms = cuda_time_ms(library)
        bound_ms, bound_by = reid_bound_ms(N, PATH_NQ, PATH_D)
        row = dict(N=N, Q=PATH_Q, nq=PATH_NQ, D=PATH_D, kernel_ms=ms, wrapper_ms=wrapper_ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        timings.append(row)
        log(f"[kernel] timing {json.dumps(row)}")
    return max_err, timings


def phase_serve(dev):
    from repro_torch.kernels.reid_match import kernel as K
    from repro_torch.kernels.reid_match.ops import reid_match
    from repro_torch.kernels.reid_match.ref import reid_match_ref
    from repro_torch.serving import (ServedStage, StageRequest, calibrate_xi, embed_frames,
                                     init_reid_tower, match)

    tower = init_reid_tower(torch.Generator().manual_seed(0), d_in=128, d_hidden=256,
                            d_embed=64, device=dev)
    tower_cpu = init_reid_tower(torch.Generator().manual_seed(0), d_in=128, d_hidden=256,
                                d_embed=64, device="cpu")
    step = lambda x: embed_frames(tower, x)
    buckets = (1, 4, 16, 32)
    xi = calibrate_xi(step, (128,), buckets=buckets)
    log("[serve] xi(b) ms: " + ", ".join(f"{b}:{xi(b) * 1e3:.4f}" for b in buckets))
    stage = ServedStage("CR", step, xi, gamma=1.0, m_max=32, buckets=buckets, device=dev)
    # A 100 ms completion budget, as accept/reject signals would teach the
    # stage: with none (the bootstrap) it streams every request alone.
    stage.budget.set_budget(0.1)
    rng = np.random.default_rng(0)
    entity = rng.normal(size=(1, 128)).astype(np.float32)
    query = embed_frames(tower, entity)
    frames, results = {}, []
    t0 = time.perf_counter()
    for i in range(300):
        is_entity = i % 37 == 0
        frame = (entity[0] + rng.normal(scale=0.05, size=128)).astype(np.float32) \
            if is_entity else rng.normal(size=128).astype(np.float32)
        req = StageRequest(frame, source_time=time.monotonic())
        frames[req.event_id] = (frame, is_entity)
        results += stage.submit(req) or []
        results += stage.flush() or []
    while stage.batcher.current_size:  # the open batch runs at its due time
        time.sleep(max(stage.next_due_time() - time.monotonic(), 0.0))
        results += stage.flush() or []
    served = [r for r in results if not r.dropped]
    matches = 0
    for r in served:  # the track_person loop: each served embedding through the kernel
        _, _, hit = reid_match(r.output[None, :].to(dev), query, threshold=0.7)
        matches += int(hit[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert stage.stats["arrived"] == 300 and served, stage.stats
    assert len(results) == 300 and stage.stats["batches"] < 300, stage.stats
    outs = torch.stack([r.output for r in served])
    want = embed_frames(tower_cpu, np.stack([frames[r.event_id][0] for r in served]))
    emb_err = float((outs - want).abs().max())
    assert emb_err < 1e-4, f"served embeddings differ from the CPU tower by {emb_err}"
    n_entity = sum(frames[r.event_id][1] for r in served)
    assert matches == n_entity, (matches, n_entity)
    # The full CR stage through the port's match on a burst of frames.
    burst = np.stack([f for f, _ in frames.values()])
    got = match(tower, burst, query, threshold=0.7)
    want_m = reid_match_ref(embed_frames(tower_cpu, burst), query.cpu(), threshold=0.7)
    compare_reid(got, want_m, 0.7)
    assert int(got[2].sum()) == sum(e for _, e in frames.values())
    log(f"[serve] {len(served)} served of 300 in {wall:.3f} s, matches {matches}, "
        f"stats {stage.stats}, embed max err {emb_err:.3e}, launches so far {K.LAUNCHES}")


def phase_track(dev):
    from repro_torch.sim import ScenarioConfig, TrackingScenario

    cfg = dict(num_cameras=1000, duration_s=300.0, tl="wbfs", tl_peak_speed=4.0,
               batching="dynamic", m_max=25, embed_dim=128)
    t0 = time.perf_counter()
    res = TrackingScenario(ScenarioConfig(**cfg, device=str(dev))).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, cfg


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU; nothing to run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(torch.device("cuda", 0))


def run(dev) -> int:
    name = phase_environment()
    phase_build()
    max_err, timings = phase_kernel(dev)

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.reid_match import kernel as K
    from repro_torch.sim import ScenarioConfig, TrackingScenario

    # ---- main path: counts from 0, read right after ------------------- #
    K.LAUNCHES = 0
    phase_serve(dev)
    serve_launches = K.LAUNCHES
    dispatch.reset_stats()
    res, wall, cfg = phase_track(dev)
    launches = K.LAUNCHES
    track_launches = launches - serve_launches
    reid_calls = dispatch.stats()["reid_calls"]
    assert serve_launches > 0, "serve phase launched no kernel"
    assert track_launches > 0 and track_launches == reid_calls, (track_launches, reid_calls)

    summary = res.summary()
    log(f"[track] cuda summary {json.dumps(summary)} reid_matched {res.reid_matched} "
        f"wall {wall:.3f} s launches {track_launches}")
    t0 = time.perf_counter()
    ref = TrackingScenario(ScenarioConfig(**cfg, device="cpu")).run()
    log(f"[track] cpu run wall {time.perf_counter() - t0:.3f} s")
    assert summary == ref.summary(), (summary, ref.summary())
    assert res.reid_matched == ref.reid_matched > 0, (res.reid_matched, ref.reid_matched)
    assert summary["source_events"] > 0 and summary["positives_completed"] > 0

    path = next(t for t in timings if t["N"] == PATH_N)
    kernels = [{
        "name": "reid_match",
        "route": "cuda",
        "source": "src/repro_torch/csrc/reid_match.cu",
        "replaces": "src/repro/kernels/reid_match/kernel.py:54",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": path["kernel_ms"],
        "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"],
        "bound_by": path["bound_by"],
        "library_ms": path["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
