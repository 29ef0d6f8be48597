"""repro_torch: the PyTorch/CUDA port of the Anveshak reproduction.

A second package beside the JAX reference (``repro``), with the same
subpackage layout (``repro_torch.core``, ``repro_torch.sim``,
``repro_torch.kernels``, ``repro_torch.serving``, ``repro_torch.models``), so
each ``repro.X`` has a ``repro_torch.X`` to be held against.  It imports
torch and numpy, never jax or ``repro``.  Entry points run on the GPU
(``device="cuda"``) unless the caller passes ``device="cpu"``.

The root lazily re-exports the entry points of the ported slice (PEP 562),
so ``from repro_torch import TrackingScenario`` works without importing the
whole stack at startup.
"""

_SIM_EXPORTS = ("ScenarioConfig", "ScenarioResult", "TrackingScenario")
_SERVING_EXPORTS = (
    "ReidTower",
    "ServedStage",
    "StageRequest",
    "StageResult",
    "calibrate_xi",
    "embed_frames",
    "init_reid_tower",
    "match",
    "tower_from_jax",
)

__all__ = list(_SIM_EXPORTS + _SERVING_EXPORTS)


def __getattr__(name):
    if name in _SIM_EXPORTS:
        from repro_torch import sim

        return getattr(sim, name)
    if name in _SERVING_EXPORTS:
        from repro_torch import serving

        return getattr(serving, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
