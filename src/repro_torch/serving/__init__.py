"""Serving: Anveshak-scheduled stages in front of batched torch steps, and
the re-ID tower they serve.  The port's counterpart of ``repro.serving``;
the LM engine, sampling and the journal have not been carried over yet."""

from .reid import ReidTower, embed_frames, init_reid_tower, match, tower_from_jax
from .scheduler import (
    ServedStage,
    StageRequest,
    StageResult,
    calibrate_xi,
    lower_app_stages,
    lower_stage,
)

__all__ = [
    "ReidTower", "ServedStage", "StageRequest", "StageResult", "calibrate_xi",
    "embed_frames", "init_reid_tower", "lower_app_stages", "lower_stage",
    "match", "tower_from_jax",
]
