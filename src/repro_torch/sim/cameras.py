"""Camera network + entity random-walk workload (paper §5.1).

The paper simulates 1000 camera feeds at 1 fps over a 7 km^2 road network:
the tracked entity random-walks the roads at 1 m/s; a camera's frame is a
*true positive* (contains the entity) while the entity is inside its FOV,
else a *true negative* drawn from CUHK03.  We reproduce the generator with
synthetic frame payloads: a frame carries ``has_entity`` plus (optionally) a
feature embedding so the JAX re-id models have real tensors to chew on.

The scenario engine sources frames once per tick for the whole *active* set,
so :meth:`CameraNetwork.frames_at` evaluates visibility for a batch of
cameras with one vectorized distance computation instead of one numpy call
per camera.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.roadnet import RoadNetwork

__all__ = ["Frame", "EntityWalk", "CameraNetwork"]


@dataclass(slots=True)
class Frame:
    """One camera frame event payload."""

    camera_id: int
    timestamp: float
    has_entity: bool
    # Median 2.9 kB JPG in the paper; used for network transit modelling.
    size_bytes: float = 2900.0
    embedding: Optional[np.ndarray] = None


class EntityWalk:
    """Random walk of the tracked entity along road edges at fixed speed.

    Precomputes the trajectory (vertex path + positions over time) so every
    query ``position(t)`` / ``at_vertex_near(t)`` is deterministic.
    """

    def __init__(
        self,
        network: RoadNetwork,
        start_vertex: int,
        speed_mps: float = 1.0,
        duration_s: float = 900.0,
        seed: int = 7,
    ) -> None:
        self.network = network
        self.speed = float(speed_mps)
        rng = np.random.default_rng(seed)
        self.times: List[float] = [0.0]
        self.vertices: List[int] = [start_vertex]
        t, u, prev = 0.0, start_vertex, -1
        while t < duration_s:
            nbrs = network.adjacency[u]
            choices = [(v, w) for v, w in nbrs if v != prev] or list(nbrs)
            v, w = choices[int(rng.integers(len(choices)))]
            t += w / self.speed
            self.times.append(t)
            self.vertices.append(v)
            prev, u = u, v
        # Vectorized lookup tables for position(t).
        self._times_arr = np.asarray(self.times, dtype=np.float64)
        verts = np.asarray(self.vertices, dtype=np.int64)
        self._seg_p0 = network.positions[verts[:-1]]
        self._seg_p1 = network.positions[verts[1:]]

    def position(self, t: float) -> np.ndarray:
        """Entity (x, y) at time t, linearly interpolated along the edge."""
        idx = int(np.searchsorted(self._times_arr, t, side="right")) - 1
        idx = max(0, min(idx, len(self.vertices) - 2))
        t0, t1 = self.times[idx], self.times[idx + 1]
        p0 = self._seg_p0[idx]
        p1 = self._seg_p1[idx]
        a = 0.0 if t1 <= t0 else min(max((t - t0) / (t1 - t0), 0.0), 1.0)
        return p0 * (1 - a) + p1 * a


class CameraNetwork:
    """Cameras placed on road vertices surrounding the walk's start vertex.

    ``visible(camera_id, t)`` — is the entity inside that camera's FOV at t.
    ``frames_at(t, camera_ids)`` — batched per-tick frame sourcing.
    """

    def __init__(
        self,
        network: RoadNetwork,
        walk: EntityWalk,
        num_cameras: int = 1000,
        fov_radius_m: float = 25.0,
        fps: float = 1.0,
        embed_dim: int = 0,
        seed: int = 13,
    ) -> None:
        self.network = network
        self.walk = walk
        self.fov_radius = float(fov_radius_m)
        self.fps = float(fps)
        self.embed_dim = int(embed_dim)
        self._rng = np.random.default_rng(seed)
        # Place cameras on the vertices nearest the start (paper: "placed on
        # vertices surrounding the starting vertex").
        start_pos = network.positions[walk.vertices[0]]
        order = np.argsort(np.sum((network.positions - start_pos) ** 2, axis=1))
        chosen = order[: min(num_cameras, network.num_vertices)]
        self.camera_vertices: Dict[int, int] = {
            cam_id: int(v) for cam_id, v in enumerate(chosen)
        }
        # Camera id -> position lookup (camera ids are contiguous 0..N-1 by
        # construction, so a plain array indexes by camera id).
        self._cam_positions = network.positions[np.asarray(chosen, dtype=np.int64)]
        self._entity_embedding = (
            self._rng.normal(size=(embed_dim,)).astype(np.float32) if embed_dim else None
        )

    @property
    def num_cameras(self) -> int:
        return len(self.camera_vertices)

    def visible(self, camera_id: int, t: float) -> bool:
        pos = self.walk.position(t)
        cam_pos = self.network.positions[self.camera_vertices[camera_id]]
        return float(np.linalg.norm(pos - cam_pos)) <= self.fov_radius

    def visible_batch(self, camera_ids: np.ndarray, t: float) -> np.ndarray:
        """Vectorized ``visible`` for a batch of camera ids at one instant.

        Matches the scalar path bit-for-bit: the per-camera distance is the
        same ``sqrt(dx^2 + dy^2)`` float64 computation.
        """
        pos = self.walk.position(t)
        diff = self._cam_positions[camera_ids] - pos
        dist = np.sqrt(diff[:, 0] ** 2 + diff[:, 1] ** 2)
        return dist <= self.fov_radius

    def frame(self, camera_id: int, t: float) -> Frame:
        has = self.visible(camera_id, t)
        emb: Optional[np.ndarray] = None
        if self.embed_dim:
            emb = self._draw_embedding(has)
        return Frame(camera_id=camera_id, timestamp=t, has_entity=has, embedding=emb)

    def frames_at(self, t: float, camera_ids: np.ndarray) -> List[Frame]:
        """Frames for all ``camera_ids`` at time ``t`` (one entity-position
        interpolation + one vectorized FOV test for the whole batch)."""
        if self.embed_dim:
            # Embedding draws consume the RNG per camera in id order; keep
            # the scalar path so the stream stays identical.
            return [self.frame(int(c), t) for c in camera_ids]
        has = self.visible_batch(camera_ids, t)
        return [
            Frame(camera_id=int(c), timestamp=t, has_entity=bool(h))
            for c, h in zip(camera_ids, has)
        ]

    def _draw_embedding(self, has_entity: bool) -> np.ndarray:
        if has_entity:
            noise = self._rng.normal(scale=0.1, size=(self.embed_dim,))
            return (self._entity_embedding + noise).astype(np.float32)
        return self._rng.normal(size=(self.embed_dim,)).astype(np.float32)

    @property
    def entity_embedding(self) -> Optional[np.ndarray]:
        return self._entity_embedding
