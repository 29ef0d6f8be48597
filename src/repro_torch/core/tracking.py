"""Tracking Logic (TL) strategies (paper §2.2.4, Alg. 1, §5.2.2).

TL receives per-frame detections from CR.  On a *negative* detection (entity
lost) it **expands** the search space — the spotlight — and activates the
cameras inside it; on a *positive* detection it **contracts** the spotlight
to the detecting camera.  Strategies:

* :class:`TLBase`  — all cameras always active (contemporary systems).
* :class:`TLBFS`   — hop-ball spotlight assuming a fixed road length.
* :class:`TLWBFS`  — Dijkstra-ball spotlight using true road lengths (Alg. 1).
* :class:`TLProbabilistic` — App 4: a naive-Bayes-style likelihood over paths;
  activates the smallest camera set covering ``coverage`` probability mass.
  Also exposes a *multi-entity* path (:meth:`TLProbabilistic.track` /
  :meth:`TLProbabilistic.spotlight_multi`) that searches all tracked
  entities' balls at once — optionally through the batched
  ``repro_torch.kernels.spotlight_ball`` CSR relaxation kernel.

All spotlight strategies are configured with the entity's expected peak speed
``es`` (m/s): the spotlight radius grows as ``es * (now - last_seen_time)``
while the entity is in a blind-spot (Rate of Expansion, §5.2.1).

The weighted-ball strategies are *incremental*: the radius only grows during
a blind spot, so each TL tick resumes the previous Dijkstra frontier
(:class:`repro_torch.core.roadnet.ResumableDijkstra`) instead of recomputing the
ball from scratch — O(newly reached road) per tick instead of O(ball).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .roadnet import ResumableDijkstra, RoadNetwork

__all__ = [
    "Detection",
    "TrackingLogic",
    "TLBase",
    "TLBFS",
    "TLWBFS",
    "TLProbabilistic",
    "multi_source_spotlight",
]


def multi_source_spotlight(
    network: RoadNetwork,
    camera_vertices: Dict[int, int],
    sources: Sequence[int],
    radii: Sequence[float],
    *,
    coverage: Optional[float] = None,
) -> List[Set[int]]:
    """Per-source spotlight camera sets via one batched multi-source
    ``spotlight_ball`` min-plus relaxation.

    The batched relaxation is a device kernel the port has not carried over
    yet: it lands with the multi-query slice (multi-query plane +
    ``spotlight_ball`` kernel).  Single-query tracking never calls this; its
    callers are ``TLProbabilistic.spotlight_multi(use_kernel=True)`` and the
    multi-query plane.
    """
    raise NotImplementedError(
        "multi_source_spotlight needs the spotlight_ball kernel, which lands "
        "with the port's multi-query slice (multi-query plane + "
        "spotlight_ball); use spotlight_multi(use_kernel=False)"
    )


@dataclass(slots=True)
class Detection:
    """A CR verdict for one frame: which camera, was the entity present."""

    camera_id: int
    positive: bool
    timestamp: float


class TrackingLogic:
    """Base class: maintains last-seen state and the active camera set."""

    def __init__(
        self,
        network: RoadNetwork,
        camera_vertices: Dict[int, int],
        entity_speed: float = 4.0,
        min_radius_m: float = 0.0,
    ) -> None:
        self.network = network
        self.camera_vertices = dict(camera_vertices)  # camera_id -> vertex
        self._vertex_cameras: Dict[int, List[int]] = {}
        for cam, v in self.camera_vertices.items():
            self._vertex_cameras.setdefault(v, []).append(cam)
        self.entity_speed = float(entity_speed)
        self.min_radius_m = float(min_radius_m)
        self.last_seen_camera: Optional[int] = None
        self.last_seen_time: Optional[float] = None
        self.active: Set[int] = set(self.camera_vertices)  # all on at start

    # ------------------------------------------------------------------ #
    def cameras_in_vertices(self, vertices: Iterable[int]) -> Set[int]:
        out: Set[int] = set()
        vc = self._vertex_cameras
        for v in vertices:
            cams = vc.get(v)
            if cams:
                out.update(cams)
        return out

    def spotlight(self, now: float) -> Set[int]:
        """Camera set for the current blind-spot duration.  Subclasses
        override; the default keeps everything active."""
        return set(self.camera_vertices)

    # ------------------------------------------------------------------ #
    def update(self, detections: Sequence[Detection], now: float) -> Set[int]:
        """Process a batch of CR detections; returns the new active set.

        Positive detection => contract to the detecting camera (§2.2.4);
        none => expand the spotlight from the last-seen location.
        """
        positives = [d for d in detections if d.positive]
        if positives:
            latest = max(positives, key=lambda d: d.timestamp)
            self.last_seen_camera = latest.camera_id
            self.last_seen_time = latest.timestamp
            self.active = {latest.camera_id}
        else:
            self.active = self.spotlight(now)
        return set(self.active)


class TLBase(TrackingLogic):
    """Keep every camera active (the paper's baseline; does not scale)."""

    def spotlight(self, now: float) -> Set[int]:
        return set(self.camera_vertices)

    def update(self, detections: Sequence[Detection], now: float) -> Set[int]:
        for d in detections:
            if d.positive:
                self.last_seen_camera = d.camera_id
                self.last_seen_time = d.timestamp
        self.active = set(self.camera_vertices)
        return set(self.active)


class _SpotlightTL(TrackingLogic):
    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        # Incremental-ball state: valid while the source stays fixed and the
        # radius keeps growing (one blind-spot episode).
        self._search: Optional[ResumableDijkstra] = None
        self._search_radius: float = -math.inf
        self._ball_cams: Set[int] = set()
        self._consumed: int = 0

    def _radius_m(self, now: float) -> float:
        if self.last_seen_time is None:
            return math.inf  # never seen: search everywhere
        elapsed = max(now - self.last_seen_time, 0.0)
        return self.min_radius_m + self.entity_speed * elapsed

    def _source_vertex(self) -> Optional[int]:
        if self.last_seen_camera is None:
            return None
        return self.camera_vertices.get(self.last_seen_camera)

    def _incremental_ball(self, src: int, radius: float) -> Dict[int, float]:
        """Resume (or restart) the Dijkstra ball; returns the live settled
        map, identical to ``weighted_ball(src, radius)``."""
        search = self._search
        if search is None or search.source != src or radius < self._search_radius:
            search = self._search = ResumableDijkstra(self.network, src)
            self._ball_cams = set()
            self._consumed = 0
        self._search_radius = radius
        return search.ball(radius)

    def _incremental_ball_cams(self, src: int, radius: float) -> Set[int]:
        """Cameras inside the incremental ball; folds only *newly settled*
        vertices into the cached camera set."""
        self._incremental_ball(src, radius)
        search = self._search
        order = search.order
        if self._consumed < len(order):
            vc = self._vertex_cameras
            cams = self._ball_cams
            for v in order[self._consumed :]:
                found = vc.get(v)
                if found:
                    cams.update(found)
            self._consumed = len(order)
        return self._ball_cams


class TLBFS(_SpotlightTL):
    """Spotlight via unweighted BFS with an assumed fixed road length."""

    def __init__(self, *args, fixed_edge_length_m: float = 84.5, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.fixed_edge_length_m = float(fixed_edge_length_m)

    def spotlight(self, now: float) -> Set[int]:
        src = self._source_vertex()
        radius = self._radius_m(now)
        if src is None or math.isinf(radius):
            return set(self.camera_vertices)
        hops = int(math.ceil(radius / self.fixed_edge_length_m))
        ball = self.network.hop_ball(src, hops)
        return self.cameras_in_vertices(ball)


class TLWBFS(_SpotlightTL):
    """Spotlight via weighted BFS (Dijkstra) over true road lengths (Alg. 1).

    Aware of exact segment lengths, its spotlight grows in finer steps and
    stays smaller than TL-BFS for the same blind-spot duration (§5.2.2).
    The ball is expanded incrementally across ticks."""

    def spotlight(self, now: float) -> Set[int]:
        src = self._source_vertex()
        radius = self._radius_m(now)
        if src is None or math.isinf(radius):
            return set(self.camera_vertices)
        return set(self._incremental_ball_cams(src, radius))


class TLProbabilistic(_SpotlightTL):
    """App 4: likelihood-weighted activation.

    Assigns each reachable camera a likelihood that the entity's path reaches
    it — a naive-Bayes combination of (a) road-distance decay from the last
    seen location and (b) a learned/uniform prior over turns (vertex degree).
    Activates the smallest set covering ``coverage`` of the probability mass,
    so it can keep the active set tighter than pure reachability.

    Multi-entity mode: :meth:`track` registers additional entity queries
    (each with its own last-seen state); :meth:`spotlight_multi` unions the
    per-entity coverage sets, evaluating all Dijkstra balls either
    incrementally in Python or as one batched CSR relaxation via the
    ``spotlight_ball`` kernel (``use_kernel=True``).
    """

    def __init__(self, *args, coverage: float = 0.9, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.coverage = float(coverage)
        # entity id -> (last seen vertex, last seen time)
        self.entities: Dict[Any, Tuple[int, float]] = {}
        self._entity_searches: Dict[Any, ResumableDijkstra] = {}

    # -- single-entity (paper App 4) ----------------------------------- #
    def spotlight(self, now: float) -> Set[int]:
        src = self._source_vertex()
        radius = self._radius_m(now)
        if src is None or math.isinf(radius):
            return set(self.camera_vertices)
        ball = self._incremental_ball(src, radius)
        cams = self._incremental_ball_cams(src, radius)
        if not cams:
            return set()
        return self._coverage_set(ball, cams, radius)

    def _coverage_set(
        self, ball: Dict[int, float], cams: Iterable[int], radius: float
    ) -> Set[int]:
        # Likelihood: exponential decay with distance, normalized.
        scores: List[Tuple[float, int]] = []
        scale = max(radius, 1.0)
        adjacency = self.network.adjacency
        camera_vertices = self.camera_vertices
        for cam in cams:
            v = camera_vertices[cam]
            d = ball.get(v, radius)
            deg = max(len(adjacency[v]), 1)
            # Random-walk heuristic: mass dilutes with distance and branching.
            scores.append((math.exp(-2.0 * d / scale) / deg, cam))
        total = sum(s for s, _ in scores)
        scores.sort(reverse=True)
        chosen: Set[int] = set()
        acc = 0.0
        threshold = self.coverage * total
        for s, cam in scores:
            chosen.add(cam)
            acc += s
            if acc >= threshold:
                break
        return chosen

    # -- multi-entity -------------------------------------------------- #
    def track(self, entity: Any, camera_id: int, timestamp: float) -> None:
        """Register (or refresh) an entity query's last positive sighting."""
        vertex = self.camera_vertices[camera_id]
        self.entities[entity] = (vertex, timestamp)
        self._entity_searches.pop(entity, None)  # contraction: restart ball

    def untrack(self, entity: Any) -> None:
        self.entities.pop(entity, None)
        self._entity_searches.pop(entity, None)

    def _entity_radius(self, last_time: float, now: float) -> float:
        return self.min_radius_m + self.entity_speed * max(now - last_time, 0.0)

    def spotlight_multi(self, now: float, use_kernel: bool = False) -> Set[int]:
        """Union of per-entity coverage sets for all tracked entities."""
        if not self.entities:
            return set()
        if use_kernel:
            return self._spotlight_multi_kernel(now)
        chosen: Set[int] = set()
        for entity, (vertex, last_time) in self.entities.items():
            radius = self._entity_radius(last_time, now)
            search = self._entity_searches.get(entity)
            if search is None or search.source != vertex:
                search = ResumableDijkstra(self.network, vertex)
                self._entity_searches[entity] = search
            ball = search.ball(radius)
            cams = self.cameras_in_vertices(ball)
            if cams:
                chosen |= self._coverage_set(ball, cams, radius)
        return chosen

    def _spotlight_multi_kernel(self, now: float) -> Set[int]:
        """Batched path: delegate to the shared multi-source ball
        implementation (:func:`multi_source_spotlight`) — one bucket-padded
        ``spotlight_ball`` relaxation for all entities' balls, then
        vectorized per-entity coverage selection, unioned."""
        items = list(self.entities.items())
        per_entity = multi_source_spotlight(
            self.network,
            self.camera_vertices,
            [v for _, (v, _) in items],
            [self._entity_radius(t, now) for _, (_, t) in items],
            coverage=self.coverage,
        )
        chosen: Set[int] = set()
        for cams in per_entity:
            chosen |= cams
        return chosen
