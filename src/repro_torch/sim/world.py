"""Shared-world bundles for the sweep engine (one build per world key).

The paper's evaluation is a *grid* of scenarios (batching x dropping x
tracking-logic x camera-count sweeps) and most grid points share the exact
same world: road network, entity walk, camera placement, and the static
per-(src, dst) transit classification.  A :class:`WorldBundle` owns that
immutable state, built once per :class:`WorldKey` and shared by every
:class:`~repro_torch.sim.scenario.TrackingScenario` that uses it:

* **in-process cache** — ``get_world`` memoizes bundles in a small LRU, so
  the second 10k-camera scenario constructs in a fraction of the first's
  build time;
* **on-disk cache** — set ``REPRO_TORCH_WORLD_CACHE`` to a directory (or
  ``1`` for ``~/.cache/repro_torch/worlds``) and bundles are pickled across
  processes.  The variable and directory are the port's own, so the port and
  the JAX package never unpickle each other's classes.  Entries are keyed by a
  version-salted hash of the :class:`WorldKey`; bump
  :data:`WORLD_CACHE_VERSION` whenever world construction changes.

Bundles are *bit-identical* to what ``TrackingScenario.__init__`` used to
build inline: :meth:`WorldKey.from_config` replicates the old constructor's
parameter derivation exactly, so per-config ``summary()`` dicts are
unchanged by the refactor.

Sharing contract: everything in a bundle is treated as immutable by
consumers.  The one exception is ``embed_dim > 0`` camera networks, whose
embedding RNG is stateful — scenarios that need embeddings build their own
:class:`CameraNetwork` (still sharing the bundle's road + walk).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.roadnet import RoadNetwork, make_road_network

from .cameras import CameraNetwork, EntityWalk

__all__ = [
    "WorldKey",
    "WorldBundle",
    "get_world",
    "build_world",
    "world_cache_stats",
    "clear_world_cache",
    "WORLD_CACHE_VERSION",
]

#: Bump whenever RoadNetwork / EntityWalk / CameraNetwork construction
#: changes in a way that affects the built world: stale on-disk bundles
#: would otherwise silently break bit-identity with fresh builds.
WORLD_CACHE_VERSION = 1

_WORLDS: "OrderedDict[WorldKey, WorldBundle]" = OrderedDict()
_WORLDS_MAX = 8
_STATS = {
    "builds": 0,
    "memory_hits": 0,
    "disk_hits": 0,
    "disk_writes": 0,
    "disk_write_errors": 0,
}


@dataclass(frozen=True)
class WorldKey:
    """Identity of a shareable world: everything world construction reads."""

    num_cameras: int
    seed: int
    road_vertices: int
    road_edges: int
    mean_length_m: float
    entity_speed_mps: float
    walk_horizon_s: float
    fov_radius_m: float
    fps: float

    @classmethod
    def from_config(cls, cfg) -> "WorldKey":
        """Derive the key from a ``ScenarioConfig`` exactly the way the
        scenario constructor used to derive its world parameters."""
        num_vertices = cfg.road_vertices or max(1000, cfg.num_cameras)
        if num_vertices == 1000:
            road_edges = 2817
        else:
            # Keep the paper's edge density (2817/1000) and mean road length.
            road_edges = int(round(num_vertices * 2.817))
        return cls(
            num_cameras=int(cfg.num_cameras),
            seed=int(cfg.seed),
            road_vertices=int(num_vertices),
            road_edges=road_edges,
            mean_length_m=84.5,
            entity_speed_mps=float(cfg.entity_speed_mps),
            walk_horizon_s=float(cfg.duration_s) + 60.0,
            fov_radius_m=float(cfg.fov_radius_m),
            fps=float(cfg.fps),
        )


@dataclass
class WorldBundle:
    """Immutable world shared by every scenario with the same key."""

    key: WorldKey
    road: RoadNetwork
    walk: EntityWalk
    cameras: CameraNetwork
    build_seconds: float = 0.0
    #: (num_va, num_cr, num_nodes) -> {(src_task, dst_task): (latency, over_net)}.
    #: The static transit classification depends only on the deployment shape
    #: and the (constant) NetworkModel latency tiers, so scenarios sharing a
    #: world also share the memoized table (see DiscreteEventSimulator).
    transit_tables: Dict[Tuple[int, int, int], Dict] = field(
        default_factory=dict, repr=False
    )

    def csr(self):
        """CSR view of the road graph (built once, cached on the network)."""
        return self.road.csr()

    def transit_table(self, num_va: int, num_cr: int, num_nodes: int) -> Dict:
        dep = (int(num_va), int(num_cr), int(num_nodes))
        table = self.transit_tables.get(dep)
        if table is None:
            table = self.transit_tables[dep] = {}
        return table


def build_world(key: WorldKey) -> WorldBundle:
    """Uncached world construction — bit-identical to the pre-sweep
    ``TrackingScenario.__init__`` inline build for the same config."""
    t0 = time.perf_counter()
    road = make_road_network(
        num_vertices=key.road_vertices,
        target_edges=key.road_edges,
        mean_length_m=key.mean_length_m,
        seed=key.seed,
    )
    walk = EntityWalk(
        road,
        start_vertex=0,
        speed_mps=key.entity_speed_mps,
        duration_s=key.walk_horizon_s,
        seed=key.seed + 7,
    )
    cameras = CameraNetwork(
        road,
        walk,
        num_cameras=key.num_cameras,
        fov_radius_m=key.fov_radius_m,
        fps=key.fps,
        seed=key.seed + 13,
    )
    _STATS["builds"] += 1
    return WorldBundle(
        key=key,
        road=road,
        walk=walk,
        cameras=cameras,
        build_seconds=time.perf_counter() - t0,
    )


# --------------------------------------------------------------------- #
# On-disk cache                                                          #
# --------------------------------------------------------------------- #
def _disk_dir() -> Optional[str]:
    """Directory for pickled bundles, from ``REPRO_TORCH_WORLD_CACHE``:
    unset/empty/``0`` disables, ``1`` selects ``~/.cache/repro_torch/worlds``,
    anything else is used as the directory path."""
    raw = os.environ.get("REPRO_TORCH_WORLD_CACHE", "")
    if raw in ("", "0"):
        return None
    if raw == "1":
        return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "worlds")
    return raw


def _disk_path(key: WorldKey, root: str) -> str:
    digest = hashlib.sha1(
        repr((WORLD_CACHE_VERSION, key)).encode()
    ).hexdigest()[:20]
    return os.path.join(root, f"world_{digest}.pkl")


def _disk_load(key: WorldKey, root: str) -> Optional[WorldBundle]:
    path = _disk_path(key, root)
    try:
        with open(path, "rb") as f:
            payload = pickle.load(f)
    except (OSError, pickle.PickleError, EOFError, AttributeError):
        return None
    if (
        not isinstance(payload, dict)
        or payload.get("version") != WORLD_CACHE_VERSION
        or payload.get("key") != key
    ):
        return None
    bundle: WorldBundle = payload["bundle"]
    bundle.transit_tables = {}
    _STATS["disk_hits"] += 1
    return bundle


def _disk_store(bundle: WorldBundle, root: str) -> None:
    try:
        os.makedirs(root, exist_ok=True)
        payload = {
            "version": WORLD_CACHE_VERSION,
            "key": bundle.key,
            "bundle": WorldBundle(
                key=bundle.key,
                road=bundle.road,
                walk=bundle.walk,
                cameras=bundle.cameras,
                build_seconds=bundle.build_seconds,
            ),
        }
        fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, _disk_path(bundle.key, root))
        except BaseException:
            os.unlink(tmp)
            raise
        _STATS["disk_writes"] += 1
    # Cache is best-effort; never fail the build over it — but count the
    # miss so a persistently broken cache dir is observable in _STATS.
    # repro: noqa[EXC001] — intentional best-effort swallow, counted above.
    except Exception:
        _STATS["disk_write_errors"] += 1


# --------------------------------------------------------------------- #
# Front door                                                             #
# --------------------------------------------------------------------- #
def get_world(key_or_config) -> WorldBundle:
    """Fetch (or build) the shared world for a :class:`WorldKey` or a
    ``ScenarioConfig``; the on-disk layer is governed by
    ``REPRO_TORCH_WORLD_CACHE`` (see :func:`_disk_dir`)."""
    key = (
        key_or_config
        if isinstance(key_or_config, WorldKey)
        else WorldKey.from_config(key_or_config)
    )
    bundle = _WORLDS.get(key)
    if bundle is not None:
        _WORLDS.move_to_end(key)
        _STATS["memory_hits"] += 1
        return bundle
    root = _disk_dir()
    bundle = _disk_load(key, root) if root else None
    if bundle is None:
        bundle = build_world(key)
        if root:
            _disk_store(bundle, root)
    _WORLDS[key] = bundle
    while len(_WORLDS) > _WORLDS_MAX:
        _WORLDS.popitem(last=False)
    return bundle


def world_cache_stats() -> Dict[str, int]:
    stats = dict(_STATS)
    stats["resident"] = len(_WORLDS)
    return stats


def clear_world_cache(*, disk: bool = False) -> None:
    """Drop in-process bundles (and optionally the on-disk entries)."""
    _WORLDS.clear()
    for k in _STATS:
        _STATS[k] = 0
    if disk:
        root = _disk_dir()
        if root and os.path.isdir(root):
            for name in os.listdir(root):
                if name.startswith("world_") and name.endswith(".pkl"):
                    try:
                        os.unlink(os.path.join(root, name))
                    except OSError:
                        pass
