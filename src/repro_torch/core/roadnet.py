"""Road-network model and spotlight search (paper §2.3, §5.1 workload).

The paper extracts a 7 km^2 circular region around IISc Bangalore from
OpenStreetMap: 1,000 vertices, 2,817 edges, average road length 84.5 m.
OSM is not available offline, so :func:`make_road_network` generates a
deterministic random-geometric graph matched to those statistics.  Cameras
are placed on vertices; the *spotlight* is the set of cameras reachable from
the last-seen location within ``speed * elapsed`` metres (weighted BFS =
Dijkstra over road lengths) or within a hop-ball assuming a fixed edge length
(unweighted BFS, the paper's TL-BFS).

Spotlight-search machinery:

* :meth:`RoadNetwork.weighted_ball` / :meth:`RoadNetwork.hop_ball` — the
  from-scratch reference searches.
* :class:`ResumableDijkstra` — incremental ball: the spotlight radius only
  grows while the entity is in a blind spot, so each TL tick resumes the
  previous frontier instead of recomputing from the source.
* :meth:`RoadNetwork.csr` — a CSR (``indptr``/``indices``/``weights``) view
  of the graph for the batched `repro_torch.kernels.spotlight_ball` relaxation
  kernel.

``make_road_network`` computes pairwise geometry in row chunks (never the
full V x V matrix), so 10k+-vertex networks build in seconds while remaining
bit-identical to the original construction for any seed.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

__all__ = [
    "RoadNetwork",
    "ResumableDijkstra",
    "clear_network_cache",
    "make_road_network",
]


@dataclass
class RoadNetwork:
    """Undirected road graph with per-edge lengths in metres."""

    positions: np.ndarray  # (V, 2) coordinates in metres
    adjacency: List[List[Tuple[int, float]]]  # vertex -> [(neighbor, length)]
    _csr_cache: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = field(
        default=None, repr=False, compare=False
    )

    @property
    def num_vertices(self) -> int:
        return len(self.adjacency)

    @property
    def num_edges(self) -> int:
        return sum(len(nbrs) for nbrs in self.adjacency) // 2

    @property
    def mean_edge_length(self) -> float:
        total, count = 0.0, 0
        for u, nbrs in enumerate(self.adjacency):
            for v, w in nbrs:
                if v > u:
                    total += w
                    count += 1
        return total / max(count, 1)

    # ------------------------------------------------------------------ #
    # CSR view (for the Pallas spotlight kernel + vectorized consumers)   #
    # ------------------------------------------------------------------ #
    def csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(indptr, indices, weights)`` in CSR form; built once, cached.

        ``indptr`` is ``(V+1,)`` int32, ``indices`` the flattened neighbor
        ids (both directions of every undirected edge), ``weights`` the
        float64 road lengths; ``lengths`` per row are
        ``indptr[v+1]-indptr[v]``.
        """
        if self._csr_cache is None:
            degrees = np.fromiter(
                (len(nbrs) for nbrs in self.adjacency), dtype=np.int64, count=self.num_vertices
            )
            indptr = np.zeros(self.num_vertices + 1, dtype=np.int32)
            np.cumsum(degrees, out=indptr[1:])
            indices = np.empty(int(indptr[-1]), dtype=np.int32)
            weights = np.empty(int(indptr[-1]), dtype=np.float64)
            k = 0
            for nbrs in self.adjacency:
                for v, w in nbrs:
                    indices[k] = v
                    weights[k] = w
                    k += 1
            self._csr_cache = (indptr, indices, weights)
        return self._csr_cache

    # ------------------------------------------------------------------ #
    # Spotlight searches                                                  #
    # ------------------------------------------------------------------ #
    def weighted_ball(self, source: int, radius: float) -> Dict[int, float]:
        """Dijkstra ball: vertices within ``radius`` metres of ``source``
        along the road network, with their distances (TL-WBFS)."""
        dist: Dict[int, float] = {source: 0.0}
        heap: List[Tuple[float, int]] = [(0.0, source)]
        while heap:
            d, u = heapq.heappop(heap)
            if d > dist.get(u, math.inf):
                continue
            for v, w in self.adjacency[u]:
                nd = d + w
                if nd <= radius and nd < dist.get(v, math.inf):
                    dist[v] = nd
                    heapq.heappush(heap, (nd, v))
        return dist

    def hop_ball(self, source: int, max_hops: int) -> Dict[int, int]:
        """Unweighted BFS ball: vertices within ``max_hops`` edges (TL-BFS
        assumes a fixed road length for all edges)."""
        seen: Dict[int, int] = {source: 0}
        frontier = [source]
        hops = 0
        while frontier and hops < max_hops:
            hops += 1
            nxt: List[int] = []
            for u in frontier:
                for v, _ in self.adjacency[u]:
                    if v not in seen:
                        seen[v] = hops
                        nxt.append(v)
            frontier = nxt
        return seen

    def nearest_vertex(self, xy: Sequence[float]) -> int:
        d2 = np.sum((self.positions - np.asarray(xy)) ** 2, axis=1)
        return int(np.argmin(d2))


class ResumableDijkstra:
    """Incremental Dijkstra ball from a fixed source.

    During a blind spot the spotlight radius only grows, so each expansion
    resumes the saved frontier: the total work over a whole blind-spot
    episode is one full Dijkstra, not one per TL tick.  ``ball(r)`` returns
    the same mapping as ``RoadNetwork.weighted_ball(source, r)`` — the
    returned dict is *live* (owned by the search); callers must not mutate
    it.
    """

    __slots__ = ("network", "source", "_dist", "_heap", "_settled", "order")

    def __init__(self, network: RoadNetwork, source: int) -> None:
        self.network = network
        self.source = source
        self._dist: Dict[int, float] = {source: 0.0}
        self._heap: List[Tuple[float, int]] = [(0.0, source)]
        self._settled: Dict[int, float] = {}
        #: vertices in settle order (nondecreasing distance); consumers can
        #: keep an index to process only newly settled vertices per tick.
        self.order: List[int] = []

    def ball(self, radius: float) -> Dict[int, float]:
        heap = self._heap
        if heap and heap[0][0] <= radius:
            dist = self._dist
            settled = self._settled
            order = self.order
            adjacency = self.network.adjacency
            pop, push = heapq.heappop, heapq.heappush
            inf = math.inf
            while heap and heap[0][0] <= radius:
                d, u = pop(heap)
                if u in settled:
                    continue
                settled[u] = d
                order.append(u)
                for v, w in adjacency[u]:
                    nd = d + w
                    if nd < dist.get(v, inf):
                        dist[v] = nd
                        push(heap, (nd, v))
        return self._settled


# Construction is deterministic in its arguments and the result is treated
# as immutable everywhere, so identical requests (e.g. every scenario of a
# benchmark sweep at seed 0) share one instance.
_NETWORK_CACHE: Dict[Tuple[int, int, float, int], "RoadNetwork"] = {}
_NETWORK_CACHE_MAX = 8


def clear_network_cache() -> None:
    """Drop memoized road networks (cold-baseline measurement support)."""
    _NETWORK_CACHE.clear()


def make_road_network(
    num_vertices: int = 1000,
    target_edges: int = 2817,
    mean_length_m: float = 84.5,
    seed: int = 0,
) -> RoadNetwork:
    """Deterministic OSM-like graph matched to the paper's §5.1 statistics.

    Vertices are sampled in a disc; each vertex connects to its nearest
    neighbours until the edge budget is met, then positions are rescaled so
    the mean edge length matches ``mean_length_m``.  The construction keeps
    the graph connected (a relative-neighbourhood backbone via a nearest
    -neighbour chain) so BFS/Dijkstra spotlights behave like a road network.

    Pairwise distances are evaluated in row chunks with a top-k partition
    per row, so memory stays O(chunk * V) and time O(V^2) with small
    constants — a 10k-vertex network builds in a few seconds.  Identical
    parameter tuples return a shared cached instance.
    """
    cache_key = (num_vertices, target_edges, mean_length_m, seed)
    cached = _NETWORK_CACHE.get(cache_key)
    if cached is not None:
        return cached
    rng = np.random.default_rng(seed)
    # Disc of area ~7 km^2 -> radius sqrt(7e6/pi) m; exact radius is
    # irrelevant because we rescale to the target mean edge length below.
    radius = math.sqrt(7.0e6 / math.pi)
    r = radius * np.sqrt(rng.uniform(0.0, 1.0, size=num_vertices))
    theta = rng.uniform(0.0, 2.0 * math.pi, size=num_vertices)
    pos = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)

    def pair_d2(us: np.ndarray, vs: np.ndarray) -> np.ndarray:
        """Squared distances between row sets, elementwise identical to the
        full (V, V) broadcast the original construction used."""
        return np.sum((pos[us][:, None, :] - pos[vs][None, :, :]) ** 2, axis=-1)

    # k-NN edges, deduplicated, preferring short roads.
    k = max(2, int(math.ceil(2.0 * target_edges / num_vertices)) + 1)
    knn = np.empty((num_vertices, k), dtype=np.int64)
    chunk = max(1, min(num_vertices, int(2**22 // max(num_vertices, 1)) or 1))
    all_idx = np.arange(num_vertices)
    for s in range(0, num_vertices, chunk):
        e = min(s + chunk, num_vertices)
        d2c = pair_d2(all_idx[s:e], all_idx)
        d2c[np.arange(e - s), np.arange(s, e)] = np.inf  # no self edges
        # Top-k by distance: partition then order the k candidates by value
        # (no ties occur for continuous random geometry, so this matches a
        # full argsort of the row).
        part = np.argpartition(d2c, k - 1, axis=1)[:, :k]
        row_order = np.argsort(np.take_along_axis(d2c, part, axis=1), axis=1, kind="stable")
        knn[s:e] = np.take_along_axis(part, row_order, axis=1)

    edges: Set[Tuple[int, int]] = set()
    # Backbone: chain each vertex to its nearest neighbour (keeps components
    # few), then add increasing-rank kNN edges until the budget is met.
    for u in range(num_vertices):
        v = int(knn[u, 0])
        edges.add((min(u, v), max(u, v)))
    for rank in range(1, k):
        if len(edges) >= target_edges:
            break
        for u in range(num_vertices):
            if len(edges) >= target_edges:
                break
            v = int(knn[u, rank])
            edges.add((min(u, v), max(u, v)))

    # Connect stray components through nearest cross-component pairs.
    parent = list(range(num_vertices))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        parent[find(a)] = find(b)

    for u, v in edges:
        union(u, v)
    roots = {find(u) for u in range(num_vertices)}
    while len(roots) > 1:
        comp: Dict[int, List[int]] = {}
        for u in range(num_vertices):
            comp.setdefault(find(u), []).append(u)
        comps = list(comp.values())
        base = np.asarray(comps[0])
        best = (math.inf, -1, -1)
        for other in comps[1:]:
            other_arr = np.asarray(other)
            block = pair_d2(base, other_arr)
            flat = int(np.argmin(block))
            bi, oi = divmod(flat, len(other))
            val = float(block[bi, oi])
            if val < best[0]:
                best = (val, int(base[bi]), int(other_arr[oi]))
        _, u, v = best
        edges.add((min(u, v), max(u, v)))
        union(u, v)
        roots = {find(x) for x in range(num_vertices)}

    def edge_d2(u: int, v: int) -> float:
        # Elementwise identical to an entry of the full (V, V) broadcast.
        diff0 = pos[u, 0] - pos[v, 0]
        diff1 = pos[u, 1] - pos[v, 1]
        return diff0 * diff0 + diff1 * diff1

    # Rescale so the mean edge length matches the paper (weights use the
    # unscaled geometry times `scale`, like the original full-matrix code).
    lengths = [math.sqrt(edge_d2(u, v)) for u, v in edges]
    scale = mean_length_m / (sum(lengths) / len(lengths))

    adjacency: List[List[Tuple[int, float]]] = [[] for _ in range(num_vertices)]
    for u, v in sorted(edges):
        w = math.sqrt(edge_d2(u, v)) * scale
        adjacency[u].append((v, w))
        adjacency[v].append((u, w))
    network = RoadNetwork(positions=pos * scale, adjacency=adjacency)
    if len(_NETWORK_CACHE) >= _NETWORK_CACHE_MAX:
        _NETWORK_CACHE.pop(next(iter(_NETWORK_CACHE)))
    _NETWORK_CACHE[cache_key] = network
    return network
