"""Stackless threaded-BVH traversal: the port of ``theia_tpu/ops/bvh_traverse.py``.

A lane's traversal state is one node index: where the ray's segment
enters a node's box it goes on to node + 1 (an interior node) or tests
the leaf's triangles and follows the miss link; where it misses the box
it follows the miss link; -1 ends the walk. The nodes are (M, 8) float32
rows ``[bmin xyz, bmax xyz, bits(miss), bits(start << 5 | count)]``, the
two link fields int32 bits (start = -1 marks an interior node), and the
triangles (T, 9) rows ``[v0, e1, e2]`` in leaf order; ``order`` maps a
leaf-order row back to the scene's ``tri_data`` row. The builder is
``theia_tpu_torch.native``'s copy of ``theia_tpu``'s.

:func:`nearest_triangle_bvh` and :func:`occluded_bvh` launch the walk of
``csrc/bvh_walk.cu`` (a thread a lane along the nodes, a warp testing its
lanes' leaves together, the tables in shared memory where they fit:
:func:`placement`) on CUDA tensors and run their plain
versions (:func:`nearest_triangle_bvh_plain`, :func:`occluded_bvh_plain`:
every live lane a step at a time, as JAX's ``while_loop``) on CPU tensors.
Both use the exact Moeller-Trumbore test of the soup kernels
(``intersect_mt.mt_exact``: 1/det as a correctly rounded reciprocal and
one Newton step, where JAX divides) and agree bit for bit; against
``theia_tpu`` the winners agree except where a second hit lies within
ulps, and t to ulps. A hit replaces the running one only if strictly
closer, so the first triangle in threaded order wins a tie.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from .intersect_mt import check_rays, mt_exact

__all__ = [
    "PackedBVH",
    "pack_bvh",
    "nearest_triangle_bvh",
    "nearest_triangle_bvh_plain",
    "occluded_bvh",
    "occluded_bvh_plain",
    "inv_dir",
    "placement",
]

#: bits of the leaf triangle count in the packed start/count field;
#: leaf_size must stay below 2^5 and start below 2^26 (kCountBits in
#: csrc/bvh_walk.cu)
_COUNT_BITS = 5
#: the most bytes of tables the walk stages in a block's shared memory: an
#: H100 block's 232,448 less the held leaves' lists of 32 warps (4,096)
SHARED_MAX = 232_448 - 4_096
#: the kernel's placements (``Place`` in csrc/bvh_walk.cu), by code
PLACES = ("global", "nodes", "nodes and rows")


@dataclass(frozen=True)
class PackedBVH:
    """The walk's tables on one device: ``nodes`` (M, 8) f32 rows
    ``[bmin xyz, bmax xyz, bits(miss), bits(start * 2^5 + count)]``,
    start = -1 for interior nodes; ``tri`` (T, 9) f32 rows ``[v0, e1,
    e2]`` in leaf order; ``order`` (T,) i32, the original id of each
    leaf-order row; ``leaf_size``, the most triangles a leaf holds."""

    nodes: torch.Tensor
    tri: torch.Tensor
    order: torch.Tensor
    leaf_size: int

    def to(self, device) -> "PackedBVH":
        """The same tables on ``device``."""
        return PackedBVH(self.nodes.to(device), self.tri.to(device), self.order.to(device), self.leaf_size)


def pack_bvh(bvh, w_v0, w_e1, w_e2, leaf_size: int, *, device) -> PackedBVH:
    """The walk's tables from a :class:`~theia_tpu_torch.native.BVH` over
    the world triangles (numpy (T, 3) x3), as ``theia_tpu.ops.bvh_traverse
    .pack_bvh`` builds them, on ``device``."""
    if not 1 <= leaf_size < (1 << _COUNT_BITS):
        raise ValueError(f"leaf_size must be from 1 to {(1 << _COUNT_BITS) - 1}, not {leaf_size}")
    order = bvh.order
    nodes = np.zeros((len(bvh.miss), 8), np.float32)
    nodes[:, 0:3] = np.asarray(bvh.bmin, np.float32)
    nodes[:, 3:6] = np.asarray(bvh.bmax, np.float32)
    start = np.asarray(bvh.start, np.int64)
    count = np.asarray(bvh.count, np.int64)
    if start.max(initial=0) >= 1 << 26:
        raise ValueError("BVH too large for packed links: leaves start at row 2^26 or later")
    # interior nodes keep start = -1: the packed field stays negative
    packed = np.where(start >= 0, start << _COUNT_BITS | count, -1)
    nodes[:, 6] = np.asarray(bvh.miss, np.int32).view(np.float32)
    nodes[:, 7] = packed.astype(np.int32).view(np.float32)
    tri = np.concatenate([np.asarray(a, np.float32)[order] for a in (w_v0, w_e1, w_e2)], axis=1)
    as_tensor = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return PackedBVH(nodes=as_tensor(nodes), tri=as_tensor(tri), order=as_tensor(order.astype(np.int32)),
                     leaf_size=leaf_size)


def inv_dir(direction: torch.Tensor) -> torch.Tensor:
    """1 / d with components below 1e-12 in size clamped to +-1e-12 by
    their sign (a NaN component to +1e-12): a flipped sign would turn a
    slab interval around and cull a true node or box."""
    tiny = torch.where(direction < 0.0, -1e-12, 1e-12)
    return 1.0 / torch.where(torch.abs(direction) > 1e-12, direction, tiny)


def _slab(lo, hi, o, inv):
    """(tn, tf): where rays (o, 1/d) enter and leave the boxes lo/hi (each
    (lanes, 3)), min and max taken axis by axis in a fixed order; a NaN
    spreads, so that it fails every comparison."""
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2])
    tf = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
    return tn, tf


def _walk(packed: PackedBVH, origin, direction, t_max, any_hit: bool, stats=None):
    """The plain walk: every live lane one node a step. Returns (t, row)
    with row the leaf-order row of the winner (-1 on a miss); with
    ``any_hit`` a lane ends at its first hit strictly before ``t_max`` and
    keeps ``t_max``. ``stats`` (a dict) counts the node visits
    ("box_tests") and the triangle tests ("tri_tests"), and appends each
    lane's two counts, int32 (N,) tensors, to its "lane_counts" list."""
    n = origin.shape[0]
    dev = origin.device
    nodes, bits = packed.nodes, packed.nodes.view(torch.int32)
    n_tri = packed.tri.shape[0]
    inv = inv_dir(direction)
    t_best = t_max.clone()
    row_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    live = torch.arange(n, device=dev) if nodes.shape[0] else torch.zeros(0, dtype=torch.int64, device=dev)
    lane_nodes = torch.zeros(n, dtype=torch.int32, device=dev)
    lane_tris = torch.zeros(n, dtype=torch.int32, device=dev)
    while live.numel():
        o, d, iv, nd = origin[live], direction[live], inv[live], node[live]
        tb, rb = t_best[live], row_best[live]
        row, link = nodes[nd], bits[nd]
        tn, tf = _slab(row[:, 0:3], row[:, 3:6], o, iv)
        hit = (tf >= torch.clamp_min(tn, 0.0)) & (tn <= tb)
        is_leaf = link[:, 7] >= 0
        start, count = link[:, 7] >> _COUNT_BITS, link[:, 7] & ((1 << _COUNT_BITS) - 1)
        # a leaf's triangles all at once: the kernel's strict in-order update
        # keeps the first of the nearest hits below the bound, which is the
        # (t, k) minimum of those hits
        ks = torch.arange(packed.leaf_size, dtype=torch.int32, device=dev)
        act = (hit & is_leaf)[:, None] & (ks < count[:, None])
        tri = torch.clamp(start[:, None] + ks, 0, n_tri - 1)
        rows = packed.tri[tri.long()]
        t, ok = mt_exact(*(o[:, None, i] for i in range(3)), *(d[:, None, i] for i in range(3)), *rows.unbind(2))
        t = torch.where(act & ok & (t < tb[:, None]), t, torch.inf)
        t_leaf = t.amin(dim=1)
        found = t_leaf < torch.inf
        if stats is not None:
            stats["box_tests"] = stats.get("box_tests", 0) + int(live.numel())
            stats["tri_tests"] = stats.get("tri_tests", 0) + int(act.sum())
            lane_nodes[live] += 1
            lane_tris[live] += act.sum(dim=1, dtype=torch.int32)
        nxt = torch.where(hit & ~is_leaf, nd + 1, link[:, 6].long())
        if any_hit:
            rb = torch.where(found, 0, rb)
            nxt = torch.where(found, -1, nxt)
        else:
            first = torch.where(t == t_leaf[:, None], ks, packed.leaf_size).amin(dim=1)
            rb = torch.where(found, tri.gather(1, first.clamp_max(packed.leaf_size - 1).long()[:, None])[:, 0], rb)
            tb = torch.where(found, t_leaf, tb)
        t_best[live], row_best[live], node[live] = tb, rb, nxt
        live = live[nxt >= 0]
    if stats is not None:
        stats.setdefault("lane_counts", []).append((lane_nodes, lane_tris))
    return t_best, row_best


def nearest_triangle_bvh_plain(packed: PackedBVH, origin, direction, t_max, stats=None):
    """Plain PyTorch version of :func:`nearest_triangle_bvh` (any device)."""
    t, row = _walk(packed, origin, direction, t_max, False, stats)
    found = row >= 0
    idx = torch.where(found, packed.order[torch.clamp_min(row, 0).long()], -1)
    return torch.where(found, t, torch.inf), idx


def occluded_bvh_plain(packed: PackedBVH, origin, direction, t_max, stats=None):
    """Plain PyTorch version of :func:`occluded_bvh` (any device)."""
    return _walk(packed, origin, direction, t_max, True, stats)[1] >= 0


def _check(packed: PackedBVH, origin, direction, t_max):
    m, n_tri = packed.nodes.shape[0], packed.tri.shape[0]
    return check_rays(origin, direction, t_max, (
        ("packed.nodes", packed.nodes, (m, 8)), ("packed.tri", packed.tri, (n_tri, 9)),
    ))


def placement(packed: PackedBVH) -> int:
    """Where the walk reads ``packed``'s tables from, a code of
    :data:`PLACES`: the nodes and the rows in shared memory where both fit
    :data:`SHARED_MAX` bytes, the nodes alone where they fit, else neither
    (through the read-only cache)."""
    nodes, rows = 4 * packed.nodes.numel(), 4 * packed.tri.numel()
    if nodes + rows <= SHARED_MAX:
        return 2
    return 1 if nodes <= SHARED_MAX else 0


def leaf_slot(leaf_size: int) -> int:
    """Threads a held leaf gets in the walk's leaf tests: ``leaf_size``
    rounded up to a power of two (at most 32)."""
    return min(32, 1 << max(leaf_size - 1, 0).bit_length())


def _launch(entry: str, packed: PackedBVH, origin, direction, t_max, *outputs) -> None:
    n = origin.shape[0]
    if packed.order.dtype != torch.int32 or packed.order.device != origin.device:
        raise ValueError(f"packed.order must be int32 on {origin.device}")
    err = getattr(_build.library(), entry)(
        origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), packed.nodes.data_ptr(), packed.tri.data_ptr(),
        packed.order.data_ptr(), packed.nodes.shape[0], packed.tri.shape[0], leaf_slot(packed.leaf_size),
        placement(packed), n, *(a.data_ptr() for a in outputs), _build.raw_stream(origin),
    )
    _build.check(err, entry)


def nearest_triangle_bvh(packed: PackedBVH, origin, direction, t_max):
    """Nearest hit: (t, idx) with idx the triangle's original id (the
    scene's ``tri_data`` row), t = inf / idx = -1 on a miss. ``origin``/
    ``direction`` f32 (N, 3), the direction need not be unit length;
    ``t_max`` a scalar or f32 (N,): a hit counts only strictly before it.
    CUDA tensors launch ``theia_bvh_nearest``, CPU tensors run the plain
    version."""
    t_max = _check(packed, origin, direction, t_max)
    if origin.device.type == "cpu":
        return nearest_triangle_bvh_plain(packed, origin, direction, t_max)
    n = origin.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    idx = torch.empty(n, dtype=torch.int32, device=origin.device)
    if n:
        _launch("theia_bvh_nearest", packed, origin, direction, t_max, t, idx)
        nearest_triangle_bvh.launches += 1
    return t, idx


nearest_triangle_bvh.launches = 0


def occluded_bvh(packed: PackedBVH, origin, direction, t_max):
    """Any hit: bool (N,), True where some triangle is hit at 0 < t <
    ``t_max``, strictly; a lane's walk ends at its first hit (the
    reference's terminateOnFirstHit). CUDA tensors launch
    ``theia_bvh_occluded``, CPU tensors run the plain version."""
    t_max = _check(packed, origin, direction, t_max)
    if origin.device.type == "cpu":
        return occluded_bvh_plain(packed, origin, direction, t_max)
    n = origin.shape[0]
    occluded = torch.empty(n, dtype=torch.bool, device=origin.device)
    if n:
        _launch("theia_bvh_occluded", packed, origin, direction, t_max, occluded)
        occluded_bvh.launches += 1
    return occluded


occluded_bvh.launches = 0
