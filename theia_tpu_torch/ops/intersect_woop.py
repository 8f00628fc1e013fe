"""Woop unit-triangle nearest-hit queries over a Morton-ordered soup.

The port of ``theia_tpu/ops/intersect_woop.py``. Per triangle a
world->unit-triangle affine ``M`` is precomputed on the host (float64,
cast to float32) such that for a point ``p``::

    (b1, b2, z) = M[:, :3] @ p + M[:, 3]

with ``z = 0`` on the triangle's plane. For a ray ``o + t d`` that turns
intersection into six dot products and a short epilogue::

    t  = -o'_z * rcp(d'_z)
    b1 = o'_x + t d'_x,  b2 = o'_y + t d'_y
    hit iff t > 0, b1 >= -eps, b2 >= -eps, b1 + b2 <= 1 + eps

The pack keeps the JAX layout — the transforms as a (T_tiles, 8, 6*BT)
table ``b`` whose columns are the o' and d' parts of the TPU kernel's
``[o,1,d,0] @ B`` product, padding and degenerate triangles with M = 0
and offset 3e38 that never hit, per-tile AABBs and tight scene bounds —
so the two packages' packs compare equal. Only ``b`` and the chunk-skip
boxes go to the device; ``aabb``, ``lo`` and ``hi`` stay host arrays, as
in :class:`~theia_tpu_torch.ops.intersect_mt.MTPack`.

:func:`nearest_triangle_woop` launches the hand-written kernel of
``csrc/intersect_woop.cu`` on CUDA tensors and runs
:func:`nearest_triangle_woop_plain` on CPU tensors. Both form o' and d'
as the same float32 sums in the same order (written down in the kernel's
source note) and take rcp as a correctly rounded reciprocal plus one
Newton step, so they agree bit for bit; do not rewrite the plain version
with fused ops (``addcmul``, ``einsum``, ``matmul``). Both skip a run of
:data:`~theia_tpu_torch.ops.intersect_mt.CHUNK` triangles for a ray that
cannot reach its widened box, with the boxes the MT pack uses. The
wavefront binning of the TPU version (``run_binned``, for scenes of 8192
triangles and more) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .intersect_mt import (
    CHUNK,
    RAY_BLOCK,
    _rcp,
    _safe,
    _slab_candidates,
    check_rays,
    chunk_boxes,
    morton_order,
    scene_bounds,
    tile_aabbs,
)

__all__ = [
    "WoopPack",
    "morton_order",
    "pack_woop",
    "nearest_triangle_woop",
    "nearest_triangle_woop_plain",
]

BT = 512  # triangles per tile
_EPS = 1e-6  # watertightness margin, matches the brute-force scan


class WoopPack:
    """Tables of the Woop query; ``n_tri`` is the count of real triangles
    (the rest of ``b`` is padding). ``chunk_box`` holds the widened bounds
    of each run of :data:`CHUNK` triangles (see
    :func:`~theia_tpu_torch.ops.intersect_mt.chunk_boxes`); ``aabb``,
    ``lo`` and ``hi`` are the JAX pack's per-tile AABBs and scene bounds
    as host numpy arrays, which no query reads yet."""

    def __init__(self, b, aabb, lo, hi, n_tri: int, chunk_box) -> None:
        self.b = b  # f32 (T_tiles, 8, 6*BT)
        self.aabb = np.asarray(aabb, np.float32)  # (T_tiles, 8): lo xyz, pad, hi xyz, pad
        self.lo = np.asarray(lo, np.float32)  # (3,) tight scene bounds
        self.hi = np.asarray(hi, np.float32)
        self.n_tri = n_tri
        self.chunk_box = chunk_box  # f32 (n_chunks, 8), on b's device


def pack_woop(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, *, device) -> WoopPack:
    """Build the (8, 6*BT)-tiled transform table, the per-tile AABBs and
    the chunk-skip boxes on ``device``.

    Triangles (T, 3) x3 float32 must already be in their final (Morton)
    order; padded slots are unhittable (o' huge, d' = 0)."""
    boxes = chunk_boxes(
        *(torch.tensor(np.asarray(a, np.float32), device=device) for a in (v0, e1, e2))
    )
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    n_tri = v0.shape[0]
    n_tiles = max(1, -(-n_tri // BT))
    t_pad = n_tiles * BT

    n = np.cross(e1, e2)
    # M_lin = inv([e1 e2 n]) (columns); rows give (b1, b2, z) coordinates
    a = np.stack([e1, e2, n], axis=-1)  # (T, 3, 3)
    det = np.linalg.det(a)
    bad = np.abs(det) < 1e-30
    a[bad] = np.eye(3)
    m_lin = np.linalg.inv(a)  # (T, 3, 3)
    m_off = -np.einsum("tij,tj->ti", m_lin, v0)  # (T, 3)
    # unhittable padding / degenerate triangles
    m_lin[bad] = 0.0
    m_off[bad] = np.array([3e38, 3e38, 3e38])

    if t_pad != n_tri:
        pad_lin = np.zeros((t_pad - n_tri, 3, 3))
        pad_off = np.full((t_pad - n_tri, 3), 3e38)
        m_lin = np.concatenate([m_lin, pad_lin], axis=0)
        m_off = np.concatenate([m_off, pad_off], axis=0)

    # B columns per tile: [b1(o') | b2(o') | z(o') | b1(d') | b2(d') | z(d')]
    # X rows: [ox oy oz 1 dx dy dz 0]
    b = np.zeros((n_tiles, 8, 6 * BT), np.float32)
    lin = m_lin.astype(np.float32).reshape(n_tiles, BT, 3, 3)
    off = m_off.astype(np.float32).reshape(n_tiles, BT, 3)
    for c in range(3):  # output component (b1, b2, z)
        # o' part: rows 0..2 = M[c,:], row 3 = offset
        b[:, 0:3, c * BT : (c + 1) * BT] = np.swapaxes(lin[:, :, c, :], 1, 2)
        b[:, 3, c * BT : (c + 1) * BT] = off[:, :, c]
        # d' part: rows 4..6 = M[c,:]
        b[:, 4:7, (3 + c) * BT : (4 + c) * BT] = np.swapaxes(lin[:, :, c, :], 1, 2)

    aabb = tile_aabbs(v0, e1, e2, n_tri, n_tiles, BT)
    lo, hi = scene_bounds(v0, e1, e2, n_tri)
    return WoopPack(torch.as_tensor(b, device=device), aabb, lo, hi, n_tri, boxes)


def _transforms(b: torch.Tensor, n_tri: int) -> torch.Tensor:
    """(12, n_tri) rows m_c0, m_c1, m_c2, f_c for c = b1, b2, z of the real
    triangles, read from the o' columns of ``b`` (the kernel's shared-
    memory layout)."""
    o_cols = b[:, 0:4, : 3 * BT].reshape(b.shape[0], 4, 3, BT)  # (tiles, k, c, j)
    return o_cols.permute(2, 1, 0, 3).reshape(12, -1)[:, :n_tri]


def nearest_triangle_woop_plain(
    pack: WoopPack,
    origin: torch.Tensor,
    direction: torch.Tensor,
    t_max: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`nearest_triangle_woop` (any device).

    Walks the triangles in :data:`CHUNK`-wide chunks, as the kernel does:
    a ray tests a chunk only if it can enter the chunk's box before its
    current winner; within a chunk the lowest index wins ties, and a
    chunk's winner replaces the running one only if strictly closer.
    o' and d' are the kernel's sums in the kernel's order, with the
    structural zeros of the TPU product left out."""
    m = _transforms(pack.b, pack.n_tri)
    n = origin.shape[0]
    t_out = torch.empty(n, dtype=torch.float32, device=origin.device)
    i_out = torch.empty(n, dtype=torch.int32, device=origin.device)
    for r0 in range(0, n, RAY_BLOCK):
        r1 = min(n, r0 + RAY_BLOCK)
        o_blk, d_blk = origin[r0:r1], direction[r0:r1]
        inv_d = _rcp(_safe(d_blk))
        best_t = t_max[r0:r1].clone()
        best_i = torch.full_like(best_t, -1, dtype=torch.int32)
        for c, c0 in enumerate(range(0, pack.n_tri, CHUNK)):
            lanes = torch.nonzero(
                _slab_candidates(pack.chunk_box[c], o_blk, inv_d, best_t)
            )[:, 0]
            if lanes.numel() == 0:
                continue
            o, d = o_blk[lanes], d_blk[lanes]
            ox, oy, oz = (o[:, k : k + 1] for k in range(3))
            dx, dy, dz = (d[:, k : k + 1] for k in range(3))
            w = m[:, c0 : c0 + CHUNK]
            o1, o2, o3 = (
                ((ox * w[k] + oy * w[k + 1]) + oz * w[k + 2]) + w[k + 3]
                for k in (0, 4, 8)
            )
            d1, d2, d3 = (
                (dx * w[k] + dy * w[k + 1]) + dz * w[k + 2] for k in (0, 4, 8)
            )
            t = -o3 * _rcp(d3)
            b1 = o1 + t * d1
            b2 = o2 + t * d2
            hit = (t > 0.0) & (b1 >= -_EPS) & (b2 >= -_EPS) & (b1 + b2 <= 1.0 + _EPS)
            tt, ic = torch.where(hit, t, torch.inf).min(dim=1)
            cur_t, cur_i = best_t[lanes], best_i[lanes]
            better = tt < cur_t
            best_i[lanes] = torch.where(better, ic.to(torch.int32) + c0, cur_i)
            best_t[lanes] = torch.where(better, tt, cur_t)
        t_out[r0:r1] = torch.where(best_i < 0, torch.inf, best_t)
        i_out[r0:r1] = best_i
    return t_out, i_out


def nearest_triangle_woop(
    pack: WoopPack, origin: torch.Tensor, direction: torch.Tensor, t_max
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-hit query: returns (t, tri_idx) with t=inf / idx=-1 on miss.

    ``origin``/``direction``: f32 (N, 3); ``t_max``: scalar or f32 (N,).
    A hit counts only if strictly closer than ``t_max``; the lowest index
    wins ties. CUDA tensors launch ``csrc/intersect_woop.cu``, CPU tensors
    run the plain version."""
    n = origin.shape[0]
    t_max = check_rays(
        origin, direction, t_max,
        (
            ("pack.b", pack.b, (pack.b.shape[0], 8, 6 * BT)),
            ("pack.chunk_box", pack.chunk_box, (-(-pack.n_tri // CHUNK), 8)),
        ),
    )
    if origin.device.type == "cpu":
        return nearest_triangle_woop_plain(pack, origin, direction, t_max)
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    idx = torch.empty(n, dtype=torch.int32, device=origin.device)
    err = _build.library().theia_woop_nearest(
        origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(),
        pack.b.data_ptr(), pack.chunk_box.data_ptr(), n, pack.n_tri,
        t.data_ptr(), idx.data_ptr(), _build.stream_handle(origin.device),
    )
    _build.check(err, "nearest_triangle_woop")
    nearest_triangle_woop.launches += 1
    return t, idx


nearest_triangle_woop.launches = 0
