"""Moeller-Trumbore nearest-hit queries over a Morton-ordered triangle soup.

The port of ``theia_tpu/ops/intersect_mt_pallas.py`` and the host half of
``theia_tpu/ops/_intersect_tiles.py``. The pack keeps the JAX layout —
triangles as (T_tiles, 9, BT) rows (v0xyz, e1xyz, e2xyz), padding with
v0 = 3e38 that never hits, per-tile AABBs and tight scene bounds — so the
two packages' packs compare equal. Only ``tri`` goes to the device: the
per-tile AABBs and scene bounds stay host arrays, since nothing on the
port's path reads them until ``run_binned`` is ported.

:func:`nearest_triangle_mt` launches the hand-written kernel of
``csrc/intersect_mt.cu`` on CUDA tensors and runs
:func:`nearest_triangle_mt_plain` on CPU tensors. Both compute the JAX
kernel's per-pair test in the same operation order, with 1/det as a
correctly rounded reciprocal plus one Newton step, so they agree bit for
bit. Both skip a run of 256 triangles for a ray that cannot reach its
(widened) box, the port's form of the TPU kernel's per-tile AABB skip.
The kernel streams the table through a fixed shared-memory chunk, so no
capacity check is needed where the TPU version checks its VMEM budget.
The wavefront binning of the TPU version (``run_binned``, for scenes of
8192 triangles and more) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

__all__ = [
    "MTPack",
    "morton_order",
    "pack_mt",
    "tile_aabbs",
    "scene_bounds",
    "nearest_triangle_mt",
    "nearest_triangle_mt_plain",
]

BT = 512  # triangles per tile for big scenes
#: small scenes use wider tiles (same choice as the TPU pack)
SMALL_SCENE_BT = 2048
SMALL_SCENE_MAX_TRI = 4 * SMALL_SCENE_BT
#: triangles per skip chunk; csrc/intersect_mt.cu's kChunk must equal it
CHUNK = 256
#: rays per block of the plain version, which bounds its (rays, CHUNK) temporaries
RAY_BLOCK = 4096


class MTPack:
    """Tables of the nearest-hit query; ``n_tri`` is the count of real
    triangles (the rest of ``tri`` is padding). ``chunk_box`` holds the
    inflated bounds of each run of :data:`CHUNK` triangles, derived from
    ``tri`` on its device. ``aabb``, ``lo`` and ``hi`` are the JAX pack's
    per-tile AABBs and scene bounds as host numpy arrays; no query reads
    them yet."""

    def __init__(self, tri, aabb, lo, hi, n_tri: int) -> None:
        self.tri = tri  # f32 (T_tiles, 9, BT): v0xyz, e1xyz, e2xyz rows
        self.aabb = np.asarray(aabb, np.float32)  # (T_tiles, 8): lo xyz, pad, hi xyz, pad
        self.lo = np.asarray(lo, np.float32)  # (3,) tight scene bounds
        self.hi = np.asarray(hi, np.float32)
        self.n_tri = n_tri
        self.chunk_box = chunk_boxes(tri, n_tri)  # f32 (n_chunks, 8)


def _rows(tri: torch.Tensor, n_tri: int) -> torch.Tensor:
    """(9, n_tri) component rows of the real triangles."""
    return tri.permute(1, 0, 2).reshape(9, -1)[:, :n_tri]


def chunk_boxes(tri: torch.Tensor, n_tri: int) -> torch.Tensor:
    """(n_chunks, 8) bounds (lo xyz, 0, hi xyz, 0) of each run of
    :data:`CHUNK` triangles over their float32 vertices v0, v0+e1, v0+e2,
    widened by 1e-3 of the extent plus 1e-5 on each side. The margin is
    far above float32 rounding, so a ray that misses the box cannot hit a
    triangle in it: skipping the chunk never changes a result. The
    values are exact min/max plus the same float32 ops on every device,
    which keeps the kernel's skips identical to the plain version's."""
    rows = _rows(tri, n_tri)
    n_chunks = -(-n_tri // CHUNK)
    pad = n_chunks * CHUNK - n_tri
    v0, e1, e2 = rows[0:3], rows[3:6], rows[6:9]
    pts = torch.stack([v0, v0 + e1, v0 + e2], dim=-1)  # (3, n_tri, 3)
    # fill the last chunk with copies of its last triangle
    pts = torch.cat([pts, pts[:, -1:].expand(3, pad, 3)], dim=1)
    pts = pts.reshape(3, n_chunks, CHUNK * 3)
    lo, hi = pts.amin(dim=-1).T, pts.amax(dim=-1).T  # (n_chunks, 3)
    margin = (hi - lo) * 1e-3 + 1e-5
    zero = torch.zeros_like(lo[:, :1])
    return torch.cat([lo - margin, zero, hi + margin, zero], dim=1).contiguous()


def morton_order(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> np.ndarray:
    """Permutation sorting triangles along a 3D Morton curve of their
    centroids — gives spatially tight per-tile AABBs."""
    c = v0 + (e1 + e2) / 3.0
    lo, hi = c.min(0), c.max(0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((c - lo) / ext * 1023.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def tile_aabbs(v0, e1, e2, n_tri: int, n_tiles: int, bt: int) -> np.ndarray:
    """(n_tiles, 8) per-tile AABBs (lo xyz, pad, hi xyz, pad) over the
    real triangles, rounded outward to float32; all-padding tiles get an
    inverted box."""
    aabb = np.zeros((n_tiles, 8), np.float32)
    pts = np.concatenate(
        [v0[:n_tri], v0[:n_tri] + e1[:n_tri], v0[:n_tri] + e2[:n_tri]], axis=0
    )
    for k in range(n_tiles):
        s = slice(k * bt, min((k + 1) * bt, n_tri))
        if s.start >= n_tri:  # tile entirely padding
            aabb[k, 0:3] = 1.0
            aabb[k, 4:7] = -1.0
            continue
        p = np.concatenate([pts[s], pts[n_tri:][s], pts[2 * n_tri:][s]], axis=0)
        lo = p.min(0)
        hi = p.max(0)
        lo32 = lo.astype(np.float32)
        hi32 = hi.astype(np.float32)
        lo32 = np.where(lo32 > lo, np.nextafter(lo32, -np.inf), lo32)
        hi32 = np.where(hi32 < hi, np.nextafter(hi32, np.inf), hi32)
        aabb[k, 0:3] = lo32
        aabb[k, 4:7] = hi32
    return aabb


def scene_bounds(v0, e1, e2, n_tri: int):
    """Tight (lo, hi) bounds over the real triangles."""
    pts = np.concatenate(
        [v0[:n_tri], v0[:n_tri] + e1[:n_tri], v0[:n_tri] + e2[:n_tri]]
    )
    return pts.min(0), pts.max(0)


def pack_mt(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, *, device) -> MTPack:
    """Pack Morton-ordered triangles (T, 3) x3 into tiles on ``device``."""
    bt = SMALL_SCENE_BT if v0.shape[0] <= SMALL_SCENE_MAX_TRI else BT
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    n_tri = v0.shape[0]
    n_tiles = max(1, -(-n_tri // bt))
    t_pad = n_tiles * bt
    if t_pad != n_tri:
        v0 = np.concatenate([v0, np.full((t_pad - n_tri, 3), 3e38, np.float32)])
        e1 = np.concatenate([e1, np.zeros((t_pad - n_tri, 3), np.float32)])
        e2 = np.concatenate([e2, np.zeros((t_pad - n_tri, 3), np.float32)])
    tri = np.zeros((n_tiles, 9, bt), np.float32)
    for c in range(3):
        tri[:, c, :] = v0[:, c].reshape(n_tiles, bt)
        tri[:, 3 + c, :] = e1[:, c].reshape(n_tiles, bt)
        tri[:, 6 + c, :] = e2[:, c].reshape(n_tiles, bt)
    aabb = tile_aabbs(v0, e1, e2, n_tri, n_tiles, bt)
    lo, hi = scene_bounds(v0, e1, e2, n_tri)
    return MTPack(torch.as_tensor(tri, device=device), aabb, lo, hi, n_tri)


def _rcp(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded reciprocal plus one Newton step (the kernel's
    ``__frcp_rn`` and ``r*(2-v*r)``)."""
    r = 1.0 / v
    return r * (2.0 - v * r)


def _safe(v: torch.Tensor) -> torch.Tensor:
    """Keep the reciprocal finite, preserving the sign."""
    tiny = torch.where(v < 0.0, -1e-20, 1e-20)
    return torch.where(torch.abs(v) < 1e-20, tiny, v)


def _slab_candidates(box, o, inv, best_t) -> torch.Tensor:
    """Rays (o, 1/d) whose segment [0, best_t) can enter the box."""
    t1 = (box[0:3] - o) * inv
    t2 = (box[4:7] - o) * inv
    near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tn = torch.maximum(
        torch.maximum(near[:, 0], near[:, 1]), torch.clamp_min(near[:, 2], 0.0)
    )
    tf = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
    return (tn <= tf) & (tn < best_t)


def nearest_triangle_mt_plain(
    pack: MTPack,
    origin: torch.Tensor,
    direction: torch.Tensor,
    t_max: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`nearest_triangle_mt` (any device).

    Walks the triangles in :data:`CHUNK`-wide chunks, as the kernel does:
    a ray tests a chunk only if it can enter the chunk's box before its
    current winner (``chunk_box``); within a chunk the lowest index wins
    ties, and a chunk's winner replaces the running one only if strictly
    closer — the kernel's sequential strict update. Rays go in blocks so
    the (rays, chunk) intermediates stay small."""
    rows = _rows(pack.tri, pack.n_tri)
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
            v = rows[:, c0 : c0 + CHUNK]
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
                v[k : k + 1] for k in range(9)
            )
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            inv = torch.where(torch.abs(det) > 1e-12, _rcp(_safe(det)), 0.0)
            tx = ox - v0x
            ty = oy - v0y
            tz = oz - v0z
            b1 = (tx * px + ty * py + tz * pz) * inv
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            b2 = (dx * qx + dy * qy + dz * qz) * inv
            t = (e2x * qx + e2y * qy + e2z * qz) * inv
            hit = (
                (inv != 0.0)
                & (b1 >= -1e-6)
                & (b2 >= -1e-6)
                & (b1 + b2 <= 1.0 + 1e-6)
                & (t > 0.0)
            )
            tt, ic = torch.where(hit, t, torch.inf).min(dim=1)
            cur_t, cur_i = best_t[lanes], best_i[lanes]
            better = tt < cur_t
            best_i[lanes] = torch.where(better, ic.to(torch.int32) + c0, cur_i)
            best_t[lanes] = torch.where(better, tt, cur_t)
        t_out[r0:r1] = torch.where(best_i < 0, torch.inf, best_t)
        i_out[r0:r1] = best_i
    return t_out, i_out


def _check_rays(pack: MTPack, origin, direction, t_max) -> None:
    n = origin.shape[0]
    for name, a, shape in (
        ("origin", origin, (n, 3)),
        ("direction", direction, (n, 3)),
        ("t_max", t_max, (n,)),
        ("pack.tri", pack.tri, (pack.tri.shape[0], 9, pack.tri.shape[2])),
        ("pack.chunk_box", pack.chunk_box, (-(-pack.n_tri // CHUNK), 8)),
    ):
        if a.dtype != torch.float32 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be float32 of shape {shape}")
        if not a.is_contiguous() or a.device != origin.device:
            raise ValueError(f"{name} must be contiguous on {origin.device}")


def nearest_triangle_mt(
    pack: MTPack, origin: torch.Tensor, direction: torch.Tensor, t_max
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-hit query: returns (t, tri_idx) with t=inf / idx=-1 on miss.

    ``origin``/``direction``: f32 (N, 3); ``t_max``: scalar or f32 (N,).
    A hit counts only if strictly closer than ``t_max``; the lowest index
    wins ties. CUDA tensors launch ``csrc/intersect_mt.cu``, CPU tensors
    run the plain version."""
    n = origin.shape[0]
    t_max = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=origin.device), (n,)
    ).contiguous()
    _check_rays(pack, origin, direction, t_max)
    if origin.device.type == "cpu":
        return nearest_triangle_mt_plain(pack, origin, direction, t_max)
    if origin.device.type != "cuda":
        raise ValueError(f"nearest_triangle_mt: unsupported device {origin.device}")
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    idx = torch.empty(n, dtype=torch.int32, device=origin.device)
    lib = _build.library()
    err = lib.theia_mt_nearest(
        origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(),
        pack.tri.data_ptr(), pack.chunk_box.data_ptr(), n, pack.n_tri,
        pack.tri.shape[2], t.data_ptr(), idx.data_ptr(),
        _build.stream_handle(origin.device),
    )
    _build.check(err, "nearest_triangle_mt")
    nearest_triangle_mt.launches += 1
    return t, idx


nearest_triangle_mt.launches = 0
