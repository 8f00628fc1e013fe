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
so the two packages' packs compare equal. Only ``b`` and the skip boxes
go to the device; ``aabb``, ``lo`` and ``hi`` stay host arrays, as in
:class:`~theia_tpu_torch.ops.intersect_mt.MTPack` (the wavefront sort
reads the bounds on the host). The kernel reads its
own copy of the transforms, ``tri_aos``: one 20-float row a triangle
(:func:`woop_aos`, with the row's index in the index column), derived
from ``b`` on its device.

:func:`nearest_triangle_woop` launches the hand-written scan of
``csrc/nearest_scan.cuh`` with the Woop test (``csrc/intersect_woop.cu``)
on CUDA tensors and runs :func:`nearest_triangle_woop_plain` on CPU
tensors. Both form o' and d'
as the same float32 sums in the same order (written down in the kernel's
source note) and take rcp as a correctly rounded reciprocal plus one
Newton step, so they agree bit for bit; do not rewrite the plain version
with fused ops (``addcmul``, ``einsum``, ``matmul``). Both skip a run of
:data:`~theia_tpu_torch.ops.intersect_mt.CHUNK` triangles, and within it
each run of :data:`~theia_tpu_torch.ops.intersect_mt.SUB`, for a ray that
cannot reach its widened box, with the boxes the MT pack uses. In front
of the exact test the kernel runs two rejection tests that never reject
a pair the exact test accepts (the ray's line against the triangle's
bounding sphere, then the exact test's inequalities without the
division); :func:`_woop_sphere_miss_plain` and :func:`_woop_reject_plain`
are their plain twins. With ``binned=True`` the query sorts its rays by
direction octant and position cell first and scatters the winners back
(``_intersect_tiles.run_binned``, the kernels of
``csrc/wavefront_sort.cu``); the TPU version does so by default from
:data:`~theia_tpu_torch.ops._intersect_tiles.BIN_THRESHOLD` triangles on,
the port only when asked.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ._intersect_tiles import run_binned
from .intersect_mt import (
    CHUNK,
    SUB,
    WOOP_GUARD,
    WOOP_SPHERE,
    ROW_AOS,
    WILD,
    _columns,
    _fma,
    _rcp,
    aos_rows,
    bounding_sphere,
    check_rays,
    chunk_boxes,
    chunk_walk,
    ray_slack,
    reject_tests,
    scan_tables,
    sphere_miss_plain,
    morton_order,
    scene_bounds,
    sub_boxes,
    tile_aabbs,
    whole_table,
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
    (the rest of ``b`` is padding). ``chunk_box`` and ``sub_box`` hold the
    widened bounds of each run of :data:`CHUNK` and of :data:`SUB`
    triangles (see :func:`~theia_tpu_torch.ops.intersect_mt.chunk_boxes`:
    they come from the world triangles, which ``b`` does not hold);
    ``aabb``, ``lo`` and ``hi`` are the JAX pack's per-tile AABBs and
    scene bounds as host numpy arrays; the wavefront sort reads the bounds.
    ``tri_aos`` is the kernel's table (:func:`woop_aos`), ``chunk_count``
    and ``chunks`` the real rows of each chunk and the list of every chunk
    (:func:`~theia_tpu_torch.ops.intersect_mt.whole_table`). ``binned``:
    whether the query sorts its rays when called with ``binned=None``
    (``Scene(binned=True)`` sets it)."""

    binned = False

    def __init__(self, b, aabb, lo, hi, n_tri: int, chunk_box, sub_box) -> None:
        self.b = b  # f32 (T_tiles, 8, 6*BT)
        self.aabb = np.asarray(aabb, np.float32)  # (T_tiles, 8): lo xyz, pad, hi xyz, pad
        self.lo = np.asarray(lo, np.float32)  # (3,) tight scene bounds
        self.hi = np.asarray(hi, np.float32)
        self.n_tri = n_tri
        self.chunk_box = chunk_box  # f32 (n_chunks, 8), on b's device
        self.sub_box = sub_box  # f32 (n_chunks * CHUNK / SUB, 8)
        # f32 (n_chunks * CHUNK, ROW_AOS)
        self.tri_aos = woop_aos(_transforms(b, n_tri))
        self.chunk_count, self.chunks = whole_table(self.tri_aos, n_tri)


def pack_woop(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, *, device) -> WoopPack:
    """Build the (8, 6*BT)-tiled transform table, the per-tile AABBs and
    the chunk-skip boxes on ``device``.

    Triangles (T, 3) x3 float32 must already be in their final (Morton)
    order; padded slots are unhittable (o' huge, d' = 0)."""
    world = [torch.tensor(np.asarray(a, np.float32), device=device) for a in (v0, e1, e2)]
    boxes = chunk_boxes(*world), sub_boxes(*world)
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
    return WoopPack(torch.as_tensor(b, device=device), aabb, lo, hi, n_tri, *boxes)


def _transforms(b: torch.Tensor, n_tri: int) -> torch.Tensor:
    """(12, n_tri) rows m_c0, m_c1, m_c2, f_c for c = b1, b2, z of the real
    triangles, read from the o' columns of ``b`` (the kernel's shared-
    memory layout)."""
    o_cols = b[:, 0:4, : 3 * BT].reshape(b.shape[0], 4, 3, BT)  # (tiles, k, c, j)
    return o_cols.permute(2, 1, 0, 3).reshape(12, -1)[:, :n_tri]


def woop_aos(m: torch.Tensor) -> torch.Tensor:
    """The Woop kernel's table from the (12, n_tri) transform rows; per
    triangle (see csrc/intersect_woop.cu): the bounding sphere c, r2 = 2.8
    R0^2; m_z, f_z; P, Q, 0, 0 (the index column, which the caller fills);
    m_b1, f_b1; m_b2, f_b2. The sphere bounds
    the triangle that the float32 map itself defines (the preimages of
    the unit triangle's corners, through a float64 inverse). P = 2 M_z
    (M_1 + M_2) + M_z and Q = M_z (F_1 + F_2) + F_z (M_1 + M_2) + M_z +
    F_z + 1e-30, with M_c = |m_c|_1 and F_c = |f_c|, are the slack
    coefficients of the rejection tests; Q = inf where an entry reaches
    :data:`~theia_tpu_torch.ops.intersect_mt.WILD` (padding and
    degenerate triangles) or the inverse does not check out, and no
    sphere test drops such a triangle."""
    a = m.abs()
    m1, m2, mz = (a[k : k + 3].sum(dim=0) for k in (0, 4, 8))
    f1, f2, fz = a[3], a[7], a[11]
    p = 2.0 * mz * (m1 + m2) + mz
    q = mz * (f1 + f2) + fz * (m1 + m2) + mz + fz + 1e-30
    # the vertices x_i with m x_i + f = corner_i, in float64
    lin = torch.stack([m[0:3], m[4:7], m[8:11]], dim=0).double().permute(2, 0, 1)  # (n, c, k)
    off = torch.stack([m[3], m[7], m[11]], dim=0).double().T  # (n, c)
    wild = (a.amax(dim=0) >= WILD) | (torch.linalg.det(lin) == 0.0)
    lin = torch.where(wild[:, None, None], torch.eye(3, dtype=torch.float64, device=m.device), lin)
    corners = torch.tensor(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=torch.float64, device=m.device
    )
    rhs = (corners[None] - off[:, None]).transpose(1, 2)  # (n, c, corner)
    x = torch.linalg.solve(lin, rhs)  # (n, k, corner)
    residual = (lin @ x - rhs).abs().amax(dim=(1, 2))
    scale = (lin.abs() @ x.abs()).amax(dim=(1, 2)) + off.abs().amax(dim=1)
    wild = wild | ~(residual <= 1e-9 * scale)
    c, r2, _ = bounding_sphere(x.permute(2, 1, 0), WOOP_SPHERE)
    tame = ~wild
    q = torch.where(tame, q, torch.inf)
    c, r2 = torch.where(tame, c, 0.0), torch.where(tame, r2, 0.0)
    zero = torch.zeros_like(p)
    cols = [c, r2[None], m[8:12], p[None], q[None], zero[None], zero[None], m[0:8]]
    return aos_rows(torch.cat(cols, dim=0))


def _woop_exact_plain(w: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """(t, hit), each (lanes, T), of rays against the (12, T) transform
    rows: the kernel's exact test, op for op. o' and d' are the kernel's
    sums in the kernel's order, with the structural zeros of the TPU
    product left out."""
    ox, oy, oz, dx, dy, dz = _columns(o, d)
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
    return t, hit


def nearest_triangle_woop_plain(
    pack: WoopPack,
    origin: torch.Tensor,
    direction: torch.Tensor,
    t_max: torch.Tensor,
    stats: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`nearest_triangle_woop` (any
    device): :func:`~theia_tpu_torch.ops.intersect_mt.chunk_walk` over
    the kernel's exact test, with the pack's sub-boxes."""
    m = _transforms(pack.b, pack.n_tri)
    return chunk_walk(
        pack.n_tri, pack.chunk_box, origin, direction, t_max,
        lambda o, d, c0: _woop_exact_plain(m[:, c0 : c0 + CHUNK], o, d), stats, sub_box=pack.sub_box,
    )


def _woop_sphere_miss_plain(aos: torch.Tensor, sub_box: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                            fused: bool = True):
    """The first of the kernel's two rejection tests
    (:func:`~theia_tpu_torch.ops.intersect_mt.sphere_miss_plain`) with the
    Woop guard g S."""
    return sphere_miss_plain(
        aos, sub_box, o, d,
        lambda a, w1, kd, ko: _fma(WOOP_GUARD * ko, a[:, 8][None], (WOOP_GUARD * kd) * a[:, 9][None], fused),
        fused,
    )


def _woop_reject_plain(aos: torch.Tensor, o: torch.Tensor, d: torch.Tensor, fused: bool = True):
    """Plain twin of the kernel's second rejection test (``reject`` of
    csrc/intersect_woop.cu): bool (lanes, T), true where the pair (ray,
    row of ``aos`` (T, ROW_AOS)) is rejected without the exact test. Same
    formulas and slack; ``fused`` rounds each a*b+c once, as the kernel's
    fmaf does."""
    ox, oy, oz, dx, dy, dz = _columns(o, d)
    col = lambda k: aos[:, k][None]
    big_p, big_q = col(8), col(9)
    kd, ko = ray_slack(o, d)
    # rows of the map: b1 at columns 12-15, b2 at 16-19, z at 4-7
    o1, o2, o3 = (
        _fma(ox, col(k), _fma(oy, col(k + 1), _fma(oz, col(k + 2), col(k + 3), fused), fused), fused)
        for k in (12, 16, 4)
    )
    d1, d2, d3 = (
        _fma(dx, col(k), _fma(dy, col(k + 1), dz * col(k + 2), fused), fused) for k in (12, 16, 4)
    )
    u = _fma(o1, d3, -(o3 * d1), fused)
    v = _fma(o2, d3, -(o3 * d2), fused)
    s = _fma(ko, big_p, kd * big_q, fused)
    return reject_tests(u, v, -o3, d3, s)


def nearest_triangle_woop(
    pack: WoopPack, origin: torch.Tensor, direction: torch.Tensor, t_max, *,
    interpret: bool | None = None, precision: str = "highest", binned: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-hit query: returns (t, tri_idx) with t=inf / idx=-1 on miss.

    ``origin``/``direction``: f32 (N, 3); ``t_max``: scalar or f32 (N,).
    A hit counts only if strictly closer than ``t_max``; the lowest index
    wins ties. CUDA tensors launch ``theia_woop_nearest`` of
    ``csrc/intersect_woop.cu``, CPU tensors run the plain version.
    ``binned=True`` sorts the rays first and scatters the winners back;
    ``None`` takes ``pack.binned``, as in
    :func:`~theia_tpu_torch.ops.intersect_mt.nearest_triangle_mt`.
    ``interpret`` and ``precision``, the JAX query's Pallas mode and
    transform precision, are accepted and ignored: the transform is
    float32 in a fixed order."""
    n = origin.shape[0]
    n_chunks = -(-pack.n_tri // CHUNK)
    t_max = check_rays(
        origin, direction, t_max,
        (
            ("pack.b", pack.b, (pack.b.shape[0], 8, 6 * BT)),
            ("pack.tri_aos", pack.tri_aos, (n_chunks * CHUNK, ROW_AOS)),
            ("pack.chunk_box", pack.chunk_box, (n_chunks, 8)),
            ("pack.sub_box", pack.sub_box, (n_chunks * CHUNK // SUB, 8)),
        ),
    )
    if pack.binned if binned is None else binned:
        return run_binned(
            lambda o, d, tm: nearest_triangle_woop(pack, o, d, tm, binned=False),
            pack.lo, pack.hi, origin, direction, t_max,
        )
    if origin.device.type == "cpu":
        return nearest_triangle_woop_plain(pack, origin, direction, t_max)
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    idx = torch.empty(n, dtype=torch.int32, device=origin.device)
    err = _build.library().theia_woop_nearest(
        origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), *scan_tables(pack), n,
        t.data_ptr(), idx.data_ptr(), _build.stream_handle(origin.device),
    )
    _build.check(err, "nearest_triangle_woop")
    nearest_triangle_woop.launches += 1
    return t, idx


nearest_triangle_woop.launches = 0
