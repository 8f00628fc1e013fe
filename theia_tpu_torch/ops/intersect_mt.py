"""Moeller-Trumbore nearest-hit queries over a Morton-ordered triangle soup.

The port of ``theia_tpu/ops/intersect_mt_pallas.py`` and the host half of
``theia_tpu/ops/_intersect_tiles.py``. The pack keeps the JAX layout —
triangles as (T_tiles, 9, BT) rows (v0xyz, e1xyz, e2xyz), padding with
v0 = 3e38 that never hits, per-tile AABBs and tight scene bounds — so the
two packages' packs compare equal. Only ``tri`` goes to the device: the
per-tile AABBs and scene bounds stay host arrays, since nothing on the
port's path reads them until ``run_binned`` is ported. The kernel reads
its own copy of the triangles, ``tri_aos``: one 20-float row a triangle
(:func:`mt_aos`, with the row's index in column :data:`INDEX_COLUMN`),
derived from ``tri`` on its device, with the boxes of its chunks and
sub-boxes.

:func:`nearest_triangle_mt` launches the hand-written scan of
``csrc/nearest_scan.cuh`` with the Moeller-Trumbore test
(``theia_soup_nearest`` of ``csrc/intersect_soup.cu``, over every chunk of
the table) on CUDA tensors and runs :func:`nearest_triangle_mt_plain` on
CPU tensors. Both compute the JAX kernel's per-pair test in the same
operation order, with 1/det as a correctly rounded reciprocal plus one
Newton step, so they agree bit for bit. :func:`nearest_triangle_mt_rows`,
the port of ``tools/exp_mt_fused.py``, also returns each winner's row of
a (T, 32) table, through the scan's variant that copies the rows itself;
``accel.intersect_scene`` calls it on ``mt`` packs. Both skip a run of
:data:`CHUNK` triangles for a ray that cannot reach its (widened) box,
the port's form of the TPU kernel's per-tile AABB skip, and within a run
the triangles of every :data:`SUB` whose box the ray cannot reach
(:func:`chunk_walk`). In front of the exact test the kernel runs two
rejection tests that never reject a pair the exact test accepts (the
ray's line against the triangle's bounding sphere, then the exact test's
inequalities without the division); :func:`_mt_sphere_miss_plain` and
:func:`_mt_reject_plain` are their plain twins.
The kernel walks the table 256 triangles at a time, one a thread, with a
fixed block of rays in shared memory, so no capacity check is needed
where the TPU version checks its VMEM budget.
The wavefront binning of the TPU version (``run_binned``, for scenes of
8192 triangles and more) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .math3d import sqrt

__all__ = [
    "MTPack",
    "morton_order",
    "pack_mt",
    "tile_aabbs",
    "scene_bounds",
    "chunk_boxes",
    "sub_boxes",
    "nearest_triangle_mt",
    "nearest_triangle_mt_plain",
    "nearest_triangle_mt_rows",
    "nearest_triangle_mt_rows_plain",
]

BT = 512  # triangles per tile for big scenes
#: small scenes use wider tiles (same choice as the TPU pack)
SMALL_SCENE_BT = 2048
SMALL_SCENE_MAX_TRI = 4 * SMALL_SCENE_BT
#: triangles per skip chunk; kChunk in csrc/nearest_scan.cuh
CHUNK = 256
#: triangles per sub-box of a chunk, a warp's share of it in the kernels;
#: kSub in csrc/nearest_scan.cuh
SUB = 32
#: the column of a kernel table's row (of ROW_AOS floats) that holds the
#: index a hit on it reports, as int32 bits; w[2].w in csrc/nearest_scan.cuh
INDEX_COLUMN = 11
#: rays per block of the plain version on the CPU, which bounds its (rays,
#: CHUNK) temporaries; 16 times as many on other devices, where a block
#: costs a host round trip per chunk
RAY_BLOCK = 4096
#: floats per row of the table nearest_triangle_mt_rows reads (tri_data)
ROW_WIDTH = 32
#: floats per row of the kernels' triangle tables (tri_aos); kRowFloat4 * 4
#: in csrc/nearest_scan.cuh
ROW_AOS = 20
#: slack factor of the kernels' rejection tests, 128 float32 unit
#: roundoffs; kSlack in csrc/nearest_scan.cuh
SLACK = 2.0 ** -17
#: r2 / R0^2 of the bounding spheres and the guard factor g of the kernels'
#: first rejection test (csrc/nearest_scan.cuh says why these pairs)
MT_SPHERE, MT_GUARD = 1.7, 4.0
WOOP_SPHERE, WOOP_GUARD = 2.8, 1.0
#: a ray or triangle with a coordinate this large gets an infinite slack;
#: kWild in csrc/nearest_scan.cuh
WILD = 1e9


class MTPack:
    """Tables of the nearest-hit query; ``n_tri`` is the count of real
    triangles (the rest of ``tri`` is padding). ``chunk_box`` and
    ``sub_box`` hold the inflated bounds of each run of :data:`CHUNK` and
    of :data:`SUB` triangles, derived from ``tri`` on its device by
    :func:`chunk_boxes`. ``aabb``, ``lo`` and ``hi`` are the JAX pack's
    per-tile AABBs and scene bounds as host numpy arrays; no query reads
    them yet. ``tri_aos`` is the kernel's table (:func:`mt_aos`, each
    row's index in column :data:`INDEX_COLUMN`), ``chunk_count`` and
    ``chunks`` the real rows of each chunk and the list of every chunk
    (:func:`whole_table`)."""

    def __init__(self, tri, aabb, lo, hi, n_tri: int) -> None:
        self.tri = tri  # f32 (T_tiles, 9, BT): v0xyz, e1xyz, e2xyz rows
        self.aabb = np.asarray(aabb, np.float32)  # (T_tiles, 8): lo xyz, pad, hi xyz, pad
        self.lo = np.asarray(lo, np.float32)  # (3,) tight scene bounds
        self.hi = np.asarray(hi, np.float32)
        self.n_tri = n_tri
        rows = _rows(tri, n_tri)
        world = (rows[0:3].T, rows[3:6].T, rows[6:9].T)
        self.chunk_box = chunk_boxes(*world)  # f32 (n_chunks, 8)
        self.sub_box = sub_boxes(*world)  # f32 (n_chunks * CHUNK / SUB, 8)
        self.tri_aos = mt_aos(rows)  # f32 (n_chunks * CHUNK, ROW_AOS)
        self.chunk_count, self.chunks = whole_table(self.tri_aos, n_tri)


def _rows(tri: torch.Tensor, n_tri: int) -> torch.Tensor:
    """(9, n_tri) component rows of the real triangles."""
    return tri.permute(1, 0, 2).reshape(9, -1)[:, :n_tri]


def aos_rows(cols: torch.Tensor) -> torch.Tensor:
    """(n_chunks * CHUNK, ROW_AOS) table from (k <= ROW_AOS, n_tri) column
    rows: transposed, zero-filled to the row width and to whole chunks, so
    a chunk is one contiguous span of 16-byte-aligned rows."""
    k, n_tri = cols.shape
    n_rows = -(-n_tri // CHUNK) * CHUNK
    out = torch.zeros((n_rows, ROW_AOS), dtype=torch.float32, device=cols.device)
    out[:n_tri, :k] = cols.T
    return out


def whole_table(aos: torch.Tensor, n_tri: int):
    """A pack's table as the kernels take it: writes each real row's index
    (its place) into column :data:`INDEX_COLUMN` of ``aos`` (the padding
    rows stay 0) and returns ``chunk_count`` (the real rows of each
    chunk) and ``chunks`` (every chunk), both i32 on ``aos``'s device."""
    n_chunks = aos.shape[0] // CHUNK
    aos.view(torch.int32)[:n_tri, INDEX_COLUMN] = torch.arange(n_tri, dtype=torch.int32, device=aos.device)
    starts = torch.arange(0, n_chunks * CHUNK, CHUNK, device=aos.device)
    count = (n_tri - starts).clamp(max=CHUNK).to(torch.int32)
    return count, torch.arange(n_chunks, dtype=torch.int32, device=aos.device)


def bounding_sphere(vertices: torch.Tensor, factor: float):
    """(c, r2, R0): the float32 centroid c (3, n) of float64 ``vertices``
    (3 vertices, 3, n), r2 (n,) = ``factor`` R0^2 rounded up, as the
    kernels' bounding-sphere test wants them, and R0 in float64, the
    largest distance from c to a vertex."""
    c = vertices.mean(dim=0).float()
    r0 = (vertices - c.double()).norm(dim=1).amax(dim=0)
    return c, (factor * (1.0 + 1e-6) * r0 * r0).float(), r0


def mt_aos(rows: torch.Tensor) -> torch.Tensor:
    """The Moeller-Trumbore kernel's table from the (9, n_tri) component
    rows; per triangle (see csrc/moller_trumbore.cuh): the bounding sphere c,
    r2 = 1.7 R0^2; n = e1 x e2 (formed in float64, rounded once) and alpha; beta_w,
    beta, e2 z, 0 (the index column, which the caller fills); v0, e1, e2 xy. alpha = E1 + E2 + E1 E2, beta =
    3 E1 E2 + 1e-30 and beta_w = beta + 1.75 R0 alpha are the slack
    coefficients of the rejection tests, with E1 = max|e1_k|, E2 =
    max|e2_k| (beta = beta_w = inf where a coordinate reaches
    :data:`WILD`)."""
    v0, e1, e2 = rows[0:3].double(), rows[3:6].double(), rows[6:9].double()
    n = torch.linalg.cross(e1, e2, dim=0).float()
    c, r2, r0 = bounding_sphere(torch.stack([v0, v0 + e1, v0 + e2]), MT_SPHERE)
    big1, big2 = rows[3:6].abs().amax(dim=0), rows[6:9].abs().amax(dim=0)
    alpha = big1 + big2 + big1 * big2
    tame = rows.abs().amax(dim=0) < WILD
    beta = torch.where(tame, 3.0 * big1 * big2 + 1e-30, torch.inf)
    beta_w = beta + 1.75 * r0.float() * alpha
    zero = torch.zeros_like(alpha)
    cols = [c, r2[None], n, alpha[None], beta_w[None], beta[None], rows[8:9], zero[None], rows[0:8]]
    return aos_rows(torch.cat(cols, dim=0))


def chunk_boxes(v0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor, size: int = CHUNK) -> torch.Tensor:
    """(n_chunks, 8) bounds (lo xyz, 0, hi xyz, 0) of each run of ``size``
    (:data:`CHUNK` by default) world triangles (v0, e1, e2: f32 (n_tri, 3)) over their
    float32 vertices v0, v0+e1, v0+e2, widened by 1e-3 of the extent plus
    1e-5 on each side. The margin is far above float32 rounding (and above
    the Woop test's 1e-6 barycentric slack), so a ray that misses the box
    cannot hit a triangle in it: skipping the chunk never changes a
    result. The values are exact min/max plus the same float32 ops on
    every device, which keeps a kernel's skips identical to its plain
    version's. The MT and Woop packs both take their boxes from here, the
    soup's table its chunks' boxes and its sub-boxes."""
    n_tri = v0.shape[0]
    n_chunks = -(-n_tri // size)
    pad = n_chunks * size - n_tri
    pts = torch.stack([v0, v0 + e1, v0 + e2], dim=0)  # (3 points, n_tri, 3)
    # fill the last chunk with copies of its last triangle
    pts = torch.cat([pts, pts[:, -1:].expand(3, pad, 3)], dim=1)
    pts = pts.reshape(3, n_chunks, size, 3)
    lo, hi = pts.amin(dim=(0, 2)), pts.amax(dim=(0, 2))  # (n_chunks, 3)
    margin = (hi - lo) * 1e-3 + 1e-5
    zero = torch.zeros_like(lo[:, :1])
    return torch.cat([lo - margin, zero, hi + margin, zero], dim=1).contiguous()


def sub_boxes(v0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """(n_chunks * CHUNK / SUB, 8) boxes of every run of :data:`SUB` world
    triangles (:func:`chunk_boxes`), a chunk's eight; the last chunk's runs
    past the last triangle repeat its last box (they hold no real row)."""
    boxes = chunk_boxes(v0, e1, e2, SUB)
    n = -(-v0.shape[0] // CHUNK) * (CHUNK // SUB)
    return torch.cat([boxes, boxes[-1:].expand(n - boxes.shape[0], 8)]).contiguous()


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


def _slab(box, o, inv):
    """(tn, tf): where rays (o, 1/d) enter the box (0 if o is inside) and
    leave it, as the kernels' slab test computes them."""
    t1 = (box[0:3] - o) * inv
    t2 = (box[4:7] - o) * inv
    near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tn = torch.maximum(
        torch.maximum(near[:, 0], near[:, 1]), torch.clamp_min(near[:, 2], 0.0)
    )
    tf = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
    return tn, tf


def _slab_candidates(box, o, inv, best_t) -> torch.Tensor:
    """Rays (o, 1/d) whose segment [0, best_t) can enter the box."""
    tn, tf = _slab(box, o, inv)
    return (tn <= tf) & (tn < best_t)


def chunk_walk(
    n_tri: int, chunk_box, origin, direction, t_max, pair_test, stats=None,
    *, visits=None, active=None, any_hit: bool = False, index=None, sub_box=None,
):
    """The chunked scan all plain versions share. Rays go in blocks (of
    :data:`RAY_BLOCK` on the CPU); a ray tests a run of :data:`CHUNK` triangles only
    if its segment [0, best_t) can enter the run's box. ``pair_test(o, d,
    c0)`` gives (t, hit) of shape (lanes, chunk) for the rays ``o``, ``d``
    (lanes, 3) against the triangles from table row ``c0``. Within a chunk the
    lowest index wins ties, and a chunk's winner replaces the running one
    only if strictly closer: the kernels' sequential strict update. With
    ``sub_box`` (the boxes of every run of :data:`SUB` rows, (n_chunks *
    CHUNK / SUB, 8)), as the kernels take it, a ray tests only the
    triangles of the sub-boxes that its segment [0, best_t) enters, best_t
    as at the chunk's start; without, every triangle of the chunk (the
    rule of the first kernels, which measurements of them still use).

    With a dict ``stats``, ``stats["pairs"]`` grows by the (ray, triangle)
    pairs that were tested, ``stats["chunk_tests"]`` by the (ray, chunk)
    box tests of rays still in the walk and ``stats["sub_tests"]`` by the
    (ray, sub-box) box tests of the rays that a chunk's box lets in; for
    every ``name: test`` in ``stats["tests"]`` (if present) ``stats[name]``
    grows by the pairs of them for which ``test(o, d, c0)`` (bool (lanes,
    chunk)) holds.

    The soup queries add four things. ``visits`` lists the chunks to
    walk as ``(chunk, first, count)``: the chunk of the table (its rows
    start at ``chunk * CHUNK``), the index that its first triangle
    reports and how many of its rows are real; the default is every chunk
    of a table of ``n_tri`` rows in one piece. ``active`` (bool (N,))
    takes lanes out: they test nothing and report a miss. With
    ``any_hit`` the walk returns one bool a ray, whether some triangle is
    hit strictly before ``t_max``, and a ray leaves the walk at its first
    hit. ``index`` (i32, a value a table row) gives the index that each row
    reports, where the rows of a chunk are not consecutive indices (the
    soup's table in Morton order); ties then go to the lowest index
    whatever the order in which the chunks come, as the kernels' (t bits,
    index) key does."""
    n = origin.shape[0]
    t_out = torch.empty(n, dtype=torch.float32, device=origin.device)
    i_out = torch.empty(n, dtype=torch.int32, device=origin.device)
    if visits is None:
        visits = [(c, c0, min(CHUNK, n_tri - c0)) for c, c0 in enumerate(range(0, n_tri, CHUNK))]
    block = RAY_BLOCK if origin.device.type == "cpu" else 16 * RAY_BLOCK
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        o_blk, d_blk = origin[r0:r1], direction[r0:r1]
        inv_d = _rcp(_safe(d_blk))
        best_t = t_max[r0:r1].clone()
        if active is not None:
            best_t = torch.where(active[r0:r1], best_t, 0.0)
        best_i = torch.full_like(best_t, -1, dtype=torch.int32)
        for c, first, count in visits:
            lanes = torch.nonzero(
                _slab_candidates(chunk_box[c], o_blk, inv_d, best_t)
            )[:, 0]
            if stats is not None:
                stats["chunk_tests"] = stats.get("chunk_tests", 0) + int((best_t > 0.0).sum())
            if lanes.numel() == 0:
                continue
            c0 = c * CHUNK
            cur_t, cur_i = best_t[lanes], best_i[lanes]
            o_l, d_l = o_blk[lanes], d_blk[lanes]
            needed = torch.ones((lanes.numel(), count), dtype=torch.bool, device=origin.device)
            if sub_box is not None:
                inv_l, k0 = inv_d[lanes], c0 // SUB
                enter = [_slab_candidates(sub_box[k0 + k], o_l, inv_l, cur_t) for k in range(CHUNK // SUB)]
                needed = torch.stack(enter, dim=1).repeat_interleave(SUB, dim=1)[:, :count]
            if stats is not None:
                stats["pairs"] = stats.get("pairs", 0) + int(needed.sum())
                if sub_box is not None:
                    stats["sub_tests"] = stats.get("sub_tests", 0) + lanes.numel() * (CHUNK // SUB)
                for name, test in stats.get("tests", {}).items():
                    stats[name] = stats.get(name, 0) + int((test(o_l, d_l, c0)[:, :count] & needed).sum())
            t, hit = pair_test(o_l, d_l, c0)
            t, hit = t[:, :count], hit[:, :count] & needed
            if any_hit:  # a hit below the bound ends the ray's walk
                occluded = (hit & (t < cur_t[:, None])).any(dim=1)
                best_i[lanes] = torch.where(occluded, 0, cur_i)
                best_t[lanes] = torch.where(occluded, 0.0, cur_t)
                continue
            t = torch.where(hit, t, torch.inf)
            tt, ic = t.min(dim=1)
            if index is None:
                win = ic.to(torch.int32) + first
                better = tt < cur_t
            else:  # the lowest index among the chunk's nearest, then (t, index) against the running one
                ids = torch.where(t == tt[:, None], index[c0 : c0 + count][None], torch.iinfo(torch.int32).max)
                win = ids.amin(dim=1)
                better = (tt < cur_t) | ((tt == cur_t) & (win < cur_i))
            best_i[lanes] = torch.where(better, win, cur_i)
            best_t[lanes] = torch.where(better, tt, cur_t)
        t_out[r0:r1] = torch.where(best_i < 0, torch.inf, best_t)
        i_out[r0:r1] = best_i
    return i_out >= 0 if any_hit else (t_out, i_out)


def _columns(o: torch.Tensor, d: torch.Tensor):
    """The six (lanes, 1) component columns of rays (lanes, 3) x2."""
    return (*(o[:, k : k + 1] for k in range(3)), *(d[:, k : k + 1] for k in range(3)))


def _mt_exact_plain(rows: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """(t, hit), each (lanes, T), of rays against the (9, T) component
    rows: the kernel's exact test, op for op."""
    ox, oy, oz, dx, dy, dz = _columns(o, d)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (rows[k : k + 1] for k in range(9))
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
    return t, hit


def nearest_triangle_mt_plain(
    pack: MTPack,
    origin: torch.Tensor,
    direction: torch.Tensor,
    t_max: torch.Tensor,
    stats: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`nearest_triangle_mt` (any device):
    :func:`chunk_walk` over the kernel's exact test, with the pack's
    sub-boxes."""
    rows = _rows(pack.tri, pack.n_tri)
    return chunk_walk(
        pack.n_tri, pack.chunk_box, origin, direction, t_max,
        lambda o, d, c0: _mt_exact_plain(rows[:, c0 : c0 + CHUNK], o, d), stats, sub_box=pack.sub_box,
    )


def _fma(a, b, c, fused: bool):
    """a * b + c in float32: rounded once (through float64, where the
    product of two float32 is exact) if ``fused``, else twice."""
    if fused:
        return (a.double() * b.double() + c.double()).float()
    return a * b + c


def ray_slack(o: torch.Tensor, d: torch.Tensor):
    """Per-ray factors (kd, ko), each (lanes, 1), of the rejection tests'
    slack: kd = SLACK * max(|d|_inf, 1) and ko = kd * |o|_inf, both inf
    for a ray with a NaN or a coordinate that reaches :data:`WILD`."""
    omax, dmax = o.abs().amax(dim=1, keepdim=True), d.abs().amax(dim=1, keepdim=True)
    tame = (omax < WILD) & (dmax < WILD)  # false for NaN as well
    kd = torch.where(tame, SLACK * torch.clamp_min(dmax, 1.0), torch.inf)
    return kd, torch.where(tame, kd * omax, torch.inf)


def reject_tests(u, v, w, det, s):
    """The comparisons both rejection tests end in: with sg = sign(det),
    reject unless sg u, sg v >= -lo, sg (u + v) <= |det| + lo and
    (sg w >= -s or |det| <= s), lo = 4e-6 |det| + s. NaN rejects nothing."""
    adet = det.abs()
    lo = adet * 4e-6 + s
    sg = torch.where(torch.signbit(det), -1.0, 1.0)
    su, sv = sg * u, sg * v
    return (su < -lo) | (sv < -lo) | (su + sv > adet + lo) | ((sg * w < -s) & (adet > s))


def sphere_miss_plain(aos, sub_box, o, d, guard, fused: bool = True):
    """Plain twin of ``sphere_miss`` in csrc/nearest_scan.cuh on the rows
    ``aos`` (R, ROW_AOS) that the boxes ``sub_box`` (ceil(R / SUB), 8)
    bound, :data:`SUB` rows each: bool (lanes, R), true where the pair is
    dropped. Each ray's origin moves to where it enters the row's sub-box
    (o' = o + s d), the line through o' is held against the row's bounding
    sphere (columns 0-3) widened by the rounding of o', and |det| (d
    dotted with columns 4-6) against ``guard(rows, w1, kd, ko)`` = g S,
    with |w|_1 widened by |o - o'|_1 (csrc/nearest_scan.cuh has the
    argument). ``fused`` rounds each a*b+c once, as the kernel's fmaf
    does."""
    kd, ko = ray_slack(o, d)
    inv = _rcp(_safe(d))
    d1k = (d[:, 0:1].abs() + d[:, 1:2].abs() + d[:, 2:3].abs()) * (1.0 + 2.0**-20)
    dx, dy, dz = (d[:, k : k + 1] for k in range(3))
    dd = _fma(dz, dz, _fma(dy, dy, dx * dx, fused), fused)
    ddk = dd * (1.0 - 64.0 * 2.0**-24)
    out = []
    for k in range(-(-aos.shape[0] // SUB)):
        a = aos[k * SUB : (k + 1) * SUB]
        s = _slab(sub_box[k], o, inv)[0][:, None]
        o2 = _fma(s, d, o, fused)
        delta = 2.0**-22 * (o2[:, 0:1].abs() + o2[:, 1:2].abs() + o2[:, 2:3].abs())
        sigma = _fma(s, d1k, delta, fused)
        ox, oy, oz = (o2[:, j : j + 1] for j in range(3))
        cx, cy, cz, r2 = (a[:, j][None] for j in range(4))
        n0, n1, n2 = (a[:, j][None] for j in (4, 5, 6))
        wx, wy, wz = cx - ox, cy - oy, cz - oz
        p = _fma(wz, dz, _fma(wy, dy, wx * dx, fused), fused)
        w2 = _fma(wz, wz, _fma(wy, wy, wx * wx, fused), fused)
        q = _fma(w2, ddk, -(p * p), fused)
        det = _fma(dz, n2, _fma(dy, n1, dx * n0, fused), fused)
        g = guard(a, wx.abs() + wy.abs() + wz.abs() + sigma, kd, ko)
        rad = sqrt(r2) + delta
        out.append((q > rad * rad * dd) & (det.abs() > g))
    return torch.cat(out, dim=1)


def chunk_tables(aos: torch.Tensor, sub_box: torch.Tensor, c0: int):
    """The rows of a kernel table's chunk that starts at row ``c0``, and
    their sub-boxes, as the rejection twins take them."""
    return aos[c0 : c0 + CHUNK], sub_box[c0 // SUB : (c0 + CHUNK) // SUB]


def _mt_sphere_miss_plain(aos: torch.Tensor, sub_box: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                          fused: bool = True):
    """The first of the kernel's two rejection tests (:func:`sphere_miss_plain`)
    with the Moeller-Trumbore guard g S (|T|_1 bounded through |w|_1)."""
    return sphere_miss_plain(
        aos, sub_box, o, d,
        lambda a, w1, kd, ko: (MT_GUARD * kd) * _fma(w1, a[:, 7][None], a[:, 8][None], fused), fused,
    )


def _mt_reject_plain(aos: torch.Tensor, o: torch.Tensor, d: torch.Tensor, fused: bool = True):
    """Plain twin of the kernel's second rejection test (``reject`` of
    csrc/moller_trumbore.cuh): bool (lanes, T), true where the pair (ray,
    row of ``aos`` (T, ROW_AOS)) is rejected without the exact test. Same
    formulas and slack; ``fused`` rounds each a*b+c once, as the kernel's
    fmaf does."""
    ox, oy, oz, dx, dy, dz = _columns(o, d)
    nx, ny, nz, alpha, _, beta = (aos[:, k][None] for k in range(4, 10))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y = (aos[:, k][None] for k in range(12, 20))
    e2z = aos[:, 10][None]
    kd, _ = ray_slack(o, d)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    cx = _fma(ty, dz, -(tz * dy), fused)
    cy = _fma(tz, dx, -(tx * dz), fused)
    cz = _fma(tx, dy, -(ty * dx), fused)
    u = _fma(e2z, cz, _fma(e2y, cy, e2x * cx, fused), fused)
    v = -_fma(e1z, cz, _fma(e1y, cy, e1x * cx, fused), fused)
    det = -_fma(dz, nz, _fma(dy, ny, dx * nx, fused), fused)
    w = _fma(tz, nz, _fma(ty, ny, tx * nx, fused), fused)
    t1 = tx.abs() + ty.abs() + tz.abs()
    s = kd * _fma(t1, alpha, beta, fused)
    return reject_tests(u, v, w, det, s)


def check_rays(origin, direction, t_max, tables) -> torch.Tensor:
    """Raise unless the rays and the ``(name, tensor, shape)`` tables are
    contiguous float32 of the stated shapes on the rays' device; returns
    ``t_max`` (a scalar or (N,)) broadcast to a contiguous (N,) tensor."""
    n = origin.shape[0]
    t_max = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=origin.device), (n,)
    ).contiguous()
    for name, a, shape in (
        ("origin", origin, (n, 3)),
        ("direction", direction, (n, 3)),
        ("t_max", t_max, (n,)),
        *tables,
    ):
        if a.dtype != torch.float32 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be float32 of shape {shape}")
        if not a.is_contiguous() or a.device != origin.device:
            raise ValueError(f"{name} must be contiguous on {origin.device}")
    if origin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {origin.device}")
    return t_max


def _mt_tables(pack: MTPack):
    n_chunks = -(-pack.n_tri // CHUNK)
    return (
        ("pack.tri", pack.tri, (pack.tri.shape[0], 9, pack.tri.shape[2])),
        ("pack.tri_aos", pack.tri_aos, (n_chunks * CHUNK, ROW_AOS)),
        ("pack.chunk_box", pack.chunk_box, (n_chunks, 8)),
        ("pack.sub_box", pack.sub_box, (n_chunks * CHUNK // SUB, 8)),
    )


def scan_tables(pack) -> tuple:
    """The table arguments of the scan's C entry points for an MT or Woop
    pack: rows, boxes, counts and the list of every chunk."""
    return (
        pack.tri_aos.data_ptr(), pack.chunk_box.data_ptr(), pack.sub_box.data_ptr(),
        pack.chunk_count.data_ptr(), pack.chunks.data_ptr(), pack.chunks.numel(),
    )


def nearest_triangle_mt(
    pack: MTPack, origin: torch.Tensor, direction: torch.Tensor, t_max
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-hit query: returns (t, tri_idx) with t=inf / idx=-1 on miss.

    ``origin``/``direction``: f32 (N, 3); ``t_max``: scalar or f32 (N,).
    A hit counts only if strictly closer than ``t_max``; the lowest index
    wins ties. CUDA tensors launch the scan (``theia_soup_nearest`` over
    every chunk of the pack), CPU tensors run the plain version."""
    n = origin.shape[0]
    t_max = check_rays(origin, direction, t_max, _mt_tables(pack))
    if origin.device.type == "cpu":
        return nearest_triangle_mt_plain(pack, origin, direction, t_max)
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    idx = torch.empty(n, dtype=torch.int32, device=origin.device)
    err = _build.library().theia_soup_nearest(
        origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), None, *scan_tables(pack), n,
        t.data_ptr(), idx.data_ptr(), _build.stream_handle(origin.device),
    )
    _build.check(err, "nearest_triangle_mt")
    nearest_triangle_mt.launches += 1
    return t, idx


nearest_triangle_mt.launches = 0


def nearest_triangle_mt_rows_plain(
    pack: MTPack, table: torch.Tensor, origin, direction, t_max, stats: dict | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`nearest_triangle_mt_rows`: the
    plain query, then a gather of ``table[max(idx, 0)]``."""
    t, idx = nearest_triangle_mt_plain(pack, origin, direction, t_max, stats)
    return t, idx, table[torch.clamp_min(idx, 0).to(torch.int64)]


def nearest_triangle_mt_rows(
    pack: MTPack, table: torch.Tensor, origin: torch.Tensor, direction: torch.Tensor, t_max
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`nearest_triangle_mt` plus each winner's table row: returns
    (t, idx, rows) with rows f32 (N, 32) = ``table[max(idx, 0)]`` (row 0
    on a miss), ``table`` f32 (R >= n_tri, 32), e.g. the scene's
    ``tri_data``. The port of ``tools/exp_mt_fused.py``'s fused kernel:
    CUDA tensors launch the row-copying variant of the scan
    (``theia_soup_nearest_rows``), CPU tensors run the plain version."""
    n = origin.shape[0]
    if table.shape[0] < pack.n_tri:
        raise ValueError(f"table has {table.shape[0]} rows, fewer than {pack.n_tri} triangles")
    t_max = check_rays(
        origin, direction, t_max,
        (*_mt_tables(pack), ("table", table, (table.shape[0], ROW_WIDTH))),
    )
    if origin.device.type == "cpu":
        return nearest_triangle_mt_rows_plain(pack, table, origin, direction, t_max)
    t = torch.empty(n, dtype=torch.float32, device=origin.device)
    idx = torch.empty(n, dtype=torch.int32, device=origin.device)
    rows = torch.empty((n, ROW_WIDTH), dtype=torch.float32, device=origin.device)
    err = _build.library().theia_soup_nearest_rows(
        origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(), None, *scan_tables(pack), n,
        table.data_ptr(), t.data_ptr(), idx.data_ptr(), rows.data_ptr(), _build.stream_handle(origin.device),
    )
    _build.check(err, "nearest_triangle_mt_rows")
    nearest_triangle_mt_rows.launches += 1
    return t, idx, rows


nearest_triangle_mt_rows.launches = 0
