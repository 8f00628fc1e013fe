"""Two-level instanced traversal: the port of ``theia_tpu/ops/instanced.py``.

The domain's scaling scenario is a detector array: many copies of a few
module meshes. A scene's instances are grouped by their mesh (a
:class:`GroupPack` each); a query walks each group in pack order. Per
lane it takes the group's instances in the order in which its segment
enters their boxes (:func:`_next_candidate`, a cursor on ``(t_entry,
k)`` that moves strictly forward, so no lane keeps a visited set), moves
the ray into the candidate's object space with that instance's
world-to-object row (the direction is not normalized, so t stays the
world ray parameter) and scans the shared prototype for the nearest hit.
A lane is done once no box it has not taken is entered before its
nearest hit. A box is also passed over where the segment provably misses
the instance's bounding sphere (conservative, so no winner changes).

The prototype and the world-to-object rows of a group are multiplied by
the group's median instance scale (``pack_instanced``), so that the
transformed rays and triangles sit at world magnitude and the exact
test's absolute ``|det|`` cutoff means what it means for the world-space
scan.

:func:`nearest_triangle_instanced` and :func:`occluded_instanced` launch
the walk of ``csrc/instanced_walk.cu`` (a block deals its lanes'
candidates to its warps, a warp scans one candidate's prototype together,
the soup kernels' rejection test in front of the exact one; the group's
tables in shared memory where they fit :data:`SHARED_MAX`; a launch a
group) on CUDA tensors and run their plain versions on CPU tensors;
kernel and plain version agree bit for bit. They use the soup kernels' exact
Moeller-Trumbore test (``intersect_mt.mt_exact``) and the ray transform
in a fixed summation order, where JAX divides and leaves the transform
to XLA's einsum: against ``theia_tpu`` the winners agree except where a
second hit lies within ulps, and t to ulps. ``theia_tpu``'s compaction
ladder (``THEIA_INSTANCED_LADDER*``) and ``query_profile`` are not
ported: they reorder XLA's work and are pinned bit-identical to the plain
walk, which is what this is. The sphere pretest is always on, in the
initial candidate scan too (``theia_tpu``'s defaults).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import _build
from .bvh_traverse import inv_dir
from .intersect_mt import RAY_BLOCK, check_rays, mt_aos, mt_exact

__all__ = [
    "GroupPack",
    "InstancedPack",
    "pack_instanced",
    "nearest_triangle_instanced",
    "nearest_triangle_instanced_plain",
    "occluded_instanced",
    "occluded_instanced_plain",
    "placement",
]

#: instance boxes a row of the packed box tables (theia_tpu's scan chunk)
BOX_CHUNK = 64
#: the sphere pretest is packed for a group only where its spheres are
#: tighter than its boxes' circumspheres: mean radius < SPHERE_TIGHT x mean
#: half-diagonal (theia_tpu's gate; the pretest never changes a winner)
SPHERE_TIGHT = 0.95
#: the most bytes of a group's tables the walk stages in a block's shared
#: memory: two blocks of 512 threads, each with its 20,484 bytes of pair
#: queue, then fit an H100 SM. The boxes go there where they fit, the
#: prototype's rows (``GroupPack.rows``, 64 bytes a row) too where both fit
#: (:func:`placement`)
SHARED_MAX = 94_208
#: the kernel's placements (``Place`` in csrc/instanced_walk.cu), by code
PLACES = ("global", "boxes", "boxes and rows")


@dataclass(frozen=True)
class GroupPack:
    """One prototype mesh and its K placed instances, as
    ``theia_tpu.ops.instanced.GroupPack``: ``v0``/``e1``/``e2`` (T, 3) the
    scale-normalized object-space triangles, ``w2o`` (K, 12) the
    scale-normalized world-to-object rows, ``box`` six (ceil(K / 64), 64)
    tables (lo xyz, hi xyz; padding inverted far boxes), ``base`` (K,) i32
    the ``tri_data`` row of each instance's first triangle, ``sph`` four
    (ceil(K / 64), 64) tables (centre xyz, r^2 with the build's slack) or
    None. Derived on the same device: ``tri`` (T, 9) ``[v0, e1, e2]``;
    ``rows`` (4, T, 4), the kernel's copy of the prototype, the four
    16-byte planes of the Moeller-Trumbore table's rows past their sphere
    (``intersect_mt.mt_aos`` columns 4-19: n, alpha | beta_w, beta, e2 z,
    0 | v0, e1 x | e1 yz, e2 xy), what the kernel's rejection and exact
    tests read; ``boxes`` (6 or 10, ceil(K / 64) * 64), the box and sphere
    tables stacked."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    w2o: torch.Tensor
    box: tuple
    base: torch.Tensor
    sph: tuple | None = None
    tri: torch.Tensor = field(init=False, repr=False, compare=False)
    rows: torch.Tensor = field(init=False, repr=False, compare=False)
    boxes: torch.Tensor = field(init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        object.__setattr__(self, "tri", torch.cat([self.v0, self.e1, self.e2], dim=1).contiguous())
        aos = mt_aos(self.tri.T)[: self.v0.shape[0], 4:20]
        object.__setattr__(self, "rows", aos.reshape(-1, 4, 4).transpose(0, 1).contiguous())
        tables = (*self.box, *(self.sph or ()))
        object.__setattr__(self, "boxes", torch.stack([a.reshape(-1) for a in tables]).contiguous())


@dataclass(frozen=True)
class InstancedPack:
    groups: tuple  # tuple[GroupPack, ...]
    n_boxes: int  # total instances

    def to(self, device) -> "InstancedPack":
        """The same tables on ``device``."""
        move = lambda t: None if t is None else tuple(a.to(device) for a in t)
        groups = tuple(
            GroupPack(g.v0.to(device), g.e1.to(device), g.e2.to(device), g.w2o.to(device), move(g.box),
                      g.base.to(device), move(g.sph))
            for g in self.groups
        )
        return InstancedPack(groups, self.n_boxes)


def pack_instanced(instances, w2o_rows, *, device) -> InstancedPack:
    """Group a scene's instances by prototype mesh, as ``theia_tpu``'s
    ``pack_instanced`` does (the same tables bit for bit), on ``device``.

    ``instances``: the Scene's MeshInstance list (build order defines the
    global triangle row layout: each instance's triangles contiguous).
    ``w2o_rows``: (K, 3, 4) world-to-object transforms in the same order.
    """
    groups: dict[int, dict] = {}
    base = 0
    for k, inst in enumerate(instances):
        mesh = inst.mesh
        gid = id(mesh)
        if gid not in groups:
            pos = np.asarray(mesh.vertices[:, :3], np.float32)
            idx = np.asarray(mesh.indices)
            groups[gid] = dict(
                v0=pos[idx[:, 0]], e1=pos[idx[:, 1]] - pos[idx[:, 0]], e2=pos[idx[:, 2]] - pos[idx[:, 0]],
                # the object-space vertices any triangle references: each
                # instance's bounding sphere transforms these once
                used=pos[np.unique(idx.ravel())],
                w2o=[], blo=[], bhi=[], base=[], sc=[], sr=[],
            )
        g = groups[gid]
        bb = inst.bbox
        g["w2o"].append(np.asarray(w2o_rows[k], np.float64).reshape(3, 4))
        g["blo"].append(np.asarray(bb.lowerCorner, np.float32))
        g["bhi"].append(np.asarray(bb.upperCorner, np.float32))
        g["base"].append(base)
        base += len(inst.mesh.indices)
        # conservative world bounding sphere over the instance's
        # referenced vertices (the slack of CullTables)
        wv = np.asarray(inst.transform.apply(g["used"]), np.float32)
        c = 0.5 * (wv.min(axis=0) + wv.max(axis=0))
        g["sc"].append(c)
        g["sr"].append(float(np.linalg.norm(wv - c, axis=1).max()) * 1.001 + 1e-5)

    as_tensor = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    packed = []
    for g in groups.values():
        w2o = np.stack(g["w2o"])  # (K, 3, 4) f64
        # median instance scale: |det(w2o_lin)|^(-1/3) is the world size
        # of a unit object length under instance k
        det = np.abs(np.linalg.det(w2o[:, :, :3]))
        scale = float(np.median(np.where(det > 0, det, 1.0) ** (-1.0 / 3.0)))
        blo, bhi = np.stack(g["blo"]), np.stack(g["bhi"])
        half_diag = 0.5 * np.linalg.norm(bhi - blo, axis=1)
        radii = np.asarray(g["sr"], np.float32)
        sph = None
        if float(np.mean(radii)) < SPHERE_TIGHT * float(np.mean(half_diag)):
            sph = tuple(as_tensor(a) for a in _pack_spheres(np.stack(g["sc"]), radii))
        packed.append(GroupPack(
            v0=as_tensor(g["v0"] * scale), e1=as_tensor(g["e1"] * scale), e2=as_tensor(g["e2"] * scale),
            w2o=as_tensor((w2o * scale).reshape(len(g["base"]), 12), torch.float32),
            box=tuple(as_tensor(a) for a in _pack_boxes(blo, bhi)),
            base=as_tensor(np.asarray(g["base"], np.int32)),
            sph=sph,
        ))
    return InstancedPack(groups=tuple(packed), n_boxes=len(instances))


def _pack_boxes(blo: np.ndarray, bhi: np.ndarray) -> tuple:
    """(K, 3) lo/hi corners -> six (n_chunks, BOX_CHUNK) component arrays;
    padded slots are inverted far boxes that no ray enters."""
    K = blo.shape[0]
    n_chunks = -(-K // BOX_CHUNK)
    pad = n_chunks * BOX_CHUNK - K
    blo = np.pad(blo, ((0, pad), (0, 0)), constant_values=3.0e38)
    bhi = np.pad(bhi, ((0, pad), (0, 0)), constant_values=-3.0e38)
    return tuple(a[:, i].reshape(n_chunks, BOX_CHUNK) for a in (blo, bhi) for i in range(3))


def _pack_spheres(centers: np.ndarray, radii: np.ndarray) -> tuple:
    """(K, 3) centres + (K,) radii -> four (n_chunks, BOX_CHUNK) arrays
    (cx, cy, cz, r^2); padded slots never matter (their boxes reject)."""
    K = centers.shape[0]
    n_chunks = -(-K // BOX_CHUNK)
    pad = n_chunks * BOX_CHUNK - K
    centers = np.pad(centers, ((0, pad), (0, 0)))
    r2 = np.pad(radii.astype(np.float64) ** 2, (0, pad)).astype(np.float32)
    return tuple(a.reshape(n_chunks, BOX_CHUNK) for a in (centers[:, 0], centers[:, 1], centers[:, 2], r2))


def _next_candidate(g: GroupPack, o, d, inv, last_tn, last_k, bound, stats=None):
    """Per lane, the nearest instance box strictly after the cursor
    ``(last_tn, last_k)`` (lexicographic) that the segment [0, ``bound``)
    enters, and whose bounding sphere it can reach where the group packs
    spheres: (tn, k), (inf, -1) when there is none. Every component in the
    kernel's order (``next_candidate`` in csrc/instanced_walk.cu)."""
    n_box = g.base.shape[0]
    lo = [a.reshape(-1)[:n_box][None] for a in g.box[:3]]
    hi = [a.reshape(-1)[:n_box][None] for a in g.box[3:]]
    t1 = [(lo[i] - o[:, i : i + 1]) * inv[:, i : i + 1] for i in range(3)]
    t2 = [(hi[i] - o[:, i : i + 1]) * inv[:, i : i + 1] for i in range(3)]
    mn = [torch.minimum(a, b) for a, b in zip(t1, t2)]
    mx = [torch.maximum(a, b) for a, b in zip(t1, t2)]
    tn = torch.maximum(torch.maximum(mn[0], mn[1]), mn[2])
    tf = torch.minimum(torch.minimum(mx[0], mx[1]), mx[2])
    ks = torch.arange(n_box, dtype=torch.int32, device=o.device)[None]
    bound, last_tn, last_k = bound[:, None], last_tn[:, None], last_k[:, None]
    ok = (
        (hi[0] >= lo[0])  # padding
        & (tf >= torch.clamp_min(tn, 0.0))
        & (tn < bound)
        & ((tn > last_tn) | ((tn == last_tn) & (ks > last_k)))
    )
    if stats is not None:
        stats["box_tests"] = stats.get("box_tests", 0) + o.shape[0] * n_box
        if g.sph is not None:  # the kernel tests a sphere where the box lets the ray in
            stats["sphere_tests"] = stats.get("sphere_tests", 0) + int(ok.sum())
    if g.sph is not None:
        # segment against the bounding sphere (conservative; a NaN only clears ok)
        dx, dy, dz = (d[:, i : i + 1] for i in range(3))
        neg_inv_d2 = -1.0 / torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-30)
        scx, scy, scz, sr2 = (a.reshape(-1)[:n_box][None] for a in g.sph)
        ocx, ocy, ocz = o[:, 0:1] - scx, o[:, 1:2] - scy, o[:, 2:3] - scz
        b = ocx * dx + ocy * dy + ocz * dz
        tc = torch.minimum(torch.clamp_min(b * neg_inv_d2, 0.0), bound)
        px, py, pz = ocx + tc * dx, ocy + tc * dy, ocz + tc * dz
        s = px * px + py * py + pz * pz
        oc2 = ocx * ocx + ocy * ocy + ocz * ocz
        ok &= s <= sr2 * 1.003 + oc2 * 1e-5 + 1e-9
    tn = torch.where(ok, tn, torch.inf)
    best_tn = tn.amin(dim=1)
    best_k = torch.where(ok & (tn == best_tn[:, None]), ks, torch.iinfo(torch.int32).max).amin(dim=1)
    return best_tn, torch.where(torch.isfinite(best_tn), best_k, -1)


def _transform(w2o, o, d):
    """The rays (o, d) in the object space of the rows ``w2o`` (lanes, 12):
    o' = ((m0 ox + m1 oy) + m2 oz) + m3 per row, d' without the offset,
    the kernel's order."""
    m = w2o.reshape(-1, 3, 4)
    rows_o = [(m[:, i, 0] * o[:, 0] + m[:, i, 1] * o[:, 1]) + m[:, i, 2] * o[:, 2] + m[:, i, 3] for i in range(3)]
    rows_d = [(m[:, i, 0] * d[:, 0] + m[:, i, 1] * d[:, 1]) + m[:, i, 2] * d[:, 2] for i in range(3)]
    return torch.stack(rows_o, dim=1), torch.stack(rows_d, dim=1)


def _prototype_nearest(g: GroupPack, o, d, t_best, stats=None):
    """Nearest hit of object-space rays over the whole prototype, strictly
    before ``t_best``, the lowest row on ties: (t, j), inf / -1 on a miss.
    Rays go in blocks that bound the (rays, T) temporaries."""
    rows = tuple(c[None] for a in (g.v0, g.e1, g.e2) for c in a.T)
    n, n_tri = o.shape[0], g.v0.shape[0]
    t_out = torch.full((n,), torch.inf, dtype=torch.float32, device=o.device)
    j_out = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    cols = torch.arange(n_tri, dtype=torch.int32, device=o.device)[None]
    block = max(1, (RAY_BLOCK if o.device.type == "cpu" else 16 * RAY_BLOCK) * 256 // max(n_tri, 1))
    for r0 in range(0, n, block):
        ob, db, tb = o[r0 : r0 + block], d[r0 : r0 + block], t_best[r0 : r0 + block, None]
        t, hit = mt_exact(*(ob[:, i : i + 1] for i in range(3)), *(db[:, i : i + 1] for i in range(3)), *rows)
        t = torch.where(hit & (t < tb), t, torch.inf)
        tt = t.amin(dim=1)
        j = torch.where(t == tt[:, None], cols, torch.iinfo(torch.int32).max).amin(dim=1)
        t_out[r0 : r0 + block] = tt
        j_out[r0 : r0 + block] = torch.where(torch.isfinite(tt), j, -1)
    if stats is not None:
        stats["tri_tests"] = stats.get("tri_tests", 0) + n * n_tri
        stats["transforms"] = stats.get("transforms", 0) + n
    return t_out, j_out


def _group_walk(g: GroupPack, origin, direction, t_best, idx_best, any_hit: bool, stats=None, lane_pairs=None) -> None:
    """One group's walk, every lane that has a candidate one candidate a
    step; updates ``t_best`` and ``idx_best`` in place, and counts each
    lane's candidates into ``lane_pairs`` where given. With ``any_hit``
    a lane that has a hit takes no candidate (its bound is -inf)."""
    inv = inv_dir(direction)
    n = origin.shape[0]

    def bound(lanes):
        if any_hit:
            return torch.where(idx_best[lanes] >= 0, -torch.inf, t_best[lanes])
        return t_best[lanes]

    every = torch.arange(n, device=origin.device)
    tn, k = _next_candidate(
        g, origin, direction, inv, torch.full((n,), -torch.inf, device=origin.device),
        torch.full((n,), -1, dtype=torch.int32, device=origin.device), bound(every), stats,
    )
    live = every[k >= 0]
    while live.numel():
        kl = k[live].long()
        if lane_pairs is not None:
            lane_pairs[live] += 1
        o, d = origin[live], direction[live]
        o_obj, d_obj = _transform(g.w2o[kl], o, d)
        t_loc, j_loc = _prototype_nearest(g, o_obj, d_obj, t_best[live], stats)
        better = j_loc >= 0
        idx_best[live] = torch.where(better, g.base[kl] + j_loc, idx_best[live])
        t_best[live] = torch.where(better, t_loc, t_best[live])
        tn_l, k_l = _next_candidate(g, o, d, inv[live], tn[live], k[live], bound(live), stats)
        tn[live], k[live] = tn_l, k_l
        live = live[k_l >= 0]


def _walk(pack: InstancedPack, origin, direction, t_max, any_hit: bool, stats=None):
    n = origin.shape[0]
    t_best = t_max.clone()
    idx_best = torch.full((n,), -1, dtype=torch.int32, device=origin.device)
    lane_pairs = None if stats is None else torch.zeros(n, dtype=torch.int32, device=origin.device)
    for g in pack.groups:
        _group_walk(g, origin, direction, t_best, idx_best, any_hit, stats, lane_pairs)
    if stats is not None:
        stats.setdefault("lane_counts", []).append((lane_pairs,))
    return t_best, idx_best


def nearest_triangle_instanced_plain(pack: InstancedPack, origin, direction, t_max, stats=None):
    """Plain PyTorch version of :func:`nearest_triangle_instanced` (any
    device). ``stats`` (a dict) counts the box tests ("box_tests", a lane
    and an instance each time a lane looks for a candidate), the sphere
    tests of the boxes that let a ray in ("sphere_tests"), the
    candidates' transforms ("transforms") and triangle tests
    ("tri_tests"), and appends each lane's candidates, an int32 (N,)
    tensor, to its "lane_counts" list."""
    t, idx = _walk(pack, origin, direction, t_max, False, stats)
    return torch.where(idx < 0, torch.inf, t), idx


def occluded_instanced_plain(pack: InstancedPack, origin, direction, t_max, stats=None):
    """Plain PyTorch version of :func:`occluded_instanced` (any device)."""
    return _walk(pack, origin, direction, t_max, True, stats)[1] >= 0


def _check(pack: InstancedPack, origin, direction, t_max):
    tables = []
    for i, g in enumerate(pack.groups):
        n_pad = g.box[0].numel()
        tables += [
            (f"groups[{i}].rows", g.rows, (4, g.v0.shape[0], 4)),
            (f"groups[{i}].w2o", g.w2o, (g.base.shape[0], 12)),
            (f"groups[{i}].boxes", g.boxes, (6 if g.sph is None else 10, n_pad)),
        ]
        if g.base.dtype != torch.int32 or g.base.device != origin.device:
            raise ValueError(f"groups[{i}].base must be int32 on {origin.device}")
    return check_rays(origin, direction, t_max, tables)


def placement(g: GroupPack) -> int:
    """Where the walk reads group ``g``'s tables from, a code of
    :data:`PLACES`: the boxes and the prototype's rows in shared memory
    where both fit :data:`SHARED_MAX` bytes, the boxes alone where they
    fit, else neither (the rows read in the same order from global
    memory)."""
    boxes, rows = 4 * g.boxes.numel(), 4 * g.rows.numel()
    if boxes + rows <= SHARED_MAX:
        return 2
    return 1 if boxes <= SHARED_MAX else 0


def _launch(entry: str, pack: InstancedPack, origin, direction, t_best, idx_best) -> int:
    """One launch a group, each reading and updating (t_best, idx_best);
    returns the number of launches."""
    lib = _build.library()
    n = origin.shape[0]
    for g in pack.groups:
        err = getattr(lib, entry)(
            origin.data_ptr(), direction.data_ptr(), g.rows.data_ptr(), g.v0.shape[0], g.w2o.data_ptr(),
            g.boxes.data_ptr(), int(g.sph is not None), g.base.data_ptr(), g.base.shape[0], g.box[0].numel(),
            placement(g), n, t_best.data_ptr(), idx_best.data_ptr(), _build.raw_stream(origin),
        )
        _build.check(err, entry)
    return len(pack.groups)


def nearest_triangle_instanced(pack: InstancedPack, origin, direction, t_max, chunk=None):
    """Nearest hit with the accel backends' contract: (t, idx), t = inf /
    idx = -1 on a miss, idx the global ``tri_data`` row (instances
    contiguous in build order). ``origin``/``direction`` f32 (N, 3);
    ``t_max`` a scalar or f32 (N,), a hit counts only strictly before it.
    ``chunk``, ``theia_tpu``'s prototype scan tile, is accepted and
    ignored. CUDA tensors launch ``theia_instanced_nearest`` once a group
    (in pack order), CPU tensors run the plain version."""
    t_max = _check(pack, origin, direction, t_max)
    if origin.device.type == "cpu":
        return nearest_triangle_instanced_plain(pack, origin, direction, t_max)
    t_best = t_max.clone()
    idx_best = torch.full((origin.shape[0],), -1, dtype=torch.int32, device=origin.device)
    if origin.shape[0]:
        nearest_triangle_instanced.launches += _launch(
            "theia_instanced_nearest", pack, origin, direction, t_best, idx_best)
    return torch.where(idx_best < 0, torch.inf, t_best), idx_best


nearest_triangle_instanced.launches = 0


def occluded_instanced(pack: InstancedPack, origin, direction, t_max, chunk=None):
    """Any hit: bool (N,), True where something blocks the ray strictly
    before ``t_max``; a lane takes no candidate after its first hit.
    ``chunk`` is accepted and ignored. CUDA tensors launch
    ``theia_instanced_occluded`` once a group, CPU tensors run the plain
    version."""
    t_max = _check(pack, origin, direction, t_max)
    if origin.device.type == "cpu":
        return occluded_instanced_plain(pack, origin, direction, t_max)
    t_best = t_max.clone()
    idx_best = torch.full((origin.shape[0],), -1, dtype=torch.int32, device=origin.device)
    if origin.shape[0]:
        occluded_instanced.launches += _launch(
            "theia_instanced_occluded", pack, origin, direction, t_best, idx_best)
    return idx_best >= 0


occluded_instanced.launches = 0
