"""Scenes: transforms, mesh instances and the packed device representation.

Semantics follow ``theia_tpu.scene`` (reference: src/theia/scene.py,
docs/scene.md): meshes are interfaces between media, normals point
outward, materials assign media and flags to both sides, detectors are
selected by a ``detectorId`` per instance, and hits are reported in
object space. A :class:`Scene` packs into a :class:`ScenePack` of tensors
on one device: per-triangle reconstruction rows (``tri_data``), per-
instance rows (``inst_data``), the media tables and the tables of the
scene's intersection backend: ``accel="brute"`` (what ``"auto"`` picks
for all but large instanced scenes) keeps the world triangle soup in
instance order with the detector split of the MIS shadow rays
(:class:`ShadowSplit`), the per-instance bounding spheres and spans
(:class:`CullTables`) and the soup kernels' table (``soup``);
``accel="mt"`` and ``accel="woop"`` Morton-order the triangles for their
nearest-hit kernels.

``accel="bvh"`` and ``accel="instanced"`` are not ported yet (ROADMAP.md,
"Instanced and BVH traversal").
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from . import units as u
from .component import resolve_device
from .material import MaterialFlags, MaterialStore, MediumStore
from .mesh import Mesh
from .ops.intersect_mt import MTPack, morton_order, pack_mt
from .ops.intersect_soup import SoupTable
from .ops.intersect_woop import WoopPack, pack_woop

__all__ = [
    "Transform",
    "RectBBox",
    "MeshInstance",
    "MeshStore",
    "Scene",
    "ScenePack",
    "ShadowSplit",
    "CullTables",
    "AUTO_BVH_THRESHOLD",
    "AUTO_INSTANCED_THRESHOLD",
]

#: triangle counts at which ``accel="auto"`` leaves the brute-force scan:
#: for the BVH (never, at this value), and for the two-level instanced
#: traversal where the scene really instances its meshes (flattened >= 2x
#: the unique prototype triangles). Both are ``theia_tpu``'s values, set
#: from measurements on a TPU; where the crossovers lie on the card has
#: not been measured.
AUTO_BVH_THRESHOLD = 1 << 62
AUTO_INSTANCED_THRESHOLD = 8 * 1024


class Transform:
    """3x4 affine transformation (reference: src/theia/scene.py:42-296)."""

    def __init__(self, matrix=None) -> None:
        self._arr = np.identity(4)
        if matrix is not None:
            matrix = np.asarray_chkfinite(matrix)
            if matrix.shape != (3, 4):
                raise ValueError("matrix must be of shape (3,4)!")
            self._arr[:3, :] = matrix

    def apply(self, points):
        return np.asarray(points) @ self._arr[:3, :3].T + self._arr[:3, 3]

    def inverse(self) -> "Transform":
        inv = Transform()
        inv._arr = np.linalg.inv(self._arr)
        return inv

    def numpy(self) -> np.ndarray:
        return np.ascontiguousarray(self._arr[:3, :], dtype=np.float32)

    def __matmul__(self, other: "Transform") -> "Transform":
        res = Transform()
        res._arr = self._arr @ other._arr
        return res

    @staticmethod
    def Rotation(dx, dy, dz, angle) -> "Transform":
        """Rotation around axis (dx,dy,dz) by ``angle`` degrees."""
        length = np.sqrt(dx * dx + dy * dy + dz * dz)
        dx, dy, dz = dx / length, dy / length, dz / length
        K = np.array([[0.0, -dz, dy], [dz, 0.0, -dx], [-dy, dx, 0.0]])
        res = Transform()
        a = np.deg2rad(angle)
        res._arr[:3, :3] += np.sin(a) * K + (1.0 - np.cos(a)) * (K @ K)
        return res

    @staticmethod
    def Scale(x, y=None, z=None) -> "Transform":
        if y is None:
            y = z = x
        res = Transform()
        res._arr[0, 0], res._arr[1, 1], res._arr[2, 2] = x, y, z
        return res

    @staticmethod
    def Translation(x, y, z) -> "Transform":
        res = Transform()
        res._arr[:3, 3] = (x, y, z)
        return res

    @staticmethod
    def TRS(*, scale=1.0, rotate=None, translate=(0.0, 0.0, 0.0)) -> "Transform":
        """translate @ rotate @ scale (scale first)."""
        t = (
            Transform.Scale(scale, scale, scale)
            if np.isscalar(scale)
            else Transform.Scale(*scale)
        )
        if rotate is not None:
            t = rotate @ t
        return Transform.Translation(*translate) @ t


class RectBBox:
    """Axis-aligned bounding box (reference: src/theia/scene.py:299-380)."""

    def __init__(self, lowerCorner, upperCorner) -> None:
        self.lowerCorner = tuple(float(c) for c in lowerCorner)
        self.upperCorner = tuple(float(c) for c in upperCorner)


class MeshInstance:
    """A placed mesh with material name, transform and detector id
    (reference: src/theia/scene.py:454-528)."""

    def __init__(
        self,
        key: str,
        mesh: Mesh,
        material: str,
        transform: Transform,
        detectorId: int = 0,
    ) -> None:
        self.key = key
        self.mesh = mesh
        self.material = material
        self.transform = transform
        self.detectorId = detectorId


class MeshStore:
    """Named mesh registry (reference: src/theia/scene.py:529-605). Takes
    :class:`~theia_tpu_torch.mesh.Mesh` objects; file paths need the mesh
    loaders, which are not ported yet."""

    def __init__(self, meshes: dict) -> None:
        for k, v in meshes.items():
            if isinstance(v, str) or hasattr(v, "__fspath__"):
                raise NotImplementedError(
                    f"mesh {k!r}: loading mesh files is not ported yet; "
                    "pass a Mesh built with Mesh.from_geometry"
                )
        self._meshes = dict(meshes)

    def createInstance(
        self,
        key: str,
        material: str,
        transform: Transform | None = None,
        *,
        detectorId: int = 0,
        scale: float | None = None,
    ) -> MeshInstance:
        mesh = self._meshes[key]
        if scale is None:
            scale = 1.0 * u.m
        trafo = Transform.Scale(scale, scale, scale)
        if transform is not None:
            trafo = transform @ trafo
        return MeshInstance(key, mesh, material, trafo, detectorId)


@dataclass(frozen=True)
class ShadowSplit:
    """Detector-triangle subsoup for MIS shadow rays: they respond on
    detector-flagged instances only, so ``accel.intersect_target`` orders
    the hits on the detectors alone and asks of everything else only
    whether it blocks the ray. ``det_idx`` maps subsoup rows back to
    ``tri_data`` rows; the instance-id columns keep
    ``translate_instance`` working. The arrays equal ``theia_tpu``'s and
    are kept for callers that read them as they read ``theia_tpu``'s: no
    query of the port does. Its queries reach the same triangles as
    groups of ``soup``, told apart by ``soup_is_det``."""

    det_v0: torch.Tensor  # (Td, 3) world-space detector triangles
    det_e1: torch.Tensor
    det_e2: torch.Tensor
    det_idx: torch.Tensor  # (Td,) i32 tri_data rows
    det_inst: torch.Tensor  # (Td,) f32 instance ids
    nd_v0: torch.Tensor  # (Tn, 3) every other triangle (occluders)
    nd_e1: torch.Tensor
    nd_e2: torch.Tensor
    nd_inst: torch.Tensor  # (Tn,) f32


@dataclass(frozen=True)
class CullTables:
    """Per-instance conservative world bounding spheres and the instances'
    spans of the brute soup, which name the groups of
    ``accel.nearest_culled`` / ``anyhit_culled``. ``radii`` are the
    largest vertex distance from the instance's AABB centre, inflated
    (``r * 1.001 + 1e-5``) for float32 slack; ``accel._seg_hits_sphere``
    adds its own margin. The tables equal ``theia_tpu``'s and are kept for
    callers that read them: no query of the port does (its kernels cull by
    the boxes of ``soup``'s chunks), so building them or not changes
    neither a result nor the work of a query."""

    centers: torch.Tensor  # (I, 3) f32
    radii: torch.Tensor  # (I,) f32, conservative
    spans: tuple = ()  # (start, end) soup rows of each instance
    is_det: tuple = ()  # whether each instance is a detector


@dataclass(frozen=True)
class ScenePack:
    """Scene tables on one device (the BLAS/TLAS analogue).

    ``tri_data`` (T, 32) f32 rows: object-space v0/e1/e2 (0:9), vertex
    normals n0/n1/n2 (9:18), world v0/e1/e2 (18:27), instance id (27).
    ``inst_data`` (K, 32) f32 rows: world_to_obj 3x4 (0:12), obj_to_world
    3x4 (12:24), inside/outside medium handle (24, 25), inward/outward
    flags (26, 27), detector id (28).

    At most one of ``mt`` and ``woop`` is set, by the scene's ``accel``;
    the triangles are then in the Morton order that the kernel's tables
    index. A brute-force pack sets neither: its triangles are in instance
    order, ``soup`` holds the soup kernels' table with one group an
    instance, ``soup_is_det`` which of them are detectors. The queries
    read these. Every pack carries the world soup ``w_v0``/``w_e1``/
    ``w_e2`` and ``shadow_split`` (the detector subsoup, None without a
    detector) in its own triangle order, as ``theia_tpu``'s do;
    ``cull`` (the instances' bounding spheres, brute-force packs only,
    None when the scene was built with ``cull=False`` or has one
    instance) mirrors ``theia_tpu``'s field. No query of the port reads
    ``w_v0``, ``shadow_split`` or ``cull`` (the brute-force queries read
    ``soup``)."""

    tri_data: torch.Tensor
    inst_data: torch.Tensor
    media: MediumStore
    medium: torch.Tensor  # i32 handle of the surrounding medium
    lower_bbox: torch.Tensor  # f32 (3,)
    upper_bbox: torch.Tensor
    mt: MTPack | None = None
    woop: WoopPack | None = None
    w_v0: torch.Tensor | None = None  # (T, 3) world-space soup
    w_e1: torch.Tensor | None = None  # v1 - v0
    w_e2: torch.Tensor | None = None  # v2 - v0
    soup: SoupTable | None = None
    soup_is_det: tuple = ()
    shadow_split: ShadowSplit | None = None
    cull: CullTables | None = None

    def translate_instance(self, instance_id: int, delta) -> "ScenePack":
        """A pack with instance ``instance_id`` rigidly shifted by
        ``delta`` (world space). Only the brute-force tables are rewritten
        (the soup, ``tri_data``'s world v0, the instance's transforms, the
        shadow split, the bounding sphere's centre and the kernels'
        table); accelerated packs bake world geometry into their own
        tables and raise. Differentiable in ``delta``, as in ``theia_tpu``:
        ``tri_data`` and ``inst_data`` carry its graph, and where
        ``tri_data`` requires a gradient the queries gather the winners'
        rows from it in torch (``accel.intersect_scene``), while the
        kernels' table, which only selects the winners, is rebuilt
        detached (``stop_gradient`` in ``theia_tpu``), in the order of the
        table it came from."""
        if self.mt is not None or self.woop is not None:
            raise ValueError(
                "translate_instance requires accel='brute' (accelerated "
                "packs bake world-space geometry)"
            )
        delta = torch.as_tensor(delta, dtype=torch.float32, device=self.tri_data.device)
        tri_mask = (self.tri_data[:, 27] == float(instance_id))[:, None]
        w_v0 = self.w_v0 + tri_mask * delta
        tri_data = self.tri_data.clone()
        tri_data[:, 18:21] += tri_mask * delta
        # out of place, so that autograd keeps the R' it multiplies delta by
        at = lambda cols: (torch.full((3,), instance_id, device=delta.device), torch.as_tensor(cols, device=delta.device))
        # world_to_obj [R'|t'] rows flat at 0:12: new t' = t' - R' @ delta
        shift = self.inst_data[instance_id, 0:12].reshape(3, 4)[:, :3] @ delta
        inst_data = self.inst_data.index_put(at([3, 7, 11]), -shift, accumulate=True)
        # obj_to_world [R|t] rows flat at 12:24 -> t entries 15, 19, 23
        inst_data = inst_data.index_put(at([15, 19, 23]), delta, accumulate=True)
        split = self.shadow_split
        if split is not None:
            dmask = (split.det_inst == float(instance_id))[:, None]
            nmask = (split.nd_inst == float(instance_id))[:, None]
            split = replace(split, det_v0=split.det_v0 + dmask * delta, nd_v0=split.nd_v0 + nmask * delta)
        cull = self.cull
        if cull is not None:
            # rigid translation: the bounding sphere moves, radius unchanged
            centers = cull.centers.clone()
            centers[instance_id] += delta
            cull = replace(cull, centers=centers)
        return replace(
            self, w_v0=w_v0, tri_data=tri_data, inst_data=inst_data, shadow_split=split, cull=cull,
            soup=SoupTable(w_v0.detach(), self.w_e1.detach(), self.w_e2.detach(), self.soup.spans, self.soup.order),
        )


def instance_spans(tri_inst: np.ndarray, n_inst: int) -> tuple:
    """``(start, end)`` rows of each instance in a soup whose triangles
    are in instance order (``tri_inst``: the instance id of each row)."""
    counts = np.bincount(np.asarray(tri_inst, np.int64), minlength=n_inst)
    starts = np.concatenate([[0], np.cumsum(counts)])
    return tuple((int(starts[k]), int(starts[k + 1])) for k in range(n_inst))


def detector_instances(inst_data: np.ndarray) -> tuple:
    """Whether each row of ``inst_data`` carries the detector flag on
    either side."""
    flags = np.asarray(inst_data)[:, 26:28].astype(np.int64)
    return tuple(bool(f) for f in ((flags[:, 0] | flags[:, 1]) & int(MaterialFlags.DETECTOR)) != 0)


class Scene:
    """Scene = instances + material store + surrounding medium
    (reference: src/theia/scene.py:608-710). Tables are built on
    ``device``: the card unless the caller names another; without a card
    the default raises, and ``device="cpu"`` runs on the CPU. ``cull`` is
    ``theia_tpu``'s keyword: it decides only whether the pack carries
    :class:`CullTables`, which no query of the port reads.

    ``materials``: a :class:`MaterialStore`, or a dict of materials by
    name, which is packed on ``device`` (as ``theia_tpu`` packs one)."""

    def __init__(
        self,
        instances: list[MeshInstance],
        materials: "MaterialStore | dict",
        *,
        medium: str | None = None,
        bbox: RectBBox | None = None,
        accel: str = "auto",
        cull: bool = True,
        device="cuda",
    ) -> None:
        if not isinstance(materials, MaterialStore):
            materials = MaterialStore.pack(list(materials.values()), device=device)
        if accel not in ("auto", "brute", "bvh", "woop", "mt", "instanced"):
            raise ValueError(
                "accel must be 'auto', 'brute', 'bvh', 'woop', 'mt' or 'instanced'"
            )
        if accel == "auto":
            # theia_tpu's rule: brute force, unless the scene is large and
            # instances its meshes (then the two-level traversal, which
            # scans one prototype per candidate instance), or huge (BVH)
            n_tri = sum(len(i.mesh.indices) for i in instances)
            protos = {id(i.mesh): i.mesh for i in instances}.values()
            unique = sum(len(m.indices) for m in protos)
            max_proto = max((len(m.indices) for m in protos), default=0)
            if (
                n_tri >= AUTO_INSTANCED_THRESHOLD
                and n_tri >= 2 * unique
                and max_proto < AUTO_BVH_THRESHOLD
            ):
                accel = "instanced"
            else:
                accel = "brute" if n_tri < AUTO_BVH_THRESHOLD else "bvh"
        if accel in ("bvh", "instanced"):
            raise NotImplementedError(
                f"accel={accel!r} is not ported yet (ROADMAP.md: 'Instanced "
                "and BVH traversal'); accel='brute', 'mt' and 'woop' are"
            )
        self.instances = instances
        self.materials = materials
        self.medium = medium
        self.accel = accel
        self.cullEnabled = cull
        self.device = resolve_device(device)
        self.bbox = bbox if bbox is not None else RectBBox(
            (-1.0 * u.km,) * 3, (1.0 * u.km,) * 3
        )
        self._pack = self._build()

    @property
    def pack(self) -> ScenePack:
        return self._pack

    def _build(self) -> ScenePack:
        store = self.materials
        cols = {k: [] for k in ("w_v0", "w_e1", "w_e2", "o_v0", "o_e1", "o_e2",
                                "o_n0", "o_n1", "o_n2", "inst")}
        inst_rows = []
        for k, inst in enumerate(self.instances):
            pos = inst.mesh.vertices[:, :3]
            nrm = inst.mesh.vertices[:, 3:]
            idx = inst.mesh.indices
            wpos = inst.transform.apply(pos).astype(np.float32)
            for key, src in (
                ("w_v0", wpos[idx[:, 0]]),
                ("w_e1", wpos[idx[:, 1]] - wpos[idx[:, 0]]),
                ("w_e2", wpos[idx[:, 2]] - wpos[idx[:, 0]]),
                ("o_v0", pos[idx[:, 0]]),
                ("o_e1", pos[idx[:, 1]] - pos[idx[:, 0]]),
                ("o_e2", pos[idx[:, 2]] - pos[idx[:, 0]]),
                ("o_n0", nrm[idx[:, 0]]),
                ("o_n1", nrm[idx[:, 1]]),
                ("o_n2", nrm[idx[:, 2]]),
            ):
                cols[key].append(np.asarray(src, np.float32))
            cols["inst"].append(np.full(len(idx), k, np.int32))
            mat = store.material_handle(inst.material)
            row = np.zeros(32, np.float32)
            row[0:12] = inst.transform.inverse().numpy().reshape(12)
            row[12:24] = inst.transform.numpy().reshape(12)
            row[24] = int(store.inside[mat])
            row[25] = int(store.outside[mat])
            row[26] = int(store.flags_inward[mat])
            row[27] = int(store.flags_outward[mat])
            row[28] = inst.detectorId
            inst_rows.append(row)

        cat = {k: np.concatenate(v, axis=0) for k, v in cols.items()}
        dev = lambda a, dt=torch.float32: torch.as_tensor(
            np.asarray(a), dtype=dt, device=self.device
        )
        inst_data = np.stack(inst_rows)
        if self.accel == "brute":
            tables = self._brute_tables(cat, inst_data, dev)
        else:
            # Morton-order triangles so each kernel tile is spatially tight
            perm = morton_order(cat["w_v0"], cat["w_e1"], cat["w_e2"])
            cat = {k: v[perm] for k, v in cat.items()}
            pack = pack_mt if self.accel == "mt" else pack_woop
            tables = {self.accel: pack(cat["w_v0"], cat["w_e1"], cat["w_e2"], device=self.device)}
            tables.update(self._soup_tables(cat, inst_data, dev))

        tri_data = np.zeros((len(cat["inst"]), 32), np.float32)
        for c0, key in enumerate(
            ("o_v0", "o_e1", "o_e2", "o_n0", "o_n1", "o_n2", "w_v0", "w_e1", "w_e2")
        ):
            tri_data[:, 3 * c0 : 3 * c0 + 3] = cat[key]
        tri_data[:, 27] = cat["inst"].astype(np.float32)

        return ScenePack(
            tri_data=dev(tri_data),
            inst_data=dev(inst_data),
            media=store.media,
            medium=dev(store.media.handle(self.medium), torch.int32),
            lower_bbox=dev(self.bbox.lowerCorner),
            upper_bbox=dev(self.bbox.upperCorner),
            **tables,
        )

    def _soup_tables(self, cat: dict, inst_data: np.ndarray, dev) -> dict:
        """The world soup (``w_v0``/``w_e1``/``w_e2``) and the detector
        split of every pack, in the pack's triangle order, as
        ``theia_tpu`` sets them on every pack (no query of an ``mt`` or
        ``woop`` pack reads them)."""
        soup = [cat[k] for k in ("w_v0", "w_e1", "w_e2")]
        tri_is_det = np.asarray(detector_instances(inst_data), bool)[cat["inst"]]
        shadow_split = None
        if tri_is_det.any():
            didx = np.nonzero(tri_is_det)[0].astype(np.int32)
            nidx = np.nonzero(~tri_is_det)[0].astype(np.int32)
            shadow_split = ShadowSplit(
                *(dev(a[didx]) for a in soup),
                det_idx=dev(didx, torch.int32),
                det_inst=dev(cat["inst"][didx].astype(np.float32)),
                nd_v0=dev(soup[0][nidx]), nd_e1=dev(soup[1][nidx]), nd_e2=dev(soup[2][nidx]),
                nd_inst=dev(cat["inst"][nidx].astype(np.float32)),
            )
        w_v0, w_e1, w_e2 = (dev(a) for a in soup)
        return dict(w_v0=w_v0, w_e1=w_e1, w_e2=w_e2, shadow_split=shadow_split)

    def _brute_tables(self, cat: dict, inst_data: np.ndarray, dev) -> dict:
        """The brute-force pack's own fields from the soup in instance
        order, built on the host as ``theia_tpu`` builds them."""
        n_inst = len(self.instances)
        soup = [cat[k] for k in ("w_v0", "w_e1", "w_e2")]
        tables = self._soup_tables(cat, inst_data, dev)
        spans = instance_spans(cat["inst"], n_inst)
        is_det = detector_instances(inst_data)
        cull = None
        if self.cullEnabled and n_inst >= 2:
            centers, radii = [], []
            for start, end in spans:
                v0, e1, e2 = (a[start:end] for a in soup)
                verts = np.concatenate([v0, v0 + e1, v0 + e2], axis=0)
                c = 0.5 * (verts.min(axis=0) + verts.max(axis=0))
                r = float(np.linalg.norm(verts - c, axis=1).max())
                centers.append(c)
                radii.append(r * 1.001 + 1e-5)
            cull = CullTables(
                centers=dev(np.stack(centers)), radii=dev(np.asarray(radii)), spans=spans, is_det=is_det,
            )
        return dict(
            tables, soup=SoupTable(tables["w_v0"], tables["w_e1"], tables["w_e2"], spans),
            soup_is_det=is_det, cull=cull,
        )
