"""Scenes: transforms, mesh instances and the packed device representation.

Semantics follow ``theia_tpu.scene`` (reference: src/theia/scene.py,
docs/scene.md): meshes are interfaces between media, normals point
outward, materials assign media and flags to both sides, detectors are
selected by a ``detectorId`` per instance, and hits are reported in
object space. A :class:`Scene` packs into a :class:`ScenePack` of tensors
on one device: per-triangle reconstruction rows (``tri_data``), per-
instance rows (``inst_data``), the media tables and the tables of the
nearest-hit kernel (``mt`` or ``woop``).

Only ``accel="mt"`` and ``accel="woop"`` are ported so far; the
brute-force scan with its shadow split and culling tables is the next
item of ROADMAP.md.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import units as u
from .material import MaterialStore, MediumStore
from .mesh import Mesh
from .ops.intersect_mt import MTPack, morton_order, pack_mt
from .ops.intersect_woop import WoopPack, pack_woop

__all__ = [
    "Transform",
    "RectBBox",
    "MeshInstance",
    "MeshStore",
    "Scene",
    "ScenePack",
]


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
class ScenePack:
    """Scene tables on one device (the BLAS/TLAS analogue).

    ``tri_data`` (T, 32) f32 rows: object-space v0/e1/e2 (0:9), vertex
    normals n0/n1/n2 (9:18), world v0/e1/e2 (18:27), instance id (27).
    ``inst_data`` (K, 32) f32 rows: world_to_obj 3x4 (0:12), obj_to_world
    3x4 (12:24), inside/outside medium handle (24, 25), inward/outward
    flags (26, 27), detector id (28). Triangles are in the Morton order
    that the kernel tables index; exactly one of ``mt`` and ``woop`` is
    set, by the scene's ``accel``."""

    tri_data: torch.Tensor
    inst_data: torch.Tensor
    media: MediumStore
    medium: torch.Tensor  # i32 handle of the surrounding medium
    lower_bbox: torch.Tensor  # f32 (3,)
    upper_bbox: torch.Tensor
    mt: MTPack | None = None
    woop: WoopPack | None = None


class Scene:
    """Scene = instances + material store + surrounding medium
    (reference: src/theia/scene.py:608-710). Tables are built on
    ``device``."""

    def __init__(
        self,
        instances: list[MeshInstance],
        materials: MaterialStore,
        *,
        medium: str | None = None,
        bbox: RectBBox | None = None,
        accel: str = "auto",
        device,
    ) -> None:
        if accel not in ("mt", "woop"):
            raise NotImplementedError(
                f"accel={accel!r} is not ported yet; only accel='mt' and "
                "accel='woop' are (ROADMAP.md: 'The brute-force flagship')"
            )
        self.instances = instances
        self.materials = materials
        self.medium = medium
        self.accel = accel
        self.device = torch.device(device)
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
        # Morton-order triangles so each kernel tile is spatially tight
        perm = morton_order(cat["w_v0"], cat["w_e1"], cat["w_e2"])
        cat = {k: v[perm] for k, v in cat.items()}
        pack = pack_mt if self.accel == "mt" else pack_woop
        tables = pack(cat["w_v0"], cat["w_e1"], cat["w_e2"], device=self.device)

        tri_data = np.zeros((len(cat["inst"]), 32), np.float32)
        for c0, key in enumerate(
            ("o_v0", "o_e1", "o_e2", "o_n0", "o_n1", "o_n2", "w_v0", "w_e1", "w_e2")
        ):
            tri_data[:, 3 * c0 : 3 * c0 + 3] = cat[key]
        tri_data[:, 27] = cat["inst"].astype(np.float32)

        dev = lambda a, dt=torch.float32: torch.as_tensor(
            np.asarray(a), dtype=dt, device=self.device
        )
        return ScenePack(
            tri_data=dev(tri_data),
            inst_data=dev(np.stack(inst_rows)),
            media=store.media,
            medium=dev(store.media.handle(self.medium), torch.int32),
            lower_bbox=dev(self.bbox.lowerCorner),
            upper_bbox=dev(self.bbox.upperCorner),
            **{self.accel: tables},
        )
