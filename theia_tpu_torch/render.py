"""Debug renderer and scene templates (``theia_tpu.render``).

:class:`SceneRender` is a simple orthographic ray caster for inspecting
scenes; colours encode surface normals (reference:
src/theia/scene.py:938-1133, shader/scene.render.glsl). Its rays go
through :func:`~theia_tpu_torch.accel.intersect_scene` on the scene's own
backend (the soup scan on a brute-force scene), and the shading is a few
eager ops.

:class:`SceneTemplate` stamps a template scene (instances with named
materials and detector ids) across a list of transforms, for detector
arrays (reference: src/theia/scene.py:713-935). Templates are built from
:class:`~theia_tpu_torch.scene.MeshInstance` lists or loaded from OBJ
files with named objects and material tags (:meth:`SceneTemplate.fromFile`,
the reference's trimesh-scene-graph loading).
"""

from __future__ import annotations

import numpy as np
import torch

from .accel import intersect_scene
from .mesh import loadObjScene
from .scene import MeshInstance, RectBBox, Scene, Transform

__all__ = ["SceneRender", "SceneTemplate"]


class SceneRender:
    """Orthographic normal-shaded debug renderer: one ray a pixel along
    ``direction`` from a ``dimension``-sized screen centred on
    ``position``, its colour ``0.5 * (normal + 1)`` where it hits within
    ``maxDistance``, white where it misses."""

    def __init__(
        self,
        *,
        width: int = 1024,
        height: int = 1024,
        dimension=(1.0, 1.0),
        position=(0.0, 0.0, 0.0),
        direction=(0.0, 1.0, 0.0),
        up=(0.0, 0.0, 1.0),
        maxDistance: float = 100.0,
    ) -> None:
        self.width = width
        self.height = height
        self.dimension = dimension
        self.position = position
        self.direction = direction
        self.up = up
        self.maxDistance = maxDistance

    def rays(self) -> tuple[np.ndarray, np.ndarray]:
        """The pixels' rays as float32 (H * W, 3) origins and directions,
        row by row, made on the host in float64 as ``theia_tpu`` makes them."""
        w, h = self.width, self.height
        d = np.asarray(self.direction, np.float64)
        d /= np.linalg.norm(d)
        upv = np.asarray(self.up, np.float64)
        right = np.cross(d, upv)
        right /= np.linalg.norm(right)
        upv = np.cross(right, d)
        xs = (np.arange(w) / (w - 1) - 0.5) * self.dimension[0]
        ys = (np.arange(h) / (h - 1) - 0.5) * self.dimension[1]
        gx, gy = np.meshgrid(xs, ys)
        origins = (
            np.asarray(self.position)[None, None] + gx[..., None] * right[None, None] + gy[..., None] * upv[None, None]
        ).reshape(-1, 3)
        dirs = np.broadcast_to(d, origins.shape)
        return origins.astype(np.float32), dirs.astype(np.float32)

    def render(self, scene: Scene) -> np.ndarray:
        """Render the scene on its device to an (H, W, 4) uint8 RGBA image."""
        pack = scene.pack
        origins, dirs = self.rays()
        device = pack.tri_data.device
        origin = torch.as_tensor(origins, device=device)
        n = origin.shape[0]
        with torch.no_grad():
            hit = intersect_scene(
                pack,
                pack.medium.to(torch.int32).expand(n),
                origin,
                torch.as_tensor(dirs, device=device),
                torch.full((n,), self.maxDistance, dtype=torch.float32, device=device),
            )
            color = torch.where(hit.valid[:, None], 0.5 * (hit.ray_nrm + 1.0), 1.0)
        img = np.ones((n, 4), np.float32)
        img[:, :3] = color.cpu().numpy()
        return (img.reshape(self.height, self.width, 4) * 255).astype(np.uint8)


class SceneTemplate:
    """A reusable set of instance blueprints to stamp across transforms.

    Templates built from files use the reference's detector-id *stride*
    semantics: each stamped copy offsets all nonzero detector ids by
    ``idStride`` so every detector in the array stays uniquely addressable
    (ref src/theia/scene.py:905-931); in-memory templates give every
    instance of copy ``i`` the id ``i``."""

    def __init__(self, instances: list[MeshInstance], *, idStride: int | None = None) -> None:
        self._instances = instances
        self._id_stride = idStride

    @classmethod
    def fromFile(
        cls,
        file,
        *,
        templateTransform: Transform | None = None,
        detectorIdMap: dict[str, int] | None = None,
        detectorMaterial: set[str] | None = None,
    ) -> "SceneTemplate":
        """Load a template from an OBJ file with named objects and
        ``usemtl`` material tags (reference: src/theia/scene.py:750-817).
        Detector ids as the reference assigns them: from ``detectorIdMap``
        (unmapped instances get 0), or a fresh id for each instance whose
        material is in ``detectorMaterial``, or by default a fresh id for
        each instance, from 1; the template's ``idStride`` is the last id."""
        next_id = 1
        instances = []
        for o in loadObjScene(file):
            if not o.material:
                raise ValueError(f'Mesh "{o.name}" has no material assigned!')
            if detectorIdMap is not None:
                det = detectorIdMap.get(o.name, 0)
            elif detectorMaterial is not None:
                det = 0
                if o.material in detectorMaterial:
                    det = next_id
                    next_id += 1
            else:
                det = next_id
                next_id += 1
            trafo = templateTransform if templateTransform is not None else Transform()
            instances.append(MeshInstance(o.name, o.mesh, o.material, trafo, det))
        return cls(instances, idStride=next_id - 1)

    @property
    def instances(self) -> list[MeshInstance]:
        return self._instances

    @property
    def idStride(self) -> int | None:
        """Detector-id offset between stamped copies (file templates)."""
        return self._id_stride

    def detectorIds(self, nCopies: int, *, detectorIdStride: int | None = None) -> dict[tuple[str, int], int]:
        """Map (instance name, copy index) -> detectorId for a stamped
        scene, as :meth:`createScene` assigns them: stride-based offsets of
        the nonzero prototype ids with a stride, else every instance of
        copy ``i`` gets id ``i``."""
        stride = detectorIdStride if detectorIdStride is not None else self._id_stride
        out = {}
        for i in range(nCopies):
            for proto in self._instances:
                if stride is not None:
                    if proto.detectorId != 0:
                        out[(proto.key, i)] = proto.detectorId + i * stride
                else:
                    out[(proto.key, i)] = i
        return out

    def createScene(
        self,
        transforms: list[Transform],
        materials,
        *,
        medium: str | None = None,
        bbox: RectBBox | None = None,
        assignDetectorIds: bool = True,
        accel: str = "auto",
        leaf_size: int = 8,
        detectorIdStride: int | None = None,
        sceneTransform: Transform | None = None,
        binned: bool = False,
        device="cuda",
    ) -> Scene:
        """Stamp the template once per transform (reference:
        src/theia/scene.py:713-935 SceneTemplate) into a
        :class:`~theia_tpu_torch.scene.Scene` on ``device``; the other
        keywords are ``Scene``'s."""
        stride = detectorIdStride if detectorIdStride is not None else self._id_stride
        out = []
        for i, trafo in enumerate(transforms):
            for proto in self._instances:
                if not assignDetectorIds:
                    det_id = proto.detectorId
                elif stride is not None:
                    det_id = proto.detectorId + i * stride if proto.detectorId != 0 else 0
                else:
                    det_id = i
                t = trafo @ proto.transform
                if sceneTransform is not None:
                    t = sceneTransform @ t
                out.append(MeshInstance(proto.key, proto.mesh, proto.material, t, det_id))
        return Scene(
            out, materials, medium=medium, bbox=bbox, accel=accel, leaf_size=leaf_size, binned=binned,
            device=device,
        )
