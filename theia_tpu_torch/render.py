"""Scene templates (``theia_tpu.render.SceneTemplate``).

:class:`SceneTemplate` stamps a template scene (instances with named
materials and detector ids) across a list of transforms, for detector
arrays (reference: src/theia/scene.py:713-935). Templates are built from
:class:`~theia_tpu_torch.scene.MeshInstance` lists; loading one from an
OBJ file (:meth:`SceneTemplate.fromFile`) waits for the mesh loaders and
raises until then. ``theia_tpu``'s debug renderer (``SceneRender``) is not
ported yet.
"""

from __future__ import annotations

from .scene import MeshInstance, RectBBox, Scene, Transform

__all__ = ["SceneTemplate"]


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
    def fromFile(cls, file, **kwargs) -> "SceneTemplate":
        """Load a template from an OBJ file: not ported yet (it needs the
        mesh loaders, ROADMAP.md queue 1 item 7)."""
        raise NotImplementedError(
            "SceneTemplate.fromFile needs the OBJ loader, which is not ported yet; "
            "build the template from MeshInstance objects"
        )

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
            out, materials, medium=medium, bbox=bbox, accel=accel, leaf_size=leaf_size, device=device,
        )
