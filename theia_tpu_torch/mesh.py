"""Triangle meshes built from geometry arrays.

Same layout and processing as ``theia_tpu.mesh.Mesh.from_geometry``:
duplicate vertices are welded and vertex normals are the area-weighted
averages of the incident face normals (trimesh's default processing,
reference: src/theia/scene.py:434-449). The file loaders (STL/PLY/OBJ)
are not ported yet; build meshes in code and pass them to
:class:`~theia_tpu_torch.scene.MeshStore`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Mesh"]


@dataclass
class Mesh:
    """Triangle mesh: vertices (V, 6) float32 [position, normal] and
    indices (T, 3) int32 — the reference's hp.Mesh layout
    (reference: src/theia/scene.py:434-441)."""

    vertices: np.ndarray
    indices: np.ndarray

    @staticmethod
    def from_geometry(positions, faces) -> "Mesh":
        positions = np.asarray(positions, np.float64)
        faces = np.asarray(faces, np.int64)
        positions, faces = _weld(positions, faces)
        normals = _vertex_normals(positions, faces)
        vertices = np.concatenate([positions, normals], axis=-1)
        return Mesh(
            vertices=np.ascontiguousarray(vertices, np.float32),
            indices=np.ascontiguousarray(faces, np.int32),
        )


def _weld(positions: np.ndarray, faces: np.ndarray):
    """Merge duplicate vertices (exact match after float32 rounding)."""
    key = np.ascontiguousarray(positions.astype(np.float32))
    key_view = key.view([("x", np.float32), ("y", np.float32), ("z", np.float32)])
    _, first, inverse = np.unique(
        key_view.ravel(), return_index=True, return_inverse=True
    )
    new_pos = positions[first]
    new_faces = inverse[faces]
    # drop degenerate faces
    good = (
        (new_faces[:, 0] != new_faces[:, 1])
        & (new_faces[:, 1] != new_faces[:, 2])
        & (new_faces[:, 0] != new_faces[:, 2])
    )
    return new_pos, new_faces[good]


def _vertex_normals(positions: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0 = positions[faces[:, 0]]
    e1 = positions[faces[:, 1]] - v0
    e2 = positions[faces[:, 2]] - v0
    fn = np.cross(e1, e2)  # length = 2x area -> area weighting for free
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    length = np.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / np.maximum(length, 1e-30)
