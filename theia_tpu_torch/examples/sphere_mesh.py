"""The meshes of the port's example scripts, built in code where
theia_tpu's examples load ``sphere.stl`` and ``suzanne.stl``: an
icosphere, a torus, and a binary STL writer for scripts that load their
meshes from files."""

import struct

import numpy as np

from theia_tpu_torch.mesh import Mesh


def unit_sphere(subdivisions: int = 3) -> Mesh:
    """An icosphere of 20 * 4**subdivisions triangles, faces outward."""
    t = (1.0 + 5.0**0.5) / 2.0
    pos = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in (
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
        (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    )]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
        (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
        (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    for _ in range(subdivisions):
        middle: dict = {}

        def mid(a, b):
            if (a, b) not in middle:
                m = pos[a] + pos[b]
                pos.append(m / np.linalg.norm(m))
                middle[(a, b)] = middle[(b, a)] = len(pos) - 1
            return middle[(a, b)]

        faces = [f for a, b, c in faces for f in (
            (a, mid(a, b), mid(c, a)), (b, mid(b, c), mid(a, b)), (c, mid(c, a), mid(b, c)),
            (mid(a, b), mid(b, c), mid(c, a)),
        )]
    return Mesh.from_geometry(np.stack(pos), np.asarray(faces))


def torus(major: float = 1.0, minor: float = 0.35, n_major: int = 48, n_minor: int = 24) -> Mesh:
    """A torus around the z axis, faces outward: the stand-in for the
    reference's suzanne, an uneven closed surface with a hole."""
    a = np.linspace(0.0, 2.0 * np.pi, n_major, endpoint=False)
    b = np.linspace(0.0, 2.0 * np.pi, n_minor, endpoint=False)
    A, B = np.meshgrid(a, b, indexing="ij")
    pos = np.stack([
        (major + minor * np.cos(B)) * np.cos(A), (major + minor * np.cos(B)) * np.sin(A), minor * np.sin(B),
    ], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_major), np.arange(n_minor), indexing="ij")
    v00 = i * n_minor + j
    v10 = ((i + 1) % n_major) * n_minor + j
    v01 = i * n_minor + (j + 1) % n_minor
    v11 = ((i + 1) % n_major) * n_minor + (j + 1) % n_minor
    faces = np.concatenate([np.stack([v00, v10, v11], -1), np.stack([v00, v11, v01], -1)], axis=-1).reshape(-1, 3)
    return Mesh.from_geometry(pos, faces)


def write_stl(path, mesh: Mesh) -> None:
    """Write ``mesh``'s triangles (float32 corners, zero facet normals) as
    a binary STL file."""
    tri = mesh.vertices[:, :3][mesh.indices].astype(np.float32)  # (T, 3, 3)
    rec = np.zeros(len(tri), np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")]))
    rec["v"] = tri
    with open(path, "wb") as f:
        f.write(b"binary STL written by theia_tpu_torch's examples".ljust(80, b" "))
        f.write(struct.pack("<I", len(tri)))
        f.write(rec.tobytes())
