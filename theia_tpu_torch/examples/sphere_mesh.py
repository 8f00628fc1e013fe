"""The module mesh of the port's example scripts: an icosphere built in
code, where theia_tpu's examples load ``sphere.stl``."""

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
