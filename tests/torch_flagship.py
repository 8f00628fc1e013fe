"""The flagship scene, built the same way in ``theia_tpu`` and in
``theia_tpu_torch`` (a helper for the port's tests and ``chip_smoke.py``;
not collected by pytest).

:func:`build_flagship` mirrors ``__graft_entry__._build_scene_tracer``
through the public names both packages share: ``SceneForwardTracer`` on
two BK7 shells around a spherical source plus one detector sphere, in
water with Henyey-Greenstein g = 0.9, ``SphereTargetGuide`` MIS, a 100-bin
``HistogramHitResponse`` and ``PhiloxRNG(key=42)``. The sphere mesh is an
icosphere built in code, so no mesh file is needed.
"""

from __future__ import annotations

import importlib

import numpy as np


def icosphere(subdivisions: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere as (positions (V, 3) f64, faces (T, 3) i64);
    ``subdivisions=3`` gives 1280 triangles. Faces wind outward."""
    t = (1.0 + 5.0**0.5) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    pos = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    for _ in range(subdivisions):
        cache: dict[tuple[int, int], int] = {}

        def mid(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = pos[a] + pos[b]
                pos.append(m / np.linalg.norm(m))
                cache[key] = len(pos) - 1
            return cache[key]

        new = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return np.stack(pos), np.asarray(faces, np.int64)


def build_flagship(pkg, mesh, batch: int, max_path: int, accel: str = "mt", device=None):
    """The flagship tracer of package ``pkg`` (``theia_tpu`` or
    ``theia_tpu_torch``) on the sphere ``mesh`` = (positions, faces).
    ``device`` is required by ``theia_tpu_torch`` and must be None for
    ``theia_tpu``."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    u = mod("units")
    light, material, rnd = mod("light"), mod("material"), mod("random")
    response, scene_mod, target = mod("response"), mod("scene"), mod("target")
    tracers = mod("trace.scene")
    dev = {} if device is None else {"device": device}

    class WaterModel(
        material.WaterBaseModel,
        material.HenyeyGreensteinPhaseFunction,
        material.MediumModel,
    ):
        ModelName = "water"

        def __init__(self):
            material.WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
            material.HenyeyGreensteinPhaseFunction.__init__(self, 0.9)

    water = WaterModel().createMedium(num_lambda=256, num_theta=256)
    glass = material.BK7Model().createMedium(num_lambda=256, num_theta=4)
    Material = material.Material
    mats = material.MaterialStore.pack(
        [
            Material("glass_water", glass, water, flags="TR"),
            Material("air_glass", None, glass, flags="TR"),
            Material("det_water", None, water, flags="DB"),
        ],
        **dev,
    )
    sphere = mod("mesh").Mesh.from_geometry(*mesh)
    meshes = scene_mod.MeshStore({"sphere": sphere})
    T = scene_mod.Transform
    light_pos = (3.0, 0.0, 0.0)
    det_pos = (0.0, 3.0, 0.0)
    instances = [
        meshes.createInstance("sphere", "glass_water", T.TRS(scale=0.8, translate=light_pos)),
        meshes.createInstance("sphere", "air_glass", T.TRS(scale=0.75, translate=light_pos)),
        meshes.createInstance(
            "sphere", "det_water", T.TRS(scale=0.6, translate=det_pos), detectorId=1
        ),
    ]
    scene = scene_mod.Scene(instances, mats, medium="water", accel=accel, **dev)
    return tracers.SceneForwardTracer(
        batch,
        light.SphericalLightSource(position=light_pos, timeRange=(0.0, 10.0), budget=1e5),
        light.UniformWavelengthSource(lambdaRange=(300.0, 700.0)),
        response.HistogramHitResponse(nBins=100, t0=0.0, binSize=5.0 * u.ns),
        rnd.PhiloxRNG(key=42),
        scene,
        maxPathLength=max_path,
        sourceMedium="vacuum",  # the source sits inside the air-filled shell
        scatterCoefficient=0.05,
        targetId=1,
        targetGuide=target.SphereTargetGuide(position=det_pos, radius=0.6),
        **dev,
    )
