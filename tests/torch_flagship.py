"""The flagship scene, built the same way in ``theia_tpu`` and in
``theia_tpu_torch`` (a helper for the port's tests and ``chip_smoke.py``;
not collected by pytest).

:func:`build_flagship` mirrors ``__graft_entry__._build_scene_tracer``
through the public names both packages share: ``SceneForwardTracer`` on
two BK7 shells around a spherical source plus one detector sphere, in
water with Henyey-Greenstein g = 0.9, ``SphereTargetGuide`` MIS, a 100-bin
``HistogramHitResponse`` and ``PhiloxRNG(key=42)``. The sphere mesh is an
icosphere built in code, so no mesh file is needed.
:func:`build_volume_flagship` is ``examples/01_volume_tracing.py``'s
volume tracer, :func:`build_volume_photon` a volume photon tracer of
``tests/test_trace_photon.py`` and :func:`build_photon_flagship` the
photon tracer of ``__graft_entry__._dryrun_photon_compacted`` on the
flagship's scene.
:func:`adversarial_rays` makes rays on the boundaries of the nearest-hit
tests from a soup's triangles.
"""

from __future__ import annotations

import dataclasses
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


def build_flagship(
    pkg, mesh, batch: int, max_path: int, accel: str = "mt", device=None, *,
    polarized: bool = False, source_position=(3.0, 0.0, 0.0), guided: bool = True, response=None,
):
    """The flagship tracer of package ``pkg`` (``theia_tpu`` or
    ``theia_tpu_torch``) on the sphere ``mesh`` = (positions, faces).
    ``device`` goes to ``theia_tpu_torch``'s constructors, which default
    to the card when it is None; it must be None for ``theia_tpu``. ``polarized`` is passed through as
    ``_build_scene_tracer`` does. ``source_position`` moves the light
    source alone; the glass shells stay centred at (3, 0, 0). Off centre,
    direct rays meet the shells at oblique incidence, where the Fresnel
    polarizers are not the identity. ``guided=False`` drops the
    ``SphereTargetGuide`` (the unguided tracer); ``response`` replaces the
    histogram."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    u = mod("units")
    light, material, rnd = mod("light"), mod("material"), mod("random")
    scene_mod, target = mod("scene"), mod("target")
    tracers = mod("trace.scene")
    dev = {} if device is None else {"device": device}

    water = water_medium(material, num_lambda=256, num_theta=256)
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
        light.SphericalLightSource(
            position=tuple(source_position), timeRange=(0.0, 10.0), budget=1e5
        ),
        light.UniformWavelengthSource(lambdaRange=(300.0, 700.0)),
        response or mod("response").HistogramHitResponse(nBins=100, t0=0.0, binSize=5.0 * u.ns),
        rnd.PhiloxRNG(key=42),
        scene,
        maxPathLength=max_path,
        sourceMedium="vacuum",  # the source sits inside the air-filled shell
        scatterCoefficient=0.05,
        targetId=1,
        targetGuide=target.SphereTargetGuide(position=det_pos, radius=0.6) if guided else None,
        polarized=polarized,
        **dev,
    )


def water_medium(material, **sizes):
    """The flagship's water (10 degC, 35 PSU, HG g = 0.9) from ``material``,
    ``theia_tpu.material`` or ``theia_tpu_torch.material``."""

    class WaterModel(
        material.WaterBaseModel,
        material.HenyeyGreensteinPhaseFunction,
        material.MediumModel,
    ):
        ModelName = "water"

        def __init__(self):
            material.WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
            material.HenyeyGreensteinPhaseFunction.__init__(self, 0.9)

    return WaterModel().createMedium(**sizes)


def build_volume_flagship(pkg, batch: int, device=None, **kw):
    """``examples/01_volume_tracing.py``'s ``VolumeForwardTracer`` (golden
    c2's configuration without its ``refCompatRNG``): water at 10 degC and
    35 PSU with Henyey-Greenstein g = 0.9 at the model's default table
    sizes, a spherical source at (-1, -7, 0) m with budget 1e9, a 5 m
    ``SphereTarget`` at the origin, 400-500 nm, 100 bins of 5 ns,
    ``PhiloxRNG(key=0xC0FFEE)``, 10 scatterings, 500 ns. ``kw`` goes to
    the tracer (``polarized``, the flags, ``medium``, ``response`` or
    ``nScattering`` to replace the water, the histogram or the depth)."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    light, rnd, response, target = mod("light"), mod("random"), mod("response"), mod("target")
    dev = {} if device is None else {"device": device}
    kw.setdefault("medium", water_medium(mod("material")))
    resp = kw.pop("response", None) or response.HistogramHitResponse(nBins=100, binSize=5.0, t0=0.0)
    return mod("trace.volume").VolumeForwardTracer(
        batch,
        light.SphericalLightSource(position=(-1.0, -7.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        target.SphereTarget(position=(0.0, 0.0, 0.0), radius=5.0),
        light.UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        resp,
        rnd.PhiloxRNG(key=0xC0FFEE),
        nScattering=kw.pop("nScattering", 10),
        maxTime=500.0,
        **kw,
        **dev,
    )


def build_volume_photon(pkg, batch: int, device=None, **kw):
    """``tests/test_trace_photon.py``'s ``VolumePhotonTracer`` of
    ``test_run_compacted_matches_run``: a strongly absorbing medium
    (mu_a 0.05, mu_s 0.02 /m, HG g = 0.3) around a source inside a 60 m
    ``InnerSphereTarget``, 4 scatterings a run, 6 runs, a 40-bin
    histogram of 25 ns. ``kw`` goes to the tracer (the response as
    ``response=``)."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    mat, light, response = mod("material"), mod("light"), mod("response")

    class Model(mat.DispersionFreeMedium, mat.HenyeyGreensteinPhaseFunction, mat.MediumModel):
        ModelName = "homogenous"

        def __init__(self):
            mat.DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=0.05, mu_s=0.02)
            mat.HenyeyGreensteinPhaseFunction.__init__(self, 0.3)

    dev = {} if device is None else {"device": device}
    resp = kw.pop("response", None) or response.HistogramHitResponse(nBins=40, t0=0.0, binSize=25.0)
    return mod("trace.photon").VolumePhotonTracer(
        batch,
        light.SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1.0),
        mod("target").InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=60.0),
        light.UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        resp,
        mod("random").PhiloxRNG(key=0xFADE),
        medium=Model().createMedium(),
        nScatteringPerRun=4,
        nRuns=6,
        maxTime=float("inf"),
        **kw,
        **dev,
    )


def build_photon_flagship(pkg, mesh, batch: int, device=None, **kw):
    """``ScenePhotonTracer`` on the flagship's scene with no ``accel``
    named (the brute-force default), with
    ``__graft_entry__._dryrun_photon_compacted``'s settings: the source at
    (3, 0, 0) over 0-10 ns with budget 1e5, 300-700 nm, 50 bins of 10 ns,
    ``PhiloxRNG(key=7)``, 2 scatterings a run, 3 runs, the source in
    vacuum, scatter coefficient 0.05, target id 1. ``kw`` goes to the
    tracer (the response as ``response=``)."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    light, rnd, response = mod("light"), mod("random"), mod("response")
    dev = {} if device is None else {"device": device}
    scene = build_flagship(pkg, mesh, 1, 2, accel="auto", device=device).scene
    resp = kw.pop("response", None) or response.HistogramHitResponse(nBins=50, t0=0.0, binSize=10.0)
    return mod("trace.photon").ScenePhotonTracer(
        batch,
        light.SphericalLightSource(position=(3.0, 0.0, 0.0), timeRange=(0.0, 10.0), budget=1e5),
        light.UniformWavelengthSource(lambdaRange=(300.0, 700.0)),
        resp,
        rnd.PhiloxRNG(key=7),
        scene,
        nScatteringPerRun=2,
        nRuns=3,
        sourceMedium="vacuum",
        scatterCoefficient=0.05,
        targetId=1,
        **kw,
        **dev,
    )


def adversarial_rays(v0, e1, e2, seed, per_kind=96):
    """Rays that sit on the rejection test's boundaries, from a soup's
    world triangles: through vertices, through points on edges, along
    edges, inside a triangle's plane, and from a surface point pushed off
    by ``offset_ray`` (towards, away and along the surface)."""
    import torch

    from theia_tpu_torch.accel import offset_ray

    rng = np.random.default_rng(seed)
    v0, e1, e2 = (np.asarray(a, np.float64) for a in (v0, e1, e2))
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    pick = lambda: rng.integers(0, v0.shape[0], per_kind)
    eye = lambda k: rng.uniform(-1.0, 4.0, size=(k, 3))
    o, d = [], []
    # through a vertex, and through a point on an edge
    for w1, w2 in ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (0.5, 0.0), (0.0, 0.3), (0.6, 0.4)):
        i = pick()
        target = v0[i] + w1 * e1[i] + w2 * e2[i]
        o.append(eye(per_kind))
        d.append(target - o[-1])
    # along an edge, starting before it, on it and beside it by an ulp or so
    i = pick()
    for shift in (0.0, 1e-7, -1e-7):
        o.append(v0[i] - 0.5 * e1[i] + shift * n[i])
        d.append(e1[i])
    # inside the triangle's plane, crossing it and passing it by
    i = pick()
    inplane = e1[i] * rng.normal(size=(per_kind, 1)) + e2[i] * rng.normal(size=(per_kind, 1))
    o.append(v0[i] + 0.3 * e1[i] + 0.3 * e2[i] - 5.0 * inplane)
    d.append(inplane)
    o.append(v0[i] + 4.0 * e1[i] - 5.0 * inplane)
    d.append(inplane)
    # from the surface after offset_ray, as the tracer's next segment starts
    i = pick()
    on = v0[i] + 0.25 * e1[i] + 0.25 * e2[i]
    for sign in (1.0, -1.0):
        pushed = offset_ray(
            torch.as_tensor(on, dtype=torch.float32), torch.as_tensor(sign * n[i], dtype=torch.float32)
        ).numpy()
        for dirs in (rng.normal(size=(per_kind, 3)), -sign * n[i], e1[i] + 1e-4 * sign * n[i]):
            o.append(pushed)
            d.append(dirs)
    o, d = np.concatenate(o), np.concatenate(d)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    return o.astype(np.float32), d.astype(np.float32)


def numpy_tree(x):
    """Flatten a ``theia_tpu`` params pytree into nested dicts of numpy
    arrays keyed by field name, keeping static fields as Python values
    (the input of ``theia_tpu_torch.interop.params_from_numpy``)."""
    if x is None:  # a vacuum medium
        return None
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return {
            f.name: numpy_tree(getattr(x, f.name))
            for f in dataclasses.fields(x)
            if getattr(x, f.name) is not None
        }
    if hasattr(x, "n_tri"):  # MTPack or WoopPack
        table = "tri" if hasattr(x, "tri") else "b"
        return {k: numpy_tree(getattr(x, k)) for k in (table, "aabb", "lo", "hi", "n_tri")}
    if isinstance(x, (str, bool, int, tuple)):
        return x
    return np.asarray(x)


def build_grad_scene(pkg, kind: str, batch: int, device=None, *, mesh=None, max_path=None):
    """The scene tracers of ``tests/test_grad_scene.py`` (and golden c5's)
    in package ``pkg``, on the in-code icosphere ``mesh`` (default
    ``icosphere(2)``) where those load ``sphere.stl`` or ``suzanne.stl``:

    - ``"medium"``: a 100 m detector sphere of HG water (mu_a 0.01, mu_s
      0.008, g 0.4) around the source, fixed scatter coefficient, path
      length 6 (``build_forward_tracer``: mu FD-exact, mu_a sign);
    - ``"fresnel"``: a non-absorbing 60 m detector sphere in water (mu_s
      0.01, g 0.3), path length 5 (``build_fresnel_tracer``: the IOR);
    - ``"source"``: four 0.4 m detectors of ``WaterTestModel`` water
      around the source, a ``KernelHistogramHitResponse`` with a detector
      axis, path length 4 (``test_arrival_time_gradient_wrt_source_position``,
      here on ``accel="brute"`` where the JAX test names ``"instanced"``);
    - ``"detector"``: one 0.5 m detector at (3, 0, 0), brute force, a
      ``KernelHistogramHitResponse``, path length 4
      (``test_detector_position_gradient``);
    - ``"c5"``: golden c5's polarized scene (a BK7 shell around the source
      in water, the detector, which in c5 is suzanne, at (0, 4, 0), a
      ``SphereTargetGuide``; ``tools/ref_conformance.c5_suzanne_polarized_grad``).

    ``max_path`` replaces the path length. Scene media keep the names the
    tests patch: ``homogenous``, ``water_test``, ``water`` and ``bk7``."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    light, material, rnd, response = mod("light"), mod("material"), mod("random"), mod("response")
    scene_mod, target, u = mod("scene"), mod("target"), mod("units")
    tracers = mod("trace.scene")
    dev = {} if device is None else {"device": device}
    Material, T = material.Material, scene_mod.Transform
    meshes = scene_mod.MeshStore({"sphere": mod("mesh").Mesh.from_geometry(*(mesh or icosphere(2)))})

    class Model(material.DispersionFreeMedium, material.HenyeyGreensteinPhaseFunction, material.MediumModel):
        ModelName = "homogenous"

        def __init__(self, a, s, g):
            material.DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=a, mu_s=s)
            material.HenyeyGreensteinPhaseFunction.__init__(self, g)

    def tracer(scene, source, resp, key, path, **kw):
        return tracers.SceneForwardTracer(
            batch, source, light.UniformWavelengthSource(lambdaRange=kw.pop("lam", (450.0, 450.0))), resp,
            rnd.PhiloxRNG(key=key), scene, maxPathLength=max_path or path, **kw, **dev,
        )

    origin = lambda t0=0.0, budget=1e9: light.SphericalLightSource(
        position=(0.0, 0.0, 0.0), timeRange=(t0, t0), budget=budget
    )
    if kind in ("medium", "fresnel"):
        a, s, g, flags, scale = (0.01, 0.008, 0.4, "DB", 100.0) if kind == "medium" else (0.0, 0.01, 0.3, "D", 60.0)
        mats = material.MaterialStore.pack([Material("det", Model(a, s, g).createMedium(), None, flags=flags)], **dev)
        inst = meshes.createInstance("sphere", "det", T.TRS(scale=scale), detectorId=0)
        scene = scene_mod.Scene([inst], mats, medium="homogenous", **dev)
        hist = response.HistogramHitResponse(nBins=50, t0=0.0, binSize=25.0)
        return tracer(
            scene, origin(10.0 if kind == "medium" else 0.0), hist, 0xC0FFEE if kind == "medium" else 0xBEEF,
            6 if kind == "medium" else 5, scatterCoefficient=0.02, maxTime=float("inf"),
        )
    if kind in ("source", "detector"):
        medium = mod("testing").WaterTestModel(mu_a=0.01, mu_s=0.02, g=0.3).createMedium()
        mats = material.MaterialStore.pack([Material("det", None, medium, flags="DB")], **dev)
        if kind == "source":
            insts = [
                meshes.createInstance(
                    "sphere", "det", T.TRS(scale=0.4, translate=(2.0 * i - 1.0, 2.0 * j - 1.0, 0.0)),
                    detectorId=i * 2 + j,
                )
                for i in range(2) for j in range(2)
            ]
            resp = response.KernelHistogramHitResponse(nBins=30, t0=0.0, binSize=1.0, nDetectors=4)
            key, lam, max_time = 0xBADA55, (420.0, 480.0), 30.0
        else:
            insts = [meshes.createInstance("sphere", "det", T.TRS(scale=0.5, translate=(3.0, 0.0, 0.0)), detectorId=0)]
            resp = response.KernelHistogramHitResponse(nBins=30, t0=0.0, binSize=1.5)
            key, lam, max_time = 0xD07, (450.0, 450.0), 40.0
        scene = scene_mod.Scene(insts, mats, medium="water_test", accel="brute", **dev)
        return tracer(scene, origin(0.0, 1e6), resp, key, 4, lam=lam, maxTime=max_time)
    if kind == "c5":
        water = water_medium(material, num_lambda=64, num_theta=256)
        glass = material.BK7Model().createMedium(num_lambda=64, num_theta=4)
        mats = material.MaterialStore.pack(
            [Material("glass_water", glass, water, flags="TR"), Material("det_water", None, water, flags="DB")], **dev
        )
        src = (0.0, -2.0, 0.0)
        insts = [
            meshes.createInstance("sphere", "glass_water", T.TRS(scale=0.8, translate=src)),
            meshes.createInstance("sphere", "det_water", T.TRS(scale=1.0, translate=(0.0, 4.0, 0.0)), detectorId=1),
        ]
        scene = scene_mod.Scene(insts, mats, medium="water", **dev)
        return tracer(
            scene, light.SphericalLightSource(position=src, timeRange=(0.0, 5.0), budget=1e6),
            response.HistogramHitResponse(nBins=100, t0=0.0, binSize=2.0 * u.ns), 0x5A, 6,
            lam=(400.0, 500.0), sourceMedium="bk7", targetId=1,
            targetGuide=target.SphereTargetGuide(position=(0.0, 4.0, 0.0), radius=1.5),
            polarized=True, refCompatRNG=True,
        )
    raise ValueError(f"unknown gradient scene {kind!r}")
