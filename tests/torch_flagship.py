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
:func:`build_volume_backward` and :func:`build_direct` are the camera
tracers of ``tests/test_trace_backward.py``'s energy and analytic tests;
:func:`build_scene_backward_target`, :func:`build_backward_eta2`,
:func:`build_lamp`, :func:`build_backward_glass`,
:func:`build_scene_backward` and :func:`build_bidirectional` the scene
camera tracers of ``tests/test_scene_backward.py``,
``tests/test_grad_scene.py`` and ``tests/test_bidirectional.py`` on
in-code icospheres.
:func:`build_array` is ``examples/08_detector_array.py``'s detector array
(what ``accel="auto"`` sends to the instanced walk), :func:`array_rays`
random rays through it, :func:`tie_scene` arrays whose hits tie exactly.
:func:`write_stl`, :func:`write_ply` and :func:`write_obj` write meshes
as the files that the mesh loaders read, and :func:`array_obj` example
08's module as an OBJ template.
:func:`adversarial_rays` makes rays on the boundaries of the nearest-hit
tests from a soup's triangles. :func:`eager_route` runs a scene tracer's
batches on the eager segment, which the staged one is held against.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import struct
from pathlib import Path

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
    polarized: bool = False, source_position=(3.0, 0.0, 0.0), guided: bool = True, response=None, rng=None,
    guide: str = "sphere",
):
    """The flagship tracer of package ``pkg`` (``theia_tpu`` or
    ``theia_tpu_torch``) on the sphere ``mesh`` = (positions, faces), or
    the path of a mesh file that ``MeshStore`` loads.
    ``device`` goes to ``theia_tpu_torch``'s constructors, which default
    to the card when it is None; it must be None for ``theia_tpu``. ``polarized`` is passed through as
    ``_build_scene_tracer`` does. ``source_position`` moves the light
    source alone; the glass shells stay centred at (3, 0, 0). Off centre,
    direct rays meet the shells at oblique incidence, where the Fresnel
    polarizers are not the identity. ``guided=False`` drops the
    ``SphereTargetGuide`` (the unguided tracer); ``guide="disk"`` puts a
    ``DiskTargetGuide`` of the detector sphere's centre and radius, its
    normal facing the glass shells' centre, in its place; ``response``
    replaces the histogram."""
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
    # a mesh file's path goes to MeshStore, which loads it
    sphere = mesh if isinstance(mesh, (str, Path)) else mod("mesh").Mesh.from_geometry(*mesh)
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
        rng(rnd) if rng else rnd.PhiloxRNG(key=42),
        scene,
        maxPathLength=max_path,
        sourceMedium="vacuum",  # the source sits inside the air-filled shell
        scatterCoefficient=0.05,
        targetId=1,
        targetGuide=flagship_guide(target, guide, det_pos, light_pos) if guided else None,
        polarized=polarized,
        **dev,
    )


def flagship_guide(target, kind: str, det_pos, light_pos):
    """The flagship's MIS guide toward its detector sphere (radius 0.6):
    ``"sphere"`` (``_build_scene_tracer``'s) or ``"disk"``, a disk of the
    sphere's centre and radius facing the shells' centre."""
    if kind == "sphere":
        return target.SphereTargetGuide(position=det_pos, radius=0.6)
    if kind == "disk":
        normal = np.subtract(light_pos, det_pos)
        return target.DiskTargetGuide(position=det_pos, radius=0.6, normal=tuple(normal / np.linalg.norm(normal)))
    raise ValueError(f"unknown guide {kind!r}")


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
    the tracer (``polarized``, the flags, ``medium``, ``response``,
    ``nScattering``, ``source`` or ``target`` to replace the water, the
    histogram, the depth, the light source or the detector);
    ``rng``, a function of the package's ``random`` module, replaces the
    Philox generator."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    light, rnd, response, target = mod("light"), mod("random"), mod("response"), mod("target")
    dev = {} if device is None else {"device": device}
    rng = kw.pop("rng", None)
    kw.setdefault("medium", water_medium(mod("material")))
    resp = kw.pop("response", None) or response.HistogramHitResponse(nBins=100, binSize=5.0, t0=0.0)
    return mod("trace.volume").VolumeForwardTracer(
        batch,
        kw.pop("source", None) or light.SphericalLightSource(position=(-1.0, -7.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        kw.pop("target", None) or target.SphereTarget(position=(0.0, 0.0, 0.0), radius=5.0),
        light.UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        resp,
        rng(rnd) if rng else rnd.PhiloxRNG(key=0xC0FFEE),
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
    ``response=``, a function of the package's ``random`` module as
    ``rng=``)."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    mat, light, response = mod("material"), mod("light"), mod("response")
    rng = kw.pop("rng", None)

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
        rng(mod("random")) if rng else mod("random").PhiloxRNG(key=0xFADE),
        medium=Model().createMedium(),
        nScatteringPerRun=4,
        nRuns=6,
        maxTime=float("inf"),
        **kw,
        **dev,
    )


def _homogeneous(mat, mu_a: float, mu_s: float, g: float):
    """A dispersion-free medium (n = n_g = 1.33) with HG scattering."""

    class Model(mat.DispersionFreeMedium, mat.HenyeyGreensteinPhaseFunction, mat.MediumModel):
        ModelName = "homogenous"

        def __init__(self):
            mat.DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=mu_a, mu_s=mu_s)
            mat.HenyeyGreensteinPhaseFunction.__init__(self, g)

    return Model().createMedium()


#: the volume backward run's light and camera centre, camera radius (the
#: camera faces inward) and scattering coefficient
BACKWARD_POSITION, BACKWARD_RADIUS, BACKWARD_MU_S = (12.0, 15.0, 0.2), 100.0, 0.02


def build_volume_backward(pkg, batch: int, device=None, **kw):
    """``tests/test_trace_backward.py``'s ``VolumeBackwardTracer`` of
    ``test_backward_energy_conservation``: a spherical light (budget 1e9,
    at 10 ns) at (12, 15, 0.2) inside a ``SphereCamera`` of radius -100
    (its surface facing inward) and an ``InnerSphereTarget`` of radius
    100.1, mu_a 0, mu_s 0.02, HG g = -0.4, 450 nm, 30 scatterings, no time
    limit, a ``HitRecorder``, ``PhiloxRNG(key=0xC0FFEE)``. ``kw`` goes to
    the tracer (``response``, ``nScattering``, ``polarized``, ``target``:
    None drops the target); ``g`` and ``key`` replace the phase function's
    asymmetry and the Philox key."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    light = mod("light")
    dev = {} if device is None else {"device": device}
    inner = mod("target").InnerSphereTarget(position=BACKWARD_POSITION, radius=BACKWARD_RADIUS * 1.001)
    return mod("trace.backward").VolumeBackwardTracer(
        batch,
        light.SphericalLightSource(position=BACKWARD_POSITION, timeRange=(10.0, 10.0), budget=1e9),
        mod("camera").SphereCamera(position=BACKWARD_POSITION, radius=-BACKWARD_RADIUS),
        light.UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        kw.pop("response", None) or mod("response").HitRecorder(),
        mod("random").PhiloxRNG(key=kw.pop("key", 0xC0FFEE)),
        medium=_homogeneous(mod("material"), 0.0, BACKWARD_MU_S, kw.pop("g", -0.4)),
        nScattering=kw.pop("nScattering", 30),
        target=kw.pop("target", inner),
        maxTime=float("inf"),
        **kw,
        **dev,
    )


#: the direct run's camera centre and radius, and its medium's absorption
DIRECT_CAMERA, DIRECT_RADIUS, DIRECT_MU_A = (8.0, 0.0, 0.0), 1.0, 0.02


def build_direct(pkg, batch: int, device=None, **kw):
    """``tests/test_trace_backward.py``'s ``DirectLightTracer`` of
    ``test_direct_tracer_analytic``: a spherical light (budget 1e9, at
    10 ns) at the origin, a ``SphereCamera`` of radius 1 at (8, 0, 0), a
    purely absorbing medium (mu_a 0.02, n = n_g = 1.33), 450 nm, 60 bins of
    10 ns, ``PhiloxRNG(key=0xC0FFEE)``. ``kw`` goes to the tracer."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    light = mod("light")
    dev = {} if device is None else {"device": device}
    return mod("trace.direct").DirectLightTracer(
        batch,
        light.SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(10.0, 10.0), budget=1e9),
        mod("camera").SphereCamera(position=DIRECT_CAMERA, radius=DIRECT_RADIUS),
        light.UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        mod("response").HistogramHitResponse(nBins=60, t0=0.0, binSize=10.0),
        mod("random").PhiloxRNG(key=0xC0FFEE),
        medium=_homogeneous(mod("material"), DIRECT_MU_A, 0.0, 0.0),
        **kw,
        **dev,
    )


def _mod(pkg):
    return lambda name: importlib.import_module(f"{pkg.__name__}.{name}")


def nearest_face_distance(mesh, scale: float = 1.0) -> float:
    """The least distance from the mesh's centre (the origin) to the plane
    of one of its faces, times ``scale``: no ray from the centre meets the
    mesh nearer."""
    pos, faces = mesh
    v0, v1, v2 = (pos[faces[:, k]] for k in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    return float(scale * np.min(np.abs(np.sum(n * v0, axis=1)) / np.linalg.norm(n, axis=1)))


def build_scene_backward_target(pkg, batch: int, device=None, *, mesh=None, max_path: int = 3, guided: bool = False,
                                rng=None, response=None, accel: str = "auto"):
    """``tests/test_scene_backward.py``'s emissive sphere: a
    ``SceneBackwardTargetTracer`` with a ``PointCamera`` at the origin
    inside an emissive (``"LB"``) sphere of radius 10 in vacuum, 450 nm, a
    ``HitRecorder``, ``PhiloxRNG(key=3)``, no time limit; ``mesh`` (default
    ``icosphere(3)``) replaces ``sphere.stl``. ``guided`` adds a
    ``SphereTargetGuide`` on the wall (radius 10), whose MIS shadow rays
    take the brute-force pack's detector split."""
    mod = _mod(pkg)
    material, scene_mod = mod("material"), mod("scene")
    dev = {} if device is None else {"device": device}
    store = material.MaterialStore.pack([material.Material("emit", None, None, flags="LB")], **dev)
    meshes = scene_mod.MeshStore({"sphere": mod("mesh").Mesh.from_geometry(*(mesh or icosphere(3)))})
    inst = meshes.createInstance("sphere", "emit", scene_mod.Transform.TRS(scale=10.0))
    scene = scene_mod.Scene([inst], store, medium=None, accel=accel, **dev)
    guide = {"targetGuide": mod("target").SphereTargetGuide(radius=10.0)} if guided else {}
    return mod("trace.scene_backward").SceneBackwardTargetTracer(
        batch,
        mod("camera").PointCamera(position=(0.0, 0.0, 0.0)),
        mod("light").UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        response or mod("response").HitRecorder(),
        rng(mod("random")) if rng else mod("random").PhiloxRNG(key=3),
        scene,
        maxPathLength=max_path,
        maxTime=float("inf"),
        **guide,
        **dev,
    )


def build_backward_eta2(pkg, batch: int, device=None, *, mesh=None, max_path: int = 4):
    """``tests/test_grad_scene.py``'s ``test_grad_backward_eta2_statistical``:
    a point camera at the centre of a glass ball (n = 1.5, radius 1) inside
    an emissive wall of radius 10 in vacuum, 50 bins of 2 ns,
    ``PhiloxRNG(key=7)``; the camera's medium is the glass (media
    ``glass``), ``mesh`` (default ``icosphere(2)``) replaces ``sphere.stl``."""
    mod = _mod(pkg)
    material, scene_mod = mod("material"), mod("scene")
    dev = {} if device is None else {"device": device}
    glass = material.DispersionFreeMedium(n=1.5, ng=1.5, mu_a=0.0, mu_s=0.0).createMedium(name="glass")
    Material, T = material.Material, scene_mod.Transform
    store = material.MaterialStore.pack(
        [Material("shell", glass, None), Material("emit", None, None, flags="LB")], **dev
    )
    meshes = scene_mod.MeshStore({"sphere": mod("mesh").Mesh.from_geometry(*(mesh or icosphere(2)))})
    ball = meshes.createInstance("sphere", "shell", T.TRS(scale=1.0))
    wall = meshes.createInstance("sphere", "emit", T.TRS(scale=10.0))
    scene = scene_mod.Scene([ball, wall], store, medium=None, **dev)
    return mod("trace.scene_backward").SceneBackwardTargetTracer(
        batch,
        mod("camera").PointCamera(position=(0.0, 0.0, 0.0)),
        mod("light").UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        mod("response").HistogramHitResponse(nBins=50, t0=0.0, binSize=2.0),
        mod("random").PhiloxRNG(key=7),
        scene,
        medium="glass",
        maxPathLength=max_path,
        maxTime=float("inf"),
        **dev,
    )


def build_lamp(pkg, batch: int, device=None, *, mesh=None, guided: bool = True, detector: bool = False,
               max_path: int = 4, accel: str = "auto"):
    """A ``SceneBackwardTargetTracer`` in scattering water (mu_a 0.01, mu_s
    0.05, HG g = 0.3, n 1.33): a ``PointCamera`` at the origin sees an
    emissive (``"LB"``) lamp of radius 0.5 at (3, 0, 0), guided by a
    ``SphereTargetGuide`` on the lamp where ``guided``; ``detector`` adds a
    detector (``"DB"``) sphere of radius 0.5 at (-3, 0, 0), which moves the
    brute-force pack's MIS shadow query onto the detector split. 50 bins of
    1 ns, ``PhiloxRNG(key=5)``, ``mesh`` default ``icosphere(2)``."""
    mod = _mod(pkg)
    material, scene_mod = mod("material"), mod("scene")
    dev = {} if device is None else {"device": device}
    water = dataclasses.replace(_homogeneous(material, 0.01, 0.05, 0.3), name="water")
    Material, T = material.Material, scene_mod.Transform
    store = material.MaterialStore.pack(
        [Material("lamp", None, water, flags="LB"), Material("det", None, water, flags="DB")], **dev
    )
    meshes = scene_mod.MeshStore({"sphere": mod("mesh").Mesh.from_geometry(*(mesh or icosphere(2)))})
    insts = [meshes.createInstance("sphere", "lamp", T.TRS(scale=0.5, translate=(3.0, 0.0, 0.0)))]
    if detector:
        insts.append(meshes.createInstance("sphere", "det", T.TRS(scale=0.5, translate=(-3.0, 0.0, 0.0)), detectorId=1))
    scene = scene_mod.Scene(insts, store, medium="water", accel=accel, **dev)
    guide = {"targetGuide": mod("target").SphereTargetGuide(position=(3.0, 0.0, 0.0), radius=0.5)} if guided else {}
    return mod("trace.scene_backward").SceneBackwardTargetTracer(
        batch,
        mod("camera").PointCamera(position=(0.0, 0.0, 0.0)),
        mod("light").UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        mod("response").HistogramHitResponse(nBins=50, t0=0.0, binSize=1.0),
        mod("random").PhiloxRNG(key=5),
        scene,
        maxPathLength=max_path,
        maxTime=float("inf"),
        **guide,
        **dev,
    )


def build_backward_glass(pkg, batch: int, device=None, *, mesh=None, flags: str = "T", response=None,
                         camera=(0.0, 0.0, 0.0), camera_medium: str = "glass", **kw):
    """``tests/test_grad_scene.py``'s ``test_backward_geometry_gradient_through_bounce``:
    a ``SceneBackwardTracer`` whose ``PointCamera`` sits at the centre of a
    glass ball (n = 1.8, radius 3, material flags ``flags``) in water (mu_a
    0.005, mu_s 0.05, HG g = 0.3), a spherical light (budget 1e6) at (8, 0,
    0), 450 nm, path length 4, 80 ns, no direct light (a point camera has
    none), ``PhiloxRNG(key=0x5EED)``; the response a ``KernelHistogramHitResponse``
    of 40 bins of 2 ns unless ``response`` is given, ``mesh`` default
    ``icosphere(2)``; ``camera`` and ``camera_medium`` move the camera (into
    the water: ``"water"``). ``kw`` goes to the tracer."""
    mod = _mod(pkg)
    material, scene_mod, light = mod("material"), mod("scene"), mod("light")
    dev = {} if device is None else {"device": device}
    glass = material.DispersionFreeMedium(n=1.8, ng=1.8, mu_a=0.0, mu_s=0.0).createMedium(name="glass")
    water = dataclasses.replace(_homogeneous(material, 0.005, 0.05, 0.3), name="water")
    store = material.MaterialStore.pack([material.Material("glass_water", glass, water, flags=flags)], **dev)
    meshes = scene_mod.MeshStore({"sphere": mod("mesh").Mesh.from_geometry(*(mesh or icosphere(2)))})
    inst = meshes.createInstance("sphere", "glass_water", scene_mod.Transform.TRS(scale=3.0))
    scene = scene_mod.Scene([inst], store, medium="water", accel=kw.pop("accel", "auto"), **dev)
    return mod("trace.scene_backward").SceneBackwardTracer(
        batch,
        light.SphericalLightSource(position=(8.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        mod("camera").PointCamera(position=camera),
        light.UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        response or mod("response").KernelHistogramHitResponse(nBins=40, t0=0.0, binSize=2.0),
        mod("random").PhiloxRNG(key=0x5EED),
        scene,
        medium=camera_medium,
        maxPathLength=kw.pop("max_path", 4),
        maxTime=80.0,
        disableDirectLighting=True,
        **kw,
        **dev,
    )


#: the scene backward and bidirectional runs' light (and camera centre),
#: camera radius, budget and start time
SCENE_CAMERA_POSITION, SCENE_CAMERA_RADIUS, SCENE_BUDGET, SCENE_T0 = (12.0, 15.0, 0.2), 100.0, 1e9, 10.0


def build_scene_backward(pkg, batch: int, device=None, *, mesh=None, max_path: int = 12, accel: str = "auto",
                         response=None, rng=None, **kw):
    """``tests/test_scene_backward.py``'s ``SceneBackwardTracer``: water of
    mu_a 0, mu_s 0.02, HG g = -0.4, n 1.33; a spherical light (budget 1e9,
    at 10 ns) at (12, 15, 0.2) inside a ``SphereCamera`` of radius -100;
    the scene a black sphere of radius 1 at (500, 0, 0) (``mesh``, default
    ``icosphere(3)``, replaces ``sphere.stl``), 450 nm, path length 12, no
    time limit, a ``HitRecorder``, ``PhiloxRNG(key=0xC0FFEE)``. ``kw`` goes
    to the tracer (``polarized``, ``disableDirectLighting``, ...)."""
    mod = _mod(pkg)
    material, scene_mod, light = mod("material"), mod("scene"), mod("light")
    dev = {} if device is None else {"device": device}
    medium = _homogeneous(material, 0.0, 0.02, -0.4)
    medium = dataclasses.replace(medium, name="water")
    store = material.MaterialStore.pack([material.Material("bb", None, medium, flags="B")], **dev)
    meshes = scene_mod.MeshStore({"sphere": mod("mesh").Mesh.from_geometry(*(mesh or icosphere(3)))})
    far = meshes.createInstance("sphere", "bb", scene_mod.Transform.TRS(scale=1.0, translate=(500.0, 0.0, 0.0)))
    scene = scene_mod.Scene([far], store, medium="water", accel=accel, **dev)
    return mod("trace.scene_backward").SceneBackwardTracer(
        batch,
        light.SphericalLightSource(position=SCENE_CAMERA_POSITION, timeRange=(SCENE_T0, SCENE_T0), budget=SCENE_BUDGET),
        mod("camera").SphereCamera(position=SCENE_CAMERA_POSITION, radius=-SCENE_CAMERA_RADIUS),
        light.UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        response or mod("response").HitRecorder(),
        rng(mod("random")) if rng else mod("random").PhiloxRNG(key=0xC0FFEE),
        scene,
        medium="water",
        maxPathLength=max_path,
        maxTime=float("inf"),
        **kw,
        **dev,
    )


def build_bidirectional(pkg, batch: int, device=None, *, mesh=None, path: int = 12, key: int = 61, response=None,
                        rng=None, **kw):
    """``tests/test_bidirectional.py``'s ``BidirectionalPathTracer``: water
    of mu_a 0, mu_s 0.02, HG g = 0.3, n 1.33 inside an absorbing detector
    (``"DB"``) sphere of radius 100 at (12, 15, 0.2) (``mesh``, default
    ``icosphere(3)``, replaces ``sphere.stl``), a spherical light (budget
    1e9, at 10 ns) at its centre, a ``SphereCamera`` of radius -99, 450 nm,
    light and camera paths of ``path`` segments, 60 bins of 80 ns,
    ``PhiloxRNG(key=key)``, no time limit. ``kw`` goes to the tracer."""
    mod = _mod(pkg)
    material, scene_mod, light = mod("material"), mod("scene"), mod("light")
    dev = {} if device is None else {"device": device}
    medium = dataclasses.replace(_homogeneous(material, 0.0, 0.02, 0.3), name="water")
    store = material.MaterialStore.pack([material.Material("det", medium, None, flags="DB")], **dev)
    meshes = scene_mod.MeshStore({"sphere": mod("mesh").Mesh.from_geometry(*(mesh or icosphere(3)))})
    T = scene_mod.Transform
    sphere = meshes.createInstance(
        "sphere", "det", T.TRS(scale=SCENE_CAMERA_RADIUS, translate=SCENE_CAMERA_POSITION)
    )
    scene = scene_mod.Scene([sphere], store, medium="water", **dev)
    return mod("trace.bidirectional").BidirectionalPathTracer(
        batch,
        light.SphericalLightSource(position=SCENE_CAMERA_POSITION, timeRange=(SCENE_T0, SCENE_T0), budget=SCENE_BUDGET),
        mod("camera").SphereCamera(position=SCENE_CAMERA_POSITION, radius=-0.99 * SCENE_CAMERA_RADIUS),
        light.UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        response or mod("response").HistogramHitResponse(nBins=60, t0=0.0, binSize=80.0),
        rng(mod("random")) if rng else mod("random").PhiloxRNG(key=key),
        scene,
        lightPathLength=path,
        cameraPathLength=path,
        maxTime=float("inf"),
        **kw,
        **dev,
    )


#: the muon of tests/test_muon_backward.py: 1 TeV from (0, 0, -5) to (0, 0, 5) m, its detector sphere
MUON_START, MUON_END, MUON_ENERGY = (0.0, 0.0, -5.0), (0.0, 0.0, 5.0), 1.0e3
MUON_DETECTOR, MUON_DETECTOR_RADIUS = (6.0, 0.0, 1.0), 1.0
#: tests/test_trace_backward.py's track: -50 -> 50 m on x at c, seen from a point camera at (0, 10, 0)
TRACK_X, TRACK_CAMERA = 50.0, (0.0, 10.0, 0.0)


def muon_source(pkg):
    """``tests/test_muon_backward.py``'s ``MuonTrackLightSource``: 1 TeV,
    ``MUON_START`` to ``MUON_END``, ``endTime`` = length / c."""
    u = importlib.import_module(f"{pkg.__name__}.units")
    length = float(np.linalg.norm(np.subtract(MUON_END, MUON_START)))
    return importlib.import_module(f"{pkg.__name__}.light").MuonTrackLightSource(
        startPosition=MUON_START, startTime=0.0, endPosition=MUON_END, endTime=length / u.speed_of_light,
        muonEnergy=MUON_ENERGY,
    )


def cascade_source(pkg):
    """The 1 TeV EM cascade of ``tests/test_light_sources.py``:
    ``createParamsFromParticle(Particle(E_MINUS, (0, 0, 0), (0, 0, 1),
    energy=1000.0))``, its class built on its parameters."""
    cascades = importlib.import_module(f"{pkg.__name__}.cascades")
    particle = cascades.Particle(cascades.ParticleType.E_MINUS, (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), energy=1000.0)
    cls, params, _ = cascades.createParamsFromParticle(particle, lightSourceName="")
    return cls(**params)


def build_cherenkov_volume(pkg, batch: int, device=None, *, source: str = "muon", **kw):
    """flagship-volume's ``VolumeForwardTracer`` (its water, wavelengths,
    histogram, generator and 10 scatterings) with a particle's light:
    ``source="muon"`` (:func:`muon_source`) or ``"cascade"``
    (:func:`cascade_source`), seen by ``tests/test_muon_backward.py``'s
    detector sphere of radius 1 at (6, 0, 1). ``kw`` goes to
    :func:`build_volume_flagship`."""
    make = {"muon": muon_source, "cascade": cascade_source}[source]
    target = importlib.import_module(f"{pkg.__name__}.target")
    return build_volume_flagship(
        pkg, batch, device, source=make(pkg),
        target=target.SphereTarget(position=MUON_DETECTOR, radius=MUON_DETECTOR_RADIUS), **kw,
    )


def track_line_source(pkg, kind: str, segments: int = 2):
    """The straight line of ``tests/test_trace_backward.py``'s
    ``test_track_backward_matches_simple_cherenkov`` (-50 -> 50 m on x,
    times x / c, photon counts): ``kind="track"`` as a ``ParticleTrack`` of
    ``segments`` equal segments (the test's 3 vertices at 2), ``"simple"``
    as a ``CherenkovLightSource``."""
    u = importlib.import_module(f"{pkg.__name__}.units")
    light = importlib.import_module(f"{pkg.__name__}.light")
    if kind == "simple":
        return light.CherenkovLightSource(
            trackStart=(-TRACK_X, 0.0, 0.0), trackEnd=(TRACK_X, 0.0, 0.0), startTime=-TRACK_X / u.c,
            endTime=TRACK_X / u.c, usePhotonCount=True,
        )
    x = np.linspace(-TRACK_X, TRACK_X, segments + 1)
    verts = np.stack([x, 0 * x, 0 * x, x / u.c], axis=1).astype(np.float32)
    return light.CherenkovTrackLightSource(light.ParticleTrack(verts), usePhotonCount=True)


def build_cherenkov_backward(pkg, batch: int, device=None, *, source, key: int = 3, **kw):
    """``tests/test_trace_backward.py``'s ``VolumeBackwardTracer`` of the
    track test: ``source`` (a light source of ``pkg``: the cascade of
    :func:`cascade_source`, a line of :func:`track_line_source`) seen by a
    ``PointCamera`` at (0, 10, 0) in ``WaterTestModel(mu_a=0.01, mu_s=0.03,
    g=0.4)``, 420-480 nm, 60 bins of 2 ns, 4 scatterings, 120 ns, direct
    lighting off, ``PhiloxRNG(key=3)``. ``kw`` goes to the tracer."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    dev = {} if device is None else {"device": device}
    return mod("trace.backward").VolumeBackwardTracer(
        batch, source, mod("camera").PointCamera(position=TRACK_CAMERA),
        mod("light").UniformWavelengthSource(lambdaRange=(420.0, 480.0)),
        kw.pop("response", None) or mod("response").HistogramHitResponse(nBins=60, t0=0.0, binSize=2.0),
        mod("random").PhiloxRNG(key=key), medium=mod("testing").WaterTestModel(mu_a=0.01, mu_s=0.03, g=0.4).createMedium(),
        nScattering=kw.pop("nScattering", 4), maxTime=120.0, disableDirectLighting=True, **kw, **dev,
    )


def build_photon_flagship(pkg, mesh, batch: int, device=None, **kw):
    """``ScenePhotonTracer`` on the flagship's scene with no ``accel``
    named (the brute-force default), with
    ``__graft_entry__._dryrun_photon_compacted``'s settings: the source at
    (3, 0, 0) over 0-10 ns with budget 1e5, 300-700 nm, 50 bins of 10 ns,
    ``PhiloxRNG(key=7)``, 2 scatterings a run, 3 runs, the source in
    vacuum, scatter coefficient 0.05, target id 1. ``kw`` goes to the
    tracer (the response as ``response=``, a function of the package's
    ``random`` module as ``rng=``)."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    light, rnd, response = mod("light"), mod("random"), mod("response")
    rng = kw.pop("rng", None)
    dev = {} if device is None else {"device": device}
    scene = build_flagship(pkg, mesh, 1, 2, accel="auto", device=device).scene
    resp = kw.pop("response", None) or response.HistogramHitResponse(nBins=50, t0=0.0, binSize=10.0)
    return mod("trace.photon").ScenePhotonTracer(
        batch,
        light.SphericalLightSource(position=(3.0, 0.0, 0.0), timeRange=(0.0, 10.0), budget=1e5),
        light.UniformWavelengthSource(lambdaRange=(300.0, 700.0)),
        resp,
        rng(rnd) if rng else rnd.PhiloxRNG(key=7),
        scene,
        nScatteringPerRun=2,
        nRuns=3,
        sourceMedium="vacuum",
        scatterCoefficient=0.05,
        targetId=1,
        **kw,
        **dev,
    )


def array_scene(pkg, accel: str, *, n_side: int = 3, mixed: bool = False, scale: float = 1.0, device=None):
    """``tests/test_instanced.py``'s ``array_scene`` in package ``pkg`` on
    in-code meshes: an ``n_side``^3 grid of ``icosphere(2)`` spheres of
    radius 0.4 ``scale``, 2 ``scale`` apart, and with ``mixed`` a second
    prototype (``icosphere(1)`` of radius 0.8 ``scale``, where the JAX test
    has suzanne) at (-3 ``scale``, 0, 0); one black material, no medium."""
    dev = {} if device is None else {"device": device}
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    material, scene_mod = mod("material"), mod("scene")
    mats = material.MaterialStore.pack([material.Material("m", None, None, flags="B")], **dev)
    Mesh = mod("mesh").Mesh
    meshes = scene_mod.MeshStore({"sphere": Mesh.from_geometry(*icosphere(2)), "other": Mesh.from_geometry(*icosphere(1))})
    T = scene_mod.Transform
    insts = [
        meshes.createInstance("sphere", "m", T.TRS(scale=0.4 * scale, translate=(2.0 * scale * i, 2.0 * scale * j, 2.0 * scale * k)))
        for i in range(n_side) for j in range(n_side) for k in range(n_side)
    ]
    if mixed:
        insts.append(meshes.createInstance("other", "m", T.TRS(scale=0.8 * scale, translate=(-3.0 * scale, 0.0, 0.0))))
    return scene_mod.Scene(insts, mats, medium=None, accel=accel, **dev)


#: the tie scenes of :func:`tie_scene`
TIE_KINDS = ("duplicated rows", "coincident instances")


def tie_scene(pkg, accel: str, kind: str, *, device=None):
    """A scene whose hits tie exactly, in package ``pkg``: a 2 x 2 x 2
    grid of ``icosphere(2)`` spheres of radius 0.4, 2 apart around the
    origin (:func:`array_rays` with ``n_side=2`` aims at them), and
    - ``"duplicated rows"``: every triangle of the prototype twice, in
      neighbouring rows (ties inside a candidate and inside a leaf);
    - ``"coincident instances"``: a ninth instance placed exactly on the
      first (ties across candidates, and across leaves)."""
    dev = {} if device is None else {"device": device}
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    material, scene_mod = mod("material"), mod("scene")
    mats = material.MaterialStore.pack([material.Material("m", None, None, flags="B")], **dev)
    pos, faces = icosphere(2)
    if kind == "duplicated rows":
        faces = np.repeat(faces, 2, axis=0)
    elif kind != "coincident instances":
        raise ValueError(f"kind must be one of {TIE_KINDS}, not {kind!r}")
    meshes = scene_mod.MeshStore({"sphere": mod("mesh").Mesh.from_geometry(pos, faces)})
    T = scene_mod.Transform
    places = [(2.0 * i - 1.0, 2.0 * j - 1.0, 2.0 * k - 1.0) for i in range(2) for j in range(2) for k in range(2)]
    if kind == "coincident instances":
        places.append(places[0])
    insts = [meshes.createInstance("sphere", "m", T.TRS(scale=0.4, translate=p)) for p in places]
    return scene_mod.Scene(insts, mats, medium=None, accel=accel, **dev)


#: the walks' t against theia_tpu's (tests/test_torch_brute.py's limits)
T_ULPS, T_RTOL = 4, 3e-4


def _ulps(a, b):
    """Distance in float32 steps."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def assert_winners_match(t, idx, jt, jidx, hit_share=0.999, same_share=0.995):
    """A walk's (t, idx) against ``theia_tpu``'s (jt, jidx), as
    tests/test_torch_bvh.py's tolerance (b) states: hit or miss the same on
    ``hit_share`` of the lanes, the same winner on ``same_share`` of those
    both hit, t within T_ULPS ulps on 90 % of them and T_RTOL on all."""
    t, idx, jt, jidx = (np.asarray(a) for a in (t, idx, jt, jidx))
    hit, jhit = idx >= 0, jidx >= 0
    assert jhit.any() and (~jhit).any()
    assert (hit == jhit).mean() >= hit_share, (hit == jhit).mean()
    both = hit & jhit
    assert (idx[both] == jidx[both]).mean() >= same_share
    same = both & (idx == jidx)
    assert np.percentile(_ulps(t[same], jt[same]), 90) <= T_ULPS
    np.testing.assert_allclose(t[same], jt[same], rtol=T_RTOL, atol=0.0)


def uniform_rays(n: int, seed: int, lo: float = -4.0, hi: float = 7.0):
    """Rays with origins uniform in the cube [lo, hi)^3 and isotropic unit
    directions, numpy float32, from ``seed``: ``tests/test_instanced.py``'s
    ``random_rays`` drawn with numpy."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


#: example 08's lattice: 3 x 3 x 3 places 2 m apart, the centre left free
ARRAY_SIDE, ARRAY_SPACING = 3, 2.0


def array_transforms(n_side: int = ARRAY_SIDE, spacing: float = ARRAY_SPACING, pkg=None):
    """The translations of ``examples/08_detector_array.py``'s lattice:
    ``n_side``^3 places ``spacing`` apart around the origin, the centre
    left free for the flash where there is one (26 for 3 x 3 x 3, 1 for
    1 x 1 x 1), as ``pkg.scene.Transform``s."""
    T = importlib.import_module(f"{pkg.__name__}.scene").Transform
    c = (n_side - 1) / 2.0
    return [
        T.TRS(translate=((i - c) * spacing, (j - c) * spacing, (k - c) * spacing))
        for i in range(n_side) for j in range(n_side) for k in range(n_side)
        if not (n_side % 2 == 1 and n_side > 1 and i == j == k == (n_side - 1) // 2)
    ]


def build_array(
    pkg, mesh, batch: int, max_path: int = 8, accel: str = "auto", device=None, *, response=None,
    n_side: int = ARRAY_SIDE, scale: float = 0.35, key: int = 0xA11CE, binned: bool = False,
):
    """``examples/08_detector_array.py``'s tracer of ``pkg``: BK7-shelled
    detector modules (flags ``"DB"``, the sphere ``mesh`` at ``scale`` m)
    stamped by ``render.SceneTemplate`` across :func:`array_transforms`,
    in water at 10 degC and 35 PSU with HG g = 0.9 on 64 x 64 tables
    (glass 64 x 4), a flash at the origin (budget 1e9), 400-500 nm,
    ``PhiloxRNG(key=0xA11CE)``, no target guide, path length 8, 120 ns, a
    ``HitRecorder`` (``response`` replaces it). 26 modules of
    ``icosphere(3)`` are 33,280 triangles and ``accel="auto"`` resolves to
    ``"instanced"``; 26 of ``icosphere(2)`` are 8,320, still past the
    threshold. ``binned=True`` (``theia_tpu_torch`` only) builds the scene
    with ``binned=True``: the ``mt`` and ``woop`` queries sort their rays."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    u, light, material, rnd, scene_mod = mod("units"), mod("light"), mod("material"), mod("random"), mod("scene")
    dev = {} if device is None else {"device": device}
    water = water_medium(material, num_lambda=64, num_theta=64)
    glass = material.BK7Model().createMedium(num_lambda=64, num_theta=4)
    mats = material.MaterialStore.pack([material.Material("det_shell", glass, water, flags="DB")], **dev)
    meshes = scene_mod.MeshStore({"sphere": mod("mesh").Mesh.from_geometry(*mesh)})
    proto = meshes.createInstance("sphere", "det_shell", scene_mod.Transform.TRS(scale=scale * u.m))
    template = mod("render").SceneTemplate([proto])
    scene = template.createScene(array_transforms(n_side, pkg=pkg), mats, medium="water", accel=accel, **dev,
                                 **({"binned": True} if binned else {}))
    return mod("trace.scene").SceneForwardTracer(
        batch,
        light.SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        light.UniformWavelengthSource(lambdaRange=(400.0 * u.nm, 500.0 * u.nm)),
        response or mod("response").HitRecorder(),
        rnd.PhiloxRNG(key=key),
        scene,
        maxPathLength=max_path,
        maxTime=120.0 * u.ns,
        **dev,
    )


def array_rays(n: int, seed: int, n_side: int = ARRAY_SIDE, spacing: float = ARRAY_SPACING):
    """Random rays (numpy float32 origin, unit direction and t_max) in and
    around the lattice: origins spread over the lattice's box and 1 m
    beyond, half of the directions aimed at a random module's centre, a
    mix of finite and infinite t_max."""
    rng = np.random.default_rng(seed)
    reach = (n_side - 1) / 2.0 * spacing + 1.0
    o = rng.uniform(-reach, reach, size=(n, 3))
    grid = np.asarray([t for t in np.ndindex(n_side, n_side, n_side)], np.float64)
    aim = (grid[rng.integers(0, len(grid), n)] - (n_side - 1) / 2.0) * spacing + rng.normal(scale=0.3, size=(n, 3))
    d = np.where(rng.uniform(size=(n, 1)) < 0.5, aim - o, rng.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0.5, 4.0 * reach, size=n), np.inf)
    return o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)


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


def build_grad_scene(pkg, kind: str, batch: int, device=None, *, mesh=None, max_path=None, accel="brute"):
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

    ``max_path`` replaces the path length; ``accel`` the backend of
    ``"source"`` and ``"detector"`` (``"instanced"`` is the JAX test's). Scene
    media keep the names the tests patch: ``homogenous``, ``water_test``, ``water`` and ``bk7``."""
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
        scene = scene_mod.Scene(insts, mats, medium="water_test", accel=accel, **dev)
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


# -- mesh files: written here, loaded by the packages' loaders --------------


def triangles32(mesh) -> np.ndarray:
    """The (T, 3, 3) float32 corners of ``mesh`` = (positions, faces)."""
    pos, faces = mesh
    return np.asarray(pos, np.float64)[np.asarray(faces)].astype(np.float32)


def write_stl(path, mesh, ascii: bool = False) -> np.ndarray:
    """Write ``mesh``'s triangles as a binary (or ASCII) STL file; returns
    the float32 corners written. ASCII writes each float with
    ``repr``, which reads back to the same float32."""
    tri = triangles32(mesh)
    if ascii:
        lines = ["solid written"]
        for t in tri:
            lines += ["facet normal 0 0 0", "outer loop"]
            lines += [f"vertex {float(x)!r} {float(y)!r} {float(z)!r}" for x, y, z in t]
            lines += ["endloop", "endfacet"]
        Path(path).write_text("\n".join(lines + ["endsolid written", ""]))
        return tri
    rec = np.zeros(len(tri), np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")]))
    rec["v"] = tri
    Path(path).write_bytes(b"binary STL".ljust(80, b" ") + struct.pack("<I", len(tri)) + rec.tobytes())
    return tri


def write_ply(path, mesh, binary: bool = False, quads: bool = False) -> None:
    """Write ``mesh`` = (positions, faces) as a PLY file (ASCII, or binary
    little-endian with float32 positions and int32 indices); ``quads``
    joins neighbouring triangle pairs (a, b, c), (a, c, d) into quads
    where the faces come in such pairs, which the loader fans back."""
    pos = np.asarray(mesh[0], np.float32)
    faces = [list(f) for f in np.asarray(mesh[1])]
    if quads:
        faces = [f + [g[2]] if (f[0], f[2]) == (g[0], g[1]) else None for f, g in zip(faces[::2], faces[1::2])]
        assert all(f is not None for f in faces), "faces do not come in quad pairs"
    head = [
        "ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0", f"element vertex {len(pos)}",
        "property float x", "property float y", "property float z", f"element face {len(faces)}",
        "property list uchar int vertex_indices", "end_header",
    ]
    if binary:
        body = pos.astype("<f4").tobytes() + b"".join(
            struct.pack("<B", len(f)) + np.asarray(f, "<i4").tobytes() for f in faces
        )
        Path(path).write_bytes(("\n".join(head) + "\n").encode() + body)
        return
    rows = [" ".join(repr(float(x)) for x in p) for p in pos] + [" ".join(map(str, [len(f), *f])) for f in faces]
    Path(path).write_text("\n".join(head + rows) + "\n")


def write_obj(path, objects) -> None:
    """Write ``objects``, (name, material, positions, faces) tuples, as one
    OBJ file with an ``o`` and a ``usemtl`` line each and 1-based indices
    (the second object's indices negative, relative to its own vertices,
    to cover the loader's relative form); faces of four indices are quads."""
    lines, base = ["# written by the port's tests"], 0
    for k, (name, material, pos, faces) in enumerate(objects):
        lines.append(f"o {name}")
        if material is not None:
            lines.append(f"usemtl {material}")
        pos = np.asarray(pos, np.float32)
        lines += [f"v {float(x)!r} {float(y)!r} {float(z)!r}" for x, y, z in pos]
        for f in np.asarray(faces):
            idx = [int(i) - len(pos) if k == 1 else int(i) + base + 1 for i in f]
            lines.append("f " + " ".join(f"{i}/{i}" if j == 0 else str(i) for j, i in enumerate(idx)))
        base += len(pos)
    Path(path).write_text("\n".join(lines) + "\n")


def array_obj(path, mesh, scale: float = 0.35) -> None:
    """Example 08's module as an OBJ template file: one sphere of radius
    ``scale`` m, named ``module`` and tagged with material ``det_shell``."""
    pos, faces = mesh
    write_obj(path, [("module", "det_shell", np.asarray(pos) * scale, faces)])


def build_array_from_template(pkg, template, batch: int, max_path: int = 8, accel: str = "auto", device=None, *,
                              response=None, n_side: int = ARRAY_SIDE, key: int = 0xA11CE):
    """:func:`build_array`'s tracer on a scene that ``template`` (a
    ``render.SceneTemplate`` whose instances use material ``det_shell``)
    stamps across :func:`array_transforms`."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    u, light, material, rnd = mod("units"), mod("light"), mod("material"), mod("random")
    dev = {} if device is None else {"device": device}
    water = water_medium(material, num_lambda=64, num_theta=64)
    glass = material.BK7Model().createMedium(num_lambda=64, num_theta=4)
    mats = material.MaterialStore.pack([material.Material("det_shell", glass, water, flags="DB")], **dev)
    scene = template.createScene(array_transforms(n_side, pkg=pkg), mats, medium="water", accel=accel, **dev)
    return mod("trace.scene").SceneForwardTracer(
        batch,
        light.SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        light.UniformWavelengthSource(lambdaRange=(400.0 * u.nm, 500.0 * u.nm)),
        response or mod("response").HitRecorder(),
        rnd.PhiloxRNG(key=key),
        scene,
        maxPathLength=max_path,
        maxTime=120.0 * u.ns,
        **dev,
    )


def build_example03(pkg, batch: int, n_scattering: int = 8, device=None):
    """``examples/03_multiple_lightsources.py``'s two tracers of ``pkg``:
    the flash (a spherical source at (-1, -7, 0), budget 1e9, key 0xAAAA)
    and the beam (a cone from (8, 0, 0) toward -x, opening cosine 0.9, at
    50 ns, budget 5e8, key 0xBBBB), each a ``VolumeForwardTracer`` in water
    at 10 degC and 35 PSU with HG g = 0.9 toward a 5 m sphere, 400-500 nm,
    ``n_scattering`` scatterings, 500 ns, sharing one 100-bin histogram of
    5 ns. Returns (flash, beam)."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    light, rnd, target = mod("light"), mod("random"), mod("target")
    dev = {} if device is None else {"device": device}
    water = water_medium(mod("material"))
    response = mod("response").HistogramHitResponse(nBins=100, binSize=5.0, t0=0.0)

    def tracer(source, key):
        return mod("trace.volume").VolumeForwardTracer(
            batch, source, target.SphereTarget(position=(0.0, 0.0, 0.0), radius=5.0),
            light.UniformWavelengthSource(lambdaRange=(400.0, 500.0)), response, rnd.PhiloxRNG(key=key),
            medium=water, nScattering=n_scattering, maxTime=500.0, **dev,
        )

    flash = tracer(light.SphericalLightSource(position=(-1.0, -7.0, 0.0), timeRange=(0.0, 0.0), budget=1e9), 0xAAAA)
    beam = tracer(light.ConeLightSource(position=(8.0, 0.0, 0.0), direction=(-1.0, 0.0, 0.0), cosOpeningAngle=0.9,
                                        timeRange=(50.0, 50.0), budget=5e8), 0xBBBB)
    return flash, beam


#: tests/test_material.py's Fournier-Forand parameters (n, mu) and
#: tests/test_polarized_backward.py's Kokhanovsky phase matrix
FF_PARAMETERS = (1.175, 4.065)
KOKHANOVSKY = dict(p90=0.66, theta0=0.25, alpha=4.0, xi=25.6)


def ff_water_medium(material, **sizes):
    """The flagship's water (10 degC, 35 PSU) with the Fournier-Forand
    phase function of ``FF_PARAMETERS`` in Henyey-Greenstein's place."""

    class FFWater(material.WaterBaseModel, material.FournierForandPhaseFunction, material.MediumModel):
        ModelName = "ff_water"

        def __init__(self):
            material.WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
            material.FournierForandPhaseFunction.__init__(self, *FF_PARAMETERS)

    return FFWater().createMedium(**sizes)


def pol_water_medium(material):
    """tests/test_polarized_backward.py's ``PolWater``: the water with HG
    g = 0.4 and the Kokhanovsky ocean-water phase matrix."""

    class PolWater(material.WaterBaseModel, material.HenyeyGreensteinPhaseFunction,
                   material.KokhanovskyOceanWaterPhaseMatrix, material.MediumModel):
        def __init__(self):
            material.WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
            material.HenyeyGreensteinPhaseFunction.__init__(self, 0.4)
            material.KokhanovskyOceanWaterPhaseMatrix.__init__(self, **KOKHANOVSKY)

    return PolWater().createMedium(name="pol_water")


def build_pol_backward(pkg, batch: int, device=None, **kw):
    """tests/test_polarized_backward.py's polarized ``VolumeBackwardTracer``
    (its ``run``): a spherical light (budget 1e9) at the origin, a 5 m
    ``SphereCamera`` at (20, 0, 0), 450 nm, ``PolWater``, 8 scatterings,
    250 ns, a 50-bin histogram of 5 ns, ``PhiloxRNG(key=0xD00D)``. ``kw``
    goes to the tracer (``polarized``, ``medium``, ``response``,
    ``nScattering``)."""
    mod = lambda name: importlib.import_module(f"{pkg.__name__}.{name}")
    light = mod("light")
    dev = {} if device is None else {"device": device}
    return mod("trace.backward").VolumeBackwardTracer(
        batch,
        light.SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        mod("camera").SphereCamera(position=(20.0, 0.0, 0.0), radius=5.0),
        light.UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        kw.pop("response", None) or mod("response").HistogramHitResponse(nBins=50, binSize=5.0, t0=0.0),
        mod("random").PhiloxRNG(key=0xD00D),
        medium=kw.pop("medium", None) or pol_water_medium(mod("material")),
        nScattering=kw.pop("nScattering", 8),
        maxTime=250.0,
        polarized=kw.pop("polarized", True),
        **kw,
        **dev,
    )


def jax_record_sums(monkeypatch) -> list:
    """Have ``theia_tpu``'s ``HistogramHitResponse.record`` hand, beside
    its own float32 record, the float64 sums by flat bin of the values it
    records (its kept lanes, by its own bins) to the list returned, one
    array a record (a ``jax.debug.callback``): what ``theia_tpu`` recorded,
    free of the order its sum takes. A test holds the port's recorded
    values against these, and the port's records against its own exact
    sums, each at the tolerance it held."""
    import jax
    import jax.numpy as jnp

    response = importlib.import_module("theia_tpu.response")
    record, sums = response.HistogramHitResponse.record, []

    def recorded(self, params, state, item, mask, rng):
        value, _ = self.value_response.value(params.get("value", {}), item, rng)
        bin_f = jnp.floor((jax.lax.stop_gradient(item.time) - params["t0"]) / params["binSize"])
        oob = (bin_f < 0) | (bin_f >= self.nBins) | ~mask
        bins, size = self._flat_bins(item, bin_f.astype(jnp.int32), oob), self._size()

        def collect(v, b):
            keep = np.asarray(b) < size
            sums.append(np.bincount(np.asarray(b)[keep], np.asarray(v, np.float64)[keep], minlength=size))

        jax.debug.callback(collect, jax.lax.stop_gradient(value), bins)
        return record(self, params, state, item, mask, rng)

    monkeypatch.setattr(response.HistogramHitResponse, "record", recorded)
    return sums


@contextlib.contextmanager
def eager_route(*tracers):
    """Inside the block, every batch of the ``SceneForwardTracer``s
    ``tracers`` (``run()``, a ``Pipeline``'s, ``_trace_batch``) takes the
    eager segment (``_trace_batch_eager``), whatever ``segment_route``
    says: the route that the staged one is held against."""
    for tracer in tracers:
        tracer._trace_batch = tracer._trace_batch_eager
    try:
        yield
    finally:
        for tracer in tracers:
            del tracer._trace_batch
