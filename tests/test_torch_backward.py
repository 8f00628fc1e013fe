"""The port's camera tracers against the live ``theia_tpu`` on the CPU:
``VolumeBackwardTracer`` unpolarized (``tests/test_trace_backward.py``'s
energy configuration: a spherical light inside an inward sphere camera of
100 m) and polarized (``tests/test_polarized_backward.py``'s ocean water
with Kokhanovsky's phase matrix, and its polarized cone light through the
direct connection), ``DirectLightTracer`` without a scene
(``test_direct_tracer_analytic``'s absorbing medium) and with a small
in-code scene (the flagship's shells between the light and the camera,
the connections tested with ``accel.is_visible``), at batch 2048-4096 on
the same parameters and streams; then the direct tracer's closed form.

Tolerances and why:
(a) histograms: sum within rtol 1e-4 and every bin within 1e-4 of the
    largest bin. The two packages do the same float32 operations lane by
    lane, but the light connections weight a lane by 1/d^2 and by
    exp(-mu d), which carry the ulps of XLA's and torch's sqrt, exp and
    trigonometric functions (measured: 4.6e-6 of the sum, 1.8e-5 of the
    largest bin on the energy configuration).
(b) recorded hits (``HitRecorder``): the same slots valid; times within
    1e-5 relative, contributions within 1e-4 relative or 1e-6 of the
    largest (measured on the polarized run: one hit of 998 at 6.6e-4
    relative, 1e-11 of the largest, its Mueller chain through ulps of
    the phase matrix's reads), Stokes vectors within 1e-4 absolute.
(c) the direct tracer's total within 5 % of its closed form and its peak
    within a bin of the arrival time (``test_direct_tracer_analytic``'s
    own limits) at its 4 x 32,768 samples.
The tracers' RNG dims cannot be read from ``theia_tpu``'s backward and
direct tracers (they have no debug hook), so lanes are compared by their
results alone.
"""

import importlib

import numpy as np
import pytest
import torch

import jax

import theia_tpu
import theia_tpu_torch
from theia_tpu_torch.interop import params_from_numpy
from torch_flagship import build_flagship, icosphere, numpy_tree

torch.set_num_threads(1)

LIGHT_POS, CAM_POS, T0, BUDGET = (0.0, 0.0, 0.0), (8.0, 0.0, 0.0), 10.0, 1e9


def mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def medium_model(pkg, mu_a, mu_s, g):
    mat = mod(pkg, "material")

    class Model(mat.DispersionFreeMedium, mat.HenyeyGreensteinPhaseFunction, mat.MediumModel):
        ModelName = "homogenous"

        def __init__(self):
            mat.DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=mu_a, mu_s=mu_s)
            mat.HenyeyGreensteinPhaseFunction.__init__(self, g)

    return Model().createMedium()


def pol_water():
    """``tests/test_polarized_backward.py``'s ocean water (theia_tpu's
    Kokhanovsky phase matrix, not yet in the port) as the port's Medium."""
    mat = theia_tpu.material

    class PolWater(mat.WaterBaseModel, mat.HenyeyGreensteinPhaseFunction,
                   mat.KokhanovskyOceanWaterPhaseMatrix, mat.MediumModel):
        def __init__(self):
            mat.WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
            mat.HenyeyGreensteinPhaseFunction.__init__(self, 0.4)
            mat.KokhanovskyOceanWaterPhaseMatrix.__init__(self, p90=0.66, theta0=0.25, alpha=4.0, xi=25.6)

    jax_medium = PolWater().createMedium(name="pol_water")
    return jax_medium, params_from_numpy({"medium": numpy_tree(jax_medium)}, "cpu")["medium"]


def energy_tracer(pkg, batch, **kw):
    """test_backward_energy_conservation's tracer (30 scatterings there)."""
    dev = {} if pkg is theia_tpu else {"device": "cpu"}
    position, radius = (12.0, 15.0, 0.2), 100.0
    return mod(pkg, "trace.backward").VolumeBackwardTracer(
        batch,
        mod(pkg, "light").SphericalLightSource(position=position, timeRange=(T0, T0), budget=BUDGET),
        mod(pkg, "camera").SphereCamera(position=position, radius=-radius),
        mod(pkg, "light").UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        kw.pop("response", None) or mod(pkg, "response").HistogramHitResponse(nBins=100, t0=0.0, binSize=100.0),
        mod(pkg, "random").PhiloxRNG(key=0xC0FFEE),
        medium=kw.pop("medium", None) or medium_model(pkg, 0.0, 0.02, -0.4),
        nScattering=kw.pop("nScattering", 8),
        target=mod(pkg, "target").InnerSphereTarget(position=position, radius=radius * 1.001),
        maxTime=float("inf"),
        **kw,
        **dev,
    )


def pol_tracer(pkg, medium, response, **kw):
    """test_polarized_backward.py's run() at batch 2048."""
    dev = {} if pkg is theia_tpu else {"device": "cpu"}
    return mod(pkg, "trace.backward").VolumeBackwardTracer(
        2048,
        kw.pop("source", None) or mod(pkg, "light").SphericalLightSource(timeRange=(0.0, 0.0), budget=1e9),
        mod(pkg, "camera").SphereCamera(position=(20.0, 0.0, 0.0), radius=kw.pop("radius", 5.0)),
        mod(pkg, "light").UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        response,
        mod(pkg, "random").PhiloxRNG(key=kw.pop("key", 0xD00D)),
        medium=medium,
        nScattering=kw.pop("nScattering", 8),
        maxTime=250.0,
        polarized=True,
        **kw,
        **dev,
    )


def direct_tracer(pkg, batch, scene=None, **kw):
    """test_direct_tracer_analytic's tracer: a sphere camera of radius 1
    at 8 m in a purely absorbing medium (mu_a 0.02)."""
    dev = {} if pkg is theia_tpu else {"device": "cpu"}
    extra = {"scene": scene} if scene is not None else {"medium": medium_model(pkg, 0.02, 0.0, 0.0)}
    return mod(pkg, "trace.direct").DirectLightTracer(
        batch,
        mod(pkg, "light").SphericalLightSource(position=kw.pop("light", LIGHT_POS), timeRange=(T0, T0), budget=BUDGET),
        mod(pkg, "camera").SphereCamera(position=kw.pop("camera", CAM_POS), radius=kw.pop("radius", 1.0)),
        mod(pkg, "light").UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        mod(pkg, "response").HistogramHitResponse(nBins=60, t0=0.0, binSize=10.0),
        mod(pkg, "random").PhiloxRNG(key=0xC0FFEE),
        **extra,
        **kw,
        **dev,
    )


def trace_both(jt, tt):
    """One batch of each tracer, the port's on the JAX tracer's parameters
    carried over; returns (JAX result, port result) as numpy."""
    p = jt.params()
    js, _ = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    tp = params_from_numpy(numpy_tree(p), "cpu")
    with torch.no_grad():
        ts, _ = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    j, t = jt.response.result(p["response"], js), tt.response.result(tp["response"], ts)
    if isinstance(j, dict):
        return {k: np.asarray(v) for k, v in j.items()}, {k: v.numpy() for k, v in t.items()}
    return np.asarray(j, np.float64), t.double().numpy()


def assert_hist_agree(jh, th):
    assert jh.sum() > 0 and np.isfinite(th).all()
    assert abs(th.sum() / jh.sum() - 1.0) <= 1e-4, th.sum() / jh.sum() - 1.0
    assert np.abs(th - jh).max() <= 1e-4 * jh.max(), np.abs(th - jh).max() / jh.max()


def assert_hits_agree(j, t, least):
    """The recorders fill their slots in the same order in both packages."""
    valid = j["valid"]
    np.testing.assert_array_equal(t["valid"], valid)
    assert valid.sum() >= least, valid.sum()
    np.testing.assert_allclose(t["time"][valid], j["time"][valid], rtol=1e-5)
    contrib = j["contrib"][valid]
    np.testing.assert_allclose(t["contrib"][valid], contrib, rtol=1e-4, atol=1e-6 * np.abs(contrib).max())
    if "stokes" in j:
        np.testing.assert_allclose(t["stokes"][valid], j["stokes"][valid], atol=1e-4)


def test_accounting_matches_jax():
    pairs = [(energy_tracer(pkg, 256), ) for pkg in (theia_tpu, theia_tpu_torch)]
    pairs += [(direct_tracer(pkg, 256), ) for pkg in (theia_tpu, theia_tpu_torch)]
    for (j,), (t,) in (pairs[0:2], pairs[2:4]):
        assert (j.nRNGSamples, j.maxHitsPerThread, j.rng.autoAdvance) == (t.nRNGSamples, t.maxHitsPerThread, t.rng.autoAdvance)


def test_volume_backward_matches_jax():
    jh, th = trace_both(energy_tracer(theia_tpu, 2048), energy_tracer(theia_tpu_torch, 2048))
    assert_hist_agree(jh, th)


def test_volume_backward_polarized_matches_jax():
    """The Mueller chain of ocean water's phase matrix, recorded with its
    Stokes vectors; and the same tracer's light curve."""
    jax_medium, medium = pol_water()
    rec = lambda pkg: mod(pkg, "response").HitRecorder(polarized=True)
    j, t = trace_both(pol_tracer(theia_tpu, jax_medium, rec(theia_tpu)), pol_tracer(theia_tpu_torch, medium, rec(theia_tpu_torch)))
    assert_hits_agree(j, t, 500)
    hist = lambda pkg: mod(pkg, "response").HistogramHitResponse(nBins=50, binSize=5.0, t0=0.0)
    jh, th = trace_both(pol_tracer(theia_tpu, jax_medium, hist(theia_tpu)), pol_tracer(theia_tpu_torch, medium, hist(theia_tpu_torch)))
    assert_hist_agree(jh, th)


def test_polarized_cone_light_direct_matches_jax():
    """test_polarized_cone_light_direct: a fully Q-polarized cone light
    through the direct connection alone (nScattering=1)."""
    out = []
    for pkg in (theia_tpu, theia_tpu_torch):
        light = mod(pkg, "light").ConeLightSource(
            position=(0.0, 0.0, 0.0), direction=(1.0, 0.0, 0.0), cosOpeningAngle=0.8, timeRange=(0.0, 0.0),
            budget=1e6, stokes=(1.0, 1.0, 0.0, 0.0), polarizationRef=(0.0, 0.0, 1.0),
        )
        medium = medium_model(pkg, 0.0, 1e-6, 0.0)
        out.append(pol_tracer(pkg, medium, mod(pkg, "response").HitRecorder(polarized=True), source=light,
                              radius=2.0, key=0xFACE, nScattering=1))
    j, t = trace_both(*out)
    assert_hits_agree(j, t, 100)
    dop = np.sqrt((t["stokes"][t["valid"]][:, 1:] ** 2).sum(-1))
    assert np.abs(dop - 1.0).max() < 1e-4


def test_camera_without_frames_raises_when_polarized():
    n = 256
    cam = theia_tpu_torch.camera.HostCamera(
        position=np.zeros((n, 3)) + (5.0, 0.0, 0.0), direction=np.tile([-1.0, 0.0, 0.0], (n, 1)),
        contrib=np.ones(n), timeDelta=np.zeros(n), hitPosition=np.zeros((n, 3)),
        hitDirection=np.tile([1.0, 0.0, 0.0], (n, 1)), hitNormal=np.tile([-1.0, 0.0, 0.0], (n, 1)),
    )
    P = theia_tpu_torch
    tracer = P.trace.VolumeBackwardTracer(
        n, P.light.SphericalLightSource(timeRange=(0.0, 0.0)), cam,
        P.light.UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        P.response.HistogramHitResponse(nBins=10, binSize=10.0, t0=0.0), P.random.PhiloxRNG(key=1),
        medium=medium_model(P, 0.0, 0.01, 0.0), nScattering=4, polarized=True, disableDirectLighting=True,
        device="cpu",
    )
    with pytest.raises(ValueError, match="polarization frames"):
        tracer.run()
    with pytest.raises(ValueError, match="direct mode"):
        P.trace.VolumeBackwardTracer(
            n, P.light.SphericalLightSource(), cam, P.light.ConstWavelengthSource(450.0),
            P.response.HistogramHitResponse(nBins=10, binSize=10.0), P.random.PhiloxRNG(key=1),
            medium=None, device="cpu",
        )


def test_direct_tracer_matches_jax():
    jt, tt = direct_tracer(theia_tpu, 4096), direct_tracer(theia_tpu_torch, 4096)
    assert_hist_agree(*trace_both(jt, tt))
    jt.run(), tt.run()
    assert jt.rng.offset == tt.rng.offset == jt.nRNGSamples
    assert_hist_agree(*trace_both(jt, tt))


def test_direct_tracer_with_scene_matches_jax():
    """The flagship's brute-force scene (two glass shells at (3, 0, 0) and
    a detector sphere at (0, 3, 0)) between a light at (6, 0.3, 0) and a
    sphere camera at (0, -2, 0): the shells' rim hides part of the camera."""
    mesh = icosphere(2)
    kw = dict(light=(6.0, 0.3, 0.0), camera=(0.0, -2.0, 0.0), radius=0.5)
    jt = direct_tracer(theia_tpu, 4096, build_flagship(theia_tpu, mesh, 1, 2, accel="auto").scene, **kw)
    scene = build_flagship(theia_tpu_torch, mesh, 1, 2, accel="auto", device="cpu").scene
    assert scene.accel == "brute"
    tt = direct_tracer(theia_tpu_torch, 4096, scene, **kw)
    jh, th = trace_both(jt, tt)
    assert_hist_agree(jh, th)
    open_h = direct_tracer(theia_tpu_torch, 4096, None, **kw).run()[0].double().numpy()
    assert 0.05 < th.sum() / open_h.sum() < 0.95  # the shells hide a part, not all


def test_direct_tracer_analytic():
    """Lambertian sphere camera of radius r at distance d in an absorbing
    medium: budget r^2 / (6 d^2) exp(-mu_a d), arriving at T0 + d n_g / c."""
    tracer = direct_tracer(theia_tpu_torch, 32 * 1024)
    curve = sum(tracer.run()[0].double().numpy() for _ in range(4)) / 4
    d = np.linalg.norm(CAM_POS)
    expected = BUDGET * (1.0 / (6 * d**2)) * np.exp(-0.02 * d)
    assert abs(curve.sum() / expected - 1.0) < 0.05, curve.sum() / expected
    t_arr = T0 + d / (theia_tpu_torch.units.c / 1.33)
    assert abs(int(curve.argmax()) - int(t_arr / 10.0)) <= 1
