"""theia_tpu_torch.testing's samplers against theia_tpu.testing's: each
sampling function and each reference-style sampler stage, on the same
Philox streams (lanes 0 .. n - 1 from dim 0), with every lane's RNG dim
after the draw.

Tolerance: the same float32 ops in the same order on every lane, so the
samples agree to rtol 1e-5 / atol 1e-6 (XLA and torch's CPU
transcendentals, sin, cos, log, exp, sqrt, differ by an ulp and a
direction's normalization amplifies it a little); every lane's dim is
equal, and the stage's RNG offset after each ``run()`` too."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch

torch.set_num_threads(1)
N = 1024
RTOL, ATOL = 1e-5, 1e-6


def mod(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg.__name__}.{name}")


def components(pkg):
    light, cam, target = mod(pkg, "light"), mod(pkg, "camera"), mod(pkg, "target")
    return dict(
        wavelength=light.UniformWavelengthSource(lambdaRange=(350.0, 650.0)),
        spherical=light.SphericalLightSource(position=(1.0, -2.0, 0.5), timeRange=(0.0, 20.0), budget=1e4),
        cone=light.ConeLightSource(position=(0.0, 0.0, 1.0), direction=(0.0, 1.0, 0.0), cosOpeningAngle=0.8,
                                   timeRange=(5.0, 5.0), budget=3e3),
        pencil=light.PencilLightSource(position=(0.0, 0.0, 0.0), direction=(1.0, 0.0, 0.0), budget=7.0),
        sphere_camera=cam.SphereCamera(position=(3.0, 0.0, 0.0), radius=1.5),
        flat_camera=cam.FlatCamera(width=2.0, length=1.0, offset=(0.0, 4.0, 0.0)),
        cone_camera=cam.ConeCamera(position=(0.0, 0.0, -2.0), direction=(0.0, 0.0, 1.0), cosOpeningAngle=0.7),
        sphere_target=target.SphereTarget(position=(0.0, 3.0, 0.0), radius=0.6),
        inner_target=target.InnerSphereTarget(position=(0.5, 0.0, 0.0), radius=10.0),
        guide=target.SphereTargetGuide(position=(0.0, 3.0, 0.0), radius=0.6),
        disk_guide=target.DiskTargetGuide(position=(0.0, 3.0, 0.0), radius=0.6, normal=(0.0, -0.6, 0.8)),
    )


def water(pkg):
    return mod(pkg, "testing").WaterTestModel().createMedium(num_lambda=64, num_theta=64)


CASES = {
    "wavelength": lambda t, c, pkg, **kw: t.sampleWavelength(c["wavelength"], N, **kw),
    "light spherical": lambda t, c, pkg, **kw: t.sampleLight(c["spherical"], N, medium=water(pkg), **kw),
    "light cone": lambda t, c, pkg, **kw: t.sampleLight(c["cone"], N, wavelength=500.0, **kw),
    "light pencil": lambda t, c, pkg, **kw: t.sampleLight(c["pencil"], N, **kw),
    "backward light spherical": lambda t, c, pkg, **kw: t.sampleBackwardLight(
        c["spherical"], (4.0, 1.0, -1.0), N, medium=water(pkg), **kw),
    "backward light cone": lambda t, c, pkg, **kw: t.sampleBackwardLight(
        c["cone"], (0.5, 6.0, 1.0), N, normal=(0.0, -1.0, 0.0), **kw),
    "camera ray sphere": lambda t, c, pkg, **kw: t.sampleCameraRay(c["sphere_camera"], N, **kw),
    "camera ray flat": lambda t, c, pkg, **kw: t.sampleCameraRay(c["flat_camera"], N, wavelength=420.0, **kw),
    "camera ray cone": lambda t, c, pkg, **kw: t.sampleCameraRay(c["cone_camera"], N, **kw),
    "camera point sphere": lambda t, c, pkg, **kw: t.sampleCameraPoint(c["sphere_camera"], N, **kw),
    "camera point flat": lambda t, c, pkg, **kw: t.sampleCameraPoint(c["flat_camera"], N, **kw),
    "target sphere": lambda t, c, pkg, **kw: t.sampleTarget(c["sphere_target"], (0.0, 0.0, 0.0), N, **kw),
    "target inner sphere": lambda t, c, pkg, **kw: t.sampleTarget(c["inner_target"], (1.0, 2.0, 0.0), N, **kw),
    "guide sphere": lambda t, c, pkg, **kw: t.sampleTargetGuide(c["guide"], (0.2, -1.0, 0.0), N, **kw),
    "guide disk": lambda t, c, pkg, **kw: t.sampleTargetGuide(c["disk_guide"], (0.0, -1.0, 0.3), N, **kw),
}


def flat(sample) -> dict:
    """A sample's arrays by field name (a tuple's by position)."""
    if dataclasses.is_dataclass(sample):
        return {f.name: getattr(sample, f.name) for f in dataclasses.fields(sample) if getattr(sample, f.name) is not None}
    return {str(i): a for i, a in enumerate(sample)}


def agree(got, want, label):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want), label
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert b.shape == a.shape, (label, k)
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=f"{label}: {k}")
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=f"{label}: {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_sampler_matches_jax(case):
    key = 0xBEEF + len(case)
    want = CASES[case](theia_tpu.testing, components(theia_tpu), theia_tpu, rng=theia_tpu.random.PhiloxRNG(key=key))
    got = CASES[case](theia_tpu_torch.testing, components(theia_tpu_torch), theia_tpu_torch,
                      rng=theia_tpu_torch.random.PhiloxRNG(key=key), device="cpu")
    agree(got, want, case)


def _dims(pkg, case):
    """Every lane's RNG dim after the sampler's draw: the sampler's own
    component call, on the state the sampler builds."""
    c = components(pkg)
    t = pkg.testing
    state = t._state(N, pkg.random.PhiloxRNG(key=5)) if pkg is theia_tpu else t._state(
        N, pkg.random.PhiloxRNG(key=5), torch.device("cpu"))
    p = (lambda comp: comp.params()) if pkg is theia_tpu else (lambda comp: comp.params(torch.device("cpu")))

    def arr(x, shape):
        if pkg is theia_tpu:
            return jnp.broadcast_to(jnp.asarray(x, jnp.float32), shape)
        return torch.broadcast_to(torch.as_tensor(np.asarray(x, np.float32)), shape)

    lam = arr(450.0, (N,))
    if pkg is theia_tpu:
        const = theia_tpu.material.medium_constants(None, lam)
    else:
        const = theia_tpu_torch.material.medium_constants(None, lam)
    obs, nrm = arr((4.0, 1.0, -1.0), (N, 3)), arr((0.0, 0.0, 0.0), (N, 3))
    calls = {
        "wavelength": lambda: c["wavelength"].sample(p(c["wavelength"]), state),
        "light": lambda: c["spherical"].sample_forward(p(c["spherical"]), lam, const, state),
        "backward light": lambda: c["cone"].sample_backward(p(c["cone"]), obs, nrm, lam, const, state),
        "camera ray": lambda: c["flat_camera"].sample_ray(p(c["flat_camera"]), lam, state),
        "camera point": lambda: c["sphere_camera"].sample_point(p(c["sphere_camera"]), lam, state),
        "target": lambda: c["sphere_target"].sample(p(c["sphere_target"]), obs, state),
        "guide": lambda: c["disk_guide"].sample(p(c["disk_guide"]), obs, state),
    }
    _, after = calls[case]()
    return np.asarray(after.dim).astype(np.int64)


@pytest.mark.parametrize("case", ["wavelength", "light", "backward light", "camera ray", "camera point", "target", "guide"])
def test_sampler_rng_dims_match_jax(case):
    want, got = _dims(theia_tpu, case), _dims(theia_tpu_torch, case)
    assert want.shape == got.shape == (N,) and want.max() > 0
    np.testing.assert_array_equal(got, want)


STAGES = {
    "LightSampler": lambda t, c, **kw: t.LightSampler(c["spherical"], 256, **kw),
    "BackwardLightSampler": lambda t, c, **kw: t.BackwardLightSampler(c["cone"], (0.5, 6.0, 1.0), 256, **kw),
    "CameraRaySampler": lambda t, c, **kw: t.CameraRaySampler(c["flat_camera"], 256, **kw),
    "CameraDirectSampler": lambda t, c, **kw: t.CameraDirectSampler(c["sphere_camera"], 256, **kw),
    "TargetSampler": lambda t, c, **kw: t.TargetSampler(c["sphere_target"], (0.0, 0.0, 0.0), 256, **kw),
    "TargetGuideSampler": lambda t, c, **kw: t.TargetGuideSampler(c["guide"], (0.2, -1.0, 0.0), 256, **kw),
}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_sampler_stages_match_jax(stage):
    js = STAGES[stage](theia_tpu.testing, components(theia_tpu))
    ts = STAGES[stage](theia_tpu_torch.testing, components(theia_tpu_torch), device="cpu")
    for _ in range(2):  # the second batch after the stage's advance
        want, got = js.run(), ts.run()
        assert sorted(got) == sorted(want), stage
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=RTOL, atol=ATOL, err_msg=f"{stage}: {k}")
        assert ts.rng.offset == js.rng.offset


def test_light_sampler_name_and_hemisphere_cosine():
    assert theia_tpu_torch.light.LightSampler is theia_tpu_torch.testing.LightSampler
    from theia_tpu.ops import sampling as js
    from theia_tpu_torch.ops import sampling as ts

    u = np.random.default_rng(4).random((2, 4096)).astype(np.float32)
    u[:, :3] = [[0.5, 0.0, 1.0], [0.5, 1.0, 0.0]]
    want = np.asarray(js.sample_hemisphere_cosine(jnp.asarray(u[0]), jnp.asarray(u[1])))
    got = ts.sample_hemisphere_cosine(torch.as_tensor(u[0]), torch.as_tensor(u[1]))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts.sample_hemisphere_cosine_pdf(got).numpy(),
                               np.asarray(js.sample_hemisphere_cosine_pdf(jnp.asarray(want))), rtol=RTOL, atol=ATOL)
    assert np.float32(ts.INV_PI) == np.float32(js.INV_PI)
    assert (got[:, 2] >= 0).all()
    from theia_tpu.ops import math3d as jm3
    from theia_tpu_torch.ops import math3d as tm3

    assert np.float32(tm3.INF) == jm3.INF
