"""The port's scene backward tracers against the live ``theia_tpu`` on the
CPU, on in-code icospheres (``tests/torch_flagship.py``), with the same
parameters (the JAX tracer's, carried over by ``interop``) and streams:

- ``SceneBackwardTargetTracer``: ``tests/test_scene_backward.py``'s
  emissive sphere (a ``HitRecorder``), and a lamp in scattering water
  unguided, guided by a ``SphereTargetGuide``, and guided with a detector
  sphere in the scene, which moves the brute-force pack's MIS shadow query
  onto the detector split (``theia_tpu``'s behaviour, kept; the shadow
  rays then never see the lamp); then the emissive sphere's own checks on
  the port alone;
- ``SceneBackwardTracer``: the energy configuration of
  ``tests/test_scene_backward.py`` unpolarized and polarized, with and
  without the direct light, on ``accel="brute"`` and ``"mt"``; the glass
  ball of ``tests/test_grad_scene.py:305`` with the camera inside it (the
  JAX test's) and outside it in the water, for each outcome at the
  surface (transmission only, reflection only, both branches,
  transmission disabled, volume borders kept and disabled), unpolarized
  and polarized;
- the gradients against ``jax.grad``: the eta^2 case
  (``tests/test_grad_scene.py:199``, in the glass's index) and the
  camera's position through a bounce (l.305).

The RNG dims are compared on every lane: the target tracer's through the
forward tracer's ``_debug_rng`` hook in both packages; ``theia_tpu``'s
``SceneBackwardTracer`` has no hook, so its lanes' last dims are those of
the last ``_merge_dim`` of a batch run eagerly (``jax.disable_jit``), where
the loop ends.

Tolerances and why:
(a) recorded hits: the same slots valid; times within rtol 1e-5,
    contributions within rtol 1e-4 or 1e-6 of the largest, Stokes vectors
    within 1e-4 (``tests/test_torch_backward.py``'s limits: ulps of XLA's
    and torch's sqrt, exp and trigonometric functions through the light
    connections' 1/d^2 and exp(-mu d));
(b) histograms: sum within rtol 1e-4, every bin within 1e-4 of the
    largest (the same);
(c) gradients: the loss within rtol 1e-5, the gradient within rtol 1e-3
    (``tests/test_torch_grad_scene.py``'s limits against ``jax.grad``);
(d) the emissive sphere: ``tests/test_scene_backward.py``'s own limits,
    its lower time bound taken from the icosphere's nearest face (0.992
    was ``sphere.stl``'s).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu
import theia_tpu.trace.scene_backward as jax_scene_backward
import theia_tpu_torch
from theia_tpu_torch.interop import params_from_numpy
from test_torch_grad_scene import patch_media
from torch_flagship import (
    build_backward_eta2, build_backward_glass, build_lamp, build_scene_backward, build_scene_backward_target,
    icosphere, jax_record_sums, nearest_face_distance, numpy_tree,
)

torch.set_num_threads(1)


def jax_run(jt, merge_modules=()):
    """One JAX batch: (params, response state, each lane's last dims).
    With ``merge_modules`` the batch runs eagerly and the dims are those of
    the last ``_merge_dim`` call in those modules."""
    p = jt.params()
    if not merge_modules:
        jt._debug_rng = True
        state, _, dims = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
        jt._debug_rng = False
        return p, state, np.asarray(dims).astype(np.int64)
    seen = []
    merges = {m: m._merge_dim for m in merge_modules}

    def recorded(module):
        def merge(after, before, take):
            out = merges[module](after, before, take)
            seen.append(out)
            return out

        return merge

    for m in merge_modules:
        m._merge_dim = recorded(m)
    try:
        with jax.disable_jit():
            state, _ = jt._trace_batch(p, jt.rng.counter_words, jt.streams())
    finally:
        for m, merge in merges.items():
            m._merge_dim = merge
    return p, state, np.asarray(seen[-1].dim).astype(np.int64)


def trace_both(build, merge_modules=(), **kw):
    """One batch of ``build``'s tracer in each package on the JAX tracer's
    parameters; returns (JAX result, port result) as numpy, the dims
    already held equal on every lane."""
    jt, tt = build(theia_tpu, **kw), build(theia_tpu_torch, device="cpu", **kw)
    assert (jt.nRNGSamples, jt.maxHitsPerThread) == (tt.nRNGSamples, tt.maxHitsPerThread)
    p, js, jd = jax_run(jt, merge_modules)
    tp = params_from_numpy(numpy_tree(p), "cpu")
    tt._debug_rng = True
    with torch.no_grad():
        ts, _, td = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    np.testing.assert_array_equal(td.numpy().astype(np.int64), jd)
    j, t = jt.response.result(p["response"], js), tt.response.result(tp["response"], ts)
    if isinstance(j, dict):
        return {k: np.asarray(v) for k, v in j.items()}, {k: v.numpy() for k, v in t.items()}
    return np.asarray(j, np.float64), t.double().numpy()


def assert_hist_agree(jh, th):
    assert jh.sum() > 0 and np.isfinite(th).all()
    assert abs(th.sum() / jh.sum() - 1.0) <= 1e-4, th.sum() / jh.sum() - 1.0
    assert np.abs(th - jh).max() <= 1e-4 * jh.max(), np.abs(th - jh).max() / jh.max()


def assert_hits_agree(j, t, least):
    valid = j["valid"]
    np.testing.assert_array_equal(t["valid"], valid)
    assert valid.sum() >= least, valid.sum()
    np.testing.assert_allclose(t["time"][valid], j["time"][valid], rtol=1e-5)
    contrib = j["contrib"][valid]
    np.testing.assert_allclose(t["contrib"][valid], contrib, rtol=1e-4, atol=1e-6 * np.abs(contrib).max())
    if "stokes" in j:
        np.testing.assert_allclose(t["stokes"][valid], j["stokes"][valid], atol=1e-4)


# ---------------------------------------------------------------- target tracer


def test_target_tracer_emissive_sphere_matches_jax():
    j, t = trace_both(build_scene_backward_target, batch=2048)
    assert_hits_agree(j, t, 2000)


LAMPS = {"unguided": dict(guided=False), "guided": {}, "guided, a detector in the scene": dict(detector=True)}


@pytest.mark.parametrize("case", sorted(LAMPS))
def test_target_tracer_lamp_matches_jax(case):
    jh, th = trace_both(build_lamp, batch=2048, **LAMPS[case])
    assert_hist_agree(jh, th)


def test_guided_shadow_rays_follow_the_detector_split():
    """``theia_tpu``'s ``intersect_target`` orders the MIS shadow rays' hits
    over the detector instances on a brute-force pack, whatever the
    tracer's target bit. With a detector in the scene the guided target
    tracer's shadow rays never count the lamp (LIGHT_SOURCE, not a
    detector), so its light curve loses the MIS shadow part. The port does
    the same: the two runs share their streams, and with the detector the
    total falls (ROADMAP.md queue 3)."""
    totals = {}
    for detector in (False, True):
        tracer = build_lamp(theia_tpu_torch, 4096, "cpu", detector=detector)
        totals[detector] = float(tracer.run()[0].double().sum())
    assert 0.0 < totals[True] < 0.9 * totals[False], totals


def test_emissive_sphere():
    """``tests/test_scene_backward.py::test_backward_target_emissive_sphere``
    on the port at its batch, the icosphere in place of ``sphere.stl``."""
    mesh = icosphere(3)
    tracer = build_scene_backward_target(theia_tpu_torch, 4096, "cpu", mesh=mesh)
    hits, _ = tracer.run()
    valid = hits["valid"].numpy()
    assert valid.sum() > 0.99 * 4096
    assert np.allclose(hits["contrib"].numpy()[valid], 4 * np.pi, rtol=1e-5)
    t = hits["time"].numpy()[valid]
    c = theia_tpu_torch.units.c
    assert np.all(t >= nearest_face_distance(mesh, 10.0) / c) and np.all(t <= 10.01 / c)


def test_target_tracer_refuses_polarized():
    for pkg, dev in ((theia_tpu, {}), (theia_tpu_torch, {"device": "cpu"})):
        base = build_scene_backward_target(pkg, 16, **dev)
        with pytest.raises(NotImplementedError):
            type(base)(16, base.camera, base.wavelengthSource, base.response, base.rng, base.scene, polarized=True, **dev)


# -------------------------------------------------------------- backward tracer


@pytest.mark.parametrize("direct", [True, False], ids=["direct", "no direct"])
@pytest.mark.parametrize("polarized", [False, True], ids=["unpolarized", "polarized"])
@pytest.mark.parametrize("accel", ["brute", "mt"])
def test_backward_tracer_matches_jax(accel, polarized, direct):
    """The energy configuration at batch 1024, path length 6."""
    rec = lambda pkg: pkg.response.HitRecorder(polarized=polarized)
    j, t = trace_both(
        lambda pkg, **kw: build_scene_backward(pkg, response=rec(pkg), **kw), [jax_scene_backward],
        batch=1024, mesh=icosphere(2), max_path=6, accel=accel, polarized=polarized,
        disableDirectLighting=not direct,
    )
    assert_hits_agree(j, t, 1000)


#: the camera outside the ball, in the water at (-5, 0, 0)
OUTSIDE = dict(camera=(-5.0, 0.0, 0.0), camera_medium="water")
GLASS = {
    "inside, transmission only": dict(flags="T"),
    "transmission only": dict(flags="T", **OUTSIDE),
    "reflection only": dict(flags="R", **OUTSIDE),
    "both branches": dict(flags="TR", **OUTSIDE),
    "transmission disabled": dict(flags="TR", disableTransmission=True, **OUTSIDE),
    "volume border": dict(flags="V", **OUTSIDE),
    "volume border disabled": dict(flags="V", disableVolumeBorder=True, **OUTSIDE),
}


@pytest.mark.parametrize("polarized", [False, True], ids=["unpolarized", "polarized"])
@pytest.mark.parametrize("case", sorted(GLASS))
def test_backward_tracer_surfaces_match_jax(case, polarized):
    """The glass ball, the camera at its centre (the JAX test's) or in the
    water outside it, each of the surface's outcomes."""
    rec = lambda pkg: pkg.response.HitRecorder(polarized=polarized)
    j, t = trace_both(
        lambda pkg, **kw: build_backward_glass(pkg, response=rec(pkg), **kw), [jax_scene_backward],
        batch=2048, polarized=polarized, **GLASS[case],
    )
    assert_hits_agree(j, t, 50)


# ------------------------------------------------------------------- gradients


def test_eta2_gradient_matches_jax(monkeypatch):
    """d sum(histogram) / d n_glass: the camera in the glass sees the wall
    through one refracting interface, and eta^2 on transmission makes the
    gradient positive (``test_grad_backward_eta2_statistical``'s sign).
    The value: the port's records add in a fixed order of spans, tiles and
    groups, ``theia_tpu``'s as its one-hot product does; at these seeds
    ``theia_tpu``'s float32 sum is 2.6e-5 from the exact sum of what it
    recorded and the port's 8e-7. So the port's sum is held at rtol 1e-5
    against the exact (float64) sum of the values it recorded, and that sum
    at rtol 1e-5 against the exact sum of the values ``theia_tpu``
    recorded, record by record."""
    record, exact = theia_tpu_torch.response.histogram_add, []

    def summed(state, value, time, mask, t0, bin_size, n_bins, object_id=None, n_detectors=None):
        keep, _ = theia_tpu_torch.response._hist_bins(time, mask, t0, bin_size, n_bins, object_id, n_detectors)
        exact.append(float(value.detach().double()[keep].sum()))
        return record(state, value, time, mask, t0, bin_size, n_bins, object_id, n_detectors)

    monkeypatch.setattr(theia_tpu_torch.response, "histogram_add", summed)
    jt = build_backward_eta2(theia_tpu, 4096)
    fn, (p0, counter, streams) = jt.trace_fn()
    handle = p0["scene"].media.handle("glass")
    j_value, j_grad = jax.jit(jax.value_and_grad(
        lambda n0: jnp.sum(fn(patch_media(p0, handle, refractive_index=n0), counter, streams)[0])
    ))(jnp.float32(1.5))
    # the same forward pass again, its records' exact sums collected
    jsums = jax_record_sums(monkeypatch)
    jax.block_until_ready(jax.jit(lambda n0: fn(patch_media(p0, handle, refractive_index=n0), counter, streams)[0])(
        jnp.float32(1.5)
    ))

    tt = build_backward_eta2(theia_tpu_torch, 4096, "cpu")
    fn, (p0, counter, streams) = tt.trace_fn()
    n0 = torch.tensor(1.5, requires_grad=True)
    t_value = fn(patch_media(p0, p0["scene"].media.handle("glass"), refractive_index=n0), counter, streams)[0].sum()
    t_value.backward()
    assert float(j_grad) > 0.0 and n0.grad.item() > 0.0 and len(exact) > 1 and len(jsums) == len(exact)
    np.testing.assert_allclose(t_value.item(), sum(exact), rtol=1e-5)
    np.testing.assert_allclose(exact, [s.sum() for s in jsums], rtol=1e-5, atol=1e-6 * max(exact))
    np.testing.assert_allclose(sum(exact), sum(s.sum() for s in jsums), rtol=1e-5)
    np.testing.assert_allclose(n0.grad.item(), float(j_grad), rtol=1e-3)


def test_geometry_gradient_through_bounce_matches_jax():
    """``test_backward_geometry_gradient_through_bounce``'s loss (relative
    squared mismatch to the light curve with the camera at x = 0.9) in the
    camera's x at 0: the glass leg of every path is a geometric hit
    distance, re-attached."""
    def camera_at(p, x, stack):
        return dict(p, camera=dict(p["camera"], position=stack(x)))

    jt = build_backward_glass(theia_tpu, 4096)
    fn, (p0, counter, streams) = jt.trace_fn()
    j_stack = lambda x: jnp.stack([x, jnp.float32(0.0), jnp.float32(0.0)])
    obs = fn(camera_at(p0, jnp.float32(0.9), j_stack), counter, streams)[0]
    j_loss = lambda x: jnp.sum((fn(camera_at(p0, x, j_stack), counter, streams)[0] - obs) ** 2) / jnp.sum(obs**2)
    j_value, j_grad = jax.value_and_grad(j_loss)(jnp.float32(0.0))

    tt = build_backward_glass(theia_tpu_torch, 4096, "cpu")
    fn, (p0, counter, streams) = tt.trace_fn()
    t_stack = lambda x: torch.stack([x, torch.zeros(()), torch.zeros(())])
    with torch.no_grad():
        obs = fn(camera_at(p0, torch.tensor(0.9), t_stack), counter, streams)[0]
    x = torch.tensor(0.0, requires_grad=True)
    t_value = ((fn(camera_at(p0, x, t_stack), counter, streams)[0] - obs) ** 2).sum() / (obs**2).sum()
    t_value.backward()
    assert np.isfinite(float(j_grad)) and float(j_grad) != 0.0
    np.testing.assert_allclose(t_value.item(), float(j_value), rtol=1e-5)
    np.testing.assert_allclose(x.grad.item(), float(j_grad), rtol=1e-3)
