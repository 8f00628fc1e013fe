"""The port's light-source targets against ``theia_tpu``'s on the CPU:
``PointLightSourceTarget``, ``DiskLightSourceTarget`` and
``FlatLightSourceTarget`` sampled on the same Philox streams, then
``TargetLightSource`` focusing a spherical and a polarized cone light on
each of them, and a ``TargetLightSource`` as the source of the volume
flagship's forward tracer (batch 2048), with the lanes' RNG dims compared
on every lane.

Tolerances and why: target points within 2e-6 of their scale (the
disk's sin and cos and a 3x3 product summed in another order differ by
float32 ulps between XLA and torch); normals, areas and the dims equal;
a focused source's directions within 2e-6, its contributions within rtol
1e-5 (a 1/r^2 and a cosine of those points); the forward tracer's
histogram sum within rtol 1e-4 and every bin within 1e-4 of the largest
(the limits of ``tests/test_torch_backward.py``, whose connections
weight lanes the same way).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch
from theia_tpu_torch.interop import params_from_numpy
from torch_flagship import build_volume_flagship, numpy_tree

torch.set_num_threads(1)

N = 4096
PACKAGES = (theia_tpu, theia_tpu_torch)

TARGETS = {
    "point": lambda L: L.PointLightSourceTarget(position=(1.0, -2.0, 0.5)),
    "disk": lambda L: L.DiskLightSourceTarget(position=(0.5, 3.0, -1.0), radius=0.7, normal=(0.36, 0.48, 0.8)),
    "flat": lambda L: L.FlatLightSourceTarget(
        width=1.2, height=0.4, position=(-2.0, 0.0, 4.0), normal=(0.0, -0.6, 0.8), up=(1.0, 0.0, 0.0)
    ),
}
PRINCIPALS = {
    "spherical": lambda L: L.SphericalLightSource(position=(0.0, 0.0, -3.0), timeRange=(1.0, 5.0), budget=7.0),
    "cone polarized": lambda L: L.ConeLightSource(
        position=(0.2, -0.1, -3.0), direction=(0.0, 0.0, 1.0), cosOpeningAngle=0.2, timeRange=(0.0, 2.0),
        budget=3.0, stokes=(1.0, 0.6, 0.0, 0.0), polarizationRef=(1.0, 0.0, 0.0),
    ),
}


def _state(pkg, key):
    if pkg is theia_tpu:
        return pkg.random.PhiloxRNG(key=key).state(jnp.arange(N, dtype=jnp.uint32))
    return pkg.random.PhiloxRNG(key=key).state(torch.arange(N, dtype=torch.int32))


def _params(component, pkg):
    return component.params() if pkg is theia_tpu else component.params("cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lam(pkg):
    return jnp.full(N, 450.0, jnp.float32) if pkg is theia_tpu else torch.full((N,), 450.0)


def _constants(pkg):
    """Water's constants on every lane (n 1.33)."""
    M = pkg.material
    c = dict(n=1.33, vg=0.225, mu_s=0.02, mu_e=0.03)
    if pkg is theia_tpu:
        return M.MediumConstants(**{k: jnp.full(N, v, jnp.float32) for k, v in c.items()})
    return M.MediumConstants(**{k: torch.full((N,), v) for k, v in c.items()})


def assert_close(j, t, what, rtol=0.0, scale_atol=2e-6):
    j, t = _np(j), _np(t)
    assert j.shape == t.shape, (what, j.shape, t.shape)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=scale_atol * max(1.0, float(np.abs(j).max())), err_msg=what)


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_target_sample_matches_jax(name):
    out = []
    for pkg in PACKAGES:
        target = TARGETS[name](pkg.light)
        (pos, nrm, contrib), rng = target.sample(_params(target, pkg), _lam(pkg), _state(pkg, 0xC0FFEE))
        out.append((pos, nrm, contrib, _np(rng.dim).astype(np.int64), target.nRNGSamples))
    (jp, jn, jc, jd, jk), (tp, tn, tc, td, tk) = out
    assert jk == tk
    np.testing.assert_array_equal(td, jd)
    assert_close(jp, tp, f"{name} position")
    np.testing.assert_array_equal(_np(tn), _np(jn))
    np.testing.assert_array_equal(_np(tc), _np(jc))
    if name != "point":  # the points lie in the plane, inside the shape
        offset = _np(tp) - np.asarray(TARGETS[name](theia_tpu_torch.light).position, np.float32)
        assert np.abs((offset * _np(tn)).sum(-1)).max() < 1e-5
        assert len(np.unique(_np(tp).round(4), axis=0)) > N // 2


@pytest.mark.parametrize("principal", sorted(PRINCIPALS))
@pytest.mark.parametrize("name", sorted(TARGETS))
def test_target_light_source_matches_jax(name, principal):
    out = []
    for pkg in PACKAGES:
        source = pkg.light.TargetLightSource(PRINCIPALS[principal](pkg.light), TARGETS[name](pkg.light))
        ray, rng = source.sample_forward(_params(source, pkg), _lam(pkg), _constants(pkg), _state(pkg, 0xBEEF))
        out.append((ray, _np(rng.dim).astype(np.int64), source))
    (jray, jd, js), (tray, td, ts) = out
    assert (js.nRNGForward, js.supportForward, js.supportBackward) == (ts.nRNGForward, ts.supportForward, ts.supportBackward)
    np.testing.assert_array_equal(td, jd)
    assert (jd == ts.nRNGForward).all()
    assert_close(jray.position, tray.position, "position")
    assert_close(jray.direction, tray.direction, "direction")
    assert_close(jray.start_time, tray.start_time, "start time", rtol=1e-6)
    jc = _np(jray.contrib)
    assert_close(jc, tray.contrib, "contrib", rtol=1e-5, scale_atol=1e-6 * float(np.abs(jc).max()))
    assert (jray.stokes is None) == (tray.stokes is None)
    if jray.stokes is not None:
        assert_close(jray.stokes, tray.stokes, "stokes")
        assert_close(jray.pol_ref, tray.pol_ref, "pol_ref", scale_atol=1e-5)
    assert (jc > 0).any()


def test_target_light_source_needs_backward_principal():
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            pkg.light.TargetLightSource(pkg.light.PencilLightSource(), pkg.light.PointLightSourceTarget())


@pytest.mark.parametrize("name", ["disk", "flat"])
def test_target_light_source_through_forward_tracer(name):
    """The volume flagship with its light focused on a target in front of
    the 5 m sphere target: the same light curve and RNG dims."""
    pair = []
    for pkg in PACKAGES:
        L = pkg.light
        target = {
            "disk": L.DiskLightSourceTarget(position=(0.0, -3.0, 0.0), radius=2.0, normal=(0.0, 1.0, 0.0), up=(0.0, 0.0, 1.0)),
            "flat": L.FlatLightSourceTarget(width=3.0, height=2.0, position=(0.0, -3.0, 0.0), normal=(0.0, 1.0, 0.0),
                                            up=(0.0, 0.0, 1.0)),
        }[name]
        source = L.TargetLightSource(L.SphericalLightSource(position=(-1.0, -7.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
                                     target)
        pair.append(build_volume_flagship(pkg, 2048, None if pkg is theia_tpu else "cpu", source=source))
    jt, tt = pair
    assert (jt.nRNGSamples, jt.maxHitsPerThread) == (tt.nRNGSamples, tt.maxHitsPerThread)
    jt._debug_rng = tt._debug_rng = True
    p = jt.params()
    js, _, jd = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    tp = params_from_numpy(numpy_tree(p), "cpu")
    with torch.no_grad():
        ts, _, td = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    np.testing.assert_array_equal(td.numpy().astype(np.int64), np.asarray(jd).astype(np.int64))
    jh = np.asarray(jt.response.result(p["response"], js), np.float64)
    th = tt.response.result(tp["response"], ts).double().numpy()
    assert jh.sum() > 0
    assert abs(th.sum() / jh.sum() - 1.0) <= 1e-4, th.sum() / jh.sum() - 1.0
    assert np.abs(th - jh).max() <= 1e-4 * jh.max(), np.abs(th - jh).max() / jh.max()
