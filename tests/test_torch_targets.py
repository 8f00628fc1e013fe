"""The port's analytic targets, single-medium lookups and the two new
sources against the live ``theia_tpu`` on the CPU, on the same numpy
inputs and Philox streams.

Tolerances and why:
(a) Philox-driven samples (``sample``, the sources) and ``occluded``:
    every bool field equal; float fields within 4 ulp of float32 at the
    field's scale (``ULP4`` = 4 * 2^-23 relative to the largest
    magnitude of the field). Both packages do the same float32 ops in the
    same order; transcendentals (sqrt, sin, cos of the cone and disk
    samples) differ by an ulp or so between XLA and torch on the CPU.
(b) ``intersect``: the same on the lanes that hit, but a lane's scale
    is the larger of the field's and its ray's |origin|_inf + t: the hit
    point is origin + t * direction, so the rounding of a long ray's t
    (a grazing ray meets a plane far away) carries into the point. The
    planar targets' points agreed within 3 ulp of that scale; XLA
    contracts the frame products in another order than the port's
    left-to-right sums. The spheres take the square root of a difference
    that cancels near grazing rays, in the same op order in both
    packages (``intersect_sphere``), and stay within the same bound on
    every lane, grazing rays included.
(c) ``lookup`` and ``medium_constants``: bit-equal (the same float32
    lerp in the same order, ``v_lo * (1 - l) + v_hi * l``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import theia_tpu.light as jlight
import theia_tpu.lookup as jlookup
import theia_tpu.material as jmat
import theia_tpu.random as jrandom
import theia_tpu.target as jtarget
import theia_tpu_torch.light as tlight
import theia_tpu_torch.lookup as tlookup
import theia_tpu_torch.material as tmat
import theia_tpu_torch.random as trandom
import theia_tpu_torch.target as ttarget

torch.set_num_threads(1)

N = 2048
ULP4 = 4 * 2.0**-23
KEY = 0x7A26E7


def _targets(mod):
    return {
        "sphere": mod.SphereTarget(position=(0.3, -0.2, 0.5), radius=1.5),
        "inner_sphere": mod.InnerSphereTarget(position=(0.3, -0.2, 0.5), radius=6.0),
        "flat": mod.FlatTarget(
            width=2.0, length=3.0, position=(0.5, 0.2, -0.4), direction=(0.2, 0.3, 1.0), up=(0.0, 1.0, 0.2)
        ),
        "disk": mod.DiskTarget(radius=1.7, position=(-0.3, 0.1, 0.4), direction=(1.0, -0.2, 0.4), up=(0.0, 0.0, 1.0)),
    }


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4.0, 4.0, (N, 3)).astype(np.float32)
    # half the rays aim at the targets' centres, half anywhere
    aim = np.array([0.3, -0.2, 0.5]) + rng.normal(scale=1.0, size=(N, 3))
    d = np.where(np.arange(N)[:, None] % 2 == 0, aim - o, rng.normal(size=(N, 3)))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _params(name):
    jt, tt = _targets(jtarget)[name], _targets(ttarget)[name]
    return jt, jt.params(), tt, tt.params("cpu")


def _states(n):
    streams = np.arange(n, dtype=np.uint32)
    js = jrandom.PhiloxRNG(key=KEY).state(jnp.asarray(streams), 3)
    ts = trandom.PhiloxRNG(key=KEY).state(torch.as_tensor(streams.astype(np.int32)), 3)
    return js, ts


def _close(name, got, want, keep=None, lane_scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype == bool:
        assert np.array_equal(got, want), name
        return
    scale = np.zeros(want.shape[0]) if lane_scale is None else lane_scale
    if keep is not None:
        got, want, scale = got[keep], want[keep], scale[keep]
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite), name
    want_f = np.where(finite, want, 0.0)
    err = np.abs(np.where(finite, got, 0.0).astype(np.float64) - want_f)
    err = err.reshape(err.shape[0], -1).max(1, initial=0.0)
    scale = np.maximum(scale, max(float(np.abs(want_f).max(initial=0.0)), 1e-30))
    assert (err <= ULP4 * scale).all(), (name, float((err / scale).max()) / 2**-23, "ulp")


def _compare_sample(jhit, thit, keep=None, lane_scale=None):
    for field in ("position", "normal", "dist", "obj_position", "obj_normal", "prob", "valid", "offset", "world_to_obj"):
        want = np.asarray(getattr(jhit, field))
        got = getattr(thit, field).numpy()
        _close(field, got, np.broadcast_to(want, got.shape), keep, lane_scale)


@pytest.mark.parametrize("name", ["sphere", "inner_sphere", "flat", "disk"])
def test_target_sample(name):
    jt, jp, tt, tp = _params(name)
    o, _ = _rays(1)
    js, ts = _states(N)
    jhit, js2 = jt.sample(jp, jnp.asarray(o), js)
    thit, ts2 = tt.sample(tp, torch.as_tensor(o), ts)
    assert np.array_equal(np.asarray(js2.dim).astype(np.int64), ts2.dim.numpy())
    valid = np.asarray(jhit.valid)
    _compare_sample(jhit, thit, keep=valid)


@pytest.mark.parametrize("name", ["sphere", "inner_sphere", "flat", "disk"])
def test_target_intersect(name):
    jt, jp, tt, tp = _params(name)
    o, d = _rays(2)
    jhit = jt.intersect(jp, jnp.asarray(o), jnp.asarray(d))
    thit = tt.intersect(tp, torch.as_tensor(o), torch.as_tensor(d))
    valid = np.asarray(jhit.valid)
    assert valid.sum() > N // 8, valid.sum()  # the rays really meet the target
    reach = np.abs(o).max(1) + np.where(valid, np.asarray(jhit.dist), 0.0)
    _compare_sample(jhit, thit, keep=valid, lane_scale=reach)


@pytest.mark.parametrize("name", ["sphere", "inner_sphere", "flat", "disk"])
def test_target_occluded(name):
    jt, jp, tt, tp = _params(name)
    o = np.random.default_rng(3).uniform(-7.0, 7.0, (N, 3)).astype(np.float32)
    want = np.asarray(jt.occluded(jp, jnp.asarray(o)))
    got = tt.occluded(tp, torch.as_tensor(o)).numpy()
    assert np.array_equal(got, want)
    if "sphere" in name:
        assert 0 < want.sum() < N


def test_planar_frames_equal():
    """``_orient_frame`` runs on the host in float64 in both packages, so
    the planar targets' frames, normals and area probabilities are equal."""
    for name in ("flat", "disk"):
        jt, jp, tt, tp = _params(name)
        for key in ("_objToWorld", "_normal", "_prob"):
            np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]), err_msg=f"{name}.{key}")
    with pytest.raises(ValueError, match="parallel"):
        ttarget.FlatTarget(direction=(0.0, 1.0, 0.0), up=(0.0, 2.0, 0.0))


@pytest.mark.parametrize("n_table", [2, 33, 1024])
def test_lookup_bit_equal(n_table):
    rng = np.random.default_rng(n_table)
    table = rng.normal(size=n_table).astype(np.float32)
    u = np.concatenate([rng.uniform(-0.2, 1.2, 4000), [0.0, 1.0, 0.5]]).astype(np.float32)
    want = np.asarray(jlookup.lookup(jnp.asarray(table), jnp.asarray(u)))
    got = tlookup.lookup(torch.as_tensor(table), torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(got, want)
    null = tlookup.lookup(None, torch.as_tensor(u), 2.5).numpy()
    np.testing.assert_array_equal(null, np.asarray(jlookup.lookup(None, jnp.asarray(u), 2.5)))


def _dispersion_free(mod):
    class Model(mod.DispersionFreeMedium, mod.HenyeyGreensteinPhaseFunction, mod.MediumModel):
        ModelName = "homogenous"

        def __init__(self):
            mod.DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=0.05, mu_s=0.02)
            mod.HenyeyGreensteinPhaseFunction.__init__(self, 0.2)

    return Model().createMedium(num_lambda=8, num_theta=256)


def _water(mod):
    class Water(mod.WaterBaseModel, mod.HenyeyGreensteinPhaseFunction, mod.MediumModel):
        ModelName = "water"

        def __init__(self):
            mod.WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
            mod.HenyeyGreensteinPhaseFunction.__init__(self, 0.9)

    return Water().createMedium(num_lambda=64, num_theta=64)


@pytest.mark.parametrize("which", ["dispersion_free", "water", "vacuum"])
def test_medium_constants_bit_equal(which):
    """``DispersionFreeMedium``'s tables equal ``theia_tpu``'s, and
    ``normalize_lambda``/``medium_constants`` on an unpacked medium are
    bit-equal at wavelengths inside, on and outside its range."""
    make = {"dispersion_free": _dispersion_free, "water": _water, "vacuum": lambda mod: None}[which]
    jm, tm = make(jmat), make(tmat)
    lam = np.random.default_rng(4).uniform(150.0, 850.0, 3000).astype(np.float32)
    lam[:3] = (200.0, 800.0, 500.0)
    if jm is not None:
        for kind in tmat._TABLE_PROPS:
            a, b = getattr(jm, kind), getattr(tm, kind)
            assert (a is None) == (b is None), kind
            if a is not None:
                np.testing.assert_array_equal(b, np.asarray(a), err_msg=kind)
        t_got = tmat.normalize_lambda(tm.to("cpu"), torch.as_tensor(lam)).numpy()
        np.testing.assert_array_equal(t_got, np.asarray(jmat.normalize_lambda(jm, jnp.asarray(lam))))
    want = jmat.medium_constants(jm, jnp.asarray(lam))
    got = tmat.medium_constants(None if tm is None else tm.to("cpu"), torch.as_tensor(lam))
    for field in ("n", "vg", "mu_s", "mu_e"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)


@pytest.mark.parametrize("polarized", [False, True])
def test_sources_sample_equal(polarized):
    """``ConstWavelengthSource`` and ``PencilLightSource`` (with a constant
    polarization state or without) draw and return what ``theia_tpu``'s do."""
    pol = dict(stokes=(1.0, 0.3, -0.2, 0.1), polarizationRef=(0.0, 1.0, 0.0)) if polarized else {}
    kw = dict(position=(0.5, 0.3, 2.0), direction=(0.3, 0.0, -0.954), timeRange=(2.0, 7.0), budget=3.0, **pol)
    jw, tw = jlight.ConstWavelengthSource(450.0), tlight.ConstWavelengthSource(450.0)
    jp, tp = jlight.PencilLightSource(**kw), tlight.PencilLightSource(**kw)
    js, ts = _states(N)
    (jlam, jc), js = jw.sample(jw.params(), js)
    (tlam, tc), ts = tw.sample(tw.params("cpu"), ts)
    np.testing.assert_array_equal(tlam.numpy(), np.asarray(jlam))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jray, js = jp.sample_forward(jp.params(), jlam, None, js)
    tray, ts = tp.sample_forward(tp.params("cpu"), tlam, None, ts)
    assert np.array_equal(np.asarray(js.dim).astype(np.int64), ts.dim.numpy())
    for field in ("position", "direction", "start_time", "contrib", "stokes", "pol_ref"):
        want, got = getattr(jray, field), getattr(tray, field)
        assert (want is None) == (got is None) == (not polarized and field in ("stokes", "pol_ref")), field
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=field)
