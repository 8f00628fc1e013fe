"""The port's Cherenkov light sources against the live ``theia_tpu`` on the
CPU: ``CherenkovLightSource``, ``CherenkovTrackLightSource``,
``MuonTrackLightSource`` and ``ParticleCascadeLightSource`` forward and
backward on the same inputs and streams (every lane's dim after the call
equal), the track's backward sample (``ops.cherenkov_track``) against
``theia_tpu``'s and against the numpy oracle of
``tests/test_light_backward.py:176``, its gradient against ``jax.grad``,
then each volume run of ``chip_smoke.py`` phase 3m at 4,096 lanes
(cherenkov-muon, cherenkov-cascade, cascade-backward, track-backward on
the 3-vertex and the 256-segment line) against ``theia_tpu``'s tracer with
every lane's dims equal.

Tolerances and why:
(a) a source's sample: each field within 1e-5 of its largest value
    (measured at most 1.6e-6: XLA's and torch's log, exp, pow, atan and
    trigonometric functions differ in ulps; sums in the same order);
    stokes equal.
(b) the track's backward total within rtol 1e-5 of ``theia_tpu``'s (both
    sum the segments' candidates in float32, the port in segment order,
    XLA in its own association) and of the float64 oracle's 1e-4; k equal
    except on lanes whose running sum lies within 1e-5 of u total, where
    the association decides (at most 1 %; the test prints the count).
(c) gradients of the track's sample within rtol 1e-4 of ``jax.grad``'s
    (the same rounding of the same sums).
(d) the volume runs: every lane's last RNG dim equal (the gamma draws'
    rounds R equal too: a lane flipped by an ulp of log would move every
    lane's later dims), histogram sum within rtol 1e-4 and every bin
    within 1e-4 of the largest, as ``tests/test_torch_backward.py``'s
    camera runs (the 1/d^2 light connections carry the ulps of (a)).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu
import theia_tpu.trace.backward as jbackward
import theia_tpu_torch
from theia_tpu_torch.interop import params_from_numpy
from torch_flagship import (
    build_cherenkov_backward, build_cherenkov_volume, cascade_source, muon_source, numpy_tree, track_line_source,
)

torch.set_num_threads(1)

N = 4096
SOURCE_TOL = 1e-5


def mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def bent_track(pkg, usePhotonCount=True):
    """tests/test_light_backward.py's bent track: two segments at an
    angle, beta = 1 timing."""
    c = mod(pkg, "units").c
    verts = np.array([[-60.0, 0.0, 0.0, -60.0 / c], [0.0, 0.0, 0.0, 0.0], [30.0, 40.0, 0.0, 50.0 / c]], np.float32)
    light = mod(pkg, "light")
    return light.CherenkovTrackLightSource(light.ParticleTrack(verts), usePhotonCount=usePhotonCount)


SOURCES = {
    "simple, photons": lambda pkg: mod(pkg, "light").CherenkovLightSource(
        trackStart=(-5.0, 1.0, 0.0), trackEnd=(10.0, 2.0, 3.0), usePhotonCount=True),
    "simple, energy": lambda pkg: mod(pkg, "light").CherenkovLightSource(
        trackStart=(-5.0, 1.0, 0.0), trackEnd=(10.0, 2.0, 3.0)),
    "track, photons": bent_track,
    "track, energy": lambda pkg: bent_track(pkg, False),
    "track, 256 segments": lambda pkg: track_line_source(pkg, "track", 256),
    "muon": muon_source,
    "muon, no Frank-Tamm": lambda pkg: mod(pkg, "light").MuonTrackLightSource(
        startPosition=(0.0, 0.0, 0.0), endPosition=(0.0, 0.0, 20.0), endTime=20.0 / mod(pkg, "units").c,
        muonEnergy=1e3, applyFrankTamm=False),
    "cascade": cascade_source,
}


def inputs(seed: int = 0):
    """Per-lane wavelengths, medium constants, observers (half on a
    surface, half volume points) as numpy."""
    rs = np.random.default_rng(seed)
    obs = rs.uniform(-30.0, 30.0, (N, 3)).astype(np.float32)
    nrm = rs.normal(size=(N, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[: N // 2] = 0.0
    return dict(
        lam=rs.uniform(400.0, 500.0, N).astype(np.float32), n=rs.uniform(1.32, 1.36, N).astype(np.float32),
        mu_e=rs.uniform(0.02, 0.1, N).astype(np.float32), obs=obs, nrm=nrm,
    )


def sample(pkg, source, direction, x, key=0xC0FFEE):
    """One ``sample_forward``/``sample_backward`` call of ``source`` on the
    inputs ``x``: (ray fields as numpy, each lane's dim after the call)."""
    if pkg is theia_tpu:
        arr, params, lanes = jnp.asarray, source.params(), jnp.arange(N, dtype=jnp.uint32)
    else:
        arr, params, lanes = torch.as_tensor, source.params("cpu"), torch.arange(N, dtype=torch.int32)
    n = arr(x["n"])
    constants = mod(pkg, "material").MediumConstants(n=n, vg=n * 0 + 0.22, mu_s=n * 0, mu_e=arr(x["mu_e"]))
    rng = mod(pkg, "random").PhiloxRNG(key=key).state(lanes)
    if direction == "forward":
        ray, rng = source.sample_forward(params, arr(x["lam"]), constants, rng)
    else:
        ray, rng = source.sample_backward(params, arr(x["obs"]), arr(x["nrm"]), arr(x["lam"]), constants, rng)
    fields = {f: getattr(ray, f) for f in ("position", "direction", "start_time", "contrib", "stokes", "pol_ref")}
    return {k: None if v is None else np.asarray(v) for k, v in fields.items()}, np.asarray(rng.dim).astype(np.int64)


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_source_matches_jax(name, direction):
    x = inputs()
    (j, jd), (t, td) = (sample(pkg, SOURCES[name](pkg), direction, x) for pkg in (theia_tpu, theia_tpu_torch))
    np.testing.assert_array_equal(td, jd)
    assert np.abs(j["contrib"]).max() > 0
    for field, want in j.items():
        if want is None:
            assert t[field] is None, field
            continue
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(t[field] - want).max()) / scale
        assert err <= (0.0 if field == "stokes" else SOURCE_TOL), (field, err)


def track_oracle(verts, obs, nrm, n_refr, ft):
    """tests/test_light_backward.py's numpy oracle, in float64: the
    segments' candidates (contrib, position, time), every lane at one
    index of refraction."""
    v0, v1 = verts[:-1].astype(np.float64), verts[1:].astype(np.float64)
    seg_vec = v1[:, :3] - v0[:, :3]
    seg_len = np.linalg.norm(seg_vec, axis=-1)
    seg_dir = seg_vec / seg_len[:, None]
    cos_t, sin_t = 1.0 / n_refr, np.sqrt(1.0 - 1.0 / n_refr**2)
    mu = ((obs[:, None, :] - v0[None, :, :3]) * seg_dir[None]).sum(-1)
    c_point = v0[None, :, :3] + mu[..., None] * seg_dir[None]
    d_perp = np.linalg.norm(obs[:, None, :] - c_point, axis=-1)
    mu = mu - cos_t / sin_t * d_perp
    pos = v0[None, :, :3] + mu[..., None] * seg_dir[None]
    ray_dir = obs[:, None, :] - pos
    ray_dir /= np.linalg.norm(ray_dir, axis=-1, keepdims=True)
    cos_nrm = np.where((nrm**2).sum(-1)[:, None] == 0.0, 1.0, np.maximum((ray_dir * nrm[:, None, :]).sum(-1), 0.0))
    on = (mu >= 0.0) & (mu <= seg_len[None])
    frac = mu / seg_len[None]
    return ft * cos_nrm / d_perp * on, pos, v0[None, :, 3] * (1 - frac) + v1[None, :, 3] * frac


@pytest.mark.parametrize("segments", [2, 256])
def test_track_backward_sample(segments):
    """``ops.cherenkov_track.track_backward_sample`` (the plain loop here)
    against ``theia_tpu``'s (N, S) construction and the float64 oracle:
    the total, k, and the chosen candidate being candidate k."""
    from theia_tpu_torch.light import _ft_factor
    from theia_tpu_torch.ops.cherenkov_track import segment_table, track_backward_sample

    source = track_line_source(theia_tpu_torch, "track", segments) if segments != 2 else bent_track(theia_tpu_torch)
    jsource = track_line_source(theia_tpu, "track", segments) if segments != 2 else bent_track(theia_tpu)
    x = inputs(1)
    x["n"][:] = 1.34
    x["obs"] *= 2.0
    j, jd = sample(theia_tpu, jsource, "backward", x)
    verts = source.track.vertices
    n, lam = torch.as_tensor(x["n"]), torch.as_tensor(x["lam"])
    cos = 1.0 / n
    sin = torch.sqrt(1.0 - cos * cos)
    u = mod(theia_tpu_torch, "random").PhiloxRNG(key=0xC0FFEE).state(torch.arange(N, dtype=torch.int32)).uniform()[0]
    total, pos, _, time, k = track_backward_sample(
        segment_table(torch.as_tensor(verts)), torch.as_tensor(x["obs"]), torch.as_tensor(x["nrm"]),
        _ft_factor(True, n, lam), cos / torch.clamp_min(sin, 1e-7), u,
    )
    total, pos, time, k = (a.numpy() for a in (total, pos, time, k))
    np.testing.assert_allclose(total, j["contrib"], rtol=1e-5, atol=1e-6 * np.abs(j["contrib"]).max())
    ft = _ft_factor(True, n, lam).double().numpy()[:, None]
    contrib, c_pos, c_time = track_oracle(verts, x["obs"].astype(np.float64), x["nrm"].astype(np.float64), 1.34, ft)
    np.testing.assert_allclose(total, contrib.sum(1), rtol=1e-4, atol=1e-6 * contrib.sum(1).max())
    assert (total > 0).mean() > 0.3
    # k: the float64 oracle's #(cum < u total) but where the running sum meets u total within rounding
    cum = np.cumsum(contrib, axis=1)
    thresh = u.double().numpy()[:, None] * contrib.sum(1, keepdims=True)
    oracle_k = np.minimum((cum < thresh).sum(1), segments - 1)
    near = (np.abs(cum - thresh) <= 1e-5 * np.maximum(thresh, 1e-30)).any(1)
    live = total > 0
    rows = np.arange(N)
    assert (contrib[rows, k][live] > 0).all(), "a chosen candidate carries no light"
    differ = (k != oracle_k) & live
    # theia_tpu's chosen sample: the same point and time as the port's, but where the association decides
    moved = (np.abs(pos - j["position"]).max(1) > 1e-4 * np.abs(c_pos).max()) & live
    print(f"track {segments} segments: k differs from the oracle's on {int(differ.sum())} and the sample from "
          f"theia_tpu's on {int(moved.sum())} of {int(live.sum())} live lanes; {int((near & live).sum())} live lanes near a tie")
    assert not (differ & ~near).any() and not (moved & ~near).any() and max(differ.mean(), moved.mean()) <= 0.01
    np.testing.assert_allclose(pos[live], c_pos[rows, k][live], atol=1e-4 * np.abs(c_pos).max())
    np.testing.assert_allclose(time[live], c_time[rows, k][live], atol=1e-5 * np.abs(c_time).max())


def test_track_backward_gradient_matches_jax():
    """The backward sample's total, position and time in the index of
    refraction, the wavelength and the track's vertices against jax.grad,
    on a loss linear in them."""
    x = inputs(2)
    x["obs"] *= 2.0
    verts = track_line_source(theia_tpu, "track", 8).track.vertices
    w = np.random.default_rng(3).normal(size=(3, N)).astype(np.float32)

    def jloss(track, n, lam):
        src = mod(theia_tpu, "light").CherenkovTrackLightSource(usePhotonCount=True)
        c = mod(theia_tpu, "material").MediumConstants(n=n, vg=n * 0 + 0.22, mu_s=n * 0, mu_e=n * 0)
        rng = mod(theia_tpu, "random").PhiloxRNG(key=5).state(jnp.arange(N, dtype=jnp.uint32))
        ray, _ = src.sample_backward({"track": track}, jnp.asarray(x["obs"]), jnp.asarray(x["nrm"]), lam, c, rng)
        return (w[0] * ray.contrib).sum() + (w[1] * ray.start_time).sum() + (w[2] * ray.position[:, 0]).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(verts), jnp.asarray(x["n"]), jnp.asarray(x["lam"]))
    track, n, lam = (torch.tensor(a, requires_grad=True) for a in (verts, x["n"], x["lam"]))
    src = mod(theia_tpu_torch, "light").CherenkovTrackLightSource(usePhotonCount=True)
    c = mod(theia_tpu_torch, "material").MediumConstants(n=n, vg=n * 0 + 0.22, mu_s=n * 0, mu_e=n * 0)
    rng = mod(theia_tpu_torch, "random").PhiloxRNG(key=5).state(torch.arange(N, dtype=torch.int32))
    ray, _ = src.sample_backward({"track": track}, torch.as_tensor(x["obs"]), torch.as_tensor(x["nrm"]), lam, c, rng)
    w_t = torch.as_tensor(w)
    ((w_t[0] * ray.contrib).sum() + (w_t[1] * ray.start_time).sum() + (w_t[2] * ray.position[:, 0]).sum()).backward()
    for name, got, want in zip(("track", "n", "wavelength"), (track.grad, n.grad, lam.grad), jg):
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max(), err_msg=name)


# ------------------------------------------------------------------ volume runs of phase 3m


def jax_dims(jt, backward: bool):
    """One JAX batch: (params, response state, each lane's last dims); the
    backward tracer has no dims hook, so its batch runs eagerly and the
    dims are those of its last ``_merge_dim``."""
    p = jt.params()
    if not backward:
        jt._debug_rng = True
        state, _, dims = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
        jt._debug_rng = False
        return p, state, np.asarray(dims).astype(np.int64)
    seen, merge = [], jbackward._merge_dim

    def recorded(after, before, take):
        seen.append(merge(after, before, take))
        return seen[-1]

    jbackward._merge_dim = recorded
    try:
        with jax.disable_jit():
            state, _ = jt._trace_batch(p, jt.rng.counter_words, jt.streams())
    finally:
        jbackward._merge_dim = merge
    return p, state, np.asarray(seen[-1].dim).astype(np.int64)


def run_both(build, backward: bool):
    jt, tt = build(theia_tpu), build(theia_tpu_torch, "cpu")
    assert (jt.nRNGSamples, jt.maxHitsPerThread) == (tt.nRNGSamples, tt.maxHitsPerThread)
    p, js, jd = jax_dims(jt, backward)
    tp = params_from_numpy(numpy_tree(p), "cpu")
    tt._debug_rng = True
    with torch.no_grad():
        ts, _, td = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    np.testing.assert_array_equal(td.numpy().astype(np.int64), jd)
    jh = np.asarray(jt.response.result(p["response"], js), np.float64)
    th = tt.response.result(tp["response"], ts).double().numpy()
    assert jh.sum() > 0 and np.isfinite(th).all()
    assert abs(th.sum() / jh.sum() - 1.0) <= 1e-4, th.sum() / jh.sum() - 1.0
    assert np.abs(th - jh).max() <= 1e-4 * jh.max(), np.abs(th - jh).max() / jh.max()
    return jd, th


RUNS = {
    "cherenkov-muon": (lambda pkg, dev=None: build_cherenkov_volume(pkg, N, dev, source="muon"), False),
    "cherenkov-cascade": (lambda pkg, dev=None: build_cherenkov_volume(pkg, N, dev, source="cascade"), False),
    "cascade-backward": (lambda pkg, dev=None: build_cherenkov_backward(pkg, N, dev, source=cascade_source(pkg)), True),
    "track-backward": (lambda pkg, dev=None: build_cherenkov_backward(
        pkg, N, dev, source=track_line_source(pkg, "track")), True),
    "track-backward, 256 segments": (lambda pkg, dev=None: build_cherenkov_backward(
        pkg, N, dev, source=track_line_source(pkg, "track", 256)), True),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_volume_run_matches_jax(run):
    build, backward = RUNS[run]
    dims, _ = run_both(build, backward)
    if run == "cherenkov-cascade":
        # wavelength 1, then the gamma draw's 1 + 2 R and the emission angle's 2 before the tracer's draws
        assert dims.min() > 1 + 1 + 2 + 2
