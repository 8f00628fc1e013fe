"""The port's planar target guides (``FlatTargetGuide``,
``DiskTargetGuide``) against the live ``theia_tpu`` on the CPU: ``sample``
and ``eval`` on the same observers, directions and streams; the port's
own sample/eval consistency (``tests/test_targets.py:91``); the wrong-side
gate and the overflow guard; then a batch of the brute-force flagship scene
guided by a ``DiskTargetGuide`` of its detector sphere.

Tolerances and why:
(a) guide samples and evaluations: directions within 2e-6, distances and
    probabilities within 1e-5 of their own value plus 1e-5 of the largest
    finite one (the same float32 operations; XLA's and torch's CPU float32
    products round alike, the square roots both correctly rounded), but on
    at most 0.1 % of the lanes, whose directions graze the plane, so that
    t = -z / d_z turns an ulp of d_z into more (measured: 2 lanes of
    4,096, 1.1e-4 relative); infinities equal.
(b) sample/eval consistency as ``theia_tpu``'s own test: pdfs within rtol
    1e-3, distances within 1e-4.
(c) the guided flagship batch as tests/test_torch_brute.py's: RNG dims
    equal on >= 99.5 % of the lanes, histogram sum within 1e-5, per-bin L1
    within 1 % (grazing soup hits differ by ulps of t, which can turn a
    lane's path).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch
from torch_flagship import build_flagship, icosphere

torch.set_num_threads(1)

N = 4096
#: lanes whose distance or pdf may exceed (a)'s tolerance: a direction that
#: grazes the plane turns an ulp of it into a relative error of t = -z / d_z
GRAZING_SHARE = 1e-3
GUIDES = {
    "flat": lambda m: m.FlatTargetGuide(width=2.0, height=3.0, position=(0.5, -1.0, 5.0), normal=(0.2, 0.1, 1.0)),
    "disk": lambda m: m.DiskTargetGuide(radius=1.5, position=(0.5, -1.0, 5.0), normal=(0.2, 0.1, 1.0)),
    "disk, tilted up": lambda m: m.DiskTargetGuide(radius=0.6, position=(0.0, 3.0, 0.0), normal=(1.0, -1.0, 0.0),
                                                   up=(0.0, 0.0, 1.0)),
}


def observers_and_directions(seed: int, centre):
    """Observers on both sides of a guide's plane (and a few on its centre),
    directions random and aimed near the centre."""
    rs = np.random.default_rng(seed)
    obs = (np.asarray(centre) + rs.uniform(-10.0, 10.0, (N, 3))).astype(np.float32)
    obs[:8] = centre  # on the plane's centre: d2 floors at 1e-30
    aim = np.asarray(centre) + rs.normal(scale=1.0, size=(N, 3)) - obs
    d = np.where(rs.uniform(size=(N, 1)) < 0.5, aim, rs.normal(size=(N, 3)))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return obs, d


def run(pkg, name, obs, d):
    guide = GUIDES[name](importlib.import_module(f"{pkg.__name__}.target"))
    rnd = importlib.import_module(f"{pkg.__name__}.random")
    if pkg is theia_tpu:
        p, arr, lanes = guide.params(), jnp.asarray, jnp.arange(N, dtype=jnp.uint32)
    else:
        p, arr, lanes = guide.params("cpu"), torch.as_tensor, torch.arange(N, dtype=torch.int32)
    sample, rng = guide.sample(p, arr(obs), rnd.PhiloxRNG(key=11).state(lanes))
    ev = guide.eval(p, arr(obs), arr(d))
    ev_at_sample = guide.eval(p, arr(obs), sample.direction)
    out = lambda g: {k: np.asarray(getattr(g, k)) for k in ("direction", "dist", "prob")}
    return out(sample), out(ev), out(ev_at_sample), np.asarray(rng.dim)


def assert_guide_close(t, j, label):
    np.testing.assert_allclose(t["direction"], j["direction"], atol=2e-6, err_msg=label)
    for key in ("dist", "prob"):
        finite = np.isfinite(j[key])
        np.testing.assert_array_equal(np.isfinite(t[key]), finite, err_msg=f"{label} {key}")
        scale = max(float(np.abs(j[key][finite]).max(initial=0.0)), 1e-30)
        diff = np.abs(np.where(finite, t[key] - j[key], 0.0))
        grazing = diff > 1e-5 * (np.abs(np.where(finite, j[key], 0.0)) + scale)
        print(f"{label} {key}: {int(grazing.sum())} grazing lanes past the tolerance")
        assert grazing.mean() <= GRAZING_SHARE, (label, key, int(grazing.sum()))


@pytest.mark.parametrize("name", sorted(GUIDES))
def test_guide_matches_jax(name):
    guide = GUIDES[name](theia_tpu_torch.target)
    obs, d = observers_and_directions(len(name), guide.position)
    jout, tout = run(theia_tpu, name, obs, d), run(theia_tpu_torch, name, obs, d)
    for label, j, t in zip(("sample", "eval", "eval at the sample"), jout[:3], tout[:3]):
        assert_guide_close(t, j, f"{name}: {label}")
        assert (j["prob"] > 0).mean() > 0.01 and (j["prob"] == 0).mean() > 0.01, f"{name}: {label}"
    np.testing.assert_array_equal(tout[3], jout[3])


@pytest.mark.parametrize("kind", ["flat", "disk"])
def test_guides_sample_eval_consistent(kind):
    """tests/test_targets.py::test_guides_sample_eval_consistent on the
    port: eval() at a sampled direction gives the sample's pdf."""
    tgt = theia_tpu_torch.target
    guide = (tgt.FlatTargetGuide(width=2.0, height=3.0, position=(0.0, 0.0, 5.0)) if kind == "flat"
             else tgt.DiskTargetGuide(radius=1.5, position=(0.0, 0.0, 5.0)))
    p = guide.params("cpu")
    # the guides' normals are +z: the observer on the normal's side sees its
    # sampled directions oppose it (the wrong-side gate)
    observer = torch.tensor([[0.2, -0.3, 10.0]]).expand(N, 3).contiguous()
    smp, _ = guide.sample(p, observer, theia_tpu_torch.random.PhiloxRNG(key=0xC0FFEE).state(torch.arange(N, dtype=torch.int32)))
    ev = guide.eval(p, observer, smp.direction)
    valid = smp.prob > 0
    assert valid.double().mean() > 0.9
    np.testing.assert_allclose(ev.prob[valid].numpy(), smp.prob[valid].numpy(), rtol=1e-3)
    np.testing.assert_allclose(ev.dist[valid].numpy(), smp.dist[valid].numpy(), rtol=1e-4)
    # from behind the plane every sample is gated out
    behind = observer * torch.tensor([1.0, 1.0, -1.0])
    assert (guide.sample(p, behind, theia_tpu_torch.random.PhiloxRNG(key=1).state(
        torch.arange(N, dtype=torch.int32)))[0].prob == 0).all()


def test_guide_overflow_gives_zero():
    """A direction grazing the plane: the area-to-solid-angle factor
    overflows to inf, which both packages turn into a zero pdf."""
    obs = np.asarray([[0.0, 0.0, 1e-3], [0.0, 0.0, 2.0]], np.float32)
    d = np.asarray([[1.0, 0.0, -1e-36], [0.0, 0.0, -1.0]], np.float32)
    for pkg in (theia_tpu, theia_tpu_torch):
        guide = importlib.import_module(f"{pkg.__name__}.target").FlatTargetGuide(width=1e9, height=1e9)
        p = guide.params() if pkg is theia_tpu else guide.params("cpu")
        arr = jnp.asarray if pkg is theia_tpu else torch.as_tensor
        prob = np.asarray(guide.eval(p, arr(obs), arr(d)).prob)
        assert prob[0] == 0.0 and prob[1] > 0.0, (pkg.__name__, prob)


def test_disk_guided_flagship_matches_jax():
    """One batch of the brute-force flagship scene with a DiskTargetGuide
    of its detector sphere (tests/torch_flagship.py ``guide="disk"``)."""
    mesh = icosphere(2)
    jt = build_flagship(theia_tpu, mesh, N, 6, accel="auto", guide="disk")
    jt._debug_rng = True
    p = jt.params()
    js, _, jd = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    jh = np.asarray(jt.response.result(p["response"], js), np.float64)
    tt = build_flagship(theia_tpu_torch, mesh, N, 6, accel="auto", guide="disk", device="cpu")
    assert tt.scene.accel == "brute" and type(tt.targetGuide).__name__ == "DiskTargetGuide"
    tt._debug_rng = True
    tp = tt.params()
    with torch.no_grad():
        ts, _, td = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    th = tt.response.result(tp["response"], ts).double().numpy()
    same = (td.numpy().astype(np.int64) == np.asarray(jd)).mean()
    assert same >= 0.995, same
    assert jh.sum() > 0 and np.isfinite(th).all()
    assert abs(th.sum() / jh.sum() - 1.0) <= 1e-5, th.sum() / jh.sum() - 1.0
    assert np.abs(th - jh).sum() / jh.sum() <= 1e-2
