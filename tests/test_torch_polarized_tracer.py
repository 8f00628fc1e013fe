"""The slice as a whole: the port's polarized flagship on the Woop query
against the live JAX tracer on CPU (accel="woop", polarized=True, batch
4096, path length 10, PhiloxRNG(key=42), the same icosphere in both
packages). tests/test_torch_polarized_offcenter.py runs the off-centre
source, where polarization changes the light curve.

Tolerances and why (those of tests/test_torch_scene_tracer.py):
(a) final per-lane RNG dims equal on >= 99.5 % of lanes: they match bit
    for bit until a lane takes another branch, and ulp differences of
    transcendentals and of the Woop reciprocal flip a few comparisons.
    Measured: every lane equal.
(b) histogram sums within rtol 1e-3 and per-bin L1 difference at most 1 %
    of the total: ulp differences move each lane's contribution by ~1e-6
    and a rare flipped lane its whole contribution. Measured: L1 7.7e-8.
(d) the port run with params_from_numpy(JAX params), the Woop pack
    included, equals the port run with its own params bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

import theia_tpu
import theia_tpu_torch
from theia_tpu_torch.interop import params_from_numpy
from torch_flagship import build_flagship, icosphere, numpy_tree

# the suite runs several xdist workers on one shared CPU: torch's intra-op
# threads in each of them oversubscribe it (the port's tests took 10x
# longer with the default thread count than with one thread per worker)
torch.set_num_threads(1)

BATCH = 4096
MAX_PATH = 10


def hist_stats(got, want):
    """(|sum ratio - 1|, per-bin L1 difference / total)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return abs(got.sum() / want.sum() - 1.0), np.abs(got - want).sum() / want.sum()


def trace_both(batch, source_position=(3.0, 0.0, 0.0), polarized=True):
    """The JAX and the port's tracer on one configuration, each run once
    with the ``_debug_rng`` hook: returns (jax tracer, jax params, jax
    histogram, jax dims, port tracer, port histogram, port dims)."""
    mesh = icosphere(3)
    kw = dict(accel="woop", polarized=polarized, source_position=source_position)
    jt = build_flagship(theia_tpu, mesh, batch, MAX_PATH, **kw)
    jt._debug_rng = True
    p = jt.params()
    j_state, _, j_dims = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    j_hist = np.asarray(jt.response.result(p["response"], j_state))

    tt = build_flagship(theia_tpu_torch, mesh, batch, MAX_PATH, device="cpu", **kw)
    assert tt.nRNGSamples == jt.nRNGSamples
    tt._debug_rng = True
    tp = tt.params()
    with torch.no_grad():
        t_state, _, t_dims = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    t_hist = tt.response.result(tp["response"], t_state).numpy()
    tt._debug_rng = False
    return jt, p, j_hist, np.asarray(j_dims), tt, t_hist, t_dims.numpy()


@pytest.fixture(scope="module")
def runs():
    jt, p, j_hist, j_dims, tt, t_hist, t_dims = trace_both(BATCH)
    assert tt.scene.pack.woop is not None and tt.scene.pack.mt is None
    interop = params_from_numpy(numpy_tree(p), "cpu")
    hist, _ = tt.run(params=interop, advance=False)
    return dict(
        j_hist=j_hist, j_dims=j_dims, t_hist=t_hist, t_dims=t_dims,
        t_hist_interop=hist.numpy(), interop=interop,
    )


def test_rng_dims_match(runs):
    same = runs["t_dims"] == runs["j_dims"]
    assert runs["j_dims"].max() > 40  # paths really ran many segments
    assert same.mean() >= 0.995, same.mean()


def test_histogram_matches(runs):
    assert np.isfinite(runs["t_hist"]).all() and runs["t_hist"].sum() > 0
    d_sum, l1 = hist_stats(runs["t_hist"], runs["j_hist"])
    assert d_sum <= 1e-3, d_sum
    assert l1 <= 1e-2, l1


def test_params_from_numpy_bit_equal(runs):
    woop = runs["interop"]["scene"].woop
    assert woop is not None and woop.n_tri == 3840
    np.testing.assert_array_equal(runs["t_hist_interop"], runs["t_hist"])


def test_cpu_run_launches_no_kernel(runs):
    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt
    from theia_tpu_torch.ops.intersect_woop import nearest_triangle_woop
    from theia_tpu_torch.response import histogram_add

    assert nearest_triangle_woop.launches == nearest_triangle_mt.launches == 0
    assert histogram_add.launches == 0
