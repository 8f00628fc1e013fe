"""The port's tracers with a ``SobolQRNG`` against the live ``theia_tpu``
on the CPU: the brute-force flagship (``__graft_entry__._build_scene_tracer
(rng="sobol")``'s ``SobolQRNG(seed=42, dims=128)``, path length 3) and
the polarized Woop flagship with the same generator, the
volume flagship with example 11's ``SobolQRNG(seed=1, dims=64)``,
unpolarized and polarized, and with 8 dims, where most lanes draw from
the Philox tail,
and the volume photon tracer, ``run()`` and ``run_compacted()``. The
kernel's own test on a card is in ``test_torch_cuda_kernels.py``, a file
that does not import JAX.

Tolerances and why (those of the Philox tests of the same tracers):
(a) final per-lane RNG dims equal on >= 99.5 % of lanes: the dims decide
    which Sobol dimension every later draw reads.
(b) the flagships: histogram sum within rtol 1e-3 and per-bin L1 at most
    1 % of the total (``test_torch_scene_tracer.py`` (b): ulp differences
    of transcendentals and of the Moeller-Trumbore reciprocal, and the
    rare lane that flips a comparison).
(c) the volume and photon tracers: sum within rtol 1e-5, every bin within
    1e-5 of the largest bin (``test_torch_volume.py`` (b),
    ``test_torch_photon.py`` (b)).
(d) ``run_compacted()`` against ``run()`` of the port: rtol 1e-6, atol
    1e-7 of the largest bin (``test_torch_photon.py`` (d)).
"""

import warnings

import numpy as np
import pytest
import torch

import jax

import theia_tpu
import theia_tpu_torch
from theia_tpu_torch.interop import params_from_numpy
from torch_flagship import build_flagship, build_volume_flagship, build_volume_photon, icosphere, numpy_tree

torch.set_num_threads(1)

FLAGSHIP_SOBOL = lambda rnd: rnd.SobolQRNG(seed=42, dims=128)
EXAMPLE_11_SOBOL = lambda rnd: rnd.SobolQRNG(seed=1, dims=64)  # examples/11_quasirandom_sampling.py


def trace_both(jt, tt):
    """One batch of each tracer on the JAX tracer's parameters carried
    over; returns (JAX result, port result, JAX dims, port dims)."""
    jt._debug_rng = tt._debug_rng = True
    p = jt.params()
    js, _, jd = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    tp = params_from_numpy(numpy_tree(p), "cpu")
    with torch.no_grad():
        ts, _, td = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    jt._debug_rng = tt._debug_rng = False
    return (
        np.asarray(jt.response.result(p["response"], js), np.float64),
        tt.response.result(tp["response"], ts).double().numpy(),
        np.asarray(jd).astype(np.int64),
        td.numpy().astype(np.int64),
    )


def assert_close_hist(jh, th, jd, td, rtol):
    same = (jd == td).mean()
    assert same >= 0.995, same
    assert jh.sum() > 0 and np.isfinite(th).all()
    assert abs(th.sum() / jh.sum() - 1.0) <= rtol, th.sum() / jh.sum() - 1.0
    assert np.abs(th - jh).max() <= rtol * jh.max(), np.abs(th - jh).max() / jh.max()


def quiet(build):
    """``build()`` with SobolQRNG's warning about dims past its table
    (example 11's generator on a path of 72 dims) held back."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build()


def test_brute_flagship_with_sobol_matches_jax():
    mesh = icosphere(3)
    jt = build_flagship(theia_tpu, mesh, 4096, 3, accel="auto", rng=FLAGSHIP_SOBOL)
    tt = build_flagship(theia_tpu_torch, mesh, 4096, 3, accel="auto", device="cpu", rng=FLAGSHIP_SOBOL)
    assert tt.scene.accel == "brute" and type(tt.rng).__name__ == "SobolQRNG"
    assert tt.rng.autoAdvance == jt.rng.autoAdvance == 4096
    jh, th, jd, td = trace_both(jt, tt)
    same = (jd == td).mean()
    assert same >= 0.995, same
    assert abs(th.sum() / jh.sum() - 1.0) <= 1e-3
    assert np.abs(th - jh).sum() / jh.sum() <= 1e-2


def test_polarized_woop_flagship_with_sobol_matches_jax():
    """The polarized flagship on the Woop query (unfused records, the
    Stokes transport) with the flagship's generator, path length 3."""
    mesh = icosphere(2)
    jt = build_flagship(theia_tpu, mesh, 2048, 3, accel="woop", polarized=True, rng=FLAGSHIP_SOBOL)
    tt = build_flagship(theia_tpu_torch, mesh, 2048, 3, accel="woop", device="cpu", polarized=True, rng=FLAGSHIP_SOBOL)
    jh, th, jd, td = trace_both(jt, tt)
    same = (jd == td).mean()
    assert same >= 0.995, same
    assert abs(th.sum() / jh.sum() - 1.0) <= 1e-3
    assert np.abs(th - jh).sum() / jh.sum() <= 1e-2


@pytest.mark.parametrize("dims,polarized", [(64, False), (64, True), (8, False)])
def test_volume_flagship_with_example_11_sobol_matches_jax(dims, polarized):
    """Example 11's generator (its budget of 72 dims is past its 64, but
    the flagship's lanes stop by dim 38); with 8 dims most lanes also
    draw from the Philox tail."""
    sobol = lambda rnd: rnd.SobolQRNG(seed=1, dims=dims)
    jt = quiet(lambda: build_volume_flagship(theia_tpu, 2048, rng=sobol, polarized=polarized))
    tt = quiet(lambda: build_volume_flagship(theia_tpu_torch, 2048, "cpu", rng=sobol, polarized=polarized))
    assert tt.nRNGSamples == jt.nRNGSamples == 72
    jh, th, jd, td = trace_both(jt, tt)
    if dims == 8:
        assert (td > dims).mean() > 0.5
    assert_close_hist(jh, th, jd, td, 1e-5)


def test_sobol_batches_and_replicates_advance_like_jax():
    """A second batch takes the next block of ``capacity`` sample indices;
    a new seed between ``run(advance=False)`` calls (example 11's
    replicates) is a new Owen randomization, the same in both packages."""
    jt = quiet(lambda: build_volume_flagship(theia_tpu, 1024, rng=EXAMPLE_11_SOBOL, nScattering=4))
    tt = quiet(lambda: build_volume_flagship(theia_tpu_torch, 1024, "cpu", rng=EXAMPLE_11_SOBOL, nScattering=4))
    first, _ = tt.run()
    jt.run()
    assert tt.rng.offset == jt.rng.offset == 1024
    assert tt.rng.counter_words == tuple(int(w) for w in np.asarray(jt.rng.counter_words))
    jh, th, jd, td = trace_both(jt, tt)
    assert_close_hist(jh, th, jd, td, 1e-5)
    replicates = []
    for r in range(2):
        jt.rng.seed = tt.rng.seed = 0x9E3779B9 * (r + 1) & 0xFFFFFFFF
        replicates.append(tt.run(advance=False)[0].double().numpy())
        jh, th, jd, td = trace_both(jt, tt)
        assert_close_hist(jh, th, jd, td, 1e-5)
        np.testing.assert_array_equal(th, replicates[-1])
    assert tt.rng.offset == 1024 and not np.array_equal(replicates[0], replicates[1])
    assert not np.array_equal(first.double().numpy(), replicates[0])


def test_volume_photon_with_sobol_matches_jax_and_compacts():
    """``run_compacted()`` keeps each survivor's lane id, so its Sobol
    index (lane + offset) and dims are those of ``run()``."""
    sobol = lambda rnd: rnd.SobolQRNG(seed=7, dims=32)
    jt = quiet(lambda: build_volume_photon(theia_tpu, 2048, rng=sobol))
    tt = quiet(lambda: build_volume_photon(theia_tpu_torch, 2048, "cpu", rng=sobol))
    jh, th, jd, td = trace_both(jt, tt)
    assert_close_hist(jh, th, jd, td, 1e-5)
    run = tt.run(advance=False)[0].double().numpy()
    compacted = tt.run_compacted(advance=False, min_lanes=64).double().numpy()
    assert tt.compaction_overflow == 0 and min(tt.compacted_lanes) < 2048
    np.testing.assert_allclose(compacted, run, rtol=1e-6, atol=1e-7 * run.max())
    np.testing.assert_allclose(run, jh, rtol=1e-5, atol=1e-5 * jh.max())
