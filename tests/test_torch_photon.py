"""The port's photon tracers against the live ``theia_tpu`` on the CPU:
``VolumePhotonTracer`` and ``ScenePhotonTracer`` (the latter on the
flagship's brute-force scene with ``__graft_entry__._dryrun_photon_compacted``'s
settings), ``run()`` against ``theia_tpu``'s and ``run_compacted()``
against ``run()``.

Tolerances and why:
(a) final per-lane RNG dims equal on >= 99.5 % of lanes (measured: all).
(b) histograms: sum within rtol 1e-5 and every bin within 1e-5 of the
    largest bin (the same float32 ops on the same lanes; measured 3e-8
    to 1.1e-7).
(c) ``StoreTimeHitResponse``: the same accepted count and, sorted, the
    same times within 1e-5 relative.
(d) ``run_compacted()`` against ``run()`` of the same tracer: survivors
    keep their stream ids and dims, so each lane draws the same words and
    adds the same values in the same record calls; only the histogram's
    float32 summation order can differ (rtol 1e-6, atol 1e-7 of the
    largest bin; ``theia_tpu``'s test allows rtol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax

import theia_tpu
import theia_tpu_torch
from theia_tpu_torch.interop import params_from_numpy
from torch_flagship import build_photon_flagship, build_volume_photon, icosphere, numpy_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return icosphere(2)


def trace_both(jt, tt):
    jt._debug_rng = tt._debug_rng = True
    p = jt.params()
    js, _, jd = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    tp = params_from_numpy(numpy_tree(p), "cpu")
    with torch.no_grad():
        ts, _, td = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    jt._debug_rng = tt._debug_rng = False
    same = (np.asarray(jd).astype(np.int64) == td.numpy()).mean()
    assert same >= 0.995, same
    return jt.response.result(p["response"], js), tt.response.result(tp["response"], ts)


def assert_hist_agree(th, jh):
    th, jh = np.asarray(th, np.float64), np.asarray(jh, np.float64)
    assert jh.sum() > 0 and np.isfinite(th).all()
    assert abs(th.sum() / jh.sum() - 1.0) <= 1e-5, th.sum() / jh.sum() - 1.0
    assert np.abs(th - jh).max() <= 1e-5 * jh.max()


def assert_detections_agree(trec, jrec, least):
    accepted = trec["valid"].numpy()
    assert accepted.sum() == np.asarray(jrec["valid"]).sum() == int(trec["cursor"]) >= least
    t_got = np.sort(trec["time"].numpy()[accepted])
    t_want = np.sort(np.asarray(jrec["time"])[np.asarray(jrec["valid"])])
    np.testing.assert_allclose(t_got, t_want, rtol=1e-5)


def test_volume_photon_matches_jax():
    jt, tt = build_volume_photon(theia_tpu, 2048), build_volume_photon(theia_tpu_torch, 2048, "cpu")
    assert (tt.nRNGSamples, tt._pre_dims, tt._per_run) == (jt.nRNGSamples, jt._pre_dims, jt._per_run)
    assert_hist_agree(*trace_both(jt, tt)[::-1])


def test_volume_photon_store_time_matches_jax():
    """Photon mode's sampler: one draw a record, accepted where it falls
    below the survival chance."""
    jt = build_volume_photon(theia_tpu, 2048, response=theia_tpu.response.StoreTimeHitResponse())
    tt = build_volume_photon(
        theia_tpu_torch, 2048, "cpu", response=theia_tpu_torch.response.StoreTimeHitResponse()
    )
    jrec, trec = trace_both(jt, tt)
    assert_detections_agree(trec, jrec, 50)


@pytest.mark.parametrize("polarized", [False, True])
def test_scene_photon_matches_jax(mesh, polarized):
    jt = build_photon_flagship(theia_tpu, mesh, 2048, polarized=polarized)
    tt = build_photon_flagship(theia_tpu_torch, mesh, 2048, "cpu", polarized=polarized)
    assert tt.nRNGSamples == jt.nRNGSamples and tt.maxPathLength == jt.maxPathLength == 6
    assert_hist_agree(*trace_both(jt, tt)[::-1])


def test_scene_photon_store_time_matches_jax(mesh):
    """Few photons leave the glass shells and reach the detector within
    six segments (9 of 2048); their count and times must agree."""
    jt = build_photon_flagship(theia_tpu, mesh, 2048, response=theia_tpu.response.StoreTimeHitResponse())
    tt = build_photon_flagship(
        theia_tpu_torch, mesh, 2048, "cpu", response=theia_tpu_torch.response.StoreTimeHitResponse()
    )
    jrec, trec = trace_both(jt, tt)
    assert_detections_agree(trec, jrec, 5)


@pytest.mark.parametrize("which", ["volume", "scene"])
def test_run_compacted_matches_run(mesh, which):
    """Two batches of each: ``run_compacted()`` equals ``run()`` of a twin
    tracer, really drops lanes between runs, never loses a live one, and
    advances the offset as ``run()`` does; the compacted histogram also
    equals ``theia_tpu``'s ``run_compacted()``."""
    if which == "volume":
        make = lambda pkg, **kw: build_volume_photon(pkg, 4096, **kw)
    else:
        make = lambda pkg, **kw: build_photon_flagship(pkg, mesh, 4096, **kw)
    plain, comp = make(theia_tpu_torch, device="cpu"), make(theia_tpu_torch, device="cpu")
    jt = make(theia_tpu)
    for _ in range(2):
        h_plain, _ = plain.run()
        h_comp = comp.run_compacted(min_lanes=64)
        h_plain, h_comp = h_plain.numpy(), h_comp.numpy()
        assert h_plain.sum() > 0 and comp.compaction_overflow == 0
        np.testing.assert_allclose(h_comp, h_plain, rtol=1e-6, atol=1e-7 * h_plain.max())
        assert comp.rng.offset == plain.rng.offset
        assert comp.compacted_lanes[-1] < 4096, comp.compacted_lanes
        assert_hist_agree(h_comp, jt.run_compacted(min_lanes=64))


def test_run_compacted_refuses_what_theia_tpu_refuses(mesh):
    rec = build_volume_photon(theia_tpu_torch, 64, "cpu", response=theia_tpu_torch.response.HitRecorder())
    with pytest.raises(ValueError, match="additive response"):
        rec.run_compacted()
    cb = build_volume_photon(theia_tpu_torch, 64, "cpu", callback=theia_tpu_torch.callback.EventStatisticCallback())
    with pytest.raises(ValueError, match="callbacks"):
        cb.run_compacted()
