"""The port's VolumeForwardTracer against the live ``theia_tpu`` on the CPU:
``examples/01_volume_tracing.py``'s configuration (water at 10 degC and
35 PSU, Henyey-Greenstein g = 0.9, a 5 m sphere target) at batch 2048
in every mode, the two mesh-free conformance goldens, the callbacks, the
hit recorder and the energy test of ``tests/test_trace_volume.py``.

Tolerances and why:
(a) final per-lane RNG dims equal on >= 99.5 % of lanes (measured: all
    of them). The dims decide which Philox words every later draw reads.
(b) histogram sum within rtol 1e-5 and every bin within 1e-5 of the
    largest bin: the same float32 ops in the same order on every lane,
    so only transcendentals (exp, log, sqrt, sin, cos; an ulp apart
    between XLA and torch on the CPU) and the histogram's summation order
    separate the two (measured: 4e-8 to 4e-7). The direct light fills
    bins 1-4 and dwarfs the scattered tail, so the tail (bins 5 on) is
    also held on its own: summed differences within 1e-5 of its sum
    (measured 5.8e-7), where polarization moves it by 8.8e-4.
(c) the goldens: each file's own ``meta["tol"]`` through
    ``tools/ref_conformance.compare`` (hist and hist_runs rtol 1e-4 of
    the largest bin, rng_dims exact, rng_draws within 2^-24).
(d) the energy estimate within 2 % of the budget, as
    ``test_volume_forward_quick`` holds ``theia_tpu``.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import theia_tpu
import theia_tpu_torch
from theia_tpu_torch.interop import params_from_numpy
from torch_flagship import build_volume_flagship, numpy_tree, water_medium

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from ref_conformance import compare  # noqa: E402

torch.set_num_threads(1)

BATCH = 2048
GOLDENS = Path(__file__).parent / "goldens"


def _pol_medium(pkg):
    """The flagship's water with phase-matrix tables (one seed in both
    packages), so that polarization changes the light curve."""
    base = water_medium(pkg.material)
    rng = np.random.default_rng(9)
    tables = {f"phase_{k}": rng.uniform(-0.6, 0.6, 129).astype(np.float32) for k in ("m12", "m33", "m34")}
    tables["phase_m22"] = rng.uniform(0.7, 1.0, 129).astype(np.float32)
    return dataclasses.replace(base, **tables)


MODES = {
    "default": {},
    "polarized": dict(polarized=True),
    "no_direct": dict(disableDirectLighting=True),
    "no_target_sampling": dict(disableTargetSampling=True),
    "polarized_no_target_sampling": dict(polarized=True, disableTargetSampling=True),
    "ref_compat": dict(refCompatRNG=True),
}


def trace_both(jt, tt):
    """One batch of each tracer on the same parameters (the JAX tracer's,
    carried over); returns (JAX hist, port hist, JAX dims, port dims)."""
    jt._debug_rng = tt._debug_rng = True
    p = jt.params()
    js, jcb, jd = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    tp = params_from_numpy(numpy_tree(p), "cpu")
    with torch.no_grad():
        ts, tcb, td = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    jt._debug_rng = tt._debug_rng = False
    return (
        np.asarray(jt.response.result(p["response"], js), np.float64),
        tt.response.result(tp["response"], ts).double().numpy(),
        np.asarray(jd).astype(np.int64),
        td.numpy().astype(np.int64),
        (jt.callback.result(p["callback"], jcb), tt.callback.result(tp["callback"], tcb)),
    )


def assert_agree(jh, th, jd, td):
    same = (jd == td).mean()
    assert same >= 0.995, same
    assert jh.sum() > 0 and np.isfinite(th).all()
    assert abs(th.sum() / jh.sum() - 1.0) <= 1e-5, th.sum() / jh.sum() - 1.0
    assert np.abs(th - jh).max() <= 1e-5 * jh.max(), np.abs(th - jh).max() / jh.max()
    tail = jh[5:].sum()
    assert np.abs(th - jh)[5:].sum() <= 1e-5 * tail, np.abs(th - jh)[5:].sum() / tail


@pytest.mark.parametrize("mode", sorted(MODES))
def test_volume_tracer_matches_jax(mode):
    kw = dict(MODES[mode])
    if kw.get("polarized"):
        jt = build_volume_flagship(theia_tpu, BATCH, medium=_pol_medium(theia_tpu), **kw)
        tt = build_volume_flagship(theia_tpu_torch, BATCH, "cpu", medium=_pol_medium(theia_tpu_torch), **kw)
    else:
        jt = build_volume_flagship(theia_tpu, BATCH, **kw)
        tt = build_volume_flagship(theia_tpu_torch, BATCH, "cpu", **kw)
    assert (tt.nRNGSamples, tt.pathLength, tt.maxHitsPerThread) == (jt.nRNGSamples, jt.pathLength, jt.maxHitsPerThread)
    jh, th, jd, td, _ = trace_both(jt, tt)
    assert_agree(jh, th, jd, td)


def test_polarization_moves_the_light_curve():
    """The polarized mode's medium has phase-matrix tables, so the
    polarized light curve differs from the unpolarized one on the same
    streams: the comparison above tests the Stokes transport. The direct
    light (bins 1-4) is unpolarized; the scattered tail moves."""
    kw = dict(medium=_pol_medium(theia_tpu_torch))
    a, _ = build_volume_flagship(theia_tpu_torch, BATCH, "cpu", **kw).run()
    b, _ = build_volume_flagship(theia_tpu_torch, BATCH, "cpu", polarized=True, **kw).run()
    a, b = a.double().numpy()[5:], b.double().numpy()[5:]
    assert np.abs(b - a).sum() / a.sum() > 1e-4, np.abs(b - a).sum() / a.sum()


def test_second_batch_advances_like_jax():
    jt = build_volume_flagship(theia_tpu, BATCH)
    tt = build_volume_flagship(theia_tpu_torch, BATCH, "cpu")
    jt.run(), tt.run()
    assert jt.rng.offset == tt.rng.offset == jt.nRNGSamples
    jh, th, jd, td, _ = trace_both(jt, tt)
    assert_agree(jh, th, jd, td)


def test_callbacks_match_jax():
    """EventStatisticCallback's counts equal ``theia_tpu``'s; the
    TrackRecordCallback (polarized, 11 columns) records the same lengths,
    codes and points (rtol 1e-5 of a track's scale)."""
    for pkg_cb in ("EventStatisticCallback", "TrackRecordCallback"):
        kw = {} if pkg_cb == "EventStatisticCallback" else {"polarized": True}
        jt = build_volume_flagship(theia_tpu, 512, callback=getattr(theia_tpu.callback, pkg_cb)(**kw), polarized=True)
        tt = build_volume_flagship(
            theia_tpu_torch, 512, "cpu", callback=getattr(theia_tpu_torch.callback, pkg_cb)(**kw), polarized=True
        )
        jh, th, jd, td, (jcb, tcb) = trace_both(jt, tt)
        assert_agree(jh, th, jd, td)
        if pkg_cb == "EventStatisticCallback":
            assert jcb == tcb and tcb["created"] == 512 and tcb["scattered"] > 0, (jcb, tcb)
        else:
            for k in ("length", "code"):
                np.testing.assert_array_equal(tcb[k], jcb[k], err_msg=k)
            assert tcb["track"].shape == jcb["track"].shape == (512, tt.pathLength + 3, 11)
            scale = np.abs(jcb["track"]).max()
            np.testing.assert_allclose(tcb["track"], jcb["track"], rtol=0, atol=1e-5 * scale)


def test_live_statistics_wait_only_when_asked():
    """``live=True`` copies the running counts to the host every step and
    ends equal to the result; ``live=False`` never does."""
    for live in (False, True):
        cb = theia_tpu_torch.callback.EventStatisticCallback(live=live)
        _, stats = build_volume_flagship(theia_tpu_torch, 256, "cpu", callback=cb).run()
        assert stats["created"] == 256
        assert (cb.statistics == stats) == live


def test_hit_recorder_matches_jax_and_histogram():
    """HitRecorder fills the same slots as ``theia_tpu``'s (record-call
    major, lane order), and binning its hits gives the histogram response
    (``test_histogram_matches_recorder``'s check, rtol 2e-3)."""
    jt = build_volume_flagship(theia_tpu, 1024, response=theia_tpu.response.HitRecorder())
    tt = build_volume_flagship(theia_tpu_torch, 1024, "cpu", response=theia_tpu_torch.response.HitRecorder())
    assert tt.response._capacity == jt.response._capacity == 1024 * tt.maxHitsPerThread
    jrec, _ = jt.run()
    trec, _ = tt.run()
    valid = trec["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(jrec["valid"]))
    assert int(trec["cursor"]) == int(jrec["cursor"]) == valid.sum() > 100 and int(trec["overflow"]) == 0
    for k in ("time", "contrib", "position", "normal", "direction"):
        want = np.asarray(jrec[k])[valid]
        np.testing.assert_allclose(trec[k].numpy()[valid], want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=k)
    hist, _ = build_volume_flagship(theia_tpu_torch, 1024, "cpu").run()
    expected, _ = np.histogram(
        trec["time"].numpy()[valid], bins=100, range=(0.0, 500.0),
        weights=(trec["contrib"].numpy()[valid] / 1024).astype(np.float64),
    )
    np.testing.assert_allclose(hist.numpy(), expected, rtol=2e-3, atol=1e-8 * expected.max())


def test_energy_inner_sphere():
    """``tests/test_trace_volume.py``'s energy test on the port: a spherical
    source inside an ``InnerSphereTarget``; undoing the absorption along
    each recorded hit's path gives back the budget."""
    mat = theia_tpu_torch.material

    class Model(mat.DispersionFreeMedium, mat.HenyeyGreensteinPhaseFunction, mat.MediumModel):
        ModelName = "homogenous"

        def __init__(self):
            mat.DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=0.0, mu_s=0.005)
            mat.HenyeyGreensteinPhaseFunction.__init__(self, 0.0)

    position, budget, t0, batch = (12.0, 15.0, 0.2), 1e9, 10.0, 32 * 1024
    tracer = theia_tpu_torch.trace.VolumeForwardTracer(
        batch,
        theia_tpu_torch.light.SphericalLightSource(position=position, timeRange=(t0, t0), budget=budget),
        theia_tpu_torch.target.InnerSphereTarget(position=position, radius=100.0),
        theia_tpu_torch.light.UniformWavelengthSource(lambdaRange=(400.0, 400.0)),
        theia_tpu_torch.response.HitRecorder(),
        theia_tpu_torch.random.PhiloxRNG(key=0xC0FFEE),
        medium=Model().createMedium(),
        maxTime=float("inf"),
        nScattering=10,
        scatterCoefficient=0.05,
        callback=theia_tpu_torch.callback.EventStatisticCallback(),
        device="cpu",
    )
    total = 0.0
    for _ in range(2):
        hits, stats = tracer.run()
        valid = hits["valid"].numpy()
        total += hits["contrib"].numpy()[valid].astype(np.float64).sum()  # mu_a = 0: nothing to undo
        assert stats["created"] == batch
    assert abs(total / (2 * batch) / budget - 1.0) < 0.02


def _golden_tracer(name, batch):
    """``tools/ref_conformance.py``'s c1 and c2 configurations on the port."""
    P = theia_tpu_torch
    mat = P.material

    if name == "c1_volume_homogeneous":
        class Homogeneous(mat.DispersionFreeMedium, mat.HenyeyGreensteinPhaseFunction, mat.MediumModel):
            ModelName = "homogenous"

            def __init__(self):
                mat.DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=0.05, mu_s=0.02)
                mat.HenyeyGreensteinPhaseFunction.__init__(self, 0.2)

        return P.trace.VolumeForwardTracer(
            batch,
            P.light.SphericalLightSource(position=(1.0, 0.0, 0.0), timeRange=(0.0, 10.0), budget=1e5),
            P.target.SphereTarget(position=(-1.0, 0.0, 0.0), radius=0.5),
            P.light.ConstWavelengthSource(500.0),
            P.response.HistogramHitResponse(nBins=100, binSize=5.0, t0=0.0),
            P.random.PhiloxRNG(key=42),
            medium=Homogeneous().createMedium(num_lambda=8, num_theta=256),
            scatterCoefficient=0.05,
            nScattering=10,
            refCompatRNG=True,
            device="cpu",
        )
    water = water_medium(mat, num_lambda=64, num_theta=256)
    return build_volume_flagship(P, batch, "cpu", medium=water, refCompatRNG=True)


@pytest.mark.parametrize("name", ["c1_volume_homogeneous", "c2_volume_hg"])
def test_golden(name):
    """The port reproduces the mesh-free goldens at their own batch
    (16,384, ``tools/ref_conformance.py`` DEFAULT_BATCH): the mean and
    per-batch light curves of two batches, the final RNG dims of a
    256-lane probe after them, and the raw Philox words of 16 streams.
    c2's ``grad_*`` keys are left out: the gradients of the volume path
    are the next item of the port (ROADMAP.md queue 1 item 3)."""
    from theia_tpu_torch.random import philox_uniform

    with np.load(GOLDENS / f"{name}.npz", allow_pickle=False) as f:
        golden = dict(f)
    meta = json.loads(str(golden["meta"]))
    tracer = _golden_tracer(name, meta["batch"])
    assert [tracer.rng.key] == meta["keys"] and [tracer.nRNGSamples] == meta["nRNGSamples"]
    runs = np.stack([tracer.run()[0].double().numpy() for _ in range(meta["n_runs"])])
    tracer._debug_rng = True
    p = tracer.params()
    with torch.no_grad():
        dims = tracer._trace_batch(p, tracer.rng.counter_words, torch.arange(256, dtype=torch.int32))[-1]
    n = tracer.nRNGSamples
    stream = torch.arange(16, dtype=torch.int32).repeat_interleave(n)
    dim = torch.arange(n, dtype=torch.int32).repeat(16)
    draws = philox_uniform(tracer.rng.key_words, (0, 0, 0, 0), stream, dim).reshape(16, n)
    fresh = dict(hist=runs.mean(0), hist_runs=runs, rng_dims=dims.numpy().astype(np.uint32), rng_draws=draws.numpy())
    golden = {k: v for k, v in golden.items() if not k.startswith("grad_")}
    errors = compare(golden, fresh, name)
    assert not errors, "\n".join(errors)
