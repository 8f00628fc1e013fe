"""The rest of the port's SceneForwardTracer against the live ``theia_tpu``
on the CPU: the material-flag matrix (``tests/test_flag_matrix.py``'s
analogue), the five constructor flags, the unguided path, responses that
draw random numbers, the unfused records of polarized runs, and the RNG
draw schedule (``tests/test_rng_schedule.py``'s analogue, final dims
through ``_debug_rng``).

Tolerances and why:
(a) event statistics equal, count for count.
(b) final per-lane RNG dims equal on >= 99.5 % of lanes (measured: all),
    and, for the schedule, equal on every lane to the consumption derived
    from the lane's recorded events.
(c) histograms: sum within rtol 1e-5 and every bin within 1e-5 of the
    largest bin: the same float32 ops on the same lanes, an ulp apart in
    transcendentals and in the nearest-hit's t (the port's scan takes a
    reciprocal and a Newton step where JAX divides; see
    tests/test_torch_brute.py).
(d) ``StoreTimeHitResponse`` and ``HitRecorder``: the same accepted
    count and slots; times and directions within 1e-5 relative.
"""

import importlib

import numpy as np
import pytest
import torch

import jax

import theia_tpu
import theia_tpu_torch
from theia_tpu_torch.interop import params_from_numpy
from torch_flagship import build_flagship, icosphere, numpy_tree

torch.set_num_threads(1)

N = 256


def _mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _dev(pkg):
    return {} if pkg is theia_tpu else {"device": "cpu"}


def trace_both(jt, tt):
    """One batch of each on the JAX tracer's parameters; returns (JAX
    response state result, port's, JAX callback result, port's, dims
    equal share)."""
    jt._debug_rng = tt._debug_rng = True
    p = jt.params()
    js, jcb, jd = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    tp = params_from_numpy(numpy_tree(p), "cpu")
    with torch.no_grad():
        ts, tcb, td = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    jt._debug_rng = tt._debug_rng = False
    same = (np.asarray(jd).astype(np.int64) == td.numpy()).mean()
    return (
        jt.response.result(p["response"], js), tt.response.result(tp["response"], ts),
        jt.callback.result(p["callback"], jcb), tt.callback.result(tp["callback"], tcb),
        same, td.numpy().astype(np.int64),
    )


def assert_hist_agree(jh, th):
    jh, th = np.asarray(jh, np.float64), np.asarray(th, np.float64)
    assert jh.sum() > 0 and np.isfinite(th).all()
    assert abs(th.sum() / jh.sum() - 1.0) <= 1e-5, th.sum() / jh.sum() - 1.0
    assert np.abs(th - jh).max() <= 1e-5 * jh.max(), np.abs(th - jh).max() / jh.max()


# ---------------------------------------------------------------- flag matrix


def _plane(pkg, z=0.0, size=50.0):
    pos = [(-size, -size, z), (size, -size, z), (size, size, z), (-size, size, z)]
    return _mod(pkg, "mesh").Mesh.from_geometry(pos, [(0, 1, 2), (0, 2, 3)])


def _flag_tracer(pkg, flags, polarized=False, outside="water", key=0xF1A6):
    """A pencil beam onto a z = 0 interface (water above, glass below)."""
    mat, scene = _mod(pkg, "material"), _mod(pkg, "scene")
    df = mat.DispersionFreeMedium
    water = df(n=4.0 / 3.0, ng=4.0 / 3.0, mu_a=0.0, mu_s=0.0).createMedium(name="water")
    glass = df(n=1.5, ng=1.5, mu_a=0.0, mu_s=0.0).createMedium(name="glass")
    inside, outside = (glass, "water") if outside == "water" else (None, glass)
    store = mat.MaterialStore.pack([mat.Material("m", inside, outside, flags=flags)], media=[water], **_dev(pkg))
    meshes = scene.MeshStore({"p": _plane(pkg)})
    sc = scene.Scene([meshes.createInstance("p", "m")], store, medium="water", **_dev(pkg))
    light = _mod(pkg, "light")
    return _mod(pkg, "trace.scene").SceneForwardTracer(
        N,
        light.PencilLightSource(
            position=(0.5, 0.3, 2.0), direction=(0.3, 0.0, -0.954), timeRange=(0.0, 0.0), budget=1.0
        ),
        light.UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        _mod(pkg, "response").HistogramHitResponse(nBins=10, binSize=20.0, t0=0.0),
        _mod(pkg, "random").PhiloxRNG(key=key),
        sc,
        maxPathLength=3,
        scatterCoefficient=1e-6,
        maxTime=200.0,
        polarized=polarized,
        callback=_mod(pkg, "callback").EventStatisticCallback(),
        **_dev(pkg),
    )


FLAG_CASES = {
    # flags, polarized: what theia_tpu's flag matrix asserts of the port's stats
    ("B", False): dict(absorbed=N, hit=0),
    ("B", True): dict(absorbed=N, hit=0),
    ("R", False): dict(hit=N, absorbed=0, lost=N),
    ("R", True): dict(hit=N, absorbed=0, lost=N),
    ("T", False): dict(hit=N, lost=N),
    ("T", True): dict(hit=N, lost=N),
    ("", False): dict(absorbed=N),
    ("V", False): dict(volume=N, absorbed=0, lost=N),
    ("RT", False): dict(hit=N, lost=N, absorbed=0),
    ("RT", True): dict(hit=N, lost=N, absorbed=0),
}


@pytest.mark.parametrize("flags,polarized", sorted(FLAG_CASES))
def test_flag_matrix(flags, polarized):
    jt, tt = (_flag_tracer(pkg, flags, polarized) for pkg in (theia_tpu, theia_tpu_torch))
    *_, jstats, tstats, same, _ = trace_both(jt, tt)
    assert tstats == jstats and same == 1.0, (tstats, jstats, same)
    for field, count in FLAG_CASES[(flags, polarized)].items():
        assert tstats[field] == count, (field, tstats)


def test_media_mismatch_counted_and_kills_path():
    """A ray that believes the wrong medium dies with
    ERROR_MEDIA_MISMATCH, counted as such (scene.intersect.glsl:77-80)."""
    jt, tt = (_flag_tracer(pkg, "R", outside="glass", key=0xBAD) for pkg in (theia_tpu, theia_tpu_torch))
    *_, jstats, tstats, same, _ = trace_both(jt, tt)
    assert tstats == jstats and tstats["mismatch"] == N and tstats["hit"] == 0


# -------------------------------------------------------- the five flags


def _scene_tracer(pkg, *, guide=True, response=None, callback=None, max_path=5, batch=1024, **kw):
    """``tests/test_rng_schedule.py``'s scene on in-code meshes: a glass
    sphere (TR), a volume border around a second, denser water (V) and a
    detector (DB, or D for ``useRefractedHitDir``), in water, with a
    spherical source beside the glass."""
    mat, scene, light = _mod(pkg, "material"), _mod(pkg, "scene"), _mod(pkg, "light")

    class Model(mat.DispersionFreeMedium, mat.HenyeyGreensteinPhaseFunction, mat.MediumModel):
        def __init__(self, name, a=0.01, s=0.4, g=0.3, n=1.33):
            self.ModelName = name
            mat.DispersionFreeMedium.__init__(self, n=n, ng=n, mu_a=a, mu_s=s)
            mat.HenyeyGreensteinPhaseFunction.__init__(self, g)

    water = Model("water").createMedium(num_lambda=8, num_theta=64)
    dense = Model("dense", s=0.8).createMedium(num_lambda=8, num_theta=64)
    glass = Model("glass", 0.0, 0.0, 0.0, n=1.5).createMedium(num_lambda=8)
    det_flags = "D" if kw.get("useRefractedHitDir") else "DB"
    mats = {
        "glass_water": mat.Material("glass_water", glass, water, flags="TR"),
        "border": mat.Material("border", dense, water, flags="V"),
        "det_water": mat.Material("det_water", None, water, flags=det_flags),
    }
    meshes = scene.MeshStore({"sphere": _mod(pkg, "mesh").Mesh.from_geometry(*icosphere(2))})
    T = scene.Transform
    det_pos = (0.0, 3.0, 0.0)
    instances = [
        meshes.createInstance("sphere", "glass_water", T.TRS(scale=1.0)),
        meshes.createInstance("sphere", "border", T.TRS(scale=1.2, translate=(-3.0, 0.5, 0.0))),
        meshes.createInstance("sphere", "det_water", T.TRS(scale=0.6, translate=det_pos), detectorId=1),
    ]
    # Scene(materials=dict): the store is packed from the dict's values
    sc = scene.Scene(instances, mats, medium="water", **_dev(pkg))
    resp = response(pkg) if response else _mod(pkg, "response").HistogramHitResponse(nBins=20, t0=0.0, binSize=5.0)
    return _mod(pkg, "trace.scene").SceneForwardTracer(
        batch,
        light.SphericalLightSource(position=(2.0, 0.0, 0.0), timeRange=(0.0, 5.0), budget=1e5),
        light.UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        resp,
        _mod(pkg, "random").PhiloxRNG(key=11),
        sc,
        maxPathLength=max_path,
        callback=callback(pkg) if callback else None,
        targetId=1,
        targetGuide=_mod(pkg, "target").SphereTargetGuide(position=det_pos, radius=0.6) if guide else None,
        maxTime=100.0,
        **kw,
        **_dev(pkg),
    )


FLAGS = {
    "none": {},
    "disableDirectLighting": dict(disableDirectLighting=True),
    "disableTransmission": dict(disableTransmission=True),
    "disableVolumeBorder": dict(disableVolumeBorder=True),
    "refCompatRNG": dict(refCompatRNG=True),
    "polarized": dict(polarized=True),
}


# refCompatRNG changes the stride only with a guide
FLAG_RUNS = [(flag, guide) for flag in sorted(FLAGS) for guide in (True, False) if guide or flag != "refCompatRNG"]


@pytest.mark.parametrize(
    "flag,guide", FLAG_RUNS, ids=[f"{f}-{'guided' if g else 'unguided'}" for f, g in FLAG_RUNS]
)
def test_flags_match_jax(flag, guide):
    """Each flag, guided and not, against ``theia_tpu`` on the same
    parameters: the draw budget, dims and light curve. Polarized runs and
    unguided runs record unfused, as ``theia_tpu``'s do."""
    stats = lambda pkg: _mod(pkg, "callback").EventStatisticCallback()
    jt, tt = (_scene_tracer(pkg, guide=guide, callback=stats, **FLAGS[flag]) for pkg in (theia_tpu, theia_tpu_torch))
    assert (tt.nRNGSamples, tt.maxHitsPerThread) == (jt.nRNGSamples, jt.maxHitsPerThread)
    assert tt._fused == (guide and flag != "polarized")
    jh, th, jstats, tstats, same, _ = trace_both(jt, tt)
    assert same >= 0.995, same
    assert tstats == jstats, (tstats, jstats)
    assert_hist_agree(jh, th)
    if flag == "disableVolumeBorder":
        assert tstats["volume"] == 0
    elif flag == "none":
        # the detector is black: its hits count as absorbed, not detected
        assert tstats["volume"] > 0 and tstats["hit"] > 0 and tstats["absorbed"] > 0


def test_use_refracted_hit_dir():
    """``useRefractedHitDir`` on a detector that is not black: the recorded
    hit directions are the refracted ones, equal to ``theia_tpu``'s."""
    rec = lambda pkg: _mod(pkg, "response").HitRecorder()
    jt, tt = (_scene_tracer(pkg, response=rec, useRefractedHitDir=True) for pkg in (theia_tpu, theia_tpu_torch))
    jrec, trec, *_, same, _ = trace_both(jt, tt)
    assert same >= 0.995
    valid = trec["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(jrec["valid"]))
    assert valid.sum() > 20
    for k in ("direction", "time", "contrib"):
        want = np.asarray(jrec[k])[valid]
        np.testing.assert_allclose(trec[k].numpy()[valid], want, rtol=1e-5, atol=1e-5 * np.abs(want).max(), err_msg=k)
    plain = _scene_tracer(theia_tpu_torch, response=rec)
    direction = plain.run()[0]["direction"].numpy()
    assert not np.allclose(direction[: valid.sum()], trec["direction"].numpy()[valid])


@pytest.mark.parametrize("guide", [True, False], ids=["guided", "unguided"])
def test_store_time_response_matches_jax(guide):
    """A response that draws: one draw a record, in ``theia_tpu``'s record
    order (extension, surface, phase shadow, guide shadow), unfused."""
    store = lambda pkg: _mod(pkg, "response").StoreTimeHitResponse()
    jt, tt = (_scene_tracer(pkg, guide=guide, response=store) for pkg in (theia_tpu, theia_tpu_torch))
    assert not tt._fused and tt.nRNGSamples == jt.nRNGSamples
    jrec, trec, *_, same, _ = trace_both(jt, tt)
    assert same >= 0.995, same
    accepted = trec["valid"].numpy()
    # unguided, only the paths that reach the detector record (11 of 1024)
    assert accepted.sum() == np.asarray(jrec["valid"]).sum() == int(trec["cursor"]) > 5
    np.testing.assert_allclose(
        np.sort(trec["time"].numpy()[accepted]), np.sort(np.asarray(jrec["time"])[np.asarray(jrec["valid"])]),
        rtol=1e-5,
    )


def test_polarized_woop_records_unfused_as_jax():
    """The polarized flagship on the Woop query records each shadow ray
    and the extension on its own, as ``theia_tpu`` does; the light curve
    agrees within (c) (the port fused polarized runs before: 7.7e-8 /
    1.4e-7 apart at batch 4096 / 16,384)."""
    mesh = icosphere(2)
    jt = build_flagship(theia_tpu, mesh, 2048, 4, accel="woop", polarized=True, source_position=(3.0, 0.6, 0.0))
    tt = build_flagship(
        theia_tpu_torch, mesh, 2048, 4, accel="woop", polarized=True, source_position=(3.0, 0.6, 0.0), device="cpu"
    )
    assert not tt._fused
    jh, th, *_, same, _ = trace_both(jt, tt)
    assert same >= 0.995, same
    assert_hist_agree(jh, th)


class _Codes:
    """Records each event slot's codes and masks (the port's CodeRecorder
    of tests/test_rng_schedule.py)."""

    def __new__(cls, pkg):
        base = _mod(pkg, "callback").TraceEventCallback

        class CodeRecorder(base):
            def init(self, batch_size, max_steps, device):
                z = lambda dtype: torch.zeros((max_steps, batch_size), dtype=dtype, device=device)
                return dict(code=z(torch.int32), mask=z(torch.bool))

            def on_event(self, params, state, ray, code, mask, i, pol=None):
                state["code"][i] = torch.where(mask, code, state["code"][i])
                state["mask"][i] |= mask
                return state

            def result(self, params, state):
                return {k: v.numpy() for k, v in state.items()}

        return CodeRecorder()


@pytest.mark.parametrize("guide", [True, False], ids=["guided", "unguided"])
def test_scene_forward_schedule(guide):
    """Each lane's final dim equals the draws its recorded events imply:
    distance 1 every segment; a reflect/transmit choice 1 on a hit of an
    RT surface; a scatter 2, and with a guide of G draws also the MIS
    shadow pair's 2 + G, on segments before the last."""
    from theia_tpu_torch.trace.core import EventResultCode as E

    tt = _scene_tracer(theia_tpu_torch, guide=guide, callback=_Codes, batch=N)
    tt._debug_rng = True
    p = tt.params()
    with torch.no_grad():
        _, cb, dims = tt._trace_batch(p, tt.rng.counter_words, tt.streams())
    rec = tt.callback.result(p["callback"], cb)
    codes, masks, dims = rec["code"], rec["mask"], dims.numpy().astype(np.int64)
    L, g = tt.maxPathLength, tt.targetGuide.nRNGSamples if guide else 0
    exp = np.full(N, tt.wavelengthSource.nRNGSamples + tt.source.nRNGForward, np.int64)
    for i in range(L):
        c, m = codes[i + 1], masks[i + 1]
        exp += 1
        if i < L - 1:
            exp += np.where(m & (c == int(E.RAY_SCATTERED)), 4 + g if guide else 2, 0)
        # RT surfaces (the glass) draw a choice; the volume border does not
        exp += np.where(m & (c == int(E.RAY_HIT)), 1, 0)
    assert (dims == exp).all(), (int((dims != exp).sum()), np.abs(dims - exp).max())
    assert dims.max() <= tt.nRNGSamples
    assert (codes[1:L] == int(E.RAY_SCATTERED)).any() and (codes[1:L] == int(E.RAY_HIT)).any()
    assert (codes[1:L] == int(E.VOLUME_HIT)).any()
