"""The port's value queue and estimators (``response``: ``EmptyResponse``,
``CustomValueResponse``, ``SampleValueResponse``, ``StoreValueHitResponse``,
``Estimator``, ``HistogramReducer``, ``HistogramEstimator``,
``HostEstimator``, ``createHitTimeQueue``, ``createValueQueue``,
``replay_hits`` / ``HitReplay``, ``sample_camera_hits`` /
``CameraHitResponseSampler``) and ``items`` against the live ``theia_tpu``
on the CPU, after ``tests/test_misc_components.py:67-108`` and
``tests/test_reference_api.py:81, 165, 195``.

Tolerances and why: the responses record what the tracers hand them, and
the tracers agree lane by lane (``tests/test_torch_volume.py``: the same
slots, times within 1e-5 relative, values within 1e-4 relative or 1e-6
of the largest); the estimators' histograms, built on the host in float64
from those queues, within rtol 1e-4; the item layouts byte for byte;
``replay_hits`` within ``theia_tpu``'s own rtol 2e-3 of np.histogram.
"""

import importlib
from contextlib import nullcontext

import numpy as np
import pytest
import torch

import jax

import theia_tpu
import theia_tpu_torch
from theia_tpu_torch.interop import params_from_numpy
from torch_flagship import jax_record_sums, numpy_tree

torch.set_num_threads(1)

N = 4096
SEVEN_B = (
    "CustomValueResponse EmptyResponse SampleValueResponse StoreValueHitResponse Estimator HistogramReducer "
    "HistogramEstimator HostEstimator createHitTimeQueue createValueQueue replay_hits sample_camera_hits "
    "HitReplay CameraHitResponseSampler PolarizedHitItem HitTimeItem HitTimeAndIdItem ValueItem "
    "CameraHitResponseItem PolarizedCameraHitResponseItem"
).split()


def mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def volume_tracer(pkg, response, batch=N):
    """tests/test_misc_components.py's tracer: a flash inside a 40 m inner
    sphere in WaterTestModel(g=0.4), 6 scatterings."""
    dev = {} if pkg is theia_tpu else {"device": "cpu"}
    light = mod(pkg, "light")
    return mod(pkg, "trace").VolumeForwardTracer(
        batch, light.SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        mod(pkg, "target").InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=40.0),
        light.UniformWavelengthSource(lambdaRange=(400.0, 500.0)), response, mod(pkg, "random").PhiloxRNG(key=0xC0FFEE),
        medium=mod(pkg, "testing").WaterTestModel(g=0.4).createMedium(), nScattering=6, scatterCoefficient=0.03, **dev,
    )


def trace_both(make_response, batch=N, slots=None):
    """One batch of each package's tracer with ``make_response(pkg)``
    (prepared for ``slots`` slots in all where given); returns the two
    results as numpy."""
    jt, tt = volume_tracer(theia_tpu, make_response(theia_tpu), batch), volume_tracer(
        theia_tpu_torch, make_response(theia_tpu_torch), batch)
    if slots is not None:
        for pkg, t in ((theia_tpu, jt), (theia_tpu_torch, tt)):
            t.response.prepare(mod(pkg, "component").TraceConfig(
                batch_size=batch, capacity=slots, max_hits_per_thread=1, normalization=1.0, polarized=False))
    p = jt.params()
    js, _ = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    tp = params_from_numpy(numpy_tree(p), "cpu")
    with torch.no_grad():
        ts, _ = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    j, t = jt.response.result(p["response"], js), tt.response.result(tp["response"], ts)
    return to_numpy(j), to_numpy(t)


def to_numpy(result):
    """A response's result (None, an array or a dict of them) as numpy."""
    if isinstance(result, dict):
        return {k: np.asarray(v) for k, v in result.items()}
    return None if result is None else np.asarray(result)


def test_names_present():
    """tests/test_reference_api.py::test_reference_names_present for 7 b's
    names, at theia_tpu's locations."""
    missing = [n for n in SEVEN_B if not hasattr(theia_tpu_torch.response, n)]
    assert not missing, missing
    assert set(SEVEN_B) <= set(theia_tpu_torch.response.__all__)
    items = ("WavelengthSampleItem", "LightSampleItem", "PolarizedLightSampleItem")
    assert all(hasattr(theia_tpu_torch.light, n) for n in items)
    assert theia_tpu_torch.response.HitReplay is theia_tpu_torch.response.replay_hits


def test_item_dtypes_byte_for_byte():
    jitems, titems = theia_tpu.items, theia_tpu_torch.items
    assert titems.__all__ == jitems.__all__
    for name in jitems.__all__[1:]:
        assert getattr(titems, name).dtype == getattr(jitems, name).dtype, name
        assert getattr(titems, name)._rename == getattr(jitems, name)._rename, name
    assert titems.HitItemLayout.dtype == jitems.HitItemLayout.dtype
    # from_queue on tensors: the same bytes as theia_tpu's from numpy
    n = 7
    rs = np.random.default_rng(0)
    queue = dict(
        position=rs.normal(size=(n, 3)).astype(np.float32), direction=rs.normal(size=(n, 3)).astype(np.float32),
        normal=np.zeros((n, 3), np.float32), stokes=np.ones((n, 4), np.float32), polRef=np.zeros((n, 3), np.float32),
        wavelength=np.full(n, 450.0, np.float32), time=np.arange(n, dtype=np.float32),
        contrib=rs.uniform(size=n).astype(np.float32), objectId=np.arange(n, dtype=np.int32),
        valid=np.array([1, 1, 0, 1, 1, 1, 0], bool), value=np.arange(n, dtype=np.float32),
    )
    tensors = {k: torch.as_tensor(v) for k, v in queue.items()}
    for name in ("PolarizedHitItem", "ValueItem", "HitTimeAndIdItem", "HitTimeItem"):
        got = getattr(titems, name).from_queue(tensors)
        want = getattr(jitems, name).from_queue(queue)
        assert got.tobytes() == want.tobytes(), name
    assert titems.PolarizedHitItem.from_queue(tensors).dtype.itemsize == (3 + 3 + 3 + 4 + 3 + 3) * 4 + 4


def test_queue_creators_match_response_layouts():
    """tests/test_reference_api.py:165 on the port: a creator's queue is the
    state its response's ``init`` makes (the port's buffers one row longer:
    the drop slot)."""
    from theia_tpu_torch.component import TraceConfig

    resp = theia_tpu_torch.response
    cfg = TraceConfig(batch_size=8, capacity=8, max_hits_per_thread=2, normalization=1.0, polarized=False)
    for response, create in ((resp.StoreTimeHitResponse(), resp.createHitTimeQueue),
                             (resp.StoreValueHitResponse(), resp.createValueQueue)):
        response.prepare(cfg)
        ref = response.init("cpu")
        q = create(16, device="cpu")
        assert set(q) == set(ref)
        assert all(q[k].shape == ref[k].shape and q[k].dtype == ref[k].dtype for k in q)
        assert q["valid"].shape == (17,)
    assert set(resp.createHitTimeQueue(16, objectId=False, device="cpu")) == {"cursor", "overflow", "time", "valid"}
    jq = theia_tpu.response.createValueQueue(16)
    assert set(jq) <= set(resp.createValueQueue(16, device="cpu"))


def test_histogram_reducer():
    red = theia_tpu_torch.response.HistogramReducer(nBins=8, normalization=0.5)
    hists = np.stack([np.arange(8.0), np.ones(8)])
    out = red(torch.as_tensor(hists))
    np.testing.assert_allclose(out.numpy(), (np.arange(8.0) + 1.0) * 0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(theia_tpu.response.HistogramReducer(
        nBins=8, normalization=0.5)(hists)), rtol=1e-6)


def test_store_value_and_estimators_match_jax():
    """tests/test_misc_components.py::test_store_value_and_estimators on
    both packages: the queues slot for slot, then the estimators."""
    j, t = trace_both(lambda pkg: mod(pkg, "response").StoreValueHitResponse())
    valid = j["valid"]
    np.testing.assert_array_equal(t["valid"], valid)
    assert valid.sum() > 100 and int(t["cursor"]) == int(j["cursor"]) == valid.sum()
    np.testing.assert_allclose(t["time"][valid], j["time"][valid], rtol=1e-5)
    np.testing.assert_allclose(t["value"][valid], j["value"][valid], rtol=1e-4, atol=1e-6 * j["value"].max())
    for pkg, q in ((theia_tpu, j), (theia_tpu_torch, t)):
        resp = mod(pkg, "response")
        hist = resp.HistogramEstimator(nBins=40, t0=0.0, binSize=20.0)(q)
        host = resp.HostEstimator()(q)
        assert hist.sum() > 0 and np.isclose(hist.sum(), host["value"][host["time"] < 800.0].sum())
    tq = {k: torch.as_tensor(v) for k, v in t.items()}
    got = theia_tpu_torch.response.HistogramEstimator(nBins=40, t0=0.0, binSize=20.0, normalization=0.5)(tq)
    want = theia_tpu.response.HistogramEstimator(nBins=40, t0=0.0, binSize=20.0, normalization=0.5)(j)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_store_value_overflow_keeps_the_first():
    """Past its capacity the queue keeps the first hits and counts the rest,
    as theia_tpu's drops them."""
    j, t = trace_both(lambda pkg: mod(pkg, "response").StoreValueHitResponse(), batch=64, slots=64)
    assert int(t["cursor"]) == int(j["cursor"]) == 64 and int(t["overflow"]) > 0
    np.testing.assert_array_equal(t["valid"], j["valid"])
    np.testing.assert_allclose(t["time"], j["time"], rtol=1e-5)


def test_value_responses_match_jax():
    """SampleValueResponse with the uniform and a custom value response
    (one draw a hit, a parameter), and EmptyResponse."""

    def custom(pkg):
        def fn(params, item, rng):
            uu, rng = rng.uniform()
            return item.contrib * params["gain"] * (uu < 0.5), rng
        return mod(pkg, "response").CustomValueResponse(fn, nRNGSamples=1, params={"gain": 3.0})

    j, t = trace_both(lambda pkg: mod(pkg, "response").SampleValueResponse())
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert (~np.isnan(j)).sum() > 100
    np.testing.assert_allclose(t[~np.isnan(j)], j[~np.isnan(j)], rtol=1e-4, atol=1e-6 * np.nanmax(j))
    j, t = trace_both(lambda pkg: mod(pkg, "response").SampleValueResponse(custom(pkg)))
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    ok = ~np.isnan(j)
    assert (j[ok] == 0).any() and (j[ok] > 0).any()
    np.testing.assert_allclose(t[ok], j[ok], rtol=1e-4, atol=1e-6 * np.nanmax(j))
    j, t = trace_both(lambda pkg: mod(pkg, "response").EmptyResponse())
    assert j is None and t is None


def test_replay_hits_matches_histogram(monkeypatch):
    """tests/test_misc_components.py::test_replay_hits_matches_histogram on
    the port, through ``HitReplay``, and the replay's histogram against
    ``theia_tpu``'s replay of the same hits."""
    P = theia_tpu_torch
    tracer = volume_tracer(P, P.response.HitRecorder(), 8 * 1024)
    hits, _ = tracer.run()
    resp = P.response.HistogramHitResponse(nBins=40, t0=0.0, binSize=20.0, normalization=1.0)
    hist = P.response.HitReplay(hits, resp).numpy()
    valid = hits["valid"].numpy()
    expected, _ = np.histogram(hits["time"].numpy()[valid], bins=40, range=(0.0, 800.0),
                               weights=hits["contrib"].numpy()[valid].astype(np.float64))
    assert expected.sum() > 0
    np.testing.assert_allclose(hist, expected, rtol=2e-3)
    jsums = jax_record_sums(monkeypatch)
    jresp = theia_tpu.response.HistogramHitResponse(nBins=40, t0=0.0, binSize=20.0, normalization=1.0)
    jhist = np.asarray(theia_tpu.response.replay_hits({k: v.numpy() for k, v in hits.items()}, jresp))
    # The port sums a bin in the records' fixed order (spans, tiles, groups),
    # theia_tpu as its one-hot product does: on this replay's fullest bin
    # (14,138 hits) they are 2.8e-5 apart, theia_tpu's float32 sum 2.8e-5
    # from the exact one and the port's 2.2e-7. So the port's histogram is
    # held at rtol 1e-5 against the exact (float64) sums of what theia_tpu
    # recorded, bin by bin, and against the exact histogram of the hits.
    assert len(jsums) == 1
    np.testing.assert_allclose(hist, jsums[0], rtol=1e-5, atol=1e-6 * jhist.max())
    np.testing.assert_allclose(hist, expected, rtol=1e-5, atol=1e-6 * jhist.max())
    # a response that draws: the replay's streams are the slots, as theia_tpu's
    store = lambda pkg: mod(pkg, "response").StoreTimeHitResponse()
    got = P.response.replay_hits(hits, store(P))
    want = theia_tpu.response.replay_hits({k: v.numpy() for k, v in hits.items()}, store(theia_tpu))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))


def test_sample_camera_hits():
    """tests/test_misc_components.py::test_sample_camera_hits on the port,
    and against theia_tpu's with a value response that draws."""
    P = theia_tpu_torch
    resp = P.response.HistogramHitResponse(nBins=10, t0=0.0, binSize=1.0, normalization=1.0)
    hist = P.response.CameraHitResponseSampler(P.camera.SphereCamera(radius=1.0), resp, 512, device="cpu").numpy()
    assert hist[0] > 0 and hist[1:].sum() == 0
    sample = lambda pkg, **kw: mod(pkg, "response").sample_camera_hits(
        mod(pkg, "camera").SphereCamera(radius=1.0), mod(pkg, "response").SampleValueResponse(), 512, **kw)
    got, want = sample(P, device="cpu").numpy(), np.asarray(sample(theia_tpu))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # its default device is the card: without one it raises rather than run on the CPU
    with pytest.raises(RuntimeError, match="needs a card") if not torch.cuda.is_available() else nullcontext():
        sample(P)
