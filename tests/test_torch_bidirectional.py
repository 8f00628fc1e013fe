"""The port's ``BidirectionalPathTracer`` against the live ``theia_tpu`` on
the CPU: ``tests/test_bidirectional.py``'s configuration (an absorbing
detector sphere of radius 100 around the light in scattering water, a
sphere camera just inside it; ``tests/torch_flagship.build_bidirectional``
on an in-code icosphere) at batch 1024 with paths of 4 segments,
unpolarized and polarized, with every ``callbackScope`` and the camera's
medium named; then the analogue of
``test_bdpt_polarized_scalar_invariance`` on the port, and the design's
one visibility query of L * N rays a camera vertex.

The RNG dims are compared on every lane: ``theia_tpu``'s tracer has no
``_debug_rng`` hook, so its lanes' last dims are those of the camera
loop's last ``_merge_dim``, in a batch run eagerly (``jax.disable_jit``).

Tolerances and why: histograms' sums within rtol 1e-4 and every bin
within 1e-4 of the largest (``tests/test_torch_backward.py``'s limits:
the connections weight a pair by 1/d^2 and exp(-mu d), whose sqrt and exp
differ by ulps between XLA and torch; measured 4e-6 of the sum here); the
scalar invariance within ``test_bdpt_polarized_scalar_invariance``'s own
rtol 1e-4, atol 1e-3 of the largest bin.
"""

import numpy as np
import pytest
import torch

import theia_tpu
import theia_tpu.trace.bidirectional as jax_bidirectional
import theia_tpu_torch
import theia_tpu_torch.trace.bidirectional as bidirectional
from theia_tpu_torch.interop import params_from_numpy
from test_torch_scene_backward import assert_hist_agree, jax_run
from torch_flagship import build_bidirectional, icosphere, numpy_tree

torch.set_num_threads(1)

BATCH, PATH = 1024, 4


def trace_both(**kw):
    """One batch in each package on the JAX tracer's parameters: (JAX
    histogram, port histogram), the dims held equal on every lane. A
    callable value of ``kw`` is called with the package."""
    of = lambda pkg: {k: v(pkg) if callable(v) else v for k, v in kw.items()}
    jt = build_bidirectional(theia_tpu, BATCH, mesh=icosphere(2), path=PATH, **of(theia_tpu))
    tt = build_bidirectional(theia_tpu_torch, BATCH, "cpu", mesh=icosphere(2), path=PATH, **of(theia_tpu_torch))
    assert (jt.nRNGSamples, jt.maxHitsPerThread) == (tt.nRNGSamples, tt.maxHitsPerThread)
    p, js, jd = jax_run(jt, [jax_bidirectional])
    tp = params_from_numpy(numpy_tree(p), "cpu")
    tt._debug_rng = True
    with torch.no_grad():
        ts, _, td = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    np.testing.assert_array_equal(td.numpy().astype(np.int64), jd)
    jh = np.asarray(jt.response.result(p["response"], js), np.float64)
    return jh, tt.response.result(tp["response"], ts).double().numpy()


@pytest.mark.parametrize("polarized", [False, True], ids=["unpolarized", "polarized"])
def test_bdpt_matches_jax(polarized):
    assert_hist_agree(*trace_both(polarized=polarized))


@pytest.mark.parametrize("scope", ["both", "light", "camera"])
def test_bdpt_callback_scopes_match_jax(scope):
    """``theia_tpu`` keeps ``callbackScope`` and reports no event to the
    callback, whose state stays as made: so does the port. The camera's
    medium is named (the scene's, the default)."""
    callback = lambda pkg: pkg.callback.EventStatisticCallback()
    assert_hist_agree(*trace_both(callback=callback, callbackScope=scope, cameraMedium="water"))
    stats = []
    for pkg, dev in ((theia_tpu, {}), (theia_tpu_torch, {"device": "cpu"})):
        tracer = build_bidirectional(pkg, BATCH, mesh=icosphere(2), path=PATH, callback=callback(pkg),
                                     callbackScope=scope, cameraMedium="water", **dev)
        assert tracer.callbackScope == scope
        stats.append({k: int(v) for k, v in tracer.run()[1].items()})
    assert stats[0] == stats[1]


def test_bdpt_polarized_scalar_invariance():
    """``test_bdpt_polarized_scalar_invariance`` on the port: a scalar
    medium's polarized light curve is the unpolarized one."""
    runs = {}
    for polarized in (False, True):
        tracer = build_bidirectional(theia_tpu_torch, 4096, "cpu", mesh=icosphere(2), path=4, key=7, polarized=polarized)
        runs[polarized] = tracer.run()[0].double().numpy()
    assert runs[False].sum() > 0
    assert np.allclose(runs[False], runs[True], rtol=1e-4, atol=1e-3 * runs[False].max())


def test_one_visibility_query_a_camera_vertex(monkeypatch):
    """A camera vertex's L x N connections go through one ``is_visible``
    call of L * N rays (``theia_tpu`` maps the query over L)."""
    calls = []
    real = bidirectional.is_visible

    def counted(pack, observer, target, **kw):
        calls.append(observer.shape[0])
        return real(pack, observer, target, **kw)

    monkeypatch.setattr(bidirectional, "is_visible", counted)
    tracer = build_bidirectional(theia_tpu_torch, 256, "cpu", mesh=icosphere(1), path=3)
    tracer.run()
    assert calls == [3 * 256] * 3, calls
