"""theia_tpu_torch HistogramHitResponse.record against theia_tpu's.

Tolerance: rtol 1e-6 per bin. JAX accumulates by a one-hot matmul and
the port by index_add_ (CPU), so each bin sums the same float32 values
in another order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import theia_tpu.response as jresp
import theia_tpu.trace.core as jcore
import theia_tpu_torch.response as tresp
import theia_tpu_torch.trace.core as tcore
from theia_tpu.component import TraceConfig as JConfig
from theia_tpu_torch.component import TraceConfig as TConfig


def _items(n, rng, n_det):
    vec = rng.normal(size=(n, 3)).astype(np.float32)
    # times span below t0 and past the last bin so both drops are hit
    time = rng.uniform(-20.0, 560.0, size=n).astype(np.float32)
    contrib = rng.uniform(0.0, 2.0, size=n).astype(np.float32)
    wavelength = rng.uniform(300.0, 700.0, size=n).astype(np.float32)
    object_id = rng.integers(-1, (n_det or 1) + 1, size=n).astype(np.int32)
    mask = rng.uniform(size=n) < 0.7
    return vec, time, contrib, wavelength, object_id, mask


@pytest.mark.parametrize("n_det", [None, 3])
def test_histogram_record_matches_jax(n_det):
    rng = np.random.default_rng(5 if n_det else 4)
    n = 8192
    vec, time, contrib, wavelength, object_id, mask = _items(n, rng, n_det)
    cfg = dict(batch_size=n, capacity=n, max_hits_per_thread=1, normalization=1.0 / n, polarized=False)
    jr = jresp.HistogramHitResponse(nBins=100, t0=0.0, binSize=5.0, nDetectors=n_det)
    tr = tresp.HistogramHitResponse(nBins=100, t0=0.0, binSize=5.0, nDetectors=n_det)
    jr.prepare(JConfig(**cfg))
    tr.prepare(TConfig(**cfg))
    jitem = jcore.HitItem(*(jnp.asarray(a) for a in (vec, vec, vec, wavelength, time, contrib, object_id)))
    titem = tcore.HitItem(*(torch.as_tensor(a) for a in (vec, vec, vec, wavelength, time, contrib, object_id)))
    jp, tp = jr.params(), tr.params("cpu")
    jstate, _ = jr.record(jp, jr.init(), jitem, jnp.asarray(mask), None)
    tstate, _ = tr.record(tp, tr.init("cpu"), titem, torch.as_tensor(mask), None)
    want = np.asarray(jr.result(jp, jstate))
    got = tr.result(tp, tstate).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert want.sum() > 0
    # masked and out-of-range lanes really were dropped
    assert got.sum() < contrib.sum() / n
    assert tresp.histogram_add.launches == 0


def test_histogram_add_rejects_grad():
    state = torch.zeros(10)
    value = torch.ones(4, requires_grad=True)
    with pytest.raises(NotImplementedError):
        tresp.histogram_add(
            state, value, torch.zeros(4), torch.ones(4, dtype=torch.bool),
            torch.tensor(0.0), torch.tensor(1.0), 10,
        )
