"""theia_tpu_torch HistogramHitResponse.record against theia_tpu's.

Tolerance: rtol 1e-6 per bin. JAX accumulates by a one-hot matmul and
the port in the records' fixed order (``response.ordered_bin_sums``), so
each bin sums the same float32 values in another order."""

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
    """The histogram takes a gradient in ``value`` only: an attached
    ``time`` is refused (its bins come from a floor, as in JAX, where the
    time is detached), while an attached ``value`` records and carries
    its gradient."""
    args = (torch.ones(4, dtype=torch.bool), torch.tensor(0.0), torch.tensor(1.0), 10)
    value = torch.ones(4, requires_grad=True)
    with pytest.raises(ValueError, match="time"):
        tresp.histogram_add(torch.zeros(10), value, torch.zeros(4, requires_grad=True), *args)
    state = tresp.histogram_add(torch.zeros(10), value * 2.0, torch.arange(4.0), *args)
    assert state.requires_grad and state[:4].tolist() == [2.0] * 4
    state.sum().backward()
    assert value.grad.tolist() == [2.0] * 4


def edge_inputs(n, seed, n_bins, n_det):
    """Seeded lanes that sit where the bin rule decides: times on exact
    bin edges (the first bin's lower edge and the last bin's upper edge
    among them), below t0, past the last bin, NaN and +-inf, ids from -1
    to n_det. Returns numpy (time, value, object_id, mask); lanes with a
    NaN time come masked (see ``test_plain_record_on_edges_matches_jax``)."""
    rng = np.random.default_rng(seed)
    lane = np.arange(n)
    time = rng.uniform(-20.0, 5.0 * n_bins + 60.0, size=n)
    time = np.where(lane % 7 == 1, 5.0 * rng.integers(-1, n_bins + 2, size=n), time)
    time = np.where(lane % 11 == 3, np.nan, time)
    time = np.where(lane % 13 == 5, np.inf, time)
    time = np.where(lane % 17 == 7, -np.inf, time).astype(np.float32)
    value = rng.uniform(0.0, 2.0, size=n).astype(np.float32)
    object_id = rng.integers(-1, (n_det or 1) + 1, size=n).astype(np.int32)
    mask = (rng.uniform(size=n) < 0.8) & ~np.isnan(time)
    return time, value, object_id, mask


def jax_response(n, n_bins, n_det):
    jr = jresp.HistogramHitResponse(nBins=n_bins, t0=0.0, binSize=5.0, nDetectors=n_det)
    jr.prepare(JConfig(batch_size=n, capacity=n, max_hits_per_thread=1, normalization=1.0, polarized=False))
    return jr


def jax_item(time, value, object_id):
    vec = jnp.zeros((time.shape[0], 3), jnp.float32)
    return jcore.HitItem(vec, vec, vec, jnp.ones(time.shape[0], jnp.float32), jnp.asarray(time),
                         jnp.asarray(value), jnp.asarray(object_id))


#: (n_bins, n_det): no detector axis, one, and a state above the 1024 flat
#: bins at which the JAX record turns from a one-hot product to a scatter
STATES = [(100, None), (50, 3), (600, 3)]
SIZES = [1, 3, 5, 1023, 4099]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("n_bins,n_det", STATES)
def test_plain_record_on_edges_matches_jax(n_bins, n_det, n):
    """``histogram_add_plain`` (and ``histogram_add`` on CPU tensors)
    against theia_tpu's record, rtol 1e-6 a bin: both sum a few thousand
    float32 values a bin at most, in another order. Unmasked NaN times are
    left out of the comparison: theia_tpu casts a NaN bin to an integer,
    which lands in bin 0 on the CPU, while the port drops the lane
    (``test_nan_time_is_a_deliberate_divergence``); that the port drops it
    is checked against itself."""
    time, value, object_id, mask = edge_inputs(n, 100 * n + n_bins, n_bins, n_det)
    jr = jax_response(n, n_bins, n_det)
    jstate, _ = jr.record(jr.params(), jr.init(), jax_item(time, value, object_id), jnp.asarray(mask), None)
    want = np.asarray(jstate)
    assert jr._size() == n_bins * (n_det or 1) and (jr._size() > jr.MXU_BINS_MAX) == (n_bins == 600)
    t = lambda a: torch.as_tensor(a)
    args = (t(value), t(time), t(mask), torch.tensor(0.0), torch.tensor(5.0), n_bins,
            t(object_id) if n_det else None, n_det)
    for fn in (tresp.histogram_add_plain, tresp.histogram_add):
        got = fn(torch.zeros(want.shape[0]), *args).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)
    # every time on an edge k * binSize lands in bin k, none in bin k - 1
    edge = np.flatnonzero(mask & (np.arange(n) % 7 == 1) & np.isfinite(time) & (time >= 0) & (time < 5.0 * n_bins))
    if edge.size:
        keep, bins = tresp._hist_bins(t(time), t(mask), 0.0, 5.0, n_bins, t(object_id) if n_det else None, n_det)
        in_det = (object_id[edge] >= 0) & (object_id[edge] < n_det) if n_det else np.ones(edge.size, bool)
        np.testing.assert_array_equal(keep.numpy()[edge], in_det)
        np.testing.assert_array_equal(bins.numpy()[edge][in_det] % n_bins, (time[edge][in_det] / 5.0).astype(np.int64))
    # NaN times drop even when unmasked
    nan = np.isnan(time)
    unmasked = fn(torch.zeros(want.shape[0]), args[0], args[1], t(mask | nan), *args[3:]).numpy()
    np.testing.assert_array_equal(unmasked, got)
    assert tresp.histogram_add.launches == 0


def test_shared_state_max_is_the_kernel_files():
    """The records' shared memory as ``csrc/ordered_sum.cuh`` takes it: a
    block's rows (``ordered::kRowFloats``) are what a block may hold less
    its 1 KB, a range of flat bins (``RECORD_RANGE``, ``ordered::kRange``)
    the rows of one of its 8 warps."""
    import re
    from pathlib import Path

    source = (Path(tresp.__file__).parent / "csrc" / "ordered_sum.cuh").read_text()
    kib = int(re.search(r"constexpr int kSmemPerSm = (\d+) \* 1024;", source).group(1))
    assert "kRowFloats = (kSmemPerSm - 1024) / 4;" in source and "kRange = kRowFloats / kWarps;" in source
    assert (kib * 1024 - 1024) // 4 // 8 == tresp.RECORD_RANGE


@pytest.mark.parametrize("n_bins,n_det", STATES)
def test_nan_time_is_a_deliberate_divergence(n_bins, n_det):
    """An unmasked lane with a NaN time, on the same inputs to both
    packages: ``theia_tpu`` casts its NaN bin to an integer, which on the
    CPU lands in bin 0 (of the lane's detector where the state has a
    detector axis and the id is in range); the port drops the lane, in
    its plain version and in its kernels alike, as ``response.py`` says.
    The port's state equals the record with those lanes masked, and
    ``theia_tpu``'s that plus their values in bin 0, rtol 1e-6 a bin (the
    sums of ``test_plain_record_on_edges_matches_jax``)."""
    time, value, object_id, mask = edge_inputs(4099, 7 + n_bins, n_bins, n_det)
    nan = np.isnan(time)
    assert nan.sum() > 100
    mask = mask | nan  # the NaN lanes recorded, not masked
    jr = jax_response(time.shape[0], n_bins, n_det)
    jstate, _ = jr.record(jr.params(), jr.init(), jax_item(time, value, object_id), jnp.asarray(mask), None)
    t = lambda a: torch.as_tensor(a)
    args = (t(value), t(time), t(mask), torch.tensor(0.0), torch.tensor(5.0), n_bins,
            t(object_id) if n_det else None, n_det)
    port = tresp.histogram_add(torch.zeros(jr._size()), *args).numpy()
    dropped = tresp.histogram_add_plain(torch.zeros(jr._size()), args[0], args[1], t(mask & ~nan), *args[3:]).numpy()
    np.testing.assert_array_equal(port, dropped)
    binned = dropped.astype(np.float64)
    lanes = nan & ((object_id >= 0) & (object_id < n_det) if n_det else True)
    np.add.at(binned, object_id[lanes] * n_bins if n_det else np.zeros(lanes.sum(), np.int64), value[lanes])
    assert lanes.sum() > 50 and not np.allclose(port, np.asarray(jstate))
    np.testing.assert_allclose(np.asarray(jstate), binned, rtol=1e-6, atol=0.0)
