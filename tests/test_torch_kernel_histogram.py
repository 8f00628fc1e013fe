"""theia_tpu_torch KernelHistogramHitResponse.record against theia_tpu's,
forward and ``jax.vjp`` in the value, the time, t0, binSize and
bandwidth (on CPU tensors the port runs the record's plain version and
its written-out backward, ``kernel_histogram_grad_plain``, which the
kernel of ``csrc/kernel_histogram.cu`` repeats).

Tolerances and why:
- state: rtol 1e-6 of the largest bin. Both add the same float32 terms,
  one scatter an offset in the same offset order; the port's weights are
  the same ops in the same order.
- d value, d time: rtol 1e-5 of the largest entry. Nine terms a lane,
  summed in another order than JAX's transposed scatters; d time is
  ``g v w z / h`` where JAX chains it through ``jnp.square`` and the
  exponential (a few ulps).
- d t0, d binSize, d bandwidth: rtol 1e-4. Sums over every lane and bin,
  in another order and with the derivative factored differently
  (``w (z^2 - 1) / h`` against JAX's two chains through the norm and
  the exponent).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu.response as jresp
import theia_tpu.trace.core as jcore
import theia_tpu_torch.response as tresp
import theia_tpu_torch.trace.core as tcore
from theia_tpu.component import TraceConfig as JConfig
from theia_tpu_torch.component import TraceConfig as TConfig

torch.set_num_threads(1)

N_BINS = 40
BIN = 5.0


def _responses(n, n_det, **kw):
    cfg = dict(batch_size=n, capacity=n, max_hits_per_thread=1, normalization=1.0 / n, polarized=False)
    args = dict(nBins=N_BINS, t0=-3.0, binSize=BIN, bandwidth=4.0, nDetectors=n_det, **kw)
    jr, tr = jresp.KernelHistogramHitResponse(**args), tresp.KernelHistogramHitResponse(**args)
    jr.prepare(JConfig(**cfg))
    tr.prepare(TConfig(**cfg))
    return jr, tr


def _lanes(n, seed, n_det, mask_share=0.7):
    """Seeded lanes over and past the histogram: times below t0, on bin
    centres and edges of the first and last bins, within the kernel's
    support of either end and past it."""
    rng = np.random.default_rng(seed)
    time = rng.uniform(-40.0, BIN * N_BINS + 40.0, size=n)
    edges = np.array([-3.0, -0.5, -23.0, 197.0, 194.5, 214.5, -3.0 - 4 * BIN, 197.0 + 4 * BIN])
    time[: min(n, edges.size)] = edges[: min(n, edges.size)]
    value = rng.uniform(0.0, 2.0, size=n)
    object_id = rng.integers(-1, (n_det or 1) + 1, size=n)
    mask = rng.uniform(size=n) < mask_share
    return time.astype(np.float32), value.astype(np.float32), object_id.astype(np.int32), mask


def _jax_record(jr, time, value, object_id, mask):
    n = time.size
    vec = jnp.zeros((n, 3), jnp.float32)

    def record(contrib, t, params):
        item = jcore.HitItem(vec, vec, vec, jnp.full(n, 400.0, jnp.float32), t, contrib, jnp.asarray(object_id))
        return jr.record(params, jr.init(), item, jnp.asarray(mask), None)[0]

    return jax.vjp(record, jnp.asarray(value), jnp.asarray(time), jr.params())


def _torch_record(tr, time, value, object_id, mask, grad_state):
    n = time.size
    leaves = dict(value=torch.tensor(value), time=torch.tensor(time))
    params = tr.params("cpu")
    for name in ("t0", "binSize", "bandwidth"):
        params[name] = params[name].clone().requires_grad_(True)
    for v in leaves.values():
        v.requires_grad_(True)
    vec = torch.zeros((n, 3))
    item = tcore.HitItem(vec, vec, vec, torch.full((n,), 400.0), leaves["time"], leaves["value"], torch.tensor(object_id))
    state, _ = tr.record(params, tr.init("cpu"), item, torch.tensor(mask), None)
    out = state.detach().clone()
    state.backward(torch.tensor(grad_state))
    grads = [leaves["value"].grad, leaves["time"].grad] + [params[k].grad for k in ("t0", "binSize", "bandwidth")]
    return out.numpy(), [g.numpy() for g in grads]


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("n,n_det", [(1, None), (7, 3), (1023, None), (4099, 3)])
def test_record_and_vjp_match_jax(n, n_det):
    state, grads = _match_jax(n, n_det, *_lanes(n, 100 + n, n_det))
    if n > 1:
        assert np.abs(state).sum() > 0 and np.abs(grads[1]).sum() > 0


@pytest.mark.parametrize("case", ["every lane kept", "every lane in one bin", "no lane kept, ids out of range",
                                  "every lane kept, a detector axis"])
def test_kept_lane_cases_match_jax(case):
    """The records that the backward kernel's lists of kept lanes single
    out: every lane kept, every lane in one bin, none kept (every lane
    unmasked with an id out of range) and a detector axis."""
    n = 1024
    n_det = None if case in ("every lane kept", "every lane in one bin") else 3
    time, value, object_id, mask = _lanes(n, 200 + len(case), n_det, mask_share=1.0)
    if case == "every lane in one bin":
        time[:] = 98.8  # bin 20 of 40, off its centre (99.5)
    elif case.startswith("no lane"):
        object_id[:] = np.where(np.arange(n) % 2 == 0, -1, n_det)
    else:
        object_id = object_id.clip(0, (n_det or 1) - 1)
    state, grads = _match_jax(n, n_det, time, value, object_id, mask)
    assert bool(np.abs(state).sum() > 0) == (not case.startswith("no lane"))
    if case.startswith("no lane"):
        assert not any(np.asarray(g).any() for g in grads)


def _match_jax(n, n_det, time, value, object_id, mask):
    jr, tr = _responses(n, n_det)
    grad_state = np.random.default_rng(n).normal(size=jr._size()).astype(np.float32)
    want_state, vjp = _jax_record(jr, time, value, object_id, mask)
    d_value, d_time, d_params = vjp(jnp.asarray(grad_state))
    state, grads = _torch_record(tr, time, value, object_id, mask, grad_state)
    _close(state, np.asarray(want_state), 1e-6)
    _close(grads[0], np.asarray(d_value), 1e-5)
    _close(grads[1], np.asarray(d_time), 1e-5)
    for got, name in zip(grads[2:], ("t0", "binSize", "bandwidth")):
        _close(got, np.asarray(d_params[name]), 1e-4)
    assert tresp.kernel_histogram_add.launches == tresp.kernel_histogram_grad.launches == 0
    return state, grads


def test_all_masked_record_is_zero():
    n = 64
    time, value, object_id, _ = _lanes(n, 3, None)
    mask = np.zeros(n, bool)
    jr, tr = _responses(n, None)
    grad_state = np.ones(N_BINS, np.float32)
    want_state, vjp = _jax_record(jr, time, value, object_id, mask)
    state, grads = _torch_record(tr, time, value, object_id, mask, grad_state)
    assert not state.any() and not np.asarray(want_state).any()
    for got, want in zip(grads, [*vjp(jnp.asarray(grad_state))[:2], *vjp(jnp.asarray(grad_state))[2].values()]):
        assert not np.asarray(got).any() and not np.asarray(want).any()


def test_result_and_params_match_jax():
    jr, tr = _responses(8, 2)
    assert set(tr.params("cpu")) == set(jr.params()) == {"t0", "binSize", "bandwidth", "value"}
    state = np.arange(2 * N_BINS, dtype=np.float32)
    np.testing.assert_array_equal(
        tr.result(tr.params("cpu"), torch.tensor(state)).numpy(), np.asarray(jr.result(jr.params(), jnp.asarray(state)))
    )


def test_nonfinite_time_is_a_deliberate_divergence():
    """A lane with a NaN or infinite time: ``theia_tpu`` casts its centre
    to an integer (on the CPU a NaN lands at 0, so the lane writes NaN
    into the first support + 1 bins) and its time gradient is 0 * inf,
    which poisons d time and every parameter's gradient. The port drops
    such a lane with exact zeros in every gradient."""
    time = np.array([12.0, np.nan, np.inf, -np.inf], np.float32)
    value = np.ones(4, np.float32)
    object_id, mask = np.zeros(4, np.int32), np.ones(4, bool)
    jr, tr = _responses(4, None)
    grad_state = np.ones(N_BINS, np.float32)
    want_state, vjp = _jax_record(jr, time, value, object_id, mask)
    d_value, d_time, d_params = vjp(jnp.asarray(grad_state))
    want_state = np.asarray(want_state)
    assert np.isnan(want_state[:4]).all() and np.isnan(np.asarray(d_time)[1:]).all()
    assert np.isnan(float(d_params["t0"]))
    state, grads = _torch_record(tr, time, value, object_id, mask, grad_state)
    # the port keeps lane 0 exactly as JAX does and drops the other three
    ok, _ = _torch_record(tr, time[:1], value[:1], object_id[:1], mask[:1], grad_state)
    np.testing.assert_array_equal(state, ok)
    assert np.isfinite(state).all() and state.sum() > 0
    np.testing.assert_array_equal(grads[0][1:], 0.0)
    np.testing.assert_array_equal(grads[1][1:], 0.0)
    _close(grads[1][:1], np.asarray(d_time)[:1], 1e-5)
    assert all(np.isfinite(g).all() for g in grads)


def test_no_graph_under_no_grad():
    """``run()`` records under ``torch.no_grad()``: nothing is saved and
    the state carries no graph."""
    n = 16
    time, value, object_id, mask = _lanes(n, 9, None)
    _, tr = _responses(n, None)
    vec = torch.zeros((n, 3))
    leaf = torch.tensor(time, requires_grad=True)
    item = tcore.HitItem(vec, vec, vec, torch.full((n,), 400.0), leaf, torch.tensor(value), torch.tensor(object_id))
    with torch.no_grad():
        state, _ = tr.record(tr.params("cpu"), tr.init("cpu"), item, torch.tensor(mask), None)
    assert state.grad_fn is None and not state.requires_grad
    with_grad, _ = tr.record(tr.params("cpu"), tr.init("cpu"), item, torch.tensor(mask), None)
    assert with_grad.grad_fn is not None
    np.testing.assert_array_equal(state.numpy(), with_grad.detach().numpy())


def test_kernel_grad_plain_matches_autograd_of_plain_record():
    """The written-out backward against torch's autograd through the
    plain record's own ops (index_add_ of differentiable weights)."""
    n, n_det = 2048, 2
    time, value, object_id, mask = _lanes(n, 17, n_det)
    args = [torch.tensor(a, requires_grad=True) for a in (value, time, -3.0, BIN, 4.0)]
    grad_state = torch.tensor(np.random.default_rng(1).normal(size=N_BINS * n_det).astype(np.float32))
    state = tresp.kernel_histogram_add_plain(
        torch.zeros(N_BINS * n_det), args[0], args[1], torch.tensor(mask), *args[2:], N_BINS, 4,
        torch.tensor(object_id), n_det,
    )
    auto = torch.autograd.grad(state, args, grad_state)
    plain = tresp.kernel_histogram_grad_plain(
        grad_state, *(a.detach() for a in args[:2]), torch.tensor(mask), *(a.detach() for a in args[2:]),
        N_BINS, 4, torch.tensor(object_id), n_det,
    )
    for got, want, rtol in zip(plain, auto, (1e-6, 1e-5, 1e-4, 1e-4, 1e-4)):
        _close(got.numpy(), want.numpy(), rtol)


def test_support_is_static_and_respected():
    """A smaller support reaches fewer bins: with support 1 a lane on a
    bin centre touches exactly three bins."""
    _, tr = _responses(1, None, support=1)
    vec = torch.zeros((1, 3))
    item = tcore.HitItem(vec, vec, vec, torch.full((1,), 400.0), torch.tensor([99.5]), torch.ones(1), torch.zeros(1, dtype=torch.int32))
    state, _ = tr.record(tr.params("cpu"), tr.init("cpu"), item, torch.ones(1, dtype=torch.bool), None)
    assert (state > 0).sum() == 3
