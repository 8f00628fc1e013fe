"""The medium gradient: d sum(histogram state) / d (water absorption_coef
row) through the port's trace_fn(), against jax.grad of the JAX tracer,
as __graft_entry__.dryrun_multichip step 1 takes it (polarized flagship,
accel="woop", batch 2048, path length 3, PhiloxRNG(key=42)).

Tolerances and why:
(a) against JAX: the same nonzero entries, each within rtol 1e-3 of
    JAX's, and the sum within rtol 1e-5. Both packages trace the same
    paths (equal RNG dims, see test_torch_polarized_tracer.py) and
    differentiate the same float32 formulas, so they differ only by
    accumulation order and ulps of transcendentals: measured 7.6e-5 on
    the worst entry (one of the smallest) and 1.2e-7 on the sum.
(b) against a central difference of a scale s on the whole row, eps
    1e-2: the scatter coefficient is fixed, so the paths do not depend on
    mu_a and the loss is smooth in s; the O(eps^2) truncation of
    exp(-mu_a d) is ~1e-5 here (measured 1.0e-5), within rtol 1e-3.
(c) d sum / d mu_a <= 0 on every entry, and everything finite.
(d) the histogram backward's plain version equals an explicit one-hot
    VJP exactly (it sums nothing).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch
from theia_tpu_torch.response import histogram_add, histogram_grad, histogram_grad_plain
from torch_flagship import build_flagship, icosphere

# the suite runs several xdist workers on one shared CPU: torch's intra-op
# threads in each of them oversubscribe it (the port's tests took 10x
# longer with the default thread count than with one thread per worker)
torch.set_num_threads(1)

BATCH = 2048
MAX_PATH = 3


def _patched(p, media, tables):
    pp = dict(p)
    pp["scene"] = dataclasses.replace(p["scene"], media=dataclasses.replace(media, tables=tables))
    return pp


def _jax_grad(mesh):
    jt = build_flagship(theia_tpu, mesh, BATCH, MAX_PATH, accel="woop", polarized=True)
    fn, (p, counter, streams) = jt.trace_fn()
    media = p["scene"].media
    h = media.handle("water")

    def loss(row):
        tables = dict(media.tables)
        tables["absorption_coef"] = tables["absorption_coef"].at[h].set(row)
        state, _ = fn(_patched(p, media, tables), counter, streams)
        return jnp.sum(state)

    value, grad = jax.jit(jax.value_and_grad(loss))(media.tables["absorption_coef"][h])
    return float(value), np.asarray(grad)


@pytest.fixture(scope="module")
def grads():
    mesh = icosphere(3)
    tt = build_flagship(theia_tpu_torch, mesh, BATCH, MAX_PATH, accel="woop", device="cpu", polarized=True)
    fn, (p, counter, streams) = tt.trace_fn()
    media = p["scene"].media
    h = media.handle("water")
    base = media.tables["absorption_coef"][h].clone()

    def loss(row):
        table = media.tables["absorption_coef"].clone()
        table[h] = row
        state, _ = fn(_patched(p, media, {**media.tables, "absorption_coef": table}), counter, streams)
        return state.sum()

    leaf = base.clone().requires_grad_(True)
    value = loss(leaf)
    value.backward()
    eps = 1e-2
    with torch.no_grad():
        fd = (float(loss(base * (1 + eps))) - float(loss(base * (1 - eps)))) / (2 * eps)
    j_value, j_grad = _jax_grad(mesh)
    return dict(
        value=value.item(), grad=leaf.grad.numpy(), base=base.numpy(), fd=fd,
        j_value=j_value, j_grad=j_grad,
    )


def test_grad_matches_jax(grads):
    g, jg = grads["grad"], grads["j_grad"]
    np.testing.assert_allclose(grads["value"], grads["j_value"], rtol=1e-5)
    np.testing.assert_array_equal(g != 0, jg != 0)
    assert (g != 0).sum() >= 10  # many table entries take part
    np.testing.assert_allclose(g, jg, rtol=1e-3)
    np.testing.assert_allclose(g.sum(), jg.sum(), rtol=1e-5)


def test_grad_matches_central_difference(grads):
    analytic = float((grads["grad"].astype(np.float64) * grads["base"]).sum())
    np.testing.assert_allclose(analytic, grads["fd"], rtol=1e-3)


def test_grad_sign_and_finite(grads):
    g = grads["grad"]
    assert np.isfinite(g).all() and np.isfinite(grads["value"])
    assert (g <= 0).all() and g.sum() < 0


@pytest.mark.parametrize("n_det", [None, 3])
def test_histogram_backward_plain(n_det):
    """The plain backward against the one-hot VJP, and through autograd."""
    rng = np.random.default_rng(21)
    n, bins = 5000, 50
    time = torch.as_tensor(rng.uniform(-20.0, 270.0, n).astype(np.float32))
    mask = torch.as_tensor(rng.uniform(size=n) < 0.7)
    oid = torch.as_tensor(rng.integers(-1, (n_det or 1) + 1, n).astype(np.int32))
    t0, size = torch.tensor(0.0), torch.tensor(5.0)
    grad_state = torch.as_tensor(rng.normal(size=bins * (n_det or 1)).astype(np.float32))
    args = (time, mask, t0, size, bins, oid if n_det else None, n_det)
    got = histogram_grad(grad_state, *args)
    assert torch.equal(got, histogram_grad_plain(grad_state, *args))
    # one-hot reference: d state[k] / d value[i] = [lane i lands in bin k]
    b = torch.floor((time - t0) / size).long()
    keep = mask & (b >= 0) & (b < bins)
    if n_det:
        keep &= (oid >= 0) & (oid < n_det)
        b = b + oid.long() * bins
    one_hot = torch.zeros(n, grad_state.numel())
    one_hot[keep.nonzero()[:, 0], b[keep]] = 1.0
    assert torch.equal(got, one_hot @ grad_state)
    assert keep.any() and (~keep).any()
    value = torch.as_tensor(rng.uniform(size=n).astype(np.float32)).requires_grad_(True)
    state = histogram_add(torch.zeros_like(grad_state), value, time, mask, t0, size, bins,
                          oid if n_det else None, n_det)
    state.backward(grad_state)
    assert torch.equal(value.grad, got)
    assert histogram_grad.launches == 0
