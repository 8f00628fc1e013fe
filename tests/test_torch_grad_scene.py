"""Gradients of the port's scene tracer through ``trace_fn()`` with
respect to the packed medium tables, against ``jax.grad`` of
``theia_tpu`` on the same seed, on in-code icospheres
(``tests/torch_flagship.build_grad_scene``):

- the analogues of ``tests/test_grad_scene.py``'s
  ``test_grad_scene_mu_matches_fd_exactly`` (l.98), ``_mu_a_sign``
  (l.129) and ``_ior_statistical`` (l.178): the medium's mu_a and mu_s
  rows (read through the const4 rows) and its index of refraction
  (through ``_fresnel`` and the score corrections);
- golden c5's configuration (``tools/ref_conformance.py:255-324``)
  live, with an icosphere for ``suzanne.stl``: the polarized, guided
  scene's gradients in water's mu_a, mu_s and ``log_phase_function``
  (the MIS shadow's phase read) and BK7's ``refractive_index``.

Tolerances and why:
- against ``jax.grad``: rtol 1e-3 on each entry (on the entries above
  1e-6 of the largest for the tables of c5, whose smallest entries are
  sums of a few lanes), the loss within 1e-5. Same paths from the same
  streams, the same float32 formulas; summation order and ulps of
  transcendentals apart. The IOR test's gradient: rtol 1e-2, for a lane
  next to total internal reflection (the test says why).
- the FD, sign and statistical checks keep the JAX tests' own limits.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch
from torch_flagship import build_grad_scene

torch.set_num_threads(1)


def patch_media(p, handle, **rows):
    """``tests/test_grad_scene.patch_media`` in either package: the
    medium's rows of the named tables set to (differentiable) scalars, or
    to vectors over their first entries."""
    pack = p["scene"]
    tables = dict(pack.media.tables)
    for kind, val in rows.items():
        if isinstance(val, torch.Tensor):
            t = tables[kind].clone()
            t[handle, : val.shape[0] if val.dim() else t.shape[1]] = val
            tables[kind] = t
        elif jnp.ndim(val):
            tables[kind] = tables[kind].at[handle, : val.shape[0]].set(val)
        else:
            tables[kind] = tables[kind].at[handle].set(val)
    return {**p, "scene": dataclasses.replace(pack, media=dataclasses.replace(pack.media, tables=tables))}


def _jax_grad(kind, batch, points, make_loss):
    tracer = build_grad_scene(theia_tpu, kind, batch)
    fn, (p0, counter, streams) = tracer.trace_fn()
    grad = jax.jit(jax.value_and_grad(make_loss(tracer, fn, p0, counter, streams)))
    return [tuple(np.asarray(a, np.float64) for a in grad(x)) for x in points]


def _medium_loss(weights):
    def make(tracer, fn, p0, counter, streams):
        handle = p0["scene"].media.handle("homogenous")

        def loss(theta):
            p = patch_media(p0, handle, absorption_coef=theta[0], scattering_coef=theta[1])
            state, _ = fn(p, counter, streams)
            return (state * weights).sum()

        return loss

    return make


N_BINS = 50
WEIGHTS = np.exp(-np.linspace(0.0, 2.0, N_BINS)).astype(np.float32)


@pytest.fixture(scope="module")
def medium_case():
    batch = 8 * 1024
    theta_fd, theta_sign = [0.01, 0.008], [0.02, 0.008]
    jax_fd = _jax_grad("medium", batch, [jnp.asarray(theta_fd, jnp.float32)], _medium_loss(jnp.asarray(WEIGHTS)))[0]
    jax_sign = _jax_grad(
        "medium", batch, [jnp.asarray(theta_sign, jnp.float32)], _medium_loss(jnp.ones(N_BINS, jnp.float32))
    )[0]
    tracer = build_grad_scene(theia_tpu_torch, "medium", batch, "cpu")
    return tracer, (theta_fd, jax_fd), (theta_sign, jax_sign)


def _torch_medium(tracer, weights):
    fn, (p0, counter, streams) = tracer.trace_fn()
    return _medium_loss(torch.as_tensor(weights))(tracer, fn, p0, counter, streams)


def _torch_value_and_grad(loss, theta):
    leaf = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
    value = loss(leaf)
    value.backward()
    return value.item(), leaf.grad.numpy().astype(np.float64)


def test_grad_scene_mu_matches_fd_exactly_and_jax(medium_case):
    """Fixed scatter coefficient: the paths do not depend on the
    attenuation, so fixed-seed central differences match the gradient."""
    tracer, (theta0, (j_value, j_grad)), _ = medium_case
    loss = _torch_medium(tracer, WEIGHTS)
    value, g = _torch_value_and_grad(loss, theta0)
    np.testing.assert_allclose(value, j_value, rtol=1e-5)
    np.testing.assert_allclose(g, j_grad, rtol=1e-3)
    with torch.no_grad():
        for i, eps in ((0, 1e-4), (1, 1e-4)):
            e = np.zeros(2)
            e[i] = eps
            hi = float(loss(torch.tensor(np.add(theta0, e), dtype=torch.float32)))
            lo = float(loss(torch.tensor(np.subtract(theta0, e), dtype=torch.float32)))
            fd = (hi - lo) / (2 * eps)
            assert fd != 0.0
            assert abs(g[i] - fd) < 3e-2 * abs(fd), (i, g[i], fd)


def test_grad_scene_mu_a_sign_and_jax(medium_case):
    """More absorption, less detected energy."""
    tracer, _, (theta0, (_, j_grad)) = medium_case
    _, g = _torch_value_and_grad(_torch_medium(tracer, np.ones(N_BINS, np.float32)), theta0)
    assert g[0] < 0.0
    np.testing.assert_allclose(g, j_grad, rtol=1e-3)


def _ior_loss(tracer, fn, p0, counter, streams):
    handle = p0["scene"].media.handle("homogenous")

    def total(n0):
        state, _ = fn(patch_media(p0, handle, refractive_index=n0), counter, streams)
        return state.sum()

    return total


def test_grad_scene_ior_statistical_and_jax():
    """Water to vacuum: the transmittance falls with n. The gradient
    through ``_fresnel`` (score-corrected reflect/transmit choice) and a
    common-random-number FD agree within Monte Carlo noise; the gradient
    equals jax.grad's."""
    batch = 16 * 1024
    (_, j_grad), = _jax_grad("fresnel", batch, [jnp.float32(1.33)], _ior_loss)
    tracer = build_grad_scene(theia_tpu_torch, "fresnel", batch, "cpu")
    fn, (p0, counter, streams) = tracer.trace_fn()
    total = _ior_loss(tracer, fn, p0, counter, streams)
    n0 = torch.tensor(1.33, requires_grad=True)
    total(n0).backward()
    g_ad = float(n0.grad)
    eps = 0.02
    with torch.no_grad():
        fd = (float(total(torch.tensor(1.33 + eps))) - float(total(torch.tensor(1.33 - eps)))) / (2 * eps)
    assert g_ad < 0.0 and fd < 0.0, (g_ad, fd)
    assert abs(g_ad / fd - 1.0) < 0.5, (g_ad, fd)
    # rtol 1e-2, not 1e-3: a lane meets the interface 100 ulps of
    # s2 = 1 - sin_t^2 (5.96e-6) short of total internal reflection, where
    # d cos_t / dn ~ 1 / sqrt(s2) turns one ulp of s2 (XLA rounds 1 -
    # cos_i^2 and sin_i n_i / n_t in an order of its own) into ~1 % of
    # that lane's term; it carries a third of one bin's gradient, and the
    # total is 3.3e-3 apart (measured; at batch 4096, with no such lane,
    # 4.6e-6)
    np.testing.assert_allclose(g_ad, j_grad, rtol=1e-2)


#: golden c5's gradients: (medium, table) -> the key of its artifact
C5_TABLES = {
    ("water", "absorption_coef"): "grad_absorption_coef",
    ("water", "scattering_coef"): "grad_scattering_coef",
    ("water", "log_phase_function"): "grad_log_phase_function",
    ("bk7", "refractive_index"): "grad_refractive_index_glass",
}


def _c5_loss(tracer, fn, p0, counter, streams):
    """``tools/ref_conformance._medium_params_loss`` over all four tables
    at once: the time-weighted detected signal."""
    media = p0["scene"].media
    n_bins = tracer.response.nBins
    torch_side = isinstance(p0["scene"].tri_data, torch.Tensor)
    lin = torch.linspace(0.0, 2.0, n_bins) if torch_side else jnp.linspace(0.0, 2.0, n_bins, dtype=jnp.float32)
    weights = torch.exp(-lin) if torch_side else jnp.exp(-lin)

    def loss(tables):
        p = p0
        for (medium, kind), tbl in zip(C5_TABLES, tables):
            p = patch_media(p, media.handle(medium), **{kind: tbl})
        state, _ = fn(p, counter, streams)
        return (tracer.response.result(p["response"], state).reshape(-1, n_bins) * weights).sum()

    return loss


def _c5_rows(media):
    rows = []
    for medium, kind in C5_TABLES:
        h = media.handle(medium)
        n = int(media.sizes[kind][h])
        rows.append(media.tables[kind][h, :n])
    return rows


def test_golden_c5_configuration_gradients_match_jax():
    """Golden c5's four gradients, live on both packages (batch 2048, its
    own): the polarized guided scene, water's mu_a, mu_s and
    log_phase_function and BK7's refractive_index."""
    batch = 2 * 1024
    jt = build_grad_scene(theia_tpu, "c5", batch)
    jfn, (jp, jc, js) = jt.trace_fn()
    j_value, j_grads = jax.jit(jax.value_and_grad(_c5_loss(jt, jfn, jp, jc, js)))(_c5_rows(jp["scene"].media))
    tracer = build_grad_scene(theia_tpu_torch, "c5", batch, "cpu")
    fn, (p0, counter, streams) = tracer.trace_fn()
    leaves = [r.clone().requires_grad_(True) for r in _c5_rows(p0["scene"].media)]
    value = _c5_loss(tracer, fn, p0, counter, streams)(leaves)
    value.backward()
    np.testing.assert_allclose(value.item(), float(j_value), rtol=1e-5)
    for leaf, want, name in zip(leaves, j_grads, C5_TABLES.values()):
        got, want = leaf.grad.double().numpy(), np.asarray(want, np.float64)
        assert np.isfinite(got).all() and np.abs(want).max() > 0, name
        big = np.abs(want) > 1e-6 * np.abs(want).max()
        np.testing.assert_array_equal(got != 0, want != 0, err_msg=name)
        np.testing.assert_allclose(got[big], want[big], rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-4, err_msg=name)
