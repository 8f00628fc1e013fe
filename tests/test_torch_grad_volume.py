"""Gradients of the port's volume tracer through ``trace_fn()``, against
``jax.grad`` of ``theia_tpu`` on the same seed, and the analogues of
``tests/test_grad_volume.py`` (mu FD-exact, ``g`` statistical, mu_a
sign) and ``tests/test_grad_time.py`` (the group velocity through the
kernel histogram's smooth time dependence).

The HG medium is built from tensors that carry a graph
(``hg_medium``), as the JAX tests build it from traced scalars: its
tables go through ``Medium.to`` unchanged, so d/d(mu_a, mu_s, g) reaches
them through ``lookup`` (the table read's backward).

Tolerances and why:
- against ``jax.grad``: rtol 1e-3. Both trace the same paths from the
  same Philox streams (equal RNG dims, tests/test_torch_volume.py) and
  differentiate the same float32 formulas; they differ by summation
  order and by the ulps of transcendentals (the tables of ``g`` are
  built with torch's ``pow``/``log`` here and with jnp's there).
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
import theia_tpu_torch.units as tu
from test_grad_volume import hg_medium as jax_hg_medium
from torch_flagship import numpy_tree

torch.set_num_threads(1)

BATCH = 4096
N_TABLE = 64
N_BINS = 60
BIN_SIZE = 20.0
WEIGHTS = np.exp(-np.linspace(0.0, 2.0, N_BINS)).astype(np.float32)


def hg_medium(mu_a, mu_s, g):
    """``tests/test_grad_volume.hg_medium`` in the port: a dispersion-free
    HG medium of ``theia_tpu_torch`` from (differentiable) scalars."""
    ones = torch.ones(N_TABLE)
    cos_theta = torch.tensor(np.array(jnp.linspace(-1.0, 1.0, N_TABLE)))
    eta = torch.tensor(np.array(jnp.linspace(0.0, 1.0, N_TABLE)))
    log_phase = torch.log((1.0 - g**2) / torch.pow(1.0 + g**2 - 2.0 * g * cos_theta, 1.5) / (4.0 * np.pi))
    phase_sampling = (1.0 + g**2 - ((1.0 - g**2) / (1.0 + g - 2.0 * g * eta)) ** 2) / (2.0 * g)
    return theia_tpu_torch.material.Medium(
        torch.tensor(400.0), torch.tensor(700.0),
        refractive_index=1.33 * ones, group_velocity=(tu.c / 1.33) * ones,
        absorption_coef=mu_a * ones, scattering_coef=mu_s * ones,
        log_phase_function=log_phase, phase_sampling=phase_sampling, name="hg",
    )


def build(pkg, batch=BATCH, **kw):
    """``tests/test_grad_volume.build_tracer`` of package ``pkg``."""
    dev = {"device": "cpu"} if pkg is theia_tpu_torch else {}
    medium = (jax_hg_medium if pkg is theia_tpu else hg_medium)(0.01, 0.008, 0.4)
    return pkg.trace.VolumeForwardTracer(
        batch,
        pkg.light.SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(10.0, 10.0), budget=1e9),
        pkg.target.InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=100.0),
        pkg.light.UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        pkg.response.HistogramHitResponse(nBins=N_BINS, t0=0.0, binSize=BIN_SIZE),
        pkg.random.PhiloxRNG(key=0xC0FFEE),
        medium=medium, nScattering=8, scatterCoefficient=0.02, maxTime=float("inf"), **kw, **dev,
    )


def _torch_loss(tracer, weights):
    fn, (p0, counter, streams) = tracer.trace_fn()

    def loss(theta):
        p = dict(p0)
        p["medium"] = hg_medium(*theta)
        state, _ = fn(p, counter, streams)
        return (state * torch.as_tensor(weights)).sum() * tracer.normalization

    return loss


def _torch_grad(loss, theta):
    leaf = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
    value = loss(leaf.unbind())
    value.backward()
    return value.item(), leaf.grad.numpy().astype(np.float64)


@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad of the JAX test's two losses at the points the tests use."""
    tracer = build(theia_tpu)
    fn, (p0, counter, streams) = tracer.trace_fn()

    def loss(theta, weights):
        p = dict(p0)
        p["medium"] = jax_hg_medium(theta[0], theta[1], theta[2])
        hist, _ = fn(p, counter, streams)
        return jnp.sum(hist * weights) * tracer.normalization

    grad = jax.jit(jax.value_and_grad(loss))
    points = {
        "fd": ([0.01, 0.008, 0.4], WEIGHTS),
        "g": ([0.0, 0.008, 0.4], np.ones(N_BINS, np.float32)),
        "sign": ([0.02, 0.008, 0.4], np.ones(N_BINS, np.float32)),
    }
    out = {}
    for name, (theta, w) in points.items():
        v, g = grad(jnp.asarray(theta, jnp.float32), jnp.asarray(w))
        out[name] = (float(v), np.asarray(g, np.float64))
    return out


@pytest.fixture(scope="module")
def tracer():
    return build(theia_tpu_torch)


def test_grad_mu_matches_fd_exactly_and_jax(tracer, jax_grads):
    """Fixed sampling coefficient: the paths do not depend on mu_a/mu_s,
    so fixed-seed central differences match the gradient."""
    loss = _torch_loss(tracer, WEIGHTS)
    theta0 = [0.01, 0.008, 0.4]
    value, g = _torch_grad(loss, theta0)
    j_value, j_grad = jax_grads["fd"]
    np.testing.assert_allclose(value, j_value, rtol=1e-5)
    np.testing.assert_allclose(g, j_grad, rtol=1e-3)
    with torch.no_grad():
        for i, eps in ((0, 1e-4), (1, 1e-4)):
            e = np.zeros(3)
            e[i] = eps
            hi = float(loss(torch.tensor(np.add(theta0, e), dtype=torch.float32).unbind()))
            lo = float(loss(torch.tensor(np.subtract(theta0, e), dtype=torch.float32).unbind()))
            fd = (hi - lo) / (2 * eps)
            assert fd != 0.0
            assert abs(g[i] - fd) < 2e-2 * abs(fd), (i, g[i], fd)


def test_grad_g_statistical_and_jax(tracer, jax_grads):
    """d total / d g through the phase tables: the detached-sampler
    gradient and a common-random-number FD agree within Monte Carlo
    noise, and the gradient equals jax.grad's."""
    loss = _torch_loss(tracer, np.ones(N_BINS, np.float32))
    theta0 = [0.0, 0.008, 0.4]
    _, g = _torch_grad(loss, theta0)
    np.testing.assert_allclose(g, jax_grads["g"][1], rtol=1e-3)
    eps = 0.05
    with torch.no_grad():
        fd = (float(loss(torch.tensor([0.0, 0.008, 0.4 + eps]).unbind()))
              - float(loss(torch.tensor([0.0, 0.008, 0.4 - eps]).unbind()))) / (2 * eps)
    assert fd > 0.0 and g[2] > 0.0
    assert abs(g[2] / fd - 1.0) < 0.5, (g[2], fd)


def test_grad_mu_a_sign_and_jax(tracer, jax_grads):
    loss = _torch_loss(tracer, np.ones(N_BINS, np.float32))
    _, g = _torch_grad(loss, [0.02, 0.008, 0.4])
    assert g[0] < 0.0
    np.testing.assert_allclose(g, jax_grads["sign"][1], rtol=1e-3)


def test_interop_carries_a_medium_of_arrays():
    """A volume tracer whose ``Medium`` was built from JAX arrays (the
    traced-scalar ``hg_medium``): ``interop.params_from_numpy`` carries
    its tables and wavelength range over bit for bit, as tensors the
    port's tracer reads."""
    jt = build(theia_tpu, batch=64)
    carried = theia_tpu_torch.interop.params_from_numpy(numpy_tree(jt.params()), "cpu")["medium"]
    assert isinstance(carried, theia_tpu_torch.material.Medium) and carried.name == "hg"
    for k in ("lambda_min", "lambda_max", "log_phase_function", "phase_sampling", "absorption_coef"):
        np.testing.assert_array_equal(getattr(carried, k).numpy(), np.asarray(getattr(jt.params()["medium"], k)))


def test_medium_to_keeps_the_graph():
    """``Medium.to`` on tensors that carry a graph returns them as they
    are (same device and type), so the tracer's params keep it."""
    g = torch.tensor(0.4, requires_grad=True)
    med = hg_medium(torch.tensor(0.01), torch.tensor(0.008), g).to("cpu")
    assert med.log_phase_function.grad_fn is not None and med.phase_sampling.requires_grad
    med.phase_sampling.sum().backward()
    assert g.grad is not None and g.grad != 0


def _time_tracer(pkg):
    """``tests/test_grad_time.py``'s tracer at batch 4096."""
    dev = {"device": "cpu"} if pkg is theia_tpu_torch else {}
    medium = pkg.testing.WaterTestModel(mu_a=0.001, mu_s=0.02, g=0.4).createMedium()
    return pkg.trace.VolumeForwardTracer(
        BATCH,
        pkg.light.SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        pkg.target.SphereTarget(position=(15.0, 0.0, 0.0), radius=4.0),
        pkg.light.UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        pkg.response.KernelHistogramHitResponse(nBins=60, binSize=4.0, t0=0.0, bandwidth=4.0),
        pkg.random.PhiloxRNG(key=0x71AE),
        medium=medium, nScattering=6, maxTime=250.0, **dev,
    )


def test_group_velocity_time_gradient():
    """Faster light, earlier arrival: d (mean bin) / d log(vg scale)
    through the kernel histogram is negative, within 5 % of a central
    difference, and equals jax.grad's; the tracer's params carried over
    from JAX by ``interop.params_from_numpy`` (the kernel histogram's
    three and the medium's tables) equal the port's own."""
    import theia_tpu.testing  # noqa: F401  (pkg.testing below)

    jt, tt = _time_tracer(theia_tpu), _time_tracer(theia_tpu_torch)
    jfn, (jp0, jc, js) = jt.trace_fn()
    bins = jnp.arange(60, dtype=jnp.float32)

    def jmean(s):
        med = dataclasses.replace(jp0["medium"], group_velocity=jp0["medium"].group_velocity * jnp.exp(s))
        state, _ = jfn({**jp0, "medium": med}, jc, js)
        hist = jt.response.result(jp0["response"], state)
        return jnp.sum(hist * bins) / jnp.sum(hist)

    j_grad = float(jax.grad(jmean)(0.0))
    fn, (p0, counter, streams) = tt.trace_fn()
    carried = theia_tpu_torch.interop.params_from_numpy(numpy_tree(jp0), "cpu")
    for stage in ("response", "tracer", "lightSource", "target"):
        for k, v in p0[stage].items():
            if isinstance(v, torch.Tensor):
                assert torch.allclose(carried[stage][k].to(v.dtype), v, rtol=0, atol=0, equal_nan=True), (stage, k)
    for k in ("group_velocity", "absorption_coef", "log_phase_function", "phase_sampling"):
        assert torch.equal(getattr(carried["medium"], k), getattr(p0["medium"], k)), k
    tbins = torch.arange(60, dtype=torch.float32)

    def mean(s):
        med = dataclasses.replace(p0["medium"], group_velocity=p0["medium"].group_velocity * torch.exp(s))
        state, _ = fn({**p0, "medium": med}, counter, streams)
        hist = tt.response.result(p0["response"], state)
        return (hist * tbins).sum() / hist.sum()

    s = torch.tensor(0.0, requires_grad=True)
    mean(s).backward()
    g = float(s.grad)
    eps = 0.02
    with torch.no_grad():
        fd = (float(mean(torch.tensor(eps))) - float(mean(torch.tensor(-eps)))) / (2 * eps)
    assert g < 0
    assert abs(g - fd) < 0.05 * abs(fd), (g, fd)
    np.testing.assert_allclose(g, j_grad, rtol=1e-3)
