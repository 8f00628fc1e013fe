"""The port's host-fed and tabulated sources against the live
``theia_tpu`` on the CPU: ``HostWavelengthSource``, ``HostLightSource`` and
their streaming forms (rows by stream id modulo the rows; each ``params``
takes the next ``batchSize`` rows, offsets walking as theia_tpu's), and
``FunctionWavelengthSource`` (scipy's inverse-CDF table, read by the
port's ``lookup``; the KS test of ``tests/test_light_sources.py``), through
the sources and the volume flagship.

Tolerances: the host sources gather rows, so equality; the tabulated
wavelengths within 1e-4 nm (the table equal, the interpolation the same
float32 operations), the volume flagship's light curve as
``tests/test_torch_volume.py``'s (sum within rtol 1e-4, every bin within
1e-4 of the largest) with every lane's dims equal.
"""

import importlib

import numpy as np
import pytest
import torch
from scipy.integrate import quad
from scipy.stats import kstest

import jax
import jax.numpy as jnp

import theia_tpu
import theia_tpu_torch
from theia_tpu_torch.interop import params_from_numpy
from torch_flagship import build_volume_flagship, numpy_tree

torch.set_num_threads(1)

N = 4096
ROWS = 1000


def light(pkg):
    return importlib.import_module(f"{pkg.__name__}.light")


def host_arrays(seed: int = 0):
    rs = np.random.default_rng(seed)
    d = rs.normal(size=(ROWS, 3))
    return dict(
        position=rs.uniform(-2.0, 2.0, (ROWS, 3)), direction=d / np.linalg.norm(d, axis=1, keepdims=True),
        startTime=rs.uniform(0.0, 10.0, ROWS), contrib=rs.uniform(0.5, 2.0, ROWS),
        wavelength=rs.uniform(400.0, 500.0, ROWS), lam_contrib=rs.uniform(0.5, 1.5, ROWS),
    )


def spectrum(lam):
    return np.exp(-((lam - 450.0) ** 2) / (2 * 30.0**2))


SOURCES = {
    "host wavelength": lambda pkg, a: light(pkg).HostWavelengthSource(a["wavelength"], a["lam_contrib"]),
    "streaming host wavelength": lambda pkg, a: light(pkg).StreamingHostWavelengthSource(
        a["wavelength"], a["lam_contrib"], batchSize=300),
    "function wavelength": lambda pkg, a: light(pkg).FunctionWavelengthSource(spectrum, lambdaRange=(300.0, 700.0)),
    "host light": lambda pkg, a: light(pkg).HostLightSource(a["position"], a["direction"], a["startTime"], a["contrib"]),
    "streaming host light": lambda pkg, a: light(pkg).StreamingHostLightSource(
        a["position"], a["direction"], a["startTime"], a["contrib"], batchSize=300),
}


def draw(pkg, source, calls: int = 3):
    """Three successive params() and samples of ``source`` on N lanes."""
    out = []
    for _ in range(calls):
        if pkg is theia_tpu:
            p, lanes, arr = source.params(), jnp.arange(N, dtype=jnp.uint32), jnp.asarray
        else:
            p, lanes, arr = source.params("cpu"), torch.arange(N, dtype=torch.int32), torch.as_tensor
        rng = importlib.import_module(f"{pkg.__name__}.random").PhiloxRNG(key=9).state(lanes)
        if hasattr(source, "sample_forward"):
            ray, rng = source.sample_forward(p, None, None, rng)
            values = [ray.position, ray.direction, ray.start_time, ray.contrib]
        else:
            (lam, contrib), rng = source.sample(p, rng)
            values = [lam, contrib]
        out.append(([np.asarray(v) for v in values], np.asarray(rng.dim)))
    return out


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_source_matches_jax(name):
    a = host_arrays()
    for (j, jd), (t, td) in zip(*(draw(pkg, SOURCES[name](pkg, a)) for pkg in (theia_tpu, theia_tpu_torch))):
        np.testing.assert_array_equal(td, jd)
        for jv, tv in zip(j, t):
            if name.startswith("function"):
                np.testing.assert_allclose(tv, jv, rtol=0.0, atol=1e-4)
            else:
                np.testing.assert_array_equal(tv, jv)
    if name.startswith("streaming"):
        src = SOURCES[name](theia_tpu_torch, a)
        src.params("cpu"), src.params("cpu")
        assert src.offset == 600 and SOURCES[name](theia_tpu, a).offset == 0


def test_function_wavelength_source():
    """tests/test_light_sources.py::test_function_wavelength_source on the
    port: the contribution is the spectrum's integral, the samples follow it."""
    src = light(theia_tpu_torch).FunctionWavelengthSource(spectrum, lambdaRange=(300.0, 700.0))
    rng = theia_tpu_torch.random.PhiloxRNG(key=0xC0FFEE).state(torch.arange(8 * 1024, dtype=torch.int32))
    (lam, contrib), _ = src.sample(src.params("cpu"), rng)
    norm_const, _ = quad(spectrum, 300.0, 700.0)
    np.testing.assert_allclose(contrib.numpy(), norm_const, rtol=1e-5)
    np.testing.assert_array_equal(src._table, light(theia_tpu).FunctionWavelengthSource(
        spectrum, lambdaRange=(300.0, 700.0))._table)

    def cdf(x):
        return np.vectorize(lambda v: quad(spectrum, 300.0, v)[0] / norm_const)(x)

    assert kstest(lam.numpy()[:2000], cdf).pvalue > 0.01


@pytest.mark.parametrize("kind", ["host light", "function wavelength"])
def test_volume_flagship_with_host_sources(kind):
    """The volume flagship fed by a host light source, or with its
    wavelengths drawn from the tabulated spectrum."""
    a = host_arrays(1)

    def build(pkg, device=None):
        if kind == "host light":
            return build_volume_flagship(pkg, N, device, source=SOURCES[kind](pkg, dict(a, position=a["position"] - 7.0)))
        tracer = build_volume_flagship(pkg, N, device)
        tracer.wavelengthSource = SOURCES[kind](pkg, a)
        return tracer

    jt, tt = build(theia_tpu), build(theia_tpu_torch, "cpu")
    jt._debug_rng = tt._debug_rng = True
    p = jt.params()
    js, _, jd = jax.jit(jt._trace_batch)(p, jt.rng.counter_words, jt.streams())
    tp = params_from_numpy(numpy_tree(p), "cpu")
    with torch.no_grad():
        ts, _, td = tt._trace_batch(tp, tt.rng.counter_words, tt.streams())
    np.testing.assert_array_equal(td.numpy().astype(np.int64), np.asarray(jd).astype(np.int64))
    jh = np.asarray(jt.response.result(p["response"], js), np.float64)
    th = tt.response.result(tp["response"], ts).double().numpy()
    assert jh.sum() > 0
    assert abs(th.sum() / jh.sum() - 1.0) <= 1e-4
    assert np.abs(th - jh).max() <= 1e-4 * jh.max()
