"""The port's gamma sampler (``theia_tpu_torch.ops.gamma.sample_gamma``, on
the CPU its plain version) against the live ``theia_tpu.ops.gamma`` on the
same streams, with Philox and Sobol generators: per-lane x and the new
dim, R (the rounds of the slowest lane) equal; then the distribution
against scipy's (``tests/test_light_sources.py:72``).

Tolerances and why: the two packages run Cheng's rejection with the same
float32 operations in the same order, but XLA's and torch's CPU ``log`` and
``exp`` differ in ulps. So x agrees within rtol 2e-6 (measured 4.1e-7,
1-3 ulp on ~10 % of the lanes), and a lane whose acceptance test sits an
ulp from its bound may accept in another round: at most 0.1 % of the
lanes (the test prints the count it saw; 0 at these seeds). R, and so
every lane's dim, must be equal: a flip of the slowest lane would move
every lane's later draws. The KS test keeps ``theia_tpu``'s p > 0.01.
"""

import numpy as np
import pytest
import torch
from scipy.stats import gamma as gamma_dist, kstest

import jax
import jax.numpy as jnp

import theia_tpu.random as jrandom
from theia_tpu.ops.gamma import sample_gamma as jax_gamma
import theia_tpu_torch.random as trandom
from theia_tpu_torch.ops.gamma import MAX_ROUNDS, sample_gamma, sample_gamma_plain

torch.set_num_threads(1)

N = 8192
X_RTOL = 2e-6
FLIP_SHARE = 1e-3

GENERATORS = {
    "philox": (lambda m: m.PhiloxRNG(key=0xC0FFEE)),
    "sobol": (lambda m: m.SobolQRNG(seed=7, dims=16)),
}


def draws(alpha, gen: str, n: int = N, dim: int = 0):
    """(x, dims) of both packages on the same lanes, as numpy."""
    jstate = GENERATORS[gen](jrandom).state(jnp.arange(n, dtype=jnp.uint32), dim)
    jx, jrng = jax.jit(jax_gamma)(jnp.asarray(alpha, jnp.float32), jstate)
    tstate = GENERATORS[gen](trandom).state(torch.arange(n, dtype=torch.int32), dim)
    tx, trng = sample_gamma(torch.as_tensor(np.asarray(alpha, np.float32)), tstate)
    return (np.asarray(jx), np.asarray(jrng.dim).astype(np.int64)), (tx.numpy(), trng.dim.numpy().astype(np.int64))


def compare(j, t, label, dim: int = 0):
    """The lanes held to each other; returns R."""
    (jx, jd), (tx, td) = j, t
    np.testing.assert_array_equal(td, jd)
    assert np.array_equal(np.isnan(tx), np.isnan(jx)), label
    ok = ~np.isnan(jx)
    flipped = ok & (np.abs(tx - jx) > X_RTOL * np.abs(jx))
    rounds = (jd[0] - dim - 1) // 2
    print(f"{label}: R = {rounds}, {int(flipped.sum())} of {tx.size} lanes flipped")
    assert flipped.mean() <= FLIP_SHARE, (label, int(flipped.sum()))
    np.testing.assert_allclose(tx[ok & ~flipped], jx[ok & ~flipped], rtol=X_RTOL, atol=0.0)
    return rounds


@pytest.mark.parametrize("gen", sorted(GENERATORS))
@pytest.mark.parametrize("alpha", [0.5, 1.0, 4.0, 20.0])
def test_gamma_matches_jax(alpha, gen):
    rounds = compare(*draws(alpha, gen), f"alpha {alpha}, {gen}")
    assert 1 <= rounds < MAX_ROUNDS


def test_gamma_lane_alphas_match_jax():
    """A lane's own alpha (the cascades' profiles), with lanes that start at
    other dims; alpha 0 gives 0 (its scale u^(1/1e-6) underflows) and a
    negative or NaN alpha never accepts: NaN after 64 rounds."""
    rs = np.random.default_rng(4)
    alpha = rs.choice([0.5, 1.0, 4.0, 20.0, 2.7], N).astype(np.float32)
    compare(*draws(alpha, "philox", dim=5), "per-lane alpha", dim=5)
    alpha[:3] = (0.0, -1.0, np.nan)
    j, t = draws(alpha, "philox")
    assert compare(j, t, "alpha 0, -1, NaN") == MAX_ROUNDS
    assert t[0][0] == 0.0 and np.isnan(t[0][1:3]).all() and np.isfinite(t[0][3:]).all()


def test_gamma_without_lanes():
    state = trandom.PhiloxRNG(key=1).state(torch.zeros(0, dtype=torch.int32))
    x, rng = sample_gamma(2.0, state)
    assert x.shape == (0,) and rng.dim.shape == (0,)


def test_gamma_plain_is_the_cpu_path():
    state = trandom.PhiloxRNG(key=3).state(torch.arange(1000, dtype=torch.int32))
    x, rng = sample_gamma(1.5, state)
    y, rng2 = sample_gamma_plain(1.5, state)
    assert torch.equal(x, y) and torch.equal(rng.dim, rng2.dim)


@pytest.mark.parametrize("alpha", [0.7, 1.5, 4.2])
def test_gamma_sampler_ks(alpha):
    """tests/test_light_sources.py::test_gamma_sampler_ks on the port's draws."""
    state = trandom.PhiloxRNG(key=0xC0FFEE).state(torch.arange(N, dtype=torch.int32))
    z, _ = sample_gamma(alpha, state)
    p = kstest(z.numpy(), gamma_dist(alpha).cdf).pvalue
    assert p > 0.01, (alpha, p)
