"""The gamma draw's mixed-rounds calls (``chip_smoke.gamma_mixed_case``:
lanes of alphas 0.05-40 with the edge alphas 0, -1 and NaN spread over
the warps of a block and over later blocks), held on the CPU between the
port (``ops.gamma.sample_gamma``, its plain version here) and the live
``theia_tpu.ops.gamma`` on the same lanes and dims, with Philox and Sobol.
On the card ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``
hold the kernel against the plain version on the same calls.

Tolerances as ``tests/test_torch_gamma.py`` states them (``compare``): x
within rtol 2e-6 but on lanes flipped by an ulp of log (at most 0.1 %),
NaN lanes alike, every lane's dim after the call equal (R the same). One
more: alpha 0.05 scales x by u^20, which falls below float32's smallest
normal (2^-126) on about 2 % of its lanes; XLA flushes such subnormals to
zero and torch keeps them, so a port lane below 2^-126 where JAX has 0 is
taken as equal (the test prints how many).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import theia_tpu.random as jrandom
from test_torch_gamma import compare
from theia_tpu.ops.gamma import sample_gamma as jax_gamma
from theia_tpu_torch.ops.gamma import MAX_ROUNDS, sample_gamma

torch.set_num_threads(1)

N = 4096


@pytest.mark.parametrize("gen", ["philox", "sobol"])
def test_mixed_rounds_match_jax(gen):
    alpha, rng = chip_smoke.gamma_mixed_case(N, "cpu")[gen]
    lanes = jnp.arange(N, dtype=jnp.uint32)
    dim = jnp.asarray(rng.dim.numpy().astype(np.uint32))
    if gen == "philox":
        jstate = jrandom.PhiloxRNG(key=0xF00D, offset=77).state(lanes, dim)
    else:
        jstate = jrandom.SobolQRNG(**chip_smoke.FLAGSHIP_SOBOL).state(lanes, dim)
    jx, jrng = jax.jit(jax_gamma)(jnp.asarray(alpha.numpy()), jstate)
    tx, trng = sample_gamma(alpha, rng)
    jx, tx = np.asarray(jx), tx.numpy().copy()
    flushed = (jx == 0.0) & (np.abs(tx) < np.finfo(np.float32).tiny)
    print(f"mixed rounds, {gen}: {int(flushed.sum())} lanes subnormal in the port, 0 in JAX")
    tx[flushed] = 0.0
    j = (jx, np.asarray(jrng.dim).astype(np.int64))
    t = (tx, trng.dim.numpy().astype(np.int64))
    before = rng.dim.numpy().astype(np.int64)
    assert compare((j[0], j[1] - before), (t[0], t[1] - before), f"mixed rounds, {gen}") == MAX_ROUNDS
    edges = [i for i in chip_smoke.GAMMA_EDGE_LANES if i < N]
    a = alpha.numpy()
    assert np.isnan(t[0][edges]).sum() == int((np.isnan(a) | (a < 0)).sum()) > 2
    assert len({i // 32 for i in edges if i < 256}) >= 6, "the edge lanes do not spread over a block's warps"
