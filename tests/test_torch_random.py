"""theia_tpu_torch.random against theia_tpu.random: Philox words and
uniform draws must be bit-exact (same inputs, made with numpy)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import theia_tpu.random as jr
import theia_tpu_torch.random as tr

MASK = 0xFFFFFFFF


def _words(rng, n, edge):
    w = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    if edge:
        w[: n // 2] = MASK  # every carry chain fires
    return w


@pytest.mark.parametrize("edge", [False, True])
def test_philox4x32_words_bit_exact(edge):
    rng = np.random.default_rng(1 + edge)
    n = 2048
    key = _words(rng, 2, edge)
    ctr = [_words(rng, n, edge) for _ in range(4)]
    want = jr.philox4x32(
        jnp.uint32(key[0]), jnp.uint32(key[1]),
        *(jnp.asarray(c, jnp.uint32) for c in ctr),
    )
    got = tr.philox4x32(
        int(key[0]), int(key[1]), *(torch.as_tensor(c.astype(np.int64)) for c in ctr)
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w, np.uint64), g.numpy().astype(np.uint64))


CASES = {
    "random": (0x0123456789ABCDEF, (0x9E3779B9, 0x12345678, 0xCAFEBABE, 0x0BADF00D)),
    "key_near_2_64": (2**64 - 3, (1, 2, 3, 4)),
    "counter_all_ones": (42, (MASK, MASK, MASK, MASK)),
    "counter_low_ones": (7, (MASK, MASK, 5, 0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_philox_uniform_bit_exact(case):
    key, counter = CASES[case]
    rng = np.random.default_rng(len(case))
    n = 4096
    stream = rng.integers(0, 2**31, size=n).astype(np.int32)
    dim = rng.integers(0, 2**31, size=n).astype(np.int32)
    stream[:8] = np.arange(8)  # small streams, where key + stream carries
    dim[:16] = np.arange(16)
    key_words = ((key & MASK), (key >> 32) & MASK)
    want = jr.philox_uniform(
        jnp.asarray(key_words, jnp.uint32),
        jnp.asarray(counter, jnp.uint32),
        jnp.asarray(stream.astype(np.uint32)),
        jnp.asarray(dim.astype(np.uint32)),
    )
    got = tr.philox_uniform(key_words, counter, torch.as_tensor(stream), torch.as_tensor(dim))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    pair = tr.philox_uniform(key_words, counter, torch.as_tensor(stream), torch.as_tensor(dim), width=2)
    want2 = jr.philox_uniform(
        jnp.asarray(key_words, jnp.uint32),
        jnp.asarray(counter, jnp.uint32),
        jnp.asarray(stream.astype(np.uint32)),
        jnp.asarray((dim.astype(np.uint64) + 1).astype(np.uint32)),
    )
    np.testing.assert_array_equal(pair[:, 0].numpy(), got.numpy())
    np.testing.assert_array_equal(pair[:, 1].numpy(), np.asarray(want2))
    assert tr.philox_uniform.launches == 0  # CPU tensors never launch


def test_rng_state_dim_advance():
    n = 1024
    jrng = jr.PhiloxRNG(key=0xC0FFEE, offset=123)
    trng = tr.PhiloxRNG(key=0xC0FFEE, offset=123)
    assert trng.key_words == tuple(int(w) for w in np.asarray(jrng.key_words))
    assert trng.counter_words == tuple(int(w) for w in np.asarray(jrng.counter_words))
    js = jrng.state(jnp.arange(n, dtype=jnp.uint32), dim=3)
    ts = trng.state(torch.arange(n, dtype=torch.int32), dim=3)
    ju, js = js.uniform()
    tu, ts = ts.uniform()
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    (ja, jb), js = js.uniform2d()
    (ta, tb), ts = ts.uniform2d()
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    js, ts = js.skip(5), ts.skip(5)
    np.testing.assert_array_equal(np.asarray(js.dim), ts.dim.numpy())
    assert ts.dim.dtype == torch.int32 and int(ts.dim[0]) == 3 + 1 + 2 + 5
    jrng.advance(74)
    trng.advance(74)
    assert trng.counter_words == tuple(int(w) for w in np.asarray(jrng.counter_words))
