"""theia_tpu_torch's Owen-scrambled Sobol generator against theia_tpu's on
the CPU, bit for bit: the four integer helpers, the direction table,
``sobol_owen_uniform_plain`` (which the CPU path of ``sobol_owen_uniform``
runs) on 2^16 seeded (index, dim) pairs and on the edge values of index,
dimension, seed and table size, the Philox tail past the table,
``SobolQRNG.sample``, ``rng_buffer``, ``Key``, ``Counter`` and
``RNGBufferSink``; then the port's analogues of ``tests/test_sobol.py``
(stratification, uniformity, seeds, batches, streams, the buffer sink).
Every comparison with ``theia_tpu`` is exact: the same uint32 arithmetic
on the same words."""

import warnings

import numpy as np
import pytest
import torch
from scipy.stats import kstest

import jax.numpy as jnp

import theia_tpu.random as jr
import theia_tpu_torch.random as tr

torch.set_num_threads(1)

MASK = 0xFFFFFFFF
N = 1 << 16
EDGE_INDICES = (0, 2**31 - 1, 2**31, 2**32 - 1)
SEEDS = (0, 0x80000000, 0xFFFFFFFF, 0x2545F491)


def _words(n: int, seed: int) -> np.ndarray:
    """n uint32 words, a quarter of them with the high bit set, the edge
    indices first."""
    w = np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint64)
    w[: n // 4] |= 0x80000000
    w[: len(EDGE_INDICES)] = EDGE_INDICES
    return w.astype(np.uint32)


def _int32(words: np.ndarray) -> torch.Tensor:
    """uint32 words as the int32 tensor of their bits (the port's lanes)."""
    return torch.as_tensor(words.astype(np.uint32).view(np.int32).copy())


def _bits(u) -> np.ndarray:
    return np.asarray(u, np.float32).view(np.uint32)


@pytest.mark.parametrize("helper", ["_reverse_bits32", "_hash32"])
def test_unary_helpers_bit_exact(helper):
    x = _words(N, 1)
    want = np.asarray(getattr(jr, helper)(jnp.asarray(x)))
    got = getattr(tr, helper)(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # host ints take the same path as tensors (the wrapper hashes the seed)
    assert all(getattr(tr, helper)(int(v)) == int(w) for v, w in zip(x[:64], want[:64]))


@pytest.mark.parametrize("helper", ["_laine_karras", "_nested_uniform_scramble"])
def test_seeded_helpers_bit_exact(helper):
    x, seed = _words(N, 2), _words(N, 3)
    want = np.asarray(getattr(jr, helper)(jnp.asarray(x), jnp.asarray(seed)))
    as_t = lambda a: torch.as_tensor(a.astype(np.int64))
    np.testing.assert_array_equal(getattr(tr, helper)(as_t(x), as_t(seed)).numpy(), want.astype(np.int64))
    for s in SEEDS:  # one host seed for every lane, as the index scramble takes it
        want = np.asarray(getattr(jr, helper)(jnp.asarray(x), jnp.uint32(s)))
        np.testing.assert_array_equal(getattr(tr, helper)(as_t(x), s).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dims", [1, 64, 128])
def test_direction_numbers_equal(dims):
    want = np.asarray(jr.sobol_direction_numbers(dims))
    got = tr.sobol_direction_numbers(dims)
    assert got.dtype == np.uint32 and got.shape == (dims, 32)
    np.testing.assert_array_equal(got, want)
    table = tr._direction_table(dims, "cpu")
    assert table.dtype == torch.int32 and table.is_contiguous()
    np.testing.assert_array_equal(table.numpy().view(np.uint32), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dims", [1, 64, 128])
def test_sobol_owen_uniform_plain_bit_exact(seed, dims):
    """2^16 seeded (index, dim) pairs, a third of them in the tail past
    the table, the edge indices and dims 0, dims - 1, dims and dims + 50
    among them; the CPU path of the wrapper is the plain version."""
    index = _words(N, seed & 0xFFFF)
    dim = np.random.default_rng(dims).integers(0, dims + dims // 2 + 51, size=N).astype(np.uint32)
    dim[: 4 * len(EDGE_INDICES)] = np.repeat([0, dims - 1, dims, dims + 50], len(EDGE_INDICES))
    index[: 4 * len(EDGE_INDICES)] = np.tile(EDGE_INDICES, 4)
    want = jr.sobol_owen_uniform(jr.sobol_direction_numbers(dims), jnp.uint32(seed), jnp.asarray(index), jnp.asarray(dim))
    table = tr._direction_table(dims, "cpu")
    got = tr.sobol_owen_uniform(table, seed, _int32(index), _int32(dim))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(tr.sobol_owen_uniform_plain(table, seed, _int32(index), _int32(dim))), _bits(want)
    )
    # width 2 is the pair (dim, dim + 1) of uniform2d
    want2 = jr.sobol_owen_uniform(
        jr.sobol_direction_numbers(dims), jnp.uint32(seed), jnp.asarray(index), jnp.asarray(dim + 1)
    )
    pair = tr.sobol_owen_uniform(table, seed, _int32(index), _int32(dim), width=2)
    np.testing.assert_array_equal(_bits(pair[:, 0]), _bits(want))
    np.testing.assert_array_equal(_bits(pair[:, 1]), _bits(want2))


def test_offset_wraps_like_the_uint32_index():
    """The lane's index is stream + offset mod 2^32: streams are int32 in
    the port and uint32 in JAX, and the offset may pass 2^32."""
    stream = _words(4096, 9)
    offset = 2**32 - 5
    dim = np.arange(4096, dtype=np.uint32) % 70
    want = jr.sobol_owen_uniform(
        jr.sobol_direction_numbers(64), jnp.uint32(7), jnp.asarray(stream) + jnp.uint32(offset), jnp.asarray(dim)
    )
    got = tr.sobol_owen_uniform(tr._direction_table(64, "cpu"), 7, _int32(stream), _int32(dim), offset=offset)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_tail_is_philox_keyed_on_the_seed():
    """Past the table a draw is theia_tpu's Philox word of the shuffled
    index under the key (seed, hash32(seed)) with a zero counter."""
    seed, dims = 0xC0FFEE, 4
    index = _words(2048, 4)
    dim = (np.arange(2048) % 40 + dims).astype(np.uint32)
    shuffled = jr._nested_uniform_scramble(jnp.asarray(index), jr._hash32(jnp.uint32(seed) ^ jnp.uint32(0xA511E9B3)))
    key = jnp.stack([jnp.uint32(seed), jr._hash32(jnp.uint32(seed))])
    want = jr.philox_uniform(key, jnp.zeros(4, jnp.uint32), shuffled, jnp.asarray(dim))
    got = tr.sobol_owen_uniform(tr._direction_table(dims, "cpu"), seed, _int32(index), _int32(dim))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_state_and_sample_match_jax():
    j, t = jr.SobolQRNG(seed=0xFFFFFFFF, dims=8), tr.SobolQRNG(seed=0xFFFFFFFF, dims=8)
    j.advance(3 * 2**30), t.advance(3 * 2**30)
    np.testing.assert_array_equal(t.sample(300, device="cpu").numpy(), j.sample(300))
    assert t.counter_words == tuple(int(w) for w in np.asarray(j.counter_words))
    lanes = np.arange(100, dtype=np.uint32)
    js = j.state(jnp.asarray(lanes), dim=3)
    ts = t.state(torch.as_tensor(lanes.astype(np.int32)), dim=3)
    np.testing.assert_array_equal(ts.index.numpy().view(np.uint32), np.asarray(js.index))
    (ja, jb), _ = js.uniform2d()
    (ta, tb), ts2 = ts.uniform2d()
    np.testing.assert_array_equal(_bits(ta), _bits(ja))
    np.testing.assert_array_equal(_bits(tb), _bits(jb))
    assert (ts2.dim == 5).all() and (ts.skip(4).dim == 7).all()
    ju, _ = js.uniform()
    tu, _ = ts.uniform()
    np.testing.assert_array_equal(_bits(tu), _bits(ju))


@pytest.mark.parametrize("kind", ["philox", "sobol"])
def test_rng_buffer_matches_jax(kind):
    make = {"philox": lambda m: m.PhiloxRNG(key=2**64 - 3, offset=5), "sobol": lambda m: m.SobolQRNG(seed=5, dims=16)}
    j, t = make[kind](jr), make[kind](tr)
    want = np.asarray(jr.rng_buffer(j, 37, 9, base_stream=4, base_count=2))
    got = tr.rng_buffer(t, 37, 9, base_stream=4, base_count=2, device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if kind == "sobol":
        with pytest.raises(ValueError, match="draws per stream"):
            tr.rng_buffer(t, 4, 15, base_count=2, device="cpu")


def test_key_counter_and_sink_match_jax():
    for value in (0, 2**64 - 1, 0x0123456789ABCDEF):
        assert tr.Key(value).words == tuple(int(w) for w in np.asarray(jr.Key(value).words))
        assert tr.Key(value).value == jr.Key(value).value == value
    for value in (0, 2**128 - 1, 3 << 70):
        assert tr.Counter(value).words == tuple(int(w) for w in np.asarray(jr.Counter(value).words))
        assert tr.Counter(value).value == value
    for make in (lambda m: m.PhiloxRNG(key=11), lambda m: m.SobolQRNG(seed=11, dims=8)):
        j = jr.RNGBufferSink(make(jr), 16, 2, baseStream=1, baseCount=1, sampleDim=2)
        t = tr.RNGBufferSink(make(tr), 16, 2, baseStream=1, baseCount=1, sampleDim=2, device="cpu")
        for _ in range(2):
            want, got = j.run(), t.run()
            assert got.shape == want.shape == (16, 2, 2)
            np.testing.assert_array_equal(got, want)
        assert t.generator.offset == j.generator.offset


def test_configure_advances_by_the_capacity_and_warns_past_dims():
    rng = tr.SobolQRNG(seed=1, dims=8)
    with pytest.warns(UserWarning, match="Sobol dims"):
        rng.configure(20, 4096)
    assert rng.autoAdvance == 4096
    rng.advance()
    assert rng.offset == 4096 and rng.counter_words == (4096, 1, 0, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr.SobolQRNG(dims=8).configure(8, 64)


# -- the port's analogues of tests/test_sobol.py ------------------------------


def test_stratification_2d():
    """The first 256 points of dims (0, 1) fill a 16x16 dyadic grid once
    each: the (0,2)-sequence property survives both scrambles."""
    for seed in (0, 1, 0xDEADBEEF):
        pts = tr.SobolQRNG(seed=seed, dims=4).sample(256, device="cpu").numpy()
        h, _, _ = np.histogram2d(pts[:, 0], pts[:, 1], bins=16, range=[[0, 1], [0, 1]])
        assert (h == 1).all(), seed


def test_stratification_1d_every_dim():
    pts = tr.SobolQRNG(seed=3, dims=16).sample(512, device="cpu").numpy()
    for d in range(16):
        h, _ = np.histogram(pts[:, d], bins=512, range=(0, 1))
        assert (h == 1).all(), d


def test_batch_blocks_stay_stratified():
    rng = tr.SobolQRNG(seed=9, dims=2)
    a = rng.sample(512, device="cpu").numpy()
    rng.advance(512)
    b = rng.sample(512, device="cpu").numpy()
    h, _ = np.histogram(np.concatenate([a[:, 0], b[:, 0]]), bins=1024, range=(0, 1))
    assert (h == 1).all()


def test_ks_uniform_including_tail_dims():
    table = tr._direction_table(8, "cpu")
    idx = torch.arange(4096, dtype=torch.int32)
    for d in (0, 3, 7, 8, 20):  # 8 and past: the Philox tail
        u = tr.sobol_owen_uniform(table, 11, idx, torch.full_like(idx, d)).numpy()
        assert 0.0 <= u.min() and u.max() < 1.0
        assert kstest(u, "uniform").pvalue > 1e-3, d


def test_seed_decorrelates_and_reproduces():
    a = tr.SobolQRNG(seed=1, dims=4).sample(128, device="cpu")
    b = tr.SobolQRNG(seed=1, dims=4).sample(128, device="cpu")
    c = tr.SobolQRNG(seed=2, dims=4).sample(128, device="cpu")
    assert torch.equal(a, b) and float((a - c).abs().max()) > 0.1


def test_integration_error_beats_philox():
    errs_q, errs_p = [], []
    for s in range(8):
        q = tr.SobolQRNG(seed=s, dims=4).sample(1024, device="cpu").double().numpy()
        errs_q.append(np.prod(q, axis=1).mean() - 1.0 / 16.0)
        p = tr.rng_buffer(tr.PhiloxRNG(key=s * 2654435761 + 13), 1024, 4, device="cpu").double().numpy()
        errs_p.append(np.prod(p, axis=1).mean() - 1.0 / 16.0)
    rmse_q, rmse_p = np.sqrt(np.mean(np.square(errs_q))), np.sqrt(np.mean(np.square(errs_p)))
    assert rmse_q < rmse_p / 5.0, (rmse_q, rmse_p)


def test_stream_is_lane_id_after_advance():
    """The state's stream stays the lane id across batches; the offset
    only shifts the sample index."""
    rng = tr.SobolQRNG(seed=5, dims=4)
    rng.advance(1024)
    st = rng.state_for(rng.counter_words, torch.arange(64, dtype=torch.int32))
    np.testing.assert_array_equal(st.stream.numpy(), np.arange(64))
    np.testing.assert_array_equal(st.index.numpy(), np.arange(64) + 1024)


def test_buffer_sink_sobol_blocks_disjoint():
    sink = tr.RNGBufferSink(tr.SobolQRNG(seed=3, dims=8), streams=32, samples=4, device="cpu")
    a, b = sink.run(), sink.run()
    assert not (a[:, None, :] == b[None, :, :]).all(-1).any()
    deep = tr.RNGBufferSink(tr.SobolQRNG(seed=3, dims=8), streams=16, samples=16, device="cpu")
    with pytest.raises(ValueError, match="draws per stream"):
        deep.run()


def test_interop_carries_a_sobol_state():
    """``params_from_numpy`` turns a theia_tpu SobolState (direction table,
    seed, offset, streams, dims) into the port's, which draws the same."""
    from theia_tpu_torch.interop import params_from_numpy
    from torch_flagship import numpy_tree

    j = jr.SobolQRNG(seed=0xFFFFFFF0, dims=32)
    j.advance(2**32 - 100)
    js = j.state(jnp.arange(500, dtype=jnp.uint32), dim=30)
    ts = params_from_numpy({"rng": numpy_tree(js)}, "cpu")["rng"]
    assert isinstance(ts, tr.SobolState) and (ts.seed, ts.offset) == (0xFFFFFFF0, 2**32 - 100)
    (ja, jb), _ = js.uniform2d()
    (ta, tb), _ = ts.uniform2d()
    np.testing.assert_array_equal(_bits(ta), _bits(ja))
    np.testing.assert_array_equal(_bits(tb), _bits(jb))
