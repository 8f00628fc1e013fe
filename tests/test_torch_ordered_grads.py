"""The backward kernels' fixed order and their plain twins.

No backward kernel of the port adds a float with an atomic. Each sum that
many lanes add into is a fixed function of the lanes' indices, their count
and the table's size, in the order of the records (``ops/ordered.py``,
``csrc/ordered_sum.cuh``):

- the table reads' backward (``read_table_grad``, ``read_packed_grad``):
  a lane's two shares of each table, slots 2 k and 2 k + 1, the tables
  that take a gradient laid end to end; a warp's span of 128 lanes (rows
  of 32, in a row the slots, in a slot the lanes), the spans of a 1024-lane
  tile, the tiles in 32 groups, the groups;
- the kernel histogram's backward: its three scalars as three bins, the
  same order (d t0 the lanes' ``- d time``);
- the row gathers' backward: items (lane, row x width + column), the same
  order with a whole tile of 1024 lanes as its first level (a tile's lanes
  in lane order).

Here each twin is held bit for bit against its order written out with
numpy float32 loops, at sizes that cross a span, a tile and a group; the
constants against the kernel files; and each twin against ``theia_tpu``'s
function (``jax.vjp``) at the tolerances the existing tests state:
``lookup.lookup`` and ``material.lookup_packed``, d x rtol 1e-6 and d
table rtol 1e-5 of the largest entry (``test_torch_table_read.py``); the
gathers' d table rtol 1e-6 of the largest entry
(``test_torch_gather_pieces.py``'s rtol); the kernel histogram's d value
and d time rtol 1e-5 and its scalars rtol 1e-4
(``test_torch_kernel_histogram.py``). The card cases (marked ``cuda``,
skipped here) hold each kernel against its twin bit for bit and two
launches against each other.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theia_tpu.lookup as jlookup
import theia_tpu.material as jmat
import theia_tpu.response as jresp
import theia_tpu.trace.core as jcore
import theia_tpu_torch.response as tresp
from theia_tpu.component import TraceConfig as JConfig
from theia_tpu_torch.component import TraceConfig as TConfig
from theia_tpu_torch.ops import ordered, table_read

torch.set_num_threads(1)

CSRC = Path(table_read.__file__).resolve().parent.parent / "csrc"
#: lanes that cross a span (128), a tile (1024) and, past 32 tiles, groups
#: of two and three tiles
SIZES = (1, 129, 1025, 40_000, 70_001)


def f32(x) -> np.float32:
    return np.float32(x)


def written_order(items, n, n_state, span=128):
    """The order written out: ``items`` are (lane, slot, bin, value) in any
    order; they are taken as the kernels' sources hand them (rows of 32
    lanes in order, in a row the slots, in a slot the lanes), each bin's
    items of a span of ``span`` lanes added one after another in float32
    from +0.0, then the spans of a tile, the tiles of a group of
    ceil(tiles / 32), the groups. numpy scalars, one add at a time."""
    tiles = -(-n // 1024)
    group = max(1, -(-tiles // 32))
    spans = {}
    for lane, _, b, v in sorted(items, key=lambda it: (it[0] // 32, it[1], it[0] % 32)):
        key = (b, lane // span)
        spans[key] = f32(spans.get(key, f32(0.0)) + f32(v))
    per = 1024 // span
    out = np.zeros(n_state, np.float32)
    for b in sorted({k[0] for k in spans}):
        total = f32(0.0)
        for g in range(-(-tiles // group)):
            g_sum = f32(0.0)
            for t in range(g * group, min((g + 1) * group, tiles)):
                t_sum = f32(0.0)
                for s in range(per * t, per * t + per):
                    if (b, s) in spans:
                        t_sum = f32(t_sum + spans[(b, s)])
                g_sum = f32(g_sum + t_sum)
            total = f32(total + g_sum)
        out[b] = total
    return out


def same_bits(got, want):
    np.testing.assert_array_equal(np.asarray(got, np.float32).view(np.int32), np.asarray(want, np.float32).view(np.int32))


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the order itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_slot_sums_is_the_written_order(n):
    """Three slots of items a lane into 13 bins, values of mixed sign and
    scale, some 0 (left out) and one NaN bin: ``slot_sums`` equals the
    order written out, bit for bit."""
    rng = np.random.default_rng(n)
    slots, items = [], []
    for s in range(3):
        bins = rng.integers(0, 13, n)
        values = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32)
        values[rng.uniform(size=n) < 0.2] = 0.0
        kept = rng.uniform(size=n) < 0.8
        if s == 2 and n > 7:
            values[7], bins[7], kept[7] = np.nan, 12, True
        slots.append((torch.as_tensor(bins), torch.as_tensor(values), torch.as_tensor(kept)))
        items += [(i, s, int(bins[i]), values[i]) for i in np.flatnonzero(kept & (values != 0))]
    got = ordered.slot_sums(slots, n, 13).numpy()
    same_bits(got, written_order(items, n, 13))
    assert np.isnan(got[12]) == (n > 7)


@pytest.mark.parametrize("n", SIZES)
def test_tile_first_level_is_the_written_order(n):
    """``ordered_bin_sums`` with a tile as its first level (the gathers'
    order): a tile's items one after another, then the tiles' groups."""
    rng = np.random.default_rng(n + 1)
    lane = np.sort(rng.choice(n, size=min(n, 4000), replace=False))
    bins = rng.integers(0, 5, lane.size)
    values = (rng.normal(size=lane.size) * 10.0 ** rng.integers(-3, 4, lane.size)).astype(np.float32)
    got = ordered.ordered_bin_sums(torch.as_tensor(lane), torch.as_tensor(bins), torch.as_tensor(values), n, 5,
                                   ordered.TILE_LANES)
    items = [(int(i), 0, int(b), v) for i, b, v in zip(lane, bins, values)]
    same_bits(got.numpy(), written_order(items, n, 5, span=1024))


# ---------------------------------------------------------------------------
# the twins against their orders written out
# ---------------------------------------------------------------------------


def _single_items(tables, x, grads, need, n):
    """The read_table backward's items, computed with numpy float32 ops as
    the kernel computes them: a lane's two shares of each table that takes
    a gradient, its entries offset by the tables before it."""
    t = np.clip(x, f32(0.0), f32(1.0))
    items, at = [], 0
    for k, (table, g) in enumerate(zip(tables, grads)):
        if table is None or not need[k]:
            continue
        m = table.size
        xx = t * f32(m - 1)
        fl = np.floor(xx)
        l = xx - fl
        lo = np.clip(fl.astype(np.int64), 0, m - 1)
        hi = np.clip(np.ceil(xx).astype(np.int64), 0, m - 1)
        for j, (entry, share) in enumerate(((lo, g * (f32(1.0) - l)), (hi, g * l))):
            items += [(i, 2 * k + j, at + int(entry[i]), share[i]) for i in np.flatnonzero(share != 0)]
        at += m
    return items, at


@pytest.mark.parametrize("n", SIZES)
def test_read_table_grad_twin_is_the_written_order(n):
    """Three single tables read at one coordinate (1024 and 64 samples and
    a null one; the 64-sample one takes no gradient), most upstream
    gradients 0 as on the gradient steps: each table's gradient equals the
    order written out, bit for bit."""
    rng = np.random.default_rng(n + 2)
    tables = [rng.normal(size=1024).astype(np.float32), rng.normal(size=64).astype(np.float32), None]
    x = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    x[: min(n, 3)] = [0.0, 1.0, 0.5][: min(n, 3)]
    grads = [np.where(rng.uniform(size=n) < 0.3, rng.normal(size=n), 0.0).astype(np.float32) for _ in tables]
    need = [True, False, True]
    got, _ = table_read.read_table_grad_plain(
        tuple(None if t is None else torch.as_tensor(t) for t in tables), torch.as_tensor(x),
        tuple(torch.as_tensor(g) for g in grads), need_tables=need, need_x=False,
    )
    items, total = _single_items(tables, x, grads, need, n)
    want = written_order(items, n, total)
    same_bits(got[0].numpy(), want)
    assert got[1] is None and got[2] is None


def _packed_items(values, sizes, handle, t, grads, shared):
    """read_packed's backward items in numpy float32: a lane's cell (the
    const4 rule's shared size and width with ``shared``), its two shares
    of each table."""
    items, at = [], 0
    t = np.clip(t, f32(0.0), f32(1.0))
    lens = [v.shape[1] for v in values]
    nk = [s[handle] for s in sizes]
    n_all = np.max(nk, axis=0) if shared else None
    for k, (v, g) in enumerate(zip(values, grads)):
        n, pad = (n_all, max(lens)) if shared else (nk[k], lens[k])
        scale = np.maximum(n - 1, 1).astype(np.float32)
        tt = t * scale
        fl = np.floor(tt)
        l = tt - fl
        j = np.clip(fl.astype(np.int64), 0, pad - 1)
        gg = np.where(n == 0, f32(0.0), g).astype(np.float32)
        last = j == pad - 1
        real = (n != 0) & (nk[k] != 0)
        base = at + handle.astype(np.int64) * lens[k]
        lo_share = np.where(last, gg, gg - gg * l).astype(np.float32)
        hi_share = (gg * l).astype(np.float32)
        for i in np.flatnonzero(real & (j < lens[k]) & (lo_share != 0)):
            items.append((i, 2 * k, int(base[i] + j[i]), lo_share[i]))
        for i in np.flatnonzero(real & ~last & (j + 1 < lens[k]) & (hi_share != 0)):
            items.append((i, 2 * k + 1, int(base[i] + j[i] + 1), hi_share[i]))
        at += v.size
    return items, at


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_read_packed_grad_twin_is_the_written_order(n, shared):
    """Four packed tables of one store (five media, rows of 64 and 16
    columns, null and short rows), each lane at its medium's row: with and
    without the const4 rule, every table's gradient equals the order
    written out, bit for bit."""
    rng = np.random.default_rng(n + (3 if shared else 4))
    lens, widths = ((0, 64, 17, 1, 2), (0, 16, 16, 3, 2), (5, 0, 9, 1, 2), (0, 2, 64, 64, 1)), (64, 16, 64, 64)
    values, sizes = [], []
    for rows, width in zip(lens, widths):
        v = np.zeros((5, width), np.float32)
        for m, size in enumerate(rows):
            v[m, :size] = rng.normal(size=size)
        values.append(v)
        sizes.append(np.asarray(rows, np.int32))
    handle = rng.integers(0, 5, n).astype(np.int32)
    t = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    grads = [np.where(rng.uniform(size=n) < 0.4, rng.normal(size=n), 0.0).astype(np.float32) for _ in values]
    got, _ = table_read.read_packed_grad_plain(
        tuple(map(torch.as_tensor, values)), tuple(map(torch.as_tensor, sizes)), torch.as_tensor(handle),
        torch.as_tensor(t), tuple(map(torch.as_tensor, grads)), shared=shared, need_x=False,
    )
    items, total = _packed_items(values, sizes, handle, t, grads, shared)
    want = written_order(items, n, total)
    same_bits(torch.cat([g.reshape(-1) for g in got]).numpy(), want)


@pytest.mark.parametrize("n", (1, 1025, 5000, 40_000))
def test_gather_grad_twin_is_the_written_order(n):
    """The reconstruction's spans of a (40, 32) table at random rows, half
    the lanes' gradients 0 (missed lanes): the table's gradient equals the
    order written out with a tile as its first level, bit for bit, and
    the whole rows' gradient likewise."""
    from theia_tpu_torch.accel import TRI_COLUMNS

    rng = np.random.default_rng(n + 5)
    index = rng.integers(0, 40, n).astype(np.int32)
    live = rng.uniform(size=n) < 0.5
    spans = [(s[0], s[1]) for s in TRI_COLUMNS if len(s) == 2]
    grads = [np.where(live[:, None], rng.normal(size=(n, b - a)), 0.0).astype(np.float32) for a, b in spans]
    got = table_read.gather_rows_grad_plain((40, 32), torch.as_tensor(index),
                                            [None if g is None else torch.as_tensor(g)
                                             for g in iter_spans(grads, TRI_COLUMNS)], TRI_COLUMNS)
    items = []
    for (a, b), g in zip(spans, grads):
        for i in np.flatnonzero(live):
            items += [(int(i), 0, int(index[i]) * 32 + a + c, g[i, c]) for c in range(b - a) if g[i, c] != 0]
    same_bits(got.numpy().reshape(-1), written_order(items, n, 40 * 32, span=1024))
    whole = np.where(live[:, None], rng.normal(size=(n, 32)), 0.0).astype(np.float32)
    got = table_read.gather_rows_grad_plain((40, 32), torch.as_tensor(index), torch.as_tensor(whole))
    items = [(int(i), 0, int(index[i]) * 32 + c, whole[i, c]) for i in np.flatnonzero(live) for c in range(32)]
    same_bits(got.numpy().reshape(-1), written_order(items, n, 40 * 32, span=1024))


def iter_spans(grads, columns):
    """The float spans' gradients in ``columns``' order, None at the
    integer spans."""
    grads = iter(grads)
    return [next(grads) if len(s) == 2 else None for s in columns]


@pytest.mark.parametrize("n", SIZES)
def test_kde_grad_scalars_are_the_written_order(n):
    """The kernel histogram's backward: d t0 is the kept lanes' ``- d
    time`` and d binSize and d bandwidth their terms, each summed in the
    order written out, bit for bit; the lanes' two gradients are the
    twin's own ops (held against JAX below)."""
    rng = np.random.default_rng(n + 6)
    time = rng.uniform(-40.0, 240.0, n).astype(np.float32)
    value = rng.uniform(0.0, 2.0, n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.7
    grad_state = rng.normal(size=40).astype(np.float32)
    p = [torch.tensor(v, dtype=torch.float32) for v in (-3.0, 5.0, 4.0)]
    args = (torch.as_tensor(value), torch.as_tensor(time), torch.as_tensor(mask), *p, 40, 4)
    d_value, d_time, d_t0, d_bs, d_h = tresp.kernel_histogram_grad_plain(torch.as_tensor(grad_state), *args)
    # the lanes' terms of d binSize and d bandwidth in the twin's ops
    t0, bs, h = p
    inv = 1.0 / (h * tresp._SQRT_2PI)
    norm = bs * inv
    tb = torch.zeros(n)
    th = torch.zeros(n)
    kept = torch.zeros(n, dtype=torch.bool)
    for keep, flat, bin_f, z, e in tresp._kde_terms(args[1], args[2], t0, bs, h, 40, 4, None, None, torch.exp):
        w = e * norm
        gv = torch.as_tensor(grad_state)[flat] * args[0]
        tb = tb + torch.where(keep, gv * (e * inv - w * z * (bin_f + 0.5) / h), 0.0)
        th = th + torch.where(keep, gv * w * (z * z - 1.0) / h, 0.0)
        kept = kept | keep
    lanes = np.flatnonzero(kept.numpy())
    terms = (-d_time.numpy(), tb.numpy(), th.numpy())
    items = [(int(i), b, b, terms[b][i]) for i in lanes for b in range(3) if terms[b][i] != 0]
    same_bits(np.array([float(d_t0), float(d_bs), float(d_h)]), written_order(items, n, 3))


# ---------------------------------------------------------------------------
# the constants and the kernel files
# ---------------------------------------------------------------------------


def test_constants_are_the_kernel_files():
    """The gathers' scratch and ranges, the reads' slots, and no float
    atomic left in the backward kernels' files."""
    source = (CSRC / "table_read.cu").read_text()
    kde = (CSRC / "kernel_histogram.cu").read_text()
    const = lambda name: re.search(rf"constexpr int {name} = ([^;]+);", source).group(1)
    assert int(const("kMergeRows")) == table_read.GATHER_MERGE_ROWS
    assert int(const("kMostRanges")) == table_read.GATHER_MOST_RANGES
    assert int(const("kPassColumns")) == table_read.GATHER_PASS_COLUMNS
    assert const("kMostRows") == "1 << (32 - kLaneBits)" and int(const("kLaneBits")) == 10
    assert table_read.GATHER_MOST_ROWS == 1 << 22
    assert const("kSortLanes") == "ordered::kTileLanes" and ordered.TILE_LANES == 1024
    assert "z.cap = rows < kSortLanes ? rows : kSortLanes;" in source
    assert ("z.words = static_cast<long long>(z.tiles) * z.cap * (1 + kPassColumns) +\n"
            "            static_cast<long long>(z.tiles) * (z.ranges + 1);") in source
    assert "ordered::record(src, count, 2 * spec->tables, static_cast<int>(total)" in source
    assert "ordered::record(src, n, 3, 3, table, table_floats, counters, grad_params, stream)" in kde
    assert '#include "ordered_sum.cuh"' in source and '#include "ordered_sum.cuh"' in kde
    for text in (source, kde):
        assert "atomicAdd" not in text and "red.global" not in text
    assert table_read._gather_scratch_words(3840, 262_144) == 256 * 1024 * 33 + 256 * (480 + 1)
    assert table_read._gather_scratch_words(3, 1000) == 3 * 33 + 1 + 1
    assert table_read._gather_scratch_words(100_000, 2048) == 2 * 1024 * 33 + 2 * (12_500 + 1)
    assert table_read._gather_scratch_words(400_000, 2048) == 2 * 1024 * 33 + 2 * (-(-400_000 // 13) + 1)


# ---------------------------------------------------------------------------
# the twins against theia_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,n_table", [(3000, 1024), (40_000, 64)])
def test_read_table_twin_matches_jax(n, n_table):
    rng = np.random.default_rng(n)
    table = rng.normal(size=n_table).astype(np.float32)
    u = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    ct = rng.normal(size=n).astype(np.float32)
    _, vjp = jax.vjp(lambda tab, uu: jlookup.lookup(tab, uu), jnp.asarray(table), jnp.asarray(u))
    want_table, want_u = (np.asarray(a) for a in vjp(jnp.asarray(ct)))
    got_table, got_u = table_read.read_table_grad_plain(torch.as_tensor(table), torch.as_tensor(u), torch.as_tensor(ct))
    _close(got_u.numpy(), want_u, 1e-6)
    _close(got_table.numpy(), want_table, 1e-5)


@pytest.mark.parametrize("n", [3000, 40_000])
def test_read_packed_twin_matches_jax(n):
    rng = np.random.default_rng(n + 1)
    lengths = (0, 64, 17, 1, 2)
    values = np.zeros((5, 64), np.float32)
    for m, size in enumerate(lengths):
        values[m, :size] = rng.normal(size=size)
    sizes = np.asarray(lengths, np.int32)
    handle = rng.integers(0, 5, n).astype(np.int32)
    t = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    ct = rng.normal(size=n).astype(np.float32)
    jfn = lambda v, tt: jmat.lookup_packed(v, jnp.asarray(sizes), jnp.asarray(handle), tt, 0.25)
    _, vjp = jax.vjp(jfn, jnp.asarray(values), jnp.asarray(t))
    want_values, want_t = (np.asarray(a) for a in vjp(jnp.asarray(ct)))
    got_values, got_t = table_read.read_packed_grad_plain(
        torch.as_tensor(values), torch.as_tensor(sizes), torch.as_tensor(handle), torch.as_tensor(t),
        torch.as_tensor(ct), 0.25,
    )
    _close(got_t.numpy(), want_t, 1e-6)
    _close(got_values.numpy(), want_values, 1e-5)


@pytest.mark.parametrize("table_rows,n", [(3840, 5000), (3, 5000), (40, 40_000)])
def test_gather_grad_twin_matches_jax(table_rows, n):
    """``jax.vjp`` of ``jnp.take`` and the reconstruction's slices, as
    ``theia_tpu.accel`` takes them, against the twin's table gradient."""
    from theia_tpu_torch.accel import TRI_COLUMNS

    rng = np.random.default_rng(table_rows + n)
    table = rng.normal(size=(table_rows, 32)).astype(np.float32)
    index = rng.integers(0, table_rows, n).astype(np.int32)
    floats = [s for s in TRI_COLUMNS if len(s) == 2]
    cts = [rng.normal(size=(n, b - a)).astype(np.float32) for a, b in floats]

    def pieces(tab):
        rows = jnp.take(tab, jnp.asarray(index), axis=0)
        return [rows[:, a:b] for a, b in floats]

    _, vjp = jax.vjp(pieces, jnp.asarray(table))
    (want,) = vjp([jnp.asarray(c) for c in cts])
    got = table_read.gather_rows_grad_plain(table.shape, torch.as_tensor(index),
                                            [None if g is None else torch.as_tensor(g)
                                             for g in iter_spans(cts, TRI_COLUMNS)], TRI_COLUMNS)
    _close(got.numpy(), np.asarray(want), 1e-6)


def test_kde_grad_twin_matches_jax():
    """``KernelHistogramHitResponse.record``'s VJP at 40,000 lanes (groups
    of two tiles), as ``test_torch_kernel_histogram.py`` holds it."""
    n, n_bins = 40_000, 40
    rng = np.random.default_rng(7)
    time = rng.uniform(-40.0, 240.0, n).astype(np.float32)
    value = rng.uniform(0.0, 2.0, n).astype(np.float32)
    object_id = np.zeros(n, np.int32)
    mask = rng.uniform(size=n) < 0.7
    grad_state = rng.normal(size=n_bins).astype(np.float32)
    args = dict(nBins=n_bins, t0=-3.0, binSize=5.0, bandwidth=4.0)
    cfg = dict(batch_size=n, capacity=n, max_hits_per_thread=1, normalization=1.0 / n, polarized=False)
    jr, tr = jresp.KernelHistogramHitResponse(**args), tresp.KernelHistogramHitResponse(**args)
    jr.prepare(JConfig(**cfg))
    tr.prepare(TConfig(**cfg))
    vec = jnp.zeros((n, 3), jnp.float32)

    def record(contrib, t, params):
        item = jcore.HitItem(vec, vec, vec, jnp.full(n, 400.0, jnp.float32), t, contrib, jnp.asarray(object_id))
        return jr.record(params, jr.init(), item, jnp.asarray(mask), None)[0]

    _, vjp = jax.vjp(record, jnp.asarray(value), jnp.asarray(time), jr.params())
    d_value, d_time, d_params = vjp(jnp.asarray(grad_state))
    params = tr.params("cpu")
    got = tresp.kernel_histogram_grad_plain(
        torch.as_tensor(grad_state), torch.as_tensor(value), torch.as_tensor(time), torch.as_tensor(mask),
        params["t0"], params["binSize"], params["bandwidth"], n_bins,
    )
    _close(got[0].numpy(), np.asarray(d_value), 1e-5)
    _close(got[1].numpy(), np.asarray(d_time), 1e-5)
    for g, name in zip(got[2:], ("t0", "binSize", "bandwidth")):
        _close(g.numpy(), np.asarray(d_params[name]), 1e-4)


# ---------------------------------------------------------------------------
# on a card: each kernel against its twin and against itself
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1025, 40_000, 262_144])
def test_read_grad_kernels_are_their_twins(cuda, n):
    """read_table_grad (one 1024-sample table, the dense pass; four tables,
    the sparse pass) and read_packed_grad (the const4 rule on four tables
    of five media): two launches the same bits, equal to the twin on the
    same card tensors, d x too; 1 % of the lanes' gradients live."""
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.uniform(-0.1, 1.1, n).astype(np.float32), device=cuda)
    live = torch.as_tensor(rng.uniform(size=n) < 0.01, device=cuda)
    for k in (1, 4):
        tables = tuple(torch.as_tensor(rng.normal(size=1024).astype(np.float32), device=cuda) for _ in range(k))
        g = tuple(torch.where(live, torch.randn(n, device=cuda), 0.0) for _ in range(k))
        runs = [table_read.read_table_grad(tables, x, g) for _ in range(2)]
        want = table_read.read_table_grad_plain(tables, x, g)
        for got in runs:
            assert all(_bits(a, b) for a, b in zip(got[0], want[0])) and _bits(got[1], want[1])
    values = tuple(torch.as_tensor(rng.normal(size=(5, 64)).astype(np.float32), device=cuda) for _ in range(4))
    sizes = tuple(torch.as_tensor(rng.integers(0, 65, 5).astype(np.int32), device=cuda) for _ in range(4))
    handle = torch.as_tensor(rng.integers(0, 5, n).astype(np.int32), device=cuda)
    g = tuple(torch.where(live, torch.randn(n, device=cuda), 0.0) for _ in range(4))
    runs = [table_read.read_packed_grad(values, sizes, handle, x, g, shared=True) for _ in range(2)]
    want = table_read.read_packed_grad_plain(values, sizes, handle, x, g, shared=True)
    for got in runs:
        assert all(_bits(a, b) for a, b in zip(got[0], want[0])) and _bits(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(3840, 262_144), (3, 262_144), (3840, 1037), (40, 1)])
def test_gather_grad_kernel_is_its_twin(cuda, rows, n):
    """The reconstruction's spans, half the lanes missed: two launches the
    same bits, equal to the twin; a 12-wide table at an unaligned address;
    rows of 40 columns (two passes)."""
    from theia_tpu_torch.accel import TRI_COLUMNS

    rng = np.random.default_rng(rows + n)
    index = torch.as_tensor(rng.integers(0, rows, n).astype(np.int32), device=cuda)
    hit = torch.as_tensor(rng.uniform(size=n) < 0.5, device=cuda)[:, None]
    grads = [None if len(s) == 3 else torch.where(hit, torch.randn(n, s[1] - s[0], device=cuda), 0.0)
             for s in TRI_COLUMNS]
    runs = [table_read.gather_rows_grad((rows, 32), index, grads, TRI_COLUMNS) for _ in range(2)]
    want = table_read.gather_rows_grad_plain((rows, 32), index, grads, TRI_COLUMNS)
    assert all(_bits(got, want) for got in runs)
    buf = torch.randn(n * 12 + 1, device=cuda)
    whole = buf[1:].view(n, 12)
    narrow = torch.as_tensor(rng.integers(0, 50, n).astype(np.int32), device=cuda)
    got = table_read.gather_rows_grad((50, 12), narrow, whole)
    assert _bits(got, table_read.gather_rows_grad_plain((50, 12), narrow, whole))
    # rows of 40 columns: two passes of 32 columns
    wide = torch.where(hit, torch.randn(n, 40, device=cuda), 0.0)
    got = table_read.gather_rows_grad((50, 40), narrow, wide)
    assert _bits(got, table_read.gather_rows_grad_plain((50, 40), narrow, wide))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1025, 262_144, 524_288])
def test_kde_grad_kernel_is_its_twin(cuda, n):
    """The kernel histogram's backward with and without the scalars: two
    launches the same bits, equal to the twin, the lanes' two gradients
    too."""
    rng = np.random.default_rng(n)
    value = torch.as_tensor(rng.uniform(0.0, 2.0, n).astype(np.float32), device=cuda)
    time = torch.as_tensor(rng.uniform(-40.0, 540.0, n).astype(np.float32), device=cuda)
    mask = torch.as_tensor(rng.uniform(size=n) < 0.5, device=cuda)
    p = [torch.tensor(v, device=cuda) for v in (0.0, 5.0, 5.0)]
    grad_state = torch.randn(100, device=cuda)
    args = (grad_state, value, time, mask, *p, 100, 4)
    want = tresp.kernel_histogram_grad_plain(*args)
    for need_params in (True, False, True):
        got = tresp.kernel_histogram_grad(*args, need_params=need_params)
        assert _bits(got[0], want[0]) and _bits(got[1], want[1])
        if need_params:
            assert all(_bits(a, b) for a, b in zip(got[2:], want[2:]))
