"""The records' fixed order (``csrc/ordered_sum.cuh``) and its plain twins.

``response.ordered_bin_sums`` is the order every record adds in, on the
CPU and on the card: a bin's items of a warp's span of 128 lanes one after
another, then the spans of a 1024-lane tile, the tiles in 32 groups, the
groups. Here it is held bit for bit against the same order written out
with numpy float32 loops, the constants against the kernel files, and the
records' plain versions against ``theia_tpu``'s:

- ``HistogramHitResponse.record``: rtol 1e-6 a bin, as
  ``test_torch_response.py`` holds it (the same float32 values, summed in
  another order: JAX by a one-hot product or a scatter);
- ``KernelHistogramHitResponse.record``: rtol 1e-6 of the largest bin, as
  ``test_torch_kernel_histogram.py`` holds it (the weights' exp in double
  precision against XLA's float32 exp, an ulp apart, and another order).

NaN and infinite times stay the deliberate divergences the response tests
pin: the port drops such a lane, bit for bit as if it were masked.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import theia_tpu.response as jresp
import theia_tpu.trace.core as jcore
import theia_tpu_torch.response as tresp
from theia_tpu.component import TraceConfig as JConfig

torch.set_num_threads(1)

CSRC = Path(tresp.__file__).parent / "csrc"


def reference_order(lane, bins, values, n, n_state):
    """The records' order written out: for each bin, the items of a span
    one after another in float32 from +0.0, the spans of a tile, the
    tiles of a group, the groups. numpy scalars, one add at a time."""
    tiles = -(-n // 1024)
    group = max(1, -(-tiles // 32))
    out = np.zeros(n_state, np.float32)
    spans = {}
    for i, b, v in zip(lane.tolist(), bins.tolist(), values.tolist()):
        key = (b, i // 128)
        spans[key] = np.float32(spans.get(key, np.float32(0.0)) + np.float32(v))
    for b in range(n_state):
        total = np.float32(0.0)
        for g in range(32):
            g_sum = np.float32(0.0)
            for t in range(g * group, min((g + 1) * group, tiles)):
                t_sum = np.float32(0.0)
                for s in range(8 * t, 8 * t + 8):
                    t_sum = np.float32(t_sum + spans.get((b, s), np.float32(0.0)))
                g_sum = np.float32(g_sum + t_sum)
            total = np.float32(total + g_sum)
        out[b] = total
    return out


@pytest.mark.parametrize("n,n_state,seed", [(1, 3, 0), (127, 5, 1), (1025, 7, 2), (40_000, 11, 3), (70_001, 4, 4)])
def test_ordered_bin_sums_is_the_written_order(n, n_state, seed):
    """Items in lane order, several to a bin within a span, values of
    mixed sign and scale (so that the order shows in the bits): the twin
    equals the order written out, bit for bit; 40,000 and 70,001 lanes
    take groups of 2 and 3 tiles."""
    rng = np.random.default_rng(seed)
    lane = np.sort(rng.choice(n, size=min(n, 3000), replace=False))
    bins = rng.integers(0, n_state, size=lane.size)
    values = (rng.normal(size=lane.size) * 10.0 ** rng.integers(-3, 4, size=lane.size)).astype(np.float32)
    got = tresp.ordered_bin_sums(torch.as_tensor(lane), torch.as_tensor(bins), torch.as_tensor(values), n, n_state)
    want = reference_order(lane, bins, values, n, n_state)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # and it is an order: a sequential float64 sum agrees to rounding
    np.testing.assert_allclose(got.numpy(), np.bincount(bins, values.astype(np.float64), n_state), rtol=1e-4, atol=1e-3)


def test_order_constants_are_the_kernel_files():
    """The twin's constants equal ``csrc/ordered_sum.cuh``'s, a range of
    flat bins too."""
    source = (CSRC / "ordered_sum.cuh").read_text()
    const = lambda name: re.search(rf"constexpr int {name} = ([^;]+);", source).group(1)
    assert int(const("kWarps")) == tresp.TILE_LANES // tresp.SPAN_LANES == 8
    assert int(const("kRowsPerSpan")) * 32 == tresp.SPAN_LANES
    assert int(const("kGroups")) == tresp.TILE_GROUPS
    kib = int(re.search(r"constexpr int kSmemPerSm = (\d+) \* 1024;", source).group(1))
    assert const("kRowFloats") == "(kSmemPerSm - 1024) / 4" and const("kRange") == "kRowFloats / kWarps"
    assert tresp.RECORD_RANGE == (kib * 1024 - 1024) // 4 // int(const("kWarps"))
    assert '#include "ordered_sum.cuh"' in (CSRC / "histogram.cu").read_text()
    assert '#include "ordered_sum.cuh"' in (CSRC / "kernel_histogram.cu").read_text()


def test_record_table_takes_ranges_past_its_budget():
    """A record's scratch: the dense pass's tile and group sums on a state
    of one range; past it the sparse pass's lists, their lengths and the
    groups' sums, where its tables fit a block's shared memory; else the
    dense pass's, every bin while that fits ``RECORD_TABLE_MAX``, whole
    ranges of ``RECORD_RANGE`` bins beyond (at most ``RECORD_MAX_RANGES`` a
    launch); the counters' size and the kernel file's agree."""
    assert tresp._record_table(262_144, 100, "cpu").numel() == (256 + 32) * 100
    assert tresp._record_table(262_144, 2048, "cpu").numel() == (256 + 32) * 2048  # 2^19 cells: dense
    assert tresp._record_table(262_144, 2049, "cpu").numel() == 2 * 256 * 1024 + 256 * 2 + 32 * 2049
    assert tresp._record_table(1, 64_000, "cpu").numel() == (1 + 32) * 64_000
    assert tresp._record_table(10_000, 64_000, "cpu").numel() == 2 * 10 * 1024 + 10 * 10 + 10 * 64_000
    assert tresp._record_table(524_288, 64_000, "cpu", 9).numel() == 2 * 512 * 9216 + 512 * 10 + 32 * 64_000
    assert tresp._record_table(0, 100, "cpu").numel() == 0
    # 17 items a lane (support 8): the sparse pass's tables pass shared memory
    assert tresp._sparse_words(3072, 11, 1_000_000) is not None and tresp._sparse_words(3072, 13, 1_000_000) is None
    floats = tresp._record_table(3_145_728, 1_000_000, "meta", 17).numel()
    fits = [w for w in range(tresp.RECORD_RANGE, 65 * tresp.RECORD_RANGE, tresp.RECORD_RANGE)
            if tresp._scratch_floats(3072, w) <= tresp.RECORD_TABLE_MAX]
    assert floats == tresp._scratch_floats(3072, max(fits)) and max(fits) < 64 * tresp.RECORD_RANGE
    source = (CSRC / "ordered_sum.cuh").read_text()
    assert "return static_cast<int>(bins + bins / 4 + 1);" in source and "smem <= 4LL * kRowFloats" in source
    assert f"constexpr long long kDenseCells = 1 << {tresp.RECORD_DENSE_CELLS.bit_length() - 1};" in source
    assert f"constexpr int kStage = {tresp.RECORD_STAGE};" in source
    assert "z.group_smem = 4LL * (2 * kStage + kRange + 2 * group + 1);" in source
    assert "z.smem = 8LL * (kWarps * z.warp_cap + z.tile_cap) + 4LL * (z.ranges + 1);" in source
    assert "constexpr int kCounters = kGroups + 1;" in source and tresp.RECORD_COUNTERS == 32 + 1
    assert f"constexpr int kMaxRanges = {tresp.RECORD_MAX_RANGES};" in source


def jax_hist(time, value, object_id, mask, n_bins, n_det):
    jr = jresp.HistogramHitResponse(nBins=n_bins, t0=0.0, binSize=5.0, nDetectors=n_det)
    jr.prepare(JConfig(batch_size=time.size, capacity=time.size, max_hits_per_thread=1, normalization=1.0,
                       polarized=False))
    vec = jnp.zeros((time.size, 3), jnp.float32)
    item = jcore.HitItem(vec, vec, vec, jnp.ones(time.size, jnp.float32), jnp.asarray(time), jnp.asarray(value),
                         jnp.asarray(object_id))
    return np.asarray(jr.record(jr.params(), jr.init(), item, jnp.asarray(mask), None)[0])


def lanes(n, seed, n_bins, n_det, offset=0, bad=False):
    """Seeded lanes (numpy float32 time and value, int32 ids, a mask with
    ~30 % masked), ``offset`` extra lanes in front (the port gets views
    that start there); with ``bad`` every 7th lane's time NaN, every 11th
    +inf and every 13th -inf, unmasked."""
    rng = np.random.default_rng(seed)
    m = n + offset
    time = rng.uniform(-20.0, 5.0 * n_bins + 40.0, size=m).astype(np.float32)
    value = rng.uniform(0.0, 2.0, size=m).astype(np.float32)
    object_id = rng.integers(-1, (n_det or 1) + 1, size=m).astype(np.int32)
    mask = rng.uniform(size=m) < 0.7
    if bad:
        lane = np.arange(m)
        time[lane % 7 == 1], time[lane % 11 == 2], time[lane % 13 == 3] = np.nan, np.inf, -np.inf
        mask[~np.isfinite(time)] = True
    return time, value, object_id, mask


#: (n, n_bins, n_det, offset): odd sizes, a detector axis, views at an
#: offset, and a state of 60,000 flat bins (past what a block's shared
#: memory holds: nine ranges of the kernel's first pass)
CASES = {
    "n1": (1, 100, None, 0),
    "n1023": (1023, 100, None, 0),
    "n4099_detector_axis": (4099, 50, 3, 0),
    "views_at_element_3": (5003, 100, None, 3),
    "views_at_element_1_detector_axis": (3001, 60, 4, 1),
    "state_of_60000_bins": (6000, 1000, 60, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_histogram_twin_matches_jax(name):
    n, n_bins, n_det, offset = CASES[name]
    time, value, object_id, mask = lanes(n, len(name), n_bins, n_det, offset)
    want = jax_hist(time[offset:], value[offset:], object_id[offset:], mask[offset:], n_bins, n_det)
    t = lambda a: torch.as_tensor(a)[offset:]
    args = (t(value), t(time), t(mask), torch.tensor(0.0), torch.tensor(5.0), n_bins,
            t(object_id) if n_det else None, n_det)
    assert args[0].storage_offset() == offset
    got = tresp.histogram_add_plain(torch.zeros(want.size), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)
    again = tresp.histogram_add(torch.zeros(want.size), *args).numpy()
    np.testing.assert_array_equal(again.view(np.int32), got.view(np.int32))
    assert n < 1000 or want.sum() > 0
    assert tresp.histogram_add.launches == 0


@pytest.mark.parametrize("n_bins,n_det", [(100, None), (50, 3), (1000, 60)])
def test_histogram_twin_nonfinite_times_are_dropped(n_bins, n_det):
    """Unmasked NaN and infinite times: the port drops the lanes, bit for
    bit as with them masked; ``theia_tpu`` drops the infinite ones too and
    puts the NaN ones in bin 0 (``test_nan_time_is_a_deliberate_divergence``),
    so on the finite lanes the two agree at rtol 1e-6."""
    time, value, object_id, mask = lanes(4099, n_bins, n_bins, n_det, bad=True)
    t = torch.as_tensor
    rest = (torch.tensor(0.0), torch.tensor(5.0), n_bins, t(object_id) if n_det else None, n_det)
    size = n_bins * (n_det or 1)
    port = tresp.histogram_add_plain(torch.zeros(size), t(value), t(time), t(mask), *rest).numpy()
    finite = mask & np.isfinite(time)
    dropped = tresp.histogram_add_plain(torch.zeros(size), t(value), t(time), t(finite), *rest).numpy()
    np.testing.assert_array_equal(port.view(np.int32), dropped.view(np.int32))
    np.testing.assert_allclose(port, jax_hist(time, value, object_id, finite, n_bins, n_det), rtol=1e-6, atol=0.0)


def test_histogram_state_adds_where_the_sum_is_not_zero():
    """The record adds its sums onto what the state held (a second record
    goes on from the first); an all-masked record leaves every bit of the
    state as it was, a -0.0 bin included."""
    time, value, object_id, mask = lanes(3000, 5, 100, None)
    t = torch.as_tensor
    args = (t(value), t(time), t(mask), torch.tensor(0.0), torch.tensor(5.0), 100)
    first = tresp.histogram_add_plain(torch.zeros(100), *args)
    twice = tresp.histogram_add_plain(first.clone(), *args)
    np.testing.assert_array_equal(twice.numpy(), (first + first).numpy())
    state = torch.full((100,), -0.0)
    tresp.histogram_add_plain(state, t(value), t(time), torch.zeros(3000, dtype=torch.bool), *args[3:])
    assert torch.equal(state.view(torch.int32), torch.full((100,), -0.0).view(torch.int32))


def jax_kde(time, value, object_id, mask, n_det):
    jr = jresp.KernelHistogramHitResponse(nBins=40, t0=-3.0, binSize=5.0, bandwidth=4.0, nDetectors=n_det)
    jr.prepare(JConfig(batch_size=time.size, capacity=time.size, max_hits_per_thread=1, normalization=1.0,
                       polarized=False))
    vec = jnp.zeros((time.size, 3), jnp.float32)
    item = jcore.HitItem(vec, vec, vec, jnp.ones(time.size, jnp.float32), jnp.asarray(time), jnp.asarray(value),
                         jnp.asarray(object_id))
    return np.asarray(jr.record(jr.params(), jr.init(), item, jnp.asarray(mask), None)[0])


def kde_args(time, value, object_id, mask, n_det, offset=0):
    t = lambda a: torch.as_tensor(a)[offset:]
    return (t(value), t(time), t(mask), torch.tensor(-3.0), torch.tensor(5.0), torch.tensor(4.0), 40, 4,
            t(object_id) if n_det else None, n_det)


#: (n, n_det, offset) of the kernel histogram's twin against JAX, and a
#: state of 60,000 flat bins (1500 detectors of 40 bins)
KDE_CASES = {"n1": (1, None, 0), "n1023": (1023, None, 0), "n4099_detector_axis": (4099, 3, 0),
             "views_at_element_5": (2001, None, 5), "state_of_60000_bins": (3000, 1500, 0)}


@pytest.mark.parametrize("name", sorted(KDE_CASES))
def test_kernel_histogram_twin_matches_jax(name):
    n, n_det, offset = KDE_CASES[name]
    time, value, object_id, mask = lanes(n, len(name) + 50, 40, n_det, offset)
    want = jax_kde(*(a[offset:] for a in (time, value, object_id, mask)), n_det)
    args = kde_args(time, value, object_id, mask, n_det, offset)
    got = tresp.kernel_histogram_add_plain(torch.zeros(want.size), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * max(np.abs(want).max(), 1e-30))
    again = tresp.kernel_histogram_add(torch.zeros(want.size), *args).numpy()
    np.testing.assert_array_equal(again.view(np.int32), got.view(np.int32))
    assert tresp.kernel_histogram_add.launches == 0


def test_kernel_histogram_twin_order_and_nonfinite_times():
    """The twin's pairs in the records' order (in a span's row the offsets
    from -support up, then the lanes), held against ``ordered_bin_sums``
    of the pairs listed by hand; unmasked NaN and infinite times drop as
    if masked, bit for bit."""
    time, value, object_id, mask = lanes(3000, 9, 40, None, bad=True)
    args = kde_args(time, value, object_id, mask, None)
    port = tresp.kernel_histogram_add_plain(torch.zeros(40), *args)
    finite = mask & np.isfinite(time)
    dropped = tresp.kernel_histogram_add_plain(torch.zeros(40), *kde_args(time, value, object_id, finite, None))
    assert torch.equal(port.view(torch.int32), dropped.view(torch.int32))
    items = []
    terms = tresp._kde_terms(*args[1:3], *args[3:6], 40, 4, None, None)
    norm = args[4] / (args[5] * tresp._SQRT_2PI)
    for s, (keep, flat, _, _, e) in enumerate(terms):
        add = args[0] * (e * norm)
        items += [(i // 32, s, i % 32, i, int(flat[i]), add[i]) for i in np.flatnonzero(keep.numpy())]
    items.sort(key=lambda x: x[:3])
    lane, bins = (torch.as_tensor([x[k] for x in items]) for k in (3, 4))
    adds = torch.stack([x[5] for x in items])
    want = tresp.ordered_bin_sums(lane, bins, adds, 3000, 40)
    assert torch.equal(port.view(torch.int32), want.view(torch.int32))


def test_kde_exp_is_correctly_rounded_nearly_everywhere():
    """The record's exp, explicit float32 products and sums (the kernel's
    ``kde_exp``, op for op): within 1 ulp of the correctly rounded float32
    of exp (math.exp of the float32 input) on every one of 2^16 inputs over
    the record's range, equal to it on more than 92 % of them (the cost of
    float32 ops against the double ones this test first held, correctly
    rounded on all but a few); 0 below -104, NaN for NaN, and a slope of
    exp."""
    x = torch.as_tensor(-np.linspace(0.0, 120.0, 1 << 16).astype(np.float32))
    x[1], x[2] = -0.0, -104.0
    got = tresp._kde_exp(x).numpy()
    want = np.array([np.float32(math.exp(v)) if v >= -110.0 else 0.0 for v in x.numpy().astype(np.float64)],
                    np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1 and (ulps == 0).mean() > 0.92, (ulps.max(), (ulps != 0).sum())
    assert got[0] == 1.0 and got[1] == 1.0 and got[-1] == 0.0
    assert math.isnan(float(tresp._kde_exp(torch.tensor([float("nan")]))[0]))
    assert float(tresp._kde_exp(torch.tensor([float("-inf")]))[0]) == 0.0
    leaf = torch.tensor([-0.5, -2.0, -7.25], requires_grad=True)
    tresp._kde_exp(leaf).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), np.exp([-0.5, -2.0, -7.25]), rtol=1e-6)
