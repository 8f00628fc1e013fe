"""The pure-Python counts behind ``chip_smoke.py``'s bounds and call
statistics, on small CPU tensors against counts made by hand (numpy loops):
``sobol_bound`` (integer operations and bytes of one Sobol call),
``kde_pairs``, ``kde_add_bound`` and ``kde_call_stats`` (what a kernel
histogram record's work turns on). Exact: these are integer counts."""

import numpy as np
import pytest
import torch

import chip_smoke as cs

torch.set_num_threads(1)


@pytest.mark.parametrize("width", [1, 2])
def test_sobol_bound_counts_table_and_tail_draws(width):
    table_dims = 4
    dim = torch.tensor([0, 1, 3, 5, 3], dtype=torch.int32)
    draws = [d + j for d in dim.tolist() for j in range(width)]
    in_table = [d for d in draws if d < table_dims]
    tail = len(draws) - len(in_table)
    n = dim.shape[0]
    bytes_ = (8 + 4 * width) * n + (128 + 4) * len(set(in_table))
    ops = lambda table_ops: (n * (cs.SOBOL_LANE_OPS + width - 1) + len(in_table) * table_ops
                             + tail * cs.SOBOL_TAIL_OPS + len(set(in_table)) * cs.SOBOL_DIM_OPS)
    want = cs.bound(bytes_, ops(cs.SOBOL_TABLE_OPS), cs.PEAK_I32)
    assert cs.sobol_bound(table_dims, dim, width) == want
    # the byte fold's count, with the bit fold's beside it
    assert cs.SOBOL_TABLE_OPS < cs.SOBOL_ROW_TABLE_OPS
    yardstick = cs.bound(bytes_, ops(cs.SOBOL_ROW_TABLE_OPS), cs.PEAK_I32)["bound_ms"]
    assert cs.sobol_bounds(table_dims, dim, width) == dict(want, yardstick_ms=yardstick)


def test_byte_tables_fold_as_the_rows():
    """``random._byte_table``, what csrc/sobol.cu reads: four lookups by
    the index's bytes give the XOR of the rows over the index's set bits,
    as the plain version folds them, on random indices and the edge ones."""
    from theia_tpu_torch.random import _byte_table, _direction_table, _sobol_words

    dirs = _direction_table(64, "cpu")
    table = _byte_table(dirs).to(torch.int64) & 0xFFFFFFFF
    assert table.shape == (64, 4, 256) and _byte_table(dirs) is _byte_table(dirs)
    rng = np.random.default_rng(5)
    idx = torch.as_tensor(np.concatenate([rng.integers(0, 2**32, 4000), [0, 1, 2**31, 2**32 - 1]]))
    dim = torch.as_tensor(rng.integers(0, 64, idx.shape[0]))
    got = table[dim, 0, idx & 255]
    for k in range(1, 4):
        got = got ^ table[dim, k, (idx >> (8 * k)) & 255]
    assert torch.equal(got, _sobol_words(dirs, idx, dim))


def _record(n: int, seed: int, bins: int, n_det, kept: float):
    """A record as the tracers hand it over: most lanes masked, times from
    before t0 to past the last bin, ids from -1 to n_det."""
    rng = np.random.default_rng(seed)
    value = torch.as_tensor(rng.uniform(0.0, 2.0, n).astype(np.float32))
    time = torch.as_tensor(rng.uniform(-40.0, 5.0 * bins + 40.0, n).astype(np.float32))
    mask = torch.as_tensor(rng.uniform(size=n) < kept)
    oid = None if n_det is None else torch.as_tensor(rng.integers(-1, n_det + 1, n).astype(np.int32))
    return value, time, mask, torch.tensor(0.0), torch.tensor(5.0), torch.tensor(5.0), bins, 4, oid, n_det


def _by_hand(case):
    """(unmasked, kept lanes, pairs in range, per-flat-bin counts, distinct
    (detector, base) keys of the kept lanes) by a loop over the lanes."""
    value, time, mask, t0, bin_size, bandwidth, bins, support, oid, n_det = case
    counts = np.zeros(bins * (n_det or 1), dtype=np.int64)
    kept, keys = 0, set()
    for i in range(mask.shape[0]):
        if not mask[i]:
            continue
        det = 0 if n_det is None else int(oid[i])
        if not 0 <= det < (n_det or 1):
            continue
        base = int(np.floor((np.float32(time[i]) - np.float32(t0)) / np.float32(bin_size)))
        hit = [b for b in range(base - support, base + support + 1) if 0 <= b < bins]
        for b in hit:
            counts[det * bins + b] += 1
        if hit:
            kept += 1
            keys.add((det, base))
    return int(mask.sum()), kept, int(counts.sum()), counts, keys


@pytest.mark.parametrize("n_det", [None, 3])
@pytest.mark.parametrize("kept", [0.0, 0.02, 0.4])
def test_kde_counts_on_a_recorded_style_call(n_det, kept):
    case = _record(3000, 7, 20, n_det, kept)
    unmasked, kept_lanes, pairs, counts, keys = _by_hand(case)
    assert cs.kde_pairs(case) == (unmasked, kept_lanes, pairs)
    extra = 8 if n_det is None else 12
    want = cs.bound(3000 + extra * unmasked + 8 * 20 * (n_det or 1), cs.KDE_PAIR_FLOP * pairs + 4 * unmasked)
    assert cs.kde_add_bound(case) == want
    stats = cs.kde_call_stats(case)
    assert stats["lanes"] == 3000 and stats["pairs"] == pairs
    assert stats["unmasked"] == unmasked / 3000 and stats["kept"] == kept_lanes / 3000
    assert stats["distinct_bases"] == len(keys)
    top = np.sort(counts)[::-1][:10].sum()
    assert stats["top10_share"] == pytest.approx(top / max(pairs, 1), rel=1e-12)
