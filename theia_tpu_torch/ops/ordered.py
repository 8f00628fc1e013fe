"""The fixed order in which the port's kernels add many lanes' items into
few sums (``csrc/ordered_sum.cuh``), its plain twin and its scratch.

The records (``response.histogram_add``, ``kernel_histogram_add``) and the
backward kernels (``ops/table_read.py``'s reads and row gathers, and
``response.kernel_histogram_grad``'s three scalars) add no float with an
atomic: every sum is a fixed function of the lanes' indices, their count
and the state's size. :func:`ordered_bin_sums` is that order in plain
PyTorch; every kernel's plain version goes through it, so a kernel and its
twin agree bit for bit and a run repeats. :func:`record_table` and
:func:`record_counters` are the kernels' scratch and counters.
"""

from __future__ import annotations

import threading

import torch

from .. import _build

__all__ = [
    "SPAN_LANES",
    "TILE_LANES",
    "TILE_GROUPS",
    "RECORD_RANGE",
    "RECORD_DENSE_CELLS",
    "RECORD_STAGE",
    "RECORD_TABLE_MAX",
    "RECORD_MAX_RANGES",
    "RECORD_COUNTERS",
    "ordered_bin_sums",
    "slot_sums",
    "record_table",
    "record_counters",
]

#: the records' fixed order (``csrc/ordered_sum.cuh``): lanes a warp's span
#: (kSpanLanes), lanes a tile (kTileLanes), groups of tiles (kGroups)
SPAN_LANES, TILE_LANES, TILE_GROUPS = 128, 1024, 32

#: flat bins one range of the records' first pass covers (ordered::kRange:
#: a block's 8 warps' rows of sums take what a block may have of an SM's
#: 227 KB of shared memory less its 1 KB)
RECORD_RANGE = (227 * 1024 - 1024) // 4 // 8

#: the dense pass takes a record of up to this many tiles x bins, the
#: sparse pass a larger one where its tables fit (ordered::kDenseCells);
#: the sparse pass stages RECORD_STAGE entries of the tiles' lists at once
#: (ordered::kStage)
RECORD_DENSE_CELLS, RECORD_STAGE = 1 << 19, 8192

#: the most floats of a record's scratch: a larger (tiles x bins) table of
#: tile sums is taken in batches of ranges (at most RECORD_MAX_RANGES a
#: launch, ordered::kMaxRanges), each range with RECORD_COUNTERS 64-bit
#: counters (ordered::kCounters)
RECORD_TABLE_MAX = 1 << 26
RECORD_MAX_RANGES, RECORD_COUNTERS = 64, TILE_GROUPS + 1


def _in_order(keys: torch.Tensor, values: torch.Tensor):
    """(distinct keys ascending, sums): each key's values added one after
    another in the order given, from +0.0, in float32 (unique indices
    each step, never an ``index_add_`` whose order is not fixed)."""
    keys, perm = torch.sort(keys, stable=True)
    values = values[perm]
    uniq, counts = torch.unique_consecutive(keys, return_counts=True)
    start = torch.cumsum(counts, 0) - counts
    sums = torch.zeros(uniq.shape[0], dtype=torch.float32, device=values.device)
    for r in range(int(counts.max()) if counts.numel() else 0):
        live = torch.nonzero(counts > r).squeeze(1)
        sums[live] = sums[live] + values[start[live] + r]
    return uniq, sums


def ordered_bin_sums(lane: torch.Tensor, bins: torch.Tensor, values: torch.Tensor, n: int, n_state: int,
                     span: int = SPAN_LANES):
    """The records' sums, (n_state,) float32, in their fixed order
    (``csrc/ordered_sum.cuh``). Items are given in the records' order, each
    with its lane and flat bin: a bin's items of a span of ``span`` lanes (a
    warp's :data:`SPAN_LANES`; the gathers' backward takes a whole tile) are
    added in that order, then the spans of a tile of :data:`TILE_LANES`
    lanes, then the tiles in :data:`TILE_GROUPS` groups of ``ceil(tiles /
    TILE_GROUPS)``, then the groups; each sum from +0.0. ``n``: the
    record's lanes."""
    tiles = -(-n // TILE_LANES)
    group = max(1, -(-tiles // TILE_GROUPS))
    keys, sums = _in_order((lane // span) * n_state + bins, values)
    for per in (TILE_LANES // span, group):
        if per > 1:
            keys, sums = _in_order((keys // n_state) // per * n_state + keys % n_state, sums)
    keys, sums = _in_order(keys % n_state, sums)
    total = torch.zeros(n_state, dtype=torch.float32, device=values.device)
    total[keys] = sums
    return total


def _add_sums(state: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """``state + total`` in place where ``total`` is not 0, as a record's
    last block adds."""
    nz = total != 0
    state[nz] += total[nz]
    return state


def _scratch_floats(tiles: int, width: int) -> int:
    """ordered::scratch_floats: a batch's tile sums and group sums."""
    return (tiles + TILE_GROUPS) * width


def _sparse_words(tiles: int, slots: int, n_state: int) -> int | None:
    """The words of the sparse pass's scratch (``ordered::sparse_size``):
    the tiles' lists of bins and sums, where each range of
    :data:`RECORD_RANGE` bins starts in them, and the groups' sums;
    None where the record takes the dense pass (up to
    :data:`RECORD_DENSE_CELLS` tiles x bins, or tables past a block's
    shared memory)."""
    if tiles * n_state <= RECORD_DENSE_CELLS:
        return None
    cap = lambda items: min(items, n_state) + min(items, n_state) // 4 + 1
    warp_cap, tile_cap = cap(SPAN_LANES * slots), cap(TILE_LANES * slots)
    group, ranges, most = -(-tiles // TILE_GROUPS), -(-n_state // RECORD_RANGE), 4 * 8 * RECORD_RANGE
    tiles_smem = 8 * (8 * warp_cap + tile_cap) + 4 * (ranges + 1)
    groups_smem = 4 * (2 * RECORD_STAGE + RECORD_RANGE + 2 * group + 1)
    if tiles_smem > most or groups_smem > most:
        return None
    return 2 * tiles * min(TILE_LANES * slots, n_state) + tiles * (ranges + 1) + -(-tiles // group) * n_state


def record_table(n: int, n_state: int, device, slots: int = 1) -> torch.Tensor:
    """Scratch for a record's sums (``csrc/ordered_sum.cuh``) of ``n``
    lanes of up to ``slots`` items: the sparse pass's lists where it takes
    them, else every bin in one batch, or whole ranges of
    :data:`RECORD_RANGE` bins a batch where that passes
    :data:`RECORD_TABLE_MAX` floats (``ordered::batch_bins`` finds the same
    width in it)."""
    tiles = -(-n // TILE_LANES)
    words = _sparse_words(tiles, slots, n_state) if tiles else None
    if words is not None:
        return torch.empty(words, dtype=torch.float32, device=device)
    width = min(n_state, RECORD_MAX_RANGES * RECORD_RANGE)
    while width > RECORD_RANGE and _scratch_floats(tiles, width) > RECORD_TABLE_MAX:
        width = (-(-width // RECORD_RANGE) - 1) * RECORD_RANGE
    return torch.empty(_scratch_floats(tiles, width) if tiles else 0, dtype=torch.float32, device=device)


#: the records' counters by (device, stream): zero between records; made
#: under the lock, so two threads on one stream share one set
_COUNTERS: dict = {}
_COUNTERS_LOCK = threading.Lock()


def record_counters(state: torch.Tensor) -> torch.Tensor:
    """The counters of ``csrc/ordered_sum.cuh`` for records on the current
    stream of ``state``'s card: made zero once; each record's last blocks
    set them back to 0, and records of one stream run one after another."""
    key = (state.get_device(), _build.raw_stream(state))
    counters = _COUNTERS.get(key)
    if counters is None:
        with _COUNTERS_LOCK:
            counters = _COUNTERS.get(key)
            if counters is None:
                counters = _COUNTERS[key] = torch.zeros(
                    RECORD_MAX_RANGES * RECORD_COUNTERS, dtype=torch.int64, device=state.device
                )
    return counters


def slot_sums(slots, n: int, n_state: int) -> torch.Tensor:
    """:func:`ordered_bin_sums` of a source whose lanes hold up to one item
    in each of ``slots`` (a list of (flat bin, value, kept) tensors of the
    lanes' shape, one a slot), handed over as the kernels' sources hand
    them: a span's rows of 32 lanes in order, in a row the slots in order,
    in a slot the lanes in order. Items that are not kept or whose value is
    0 are left out (adding +-0.0 changes no sum's bits; a NaN is kept)."""
    lanes, bins, values, order = [], [], [], []
    for s, (flat, value, kept) in enumerate(slots):
        lane = torch.nonzero(kept & (value != 0)).squeeze(1)
        lanes.append(lane)
        bins.append(flat[lane])
        values.append(value[lane])
        order.append(((lane // 32) * len(slots) + s) * 32 + lane % 32)
    perm = torch.argsort(torch.cat(order))
    lane, flat, value = (torch.cat(x)[perm] for x in (lanes, bins, values))
    return ordered_bin_sums(lane, flat, value, n, n_state)
