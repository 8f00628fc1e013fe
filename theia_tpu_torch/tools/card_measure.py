#!/usr/bin/env python3
"""Measurements of the hand-written kernels on one NVIDIA GPU, beyond what
``chip_smoke.py`` prints. Run from the repository root:

    python3 -m theia_tpu_torch.tools.card_measure tiles
    python3 -m theia_tpu_torch.tools.card_measure baseline DIR [aos]
    python3 -m theia_tpu_torch.tools.card_measure soup DIR
    python3 -m theia_tpu_torch.tools.card_measure soup-builds
    python3 -m theia_tpu_torch.tools.card_measure read-grad-live
    python3 -m theia_tpu_torch.tools.card_measure walk-builds [DIR]
    python3 -m theia_tpu_torch.tools.card_measure gamma-track-builds [DIR]
    python3 -m theia_tpu_torch.tools.card_measure cherenkov-turns DIR
    python3 -m theia_tpu_torch.tools.card_measure profile
    python3 -m theia_tpu_torch.tools.card_measure sharded [RANKS]
    python3 -m theia_tpu_torch.tools.card_measure sort-turns DIR
    python3 -m theia_tpu_torch.tools.card_measure record-builds [WORDS]
    python3 -m theia_tpu_torch.tools.card_measure record-turns DIR
    python3 -m theia_tpu_torch.tools.card_measure grad-turns DIR

``tiles`` builds the scan of ``csrc/nearest_scan.cuh`` with 256 and 512
rays a block, prints what ptxas reports for each (registers, shared
memory, spills), checks each against the default build bit for bit and
times the three whole-table queries (MT, MT with rows, Woop) at N =
262,144 random rays over the flagship's 3840 triangles.

``baseline DIR`` times the kernels of an earlier commit beside the current
ones in turns (old, new, new, old) at N = 262,144 and 524,288. ``DIR``
holds that commit's ``csrc`` files, e.g. from
``git archive <commit> theia_tpu_torch/csrc | tar -x -C <dir>`` (pass
``<dir>/theia_tpu_torch/csrc``). Without ``aos`` they are the first
kernels, which read the tiled tables ``MTPack.tri`` and ``WoopPack.b``;
with it, the whole-table scan of a commit that reads ``tri_aos`` through
``theia_mt_nearest``, ``theia_mt_nearest_rows`` and ``theia_woop_nearest``
(from the one that added ``tri_aos`` to the parent of the one that made
the whole-table queries the one-group case of the soup's scan), against
the current queries on the same packs. Either way the histogram
record and its backward of ``DIR`` are timed in turns with the current
ones through their C entry points, as a caller sees them and queued
behind a spin kernel (device time alone): at ``chip_smoke.py``'s
mask-0.5 input, on the recorded records of one ``mt`` flagship batch, and
on ``chip_smoke.large_state_cases``' two records over 64,000 flat bins
(kept lanes spread over all bins, and in four bins); a record whose C
entry point takes the table of tile sums (the ordered records) gets it;
then the ``mt`` flagship's seconds per batch and the polarized ``woop``
gradient step's seconds with the old and the current histogram kernels
in turns. With ``aos`` the soup kernels of ``DIR`` are compared too, as
``soup DIR`` does.

``soup DIR`` times the soup entry points of a commit whose
``intersect_soup.cu`` has the first soup kernels' C interface (a chunk
list with ``chunk_first``, no sub-boxes, no ``theia_soup_target``; the
commit that added them) in turns with the current ones (old, new, new,
old), on the recorded queries of one brute-force flagship batch: the 10
primary queries with rows, and the 9 shadow pairs, old as the nearest hit
with rows over the detector, the any-hit over the occluders and the
masks in torch (what ``accel.intersect_target`` ran), new as one
``theia_soup_target`` launch; then the first 9 of those as separate
detector and any-hit replays, and random rays at N = 262,144 and
524,288. Each old query runs on the table in instance order, each new one
on the scene's; the results are held equal first. As called and queued.

``soup-builds`` times measurement builds of the soup kernels, each from
a copy of ``csrc`` patched in the build directory (``SOUP_BUILDS``:
another count of resident blocks, or the lists and the sphere test
without reject() and exact(), whose results are then wrong), in turns
with the package's, on the same recorded queries; then the shadow pairs'
any-hit halves on masked wavefronts against compacted ones.

``read-grad-live`` counts, in each table-read backward of one step of
each gradient path that ``profile`` traces, the lanes whose upstream
gradient is not zero: the traffic that the backward sees on those paths.

``sort-turns DIR`` times the wavefront sort and the scatter back of
``DIR`` (an earlier commit's ``csrc`` with the same C interface of
``csrc/wavefront_sort.cu``; only that file is built, its tile read from
its ``kTile``) in turns with the package's (old, new, new, old), as
called and queued, on the 8 recorded queries of one batch of
flagship-array with ``accel="mt"`` (rows) and with ``accel="woop"``
(``chip_smoke.sort_path_runs``), each call's outputs bit-equal between
the two; then the binned query against the unbinned one in turns, the
measurement behind ``binned=None``; then the package's kernels' device
time a call under ``torch.profiler``.

``record-builds`` times the measurement builds of ``RECORD_BUILDS`` (patches
of copies of ``csrc``: the records' and the sort's dependent launches
triggered early or made plain launches, the record's lane loads in one
round with the masks, fences around relaxed counter adds in place of
acquire-release adds, spans of 8 rows, which is another order, and the
kernel histogram's weights by expf or by an exp in double ops in place
of ``kde_exp``) in turns with the package's, queued: a brute flagship
batch's 19 records, the mask-0.5 record of 524,288 lanes, the kernel
histogram's 40 path calls, and the sort and scatter on flagship-array's
recorded queries; the batch's curve held bit for bit against the
package's. With ``WORDS``, only the builds whose label holds them.

``record-turns DIR`` times the records of ``DIR`` (an earlier commit's
``csrc``; only its ``histogram.cu`` and ``kernel_histogram.cu`` are built,
e.g. the float-atomic records of the commit before the fixed order) in
turns with the package's (old, new, new, old), through their C entry
points, as called and queued: the histogram's record on a brute flagship
batch's 19 records, on the mask-0.5 record of 524,288 lanes and on states
of 1,000 to 64,000 flat bins (``chip_smoke.hist_case`` with a detector
axis; and the 64,000 bins with every kept lane in four of them); the
kernel histogram's on its mask-0.5 record of 524,288 lanes and on the
gradient paths' recorded calls (``chip_smoke.kde_path_calls``). Each
pair's states agree within rtol 1e-4 of the largest bin (the order of an
earlier commit's float atomics), the backward's bit for bit.

``walk-builds [DIR]`` times the instanced and BVH walks' four entry
points, queued and as called, on their cells' cases: random rays at N =
262,144 (``chip_smoke.walk_rays``), the recorded queries of one batch of
flagship-array (8) and flagship-bvh (19; the any-hits bounded at half the
nearest hit, ``chip_smoke.anyhit_queries``), 65,536 rays through the
sweep's 124 modules on either walk, and for the BVH 65,536 rays
(``chip_smoke.case_rays``) through the tests' 27-module array, whose
nodes alone go to shared memory. With ``DIR`` (an earlier commit's
``csrc`` with the walks' first C interface, a thread a lane) first that
commit's walks in turns with the package's (old, new, new, old), results
held equal; then measurement builds (``WALK_BUILDS``: patches of
``csrc/instanced_walk.cu`` or ``csrc/bvh_walk.cu`` in a copy: the BVH's
blocks of 512 threads alone, its node-step cap, a warp's lanes taking
new rays only when all are done, node + 1's rows loaded ahead; the
instanced walk's pairs each warp's own instead of a block's queue, its
box scans lane by lane, no rejection test in front of the exact one,
blocks of 256 or 1024 threads) in turns with the package's; then the
instanced walk on the same rays with the lanes dealt to warps so that
every warp holds as many candidates as the others (what a block-level
queue of pairs could even out at best) and sorted by their candidates,
in turns with the rays as they come.

``gamma-track-builds [DIR]`` times the gamma draw (K1, ``csrc/gamma.cu``)
and the track's backward sample (K2, ``csrc/cherenkov_track.cu``) through
their C entry points, as called and queued, on ``gamma_track_cases``: the
recorded calls of one batch of each ``chip_smoke.py`` phase 3m run that
makes them, the 2^20-lane synthetic calls, and the gamma's mixed rounds
and the track's zigzag and edge lanes at 2^16 lanes. With ``DIR`` (the
``csrc`` of the commit before the redesign, ``git archive <commit>
theia_tpu_torch/csrc``) first that commit's kernels, with its wrapper's
fill and dim add around K1, in turns with the package's (old, new, new,
old), results held bit for bit; then the measurement builds
(``GAMMA_TRACK_BUILDS``, patches of ``csrc/gamma.cu`` and
``csrc/cherenkov_track.cu``: K1 as one cooperative launch on a
persistent grid with a grid-wide barrier, its second launch not a
programmatic dependent, without the queue, with Philox's key set up for
every draw, with the scale's pow skipped by a warp without a small
alpha, at 6 and 8 blocks an SM, and two builds whose results are wrong,
to split its time: a hash in each Philox draw's place, and the rounds'
logs, exp and divisions by the fast approximate intrinsics; K2 with
lists of 8 and 4 and tiles of 128 and 512 rows) in turns with the
package's.

``grad-turns DIR`` times the backward kernels of ``DIR`` (an earlier
commit's ``csrc`` whose backward kernels add with float atomics and take
their C interface, ``ATOMIC_GRAD_SIGNATURES``; only ``table_read.cu`` and
``kernel_histogram.cu`` are built, with their headers) in turns with the
package's (atomics, ordered, ordered, atomics), as called and queued, on
the recorded calls of one step of each gradient run (``_GRAD_RUNS``:
flagship-woop-pol-grad, flagship-volume-grad's two steps,
flagship-brute-geom-grad and scene-backward-target-grad at 262,144
lanes, and the 2,048-lane step that each gloo rank of
gloo-ranks-one-card takes a share of, in one process): all of a step's
calls, and the calls of each kernel apart, each call's outputs held
within float32 rounding of the other's, with the queued ratio. Then
seconds a step of each run with the tree of ``DIR`` (``DIR``'s grandparent
directory, e.g. ``build/parent`` for ``build/parent/theia_tpu_torch/csrc``
from ``git archive HEAD``) and with this one in turns, a process each.

``cherenkov-turns DIR`` times seconds a batch of the Cherenkov runs
(``chip_smoke.py`` phase 3m's cherenkov-muon, cherenkov-cascade,
cascade-backward and track-backward at 3 vertices and at 256 segments,
262,144 lanes, a warm-up and ``CHERENKOV_REPS`` timed batches each) with
the package of the tree ``DIR`` (an earlier commit, ``git archive``) and
with this one in turns (DIR, this tree, this tree, DIR), each a process of
its own that imports its tree's package and ``tests/torch_flagship.py``.
cherenkov-muon runs neither K1 nor K2: it shows how far the host moves
seconds between processes.

``profile`` traces one batch of the ``mt`` flagship, one of the
brute-force flagship (``accel="auto"``), each on both segment routes in
turns (eager, stages, stages, eager; the eager turns through
``torch_flagship.eager_route``), and one of the polarized ``woop``
flagship (262,144 lanes, path length 10) with ``torch.profiler``, one
gradient step of the latter, one step of each of ``chip_smoke.py``'s
gradient phases 3h and 3i (the volume flagship in its absorption and,
with a kernel histogram, its group velocity; the brute flagship's
geometry), one batch of the volume flagship and one of the photon
flagship by ``run()`` and by ``run_compacted()``, and prints device-busy
time, kernel count, the largest items and the hand-written kernels'
device time (the scans, Philox, the histograms, the table reads).

``sharded [RANKS]`` runs flagship-brute over ``RANKS`` cards (all the
cards by default), one process a card (``torch.multiprocessing`` spawn,
``parallel.initialize`` over NCCL with a ``file://`` rendezvous), each rank
262,144 of the global batch's ``RANKS`` x 262,144 lanes: one batch through
``parallel.shard_trace`` with its lanes' RNG dims, then
``SHARDED_BATCHES`` batches a schedule through ``Pipeline(tracer,
runner=ShardedRunner(tracer))`` synchronously and on the dispatch thread
in turns, and the all-reduce of a 100-bin state. Then, on card 0 alone,
the same global batch in one process: each rank's dims equal to its slice
bit for bit, the summed state within ``chip_smoke.RANK_ORDER_RTOL`` of
the largest bin, and seconds a batch of the same schedules, for the
ranks' speed-up.

Every mode but ``profile`` and ``sharded`` runs the flagship's batches
on the eager segment (``SceneForwardTracer._trace_batch_eager``), whose
queries, reads and records it was written to measure.

Every mode prints the card's name and power limit first and writes its
numbers to ``card_measure_<mode>.json`` (``card_measure_baseline_aos.json``
for ``baseline DIR aos``) in ``chip_smoke.py``'s output directory.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
import theia_tpu_torch  # noqa: E402
from theia_tpu_torch import _build  # noqa: E402
from theia_tpu_torch.response import KernelHistogramHitResponse  # noqa: E402
from theia_tpu_torch.trace import SceneForwardTracer  # noqa: E402
from torch_flagship import (  # noqa: E402
    array_rays, build_array, build_flagship, build_photon_flagship, build_volume_flagship, eager_route, icosphere,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
#: the entry points of the first kernels (tiled tables, MT with its tile width)
OLD_SIGNATURES = (
    ("theia_mt_nearest", (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P)),
    ("theia_mt_nearest_rows", (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P)),
    ("theia_woop_nearest", (_P, _P, _P, _P, _P, _I, _I, _P, _P, _P)),
)
#: the histogram entry points that every commit since the backward has
_HIST = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P)
HIST_SIGNATURES = (("theia_histogram_add", _HIST), ("theia_histogram_grad", _HIST))
#: the entry points of a commit whose whole-table scan reads ``tri_aos``
#: (rows, chunk boxes, ray and triangle counts)
AOS_SIGNATURES = (
    ("theia_mt_nearest", (_P, _P, _P, _P, _P, _I, _I, _P, _P, _P)),
    ("theia_mt_nearest_rows", (_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P)),
    ("theia_woop_nearest", (_P, _P, _P, _P, _P, _I, _I, _P, _P, _P)),
    ("theia_philox_uniform", _build._SIGNATURES["theia_philox_uniform"]),
) + HIST_SIGNATURES
#: rays a block, in units of its 256 threads; 3 needs more than 48 KiB of static shared memory
TILES = (1, 2)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Calls:
    """The three whole-table nearest-hit queries of one built library on
    fixed rays, each as a closure that returns its outputs, through the C
    entry points of ``form``: "tiled" (the first kernels), "aos" (the
    whole-table scan over ``tri_aos``) or "scan" (the package's)."""

    def __init__(self, lib, packs, rays, form: str) -> None:
        from theia_tpu_torch.ops.intersect_mt import scan_tables

        mt, woop, table = packs
        o, d, tmax = rays
        n = o.shape[0]
        t = torch.empty(n, device="cuda")
        idx = torch.empty(n, dtype=torch.int32, device="cuda")
        rows = torch.empty((n, 32), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        head = (o.data_ptr(), d.data_ptr(), tmax.data_ptr())
        out = (t.data_ptr(), idx.data_ptr())

        def call(fn, *args):
            def run():
                _build.check(fn(*args), fn.__name__)
                return t, idx, rows
            return run

        if form == "scan":
            mt_head, woop_head = (*head, None, *scan_tables(mt), n), (*head, *scan_tables(woop), n)
            self.mt = call(lib.theia_soup_nearest, *mt_head, *out, stream)
            self.mt_rows = call(lib.theia_soup_nearest_rows, *mt_head, table.data_ptr(), *out, rows.data_ptr(), stream)
            self.woop = call(lib.theia_woop_nearest, *woop_head, *out, stream)
            return
        if form == "tiled":  # the tiled tables, MT with its tile width
            mt_tab = (mt.tri.data_ptr(), mt.chunk_box.data_ptr(), n, mt.n_tri, mt.tri.shape[2])
            woop_tab = (woop.b.data_ptr(), woop.chunk_box.data_ptr(), n, woop.n_tri)
        else:
            mt_tab = (mt.tri_aos.data_ptr(), mt.chunk_box.data_ptr(), n, mt.n_tri)
            woop_tab = (woop.tri_aos.data_ptr(), woop.chunk_box.data_ptr(), n, woop.n_tri)
        self.mt = call(lib.theia_mt_nearest, *head, *mt_tab, *out, stream)
        self.mt_rows = call(
            lib.theia_mt_nearest_rows, *head, *mt_tab, table.data_ptr(), *out, rows.data_ptr(), stream
        )
        self.woop = call(lib.theia_woop_nearest, *head, *woop_tab, *out, stream)

    def results(self):
        got = {}
        for name in ("mt", "mt_rows", "woop"):
            t, idx, rows = getattr(self, name)()
            torch.cuda.synchronize()
            got[name] = (t.clone(), idx.clone(), rows.clone() if name == "mt_rows" else None)
        return got


def _packs():
    mesh = icosphere(3)
    mt = build_flagship(theia_tpu_torch, mesh, 64, 2, device="cuda").scene.pack
    woop = build_flagship(theia_tpu_torch, mesh, 64, 2, accel="woop", device="cuda").scene.pack
    return mt.mt, woop.woop, mt.tri_data


def _same(a, b) -> bool:
    return all(
        torch.equal(x, y)
        for name in a for x, y in zip(a[name], b[name]) if x is not None
    )


def tiles() -> dict:
    packs = _packs()
    rays = chip_smoke.random_rays(chip_smoke.BATCH, 11, "cuda")
    want = Calls(_build.library(), packs, rays, "scan").results()
    out = {}
    for r in TILES:
        lib = _build.build(defines=(f"THEIA_RAYS_PER_THREAD={r}",))
        calls = Calls(lib, packs, rays, "scan")
        assert _same(calls.results(), want), f"{256 * r} rays a block differ from the default build"
        ms = {name: chip_smoke.cuda_ms(getattr(calls, name), 20) for name in ("mt", "mt_rows", "woop")}
        ptxas = _scan_ptxas(lib.build_log)
        out[f"{256 * r} rays a block"] = dict(ms=ms, ptxas=ptxas)
        print(f"{256 * r} rays a block: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
        for line in ptxas:
            print("   ", line)
    return out


class HistCalls:
    """The record and its backward of one built library on fixed records
    (tuples as ``chip_smoke.hist_case`` makes), through the C entry points:
    ``add()`` and ``grad()`` run every record once."""

    def __init__(self, lib, records) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        n_state = records[0][5] * (records[0][7] or 1)
        self.state = torch.zeros(n_state, device="cuda")
        seeded = torch.Generator("cuda").manual_seed(n_state)  # the same in every instance
        self.grad_state = torch.randn(n_state, device="cuda", generator=seeded)
        self.grad_value = torch.empty(max(r[2].shape[0] for r in records), device="cuda")
        self.records = records  # keeps the tensors alive
        self._add, self._grad = [], []
        self.tables = []
        for value, time_, mask, t0, bin_size, bins, oid, n_det in records:
            tail = (time_.data_ptr(), mask.data_ptr(), None if oid is None else oid.data_ptr(),
                    t0.data_ptr(), bin_size.data_ptr(), mask.shape[0], bins, n_det or 0)
            self._add.append((lib.theia_histogram_add, value.data_ptr(), *tail,
                              *_table_args(lib.theia_histogram_add, 14, mask.shape[0], n_state, self.tables),
                              self.state.data_ptr(), stream))
            self._grad.append(
                (lib.theia_histogram_grad, self.grad_state.data_ptr(), *tail, self.grad_value.data_ptr(), stream)
            )

    def add(self):
        for fn, *args in self._add:
            _build.check(fn(*args), "histogram_add")

    def grad(self):
        for fn, *args in self._grad:
            _build.check(fn(*args), "histogram_grad")

    def result(self):
        """The state after one ``add()`` from zero, and the last record's gradient."""
        self.state.zero_()
        self.add()
        self.grad()
        torch.cuda.synchronize()
        state = self.state.clone()
        self.state.zero_()
        return state, self.grad_value.clone()


def _table_args(fn, ordered_args: int, n: int, n_state: int, keep: list, slots: int = 1) -> tuple:
    """The scratch and counters that an ordered record's C entry point (of
    ``ordered_args`` arguments) takes after the lanes (``keep`` holds the
    scratch), or nothing for a float-atomic record's."""
    if len(fn.argtypes) != ordered_args:
        return ()
    table = theia_tpu_torch.response._record_table(n, n_state, "cuda", slots)
    counters = theia_tpu_torch.response._record_counters(table)
    keep.append(table)
    return table.data_ptr(), table.numel(), counters.data_ptr()


def _in_turns(old, new, name: str, reps: int) -> dict:
    """``name`` of ``old`` and ``new`` timed old, new, new, old: as a caller
    sees it and queued."""
    order = (old, new, new, old)
    ms = [chip_smoke.cuda_ms(getattr(c, name), reps) for c in order]
    queued = [chip_smoke.cuda_ms_queued(getattr(c, name), reps) for c in order]
    return dict(old_ms=[ms[0], ms[3]], new_ms=[ms[1], ms[2]],
                old_queued_ms=[queued[0], queued[3]], new_queued_ms=[queued[1], queued[2]])


class _OldHistogram:
    """The package's library with the histogram entry points of another."""

    def __init__(self, new, old) -> None:
        self._new, self._old = new, old

    def __getattr__(self, name):
        return getattr(self._old if name.startswith("theia_histogram") else self._new, name)


def baseline_histogram(old_lib) -> dict:
    """The histogram kernels of ``old_lib`` in turns with the package's."""
    new_lib, out = _build.library(), {}
    mesh = icosphere(3)
    tracer = build_flagship(theia_tpu_torch, mesh, chip_smoke.BATCH, chip_smoke.MAX_PATH, device="cuda")
    inputs = {
        "mask 0.5, N=524288": ([chip_smoke.hist_case(2 * chip_smoke.BATCH, 3)], 50),
        "19 recorded records of an mt flagship batch": (chip_smoke.record_records(tracer), 20),
    }
    large, hot = chip_smoke.large_state_cases(2 * chip_smoke.BATCH)
    inputs["64,000 bins, mask 0.5, N=524288"] = ([large], 50)
    inputs["64,000 bins of which 4 in use, mask 0.5, N=524288"] = ([hot], 50)
    for label, (records, reps) in inputs.items():
        old, new = HistCalls(old_lib, records), HistCalls(new_lib, records)
        (old_state, old_grad), (new_state, new_grad) = old.result(), new.result()
        torch.testing.assert_close(new_state, old_state, rtol=1e-4, atol=0.0)
        assert torch.equal(new_grad, old_grad), "old and new backward differ"
        for name in ("add", "grad"):
            t = out[f"histogram_{name}, {label}"] = _in_turns(old, new, name, reps)
            print(f"histogram_{name}, {label}: old {t['old_ms'][0]:.4f} / {t['old_ms'][1]:.4f} ms "
                  f"(queued {t['old_queued_ms'][0]:.4f} / {t['old_queued_ms'][1]:.4f}), "
                  f"new {t['new_ms'][0]:.4f} / {t['new_ms'][1]:.4f} ms "
                  f"(queued {t['new_queued_ms'][0]:.4f} / {t['new_queued_ms'][1]:.4f}) (old, new, new, old)")
    # end to end, the old and the new histogram kernels in turns
    wrappers = {"histogram_add": theia_tpu_torch.response.histogram_add}
    pol_tracer = build_flagship(
        theia_tpu_torch, mesh, chip_smoke.BATCH, chip_smoke.MAX_PATH, accel="woop", polarized=True, device="cuda"
    )
    chip_smoke.absorption_grad(pol_tracer)  # warm-up step
    package_library = _build.library
    turns = []
    try:
        for which in ("old", "new", "new", "old") * 2:
            lib = _OldHistogram(new_lib, old_lib) if which == "old" else new_lib
            _build.library = lambda lib=lib: lib
            seconds, _, counts, _ = chip_smoke.timed_runs(tracer, wrappers, "mt path")
            assert counts["histogram_add"] == 19 * 3, counts
            torch.cuda.synchronize()
            start = time.perf_counter()
            chip_smoke.absorption_grad(pol_tracer)
            torch.cuda.synchronize()
            turns.append(dict(histogram=which, mt_seconds_per_batch=seconds,
                              gradient_step_seconds=time.perf_counter() - start))
    finally:
        _build.library = package_library
    print("mt flagship s/batch and polarized woop gradient step s, old and new histogram kernels in turns: "
          + "; ".join(f"{t['histogram']} {[round(x, 4) for x in t['mt_seconds_per_batch']]} "
                      f"{t['gradient_step_seconds']:.4f}" for t in turns))
    out["end to end"] = turns
    return out


#: the first soup kernels' entry points: chunk_first, no sub-boxes
_SOUP_HEAD = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I)
OLD_SOUP_SIGNATURES = (
    ("theia_soup_nearest", _SOUP_HEAD + (_P, _P, _P)),
    ("theia_soup_nearest_rows", _SOUP_HEAD + (_P, _P, _P, _P, _P)),
    ("theia_soup_anyhit", _SOUP_HEAD + (_P, _P)),
)


class SoupCalls:
    """The soup queries of one built library on fixed recorded queries,
    through the C entry points: ``primary()`` runs the primary queries with
    rows, ``shadow()`` the shadow pairs, ``detector()`` and ``anyhit()``
    their halves alone (the first soup kernels' two launches). ``old``: the
    first kernels' interface, on ``table`` in instance order."""

    def __init__(self, lib, table, rows_table, primary, shadow, old: bool) -> None:
        self.lib, self.table, self.rows_table, self.old = lib, table, rows_table, old
        self.stream = torch.cuda.current_stream().cuda_stream
        self.det, self.occ = table.chunk_list([2]), table.chunk_list([0, 1])
        every = table.chunk_list(None)
        n = max(q[0].shape[0] for q in primary + shadow)
        self.t, self.idx = torch.empty(n, device="cuda"), torch.empty(n, dtype=torch.int32, device="cuda")
        self.rows = torch.empty((n, 32), device="cuda")
        self.any = torch.empty(n, dtype=torch.bool, device="cuda")
        self._primary = [(q, every) for q in primary]
        self._shadow = shadow
        # the occluder halves need the detector halves' answers: t and found, per shadow pair
        self.halves = [(torch.empty(q[0].shape[0], device="cuda"), torch.empty(q[0].shape[0], dtype=torch.bool,
                                                                                  device="cuda")) for q in shadow]

    def _head(self, q, chunks, active=None, t_max=None):
        o, d, tm = q[0], q[1], q[2] if t_max is None else t_max
        tab = self.table
        mid = (tab.chunk_first.data_ptr(),) if self.old else (tab.sub_box.data_ptr(),)
        return (o.data_ptr(), d.data_ptr(), tm.data_ptr(), None if active is None else active.data_ptr(),
                tab.aos.data_ptr(), tab.chunk_box.data_ptr(), *mid, tab.chunk_count.data_ptr(),
                chunks.data_ptr(), chunks.numel())

    def _nearest_rows(self, q, chunks, active=None):
        n = q[0].shape[0]
        err = self.lib.theia_soup_nearest_rows(*self._head(q, chunks, active), n, self.rows_table.data_ptr(),
                                               self.t.data_ptr(), self.idx.data_ptr(), self.rows.data_ptr(),
                                               self.stream)
        _build.check(err, "theia_soup_nearest_rows")

    def _anyhit(self, q, chunks, t_max, active):
        err = self.lib.theia_soup_anyhit(*self._head(q, chunks, active, t_max), q[0].shape[0],
                                         self.any.data_ptr(), self.stream)
        _build.check(err, "theia_soup_anyhit")

    def primary_one(self, k):
        q, chunks = self._primary[k]
        self._nearest_rows(q, chunks)
        n = q[0].shape[0]
        return self.t[:n].clone(), self.idx[:n].clone(), self.rows[:n].clone()

    def primary(self):
        for q, chunks in self._primary:
            self._nearest_rows(q, chunks)

    def shadow_one(self, k):
        """One shadow pair as accel.intersect_target ran it (old) or runs it (new)."""
        q = self._shadow[k]
        n = q[0].shape[0]
        if not self.old:
            err = self.lib.theia_soup_target(*self._head(q, self.det, q[4]), self.occ.data_ptr(), self.occ.numel(),
                                             n, self.rows_table.data_ptr(), self.t.data_ptr(), self.idx.data_ptr(),
                                             self.rows.data_ptr(), self.stream)
            _build.check(err, "theia_soup_target")
            return self.t[:n], self.idx[:n], self.rows[:n]
        self._nearest_rows(q, self.det, q[4])
        t, idx, rows = self.t[:n], self.idx[:n], self.rows[:n]
        found = idx >= 0
        self._anyhit(q, self.occ, t, found)
        valid = found & ~self.any[:n]
        return (torch.where(valid, t, torch.inf), torch.where(valid, idx, -1),
                torch.where(valid[:, None], rows, self.rows_table[0]))

    def shadow(self):
        for k in range(len(self._shadow)):
            self.shadow_one(k)

    def detector(self):
        for q in self._shadow:
            self._nearest_rows(q, self.det, q[4])

    def anyhit(self):
        for q, (t, found) in zip(self._shadow, self.halves):
            self._anyhit(q, self.occ, t, found)


def baseline_soup(old_lib) -> dict:
    """The soup kernels of ``old_lib`` in turns with the package's on the
    recorded queries of a brute-force flagship batch and on random rays."""
    from theia_tpu_torch.ops.intersect_soup import nearest_in_table

    tracer = build_flagship(theia_tpu_torch, icosphere(3), chip_smoke.BATCH, chip_smoke.MAX_PATH, accel="auto",
                            device="cuda")
    pack = tracer.scene.pack
    primary = chip_smoke.record_soup_queries(tracer, "nearest_in_table_rows")
    shadow = chip_smoke.record_soup_queries(tracer, "target_in_table")
    old = SoupCalls(old_lib, chip_smoke.instance_order(pack.soup), pack.tri_data, primary, shadow, old=True)
    new = SoupCalls(_build.library(), pack.soup, pack.tri_data, primary, shadow, old=False)
    for calls in (old, new):
        for q, half in zip(shadow, calls.halves):
            t, idx = nearest_in_table(pack.soup, q[0], q[1], q[2], groups=[2], active=q[4])
            half[0].copy_(t)
            half[1].copy_(idx >= 0)
    for k in range(len(primary)):
        assert all(torch.equal(a, b) for a, b in zip(old.primary_one(k), new.primary_one(k))), "primary differs"
    for k in range(len(shadow)):
        got_old = [a.clone() for a in old.shadow_one(k)]
        assert all(torch.equal(a, b) for a, b in zip(got_old, new.shadow_one(k))), "shadow pair differs"
    out = {}
    for name in ("primary", "shadow", "detector", "anyhit"):
        t = out[f"{name}, recorded brute batch"] = _in_turns(old, new, name, 5)
        print(f"soup {name} ({len(primary) if name == 'primary' else len(shadow)} recorded queries of a brute batch): "
              f"old {t['old_ms'][0]:.4f} / {t['old_ms'][1]:.4f} ms (queued {t['old_queued_ms'][0]:.4f} / "
              f"{t['old_queued_ms'][1]:.4f}), new {t['new_ms'][0]:.4f} / {t['new_ms'][1]:.4f} ms (queued "
              f"{t['new_queued_ms'][0]:.4f} / {t['new_queued_ms'][1]:.4f}) (old, new, new, old; bit-equal)")
    for n in (chip_smoke.BATCH, 2 * chip_smoke.BATCH):
        o, d, tmax = chip_smoke.random_rays(n, n, "cuda")
        rays = [(o, d, tmax, None, None)]
        old_r = SoupCalls(old_lib, chip_smoke.instance_order(pack.soup), pack.tri_data, rays, [], old=True)
        new_r = SoupCalls(_build.library(), pack.soup, pack.tri_data, rays, [], old=False)
        assert all(torch.equal(a, b) for a, b in zip(old_r.primary_one(0), new_r.primary_one(0))), "random rays differ"
        t = out[f"nearest with rows N={n}"] = _in_turns(old_r, new_r, "primary", 20)
        print(f"soup nearest with rows N={n}: old {t['old_ms'][0]:.4f} / {t['old_ms'][1]:.4f} ms, new "
              f"{t['new_ms'][0]:.4f} / {t['new_ms'][1]:.4f} ms (old, new, new, old; bit-equal)")
    return out


#: measurement builds of the soup kernels, each against the package's: a
#: copy of ``csrc`` with each (text, replacement) of ``csrc/nearest_scan.cuh``
#: made, and whether the results stay those of the package
_PAIR_TESTS = "__device__ __forceinline__ void test_row(const Ray& r, const float4* row, unsigned long long* key) {"
SOUP_BUILDS = {
    "3 blocks an SM": ((("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 3;"),), True),
    "5 blocks an SM": ((("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 5;"),), True),
    "lists and sphere test alone": (((_PAIR_TESTS, _PAIR_TESTS + "\n  return;"),), False),
}


def patched_build(label: str, patches, source: str = "nearest_scan.cuh", csrc: Path = _build.CSRC,
                  signatures: tuple | None = None):
    """The kernels of ``csrc`` (the package's by default) built from a copy
    in the build directory with ``patches`` ((text, replacement) pairs of
    ``source``, each text found once) made."""
    import shutil

    copy = _build.BUILD_DIR / "patched" / label.replace(" ", "-").replace("(", "").replace(")", "")
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(csrc, copy)
    path = copy / source
    text = path.read_text()
    for old, new in patches:
        assert text.count(old) == 1, f"{label}: {old!r} is not in {source} once"
        text = text.replace(old, new)
    path.write_text(text)
    return _build.build(copy, (), signatures or tuple(_build._SIGNATURES.items()))


def _scan_ptxas(log: str) -> list:
    """ptxas's registers, spills and shared memory of each instance of the scan."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "4scanI" in line:
            tail = [x.strip() for x in lines[i + 1 : i + 4] if "bytes" in x or "registers" in x]
            out.append(line.split("4scanI")[1][:40] + ": " + "; ".join(tail))
    return out


def soup_builds() -> dict:
    """The soup kernels of each build of ``SOUP_BUILDS`` in turns with the
    package's (package, build, build, package) on a brute batch's recorded
    queries: what ptxas reports, bit-equality where the build keeps the
    results, ms as called and queued."""
    tracer = build_flagship(theia_tpu_torch, icosphere(3), chip_smoke.BATCH, chip_smoke.MAX_PATH, accel="auto",
                            device="cuda")
    pack = tracer.scene.pack
    primary = chip_smoke.record_soup_queries(tracer, "nearest_in_table_rows")
    shadow = chip_smoke.record_soup_queries(tracer, "target_in_table")
    base = SoupCalls(_build.library(), pack.soup, pack.tri_data, primary, shadow, old=False)
    for q, half in zip(shadow, base.halves):
        t, idx = theia_tpu_torch.ops.intersect_soup.nearest_in_table(pack.soup, *q[:3], groups=[2], active=q[4])
        half[0].copy_(t)
        half[1].copy_(idx >= 0)
    out = {"package": dict(ptxas=_scan_ptxas(_build.library().build_log))}
    for line in out["package"]["ptxas"]:
        print("    package:", line)
    for label, (patches, same) in SOUP_BUILDS.items():
        lib = patched_build(label, patches)
        calls = SoupCalls(lib, pack.soup, pack.tri_data, primary, shadow, old=False)
        calls.halves = base.halves
        ptxas = _scan_ptxas(lib.build_log)
        if same:
            for k in range(len(primary)):
                assert all(torch.equal(a, b) for a, b in zip(base.primary_one(k), calls.primary_one(k))), label
            for k in range(len(shadow)):
                want = [a.clone() for a in base.shadow_one(k)]
                assert all(torch.equal(a, b) for a, b in zip(want, calls.shadow_one(k))), label
        entry = out[label] = dict(patches=patches, ptxas=ptxas)
        for name in ("primary", "shadow", "detector", "anyhit"):
            t = entry[name] = _in_turns(base, calls, name, 5)
            print(f"soup {name}, {label}: package {t['old_queued_ms'][0]:.4f} / "
                  f"{t['old_queued_ms'][1]:.4f} ms, build {t['new_queued_ms'][0]:.4f} / {t['new_queued_ms'][1]:.4f} ms "
                  f"(queued; package, build, build, package)")
        for line in ptxas:
            print("   ", line)
    out["compacted any-hit"] = soup_compacted(base)
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel_ptxas(log: str, name: str) -> list:
    """ptxas's registers, spills and shared memory of each kernel whose
    mangled name holds ``name``."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            tail = [x.strip() for x in lines[i + 1 : i + 4] if "bytes" in x or "registers" in x]
            out.append(line.split(name)[1][:24] + ": " + "; ".join(tail))
    return out


def _base_sources(parent: Path | None) -> tuple:
    """(csrc, signatures) of the base kernels: ``parent``'s (an earlier
    commit's, with those of the package's C entry points that its sources
    define) or the package's."""
    if parent is None:
        return _build.CSRC, tuple(_build._SIGNATURES.items())
    text = "".join(path.read_text() for path in parent.glob("*.cu"))
    return parent, tuple((name, args) for name, args in _build._SIGNATURES.items() if name in text)


def _design(source: Path, builds: dict) -> dict:
    """The measurement builds of the design whose marker ``source`` holds."""
    text = source.read_text()
    found = [b for marker, b in builds.items() if marker in text]
    assert len(found) == 1, f"{source}: no measurement builds for its design"
    return found[0]


def read_grad_live() -> dict:
    """The table reads' backward calls of one step of each gradient path
    (``chip_smoke.absorption_grad`` of the polarized ``woop`` flagship, the
    volume flagship's absorption and group-velocity steps, the brute
    flagship's geometry step, as ``profile`` runs them): for each call its
    lanes, the lanes with a nonzero upstream gradient (in any table), and
    the floats of the tables' gradients it takes."""
    from theia_tpu_torch.ops import table_read as tr

    calls, inner = [], tr._backward

    def counting(reader, tables, sizes, bounds, handle, x, grad_out, need_tables, need_x):
        live = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        for g in grad_out:
            if g is not None:
                live |= g.reshape(-1) != 0
        floats = sum(t.numel() for t, need in zip(tables, need_tables) if need and t is not None)
        calls.append(dict(lanes=int(x.shape[0]), live=int(live.sum()), tables=len(tables), floats=int(floats),
                          packed=bool(reader.packed)))
        return inner(reader, tables, sizes, bounds, handle, x, grad_out, need_tables, need_x)

    mesh = icosphere(3)
    kde = lambda: KernelHistogramHitResponse(nBins=100, t0=0.0, binSize=5.0, bandwidth=5.0)
    polarized = lambda: build_flagship(theia_tpu_torch, mesh, chip_smoke.BATCH, chip_smoke.MAX_PATH, device="cuda",
                                       accel="woop", polarized=True)
    steps = (
        ("woop polarized gradient", polarized, chip_smoke.absorption_grad),
        ("volume gradient, absorption", lambda: build_volume_flagship(theia_tpu_torch, chip_smoke.BATCH, "cuda"),
         lambda t: chip_smoke.scale_step(t, "absorption_coef", float(np.log(1.35)))()),
        ("volume gradient, group velocity",
         lambda: build_volume_flagship(theia_tpu_torch, chip_smoke.BATCH, "cuda", response=kde()),
         lambda t: chip_smoke.scale_step(t, "group_velocity", float(np.log(0.92)))()),
        ("brute geometry gradient", lambda: build_flagship(theia_tpu_torch, mesh, chip_smoke.BATCH, chip_smoke.MAX_PATH,
                                                            accel="auto", device="cuda", response=kde()),
         lambda t: chip_smoke.geometry_step(t)()),
    )
    out = {}
    tr._backward = counting
    try:
        for label, make, run in steps:
            tracer = make()
            calls.clear()
            run(tracer)
            torch.cuda.synchronize()
            lanes, live = sum(c["lanes"] for c in calls), sum(c["live"] for c in calls)
            shares = sorted(c["live"] / max(c["lanes"], 1) for c in calls)
            out[label] = dict(calls=list(calls), lanes=lanes, live=live)
            print(f"{label}: {len(calls)} read backwards, {lanes} lanes, {live} live ({live / max(lanes, 1):.4f}); "
                  f"a call's live share min {shares[0] if shares else 0:.4f}, median "
                  f"{shares[len(shares) // 2] if shares else 0:.4f}, max {shares[-1] if shares else 0:.4f}")
            for c in calls:
                print(f"    {c['lanes']} lanes, {c['live']} live, {c['tables']} table(s), {c['floats']} floats of "
                      f"gradient, {'packed' if c['packed'] else 'single'}")
            del tracer
            torch.cuda.empty_cache()
    finally:
        tr._backward = inner
    return out


class KdeAddCalls:
    """The kernel histogram's record of one built library on fixed calls
    (``chip_smoke.kde_case`` tuples, one state size), through its C entry
    point: ``add()`` runs every call once into one state."""

    def __init__(self, lib, calls) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        self.calls = calls  # keeps the tensors alive
        self.state = torch.zeros(calls[0][6] * (calls[0][9] or 1), device="cuda")
        self.fn = lib.theia_kde_add
        self.tables, n_state = [], self.state.shape[0]
        self.args = [(value.data_ptr(), time_.data_ptr(), mask.data_ptr(), _ptr(oid), t0.data_ptr(), bs.data_ptr(),
                      bw.data_ptr(), time_.shape[0], bins, n_det or 0, support,
                      *_table_args(self.fn, 16, time_.shape[0], n_state, self.tables, 2 * support + 1),
                      self.state.data_ptr(), stream)
                     for value, time_, mask, t0, bs, bw, bins, support, oid, n_det in calls]

    def add(self):
        for args in self.args:
            _build.check(self.fn(*args), "theia_kde_add")

    def result(self):
        """The state after one ``add()`` from zero."""
        self.state.zero_()
        self.add()
        torch.cuda.synchronize()
        out = self.state.clone()
        self.state.zero_()
        return out


def _turns(base, build, name: str, launches: int, reps: int = 200) -> dict:
    """``name`` of ``base`` and ``build`` (each ``launches`` launches) timed
    base, build, build, base, as called and queued (twice the launches of
    ``reps`` calls): ms a launch."""
    order = (base, build, build, base)
    ms = [chip_smoke.cuda_ms(getattr(c, name), max(1, reps // launches)) / launches for c in order]
    queued = [chip_smoke.cuda_ms_queued(getattr(c, name), max(1, 2 * reps // launches)) / launches for c in order]
    return dict(base_ms=[ms[0], ms[3]], build_ms=[ms[1], ms[2]], base_queued_ms=[queued[0], queued[3]],
                build_queued_ms=[queued[1], queued[2]])


def _print_turns(what: str, label: str, t: dict) -> None:
    print(f"{what}, {label}: base {t['base_queued_ms'][0]:.4f} / {t['base_queued_ms'][1]:.4f} ms, build "
          f"{t['build_queued_ms'][0]:.4f} / {t['build_queued_ms'][1]:.4f} ms a launch queued; as called base "
          f"{t['base_ms'][0]:.4f} / {t['base_ms'][1]:.4f}, build {t['build_ms'][0]:.4f} / {t['build_ms'][1]:.4f} "
          f"(base, build, build, base)")


def _builds(parent: Path | None, source: str, designs: dict) -> dict:
    """label -> (base library, library, patches, which of the two are the
    parent's kernels) of a ``*-builds`` mode: with ``parent`` (an earlier
    commit's ``csrc``, the same C entry points) first the package against
    the parent's kernels and the measurement builds of the parent's design
    against the parent ("parent, ..."), then each measurement build of the
    package's design (``designs``, keyed by a line of ``source``) against
    the package."""
    package = _build.library()
    out = {}
    if parent is not None:
        csrc, sigs = _base_sources(parent)
        parent_lib = _build.build(csrc, (), sigs)
        out["package against the parent"] = (parent_lib, package, None, (True, False))
        # a parent from before a source was split off has none of its designs
        text = (csrc / source).read_text() if (csrc / source).is_file() else ""
        for marker, builds in designs.items():
            if marker in text and marker not in (_build.CSRC / source).read_text():
                for label, patches in builds.items():
                    lib = patched_build(f"parent, {label}", patches, source, csrc, sigs)
                    out[f"parent, {label}"] = (parent_lib, lib, patches, (True, True))
    for label, patches in _design(_build.CSRC / source, designs).items():
        out[label] = (package, patched_build(label, patches, source), patches, (False, False))
    return out


#: the Sobol draw's measurement builds, by design (keyed by a line of the design's source). The
#: first: a thread a lane, the row read as eight 16-byte loads, each bit's
#: mask made with two shifts
_SOBOL_FIRST_FOLD = ("      const uint32_t mask = static_cast<uint32_t>(static_cast<int32_t>(idx << (31 - b)) >> 31);\n"
                     "      v ^= words[k] & mask;")
SOBOL_BUILDS = {
    _SOBOL_FIRST_FOLD: {
        "predicated fold": ((_SOBOL_FIRST_FOLD, "      if (idx & (1u << b)) v ^= words[k];"),),
        "scramble seed not hashed (results wrong)": (("hash32(d ^ a.seed_hash)", "(d ^ a.seed_hash)"),),
        "no fold (results wrong)": (("  for (int q = 0; q < 8; ++q) {\n    const uint4 w",
                                     "  for (int q = 0; q < 0; ++q) {\n    const uint4 w"),),
    },
    # the current one: the fold as four lookups in the index's byte tables (random._byte_table)
    "  // the fold a byte of the index at a time: four independent lookups": {
        "scramble seed hashed once a call (results wrong)": (("hash32(d ^ a.seed_hash)", "(d ^ a.seed_hash)"),),
        "no lookups (results wrong)": ((
            "  const uint32_t v = __ldg(t + (idx & 0xffu)) ^ __ldg(t + 256 + __byte_perm(idx, 0u, 0x4441)) ^\n"
            "                     __ldg(t + 512 + __byte_perm(idx, 0u, 0x4442)) ^ __ldg(t + 768 + (idx >> 24));",
            "  const uint32_t v = idx ^ static_cast<uint32_t>(reinterpret_cast<uintptr_t>(t));"),),
    },
}


class SobolCalls:
    """The Sobol draw of one built library on fixed calls ((table, seed,
    stream, dim, width, offset) tuples, as ``chip_smoke.record_sobol_calls``
    makes them), through its C entry point: ``draw()`` runs every call once.
    ``rows``: the library's kernel reads the direction rows (the kernels
    before the byte tables), not ``random._byte_table``."""

    def __init__(self, lib, calls, rows: bool = False) -> None:
        from theia_tpu_torch.random import _MASK, _SHUFFLE_SALT, _byte_table, _hash32

        stream = torch.cuda.current_stream().cuda_stream
        self.calls = calls
        self.outs = [torch.empty((c[2].shape[0], c[4]), device="cuda") for c in calls]
        self.fn = lib.theia_sobol_uniform
        self.args = []
        for (dirs, seed, lanes, dim, width, offset), out in zip(calls, self.outs):
            seed = int(seed) & _MASK
            self.args.append(((dirs if rows else _byte_table(dirs)).data_ptr(), dirs.shape[0], seed, _hash32(seed ^ _SHUFFLE_SALT), _hash32(seed),
                              int(offset) & _MASK, lanes.data_ptr(), dim.data_ptr(), lanes.shape[0], width,
                              out.data_ptr(), stream))

    def draw(self):
        for args in self.args:
            _build.check(self.fn(*args), "theia_sobol_uniform")

    def result(self):
        self.draw()
        torch.cuda.synchronize()
        return [o.clone() for o in self.outs]


def sobol_cases() -> dict:
    """The Sobol draw's timing cases: label -> calls. ``chip_smoke.check_sobol``'s
    2^20 lanes x 2 draws of the flagship's generator over the path's 74
    dims and of example 11's over 160 (the Philox tail), and one batch's
    recorded calls of flagship-brute-sobol and flagship-volume-sobol
    (262,144 lanes), with their ``chip_smoke.sobol_call_stats``."""
    import warnings

    from theia_tpu_torch.random import _direction_table

    n = 1 << 20
    rng = np.random.default_rng(3)
    lanes = torch.arange(n, dtype=torch.int32, device="cuda")
    cases = {}
    for label, gen, top in (("synthetic, 2^20 x 2, 128 dims over 74", chip_smoke.FLAGSHIP_SOBOL, 74),
                            ("synthetic, 2^20 x 2, 64 dims over 160", chip_smoke.EXAMPLE_11_SOBOL, 160)):
        dim = torch.as_tensor(rng.integers(0, top, size=n).astype(np.int32), device="cuda")
        cases[label] = [(_direction_table(gen["dims"], "cuda"), gen["seed"], lanes, dim, 2, n)]
    mesh = icosphere(3)
    brute = build_flagship(theia_tpu_torch, mesh, chip_smoke.BATCH, chip_smoke.MAX_PATH, accel="auto", device="cuda",
                           rng=chip_smoke.sobol(chip_smoke.FLAGSHIP_SOBOL))
    cases["flagship-brute-sobol"] = chip_smoke.record_sobol_calls(brute)
    del brute
    with warnings.catch_warnings():  # its path's budget of 72 dims is past example 11's 64
        warnings.simplefilter("ignore")
        volume = build_volume_flagship(theia_tpu_torch, chip_smoke.BATCH, "cuda",
                                       rng=chip_smoke.sobol(chip_smoke.EXAMPLE_11_SOBOL))
    cases["flagship-volume-sobol"] = chip_smoke.record_sobol_calls(volume)
    del volume
    for label in ("flagship-brute-sobol", "flagship-volume-sobol"):
        calls = cases[label]
        print(f"{label}: {chip_smoke.sobol_call_stats(calls, calls[0][0].shape[0])}")
    return cases


def sobol_builds(parent: Path | None) -> dict:
    """The Sobol draw on ``sobol_cases``: with ``parent`` the package's kernel in turns with the
    parent's, then the measurement builds of the package's design
    (``SOBOL_BUILDS``) in turns with the package; results held bit for bit
    against their base where the build keeps them. Each library's SASS of
    ``sobol_uniform``."""
    cases = sobol_cases()
    package = _build.library()
    out = {"package": dict(sass=chip_smoke.sass_report(package, ("sobol_uniform",)),
                           ptxas=_kernel_ptxas(package.build_log, "sobol_uniform"))}
    for label, (base_lib, lib, patches, (base_rows, rows)) in _builds(parent, "sobol.cuh", SOBOL_BUILDS).items():
        entry = out[label] = dict(patches=patches, sass=chip_smoke.sass_report(lib, ("sobol_uniform",)),
                                  ptxas=_kernel_ptxas(lib.build_log, "sobol_uniform"))
        for name, calls in cases.items():
            base, other = SobolCalls(base_lib, calls, base_rows), SobolCalls(lib, calls, rows)
            if not label.endswith("(results wrong)"):
                for a, b in zip(other.result(), base.result()):
                    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (label, name)
            t = entry[name] = _turns(base, other, "draw", len(calls))
            _print_turns(f"sobol on {name} ({len(calls)} calls)", label, t)
        for line in entry["ptxas"]:
            print("   ", line)
        for fn, info in entry["sass"].items():
            print(f"    sass {fn[:60]}: {info['instructions']} instructions, {info['opcodes']}")
    out["empty launch"] = chip_smoke.empty_launch_ms()
    print(f"empty launch: {out['empty launch']['queued_ms']:.4f} ms queued")
    return out


class CompactedAnyhit:
    """The occluder halves of the shadow pairs of ``calls`` on their live
    lanes alone (those with a detector hit): ``anyhit`` launches the
    any-hit on wavefronts compacted beforehand, the kernel's time on live
    lanes only; ``compacting`` also compacts in torch around each launch
    and scatters the answers back, what compacting outside the kernel
    costs."""

    def __init__(self, calls: SoupCalls) -> None:
        self.calls = calls
        live = [torch.nonzero(found).squeeze(1) for _, found in calls.halves]
        self.queries = [(q[0][i].contiguous(), q[1][i].contiguous(), t[i].contiguous())
                        for q, (t, _), i in zip(calls._shadow, calls.halves, live)]
        self.out = [torch.zeros(q[0].shape[0], dtype=torch.bool, device="cuda") for q in calls._shadow]

    def anyhit(self):
        for q in self.queries:
            self.calls._anyhit(q, self.calls.occ, q[2], None)

    def compacting(self):
        for q, (t, found), out in zip(self.calls._shadow, self.calls.halves, self.out):
            live = torch.nonzero(found).squeeze(1)
            c = (q[0][live].contiguous(), q[1][live].contiguous(), t[live].contiguous())
            self.calls._anyhit(c, self.calls.occ, c[2], None)
            out.zero_()
            out[live] = self.calls.any[: live.numel()]


def soup_compacted(base: SoupCalls) -> dict:
    """The any-hit halves of a brute batch's shadow pairs on masked
    wavefronts (the package's way) against compacted ones, in turns: the
    kernel alone on wavefronts compacted beforehand (as called and queued),
    and with the compaction in torch (as called only: ``torch.nonzero``
    waits for the device)."""
    comp = CompactedAnyhit(base)
    comp.compacting()
    for k, (q, (t, found)) in enumerate(zip(base._shadow, base.halves)):
        base._anyhit(q, base.occ, t, found)
        assert torch.equal(comp.out[k], base.any[: q[0].shape[0]]), "compacted any-hit differs"
    live = sum(q[0].shape[0] for q in comp.queries)
    kernel = _in_turns(base, comp, "anyhit", 5)
    with_torch = [chip_smoke.cuda_ms(f, 5) for f in (base.anyhit, comp.compacting, comp.compacting, base.anyhit)]
    print(f"soup anyhit of {len(comp.queries)} shadow pairs ({live} live lanes): masked {kernel['old_queued_ms'][0]:.4f} "
          f"/ {kernel['old_queued_ms'][1]:.4f} ms queued, compacted beforehand {kernel['new_queued_ms'][0]:.4f} / "
          f"{kernel['new_queued_ms'][1]:.4f} ms queued; as called, masked {with_torch[0]:.4f} / {with_torch[3]:.4f} ms, "
          f"compacting in torch {with_torch[1]:.4f} / {with_torch[2]:.4f} ms (equal answers)")
    return dict(live_lanes=live, kernel=kernel, masked_ms=[with_torch[0], with_torch[3]],
                compacting_ms=[with_torch[1], with_torch[2]])


def baseline(csrc: Path, tiled: bool) -> dict:
    packs = _packs()
    old_lib = _build.build(csrc, (), OLD_SIGNATURES + HIST_SIGNATURES if tiled else AOS_SIGNATURES)
    out = baseline_histogram(old_lib)
    if not tiled and (csrc / "intersect_soup.cu").exists():  # a commit with the first soup kernels
        out["soup"] = baseline_soup(_build.build(csrc, (), OLD_SOUP_SIGNATURES))
    for n in (chip_smoke.BATCH, 2 * chip_smoke.BATCH):
        rays = chip_smoke.random_rays(n, n, "cuda")
        old = Calls(old_lib, packs, rays, "tiled" if tiled else "aos")
        new = Calls(_build.library(), packs, rays, "scan")
        assert _same(old.results(), new.results()), "old and new kernels differ"
        for name in ("mt", "mt_rows", "woop"):
            ms = [chip_smoke.cuda_ms(getattr(c, name), 20) for c in (old, new, new, old)]
            out[f"{name} N={n}"] = dict(old_ms=[ms[0], ms[3]], new_ms=[ms[1], ms[2]])
            print(f"{name} N={n}: old {ms[0]:.4f} / {ms[3]:.4f} ms, new {ms[1]:.4f} / {ms[2]:.4f} ms "
                  f"(old, new, new, old; bit-equal)")
    return out


#: the walks' first C entry points, a thread a lane (no placement, no slot)
OLD_WALK_SIGNATURES = (
    ("theia_bvh_nearest", (_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P)),
    ("theia_bvh_occluded", (_P, _P, _P, _P, _P, _P, _I, _I, _P, _P)),
    ("theia_instanced_nearest", (_P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P)),
    ("theia_instanced_occluded", (_P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P)),
)
#: the instanced walk's rounds as the package runs them (a block-level
#: queue of pairs), and with each warp scanning its own lanes' pairs
_QUEUE_ROUNDS = """  while (__syncthreads_or(L.k >= 0)) {
    int slot = -1;
    if (L.k >= 0) {
      const Ray q = to_object(g.w2o + 12 * L.k, L.r);
      slot = atomicAdd(&n_items, 1);
      item_o[slot] = make_float4(q.ox, q.oy, q.oz, L.t_best);
      item_d[slot] = make_float4(q.dx, q.dy, q.dz, ray_slack(q));
    }
    __syncthreads();
    const int items = n_items;
    for (int it = warp; it < items; it += kThreads / 32) {
      const float4 a = item_o[it], b = item_d[it];
      Ray q{};
      q.ox = a.x, q.oy = a.y, q.oz = a.z, q.dx = b.x, q.dy = b.y, q.dz = b.z, q.kd = b.w;
      const unsigned long long key = scan_prototype<kAnyHit, kPlace >= kRows>(g, rows, q, a.w);
      if ((threadIdx.x & 31) == 0) item_key[it] = key;
    }
    __syncthreads();
    if (threadIdx.x == 0) n_items = 0;
    if (slot >= 0) L.take(g, item_key[slot]);
    L.next(g, boxes, __ballot_sync(kFullMask, slot >= 0));
  }
"""
_WARP_ROUNDS = """\
  for (unsigned holders; (holders = __ballot_sync(kFullMask, L.k >= 0)) != 0;) {
    Ray q = L.k >= 0 ? to_object(g.w2o + 12 * L.k, L.r) : Ray{};
    q.kd = ray_slack(q);
    theia::for_each_holder(holders, [&](int h) {
      Ray qh = theia::shfl_ray(q, h);
      qh.kd = __shfl_sync(kFullMask, q.kd, h);
      const unsigned long long key = scan_prototype<kAnyHit, kPlace >= kRows>(
          g, rows, qh, __shfl_sync(kFullMask, L.t_best, h));
      if ((threadIdx.x & 31) == h) L.take(g, key);
    });
    L.next(g, boxes, holders);
  }
"""
#: the BVH's node step with node + 1's rows loaded while node's box is
#: tested (where the segment enters an interior node the walk goes there)
_NODE_LOADS = """\
      const float4 a = ld<kSharedNodes>(nodes + 2 * node), b = ld<kSharedNodes>(nodes + 2 * node + 1);
"""
_NODE_LOADS_AHEAD = """\
      if (!loaded) a = ld<kSharedNodes>(nodes + 2 * node), b = ld<kSharedNodes>(nodes + 2 * node + 1);
      const bool more = node + 1 < n_nodes;
      const float4 a1 = more ? ld<kSharedNodes>(nodes + 2 * node + 2) : a;
      const float4 b1 = more ? ld<kSharedNodes>(nodes + 2 * node + 3) : b;
"""
_NODE_NEXT = """\
      node = (hit && link < 0) ? node + 1 : __float_as_int(b.z);
"""
#: measurement builds of the walks: (source, its (text, replacement)
#: patches, the walk they change); their results are the package's
WALK_BUILDS = {
    "bvh blocks of 512 threads only": (
        "bvh_walk.cu", (("const bool use_large = ", "const bool use_large = false && "),), "bvh"),
    "bvh node cap 4": ("bvh_walk.cu", (("kNodeCap = 8;", "kNodeCap = 4;"),), "bvh"),
    "bvh node cap 16": ("bvh_walk.cu", (("kNodeCap = 8;", "kNodeCap = 16;"),), "bvh"),
    "bvh warps take 32 rays when all their lanes are done": ("bvh_walk.cu", ((
        "    const bool want = !drained && i < 0;\n",
        "    const bool idle = __all_sync(kFullMask, i < 0);\n"
        "    const bool want = !drained && i < 0 && idle;\n"),), "bvh"),
    "bvh with node + 1's rows loaded ahead": ("bvh_walk.cu", (
        ("  while (true) {\n", "  float4 a, b;\n  bool loaded = false;\n  while (true) {\n"),
        (_NODE_LOADS, _NODE_LOADS_AHEAD),
        (_NODE_NEXT, "      loaded = more && hit && link < 0;\n" + _NODE_NEXT + "      a = a1, b = b1;\n"),
    ), "bvh"),
    "instanced pairs each warp's own": ("instanced_walk.cu", ((_QUEUE_ROUNDS, _WARP_ROUNDS),), "instanced"),
    "instanced box scans lane by lane": ("instanced_walk.cu", ((
        "    L.next(g, boxes, __ballot_sync(kFullMask, slot >= 0));",
        "    if (slot >= 0) next_candidate<(kPlace >= kBoxes)>(g, boxes, L.r, L.ix, L.iy, L.iz, L.neg_inv_d2,"
        " L.bound(), L.tn, L.k);"),), "instanced"),
    "instanced without the rejection test": (
        "instanced_walk.cu", (("pass = !theia::MollerTrumbore::reject(q, w);", "pass = true;"),), "instanced"),
    "instanced 256 threads a block": ("instanced_walk.cu", (("kThreads = 512;", "kThreads = 256;"),), "instanced"),
    "instanced 1024 threads a block": ("instanced_walk.cu", (
        ("kThreads = 512;", "kThreads = 1024;"), ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")),
        "instanced"),
}


class WalkCalls:
    """One walk entry point (``name``, of ``chip_smoke.WALK_KERNELS``) of
    ``lib`` on fixed queries over ``pack`` (a scene pack's ``instanced``
    or ``bvh``): ``run()`` launches it on each query as the wrapper does
    (the instanced walk's running hit reset from t_max first), ``results()``
    gives the outputs; ``old`` takes the walks' first C interface (the prototype as
    ``tri``, no placement, no slot)."""

    def __init__(self, lib, name: str, pack, queries, old: bool) -> None:
        self.lib, self.name, self.pack, self.queries, self.old = lib, name, pack, queries, old
        any_hit = name.startswith("occluded")
        if name.endswith("instanced"):
            self.entry = "theia_instanced_occluded" if any_hit else "theia_instanced_nearest"
            self.outs = [(torch.empty_like(q[2]), torch.empty(q[2].shape, dtype=torch.int32, device="cuda"))
                         for q in queries]
        else:
            self.entry = "theia_bvh_occluded" if any_hit else "theia_bvh_nearest"
            self.outs = [(torch.empty(q[2].shape, dtype=torch.bool, device="cuda"),) if any_hit else
                         (torch.empty_like(q[2]), torch.empty(q[2].shape, dtype=torch.int32, device="cuda"))
                         for q in queries]

    def run(self):
        from theia_tpu_torch.ops import bvh_traverse, instanced

        fn, stream = getattr(self.lib, self.entry), _build.raw_stream(self.queries[0][0])
        for (o, d, t_max), outs in zip(self.queries, self.outs):
            n = o.shape[0]
            if self.entry.startswith("theia_instanced"):
                outs[0].copy_(t_max)
                outs[1].fill_(-1)
                for g in self.pack.groups:
                    place = () if self.old else (instanced.placement(g),)
                    table = g.tri if self.old else g.rows
                    _build.check(fn(o.data_ptr(), d.data_ptr(), table.data_ptr(), g.v0.shape[0], g.w2o.data_ptr(),
                                    g.boxes.data_ptr(), int(g.sph is not None), g.base.data_ptr(), g.base.shape[0],
                                    g.box[0].numel(), *place, n, outs[0].data_ptr(), outs[1].data_ptr(), stream),
                                 self.entry)
            else:
                p = self.pack
                extra = () if self.old else (p.tri.shape[0], bvh_traverse.leaf_slot(p.leaf_size),
                                             bvh_traverse.placement(p))
                _build.check(fn(o.data_ptr(), d.data_ptr(), t_max.data_ptr(), p.nodes.data_ptr(), p.tri.data_ptr(),
                                p.order.data_ptr(), p.nodes.shape[0], *extra, n, *(a.data_ptr() for a in outs),
                                stream), self.entry)

    def results(self):
        self.run()
        torch.cuda.synchronize()
        if self.entry == "theia_instanced_occluded":
            return [outs[1] >= 0 for outs in self.outs]
        return [a.clone() for outs in self.outs for a in outs]


def _walk_cases() -> dict:
    """The walks' timing cases (see ``walk-builds``): kind -> label ->
    (scene pack, nearest-hit queries)."""
    mesh = icosphere(3)
    array = build_array(theia_tpu_torch, mesh, chip_smoke.BATCH, chip_smoke.ARRAY_PATH, device="cuda")
    flagship = build_flagship(theia_tpu_torch, mesh, chip_smoke.BATCH, chip_smoke.MAX_PATH, accel="bvh", device="cuda")
    rays = lambda sp, seed: [chip_smoke.walk_rays(sp, chip_smoke.BATCH, seed)]
    sweep = {kind: build_array(theia_tpu_torch, mesh, 1, 2, accel=kind, device="cuda", n_side=5).scene.pack
             for kind in ("instanced", "bvh")}
    sweep_rays = [tuple(torch.as_tensor(a, device="cuda") for a in array_rays(chip_smoke.SWEEP_RAYS, 105, 5))]
    nodes_only = chip_smoke.walk_cases("bvh")["the tests' 27-module array"][0]().pack
    return {
        "instanced": {
            f"random rays N={chip_smoke.BATCH}": (array.scene.pack, rays(array.scene.pack, 5)),
            "flagship-array's 8 recorded queries": (
                array.scene.pack, chip_smoke.walk_queries(array, "nearest_triangle_instanced")),
            f"the sweep's 124 modules, {chip_smoke.SWEEP_RAYS} rays": (sweep["instanced"], sweep_rays),
        },
        "bvh": {
            f"random rays N={chip_smoke.BATCH}": (flagship.scene.pack, rays(flagship.scene.pack, 5)),
            "flagship-bvh's 19 recorded queries": (
                flagship.scene.pack, chip_smoke.walk_queries(flagship, "nearest_triangle_bvh")),
            f"the tests' 27-module array (nodes placed), {chip_smoke.SWEEP_RAYS} rays": (
                nodes_only, [chip_smoke.case_rays(nodes_only, chip_smoke.SWEEP_RAYS, 7)]),
            f"the sweep's 124 modules, {chip_smoke.SWEEP_RAYS} rays": (sweep["bvh"], sweep_rays),
        },
    }


def _walk_queries(name: str, scene_pack, queries) -> list:
    """The queries of entry point ``name``: the any-hits bounded at half
    the nearest hit."""
    if not name.startswith("occluded"):
        return queries
    return chip_smoke.anyhit_queries(chip_smoke.Walk(name.replace("occluded", "nearest_triangle"), scene_pack), queries)


def _walk_turns(base_lib, lib, cases, names, label: str, old: bool = False) -> dict:
    """``lib``'s walks against the package's (``base_lib``) in turns on
    ``cases``: results equal first, then base, lib, lib, base."""
    out = {}
    for name in names:
        kind = "instanced" if name.endswith("instanced") else "bvh"
        for case, (scene_pack, queries) in cases[kind].items():
            pack = getattr(scene_pack, kind)
            qs = _walk_queries(name, scene_pack, queries)
            base, other = WalkCalls(base_lib, name, pack, qs, False), WalkCalls(lib, name, pack, qs, old)
            assert all(torch.equal(a, b) for a, b in zip(base.results(), other.results())), (label, name, case)
            t = _in_turns(base, other, "run", 5 if len(qs) > 1 else 20)
            out[f"{name}, {case}"] = t
            print(f"walk {name}, {case}: package {t['old_queued_ms'][0]:.4f} / {t['old_queued_ms'][1]:.4f} ms, "
                  f"{label} {t['new_queued_ms'][0]:.4f} / {t['new_queued_ms'][1]:.4f} ms queued (package, "
                  f"{label}, {label}, package); as called {t['old_ms'][0]:.4f} / {t['old_ms'][1]:.4f} against "
                  f"{t['new_ms'][0]:.4f} / {t['new_ms'][1]:.4f}", flush=True)
    return out


class _Permuted:
    """The package's instanced nearest hit on rays as they come (``base``)
    and on the same rays permuted (``other``), for ``_in_turns``."""

    def __init__(self, lib, pack, rays, perm) -> None:
        self.base = WalkCalls(lib, "nearest_triangle_instanced", pack, [rays], False)
        self.other = WalkCalls(lib, "nearest_triangle_instanced", pack, [tuple(r[perm].contiguous() for r in rays)],
                               False)


def _balance(cases) -> dict:
    """The instanced nearest hit with the lanes dealt so that each warp
    holds as many candidates as the others (the lanes sorted by their
    candidates, dealt round-robin to the warps), and sorted by them, each
    in turns with the rays as they come."""
    from theia_tpu_torch.ops import instanced

    lib, out = _build.library(), {}
    for case, (scene_pack, queries) in cases["instanced"].items():
        rays = queries[0]
        stats = {}
        instanced.nearest_triangle_instanced_plain(scene_pack.instanced, *rays, stats=stats)
        pairs = stats["lane_counts"][0][0].long()
        n = pairs.shape[0]
        assert n % 32 == 0, n
        order = torch.argsort(pairs, descending=True, stable=True)
        # the k-th lane of that order to warp k % warps: every warp takes one of each 'warps' ranks
        k = torch.arange(n, device="cuda")
        dealt = torch.empty_like(order)
        dealt[(k % (n // 32)) * 32 + k // (n // 32)] = order
        perms = {"dealt evenly": dealt, "sorted by candidates": order}
        for label, perm in perms.items():
            p = _Permuted(lib, scene_pack.instanced, rays, perm)
            t = _in_turns(p.base, p.other, "run", 20)
            per_warp = torch.nn.functional.pad(pairs[perm], (0, -n % 32)).view(-1, 32).sum(dim=1).float()
            out[f"{case}, {label}"] = dict(turns=t, warp_candidates_max_over_mean=float(per_warp.max() / per_warp.mean()))
            print(f"walk balance, {case}, {label}: as they come {t['old_queued_ms'][0]:.4f} / "
                  f"{t['old_queued_ms'][1]:.4f} ms, permuted {t['new_queued_ms'][0]:.4f} / {t['new_queued_ms'][1]:.4f} "
                  f"ms queued", flush=True)
    return out


def walk_builds(parent: Path | None) -> dict:
    """See ``walk-builds`` in the module's docstring."""
    base_lib = _build.library()
    cases = _walk_cases()
    names = tuple(chip_smoke.WALK_KERNELS)
    out = {"package ptxas": [x for x in _kernel_ptxas(base_lib.build_log, "walk")]}
    if parent is not None:
        old = _build.build(parent, (), OLD_WALK_SIGNATURES)
        out["parent"] = _walk_turns(base_lib, old, cases, names, "parent", old=True)
    for label, (source, patches, kind) in WALK_BUILDS.items():
        lib = patched_build(label, patches, source)
        out[label] = dict(ptxas=_kernel_ptxas(lib.build_log, "walk"), turns=_walk_turns(
            base_lib, lib, cases, [n for n in names if n.endswith(kind)], label))
    out["balance"] = _balance(cases)
    return out


#: the gamma draw's first C entry points: the rounds into one int
#: that the caller zeroes, the dims advanced by the caller
_U = ctypes.c_uint32
OLD_GAMMA_SIGNATURES = (
    ("theia_gamma_philox", (_U, _U, _U, _U, _U, _U, _P, _I, _P, _P, _I, _P, _P, _P)),
    ("theia_gamma_sobol", (_P, _I, _U, _U, _U, _U, _P, _I, _P, _P, _I, _P, _P, _P)),
    ("theia_track_sample", _build._SIGNATURES["theia_track_sample"]),
)
#: the gamma draw's one-launch form: a cooperative grid of resident blocks
#: takes the tiles in turn (round 1, then the tile's queue), meets at a
#: grid-wide barrier and writes the new dims itself
_GAMMA_BARRIER_KERNEL = """
__device__ unsigned barrier_count, barrier_generation;

template <class Gen>
__global__ void __launch_bounds__(kThreads) sample_gamma_barrier(
    Gen gen, const float* __restrict__ alpha, int alpha_stride, const int* __restrict__ stream,
    const int* __restrict__ dim, int n, float* __restrict__ out, int* __restrict__ dim_out,
    unsigned long long* sync, unsigned long long tag) {
  __shared__ Queue q;
  __shared__ int block_max;
  if (threadIdx.x == 0) block_max = 0;
  int adv = 0;
  for (int base = blockIdx.x * kThreads; base < n; base += gridDim.x * kThreads) {
    if (threadIdx.x == 0) q.count = 0;
    __syncthreads();
    if (base + threadIdx.x < n)
      adv = max(adv, first_round(gen, alpha, alpha_stride, stream, dim, base + threadIdx.x, out, q));
    __syncthreads();
    adv = max(adv, drain(gen, q, out));
    __syncthreads();
  }
  block_max_into(sync, tag, adv, &block_max);
  if (threadIdx.x == 0) {  // the barrier, self-resetting: the last block in moves the generation
    volatile unsigned* generation = &barrier_generation;
    const unsigned seen = *generation;
    __threadfence();
    if (atomicAdd(&barrier_count, 1u) == gridDim.x - 1) {
      barrier_count = 0;
      __threadfence();
      atomicAdd(&barrier_generation, 1u);
    } else {
      while (*generation == seen) {
      }
    }
    __threadfence();
    block_max = static_cast<int>(atomicAdd(sync, 0ull) & 0xffffffffu);
  }
  __syncthreads();
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) dim_out[i] = dim[i] + block_max;
}

template <class Gen>
int launch(Gen gen,"""
_GAMMA_BARRIER_LAUNCH = """
  static int resident = 0;  // the card's resident blocks, asked once (one card)
  if (resident == 0) {
    int per_sm = 0, sms = 0, device = 0;
    cudaGetDevice(&device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sample_gamma_barrier<Gen>, kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    resident = per_sm * sms;
  }
  void* args[] = {&gen, &alpha, &alpha_stride, &stream, &dim, &n, &out, &dim_out, &sync, &tag};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(sample_gamma_barrier<Gen>),
                                                      dim3(tiles < resident ? tiles : resident), dim3(kThreads),
                                                      args, 0, cuda_stream));"""
_GAMMA_PHILOX_LANE = "return theia::philox_keyed(key, base, d); }"
_GAMMA_KERNEL = "__global__ void __launch_bounds__(kThreads) sample_gamma("
#: measurement builds of the package's K1 and K2: (kind, source, patches of
#: that source in ``csrc``), each patch a (text, replacement) pair
GAMMA_TRACK_BUILDS = {
    "gamma: one cooperative launch, a persistent grid and a barrier": ("gamma", "gamma.cu", (
        ("template <class Gen>\nint launch(Gen gen,", _GAMMA_BARRIER_KERNEL),
        ("  sample_gamma<Gen><<<tiles, kThreads, 0, cuda_stream>>>(", _GAMMA_BARRIER_LAUNCH
         + "\n  sample_gamma<Gen><<<tiles, kThreads, 0, cuda_stream>>>("))),
    "gamma: the second launch not a programmatic dependent": ("gamma", "gamma.cu", ((
        "programmaticStreamSerializationAllowed = 1;", "programmaticStreamSerializationAllowed = 0;"),)),
    "gamma: no queue, a lane's own rounds": ("gamma", "gamma.cu", ((
        "  const int s = atomicAdd(&q.count, 1);",
        "  return finish(lane, d, 1, k, out + i);\n  const int s = atomicAdd(&q.count, 1);"),)),
    "gamma: Philox's key set up for every draw": ("gamma", "gamma.cu", ((
        _GAMMA_PHILOX_LANE, "return theia::philox_draw(base, idx, d); }"),)),
    "gamma: the scale's pow only in a warp with a small alpha": ("gamma", "gamma.cu", ((
        "k.scale = small ? powf(u0, 1.0f / fmaxf(a, 1e-6f)) : 1.0f;",
        "k.scale = __any_sync(__activemask(), small) ? (small ? powf(u0, 1.0f / fmaxf(a, 1e-6f)) : 1.0f) : 1.0f;"),)),
    "gamma: a hash for each draw, no Philox (results wrong)": ("gamma", "gamma.cu", ((
        _GAMMA_PHILOX_LANE, "return theia::uniform_from_bits((d * 0x9E3779B9u) ^ idx); }"),)),
    "gamma: the rounds' logs, exp and divisions approximate (results wrong)": ("gamma", "gamma.cu", (
        ("const float v = logf(u1 / (1.0f - u1)) / k.lam;",
         "const float v = __fdividef(__logf(__fdividef(u1, 1.0f - u1)), k.lam);"),
        ("*x = k.a_eff * expf(v);", "*x = k.a_eff * __expf(v);"),
        ("return k.b + k.c * v - *x >= logf(u1 * u1 * u2);", "return k.b + k.c * v - *x >= __logf(u1 * u1 * u2);"))),
    "gamma: 6 blocks an SM": ("gamma", "gamma.cu", ((
        _GAMMA_KERNEL, "__global__ void __launch_bounds__(kThreads, 6) sample_gamma("),)),
    "gamma: 8 blocks an SM": ("gamma", "gamma.cu", ((
        _GAMMA_KERNEL, "__global__ void __launch_bounds__(kThreads, 8) sample_gamma("),)),
    **{f"track: a list of {m}": ("track", "cherenkov_track.cu", ((
        "constexpr int kList = 16;", f"constexpr int kList = {m};"),)) for m in (8, 4)},
    **{f"track: tiles of {rows} rows": ("track", "cherenkov_track.cu", ((
        "constexpr int kTile = 256;", f"constexpr int kTile = {rows};"),)) for rows in (128, 512)},
}


class GammaCalls:
    """``sample_gamma``'s calls ((alpha, rng) pairs) through one library's
    C entry points, each with its commit's wrapper work: ``old`` (the first)
    zeroes an int, launches and adds the int to the dims in torch; the
    package's keeps one tagged word for its calls and calls its C entry point once.
    ``draw()`` runs every call once."""

    def __init__(self, lib, calls, old: bool) -> None:
        from theia_tpu_torch.random import SobolState, _MASK, _SHUFFLE_SALT, _byte_table, _hash32

        self.lib, self.old, self.calls = lib, old, calls
        self.stream = torch.cuda.current_stream().cuda_stream
        self.sync, self.tag = torch.zeros(1, dtype=torch.int64, device="cuda"), 0
        self.heads, self.dims = [], []
        for alpha, rng in calls:
            n = rng.stream.shape[0]
            a = torch.as_tensor(alpha, dtype=torch.float32, device="cuda")
            a, stride = (a.reshape(1).contiguous(), 0) if a.numel() == 1 else (a.contiguous(), 1)
            out = torch.empty(n, device="cuda")
            if isinstance(rng, SobolState):
                seed = int(rng.seed) & _MASK
                fn, gen = lib.theia_gamma_sobol, (_byte_table(rng.dirs).data_ptr(), rng.dirs.shape[0], seed,
                                                   _hash32(seed ^ _SHUFFLE_SALT), _hash32(seed), int(rng.offset) & _MASK)
            else:
                fn, gen = lib.theia_gamma_philox, (*(int(k) & _MASK for k in rng.key),
                                                    *(int(c) & _MASK for c in rng.counter))
            self.heads.append((fn, gen, (a.data_ptr(), stride, rng.stream.data_ptr(), rng.dim.data_ptr(), n,
                                         out.data_ptr()), rng.dim, out, a))

    def draw(self):
        self.dims = []
        for fn, gen, lanes, dim, out, _ in self.heads:
            if self.old:
                advance = torch.zeros(1, dtype=torch.int32, device="cuda")
                _build.check(fn(*gen, *lanes, advance.data_ptr(), self.stream), "old sample_gamma")
                self.dims.append(dim + advance)
            else:
                new_dim = torch.empty_like(dim)
                self.tag += 1
                _build.check(fn(*gen, *lanes, new_dim.data_ptr(), self.sync.data_ptr(), self.tag, self.stream),
                             "sample_gamma")
                self.dims.append(new_dim)

    def result(self):
        self.draw()
        torch.cuda.synchronize()
        return [(h[4].clone(), d.clone()) for h, d in zip(self.heads, self.dims)]


class TrackCalls:
    """``track_backward_sample``'s calls through one library's C entry
    point (the same since the first kernel): ``sample()`` runs every call once."""

    def __init__(self, lib, calls) -> None:
        self.fn, self.stream, self.args = lib.theia_track_sample, torch.cuda.current_stream().cuda_stream, []
        for seg, observer, normal, ft, cot, u in calls:
            n = observer.shape[0]
            outs = (torch.empty(n, device="cuda"), torch.empty(n, dtype=torch.int32, device="cuda"),
                    torch.empty_like(observer), torch.empty_like(observer), torch.empty(n, device="cuda"))
            self.args.append(((seg.data_ptr(), seg.shape[0], observer.data_ptr(), normal.data_ptr(), ft.data_ptr(),
                               cot.data_ptr(), u.data_ptr(), n, *(o.data_ptr() for o in outs), self.stream), outs))

    def sample(self):
        for args, _ in self.args:
            _build.check(self.fn(*args), "track_sample")

    def result(self):
        self.sample()
        torch.cuda.synchronize()
        return [tuple(o.clone() for o in outs) for _, outs in self.args]


def _bits_equal(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for p, q in zip(a, b) for x, y in zip(p, q))


def gamma_track_cases() -> tuple[dict, dict]:
    """K1's and K2's timing cases: label -> calls. The recorded calls of
    one batch of each phase 3m run that makes them
    (``chip_smoke.cherenkov_path_calls``), the 2^20-lane synthetic calls
    (``chip_smoke.gamma_cases``, ``chip_smoke.track_case`` at 256 and 2
    segments), and at 2^16 lanes the gamma's mixed rounds and the track's
    zigzag and edge lanes (``chip_smoke.gamma_mixed_case``,
    ``chip_smoke.track_rule_cases``)."""
    gamma_paths, track_paths = chip_smoke.cherenkov_path_calls()
    gamma = dict(gamma_paths)
    gamma.update({f"synthetic, 2^20 lanes, {gen}": [call] for gen, call in chip_smoke.gamma_cases(1 << 20).items()})
    gamma["mixed rounds, 2^16 lanes, philox"] = [chip_smoke.gamma_mixed_case(1 << 16)["philox"]]
    track = dict(track_paths)
    track.update({f"synthetic, 2^20 lanes, {s} segments": [chip_smoke.track_case(1 << 20, s, s)] for s in (256, 2)})
    rules = chip_smoke.track_rule_cases(1 << 16)
    track.update({f"{label}, 2^16 lanes": [rules[label]] for label in ("zigzag, 300 segments", "edge lanes")})
    return gamma, track


def _gamma_track_turns(kind: str, base_lib, lib, cases: dict, label: str, base_old: bool = False) -> dict:
    """``kind``'s kernel of ``lib`` in turns with ``base_lib``'s on every case
    (base, build, build, base), the results held bit for bit first."""
    out = {}
    for name, calls in cases.items():
        if kind == "gamma":
            base, other = GammaCalls(base_lib, calls, base_old), GammaCalls(lib, calls, False)
            fn = "draw"
        else:
            base, other = TrackCalls(base_lib, calls), TrackCalls(lib, calls)
            fn = "sample"
        same = _bits_equal(base.result(), other.result())
        assert same or label.endswith("(results wrong)"), f"{label} differs from its base on {name}"
        # the first gamma wrapper enqueues a fill, a launch and an add a call: 40 calls stay inside the spin
        t = out[name] = _turns(base, other, fn, len(calls), reps=20)
        _print_turns(f"{kind} on {name} ({len(calls)} calls)", label, t)
    return out


def gamma_track_builds(parent: Path | None) -> dict:
    """See ``gamma-track-builds`` in the module's docstring."""
    gamma, track = gamma_track_cases()
    package = _build.library()
    out = {"package ptxas": _kernel_ptxas(package.build_log, "sample_gamma")
           + _kernel_ptxas(package.build_log, "track_sample")}
    if parent is not None:
        old = _build.build(parent, (), OLD_GAMMA_SIGNATURES)
        out["the parent (base) against the package (build)"] = dict(
            gamma=_gamma_track_turns("gamma", old, package, gamma, "package", base_old=True),
            track=_gamma_track_turns("track", old, package, track, "package"))
    for label, (kind, source, patches) in GAMMA_TRACK_BUILDS.items():
        lib = patched_build(label, patches, source)
        name = "sample_gamma" if kind == "gamma" else "track_sample"
        out[label] = dict(ptxas=_kernel_ptxas(lib.build_log, name), turns=_gamma_track_turns(
            kind, package, lib, gamma if kind == "gamma" else track, label))
        for line in out[label]["ptxas"]:
            print("   ", line)
    out["empty launch"] = chip_smoke.empty_launch_ms()
    print(f"empty launch: {out['empty launch']['queued_ms']:.4f} ms queued")
    return out


#: timed batches of each run in a ``cherenkov-turns`` process
CHERENKOV_REPS = 10
#: one process of ``cherenkov-turns``: seconds a batch of each run with the
#: package of the tree argv[1] (batch argv[2], argv[3] timed batches)
_CHERENKOV_CHILD = """
import json, sys, time
root, batch, reps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
sys.path[:0] = [root, root + "/tests"]
import torch
import theia_tpu_torch as P
from torch_flagship import build_cherenkov_backward, build_cherenkov_volume, cascade_source, track_line_source
assert P.__file__.startswith(root), P.__file__
runs = {
    "cherenkov-muon": lambda: build_cherenkov_volume(P, batch, "cuda", source="muon"),
    "cherenkov-cascade": lambda: build_cherenkov_volume(P, batch, "cuda", source="cascade"),
    "cascade-backward": lambda: build_cherenkov_backward(P, batch, "cuda", source=cascade_source(P)),
    "track-backward": lambda: build_cherenkov_backward(P, batch, "cuda", source=track_line_source(P, "track")),
    "track-backward, 256 segments": lambda: build_cherenkov_backward(
        P, batch, "cuda", source=track_line_source(P, "track", 256)),
}
out = {}
for label, build in runs.items():
    tracer = build()
    tracer.run()
    torch.cuda.synchronize()
    seconds = []
    for _ in range(reps):
        start = time.perf_counter()
        tracer.run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
    out[label] = seconds
    del tracer
    torch.cuda.empty_cache()
print("SECONDS " + json.dumps(out))
"""


def cherenkov_turns(parent: Path) -> dict:
    """See ``cherenkov-turns`` in the module's docstring: each run's
    seconds a batch (the median of its timed batches) in each turn."""
    turns = []
    for name, root in (("parent", parent), ("tree", ROOT), ("tree", ROOT), ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", _CHERENKOV_CHILD, str(root), str(chip_smoke.BATCH),
                               str(CHERENKOV_REPS)], cwd=root, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, f"{name} at {root}: {proc.stderr[-3000:]}"
        line = next(x for x in proc.stdout.splitlines() if x.startswith("SECONDS "))
        turns.append((name, json.loads(line[len("SECONDS "):])))
    out = {}
    for label in turns[0][1]:
        medians = [float(np.median(seconds[label])) for _, seconds in turns]
        out[label] = dict(parent_s=[medians[0], medians[3]], tree_s=[medians[1], medians[2]],
                          seconds=[seconds[label] for _, seconds in turns])
        print(f"{label}: seconds a batch, median of {CHERENKOV_REPS}, parent {medians[0]:.4f} / tree {medians[1]:.4f} "
              f"/ tree {medians[2]:.4f} / parent {medians[3]:.4f}")
    return out


def _profiled(label: str, step, plain_seconds: float) -> dict:
    """Trace one call of ``step`` and print where its device time went."""
    prof = chip_smoke.profile_step(step)
    print(f"{label}: {plain_seconds:.4f} s unprofiled, device busy {prof['device_busy_ms']:.2f} ms, "
          f"{prof['kernels']} kernels and copies")
    for entry in prof["top"] + prof["own"] + list(prof["kinds"].values()):
        print(f"    {entry['ms']:9.3f} ms  {entry['count']:6d} x  {entry['name'][:100]}")
    return dict(unprofiled_seconds=plain_seconds, **prof)


def _seconds(step) -> float:
    torch.cuda.synchronize()
    start = time.perf_counter()
    step()
    torch.cuda.synchronize()
    return time.perf_counter() - start


def profile() -> dict:
    mesh = icosphere(3)
    out = {}
    for label, kw in (("mt", {}), ("brute", dict(accel="auto")), ("woop polarized", dict(accel="woop", polarized=True))):
        tracer = build_flagship(
            theia_tpu_torch, mesh, chip_smoke.BATCH, chip_smoke.MAX_PATH, device="cuda", **kw
        )
        for _ in range(2):
            tracer.run()
        if kw.get("polarized"):
            out[label] = _profiled(f"{label}, one batch", tracer.run, _seconds(tracer.run))
        else:
            # the two segment routes in turns: the eager segment and the four kernels
            for k, staged in enumerate((False, True, True, False)):
                route = "stages" if staged else "eager"
                with contextlib.nullcontext() if staged else eager_route(tracer):
                    tracer.run()  # a warm-up on the route
                    out[f"{label}, {route}, turn {k + 1}"] = _profiled(
                        f"{label}, {route}, one batch", tracer.run, _seconds(tracer.run))
        if kw.get("polarized"):
            step = lambda: chip_smoke.absorption_grad(tracer)
            step()
            out[f"{label} gradient"] = _profiled(f"{label}, one gradient step", step, _seconds(step))
        del tracer
        torch.cuda.empty_cache()
    kde = lambda: KernelHistogramHitResponse(nBins=100, t0=0.0, binSize=5.0, bandwidth=5.0)
    for label, tracer, make in (
        ("volume gradient, absorption", build_volume_flagship(theia_tpu_torch, chip_smoke.BATCH, "cuda"),
         lambda t: chip_smoke.scale_step(t, "absorption_coef", float(np.log(1.35)))),
        ("volume gradient, group velocity",
         build_volume_flagship(theia_tpu_torch, chip_smoke.BATCH, "cuda", response=kde()),
         lambda t: chip_smoke.scale_step(t, "group_velocity", float(np.log(0.92)))),
        ("brute geometry gradient", build_flagship(theia_tpu_torch, mesh, chip_smoke.BATCH, chip_smoke.MAX_PATH,
                                                    accel="auto", device="cuda", response=kde()),
         chip_smoke.geometry_step),
    ):
        step = make(tracer)
        step()
        out[label] = _profiled(f"{label}, one step", step, _seconds(step))
        del tracer, step
        torch.cuda.empty_cache()
    volume = build_volume_flagship(theia_tpu_torch, chip_smoke.BATCH, "cuda")
    photon = build_photon_flagship(theia_tpu_torch, mesh, chip_smoke.BATCH, "cuda")
    compacted = lambda: photon.run_compacted(min_lanes=chip_smoke.PHOTON_MIN_LANES)
    for label, step in (("volume", volume.run), ("photon run", photon.run), ("photon run_compacted", compacted)):
        for _ in range(2):
            step()
        out[label] = _profiled(f"{label}, one batch", step, _seconds(step))
    return out


def _sharded_rank(rank: int, ranks: int, url: str, out: str) -> None:
    """One rank of ``sharded``: its card, its block of the lanes."""
    from theia_tpu_torch import parallel
    from theia_tpu_torch.pipeline import Pipeline

    parallel.initialize(url, ranks, rank, backend="nccl")
    try:
        mesh = parallel.make_photon_mesh()
        tracer = build_flagship(theia_tpu_torch, icosphere(3), ranks * chip_smoke.BATCH, chip_smoke.MAX_PATH,
                                accel="auto", device=mesh.device)
        tracer._debug_rng = True
        with torch.no_grad():
            state, _, dims = parallel.shard_trace(tracer, mesh)(
                tracer.params(), tracer.rng.counter_words, parallel.sharded_streams(tracer.capacity, mesh))
        tracer._debug_rng = False
        pipe = Pipeline(tracer, runner=parallel.ShardedRunner(tracer))
        seconds, curves = _schedules(pipe, tracer)
        x = torch.zeros(100, device=mesh.device)
        reduce_ms = chip_smoke.cuda_ms(lambda: torch.distributed.all_reduce(x), 200)
        torch.save(dict(device=str(mesh.device), state=state.cpu(), dims=dims.cpu(), seconds=seconds, curves=curves,
                        all_reduce_ms=reduce_ms), Path(out) / f"rank-{rank}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def _schedules(pipe, tracer) -> tuple[dict, list]:
    """Seconds a batch of ``SHARDED_BATCHES``-batch schedules of ``pipe``,
    synchronous and threaded in turns after a warm-up, and the light
    curves of the first synchronous one."""
    from theia_tpu_torch.pipeline import PipelineScheduler

    seconds, first = {"sync": [], "threaded": []}, None
    for mode in ("sync", "sync", "threaded", "threaded", "sync"):
        tracer.rng.offset = 0
        curves = []
        torch.cuda.synchronize()
        start = time.perf_counter()
        PipelineScheduler(pipe, processFn=lambda c, b, r: curves.append(r[0]),
                          dispatchThread=mode == "threaded").schedule([{}] * chip_smoke.SHARDED_BATCHES)
        torch.cuda.synchronize()
        if first is None:
            first = curves  # the warm-up
        else:
            seconds[mode].append((time.perf_counter() - start) / chip_smoke.SHARDED_BATCHES)
    return seconds, first


def sharded(ranks: int) -> dict:
    """``sharded``: see the module docstring."""
    import statistics
    import tempfile

    import torch.multiprocessing as mp

    from theia_tpu_torch.pipeline import Pipeline

    smis = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    assert torch.cuda.device_count() >= ranks, (torch.cuda.device_count(), ranks)
    ctx = mp.get_context("spawn")
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_sharded_rank, args=(r, ranks, f"file://{tmp}/rendezvous", tmp))
                 for r in range(ranks)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + chip_smoke.RANK_TIMEOUT
        for proc in procs:
            proc.join(timeout=max(deadline - time.monotonic(), 1.0))
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        codes = [proc.exitcode for proc in procs]
        assert codes == [0] * ranks, f"the ranks exited with {codes}"
        got = [torch.load(Path(tmp) / f"rank-{r}.pt", weights_only=False) for r in range(ranks)]
    ranks_seconds = time.perf_counter() - start
    tracer = build_flagship(theia_tpu_torch, icosphere(3), ranks * chip_smoke.BATCH, chip_smoke.MAX_PATH,
                            accel="auto", device="cuda:0")
    tracer._debug_rng = True
    with torch.no_grad():
        state, _, dims = tracer._trace_batch(tracer.params(), tracer.rng.counter_words, tracer.streams())
    tracer._debug_rng = False
    seconds, curves = _schedules(Pipeline(tracer), tracer)
    per = chip_smoke.BATCH
    for r, g in enumerate(got):
        assert g["device"] == f"cuda:{r}", g["device"]
        assert torch.equal(g["dims"], dims[r * per:(r + 1) * per].cpu()), f"rank {r}'s RNG dims"
        assert torch.equal(g["state"].view(torch.int32), got[0]["state"].view(torch.int32))
    twin = chip_smoke.curves_twin("sharded against one card", [state.cpu().numpy()], [got[0]["state"].numpy()])
    curves_twin = chip_smoke.curves_twin("sharded schedule against one card's", curves, got[0]["curves"])
    med = {mode: statistics.median(v) for mode, v in seconds.items()}
    rank_med = {mode: statistics.median(v) for mode, v in got[0]["seconds"].items()}
    result = dict(
        ranks=ranks, lanes_a_rank=per, global_batch=ranks * per, smi=smis, seconds_with_start=ranks_seconds,
        one_card_seconds_per_batch=seconds, one_card_median=med,
        rank_seconds_per_batch=[g["seconds"] for g in got], rank0_median=rank_med,
        speedup={m: med[m] / rank_med[m] for m in med}, all_reduce_ms=[g["all_reduce_ms"] for g in got],
        state_twin=twin, curves_twin=curves_twin,
    )
    print(f"sharded: flagship-brute over {ranks} cards ({'; '.join(smis)}), {per} lanes a rank, global batch "
          f"{ranks * per}: every rank's RNG dims equal to one card's slice; the summed state within "
          f"{twin['max_rel']:.3g} of its largest bin, the schedules' curves within {curves_twin['max_rel']:.3g}; "
          f"s/batch (median) sync {rank_med['sync']:.4f} / threaded {rank_med['threaded']:.4f} on {ranks} cards "
          f"against {med['sync']:.4f} / {med['threaded']:.4f} on one card: x{result['speedup']['sync']:.2f} / "
          f"x{result['speedup']['threaded']:.2f}; an all-reduce of 100 bins "
          f"{[round(x, 4) for x in result['all_reduce_ms']]} ms; {ranks_seconds:.1f} s with the ranks' start")
    return result


def sort_turns(parent: Path) -> dict:
    """``sort-turns DIR``: the sort and scatter of ``parent`` in turns with
    the package's on flagship-array's recorded queries, then the binned
    query against the unbinned one in turns."""
    import re
    import shutil

    from theia_tpu_torch.ops import _intersect_tiles as tiles
    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt_rows
    from theia_tpu_torch.ops.intersect_woop import nearest_triangle_woop

    src = parent / "wavefront_sort.cu"
    copy = _build.BUILD_DIR / "sort_turns_parent"
    shutil.rmtree(copy, ignore_errors=True)
    copy.mkdir(parents=True)
    shutil.copy(src, copy / src.name)
    names = ("theia_wavefront_sort", "theia_wavefront_scatter")
    old_lib = _build.build(copy, (), tuple((k, _build._SIGNATURES[k]) for k in names))
    old_tile = int(re.search(r"constexpr int kTile = (\d+);", src.read_text()).group(1))
    new_lib = _build.library()
    wrappers = {k: v for k, v in (("sort_rays", tiles.sort_rays), ("scatter_back", tiles.scatter_back),
                                  ("nearest_triangle_mt_rows", nearest_triangle_mt_rows),
                                  ("nearest_triangle_woop", nearest_triangle_woop))}
    runs, kernels = {}, {"sort_rays": {}, "scatter_back": {}}
    paths = chip_smoke.sort_path_runs(runs, wrappers, kernels, icosphere(3), _smi(), chip_smoke.BATCH)

    class Sort:
        """One library's sort and scatter on fixed calls."""

        def __init__(self, lib, tile, pack, queries, outs):
            self.lib, self.tile, self.pack, self.queries, self.outs = lib, tile, pack, queries, outs
            lo, span = tiles._grid(pack.lo, pack.hi)
            self.grid = (*map(float, lo), *map(float, span))
            self.sorted = [self._sort(*q) for q in queries]

        def _sort(self, o, d, t):
            n = o.shape[0]
            scratch = torch.empty(n + (-(-n // self.tile) + 1) * tiles.BIN_KEYS, dtype=torch.int32, device="cuda")
            out = (torch.empty(n, dtype=torch.int32, device="cuda"), torch.empty_like(o), torch.empty_like(d),
                   torch.empty_like(t))
            _build.check(self.lib.theia_wavefront_sort(
                o.data_ptr(), d.data_ptr(), t.data_ptr(), *self.grid, n, scratch[:n].data_ptr(),
                scratch[n:-tiles.BIN_KEYS].data_ptr(), scratch[-tiles.BIN_KEYS:].data_ptr(),
                *(x.data_ptr() for x in out), _build.raw_stream(o)), "sort")
            return (scratch[:n], *out)

        def sort(self):
            for q in self.queries:
                self._sort(*q)

        def scatter(self):
            for (_, order, *_), outs in zip(self.sorted, self.outs):
                back = [torch.empty_like(x) for x in outs]
                rows = len(outs) == 3
                _build.check(self.lib.theia_wavefront_scatter(
                    order.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr() if rows else None,
                    order.shape[0], back[0].data_ptr(), back[1].data_ptr(), back[2].data_ptr() if rows else None,
                    _build.raw_stream(order)), "scatter")
            return back

    out = {}
    for label, (pack, query, queries) in paths.items():
        outs = [query(o, d, t, False) for o, d, t in queries]
        old, new = (Sort(lib, tile, pack, queries, outs) for lib, tile in ((old_lib, old_tile), (new_lib, tiles.SORT_TILE)))
        for a, b in zip(old.sorted, new.sorted):
            assert chip_smoke.same_sort(a, b) == 0, f"{label}: the two sorts differ"
        turns = {name: _in_turns(old, new, name, 20) for name in ("sort", "scatter")}
        q = {True: dict(ms=[], queued_ms=[]), False: dict(ms=[], queued_ms=[])}
        for binned in (False, True, True, False):
            calls = lambda: [query(o, d, t, binned) for o, d, t in queries]
            q[binned]["ms"].append(chip_smoke.cuda_ms(calls, 3) / len(queries))
            q[binned]["queued_ms"].append(chip_smoke.cuda_ms_queued(calls, 3) / len(queries))
        per_call = {name: {k: [v / len(queries) for v in vs] for k, vs in t.items()} for name, t in turns.items()}
        out[label] = dict(calls=len(queries), lanes=[x[0].shape[0] for x in queries], turns=per_call,
                          query_turns=dict(binned=q[True], unbinned=q[False]))
        for name, t in per_call.items():
            print(f"{label} {name}, ms a call (old, new, new, old): as called {t['old_ms'][0]:.4f} / "
                  f"{t['new_ms'][0]:.4f} / {t['new_ms'][1]:.4f} / {t['old_ms'][1]:.4f}, queued "
                  f"{t['old_queued_ms'][0]:.4f} / {t['new_queued_ms'][0]:.4f} / {t['new_queued_ms'][1]:.4f} / "
                  f"{t['old_queued_ms'][1]:.4f}")
        print(f"{label} query ms a call, binned {q[True]} / unbinned {q[False]} (unbinned, binned, binned, unbinned)")
        # the package's three sort kernels and the scatter, each kernel's device time a call (torch.profiler)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            new.sort()
            new.scatter()
            torch.cuda.synchronize()
        kernels = {e.key: e.device_time_total / 1000.0 / len(queries) for e in prof.key_averages()
                   if any(k in e.key for k in ("count_keys", "scan_columns", "scatter_rays", "scatter_back"))}
        out[label]["kernel_ms"] = kernels
        print(f"{label}: device ms a call by kernel (profiler) " + ", ".join(f"{k.split('(')[0]} {v:.4f}"
                                                                           for k, v in kernels.items()))
    out["runs"] = runs
    return out


#: measurement builds of the ordered records and the sort (patches of
#: several files: (file, text, replacement), each text found once): the
#: designs they replaced or lost to, timed in turns with the package's
_WAIT = '''__device__ __forceinline__ void wait_for_previous() { asm volatile("griddepcontrol.wait;" ::: "memory"); }'''
_MASK_FIRST = '''    if (!__any_sync(ordered::kAll, any)) return;
    float t[kRows], v[kRows];
    int det[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = first + 32 * r + lane;
      const bool live = i < in.n;
      t[r] = live ? in.time[i] : 0.0f;
      v[r] = live ? value[i] : 0.0f;
      det[r] = live && in.n_det > 0 ? in.object_id[i] : 0;
    }'''
_ONE_ROUND = '''    float t[kRows], v[kRows];
    int det[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = first + 32 * r + lane;
      const bool live = i < in.n;
      t[r] = live ? in.time[i] : 0.0f;
      v[r] = live ? value[i] : 0.0f;
      det[r] = live && in.n_det > 0 ? in.object_id[i] : 0;
    }
    if (!__any_sync(ordered::kAll, any)) return;'''
_ACQ_REL = '''  return cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(counter).fetch_add(
      v, cuda::memory_order_acq_rel);'''
_KDE_WEIGHT = "          const float w = kde_exp(-0.5f * (z * z)) * norm;"
_KDE_SOURCE = "// the record's items: each kept lane's pairs (flat bin, value * w)\n"
#: the KDE weights' exp in double products and sums (a Taylor polynomial to
#: r^13 / 13!), this PR's first form
_KDE_EXP64 = """// exp(x) rounded to float from a double: n = rint(x / ln 2), r = x - n ln 2
// in two parts, e^r by its Taylor polynomial in Horner's form, times 2^n
constexpr double kInvLn2 = 1.4426950408889634;
constexpr double kLn2Hi = 0.6931471803691238;
constexpr double kLn2Lo = 1.9082149292705877e-10;

__device__ __forceinline__ float kde_exp64(float x) {
  constexpr double kC[14] = {1.0, 1.0, 0.5, 0.16666666666666666, 0.041666666666666664, 0.008333333333333333,
                             0.001388888888888889, 0.0001984126984126984, 2.48015873015873e-05,
                             2.7557319223985893e-06, 2.755731922398589e-07, 2.505210838544172e-08,
                             2.08767569878681e-09, 1.6059043836821613e-10};
  const double d = static_cast<double>(x);
  if (d < -110.0) return 0.0f;  // below float32's least subnormal
  const double n = rint(d * kInvLn2);
  const double r = (d - n * kLn2Hi) - n * kLn2Lo;
  double p = kC[13];
#pragma unroll
  for (int k = 12; k >= 0; --k) p = p * r + kC[k];
  const double scale = __longlong_as_double((static_cast<long long>(n) + 1023) << 52);
  return __double2float_rn(p * scale);
}

"""
RECORD_BUILDS = {
    "dependents triggered at the wait (early)": [
        ("launch.cuh", _WAIT, _WAIT.replace('asm volatile("griddepcontrol.wait;"',
                                            'asm volatile("griddepcontrol.launch_dependents;");\n  asm volatile("griddepcontrol.wait;"'))],
    "plain launches, no dependents": [("launch.cuh", "  config.numAttrs = 1;", "  config.numAttrs = 0;")],
    "a round of loads with the masks": [("histogram.cu", _MASK_FIRST, _ONE_ROUND)],
    "fences around relaxed adds": [("ordered_sum.cuh", _ACQ_REL,
                                    "  __threadfence();\n  const unsigned long long old = atomicAdd(&counter, v);\n"
                                    "  __threadfence();\n  return old;")],
    "spans of 8 rows (another order)": [("ordered_sum.cuh", "constexpr int kRowsPerSpan = 4;",
                                         "constexpr int kRowsPerSpan = 8;")],
    "the kernel histogram's weights by expf (other bits)": [("kernel_histogram.cu", _KDE_WEIGHT,
                                                             _KDE_WEIGHT.replace("kde_exp(", "expf("))],
    "the kernel histogram's weights by an exp in double ops (other bits)": [
        ("kernel_histogram.cu", _KDE_SOURCE, _KDE_EXP64 + _KDE_SOURCE),
        ("kernel_histogram.cu", _KDE_WEIGHT, _KDE_WEIGHT.replace("kde_exp(", "kde_exp64(")),
    ],
}


def record_builds(words: str = "") -> dict:
    """``record-builds``: each of ``RECORD_BUILDS`` in turns with the package
    (package, build, build, package), queued, on a brute flagship batch's
    19 records, the mask-0.5 case of 524,288 lanes, the kernel histogram's
    40 recorded calls of the gradient paths, and the sort and scatter on
    flagship-array's recorded queries; the records' bits held against the
    package's where the build keeps the order."""
    import shutil

    from theia_tpu_torch.ops import _intersect_tiles as tiles
    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt_rows
    from theia_tpu_torch.ops.intersect_woop import nearest_triangle_woop
    from theia_tpu_torch.response import histogram_add, kernel_histogram_add

    libs = {}
    for label, patches in ((k, v) for k, v in RECORD_BUILDS.items() if words in k):
        copy = _build.BUILD_DIR / "patched" / ("records-" + "".join(c if c.isalnum() else "-" for c in label))
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(_build.CSRC, copy)
        for name, old, new in patches:
            text = (copy / name).read_text()
            assert text.count(old) == 1, f"{label}: {old!r} is not in {name} once"
            (copy / name).write_text(text.replace(old, new))
        libs[label] = _build.build(copy)
    mesh = icosphere(3)
    tracer = build_flagship(theia_tpu_torch, mesh, chip_smoke.BATCH, chip_smoke.MAX_PATH, accel="auto", device="cuda")
    tracer.run()
    records = chip_smoke.record_records(tracer)
    main = chip_smoke.hist_case(2 * chip_smoke.BATCH, 3)
    kde_calls = [c for calls in chip_smoke.kde_path_calls(mesh).values() for c in calls]
    wrappers = {"sort_rays": tiles.sort_rays, "scatter_back": tiles.scatter_back,
                "nearest_triangle_mt_rows": nearest_triangle_mt_rows, "nearest_triangle_woop": nearest_triangle_woop}
    paths = chip_smoke.sort_path_runs({}, wrappers, {"sort_rays": {}, "scatter_back": {}}, mesh, _smi(),
                                      chip_smoke.BATCH)
    state = torch.zeros(100, device="cuda")
    kde_state = torch.zeros(kde_calls[0][6] * (kde_calls[0][9] or 1), device="cuda")
    cases = {
        "19 brute records": (lambda: [histogram_add(state, *c) for c in records], 19),
        "record, mask 0.5, N=524288": (lambda: histogram_add(state, *main), 1),
        "kernel histogram, 40 path calls": (lambda: [kernel_histogram_add(kde_state, *c) for c in kde_calls], 40),
    }
    for label, (pack, query, queries) in paths.items():
        outs = [query(o, d, t, False) for o, d, t in queries]
        orders = [tiles.sort_rays(pack.lo, pack.hi, *q)[1] for q in queries]
        cases[f"sort, {label}"] = (lambda pack=pack, qs=queries: [tiles.sort_rays(pack.lo, pack.hi, *q) for q in qs],
                                   len(queries))
        cases[f"scatter, {label}"] = (lambda outs=outs, orders=orders: [tiles.scatter_back(o, *x)
                                                                        for o, x in zip(orders, outs)], len(queries))

    def curve():
        state.zero_()
        for c in records:
            histogram_add(state, *c)
        return state.clone()

    package, out = _build.library, {}
    try:
        want = curve()
        for label, lib in libs.items():
            row = out[label] = {}
            for which in ("package", "build", "build", "package"):
                _build.library = (lambda lib=lib: lib) if which == "build" else package
                for case, (fn, n) in cases.items():
                    row.setdefault(case, {}).setdefault(which, []).append(chip_smoke.cuda_ms_queued(fn, 10) / n)
            _build.library = lambda lib=lib: lib
            row["same bits as the package"] = bool(torch.equal(curve(), want))
            _build.library = package
            print(f"{label}: the batch's curve {'the same bits' if row['same bits as the package'] else 'other bits'}")
            for case, t in row.items():
                if isinstance(t, dict):
                    print(f"    {case}, queued ms a call: package {[round(x, 4) for x in t['package']]}, "
                          f"build {[round(x, 4) for x in t['build']]}")
    finally:
        _build.library = package
    return out


#: the records' entry points before the fixed order (float atomics, no
#: scratch)
OLD_RECORD_SIGNATURES = HIST_SIGNATURES + (("theia_kde_add", (_P,) * 7 + (_I,) * 4 + (_P, _P)),)


def record_turns(parent: Path) -> dict:
    """``record-turns DIR``: the records of ``parent`` in turns with the
    package's on a brute flagship batch, synthetic states of 100 to 64,000
    flat bins and the kernel histogram's cases."""
    import shutil

    copy = _build.BUILD_DIR / "record_turns_parent"
    shutil.rmtree(copy, ignore_errors=True)
    copy.mkdir(parents=True)
    for name in ("histogram.cu", "kernel_histogram.cu"):
        shutil.copy(parent / name, copy / name)
    old_lib, new_lib = _build.build(copy, (), OLD_RECORD_SIGNATURES), _build.library()
    mesh = icosphere(3)
    tracer = build_flagship(theia_tpu_torch, mesh, chip_smoke.BATCH, chip_smoke.MAX_PATH, accel="auto", device="cuda")
    tracer.run()
    n = 2 * chip_smoke.BATCH
    hist = {"19 records of a brute flagship batch": (chip_smoke.record_records(tracer), 20),
            "mask 0.5, 100 bins": ([chip_smoke.hist_case(n, 3)], 50)}
    for n_det in (1, 2, 4, 7, 15, 32, 64):
        hist[f"mask 0.5, {1000 * n_det} bins"] = ([chip_smoke.hist_case(n, 13, bins=1000, n_det=n_det)], 20)
    hist["mask 0.5, 64,000 bins of which 4 in use"] = ([chip_smoke.large_state_cases(n)[1]], 20)
    out = {}

    def report(what, label, calls, t):
        ratio = [x / min(t["old_queued_ms"]) for x in t["new_queued_ms"]]
        out[f"{what}, {label}"] = dict(t, calls=calls, queued_ratio=ratio)
        print(f"{what}, {label} ({calls} calls): queued ms old {t['old_queued_ms'][0]:.4f} / "
              f"{t['old_queued_ms'][1]:.4f}, new {t['new_queued_ms'][0]:.4f} / {t['new_queued_ms'][1]:.4f} "
              f"(new / old {ratio[0]:.2f}, {ratio[1]:.2f}); as called old {t['old_ms'][0]:.4f} / {t['old_ms'][1]:.4f}, "
              f"new {t['new_ms'][0]:.4f} / {t['new_ms'][1]:.4f} (old, new, new, old)")

    for label, (records, reps) in hist.items():
        old, new = HistCalls(old_lib, records), HistCalls(new_lib, records)
        (old_state, old_grad), (new_state, new_grad) = old.result(), new.result()
        scale = float(old_state.abs().max()) or 1.0
        torch.testing.assert_close(new_state, old_state, rtol=1e-4, atol=1e-4 * scale)
        assert torch.equal(new_grad, old_grad), f"{label}: old and new backward differ"
        report("histogram_add", label, len(records), _in_turns(old, new, "add", reps))
    kde = {"mask 0.5, 100 bins": [chip_smoke.kde_case(n, 3)], **chip_smoke.kde_path_calls(mesh)}
    for label, calls in kde.items():
        old, new = KdeAddCalls(old_lib, calls), KdeAddCalls(new_lib, calls)
        want, got = old.result(), new.result()
        scale = float(want.abs().max()) or 1.0
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
        report("kernel_histogram_add", label, len(calls), _in_turns(old, new, "add", max(1, 200 // len(calls))))
    # the package's record's kernels apart, device time under torch.profiler
    for label in ("mask 0.5, 100 bins", "mask 0.5, 2000 bins", "mask 0.5, 64000 bins"):
        calls = HistCalls(new_lib, hist[label][0])
        calls.add()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                calls.add()
            torch.cuda.synchronize()
        kernels = {e.key: e.device_time_total / 1000.0 / 20 for e in prof.key_averages() if e.device_time_total > 0}
        out[f"histogram_add kernels, {label}"] = kernels
        print(f"histogram_add kernels, {label}, device ms a record: "
              + ", ".join(f"{k[:60]} {v:.4f}" for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])))
    return out


#: the entry points of the backward kernels before they kept a fixed
#: order (float atomics; the commit before the ordered backward kernels)
ATOMIC_GRAD_SIGNATURES = (
    ("theia_table_read_grad", (_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P)),
    ("theia_gather_rows_grad", (_P, _P, _P, _I, _I, _I, _P, _P)),
    ("theia_kde_grad", (_P,) * 8 + (_I,) * 4 + (_P,) * 4),
)
#: the gradient runs whose steps ``grad-turns`` replays and times, written
#: against a tree's package P, its chip_smoke C and its tests' helpers F, so
#: that the parent's tree runs them too: label -> (a tracer, its step)
_GRAD_RUNS = """
def grad_runs(P, C, F, mesh):
    import numpy as np
    from theia_tpu_torch.response import KernelHistogramHitResponse

    kde = lambda: KernelHistogramHitResponse(nBins=100, t0=0.0, binSize=5.0, bandwidth=5.0)
    absorption = lambda t: (lambda: C.absorption_grad(t))
    return {
        "flagship-woop-pol-grad": (lambda: F.build_flagship(P, mesh, C.BATCH, C.MAX_PATH, accel="woop",
                                                            polarized=True, device="cuda"), absorption),
        "flagship-volume-grad, absorption": (lambda: F.build_volume_flagship(P, C.BATCH, "cuda"),
                                             lambda t: C.scale_step(t, "absorption_coef", float(np.log(1.35)))),
        "flagship-volume-grad, group velocity": (
            lambda: F.build_volume_flagship(P, C.BATCH, "cuda", response=kde()),
            lambda t: C.scale_step(t, "group_velocity", float(np.log(0.92)))),
        "flagship-brute-geom-grad": (lambda: F.build_flagship(P, mesh, C.BATCH, C.MAX_PATH, accel="auto",
                                                              device="cuda", response=kde()), C.geometry_step),
        "scene-backward-target-grad": (lambda: F.build_backward_eta2(P, C.BATCH, "cuda", mesh=mesh), C.index_step),
        "gloo-ranks-one-card's step in one process": (
            lambda: F.build_flagship(P, mesh, C.GRAD_BATCH, C.GRAD_PATH, accel="auto", device="cuda"), absorption),
    }
"""
#: one process of ``grad-turns``: seconds a step of each gradient run with
#: the package, chip_smoke and tests' helpers of the tree argv[1] (argv[2]
#: timed steps after one)
_GRAD_CHILD = """
import json, sys, time
root, reps = sys.argv[1], int(sys.argv[2])
sys.path[:0] = [root, root + "/tests"]
import torch
import chip_smoke as C
import theia_tpu_torch as P
import torch_flagship as F
assert P.__file__.startswith(root) and C.__file__.startswith(root), (P.__file__, C.__file__)
exec(sys.stdin.read())
out = {}
for label, (build, make) in grad_runs(P, C, F, F.icosphere(3)).items():
    step = make(build())
    step()
    torch.cuda.synchronize()
    seconds = []
    for _ in range(reps):
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
    out[label] = seconds
    del step
    torch.cuda.empty_cache()
print("SECONDS " + json.dumps(out))
"""
GRAD_STEP_REPS = 5


class AtomicGradCalls:
    """A step's recorded backward calls (``chip_smoke.record_grad_calls``)
    through the float-atomic entry points of ``lib``, as that commit's
    wrappers made them: the outputs' zero fills and the launch a call."""

    def __init__(self, lib, calls) -> None:
        from theia_tpu_torch import response
        from theia_tpu_torch.ops import table_read

        self.fns, stream = [], torch.cuda.current_stream().cuda_stream
        for kind, args, kw in calls:
            if kind == "read":
                reader, tables, _, _, handle, x, grad_out, need_tables, need_x = args
                need = [bool(n) and t is not None for n, t in zip(need_tables, tables)]
                rows = [None if g is None else g.contiguous() for g in grad_out] + [None] * (4 - len(tables))

                def call(reader=reader, tables=tables, handle=handle, x=x, rows=rows, need=need, need_x=need_x):
                    grads = [torch.zeros_like(t) if n else None for n, t in zip(need, tables)]
                    grad_x = torch.empty(x.shape, dtype=torch.float32, device=x.device) if need_x else None
                    if x.shape[0] and (need_x or any(need)):
                        _build.check(lib.theia_table_read_grad(
                            reader.spec_address, _ptr(handle), x.data_ptr(), x.stride(0), *map(_ptr, rows),
                            x.shape[0], *map(_ptr, grads + [None] * (4 - len(grads))), _ptr(grad_x), stream),
                            "theia_table_read_grad")
                    return (*grads, grad_x)
            elif kind == "gather":
                shape, index, grad_out, columns = args
                spans, spec = table_read._span_set(columns, shape[1])
                grads = table_read._gradients(spans, index, (grad_out,) if columns is None else tuple(grad_out))
                pointers = table_read._pointers(grads)

                def call(shape=shape, index=index, spec=spec, pointers=pointers, grads=grads):
                    grad = torch.zeros(shape, dtype=torch.float32, device=index.device)
                    if index.shape[0] and any(g is not None for g in grads):
                        _build.check(lib.theia_gather_rows_grad(ctypes.byref(spec), pointers, index.data_ptr(),
                                                                index.shape[0], shape[0], shape[1], grad.data_ptr(),
                                                                stream), "theia_gather_rows_grad")
                    return (grad,)
            else:
                grad_state, value, time_, mask, t0, bs, bw, bins, support, oid, n_det = args
                need_lanes, need_params = kw.get("need_lanes", True), kw.get("need_params", True)
                lanes = response._kde_args(time_, mask, oid, n_det, t0, bs, bw, bins, support)

                def call(grad_state=grad_state, value=value, time_=time_, lanes=lanes, need_lanes=need_lanes,
                         need_params=need_params):
                    out = (torch.empty_like(time_), torch.empty_like(time_)) if need_lanes else (None, None)
                    scalars = torch.zeros(3, device=time_.device) if need_params else None
                    if time_.shape[0] and (need_lanes or need_params):
                        _build.check(lib.theia_kde_grad(grad_state.data_ptr(), value.data_ptr(), *lanes,
                                                        *map(_ptr, (*out, scalars)), stream), "theia_kde_grad")
                    return (*out, *(scalars.unbind() if need_params else (None,) * 3))
            self.fns.append(call)

    def backward(self):
        return [f() for f in self.fns]


class PackageGradCalls:
    """The same calls through the package's wrappers."""

    def __init__(self, calls) -> None:
        self.fns = [chip_smoke.grad_call(*call) for call in calls]

    def backward(self):
        return [f() for f in self.fns]


def _agree(old, new, label: str) -> None:
    """The float-atomic and the ordered kernels' outputs of each call within
    float32 rounding of each other: rtol 1e-4 of the largest entry."""
    for k, (a, b) in enumerate(zip(old.backward(), new.backward())):
        for x, y in zip(a, b):
            assert (x is None) == (y is None), f"{label}: call {k}"
            if x is not None:
                x, y = x.reshape(-1), y.reshape(-1)
                scale = float(torch.nan_to_num(x).abs().max()) if x.numel() else 0.0
                torch.testing.assert_close(y, x, rtol=1e-4, atol=1e-4 * (scale or 1.0), equal_nan=True,
                                           msg=lambda m: f"{label}, call {k}: {m}")


def grad_turns(parent: Path) -> dict:
    """``grad-turns DIR``: the backward kernels of ``parent`` (an earlier
    commit's ``csrc``, with the float-atomic kernels' C interface) in turns
    with the package's on each gradient run's recorded calls of one step,
    all of a step's calls and each kernel's apart; then seconds a step of
    each run with the parent's tree and this one in turns, a process each."""
    import shutil

    copy = _build.BUILD_DIR / "grad_turns_parent"
    shutil.rmtree(copy, ignore_errors=True)
    copy.mkdir(parents=True)
    for name in ("table_read.cu", "kernel_histogram.cu", "ordered_sum.cuh", "launch.cuh"):
        shutil.copy(parent / name, copy / name)
    old_lib = _build.build(copy, (), ATOMIC_GRAD_SIGNATURES)
    import torch_flagship

    scope = {}
    exec(_GRAD_RUNS, scope)
    out = {}
    for label, (build, make) in scope["grad_runs"](theia_tpu_torch, chip_smoke, torch_flagship, icosphere(3)).items():
        step = make(build())
        step()
        calls = chip_smoke.record_grad_calls(step)
        del step
        kinds = {"every backward call": calls}
        for kind, name in (("read", "table reads"), ("gather", "row gathers"), ("kde", "kernel histogram")):
            mine = [c for c in calls if c[0] == kind]
            if mine and len(mine) < len(calls):
                kinds[name] = mine
        entry = out[label] = {}
        for what, subset in kinds.items():
            old, new = AtomicGradCalls(old_lib, subset), PackageGradCalls(subset)
            _agree(old, new, f"{label}, {what}")
            t = _in_turns(old, new, "backward", max(1, 200 // len(subset)))
            ratio = [x / min(t["old_queued_ms"]) for x in t["new_queued_ms"]]
            entry[what] = dict(t, calls=len(subset), queued_ratio=ratio,
                               kinds={k: sum(c[0] == k for c in subset) for k in ("read", "gather", "kde")})
            print(f"{label}, {what} ({len(subset)} calls): queued ms a step, float atomics "
                  f"{t['old_queued_ms'][0]:.4f} / {t['old_queued_ms'][1]:.4f}, ordered {t['new_queued_ms'][0]:.4f} / "
                  f"{t['new_queued_ms'][1]:.4f} (ordered / atomics {ratio[0]:.2f}, {ratio[1]:.2f}); as called "
                  f"{t['old_ms'][0]:.4f} / {t['old_ms'][1]:.4f}, {t['new_ms'][0]:.4f} / {t['new_ms'][1]:.4f} "
                  f"(atomics, ordered, ordered, atomics)")
        # the package's kernels of the step's calls apart, device time under torch.profiler
        calls_ = PackageGradCalls(calls)
        calls_.backward()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            calls_.backward()
            torch.cuda.synchronize()
        kernels = {e.key: e.device_time_total / 1000.0 for e in prof.key_averages() if e.device_time_total > 0}
        entry["kernels a step"] = kernels
        print(f"{label}, the package's kernels of a step's backward calls, device ms: " + ", ".join(
            f"{k[:70]} {v:.4f}" for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]))
        del calls, calls_
        torch.cuda.empty_cache()
    root = parent.parents[1]
    turns = []
    for name, tree in (("parent", root), ("tree", ROOT), ("tree", ROOT), ("parent", root)):
        proc = subprocess.run([sys.executable, "-c", _GRAD_CHILD, str(tree), str(GRAD_STEP_REPS)], input=_GRAD_RUNS,
                              cwd=tree, capture_output=True, text=True, timeout=1200)
        assert proc.returncode == 0, f"{name} at {tree}: {proc.stderr[-3000:]}"
        line = next(x for x in proc.stdout.splitlines() if x.startswith("SECONDS "))
        turns.append((name, json.loads(line[len("SECONDS "):])))
    for label in turns[0][1]:
        medians = [float(np.median(seconds[label])) for _, seconds in turns]
        out[label]["seconds a step"] = dict(parent_s=[medians[0], medians[3]], tree_s=[medians[1], medians[2]],
                                            seconds=[seconds[label] for _, seconds in turns])
        print(f"{label}: seconds a step, median of {GRAD_STEP_REPS}, parent {medians[0]:.4f} / tree {medians[1]:.4f} "
              f"/ tree {medians[2]:.4f} / parent {medians[3]:.4f}")
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("card_measure: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    mode = argv[1] if len(argv) > 1 else ""
    smi = _smi()
    print(smi)
    if mode not in ("profile", "sharded"):
        # these modes record and time the eager segment's calls (its queries, reads and records), as they did
        # before the staged route; profile takes both routes in turns, sharded the default one
        SceneForwardTracer._trace_batch = SceneForwardTracer._trace_batch_eager
    if mode == "tiles":
        result = tiles()
    elif mode == "baseline" and (len(argv) == 3 or argv[3:] == ["aos"]):
        result = baseline(Path(argv[2]).resolve(), tiled=len(argv) == 3)
    elif mode == "soup-builds":
        result = soup_builds()
    elif mode == "soup" and len(argv) == 3:
        result = baseline_soup(_build.build(Path(argv[2]).resolve(), (), OLD_SOUP_SIGNATURES))
    elif mode == "read-grad-live":
        result = read_grad_live()
    elif mode == "sobol-builds" and len(argv) <= 3:
        result = sobol_builds(Path(argv[2]).resolve() if len(argv) == 3 else None)
    elif mode == "walk-builds" and len(argv) <= 3:
        result = walk_builds(Path(argv[2]).resolve() if len(argv) == 3 else None)
    elif mode == "gamma-track-builds" and len(argv) <= 3:
        result = gamma_track_builds(Path(argv[2]).resolve() if len(argv) == 3 else None)
    elif mode == "cherenkov-turns" and len(argv) == 3:
        result = cherenkov_turns(Path(argv[2]).resolve())
    elif mode == "profile":
        result = profile()
    elif mode == "record-builds" and len(argv) <= 3:
        result = record_builds(argv[2] if len(argv) == 3 else "")
    elif mode == "record-turns" and len(argv) == 3:
        result = record_turns(Path(argv[2]).resolve())
    elif mode == "sort-turns" and len(argv) == 3:
        result = sort_turns(Path(argv[2]).resolve())
    elif mode == "grad-turns" and len(argv) == 3:
        result = grad_turns(Path(argv[2]).resolve())
    elif mode == "sharded" and len(argv) <= 3:
        result = sharded(int(argv[2]) if len(argv) == 3 else torch.cuda.device_count())
    else:
        print(__doc__, file=sys.stderr)
        return 2
    chip_smoke.OUT.mkdir(exist_ok=True)
    name = "_".join(argv[1:2] + argv[3:])  # "baseline_aos" beside "baseline"
    (chip_smoke.OUT / f"card_measure_{name}.json").write_text(
        json.dumps(dict(nvidia_smi=smi, **{mode: result}), indent=1)
    )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
