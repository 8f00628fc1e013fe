#!/usr/bin/env python3
"""Measurements of the hand-written kernels on one NVIDIA GPU, beyond what
``chip_smoke.py`` prints. Run from the repository root:

    python3 -m theia_tpu_torch.tools.card_measure tiles
    python3 -m theia_tpu_torch.tools.card_measure baseline DIR [aos]
    python3 -m theia_tpu_torch.tools.card_measure soup DIR
    python3 -m theia_tpu_torch.tools.card_measure soup-builds
    python3 -m theia_tpu_torch.tools.card_measure histogram
    python3 -m theia_tpu_torch.tools.card_measure gather-builds
    python3 -m theia_tpu_torch.tools.card_measure gather-skew
    python3 -m theia_tpu_torch.tools.card_measure read-grad-builds [DIR]
    python3 -m theia_tpu_torch.tools.card_measure read-grad-live
    python3 -m theia_tpu_torch.tools.card_measure kde-builds [DIR]
    python3 -m theia_tpu_torch.tools.card_measure profile

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
on ``chip_smoke.large_state_cases``' two records over 64,000 flat bins,
which take the current record's large-state variant (kept lanes spread
over all bins, and in four bins);
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

``histogram`` times the record's two variants (a block-private histogram
in shared memory, adds merged by warp straight to the state; the second
from a build with ``THEIA_HISTOGRAM_SHARED_MAX=0``, which puts it on every
state) against each other on states of 100 to 57,856 flat bins, with half, a hundredth and
all of the lanes kept and with every kept lane in one of four bins: the
numbers behind the size at which ``theia_histogram_add`` changes variant.

``gather-builds`` times measurement builds of the row gathers, each from
a copy of ``csrc`` with ``table_read.cu`` patched in the build directory
(``GATHER_BUILDS``: the forward's tiles of 128 rows, the backward's of
64, one tile a forward block, the forward or the backward on device
memory looping over tiles in 8 blocks an SM, the backward held to 32
registers (8 blocks an SM), the backward without its warp merge or with
four scalar atomics where it adds a float4), in turns with the
package's on ``chip_smoke.py``'s gather cases with the reconstruction's
spans (the winners of a recorded brute shadow pair among them), forward
and backward, queued.

``gather-skew`` times the package's row gathers on ``tri_data`` with
a share of the lanes on row 0 (0 to 100 %) and with every lane on 1 to
1280 rows, with the reconstruction's spans and as whole rows.

``read-grad-builds [DIR]`` times the table reads' backward, queued, at
``chip_smoke.py``'s four read cases (packed at t, the const4 rule, single
at t, four single tables at the wavelength), with every lane at one
coordinate, with 30 %, 10 % and 0.5 % of the lanes' upstream gradients
nonzero (``READ_GRAD_LIVE``) and on a table of 16,384 samples, with the
tables' gradients and with d x alone: with ``DIR`` (an earlier commit's
``csrc``, e.g. the parent's from ``git archive``) first that commit's
kernels in turns with the package's, then measurement builds of the
package's design (``READ_GRAD_BUILDS``: patches of ``csrc/table_read.cu``
in a copy, chosen by a line of the design's source) in turns with it.

``read-grad-live`` counts, in each table-read backward of one step of
each gradient path that ``profile`` traces, the lanes whose upstream
gradient is not zero: the traffic that the backward sees on those paths.

``kde-builds [DIR]`` does the same for the kernel histogram's backward
(``KDE_BUILDS``, patches of ``csrc/kernel_histogram.cu``) at N = 524,288
with 10 %, 50 % and 100 % of the lanes unmasked, every lane in one bin,
and a detector axis.

``profile`` traces one batch of the ``mt`` flagship, one of the
brute-force flagship (``accel="auto"``) and one of the polarized ``woop``
flagship (262,144 lanes, path length 10) with ``torch.profiler``, one
gradient step of the latter, one step of each of ``chip_smoke.py``'s
gradient phases 3h and 3i (the volume flagship in its absorption and,
with a kernel histogram, its group velocity; the brute flagship's
geometry), one batch of the volume flagship and one of the photon
flagship by ``run()`` and by ``run_compacted()``, and prints device-busy
time, kernel count, the largest items and the hand-written kernels'
device time (the scans, Philox, the histograms, the table reads).

Every mode prints the card's name and power limit first and writes its
numbers to ``card_measure_<mode>.json`` (``card_measure_baseline_aos.json``
for ``baseline DIR aos``) in ``chip_smoke.py``'s output directory.
"""

from __future__ import annotations

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
from torch_flagship import build_flagship, build_photon_flagship, build_volume_flagship, icosphere  # noqa: E402

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
        for value, time_, mask, t0, bin_size, bins, oid, n_det in records:
            tail = (time_.data_ptr(), mask.data_ptr(), None if oid is None else oid.data_ptr(),
                    t0.data_ptr(), bin_size.data_ptr(), mask.shape[0], bins, n_det or 0)
            self._add.append((lib.theia_histogram_add, value.data_ptr(), *tail, self.state.data_ptr(), stream))
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


def histogram_variants() -> dict:
    """The record's shared-memory variant (``theia_histogram_add`` on
    states that it takes) against the large-state variant (the same entry
    point of a build that gives the shared-memory variant no state) on the
    same inputs, queued ms."""
    lib, out, n = _build.library(), {}, 2 * chip_smoke.BATCH
    merged_lib = _build.build(defines=("THEIA_HISTOGRAM_SHARED_MAX=0",))
    for bins in (100, 1024, 4096, 12_288, 32_768, theia_tpu_torch.response.SHARED_STATE_MAX):
        for label, kept in (("half kept", 0.5), ("1 % kept", 0.01), ("all kept", 1.0)):
            cases = {label: chip_smoke.hist_case(n, bins, bins=bins, kept=kept)}
            if kept == 0.5:  # every kept lane in one of bins 1 to 4
                c = cases[label]
                cases["half kept, 4 bins in use"] = (c[0], 5.0 + 5.0 * (c[1] % 4.0).floor(), *c[2:])
            for name, case in cases.items():
                shared = HistCalls(lib, [case])
                merged = HistCalls(merged_lib, [case])
                torch.testing.assert_close(shared.result()[0], merged.result()[0], rtol=1e-4, atol=0.0)
                ms = [chip_smoke.cuda_ms_queued(c.add, 50) for c in (shared, merged, merged, shared)]
                out[f"{bins} bins, {name}"] = dict(shared_ms=[ms[0], ms[3]], merged_ms=[ms[1], ms[2]])
                print(f"{bins} bins, {name}: shared memory {ms[0]:.4f} / {ms[3]:.4f} ms, "
                      f"merged by warp {ms[1]:.4f} / {ms[2]:.4f} ms (queued; shared, merged, merged, shared)")
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


#: measurement builds of the row gathers: a copy of ``csrc`` with each
#: (text, replacement) of ``csrc/table_read.cu`` made; their results are
#: the package's
GATHER_BUILDS = {
    "forward tiles of 128 rows": (("constexpr int kPasses = 2;", "constexpr int kPasses = 4;"),),
    "backward tiles of 64 rows": (("constexpr int kGradPasses = 4;", "constexpr int kGradPasses = 2;"),),
    "forward one tile a block": (("constexpr int kForwardTiles = 4;", "constexpr int kForwardTiles = 1;"),),
    "forward in 8 blocks an SM": (
        ("grid_for(count, kForwardTiles * Tile<kPasses>::kRows, kMostBlocksPerSm, &err)",
         "grid_for(count, Tile<kPasses>::kRows, kGatherBlocksPerSm, &err)"),),
    "backward in 8 blocks an SM": (("grid_for(count, T::kRows, kMostBlocksPerSm, &err)",
                                    "grid_for(count, T::kRows, kGatherBlocksPerSm, &err)"),),
    "backward held to 32 registers": (("__launch_bounds__(kGatherThreads)\n    gather_rows32_grad(",
                                       "__launch_bounds__(kGatherThreads, kGatherBlocksPerSm)\n    gather_rows32_grad("),),
    "no warp merge": (("& (0x01010101u << sub);", "& (1u << lane);"),),
    "scalar atomics": (("  atomicAdd(reinterpret_cast<float4*>(p), v);",
                        "  atomicAdd(p, v.x);\n  atomicAdd(p + 1, v.y);\n  atomicAdd(p + 2, v.z);\n  atomicAdd(p + 3, v.w);"),),
}


class GatherCalls:
    """The row gather and its backward of one built library on one case of
    ``chip_smoke.gather_cases``, through the C entry points, outputs made
    beforehand: ``forward`` and ``backward`` (the zero fill of the table's
    gradient, which the wrapper makes, and the launch)."""

    def __init__(self, lib, table, columns, index, hit) -> None:
        from theia_tpu_torch.ops import table_read

        self.lib, self.table, self.index = lib, table, index
        spans, self.spec = table_read._span_set(columns, table.shape[1])
        n = index.shape[0]
        self.outs = tuple(torch.empty((n, b - a), dtype=torch.int32 if i else torch.float32, device="cuda")
                          for a, b, i in spans)
        gen = torch.Generator(device="cuda").manual_seed(5)
        self.grads = [None if i else torch.randn(n, b - a, device="cuda", generator=gen) for a, b, i in spans]
        if hit is not None:
            self.grads = [None if g is None else torch.where(hit[:, None], g, 0.0) for g in self.grads]
        self.out_ptrs, self.grad_ptrs = table_read._pointers(self.outs), table_read._pointers(self.grads)
        self.grad = torch.zeros(table.shape, device="cuda")
        self.stream = torch.cuda.current_stream().cuda_stream

    def forward(self):
        t = self.table
        _build.check(self.lib.theia_gather_rows(t.data_ptr(), t.shape[0], t.shape[1], self.index.data_ptr(),
                                                self.index.shape[0], ctypes.byref(self.spec), self.out_ptrs,
                                                self.stream), "theia_gather_rows")
        return self.outs

    def backward(self):
        self.grad.zero_()
        t = self.table
        _build.check(self.lib.theia_gather_rows_grad(ctypes.byref(self.spec), self.grad_ptrs, self.index.data_ptr(),
                                                     self.index.shape[0], t.shape[0], t.shape[1],
                                                     self.grad.data_ptr(), self.stream), "theia_gather_rows_grad")
        return self.grad


def gather_builds() -> dict:
    """The row gathers of each build of ``GATHER_BUILDS`` in turns with the
    package's (package, build, build, package) on ``chip_smoke``'s gather
    cases with the reconstruction's spans, the winners those of one
    recorded shadow pair of a brute batch: the forward bit-equal to the
    package's, the backward within 2e-5 of the absolute shares; ms as
    called and queued."""
    tracer = build_flagship(theia_tpu_torch, icosphere(3), chip_smoke.BATCH, chip_smoke.MAX_PATH, accel="auto",
                            device="cuda")
    pack = tracer.scene.pack
    shadow = chip_smoke.record_soup_queries(tracer, "target_in_table")
    bare = chip_smoke.Soup("target_in_table", pack, rows=False)
    winners = bare.run(bare.kernel, bare.tables[0], shadow[0][:3], shadow[0][3], shadow[0][4])[1]
    from theia_tpu_torch.ops.table_read import gather_rows_grad_plain

    cases = chip_smoke.gather_cases(pack, winners)
    base = {label: GatherCalls(_build.library(), *case) for label, case in cases.items()}
    out = {"package": dict(ptxas=_kernel_ptxas(_build.library().build_log, "gather_rows"))}
    for line in out["package"]["ptxas"]:
        print("    package:", line)
    for label, patches in GATHER_BUILDS.items():
        lib = patched_build(label, patches, "table_read.cu")
        entry = out[label] = dict(patches=patches, ptxas=_kernel_ptxas(lib.build_log, "gather_rows"))
        for name, case in cases.items():
            calls = GatherCalls(lib, *case)
            assert all(torch.equal(a, b) for a, b in zip(base[name].forward(), calls.forward())), (label, name)
            # each within 2e-5 of the exact sums, so within 4e-5 of each other
            want, got = base[name].backward().clone(), calls.backward()
            table, columns, index = case[:3]
            shares = gather_rows_grad_plain(table.shape, index, [None if g is None else g.abs() for g in calls.grads],
                                            columns)
            assert float(((got - want).abs() - 4e-5 * shares).max()) <= 0.0, (label, name)
            for kind in ("forward", "backward"):
                t = entry[f"{name}, {kind}"] = _in_turns(base[name], calls, kind, 20)
                print(f"gather {kind} on {name} (N = {case[2].shape[0]}), {label}: package {t['old_queued_ms'][0]:.4f} / "
                      f"{t['old_queued_ms'][1]:.4f} ms, build {t['new_queued_ms'][0]:.4f} / "
                      f"{t['new_queued_ms'][1]:.4f} ms (queued; package, build, build, package)")
        for line in entry["ptxas"]:
            print("   ", line)
    return out


def gather_skew() -> dict:
    """The package's row gathers, forward and backward, queued, on the
    flagship's ``tri_data`` with the reconstruction's spans and as whole
    rows at N = 262,144 as the rows' distribution is skewed: a share of the
    lanes on row 0 (as a shadow query's misses are), and every lane on a
    few rows; the backward's gradient 0 on the lanes of row 0 where they
    stand for misses, random elsewhere."""
    from theia_tpu_torch.accel import TRI_COLUMNS

    pack = build_flagship(theia_tpu_torch, icosphere(3), 64, 2, accel="auto", device="cuda").scene.pack
    table, n = pack.tri_data, chip_smoke.BATCH
    rng = np.random.default_rng(9)
    cases = {}
    for share in (0.0, 0.5, 0.9, 1.0):
        on_zero = rng.uniform(size=n) < share
        rows = np.where(on_zero, 0, rng.integers(0, table.shape[0], n))
        cases[f"{share:.0%} of the lanes on row 0"] = (rows, ~on_zero)
    for hot in (1, 4, 32, 1280):
        cases[f"every lane on {hot} rows"] = (rng.integers(0, hot, n), np.ones(n, bool))
    out = {}
    for label, (rows, hit) in cases.items():
        index = torch.as_tensor(rows.astype(np.int32), device="cuda")
        hit = torch.as_tensor(hit, device="cuda")
        for columns in (TRI_COLUMNS, None):
            calls = GatherCalls(_build.library(), table, columns, index, hit)
            name = f"{label}, {'spans' if columns else 'whole rows'}"
            out[name] = {kind: chip_smoke.cuda_ms_queued(getattr(calls, kind), 20) for kind in ("forward", "backward")}
            print(f"gather on {name}: forward {out[name]['forward']:.4f} ms, backward {out[name]['backward']:.4f} ms "
                  f"(queued)")
    return out


#: the read cases of ``chip_smoke.read_cases`` whose backward the
#: measurement builds time: packed at t, the const4 rule, single at t, four
#: single tables at the wavelength
READ_GRAD_CASES = ("read_packed", "read_packed, const4", "read_table", "read_table, medium constants")
#: measurement builds of the table reads' backward, by design: a copy of
#: ``csrc`` with each (text, replacement) of ``csrc/table_read.cu`` made;
#: a design is told by a line that only its source holds
READ_GRAD_BUILDS = {
    # a block's shared copy of every table's gradient, flushed with a global
    # atomic a nonzero entry, 512 threads, 2 blocks an SM
    "constexpr int kGradBlocksPerSm = 2;": {
        "no flush (results wrong)": (("        if (v != 0.0f) atomicAdd(grads.table[k] + e, v);",
                                      "        (void)v;"),),
        "1 block an SM": (("constexpr int kGradBlocksPerSm = 2;", "constexpr int kGradBlocksPerSm = 1;"),),
        "4 blocks an SM": (("constexpr int kGradBlocksPerSm = 2;", "constexpr int kGradBlocksPerSm = 4;"),),
        "8 blocks an SM": (("constexpr int kGradBlocksPerSm = 2;", "constexpr int kGradBlocksPerSm = 8;"),),
    },
}
#: the shares of lanes with a nonzero upstream gradient at which
#: ``read_grad_builds`` also times each read case (the rest zero, as a
#: tracer's dead lanes are)
READ_GRAD_LIVE = (0.3, 0.1, 0.005)


class ReadGradCalls:
    """The table reads' backward of one built library on read case ``c``
    with upstream gradients ``g`` (one a table), through the C entry point:
    ``backward`` (the tables' gradients, views of one buffer, zeroed in one
    fill, and the launch) with the tables' gradients, or with ``grad_x``
    alone."""

    def __init__(self, lib, c, g, tables: bool) -> None:
        self.lib = lib
        self.reader, self.tables, _, _, self.handle, self.x = chip_smoke._read_reader(c)
        live = [t for t in self.tables if tables and t is not None]
        self.buffer = torch.zeros(max(sum(t.numel() for t in live), 1), device="cuda")
        self.grads, at = [], 0
        for t in self.tables:
            self.grads.append(self.buffer[at : at + t.numel()].view(t.shape) if tables and t is not None else None)
            at += t.numel() if tables and t is not None else 0
        self.grad_x = torch.empty_like(self.x)
        self.stream = torch.cuda.current_stream().cuda_stream
        pad = [None] * (4 - len(self.tables))
        self.rows = [_ptr(r) for r in g] + pad
        self.outs = [_ptr(r) for r in self.grads] + pad

    def backward(self):
        x = self.x
        if any(grad is not None for grad in self.grads):
            self.buffer.zero_()
        _build.check(self.lib.theia_table_read_grad(
            self.reader.spec_address, _ptr(self.handle), x.data_ptr(), x.stride(0), *self.rows, x.shape[0],
            *self.outs, self.grad_x.data_ptr(), self.stream), "theia_table_read_grad")
        return self.grads, self.grad_x


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
    commit's, with the package's C entry points) or the package's."""
    return parent or _build.CSRC, tuple(_build._SIGNATURES.items())


def _design(source: Path, builds: dict) -> dict:
    """The measurement builds of the design whose marker ``source`` holds."""
    text = source.read_text()
    found = [b for marker, b in builds.items() if marker in text]
    assert len(found) == 1, f"{source}: no measurement builds for its design"
    return found[0]


def read_grad_builds(parent: Path | None) -> dict:
    """The table reads' backward at ``chip_smoke``'s read cases
    (``READ_GRAD_CASES``, N = 262,144), with every lane at one coordinate
    (``chip_smoke.hot_read_case``), with a share of the lanes' upstream
    gradients nonzero (``READ_GRAD_LIVE``: a tracer's dead lanes) and on a
    single table of 16,384 samples, with the tables' gradients and with d
    x alone, queued: with ``parent`` (an earlier commit's ``csrc``) first
    the package's kernels in turns with the parent's (parent, package,
    package, parent), then each measurement build of the package's design
    (``READ_GRAD_BUILDS``) in turns with the package's (package, build,
    build, package). d x is held bit-equal to the first's everywhere, the
    tables' gradients within 4e-5 of the absolute shares where the build
    keeps the results."""
    store = build_flagship(theia_tpu_torch, icosphere(1), 64, 2, accel="auto", device="cuda").scene.pack.media
    medium = build_volume_flagship(theia_tpu_torch, 64, "cuda").params()["medium"]
    every = chip_smoke.read_cases(store, medium)
    cases = {}
    for name in READ_GRAD_CASES:
        cases[name] = every[name]
        cases[f"{name}, every lane at one coordinate"] = chip_smoke.hot_read_case(every[name])
    gen = torch.Generator(device="cuda").manual_seed(11)
    ups = {name: tuple(torch.randn(c["args"][-2].shape, device="cuda", generator=gen) for _ in
                       (c["args"][0] if isinstance(c["args"][0], tuple) else (c["args"][0],))) for name, c in cases.items()}
    # a share of the lanes live (the rest with zero upstream gradients, as a tracer's dead lanes)
    for name in READ_GRAD_CASES:
        for share in READ_GRAD_LIVE:
            live = f"{name}, {share:g} of the lanes live"
            cases[live] = every[name]
            ups[live] = chip_smoke.live_grads(ups[name], share, gen)
    # a single table of 16,384 samples: its gradient still in a block's shared copy
    band = chip_smoke.sized_read_case(every["read_table"], 16_384)
    cases["read_table, 16,384 samples"] = band
    ups["read_table, 16,384 samples"] = ups["read_table"]
    package = _build.library()
    out = {"package": dict(ptxas=_kernel_ptxas(package.build_log, "read_tables_grad"))}
    for line in out["package"]["ptxas"]:
        print("    package:", line)
    # label -> (patches of the package's source, or None; the library the build is timed against)
    builds = {}
    if parent is not None:
        builds["package against the parent"] = (None, _build.build(parent, (), tuple(_build._SIGNATURES.items())))
    builds.update({label: (patches, package) for label, patches in
                   _design(_build.CSRC / "table_read.cu", READ_GRAD_BUILDS).items()})
    for label, (patches, base_lib) in builds.items():
        lib = package if patches is None else patched_build(label, patches, "table_read.cu")
        entry = out[label] = dict(patches=patches, ptxas=_kernel_ptxas(lib.build_log, "read_tables_grad"))
        for name, c in cases.items():
            for tables in (True, False):
                base, calls = ReadGradCalls(base_lib, c, ups[name], tables), ReadGradCalls(lib, c, ups[name], tables)
                base.backward()
                got_t, got_x = calls.backward()
                torch.cuda.synchronize()
                if not label.endswith("(results wrong)"):
                    assert chip_smoke.same(got_x, base.grad_x), (label, name, "d x")
                if tables and not label.endswith("(results wrong)"):
                    for a, b, s in zip(got_t, base.grads, _abs_shares(c, ups[name])):
                        if b is not None:
                            finite = torch.isfinite(b)
                            assert float(((a - b)[finite].abs() - 4e-5 * s[finite]).max()) <= 0.0, (label, name)
                key = f"{name}, {'tables and d x' if tables else 'd x alone'}"
                t = entry[key] = _in_turns(base, calls, "backward", 20)
                print(f"read backward on {key}, {label}: base {t['old_queued_ms'][0]:.4f} / "
                      f"{t['old_queued_ms'][1]:.4f} ms, build {t['new_queued_ms'][0]:.4f} / "
                      f"{t['new_queued_ms'][1]:.4f} ms (queued; base, build, build, base)")
        for line in entry["ptxas"] if patches is not None else _kernel_ptxas(base_lib.build_log, "read_tables_grad"):
            print("    " + ("" if patches is not None else "parent: ") + line)
    out["empty launch"] = chip_smoke.empty_launch_ms()
    print(f"empty launch: {out['empty launch']['queued_ms']:.4f} ms queued")
    return out


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


def _abs_shares(c, g):
    """The plain backward's tables' gradients on |g|: each entry's sum of
    absolute shares."""
    _, _, _, grad_plain = chip_smoke.read_calls(c, g)
    one = not isinstance(c["args"][0], tuple)
    got, _ = grad_plain(g[0].abs() if one else tuple(a.abs() for a in g))
    return chip_smoke._outputs(got)


#: kde measurement builds, by design (as ``READ_GRAD_BUILDS``). The first: a
#: thread a lane, a lane's 9 bins in a loop, five IEEE divisions a pair
_KDE_FIRST_LOOP = ("    if (kept(in, i, p, &t, &base, &offset)) {\n      const float v = in.value[i];\n"
                 "      for (int o = -in.support; o <= in.support; ++o) {")
KDE_BUILDS = {
    "        dt = dt + __fdiv_rn(gv * w * z, p.h);": {
        "the three gradient divisions as products": (
            ("  const float norm = p.bin_size * inv;\n  float sum_t",
             "  const float norm = p.bin_size * inv;\n  const float rh = __fdiv_rn(1.0f, p.h);\n  float sum_t"),
            ("        dt = dt + __fdiv_rn(gv * w * z, p.h);", "        dt = dt + gv * w * z * rh;"),
            ("        dbs = dbs + gv * (e * inv - __fdiv_rn(w * z * (bf + 0.5f), p.h));",
             "        dbs = dbs + gv * (e * inv - w * z * (bf + 0.5f) * rh);"),
            ("        dh = dh + __fdiv_rn(gv * w * (z * z - 1.0f), p.h);",
             "        dh = dh + gv * w * (z * z - 1.0f) * rh;"),
        ),
        "one bin a lane (results wrong)": ((_KDE_FIRST_LOOP, _KDE_FIRST_LOOP.replace("o = -in.support", "o = 0")
                                            .replace("o <= in.support", "o <= 0")),),
    },
    # the current one: a block's list of kept lanes dealt a round of threads at a
    # time, the three gradient divisions by h as products by 1 / h
    "    dt = dt + gv * w * z * rh;": {
        "the three gradient divisions kept": (
            ("    dt = dt + gv * w * z * rh;", "    dt = dt + __fdiv_rn(gv * w * z, p.h);"),
            ("    dbs = dbs + gv * (e * inv - w * z * (bf + 0.5f) * rh);",
             "    dbs = dbs + gv * (e * inv - __fdiv_rn(w * z * (bf + 0.5f), p.h));"),
            ("    dh = dh + gv * w * (z * z - 1.0f) * rh;", "    dh = dh + __fdiv_rn(gv * w * (z * z - 1.0f), p.h);"),
        ),
        "2 blocks an SM": (("constexpr int kGradBlocksPerSm = 4;", "constexpr int kGradBlocksPerSm = 2;"),),
        "8 blocks an SM": (("constexpr int kGradBlocksPerSm = 4;", "constexpr int kGradBlocksPerSm = 8;"),),
        "no bins (results wrong)": (("  for (int o = -in.support; o <= in.support; ++o) {\n    const float bf",
                                     "  for (int o = 0; o < 0; ++o) {\n    const float bf"),),
    },
}


class KdeCalls:
    """The kernel histogram's backward of one built library on one
    ``chip_smoke.kde_case``, through its C entry point (the scalars'
    zero fill, which the wrapper makes, and the launch)."""

    def __init__(self, lib, case, grad_state) -> None:
        value, time_, mask, t0, bs, bw, bins, support, oid, n_det = case
        self.lib, self.case, self.grad_state = lib, case, grad_state
        self.grad_value, self.grad_time = torch.empty_like(time_), torch.empty_like(time_)
        self.params = torch.zeros(3, device="cuda")
        self.args = (grad_state.data_ptr(), value.data_ptr(), time_.data_ptr(), mask.data_ptr(), _ptr(oid),
                     t0.data_ptr(), bs.data_ptr(), bw.data_ptr(), time_.shape[0], bins, n_det or 0, support,
                     self.grad_value.data_ptr(), self.grad_time.data_ptr(), self.params.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)

    def backward(self):
        self.params.zero_()
        _build.check(self.lib.theia_kde_grad(*self.args), "theia_kde_grad")
        return self.grad_value, self.grad_time, self.params


def kde_builds(parent: Path | None) -> dict:
    """The kernel histogram's backward at ``chip_smoke.kde_case``'s N =
    524,288 with 10 %, 50 % and 100 % of the lanes unmasked, all lanes in
    one bin, and with a detector axis, queued: the kernels of ``parent``
    or of the package in turns with each measurement build of their design
    (``KDE_BUILDS``: base, build, build, base), with ``parent`` also the
    package's in turns with the parent's. The builds that keep the results
    hold ``chip_smoke.hold_kde``'s tolerances against the base."""
    n = 2 * chip_smoke.BATCH
    cases = {f"mask {kept}": chip_smoke.kde_case(n, 3, kept=kept) for kept in (0.1, 0.5, 1.0)}
    one = chip_smoke.kde_case(n, 3, kept=1.0)
    cases["every lane in one bin"] = (one[0], torch.full_like(one[1], 252.5), *one[2:])
    cases["a detector axis (3), mask 0.5"] = chip_smoke.kde_case(n, 6, n_det=3)
    csrc, sigs = _base_sources(parent)
    base_lib = _build.build(csrc, (), sigs)
    out = {"base": dict(csrc=str(csrc), ptxas=_kernel_ptxas(base_lib.build_log, "kde_grad"))}
    builds = {label: (patches, base_lib) for label, patches in
              _design(csrc / "kernel_histogram.cu", KDE_BUILDS).items()}
    if parent is not None:
        builds["package"] = (None, _build.library())
    for label, (patches, lib) in builds.items():
        if patches is not None:
            lib = patched_build(label, patches, "kernel_histogram.cu", csrc, sigs)
        entry = out[label] = dict(patches=patches, ptxas=_kernel_ptxas(lib.build_log, "kde_grad"))
        for name, case in cases.items():
            g = torch.randn(case[6] * (case[9] or 1), device="cuda", generator=torch.Generator("cuda").manual_seed(3))
            base, calls = KdeCalls(base_lib, case, g), KdeCalls(lib, case, g)
            want = [a.clone() for a in base.backward()]
            got = calls.backward()
            torch.cuda.synchronize()
            if not label.endswith("(results wrong)"):
                for what, a, b, rtol in zip(("d value", "d time", "d params"), got, want, (1e-5, 1e-5, 1e-4)):
                    atol = rtol * (float(b.abs().max()) or 1.0)
                    torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=lambda m: f"{label}, {name}, {what}: {m}")
            t = entry[name] = _in_turns(base, calls, "backward", 20)
            print(f"kde backward on {name}, {label}: base {t['old_queued_ms'][0]:.4f} / {t['old_queued_ms'][1]:.4f} "
                  f"ms, build {t['new_queued_ms'][0]:.4f} / {t['new_queued_ms'][1]:.4f} ms (queued; base, build, "
                  f"build, base)")
        for line in entry["ptxas"]:
            print("   ", line)
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
        out[label] = _profiled(f"{label}, one batch", tracer.run, _seconds(tracer.run))
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


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("card_measure: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    mode = argv[1] if len(argv) > 1 else ""
    smi = _smi()
    print(smi)
    if mode == "tiles":
        result = tiles()
    elif mode == "baseline" and (len(argv) == 3 or argv[3:] == ["aos"]):
        result = baseline(Path(argv[2]).resolve(), tiled=len(argv) == 3)
    elif mode == "soup-builds":
        result = soup_builds()
    elif mode == "soup" and len(argv) == 3:
        result = baseline_soup(_build.build(Path(argv[2]).resolve(), (), OLD_SOUP_SIGNATURES))
    elif mode == "histogram":
        result = histogram_variants()
    elif mode == "gather-builds":
        result = gather_builds()
    elif mode == "gather-skew":
        result = gather_skew()
    elif mode in ("read-grad-builds", "kde-builds") and len(argv) <= 3:
        parent = Path(argv[2]).resolve() if len(argv) == 3 else None
        result = (read_grad_builds if mode == "read-grad-builds" else kde_builds)(parent)
    elif mode == "read-grad-live":
        result = read_grad_live()
    elif mode == "profile":
        result = profile()
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
