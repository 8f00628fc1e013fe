#!/usr/bin/env python3
"""Measurements of the hand-written kernels on one NVIDIA GPU, beyond what
``chip_smoke.py`` prints. Run from the repository root:

    python3 -m theia_tpu_torch.tools.card_measure tiles
    python3 -m theia_tpu_torch.tools.card_measure baseline DIR [aos]
    python3 -m theia_tpu_torch.tools.card_measure histogram
    python3 -m theia_tpu_torch.tools.card_measure profile

``tiles`` builds the scan of ``csrc/nearest_scan.cuh`` with 256 and 512
rays a block, prints what ptxas reports for each (registers, shared
memory, spills), checks each against the default build bit for bit and
times the three entry points at N = 262,144 random rays over the
flagship's 3840 triangles.

``baseline DIR`` times the kernels of an earlier commit beside the current
ones in turns (old, new, new, old) at N = 262,144 and 524,288. ``DIR``
holds that commit's ``csrc`` files, e.g. from
``git archive <commit> theia_tpu_torch/csrc | tar -x -C <dir>`` (pass
``<dir>/theia_tpu_torch/csrc``). Without ``aos`` they are the first
kernels, which read the tiled tables ``MTPack.tri`` and ``WoopPack.b``;
with it, an earlier form of the scan over the current tables
(``tri_aos``) with the current entry points. Either way the histogram
record and its backward of ``DIR`` are timed in turns with the current
ones through their C entry points, as a caller sees them and queued
behind a spin kernel (device time alone): at ``chip_smoke.py``'s
mask-0.5 input, on the recorded records of one ``mt`` flagship batch, and
on ``chip_smoke.large_state_cases``' two records over 64,000 flat bins,
which take the current record's large-state variant (kept lanes spread
over all bins, and in four bins);
then the ``mt`` flagship's seconds per batch and the polarized ``woop``
gradient step's seconds with the old and the current histogram kernels
in turns.

``histogram`` times the record's two variants (a block-private histogram
in shared memory, adds merged by warp straight to the state; the second
from a build with ``THEIA_HISTOGRAM_SHARED_MAX=0``, which puts it on every
state) against each other on states of 100 to 57,856 flat bins, with half, a hundredth and
all of the lanes kept and with every kept lane in one of four bins: the
numbers behind the size at which ``theia_histogram_add`` changes variant.

``profile`` traces one batch of the ``mt`` flagship and one of the
polarized ``woop`` flagship (262,144 lanes, path length 10) with
``torch.profiler``, and one gradient step of the latter, and prints
device-busy time, kernel count, the largest items and the histogram
kernels' device time.

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

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
import theia_tpu_torch  # noqa: E402
from theia_tpu_torch import _build  # noqa: E402
from torch_flagship import build_flagship, icosphere  # noqa: E402

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
#: the entry points of a commit that already reads ``tri_aos``
AOS_SIGNATURES = tuple(
    (name, _build._SIGNATURES[name])
    for name in ("theia_mt_nearest", "theia_mt_nearest_rows", "theia_woop_nearest", "theia_philox_uniform")
) + HIST_SIGNATURES
#: rays a block, in units of its 256 threads; 3 needs more than 48 KiB of static shared memory
TILES = (1, 2)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Calls:
    """The three nearest-hit entry points of one built library on fixed
    rays, each as a closure that returns its outputs."""

    def __init__(self, lib, packs, rays, old: bool) -> None:
        mt, woop, table = packs
        o, d, tmax = rays
        n = o.shape[0]
        t = torch.empty(n, device="cuda")
        idx = torch.empty(n, dtype=torch.int32, device="cuda")
        rows = torch.empty((n, 32), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        head = (o.data_ptr(), d.data_ptr(), tmax.data_ptr())
        if old:  # the tiled tables, MT with its tile width
            mt_tab = (mt.tri.data_ptr(), mt.chunk_box.data_ptr(), n, mt.n_tri, mt.tri.shape[2])
            woop_tab = (woop.b.data_ptr(), woop.chunk_box.data_ptr(), n, woop.n_tri)
        else:
            mt_tab = (mt.tri_aos.data_ptr(), mt.chunk_box.data_ptr(), n, mt.n_tri)
            woop_tab = (woop.tri_aos.data_ptr(), woop.chunk_box.data_ptr(), n, woop.n_tri)
        out = (t.data_ptr(), idx.data_ptr())

        def call(fn, *args):
            def run():
                _build.check(fn(*args), fn.__name__)
                return t, idx, rows
            return run

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
    want = Calls(_build.library(), packs, rays, old=False).results()
    out = {}
    for r in TILES:
        lib = _build.build(defines=(f"THEIA_RAYS_PER_THREAD={r}",))
        calls = Calls(lib, packs, rays, old=False)
        assert _same(calls.results(), want), f"{256 * r} rays a block differ from the default build"
        ms = {name: chip_smoke.cuda_ms(getattr(calls, name), 20) for name in ("mt", "mt_rows", "woop")}
        ptxas = [line.strip() for line in lib.build_log.splitlines()
                 if ("registers" in line or "spill" in line) and "ptxas" in line]
        out[f"{256 * r} rays a block"] = dict(ms=ms, ptxas=ptxas)
        print(f"{256 * r} rays a block: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
        for line in lib.build_log.splitlines():
            if "nearest_scan" in line or "registers" in line or "spill" in line:
                print("   ", line.strip())
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


def baseline(csrc: Path, tiled: bool) -> dict:
    packs = _packs()
    old_lib = _build.build(csrc, (), OLD_SIGNATURES + HIST_SIGNATURES if tiled else AOS_SIGNATURES)
    out = baseline_histogram(old_lib)
    for n in (chip_smoke.BATCH, 2 * chip_smoke.BATCH):
        rays = chip_smoke.random_rays(n, n, "cuda")
        old = Calls(old_lib, packs, rays, old=tiled)
        new = Calls(_build.library(), packs, rays, old=False)
        assert _same(old.results(), new.results()), "old and new kernels differ"
        for name in ("mt", "mt_rows", "woop"):
            ms = [chip_smoke.cuda_ms(getattr(c, name), 20) for c in (old, new, new, old)]
            out[f"{name} N={n}"] = dict(old_ms=[ms[0], ms[3]], new_ms=[ms[1], ms[2]])
            print(f"{name} N={n}: old {ms[0]:.4f} / {ms[3]:.4f} ms, new {ms[1]:.4f} / {ms[2]:.4f} ms "
                  f"(old, new, new, old; bit-equal)")
    return out


def _profiled(label: str, step, plain_seconds: float) -> dict:
    """Trace one call of ``step`` and print where its device time went."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.device_time if hasattr(e, "device_time") else e.cuda_time)
    busy_ms = sum(map(sum, by_name.values())) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    histogram = {name: times for name, times in by_name.items() if "histogram" in name}
    print(f"{label}: {plain_seconds:.4f} s unprofiled, device busy {busy_ms:.2f} ms, "
          f"{len(events)} kernels and copies")
    for name, times in top + sorted(histogram.items()):
        print(f"    {sum(times) / 1e3:9.3f} ms  {len(times):6d} x  {name[:100]}")
    item = lambda n, t: dict(name=n, ms=sum(t) / 1e3, count=len(t))
    return dict(
        unprofiled_seconds=plain_seconds, device_busy_ms=busy_ms, kernels=len(events),
        top=[item(n, t) for n, t in top], histogram=[item(n, t) for n, t in sorted(histogram.items())],
    )


def _seconds(step) -> float:
    torch.cuda.synchronize()
    start = time.perf_counter()
    step()
    torch.cuda.synchronize()
    return time.perf_counter() - start


def profile() -> dict:
    mesh = icosphere(3)
    out = {}
    for label, kw in (("mt", {}), ("woop polarized", dict(accel="woop", polarized=True))):
        tracer = build_flagship(
            theia_tpu_torch, mesh, chip_smoke.BATCH, chip_smoke.MAX_PATH, device="cuda", **kw
        )
        for _ in range(2):
            tracer.run()
        out[label] = _profiled(f"{label}, one batch", tracer.run, _seconds(tracer.run))
        if kw:
            step = lambda: chip_smoke.absorption_grad(tracer)
            step()
            out[f"{label} gradient"] = _profiled(f"{label}, one gradient step", step, _seconds(step))
        del tracer
        torch.cuda.empty_cache()
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
    elif mode == "histogram":
        result = histogram_variants()
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
