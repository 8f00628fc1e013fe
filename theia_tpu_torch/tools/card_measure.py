#!/usr/bin/env python3
"""Measurements of the nearest-hit kernels on one NVIDIA GPU, beyond what
``chip_smoke.py`` prints. Run from the repository root:

    python3 -m theia_tpu_torch.tools.card_measure tiles
    python3 -m theia_tpu_torch.tools.card_measure baseline DIR [aos]
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
(``tri_aos``) with the current entry points.

``profile`` traces one batch of the ``mt`` flagship and one of the
polarized ``woop`` flagship (262,144 lanes, path length 10) with
``torch.profiler`` and prints device-busy time, kernel count and the
largest items.

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


def baseline(csrc: Path, tiled: bool) -> dict:
    packs = _packs()
    old_lib = _build.build(csrc, (), OLD_SIGNATURES if tiled else None)
    out = {}
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


def profile() -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    mesh = icosphere(3)
    out = {}
    for label, kw in (("mt", {}), ("woop polarized", dict(accel="woop", polarized=True))):
        tracer = build_flagship(
            theia_tpu_torch, mesh, chip_smoke.BATCH, chip_smoke.MAX_PATH, device="cuda", **kw
        )
        for _ in range(2):
            tracer.run()
        torch.cuda.synchronize()
        start = time.perf_counter()
        tracer.run()
        torch.cuda.synchronize()
        plain_seconds = time.perf_counter() - start
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tracer.run()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name: dict[str, list[float]] = {}
        for e in events:
            by_name.setdefault(e.name, []).append(e.device_time if hasattr(e, "device_time") else e.cuda_time)
        busy_ms = sum(map(sum, by_name.values())) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
        print(f"{label}: {plain_seconds:.4f} s unprofiled batch, device busy {busy_ms:.2f} ms, "
              f"{len(events)} kernels and copies")
        for name, times in top:
            print(f"    {sum(times) / 1e3:9.3f} ms  {len(times):6d} x  {name[:100]}")
        out[label] = dict(
            unprofiled_seconds=plain_seconds, device_busy_ms=busy_ms, kernels=len(events),
            top=[dict(name=n, ms=sum(t) / 1e3, count=len(t)) for n, t in top],
        )
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
