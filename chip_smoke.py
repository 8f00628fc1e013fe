#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``theia_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi), then the kernels' build
   from ``theia_tpu_torch/csrc`` with nvcc (one process per source, run
   together) and its seconds;
2. each hand-written kernel against its plain PyTorch version at the main
   paths' shapes (the plain version runs on the inputs moved to the CPU),
   with its time beside the plain version's on the card (CUDA events),
   its bound (the larger of bytes over 3.35 TB/s and operations over 67
   TFLOP/s, counted from this run's inputs) and, where one PyTorch call
   computes the same function, that call's time as a yardstick. The
   three nearest-hit kernels are also held bit for bit against their
   plain versions on adversarial rays (through vertices, along edges, in
   a triangle's plane, off a surface) and on the 19 queries of one
   recorded flagship batch, which are replayed for the time and bound
   that a batch sees; the share of pairs that survive the kernels'
   rejection tests is counted with their plain twins. The
   Moeller-Trumbore kernel with winner rows also runs the A/B/C
   experiment of ``tools/exp_mt_fused.py`` (kernel alone, kernel with
   rows, kernel plus a torch gather);
3. the first main path at full width: the flagship scene tracer
   (262,144 lanes, path length 10, 3840 triangles, 100 bins,
   ``accel="mt"``) through ``run()``, one warm-up batch and three timed
   ones, with the kernels' launch counts; then seconds per batch with
   the winners' rows from the kernel and from a torch gather, in turns;
3b. the second main path at full width: the polarized flagship on the
   Woop query (``accel="woop", polarized=True``), the same way;
3c. its gradient at full width: one ``trace_fn()`` forward and backward
   of sum(histogram state) with respect to the water absorption table;
4. the port on the CPU against the port on the card: the unpolarized
   ``mt`` flagship and the polarized ``woop`` flagship with the source
   off centre at batch 4096, and the gradient at batch 2048, path
   length 3.

Every path's launch counts are set to 0 just before it runs and read
just after. Then one JSON line of kernels (name, route, source,
replaces, launches, launches_per_batch, max_abs_err, ms = card_ms,
plain_ms, bound_ms, bound_by, share_of_bound, library_ms), the
nvidia-smi line, and as
the last line ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}``. Without CUDA it exits non-zero before printing any
result. Details go to ``chip_smoke.json`` in the output directory
``OUT``. It never imports jax or theia_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
BATCH = 262_144
MAX_PATH = 10
SMALL_BATCH = 4096
GRAD_BATCH = 2048
GRAD_PATH = 3
#: the light source off centre, where polarization changes the light curve
OFF_CENTRE = (3.0, 0.6, 0.0)
#: published peaks of one H100 SXM: HBM bytes/s, float32 flop/s outside the
#: tensor cores, and int32 op/s (half the float32 lanes)
PEAK_BYTES, PEAK_F32, PEAK_I32 = 3.35e12, 67e12, 33.5e12
#: float32 operations a (ray, triangle) pair costs in the kernels' two
#: rejection tests (an FMA counts two; recounted from sphere_miss() in
#: csrc/nearest_scan.cuh and reject() in csrc/intersect_*.cu) and in their
#: exact tests (the reciprocal and its Newton step as 4)
PAIR_FLOP = {"mt": (27, 41, 48), "woop": (25, 46, 44)}


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_rays(n: int, seed: int, device):
    """Rays from around the scene, half aimed near the spheres, with a mix
    of finite and infinite t_max (like the tracer's primary and shadow
    queries)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.0, -1.0, -1.0], [4.5, 4.0, 1.0], size=(n, 3))
    centers = np.asarray([[3.0, 0.0, 0.0], [0.0, 3.0, 0.0]])[rng.integers(0, 2, n)]
    aim = centers + rng.normal(scale=0.5, size=(n, 3))
    d = np.where(rng.uniform(size=(n, 1)) < 0.5, aim - o, rng.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0.5, 5.0, size=n), np.inf)
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return f32(o), f32(d), f32(tmax)


def check_philox(report):
    """Kernel 2 against the plain version, bit-exact, single and pair."""
    import numpy as np
    import torch

    from theia_tpu_torch.random import PhiloxRNG, philox_uniform, philox_uniform_plain

    n = 1 << 20
    rng = np.random.default_rng(2)
    stream = torch.arange(n, dtype=torch.int32, device="cuda")
    dim = torch.as_tensor(rng.integers(0, 74, size=n).astype(np.int32), device="cuda")
    gen = PhiloxRNG(key=(1 << 64) - 5, offset=(1 << 30) - 3)  # key and counter carries
    key, ctr = gen.key_words, gen.counter_words
    for width in (1, 2):
        got = philox_uniform(key, ctr, stream, dim, width)
        torch.cuda.synchronize()
        want = philox_uniform_plain(key, ctr, stream.cpu(), dim.cpu(), width)
        assert torch.equal(got.cpu(), want), f"philox width {width} differs"
    ms = cuda_ms(lambda: philox_uniform(key, ctr, stream, dim, 2), 50)
    plain_ms = cuda_ms(lambda: philox_uniform_plain(key, ctr, stream, dim, 2), 5)
    # per lane: 8 bytes read, 8 written; ten rounds of 4 multiplies, 4 xors
    # and 2 key adds, the counter set-up and two conversions: ~116 int32 ops.
    # No library call: torch's Philox draws other words from the same key.
    b = bound(16 * n, 116 * n, PEAK_I32)
    print(f"kernel philox N={n}: bit-exact (width 1 and 2); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}, library call: none")
    report.update(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def check_histogram(report):
    """Kernel 3 against the plain version, rtol 1e-4 per bin (atomic
    order varies from run to run)."""
    import numpy as np
    import torch

    from theia_tpu_torch.response import _hist_bins, histogram_add, histogram_add_plain

    n, bins = 2 * BATCH, 100
    rng = np.random.default_rng(3)
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device="cuda")
    value = f32(rng.uniform(0.0, 2.0, size=n))
    time_ = f32(rng.uniform(-10.0, 520.0, size=n))
    mask = torch.as_tensor(rng.uniform(size=n) < 0.5, device="cuda")
    t0 = torch.tensor(0.0, device="cuda")
    bin_size = torch.tensor(5.0, device="cuda")
    got = histogram_add(torch.zeros(bins, device="cuda"), value, time_, mask, t0, bin_size, bins)
    torch.cuda.synchronize()
    want = histogram_add_plain(
        torch.zeros(bins), value.cpu(), time_.cpu(), mask.cpu(), t0.cpu(), bin_size.cpu(), bins
    )
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=0.0)
    state = torch.zeros(bins, device="cuda")
    ms = cuda_ms(lambda: histogram_add(state, value, time_, mask, t0, bin_size, bins), 50)
    plain_ms = cuda_ms(
        lambda: histogram_add_plain(state, value, time_, mask, t0, bin_size, bins), 10
    )
    err = float((got.cpu() - want).abs().max())
    # the yardstick: one index_add_ on bins and masked values made beforehand
    # (the kernel also computes the bins and applies the mask)
    keep, flat = _hist_bins(time_, mask, t0, bin_size, bins, None, None)
    masked = torch.where(keep, value, 0.0)
    library_ms = cuda_ms(lambda: state.index_add_(0, flat, masked), 50)
    # per item: value, time and mask read (9 bytes); ~8 float32 operations
    b = bound(9 * n + 8 * bins, 8 * n)
    print(f"kernel histogram N={n} bins={bins}: rtol 1e-4 ok (max abs err {err:.3g}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms; "
          f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    report.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **b)


def bound(n_bytes: float, flop: float, peak: float = PEAK_F32) -> dict:
    """bound_ms and bound_by of a call that must move ``n_bytes`` and do
    ``flop`` operations of peak rate ``peak``."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, flop / peak * 1e3
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations")


class Nearest:
    """One of the three nearest-hit entry points with its plain version,
    its pack on the card and on the CPU, and its rejection twin."""

    def __init__(self, name, scene_pack):
        from theia_tpu_torch.ops import intersect_mt as tmt
        from theia_tpu_torch.ops import intersect_woop as twoop

        self.name, self.table = name, None
        if name == "nearest_triangle_woop":
            p = self.pack = scene_pack.woop
            self.cpu_pack = twoop.WoopPack(p.b.cpu(), p.aabb, p.lo, p.hi, p.n_tri, p.chunk_box.cpu())
            self.kernel, self.plain = twoop.nearest_triangle_woop, twoop.nearest_triangle_woop_plain
            self.rejects = (twoop._woop_sphere_miss_plain, twoop._woop_reject_plain)
            self.flop = PAIR_FLOP["woop"]
        else:
            p = self.pack = scene_pack.mt
            self.cpu_pack = tmt.MTPack(p.tri.cpu(), p.aabb, p.lo, p.hi, p.n_tri)
            assert (self.cpu_pack.chunk_box == p.chunk_box.cpu()).all(), "chunk boxes differ"
            self.kernel, self.plain = tmt.nearest_triangle_mt, tmt.nearest_triangle_mt_plain
            self.rejects = (tmt._mt_sphere_miss_plain, tmt._mt_reject_plain)
            self.flop = PAIR_FLOP["mt"]
            if name == "nearest_triangle_mt_rows":
                self.table = scene_pack.tri_data
                self.kernel, self.plain = tmt.nearest_triangle_mt_rows, tmt.nearest_triangle_mt_rows_plain
        # the tables are derived on their device: float64 products may round
        # another way there, which can move a float32 entry by an ulp
        import torch

        torch.testing.assert_close(self.cpu_pack.tri_aos, p.tri_aos.cpu(), rtol=1e-6, atol=1e-7)

    def run(self, fn, pack, rays, **kw):
        tables = (pack,) if self.table is None else (pack, self.table.to(rays[0].device))
        return fn(*tables, *rays, **kw)

    def check(self, rays, label, on_cpu: bool, count: bool = False):
        """Kernel against plain (on the CPU copy of the inputs, or on the
        card), bit for bit; returns (max |t diff| over hits, hit share,
        stats). With ``count``, stats holds the (ray, triangle) pairs that
        the plain walk tested ("pairs") and how many of them pass the
        twins of the first ("sphere") and of both ("both") rejection
        tests: the work these rays need."""
        import torch

        from theia_tpu_torch.ops.intersect_mt import CHUNK

        got = self.run(self.kernel, self.pack, rays)
        torch.cuda.synchronize()
        pack = self.cpu_pack if on_cpu else self.pack
        stats = {}
        if count:
            aos = pack.tri_aos[: pack.n_tri]
            stats["tests"] = {
                name: (lambda o, d, c0, reject=reject: ~reject(aos[c0 : c0 + CHUNK], o, d))
                for name, reject in zip(("sphere", "both"), self.rejects)
            }
        if on_cpu:
            want = self.run(self.plain, pack, [r.cpu() for r in rays], stats=stats)
            got = [g.cpu() for g in got]
        else:
            want = self.run(self.plain, pack, rays, stats=stats)
        for what, g, w in zip(("t", "idx", "rows"), got, want):
            assert torch.equal(g, w), f"{self.name}: {what} differs from plain on {label}"
        hit = want[1] >= 0
        err = float((got[0][hit] - want[0][hit]).abs().max()) if bool(hit.any()) else 0.0
        stats.pop("tests", None)
        return err, float(hit.float().mean()), stats

    def bound(self, n_rays: int, stats: dict) -> dict:
        """The least time for queries of ``n_rays`` rays in all whose
        needed pairs ``stats`` counts."""
        n_bytes = n_rays * (28 + 8) + self.pack.tri_aos.numel() * 4 + self.pack.chunk_box.numel() * 4
        if self.table is not None:
            n_bytes += n_rays * 128 + self.pack.n_tri * 128
        f0, f1, f2 = self.flop
        return bound(n_bytes, stats["pairs"] * f0 + stats["sphere"] * f1 + stats["both"] * f2)


def check_nearest(nearest: Nearest, adversarial, queries, report):
    """A nearest-hit kernel against its plain version, bit-equal t and idx
    (and rows): random rays at N = 262,144 and 524,288 with times and
    bound, adversarial rays, and the recorded queries of one flagship
    batch, replayed for the time and bound a batch sees."""
    import torch

    name, worst = nearest.name, 0.0
    for n in (BATCH, 2 * BATCH):
        rays = random_rays(n, n + len(name), "cuda")
        err, hits, _ = nearest.check(rays, f"random rays N={n}", on_cpu=True)
        _, _, stats = nearest.check(rays, f"random rays N={n} (plain on the card)", on_cpu=False, count=True)
        worst = max(worst, err)
        ms = cuda_ms(lambda: nearest.run(nearest.kernel, nearest.pack, rays), 20)
        plain_ms = cuda_ms(lambda: nearest.run(nearest.plain, nearest.pack, rays), 2)
        b = nearest.bound(n, stats)
        print(
            f"kernel {name} N={n}: bit-equal to plain, hits {hits:.4f}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms; {stats['pairs']} of {n * nearest.pack.n_tri} pairs needed, "
            f"{stats['sphere']} of them survive the sphere test and {stats['both']} both rejection tests; "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}, share of bound {b['bound_ms'] / ms:.3f}"
        )
        if n == BATCH:
            report.update(ms=ms, plain_ms=plain_ms, **b, n=n, **stats)
        else:
            report.update(double=dict(n=n, ms=ms, plain_ms=plain_ms, **b, **stats))
    err, hits, _ = nearest.check(adversarial, "adversarial rays", on_cpu=True)
    print(f"kernel {name}: bit-equal to plain on {adversarial[0].shape[0]} adversarial rays, hits {hits:.4f}")
    worst = max(worst, err)
    # the recorded batch: bit-equality (plain on the card), then a replay
    total = dict(pairs=0, sphere=0, both=0)
    n_rays = 0
    for q in queries:
        err, _, stats = nearest.check(q, "a recorded flagship query", on_cpu=False, count=True)
        worst, n_rays = max(worst, err), n_rays + q[0].shape[0]
        total = {k: v + stats.get(k, 0) for k, v in total.items()}

    def replay():
        for q in queries:
            nearest.run(nearest.kernel, nearest.pack, q)

    batch_ms = cuda_ms(replay, 5)
    b = nearest.bound(n_rays, total)
    print(
        f"kernel {name}: bit-equal to plain on the {len(queries)} recorded queries of a flagship batch "
        f"({n_rays} rays); replayed {batch_ms:.4f} ms a batch; {total['pairs']} of "
        f"{n_rays * nearest.pack.n_tri} pairs needed, {total['sphere']} / {total['both']} of them survive; "
        f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}, share of bound {b['bound_ms'] / batch_ms:.3f}"
    )
    report.update(
        max_abs_err=worst, library_ms=None,
        batch=dict(queries=len(queries), rays=n_rays, ms=batch_ms, **total, **b),
    )


def record_queries(tracer, names):
    """Run one batch of ``tracer`` and return the (origin, direction,
    t_max) of every call it makes to the nearest-hit wrapper
    ``accel.<name>`` for ``name`` in ``names``, in order."""
    import torch

    from theia_tpu_torch import accel

    queries = []

    def recording(fn):
        def wrapper(*args):
            o, d, t_max = args[-3:]
            t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device), o.shape[:1])
            queries.append((o.clone(), d.clone(), t_max.clone().contiguous()))
            return fn(*args)
        return wrapper

    saved = {name: getattr(accel, name) for name in names}
    try:
        for name, fn in saved.items():
            setattr(accel, name, recording(fn))
        offset = tracer.rng.offset
        tracer.run()
        tracer.rng.offset = offset  # the timed batches start where they always did
    finally:
        for name, fn in saved.items():
            setattr(accel, name, fn)
    torch.cuda.synchronize()
    return queries


def abc_experiment(nearest_rows: Nearest, report):
    """The A/B/C experiment of tools/exp_mt_fused.py at N = 262,144: A the
    MT kernel alone, B the kernel that writes the winner rows, C the MT
    kernel plus a torch row gather."""
    import torch

    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt, nearest_triangle_mt_rows

    pack, table = nearest_rows.pack, nearest_rows.table
    o, d, tmax = random_rays(BATCH, 11, "cuda")

    def run_c():
        t, i = nearest_triangle_mt(pack, o, d, tmax)
        return t, i, table[torch.clamp_min(i, 0).long()]

    assert torch.equal(nearest_triangle_mt_rows(pack, table, o, d, tmax)[2], run_c()[2]), "B rows differ from C rows"
    times = {
        "A": cuda_ms(lambda: nearest_triangle_mt(pack, o, d, tmax), 20),
        "B": cuda_ms(lambda: nearest_triangle_mt_rows(pack, table, o, d, tmax), 20),
        "C": cuda_ms(run_c, 20),
    }
    print(
        f"A/B/C at N={BATCH}: B rows == C rows; A (MT) {times['A']:.4f} ms, "
        f"B (MT + rows in kernel) {times['B']:.4f} ms, C (MT + torch gather) {times['C']:.4f} ms; "
        f"B < C: {times['B'] < times['C']}"
    )
    report.update(experiment_ms=times)


def check_histogram_grad(report):
    """Kernel C against the plain version, bit-exact (it sums nothing)."""
    import numpy as np
    import torch

    from theia_tpu_torch.response import _hist_bins, histogram_grad, histogram_grad_plain

    n, bins = 2 * BATCH, 100
    rng = np.random.default_rng(5)
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device="cuda")
    grad_state = f32(rng.normal(size=bins))
    time_ = f32(rng.uniform(-10.0, 520.0, size=n))
    mask = torch.as_tensor(rng.uniform(size=n) < 0.5, device="cuda")
    t0 = torch.tensor(0.0, device="cuda")
    bin_size = torch.tensor(5.0, device="cuda")
    got = histogram_grad(grad_state, time_, mask, t0, bin_size, bins)
    torch.cuda.synchronize()
    want = histogram_grad_plain(grad_state.cpu(), time_.cpu(), mask.cpu(), t0.cpu(), bin_size.cpu(), bins)
    assert torch.equal(got.cpu(), want), "histogram backward differs"
    ms = cuda_ms(lambda: histogram_grad(grad_state, time_, mask, t0, bin_size, bins), 50)
    plain_ms = cuda_ms(lambda: histogram_grad_plain(grad_state, time_, mask, t0, bin_size, bins), 10)
    # the yardstick: one index_select on bins made beforehand (the kernel
    # also computes the bins and zeroes the dropped lanes)
    _, flat = _hist_bins(time_, mask, t0, bin_size, bins, None, None)
    library_ms = cuda_ms(lambda: torch.index_select(grad_state, 0, flat), 50)
    # per item: time and mask read, one float written (9 bytes); ~7 operations
    b = bound(9 * n + 4 * bins, 7 * n)
    print(f"kernel histogram_grad N={n} bins={bins}: bit-exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_select {library_ms:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    report.update(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **b)


def timed_runs(tracer, wrappers, label):
    """One warm-up and three timed ``run()``s of ``tracer`` with the launch
    counts of ``wrappers`` set to 0 just before the timed runs; returns
    (seconds, histogram sums, launch counts, peak bytes)."""
    import torch

    tracer.run()  # warm-up batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    seconds, sums = [], []
    for _ in range(3):
        start = time.perf_counter()
        hist, _ = tracer.run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        assert hist.shape == (100,) and bool(torch.isfinite(hist).all()), f"{label}: bad histogram"
        sums.append(float(hist.sum()))
        assert sums[-1] > 0.0, f"{label}: empty histogram"
    counts = {name: w.launches for name, w in wrappers.items()}
    return seconds, sums, counts, torch.cuda.max_memory_allocated()


def absorption_grad(tracer):
    """d sum(histogram state) / d (water absorption_coef row) through
    ``trace_fn()``; returns (loss, gradient) as float64 numpy."""
    import torch

    fn, (p, counter, streams) = tracer.trace_fn()
    media = p["scene"].media
    h = media.handle("water")
    leaf = media.tables["absorption_coef"][h].clone().requires_grad_(True)
    table = media.tables["absorption_coef"].clone()
    table[h] = leaf
    tables = {**media.tables, "absorption_coef": table}
    pp = dict(p)
    pp["scene"] = dataclasses.replace(p["scene"], media=dataclasses.replace(media, tables=tables))
    state, _ = fn(pp, counter, streams)
    loss = state.sum()
    loss.backward()
    return loss.item(), leaf.grad.double().cpu().numpy()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import theia_tpu_torch
    from theia_tpu_torch import _build, accel
    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt, nearest_triangle_mt_rows
    from theia_tpu_torch.ops.intersect_woop import nearest_triangle_woop
    from theia_tpu_torch.random import philox_uniform
    from theia_tpu_torch.response import histogram_add, histogram_grad
    from torch_flagship import adversarial_rays, build_flagship, icosphere

    # phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "python", sys.version.split()[0])
    lib = _build.library()
    print(f"build: {lib.build_seconds:.1f} s with nvcc -> {lib.path.name}")
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_build.log").write_text(lib.build_log)
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    # phase 2: kernels against their plain versions at the main path's shapes
    mesh = icosphere(3)
    tracer = build_flagship(theia_tpu_torch, mesh, BATCH, MAX_PATH, device="cuda")
    pol_tracer = build_flagship(
        theia_tpu_torch, mesh, BATCH, MAX_PATH, accel="woop", polarized=True, device="cuda"
    )
    kernels = {
        "nearest_triangle_mt": dict(
            route="cuda", source="theia_tpu_torch/csrc/intersect_mt.cu",
            replaces="theia_tpu/ops/intersect_mt_pallas.py:158",
        ),
        "philox_uniform": dict(
            route="cuda", source="theia_tpu_torch/csrc/philox.cu",
            replaces="theia_tpu/random.py:121",
        ),
        "histogram_add": dict(
            route="cuda", source="theia_tpu_torch/csrc/histogram.cu",
            replaces="theia_tpu/response.py:226",
        ),
        "nearest_triangle_woop": dict(
            route="cuda", source="theia_tpu_torch/csrc/intersect_woop.cu",
            replaces="theia_tpu/ops/intersect_woop.py:198",
        ),
        "nearest_triangle_mt_rows": dict(
            route="cuda", source="theia_tpu_torch/csrc/intersect_mt.cu",
            replaces="tools/exp_mt_fused.py:68",
        ),
        "histogram_grad": dict(
            route="cuda", source="theia_tpu_torch/csrc/histogram.cu",
            replaces="theia_tpu/response.py:226",
        ),
    }
    rows = tracer.scene.pack.tri_data[:, 18:27].cpu().numpy()
    adversarial = tuple(
        torch.as_tensor(a, device="cuda")
        for a in (*adversarial_rays(rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], seed=7, per_kind=512),)
    )
    adversarial += (torch.full((adversarial[0].shape[0],), torch.inf, device="cuda"),)
    mt_queries = record_queries(tracer, ("nearest_triangle_mt_rows",))
    woop_queries = record_queries(pol_tracer, ("nearest_triangle_woop",))
    assert len(mt_queries) == len(woop_queries) == 2 * MAX_PATH - 1, (len(mt_queries), len(woop_queries))
    for name, queries in (
        ("nearest_triangle_mt", mt_queries),
        ("nearest_triangle_woop", woop_queries),
        ("nearest_triangle_mt_rows", mt_queries),
    ):
        scene_pack = (pol_tracer if name == "nearest_triangle_woop" else tracer).scene.pack
        nearest = Nearest(name, scene_pack)
        check_nearest(nearest, adversarial, queries, kernels[name])
        if name == "nearest_triangle_mt_rows":
            abc_experiment(nearest, kernels[name])
    del mt_queries, woop_queries, queries, nearest
    check_philox(kernels["philox_uniform"])
    check_histogram(kernels["histogram_add"])
    check_histogram_grad(kernels["histogram_grad"])

    # phase 3: the first main path (accel="mt") at full width
    wrappers = {
        "nearest_triangle_mt": nearest_triangle_mt,
        "nearest_triangle_mt_rows": nearest_triangle_mt_rows,
        "nearest_triangle_woop": nearest_triangle_woop,
        "philox_uniform": philox_uniform,
        "histogram_add": histogram_add,
    }
    seconds, sums, counts, peak = timed_runs(tracer, wrappers, "mt path")
    assert counts["nearest_triangle_mt_rows"] == 19 * 3, counts  # 10 primary + 9 shadow
    assert counts["nearest_triangle_mt"] == counts["nearest_triangle_woop"] == 0, counts
    assert counts["philox_uniform"] > 0 and counts["histogram_add"] > 0, counts
    med = statistics.median(seconds)
    print(
        f"main path (mt): batch {BATCH}, path length {MAX_PATH}, {tracer.scene.pack.mt.n_tri} triangles: "
        f"{med:.4f} s/batch (median of {[round(s, 4) for s in seconds]}), "
        f"{BATCH * MAX_PATH / med:.6g} bounces/s, peak memory {peak / 2**20:.1f} MiB, "
        f"launches per batch {{{', '.join(f'{k}: {v // 3}' for k, v in counts.items())}}}, "
        f"histogram sums {sums}"
    )
    for name in ("nearest_triangle_mt_rows", "philox_uniform", "histogram_add"):
        kernels[name].update(launches=counts[name], launches_per_batch=counts[name] // 3,
                             path="mt flagship, 3 batches")
    # the winners' rows from the kernel and from a torch gather, in turns
    turns = []
    for from_query in (True, False, False, True):
        accel.MT_ROWS_FROM_QUERY = from_query
        turn_seconds, _, turn_counts, _ = timed_runs(tracer, wrappers, "mt path")
        own, other = "nearest_triangle_mt_rows", "nearest_triangle_mt"
        if not from_query:
            own, other = other, own
        assert turn_counts[own] == 19 * 3 and turn_counts[other] == 0, turn_counts
        turns.append(dict(rows_from_kernel=from_query, seconds_per_batch=turn_seconds))
        if not from_query:
            kernels["nearest_triangle_mt"].update(
                launches=turn_counts[own], launches_per_batch=19,
                path="mt flagship with the torch gather, 3 batches",
            )
    accel.MT_ROWS_FROM_QUERY = True
    print("main path (mt), rows from the kernel / a torch gather, in turns: " + "; ".join(
        f"{'kernel' if t['rows_from_kernel'] else 'gather'} {statistics.median(t['seconds_per_batch']):.4f} s "
        f"{[round(x, 4) for x in t['seconds_per_batch']]}" for t in turns
    ))
    del tracer
    torch.cuda.empty_cache()

    # phase 3b: the second main path (accel="woop", polarized) at full width
    pol_seconds, pol_sums, pol_counts, pol_peak = timed_runs(pol_tracer, wrappers, "woop path")
    assert pol_counts["nearest_triangle_woop"] == 19 * 3, pol_counts
    assert pol_counts["nearest_triangle_mt"] == pol_counts["nearest_triangle_mt_rows"] == 0, pol_counts
    assert pol_counts["philox_uniform"] > 0 and pol_counts["histogram_add"] > 0, pol_counts
    pol_med = statistics.median(pol_seconds)
    print(
        f"main path (woop, polarized): batch {BATCH}, path length {MAX_PATH}: "
        f"{pol_med:.4f} s/batch (median of {[round(s, 4) for s in pol_seconds]}), "
        f"{BATCH * MAX_PATH / pol_med:.6g} bounces/s, peak memory {pol_peak / 2**20:.1f} MiB, "
        f"launches per batch {{{', '.join(f'{k}: {v // 3}' for k, v in pol_counts.items())}}}, "
        f"histogram sums {pol_sums}"
    )
    kernels["nearest_triangle_woop"].update(
        launches=pol_counts["nearest_triangle_woop"], launches_per_batch=19,
        path="polarized woop flagship, 3 batches",
    )

    # phase 3c: the gradient at full width, on the same tracer (the
    # largest power-of-two batch that fits, should the full one not)
    grad_batch = BATCH
    while True:
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            histogram_grad.launches = 0
            start = time.perf_counter()
            loss, grad = absorption_grad(pol_tracer)
            torch.cuda.synchronize()
            grad_seconds = time.perf_counter() - start
            grad_launches = histogram_grad.launches
            break
        except torch.cuda.OutOfMemoryError:
            grad_batch //= 2
            assert grad_batch >= 1024, "the gradient does not fit at batch 1024"
            pol_tracer = build_flagship(
                theia_tpu_torch, mesh, grad_batch, MAX_PATH, accel="woop", polarized=True, device="cuda"
            )
    grad_peak = torch.cuda.max_memory_allocated()
    assert np.isfinite(grad).all() and np.isfinite(loss), "non-finite gradient"
    assert grad.sum() <= 0.0, f"d sum / d mu_a summed is {grad.sum()} > 0"
    assert grad_launches > 0, "the histogram backward never launched"
    print(
        f"gradient (woop, polarized): batch {grad_batch}{'' if grad_batch == BATCH else ' (largest that fits)'}, "
        f"path length {MAX_PATH}: forward + backward {grad_seconds:.4f} s, peak memory "
        f"{grad_peak / 2**20:.1f} MiB, loss {loss:.6g}, d loss / d mu_a summed {grad.sum():.6g}, "
        f"{int((grad != 0).sum())} nonzero entries, histogram_grad launches {grad_launches}"
    )
    kernels["histogram_grad"].update(
        launches=grad_launches, launches_per_batch=grad_launches, path="polarized woop gradient, 1 step"
    )
    del pol_tracer
    torch.cuda.empty_cache()

    # phase 4: the port on the CPU against the port on the card
    cpu_vs_card = {}
    for label, kw in (
        ("mt", {}),
        ("woop polarized off centre", dict(accel="woop", polarized=True, source_position=OFF_CENTRE)),
    ):
        dims, hists = {}, {}
        for dev in ("cpu", "cuda"):
            small = build_flagship(theia_tpu_torch, mesh, SMALL_BATCH, MAX_PATH, device=dev, **kw)
            small._debug_rng = True
            p = small.params()
            with torch.no_grad():
                state, _, dim = small._trace_batch(p, small.rng.counter_words, small.streams())
            hists[dev] = small.response.result(p["response"], state).double().cpu()
            dims[dev] = dim.cpu()
        same = float((dims["cpu"] == dims["cuda"]).double().mean())
        d_sum = abs(float(hists["cuda"].sum() / hists["cpu"].sum()) - 1.0)
        l1 = float((hists["cuda"] - hists["cpu"]).abs().sum() / hists["cpu"].sum())
        print(f"cpu vs card ({label}) at batch {SMALL_BATCH}: rng dims equal {same:.6f}, "
              f"histogram sum rel diff {d_sum:.3g}, per-bin L1 {l1:.3g}")
        assert same >= 0.995 and d_sum <= 1e-3 and l1 <= 1e-2, f"cpu and card disagree ({label})"
        cpu_vs_card[label] = dict(dims_equal=same, sum_rel=d_sum, l1=l1)
    grads = {}
    for dev in ("cpu", "cuda"):
        small = build_flagship(
            theia_tpu_torch, mesh, GRAD_BATCH, GRAD_PATH, accel="woop", polarized=True, device=dev
        )
        grads[dev] = absorption_grad(small)[1]
    g_cpu, g_card = grads["cpu"], grads["cuda"]
    rel = np.abs(g_card - g_cpu) / np.maximum(np.abs(g_cpu), 1e-300)
    worst = float(rel[g_cpu != 0].max())
    sum_rel = abs(g_card.sum() / g_cpu.sum() - 1.0)
    print(f"cpu vs card (gradient) at batch {GRAD_BATCH}, path length {GRAD_PATH}: "
          f"{int((g_cpu != 0).sum())} nonzero entries, worst entry rel diff {worst:.3g}, sum rel diff {sum_rel:.3g}")
    assert np.array_equal(g_cpu != 0, g_card != 0), "gradient nonzero pattern differs"
    assert worst <= 1e-3 and sum_rel <= 1e-5, "cpu and card gradients disagree"
    cpu_vs_card["gradient"] = dict(worst_entry_rel=worst, sum_rel=sum_rel)

    for info in kernels.values():
        assert info["launches"] > 0, info
        info.update(card_ms=info["ms"], share_of_bound=info["bound_ms"] / info["ms"])
    line = {"kernels": [dict(name=name, **info) for name, info in kernels.items()]}
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, build_seconds=lib.build_seconds,
        mt_path=dict(seconds_per_batch=seconds, bounces_per_s=BATCH * MAX_PATH / med,
                     peak_bytes=peak, histogram_sums=sums, launches=counts, row_source_turns=turns),
        woop_polarized_path=dict(seconds_per_batch=pol_seconds, bounces_per_s=BATCH * MAX_PATH / pol_med,
                                 peak_bytes=pol_peak, histogram_sums=pol_sums, launches=pol_counts),
        gradient=dict(batch=grad_batch, seconds=grad_seconds, peak_bytes=grad_peak, loss=loss,
                      grad_sum=float(grad.sum()), grad=grad.tolist(), histogram_grad_launches=grad_launches),
        cpu_vs_card=cpu_vs_card, **line,
    ), indent=1))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
