#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``theia_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi), then the kernels' build
   from ``theia_tpu_torch/csrc`` with nvcc (one process per source, run
   together) and its seconds;
2. each hand-written kernel against its plain PyTorch version at the main
   paths' shapes (the plain version runs on the inputs moved to the CPU),
   with its time beside the plain version's on the card (CUDA events);
   the Moeller-Trumbore kernel with winner rows also runs the A/B/C
   experiment of ``tools/exp_mt_fused.py`` (kernel alone, kernel with
   rows, kernel plus a torch gather) and prints its decision rule;
3. the first main path at full width: the flagship scene tracer
   (262,144 lanes, path length 10, 3840 triangles, 100 bins,
   ``accel="mt"``) through ``run()``, one warm-up batch and three timed
   ones, with the kernels' launch counts;
3b. the second main path at full width: the polarized flagship on the
   Woop query (``accel="woop", polarized=True``), the same way;
3c. its gradient at full width: one ``trace_fn()`` forward and backward
   of sum(histogram state) with respect to the water absorption table;
4. the port on the CPU against the port on the card: the unpolarized
   ``mt`` flagship and the polarized ``woop`` flagship with the source
   off centre at batch 4096, and the gradient at batch 2048, path
   length 3.

Every path's launch counts are set to 0 just before it runs and read
just after. Then one JSON line of kernels, the nvidia-smi line, and as
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


def check_mt(pack, report):
    """Kernel 1 against the plain version, bit-equal t and idx."""
    import torch

    from theia_tpu_torch.ops.intersect_mt import (
        MTPack,
        nearest_triangle_mt,
        nearest_triangle_mt_plain,
    )

    cpu_pack = MTPack(pack.tri.cpu(), pack.aabb, pack.lo, pack.hi, pack.n_tri)
    assert torch.equal(cpu_pack.chunk_box, pack.chunk_box.cpu()), "chunk boxes differ"
    worst = 0.0
    for n in (BATCH, 2 * BATCH):
        o, d, tmax = random_rays(n, n, "cuda")
        t_k, i_k = nearest_triangle_mt(pack, o, d, tmax)
        torch.cuda.synchronize()
        t_p, i_p = nearest_triangle_mt_plain(cpu_pack, o.cpu(), d.cpu(), tmax.cpu())
        assert torch.equal(i_k.cpu(), i_p), f"MT idx differs at N={n}"
        assert torch.equal(t_k.cpu(), t_p), f"MT t differs at N={n}"
        hit = i_p >= 0
        worst = max(worst, float((t_k.cpu()[hit] - t_p[hit]).abs().max()))
        ms = cuda_ms(lambda: nearest_triangle_mt(pack, o, d, tmax), 20)
        plain_ms = cuda_ms(lambda: nearest_triangle_mt_plain(pack, o, d, tmax), 2)
        print(
            f"kernel mt N={n}: idx and t bit-equal to plain, hits {float(hit.float().mean()):.4f}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        )
    report.update(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


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
    print(f"kernel philox N={n}: bit-exact (width 1 and 2); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    report.update(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)


def check_histogram(report):
    """Kernel 3 against the plain version, rtol 1e-4 per bin (atomic
    order varies from run to run)."""
    import numpy as np
    import torch

    from theia_tpu_torch.response import histogram_add, histogram_add_plain

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
    print(f"kernel histogram N={n} bins={bins}: rtol 1e-4 ok (max abs err {err:.3g}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    report.update(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_woop(pack, report):
    """Kernel A against the plain version, bit-equal t and idx."""
    import torch

    from theia_tpu_torch.ops.intersect_woop import (
        WoopPack,
        nearest_triangle_woop,
        nearest_triangle_woop_plain,
    )

    cpu_pack = WoopPack(pack.b.cpu(), pack.aabb, pack.lo, pack.hi, pack.n_tri, pack.chunk_box.cpu())
    worst = 0.0
    for n in (BATCH, 2 * BATCH):
        o, d, tmax = random_rays(n, n + 1, "cuda")
        t_k, i_k = nearest_triangle_woop(pack, o, d, tmax)
        torch.cuda.synchronize()
        t_p, i_p = nearest_triangle_woop_plain(cpu_pack, o.cpu(), d.cpu(), tmax.cpu())
        assert torch.equal(i_k.cpu(), i_p), f"Woop idx differs at N={n}"
        assert torch.equal(t_k.cpu(), t_p), f"Woop t differs at N={n}"
        hit = i_p >= 0
        worst = max(worst, float((t_k.cpu()[hit] - t_p[hit]).abs().max()))
        ms = cuda_ms(lambda: nearest_triangle_woop(pack, o, d, tmax), 20)
        plain_ms = cuda_ms(lambda: nearest_triangle_woop_plain(pack, o, d, tmax), 2)
        print(
            f"kernel woop N={n}: idx and t bit-equal to plain, hits {float(hit.float().mean()):.4f}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        )
    report.update(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


def check_mt_rows(pack, table, report, counted):
    """Kernel B against the plain version (bit-equal t, idx and rows), then
    the A/B/C experiment of tools/exp_mt_fused.py at N = 262,144: A the MT
    kernel alone, B the kernel that writes the winner rows, C the MT
    kernel plus a torch row gather. Its launches are counted over the
    experiment's own runs."""
    import torch

    from theia_tpu_torch.ops.intersect_mt import (
        MTPack,
        nearest_triangle_mt,
        nearest_triangle_mt_rows,
        nearest_triangle_mt_rows_plain,
    )

    o, d, tmax = random_rays(BATCH, 11, "cuda")
    t_k, i_k, r_k = nearest_triangle_mt_rows(pack, table, o, d, tmax)
    torch.cuda.synchronize()
    cpu_pack = MTPack(pack.tri.cpu(), pack.aabb, pack.lo, pack.hi, pack.n_tri)
    t_p, i_p, r_p = nearest_triangle_mt_rows_plain(cpu_pack, table.cpu(), o.cpu(), d.cpu(), tmax.cpu())
    assert torch.equal(i_k.cpu(), i_p) and torch.equal(t_k.cpu(), t_p), "MT-rows (t, idx) differ"
    assert torch.equal(r_k.cpu(), r_p), "MT-rows rows differ"
    plain_ms = cuda_ms(lambda: nearest_triangle_mt_rows_plain(pack, table, o, d, tmax), 2)

    def run_c():
        t, i = nearest_triangle_mt(pack, o, d, tmax)
        return t, i, table[torch.clamp_min(i, 0).long()]

    _, _, r_c = run_c()
    assert torch.equal(r_k, r_c), "B rows differ from C rows"
    counted.launches = 0
    times = {
        "A": cuda_ms(lambda: nearest_triangle_mt(pack, o, d, tmax), 20),
        "B": cuda_ms(lambda: nearest_triangle_mt_rows(pack, table, o, d, tmax), 20),
        "C": cuda_ms(run_c, 20),
    }
    launches = counted.launches
    assert launches > 0
    print(
        f"kernel mt_rows N={BATCH}: t, idx and rows bit-equal to plain, B rows == C rows; "
        f"A (MT) {times['A']:.4f} ms, B (MT + rows in kernel) {times['B']:.4f} ms, "
        f"C (MT + torch gather) {times['C']:.4f} ms, plain {plain_ms:.4f} ms; "
        f"decision rule B < C: {times['B'] < times['C']} "
        f"({'wire kernel B into intersect_scene' if times['B'] < times['C'] else 'null'})"
    )
    report.update(max_abs_err=0.0, ms=times["B"], plain_ms=plain_ms, launches=launches,
                  path="exp_mt_fused A/B/C", experiment_ms=times)


def check_histogram_grad(report):
    """Kernel C against the plain version, bit-exact (it sums nothing)."""
    import numpy as np
    import torch

    from theia_tpu_torch.response import histogram_grad, histogram_grad_plain

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
    print(f"kernel histogram_grad N={n} bins={bins}: bit-exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    report.update(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)


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
    from theia_tpu_torch import _build
    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt, nearest_triangle_mt_rows
    from theia_tpu_torch.ops.intersect_woop import nearest_triangle_woop
    from theia_tpu_torch.random import philox_uniform
    from theia_tpu_torch.response import histogram_add, histogram_grad
    from torch_flagship import build_flagship, icosphere

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
    check_mt(tracer.scene.pack.mt, kernels["nearest_triangle_mt"])
    check_philox(kernels["philox_uniform"])
    check_histogram(kernels["histogram_add"])
    check_woop(pol_tracer.scene.pack.woop, kernels["nearest_triangle_woop"])
    check_mt_rows(
        tracer.scene.pack.mt, tracer.scene.pack.tri_data,
        kernels["nearest_triangle_mt_rows"], nearest_triangle_mt_rows,
    )
    check_histogram_grad(kernels["histogram_grad"])

    # phase 3: the first main path (accel="mt") at full width
    wrappers = {
        "nearest_triangle_mt": nearest_triangle_mt,
        "nearest_triangle_woop": nearest_triangle_woop,
        "philox_uniform": philox_uniform,
        "histogram_add": histogram_add,
    }
    seconds, sums, counts, peak = timed_runs(tracer, wrappers, "mt path")
    assert counts["nearest_triangle_mt"] == 19 * 3, counts  # 10 primary + 9 shadow
    assert counts["nearest_triangle_woop"] == 0, counts
    assert counts["philox_uniform"] > 0 and counts["histogram_add"] > 0, counts
    med = statistics.median(seconds)
    print(
        f"main path (mt): batch {BATCH}, path length {MAX_PATH}, {tracer.scene.pack.mt.n_tri} triangles: "
        f"{med:.4f} s/batch (median of {[round(s, 4) for s in seconds]}), "
        f"{BATCH * MAX_PATH / med:.6g} bounces/s, peak memory {peak / 2**20:.1f} MiB, "
        f"launches per batch {{{', '.join(f'{k}: {v // 3}' for k, v in counts.items())}}}, "
        f"histogram sums {sums}"
    )
    for name in ("nearest_triangle_mt", "philox_uniform", "histogram_add"):
        kernels[name].update(launches=counts[name], path="mt flagship, 3 batches")
    del tracer
    torch.cuda.empty_cache()

    # phase 3b: the second main path (accel="woop", polarized) at full width
    pol_seconds, pol_sums, pol_counts, pol_peak = timed_runs(pol_tracer, wrappers, "woop path")
    assert pol_counts["nearest_triangle_woop"] == 19 * 3, pol_counts
    assert pol_counts["nearest_triangle_mt"] == 0, pol_counts
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
        launches=pol_counts["nearest_triangle_woop"], path="polarized woop flagship, 3 batches"
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
    kernels["histogram_grad"].update(launches=grad_launches, path="polarized woop gradient, 1 step")
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

    line = {"kernels": [dict(name=name, **info) for name, info in kernels.items()]}
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, build_seconds=lib.build_seconds,
        mt_path=dict(seconds_per_batch=seconds, bounces_per_s=BATCH * MAX_PATH / med,
                     peak_bytes=peak, histogram_sums=sums, launches=counts),
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
