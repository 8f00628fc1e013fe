#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``theia_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi), then the kernels' build
   from ``theia_tpu_torch/csrc`` with nvcc and its seconds;
2. each hand-written kernel against its plain PyTorch version at the main
   path's shapes (the plain version runs on the inputs moved to the CPU),
   with its time beside the plain version's on the card (CUDA events);
3. the main path at full width: the flagship scene tracer (262,144 lanes,
   path length 10, 3840 triangles, 100 bins) through ``run()``, one
   warm-up batch and three timed ones, with the kernels' launch counts;
4. the port on the CPU against the port on the card at batch 4096.

Then one JSON line of kernels, the nvidia-smi line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA it exits non-zero before printing any result. Details go to
``chiprun_out/chip_smoke.json``. It never imports jax or theia_tpu.
"""

from __future__ import annotations

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import theia_tpu_torch
    from theia_tpu_torch import _build
    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt
    from theia_tpu_torch.random import philox_uniform
    from theia_tpu_torch.response import histogram_add
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
    }
    check_mt(tracer.scene.pack.mt, kernels["nearest_triangle_mt"])
    check_philox(kernels["philox_uniform"])
    check_histogram(kernels["histogram_add"])

    # phase 3: the main path at full width
    hist, _ = tracer.run()  # warm-up batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = {
        "nearest_triangle_mt": nearest_triangle_mt,
        "philox_uniform": philox_uniform,
        "histogram_add": histogram_add,
    }
    for w in wrappers.values():
        w.launches = 0
    seconds, sums = [], []
    for _ in range(3):
        start = time.perf_counter()
        hist, _ = tracer.run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        assert hist.shape == (100,) and bool(torch.isfinite(hist).all()), "bad histogram"
        sums.append(float(hist.sum()))
        assert sums[-1] > 0.0, "empty histogram"
    counts = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    assert counts["nearest_triangle_mt"] == 19 * 3, counts  # 10 primary + 9 shadow
    assert counts["philox_uniform"] > 0 and counts["histogram_add"] > 0, counts
    med = statistics.median(seconds)
    print(
        f"main path: batch {BATCH}, path length {MAX_PATH}, {tracer.scene.pack.mt.n_tri} triangles: "
        f"{med:.4f} s/batch (median of {[round(s, 4) for s in seconds]}), "
        f"{BATCH * MAX_PATH / med:.6g} bounces/s, peak memory {peak / 2**20:.1f} MiB, "
        f"launches per batch {{{', '.join(f'{k}: {v // 3}' for k, v in counts.items())}}}, "
        f"histogram sums {sums}"
    )

    # phase 4: the port on the CPU against the port on the card
    dims, hists = {}, {}
    for dev in ("cpu", "cuda"):
        small = build_flagship(theia_tpu_torch, mesh, SMALL_BATCH, MAX_PATH, device=dev)
        small._debug_rng = True
        p = small.params()
        with torch.no_grad():
            state, _, dim = small._trace_batch(p, small.rng.counter_words, small.streams())
        hists[dev] = small.response.result(p["response"], state).double().cpu()
        dims[dev] = dim.cpu()
    same = float((dims["cpu"] == dims["cuda"]).double().mean())
    d_sum = abs(float(hists["cuda"].sum() / hists["cpu"].sum()) - 1.0)
    l1 = float((hists["cuda"] - hists["cpu"]).abs().sum() / hists["cpu"].sum())
    print(f"cpu vs card at batch {SMALL_BATCH}: rng dims equal {same:.6f}, "
          f"histogram sum rel diff {d_sum:.3g}, per-bin L1 {l1:.3g}")
    assert same >= 0.995 and d_sum <= 1e-3 and l1 <= 1e-2, "cpu and card disagree"

    line = {"kernels": [
        dict(name=name, **info, launches=counts[name]) for name, info in kernels.items()
    ]}
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, build_seconds=lib.build_seconds, seconds_per_batch=seconds,
        bounces_per_s=BATCH * MAX_PATH / med, peak_bytes=peak, histogram_sums=sums,
        cpu_vs_card=dict(dims_equal=same, sum_rel=d_sum, l1=l1), **line,
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
