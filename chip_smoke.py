#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``theia_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi), then the kernels' build
   from ``theia_tpu_torch/csrc`` with nvcc (one process per source, run
   together) and its seconds;
2. the port's square root on the card (``ops.math3d.sqrt``, CUDA's
   float32 ``torch.sqrt``) bit for bit against the float64 route that it
   takes on the CPU, on 2^20 values; then each hand-written kernel
   against its plain PyTorch version at the main
   paths' shapes (the plain version runs on the inputs moved to the CPU),
   with its time beside the plain version's on the card (CUDA events),
   its bound (the larger of bytes over 3.35 TB/s and operations over 67
   TFLOP/s, counted from this run's inputs) and, where one PyTorch call
   computes the same function, that call's time as a yardstick. The
   small kernels are timed twice: as a caller sees them ("ms": host
   enqueue and device in a pipeline) and queued behind a spin kernel, so
   that only the device's time counts ("queued_ms"), beside an empty
   launch timed both ways. The histogram record and its backward are
   also held against their plain versions on odd sizes, offset views, a
   detector axis, an all-masked record, a state above 48 KB and one
   above what shared memory holds (the record's second variant), and on
   the recorded records of one flagship batch of each path (19; 38 on
   the polarized path, which records unfused), replayed
   for the time and the bound that a batch sees. The three nearest-hit
   kernels are also held bit for bit against their
   plain versions (on the card on every lane, on the CPU on a seeded
   eighth of the lanes of N = 262,144) on adversarial rays (through vertices, along edges, in
   a triangle's plane, off a surface) and on the 19 queries of one
   recorded flagship batch, which are replayed for the time and bound
   that a batch sees; the share of pairs that survive the kernels'
   rejection tests is counted with their plain twins. The
   Moeller-Trumbore kernel with winner rows also runs the A/B/C
   experiment of ``tools/exp_mt_fused.py`` (kernel alone, kernel with
   rows, kernel plus a torch gather). The four soup entry points
   (nearest hit over groups of the brute-force soup with a lane mask,
   the same with winner rows, any hit, and the MIS shadow pair in one
   launch) are held bit for bit against their plain versions the same
   way: random rays at N = 262,144 and 524,288, with random lane masks
   and on group ranges, with per-lane bounds at, just below and just
   above a hit, adversarial rays, soups of 1, 255, 257 and 3840
   triangles and groups that end inside a chunk, and the recorded
   queries of one brute-force flagship batch (rays, bounds, groups and
   masks as the tracer passed them: the 10 primary queries, the 9 shadow
   pairs, their detector halves and, for the any-hit, their occluder
   halves), replayed for ms a batch. Every scan's bound counts the work
   that its own layout needs (``scan_stats``: the pairs under the
   sub-box rule, their sphere and reject survivors, and the chunk and
   sub-box tests); beside it, as ``yardstick``, the bound under the rule
   that earlier measurements used (the chunk rule, the sphere test from
   the ray's origin; for the soup, over the soup in instance order), so
   that shares stay comparable. The gradient path's kernels: the kernel
   histogram's record and backward (``csrc/kernel_histogram.cu``) at
   524,288 items over 100 bins, with and without a detector axis, odd N,
   offset views, a state past shared memory, an all-masked record,
   NaN/inf times and the records that the backward's lists of kept lanes
   single out (``kde_cases``: every lane kept, none, every lane in one
   bin, a detector axis; each timed queued beside its bound and an empty
   launch); the table reads and their backward
   (``csrc/table_read.cu``) in every form of every read site at N =
   262,144 with lanes at t = 0 and 1 (``read_cases``: on the flagship
   scene's store the refractive index at t and at the wavelength clipped
   twice, the log phase function and the phase matrix's four tables at
   the cosine, the four constants tables by the const4 rule; on the
   volume flagship's medium its absorption at t, its log phase function
   at the cosine, its four constants tables at the wavelength and four
   phase-matrix tables; and tables of 100,000 and 16,384 samples), each
   also with every lane at one coordinate (``hot_read_case``) and with
   upstream gradients on ``READ_LIVE_SHARE`` of the lanes, as the
   gradient steps' calls mostly see (``hold_read_grad``);
   the hit reconstruction's row
   gathers and their backward (``gather_rows``) with the reconstruction's
   spans and as whole rows, on the flagship's ``tri_data`` and
   ``inst_data``, on ``tri_data`` with half the lanes missed (row 0, zero
   gradient) and on a recorded shadow pair's winners and their instances
   (``gather_cases``), then on ragged, empty, unaligned and 12-wide
   tables (``odd_gather_cases``); each timed as called and queued beside
   its plain version, its bound, and the library call that computes the
   same on inputs made beforehand (``grid_sample`` for the reads,
   ``index_add_`` for their backward and the gathers', ``index_select``
   of the pairs' bins for the kernel histogram's and of the whole rows
   for the gathers);
3. the first main path at full width: the flagship scene tracer
   (262,144 lanes, path length 10, 3840 triangles, 100 bins,
   ``accel="mt"``) through ``run()``, one warm-up batch and three timed
   ones, with the kernels' launch counts, and one batch with each table-read
   site counted (``read_sites``: one launch a read, at most two a
   medium's constants); then seconds per batch with
   the winners' rows from the kernel and from a separate gather, in turns;
3b. the second main path at full width: the polarized flagship on the
   Woop query (``accel="woop", polarized=True``), the same way, its read
   sites counted too;
3c. its gradient at full width: one ``trace_fn()`` forward and backward
   of sum(histogram state) with respect to the water absorption table,
   then one step under the profiler (device busy, the table reads'
   launches a step, forward and backward, no
   ``indexing_backward_kernel_small_stride``);
3d. the third main path at full width: the brute-force flagship, the
   scene with no ``accel`` named (``"auto"`` resolves to ``"brute"``),
   with its launches a batch (10 primary nearest hits with winner rows,
   9 shadow pairs, each one ``target_in_table`` launch, no separate
   any-hit, none of the other nearest-hit kernels; its read sites counted,
   nothing stacked for the constants' read); then seconds per
   batch with the winners' rows from the kernel and from a separate gather,
   in turns; then the ``mt``, unpolarized ``woop`` and brute-force
   flagships in turns, for seconds per batch that can be compared;
3e. ``accel.is_visible`` on the brute-force scene, the any-hit kernel's
   path: 262,144 observer-target pairs, three calls;
3f. the volume flagship (``examples/01_volume_tracing.py``'s
   ``VolumeForwardTracer``: water, a 5 m sphere target, 10 scatterings)
   at 262,144 lanes: seconds per batch, bounces/s, peak memory, the
   kernels' launches a batch (21 records, no triangle query), one
   batch under ``torch.profiler`` (device busy, kernels and copies) and
   one with its read sites counted;
   phase 2 holds its 21 recorded records against the plain version;
3g. the photon flagship (``ScenePhotonTracer`` on the brute-force scene,
   3 runs of 2 segments) at 262,144 lanes: ``run_compacted()`` against
   ``run()`` on the same streams (rtol 1e-6, atol 1e-4), then each timed
   in turns (run, compacted, compacted, run; 6 primary queries and 6
   records a batch, no shadow query) and profiled; phase 2 holds the
   primary queries and records of both against the plain versions;
3h. the volume flagship's gradient steps at 262,144 lanes: example 05's
   loss in the absorption scale and example 06's, with a kernel
   histogram (100 bins of 5 ns, bandwidth 5 ns), in the group
   velocity's; seconds a step (median of 3), peak memory, the kernels'
   launches a step and device busy of one profiled step;
3i. the brute-force flagship's geometry step at 262,144 lanes, path
   length 10, with a kernel histogram: the loss of example 10 in the
   detector's shift (``translate_instance``), the source's position and
   the packed ``log_phase_function`` and ``refractive_index`` tables,
   reported the same way;
4. the port on the CPU against the port on the card at batch 4096: the
   unpolarized ``mt`` flagship, the brute-force flagship, the polarized
   ``woop`` flagship with the source off centre, the volume flagship
   unpolarized and polarized, a volume photon tracer, the photon
   flagship and the unguided brute-force flagship with a
   ``StoreTimeHitResponse`` (the same detections, times within 1e-5);
   then the gradients at batch 2048, path length 3: the polarized
   medium gradient, the volume steps of 3h and the geometry step of 3i,
   each by ``PERF.md``'s gradient agreement.

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
#: a polarized flagship batch's records: unfused, as theia_tpu records
#: polarized runs, the extension and the surface record every segment and
#: the two shadow halves every segment but the last
POL_RECORDS = 4 * MAX_PATH - 2
#: the volume flagship's records a batch: the direct extension, then the
#: two MIS candidates of each of its 10 segments
VOLUME_RECORDS = 21
#: the photon flagship's segments a batch (3 runs of 2), one primary query
#: and one record each; its wavefront shrinks between runs down to this
PHOTON_PATH = 6
PHOTON_MIN_LANES = 1024
#: published peaks of one H100 SXM: HBM bytes/s and float32 flop/s outside
#: the tensor cores (132 SMs x 128 lanes x 2 flop an FMA x 1.98 GHz)
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
#: int32 instructions/s of one pipe: an SM issues 64 results a clock of
#: 32-bit integer add, compare and logic, and 64 of integer multiply and
#: multiply-add (NVIDIA's table of arithmetic throughput for compute
#: capability 9.0), half the float32 lanes and one operation an
#: instruction: 132 x 64 x 1.98 GHz
PEAK_I32 = PEAK_F32 / 4
#: int32 operations on the integer pipe that philox_uniform needs for one
#: lane of a width-2 call, counted from the arithmetic of philox_draw() in
#: csrc/philox.cu with a three-input xor as one. The two draws of a lane
#: share the stream, so the key is set up and stepped once a lane: its
#: 64-bit add with the carries 5, two adds a round 20, dim + 1 for the
#: second draw 1. Each draw then takes 9 for the 128-bit counter add (four
#: adds, four carries, the wrap-around; 4 * dim folds into the first add),
#: two xors a round 20, 6 to pick the word and 1 conversion to float. A
#: round's two 32x32 -> 64 products (20 a draw) go to the multiply-add
#: pipe, which issues its own 64 a clock an SM beside the integer pipe's,
#: so the integer pipe's larger count is what bounds.
PHILOX_SHARED_OPS, PHILOX_DRAW_OPS = 5 + 20 + 1, 9 + 20 + 6 + 1
PHILOX_PAIR_OPS = max(PHILOX_SHARED_OPS + 2 * PHILOX_DRAW_OPS, 2 * 20)
#: cycles that torch.cuda._sleep spins in front of queued launches (~50 ms)
SPIN_CYCLES = 100_000_000
#: float32 operations a (ray, triangle) pair costs in the scan's two
#: rejection tests (an FMA counts two; counted from sphere_miss() in
#: csrc/nearest_scan.cuh, less what it computes once a ray and sub-box,
#: and reject() in csrc/moller_trumbore.cuh and csrc/intersect_woop.cu)
#: and in the exact tests (the reciprocal and its Newton step as 4)
PAIR_FLOP = {"mt": (30, 41, 48), "woop": (27, 46, 44)}
#: float32 operations of one slab test of a ray against a box (a chunk's
#: or a sub-box): 6 differences, 6 products, 11 minima and maxima
BOX_FLOP = 23
#: the yardstick's sphere test, from the ray's origin (the first kernels'),
#: a pair
FIRST_SPHERE_FLOP = {"mt": 27, "woop": 25}


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


def cuda_ms_queued(fn, reps: int) -> float:
    """Mean milliseconds of ``fn``'s device work over ``reps`` calls with
    the host's enqueue time taken out: the calls queue up behind a spin
    kernel, so the device runs them back to back. ``reps`` times the
    launches of ``fn`` must stay under the stream's queue (~1000)."""
    import torch

    fn()
    torch.cuda.synchronize()
    before, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    before.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    host = time.perf_counter()
    for _ in range(reps):
        fn()
    end.record()
    host = (time.perf_counter() - host) * 1e3
    torch.cuda.synchronize()
    spin = before.elapsed_time(start)
    if host >= spin:
        raise RuntimeError(f"queued timing: the host took {host:.1f} ms to enqueue, the spin {spin:.1f} ms")
    return start.elapsed_time(end) / reps


def empty_launch_ms() -> dict:
    """An empty kernel (one warp) through the library's C entry point:
    what a launch alone costs, as a caller sees it and queued."""
    import torch

    from theia_tpu_torch import _build

    lib, stream = _build.library(), torch.cuda.current_stream().cuda_stream
    launch = lambda: _build.check(lib.theia_empty_launch(stream), "empty_launch")
    return dict(ms=cuda_ms(launch, 200), queued_ms=cuda_ms_queued(launch, 200))


def check_sqrt() -> dict:
    """The port's square root on the card (``ops.math3d.sqrt``, which
    calls ``torch.sqrt`` there) against the float64 route that it takes on
    the CPU, bit for bit on 2^20 float32 values: every positive finite
    float32 bit pattern drawn at random (subnormals included) and values
    log-uniform over [1e-6, 1e4]. CUDA's float32 sqrt is IEEE, correctly
    rounded, as XLA's is; so the plain versions, run on the CPU, and the
    kernels see the same square roots."""
    import numpy as np
    import torch

    from theia_tpu_torch.ops.math3d import sqrt

    rng = np.random.default_rng(20)
    n = 1 << 20
    bits = rng.integers(1, 0x7F800000, n // 2, dtype=np.int64).astype(np.int32).view(np.float32)
    logs = np.exp(rng.uniform(np.log(1e-6), np.log(1e4), n - n // 2)).astype(np.float32)
    x = torch.as_tensor(np.concatenate([bits, logs]), device="cuda")
    got = sqrt(x)
    want = torch.sqrt(x.double()).float()
    torch.cuda.synchronize()
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    assert differ == 0, f"CUDA's float32 sqrt differs from the float64 route on {differ} of {n} values"
    print(f"sqrt: CUDA's float32 torch.sqrt equals the float64 route bit for bit on {n} values")
    return dict(values=n, differ=differ)


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
    draw = lambda: philox_uniform(key, ctr, stream, dim, 2)
    ms, queued_ms = cuda_ms(draw, 50), cuda_ms_queued(draw, 50)
    plain_ms = cuda_ms(lambda: philox_uniform_plain(key, ctr, stream, dim, 2), 5)
    # per lane: 8 bytes read, 8 written, and two ciphers under one key, as
    # dims d and d + 1 of the timed width-2 launch sit in different counter
    # blocks of one stream. No library call: torch's Philox draws other
    # words from the same key.
    b = bound(16 * n, PHILOX_PAIR_OPS * n, PEAK_I32)
    print(f"kernel philox N={n}: bit-exact (width 1 and 2); kernel {ms:.4f} ms ({queued_ms:.4f} queued), "
          f"plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
          f"({PHILOX_PAIR_OPS} int32 operations a lane at {PEAK_I32:.4g}/s), share of bound "
          f"{b['bound_ms'] / ms:.3f} ({b['bound_ms'] / queued_ms:.3f} queued), library call: none")
    report.update(max_abs_err=0.0, ms=ms, queued_ms=queued_ms, plain_ms=plain_ms, library_ms=None, **b)


def hist_case(n: int, seed: int, bins: int = 100, n_det=None, kept: float = 0.5, offset: int = 0):
    """Seeded inputs of one record on the card: (value, time, mask, t0,
    bin_size, bins, object_id, n_det). Times run from below t0 to past the
    last bin (~94 % in range at 100 bins), ids from -1 to n_det. With
    ``offset`` every lane array is a view that starts ``offset`` elements
    into its storage, so no pointer is aligned for 16-byte loads."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    m = n + offset
    dev = lambda a: torch.as_tensor(a, device="cuda")[offset:]
    value = dev(rng.uniform(0.0, 2.0, size=m).astype(np.float32))
    time_ = dev(rng.uniform(-10.0, 5.0 * bins + 20.0, size=m).astype(np.float32))
    mask = dev(rng.uniform(size=m) < kept)
    oid = None if n_det is None else dev(rng.integers(-1, n_det + 1, size=m).astype(np.int32))
    return value, time_, mask, torch.tensor(0.0, device="cuda"), torch.tensor(5.0, device="cuda"), bins, oid, n_det


def large_state_cases(n: int):
    """Two records on a state of 64,000 flat bins (1000 bins, 64
    detectors), past what the record's shared-memory variant takes: kept
    lanes spread over all bins, and the same with every kept lane in bin 1
    of detectors 0 to 3, so that whole warps share a bin."""
    import torch

    large = hist_case(n, 13, bins=1000, n_det=64)
    hot = (large[0], torch.full_like(large[1], 7.0), *large[2:6], large[6] % 4, large[7])
    return large, hot


def cpu(case):
    """``case`` with its tensors copied to the CPU."""
    import torch

    return tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in case)


def hold_record(case, label) -> float:
    """The record kernel and its backward on ``case`` against the plain
    versions on the CPU copy of the inputs: the record within rtol 1e-4 a
    bin (atomic adds land in an order that changes from run to run, the
    plain version sums in lane order), the backward bit for bit (it sums
    nothing). Returns the record's max abs error."""
    import numpy as np
    import torch

    from theia_tpu_torch.response import histogram_add, histogram_add_plain, histogram_grad, histogram_grad_plain

    n_state = case[5] * (case[7] or 1)
    got = histogram_add(torch.zeros(n_state, device="cuda"), *case)
    torch.cuda.synchronize()
    want = histogram_add_plain(torch.zeros(n_state), *cpu(case))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=0.0, msg=lambda m: f"histogram_add on {label}: {m}")
    grad_state = torch.as_tensor(np.random.default_rng(n_state).normal(size=n_state).astype(np.float32))
    got_grad = histogram_grad(grad_state.cuda(), *case[1:])
    torch.cuda.synchronize()
    assert torch.equal(got_grad.cpu(), histogram_grad_plain(grad_state, *cpu(case)[1:])), (
        f"histogram_grad differs from plain on {label}"
    )
    return float((got.cpu() - want).abs().max())


def forced_bytes(case) -> dict:
    """Bytes that the record and its backward must move for ``case`` on
    this card, in 32-byte sectors: the mask of every lane, the time where
    a sector holds an unmasked lane (it decides the bin), the value where
    it holds a kept lane, the ids like the time, the state read and
    written; the backward writes every lane. Also the kept and unmasked
    shares, the bins in use and the kept lanes of the fullest bin."""
    import torch

    from theia_tpu_torch.response import _hist_bins

    value, time_, mask, t0, bin_size, bins, oid, n_det = case
    keep, flat = _hist_bins(time_, mask, t0, bin_size, bins, oid, n_det)
    n, n_state = mask.shape[0], bins * (n_det or 1)
    filling = torch.bincount(flat[keep], minlength=n_state)
    sectors = lambda on: int(torch.nn.functional.pad(on.to(torch.uint8), (0, -n % 8)).reshape(-1, 8).any(1).sum())
    lanes = 32 * sectors(mask) * (1 if n_det is None else 2)
    return dict(
        add=n + lanes + 32 * sectors(keep) + 8 * n_state,
        grad=n + lanes + 4 * n + 4 * n_state,
        kept=float(keep.float().mean()), unmasked=float(mask.float().mean()),
        bins_in_use=int((filling > 0).sum()), fullest_bin=int(filling.max()),
    )


def check_histogram(add_report, grad_report):
    """The record and its backward (kernel C) against their plain
    versions: the shapes and alignments a caller may hand in, then the
    times at the mask-0.5 input and on a state that takes the record's
    large-state variant."""
    import torch

    from theia_tpu_torch.response import (
        SHARED_STATE_MAX, _hist_bins, histogram_add, histogram_add_plain, histogram_grad, histogram_grad_plain,
    )

    n = 2 * BATCH
    main = hist_case(n, 3)
    large, hot = large_state_cases(n)
    assert large[5] * large[7] > SHARED_STATE_MAX
    errors = {}
    for label, case in (
        (f"N={n}, mask 0.5", main),
        ("N=1", hist_case(1, 4, kept=1.0)),
        ("N=3", hist_case(3, 5)),
        ("N=4099", hist_case(4099, 6)),
        ("N=4099 with a detector axis", hist_case(4099, 7, bins=50, n_det=3)),
        (f"views at element 1, N={n + 1}", hist_case(n + 1, 8, offset=1)),
        ("views at element 3 with a detector axis", hist_case(100_003, 9, bins=50, n_det=3, offset=3)),
        ("a state of 200 KB (shared memory past 48 KB)", hist_case(n, 10, bins=1000, n_det=50)),
        ("sparse, 1 lane in 1000 kept", hist_case(n, 11, kept=1e-3)),
        ("every lane kept", hist_case(n, 12, kept=1.0)),
        ("the large-state variant", large),
        ("the large-state variant, views at element 1", hist_case(100_001, 14, bins=1000, n_det=64, offset=1)),
        ("the large-state variant, 4 bins of 64,000 in use", hot),
    ):
        errors[label] = hold_record(case, label)
    # an all-masked record leaves the state as it was, bit for bit
    for case in (main, large):
        state = torch.rand(case[5] * (case[7] or 1), device="cuda") + 1.0
        want = state.clone()
        histogram_add(state, *case[:2], torch.zeros_like(case[2]), *case[3:])
        torch.cuda.synchronize()
        assert torch.equal(state, want), "an all-masked record changed the state"
        # NaN and infinite times drop
        bad = torch.full_like(case[1], float("nan"))
        bad[1::3], bad[2::3] = float("inf"), float("-inf")
        histogram_add(state, case[0], bad, *case[2:])
        torch.cuda.synchronize()
        assert torch.equal(state, want), "a NaN or infinite time was recorded"
    # the errors kept are those at the main path's size (a bin there sums ~2,500 values around 1)
    worst, large_err = errors[f"N={n}, mask 0.5"], errors["the large-state variant"]
    print(f"kernels histogram_add / histogram_grad: rtol 1e-4 a bin / bit-exact on {len(errors)} cases (odd N, offset "
          f"views, detector axis, 200 KB state, large-state variant) and on all-masked, NaN and infinite records; "
          f"max abs err at N={n}, mask 0.5: {worst:.3g}, large-state variant {large_err:.3g}")

    empty = empty_launch_ms()
    print(f"empty launch: {empty['ms']:.4f} ms as a caller sees it, {empty['queued_ms']:.4f} ms queued")

    def timed_add(label, case) -> dict:
        value, time_, mask, t0, bin_size, bins, oid, n_det = case
        n_state = bins * (n_det or 1)
        state = torch.zeros(n_state, device="cuda")
        add = lambda: histogram_add(state, *case)
        ms, queued_ms = cuda_ms(add, 50), cuda_ms_queued(add, 50)
        plain_ms = cuda_ms(lambda: histogram_add_plain(state, *case), 10)
        # the yardstick: one index_add_ on bins and masked values made
        # beforehand (the kernel also computes the bins and applies the mask)
        keep, flat = _hist_bins(*case[1:])
        masked = torch.where(keep, value, 0.0)
        library_ms = cuda_ms(lambda: state.index_add_(0, flat, masked), 50)
        # a lane: value, time and mask read (9 bytes, 13 with ids), ~8
        # float32 operations; the state read and written
        b = bound((9 if n_det is None else 13) * n + 8 * n_state, 8 * n)
        print(f"kernel histogram_add{label} N={n} bins={n_state}: kernel {ms:.4f} ms ({queued_ms:.4f} queued), "
              f"plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
              f"share of bound {b['bound_ms'] / ms:.3f} ({b['bound_ms'] / queued_ms:.3f} queued)")
        return dict(ms=ms, queued_ms=queued_ms, plain_ms=plain_ms, library_ms=library_ms, **b)

    add_report.update(max_abs_err=worst, empty_launch=empty, **timed_add("", main))
    add_report["large_state"] = dict(
        n=n, bins=large[5] * large[7], max_abs_err=large_err, **timed_add(" large-state variant", large)
    )

    back, bins = main[1:], main[5]
    grad_state = torch.randn(bins, device="cuda")
    grad = lambda: histogram_grad(grad_state, *back)
    ms, queued_ms = cuda_ms(grad, 50), cuda_ms_queued(grad, 50)
    plain_ms = cuda_ms(lambda: histogram_grad_plain(grad_state, *back), 10)
    # the yardstick: one index_select on bins made beforehand (the kernel
    # also computes the bins and zeroes the dropped lanes)
    _, flat = _hist_bins(*back)
    select = lambda: torch.index_select(grad_state, 0, flat)
    library_ms, library_queued_ms = cuda_ms(select, 50), cuda_ms_queued(select, 50)
    # a lane: time and mask read, one float written (9 bytes); ~7 operations
    b = bound(9 * n + 4 * bins, 7 * n)
    print(f"kernel histogram_grad N={n} bins={bins}: bit-exact; kernel {ms:.4f} ms ({queued_ms:.4f} queued), "
          f"plain {plain_ms:.4f} ms, index_select {library_ms:.4f} ms ({library_queued_ms:.4f} queued); "
          f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}, share of bound {b['bound_ms'] / ms:.3f} "
          f"({b['bound_ms'] / queued_ms:.3f} queued)")
    grad_report.update(max_abs_err=0.0, ms=ms, queued_ms=queued_ms, plain_ms=plain_ms, library_ms=library_ms,
                       library_queued_ms=library_queued_ms, **b)


def check_record_replay(records, path, add_report, grad_report):
    """The recorded records of one flagship batch: the record held against
    its plain version on each (rtol 1e-4 a bin) and the backward bit for
    bit, then all of them replayed for the time a batch sees, beside the
    bound from the bytes these inputs force."""
    import torch

    from theia_tpu_torch.response import histogram_add, histogram_grad

    worst, forced = 0.0, []
    for k, case in enumerate(records):
        worst = max(worst, hold_record(case, f"record {k} of a {path} flagship batch"))
        forced.append(forced_bytes(case))
    bins = records[0][5]
    state, grad_state = torch.zeros(bins, device="cuda"), torch.randn(bins, device="cuda")

    def replay_add():
        for case in records:
            histogram_add(state, *case)

    def replay_grad():
        for case in records:
            histogram_grad(grad_state, *case[1:])

    lanes = sum(case[2].shape[0] for case in records)
    for name, fn, report in (("add", replay_add, add_report), ("grad", replay_grad, grad_report)):
        ms, queued_ms = cuda_ms(fn, 20), cuda_ms_queued(fn, 20)
        b = bound(sum(f[name] for f in forced), 8 * lanes)
        print(f"kernel histogram_{name}: the {len(records)} recorded records of a {path} flagship batch ({lanes} lanes) "
              f"replayed {ms:.4f} ms a batch ({queued_ms:.4f} queued); bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
              f"share of bound {b['bound_ms'] / ms:.3f} ({b['bound_ms'] / queued_ms:.3f} queued)")
        report.setdefault("batch", {})[path] = dict(
            records=len(records), lanes=lanes, ms=ms, queued_ms=queued_ms, **b,
            **{key: [f[key] for f in forced] for key in ("kept", "unmasked", "bins_in_use", "fullest_bin")},
        )
    add_report["batch"][path]["max_abs_err"] = worst
    for key, form in (("kept", ".4f"), ("unmasked", ".4f"), ("bins_in_use", "d"), ("fullest_bin", "d")):
        print(f"    {key} of each record: " + " ".join(format(f[key], form) for f in forced))


#: float32 operations of the kernel histogram a (lane, bin) pair in range:
#: the bin centre 3, z 2, z^2 / 2 2, exp 4 (a MUFU op and its range
#: reduction), the weight 1, the value 1, the add 1, the bin 3; the
#: backward's: the same 12 to the weight, then 2 for d value, 4 for d t,
#: 7 for d binSize and 5 for d bandwidth, and the read of g
KDE_PAIR_FLOP, KDE_GRAD_PAIR_FLOP = 17, 31
#: float32 operations of a lane's table read of K tables: the clip, the
#: scale, floor and the fraction (6), the coordinate's form (affine: a
#: product and a sum; the wavelength: two differences and a division),
#: then a table's slope, lerp and null select (4); its backward's: the same
#: 6 and the form, a table's two shares of its table, its slope and its
#: product into d x (8), and the chain's product or division (1)
FORM_FLOP = {"t": 0, "affine": 2, "wavelength": 3}
READ_FLOP = lambda k, form: 6 + FORM_FLOP[form] + 4 * k
READ_GRAD_FLOP = lambda k, form: 7 + FORM_FLOP[form] + 8 * k


def kde_case(n: int, seed: int, bins: int = 100, n_det=None, kept: float = 0.5, offset: int = 0):
    """``hist_case``'s lanes as a kernel histogram record's arguments:
    (value, time, mask, t0, binSize, bandwidth, bins, support, object_id,
    n_det), 5 ns bins and a 5 ns bandwidth."""
    import torch

    value, time_, mask, t0, bin_size, bins, oid, n_det = hist_case(n, seed, bins, n_det, kept, offset)
    return value, time_, mask, t0, bin_size, torch.tensor(5.0, device="cuda"), bins, 4, oid, n_det


def kde_pairs(case) -> tuple[int, int, int]:
    """(unmasked lanes, kept lanes, (lane, bin) pairs in range) of a
    kernel histogram record: what its work depends on."""
    import torch

    from theia_tpu_torch.response import _kde_terms

    value, time_, mask, t0, bin_size, bandwidth, bins, support, oid, n_det = case
    terms = _kde_terms(time_, mask, t0, bin_size, bandwidth, bins, support, oid, n_det)
    kept = torch.stack([k for k, *_ in terms]).any(0)
    return int(mask.sum()), int(kept.sum()), int(sum(int(k.sum()) for k, *_ in terms))


def kde_cases(n: int) -> dict:
    """The kernel histogram records that the backward's lists of kept
    lanes single out, at N = ``n``: every lane kept, none kept, every lane
    kept in one bin (bin 50 of 100), and a detector axis."""
    import torch

    every = kde_case(n, 21, kept=1.0)
    return {
        "every lane kept": every,
        "no lane kept": kde_case(n, 22, kept=0.0),
        "every lane in one bin": (every[0], torch.full_like(every[1], 252.5), *every[2:]),
        "a detector axis (3), mask 0.5": kde_case(n, 23, n_det=3),
    }


def kde_grad_bound(case) -> dict:
    """The kernel histogram backward's bound on ``case``: the record's reads
    (every lane's mask, the unmasked lanes' time and value), g read, two
    floats a lane and three scalars written; KDE_GRAD_PAIR_FLOP a (lane,
    bin) pair in range and 4 an unmasked lane."""
    n, bins = case[1].shape[0], case[6] * (case[9] or 1)
    unmasked, _, pairs = kde_pairs(case)
    return bound(n + 8 * unmasked + 4 * bins + 8 * n + 12, KDE_GRAD_PAIR_FLOP * pairs + 4 * unmasked)


def hold_kde(case, label) -> dict:
    """The kernel histogram's record and backward on ``case`` against the
    plain versions on the CPU copy of the inputs. Tolerances: the record
    rtol 1e-4 a bin (atomic adds in an order that changes from run to run,
    and the card's expf against the CPU's exp, an ulp apart); d value and
    d time rtol 1e-5 of the largest lane (nine terms, the exponentials an
    ulp apart); the three scalars rtol 1e-4 (a block's tree and one atomic
    a block against a sequential sum over every lane). Returns the max
    abs errors."""
    import numpy as np
    import torch

    from theia_tpu_torch.response import (
        kernel_histogram_add, kernel_histogram_add_plain, kernel_histogram_grad, kernel_histogram_grad_plain,
    )

    n_state = case[6] * (case[9] or 1)
    got = kernel_histogram_add(torch.zeros(n_state, device="cuda"), *case)
    torch.cuda.synchronize()
    want = kernel_histogram_add_plain(torch.zeros(n_state), *cpu(case))
    scale = float(want.abs().max()) or 1.0
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-6 * scale,
                               msg=lambda m: f"kernel_histogram_add on {label}: {m}")
    grad_state = torch.as_tensor(np.random.default_rng(n_state).normal(size=n_state).astype(np.float32))
    got_g = kernel_histogram_grad(grad_state.cuda(), *case)
    torch.cuda.synchronize()
    want_g = kernel_histogram_grad_plain(grad_state, *cpu(case))
    err = {"add": float((got.cpu() - want).abs().max())}
    for name, a, b, rtol in zip(("d value", "d time", "d t0", "d binSize", "d bandwidth"), got_g, want_g,
                                (1e-5, 1e-5, 1e-4, 1e-4, 1e-4)):
        a = a.cpu()
        atol = rtol * (float(b.abs().max()) or 1.0) if b.dim() else 0.0
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=lambda m: f"kernel_histogram_grad {name} on {label}: {m}")
        err[name] = float((a - b).abs().max())
    return err


def check_kernel_histogram(add_report, grad_report):
    """The kernel histogram's record and backward (K1) against their plain
    versions: 524,288 items over 100 bins, with and without a detector
    axis, odd N, offset views, a state past what shared memory holds, an
    all-masked record and NaN or infinite times (dropped, exact zeros);
    then their times at the main case beside the plain versions',
    ``index_add_`` / ``index_select`` on the bins and weights made
    beforehand, and the bounds from the pairs these inputs need."""
    import torch

    from theia_tpu_torch.response import (
        SHARED_STATE_MAX, _kde_terms, kernel_histogram_add, kernel_histogram_add_plain, kernel_histogram_grad,
        kernel_histogram_grad_plain,
    )

    n = 2 * BATCH
    main = kde_case(n, 3)
    errors = {}
    for label, case in (
        (f"N={n}, mask 0.5", main),
        (f"N={n - 1}", kde_case(n - 1, 4)),
        ("N=1", kde_case(1, 5, kept=1.0)),
        ("a detector axis (3)", kde_case(n, 6, bins=100, n_det=3)),
        (f"views at element 1, N={n + 1}", kde_case(n + 1, 7, offset=1)),
        ("views at element 3 with a detector axis", kde_case(100_003, 8, bins=50, n_det=3, offset=3)),
        ("a state past shared memory (64,000 flat bins)", kde_case(100_000, 9, bins=1000, n_det=64)),
        *kde_cases(n).items(),
    ):
        if label.startswith("a state past"):
            assert case[6] * case[9] > SHARED_STATE_MAX
        errors[label] = hold_kde(case, label)
    # an all-masked record and NaN or infinite times leave the state as it was, with zero gradients
    state = torch.rand(100, device="cuda") + 1.0
    want = state.clone()
    masked = (*main[:2], torch.zeros_like(main[2]), *main[3:])
    bad = torch.full_like(main[1], float("nan"))
    bad[1::3], bad[2::3] = float("inf"), float("-inf")
    nonfinite = (main[0], bad, torch.ones_like(main[2]), *main[3:])
    for case in (masked, nonfinite):
        kernel_histogram_add(state, *case)
        grads = kernel_histogram_grad(torch.randn(100, device="cuda"), *case)
        torch.cuda.synchronize()
        assert torch.equal(state, want), "an all-masked or non-finite record changed the state"
        assert all(not bool(g.any()) for g in grads), "an all-masked or non-finite record has a gradient"
    worst = errors[f"N={n}, mask 0.5"]
    print(f"kernels kernel_histogram_add / kernel_histogram_grad: rtol 1e-4 a bin / 1e-5 a lane / 1e-4 a scalar on "
          f"{len(errors)} cases and on all-masked and NaN/inf records (unchanged, zero gradients); max abs err at "
          f"N={n}: {worst}")

    # the backward on the cases that its kept-lane lists single out, queued, beside its bound and an empty launch
    empty = empty_launch_ms()
    grad_report["cases"] = {}
    for label, case in kde_cases(n).items():
        g = torch.randn(case[6] * (case[9] or 1), device="cuda")
        ms = cuda_ms_queued(lambda: kernel_histogram_grad(g, *case), 50)
        b = kde_grad_bound(case)
        grad_report["cases"][label] = dict(queued_ms=ms, queued_share_of_bound=b["bound_ms"] / ms, **b)
        print(f"kernel kernel_histogram_grad on {label} (N={n}): {ms:.4f} ms queued, bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']}, share {b['bound_ms'] / ms:.3f}; an empty launch {empty['queued_ms']:.4f} ms queued")
    value, time_, mask, t0, bin_size, bandwidth, bins, support, oid, n_det = main
    unmasked, kept, pairs = kde_pairs(main)
    state = torch.zeros(bins, device="cuda")
    add = lambda: kernel_histogram_add(state, *main)
    ms, queued_ms = cuda_ms(add, 50), cuda_ms_queued(add, 50)
    plain_ms = cuda_ms(lambda: kernel_histogram_add_plain(state, *main), 10)
    # the yardstick: one index_add_ of the pairs' weights on bins made beforehand
    terms = _kde_terms(time_, mask, t0, bin_size, bandwidth, bins, support, oid, n_det)
    norm = bin_size / (bandwidth * 2.5066282749176025)
    flat = torch.cat([f[k] for k, f, *_ in terms])
    weights = torch.cat([(value * e * norm)[k] for k, _, _, _, e in terms])
    library_ms = cuda_ms(lambda: state.index_add_(0, flat, weights), 50)
    # mask of every lane, time and value of the unmasked ones, the state read and written
    b = bound(n + 8 * unmasked + 8 * bins, KDE_PAIR_FLOP * pairs + 4 * unmasked)
    print(f"kernel kernel_histogram_add N={n} bins={bins}: {unmasked} unmasked, {kept} kept, {pairs} (lane, bin) pairs; "
          f"kernel {ms:.4f} ms ({queued_ms:.4f} queued), plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms; "
          f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}, share {b['bound_ms'] / ms:.3f} "
          f"({b['bound_ms'] / queued_ms:.3f} queued)")
    add_report.update(max_abs_err=worst["add"], ms=ms, queued_ms=queued_ms, plain_ms=plain_ms,
                      library_ms=library_ms, pairs=pairs, **b)
    grad_state = torch.randn(bins, device="cuda")
    grad = lambda: kernel_histogram_grad(grad_state, *main)
    ms, queued_ms = cuda_ms(grad, 50), cuda_ms_queued(grad, 50)
    plain_ms = cuda_ms(lambda: kernel_histogram_grad_plain(grad_state, *main), 10)
    select = lambda: torch.index_select(grad_state, 0, flat)
    library_ms = cuda_ms(select, 50)
    b = kde_grad_bound(main)
    print(f"kernel kernel_histogram_grad N={n} bins={bins}: kernel {ms:.4f} ms ({queued_ms:.4f} queued), plain "
          f"{plain_ms:.4f} ms, index_select of the pairs' bins {library_ms:.4f} ms; bound {b['bound_ms']:.4f} ms by "
          f"{b['bound_by']}, share {b['bound_ms'] / ms:.3f} ({b['bound_ms'] / queued_ms:.3f} queued); an empty "
          f"launch {empty['queued_ms']:.4f} ms queued")
    grad_report.update(max_abs_err=max(worst["d value"], worst["d time"]), ms=ms, queued_ms=queued_ms,
                       plain_ms=plain_ms, library_ms=library_ms, empty_launch=empty, scalar_errors=[worst[k] for k in
                       ("d t0", "d binSize", "d bandwidth")], **b)


def read_cases(store, medium) -> dict:
    """The table reads' inputs at the main paths' shapes, N = 262,144
    lanes, one case a read site's form: inputs u uniform over [-0.05,
    1.05], 1 % of them exactly at 0 and 1 % at 1, seen as each form's
    input (t = u; cos = 2u - 1, so t = 0.5 * cos + 0.5 is u again; the
    wavelength lambda_min + u * (lambda_max - lambda_min) of the lane's
    medium, so the bounds are met exactly). The packed reads on the
    flagship scene's store (3 media, 256 columns; every medium's handle,
    vacuum, null, included): the refractive index at t (``lookup_packed``),
    at the wavelength clipped twice (``_fresnel``), the log phase function
    at the cosine (``_scatter_prob_packed``), the four phase-matrix tables
    at the cosine (``_phase_matrix_packed``; the flagship's water has none,
    HG, so three media of 0, 256 and 200 samples made from the seed) and
    the four constants tables by the const4 rule at the wavelength
    (``packed_medium_constants``; BK7's absorption is infinite below 235
    nm, so lanes there read inf and NaN, as they do in the plain version).
    The single reads on the volume flagship's medium (1024 samples a
    table): the absorption at t (``lookup``), the log phase function at the
    cosine, its four constants tables at the wavelength clipped twice
    (``medium_constants``) and four phase-matrix tables at the cosine
    (``phase_matrix_elements``; from the seed: 1024, 1024 and 512 samples
    and a null one). Returns label -> dict(kernel=the wrapper's name, args
    (tables, [sizes, handle,] x, null values), kw (the form's keywords),
    form, site)."""
    import numpy as np
    import torch

    from theia_tpu_torch.material import _CONST4_KINDS, _CONST4_NULLS
    from theia_tpu_torch.ops.table_read import PHASE
    from theia_tpu_torch.trace.scene import _LOG_INV_4PI

    rng = np.random.default_rng(41)
    n = BATCH
    u = rng.uniform(-0.05, 1.05, n)
    u[: n // 100], u[n // 100 : n // 50] = 0.0, 1.0
    dev = lambda a, dtype=np.float32: torch.as_tensor(np.asarray(a, dtype), device="cuda")
    m = store.sizes["refractive_index"].shape[0]
    h = rng.integers(0, m, n).astype(np.int32)
    handle = dev(h, np.int32)
    lo, hi = (b.cpu().numpy().astype(np.float64) for b in (store.lambda_min, store.lambda_max))
    lam = dev(lo[h] + u * (hi - lo)[h])
    cos = dev(2.0 * u - 1.0)
    vlo, vhi = float(medium.lambda_min), float(medium.lambda_max)
    kinds = ("phase_m12", "phase_m22", "phase_m33", "phase_m34")
    pm_sizes = np.array([0, 256, 200], np.int32)
    columns = np.arange(256)[None] < pm_sizes[:, None]
    pm = tuple(dev(np.where(columns, rng.uniform(-1.0, 1.0, (3, 256)), 0.0)) for _ in kinds)
    pm_sizes = tuple(dev(pm_sizes, np.int32) for _ in kinds)
    single_pm = (dev(rng.uniform(-1.0, 1.0, 1024)), dev(rng.uniform(-1.0, 1.0, 1024)),
                 dev(rng.uniform(-1.0, 1.0, 512)), None)
    bounds = (store.lambda_min, store.lambda_max)
    tab, size = store.tables, store.sizes
    packed = lambda tables, sizes, x, null, form, site, **kw: dict(
        kernel="read_packed", args=(tables, sizes, handle, x, null), kw=kw, form=form, site=site)
    single = lambda tables, x, null, form, site, **kw: dict(
        kernel="read_table", args=(tables, x, null), kw=kw, form=form, site=site)
    return {
        "read_packed": packed(tab["refractive_index"], size["refractive_index"], dev(u), 1.0, "t",
                              "material.lookup_packed"),
        "read_packed, fresnel": packed(tab["refractive_index"], size["refractive_index"], lam, 1.0, "wavelength",
                                       "trace/scene.py _fresnel", bounds=bounds, clips=2),
        "read_packed, scatter prob": packed(tab["log_phase_function"], size["log_phase_function"], cos, _LOG_INV_4PI,
                                            "affine", "trace/scene.py _scatter_prob_packed", affine=PHASE),
        "read_packed, phase matrix": packed(pm, pm_sizes, cos, 0.0, "affine", "trace/scene.py _phase_matrix_packed",
                                            affine=PHASE),
        "read_packed, const4": packed(tuple(tab[k] for k in _CONST4_KINDS), tuple(size[k] for k in _CONST4_KINDS),
                                      lam, _CONST4_NULLS, "wavelength", "material.packed_medium_constants",
                                      bounds=bounds, shared=True),
        "read_table": single(medium.absorption_coef, dev(u), 0.0, "t", "lookup.lookup"),
        "read_table, phase": single(medium.log_phase_function, cos, 0.0, "affine",
                                    "trace/core.py, volume.py, photon.py: the log phase function", affine=PHASE),
        "read_table, medium constants": single(
            tuple(getattr(medium, k) for k in _CONST4_KINDS), dev(vlo + u * (vhi - vlo)), _CONST4_NULLS,
            "wavelength", "material.medium_constants", bounds=(medium.lambda_min, medium.lambda_max), clips=2),
        "read_table, phase matrix": single(single_pm, cos, 0.0, "affine", "polarization.phase_matrix_elements",
                                           affine=PHASE),
    }


def hot_read_case(c, t: float = 0.37) -> dict:
    """Read case ``c`` with every lane at one coordinate: the formed and
    clipped coordinate ``t`` for all lanes and, for a packed read, every
    lane on the medium whose first table is the largest, so that each
    table's gradient takes every lane's shares on the same two entries."""
    import torch

    args, kw = c["args"], c["kw"]
    x = args[-2]
    packed = c["kernel"] == "read_packed"
    h = 0
    if packed:
        sizes = args[1] if isinstance(args[1], tuple) else (args[1],)
        h = int(torch.argmax(sizes[0]))
    if c["form"] == "affine":
        a, b = kw["affine"]
        value = (t - b) / a
    elif c["form"] == "wavelength":
        lo, hi = (float(torch.as_tensor(bound).reshape(-1)[h]) for bound in kw["bounds"])
        value = lo + t * (hi - lo)
    else:
        value = t
    lanes = torch.full_like(x, value)
    if packed:
        args = (args[0], args[1], torch.full_like(args[2], h), lanes, args[-1])
    else:
        args = (args[0], lanes, args[-1])
    return dict(c, args=args)


def sized_read_case(c, samples: int, seed: int = 5) -> dict:
    """Single read case ``c`` on one table of ``samples`` normal values made
    from ``seed``."""
    import numpy as np
    import torch

    table = torch.as_tensor(np.random.default_rng(seed).normal(size=samples).astype(np.float32), device="cuda")
    return dict(c, args=(table, *c["args"][1:]))


def live_grads(g, share: float, gen=None) -> tuple:
    """Upstream gradients ``g`` (one a table) kept on a random ``share`` of
    the lanes and zero on the rest, as a tracer's dead lanes leave them."""
    import torch

    live = torch.rand(g[0].shape, device=g[0].device, generator=gen) < share
    return tuple(torch.where(live, a, 0.0) for a in g)


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def read_calls(c, g=None):
    """(forward, plain, backward, plain backward) of read case ``c`` as
    functions of nothing, the backward for the upstream gradient ``g`` (a
    tuple, one a table)."""
    from theia_tpu_torch.ops import table_read as tr

    kernel, args, kw = c["kernel"], c["args"], c["kw"]
    one = not isinstance(args[0], tuple)
    gg = None if g is None else (g[0] if one else g)
    grad_args = lambda go: (*args[:-1], go, args[-1])
    return (lambda: getattr(tr, kernel)(*args, **kw), lambda: getattr(tr, kernel + "_plain")(*args, **kw),
            lambda: getattr(tr, kernel + "_grad")(*grad_args(gg), **kw),
            lambda go=gg: getattr(tr, kernel + "_grad_plain")(*grad_args(go), **kw))


def hold_read_grad(name, c, label, live: float | None = None) -> float:
    """Read case ``c``'s backward against its plain version on the same
    card tensors, for random upstream gradients (nonzero on a ``live``
    share of the lanes alone, where given):
    d x bit for bit (the same float32 ops in the same order, the tables'
    products summed in the same order), each d table within 2e-5 of each
    entry's sum of absolute shares (the plain version's backward run on
    |g|: the kernel sums the shares in another order than index_add_'s),
    NaN where the plain version's is. Returns the max abs error of d
    tables."""
    import torch

    _, plain, _, _ = read_calls(c)
    g = tuple(torch.randn_like(w) for w in _outputs(plain()))
    if live is not None:
        g = live_grads(g, live)
    _, _, grad, grad_plain = read_calls(c, g)
    got_t, got_x = grad()
    want_t, want_x = grad_plain()
    abs_t, _ = grad_plain(tuple(x.abs() for x in g) if len(g) > 1 else g[0].abs())
    torch.cuda.synchronize()
    assert same(got_x, want_x), f"{name} backward d x differs from plain on {label}"
    err = 0.0
    for k, (a, b, s) in enumerate(zip(_outputs(got_t), _outputs(want_t), _outputs(abs_t))):
        if b is None:
            assert a is None, f"{name}: a null table got a gradient"
            continue
        assert torch.equal(torch.isnan(a), torch.isnan(b)), f"{name} d table {k} NaNs differ on {label}"
        finite = torch.isfinite(b)
        diff = (a - b)[finite].abs()
        excess = float((diff - 2e-5 * s[finite]).max())
        assert excess <= 0.0, f"{name} backward d table {k} off by {excess} on {label}"
        err = max(err, float(diff.max()))
    return err


def hold_table_reads(store, medium) -> dict:
    """The table reads (K2) against their plain versions on the same card
    tensors (``read_cases``): the forward bit for bit, the backward as
    ``hold_read_grad`` holds it. Also tables of 100,000 samples, whose
    gradient takes the variant that adds to device memory, and of 16,384
    samples, and each case with every lane at one coordinate
    (``hot_read_case``) and with upstream gradients nonzero on
    ``READ_LIVE_SHARE`` of the lanes. Returns the
    cases and, per case, the max abs error of d tables at the main shape."""
    import torch

    from theia_tpu_torch.ops import table_read as tr

    cases = read_cases(store, medium)
    main = cases["read_table"]
    big, band = sized_read_case(main, 100_000), sized_read_case(main, 16_384)
    assert big["args"][0].numel() > tr.SHARED_TABLE_MAX >= band["args"][0].numel()
    extra = {"read_table": [("a table of 100,000 samples", big, None), ("a table of 16,384 samples", band, None)]}
    errors = {}
    for name, case in cases.items():
        for label, c, live in [("the main path's shape", case, None), (HOT, hot_read_case(case), None),
                               (LIVE, case, READ_LIVE_SHARE)] + extra.get(name, []):
            forward, plain, _, _ = read_calls(c)
            got, want = _outputs(forward()), _outputs(plain())
            torch.cuda.synchronize()
            assert all(same(a, b) for a, b in zip(got, want)), f"{name} forward differs from plain on {label}"
            err = hold_read_grad(name, c, label, live)
            errors.setdefault(name, err)
            x = c["args"][-2]
            print(f"kernel {name} on {label} ({len(got)} table(s), {x.numel()} lanes): forward bit-equal, d x "
                  f"bit-equal, d tables within 2e-5 of their absolute sums (max abs err {err:.3g})")
    return cases, errors


#: the label of a read case with every lane at one coordinate
HOT = "every lane at one coordinate"
#: the share of lanes with a nonzero upstream gradient in a read backward's
#: sparse case. On the gradient steps most calls see few live lanes (the
#: polarized step's median call 0.5 %, the geometry step's 0.02 %) and a
#: few see most lanes live (card_measure.py read-grad-live)
READ_LIVE_SHARE = 0.005
#: the label of a read case with READ_LIVE_SHARE of the lanes live
LIVE = f"{READ_LIVE_SHARE:g} of the lanes' upstream gradients nonzero"


def same(a, b) -> bool:
    """``a`` and ``b`` equal entry for entry, a NaN equal to a NaN."""
    import torch

    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def _read_reader(c):
    """The validated table set of read case ``c`` and its flat parts:
    (reader, tables, sizes, bounds, handle, x)."""
    from theia_tpu_torch.ops import table_read as tr

    args, kw = c["args"], c["kw"]
    packed = c["kernel"] == "read_packed"
    tables = args[0] if isinstance(args[0], tuple) else (args[0],)
    sizes = (args[1] if isinstance(args[1], tuple) else (args[1],)) if packed else None
    handle = args[2] if packed else None
    x, null, bounds = args[-2], args[-1], kw.get("bounds")
    reader = tr._reader(packed, tables, sizes, null, kw.get("affine"), bounds, kw.get("clips", 1),
                        kw.get("shared", False), x.device)
    return reader, tables, sizes, bounds, handle, x


def grid_sample_read(c):
    """The library call that computes read case ``c``: one ``grid_sample``
    (bilinear, ``align_corners=True``, border padding) over the tables seen
    as a (1, K, M, L) image (null tables as the const4 rule reads them:
    their null value, 0 beyond a table's width; a single table's M is 1), on
    a grid made beforehand from the formed and clipped coordinate: x scaled
    by the lane's size, y the lane's medium row. Forming the coordinate
    (the wavelength bounds' gathers, the affine map) and the null select
    are left out of its time. Returns (call, the lanes and tables on which
    it computes what the read does: a (K, N) mask)."""
    import torch
    import torch.nn.functional as F

    from theia_tpu_torch.ops.table_read import clip01

    reader, tables, sizes, bounds, handle, x = _read_reader(c)
    r, _ = reader.coordinate(bounds, handle, x)
    t = clip01(r)
    live = [k for k, tab in enumerate(tables) if tab is not None]
    width = max(tables[k].shape[-1] for k in live)
    pad = lambda a: torch.nn.functional.pad(a, (0, width - a.shape[-1]))
    if reader.packed:
        h = handle.long()
        nk = torch.stack([s[h] for s in sizes])
        n = nk.max(0).values if reader.shared else nk[0]
        image = torch.stack([pad(torch.where((s == 0)[:, None], null, tab))
                             for tab, s, null in zip(tables, sizes, reader.nulls)])[None]
        m = image.shape[2]
        gx = 2.0 * (t * torch.clamp_min(n - 1, 1).float()) / (width - 1) - 1.0
        gy = 2.0 * h.float() / (m - 1) - 1.0
        kept = (n > 0)[None] & ((nk == n[None]) | reader.shared)
    else:
        image = torch.stack([pad(tables[k]) for k in live])[:, None][None]
        gx, gy = 2.0 * t - 1.0, torch.zeros_like(t)
        same_width = torch.tensor([tables[k].shape[0] == width for k in live], device=t.device)
        kept = same_width[:, None].expand(-1, t.shape[0])
    grid = torch.stack([gx, gy], dim=-1).reshape(1, 1, -1, 2).contiguous()
    image = image.contiguous()
    call = lambda: F.grid_sample(image, grid, mode="bilinear", padding_mode="border", align_corners=True)
    return call, live, kept


def read_bound(c, backward: bool) -> dict:
    """The bound of read case ``c``'s forward or backward: each lane's
    input, handle and outputs (backward: its upstream gradients and d x)
    once, the tables, their sizes and the wavelength bounds once (backward:
    and the tables' gradients written); the operations of READ_FLOP /
    READ_GRAD_FLOP a lane."""
    import torch

    reader, tables, sizes, bounds, handle, x = _read_reader(c)
    n, k = x.numel(), len(tables)
    table_bytes = 4 * sum(tab.numel() for tab in tables if tab is not None)
    once = table_bytes + (4 * sum(s.numel() for s in sizes) if sizes else 0)
    once += 0 if bounds is None else 4 * sum(b.numel() for b in bounds if isinstance(b, torch.Tensor))
    lane_bytes = 4 + (4 if handle is not None else 0)
    if backward:
        return bound(n * (lane_bytes + 4 * k + 4) + once + table_bytes, READ_GRAD_FLOP(k, c["form"]) * n)
    return bound(n * (lane_bytes + 4 * k) + once, READ_FLOP(k, c["form"]) * n)


def check_table_read(reports, store, medium):
    """``hold_table_reads``, then each read case's forward and backward
    timed at the main shape as called and queued, beside the plain
    versions', the library calls that compute the same on inputs made
    beforehand (``grid_sample`` for the forward, checked against the kernel
    where it computes the same; ``index_add_`` of the lanes' shares for the
    backward: what autograd's index backward computes) and the bounds
    (each lane's input, handle, outputs and, for the backward, its upstream
    gradient and d x; the tables, their sizes and the wavelength bounds
    once, the tables' gradients once). The first packed and single cases
    report at ``read_packed`` and ``read_table``, the others under their
    labels in ``forms``."""
    import torch

    cases, errors = hold_table_reads(store, medium)
    empty = empty_launch_ms()
    for name, c in cases.items():
        kernel = c["kernel"]
        report, grad_report = reports[kernel], reports[kernel + "_grad"]
        if name != kernel:
            report = report.setdefault("forms", {}).setdefault(name, {})
            grad_report = grad_report.setdefault("forms", {}).setdefault(name, {})
        report.update(max_abs_err=0.0, site=c["site"], form=c["form"])
        grad_report.update(max_abs_err=errors[name], site=c["site"], form=c["form"])
        reader, tables, sizes, bounds, handle, x = _read_reader(c)
        forward, plain, _, _ = read_calls(c)
        out = _outputs(forward())
        g = tuple(torch.randn_like(o) for o in out)
        _, _, grad, grad_plain = read_calls(c, g)
        n, k = x.numel(), len(tables)
        table_bytes = 4 * sum(tab.numel() for tab in tables if tab is not None)
        for rep, fn, plain_fn, b in (
            (report, forward, plain, read_bound(c, backward=False)),
            (grad_report, grad, grad_plain, read_bound(c, backward=True)),
        ):
            ms, queued_ms = cuda_ms(fn, 50), cuda_ms_queued(fn, 50)
            plain_ms = cuda_ms(plain_fn, 10)
            rep.update(ms=ms, queued_ms=queued_ms, plain_ms=plain_ms, empty_launch=empty, **b)
            rep.update(share_of_bound=rep["bound_ms"] / ms, queued_share_of_bound=rep["bound_ms"] / queued_ms)
        # the backward with every lane at one coordinate: the same bound, every share on two entries a table
        hot = hot_read_case(c)
        _, _, hot_grad, _ = read_calls(hot, g)
        hot_ms = cuda_ms_queued(hot_grad, 50)
        grad_report[HOT] = dict(queued_ms=hot_ms, queued_share_of_bound=grad_report["bound_ms"] / hot_ms)
        # and with most upstream gradients zero, as on the gradient steps: the same bound
        _, _, live_grad, _ = read_calls(c, live_grads(g, READ_LIVE_SHARE))
        live_ms = cuda_ms_queued(live_grad, 50)
        grad_report[LIVE] = dict(queued_ms=live_ms, queued_share_of_bound=grad_report["bound_ms"] / live_ms)
        for label, t in ((HOT, hot_ms), (LIVE, live_ms)):
            print(f"kernel {name} backward, {label}: {t:.4f} ms queued, bound {grad_report['bound_ms']:.4f} ms, "
                  f"share {grad_report['bound_ms'] / t:.3f}; an empty launch {empty['queued_ms']:.4f} ms queued")
        if name == "read_table":
            band_grad = read_calls(sized_read_case(c, 16_384), g)[2]
            band_ms = cuda_ms_queued(band_grad, 50)
            grad_report["a table of 16,384 samples"] = dict(queued_ms=band_ms)
            print(f"kernel {name} backward on a table of 16,384 samples: {band_ms:.4f} ms queued")
        library, live, kept = grid_sample_read(c)
        lib_out = library().reshape(len(live), -1)
        got = torch.stack([out[j] for j in live])
        kept = kept & torch.isfinite(got) & torch.isfinite(lib_out)
        scale = float(got[kept].abs().max())
        lib_err = float((lib_out - got)[kept].abs().max()) / scale
        assert lib_err <= 1e-4, f"grid_sample does not compute {name}: {lib_err}"
        report["library_ms"] = cuda_ms(library, 50)
        entries, shares = read_shares(c, g)
        acc = torch.zeros(table_bytes // 4, dtype=torch.float32, device=x.device)
        grad_report["library_ms"] = cuda_ms(lambda: acc.index_add_(0, entries, shares), 50)
        for rep, what, lib in ((report, "forward", "grid_sample"), (grad_report, "backward", "index_add_")):
            print(f"kernel {name} {what} ({c['site']}, {k} table(s), form {c['form']}) N={n}: kernel "
                  f"{rep['ms']:.4f} ms ({rep['queued_ms']:.4f} queued), plain {rep['plain_ms']:.4f} ms, {lib} "
                  f"{rep['library_ms']:.4f} ms; bound {rep['bound_ms']:.4f} ms by {rep['bound_by']}, share "
                  f"{rep['share_of_bound']:.3f} ({rep['queued_share_of_bound']:.3f} queued); an empty launch "
                  f"{empty['queued_ms']:.4f} ms queued")
        print(f"kernel {name}: grid_sample within {lib_err:.3g} of the kernel's largest value where it computes the "
              f"same (the coordinate formed and the nulls selected beforehand, outside its time)")


def gather_cases(pack, winners) -> dict:
    """The row gathers' cases at N = 262,144: label -> (table, columns,
    index, hit). Synthetic: the brute flagship's ``tri_data`` (3840 x 32,
    past shared memory: the backward adds to device memory) with half the
    lanes on the detector's rows, as a shadow query's winners are, and
    again with half the lanes missed (they read row 0, the clamp of -1,
    and carry a zero gradient); ``inst_data`` (3 x 32, in shared memory)
    at random rows. The path's own: the winners of one recorded shadow
    pair of a brute batch (``winners``, -1 on a miss) and their instances,
    the rows the reconstruction gathers from them."""
    import numpy as np
    import torch

    from theia_tpu_torch.accel import INST_COLUMNS, TRI_COLUMNS

    rng = np.random.default_rng(43)
    n = BATCH
    det = np.nonzero(pack.tri_data[:, 27].cpu().numpy() == 2)[0]
    rows = np.where(rng.uniform(size=n) < 0.5, rng.choice(det, n), rng.integers(0, pack.tri_data.shape[0], n))
    missed = rng.uniform(size=n) < 0.5
    index = lambda a: torch.as_tensor(a.astype(np.int32), device="cuda")
    found = winners >= 0
    tri = torch.clamp_min(winners, 0).to(torch.int32)
    inst = pack.tri_data[tri.long(), 27].to(torch.int32)
    return {
        "tri_data": (pack.tri_data, TRI_COLUMNS, index(rows), None),
        "tri_data with misses": (pack.tri_data, TRI_COLUMNS, index(np.where(missed, 0, rows)),
                                 torch.as_tensor(~missed, device="cuda")),
        "inst_data": (pack.inst_data, INST_COLUMNS, index(rng.integers(0, 3, n)), None),
        "tri_data, a shadow query's winners": (pack.tri_data, TRI_COLUMNS, tri, found),
        "inst_data, a shadow query's instances": (pack.inst_data, INST_COLUMNS, inst, found),
    }


def odd_gather_cases(pack) -> dict:
    """Cases that only check the row gathers, at sizes and layouts off the
    path: ragged tiles (N = 1037 and 1), an empty index, a ``tri_data``
    copy that is not 16-byte aligned and a table 12 floats wide (both take
    the element-a-thread kernels), with the reconstruction's spans or
    spans of their own."""
    import numpy as np
    import torch

    from theia_tpu_torch.accel import INST_COLUMNS, TRI_COLUMNS

    rng = np.random.default_rng(44)
    index = lambda n, rows: torch.as_tensor(rng.integers(0, rows, n).astype(np.int32), device="cuda")
    hit = lambda n: torch.as_tensor(rng.uniform(size=n) < 0.7, device="cuda")
    tri, inst = pack.tri_data, pack.inst_data
    buf = torch.empty(tri.numel() + 1, device="cuda")
    unaligned = buf[1:].view(tri.shape)
    unaligned.copy_(tri)
    narrow = torch.as_tensor(rng.normal(0.0, 20.0, (50, 12)).astype(np.float32), device="cuda")
    return {
        "tri_data, N = 1037": (tri, TRI_COLUMNS, index(1037, tri.shape[0]), hit(1037)),
        "inst_data, N = 1037": (inst, INST_COLUMNS, index(1037, inst.shape[0]), None),
        "tri_data, N = 1": (tri, TRI_COLUMNS, index(1, tri.shape[0]), None),
        "tri_data, N = 0": (tri, TRI_COLUMNS, index(0, tri.shape[0]), None),
        "tri_data not 16-byte aligned": (unaligned, TRI_COLUMNS, index(5000, tri.shape[0]), hit(5000)),
        "a table 12 wide": (narrow, ((0, 5), (5, 12, torch.int32)), index(5000, 50), None),
        "a table 12 wide, whole rows": (narrow, None, index(5000, 50), None),
    }


def hold_gather(name, table, cols, index, hit):
    """``gather_rows`` on ``table`` with ``cols`` against its plain version,
    bit for bit, and its backward on a random gradient a float span (0 on
    the lanes where ``hit`` is False) within 2e-5 of each entry's sum of
    absolute shares; returns (the gradient as ``gather_rows_grad`` takes
    it, the spans' gradients, the largest error)."""
    import torch

    from theia_tpu_torch.ops.table_read import (
        gather_rows, gather_rows_grad, gather_rows_grad_plain, gather_rows_plain,
    )

    n = index.shape[0]
    spans = [(s[0], s[1], len(s) == 3) for s in (cols or ((0, table.shape[1]),))]
    got = gather_rows(table, index, columns=cols)
    got = (got,) if cols is None else got
    want = gather_rows_plain(table, index, cols)
    grads = [None if integer else torch.randn(n, stop - start, device="cuda") for start, stop, integer in spans]
    if hit is not None:
        grads = [None if g is None else torch.where(hit[:, None], g, 0.0) for g in grads]
    arg = grads[0] if cols is None else grads
    got_t = gather_rows_grad(table.shape, index, arg, cols)
    want_t = gather_rows_grad_plain(table.shape, index, arg, cols)
    abs_arg = arg.abs() if cols is None else [None if g is None else g.abs() for g in grads]
    abs_t = gather_rows_grad_plain(table.shape, index, abs_arg, cols)
    torch.cuda.synchronize()
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want)), (
        f"gather_rows differs from plain on {name}")
    excess = float(((got_t - want_t).abs() - 2e-5 * abs_t).max())
    assert excess <= 0.0, f"gather_rows_grad off by {excess} on {name}"
    return arg, grads, float((got_t - want_t).abs().max())


def check_gather_rows(report, grad_report, pack, winners):
    """The hit reconstruction's row gathers and their backward against
    their plain versions on the card (``gather_rows_plain``: ``table[:,
    a:b][index]`` a span; ``gather_rows_grad_plain``: ``index_add_`` of
    each span's gradient into its columns) by ``hold_gather``: with the
    reconstruction's spans (``accel.TRI_COLUMNS``, ``INST_COLUMNS``) on
    every case of ``gather_cases`` and as whole rows on the first two, and
    on ``odd_gather_cases``. Each case of ``gather_cases`` is then timed as
    called and queued beside the plain versions and the library calls
    (``index_select`` of the whole rows; ``index_add_`` of the whole rows'
    gradient into a zero table, the gradient assembled beforehand), with
    its bound: the forward's bytes are each lane's index and used columns
    written and the used columns of the distinct rows it reads, the
    backward's each lane's index and float columns read and the table's
    float columns written, its operations an add a nonzero share. The
    kernels line reports the case with misses."""
    import torch

    from theia_tpu_torch.ops.table_read import (
        gather_rows, gather_rows_grad, gather_rows_grad_plain, gather_rows_plain,
    )

    odd = odd_gather_cases(pack)
    for name, case in odd.items():
        err = hold_gather(name, *case)[2]
        grad_report["max_abs_err"] = max(grad_report.get("max_abs_err", 0.0), err)
    print(f"kernel gather_rows: forward bit-equal, backward within 2e-5 of its absolute sums on {', '.join(odd)}")
    del odd
    items = []
    for label, (table, columns, index, hit) in gather_cases(pack, winners).items():
        items.append((label, table, columns, index, hit))
        if label in ("tri_data", "tri_data with misses"):
            items.append((f"{label}, whole rows", table, None, index, hit))
    cases = {}
    for name, table, cols, index, hit in items:
        arg, grads, err = hold_gather(name, table, cols, index, hit)
        report.update(max_abs_err=0.0)
        grad_report["max_abs_err"] = max(grad_report.get("max_abs_err", 0.0), err)
        n = index.shape[0]
        spans = [(s[0], s[1], len(s) == 3) for s in (cols or ((0, table.shape[1]),))]
        long_index = index.long()
        full = torch.zeros(n, table.shape[1], device="cuda")
        for g, (start, stop, _) in zip(grads, spans):
            if g is not None:
                full[:, start:stop] = g
        used = sum(stop - start for start, stop, _ in spans)
        used_f = sum(stop - start for start, stop, integer in spans if not integer)
        distinct = int(torch.unique(index).numel())
        shares = sum(int((g != 0).sum()) for g in grads if g is not None)
        entry = {}
        for kind, fn, plain_fn, library_fn, n_bytes, flop in (
            ("forward", lambda: gather_rows(table, index, columns=cols),
             lambda: gather_rows_plain(table, index, cols), lambda: torch.index_select(table, 0, index),
             4 * n + 4 * n * used + 4 * distinct * used, 0),
            ("backward", lambda: gather_rows_grad(table.shape, index, arg, cols),
             lambda: gather_rows_grad_plain(table.shape, index, arg, cols),
             lambda: torch.zeros_like(table).index_add_(0, long_index, full),
             4 * n + 4 * n * used_f + 4 * table.shape[0] * used_f, shares),
        ):
            ms, queued_ms = cuda_ms(fn, 50), cuda_ms_queued(fn, 50)
            plain_ms, library_ms = cuda_ms(plain_fn, 10), cuda_ms(library_fn, 10)
            b = bound(n_bytes, flop)
            entry[kind] = dict(ms=ms, queued_ms=queued_ms, plain_ms=plain_ms, library_ms=library_ms,
                               queued_share_of_bound=b["bound_ms"] / queued_ms, **b)
            lib = "index_select" if kind == "forward" else "index_add_"
            print(f"kernel gather_rows{'_grad' if kind == 'backward' else ''} on {name} "
                  f"({tuple(table.shape)}, N={n}, {len(spans)} spans, {used} columns, {distinct} rows read): "
                  f"{ms:.4f} ms ({queued_ms:.4f} queued), plain {plain_ms:.4f} ms, {lib} {library_ms:.4f} ms; "
                  f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}, share {b['bound_ms'] / ms:.3f} "
                  f"({b['bound_ms'] / queued_ms:.3f} queued)")
        print(f"kernel gather_rows on {name}: forward bit-equal, backward within 2e-5 of its absolute sums "
              f"(max abs err {err:.3g})")
        cases[name] = entry
    for rep, kind in ((report, "forward"), (grad_report, "backward")):
        rep.update(cases={name: entry[kind] for name, entry in cases.items()}, **cases["tri_data with misses"][kind])


def read_shares(c, g):
    """(entries, shares) of read case ``c``'s backward: every lane's two
    adds a table into the tables' gradients laid end to end, made
    beforehand for the index_add_ yardstick."""
    import torch

    from theia_tpu_torch.ops import table_read as tr

    reader, tables, sizes, bounds, handle, x = _read_reader(c)
    r, _ = reader.coordinate(bounds, handle, x)
    t = tr.clip01(r)
    entries, shares, offset = [], [], 0
    if reader.packed:
        h = handle.long()
        for k, (_, pad, _, j, l, _) in enumerate(reader.cells(sizes, h, t)):
            length, last = reader.lens[k], j == pad - 1
            base = offset + h * length
            entries += [base + torch.clamp_max(j, length - 1), base + torch.clamp_max(j + 1, length - 1)]
            shares += [torch.where(last, g[k], g[k] - g[k] * l), torch.where(last, 0.0, g[k] * l)]
            offset += tables[k].numel()
    else:
        for k, table in enumerate(tables):
            if table is None:
                continue
            n = table.shape[0]
            xx = t * float(n - 1)
            fl = torch.floor(xx)
            l = xx - fl
            entries += [offset + tr._index(fl, n), offset + tr._index(torch.ceil(xx), n)]
            shares += [g[k] * (1.0 - l), g[k] * l]
            offset += n
    return torch.cat(entries), torch.cat(shares)


def bound(n_bytes: float, flop: float, peak: float = PEAK_F32) -> dict:
    """bound_ms and bound_by of a call that must move ``n_bytes`` and do
    ``flop`` operations of peak rate ``peak``."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, flop / peak * 1e3
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations")


def first_sphere_miss(policy: str, aos, o, d):
    """The sphere test of the first kernels, from the ray's origin (the
    yardstick's): bool (lanes, rows of ``aos``), true where the pair is
    dropped; products rounded once, as those kernels' fmaf did."""
    from theia_tpu_torch.ops.intersect_mt import MT_GUARD, WOOP_GUARD, _columns, _fma, ray_slack

    ox, oy, oz, dx, dy, dz = _columns(o, d)
    cx, cy, cz, r2 = (aos[:, k][None] for k in range(4))
    n0, n1, n2 = (aos[:, k][None] for k in (4, 5, 6))
    kd, ko = ray_slack(o, d)
    dd = _fma(dz, dz, _fma(dy, dy, dx * dx, True), True)
    wx, wy, wz = cx - ox, cy - oy, cz - oz
    p = _fma(wz, dz, _fma(wy, dy, wx * dx, True), True)
    w2 = _fma(wz, wz, _fma(wy, wy, wx * wx, True), True)
    q = _fma(w2, dd * (1.0 - 64.0 * 2.0**-24), -(p * p), True)
    det = _fma(dz, n2, _fma(dy, n1, dx * n0, True), True)
    if policy == "mt":
        g = (MT_GUARD * kd) * _fma(wx.abs() + wy.abs() + wz.abs(), aos[:, 7][None], aos[:, 8][None], True)
    else:
        g = _fma(WOOP_GUARD * ko, aos[:, 8][None], (WOOP_GUARD * kd) * aos[:, 9][None], True)
    return (q > r2 * dd) & (det.abs() > g)


def scan_stats(policy: str, aos, sub_box, walk, layout: bool = True) -> dict:
    """The work a scan's query needs, counted by its plain walk
    ``walk(stats, sub_box)`` over the table rows ``aos``: the pairs it
    tests ("pairs"), how many of them pass the first rejection test
    ("sphere") and both ("both"), and its box tests ("chunk_tests",
    "sub_tests"). With ``layout`` the scan's own rule (sub-boxes, the
    sphere test from the sub-box's entry); without, the yardstick's (the
    chunk rule, the first kernels' sphere test from the ray's origin)."""
    from theia_tpu_torch.ops import intersect_mt as tmt
    from theia_tpu_torch.ops import intersect_woop as twoop

    sphere, reject = {
        "mt": (tmt._mt_sphere_miss_plain, tmt._mt_reject_plain),
        "woop": (twoop._woop_sphere_miss_plain, twoop._woop_reject_plain),
    }[policy]
    if layout:
        miss = lambda o, d, c0: sphere(*tmt.chunk_tables(aos, sub_box, c0), o, d)
    else:
        miss = lambda o, d, c0: first_sphere_miss(policy, aos[c0 : c0 + tmt.CHUNK], o, d)
    stats = {"tests": {
        "sphere": lambda o, d, c0: ~miss(o, d, c0),
        "both": lambda o, d, c0: ~(miss(o, d, c0) | reject(aos[c0 : c0 + tmt.CHUNK], o, d)),
    }}
    walk(stats, sub_box if layout else None)
    stats.pop("tests")
    return stats


def scan_bound(policy: str, n_bytes: int, stats: dict, layout: bool = True) -> dict:
    """bound_ms and bound_by of queries that move ``n_bytes`` and do the
    work that ``stats`` (:func:`scan_stats`) counts: the pairs' tests and,
    on the scan's own layout, its box tests."""
    f_sphere, f_reject, f_exact = PAIR_FLOP[policy]
    if not layout:
        f_sphere = FIRST_SPHERE_FLOP[policy]
    flop = stats.get("pairs", 0) * f_sphere + stats.get("sphere", 0) * f_reject + stats.get("both", 0) * f_exact
    if layout:
        flop += (stats.get("chunk_tests", 0) + stats.get("sub_tests", 0)) * BOX_FLOP
    return bound(n_bytes, flop)


def add_stats(total: dict, stats: dict) -> None:
    for k, v in stats.items():
        total[k] = total.get(k, 0) + v


def work_line(stats: dict) -> str:
    """The counts of :func:`scan_stats`, for a printed line."""
    return (f"{stats['pairs']} pairs, {stats['sphere']} / {stats['both']} survive"
            + (f", {stats['chunk_tests']} chunk and {stats['sub_tests']} sub-box tests" if "sub_tests" in stats else ""))


class Nearest:
    """One of the three nearest-hit entry points with its plain version,
    its pack on the card and on the CPU, and its policy."""

    def __init__(self, name, scene_pack):
        from theia_tpu_torch.ops import intersect_mt as tmt
        from theia_tpu_torch.ops import intersect_woop as twoop

        self.name, self.table = name, None
        if name == "nearest_triangle_woop":
            p = self.pack = scene_pack.woop
            self.cpu_pack = twoop.WoopPack(p.b.cpu(), p.aabb, p.lo, p.hi, p.n_tri, p.chunk_box.cpu(), p.sub_box.cpu())
            self.kernel, self.plain = twoop.nearest_triangle_woop, twoop.nearest_triangle_woop_plain
            self.policy = "woop"
            self.exact, self.cols = twoop._woop_exact_plain, twoop._transforms(p.b, p.n_tri)
        else:
            p = self.pack = scene_pack.mt
            self.cpu_pack = tmt.MTPack(p.tri.cpu(), p.aabb, p.lo, p.hi, p.n_tri)
            assert (self.cpu_pack.chunk_box == p.chunk_box.cpu()).all(), "chunk boxes differ"
            assert (self.cpu_pack.sub_box == p.sub_box.cpu()).all(), "sub-boxes differ"
            self.kernel, self.plain = tmt.nearest_triangle_mt, tmt.nearest_triangle_mt_plain
            self.policy = "mt"
            self.exact, self.cols = tmt._mt_exact_plain, tmt._rows(p.tri, p.n_tri)
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

    def check(self, rays, label, on_cpu: bool, lanes=None):
        """Kernel against plain (on the CPU copy of the inputs, or on the
        card), bit for bit; on the CPU only at ``lanes`` where given (the
        kernel runs on every lane, and a lane's answer is its own); returns
        (max |t diff| over hits, hit share)."""
        import torch

        got = self.run(self.kernel, self.pack, rays)
        torch.cuda.synchronize()
        pack = self.cpu_pack if on_cpu else self.pack
        if on_cpu:
            at = slice(None) if lanes is None else lanes
            want = self.run(self.plain, pack, [r[at].cpu() for r in rays])
            got = [g[at].cpu() for g in got]
        else:
            want = self.run(self.plain, pack, rays)
        for what, g, w in zip(("t", "idx", "rows"), got, want):
            assert torch.equal(g, w), f"{self.name}: {what} differs from plain on {label}"
        hit = want[1] >= 0
        err = float((got[0][hit] - want[0][hit]).abs().max()) if bool(hit.any()) else 0.0
        return err, float(hit.float().mean())

    def stats(self, rays, layout: bool = True) -> dict:
        """:func:`scan_stats` of a query of ``rays`` (plain walk on the card)."""
        from theia_tpu_torch.ops import intersect_mt as tmt

        p = self.pack
        pair_test = lambda o, d, c0: self.exact(self.cols[:, c0 : c0 + tmt.CHUNK], o, d)
        walk = lambda stats, sub_box: tmt.chunk_walk(p.n_tri, p.chunk_box, *rays, pair_test, stats, sub_box=sub_box)
        return scan_stats(self.policy, p.tri_aos, p.sub_box, walk, layout)

    def bound(self, n_rays: int, stats: dict, layout: bool = True) -> dict:
        """The least time for queries of ``n_rays`` rays in all whose work
        ``stats`` counts."""
        n_bytes = n_rays * (28 + 8) + self.pack.tri_aos.numel() * 4 + self.pack.chunk_box.numel() * 4
        n_bytes += self.pack.sub_box.numel() * 4 if layout else 0
        if self.table is not None:
            n_bytes += n_rays * 128 + self.pack.n_tri * 128
        return scan_bound(self.policy, n_bytes, stats, layout)


def yardstick(b: dict, ms: float, rule: str) -> dict:
    """The bound under an earlier rule, for shares comparable with earlier
    measurements."""
    return dict(rule=rule, bound_ms=b["bound_ms"], bound_by=b["bound_by"], share_of_bound=b["bound_ms"] / ms)


#: the rule of the whole-table scans' earlier bounds
FIRST_SCAN_RULE = "chunk rule, sphere test from the ray's origin (the bounds of the first scans)"


def seeded_lanes(n: int, share: int, seed: int):
    """A seeded eighth (one in ``share``) of ``n`` lanes, sorted, on the
    card: where a plain version on the CPU checks a kernel's lanes."""
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    return torch.sort(torch.randperm(n, device="cuda", generator=gen)[: n // share]).values


def check_nearest(nearest: Nearest, adversarial, queries, report):
    """A nearest-hit kernel against its plain version, bit-equal t and idx
    (and rows): random rays at N = 262,144 and 524,288 with times and
    bound (the plain version on the card on every lane, and on the CPU on a
    seeded eighth of the first size's), adversarial rays, and the recorded
    queries of one flagship batch, replayed for the time and bound a batch
    sees."""
    name, worst = nearest.name, 0.0
    for n in (BATCH, 2 * BATCH):
        rays = random_rays(n, n + len(name), "cuda")
        err, hits = nearest.check(rays, f"random rays N={n} (plain on the card)", on_cpu=False)
        if n == BATCH:
            nearest.check(rays, f"random rays N={n} (plain on the CPU, an eighth of the lanes)", on_cpu=True,
                          lanes=seeded_lanes(n, 8, n + len(name)))
        own, yard = nearest.stats(rays), nearest.stats(rays, layout=False)
        worst = max(worst, err)
        ms = cuda_ms(lambda: nearest.run(nearest.kernel, nearest.pack, rays), 20)
        plain_ms = cuda_ms(lambda: nearest.run(nearest.plain, nearest.pack, rays), 2)
        b, yb = nearest.bound(n, own), nearest.bound(n, yard, layout=False)
        print(
            f"kernel {name} N={n}: bit-equal to plain, hits {hits:.4f}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms; of {n * nearest.pack.n_tri} pairs: this layout {work_line(own)}; "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}, share of bound {b['bound_ms'] / ms:.3f}; "
            f"yardstick ({FIRST_SCAN_RULE}) {work_line(yard)}, bound {yb['bound_ms']:.4f} ms, "
            f"share {yb['bound_ms'] / ms:.3f}"
        )
        entry = dict(ms=ms, plain_ms=plain_ms, **b, n=n, **own, yardstick=dict(yardstick(yb, ms, FIRST_SCAN_RULE), **yard))
        if n == BATCH:
            report.update(entry)
        else:
            report.update(double=entry)
    err, hits = nearest.check(adversarial, "adversarial rays", on_cpu=True)
    print(f"kernel {name}: bit-equal to plain on {adversarial[0].shape[0]} adversarial rays, hits {hits:.4f}")
    worst = max(worst, err)
    # the recorded batch: bit-equality (plain on the card), then a replay
    own, yard, n_rays = {}, {}, 0
    for q in queries:
        err, _ = nearest.check(q, "a recorded flagship query", on_cpu=False)
        worst, n_rays = max(worst, err), n_rays + q[0].shape[0]
        add_stats(own, nearest.stats(q))
        add_stats(yard, nearest.stats(q, layout=False))

    def replay():
        for q in queries:
            nearest.run(nearest.kernel, nearest.pack, q)

    batch_ms = cuda_ms(replay, 5)
    b, yb = nearest.bound(n_rays, own), nearest.bound(n_rays, yard, layout=False)
    print(
        f"kernel {name}: bit-equal to plain on the {len(queries)} recorded queries of a flagship batch "
        f"({n_rays} rays); replayed {batch_ms:.4f} ms a batch; of {n_rays * nearest.pack.n_tri} pairs: "
        f"this layout {work_line(own)}; bound {b['bound_ms']:.4f} ms by {b['bound_by']}, share of bound "
        f"{b['bound_ms'] / batch_ms:.3f}; yardstick {work_line(yard)}, bound {yb['bound_ms']:.4f} ms, "
        f"share {yb['bound_ms'] / batch_ms:.3f}"
    )
    report.update(
        max_abs_err=worst, library_ms=None,
        batch=dict(queries=len(queries), rays=n_rays, ms=batch_ms, **own, **b,
                   yardstick=dict(yardstick(yb, batch_ms, FIRST_SCAN_RULE), **yard)),
    )


#: the gradient path's kernels: (source, the theia_tpu function
#: whose jnp code and VJP each replaces)
GRADIENT_KERNELS = {
    "kernel_histogram_add": ("theia_tpu_torch/csrc/kernel_histogram.cu", "theia_tpu/response.py:283"),
    "kernel_histogram_grad": ("theia_tpu_torch/csrc/kernel_histogram.cu", "theia_tpu/response.py:283"),
    "read_table": ("theia_tpu_torch/csrc/table_read.cu", "theia_tpu/lookup.py:43"),
    "read_table_grad": ("theia_tpu_torch/csrc/table_read.cu", "theia_tpu/lookup.py:43"),
    "read_packed": ("theia_tpu_torch/csrc/table_read.cu", "theia_tpu/material.py:355"),
    "read_packed_grad": ("theia_tpu_torch/csrc/table_read.cu", "theia_tpu/material.py:355"),
    "gather_rows": ("theia_tpu_torch/csrc/table_read.cu", "theia_tpu/accel.py:614"),
    "gather_rows_grad": ("theia_tpu_torch/csrc/table_read.cu", "theia_tpu/accel.py:614"),
}
#: the soup entry points of ops/intersect_soup.py and the JAX functions they replace
SOUP_KERNELS = {
    "nearest_in_table_rows": "theia_tpu/accel.py:73",
    "nearest_in_table": "theia_tpu/accel.py:73",
    "anyhit_in_table": "theia_tpu/accel.py:188",
    "target_in_table": "theia_tpu/accel.py:688",
}


def instance_order(table):
    """The soup's table in the soup's own order (instance order, the
    layout of the first soup kernels), on the same device."""
    import numpy as np

    from theia_tpu_torch.ops.intersect_soup import SoupTable

    return SoupTable(*table.soup, table.spans, np.arange(table.n_tri))


def soup_stats(table, query, rays, groups, active, occluders=None, layout: bool = True):
    """:func:`scan_stats` of a soup query: with ``layout`` over ``table``
    itself, without over ``instance_order(table)`` (the first soup
    kernels' yardstick). A target query counts its nearest walk over
    ``groups`` and its any-hit walk over ``occluders``."""
    from theia_tpu_torch.ops import intersect_mt as tmt
    from theia_tpu_torch.ops import intersect_soup as tsoup

    if not layout:
        table = instance_order(table)

    def walks(stats, sub_box):
        def walk(t_max, groups, active, any_hit):
            return tmt.chunk_walk(
                table.n_tri, table.chunk_box, *rays[:2], t_max, tsoup._pair_test(table), stats,
                visits=table.visits(groups), active=active, any_hit=any_hit, index=table.index, sub_box=sub_box,
            )

        out = walk(rays[2], groups, active, query == "anyhit")
        if query == "target":
            walk(out[0], occluders, out[1] >= 0, True)

    return scan_stats("mt", table.aos, table.sub_box, walks, layout)


#: the rule of the soup kernels' earlier bounds
FIRST_SOUP_RULE = "the soup in instance order, chunk rule, sphere test from the ray's origin (the first soup kernels')"


class Soup:
    """One of the four soup entry points with its plain version, the
    scene's table on the card and one derived on the CPU. A target query
    (``target_in_table``) takes ``groups`` as its detectors, the table's
    last group by default, and every other group as its occluders."""

    def __init__(self, name, scene_pack, rows: bool | None = None):
        import torch

        from theia_tpu_torch.ops import intersect_soup as tsoup

        self.name, self.any_hit, self.target = name, name.startswith("anyhit"), name.startswith("target")
        rows = name.endswith("_rows") or self.target if rows is None else rows
        self.rows = scene_pack.tri_data if rows else None
        self.kernel, self.plain = getattr(tsoup, name), getattr(tsoup, name + "_plain")
        self.tables = (scene_pack.soup, scene_pack.soup.to("cpu"))
        # the tables are derived on their device (see Nearest)
        torch.testing.assert_close(self.tables[1].aos, self.tables[0].aos.cpu(), rtol=1e-6, atol=1e-7)
        assert torch.equal(self.tables[1].chunk_box, self.tables[0].chunk_box.cpu()), "chunk boxes differ"
        assert torch.equal(self.tables[1].sub_box, self.tables[0].sub_box.cpu()), "sub-boxes differ"

    def groups(self, table, groups):
        """(groups, occluders) of a target query over ``table``."""
        n = len(table.spans)
        det = [n - 1] if groups is None else list(groups)
        return det, [k for k in range(n) if k not in det]

    def run(self, fn, table, rays, groups=None, active=None, **kw):
        rows = None if self.rows is None else self.rows.to(rays[0].device)
        if self.target:
            det, occ = self.groups(table, groups)
            return fn(table, *rays, groups=det, occluders=occ, active=active, rows_table=rows, **kw)
        head = (table,) if rows is None else (table, rows)
        out = fn(*head, *rays, groups=groups, active=active, **kw)
        return (out,) if self.any_hit else out

    def check(self, rays, label, on_cpu: bool, groups=None, active=None, tables=None, lanes=None):
        """Kernel against plain (on the CPU copy of the inputs and the CPU
        table, at ``lanes`` where given, or on the card), bit for bit;
        returns the share of lanes with a hit."""
        import torch

        card, host = tables or self.tables
        got = self.run(self.kernel, card, rays, groups, active)
        torch.cuda.synchronize()
        table = host if on_cpu else card
        if on_cpu:
            at = slice(None) if lanes is None else lanes
            rays, active = [r[at].cpu() for r in rays], None if active is None else active[at].cpu()
            got = [g[at].cpu() for g in got]
        want = self.run(self.plain, table, rays, groups, active)
        for what, g, w in zip(("flag",) if self.any_hit else ("t", "idx", "rows"), got, want):
            assert torch.equal(g, w), f"{self.name}: {what} differs from plain on {label}"
        hit = want[0] if self.any_hit else want[1] >= 0
        return float(hit.float().mean())

    def stats(self, table, rays, groups=None, active=None, layout: bool = True) -> dict:
        """``soup_stats`` of this entry point's query."""
        query = "target" if self.target else "anyhit" if self.any_hit else "nearest"
        det, occ = self.groups(table, groups) if self.target else (groups, None)
        return soup_stats(table, query, rays, det, active, occ, layout)

    def ray_bytes(self, n_rays: int, active=None) -> int:
        """The bytes a query of ``n_rays`` lanes must move for its rays:
        28 read for a ray that is asked for, a byte of the mask where there
        is one, and every lane's answer written (a flag, or t and idx, and
        the winner's row)."""
        out = 1 if self.any_hit else 8 if self.rows is None else 8 + 128
        if active is None:
            return n_rays * (28 + out)
        return int(active.sum()) * 28 + n_rays * (1 + out)

    def visited(self, table, groups) -> int:
        """The chunks a query visits: both lists of a target query."""
        if self.target:
            return sum(len(table.visits(g)) for g in self.groups(table, groups))
        return len(table.visits(groups))

    def bound(self, ray_bytes: int, n_chunks: int, stats: dict, layout: bool = True) -> dict:
        """The least time for queries whose rays need ``ray_bytes`` in all
        (:meth:`ray_bytes`) over ``n_chunks`` chunks in all, whose work
        ``stats`` counts: besides the rays, each visited chunk's rows, box
        (and sub-boxes on the own layout) and count read, and its rows of
        the winners' table."""
        n_bytes = ray_bytes + n_chunks * (256 * 80 + 32 + 12 + (8 * 32 if layout else 0))
        if self.rows is not None:
            n_bytes += n_chunks * 256 * 128
        return scan_bound("mt", n_bytes, stats, layout)


def small_soups(table):
    """Tables of 1, 255, 257 and 3840 triangles of ``table``'s soup, one
    group each: a target query over them has no occluder."""
    from theia_tpu_torch.ops.intersect_soup import SoupTable

    v0, e1, e2 = table.soup
    for n_tri in (1, 255, 257, 3840):
        small = SoupTable(v0[-n_tri:].contiguous(), e1[-n_tri:].contiguous(), e2[-n_tri:].contiguous())
        yield n_tri, (small, small.to("cpu"))


def check_soup(soup: Soup, adversarial, queries, report):
    """A soup kernel against its plain version, bit-equal: random rays at
    N = 262,144 and 524,288 with times and bound (the plain version on the
    card on every lane, and on the CPU on a seeded eighth of the first
    size's), lane masks, group ranges (on the card), bounds at and beside a
    hit, small and oddly cut soups (on the CPU, 8,192 rays), adversarial
    rays, and the recorded queries of one brute-force flagship
    batch, replayed for the time and bound a batch sees. Bounds count the
    work of the table's own layout; the first soup kernels' yardstick
    (``soup_stats`` without ``layout``) is kept beside."""
    import torch

    from theia_tpu_torch.ops.intersect_soup import SoupTable, nearest_in_table

    name, card = soup.name, soup.tables[0]
    for n in (BATCH, 2 * BATCH):
        rays = random_rays(n, n + len(name), "cuda")
        hits = soup.check(rays, f"random rays N={n} (plain on the card)", on_cpu=False)
        if n == BATCH:
            soup.check(rays, f"random rays N={n} (plain on the CPU, an eighth of the lanes)", on_cpu=True,
                       lanes=seeded_lanes(n, 8, n + len(name)))
        own, yard = soup.stats(card, rays), soup.stats(card, rays, layout=False)
        ms = cuda_ms(lambda: soup.run(soup.kernel, card, rays), 20)
        queued_ms = cuda_ms_queued(lambda: soup.run(soup.kernel, card, rays), 20)
        plain_ms = cuda_ms(lambda: soup.run(soup.plain, card, rays), 2)
        chunks = soup.visited(card, None)
        b = soup.bound(soup.ray_bytes(n), chunks, own)
        yb = soup.bound(soup.ray_bytes(n), chunks, yard, layout=False)
        print(
            f"kernel {name} N={n}: bit-equal to plain, hits {hits:.4f}; kernel {ms:.4f} ms ({queued_ms:.4f} queued), "
            f"plain {plain_ms:.4f} ms; this layout {work_line(own)}; bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']}, share of bound {b['bound_ms'] / ms:.3f} ({b['bound_ms'] / queued_ms:.3f} queued); "
            f"yardstick ({FIRST_SOUP_RULE}) {work_line(yard)}, bound {yb['bound_ms']:.4f} ms, share "
            f"{yb['bound_ms'] / ms:.3f} ({yb['bound_ms'] / queued_ms:.3f} queued)"
        )
        entry = dict(ms=ms, queued_ms=queued_ms, plain_ms=plain_ms, **b, n=n, **own,
                     yardstick=dict(yardstick(yb, ms, FIRST_SOUP_RULE), **yard))
        if n == BATCH:
            report.update(entry)
        else:
            report.update(double=entry)
    # lane masks and group ranges, and bounds at, just below and just above the nearest hit
    rays = random_rays(BATCH, 5 + len(name), "cuda")
    gen = torch.Generator("cuda").manual_seed(17)
    cases = 0
    for kept in (0.5, 0.02, 0.0):
        active = torch.rand(BATCH, device="cuda", generator=gen) < kept
        for groups in (None, [2], [0, 1], [1, 2]):
            soup.check(rays, f"mask {kept}, groups {groups}", on_cpu=False, groups=groups, active=active)
            cases += 1
    # the plain version runs on the CPU for the rest: a 32nd of the rays
    rays = tuple(r[: BATCH // 32].contiguous() for r in rays)
    t_hit = nearest_in_table(card, rays[0], rays[1], torch.inf)[0]
    t_hit = torch.where(torch.isfinite(t_hit), t_hit, 3.0)
    for label, t_max in (
        ("at", t_hit),
        ("just below", torch.nextafter(t_hit, torch.zeros_like(t_hit))),
        ("just above", torch.nextafter(t_hit, torch.full_like(t_hit, torch.inf))),
        ("zero, negative and NaN", torch.where(rays[2] < 2.0, torch.nan, rays[2] - 3.0)),
    ):
        soup.check((rays[0], rays[1], t_max.contiguous()), f"bounds {label} the hit", on_cpu=True)
        cases += 1
    # soups of 1, 255, 257 and 3840 triangles (a target query there has no occluder) under a lane mask, and
    # groups that end inside a chunk (one of them empty)
    half = torch.rand(rays[0].shape[0], device="cuda", generator=gen) < 0.5
    for n_tri, tables in small_soups(card):
        soup.check(rays, f"a soup of {n_tri}", on_cpu=True, active=half, tables=tables)
        cases += 1
    v0, e1, e2 = card.soup
    odd = SoupTable(v0, e1, e2, ((0, 100), (100, 100), (100, 1000), (1000, 2561), (2561, 3840)))
    for groups in (None, [0, 2], [1], [3, 4]):
        soup.check(rays, f"oddly cut groups {groups}", on_cpu=True, groups=groups, tables=(odd, odd.to("cpu")))
        cases += 1
    hits = soup.check(adversarial, "adversarial rays", on_cpu=True)
    print(f"kernel {name}: bit-equal to plain on {cases} cases of masks, groups, bounds beside a hit and small or "
          f"oddly cut soups, and on {adversarial[0].shape[0]} adversarial rays (hits {hits:.4f})")
    # the recorded batch: bit-equality (plain on the card), then a replay
    own, yard = {}, {}
    n_rays, n_chunks, unmasked, ray_bytes = 0, 0, 0, 0
    for o, d, t_max, groups, active in queries:
        soup.check((o, d, t_max), "a recorded flagship query", on_cpu=False, groups=groups, active=active)
        add_stats(own, soup.stats(card, (o, d, t_max), groups, active))
        add_stats(yard, soup.stats(card, (o, d, t_max), groups, active, layout=False))
        n_rays, n_chunks = n_rays + o.shape[0], n_chunks + soup.visited(card, groups)
        unmasked += o.shape[0] if active is None else int(active.sum())
        ray_bytes += soup.ray_bytes(o.shape[0], active)

    def replay():
        for o, d, t_max, groups, active in queries:
            soup.run(soup.kernel, card, (o, d, t_max), groups, active)

    batch_ms, queued_ms = cuda_ms(replay, 5), cuda_ms_queued(replay, 5)
    b, yb = soup.bound(ray_bytes, n_chunks, own), soup.bound(ray_bytes, n_chunks, yard, layout=False)
    print(
        f"kernel {name}: bit-equal to plain on the {len(queries)} recorded queries of a brute-force flagship batch "
        f"({n_rays} rays, {unmasked} unmasked); replayed {batch_ms:.4f} ms a batch ({queued_ms:.4f} queued); "
        f"this layout {work_line(own)}; bound {b['bound_ms']:.4f} ms by {b['bound_by']}, share of bound "
        f"{b['bound_ms'] / batch_ms:.3f} ({b['bound_ms'] / queued_ms:.3f} queued); yardstick {work_line(yard)}, "
        f"bound {yb['bound_ms']:.4f} ms by {yb['bound_by']}, share {yb['bound_ms'] / batch_ms:.3f} "
        f"({yb['bound_ms'] / queued_ms:.3f} queued)"
    )
    report.update(
        max_abs_err=0.0, library_ms=None,
        batch=dict(queries=len(queries), rays=n_rays, unmasked=unmasked, ms=batch_ms, queued_ms=queued_ms,
                   **own, **b, yardstick=dict(yardstick(yb, batch_ms, FIRST_SOUP_RULE), **yard)),
    )


def record_soup_queries(tracer, name, step=None):
    """(origin, direction, t_max, groups, active) of every call that one
    batch of ``tracer`` (or ``step``) makes to the soup wrapper
    ``accel.<name>``."""
    import torch

    from theia_tpu_torch import accel

    def query(*args, groups=None, active=None, **kw):
        o, d, t_max = args[-3:]
        t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device), o.shape[:1])
        return o.clone(), d.clone(), t_max.clone().contiguous(), groups, None if active is None else active.clone()

    return record_calls(tracer, accel, (name,), query, step)


def record_calls(tracer, module, names, keep, step=None):
    """Run one batch of ``tracer`` (``tracer.run``, or ``step``) and return
    ``keep(*args)`` of every call it makes to ``module.<name>`` for
    ``name`` in ``names``, in order. The RNG offset is put back, so the
    timed batches start where they always did."""
    import torch

    kept = []

    def recording(fn):
        def wrapper(*args, **kw):
            kept.append(keep(*args, **kw))
            return fn(*args, **kw)
        wrapper.launches = fn.launches  # a wrapper counts on the name it is called by
        return wrapper

    saved = {name: getattr(module, name) for name in names}
    try:
        for name, fn in saved.items():
            setattr(module, name, recording(fn))
        offset = tracer.rng.offset
        (step or tracer.run)()
        tracer.rng.offset = offset
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
    torch.cuda.synchronize()
    return kept


def record_queries(tracer, names):
    """The (origin, direction, t_max) of every call that one batch of
    ``tracer`` makes to the nearest-hit wrappers ``accel.<name>``."""
    import torch

    from theia_tpu_torch import accel

    def rays(*args):
        o, d, t_max = args[-3:]
        t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device), o.shape[:1])
        return o.clone(), d.clone(), t_max.clone().contiguous()

    return record_calls(tracer, accel, names, rays)


def record_records(tracer, step=None):
    """The inputs of every ``histogram_add`` call of one batch of
    ``tracer`` (or ``step``), as the tuples that ``hist_case`` makes."""
    from theia_tpu_torch import response

    def inputs(state, value, time_, mask, t0, bin_size, n_bins, object_id, n_det):
        oid = None if object_id is None else object_id.clone()
        return value.detach().clone(), time_.clone(), mask.clone(), t0, bin_size, n_bins, oid, n_det

    return record_calls(tracer, response, ("histogram_add",), inputs, step)


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


#: the table-read sites of each path, (module, names): the reads the scene
#: tracer calls and the reads of the volume and photon tracers
SCENE_READS = (("theia_tpu_torch.trace.scene", ("packed_medium_constants", "read_packed", "lookup_packed")),)
VOLUME_READS = (
    ("theia_tpu_torch.trace.volume", ("medium_constants", "lookup", "phase_matrix_elements")),
    ("theia_tpu_torch.trace.core", ("lookup",)),
)
#: aten operations that launch nothing on the card besides views
NO_LAUNCH = ("empty", "empty_like", "empty_strided", "detach", "alias", "lift_fresh")


def read_sites(step, sites) -> dict:
    """One call of ``step`` with each table-read site of ``sites`` wrapped:
    per site, its calls, the table-read kernels they launched and the
    launches of torch that they made (every aten operation that is not a
    view or an allocation, counted by a ``TorchDispatchMode``), and the
    most launches of one call."""
    import importlib

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from theia_tpu_torch.ops import table_read as tr

    ops = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not (func.is_view or func.overloadpacket.__name__ in NO_LAUNCH):
                ops[0] += 1
            return func(*args, **(kwargs or {}))

    stats, patched = {}, []

    def wrap(fn, label):
        def site(*args, **kwargs):
            before = ops[0], tr.read_table.launches + tr.read_packed.launches
            out = fn(*args, **kwargs)
            reads = tr.read_table.launches + tr.read_packed.launches - before[1]
            s = stats.setdefault(label, dict(calls=0, read_launches=0, torch_launches=0, most=0))
            s["calls"] += 1
            s["read_launches"] += reads
            s["torch_launches"] += ops[0] - before[0]
            s["most"] = max(s["most"], reads + ops[0] - before[0])
            return out
        return site

    for module, names in sites:
        mod = importlib.import_module(module)
        for name in names:
            patched.append((mod, name, getattr(mod, name)))
            setattr(mod, name, wrap(getattr(mod, name), f"{name} ({module.rsplit('.', 1)[1]}.py)"))
    try:
        with Count():
            step()
            torch.cuda.synchronize()
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
    return stats


def check_read_sites(label, stats) -> None:
    """Print a batch's read sites and hold each to its launches: one a
    table read, at most two a medium's constants (the read and mu_e's
    add)."""
    for site, s in stats.items():
        print(f"{label} read site {site}: {s['calls']} calls, {s['read_launches']} table-read launches, "
              f"{s['torch_launches']} torch launches, at most {s['most']} a call")
        assert s["read_launches"] <= s["calls"], (site, s)
        assert s["most"] <= (2 if "constants" in site else 1), (site, s)


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


#: kinds of eager kernels that a profile sums: fragments of their names
#: (lower case), e.g. the zero fills, copies and adds that the backward of
#: a slice makes
KINDS = {"fills": ("fillfunctor", "memset"), "copies": ("copy_kernel", "memcpy"), "adds": ("functor_add",)}


def profile_step(step, watch=()) -> dict:
    """One call of ``step`` under ``torch.profiler``: the device's busy
    time (the sum of its kernels' and copies' times), their count, the
    twelve largest items, the hand-written kernels' items, the ``KINDS``
    summed and, for each name fragment in ``watch``, the items whose name
    holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.device_time if hasattr(e, "device_time") else e.cuda_time)
    item = lambda n, t: dict(name=n, ms=sum(t) / 1e3, count=len(t))
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    mine = ("histogram", "theia::scan", "philox", "kde_", "read_", "::gather")
    own = sorted((n, t) for n, t in by_name.items() if any(k in n for k in mine))
    watched = {w: [item(n, t) for n, t in by_name.items() if w in n] for w in watch}
    kinds = {
        kind: item(kind, [x for n, t in by_name.items() if any(f in n.lower() for f in frags) for x in t])
        for kind, frags in KINDS.items()
    }
    return dict(
        device_busy_ms=sum(map(sum, by_name.values())) / 1e3, kernels=len(events),
        top=[item(n, t) for n, t in top], own=[item(n, t) for n, t in own], watched=watched, kinds=kinds,
    )


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


def time_weighted(curve):
    """sum(curve * exp(-linspace(0, 2, nBins))): the time-weighted signal
    of ``tools/ref_conformance._medium_params_loss``, linear in the light
    curve. Phase 4 compares gradients of this loss: the examples' losses
    are squared differences of two light curves, whose cancellation turns
    the atomics' rounding of each bin into 1e-5 of the gradient."""
    import torch

    n_bins = curve.shape[-1]
    return (curve * torch.exp(-torch.linspace(0.0, 2.0, n_bins, device=curve.device))).sum()


def scale_step(tracer, table: str, truth: float | None):
    """Examples 05 and 06 as one gradient step on ``tracer`` (a volume
    tracer): the light curve with the medium table ``table`` scaled by
    exp(s), the observation at s = ``truth`` made beforehand, and a step
    that returns (loss, d loss / d s) at s = 0 through ``trace_fn()``:
    loss = 1e6 * sum(((curve - observed) / (sum(observed) + 1))^2), or
    ``time_weighted(curve)`` where ``truth`` is None."""
    import torch

    fn, (p, counter, streams) = tracer.trace_fn()
    base = getattr(p["medium"], table)

    def curve(s):
        med = dataclasses.replace(p["medium"], **{table: base * torch.exp(s)})
        state, _ = fn({**p, "medium": med}, counter, streams)
        return tracer.response.result(p["response"], state)

    if truth is not None:
        with torch.no_grad():
            observed = curve(torch.tensor(truth, device=base.device))

    def step():
        s = torch.zeros((), device=base.device, requires_grad=True)
        if truth is None:
            loss = time_weighted(curve(s))
        else:
            d = (curve(s) - observed) / (observed.sum() + 1.0)
            loss = (d * d).sum() * 1e6
        loss.backward()
        return loss.item(), s.grad.double().cpu().numpy().reshape(1)

    return step


#: the geometry step's observation: the detector (instance 2 of the
#: flagship) and the source moved by these, in metres
GEOMETRY_TRUTH = ((0.05, -0.03, 0.0), (0.02, 0.0, 0.01))


def geometry_step(tracer, fit: bool = True):
    """Example 10's calibration as one gradient step on the brute-force
    flagship ``tracer`` (with a ``KernelHistogramHitResponse``): the light
    curve with the detector moved by ``translate_instance`` and the source
    moved, the observation at ``GEOMETRY_TRUTH`` made beforehand, and a
    step that returns (loss, gradient) at the nominal geometry, loss =
    sum((curve - observed)^2) / sum(observed^2), the gradient in the
    detector's shift, the source's position and the packed
    ``log_phase_function`` and ``refractive_index`` tables (so that the
    packed read's backward runs too), concatenated. Without ``fit`` the
    loss is ``time_weighted(curve)``."""
    import numpy as np
    import torch

    fn, (p, counter, streams) = tracer.trace_fn()
    media = p["scene"].media
    source = p["lightSource"]["position"]
    dev = source.device

    def curves(delta, src, tables):
        pack = p["scene"].translate_instance(2, delta)
        pack = dataclasses.replace(pack, media=dataclasses.replace(media, tables={**media.tables, **tables}))
        return fn({**p, "scene": pack, "lightSource": {**p["lightSource"], "position": src}}, counter, streams)[0]

    if fit:
        with torch.no_grad():
            det_shift, src_shift = (torch.tensor(v, device=dev) for v in GEOMETRY_TRUTH)
            observed = curves(det_shift, source + src_shift, {})

    def step():
        leaves = [torch.zeros(3, device=dev), source.clone()] + [
            media.tables[k].clone() for k in ("log_phase_function", "refractive_index")
        ]
        for leaf in leaves:
            leaf.requires_grad_(True)
        c = curves(leaves[0], leaves[1], {"log_phase_function": leaves[2], "refractive_index": leaves[3]})
        loss = ((c - observed) ** 2).sum() / (observed**2).sum() if fit else time_weighted(c)
        loss.backward()
        return loss.item(), np.concatenate([leaf.grad.double().cpu().numpy().reshape(-1) for leaf in leaves])

    return step


def time_step(step, wrappers, label, reps: int = 3) -> dict:
    """``step`` once to warm up, then ``reps`` times on the host's clock
    ending in a synchronize (the median is seconds per step), with the
    peak memory over them and the launches of ``wrappers`` in the first
    timed step; then one step under the profiler."""
    import numpy as np
    import torch

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, counts = [], None
    for k in range(reps):
        for w in wrappers.values():
            w.launches = 0
        start = time.perf_counter()
        loss, grad = step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        counts = counts or {name: w.launches for name, w in wrappers.items() if w.launches}
        assert np.isfinite(grad).all() and np.isfinite(loss) and loss > 0.0, f"{label}: non-finite or zero loss"
    peak = torch.cuda.max_memory_allocated()
    prof = profile_step(step, watch=("indexing_backward",))
    med = statistics.median(seconds)
    print(f"{label}: {med:.4f} s a step (median of {[round(x, 4) for x in seconds]}), peak memory "
          f"{peak / 2**20:.1f} MiB, launches a step {counts}; profiled: device busy {prof['device_busy_ms']:.2f} ms, "
          f"{prof['kernels']} kernels and copies, index backward {prof['watched']['indexing_backward']}; loss {loss:.6g}, "
          f"gradient {np.array2string(grad[:6], precision=6)}{' ...' if grad.size > 6 else ''}")
    for entry in prof["top"][:6] + prof["own"] + list(prof["kinds"].values()):
        print(f"    {entry['ms']:9.3f} ms {entry['count']:6d} x {entry['name'][:90]}")
    return dict(seconds_per_step=seconds, median_s=med, peak_bytes=peak, launches=counts, profile=prof,
                loss=loss, grad=grad.tolist())


def gradient_agreement(label, g_cpu, g_card) -> dict:
    """``PERF.md``'s gradient agreement between the port on the CPU and on
    the card: the same nonzero entries, each within rtol 1e-3, the sum
    within 1e-5."""
    import numpy as np

    rel = np.abs(g_card - g_cpu) / np.maximum(np.abs(g_cpu), 1e-300)
    worst = float(rel[g_cpu != 0].max())
    sum_rel = abs(g_card.sum() / g_cpu.sum() - 1.0)
    print(f"cpu vs card ({label}) at batch {GRAD_BATCH}, path length {GRAD_PATH}: "
          f"{int((g_cpu != 0).sum())} nonzero entries, worst entry rel diff {worst:.3g}, sum rel diff {sum_rel:.3g}")
    assert np.array_equal(g_cpu != 0, g_card != 0), f"gradient nonzero pattern differs ({label})"
    assert worst <= 1e-3 and sum_rel <= 1e-5, f"cpu and card gradients disagree ({label})"
    return dict(worst_entry_rel=worst, sum_rel=sum_rel)


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
    from theia_tpu_torch.ops.intersect_soup import (
        anyhit_in_table, nearest_in_table, nearest_in_table_rows, target_in_table,
    )
    from theia_tpu_torch.ops.intersect_woop import nearest_triangle_woop
    from theia_tpu_torch.random import philox_uniform
    from theia_tpu_torch.ops import table_read
    from theia_tpu_torch.response import histogram_add, histogram_grad
    from theia_tpu_torch.response import (
        KernelHistogramHitResponse, StoreTimeHitResponse, kernel_histogram_add, kernel_histogram_grad,
    )
    from torch_flagship import (
        adversarial_rays, build_flagship, build_photon_flagship, build_volume_flagship, build_volume_photon, icosphere,
    )

    # the seconds of each phase, printed as it ends
    clock = {"1": time.perf_counter()}

    def phase(name: str) -> None:
        last = list(clock)[-1]
        clock[name] = lap_clock[0] = time.perf_counter()
        print(f"phase {last}: {clock[name] - clock[last]:.1f} s")

    lap_clock = [time.perf_counter()]

    def lap(what: str) -> None:
        """The seconds since the last lap, inside a phase."""
        now = time.perf_counter()
        print(f"    ({what}: {now - lap_clock[0]:.1f} s)")
        lap_clock[0] = now

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

    phase("2")
    # phase 2: kernels against their plain versions at the main path's shapes
    sqrt_check = check_sqrt()
    mesh = icosphere(3)
    tracer = build_flagship(theia_tpu_torch, mesh, BATCH, MAX_PATH, device="cuda")
    brute_tracer = build_flagship(theia_tpu_torch, mesh, BATCH, MAX_PATH, accel="auto", device="cuda")
    assert brute_tracer.scene.accel == "brute", brute_tracer.scene.accel
    pol_tracer = build_flagship(
        theia_tpu_torch, mesh, BATCH, MAX_PATH, accel="woop", polarized=True, device="cuda"
    )
    kernels = {
        "nearest_triangle_mt": dict(
            route="cuda", source="theia_tpu_torch/csrc/intersect_soup.cu",
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
            route="cuda", source="theia_tpu_torch/csrc/intersect_soup.cu",
            replaces="tools/exp_mt_fused.py:68",
        ),
        "histogram_grad": dict(
            route="cuda", source="theia_tpu_torch/csrc/histogram.cu",
            replaces="theia_tpu/response.py:226",
        ),
        **{
            name: dict(route="cuda", source="theia_tpu_torch/csrc/intersect_soup.cu", replaces=replaces)
            for name, replaces in SOUP_KERNELS.items()
        },
        **{
            name: dict(route="cuda", source=source, replaces=replaces)
            for name, (source, replaces) in GRADIENT_KERNELS.items()
        },
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
    mt_records, woop_records = record_records(tracer), record_records(pol_tracer)
    # fused: 10 of N lanes, 9 of 2 N; polarized, unfused: the extension, the surface and two shadow halves
    assert sorted(r[2].shape[0] for r in mt_records) == [BATCH] * MAX_PATH + [2 * BATCH] * (MAX_PATH - 1)
    assert [r[2].shape[0] for r in woop_records] == [BATCH] * POL_RECORDS, len(woop_records)
    lap("recording the flagship batches")
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
    lap("the three nearest-hit kernels")
    soup_rows = brute_tracer.scene.pack.tri_data[:, 18:27].cpu().numpy()
    assert (soup_rows[:, 0:3] != rows[:, 0:3]).any(), "the brute-force soup is in instance order, not Morton order"
    # the 10 primary queries (every group, no mask) and the 9 shadow pairs (the detector, masked)
    primary = record_soup_queries(brute_tracer, "nearest_in_table_rows")
    shadow = record_soup_queries(brute_tracer, "target_in_table")
    assert len(primary) == MAX_PATH and all(q[3] is None and q[4] is None for q in primary), len(primary)
    assert len(shadow) == MAX_PATH - 1 and all(q[3] == [2] and q[4] is not None for q in shadow), len(shadow)
    # the nearest-hit kernels take the primary queries and the shadow pairs' detector halves; the
    # any-hit takes the occluder halves with the bounds and masks that the detector halves give
    occluder_halves = []
    for o, d, t_max, groups, active in shadow:
        t_det, idx_det = nearest_in_table(brute_tracer.scene.pack.soup, o, d, t_max, groups=groups, active=active)
        occluder_halves.append((o, d, t_det, [0, 1], idx_det >= 0))
    for name in SOUP_KERNELS:
        queries = dict(nearest_in_table_rows=primary, anyhit_in_table=occluder_halves, target_in_table=shadow)
        queries = queries.get(name, primary + shadow)
        check_soup(Soup(name, brute_tracer.scene.pack), adversarial, queries, kernels[name])
    # the shadow pair without the winners' rows, as the flagship takes it where tri_data is differentiated
    bare = Soup("target_in_table", brute_tracer.scene.pack, rows=False)
    # the winners of one shadow pair: the rows that the reconstruction gathers (phase 2's gather cases)
    shadow_winners = bare.run(bare.kernel, bare.tables[0], shadow[0][:3], shadow[0][3], shadow[0][4])[1]
    for o, d, t_max, groups, active in shadow:
        bare.check((o, d, t_max), "a recorded shadow pair without rows", on_cpu=False, groups=groups, active=active)
    o, d, t_max, active = (q[: BATCH // 32].contiguous() for q in (*shadow[0][:3], shadow[0][4]))
    for n_tri, tables in small_soups(bare.tables[0]):
        bare.check((o, d, t_max), f"a soup of {n_tri} without rows", on_cpu=True, active=active, tables=tables)
    print(f"kernel target_in_table: bit-equal to plain without rows on the {len(shadow)} recorded shadow pairs "
          f"and on soups of 1, 255, 257 and 3840 triangles (no occluder)")
    del primary, shadow, occluder_halves, queries
    lap("the soup kernels")
    check_philox(kernels["philox_uniform"])
    check_histogram(kernels["histogram_add"], kernels["histogram_grad"])
    brute_records = record_records(brute_tracer)
    assert sorted(r[2].shape[0] for r in brute_records) == [BATCH] * MAX_PATH + [2 * BATCH] * (MAX_PATH - 1)
    for path, records in (("mt", mt_records), ("polarized woop", woop_records), ("brute", brute_records)):
        check_record_replay(records, path, kernels["histogram_add"], kernels["histogram_grad"])
    del mt_records, woop_records, brute_records, records
    lap("philox and the histogram")
    # the volume flagship's records (one direct extension, then two MIS candidates a segment) and the
    # photon flagship's: its primary queries and records, of run() and of run_compacted()
    volume_tracer = build_volume_flagship(theia_tpu_torch, BATCH, "cuda")
    photon_tracer = build_photon_flagship(theia_tpu_torch, mesh, BATCH, "cuda")
    volume_records = record_records(volume_tracer)
    assert [r[2].shape[0] for r in volume_records] == [BATCH] * VOLUME_RECORDS, len(volume_records)
    check_record_replay(volume_records, "volume", kernels["histogram_add"], kernels["histogram_grad"])
    compacted = lambda: photon_tracer.run_compacted(advance=False, min_lanes=PHOTON_MIN_LANES)
    photon_queries = record_soup_queries(photon_tracer, "nearest_in_table_rows")
    photon_queries += record_soup_queries(photon_tracer, "nearest_in_table_rows", compacted)
    assert len(photon_queries) == 2 * PHOTON_PATH, len(photon_queries)
    photon_soup = Soup("nearest_in_table_rows", photon_tracer.scene.pack)
    for o, d, t_max, groups, active in photon_queries:
        photon_soup.check((o, d, t_max), "a recorded photon query", on_cpu=False, groups=groups, active=active)
    print(f"kernel nearest_in_table_rows: bit-equal to plain on the {len(photon_queries)} recorded queries of a "
          f"photon flagship batch, run() and run_compacted() (rays {[q[0].shape[0] for q in photon_queries]})")
    photon_records = record_records(photon_tracer) + record_records(photon_tracer, compacted)
    assert len(photon_records) == 2 * PHOTON_PATH, len(photon_records)
    check_record_replay(photon_records, "photon", kernels["histogram_add"], kernels["histogram_grad"])
    del volume_records, photon_queries, photon_records
    # the gradient path's kernels: the kernel histogram (K1) and the table reads (K2) on the flagship
    # scene's packed tables and the volume flagship's 1024-sample table
    lap("the volume and photon flagships' records and queries")
    check_kernel_histogram(kernels["kernel_histogram_add"], kernels["kernel_histogram_grad"])
    check_table_read(kernels, brute_tracer.scene.pack.media, volume_tracer.params()["medium"])
    check_gather_rows(kernels["gather_rows"], kernels["gather_rows_grad"], brute_tracer.scene.pack, shadow_winners)
    lap("the kernel histogram and the table reads")

    phase("3")
    # phase 3: the first main path (accel="mt") at full width
    wrappers = {
        "nearest_triangle_mt": nearest_triangle_mt,
        "nearest_triangle_mt_rows": nearest_triangle_mt_rows,
        "nearest_triangle_woop": nearest_triangle_woop,
        "nearest_in_table_rows": nearest_in_table_rows,
        "nearest_in_table": nearest_in_table,
        "anyhit_in_table": anyhit_in_table,
        "target_in_table": target_in_table,
        "philox_uniform": philox_uniform,
        "histogram_add": histogram_add,
        "read_table": table_read.read_table,
        "read_packed": table_read.read_packed,
        "gather_rows": table_read.gather_rows,
    }
    # the gradient steps' launches: every wrapper, the backward kernels and the kernel histogram too
    grad_wrappers = {
        **wrappers,
        "histogram_grad": histogram_grad,
        "kernel_histogram_add": kernel_histogram_add,
        "kernel_histogram_grad": kernel_histogram_grad,
        "read_table_grad": table_read.read_table_grad,
        "read_packed_grad": table_read.read_packed_grad,
        "gather_rows_grad": table_read.gather_rows_grad,
    }
    seconds, sums, counts, peak = timed_runs(tracer, wrappers, "mt path")
    assert counts["nearest_triangle_mt_rows"] == 19 * 3, counts  # 10 primary + 9 shadow
    assert counts["nearest_triangle_mt"] == counts["nearest_triangle_woop"] == 0, counts
    assert not any(counts[name] for name in SOUP_KERNELS), counts
    assert counts["philox_uniform"] > 0 and counts["histogram_add"] == 19 * 3, counts
    assert counts["read_packed"] > 0, counts
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
    # every read site of a batch is one launch, a medium's constants at most two (one read, mu_e's add)
    mt_sites = read_sites(tracer.run, SCENE_READS)
    check_read_sites("main path (mt)", mt_sites)
    print(f"main path (mt): table-read launches a batch: read_packed {counts['read_packed'] // 3}, "
          f"read_table {counts['read_table'] // 3}")
    # the winners' rows from the kernel and from a separate gather (gather_rows), in turns
    turns = []
    for from_query in (True, False, False, True):
        accel.ROWS_FROM_QUERY = from_query
        turn_seconds, _, turn_counts, _ = timed_runs(tracer, wrappers, "mt path")
        own, other = "nearest_triangle_mt_rows", "nearest_triangle_mt"
        if not from_query:
            own, other = other, own
        assert turn_counts[own] == 19 * 3 and turn_counts[other] == 0, turn_counts
        turns.append(dict(rows_from_kernel=from_query, seconds_per_batch=turn_seconds))
        if not from_query:
            kernels["nearest_triangle_mt"].update(
                launches=turn_counts[own], launches_per_batch=19,
                path="mt flagship with the separate gather, 3 batches",
            )
    accel.ROWS_FROM_QUERY = True
    print("main path (mt), rows from the kernel / a separate gather, in turns: " + "; ".join(
        f"{'kernel' if t['rows_from_kernel'] else 'gather'} {statistics.median(t['seconds_per_batch']):.4f} s "
        f"{[round(x, 4) for x in t['seconds_per_batch']]}" for t in turns
    ))
    del tracer
    torch.cuda.empty_cache()

    phase("3b")
    # phase 3b: the second main path (accel="woop", polarized) at full width
    pol_seconds, pol_sums, pol_counts, pol_peak = timed_runs(pol_tracer, wrappers, "woop path")
    assert pol_counts["nearest_triangle_woop"] == 19 * 3, pol_counts
    assert pol_counts["nearest_triangle_mt"] == pol_counts["nearest_triangle_mt_rows"] == 0, pol_counts
    assert not any(pol_counts[name] for name in SOUP_KERNELS), pol_counts
    assert pol_counts["philox_uniform"] > 0 and pol_counts["histogram_add"] == POL_RECORDS * 3, pol_counts
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
    pol_sites = read_sites(pol_tracer.run, SCENE_READS)
    check_read_sites("main path (woop, polarized)", pol_sites)
    print(f"main path (woop, polarized): table-read launches a batch: read_packed {pol_counts['read_packed'] // 3}, "
          f"read_table {pol_counts['read_table'] // 3}")

    phase("3c")
    # phase 3c: the gradient at full width, on the same tracer (the
    # largest power-of-two batch that fits, should the full one not)
    grad_batch = BATCH
    while True:
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for w in grad_wrappers.values():
                w.launches = 0
            start = time.perf_counter()
            loss, grad = absorption_grad(pol_tracer)
            torch.cuda.synchronize()
            grad_seconds = time.perf_counter() - start
            grad_launches = histogram_grad.launches
            grad_counts = {name: w.launches for name, w in grad_wrappers.items() if w.launches}
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
    assert grad_launches == POL_RECORDS, f"the histogram backward launched {grad_launches} times"
    print(
        f"gradient (woop, polarized): batch {grad_batch}{'' if grad_batch == BATCH else ' (largest that fits)'}, "
        f"path length {MAX_PATH}: forward + backward {grad_seconds:.4f} s, peak memory "
        f"{grad_peak / 2**20:.1f} MiB, loss {loss:.6g}, d loss / d mu_a summed {grad.sum():.6g}, "
        f"{int((grad != 0).sum())} nonzero entries, histogram_grad launches {grad_launches}"
    )
    kernels["histogram_grad"].update(
        launches=grad_launches, launches_per_batch=grad_launches, path="polarized woop gradient, 1 step"
    )
    # the table reads' backward replaces torch's sorting index backward (before it was a kernel:
    # indexing_backward_kernel_small_stride, 10 launches, 51.0 of 168.1 ms of device time); one step profiled
    assert grad_counts.get("read_packed_grad", 0) > 0, grad_counts
    for name in ("read_packed",):
        kernels[name].update(launches=grad_counts.get(name, 0), launches_per_step=grad_counts.get(name, 0),
                             path="polarized woop gradient, 1 step")
    grad_prof = profile_step(lambda: absorption_grad(pol_tracer), watch=("indexing_backward",))
    small_stride = [e for e in grad_prof["watched"]["indexing_backward"] if "small_stride" in e["name"]]
    print(f"gradient (woop, polarized) profiled: device busy {grad_prof['device_busy_ms']:.2f} ms, "
          f"{grad_prof['kernels']} kernels and copies; launches a step {grad_counts}; index backward kernels "
          f"{grad_prof['watched']['indexing_backward']} (before the reads' backward kernel: "
          f"indexing_backward_kernel_small_stride 10 launches, "
          f"51.048 ms of 168.09 ms)")
    for entry in grad_prof["top"][:8] + grad_prof["own"]:
        print(f"    {entry['ms']:9.3f} ms {entry['count']:6d} x {entry['name'][:90]}")
    print("gradient (woop, polarized): table-read launches a step: " + ", ".join(
        f"{name} {grad_counts.get(name, 0)}" for name in ("read_packed", "read_packed_grad", "read_table",
                                                          "read_table_grad")))
    assert not small_stride, f"the table reads' backward still runs torch's index backward: {small_stride}"
    del pol_tracer
    torch.cuda.empty_cache()

    phase("3d")
    # phase 3d: the third main path, the brute-force flagship (no accel named), at full width
    brute_seconds, brute_sums, brute_counts, brute_peak = timed_runs(brute_tracer, wrappers, "brute path")
    # 10 primary queries with rows, and the 9 shadow pairs in one launch each; no separate any-hit
    assert brute_counts["nearest_in_table_rows"] == MAX_PATH * 3 and brute_counts["nearest_in_table"] == 0, brute_counts
    assert brute_counts["target_in_table"] == (MAX_PATH - 1) * 3 and brute_counts["anyhit_in_table"] == 0, brute_counts
    for name in ("nearest_triangle_mt", "nearest_triangle_mt_rows", "nearest_triangle_woop"):
        assert brute_counts[name] == 0, brute_counts
    assert brute_counts["philox_uniform"] > 0 and brute_counts["histogram_add"] == 19 * 3, brute_counts
    brute_med = statistics.median(brute_seconds)
    print(
        f"main path (brute, the default accel): batch {BATCH}, path length {MAX_PATH}, "
        f"{brute_tracer.scene.pack.soup.n_tri} triangles: "
        f"{brute_med:.4f} s/batch (median of {[round(s, 4) for s in brute_seconds]}), "
        f"{BATCH * MAX_PATH / brute_med:.6g} bounces/s, peak memory {brute_peak / 2**20:.1f} MiB, "
        f"launches per batch {{{', '.join(f'{k}: {v // 3}' for k, v in brute_counts.items())}}}, "
        f"histogram sums {brute_sums}"
    )
    for name in ("nearest_in_table_rows", "target_in_table"):
        kernels[name].update(launches=brute_counts[name], launches_per_batch=brute_counts[name] // 3,
                             path="brute-force flagship, 3 batches")
    # the constants tables are read where they lie: nothing stacks them (const4_table is gone)
    assert not hasattr(theia_tpu_torch.material, "const4_table")
    brute_sites = read_sites(brute_tracer.run, SCENE_READS)
    check_read_sites("main path (brute)", brute_sites)
    print(f"main path (brute): table-read launches a batch: read_packed {brute_counts['read_packed'] // 3}, "
          f"read_table {brute_counts['read_table'] // 3}")
    # the winners' rows from the kernel and from a separate gather (gather_rows), in turns
    brute_turns = []
    for from_query in (True, False, False, True):
        accel.ROWS_FROM_QUERY = from_query
        turn_seconds, _, turn_counts, _ = timed_runs(brute_tracer, wrappers, "brute path")
        own, other = "nearest_in_table_rows", "nearest_in_table"
        if not from_query:
            own, other = other, own
        assert turn_counts[own] == MAX_PATH * 3 and turn_counts[other] == 0, turn_counts
        assert turn_counts["target_in_table"] == (MAX_PATH - 1) * 3, turn_counts
        brute_turns.append(dict(rows_from_kernel=from_query, seconds_per_batch=turn_seconds))
        if not from_query:
            kernels["nearest_in_table"].update(
                launches=turn_counts[own], launches_per_batch=MAX_PATH,
                path="brute-force flagship with the separate gather, 3 batches",
            )
    accel.ROWS_FROM_QUERY = True
    print("main path (brute), rows from the kernel / a separate gather, in turns: " + "; ".join(
        f"{'kernel' if t['rows_from_kernel'] else 'gather'} {statistics.median(t['seconds_per_batch']):.4f} s "
        f"{[round(x, 4) for x in t['seconds_per_batch']]}" for t in brute_turns
    ))
    # the three backends in turns, unpolarized: seconds per batch compare only inside one call
    backends = {
        "mt": build_flagship(theia_tpu_torch, mesh, BATCH, MAX_PATH, accel="mt", device="cuda"),
        "woop": build_flagship(theia_tpu_torch, mesh, BATCH, MAX_PATH, accel="woop", device="cuda"),
        "brute": brute_tracer,
    }
    backend_turns = []
    for label in ("mt", "woop", "brute", "brute", "woop", "mt"):
        turn_seconds, turn_sums, _, _ = timed_runs(backends[label], wrappers, f"{label} path")
        backend_turns.append(dict(accel=label, seconds_per_batch=turn_seconds, histogram_sums=turn_sums))
    print("main paths in turns, unpolarized: " + "; ".join(
        f"{t['accel']} {statistics.median(t['seconds_per_batch']):.4f} s "
        f"{[round(x, 4) for x in t['seconds_per_batch']]}" for t in backend_turns
    ))
    phase("3e")
    # phase 3e: the visibility query on the brute-force scene, the any-hit's entry point since the
    # shadow pair takes one launch: observers around the scene, targets up to 5 m along random rays
    o, d, reach = random_rays(BATCH, 31, "cuda")
    target = o + d * torch.where(torch.isfinite(reach), reach, 5.0)[:, None]
    for w in wrappers.values():
        w.launches = 0
    seen = [accel.is_visible(brute_tracer.scene.pack, o, target) for _ in range(3)]
    torch.cuda.synchronize()
    vis_counts = {name: w.launches for name, w in wrappers.items()}
    assert vis_counts["anyhit_in_table"] == 3 and sum(vis_counts.values()) == 3, vis_counts
    assert all(torch.equal(v, seen[0]) for v in seen) and 0.0 < float(seen[0].float().mean()) < 1.0
    print(f"is_visible (brute): {BATCH} observer-target pairs, visible {float(seen[0].float().mean()):.4f}, "
          f"launches {vis_counts['anyhit_in_table']}")
    kernels["anyhit_in_table"].update(launches=vis_counts["anyhit_in_table"], launches_per_batch=1,
                                      path="is_visible on the brute-force scene, 3 calls")
    del backends, brute_tracer
    torch.cuda.empty_cache()

    phase("3f")
    # phase 3f: the volume flagship (examples/01_volume_tracing.py's tracer) at the flagship's width
    vol_seconds, vol_sums, vol_counts, vol_peak = timed_runs(volume_tracer, wrappers, "volume path")
    assert vol_counts["histogram_add"] == VOLUME_RECORDS * 3 and vol_counts["philox_uniform"] > 0, vol_counts
    assert vol_counts["read_table"] > 0, vol_counts
    assert not any(vol_counts[name] for name in wrappers if name not in ("histogram_add", "philox_uniform", "read_table")), vol_counts
    vol_med = statistics.median(vol_seconds)
    vol_prof = profile_step(volume_tracer.run)
    print(
        f"volume path: batch {BATCH}, {volume_tracer.nScattering} scatterings: {vol_med:.4f} s/batch (median of "
        f"{[round(x, 4) for x in vol_seconds]}), {BATCH * volume_tracer.nScattering / vol_med:.6g} bounces/s, "
        f"peak memory {vol_peak / 2**20:.1f} MiB, launches per batch "
        f"{{{', '.join(f'{k}: {v // 3}' for k, v in vol_counts.items() if v)}}}; one batch profiled: device busy "
        f"{vol_prof['device_busy_ms']:.2f} ms, {vol_prof['kernels']} kernels and copies; histogram sums {vol_sums}"
    )
    for entry in vol_prof["top"][:6] + vol_prof["own"]:
        print(f"    {entry['ms']:9.3f} ms {entry['count']:6d} x {entry['name'][:90]}")
    vol_sites = read_sites(volume_tracer.run, VOLUME_READS)
    check_read_sites("volume path", vol_sites)
    del volume_tracer
    torch.cuda.empty_cache()

    phase("3g")
    # phase 3g: the photon flagship (ScenePhotonTracer on the brute-force scene): run() and
    # run_compacted() on the same streams, then each timed in turns, then each profiled
    h_run = photon_tracer.run(advance=False)[0]
    h_comp = photon_tracer.run_compacted(advance=False, min_lanes=PHOTON_MIN_LANES)
    torch.testing.assert_close(h_comp, h_run, rtol=1e-6, atol=1e-4)  # the graft's limits
    photon_rel = float((h_comp - h_run).abs().max() / h_run.abs().max())
    assert h_run.shape == (50,) and float(h_run.sum()) > 0.0 and photon_tracer.compaction_overflow == 0
    photon_lanes = photon_tracer.compacted_lanes
    print(f"photon path: run_compacted() against run() on the same streams: max difference {photon_rel:.3g} of the "
          f"largest bin; lanes after each run {photon_lanes}")
    photon_turns = []
    for kind in ("run", "compacted", "compacted", "run"):
        step = (lambda: photon_tracer.run()[0]) if kind == "run" else (
            lambda: photon_tracer.run_compacted(min_lanes=PHOTON_MIN_LANES))
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        turn_seconds = []
        for _ in range(3):
            start = time.perf_counter()
            hist = step()
            torch.cuda.synchronize()
            turn_seconds.append(time.perf_counter() - start)
            assert bool(torch.isfinite(hist).all()) and float(hist.sum()) > 0.0, f"photon {kind}: bad histogram"
        turn_counts = {name: w.launches for name, w in wrappers.items()}
        assert turn_counts["nearest_in_table_rows"] == PHOTON_PATH * 3, turn_counts
        assert turn_counts["histogram_add"] == PHOTON_PATH * 3 and turn_counts["philox_uniform"] > 0, turn_counts
        assert turn_counts["target_in_table"] == turn_counts["anyhit_in_table"] == 0, turn_counts  # no guide
        photon_turns.append(dict(kind=kind, seconds_per_batch=turn_seconds, launches=turn_counts,
                                 peak_bytes=torch.cuda.max_memory_allocated()))
    photon_prof = {
        "run": profile_step(lambda: photon_tracer.run()),
        "compacted": profile_step(lambda: photon_tracer.run_compacted(min_lanes=PHOTON_MIN_LANES)),
    }
    print("photon path: batch {}, {} segments, s/batch in turns: {}".format(BATCH, PHOTON_PATH, "; ".join(
        f"{t['kind']} {statistics.median(t['seconds_per_batch']):.4f} s {[round(x, 4) for x in t['seconds_per_batch']]}"
        f" (peak {t['peak_bytes'] / 2**20:.1f} MiB)" for t in photon_turns
    )))
    photon_launches = {k: v // 3 for k, v in photon_turns[0]["launches"].items() if v}
    print(f"photon path: launches per batch {photon_launches}; profiled: " + "; ".join(
        f"{kind} device busy {p['device_busy_ms']:.2f} ms, {p['kernels']} kernels and copies"
        for kind, p in photon_prof.items()
    ))
    del photon_tracer
    torch.cuda.empty_cache()

    phase("3h")
    # phase 3h: the volume flagship's gradient steps at full width: example 05's loss in the absorption
    # scale, example 06's with a kernel histogram (100 bins of 5 ns, bandwidth 5 ns) in the group velocity's
    kde = lambda: KernelHistogramHitResponse(nBins=100, t0=0.0, binSize=5.0, bandwidth=5.0)
    volume_steps = {}
    for label, build, table, truth in (
        ("absorption (example 05)", lambda: build_volume_flagship(theia_tpu_torch, BATCH, "cuda"),
         "absorption_coef", float(np.log(1.35))),
        ("group velocity, kernel histogram (example 06)",
         lambda: build_volume_flagship(theia_tpu_torch, BATCH, "cuda", response=kde()),
         "group_velocity", float(np.log(0.92))),
    ):
        torch.cuda.empty_cache()
        volume_steps[label] = time_step(scale_step(build(), table, truth), grad_wrappers,
                                        f"volume gradient step, {label}: batch {BATCH}, 10 scatterings")
    vol_abs, vol_vg = volume_steps.values()
    assert vol_abs["launches"].get("read_table_grad", 0) > 0 and "kernel_histogram_add" not in vol_abs["launches"]
    assert vol_vg["launches"]["kernel_histogram_add"] == VOLUME_RECORDS, vol_vg["launches"]
    assert vol_vg["launches"]["kernel_histogram_grad"] == VOLUME_RECORDS, vol_vg["launches"]
    for name in ("read_table", "read_table_grad"):
        kernels[name].update(launches=vol_abs["launches"][name], launches_per_step=vol_abs["launches"][name],
                             path="volume flagship gradient in the absorption scale, 1 step")
    for name in ("kernel_histogram_add", "kernel_histogram_grad"):
        kernels[name].update(launches=vol_vg["launches"][name], launches_per_step=vol_vg["launches"][name],
                             path="volume flagship gradient in the group velocity, kernel histogram, 1 step")
    torch.cuda.empty_cache()

    phase("3i")
    # phase 3i: the brute-force flagship's geometry gradient at full width, with a kernel histogram
    # (100 bins of 5 ns, bandwidth 5 ns): the detector through translate_instance, the source's position,
    # and the packed log_phase_function and refractive_index tables
    geo_tracer = build_flagship(theia_tpu_torch, mesh, BATCH, MAX_PATH, accel="auto", device="cuda", response=kde())
    assert geo_tracer.scene.accel == "brute"
    geo = time_step(geometry_step(geo_tracer), grad_wrappers,
                    f"brute geometry gradient step: batch {BATCH}, path length {MAX_PATH}")
    assert geo["launches"]["kernel_histogram_grad"] == 19 and geo["launches"]["read_packed_grad"] > 0, geo["launches"]
    # the hit reconstruction's rows of tri_data and inst_data, forward and backward, at each of the 19
    # queries, leave no sorting index backward of rows (indexing_backward_kernel_small_stride)
    assert geo["launches"]["gather_rows"] == geo["launches"]["gather_rows_grad"] == 2 * 19, geo["launches"]
    assert not [e for e in geo["profile"]["watched"]["indexing_backward"] if "small_stride" in e["name"]], geo
    for name in ("read_packed_grad", "gather_rows", "gather_rows_grad"):
        kernels[name].update(launches=geo["launches"][name], launches_per_step=geo["launches"][name],
                             path="brute geometry gradient, 1 step")
    del geo_tracer
    torch.cuda.empty_cache()

    phase("4")
    # phase 4: the port on the CPU against the port on the card
    cpu_vs_card = {}
    flagship = lambda **kw: lambda dev: build_flagship(theia_tpu_torch, mesh, SMALL_BATCH, MAX_PATH, device=dev, **kw)
    for label, build in (
        ("mt", flagship()),
        ("brute", flagship(accel="auto")),
        ("woop polarized off centre", flagship(accel="woop", polarized=True, source_position=OFF_CENTRE)),
        ("volume", lambda dev: build_volume_flagship(theia_tpu_torch, SMALL_BATCH, dev)),
        ("volume polarized", lambda dev: build_volume_flagship(theia_tpu_torch, SMALL_BATCH, dev, polarized=True)),
        ("volume photon", lambda dev: build_volume_photon(theia_tpu_torch, SMALL_BATCH, dev)),
        ("scene photon", lambda dev: build_photon_flagship(theia_tpu_torch, mesh, SMALL_BATCH, dev)),
        ("unguided, StoreTimeHitResponse", flagship(accel="auto", guided=False, response=StoreTimeHitResponse())),
    ):
        dims, results = {}, {}
        for dev in ("cpu", "cuda"):
            small = build(dev)
            small._debug_rng = True
            p = small.params()
            with torch.no_grad():
                state, _, dim = small._trace_batch(p, small.rng.counter_words, small.streams())
            results[dev] = small.response.result(p["response"], state)
            dims[dev] = dim.cpu()
        same = float((dims["cpu"] == dims["cuda"]).double().mean())
        if isinstance(results["cpu"], dict):  # the stored detections
            kept = {dev: r["time"][r["valid"]].cpu().sort().values for dev, r in results.items()}
            n_kept = int(kept["cpu"].shape[0])
            assert n_kept == kept["cuda"].shape[0] > 0, f"cpu and card accept other counts ({label})"
            t_rel = float(((kept["cuda"] - kept["cpu"]).abs() / kept["cpu"].abs()).max())
            print(f"cpu vs card ({label}) at batch {SMALL_BATCH}: rng dims equal {same:.6f}, {n_kept} detections "
                  f"on both, sorted times within {t_rel:.3g} relative")
            assert same >= 0.995 and t_rel <= 1e-5, f"cpu and card disagree ({label})"
            cpu_vs_card[label] = dict(dims_equal=same, detections=n_kept, time_rel=t_rel)
            continue
        hists = {dev: r.double().cpu() for dev, r in results.items()}
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
    # the gradient path's steps, small, of their time-weighted signals (see time_weighted): the volume
    # flagship's two (3 scatterings) and the geometry step
    small_volume = lambda **kw: lambda dev: build_volume_flagship(
        theia_tpu_torch, GRAD_BATCH, dev, nScattering=GRAD_PATH, **kw)
    for label, build, make in (
        ("volume, absorption", small_volume(), lambda t: scale_step(t, "absorption_coef", None)),
        ("volume, group velocity, kernel histogram", small_volume(response=kde()),
         lambda t: scale_step(t, "group_velocity", None)),
        ("brute geometry", lambda dev: build_flagship(theia_tpu_torch, mesh, GRAD_BATCH, GRAD_PATH, accel="auto",
                                                      device=dev, response=kde()),
         lambda t: geometry_step(t, fit=False)),
    ):
        grads = {dev: make(build(dev))()[1] for dev in ("cpu", "cuda")}
        cpu_vs_card[f"gradient, {label}"] = gradient_agreement(label, grads["cpu"], grads["cuda"])

    phase("end")
    for info in kernels.values():
        assert info["launches"] > 0, info
        info.update(card_ms=info["ms"], share_of_bound=info["bound_ms"] / info["ms"])
    line = {"kernels": [dict(name=name, **info) for name, info in kernels.items()]}
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, build_seconds=lib.build_seconds, sqrt=sqrt_check,
        mt_path=dict(seconds_per_batch=seconds, bounces_per_s=BATCH * MAX_PATH / med,
                     peak_bytes=peak, histogram_sums=sums, launches=counts, row_source_turns=turns),
        brute_path=dict(seconds_per_batch=brute_seconds, bounces_per_s=BATCH * MAX_PATH / brute_med,
                        peak_bytes=brute_peak, histogram_sums=brute_sums, launches=brute_counts,
                        row_source_turns=brute_turns),
        backends_in_turns=backend_turns,
        read_sites=dict(mt=mt_sites, woop_polarized=pol_sites, brute=brute_sites, volume=vol_sites),
        woop_polarized_path=dict(seconds_per_batch=pol_seconds, bounces_per_s=BATCH * MAX_PATH / pol_med,
                                 peak_bytes=pol_peak, histogram_sums=pol_sums, launches=pol_counts),
        volume_path=dict(seconds_per_batch=vol_seconds, bounces_per_s=BATCH * 10 / vol_med, peak_bytes=vol_peak,
                         histogram_sums=vol_sums, launches=vol_counts, profile=vol_prof),
        photon_path=dict(compacted_vs_run_rel=photon_rel, lanes_after_each_run=photon_lanes, turns=photon_turns,
                         profile=photon_prof),
        gradient=dict(batch=grad_batch, seconds=grad_seconds, peak_bytes=grad_peak, loss=loss,
                      grad_sum=float(grad.sum()), grad=grad.tolist(), histogram_grad_launches=grad_launches,
                      launches=grad_counts, profile=grad_prof),
        volume_gradient_steps=volume_steps, geometry_gradient_step=geo,
        cpu_vs_card=cpu_vs_card, phase_seconds={k: clock[n] - clock[k] for k, n in zip(clock, list(clock)[1:])},
        **line,
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
