#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``theia_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi), then the kernels' build
   from ``theia_tpu_torch/csrc`` with nvcc (one process per source, run
   together) and its seconds, and the SASS of the kernel histogram's
   record, the Sobol draw, the gamma draw and the track's backward sample
   (``sass_report``: cuobjdump's opcodes, the atomics apart);
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
   sixteenth of the lanes of N = 262,144) on adversarial rays (through vertices, along edges, in
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
   launch, the record also on 1 lane in 1000 kept), and the recorded
   calls of one step of flagship-volume-grad (21) and of
   flagship-brute-geom-grad (19) (``kde_path_calls``), each held under
   ``hold_kde``'s tolerances with its kept share, distinct base bins and
   top-ten share printed (``kde_call_stats``), then replayed as called
   and queued: the mean a call is the record's row, the 524,288-lane case
   beside it as ``synthetic`` (``time_kde_path``); the table reads and their backward
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
   for the gathers); the four walk entry points (the instanced walk's
   nearest and any hit, ``csrc/instanced_walk.cu``, and the threaded
   BVH's, ``csrc/bvh_walk.cu``) on random rays at N = 262,144 (the plain
   walk on the card on every lane and on the CPU on a seeded eighth), on
   adversarial rays (``walk_adversarial``: grazing, along edges and in
   triangle planes, lying in box faces, dead lanes, t_max inf, 0, -1 and
   NaN) and on the queries of one recorded batch of flagship-array (8)
   and flagship-bvh (19; the any-hit on the same rays bounded at half
   their nearest hit), each timed as called and queued beside the plain
   walk and a bound from the plain walk's counts of box, sphere and
   triangle tests and transforms (``Walk.bound``); and the Owen-scrambled
   Sobol draw (``csrc/sobol.cu``, ``check_sobol``) bit for bit on 2^20
   lanes x 2 draws with the flagship's generator (128 dims, the path's 74)
   and example 11's (64 dims, 160 drawn: the Philox tail) and on the edge
   indices, dims, seeds, tables and a wrapping offset, timed as called and
   queued beside its plain version and a bound from its integer
   operations (the fold by byte's; the bit fold's beside it as
   ``yardstick_ms``);
3. the first main path at full width: the flagship scene tracer
   (262,144 lanes, path length 10, 3840 triangles, 100 bins,
   ``accel="mt"``) through ``run()`` on the staged route, one warm-up
   batch and three timed ones, with the kernels' launch counts (19
   row-less queries, 10 + 9 segment kernels and 19 records a batch); then
   on the eager route (``trace_fn()``'s forward), one batch with each
   table-read site counted (``read_sites``: one launch a read, at most two
   a medium's constants) and seconds per batch with the winners' rows from
   the kernel and from a separate gather, in turns;
3b. the second main path at full width: the polarized flagship on the
   Woop query (``accel="woop", polarized=True``), the same way, its read
   sites counted too;
3c. its gradient at full width: one ``trace_fn()`` forward and backward
   of sum(histogram state) with respect to the water absorption table,
   then one step under the profiler (device busy, the table reads'
   launches a step, forward and backward, no
   ``indexing_backward_kernel_small_stride``);
3d. the third main path at full width: the brute-force flagship, the
   scene with no ``accel`` named (``"auto"`` resolves to ``"brute"``), on
   the staged route, with its launches a batch (10 primary nearest hits
   without rows, 9 shadow pairs, each one ``target_in_table`` launch, no
   separate any-hit, none of the other nearest-hit kernels, the segment
   kernels); then on the eager route its read sites counted (nothing
   stacked for the constants' read) and seconds per batch with the
   winners' rows from the kernel and from a separate gather, in turns; then
   the ``mt``, unpolarized ``woop``, brute-force and ``bvh`` flagships in
   turns, each on its default route, for seconds per batch that can be
   compared;
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
3j. flagship-array (``examples/08_detector_array.py``: 26 BK7-shelled
   modules of 1280 triangles, ``accel="auto"`` -> ``"instanced"``, a
   ``HitRecorder``, path length 8) and flagship-bvh (the flagship scene
   with ``accel="bvh"``, leaf size 8) at 262,144 lanes: seconds per batch
   (median of 3), launches a batch (8 instanced walks; 19 BVH walks, the
   shadow rays on the full walk), peak memory, one batch profiled, then
   ``is_visible`` on each scene (three any-hit walks); then the crossover
   sweep (``sweep``): 65,536 random rays through 1, 8, 26 and 124
   modules on the brute-force soup, the instanced walk and the BVH;
3k. (``sobol_and_camera_runs``) flagship-brute-sobol (the brute-force
   flagship with ``_build_scene_tracer(rng="sobol")``'s ``SobolQRNG(seed=42,
   dims=128)``: 50 Sobol launches a batch in Philox's place; one batch's
   Sobol calls recorded, with flagship-volume-sobol's 42, held bit for bit
   and replayed, ``time_sobol_path``, whose mean a call is the kernel's
   row), then flagship-brute profiled in
   the same call and in turns with it; flagship-volume-sobol (the volume flagship
   with example 11's ``SobolQRNG(seed=1, dims=64)``, the lanes' last dim
   reported); volume-backward (``VolumeBackwardTracer`` of
   ``test_backward_energy_conservation``, 30 scatterings, a
   ``HitRecorder``: the energy estimate of 4 batches within 5 % of the
   budget) and direct (``DirectLightTracer`` of
   ``test_direct_tracer_analytic``: 4 batches within 5 % of the closed
   form, the peak within a bin of the arrival time), each at 262,144
   lanes: seconds a batch (median of 3 after a warm-up), launches a
   batch, peak memory, one profiled batch;
3l. (``scene_camera_runs``) the scene camera tracers at 262,144 lanes, in
   the same measures: scene-backward-target (``SceneBackwardTargetTracer``
   in ``tests/test_scene_backward.py``'s emissive sphere: more than 99 %
   of the lanes recorded, 4 pi within rtol 1e-5, times between the
   icosphere's nearest face and 10.01 m over c), scene-backward-target-grad
   (one gradient step of sum(histogram) in the glass's index,
   ``tests/test_grad_scene.py:199``: the gradient > 0), scene-backward
   (``SceneBackwardTracer``, path length 12: the total of 4 batches within
   5 % of a ``VolumeBackwardTracer`` of 12 scatterings in the same call)
   and bidirectional (``BidirectionalPathTracer``, L = C = 12: the total
   of 4 batches within 10 % of the budget less the direct and the
   single-scatter light, a ``VolumeBackwardTracer`` of 2 scatterings in
   the same call; one any-hit and one record a camera vertex; one camera
   vertex's connection step profiled alone), then one polarized
   bidirectional batch against the unpolarized one;
3m. (``cherenkov_runs``) Cherenkov light at 262,144 lanes, in the same
   measures: cherenkov-muon and cherenkov-cascade (flagship-volume's tracer
   with ``tests/test_muon_backward.py``'s 1 TeV muon, or the 1 TeV EM
   cascade of ``createParamsFromParticle``, onto its detector sphere:
   one ``sample_gamma`` a cascade batch), cascade-backward and
   track-backward (``tests/test_trace_backward.py``'s volume backward
   tracer with the cascade, 3 ``sample_gamma`` a batch, and with the
   track's 3 vertices and the same line in 256 segments, 3
   ``track_backward_sample`` a batch: their light curves within 5 % of
   each other and of the simple source's on the line, the peaks within a
   bin), flagship-brute-disk-guide (the brute-force flagship with a
   ``DiskTargetGuide``); then kernels K1 (``csrc/gamma.cu``) and K2
   (``csrc/cherenkov_track.cu``) bit for bit against their plain versions
   on the runs' recorded calls and on synthetic 2^20-lane calls (K1 with
   both generators and the edge lanes alpha 0 and -1, R = 64; K2 on 2 and
   256 segments, and its gradient), timed as called and queued a call,
   with their bounds and, for K1, ``torch._standard_gamma`` as a yardstick;
3n. (``single_card_runs``) the last single-card modules at 262,144 lanes,
   each with the card's name and power limit beside its numbers:
   pipeline-example03 (example 03's flash and beam, 8 scatterings, 4
   batches each under ``PipelineScheduler`` synchronous and on its
   dispatch thread and as a bare ``run()`` loop: the same histogram
   records bit for bit in every mode (``RecordDigests``, int64 digests of
   each record's inputs made on the card), light curves within 1e-5 of
   their largest bin, which is as far as the record's float atomics let
   two runs of one batch agree; seconds a batch in turns, the host syncs
   of a launch and of a wait, launches, one profiled schedule),
   converge-brute (``ConvergeHistogramTask`` on the brute-force flagship,
   its batches and error; then 2 + 2 batches across a checkpoint resumed
   by a fresh pipeline: the resumed records bit for bit), ocean-ff-volume
   (flagship-volume with ``FournierForandPhaseFunction(1.175, 4.065)``)
   and kokhanovsky-backward-pol (the polarized backward tracer on ocean
   water with the Kokhanovsky phase matrix), each held against the CPU
   port at batch 4096, flagship-brute-from-stl (the flagship's meshes
   from a binary STL that the run writes: arrays, pack tables, one
   batch's ``HitRecorder`` hits and histogram records bit for bit against
   the scene built in memory from the written corners; ASCII STL, PLY and
   OBJ of the same mesh), array-from-obj (example 08's 26 modules from an
   OBJ through ``SceneTemplate.fromFile``: detector ids, tables and one
   batch bit for bit against the array stamped in memory, on the
   instanced walk) and render-flagship (``SceneRender`` at 1024 x 1024 of
   the flagship scene, ms a render; the card's image at 128 x 128 against
   the CPU port's);
3o. (``last_slice_runs``) the multi-device layer, profiling and the
   wavefront sort, each with the card's name and power limit: (a)
   flagship-brute at 262,144 lanes through ``Pipeline(tracer,
   runner=ShardedRunner(tracer))`` over an NCCL process group of one, 4
   batches a schedule under ``PipelineScheduler`` synchronous and threaded
   in turns with ``Pipeline(tracer)``: the records bit for bit, the curves
   within 1e-5 of the largest bin, seconds a batch in each mode, the
   all-reduce's ms; (b) two gloo ranks sharing the card
   (``torch.multiprocessing`` spawn), 131,072 lanes each: each rank's RNG
   dims equal to the single run's slice, the summed curve within 1e-5 of
   its largest bin, a sharded gradient step at batch 2048 against the
   single one; (c) ``profiling.profile_batch`` on flagship-brute: the
   trace and its statistics beside phase 3d's median; (d) the sort's path,
   flagship-array (33,280 triangles) with ``accel="mt"`` and ``"woop"``,
   built with ``binned=True`` (the port does not sort by default), one
   batch each (8 ``sort_rays`` and 8 ``scatter_back`` launches a batch),
   the sort and its scatter back (``csrc/wavefront_sort.cu``) bit for bit
   against their plain twins on synthetic rays (NaN and infinite origins)
   and on the batch's recorded queries, binned winners bit-equal to
   unbinned, each kernel's time as called and queued beside
   ``torch.argsort(stable=True)`` with gathers / ``index_copy_`` and the
   bound, the binned query against the unbinned one in turns;
3p. (``segment_runs``) the flagship's segment as four kernels
   (``trace/segment.py``, ``csrc/segment.cu``: K_pre, K_surface,
   K_scatter, K_shadow) on flagship-brute and flagship-mt at 262,144
   lanes, path length 10: every call of the four kernels in one staged
   batch against its plain twin on the card, bit for bit (a NaN equal to
   a NaN), and 65,536 edge lanes (total internal reflection, grazing
   incidence, media mismatch, out of the propagation box, past
   ``maxTime``, dead, NaN and infinite lanes, misses; each case counted);
   the staged route's light curve, every lane's final RNG dim and each
   segment's end state equal to the eager route's bit for bit; seconds a
   batch of the two routes in turns (eager, stages, stages, eager) with
   the launches of the timed batches, peak memory, one profiled batch of
   each route (busy ms and kernels; at most ``SEGMENT_LAUNCH_LIMIT`` a
   staged flagship-brute batch); each kernel's ms as called and queued on
   the batch's middle call and its calls queued, its twin's ms, its bound
   (``segment_bound``: the bytes each kernel reads and stores). Phases 3,
   3d, 3n, 3o and 4 drive flagship-mt and flagship-brute on their default
   route, the staged one; phase 2 records the eager segment's calls
   (``torch_flagship.eager_route``) to replay them, and phases 3 and 3d
   also time the eager route (the autograd path's forward), labelled so;
4. the port on the CPU against the port on the card at batch 4096: the
   unpolarized ``mt`` flagship and the brute-force flagship (both on the
   staged route: the twins on the CPU, the kernels on the card), the polarized
   ``woop`` flagship with the source off centre, the volume flagship
   unpolarized and polarized, a volume photon tracer, the photon
   flagship, the unguided brute-force flagship with a
   ``StoreTimeHitResponse`` and flagship-array's ``HitRecorder`` (the same
   detections, times within 1e-5), flagship-bvh, the four runs of 3k
   (the volume backward run's ``HitRecorder`` as flagship-array's) and
   those of 3l (scene-backward on ``accel="auto"`` and ``"mt"``) and of
   3m (the simple source's run aside) and flagship-array with
   ``accel="mt"`` and ``"woop"`` (binned);
   then the gradients at batch 2048, path length 3: the polarized
   medium gradient, the volume steps of 3h, the geometry step of 3i and
   3l's index step, each by ``PERF.md``'s gradient agreement.

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
#: the volume backward run's batches for its energy check (4 x 262,144 =
#: test_backward_energy_conservation's 1,048,576 samples) and the direct
#: run's for its closed form: timed_runs' warm-up and its three timed runs
CAMERA_RUN_BATCHES = 4
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
#: int32 operations that sobol_owen_uniform needs, counted at the least
#: form of each step, with a three-input logic op as one and the 32-bit
#: products (which go to the multiply-add pipe beside the integer pipe,
#: as Philox's do) left out, since the integer pipe's count is the
#: larger. A lane: the index + offset 1, its nested scramble 7 (two bit
#: reversals, the seed's add, four xors); a draw after its first, dim + j
#: 1. A draw in the table: the tail test 1, the table's address 2, the XOR
#: fold 10, the Owen scramble 7 (as the index's), the conversion to float
#: 1. The fold's least form takes the index a byte at a time, as
#: csrc/sobol.cu does from random._byte_table: four byte extracts, four
#: lookups' addresses and two three-input xors. The scramble's seed
#: hash32(dim ^ hash32(seed)) depends on the dimension alone, so it is
#: made once a call for each dimension drawn (7 operations, 4 bytes read
#: beside the row) and costs a draw nothing. A draw past the table: the
#: tail test 1 and the Philox draw's own 61 (its key set up again,
#: csrc/philox.cuh).
SOBOL_LANE_OPS, SOBOL_TABLE_OPS, SOBOL_TAIL_OPS = 1 + 7, 1 + 2 + 10 + 7 + 1, 1 + 61
SOBOL_DIM_OPS = 7
#: a draw in the table with the fold's least form over the rows a bit at a
#: time (four R2P moves put bits 0-6 of each byte into predicates, four
#: tests set bits 7, 15, 23 and 31, 32 predicated xors apply them: 40), the
#: count of the bounds before the byte tables; kept beside as ``yardstick``
SOBOL_ROW_TABLE_OPS = 1 + 2 + 40 + 7 + 1
#: the flagship's generator (``_build_scene_tracer(rng="sobol")``) and
#: example 11's (``examples/11_quasirandom_sampling.py``)
FLAGSHIP_SOBOL = dict(seed=42, dims=128)
EXAMPLE_11_SOBOL = dict(seed=1, dims=64)


def sobol(gen: dict):
    """The ``rng`` argument of the flagship builders for a SobolQRNG."""
    return lambda rnd: rnd.SobolQRNG(**gen)

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
    # blocks of one stream. The library call is a yardstick: torch.rand
    # draws the same count of uniforms with its own Philox, other words.
    b = bound(16 * n, PHILOX_PAIR_OPS * n, PEAK_I32)
    library = lambda: torch.rand(n, 2, device="cuda")
    library_ms, library_queued_ms = cuda_ms(library, 50), cuda_ms_queued(library, 50)
    print(f"kernel philox N={n}: bit-exact (width 1 and 2); kernel {ms:.4f} ms ({queued_ms:.4f} queued), "
          f"plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
          f"({PHILOX_PAIR_OPS} int32 operations a lane at {PEAK_I32:.4g}/s), share of bound "
          f"{b['bound_ms'] / ms:.3f} ({b['bound_ms'] / queued_ms:.3f} queued); torch.rand of {n} x 2 (yardstick: "
          f"other words) {library_ms:.4f} ms ({library_queued_ms:.4f} queued)")
    report.update(max_abs_err=0.0, ms=ms, queued_ms=queued_ms, plain_ms=plain_ms, library_ms=library_ms,
                  library_queued_ms=library_queued_ms, library="torch.rand of the same 2^20 x 2 uniforms, a "
                  "yardstick: torch's Philox draws other words", **b)


def sobol_bound(table_dims: int, dim, width: int, table_ops: int = SOBOL_TABLE_OPS) -> dict:
    """The bound of one ``sobol_owen_uniform`` call: each lane's stream and
    dim read and its ``width`` floats written, the table's rows and seeds
    of the dimensions drawn once; the integer operations of this call's
    draws, in the table (``table_ops`` a draw) or past it, and of its
    dimensions' seeds."""
    import torch

    draws = torch.stack([dim.to(torch.int64) + j for j in range(width)])
    tail = int((draws >= table_dims).sum())
    rows = int(torch.unique(draws[draws < table_dims]).numel())
    n = dim.shape[0]
    ops = n * (SOBOL_LANE_OPS + width - 1) + (n * width - tail) * table_ops + tail * SOBOL_TAIL_OPS + rows * SOBOL_DIM_OPS
    return bound((8 + 4 * width) * n + (128 + 4) * rows, ops, PEAK_I32)


def sobol_bounds(table_dims: int, dim, width: int) -> dict:
    """``sobol_bound`` at the byte fold's count, with the bound at the bit
    fold's count (``SOBOL_ROW_TABLE_OPS``) beside it as ``yardstick_ms``."""
    b = sobol_bound(table_dims, dim, width)
    return dict(b, yardstick_ms=sobol_bound(table_dims, dim, width, SOBOL_ROW_TABLE_OPS)["bound_ms"])


def check_sobol(report):
    """``sobol_owen_uniform`` against its plain version, bit for bit: 2^20
    lanes x 2 draws at the flagship's generator (128 dims) over the
    path's 74 dims, and example 11's (64 dims) over 160 dims, so that
    the Philox tail runs too; then the edge values (indices 0, 2^31 - 1,
    2^31, 2^32 - 1, dims 0, dims - 1, dims, dims + 50, seeds 0,
    0x80000000, 0xFFFFFFFF, tables of 1, 64 and 128 dims, an offset that
    wraps). The flagship's case is timed as called and queued beside its
    plain version and its bound. No library call: torch's SobolEngine
    scrambles its own way and draws other points."""
    import numpy as np
    import torch

    from theia_tpu_torch.random import _direction_table, sobol_owen_uniform, sobol_owen_uniform_plain

    n = 1 << 20
    rng = np.random.default_rng(3)
    stream = torch.arange(n, dtype=torch.int32, device="cuda")
    same = lambda got, want: torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    for gen, top in ((FLAGSHIP_SOBOL, 74), (EXAMPLE_11_SOBOL, 160)):
        table = _direction_table(gen["dims"], "cuda")
        dim = torch.as_tensor(rng.integers(0, top, size=n).astype(np.int32), device="cuda")
        for width in (1, 2):
            got = sobol_owen_uniform(table, gen["seed"], stream, dim, width, offset=n)
            torch.cuda.synchronize()
            want = sobol_owen_uniform_plain(table.cpu(), gen["seed"], stream.cpu(), dim.cpu(), width, offset=n)
            assert same(got, want), f"sobol {gen} width {width} differs"
    edges = torch.tensor([0, 2**31 - 1, -(2**31), -1], dtype=torch.int32, device="cuda")
    for dims in (1, 64, 128):
        table = _direction_table(dims, "cuda")
        dim = torch.tensor([0, dims - 1, dims, dims + 50], dtype=torch.int32, device="cuda")
        s, d = edges.repeat_interleave(4), dim.repeat(4)
        for seed in (0, 0x80000000, 0xFFFFFFFF):
            for offset in (0, 2**32 - 2):
                got = sobol_owen_uniform(table, seed, s, d, 2, offset)
                want = sobol_owen_uniform_plain(table.cpu(), seed, s.cpu(), d.cpu(), 2, offset)
                assert same(got, want), f"sobol edge case dims {dims} seed {seed:#x} offset {offset} differs"
    table = _direction_table(FLAGSHIP_SOBOL["dims"], "cuda")
    dim = torch.as_tensor(rng.integers(0, 74, size=n).astype(np.int32), device="cuda")
    draw = lambda: sobol_owen_uniform(table, FLAGSHIP_SOBOL["seed"], stream, dim, 2, n)
    ms, queued_ms = cuda_ms(draw, 50), cuda_ms_queued(draw, 50)
    plain_ms = cuda_ms(lambda: sobol_owen_uniform_plain(table, FLAGSHIP_SOBOL["seed"], stream, dim, 2, n), 5)
    b = sobol_bounds(FLAGSHIP_SOBOL["dims"], dim, 2)
    print(f"kernel sobol_owen_uniform N={n}: bit-exact (width 1 and 2; 128 dims over 74, 64 dims over 160 with "
          f"the Philox tail; 48 edge cases x 6); kernel {ms:.4f} ms ({queued_ms:.4f} queued), plain {plain_ms:.4f} ms; "
          f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({SOBOL_LANE_OPS + 1} + 2 x {SOBOL_TABLE_OPS} int32 "
          f"operations a lane at {PEAK_I32:.4g}/s; {b['yardstick_ms']:.4f} ms at the bit fold's {SOBOL_ROW_TABLE_OPS} a "
          f"draw), share of bound {b['bound_ms'] / ms:.3f} ({b['bound_ms'] / queued_ms:.3f} queued), library call: none")
    report.update(max_abs_err=0.0, ms=ms, queued_ms=queued_ms, plain_ms=plain_ms, library_ms=None, **b)


def record_sobol_calls(tracer):
    """(table, seed, stream, dim, width, offset) of every
    ``sobol_owen_uniform`` call of one batch of ``tracer``."""
    from theia_tpu_torch import random

    def draw(dirs, seed, stream, dim, width=1, offset=0):
        return dirs, seed, stream.clone(), dim.clone(), width, offset

    return record_calls(tracer, random, ("sobol_owen_uniform",), draw)


def sobol_call_stats(calls, table_dims: int) -> dict:
    """What one path's ``sobol_owen_uniform`` calls turn on: their count,
    lanes and widths, the most distinct dims a call draws, and the share
    of draws past the direction table (the Philox tail)."""
    import torch

    draws = [torch.stack([c[3].to(torch.int64) + j for j in range(c[4])]) for c in calls]
    total = sum(d.numel() for d in draws)
    return dict(calls=len(calls), lanes=sorted({int(c[2].shape[0]) for c in calls}),
                width_2=sum(c[4] == 2 for c in calls), max_distinct_dims=max(int(torch.unique(d).numel()) for d in draws),
                share_past_table=sum(int((d >= table_dims).sum()) for d in draws) / max(total, 1))


def time_sobol_path(report, paths: dict) -> None:
    """``sobol_owen_uniform`` on the paths' own inputs: each path's calls
    (``record_sobol_calls`` of one batch: flagship-brute-sobol's 50,
    flagship-volume-sobol's 42) held bit for bit against the plain version
    and replayed, as called and queued; the mean a call over both paths,
    with the calls' mean bound, becomes the kernel's row, each path's
    beside it under ``paths``, and the 2^20-lane case of
    :func:`check_sobol` as ``synthetic``."""
    import torch

    from theia_tpu_torch.random import sobol_owen_uniform, sobol_owen_uniform_plain

    rows, every = {}, []
    for label, calls in paths.items():
        for dirs, seed, stream, dim, width, offset in calls:
            got = sobol_owen_uniform(dirs, seed, stream, dim, width, offset)
            torch.cuda.synchronize()
            want = sobol_owen_uniform_plain(dirs.cpu(), seed, stream.cpu(), dim.cpu(), width, offset)
            assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)), f"sobol on {label}'s inputs differs"

        def replay(fn=sobol_owen_uniform):
            for c in calls:
                fn(*c)

        n = len(calls)
        bounds = [sobol_bounds(c[0].shape[0], c[3], c[4]) for c in calls]
        kinds = [x["bound_by"] for x in bounds]
        row = dict(ms=cuda_ms(replay, 10) / n, queued_ms=cuda_ms_queued(replay, max(1, 400 // n)) / n,
                   plain_ms=cuda_ms(lambda: replay(sobol_owen_uniform_plain), 1) / n,
                   bound_ms=sum(x["bound_ms"] for x in bounds) / n, bound_by=max(set(kinds), key=kinds.count),
                   yardstick_ms=sum(x["yardstick_ms"] for x in bounds) / n,
                   **sobol_call_stats(calls, calls[0][0].shape[0]))
        rows[label] = row
        every += bounds
        print(f"kernel sobol_owen_uniform on {label}'s inputs: {n} calls of a batch ({row['lanes']} lanes, "
              f"{row['width_2']} of width 2, at most {row['max_distinct_dims']} distinct dims a call, "
              f"{row['share_past_table']:.4f} of the draws past the table), bit-exact; {row['ms']:.4f} ms a call "
              f"({row['queued_ms']:.4f} queued), plain {row['plain_ms']:.4f} ms; bound {row['bound_ms']:.5f} ms a "
              f"call by {row['bound_by']} (yardstick {row['yardstick_ms']:.5f}), share of bound "
              f"{row['bound_ms'] / row['queued_ms']:.3f} queued")
    n = sum(r["calls"] for r in rows.values())
    mean = lambda key: sum(r[key] * r["calls"] for r in rows.values()) / n
    kinds = [x["bound_by"] for x in every]
    synthetic = {k: report[k] for k in ("ms", "queued_ms", "plain_ms", "bound_ms", "bound_by", "yardstick_ms")}
    report.update(ms=mean("ms"), queued_ms=mean("queued_ms"), plain_ms=mean("plain_ms"),
                  bound_ms=sum(x["bound_ms"] for x in every) / n, bound_by=max(set(kinds), key=kinds.count),
                  yardstick_ms=sum(x["yardstick_ms"] for x in every) / n, path_calls=n, paths=rows,
                  synthetic=dict(synthetic, lanes=1 << 20, width=2))


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
    versions on the CPU copy of the inputs, bit for bit (NaN equal to NaN):
    the record adds in the fixed order of ``response.ordered_bin_sums`` on
    either device, and a second launch on the same inputs gives the same
    bits; the backward sums nothing. Returns the record's max abs error
    (0)."""
    import numpy as np
    import torch

    from theia_tpu_torch.response import histogram_add, histogram_add_plain, histogram_grad, histogram_grad_plain

    n_state = case[5] * (case[7] or 1)
    got = histogram_add(torch.zeros(n_state, device="cuda"), *case)
    again = histogram_add(torch.zeros(n_state, device="cuda"), *case)
    torch.cuda.synchronize()
    want = histogram_add_plain(torch.zeros(n_state), *cpu(case))
    assert same_bits(got, again) == 0, f"histogram_add on {label}: two launches differ"
    assert same_bits(got.cpu(), want) == 0, f"histogram_add on {label}: {same_bits(got.cpu(), want)} bins off plain"
    grad_state = torch.as_tensor(np.random.default_rng(n_state).normal(size=n_state).astype(np.float32))
    got_grad = histogram_grad(grad_state.cuda(), *case[1:])
    torch.cuda.synchronize()
    assert torch.equal(got_grad.cpu(), histogram_grad_plain(grad_state, *cpu(case)[1:])), (
        f"histogram_grad differs from plain on {label}"
    )
    return float(torch.nan_to_num(got.cpu() - want).abs().max()) if n_state else 0.0


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
    versions, bit for bit: the shapes and alignments a caller may hand
    in, then the times at the mask-0.5 input and on a state of 64,000
    flat bins (past one range of ``RECORD_RANGE`` bins: the sparse pass)."""
    import torch

    from theia_tpu_torch.response import (
        RECORD_RANGE, _hist_bins, histogram_add, histogram_add_plain, histogram_grad, histogram_grad_plain,
    )

    n = 2 * BATCH
    main = hist_case(n, 3)
    large, hot = large_state_cases(n)
    assert large[5] * large[7] > 8 * RECORD_RANGE
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
        ("N=4099 on a state of 200 KB (the dense pass's ranges)", hist_case(4099, 16, bins=1000, n_det=50)),
        ("sparse, 1 lane in 1000 kept", hist_case(n, 11, kept=1e-3)),
        ("every lane kept", hist_case(n, 12, kept=1.0)),
        ("the large-state variant", large),
        ("the large-state variant, views at element 1", hist_case(100_001, 14, bins=1000, n_det=64, offset=1)),
        ("the large-state variant, 4 bins of 64,000 in use", hot),
        ("the large-state variant, N=1", hist_case(1, 15, bins=1000, n_det=64, kept=1.0)),
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
    worst, large_err = errors[f"N={n}, mask 0.5"], errors["the large-state variant"]
    print(f"kernels histogram_add / histogram_grad: bit for bit against the plain versions on the CPU copy, two "
          f"launches the same bits, on {len(errors)} cases (odd N, offset views, detector axis, 200 KB state, states "
          f"of 64,000 flat bins) and on all-masked, NaN and infinite records")

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
    its plain version on each, bit for bit, and launched twice; the
    backward bit for bit; then all of them replayed twice from a zero
    state (the batch's light curve, the same bits both times) and timed
    for the time a batch sees, beside the bound from the bytes these
    inputs force."""
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

    curves = []
    for _ in range(2):
        state.zero_()
        replay_add()
        curves.append(state.clone())
    torch.cuda.synchronize()
    assert same_bits(curves[0], curves[1]) == 0 and float(curves[0].sum()) > 0, f"{path}: a replay's curve moved"
    lanes = sum(case[2].shape[0] for case in records)
    for name, fn, report in (("add", replay_add, add_report), ("grad", replay_grad, grad_report)):
        # about 380 calls queued behind the spin, which the host enqueues within it
        ms, queued_ms = cuda_ms(fn, 20), cuda_ms_queued(fn, max(1, 380 // len(records)))
        b = bound(sum(f[name] for f in forced), 8 * lanes)
        print(f"kernel histogram_{name}: the {len(records)} recorded records of a {path} flagship batch ({lanes} lanes) "
              f"replayed {ms:.4f} ms a batch ({queued_ms:.4f} queued); bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
              f"share of bound {b['bound_ms'] / ms:.3f} ({b['bound_ms'] / queued_ms:.3f} queued)")
        report.setdefault("batch", {})[path] = dict(
            records=len(records), lanes=lanes, ms=ms, queued_ms=queued_ms, **b,
            **{key: [f[key] for f in forced] for key in ("kept", "unmasked", "bins_in_use", "fullest_bin")},
        )
    add_report["batch"][path].update(max_abs_err=worst, replays_bit_equal=True)
    print("    the batch replayed twice: the same bits")
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


def kde_case(n: int, seed: int, bins: int = 100, n_det=None, kept: float = 0.5, offset: int = 0, support: int = 4):
    """``hist_case``'s lanes as a kernel histogram record's arguments:
    (value, time, mask, t0, binSize, bandwidth, bins, support, object_id,
    n_det), 5 ns bins and a 5 ns bandwidth."""
    import torch

    value, time_, mask, t0, bin_size, bins, oid, n_det = hist_case(n, seed, bins, n_det, kept, offset)
    return value, time_, mask, t0, bin_size, torch.tensor(5.0, device="cuda"), bins, support, oid, n_det


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


def kde_add_bound(case) -> dict:
    """The kernel histogram record's bound on ``case``: the mask of every
    lane, time and value of the unmasked ones (ids beside them with a
    detector axis), the state read and written; KDE_PAIR_FLOP a (lane,
    bin) pair in range and 4 an unmasked lane."""
    n, bins = case[1].shape[0], case[6] * (case[9] or 1)
    unmasked, _, pairs = kde_pairs(case)
    return bound(n + (8 if case[9] is None else 12) * unmasked + 8 * bins, KDE_PAIR_FLOP * pairs + 4 * unmasked)


def kde_call_stats(case) -> dict:
    """What a kernel histogram record's work turns on: its lanes, the
    shares unmasked and kept (a lane with a bin in range), the distinct
    base bins of its kept lanes (per detector), its (lane, bin) pairs in
    range and the share of them in the call's ten most-hit bins."""
    import torch

    from theia_tpu_torch.response import _kde_terms

    value, time_, mask, t0, bin_size, bandwidth, bins, support, oid, n_det = case
    terms = _kde_terms(time_, mask, t0, bin_size, bandwidth, bins, support, oid, n_det)
    kept = torch.stack([k for k, *_ in terms]).any(0)
    counts = torch.bincount(torch.cat([f[k] for k, f, *_ in terms]), minlength=bins * (n_det or 1))
    pairs = int(counts.sum())
    base = torch.floor((time_ - t0) / bin_size)[kept].to(torch.int64)
    if n_det is not None:
        base = base + oid[kept].to(torch.int64) * (1 << 32)
    n = mask.shape[0]
    return dict(
        lanes=n, unmasked=int(mask.sum()) / max(n, 1), kept=int(kept.sum()) / max(n, 1),
        distinct_bases=int(torch.unique(base).numel()), pairs=pairs,
        top10_share=float(counts.topk(min(10, counts.numel())).values.sum()) / max(pairs, 1),
    )


def record_kde_calls(tracer, step):
    """The inputs of every ``kernel_histogram_add`` call of one ``step`` of
    ``tracer``, as the tuples that ``kde_case`` makes."""
    from theia_tpu_torch import response

    def inputs(state, value, time_, mask, t0, bin_size, bandwidth, n_bins, support=4, object_id=None,
               n_detectors=None):
        oid = None if object_id is None else object_id.clone()
        return (value.detach().clone(), time_.detach().clone(), mask.clone(), t0.detach(), bin_size.detach(),
                bandwidth.detach(), n_bins, support, oid, n_detectors)

    return record_calls(tracer, response, ("kernel_histogram_add",), inputs, step)


def kde_path_calls(mesh) -> dict:
    """The recorded ``kernel_histogram_add`` calls of one gradient step of
    each path that records through the kernel histogram (100 bins of 5 ns,
    bandwidth 5 ns, 262,144 lanes): flagship-volume-grad's step in the
    group velocity (example 06's loss; its other step, example 05's in the
    absorption, records through ``histogram_add``) and
    flagship-brute-geom-grad's step (example 10's loss)."""
    import numpy as np

    import theia_tpu_torch
    from theia_tpu_torch.response import KernelHistogramHitResponse
    from torch_flagship import build_flagship, build_volume_flagship

    kde = lambda: KernelHistogramHitResponse(nBins=100, t0=0.0, binSize=5.0, bandwidth=5.0)
    volume = build_volume_flagship(theia_tpu_torch, BATCH, "cuda", response=kde())
    paths = {"flagship-volume-grad": record_kde_calls(
        volume, scale_step(volume, "group_velocity", float(np.log(0.92))))}
    del volume
    geo = build_flagship(theia_tpu_torch, mesh, BATCH, MAX_PATH, accel="auto", device="cuda", response=kde())
    paths["flagship-brute-geom-grad"] = record_kde_calls(geo, geometry_step(geo))
    assert [len(c) for c in paths.values()] == [VOLUME_RECORDS, 2 * MAX_PATH - 1], {k: len(c) for k, c in paths.items()}
    return paths


def kde_library_call(case):
    """``index_add_`` of the pairs' weights on bins made beforehand from
    ``case``: (flat bins, weights), the record's library yardstick."""
    import torch

    from theia_tpu_torch.response import _kde_terms

    value, time_, mask, t0, bin_size, bandwidth, bins, support, oid, n_det = case
    terms = _kde_terms(time_, mask, t0, bin_size, bandwidth, bins, support, oid, n_det)
    norm = bin_size / (bandwidth * 2.5066282749176025)
    return (torch.cat([f[k] for k, f, *_ in terms]), torch.cat([(value * e * norm)[k] for k, _, _, _, e in terms]))


def time_kde_path(report, paths: dict) -> None:
    """``kernel_histogram_add`` on the paths' own inputs (``kde_path_calls``):
    each call held against the plain versions as ``hold_kde`` holds them
    (the record bit for bit), its ``kde_call_stats`` printed, then each
    path's calls replayed twice from a zero state (the same bits), timed
    as called and queued, beside the plain version, ``index_add_`` of the
    pairs' weights and the calls' mean bound. The mean a call over both paths becomes the kernel's row; the
    N = 524,288 case of ``check_kernel_histogram`` stays beside it as
    ``synthetic``."""
    import torch

    from theia_tpu_torch.response import kernel_histogram_add, kernel_histogram_add_plain

    worst, rows, every = 0.0, {}, []
    for label, calls in paths.items():
        stats = []
        for k, case in enumerate(calls):
            worst = max(worst, hold_kde(case, f"call {k} of {label}")["add"])
            stats.append(kde_call_stats(case))
        state = torch.zeros(calls[0][6] * (calls[0][9] or 1), device="cuda")
        library = [kde_library_call(c) for c in calls]

        def replay(fn=kernel_histogram_add):
            for c in calls:
                fn(state, *c)

        curves = []
        for _ in range(2):
            state.zero_()
            replay()
            curves.append(state.clone())
        torch.cuda.synchronize()
        assert same_bits(curves[0], curves[1]) == 0, f"{label}: a replay's curve moved"

        def replay_library():
            for flat, weights in library:
                state.index_add_(0, flat, weights)

        n = len(calls)
        bounds = [kde_add_bound(c) for c in calls]
        kinds = [b["bound_by"] for b in bounds]
        row = dict(
            calls=n, lanes=sorted({s["lanes"] for s in stats}),
            ms=cuda_ms(replay, 10) / n, queued_ms=cuda_ms_queued(replay, max(1, 400 // n)) / n,
            plain_ms=cuda_ms(lambda: replay(kernel_histogram_add_plain), 1) / n,
            library_ms=cuda_ms(replay_library, 10) / n,
            bound_ms=sum(b["bound_ms"] for b in bounds) / n, bound_by=max(set(kinds), key=kinds.count),
            stats=stats, replays_bit_equal=True,
        )
        rows[label] = row
        every += [(row, b) for b in bounds]
        print(f"kernel kernel_histogram_add on {label}'s {n} calls of a step ({row['lanes']} lanes): "
              f"{row['ms']:.4f} ms a call ({row['queued_ms']:.4f} queued), plain {row['plain_ms']:.4f} ms, index_add_ "
              f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.5f} ms a call by {row['bound_by']}, share "
              f"{row['bound_ms'] / row['queued_ms']:.3f} queued); replayed twice, the same bits")
        for key, form in (("unmasked", ".4f"), ("kept", ".4f"), ("distinct_bases", "d"), ("top10_share", ".3f")):
            print(f"    {key} of each call: " + " ".join(format(s[key], form) for s in stats))
    n = sum(r["calls"] for r in rows.values())
    mean = lambda key: sum(r[key] * r["calls"] for r in rows.values()) / n
    kinds = [b["bound_by"] for _, b in every]
    synthetic = {k: report[k] for k in ("ms", "queued_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    report.update(ms=mean("ms"), queued_ms=mean("queued_ms"), plain_ms=mean("plain_ms"), library_ms=mean("library_ms"),
                  bound_ms=sum(b["bound_ms"] for _, b in every) / n, bound_by=max(set(kinds), key=kinds.count),
                  path_calls=n, path_max_abs_err=worst, paths=rows, synthetic=dict(synthetic, lanes=2 * BATCH))
    print(f"kernel kernel_histogram_add on the paths' {n} recorded calls: {report['ms']:.4f} ms a call "
          f"({report['queued_ms']:.4f} queued), bound {report['bound_ms']:.5f} ms; max abs err {worst:.3g}")


def sass_report(lib, names) -> dict:
    """The SASS of the kernels of ``lib`` whose mangled names hold one of
    ``names`` (``cuobjdump -sass`` of the built library): each kernel's
    instruction count and its opcodes counted, with the atomics (a shared
    float add is ``ATOMS.ADD.F32`` where native, a CAS loop ``ATOMS.CAS``
    otherwise) listed apart. Empty where the toolkit has no cuobjdump."""
    import collections
    import re

    from theia_tpu_torch import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return {}
    text = subprocess.run([str(tool), "-sass", str(lib.path)], capture_output=True, text=True, timeout=600,
                          check=True).stdout
    out, name, ops = {}, None, None
    instruction = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            name, ops = (fn, collections.Counter()) if any(k in fn for k in names) else (None, None)
            if name:
                out[name] = ops
        elif ops is not None:
            m = instruction.search(line)
            if m:
                ops[m.group(1)] += 1
    return {
        fn: dict(instructions=sum(c.values()), atomics={k: v for k, v in c.items() if k.startswith(("ATOM", "RED"))},
                 opcodes=dict(c.most_common(24)))
        for fn, c in out.items()
    }


def hold_kde(case, label) -> dict:
    """The kernel histogram's record and backward on ``case`` against the
    plain versions. The record bit for bit against the plain version on the
    CPU copy of the inputs (NaN equal to NaN), and a second launch the same
    bits: both add the pairs in the records' fixed order, their weights
    through the same float32 exp. The backward bit for bit against its
    plain twin on the same card tensors (the same ops, expf as torch's exp
    on the card, the scalars' terms in the records' order), a second launch
    the same bits; and against the plain version on the CPU: d value and d
    time rtol 1e-5 of the largest lane (nine terms; the CPU's exp and the
    card's expf an ulp apart), the three scalars rtol 1e-4 (sums of those
    terms). Returns the max abs errors against the CPU."""
    import numpy as np
    import torch

    from theia_tpu_torch.response import (
        kernel_histogram_add, kernel_histogram_add_plain, kernel_histogram_grad, kernel_histogram_grad_plain,
    )

    n_state = case[6] * (case[9] or 1)
    got = kernel_histogram_add(torch.zeros(n_state, device="cuda"), *case)
    again = kernel_histogram_add(torch.zeros(n_state, device="cuda"), *case)
    torch.cuda.synchronize()
    want = kernel_histogram_add_plain(torch.zeros(n_state), *cpu(case))
    assert same_bits(got, again) == 0, f"kernel_histogram_add on {label}: two launches differ"
    assert same_bits(got.cpu(), want) == 0, (
        f"kernel_histogram_add on {label}: {same_bits(got.cpu(), want)} bins off plain"
    )
    grad_state = torch.as_tensor(np.random.default_rng(n_state).normal(size=n_state).astype(np.float32))
    got_g = kernel_histogram_grad(grad_state.cuda(), *case)
    again_g = kernel_histogram_grad(grad_state.cuda(), *case)
    twin_g = kernel_histogram_grad_plain(grad_state.cuda(), *case)
    torch.cuda.synchronize()
    want_g = kernel_histogram_grad_plain(grad_state, *cpu(case))
    err = {"add": float(torch.nan_to_num(got.cpu() - want).abs().max())}
    for name, a, a2, t, b, rtol in zip(("d value", "d time", "d t0", "d binSize", "d bandwidth"), got_g, again_g,
                                       twin_g, want_g, (1e-5, 1e-5, 1e-4, 1e-4, 1e-4)):
        assert same_tensors(a.reshape(-1), a2.reshape(-1)), f"kernel_histogram_grad {name} on {label}: two launches differ"
        assert same_tensors(a.reshape(-1), t.reshape(-1)), f"kernel_histogram_grad {name} on {label}: off its card twin"
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
        RECORD_RANGE, kernel_histogram_add, kernel_histogram_add_plain, kernel_histogram_grad,
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
        ("support 8 on 64,000 flat bins (the dense pass's ranges)",
         kde_case(100_000, 28, bins=1000, n_det=64, support=8)),
        *kde_cases(n).items(),
    ):
        if label.startswith("a state past"):
            assert case[6] * case[9] > 8 * RECORD_RANGE
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
    print(f"kernels kernel_histogram_add / kernel_histogram_grad: bit for bit (two launches the same bits), the "
          f"backward against its twin on the card bit for bit and against the CPU within rtol 1e-5 a lane / 1e-4 a "
          f"scalar, on {len(errors)} cases and on all-masked and NaN/inf records (unchanged, zero gradients); max abs "
          f"err against the CPU at N={n}: {worst}")

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
    # the record on the same cases and on a sparse one, queued
    add_report["cases"] = {}
    for label, case in (*kde_cases(n).items(), ("1 lane in 1000 kept", kde_case(n, 24, kept=1e-3))):
        state = torch.zeros(case[6] * (case[9] or 1), device="cuda")
        ms = cuda_ms_queued(lambda: kernel_histogram_add(state, *case), 50)
        b = kde_add_bound(case)
        add_report["cases"][label] = dict(queued_ms=ms, queued_share_of_bound=b["bound_ms"] / ms, **b)
        print(f"kernel kernel_histogram_add on {label} (N={n}): {ms:.4f} ms queued, bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']}, share {b['bound_ms'] / ms:.3f}")
    bins = main[6]
    unmasked, kept, pairs = kde_pairs(main)
    state = torch.zeros(bins, device="cuda")
    add = lambda: kernel_histogram_add(state, *main)
    ms, queued_ms = cuda_ms(add, 50), cuda_ms_queued(add, 50)
    plain_ms = cuda_ms(lambda: kernel_histogram_add_plain(state, *main), 10)
    # the yardstick: one index_add_ of the pairs' weights on bins made beforehand
    flat, weights = kde_library_call(main)
    library_ms = cuda_ms(lambda: state.index_add_(0, flat, weights), 50)
    b = kde_add_bound(main)
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
    share of the lanes alone, where given): d x and every d table bit for
    bit (the same float32 ops in the same order, each entry's shares
    summed in the records' fixed order by both), and a second launch the
    same bits. Returns the max abs error of d tables (0)."""
    import torch

    _, plain, _, _ = read_calls(c)
    g = tuple(torch.randn_like(w) for w in _outputs(plain()))
    if live is not None:
        g = live_grads(g, live)
    _, _, grad, grad_plain = read_calls(c, g)
    got_t, got_x = grad()
    again_t, again_x = grad()
    want_t, want_x = grad_plain()
    torch.cuda.synchronize()
    assert same_tensors(got_x, want_x) and same_tensors(got_x, again_x), f"{name} backward d x differs on {label}"
    err = 0.0
    for k, (a, a2, b) in enumerate(zip(_outputs(got_t), _outputs(again_t), _outputs(want_t))):
        if b is None:
            assert a is None and a2 is None, f"{name}: a null table got a gradient"
            continue
        assert same_tensors(a, a2), f"{name} backward d table {k}: two launches differ on {label}"
        assert same_tensors(a, b), f"{name} backward d table {k}: {same_bits(a, b)} entries off its twin on {label}"
        err = max(err, float(torch.nan_to_num(a - b).abs().max()))
    return err


def hold_table_reads(store, medium) -> dict:
    """The table reads (K2) against their plain versions on the same card
    tensors (``read_cases``): the forward bit for bit, the backward as
    ``hold_read_grad`` holds it. Also tables of 100,000 samples (the
    records' sparse pass) and of 16,384 samples, and each case with every lane at one coordinate
    (``hot_read_case``) and with upstream gradients nonzero on
    ``READ_LIVE_SHARE`` of the lanes. Returns the
    cases and, per case, the max abs error of d tables at the main shape."""
    import torch

    from theia_tpu_torch.ops import table_read as tr

    cases = read_cases(store, medium)
    main = cases["read_table"]
    big, band = sized_read_case(main, 100_000), sized_read_case(main, 16_384)
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
                  f"and d tables bit-equal to the plain twin, two launches the same bits")
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
    the lanes where ``hit`` is False) bit for bit against its plain twin
    (both sum a tile's lanes in lane order, then the tiles in the records'
    groups), a second launch the same bits; returns (the gradient as
    ``gather_rows_grad`` takes it, the spans' gradients, the largest error,
    0)."""
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
    again_t = gather_rows_grad(table.shape, index, arg, cols)
    want_t = gather_rows_grad_plain(table.shape, index, arg, cols)
    torch.cuda.synchronize()
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want)), (
        f"gather_rows differs from plain on {name}")
    assert same_tensors(got_t, again_t), f"gather_rows_grad: two launches differ on {name}"
    assert same_tensors(got_t, want_t), f"gather_rows_grad: {same_bits(got_t, want_t)} entries off its twin on {name}"
    return arg, grads, float((got_t - want_t).abs().max()) if got_t.numel() else 0.0


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
    print(f"kernel gather_rows: forward and backward bit-equal to their twins on {', '.join(odd)}")
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
        print(f"kernel gather_rows on {name}: forward and backward bit-equal to their twins, two launches the "
              f"same bits")
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
    """A seeded share (one in ``share``) of ``n`` lanes, sorted, on the
    card: where a plain version on the CPU checks a kernel's lanes."""
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    return torch.sort(torch.randperm(n, device="cuda", generator=gen)[: n // share]).values


def check_nearest(nearest: Nearest, adversarial, queries, report, memo: dict):
    """A nearest-hit kernel against its plain version, bit-equal t and idx
    (and rows): random rays at N = 262,144 and 524,288 with times and
    bound (the plain version on the card on every lane, and on the CPU on a
    seeded sixteenth of the first size's), adversarial rays, and the recorded
    queries of one flagship batch, replayed for the time and bound a batch
    sees. ``memo`` keeps the recorded queries' scan statistics by policy,
    pack and query, so a second entry point on the same tables and queries
    (the MT query with rows) does not walk them again."""
    name, worst = nearest.name, 0.0
    for n in (BATCH, 2 * BATCH):
        rays = random_rays(n, n + len(name), "cuda")
        err, hits = nearest.check(rays, f"random rays N={n} (plain on the card)", on_cpu=False)
        if n == BATCH:
            nearest.check(rays, f"random rays N={n} (plain on the CPU, a sixteenth of the lanes)", on_cpu=True,
                          lanes=seeded_lanes(n, 16, n + len(name)))
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
        key = (nearest.policy, id(nearest.pack), id(q))
        if key not in memo:
            memo[key] = nearest.stats(q), nearest.stats(q, layout=False)
        add_stats(own, memo[key][0])
        add_stats(yard, memo[key][1])

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


def check_soup(soup: Soup, adversarial, queries, report, memo: dict):
    """A soup kernel against its plain version, bit-equal: random rays at
    N = 262,144 and 524,288 with times and bound (the plain version on the
    card on every lane, and on the CPU on a seeded sixteenth of the first
    size's), lane masks, group ranges (on the card), bounds at and beside a
    hit, small and oddly cut soups (on the CPU, 8,192 rays), adversarial
    rays, and the recorded queries of one brute-force flagship
    batch, replayed for the time and bound a batch sees. Bounds count the
    work of the table's own layout; the first soup kernels' yardstick
    (``soup_stats`` without ``layout``) is kept beside. ``memo`` keeps the
    recorded queries' statistics by query kind, table and query, so the
    nearest hit with and without rows walks each query once."""
    import torch

    from theia_tpu_torch.ops.intersect_soup import SoupTable, nearest_in_table

    name, card = soup.name, soup.tables[0]
    for n in (BATCH, 2 * BATCH):
        rays = random_rays(n, n + len(name), "cuda")
        hits = soup.check(rays, f"random rays N={n} (plain on the card)", on_cpu=False)
        if n == BATCH:
            soup.check(rays, f"random rays N={n} (plain on the CPU, a sixteenth of the lanes)", on_cpu=True,
                       lanes=seeded_lanes(n, 16, n + len(name)))
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
    # the plain version runs on the CPU for the rest: a 64th of the rays
    rays = tuple(r[: BATCH // 64].contiguous() for r in rays)
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
        key = (soup.any_hit, soup.target, id(card), id(o), id(groups), id(active))
        if key not in memo:
            memo[key] = (soup.stats(card, (o, d, t_max), groups, active),
                         soup.stats(card, (o, d, t_max), groups, active, layout=False))
        add_stats(own, memo[key][0])
        add_stats(yard, memo[key][1])
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


def histogram_total(hist, label) -> float:
    """The sum of a 100-bin light curve, which must be finite and not 0."""
    import torch

    assert hist.shape == (100,) and bool(torch.isfinite(hist).all()), f"{label}: bad histogram"
    assert float(hist.sum()) > 0.0, f"{label}: empty histogram"
    return float(hist.sum())


def recorded_total(hits, label) -> float:
    """The summed contribution of a ``HitRecorder``'s valid hits, of which
    there must be some, all with finite times and contributions."""
    import torch

    valid = hits["valid"]
    assert int(valid.sum()) > 0, f"{label}: no hit recorded"
    assert bool(torch.isfinite(hits["time"][valid]).all() & torch.isfinite(hits["contrib"][valid]).all()), label
    return float(hits["contrib"][valid].sum())


def timed_runs(tracer, wrappers, label, total=histogram_total, keep_warmup: bool = False):
    """One warm-up and three timed ``run()``s of ``tracer`` with the launch
    counts of ``wrappers`` set to 0 just before the timed runs; returns
    (seconds, ``total``s of the results, the warm-up's first where
    ``keep_warmup`` asks for it, launch counts, peak bytes)."""
    import torch

    out, _ = tracer.run()  # warm-up batch
    sums = [total(out, label)] if keep_warmup else []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    seconds = []
    for _ in range(3):
        start = time.perf_counter()
        out, _ = tracer.run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        sums.append(total(out, label))
    counts = {name: w.launches for name, w in wrappers.items()}
    return seconds, sums, counts, torch.cuda.max_memory_allocated()


#: kinds of eager kernels that a profile sums: fragments of their names
#: (lower case), e.g. the zero fills, copies and adds that the backward of
#: a slice makes
KINDS = {"fills": ("fillfunctor", "memset"), "copies": ("copy_kernel", "memcpy"), "adds": ("functor_add",)}


def light_curve(hist, label):
    """A light curve on the host, which must be finite and not 0."""
    import torch

    assert bool(torch.isfinite(hist).all()) and float(hist.sum()) > 0.0, f"{label}: bad light curve"
    return hist.double().cpu()


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
    mine = ("histogram", "theia::scan", "philox", "sobol", "kde_", "read_", "::gather", "_walk", "gamma", "advance_dims",
            "segment_",
            "track_sample")
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


def absorption_grad(tracer, mesh=None):
    """d sum(histogram state) / d (water absorption_coef row) through
    ``trace_fn()``; returns (loss, gradient, state), the last two as numpy
    (the gradient float64). With a photon
    ``mesh`` this rank traces its block of the lanes through
    ``parallel.shard_trace`` (the state summed over the group) and the
    gradient is its share summed over the group (``reduce_gradients``)."""
    import torch

    fn, (p, counter, streams) = tracer.trace_fn()
    if mesh is not None:
        from theia_tpu_torch import parallel

        fn, streams = parallel.shard_trace(tracer, mesh), parallel.sharded_streams(tracer.capacity, mesh)
    media = p["scene"].media
    h = media.handle("water")
    leaf = media.tables["absorption_coef"][h].clone().requires_grad_(True)
    table = media.tables["absorption_coef"].clone()
    table[h] = leaf
    tables = {**media.tables, "absorption_coef": table}
    pp = dict(p)
    pp["scene"] = dataclasses.replace(p["scene"], media=dataclasses.replace(media, tables=tables))
    state = fn(pp, counter, streams)[0]
    loss = state.sum()
    loss.backward()
    if mesh is not None:
        parallel.reduce_gradients([leaf], mesh)
    return loss.item(), leaf.grad.double().cpu().numpy(), state.detach().cpu().numpy()


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
    that returns (loss, d loss / d s, light curve) at s = 0 through ``trace_fn()``:
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
        c = curve(s)
        if truth is None:
            loss = time_weighted(c)
        else:
            d = (c - observed) / (observed.sum() + 1.0)
            loss = (d * d).sum() * 1e6
        loss.backward()
        return loss.item(), s.grad.double().cpu().numpy().reshape(1), c.detach().cpu().numpy()

    return step


#: the geometry step's observation: the detector (instance 2 of the
#: flagship) and the source moved by these, in metres
GEOMETRY_TRUTH = ((0.05, -0.03, 0.0), (0.02, 0.0, 0.01))


def geometry_step(tracer, fit: bool = True):
    """Example 10's calibration as one gradient step on the brute-force
    flagship ``tracer`` (with a ``KernelHistogramHitResponse``): the light
    curve with the detector moved by ``translate_instance`` and the source
    moved, the observation at ``GEOMETRY_TRUTH`` made beforehand, and a
    step that returns (loss, gradient, light curve) at the nominal geometry, loss =
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
        grad = np.concatenate([leaf.grad.double().cpu().numpy().reshape(-1) for leaf in leaves])
        return loss.item(), grad, c.detach().cpu().numpy()

    return step


def time_step(step, wrappers, label, reps: int = 3) -> dict:
    """``step`` once to warm up, then ``reps`` times on the host's clock
    ending in a synchronize (the median is seconds per step), with the
    peak memory over them and the launches of ``wrappers`` in the first
    timed step; then one step under the profiler; then
    ``check_gradient_run``: every step's loss, gradient and light curve
    the same bits, torch's nondeterministic sites, the step's backward
    calls against their twins."""
    import numpy as np
    import torch

    results = [step()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, counts = [], None
    for k in range(reps):
        for w in wrappers.values():
            w.launches = 0
        start = time.perf_counter()
        results.append(step())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        loss, grad, _ = results[-1]
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
    checks = check_gradient_run(label, step, results)
    return dict(seconds_per_step=seconds, median_s=med, peak_bytes=peak, launches=counts, profile=prof,
                loss=loss, grad=grad.tolist(), **checks)


def same_tensors(a, b) -> bool:
    """``a`` and ``b`` the same float32 bits entry for entry (-0.0 and +0.0
    differ), a NaN equal to a NaN."""
    return a.shape == b.shape and same_bits(a, b) == 0 and bool((a.isnan() == b.isnan()).all())


def record_grad_calls(step) -> list:
    """One call of ``step`` (a gradient step), and every call its backward
    makes to the backward kernels' wrappers, in order, as (kind, args,
    keywords): "read" (``ops.table_read._backward``: the reads' backward),
    "gather" (``gather_rows_grad``) and "kde" (``kernel_histogram_grad``),
    the lanes' tensors cloned (the tables, whose addresses a read's spec
    holds, kept as they are)."""
    import torch

    from theia_tpu_torch import response
    from theia_tpu_torch.ops import table_read

    def clone(a):
        if isinstance(a, torch.Tensor):
            return a.detach().clone()
        return type(a)(clone(b) for b in a) if isinstance(a, (tuple, list)) else a

    kept = []
    lanes = {"read": (4, 5, 6), "gather": (1, 2), "kde": (0, 1, 2, 3, 4, 5, 6, 9)}
    sites = {"read": (table_read, "_backward"), "gather": (table_read, "gather_rows_grad"),
             "kde": (response, "kernel_histogram_grad")}
    saved = {kind: getattr(module, name) for kind, (module, name) in sites.items()}

    def recording(kind, fn):
        def wrapper(*args, **kw):
            kept.append((kind, tuple(clone(a) if k in lanes[kind] else a for k, a in enumerate(args)), dict(kw)))
            return fn(*args, **kw)
        wrapper.launches = getattr(fn, "launches", 0)  # a wrapper counts on the name it is called by
        return wrapper

    try:
        for kind, (module, name) in sites.items():
            setattr(module, name, recording(kind, saved[kind]))
        step()
    finally:
        for kind, (module, name) in sites.items():
            setattr(module, name, saved[kind])
    torch.cuda.synchronize()
    return kept


def grad_call(kind, args, kw, plain: bool = False):
    """A recorded backward call (``record_grad_calls``) as a function of
    nothing that runs it through the package's wrapper, or through its
    plain twin on the same card tensors, and returns its outputs (None
    where it takes none)."""
    from theia_tpu_torch import response
    from theia_tpu_torch.ops import table_read

    if kind == "read":
        reader, *rest = args
        flat = lambda g: tuple(g[0]) + (g[1],)
        if plain:
            return lambda: flat(reader.grad_plain(*rest))
        return lambda: flat(table_read._backward(reader, *rest))
    if kind == "gather":
        fn = table_read.gather_rows_grad_plain if plain else table_read.gather_rows_grad
        return lambda: (fn(*args),)
    if not plain:
        return lambda: response.kernel_histogram_grad(*args, **kw)
    need_lanes, need_params = kw.get("need_lanes", True), kw.get("need_params", True)

    def twin():
        g = response.kernel_histogram_grad_plain(*args)
        return (*(g[:2] if need_lanes else (None, None)), *(g[2:] if need_params else (None,) * 3))

    return twin


def hold_grad_calls(label, calls) -> dict:
    """Each recorded backward call of a step (``record_grad_calls``) run
    twice through the package's wrapper and once through its plain twin on
    the same card tensors: the three the same bits, output for output.
    Returns the calls held, by kind."""
    import torch

    counts = {}
    for kind, args, kw in calls:
        first, second = grad_call(kind, args, kw)(), grad_call(kind, args, kw)()
        want = grad_call(kind, args, kw, plain=True)()
        torch.cuda.synchronize()
        for k, (a, b, c) in enumerate(zip(first, second, want)):
            assert (a is None) == (b is None) == (c is None), f"{label}: a {kind} call's output {k}"
            if a is not None:
                a, b, c = (x.reshape(-1) for x in (a, b, c))
                assert same_tensors(a, b), f"{label}: two launches of a {kind} call differ in output {k}"
                assert same_tensors(a, c), (
                    f"{label}: a {kind} call's output {k} differs from its twin in {same_bits(a, c)} entries")
        counts[kind] = counts.get(kind, 0) + 1
    print(f"{label}: the backward kernels on the step's {len(calls)} recorded calls {counts}: two launches the "
          f"same bits, equal to their plain twins bit for bit")
    return counts


def nondeterministic_sites(step) -> list:
    """The ops that torch warns, under ``torch.use_deterministic_algorithms(
    True, warn_only=True)`` set around one call of ``step`` alone (the
    package never sets it), have no deterministic implementation: each
    warning's first line, once. Ops that torch would switch to a
    deterministic form are not listed; the step's repeat check finds them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).splitlines()[0][:200] for w in caught if "determinis" in str(w.message)})


def step_repeats(label, results) -> int:
    """Steps' (loss, gradient, light curve, ...) results, each the same
    bits as the first; returns how many steps were compared."""
    import numpy as np

    first = results[0]
    for k, got in enumerate(results[1:], 1):
        for j, (a, b) in enumerate(zip(first, got)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes(), (
                f"{label}: step {k} differs from step 0 in result {j}")
    return len(results)


def check_gradient_run(label, step, repeated: list) -> dict:
    """What every gradient run is held to beyond its timing: its steps'
    results bit for bit (``repeated``, the results of the steps it took),
    the ops torch lists as without a deterministic implementation in one
    step (``nondeterministic_sites``), and one step's recorded backward
    calls held against their twins (``hold_grad_calls``)."""
    steps = step_repeats(label, repeated)
    sites = nondeterministic_sites(step)
    print(f"{label}: {steps} steps the same bits (loss, gradient, light curve); torch's ops without a deterministic "
          f"implementation in a step: {sites or 'none'}")
    return dict(steps_repeated=steps, nondeterministic_sites=sites, calls_held=hold_grad_calls(label, record_grad_calls(step)))


def gradient_agreement(label, g_cpu, g_card, what: str = "cpu vs card") -> dict:
    """``PERF.md``'s gradient agreement between the port on the CPU and on
    the card (or two runs ``what`` names): the same nonzero entries, each
    within rtol 1e-3, the sum within 1e-5."""
    import numpy as np

    rel = np.abs(g_card - g_cpu) / np.maximum(np.abs(g_cpu), 1e-300)
    worst = float(rel[g_cpu != 0].max())
    sum_rel = abs(g_card.sum() / g_cpu.sum() - 1.0)
    print(f"{what} ({label}) at batch {GRAD_BATCH}, path length {GRAD_PATH}: "
          f"{int((g_cpu != 0).sum())} nonzero entries, worst entry rel diff {worst:.3g}, sum rel diff {sum_rel:.3g}")
    assert np.array_equal(g_cpu != 0, g_card != 0), f"gradient nonzero pattern differs ({label})"
    assert worst <= 1e-3 and sum_rel <= 1e-5, f"cpu and card gradients disagree ({label})"
    return dict(worst_entry_rel=worst, sum_rel=sum_rel)


#: the four walk entry points: (source, the theia_tpu function each replaces)
WALK_KERNELS = {
    "nearest_triangle_instanced": ("theia_tpu_torch/csrc/instanced_walk.cu", "theia_tpu/ops/instanced.py:618"),
    "occluded_instanced": ("theia_tpu_torch/csrc/instanced_walk.cu", "theia_tpu/ops/instanced.py:602"),
    "nearest_triangle_bvh": ("theia_tpu_torch/csrc/bvh_walk.cu", "theia_tpu/ops/bvh_traverse.py:95"),
    "occluded_bvh": ("theia_tpu_torch/csrc/bvh_walk.cu", "theia_tpu/ops/bvh_traverse.py:184"),
}
WALK_LIBRARY = "none: no PyTorch call walks a BVH or an instance list"
#: float32 operations of the walks' work (counted from csrc/walk.cuh and
#: csrc/instanced_walk.cu): an instance's sphere pretest, where its box lets
#: the ray in (3 differences, 5 for b, 1 product, 2 for the clip, 6 for p,
#: 5 for s, 5 for |oc|^2, 4 for the right side, 1 comparison), and a ray's
#: move into an instance's object space (3 rows of 3 products and 3 sums,
#: 3 of 3 products and 2 sums); a node's or an instance box's slab test is
#: BOX_FLOP, a triangle's exact test PAIR_FLOP["mt"][2]
SPHERE_TEST_FLOP = 32
TRANSFORM_FLOP = 33
#: the sweep's module counts (1 x 1 x 1, 2 x 2 x 2, 3 x 3 x 3 and 5 x 5 x 5
#: lattices, the centre of an odd one left free) and its rays
SWEEP_SIDES = (1, 2, 3, 5)
SWEEP_RAYS = 65_536
#: the path length of flagship-array (example 08's)
ARRAY_PATH = 8


class Walk:
    """One of the four walk entry points with its plain version and the
    tables it walks (a scene pack's ``instanced`` or ``bvh``)."""

    def __init__(self, name, scene_pack):
        from theia_tpu_torch.ops import bvh_traverse as tbvh
        from theia_tpu_torch.ops import instanced as tinst

        self.name = name
        kind = "instanced" if name.endswith("instanced") else "bvh"
        module = tinst if kind == "instanced" else tbvh
        self.kernel, self.plain = getattr(module, name), getattr(module, f"{name}_plain")
        self.scene_pack = scene_pack
        self.pack = getattr(scene_pack, kind)
        self.cpu_pack = self.pack.to("cpu")
        self.any_hit = name.startswith("occluded")
        self.module = module

    def placement(self) -> str:
        """Where the kernel reads the tables from, with their bytes."""
        m = self.module
        if hasattr(self.pack, "groups"):
            return "; ".join(f"{m.PLACES[m.placement(g)]} ({4 * (g.boxes.numel() + g.rows.numel())} bytes)"
                             for g in self.pack.groups)
        return f"{m.PLACES[m.placement(self.pack)]} ({4 * (self.pack.nodes.numel() + self.pack.tri.numel())} bytes)"

    def results(self, fn, pack, rays, stats=None):
        out = fn(pack, *rays) if stats is None else fn(pack, *rays, stats=stats)
        return out if isinstance(out, tuple) else (out,)

    def check(self, rays, label, on_cpu: bool, lanes=None, stats=None):
        """Kernel against plain (on the card, or on the CPU copy of the
        inputs at ``lanes``), bit for bit; ``stats`` takes the plain walk's
        counts. Returns (max |t diff| over hits, hit share)."""
        import torch

        got = self.results(self.kernel, self.pack, rays)
        torch.cuda.synchronize()
        if on_cpu:
            at = slice(None) if lanes is None else lanes
            want = self.results(self.plain, self.cpu_pack, [r[at].cpu() for r in rays], stats)
            got = [g[at].cpu() for g in got]
        else:
            want = self.results(self.plain, self.pack, rays, stats)
        for what, g, w in zip(("occluded",) if self.any_hit else ("t", "idx"), got, want):
            assert torch.equal(g, w), f"{self.name}: {what} differs from plain on {label}"
        hit = want[0] if self.any_hit else want[1] >= 0
        err = 0.0 if self.any_hit or not bool(hit.any()) else float((got[0][hit] - want[0][hit]).abs().max())
        return err, float(hit.float().mean())

    def bound(self, n_rays: int, stats: dict) -> dict:
        """The least time for queries of ``n_rays`` rays in all whose work
        ``stats`` counts: each ray and answer moved once (29 bytes a lane
        for the any-hit, 36 for the nearest hit), the tables once."""
        flop = (stats.get("box_tests", 0) * BOX_FLOP + stats.get("sphere_tests", 0) * SPHERE_TEST_FLOP
                + stats.get("transforms", 0) * TRANSFORM_FLOP + stats.get("tri_tests", 0) * PAIR_FLOP["mt"][2])
        if hasattr(self.pack, "groups"):
            tables = sum(g.tri.numel() + g.w2o.numel() + g.boxes.numel() + g.base.numel() for g in self.pack.groups)
        else:
            tables = self.pack.nodes.numel() + self.pack.tri.numel() + self.pack.order.numel()
        return bound(n_rays * (29 if self.any_hit else 36) + tables * 4, flop)


def walk_adversarial(scene_pack, seed: int, per_kind: int = 256, device="cuda"):
    """Hard rays for a walk over ``scene_pack`` (card tensors origin,
    direction, t_max): ``adversarial_rays`` on its world soup (through
    vertices, along edges, in a triangle's plane, off a surface), rays
    lying in a face of a node's or an instance's box (the direction's
    component across the face 0, -0 or below the 1e-12 clamp, either sign),
    and dead lanes (NaN in the origin or the direction, a zero direction);
    t_max cycles through inf, a finite bound, 0, -1 and NaN."""
    import numpy as np
    import torch

    from torch_flagship import adversarial_rays

    soup = [a.cpu().numpy() for a in (scene_pack.w_v0, scene_pack.w_e1, scene_pack.w_e2)]
    o, d = adversarial_rays(*soup, seed=seed, per_kind=per_kind)
    if scene_pack.bvh is not None:
        boxes = scene_pack.bvh.nodes[:, 0:6].cpu().numpy()
    else:
        g = scene_pack.instanced.groups[0]
        boxes = np.stack([a.reshape(-1)[: g.base.shape[0]].cpu().numpy() for a in g.box], axis=1)
    rng = np.random.default_rng(seed)
    pick = boxes[rng.integers(0, len(boxes), 6 * per_kind)]
    lo, hi = pick[:, 0:3], pick[:, 3:6]
    axis = rng.integers(0, 3, len(pick))
    face = np.where(rng.uniform(size=(len(pick), 1)) < 0.5, lo, hi)[np.arange(len(pick)), axis]
    fo = lo - (hi - lo) + rng.uniform(size=lo.shape) * 3.0 * (hi - lo)
    fo[np.arange(len(pick)), axis] = face
    fd = rng.normal(size=lo.shape)
    fd /= np.linalg.norm(fd, axis=1, keepdims=True)
    across = np.asarray([0.0, -0.0, 1e-13, -1e-13, 5e-13, -5e-13])[rng.integers(0, 6, len(pick))]
    fd[np.arange(len(pick)), axis] = across
    dead_o = rng.uniform(-3.0, 3.0, (4 * 8, 3))
    dead_d = rng.normal(size=(4 * 8, 3))
    dead_o[:8, 1] = np.nan
    dead_d[8:16, 2] = np.nan
    dead_d[16:24] = 0.0
    dead_o[24:] = np.inf
    o = np.concatenate([o, fo, dead_o]).astype(np.float32)
    d = np.concatenate([d, fd, dead_d]).astype(np.float32)
    kinds = np.asarray([np.inf, 3.0, 0.0, -1.0, np.nan], np.float32)
    t_max = kinds[np.arange(len(o)) % len(kinds)]
    t_max = np.where(t_max == 3.0, rng.uniform(0.5, 6.0, len(o)), t_max).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (o, d, t_max))


def walk_rays(scene_pack, n: int, seed: int, device="cuda"):
    """Random rays for a walk over ``scene_pack``: through the detector
    array (``array_rays``) on an instanced pack, around the flagship's
    spheres (``random_rays``) on a BVH pack."""
    import torch

    from torch_flagship import array_rays

    if scene_pack.instanced is not None:
        return tuple(torch.as_tensor(a, device=device) for a in array_rays(n, seed))
    return random_rays(n, seed, device)


def check_walk(walk: Walk, scene_pack, queries, report):
    """A walk entry point against its plain version, bit for bit: random
    rays at N = 262,144 (the plain walk on the card on every lane and on
    the CPU on a seeded eighth of them), with its time as called and
    queued, the plain walk's, and the bound from the plain walk's counts;
    the adversarial rays (``walk_adversarial``, on the card and on the
    CPU); and the queries that one batch of the walk's cell recorded, with
    an any-hit on each of them bounded at half its nearest hit's t,
    replayed for ms a batch."""
    import torch

    name, worst = walk.name, 0.0
    print(f"kernel {name}: tables placed {walk.placement()}")
    rays = walk_rays(scene_pack, BATCH, len(name))
    stats = {}
    err, hits = walk.check(rays, f"random rays N={BATCH} (plain on the card)", on_cpu=False, stats=stats)
    lanes = {"random": lane_report(stats.pop("lane_counts"))}
    walk.check(rays, f"random rays N={BATCH} (plain on the CPU, an eighth of the lanes)", on_cpu=True,
               lanes=seeded_lanes(BATCH, 8, len(name)))
    worst = max(worst, err)
    call = lambda: walk.kernel(walk.pack, *rays)
    ms, queued = cuda_ms(call, 20), cuda_ms_queued(call, 20)
    plain_ms = cuda_ms(lambda: walk.plain(walk.pack, *rays), 1)
    b = walk.bound(BATCH, stats)
    print(f"kernel {name} N={BATCH}: bit-equal to plain, hits {hits:.4f}; kernel {ms:.4f} ms as called, {queued:.4f} "
          f"queued; plain {plain_ms:.4f} ms; work {stats}; bound {b['bound_ms']:.4f} ms by {b['bound_by']}, share of "
          f"bound (queued) {b['bound_ms'] / queued:.4f}")
    report.update(ms=ms, queued_ms=queued, plain_ms=plain_ms, **b, n=BATCH, work=stats, library_ms=None,
                  library=WALK_LIBRARY, share_of_bound_queued=b["bound_ms"] / queued, placement=walk.placement())
    adversarial = walk_adversarial(scene_pack, 11 + len(name))
    for on_cpu in (False, True):
        err, hits = walk.check(adversarial, "adversarial rays", on_cpu=on_cpu)
        worst = max(worst, err)
    print(f"kernel {name}: bit-equal to plain on {adversarial[0].shape[0]} adversarial rays (card and CPU), hits "
          f"{hits:.4f}")
    batch_stats, n_rays = {}, 0
    for q in queries:
        err, _ = walk.check(q, "a recorded query", on_cpu=False, stats=batch_stats)
        worst, n_rays = max(worst, err), n_rays + q[0].shape[0]

    def replay():
        for q in queries:
            walk.kernel(walk.pack, *q)

    batch_ms, batch_queued = cuda_ms(replay, 5), cuda_ms_queued(replay, 5)
    lanes["recorded"] = lane_report(batch_stats.pop("lane_counts"))
    bb = walk.bound(n_rays, batch_stats)
    print(f"kernel {name}: bit-equal to plain on the {len(queries)} recorded queries of a batch ({n_rays} rays); "
          f"replayed {batch_ms:.4f} ms a batch as called, {batch_queued:.4f} queued; work {batch_stats}; bound "
          f"{bb['bound_ms']:.4f} ms, share (queued) {bb['bound_ms'] / batch_queued:.4f}")
    for label, r in lanes.items():
        print(f"kernel {name}: lanes 32 a warp, {label} rays: " + ", ".join(f"{k} {v:.4f}" for k, v in r.items()))
    report.update(max_abs_err=worst, lanes=lanes, batch=dict(queries=len(queries), rays=n_rays, ms=batch_ms,
                                                             queued_ms=batch_queued, work=batch_stats, **bb))
    worst = max(worst, check_walk_cases(walk, report.setdefault("cases", {})))
    report["max_abs_err"] = worst


def lane_report(lane_counts, warps_a_block: int = 8) -> dict:
    """How a thread-a-lane walk's warps spend their steps, from the plain
    walk's per-lane counts of each call (``stats["lane_counts"]``), lanes
    grouped 32 a warp in their order, as the kernel groups them (lanes past
    the rays count 0). The BVH's (node visits, triangle tests): each
    efficiency is the lanes' steps over 32 times the warps' largest
    (mean / max a warp, weighted by the max), of the node visits, of the
    triangle tests and of both together; the leaf loop's share is the
    triangle tests' of both. The instanced walk's candidates: the same
    efficiency of a lane's candidate loop, and the balance of the warps'
    candidates (a warp scans them together) over ``warps_a_block`` warps,
    what a block-level queue could even out."""
    import torch

    sums: dict = {}

    def add(key, value):
        sums[key] = sums.get(key, 0) + int(value)

    for counts in lane_counts:
        warps = [torch.nn.functional.pad(c.long(), (0, -c.shape[0] % 32)).view(-1, 32) for c in counts]
        parts = {"nodes": warps[0], "triangles": warps[1], "both": warps[0] + warps[1]} if len(warps) == 2 else {
            "candidates": warps[0]}
        for key, w in parts.items():
            add(f"{key} lane steps", w.sum())
            add(f"{key} warp steps", 32 * w.amax(dim=1).sum())
        if len(warps) == 1:
            per_warp = warps[0].sum(dim=1)
            blocks = torch.nn.functional.pad(per_warp, (0, -per_warp.shape[0] % warps_a_block)).view(-1, warps_a_block)
            add("block pairs", blocks.sum())
            add("block pair slots", warps_a_block * blocks.amax(dim=1).sum())
    out = {f"{key} efficiency": sums[f"{key} lane steps"] / max(sums[f"{key} warp steps"], 1)
           for key in ("nodes", "triangles", "both", "candidates") if f"{key} lane steps" in sums}
    if "both lane steps" in sums:
        out["leaf loop share"] = sums["triangles lane steps"] / max(sums["both lane steps"], 1)
    else:
        out["candidates a lane"] = sums["candidates lane steps"] / sum(c[0].shape[0] for c in lane_counts)
        out["warps' balance in a block"] = sums["block pairs"] / max(sums["block pair slots"], 1)
    return out


def case_rays(scene_pack, n: int, seed: int, device="cuda"):
    """Random rays for a walk over any scene: origins in the box of its
    world triangles and 1 m beyond, half of the directions aimed near a
    random triangle's first vertex, t_max half finite, half infinite."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    v0 = scene_pack.w_v0.cpu().numpy().astype(np.float64)
    lo, hi = v0.min(axis=0) - 1.0, v0.max(axis=0) + 1.0
    o = rng.uniform(lo, hi, (n, 3))
    aim = v0[rng.integers(0, len(v0), n)] + rng.normal(scale=0.05, size=(n, 3))
    d = np.where(rng.uniform(size=(n, 1)) < 0.5, aim - o, rng.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0.5, float(np.linalg.norm(hi - lo)), n), np.inf)
    return tuple(torch.as_tensor(a.astype(np.float32), device=device) for a in (o, d, t_max))


#: the rays of each of a walk's cases (walk_cases)
CASE_RAYS = 65_536


def walk_cases(kind: str, device="cuda") -> dict:
    """The scenes a walk of ``kind`` ("instanced" or "bvh") is held on
    besides its cell's, each with the placement its tables must get: the
    tie scenes (``torch_flagship.tie_scene``), and a scene for each
    placement the cells do not reach: for the instanced walk a prototype
    over the shared-memory budget (8 modules of ``icosphere(5)``, 20,480
    rows: the boxes staged, the rows read from global memory); for the BVH
    the tests' 27-module array (3,239 nodes staged, its 8,640 rows not)
    and the sweep's 124-module scene (neither). Values: (a function that
    makes the scene, the start of its placement's name, empty where any
    will do)."""
    import theia_tpu_torch
    from torch_flagship import TIE_KINDS, array_scene, build_array, icosphere, tie_scene

    cases = {f"tie, {k}": ((lambda k=k: tie_scene(theia_tpu_torch, kind, k, device=device)), "") for k in TIE_KINDS}
    if kind == "instanced":
        cases["a prototype over the budget: 8 modules of icosphere(5)"] = (lambda: build_array(
            theia_tpu_torch, icosphere(5), 64, 2, accel="instanced", device=device, n_side=2).scene, "boxes")
    else:
        cases["the tests' 27-module array"] = (lambda: array_scene(theia_tpu_torch, "bvh", device=device), "nodes")
        cases["the sweep's 124 modules"] = (lambda: build_array(
            theia_tpu_torch, icosphere(3), 64, 2, accel="bvh", device=device, n_side=5).scene, "global")
    return cases


def check_walk_cases(walk: "Walk", report: dict, n: int = CASE_RAYS) -> float:
    """``walk``'s kernel against its plain version, bit for bit, on each
    of :func:`walk_cases` (random rays, ``case_rays``, and adversarial
    rays; the plain walk on the card, and on the CPU on the tie scenes),
    after checking the case's placement. Returns the largest |t diff|."""
    import torch

    worst = 0.0
    kind = "instanced" if walk.name.endswith("instanced") else "bvh"
    for label, (build, place) in walk_cases(kind).items():
        case = Walk(walk.name, build().pack)
        assert case.placement().startswith(place), (label, case.placement())
        hits = []
        for rays, what in ((case_rays(case.scene_pack, n, 5), f"random rays N={n}"),
                           (walk_adversarial(case.scene_pack, 6, per_kind=64), "adversarial rays")):
            err, hit = case.check(rays, f"{label}, {what}", on_cpu=False)
            if label.startswith("tie"):
                case.check(rays, f"{label}, {what}", on_cpu=True)
            worst, hits = max(worst, err), hits + [hit]
        report[label] = dict(placement=case.placement(), hits=hits)
        print(f"kernel {walk.name}: bit-equal to plain on {label} (tables placed {case.placement()}): {n} random "
              f"rays (hits {hits[0]:.4f}) and the adversarial rays (hits {hits[1]:.4f})")
        del case
        torch.cuda.empty_cache()
    return worst


def walk_queries(tracer, name):
    """The (origin, direction, t_max) of every nearest-hit query of one
    batch of ``tracer`` (its calls of ``accel._nearest``'s walk ``name``)."""
    import torch

    from theia_tpu_torch import accel

    def rays(pack, o, d, t_max):
        t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device), o.shape[:1])
        return o.clone(), d.clone(), t_max.clone().contiguous()

    return record_calls(tracer, accel, (name,), rays)


def anyhit_queries(nearest: Walk, queries):
    """For each recorded nearest-hit query, the any-hit's rays bounded at
    half the nearest hit's t (``nearest``'s kernel; the query's t_max where
    it missed), so that some lanes find a blocker and some do not."""
    import torch

    out = []
    for o, d, t_max in queries:
        t, _ = nearest.kernel(nearest.pack, o, d, t_max)
        out.append((o, d, torch.where(torch.isfinite(t), t * 0.5, t_max).contiguous()))
    return out


def sweep(mesh, report):
    """The crossover sweep: the nearest hit of SWEEP_RAYS random rays
    through lattices of SWEEP_SIDES (1, 8, 26 and 124 modules of
    ``mesh``), on the brute-force soup, the instanced walk and the BVH,
    each timed as called (one launch each; the instanced walk one a
    group). Recorded only: ``accel="auto"`` keeps theia_tpu's rule."""
    import torch

    import theia_tpu_torch
    from torch_flagship import array_rays, build_array

    from theia_tpu_torch import accel

    rows = []
    for n_side in SWEEP_SIDES:
        row = dict(n_side=n_side)
        rays = tuple(torch.as_tensor(a, device="cuda") for a in array_rays(SWEEP_RAYS, 100 + n_side, n_side))
        for backend in ("brute", "instanced", "bvh"):
            scene = build_array(theia_tpu_torch, mesh, 1, 2, accel=backend, device="cuda", n_side=n_side).scene
            query = lambda: accel._nearest(scene.pack, *rays)
            row["modules"], row["triangles"] = len(scene.instances), sum(len(i.mesh.indices) for i in scene.instances)
            row[backend] = cuda_ms(query, 10)
            row[f"{backend}_hits"] = float((query()[1] >= 0).float().mean())
        row["auto"] = build_array(theia_tpu_torch, mesh, 1, 2, device="cuda", n_side=n_side).scene.accel
        assert row["brute_hits"] == row["instanced_hits"] or abs(row["brute_hits"] - row["instanced_hits"]) < 1e-3, row
        print(f"sweep: {row['modules']} modules ({row['triangles']} triangles), {SWEEP_RAYS} rays: brute "
              f"{row['brute']:.4f} ms, instanced {row['instanced']:.4f} ms, bvh {row['bvh']:.4f} ms as called; hits "
              f"{row['brute_hits']:.4f}; auto picks {row['auto']}")
        rows.append(row)
    report["sweep"] = rows


def report_run(runs: dict, batch: int, label, seconds, counts, peak, prof, extra=""):
    """Print a run's seconds a batch, peak memory, launches a batch and
    profiled batch, and keep them in ``runs[label]``."""
    med = statistics.median(seconds)
    print(f"{label}: batch {batch}: {med:.4f} s/batch (median of {[round(x, 4) for x in seconds]}), peak memory "
          f"{peak / 2**20:.1f} MiB, launches per batch {counts}; one batch profiled: device busy "
          f"{prof['device_busy_ms']:.2f} ms, {prof['kernels']} kernels and copies{extra}")
    for entry in prof["top"][:5] + prof["own"]:
        print(f"    {entry['ms']:9.3f} ms {entry['count']:6d} x {entry['name'][:90]}")
    runs[label] = dict(seconds_per_batch=seconds, launches_per_batch=counts, peak_bytes=peak, profile=prof)


def sobol_and_camera_runs(mesh, wrappers, kernels, batch: int = BATCH, device="cuda") -> dict:
    """Phase 3k: the Sobol generator on the brute-force flagship
    (``_build_scene_tracer(rng="sobol")``, then in turns with its Philox
    twin) and on the volume flagship (example 11's generator), then the
    volume backward and direct runs with their physics checks, each at
    ``batch`` lanes: seconds a batch, launches a batch, peak memory and
    one profiled batch. Returns the runs' report."""
    import warnings

    import numpy as np
    import torch

    import theia_tpu_torch
    from torch_flagship import (
        DIRECT_CAMERA, DIRECT_MU_A, DIRECT_RADIUS, build_direct, build_flagship, build_volume_backward,
        build_volume_flagship, eager_route,
    )

    camera_runs = {}
    report_run_ = lambda *args, **kw: report_run(camera_runs, batch, *args, **kw)

    brute_sobol = build_flagship(theia_tpu_torch, mesh, batch, MAX_PATH, accel="auto", device=device,
                                 rng=sobol(FLAGSHIP_SOBOL))
    assert brute_sobol.scene.accel == "brute"
    seconds_, sums_, counts_, peak_ = timed_runs(brute_sobol, wrappers, "flagship-brute-sobol")
    per_batch = {k: v // 3 for k, v in counts_.items() if v}
    assert counts_["philox_uniform"] == 0 and counts_["sobol_owen_uniform"] > 0, per_batch
    assert counts_["nearest_in_table_rows"] == MAX_PATH * 3 and counts_["target_in_table"] == (MAX_PATH - 1) * 3
    report_run_("flagship-brute-sobol", seconds_, per_batch, peak_, profile_step(brute_sobol.run),
               f"; histogram sums {sums_}")
    kernels["sobol_owen_uniform"].update(launches=counts_["sobol_owen_uniform"],
                                         launches_per_batch=per_batch["sobol_owen_uniform"],
                                         path="flagship-brute-sobol, 3 batches")
    sobol_paths = {"flagship-brute-sobol": record_sobol_calls(brute_sobol)}
    # flagship-brute-sobol in turns with flagship-brute (Philox): the one generator's launches in the other's place
    # its Philox twin on the eager route, as the Sobol tracer runs: each draw one launch of its generator
    brute_philox = build_flagship(theia_tpu_torch, mesh, batch, MAX_PATH, accel="auto", device=device)
    sobol_turns = []
    with eager_route(brute_philox):
        brute_philox.run()  # warm-up batch
        prof = profile_step(brute_philox.run, watch=("philox",))
        print(f"flagship-brute (PhiloxRNG, eager route) in the same call: one batch profiled: device busy "
              f"{prof['device_busy_ms']:.2f} ms, {prof['kernels']} kernels and copies; its draws "
              f"{prof['watched']['philox']}")
        camera_runs["flagship-brute-sobol"]["philox_profile"] = prof
        for label, cell in (("sobol", brute_sobol), ("philox", brute_philox), ("philox", brute_philox),
                            ("sobol", brute_sobol)):
            turn_seconds, turn_sums, turn_counts, _ = timed_runs(cell, wrappers, f"flagship-brute ({label})")
            draws = turn_counts["sobol_owen_uniform" if label == "sobol" else "philox_uniform"]
            assert draws == per_batch["sobol_owen_uniform"] * 3, (label, turn_counts)
            sobol_turns.append(dict(rng=label, seconds_per_batch=turn_seconds, histogram_sums=turn_sums))
    print("flagship-brute with SobolQRNG / PhiloxRNG (eager route) in turns: " + "; ".join(
        f"{t['rng']} {statistics.median(t['seconds_per_batch']):.4f} s {[round(x, 4) for x in t['seconds_per_batch']]}"
        for t in sobol_turns))
    camera_runs["flagship-brute-sobol"]["turns_with_philox"] = sobol_turns
    del brute_sobol, brute_philox
    torch.cuda.empty_cache()

    with warnings.catch_warnings():  # its path's budget of 72 dims is past example 11's 64
        warnings.simplefilter("ignore")
        vol_sobol = build_volume_flagship(theia_tpu_torch, batch, device, rng=sobol(EXAMPLE_11_SOBOL))
    seconds_, sums_, counts_, peak_ = timed_runs(vol_sobol, wrappers, "flagship-volume-sobol")
    per_batch = {k: v // 3 for k, v in counts_.items() if v}
    assert counts_["philox_uniform"] == 0 and counts_["sobol_owen_uniform"] > 0, per_batch
    assert counts_["histogram_add"] == VOLUME_RECORDS * 3, per_batch
    vol_sobol._debug_rng = True
    with torch.no_grad():
        dims_ = vol_sobol._trace_batch(vol_sobol.params(), vol_sobol.rng.counter_words, vol_sobol.streams())[2]
    vol_sobol._debug_rng = False
    past = float((dims_ > EXAMPLE_11_SOBOL["dims"]).double().mean())
    report_run_("flagship-volume-sobol", seconds_, per_batch, peak_, profile_step(vol_sobol.run),
               f"; histogram sums {sums_}; lanes' last dim at most {int(dims_.max())}, past the table on {past:.6f} "
               f"of the lanes (budget {vol_sobol.nRNGSamples})")
    camera_runs["flagship-volume-sobol"].update(max_dim=int(dims_.max()), share_past_table=past)
    sobol_paths["flagship-volume-sobol"] = record_sobol_calls(vol_sobol)
    del vol_sobol
    time_sobol_path(kernels["sobol_owen_uniform"], sobol_paths)
    del sobol_paths
    torch.cuda.empty_cache()

    backward = build_volume_backward(theia_tpu_torch, batch, device)
    seconds_, totals_, counts_, peak_ = timed_runs(backward, wrappers, "volume-backward", recorded_total, True)
    assert len(totals_) == CAMERA_RUN_BATCHES
    counts_ = {k: v // 3 for k, v in counts_.items() if v}
    assert counts_["philox_uniform"] > 0 and counts_.get("histogram_add", 0) == 0, counts_
    # test_backward_energy_conservation: with mu_a = 0 the recorded contributions sum to the budget
    energy = sum(totals_) / (batch * CAMERA_RUN_BATCHES) / 1e9
    assert abs(energy - 1.0) < 0.05, f"volume-backward: energy estimate {energy} of the budget"
    report_run_("volume-backward", seconds_, counts_, peak_, profile_step(backward.run),
               f"; energy estimate over {CAMERA_RUN_BATCHES} x {batch} samples {energy:.6f} of the budget "
               f"(limit 5 %)")
    camera_runs["volume-backward"].update(energy_over_budget=energy, batches=CAMERA_RUN_BATCHES)
    del backward
    torch.cuda.empty_cache()

    direct = build_direct(theia_tpu_torch, batch, device)
    seconds_, curves_, counts_, peak_ = timed_runs(direct, wrappers, "direct", light_curve, True)
    assert len(curves_) == CAMERA_RUN_BATCHES
    counts_ = {k: v // 3 for k, v in counts_.items() if v}
    assert counts_["philox_uniform"] > 0 and counts_["histogram_add"] == 1, counts_
    curve = sum(curves_) / CAMERA_RUN_BATCHES
    d = float(np.linalg.norm(DIRECT_CAMERA))
    expected = 1e9 * DIRECT_RADIUS**2 / (6 * d * d) * np.exp(-DIRECT_MU_A * d)
    t_arr = 10.0 + d / (theia_tpu_torch.units.c / 1.33)
    closed = float(curve.sum()) / expected
    assert abs(closed - 1.0) < 0.05 and abs(int(curve.argmax()) - int(t_arr / 10.0)) <= 1, (closed, curve.argmax())
    report_run_("direct", seconds_, counts_, peak_, profile_step(direct.run),
               f"; total over {CAMERA_RUN_BATCHES} x {batch} samples {closed:.6f} of the closed form (limit 5 %), "
               f"peak bin {int(curve.argmax())} (arrival {t_arr:.2f} ns)")
    camera_runs["direct"].update(total_over_closed_form=closed, peak_bin=int(curve.argmax()))
    del direct
    torch.cuda.empty_cache()
    return camera_runs


def index_step(tracer, medium: str = "glass", weighted: bool = False):
    """One gradient step of sum(histogram state) in the packed refractive
    index of ``medium`` (every entry of its row one scalar, as
    ``tests/test_grad_scene.py``'s ``patch_media`` sets it) through
    ``trace_fn()``: a step that returns (loss, d loss / d n, light curve) as
    numpy (the gradient float64). ``weighted``: the loss is ``time_weighted`` of the light curve,
    the signal whose gradient phase 4 compares."""
    import torch

    fn, (p, counter, streams) = tracer.trace_fn()
    media = p["scene"].media
    h = media.handle(medium)
    n0 = float(media.tables["refractive_index"][h, 0])

    def step():
        leaf = torch.tensor(n0, device=streams.device, requires_grad=True)
        table = media.tables["refractive_index"].clone()
        table[h] = leaf
        tables = {**media.tables, "refractive_index": table}
        scene = dataclasses.replace(p["scene"], media=dataclasses.replace(media, tables=tables))
        state = fn({**p, "scene": scene}, counter, streams)[0]
        curve = tracer.response.result(p["response"], state)
        loss = time_weighted(curve) if weighted else state.sum()
        loss.backward()
        return loss.item(), leaf.grad.double().cpu().numpy().reshape(1), curve.detach().cpu().numpy()

    return step


def emissive_check(batch: int, lower: float, upper: float):
    """``tests/test_scene_backward.py``'s check of the emissive sphere as a
    ``timed_runs`` total: more than 99 % of the lanes recorded, each with
    4 pi within rtol 1e-5, at a time in [``lower``, ``upper``]."""
    import numpy as np

    def check(hits, label):
        valid = hits["valid"]
        n = int(valid.sum())
        contrib = hits["contrib"][valid].double()
        t = hits["time"][valid]
        rel = float(((contrib - 4 * np.pi) / (4 * np.pi)).abs().max())
        t_min, t_max = float(t.min()), float(t.max())
        assert n > 0.99 * batch and rel <= 1e-5 and t_min >= lower and t_max <= upper, (label, n, rel, t_min, t_max)
        return dict(valid_share=n / batch, contrib_rel=rel, t_min=t_min, t_max=t_max)

    return check


def connection_step(tracer):
    """The first camera vertex of a ``BidirectionalPathTracer`` batch, made
    once, and a step that connects it to the light subpath's L vertices
    and records the L * N items: one vertex's (L, N) work of a batch, for
    the profiler."""
    import torch

    from theia_tpu_torch.material import packed_medium_constants
    from theia_tpu_torch.trace.core import active_lanes
    from theia_tpu_torch.trace.scene import scene_propagation
    from theia_tpu_torch.trace.scene_backward import camera_ray, trace_to_surface

    p, streams = tracer.params(), tracer.streams()
    pack, rng = p["scene"], tracer.rng.state_for(tracer.rng.counter_words, streams)
    prop = scene_propagation(pack, p["tracer"])
    with torch.no_grad():
        (lam, lam_c), rng = tracer.wavelengthSource.sample(p["photons"], rng)
        verts, rng = tracer._light_subpath(p, pack, prop, lam, lam_c, streams, rng)
        cam, rng = tracer.camera.sample_ray(p["camera"], lam, rng)
        medium = torch.full_like(streams, pack.media.handle(tracer.cameraMedium))
        cray = camera_ray(cam, lam, cam.contrib, packed_medium_constants(pack.media, medium, lam))
        alive = active_lanes(streams, p)
        cray, *_ = trace_to_surface(pack, prop, cray, medium, alive, rng)

    def step():
        with torch.no_grad():
            item, ok = tracer._connect_all(pack, prop, p, verts, cray, medium, alive, 0, None, cam)
            tracer.response.record(p["response"], tracer.response.init(streams.device), item, ok, rng)

    return step


def scene_camera_runs(mesh, wrappers, grad_wrappers, batch: int = BATCH, device="cuda") -> dict:
    """Phase 3l: the scene camera tracers at ``batch`` lanes, each with its
    physics check (``tests/test_scene_backward.py``, ``test_grad_scene.py``
    and ``test_bidirectional.py``'s): scene-backward-target (the emissive
    sphere), scene-backward-target-grad (one step in the glass's index),
    scene-backward (against a ``VolumeBackwardTracer`` of 12 scatterings in
    the same call), bidirectional (against the budget less the direct and
    the single-scatter light, the latter a ``VolumeBackwardTracer`` in the
    same call; then one polarized batch against the unpolarized one):
    seconds a batch (median of 3 after a warm-up), launches a batch, peak
    memory, one profiled batch. Returns the runs' report."""
    import numpy as np
    import torch

    import theia_tpu_torch
    from torch_flagship import (
        SCENE_BUDGET, SCENE_CAMERA_RADIUS, build_backward_eta2, build_bidirectional, build_scene_backward,
        build_scene_backward_target, build_volume_backward, nearest_face_distance,
    )

    P, runs = theia_tpu_torch, {}
    report = lambda *args, **kw: report_run(runs, batch, *args, **kw)
    per_batch = lambda counts: {k: v // 3 for k, v in counts.items() if v}

    target = build_scene_backward_target(P, batch, device, mesh=mesh)
    bounds = nearest_face_distance(mesh, 10.0) / P.units.c, 10.01 / P.units.c
    seconds_, checks_, counts_, peak_ = timed_runs(
        target, wrappers, "scene-backward-target", emissive_check(batch, *bounds), True
    )
    counts_ = per_batch(counts_)
    assert counts_["nearest_in_table_rows"] == target.maxPathLength and "target_in_table" not in counts_, counts_
    report("scene-backward-target", seconds_, counts_, peak_, profile_step(target.run),
           f"; every batch: > 99 % of lanes recorded, 4 pi within {max(c['contrib_rel'] for c in checks_):.3g}, "
           f"times in [{min(c['t_min'] for c in checks_):.6g}, {max(c['t_max'] for c in checks_):.6g}] ns "
           f"(bounds [{bounds[0]:.6g}, {bounds[1]:.6g}])")
    runs["scene-backward-target"].update(checks=checks_)
    del target
    torch.cuda.empty_cache()

    eta2 = build_backward_eta2(P, batch, device, mesh=mesh)
    step = time_step(index_step(eta2), grad_wrappers, "scene-backward-target-grad")
    assert step["grad"][0] > 0.0, f"scene-backward-target-grad: d sum / d n = {step['grad'][0]} (eta^2 makes it > 0)"
    runs["scene-backward-target-grad"] = step
    del eta2
    torch.cuda.empty_cache()

    backward = build_scene_backward(P, batch, device, mesh=mesh)
    seconds_, totals_, counts_, peak_ = timed_runs(backward, wrappers, "scene-backward", recorded_total, True)
    counts_ = per_batch(counts_)
    # one shadow ray a segment and the direct connection's: the any-hit on the brute-force pack
    assert counts_["anyhit_in_table"] == backward.maxPathLength, counts_
    volume = build_volume_backward(P, batch, device, nScattering=backward.maxPathLength, target=None)
    vol_totals = [recorded_total(volume.run()[0], "volume-backward, 12 scatterings") for _ in range(CAMERA_RUN_BATCHES)]
    ratio = sum(totals_) / sum(vol_totals)
    assert abs(ratio - 1.0) < 0.05, f"scene-backward: {ratio} of the volume backward tracer's total"
    report("scene-backward", seconds_, counts_, peak_, profile_step(backward.run),
           f"; total over {CAMERA_RUN_BATCHES} x {batch} samples {ratio:.6f} of VolumeBackwardTracer's (limit 5 %)")
    runs["scene-backward"].update(over_volume_backward=ratio)
    del backward, volume
    torch.cuda.empty_cache()

    bdpt = build_bidirectional(P, batch, device, mesh=mesh)
    seconds_, curves_, counts_, peak_ = timed_runs(bdpt, wrappers, "bidirectional", light_curve, True)
    counts_ = per_batch(counts_)
    # a camera vertex's L x N connections: one any-hit query and one record
    assert counts_["anyhit_in_table"] == counts_["histogram_add"] == bdpt.cameraPathLength, counts_
    single = build_volume_backward(
        P, batch, device, nScattering=2, g=0.3, key=11, disableDirectLighting=True,
        response=P.response.HistogramHitResponse(nBins=60, t0=0.0, binSize=80.0),
    )
    single_total = sum(float(light_curve(single.run()[0], "single scatter").sum()) for _ in range(4)) / 4
    direct = SCENE_BUDGET * np.exp(-0.02 * SCENE_CAMERA_RADIUS)
    expected = SCENE_BUDGET - direct - single_total
    total = float(sum(curves_).sum()) / CAMERA_RUN_BATCHES
    assert expected > 0 and abs(total / expected - 1.0) < 0.1, f"bidirectional: {total} against {expected}"
    report("bidirectional", seconds_, counts_, peak_, profile_step(bdpt.run),
           f"; total over {CAMERA_RUN_BATCHES} x {batch} samples {total / expected:.6f} of budget - direct - "
           f"single scatter ({expected:.6g}; single {single_total:.6g}; limit 10 %)")
    runs["bidirectional"].update(over_expected=total / expected, expected=expected, single_scatter=single_total)
    step = connection_step(bdpt)
    step()  # warm-up
    conn = profile_step(step)
    print(f"bidirectional: one camera vertex's connection step ({bdpt.lightPathLength} x {batch} pairs, one "
          f"any-hit, one record): device busy {conn['device_busy_ms']:.2f} ms in {conn['kernels']} kernels and "
          f"copies; x {bdpt.cameraPathLength} a batch")
    for entry in conn["top"][:5] + conn["own"]:
        print(f"    {entry['ms']:9.3f} ms {entry['count']:6d} x {entry['name'][:90]}")
    runs["bidirectional"].update(connection_step=conn)
    del bdpt, single, step
    torch.cuda.empty_cache()

    # polarized, one batch: a scalar medium's Stokes and Mueller chains leave S0 as the unpolarized batch's
    pol = build_bidirectional(P, batch, device, mesh=mesh, polarized=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    pol_curve = light_curve(pol.run()[0], "bidirectional polarized")
    torch.cuda.synchronize()
    pol_seconds = time.perf_counter() - start
    pol_peak = torch.cuda.max_memory_allocated()
    first = curves_[0]
    assert np.allclose(pol_curve.numpy(), first.numpy(), rtol=1e-4, atol=1e-3 * float(first.max())), "polarized BDPT"
    pol_rel = float((pol_curve.sum() / first.sum() - 1.0).abs())
    print(f"bidirectional polarized: one batch of {batch} lanes {pol_seconds:.4f} s (its first, compiled already), "
          f"peak memory {pol_peak / 2**20:.1f} MiB; light curve within rtol 1e-4 of the unpolarized first batch's "
          f"(sum rel diff {pol_rel:.3g})")
    runs["bidirectional"].update(polarized=dict(seconds=pol_seconds, peak_bytes=pol_peak, sum_rel=pol_rel))
    del pol
    torch.cuda.empty_cache()
    return runs


#: float32 operations of the gamma kernel (csrc/gamma.cu), from its
#: arithmetic: a lane's set-up (the small test, max, reciprocal, pow and its
#: select, a_eff's add and select, 2 a - 1, sqrt, b, c) and its end (the
#: product with the scale) 12; a round (the clip 2, 1 - u1, the quotient,
#: log, / lam, exp, * a_eff, c v, + b, - cand, u1 u1 u2, log, the compare) 15.
GAMMA_LANE_FLOP, GAMMA_ROUND_FLOP = 12, 15
#: int32 operations of Philox's key set-up, which a lane's draws share (its
#: key is key + stream for every dim): the 64-bit add with its carries 5 and
#: the round keys' adds 20, that is PHILOX_SHARED_OPS less the dim + 1
PHILOX_KEY_OPS = PHILOX_SHARED_OPS - 1
#: float32 operations of the track's backward sample
#: (csrc/cherenkov_track.cu) at the least form of each step, a square root
#: or a division counted as one (``track_flop``). A (lane, segment) pair
#: off the segment: mu 8, the perpendicular's vector 9, its length 7, the
#: shift mu - cot d 2, the segment test 3. A pair on the segment adds its
#: contribution ft cos / d and its select 2 and the sum 1; on a surface
#: (a nonzero normal) also the point 6, the direction to the observer 3 + 7
#: + 3, the cosine 5 + 1 and its product 1 (a volume point's cosine is 1).
TRACK_OFF_FLOP, TRACK_ON_FLOP, TRACK_SURFACE_FLOP = 29, 3, 26
#: the two-pass design's count (``track_flop_yardstick``): the on-segment
#: form in every pair, and a second pass of compares up to k
TRACK_PAIR_FLOP, TRACK_COUNT_FLOP = TRACK_OFF_FLOP + TRACK_ON_FLOP, 1
#: the chosen candidate's outputs, once a lane: its time 5 and, where its
#: pair did not form them (a volume point, or a pair off the segment), the
#: point 6 and the direction 13
TRACK_TIME_FLOP, TRACK_POINT_FLOP = 5, 19
#: the synthetic gamma case's alphas, a lane each in turn (the cascades'
#: alpha_long runs from 1.6 at 1 GeV to 10.8 at 1 PeV; 6.38 for phase 3m's
#: 1 TeV EM cascade), and
#: its edge lanes: alpha 0 gives 0 (its scale u^(1/1e-6) underflows, as in
#: theia_tpu) and alpha -1 never accepts: NaN after 64 rounds, so R = 64
GAMMA_SWEEP = (0.5, 1.0, 4.0, 20.0)
GAMMA_EDGES = (0.0, -1.0)


def _copy_rng(rng):
    return dataclasses.replace(rng, stream=rng.stream.clone(), dim=rng.dim.clone())


def record_gamma_calls(tracer):
    """(alpha, rng) of every ``sample_gamma`` call of one batch of ``tracer``."""
    from theia_tpu_torch.ops import gamma

    keep = lambda alpha, rng: (alpha.detach().clone() if hasattr(alpha, "detach") else alpha, _copy_rng(rng))
    return record_calls(tracer, gamma, ("sample_gamma",), keep)


def record_track_calls(tracer):
    """The six tensors of every ``track_backward_sample`` call of one batch."""
    from theia_tpu_torch.ops import cherenkov_track

    keep = lambda *args: tuple(a.detach().clone() for a in args)
    return record_calls(tracer, cherenkov_track, ("track_backward_sample",), keep)


def same_bits(a, b) -> int:
    """Lanes whose float32 bits differ, NaN equal to NaN."""
    import torch

    nan = torch.isnan(a) & torch.isnan(b)
    return int(((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)) & ~nan).sum())


def gamma_int_ops(rng, rounds) -> int:
    """int32 operations of the draws of one ``sample_gamma`` call whose
    lanes ran ``rounds`` each (1 + 2 rounds draws at dims dim, dim + 1, ...):
    a draw after a lane's first forms its dim (1). Philox: the key once a
    lane (``PHILOX_KEY_OPS``) and ``PHILOX_DRAW_OPS`` a draw. Sobol: the
    lane's index (``SOBOL_LANE_OPS``), a draw in the table
    ``SOBOL_TABLE_OPS``, the seed of each dimension drawn in the table once
    (``SOBOL_DIM_OPS``), and a draw past the table its tail test and
    Philox's draw, with Philox's key once a lane that reaches the tail."""
    import torch

    from theia_tpu_torch.random import SobolState

    lane_draws = 1 + 2 * rounds.to(torch.int64)
    n, draws = lane_draws.numel(), int(lane_draws.sum())
    if not isinstance(rng, SobolState):
        return n * PHILOX_KEY_OPS + (draws - n) + draws * PHILOX_DRAW_OPS
    table = rng.dirs.shape[0]
    first = rng.dim.to(torch.int64)
    end = first + lane_draws
    tail = torch.clamp_min(end - torch.clamp_min(first, table), 0)
    in_table = int((lane_draws - tail).sum())
    rows = sum(bool(((first <= j) & (j < end)).any()) for j in range(table))
    return (n * SOBOL_LANE_OPS + (draws - n) + in_table * SOBOL_TABLE_OPS + rows * SOBOL_DIM_OPS
            + int(tail.sum()) * (1 + PHILOX_DRAW_OPS) + int((tail > 0).sum()) * PHILOX_KEY_OPS)


def hold_gamma(alpha, rng, label) -> dict:
    """``sample_gamma``'s kernel against its plain version on the card on
    one call: x bit for bit (NaN lanes alike) and every lane's new dim;
    returns R, the lanes' rounds and the call's bound."""
    import torch

    from theia_tpu_torch.ops.gamma import sample_gamma, sample_gamma_plain

    x, got = sample_gamma(alpha, rng)
    torch.cuda.synchronize()
    stats = {}
    y, want = sample_gamma_plain(alpha, rng, stats)
    differ = same_bits(x, y)
    assert differ == 0 and torch.equal(got.dim, want.dim), f"sample_gamma on {label}: {differ} lanes differ"
    n = x.shape[0]
    rounds = stats["rounds"]
    r_total = int(rounds.sum())
    per_lane = torch.as_tensor(alpha).numel() != 1
    # a lane reads its stream and dim (and alpha) and writes x and its new dim
    b = bound(n * (16 + 4 * per_lane), n * GAMMA_LANE_FLOP + r_total * GAMMA_ROUND_FLOP)
    int_ms = gamma_int_ops(rng, rounds) / PEAK_I32 * 1e3
    if int_ms > b["bound_ms"]:
        b = dict(bound_ms=int_ms, bound_by="operations")
    R = int(got.dim[0] - rng.dim[0] - 1) // 2 if n else 0
    return dict(b, lanes=n, R=R, mean_rounds=r_total / max(n, 1), nan_lanes=int(torch.isnan(x).sum()), differ=0)


def gamma_cases(n: int) -> dict:
    """The synthetic calls of ``sample_gamma``: ``n`` lanes sweeping
    ``GAMMA_SWEEP`` with the ``GAMMA_EDGES`` lanes first, drawn by Philox
    (a key and counter with carries, lanes at dims 0-9) and by the
    flagship's SobolQRNG (128 dims, the rounds of the edge lane past the
    table into its Philox tail)."""
    import torch

    from theia_tpu_torch.random import PhiloxRNG, SobolQRNG

    lanes = torch.arange(n, dtype=torch.int32, device="cuda")
    alpha = torch.tensor(GAMMA_SWEEP, device="cuda")[lanes % len(GAMMA_SWEEP)]
    alpha[: len(GAMMA_EDGES)] = torch.tensor(GAMMA_EDGES, device="cuda")
    philox = PhiloxRNG(key=(1 << 64) - 5, offset=(1 << 30) - 3).state(lanes)
    philox = dataclasses.replace(philox, dim=(lanes * 7) % 10)
    return {"philox": (alpha, philox), "sobol": (alpha, SobolQRNG(**FLAGSHIP_SOBOL).state(lanes))}


#: the alphas of ``gamma_mixed_case``'s lanes, and the lanes of its first
#: blocks that take the edge alphas (0, -1, NaN): spread over every warp
GAMMA_MIXED = (0.05, 0.5, 1.0, 2.5, 6.38, 40.0)
#: the kernels that one sample_gamma call runs on the card: the draws,
#: then the new dims (a programmatic dependent launch)
GAMMA_KERNELS_A_CALL = 2
GAMMA_EDGE_LANES = (3, 37, 70, 101, 140, 199, 230, 255, 300, 777, 1023)


def gamma_mixed_case(n: int, device="cuda") -> dict:
    """Calls of ``sample_gamma`` whose lanes' rounds differ widely within
    a block: ``n`` lanes of ``GAMMA_MIXED`` at random (seeded numpy), the
    edge alphas 0, -1 and NaN in turn at ``GAMMA_EDGE_LANES`` (64 rounds for
    -1 and NaN, in several warps of one block and in later blocks), drawn
    by Philox (lanes at dims 0-12) and by the flagship's SobolQRNG, as
    ``gamma_cases``."""
    import numpy as np
    import torch

    from theia_tpu_torch.random import PhiloxRNG, SobolQRNG

    rs = np.random.default_rng(9)
    alpha = rs.choice(np.asarray(GAMMA_MIXED, np.float32), n)
    edges = [j for j in GAMMA_EDGE_LANES if j < n]
    alpha[edges] = np.resize(np.asarray([0.0, -1.0, np.nan], np.float32), len(edges))
    lanes = torch.arange(n, dtype=torch.int32, device=device)
    alpha = torch.as_tensor(alpha, device=device)
    philox = PhiloxRNG(key=0xF00D, offset=77).state(lanes)
    philox = dataclasses.replace(philox, dim=(lanes * 5) % 13)
    return {"philox": (alpha, philox), "sobol": (alpha, SobolQRNG(**FLAGSHIP_SOBOL).state(lanes))}


def gamma_kernels(prof, calls: int) -> dict:
    """The kernels of ``calls`` ``sample_gamma`` calls in a ``profile_step``
    report ``prof``, by name, each count divided by ``calls``."""
    found = {}
    for item in prof["own"]:
        name = next((k for k in ("sample_gamma", "advance_dims") if k in item["name"]), None)
        if name:
            found[name] = found.get(name, 0) + item["count"] / calls
    return found


def gamma_launches(alpha, rng, calls: int = 4) -> dict:
    """The kernels that one ``sample_gamma`` call runs on the card, by
    name: ``profile_step`` of ``calls`` calls (after a warm-up call)."""
    from theia_tpu_torch.ops.gamma import sample_gamma

    sample_gamma(alpha, rng)
    return gamma_kernels(profile_step(lambda: [sample_gamma(alpha, rng) for _ in range(calls)]), calls)


def check_gamma(report, paths: dict, profiled: dict) -> None:
    """Kernel K1 (``sample_gamma``, ``csrc/gamma.cu``) against its plain
    version, bit for bit: the synthetic 2^20-lane calls of both generators
    (``gamma_cases``), the mixed rounds of ``gamma_mixed_case`` and each
    path's recorded calls (``paths``: label -> calls); the kernels of one
    call in each path's profiled batch (``profiled``: label -> name ->
    count, ``gamma_kernels``); then the paths' calls replayed, as called
    and queued (the
    kernel's row: the mean a call), beside the plain version, the bound at
    the lanes' own rounds and ``torch._standard_gamma`` on the same alphas
    (a yardstick: it draws other numbers, from torch's generator)."""
    import torch

    from theia_tpu_torch.ops.gamma import sample_gamma, sample_gamma_plain

    synthetic = {}
    for gen, (alpha, rng) in gamma_cases(1 << 20).items():
        info = synthetic[gen] = hold_gamma(alpha, rng, f"2^20 lanes, {gen}")
        assert info["R"] == 64 and info["nan_lanes"] == 1, info
        print(f"kernel sample_gamma, 2^20 lanes ({gen}; alphas {GAMMA_SWEEP}, edge lanes {GAMMA_EDGES}): bit-exact, "
              f"R = {info['R']}, mean rounds {info['mean_rounds']:.4f}, {info['nan_lanes']} NaN lane")
    for gen, (alpha, rng) in gamma_mixed_case(1 << 16).items():
        info = synthetic[f"mixed rounds, {gen}"] = hold_gamma(alpha, rng, f"mixed rounds, {gen}")
        edges = int(torch.isnan(alpha).sum() + (alpha < 0).sum())
        assert info["R"] == 64 and info["nan_lanes"] == edges, info
        print(f"kernel sample_gamma, 2^16 lanes of mixed rounds ({gen}; alphas {GAMMA_MIXED}, 0, -1 and NaN at lanes "
              f"{GAMMA_EDGE_LANES}): bit-exact, R = {info['R']}, mean rounds {info['mean_rounds']:.4f}, "
              f"{info['nan_lanes']} NaN lanes")
    alpha, rng = gamma_cases(1 << 20)["philox"]
    call = lambda: sample_gamma(alpha, rng)
    synthetic.update(ms=cuda_ms(call, 20), queued_ms=cuda_ms_queued(call, 20),
                     plain_ms=cuda_ms(lambda: sample_gamma_plain(alpha, rng), 1),
                     library_ms=cuda_ms(lambda: torch._standard_gamma(alpha.clamp_min(1e-6)), 20),
                     library_queued_ms=cuda_ms_queued(lambda: torch._standard_gamma(alpha.clamp_min(1e-6)), 20),
                     **synthetic["philox"])
    rows, every = {}, []
    for label, calls in paths.items():
        held = [hold_gamma(a, r, label) for a, r in calls]

        def replay(fn=sample_gamma):
            for a, r in calls:
                fn(a, r)

        n = len(calls)
        dense = [torch.broadcast_to(torch.as_tensor(a, device="cuda"), r.stream.shape).contiguous() for a, r in calls]
        rows[label] = dict(
            calls=n, lanes=sorted({h["lanes"] for h in held}), R=[h["R"] for h in held],
            mean_rounds=sum(h["mean_rounds"] for h in held) / n, ms=cuda_ms(replay, 10) / n,
            queued_ms=cuda_ms_queued(replay, max(1, 300 // n)) / n,
            plain_ms=cuda_ms(lambda: replay(sample_gamma_plain), 1) / n,
            bound_ms=sum(h["bound_ms"] for h in held) / n, bound_by=held[0]["bound_by"],
            library_ms=cuda_ms(lambda: [torch._standard_gamma(a) for a in dense], 10) / n,
            library_queued_ms=cuda_ms_queued(lambda: [torch._standard_gamma(a) for a in dense], max(1, 300 // n)) / n,
        )
        every += held
        r = rows[label]
        print(f"kernel sample_gamma on {label}'s inputs: {n} calls a batch ({r['lanes']} lanes, R {r['R']}, mean "
              f"rounds {r['mean_rounds']:.4f}), bit-exact; {r['ms']:.4f} ms a call ({r['queued_ms']:.4f} queued), plain "
              f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.5f} ms by {r['bound_by']}, share {r['bound_ms'] / r['queued_ms']:.3f} "
              f"queued; torch._standard_gamma (yardstick: other numbers) {r['library_ms']:.4f} ms "
              f"({r['library_queued_ms']:.4f} queued)")
    n = sum(r["calls"] for r in rows.values())
    mean = lambda key: sum(r[key] * r["calls"] for r in rows.values()) / n
    for label, launches in profiled.items():
        print(f"kernel sample_gamma: one call of {label}'s profiled batch runs {sum(launches.values()):g} kernels on the "
              f"card (torch.profiler: {launches}; {GAMMA_KERNELS_A_CALL} by design)")
    for label, launches in profiled.items():
        assert launches.get("sample_gamma") == 1 and sum(launches.values()) == GAMMA_KERNELS_A_CALL, (label, profiled)
    launches = next(iter(profiled.values()))
    report.update(max_abs_err=0.0, ms=mean("ms"), queued_ms=mean("queued_ms"), plain_ms=mean("plain_ms"),
                  bound_ms=sum(h["bound_ms"] for h in every) / n, bound_by=every[0]["bound_by"],
                  library_ms=mean("library_ms"), library_queued_ms=mean("library_queued_ms"),
                  library="torch._standard_gamma on the same alphas, a yardstick: "
                  "it draws other numbers", path_calls=n, paths=rows, synthetic=synthetic,
                  kernels_a_call=sum(launches.values()), kernels_of_a_call=profiled)
    print(f"kernel sample_gamma synthetic (2^20 lanes, Philox): {synthetic['ms']:.4f} ms ({synthetic['queued_ms']:.4f} "
          f"queued), plain {synthetic['plain_ms']:.4f} ms, bound {synthetic['bound_ms']:.5f} ms by "
          f"{synthetic['bound_by']}, torch._standard_gamma {synthetic['library_ms']:.4f} ms "
          f"({synthetic['library_queued_ms']:.4f} queued)")


def track_case(n: int, segments: int, seed: int, device="cuda"):
    """A synthetic call of ``track_backward_sample``: the straight line of
    the track run cut into ``segments`` (and bent after its middle),
    observers around it, half of them on a surface, photon-count factors
    and cotangents at n 1.33-1.36, uniforms."""
    import numpy as np

    x = np.linspace(-50.0, 50.0, segments + 1)
    verts = np.stack([x, np.where(x > 0, 0.3 * x, 0.0), 0 * x, x / 0.3], axis=1)
    rs = np.random.default_rng(seed)
    return _track_call(verts, rs.uniform(-60.0, 60.0, (n, 3)), rs, device)


def _track_call(verts, obs, rs, device):
    """``track_backward_sample``'s arguments for the vertices ``verts`` and
    observers ``obs``: half of them on a surface (a random unit normal),
    photon-count factors and cotangents at n 1.33-1.36, uniforms; float32
    on ``device``."""
    import numpy as np
    import torch

    from theia_tpu_torch.light import _ft_factor
    from theia_tpu_torch.ops.cherenkov_track import segment_table

    n = obs.shape[0]
    nrm = rs.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[: n // 2] = 0.0
    dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    n_refr, lam = dev(rs.uniform(1.33, 1.36, n)), dev(rs.uniform(420.0, 480.0, n))
    cos = 1.0 / n_refr
    cot = cos / torch.clamp_min(torch.sqrt(1.0 - cos * cos), 1e-7)
    return (segment_table(dev(verts)), dev(obs), dev(nrm), _ft_factor(True, n_refr, lam), cot,
            dev(rs.uniform(size=n)))


#: the first lanes of ``track_rule_cases``' "edge lanes", in order
TRACK_EDGE_LANES = (
    "ft NaN", "observer +inf", "observer -inf", "normal NaN", "cot NaN", "cot 1e8 (not tame)", "u 0",
    "u 1 - 2^-24", "u 1", "u NaN", "ft 0", "on the line past its end (total 0)", "a surface facing away",
    "observer at TAME_POSITION", "ft at TAME_WEIGHT",
)


def zigzag(n: int, rs, step: float = 4.0):
    """(vertices, observers) of a track that crosses x = -20 .. 20 m 300
    times, ``step`` m further along z each time, and ``n`` observers in the
    box around it, from the numpy generator ``rs``."""
    import numpy as np

    z = np.arange(301) * step
    verts = np.stack([np.where(np.arange(301) % 2 == 0, -20.0, 20.0), 0 * z, z, np.arange(301) * 40.0 / 0.3], axis=1)
    return verts, rs.uniform([-30.0, -15.0, -10.0], [30.0, 15.0, 300 * step + 10.0], (n, 3))


def track_rule_cases(n: int, device="cuda") -> dict:
    """The calls that single out the track kernel's shortcuts, ``n`` lanes
    each (``n`` >= 64), seeded numpy, half of the lanes on a surface:
    "edge lanes" (``track_case``'s bent line at 256 segments with the
    ``TRACK_EDGE_LANES`` first), "equal running sums" (a 128-segment line
    with every row twice and u = 0.5: a lit lane's two equal contributions
    put its running sum exactly at u total after the first), "zigzag, 300
    segments" (``zigzag``, 4 m a crossing: lanes lit on 1 to 12
    segments), "dense zigzag, 300 segments" (2 m a crossing: lanes lit on 2
    to 23 segments, about half of them past ``TRACK_LIST``, so the second
    pass), "a wild row" (the edge lanes' line with one row's
    start at 1e16: no lane of the call is tame, every lane takes two full
    passes)."""
    import numpy as np
    import torch

    from theia_tpu_torch.ops.cherenkov_track import TAME_POSITION, TAME_WEIGHT

    cases = {"edge lanes": track_case(n, 256, 7, device)}
    seg, obs, nrm, ft, cot, u = (a.clone() for a in cases["edge lanes"])

    def lit(j, value):  # a volume point that the line's first half lights, at the given u
        obs[j] = torch.tensor([-20.0, 5.0, 3.0])
        u[j] = value

    edits = {
        "ft NaN": lambda j: ft.__setitem__(j, float("nan")),
        "observer +inf": lambda j: obs.__setitem__((j, 0), float("inf")),
        "observer -inf": lambda j: obs.__setitem__((j, 2), -float("inf")),
        "normal NaN": lambda j: nrm.__setitem__((j, 1), float("nan")),
        "cot NaN": lambda j: cot.__setitem__(j, float("nan")),
        "cot 1e8 (not tame)": lambda j: cot.__setitem__(j, 1e8),
        "u 0": lambda j: lit(j, 0.0),
        "u 1 - 2^-24": lambda j: lit(j, 1.0 - 2.0**-24),
        "u 1": lambda j: lit(j, 1.0),
        "u NaN": lambda j: lit(j, float("nan")),
        "ft 0": lambda j: ft.__setitem__(j, 0.0),
        "on the line past its end (total 0)": lambda j: obs.__setitem__(j, torch.tensor([70.0, 21.0, 0.0])),
        "a surface facing away": lambda j: (obs.__setitem__(j, torch.tensor([-20.0, 0.0, 8.0])),
                                            nrm.__setitem__(j, torch.tensor([0.0, 0.0, -1.0]))),
        "observer at TAME_POSITION": lambda j: obs.__setitem__((j, 1), TAME_POSITION),
        "ft at TAME_WEIGHT": lambda j: ft.__setitem__(j, TAME_WEIGHT),
    }
    for j, label in enumerate(TRACK_EDGE_LANES):
        edits[label](j)
    cases["edge lanes"] = (seg, obs, nrm, ft, cot, u)
    rs = np.random.default_rng(8)
    x = np.linspace(-50.0, 50.0, 129)
    line = np.stack([x, 0 * x, 0 * x, x / 0.3], axis=1)
    call = _track_call(line, rs.uniform(-60.0, 60.0, (n, 3)), rs, device)
    twice = torch.repeat_interleave(call[0], 2, dim=0)
    cases["equal running sums"] = (twice, *call[1:5], torch.full_like(call[5], 0.5))
    cases["zigzag, 300 segments"] = _track_call(*zigzag(n, rs), rs, device)
    cases["dense zigzag, 300 segments"] = _track_call(*zigzag(n, rs, 2.0), rs, device)
    wild = seg.clone()
    wild[100, 0] = 1e16
    cases["a wild row"] = (wild, *cases["edge lanes"][1:])
    return cases


def hold_track(args, label) -> dict:
    """``track_backward_sample``'s kernel against its plain version on the
    card on one call, bit for bit in each output; returns its bound, with
    the two-pass design's count as ``yardstick``, and the lanes that the kernel
    sends to its second pass (lit on more than ``TRACK_LIST`` segments)."""
    import torch

    from theia_tpu_torch.ops.cherenkov_track import TRACK_LIST, track_backward_sample, track_backward_sample_plain

    got = track_backward_sample(*args)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = track_backward_sample_plain(*args)
    differ = {name: same_bits(g, w) if g.dtype == torch.float32 else int((g != w).sum())
              for name, g, w in zip(("total", "position", "direction", "time", "k"), got, want)}
    assert not any(differ.values()), f"track_backward_sample on {label}: {differ}"
    n, segments = args[1].shape[0], args[0].shape[0]
    lit = track_lit(args, got[4])
    flop = track_flop(args[2], lit)
    old, full = track_flop_yardstick(args[2], got[4], segments)
    return dict(bound(n * (36 + 36) + segments * 36, flop), lanes=n, segments=segments,
                live=float((got[0] > 0).double().mean()), yardstick_ms=old / PEAK_F32 * 1e3,
                two_full_passes_ms=full / PEAK_F32 * 1e3, lit_pairs=int(lit["on"].sum()),
                past_list=int((lit["on"] > TRACK_LIST).sum()))


def track_lit(args, k) -> dict:
    """Each lane's segments on the segment (``on``), those of surface lanes
    (``surface``), and whether its chosen candidate ``k`` is on its segment
    (``chosen_on``), from the plain version's candidates."""
    import torch

    from theia_tpu_torch.ops.cherenkov_track import _candidate

    seg, observer, normal, _, cot, _ = args
    on = torch.zeros(observer.shape[0], dtype=torch.int64, device=observer.device)
    with torch.no_grad():
        for s in range(seg.shape[0]):
            *_, mu, length = _candidate(seg[s], observer, cot)
            on += (mu >= 0.0) & (mu <= length)
        *_, mu, length = _candidate(seg[k.long()], observer, cot)
    return dict(on=on, surface=(normal * normal).sum(1) != 0, chosen_on=(mu >= 0.0) & (mu <= length),
                segments=seg.shape[0])


def track_flop(normal, lit) -> int:
    """float32 operations that one ``track_backward_sample`` call needs
    at the function's least form: every pair's short form, the lit pairs'
    contributions and sums (and, on a surface, their direction and
    cosine), the chosen candidate's outputs once; no second pass."""
    n = normal.shape[0]
    on, surface = lit["on"], lit["surface"]
    reuse = int((surface & lit["chosen_on"]).sum())  # a surface lane's lit pair formed its point and direction
    pairs = int(on.sum()) * TRACK_ON_FLOP + int(on[surface].sum()) * TRACK_SURFACE_FLOP
    return n * TRACK_OFF_FLOP * lit["segments"] + pairs + n * TRACK_TIME_FLOP + (n - reuse) * TRACK_POINT_FLOP


def track_flop_yardstick(normal, k, segments: int) -> tuple[int, int]:
    """The two-pass design's count, from the lanes' normals and chosen segments
    ``k``: the whole pair form (a surface lane's direction and cosine) over
    every segment; the second pass, whose running sum only grows, up to and
    including segment k; the chosen candidate's outputs. Second, the count
    with both passes over every segment."""
    import torch

    surface = (normal * normal).sum(1) != 0
    n, n_surface = normal.shape[0], int(surface.sum())
    upto = k.to(torch.int64) + 1
    pair = n * TRACK_PAIR_FLOP + n_surface * TRACK_SURFACE_FLOP
    ends = n * TRACK_TIME_FLOP + (n - n_surface) * TRACK_POINT_FLOP
    second = int(upto.sum()) * (TRACK_PAIR_FLOP + TRACK_COUNT_FLOP) + int(upto[surface].sum()) * TRACK_SURFACE_FLOP
    return segments * pair + second + ends, segments * (2 * pair + n * TRACK_COUNT_FLOP) + ends


def track_gradient_rel(args) -> float:
    """The gradient of ``track_backward_sample`` on the card (the kernel's
    forward, the plain loop recomputed in its backward) against the CPU
    port's on the same inputs (the plain loop, which
    tests/test_torch_cherenkov.py holds to ``jax.grad``): the chosen
    segments equal, then the largest difference in each input's gradient
    over that gradient's largest entry, the worst of the five."""
    import torch

    from theia_tpu_torch.ops.cherenkov_track import track_backward_sample

    grads, chosen = [], []
    for device in ("cuda", "cpu"):
        x = [a.detach().to(device).requires_grad_(i < 5) for i, a in enumerate(args)]
        out = track_backward_sample(*x)
        loss = out[0].sum() + out[1].sum() + out[2].sum() + out[3].sum()
        grads.append([g.cpu() for g in torch.autograd.grad(loss, x[:5])])
        chosen.append(out[4].cpu())
    assert torch.equal(*chosen), f"k differs on {int((chosen[0] != chosen[1]).sum())} lanes between card and CPU"
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in zip(*grads))


def check_track(report, paths: dict) -> None:
    """Kernel K2 (``track_backward_sample``, ``csrc/cherenkov_track.cu``)
    against its plain version, bit for bit: synthetic 2^20-lane calls on
    2 and 256 segments, 2^16-lane calls on 1 and 300 segments and on
    ``track_rule_cases`` (the edge lanes, equal running sums, the zigzag
    whose lanes overflow the kernel's list, a row that is not tame), and
    each path's recorded calls (``paths``); its gradient on the card
    against the CPU port's on a small call (``track_gradient_rel``); then
    the paths' calls replayed as called and queued (the kernel's row: the
    mean a call of the 256-segment run; the 3-vertex run's beside it),
    beside the plain version and the bound (the two-pass design's count as
    ``yardstick``). No library call computes it."""
    import torch

    from theia_tpu_torch.ops.cherenkov_track import track_backward_sample, track_backward_sample_plain

    synthetic = {}
    for segments in (2, 256):
        args = track_case(1 << 20, segments, segments)
        info = synthetic[f"{segments} segments"] = hold_track(args, f"2^20 lanes, {segments} segments")
        call = lambda: track_backward_sample(*args)
        info.update(ms=cuda_ms(call, 10), queued_ms=cuda_ms_queued(call, 10))
        print(f"kernel track_backward_sample, 2^20 lanes, {segments} segments: bit-exact ({info['live']:.3f} of the "
              f"lanes lit, {info['past_list']} past the list); {info['ms']:.4f} ms ({info['queued_ms']:.4f} queued), "
              f"bound {info['bound_ms']:.4f} ms by {info['bound_by']}, share {info['bound_ms'] / info['queued_ms']:.3f} "
              f"queued (yardstick {info['yardstick_ms']:.4f} ms, with two full passes {info['two_full_passes_ms']:.4f})")
    cases = {f"{s} segments": track_case(1 << 16, s, s) for s in (1, 300)}
    cases.update(track_rule_cases(1 << 16))
    for label, args in cases.items():
        info = synthetic[label] = hold_track(args, label)
        print(f"kernel track_backward_sample, 2^16 lanes, {label}: bit-exact ({info['live']:.3f} of the lanes lit, "
              f"{info['lit_pairs']} lit pairs, {info['past_list']} lanes past the list)")
    worst = track_gradient_rel(track_case(4096, 8, 1))
    assert worst <= 1e-5, f"track_backward_sample's gradient on the card differs from the CPU port's: {worst}"
    print(f"kernel track_backward_sample's gradient (4096 lanes, 8 segments): within {worst:.3g} of the CPU port's, "
          f"relative to each input's largest")
    rows = {}
    for label, calls in paths.items():
        held = [hold_track(c, label) for c in calls]

        def replay(fn=track_backward_sample):
            with torch.no_grad():
                for c in calls:
                    fn(*c)

        n = len(calls)
        rows[label] = r = dict(
            calls=n, lanes=held[0]["lanes"], segments=held[0]["segments"], live=[h["live"] for h in held],
            past_list=[h["past_list"] for h in held],
            ms=cuda_ms(replay, 5) / n, queued_ms=cuda_ms_queued(replay, max(1, 60 // n)) / n,
            plain_ms=cuda_ms(lambda: replay(track_backward_sample_plain), 1) / n,
            bound_ms=sum(h["bound_ms"] for h in held) / n, bound_by=held[0]["bound_by"],
            yardstick_ms=sum(h["yardstick_ms"] for h in held) / n,
            two_full_passes_ms=sum(h["two_full_passes_ms"] for h in held) / n,
        )
        print(f"kernel track_backward_sample on {label}'s inputs: {n} calls a batch ({r['lanes']} lanes, "
              f"{r['segments']} segments, lit {[round(x, 4) for x in r['live']]}, past the list {r['past_list']}), "
              f"bit-exact; {r['ms']:.4f} ms a call ({r['queued_ms']:.4f} queued), plain {r['plain_ms']:.4f} ms; bound "
              f"{r['bound_ms']:.5f} ms by {r['bound_by']}, share {r['bound_ms'] / r['queued_ms']:.3f} queued (yardstick "
              f"{r['yardstick_ms']:.5f} ms, with two full passes {r['two_full_passes_ms']:.5f}); library call: none")
    main_row = rows["track-backward, 256 segments"]
    report.update(max_abs_err=0.0, **{k: main_row[k] for k in ("ms", "queued_ms", "plain_ms", "bound_ms", "bound_by",
                                                                "yardstick_ms")},
                  library_ms=None, paths=rows, synthetic=synthetic, gradient_worst_rel=worst)


def cherenkov_path_calls(batch: int = BATCH) -> tuple[dict, dict]:
    """The ``sample_gamma`` and ``track_backward_sample`` calls of one
    batch of each phase 3m run that makes them (cherenkov-cascade,
    cascade-backward; track-backward at 3 vertices and at 256 segments),
    recorded as ``cherenkov_runs`` records them: (gamma, track), each
    label -> calls."""
    import theia_tpu_torch as P
    from torch_flagship import build_cherenkov_backward, build_cherenkov_volume, cascade_source, track_line_source

    gamma = {"cherenkov-cascade": record_gamma_calls(build_cherenkov_volume(P, batch, "cuda", source="cascade")),
             "cascade-backward": record_gamma_calls(build_cherenkov_backward(P, batch, "cuda",
                                                                             source=cascade_source(P)))}
    track = {label: record_track_calls(build_cherenkov_backward(P, batch, "cuda",
                                                                source=track_line_source(P, "track", segments)))
             for label, segments in (("track-backward", 2), ("track-backward, 256 segments", 256))}
    return gamma, track


#: the track runs' light curves agree with each other and with the simple
#: source's on the same line as tests/test_trace_backward.py's
#: test_track_backward_matches_simple_cherenkov holds them
TRACK_SUM_RTOL, TRACK_PEAK_BINS = 0.05, 1


def cherenkov_runs(mesh, wrappers, kernels, batch: int = BATCH, device="cuda") -> dict:
    """Phase 3m: Cherenkov light at ``batch`` lanes: cherenkov-muon and
    cherenkov-cascade (flagship-volume's tracer with a 1 TeV muon or a 1 TeV
    EM cascade), cascade-backward and track-backward (the volume backward
    tracer of tests/test_trace_backward.py with the cascade, the track's 3
    vertices and the same line in 256 segments, and the simple source on
    it for the curves' check), then flagship-brute-disk-guide; each run's
    seconds a batch (median of 3 after a warm-up), launches a batch, peak
    memory and one profiled batch; then kernels K1 and K2 on the runs'
    recorded calls (``check_gamma``, ``check_track``). Returns the runs."""
    import numpy as np
    import torch

    import theia_tpu_torch as P
    from torch_flagship import (
        build_cherenkov_backward, build_cherenkov_volume, build_flagship, cascade_source, track_line_source,
    )

    runs, gamma_paths, track_paths, curves, gamma_profiled = {}, {}, {}, {}, {}
    report_run_ = lambda *args, **kw: report_run(runs, batch, *args, **kw)
    for kind in ("muon", "cascade"):
        label = f"cherenkov-{kind}"
        tracer = build_cherenkov_volume(P, batch, device, source=kind)
        seconds_, sums_, counts_, peak_ = timed_runs(tracer, wrappers, label)
        per_batch = {k: v // 3 for k, v in counts_.items() if v}
        assert counts_["histogram_add"] == VOLUME_RECORDS * 3, per_batch
        assert per_batch.get("sample_gamma", 0) == (kind == "cascade"), per_batch
        prof = profile_step(tracer.run)
        report_run_(label, seconds_, per_batch, peak_, prof, f"; histogram sums {sums_}")
        if kind == "cascade":
            gamma_paths[label] = record_gamma_calls(tracer)
            gamma_profiled[label] = gamma_kernels(prof, per_batch["sample_gamma"])
        del tracer
        torch.cuda.empty_cache()

    lines = (
        ("cascade-backward", cascade_source(P)), ("track-backward", track_line_source(P, "track")),
        ("track-backward, 256 segments", track_line_source(P, "track", 256)),
        ("simple Cherenkov on the track's line", track_line_source(P, "simple")),
    )
    for label, source in lines:
        tracer = build_cherenkov_backward(P, batch, device, source=source)
        seconds_, curves_, counts_, peak_ = timed_runs(tracer, wrappers, label, light_curve, True)
        per_batch = {k: v // 3 for k, v in counts_.items() if v}
        calls = tracer.nScattering - 1  # one sample_backward a scattering vertex
        assert per_batch.get("sample_gamma", 0) == (calls if label.startswith("cascade") else 0), per_batch
        assert per_batch.get("track_backward_sample", 0) == (calls if label.startswith("track") else 0), per_batch
        curves[label] = sum(curves_) / len(curves_)
        prof = profile_step(tracer.run)
        report_run_(label, seconds_, per_batch, peak_, prof,
                    f"; light curve sum over {len(curves_)} batches {float(curves[label].sum()):.6g}")
        if label.startswith("cascade"):
            gamma_paths[label] = record_gamma_calls(tracer)
            gamma_profiled[label] = gamma_kernels(prof, calls)
        elif label.startswith("track"):
            track_paths[label] = record_track_calls(tracer)
        del tracer
        torch.cuda.empty_cache()
    simple = curves["simple Cherenkov on the track's line"]
    for label in ("track-backward", "track-backward, 256 segments"):
        ratio = float(curves[label].sum() / simple.sum())
        peaks = int(curves[label].argmax()), int(simple.argmax())
        runs[label].update(sum_over_simple=ratio, peak_bins=peaks)
        print(f"    {label}: light curve sum {ratio:.6f} of the simple source's on the same line, peak bin {peaks[0]} "
              f"(simple {peaks[1]})")
        assert abs(ratio - 1.0) < TRACK_SUM_RTOL and abs(peaks[0] - peaks[1]) <= TRACK_PEAK_BINS, (label, ratio, peaks)
    pair = float(curves["track-backward, 256 segments"].sum() / curves["track-backward"].sum())
    assert abs(pair - 1.0) < TRACK_SUM_RTOL, pair
    assert abs(int(curves["track-backward, 256 segments"].argmax()) - int(curves["track-backward"].argmax())) <= 1

    disk = build_flagship(P, mesh, batch, MAX_PATH, accel="auto", guide="disk", device=device)
    assert disk.scene.accel == "brute"
    seconds_, sums_, counts_, peak_ = timed_runs(disk, wrappers, "flagship-brute-disk-guide")
    per_batch = {k: v // 3 for k, v in counts_.items() if v}
    assert counts_["nearest_in_table_rows"] == MAX_PATH * 3 and counts_["target_in_table"] == (MAX_PATH - 1) * 3
    report_run_("flagship-brute-disk-guide", seconds_, per_batch, peak_, profile_step(disk.run),
                f"; histogram sums {sums_}")
    del disk
    torch.cuda.empty_cache()

    check_gamma(kernels["sample_gamma"], gamma_paths, gamma_profiled)
    check_track(kernels["track_backward_sample"], track_paths)
    for name in ("sample_gamma", "track_backward_sample"):
        launches = {label: info["launches_per_batch"].get(name, 0) for label, info in runs.items()}
        kernels[name].update(launches=3 * sum(launches.values()), launches_per_batch=launches,
                             path="phase 3m's runs, 3 batches each")
    return runs


# -- phase 3n: the last single-card modules --------------------------------

#: example 03's scatterings and batches of each source a schedule
PIPELINE_SCATTER, PIPELINE_BATCHES = 8, 4
#: the order of phase 3n's schedules in turns: 3 of each mode
PIPELINE_TURNS = ("sync", "threaded", "bare", "bare", "threaded", "sync", "sync", "threaded", "bare")
#: converge-brute's task: the total of one batch of 262,144 lanes scatters by about 3.7 %
#: (one H100 run), so the error of the mean falls below 1.5 % in about 6-10 batches
CONVERGE = dict(initialBatchCount=4, extraBatchCount=2, maxBatchCount=16, atol=0.0, rtol=1.5e-2)
#: batches before the checkpoint, and after it
CHECKPOINT_SPLIT = (2, 2)
#: render-flagship's view of the flagship (the renderer's default 1024 x
#: 1024 pixels), and the CPU comparison's width
RENDER_VIEW = dict(dimension=(5.0, 5.0), position=(1.5, -6.0, 0.5), direction=(0.0, 1.0, 0.0), up=(0.0, 0.0, 1.0),
                   maxDistance=20.0)
RENDER_SMALL = 128
#: two ranks' summed light curve against one card's run of the same lanes:
#: each bin within this share of the largest bin (each rank's record adds
#: its own lanes' tiles, then the states are summed: another order)
RANK_ORDER_RTOL = 1e-5


def sync_sites(fn):
    """(``fn()``, the places of the host syncs it made, "file:line" of the
    Python frame that made each), as torch's sync debug mode in its warning
    mode reports them on this thread."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # a sync reads "called a synchronizing CUDA operation"; torch's notice
    # that the mode is a prototype ("... does not yet detect all
    # synchronizing operations") is not one
    sync = "called a synchronizing"
    return out, [f"{Path(w.filename).name}:{w.lineno}" for w in caught if sync in str(w.message)]


def same_params(a, b, path: str = "") -> None:
    """Two params snapshots (a card's copied to the host, and the CPU
    tracer's): the same tree, each tensor of the same dtype, shape and
    values (NaN equal to NaN)."""
    import dataclasses

    import torch

    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            same_params(a[k], b[k], f"{path}/{k}")
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(a):
            same_params(getattr(a, f.name), getattr(b, f.name), f"{path}/{f.name}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a.nan_to_num(), b.nan_to_num()), path
    else:
        assert a == b, path


def count_syncs(fn):
    """(``fn()``, the host syncs it made): ``sync_sites`` counted."""
    out, sites = sync_sites(fn)
    return out, len(sites)


def record_digest(value, time_, mask):
    """An int64 fingerprint of one histogram record's inputs, made on the
    device with integer sums (which add in any order to the same bits):
    the kept lanes' count, the sums of their time and value bits, and the
    same weighted by lane number (1, 2, ...), which moves if two lanes
    trade their hits."""
    import torch

    m = mask.to(torch.int64)
    lane = torch.arange(1, m.shape[0] + 1, device=m.device)
    tb = time_.detach().contiguous().view(torch.int32).to(torch.int64) * m
    vb = value.detach().contiguous().view(torch.int32).to(torch.int64) * m
    return torch.stack([m.sum(), tb.sum(), vb.sum(), (tb * lane).sum(), (vb * lane).sum()])


class RecordDigests:
    """While active, every ``histogram_add`` call (on any thread) also
    appends :func:`record_digest` of its inputs, in call order, and the
    first ``keep`` calls' inputs as copies (``held`` holds them against the
    plain version). Launches made meanwhile count on the wrapper, not on
    the kernel's wrapper."""

    def __init__(self, keep: int = 0):
        self.keep, self.kept = keep, []

    def __enter__(self):
        from theia_tpu_torch import response

        self.digests, self.module, fn = [], response, response.histogram_add

        def wrapper(state, value, time_, mask, *args, **kw):
            self.digests.append(record_digest(value, time_, mask))
            if len(self.kept) < self.keep:
                copy = lambda a: a.detach().clone() if hasattr(a, "detach") else a
                self.kept.append(tuple(copy(a) for a in (value, time_, mask, *args, *kw.values())))
            return fn(state, value, time_, mask, *args, **kw)

        wrapper.launches, self.fn = fn.launches, fn
        response.histogram_add = wrapper
        return self

    def __exit__(self, *exc):
        self.module.histogram_add = self.fn

    def stacked(self):
        import torch

        return torch.stack(self.digests).cpu() if self.digests else torch.zeros((0, 5), dtype=torch.int64)

    def held(self, label) -> int:
        """The kept records held by ``hold_record`` (two launches the same
        bits, equal to the plain version on the CPU copy); their count."""
        for k, case in enumerate(self.kept):
            hold_record(case, f"{label}, record {k}")
        return len(self.kept)


def curves_twin(label, a, b, exact: bool = True) -> dict:
    """Two lists of light curves that traced the same records: how many
    bins differ in their bits (none where ``exact``: the records add in a
    fixed order on the card), and the largest difference over the largest
    bin, held within ``RANK_ORDER_RTOL`` where not ``exact``."""
    import numpy as np

    a, b = np.stack([np.asarray(x, np.float32) for x in a]), np.stack([np.asarray(x, np.float32) for x in b])
    assert a.shape == b.shape and np.isfinite(a).all() and a.sum() > 0, label
    bins = int((a.view(np.int32) != b.view(np.int32)).sum())
    rel = float(np.abs(a.astype(np.float64) - b).max() / np.abs(a).max())
    assert bins == 0 if exact else rel <= RANK_ORDER_RTOL, (label, bins, rel)
    return dict(bins_differing=bins, bins=int(a.size), max_rel=rel)


def pipeline_example03(runs, wrappers, smi, batch: int) -> None:
    """pipeline-example03: example 03's flash and beam at ``batch`` lanes,
    ``PIPELINE_BATCHES`` batches each, under ``PipelineScheduler`` in both
    modes and as a bare ``run()`` loop. The modes trace the same records
    bit for bit (``RecordDigests``) and give the same light curves bit for
    bit (so does a second synchronous schedule); then seconds a batch in
    turns, the host syncs of a launch (with their places) and of a wait,
    launches a batch and one profiled schedule."""
    import torch

    import theia_tpu_torch as P
    from theia_tpu_torch.pipeline import Pipeline, PipelineScheduler
    from torch_flagship import build_example03

    label = "pipeline-example03"
    flash, beam = build_example03(P, batch, PIPELINE_SCATTER, "cuda")
    pipes = [("flash", Pipeline(flash)), ("beam", Pipeline(beam))]
    n_batches = 2 * PIPELINE_BATCHES

    def rewind():
        flash.rng.offset = beam.rng.offset = 0

    def scheduled(threaded):
        rewind()
        curves = []
        PipelineScheduler(pipes, processFn=lambda c, b, r: curves.append(r[0]), dispatchThread=threaded).schedule(
            [("flash", {}), ("beam", {})] * PIPELINE_BATCHES)
        return curves

    def bare():
        rewind()
        return [t.run()[0].cpu().numpy() for _ in range(PIPELINE_BATCHES) for t in (flash, beam)]

    modes = {"sync": lambda: scheduled(False), "threaded": lambda: scheduled(True), "bare": bare}
    for fn in modes.values():
        fn()  # warm-up
    torch.cuda.synchronize()
    traced = {}
    records = 2 * PIPELINE_SCATTER + 1  # a volume batch's records: the direct light and two a scattering
    for name in ("sync", "threaded", "bare", "sync again"):
        with RecordDigests(keep=records if name == "sync" else 0) as d:
            curves = modes[name.split()[0]]()
        traced[name] = (d.stacked(), curves)
        held = d.held(f"{label} {name}") if name == "sync" else held
    digests = traced["sync"][0]
    assert digests.shape[0] == n_batches * records and int(digests[:, 0].sum()) > 0
    for name in ("threaded", "bare", "sync again"):
        assert torch.equal(traced[name][0], digests), f"{label}: {name} traced other records than sync"
    twins = {name: curves_twin(f"{label} {name}", traced["sync"][1], traced[name][1])
             for name in ("threaded", "bare", "sync again")}
    seconds = {name: [] for name in modes}
    for name in PIPELINE_TURNS:
        torch.cuda.synchronize()
        start = time.perf_counter()
        modes[name]()
        seconds[name].append((time.perf_counter() - start) / n_batches)
    rewind()
    pl = Pipeline(flash)
    launched, launch_sites = sync_sites(lambda: pl.launch({}))
    launch_syncs = len(launch_sites)
    _, wait_syncs = count_syncs(launched.materialize)
    _, bare_syncs = count_syncs(lambda: flash.run()[0].cpu())
    for w in wrappers.values():
        w.launches = 0
    scheduled(True)
    counts = {k: w.launches // n_batches for k, w in wrappers.items() if w.launches}
    assert counts["histogram_add"] == records, counts
    prof = profile_step(lambda: scheduled(False))
    busy = prof["device_busy_ms"] / n_batches
    med = {k: statistics.median(v) for k, v in seconds.items()}
    print(f"{label}: batch {batch} x {n_batches} batches a schedule [{smi}]: s/batch in turns (median of 3) sync "
          f"{med['sync']:.4f}, threaded {med['threaded']:.4f}, bare run() {med['bare']:.4f} (all {seconds}); "
          f"device busy {busy:.2f} ms a batch ({prof['kernels']} kernels and copies a schedule); launches a batch "
          f"{counts}; host syncs a batch: launch {launch_syncs} {launch_sites}, wait {wait_syncs}, bare run() with "
          f"its copy {bare_syncs}")
    for name, t in twins.items():
        print(f"    {name} against sync: the same {digests.shape[0]} records and light curves bit for bit "
              f"({t['bins_differing']} of {t['bins']} bins differ)")
    print(f"    the first batch's {held} records held against the plain version on the CPU, bit for bit, and "
          f"launched twice to the same bits")
    runs[label] = dict(seconds_per_batch=seconds, median=med, launches_per_batch=counts, device_busy_ms=busy,
                       host_syncs=dict(launch=launch_syncs, launch_sites=launch_sites, wait=wait_syncs,
                                       bare_run=bare_syncs),
                       records=int(digests.shape[0]), held_records=held, twins=twins, profile=prof, smi=smi)


def converge_brute(runs, wrappers, mesh, smi, batch: int) -> None:
    """converge-brute: ``ConvergeHistogramTask`` on the brute-force
    flagship under the threaded scheduler (its batches, final error,
    seconds and launches a batch, and one profiled batch);
    then 2 + 2 batches with a checkpoint between them, resumed by a fresh
    pipeline on a fresh tracer, against 4 without the break: the RNG
    cursor, the batch count, the resumed batches' records and the Welford
    result (mean light curve and error) bit for bit."""
    import tempfile

    import numpy as np
    import torch

    import theia_tpu_torch as P
    from theia_tpu_torch.pipeline import (
        ConvergeHistogramTask, Pipeline, PipelineScheduler, loadCheckpoint, saveCheckpoint,
    )
    from torch_flagship import build_flagship

    label = "converge-brute"
    tracer = build_flagship(P, mesh, batch, MAX_PATH, accel="auto", device="cuda")
    assert tracer.scene.accel == "brute"
    tracer.run()  # warm-up
    tracer.rng.offset = 0
    task = ConvergeHistogramTask(**CONVERGE)
    for w in wrappers.values():
        w.launches = 0
    start = time.perf_counter()
    PipelineScheduler(Pipeline(tracer)).schedule([task])
    elapsed = time.perf_counter() - start
    counts = {k: w.launches // task.totalBatches for k, w in wrappers.items() if w.launches}
    # the scheduler's batches take the staged route: the row-less scan, the shadow pairs, the segment kernels
    assert counts["nearest_in_table"] == MAX_PATH and counts["target_in_table"] == MAX_PATH - 1, counts
    assert counts["histogram_add"] == 2 * MAX_PATH - 1 and "nearest_in_table_rows" not in counts, counts
    assert [counts.get(name, 0) for name in SEGMENT_WRAPPERS] == [MAX_PATH] * 2 + [MAX_PATH - 1] * 2, counts
    prof = profile_step(tracer.run)
    # a Pipeline's launch of a staged batch waits for nothing on the card
    offset = tracer.rng.offset
    launched, launch_sites = sync_sites(lambda: Pipeline(tracer).launch({}))
    launched.materialize()
    tracer.rng.offset = offset
    assert not launch_sites, f"{label}: a staged batch's launch synced the host at {launch_sites}"
    rel = task.error / task._totalMean
    print(f"{label}: batch {batch} [{smi}]: {task.totalBatches} batches, converged {task.converged}, error "
          f"{task.error:.6g} ({rel:.3g} of the total {task._totalMean:.6g}; asked {CONVERGE['rtol']:g}), "
          f"{elapsed / task.totalBatches:.4f} s/batch over the task, launches a batch {counts}; one batch "
          f"profiled: device busy {prof['device_busy_ms']:.2f} ms, {prof['kernels']} kernels and copies; host syncs "
          f"of a Pipeline launch {len(launch_sites)}")

    def batches(pipe, task, n):
        for _ in range(n):
            task.processBatch(pipe.run())

    before, after = CHECKPOINT_SPLIT
    tracer.rng.offset = 0
    ref, ref_task = Pipeline(tracer), ConvergeHistogramTask(maxBatchCount=50)
    with RecordDigests(keep=2 * MAX_PATH - 1) as d_ref:
        batches(ref, ref_task, before + after)
    held = d_ref.held(f"{label}, the first batch")
    ref_offset = tracer.rng.offset
    tracer.rng.offset = 0
    first, first_task = Pipeline(tracer), ConvergeHistogramTask(maxBatchCount=50)
    batches(first, first_task, before)
    with tempfile.TemporaryDirectory() as tmp:
        saveCheckpoint(f"{tmp}/run.npz", first, first_task)
        resumed = Pipeline(build_flagship(P, mesh, batch, MAX_PATH, accel="auto", device="cuda"))
        resumed_task = ConvergeHistogramTask(maxBatchCount=50)
        loadCheckpoint(f"{tmp}/run.npz", resumed, resumed_task)
    assert resumed.tracer.rng.offset == first.tracer.rng.offset and resumed_task.totalBatches == before
    with RecordDigests() as d_res:
        batches(resumed, resumed_task, after)
    per_batch = d_ref.stacked().shape[0] // (before + after)
    assert per_batch == 2 * MAX_PATH - 1, per_batch
    assert torch.equal(d_res.stacked(), d_ref.stacked()[before * per_batch:]), f"{label}: resumed records differ"
    assert resumed_task.totalBatches == ref_task.totalBatches and resumed.tracer.rng.offset == ref_offset
    twin = curves_twin(f"{label} resumed", [ref_task.result], [resumed_task.result])
    err_rel = abs(resumed_task.error / ref_task.error - 1.0)
    print(f"    checkpoint after {before} batches, a fresh pipeline resumed {after}: RNG offset "
          f"{resumed.tracer.rng.offset} and {resumed_task.totalBatches} batches as without the break, the resumed "
          f"{after * per_batch} records, the mean light curve ({twin['bins_differing']} of {twin['bins']} bins "
          f"differ) and the error (relative difference {err_rel:.3g}) bit for bit; the first batch's {held} records "
          f"held against the plain version on the CPU, bit for bit")
    assert np.float64(resumed_task.error) == np.float64(ref_task.error), (resumed_task.error, ref_task.error)
    runs[label] = dict(batches=task.totalBatches, converged=task.converged, error=task.error, error_rel=rel,
                       seconds_per_batch=elapsed / task.totalBatches, launches_per_batch=counts, profile=prof,
                       launch_syncs=len(launch_sites),
                       resume=dict(twin, error_rel=err_rel), held_records=held, smi=smi)


def mesh_file_runs(runs, wrappers, mesh, smi, batch: int, cpu_vs_card: dict) -> None:
    """flagship-brute-from-stl and array-from-obj: the flagship's three
    meshes loaded from a binary STL that this run writes, against the same
    scene built in memory from the written float32 corners (the loaded
    arrays, every pack table and one batch's ``HitRecorder`` hits bit for
    bit, one histogram batch's records too), the same mesh from ASCII
    STL, PLY and OBJ (the arrays); example 08's 26-module array built by
    ``SceneTemplate.fromFile`` from an OBJ, against the array stamped in
    memory from the loaded mesh with the same stride (``"auto"`` picks the
    instanced walk; detector ids, pack tables and one batch bit for bit).
    Each timed as the other runs."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    import theia_tpu_torch as P
    from theia_tpu_torch.scene import MeshInstance, Transform
    from torch_flagship import (
        array_obj, build_array_from_template, build_flagship, write_obj, write_ply, write_stl,
    )

    report_run_ = lambda *args, **kw: report_run(runs, batch, *args, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        tri = write_stl(tmp / "sphere.stl", mesh)
        corners = (tri.reshape(-1, 3).astype(np.float64), np.arange(3 * len(tri)).reshape(-1, 3))
        written = P.mesh.Mesh.from_geometry(*corners)
        pos32 = (np.asarray(mesh[0], np.float32).astype(np.float64), mesh[1])
        indexed = P.mesh.Mesh.from_geometry(*pos32)
        write_stl(tmp / "ascii.stl", mesh, ascii=True)
        write_ply(tmp / "ascii.ply", mesh)
        write_ply(tmp / "binary.ply", mesh, binary=True)
        write_obj(tmp / "sphere.obj", [("sphere", "m", *mesh)])
        files = {"sphere.stl": written, "ascii.stl": written, "ascii.ply": indexed, "binary.ply": indexed,
                 "sphere.obj": indexed}
        for name, want in files.items():
            got = P.mesh.loadMesh(tmp / name)
            assert np.array_equal(got.vertices, want.vertices) and np.array_equal(got.indices, want.indices), name
        print(f"mesh files: {len(tri)} triangles loaded from {', '.join(files)}: the arrays equal Mesh.from_geometry "
              f"of the float32 values written, bit for bit")

        label = "flagship-brute-from-stl"
        hits = {}
        for kind, source in (("stl", tmp / "sphere.stl"), ("memory", corners)):
            t = build_flagship(P, source, batch, MAX_PATH, accel="auto", device="cuda", response=P.response.HitRecorder())
            assert t.scene.accel == "brute"
            hits[kind] = (t.scene.pack, t.run()[0])
        (pa, ha), (pb, hb) = hits["stl"], hits["memory"]
        for name in ("tri_data", "inst_data"):
            assert torch.equal(getattr(pa, name), getattr(pb, name)), name
        assert torch.equal(pa.soup.aos, pb.soup.aos)
        assert int(ha["valid"].sum()) > 0 and all(torch.equal(ha[k], hb[k]) for k in ha), f"{label}: hits differ"
        n_hits = int(ha["valid"].sum())
        del hits, pa, pb, ha, hb
        stl = build_flagship(P, tmp / "sphere.stl", batch, MAX_PATH, accel="auto", device="cuda")
        twin = build_flagship(P, corners, batch, MAX_PATH, accel="auto", device="cuda")
        traced = {}
        for kind, t in (("stl", stl), ("memory", twin)):
            with RecordDigests(keep=2 * MAX_PATH - 1 if kind == "stl" else 0) as d:
                curve = t.run()[0].cpu().numpy()
            t.rng.offset = 0
            traced[kind] = (d.stacked(), curve)
            held = d.held(f"{label}, a batch") if kind == "stl" else held
        assert torch.equal(traced["stl"][0], traced["memory"][0]), f"{label}: histogram records differ"
        hist_twin = curves_twin(label, [traced["stl"][1]], [traced["memory"][1]])
        del twin
        seconds_, sums_, counts_, peak_ = timed_runs(stl, wrappers, label)
        per_batch = {k: v // 3 for k, v in counts_.items() if v}
        report_run_(label, seconds_, per_batch, peak_, profile_step(stl.run),
                    f"; {n_hits} HitRecorder hits and {traced['stl'][0].shape[0]} histogram records bit for bit as "
                    f"the in-memory twin's, light curves differ in {hist_twin['bins_differing']} bins (bit for "
                    f"bit); {held} records held against the plain version on the CPU, bit for bit; [{smi}]")
        runs[label].update(hits=n_hits, histogram_twin=hist_twin, held_records=held, smi=smi)
        del stl
        torch.cuda.empty_cache()

        label = "array-from-obj"
        array_obj(tmp / "module.obj", mesh)
        tpl = P.render.SceneTemplate.fromFile(tmp / "module.obj")
        loaded = P.mesh.loadObjScene(tmp / "module.obj")[0]
        twin_tpl = P.render.SceneTemplate([MeshInstance("module", loaded.mesh, "det_shell", Transform(), 1)], idStride=1)
        ids = tpl.detectorIds(26)
        assert ids == twin_tpl.detectorIds(26) and sorted(ids.values()) == list(range(1, 27))
        a = build_array_from_template(P, tpl, batch, ARRAY_PATH, device="cuda")
        b = build_array_from_template(P, twin_tpl, batch, ARRAY_PATH, device="cuda")
        assert a.scene.accel == b.scene.accel == "instanced"
        assert [i.detectorId for i in a.scene.instances] == [i.detectorId for i in b.scene.instances]
        for name in ("tri_data", "inst_data"):
            assert torch.equal(getattr(a.scene.pack, name), getattr(b.scene.pack, name)), name
        ha, hb = a.run()[0], b.run()[0]
        assert int(ha["valid"].sum()) > 0 and all(torch.equal(ha[k], hb[k]) for k in ha), f"{label}: hits differ"
        n_hits = int(ha["valid"].sum())
        del b, ha, hb
        seconds_, sums_, counts_, peak_ = timed_runs(a, wrappers, label, recorded_total)
        per_batch = {k: v // 3 for k, v in counts_.items() if v}
        assert per_batch.get("nearest_triangle_instanced", 0) == ARRAY_PATH, per_batch
        report_run_(label, seconds_, per_batch, peak_, profile_step(a.run),
                    f"; {len(a.scene.instances)} modules, {int(a.scene.pack.tri_data.shape[0])} triangles, detector ids "
                    f"1-26 as the in-memory array's, {n_hits} hits of one batch bit for bit; [{smi}]")
        runs[label].update(hits=n_hits, smi=smi)
        del a
        torch.cuda.empty_cache()


def ocean_runs(runs, wrappers, smi, batch: int, cpu_vs_card: dict) -> None:
    """ocean-ff-volume (flagship-volume with ``FournierForandPhaseFunction
    (1.175, 4.065)`` in Henyey-Greenstein's place) and
    kokhanovsky-backward-pol (tests/test_polarized_backward.py's polarized
    ``VolumeBackwardTracer`` on ``PolWater``), each timed at ``batch``
    lanes and held against the CPU port at ``SMALL_BATCH`` by
    ``hold_cpu_vs_card``."""
    import torch

    import theia_tpu_torch as P
    from torch_flagship import build_pol_backward, build_volume_flagship, ff_water_medium

    report_run_ = lambda *args, **kw: report_run(runs, batch, *args, **kw)
    curve_total = lambda h, label: float(light_curve(h, label).sum())
    builds = {
        "ocean-ff-volume": lambda b, dev: build_volume_flagship(P, b, dev, medium=ff_water_medium(P.material)),
        "kokhanovsky-backward-pol": lambda b, dev: build_pol_backward(P, b, dev),
    }
    for label, build in builds.items():
        tracer = build(batch, "cuda")
        seconds_, sums_, counts_, peak_ = timed_runs(tracer, wrappers, label, curve_total)
        per_batch = {k: v // 3 for k, v in counts_.items() if v}
        assert per_batch.get("read_table", 0) > 0 and per_batch.get("histogram_add", 0) > 0, per_batch
        report_run_(label, seconds_, per_batch, peak_, profile_step(tracer.run), f"; light curve sums {sums_}; [{smi}]")
        del tracer
        torch.cuda.empty_cache()
        cpu_vs_card[label] = runs[label]["cpu_vs_card"] = hold_cpu_vs_card(label, lambda dev: build(SMALL_BATCH, dev))


def render_flagship(runs, wrappers, mesh, smi) -> None:
    """render-flagship: ``SceneRender`` at its default 1024 x 1024 pixels
    (1,048,576 rays) of the brute-force flagship scene, ms a render
    (median of 3 after a warm-up, the image copied to the host), launches
    and one profiled render; then the card's image at ``RENDER_SMALL``
    squared against the CPU port's: equal pixels except on at most 0.1 %
    of them, each within one level (grazing hits)."""
    import numpy as np
    import torch

    import theia_tpu_torch as P
    from torch_flagship import build_flagship

    label = "render-flagship"
    scene = build_flagship(P, mesh, 16, MAX_PATH, accel="auto", device="cuda").scene
    assert scene.accel == "brute"
    render = P.render.SceneRender(**RENDER_VIEW)
    assert (render.width, render.height) == (1024, 1024)
    img = render.render(scene)
    hit = float((img[..., :3].astype(int).sum(-1) < 3 * 255).mean())
    for w in wrappers.values():
        w.launches = 0
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        render.render(scene)
        ms.append(1e3 * (time.perf_counter() - start))
    counts = {k: w.launches // 3 for k, w in wrappers.items() if w.launches}
    assert counts.get("nearest_in_table_rows", 0) + counts.get("nearest_in_table", 0) == 1, counts
    prof = profile_step(lambda: render.render(scene))
    small = P.render.SceneRender(width=RENDER_SMALL, height=RENDER_SMALL, **RENDER_VIEW)
    card = small.render(scene)
    cpu = small.render(build_flagship(P, mesh, 16, MAX_PATH, accel="auto", device="cpu").scene)
    diff = np.abs(card.astype(int) - cpu.astype(int)).max(-1)
    share = float((diff > 0).mean())
    print(f"{label}: 1024 x 1024 rays [{smi}]: {statistics.median(ms):.3f} ms a render (median of "
          f"{[round(x, 3) for x in ms]}, image on the host), {hit:.4f} of the pixels hit, launches a render {counts}; "
          f"one render profiled: device busy {prof['device_busy_ms']:.3f} ms, {prof['kernels']} kernels and copies; "
          f"card against CPU at {RENDER_SMALL} x {RENDER_SMALL}: {int((diff > 0).sum())} pixels differ, by at most "
          f"{int(diff.max())} levels")
    for entry in prof["top"][:5] + prof["own"]:
        print(f"    {entry['ms']:9.3f} ms {entry['count']:6d} x {entry['name'][:90]}")
    assert share <= 1e-3 and diff.max() <= 1, (share, int(diff.max()))
    runs[label] = dict(ms=ms, hit_share=hit, launches_per_batch=counts, profile=prof,
                       cpu_vs_card=dict(pixels_differing=int((diff > 0).sum()), max_levels=int(diff.max())), smi=smi)


def single_card_runs(mesh, wrappers, smi, batch: int = BATCH) -> tuple[dict, dict]:
    """Phase 3n: the last single-card modules at ``batch`` lanes:
    pipeline-example03, converge-brute, ocean-ff-volume,
    kokhanovsky-backward-pol, flagship-brute-from-stl, array-from-obj and
    render-flagship, each with the card's name and power limit (``smi``)
    beside its numbers. Returns (runs, their CPU-against-card checks)."""
    runs, cpu_vs_card = {}, {}
    pipeline_example03(runs, wrappers, smi, batch)
    converge_brute(runs, wrappers, mesh, smi, batch)
    ocean_runs(runs, wrappers, smi, batch, cpu_vs_card)
    mesh_file_runs(runs, wrappers, mesh, smi, batch, cpu_vs_card)
    render_flagship(runs, wrappers, mesh, smi)
    return runs, cpu_vs_card


#: batches of flagship-brute in each schedule of the sharded pipeline's runs
SHARDED_BATCHES = 4
#: the sharded pipeline's schedules in turns: (pipeline, scheduler mode)
SHARDED_TURNS = (("plain", "sync"), ("sharded", "sync"), ("sharded", "threaded"), ("plain", "threaded"),
                 ("plain", "threaded"), ("sharded", "threaded"), ("sharded", "sync"), ("plain", "sync"))
#: gloo ranks sharing the one card, and the seconds a rank may take
GLOO_RANKS = 2
RANK_TIMEOUT = 300.0
#: bytes a lane that the wavefront sort must move: the rays read (o, d,
#: t_max: 28), the key, order and the rays' copy written (4 + 4 + 28)
SORT_LANE_BYTES = 28 + 36
#: bytes a lane of the scatter back: order and the query's t and idx read
#: (12), t and idx written (8); a winner's row of 32 floats read and
#: written where the query fetches rows
SCATTER_LANE_BYTES = 12 + 8
SCATTER_ROW_BYTES = 2 * 128
#: operations a lane of the key: three cells of a subtract, a divide, a
#: multiply, a cast and two clamps, the octant's three compares, the sums
SORT_KEY_FLOP = 3 * 6 + 3 + 6


def wild_sort_rays(n: int, seed: int, device="cuda"):
    """Rays for the sort's kernel checks, with bounds (lo, hi): origins
    around and in the bounds, NaN, infinite and huge origins, origins on a
    cell's edge, zero, negative-zero and NaN directions."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lo, hi = np.array([-1.0, -2.0, -1.5], np.float32), np.array([2.0, 1.0, 1.0], np.float32)
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    k = n // 16
    o[0:k, 0] = np.nan
    o[k:2 * k, 1] = np.inf
    o[2 * k:3 * k, 2] = -np.inf
    o[3 * k:4 * k] = rng.choice([1e30, -1e30, 3e9, -3e9], (k, 3))
    o[4 * k:5 * k] = rng.choice([-1.0, 2.0, 0.5, -0.25], (k, 3))
    d[5 * k:6 * k] = rng.choice([0.0, -0.0], (k, 3))
    d[6 * k:7 * k, 1] = np.nan
    t = rng.uniform(0.0, 10.0, n).astype(np.float32)
    return lo, hi, *(torch.as_tensor(a, device=device) for a in (o, d, t))


def same_sort(got, want) -> int:
    """The sort's outputs (key, order, origin, direction, t_max) against
    its plain twin's: the count of differing bits' elements (0 is
    bit-equal; NaNs compare by their bits)."""
    import torch

    bits = lambda x: x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x.to(torch.int32)
    return sum(int((bits(a).cpu() != bits(b).cpu()).sum()) for a, b in zip(got, want))


def check_sort_kernel() -> dict:
    """The sort and the scatter back against their plain twins on the card,
    bit for bit, on ``wild_sort_rays`` of 1, 1023-1025, 2047-2049, 100,003
    and 262,144 lanes and on a degenerate grid (lo = hi); the scatter with and
    without rows, and on an order of 0 lanes."""
    import torch

    from theia_tpu_torch.ops import _intersect_tiles as tiles

    checked = []
    for n in (1, 1023, 1024, 1025, 2047, 2048, 2049, 100_003, BATCH):
        for grid in ("bounds", "degenerate"):
            lo, hi, o, d, t = wild_sort_rays(n, n, "cuda")
            if grid == "degenerate":
                hi = lo
            got = tiles.sort_rays(lo, hi, o, d, t)
            want = tiles.sort_rays_plain(lo, hi, o, d, t)
            assert same_sort(got, want) == 0, f"the sort differs from its twin at {n} lanes ({grid})"
            assert same_sort(got[1:2], (torch.argsort(want[0].cpu(), stable=True),)) == 0
            t_s, idx_s = torch.rand(n, device=o.device), torch.randint(-1, 99, (n,), dtype=torch.int32, device=o.device)
            rows_s = torch.rand(n, 32, device=o.device)
            for outs in ((t_s, idx_s), (t_s, idx_s, rows_s)):
                back = tiles.scatter_back(got[1], *outs)
                plain = tiles.scatter_back_plain(got[1], *outs)
                assert all(torch.equal(a, b) for a, b in zip(back, plain)), f"the scatter differs at {n} lanes"
            checked.append((n, grid))
    empty = torch.empty(0, dtype=torch.int32, device=o.device)
    assert [x.shape[0] for x in tiles.scatter_back(empty, empty.float(), empty)] == [0, 0]
    torch.cuda.synchronize()
    print(f"kernels sort_rays and scatter_back (csrc/wavefront_sort.cu): the sort (key, order, the rays' copy) and "
          f"the scatter back "
          f"(with and without rows) bit-equal to their plain twins on {len(checked)} cases of 1-{BATCH} lanes with "
          f"NaN, infinite and huge origins, zero and NaN directions, on the scene's grid and a degenerate one; "
          f"order equal to torch.argsort(stable=True)")
    return dict(cases=checked)


def time_sort_path(reports: dict, runs: dict, paths: dict) -> None:
    """The wavefront sort on the recorded queries of one batch of each
    path (``paths``: label -> (pack, query, queries); ``query(o, d, t,
    binned)``): the sort's order, key and copy bit-equal to its plain twin
    and the binned winners (and rows) bit-equal to the unbinned ones; then
    each kernel as called and queued (its row in ``reports["sort_rays"]``
    and ``reports["scatter_back"]``: the mean a call), beside its plain
    twin, the library column (``torch.argsort(stable=True)`` with the
    rays' gathers; the outputs' ``index_copy_``) and the bound from the
    bytes forced; then each binned query against the unbinned one in
    turns, as called and queued (``runs``)."""
    import torch

    from theia_tpu_torch.ops import _intersect_tiles as tiles

    rows, every = {"sort_rays": {}, "scatter_back": {}}, {"sort_rays": [], "scatter_back": []}
    for label, (pack, query, queries) in paths.items():
        n_calls, lanes, calls = len(queries), [q[0].shape[0] for q in queries], []
        for o, d, t in queries:
            got = tiles.sort_rays(pack.lo, pack.hi, o, d, t)
            assert same_sort(got, tiles.sort_rays_plain(pack.lo, pack.hi, o, d, t)) == 0, label
            binned, plain = query(o, d, t, True), query(o, d, t, False)
            assert all(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
                       for a, b in zip(binned, plain)), f"{label}: binned winners differ"
            calls.append(dict(rays=(o, d, t), key=got[0], order=got[1], outs=plain, with_rows=len(plain) == 3))

        def sort(fn=tiles.sort_rays):
            for c in calls:
                fn(pack.lo, pack.hi, *c["rays"])

        def scatter(fn=tiles.scatter_back):
            for c in calls:
                fn(c["order"], *c["outs"])

        def sort_library():
            for c in calls:
                order = torch.argsort(c["key"], stable=True)
                o, d, t = (x[order] for x in c["rays"])

        def scatter_library():
            for c in calls:
                order = c["order"].long()
                for x in c["outs"]:
                    torch.empty_like(x).index_copy_(0, order, x)

        def queries_of(binned: bool):
            return lambda: [query(*c["rays"], binned) for c in calls]

        turns = {True: dict(ms=[], queued_ms=[]), False: dict(ms=[], queued_ms=[])}
        for binned in (False, True, True, False):
            turns[binned]["ms"].append(cuda_ms(queries_of(binned), 3) / n_calls)
            turns[binned]["queued_ms"].append(cuda_ms_queued(queries_of(binned), 3) / n_calls)
        q = {("binned" if k else "unbinned"): {m: statistics.median(v) for m, v in t.items()}
             for k, t in turns.items()}
        runs[f"{label}, binned / unbinned query in turns"] = dict(calls=n_calls, lanes=lanes, turns=turns)
        for name, run, plain, library, lane_bytes, flop in (
            ("sort_rays", sort, lambda: sort(tiles.sort_rays_plain), sort_library, lambda c: SORT_LANE_BYTES,
             SORT_KEY_FLOP),
            ("scatter_back", scatter, lambda: scatter(tiles.scatter_back_plain), scatter_library,
             lambda c: SCATTER_LANE_BYTES + SCATTER_ROW_BYTES * c["with_rows"], 0),
        ):
            bounds = [bound(c["rays"][0].shape[0] * lane_bytes(c), c["rays"][0].shape[0] * flop) for c in calls]
            r = rows[name][label] = dict(
                calls=n_calls, lanes=lanes, with_rows=calls[0]["with_rows"],
                ms=cuda_ms(run, 10) / n_calls,
                queued_ms=cuda_ms_queued(run, max(1, 100 // n_calls)) / n_calls,
                plain_ms=cuda_ms(plain, 3) / n_calls,
                library_ms=cuda_ms(library, 10) / n_calls,
                library_queued_ms=cuda_ms_queued(library, max(1, 24 // n_calls)) / n_calls,
                bound_ms=sum(b["bound_ms"] for b in bounds) / n_calls, bound_by=bounds[0]["bound_by"],
            )
            every[name] += bounds
            print(f"kernel {name} on {label}'s {n_calls} recorded queries ({lanes} rays"
                  f"{', with rows' if r['with_rows'] else ''}): {r['ms']:.4f} ms a call ({r['queued_ms']:.4f} queued), "
                  f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f} ({r['library_queued_ms']:.4f} queued); "
                  f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}, share {r['bound_ms'] / r['queued_ms']:.3f} queued")
        print(f"{label}: order, key and copy bit-equal to the plain twin, binned winners bit-equal to unbinned; the "
              f"query binned / unbinned in turns, ms a call: {q['binned']['ms']:.4f} / {q['unbinned']['ms']:.4f} as "
              f"called, {q['binned']['queued_ms']:.4f} / {q['unbinned']['queued_ms']:.4f} queued (all {turns})")
    library = dict(sort_rays="torch.argsort(key, stable=True) and the rays' gathers",
                   scatter_back="the outputs' index_copy_")
    for name, report in reports.items():
        paths_of = rows[name]
        n = sum(r["calls"] for r in paths_of.values())
        mean = lambda key: sum(r[key] * r["calls"] for r in paths_of.values()) / n
        report.update(max_abs_err=0.0, ms=mean("ms"), queued_ms=mean("queued_ms"), plain_ms=mean("plain_ms"),
                      bound_ms=sum(b["bound_ms"] for b in every[name]) / n, bound_by=every[name][0]["bound_by"],
                      library_ms=mean("library_ms"), library_queued_ms=mean("library_queued_ms"),
                      library=library[name], path_calls=n, paths=paths_of)


def sort_path_runs(runs, wrappers, kernels, mesh, smi, batch: int) -> dict:
    """(d) the wavefront sort's path: flagship-array (33,280 triangles) with
    ``accel="mt"`` and with ``accel="woop"``, one batch each at ``batch``
    lanes: the launches of the batch (the counts set to 0 just before it),
    then its recorded queries through ``time_sort_path``. The scenes are
    built with ``binned=True``: the port's queries do not sort by default.
    Returns the paths' (pack, query, queries) for the kernels' rows."""
    import torch

    import theia_tpu_torch as P
    from theia_tpu_torch.ops import _intersect_tiles as tiles
    from theia_tpu_torch.ops.intersect_mt import nearest_triangle_mt_rows
    from theia_tpu_torch.ops.intersect_woop import nearest_triangle_woop
    from torch_flagship import build_array

    paths, launched = {}, 0
    for accel, name in (("mt", "nearest_triangle_mt_rows"), ("woop", "nearest_triangle_woop")):
        label = f"flagship-array ({accel})"
        tracer = build_array(P, mesh, batch, ARRAY_PATH, accel=accel, device="cuda", binned=True)
        pack = tracer.scene.pack
        sub = pack.mt if accel == "mt" else pack.woop
        assert sub.binned and sub.n_tri == pack.tri_data.shape[0] >= tiles.BIN_THRESHOLD, sub.n_tri
        tracer.run()  # warm-up
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        start = time.perf_counter()
        result, _ = tracer.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = {k: w.launches for k, w in wrappers.items() if w.launches}
        # every query of the batch sorts its rays, runs the scan and scatters the winners back
        assert counts["sort_rays"] == counts["scatter_back"] == counts[name] == ARRAY_PATH, (label, counts)
        launched += counts["sort_rays"]
        detected = int(result["valid"].sum())
        assert detected > 0, label
        queries = record_queries(tracer, (name,))
        assert len(queries) == ARRAY_PATH, len(queries)
        if accel == "mt":
            query = lambda o, d, t, binned, p=sub, table=pack.tri_data: nearest_triangle_mt_rows(
                p, table, o, d, t, binned=binned)
        else:
            query = lambda o, d, t, binned, p=sub: nearest_triangle_woop(p, o, d, t, binned=binned)
        paths[label] = (sub, query, queries)
        print(f"{label}: batch {batch}, path length {ARRAY_PATH}, {sub.n_tri} triangles, Scene(binned=True) "
              f"[{smi}]: one batch {seconds:.4f} s, launches {counts}, {detected} detections")
        runs[label] = dict(seconds=seconds, launches=counts, detections=detected, smi=smi)
    for name in ("sort_rays", "scatter_back"):
        kernels[name].update(launches=launched, launches_per_batch=ARRAY_PATH,
                             path="flagship-array (binned=True) with accel='mt' and with accel='woop', a batch each")
    return paths


def sharded_pipeline_runs(runs, wrappers, mesh, smi, batch: int) -> None:
    """(a) flagship-brute at ``batch`` lanes through ``Pipeline(tracer,
    runner=ShardedRunner(tracer))`` over an NCCL process group of one
    (``file://`` rendezvous, destroyed after), ``SHARDED_BATCHES`` batches
    a schedule under ``PipelineScheduler`` synchronous and threaded, in
    turns with ``Pipeline(tracer)``: the records bit for bit
    (``RecordDigests``) and the light curves bit for bit, seconds a batch
    in each mode, the launches of a
    sharded schedule and the all-reduce's ms."""
    import tempfile

    import torch
    import torch.distributed as dist

    import theia_tpu_torch as P
    from theia_tpu_torch.pipeline import Pipeline, PipelineScheduler
    from torch_flagship import build_flagship

    label = "sharded-flagship-brute"
    with tempfile.TemporaryDirectory() as tmp:
        P.parallel.initialize(f"file://{tmp}/rendezvous", 1, 0, backend="nccl")
        try:
            assert dist.get_backend() == "nccl"
            tracer = build_flagship(P, mesh, batch, MAX_PATH, accel="auto", device="cuda")
            runner = P.parallel.ShardedRunner(tracer)
            assert runner.mesh.group is not None and runner.mesh.size == 1 and not runner.multihost
            pipes = {"sharded": Pipeline(tracer, runner=runner), "plain": Pipeline(tracer)}

            def schedule(kind, mode):
                tracer.rng.offset = 0
                curves = []
                PipelineScheduler(pipes[kind], processFn=lambda c, b, r: curves.append(r[0]),
                                  dispatchThread=mode == "threaded").schedule([{}] * SHARDED_BATCHES)
                return curves

            schedule("sharded", "sync")  # warm-up
            for w in wrappers.values():
                w.launches = 0
            schedule("sharded", "threaded")
            counts = {k: w.launches // SHARDED_BATCHES for k, w in wrappers.items() if w.launches}
            # ShardedRunner's batches take the staged route
            assert counts["nearest_in_table"] == MAX_PATH and counts["target_in_table"] == MAX_PATH - 1, counts
            assert [counts.get(name, 0) for name in SEGMENT_WRAPPERS] == [MAX_PATH] * 2 + [MAX_PATH - 1] * 2, counts
            traced, seconds = {}, {}
            for kind, mode in SHARDED_TURNS:
                torch.cuda.synchronize()
                with RecordDigests() as rec:
                    start = time.perf_counter()
                    curves = schedule(kind, mode)
                    torch.cuda.synchronize()
                    seconds.setdefault(f"{kind} {mode}", []).append((time.perf_counter() - start) / SHARDED_BATCHES)
                traced.setdefault(f"{kind} {mode}", []).append((rec.stacked(), curves))
            with RecordDigests(keep=2 * MAX_PATH - 1) as rec:
                schedule("sharded", "sync")
            held = rec.held(f"{label}, a sharded batch")
            ref_digests, ref_curves = traced["plain sync"][0]
            assert ref_digests.shape[0] == SHARDED_BATCHES * (2 * MAX_PATH - 1), ref_digests.shape
            twins = {}
            for key, tries in traced.items():
                for i, (dig, curves) in enumerate(tries):
                    assert torch.equal(dig, ref_digests), f"{label}: {key} traced other records"
                    if (key, i) != ("plain sync", 0):
                        twins[f"{key} #{i + 1}"] = curves_twin(f"{label} {key}", ref_curves, curves)
            x = torch.zeros(100, device=runner.mesh.device)
            reduce_ms = cuda_ms(lambda: dist.all_reduce(x, group=runner.mesh.group), 200)
        finally:
            dist.destroy_process_group()
    med = {k: statistics.median(v) for k, v in seconds.items()}
    worst = max(t["max_rel"] for t in twins.values())
    print(f"{label}: batch {batch}, path length {MAX_PATH}, {SHARDED_BATCHES} batches a schedule, ShardedRunner over "
          f"an NCCL group of one [{smi}]: s/batch in turns (median of 2): "
          + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
          + f" (all {seconds}); launches a sharded batch {counts}; the same {ref_digests.shape[0]} records bit for bit "
          f"and light curves bit for bit in every mode (largest difference {worst:.3g}); an all-reduce of the 100-bin "
          f"state "
          f"{reduce_ms:.4f} ms")
    print(f"    a sharded batch's {held} records held against the plain version on the CPU, bit for bit")
    runs[label] = dict(seconds_per_batch=seconds, median=med, launches_per_batch=counts,
                       records=int(ref_digests.shape[0]), held_records=held, twins=twins, all_reduce_ms=reduce_ms,
                       smi=smi)


def gloo_rank(rank: int, world: int, url: str, out: str) -> None:
    """(b) one gloo rank on the card, started by ``gloo_ranks_on_one_card``:
    its block of flagship-brute's ``BATCH`` lanes through ``shard_trace``
    (the summed histogram state, its lanes' RNG dims), and a sharded
    gradient step of sum(state) in the water's absorption at
    ``GRAD_BATCH`` lanes, path length ``GRAD_PATH``."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import torch

    import theia_tpu_torch as P
    import theia_tpu_torch.parallel  # noqa: F401
    from torch_flagship import build_flagship, icosphere

    P.parallel.initialize(url, world, rank, backend="gloo")
    try:
        mesh = P.parallel.make_photon_mesh(["cuda"])
        tracer = build_flagship(P, icosphere(3), BATCH, MAX_PATH, accel="auto", device="cuda")
        tracer._debug_rng = True
        fn = P.parallel.shard_trace(tracer, mesh)
        with torch.no_grad():
            assert tracer.segment_route == "stages"
            state, _, dims = fn(tracer.params(), tracer.rng.counter_words, P.parallel.sharded_streams(BATCH, mesh))
        small = build_flagship(P, icosphere(3), GRAD_BATCH, GRAD_PATH, accel="auto", device="cuda")
        steps = [absorption_grad(small, mesh) for _ in range(2)]
        loss, grad, _ = steps[0]
        torch.save(dict(state=state.cpu(), dims=dims.cpu(), loss=loss, grad=grad, steps=steps,
                        device=str(mesh.device), size=mesh.size), Path(out) / f"rank-{rank}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def gloo_ranks_on_one_card(runs, mesh, smi) -> None:
    """(b) ``GLOO_RANKS`` gloo ranks sharing the card (``torch.multiprocessing``
    spawn; NCCL takes one rank a card), each ``BATCH / GLOO_RANKS`` lanes:
    each rank's final RNG dims equal to the single run's slice bit for bit,
    the summed light curve within ``RANK_ORDER_RTOL`` of the single run's
    largest bin, and the sharded gradient step against the single one by
    ``gradient_agreement``'s limits. A rank that fails, or outlasts
    ``RANK_TIMEOUT``, fails the phase."""
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import theia_tpu_torch as P
    from torch_flagship import build_flagship

    label = "gloo-ranks-one-card"
    single = build_flagship(P, mesh, BATCH, MAX_PATH, accel="auto", device="cuda")
    single._debug_rng = True
    p = single.params()
    with torch.no_grad():
        state, _, dims = single._trace_batch(p, single.rng.counter_words, single.streams())
    state, dims = state.cpu(), dims.cpu()
    g_single = absorption_grad(build_flagship(P, mesh, GRAD_BATCH, GRAD_PATH, accel="auto", device="cuda"))[1]
    del single
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=gloo_rank, args=(r, GLOO_RANKS, f"file://{tmp}/rendezvous", tmp))
                 for r in range(GLOO_RANKS)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + RANK_TIMEOUT
        for proc in procs:
            proc.join(timeout=max(deadline - time.monotonic(), 1.0))
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        codes = [proc.exitcode for proc in procs]
        assert codes == [0] * GLOO_RANKS, f"{label}: the ranks exited with {codes}"
        ranks = [torch.load(Path(tmp) / f"rank-{r}.pt", weights_only=False) for r in range(GLOO_RANKS)]
    seconds = time.perf_counter() - start
    per = BATCH // GLOO_RANKS
    for r, got in enumerate(ranks):
        assert got["size"] == GLOO_RANKS and got["device"].startswith("cuda"), got["device"]
        assert torch.equal(got["dims"], dims[r * per:(r + 1) * per]), f"{label}: rank {r}'s RNG dims"
        assert torch.equal(got["state"].view(torch.int32), ranks[0]["state"].view(torch.int32)), label
        assert np.array_equal(got["grad"], ranks[0]["grad"]), label
        # two sharded steps after reduce_gradients: loss, gradient and state the same bits
        step_repeats(f"{label}, rank {r}", got["steps"])
    twin = curves_twin(label, [state.numpy()], [ranks[0]["state"].numpy()], exact=False)
    agreement = gradient_agreement(label, g_single, ranks[0]["grad"], "single against sharded")
    print(f"{label}: {GLOO_RANKS} gloo ranks on the card, {per} of flagship-brute's {BATCH} lanes each [{smi}], "
          f"{seconds:.1f} s with the ranks' start: each rank's RNG dims equal to the single run's slice, the summed "
          f"state within {twin['max_rel']:.3g} of its largest bin ({twin['bins_differing']} of {twin['bins']} bins "
          f"differ in their bits); the gradient step at batch {GRAD_BATCH}: worst entry {agreement['worst_entry_rel']:.3g}, "
          f"sum {agreement['sum_rel']:.3g} from the single step; two sharded steps the same bits (loss, gradient "
          f"after reduce_gradients, state) on every rank")
    runs[label] = dict(ranks=GLOO_RANKS, seconds=seconds, twin=twin, gradient=agreement, smi=smi)


def profile_batch_run(runs, mesh, smi, timed_median: float) -> None:
    """(c) ``profiling.profile_batch`` on flagship-brute: the trace file
    written and loadable, with the card's kernels in it, the statistics
    ordered; its fastest batch beside ``timed_runs``' median of phase 3d."""
    import json as json_
    import os
    import tempfile

    import theia_tpu_torch as P
    from torch_flagship import build_flagship

    label = "profile-batch-brute"
    tracer = build_flagship(P, mesh, BATCH, MAX_PATH, accel="auto", device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        stats = P.profiling.profile_batch(tracer, tmp, runs=2)
        files = [os.path.join(r, f) for r, _, fs in os.walk(tmp) for f in fs]
        assert len(files) == 1 and files[0].endswith(".pt.trace.json"), files
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json_.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    names = {e.get("name") for e in events}
    assert "theia_tpu_torch.batch" in names and kernels > 0, (kernels, len(events))
    assert 0 < stats["min"] <= stats["median"] <= stats["max"] and stats["bounces_per_s"] > 0, stats
    print(f"{label}: profile_batch(runs=2) [{smi}]: min {stats['min']:.4f} s, median {stats['median']:.4f} s a batch "
          f"under the profiler, against timed_runs' median {timed_median:.4f} s (phase 3d); trace {size / 2**20:.1f} MiB, "
          f"{len(events)} events, {kernels} kernels")
    runs[label] = dict(stats=stats, timed_runs_median=timed_median, trace_bytes=size, events=len(events),
                       kernels=kernels, smi=smi)


def last_slice_runs(mesh, wrappers, kernels, smi, brute_median: float, batch: int = BATCH) -> dict:
    """Phase 3o: the multi-device layer, profiling and the wavefront sort:
    (a) ``sharded_pipeline_runs``, (b) ``gloo_ranks_on_one_card``, (c)
    ``profile_batch_run``, (d) ``sort_path_runs`` with the sort's kernel
    checks (``check_sort_kernel``) and its rows (``time_sort_path``)."""
    import torch

    runs = {}
    sharded_pipeline_runs(runs, wrappers, mesh, smi, batch)
    torch.cuda.empty_cache()
    gloo_ranks_on_one_card(runs, mesh, smi)
    torch.cuda.empty_cache()
    profile_batch_run(runs, mesh, smi, brute_median)
    torch.cuda.empty_cache()
    paths = sort_path_runs(runs, wrappers, kernels, mesh, smi, batch)
    runs["sort kernel checks"] = check_sort_kernel()
    time_sort_path({name: kernels[name] for name in ("sort_rays", "scatter_back")}, runs, paths)
    del paths
    torch.cuda.empty_cache()
    return runs


# -- phase 3p: the flagship's segment as four kernels ------------------------

#: the segment's kernels (``trace/segment.py``, ``csrc/segment.cu``): each
#: wrapper's name and the part of ``_segment_body`` it replaces
SEGMENT_WRAPPERS = {
    "segment_pre": "theia_tpu/trace/scene.py:488",
    "segment_surface": "theia_tpu/trace/scene.py:547",
    "segment_scatter": "theia_tpu/trace/scene.py:751",
    "segment_shadow": "theia_tpu/trace/scene.py:390",
}
#: float32 operations a lane of each kernel does, counted from
#: ``csrc/segment.cu`` with a division, a square root or a transcendental as
#: one, and its Philox draws (the key once a lane, ``PHILOX_KEY_OPS``, then
#: ``PHILOX_DRAW_OPS`` a draw, on the integer pipe). K_pre: the health check
#: 14, the distance 6, the guide's cone 33 and eval 8, the tests 4; K_surface:
#: the winner's rebuild 150 (Moeller-Trumbore 38, the object point and normals
#: 42, the transforms 70), the extension 14, the propagation 30, the Fresnel
#: terms 30 and the read 12, the item 12, reflect and refract 60, the offsets
#: 12, the constants' read 20; K_scatter: two phase samples at 95 (the read,
#: scatter_dir's three normalizations and its frame), the guide's cone, sample
#: and eval 75, the phase read 12, the weights 12, the scatter's selects 6;
#: K_shadow (a shadow ray): the rebuild 150, the item 70.
SEGMENT_FLOP = {"segment_pre": 65, "segment_surface": 340, "segment_scatter": 295, "segment_shadow": 220}
SEGMENT_DRAWS = {"segment_pre": 1, "segment_surface": 1, "segment_scatter": 8, "segment_shadow": 0}
#: the launches a staged flagship-brute batch may make: 4 segment kernels,
#: the scan, the records and the shadow query a segment, and the initial rays
SEGMENT_LAUNCH_LIMIT = 250
SEGMENT_EDGE_LANES = 65_536


def _sync(t) -> None:
    """Wait for the card where ``t`` lies on it (the segment checks also
    run on the CPU, in tests/test_torch_segment_host.py)."""
    import torch

    if t.is_cuda:
        torch.cuda.synchronize()


def _clone_arg(a):
    """A copy of a segment wrapper's argument: tensors and the tensors of
    the per-lane dataclasses cloned, the batch's ``Setup`` kept."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.clone()
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{f.name: _clone_arg(getattr(a, f.name)) for f in dataclasses.fields(a)})
    return a


def _flat_outputs(out) -> list:
    """A segment wrapper's outputs as (name, tensor) pairs."""
    import torch

    if isinstance(out, torch.Tensor):
        return [("", out)]
    if isinstance(out, tuple):
        return [(f"{k}.{n}", t) for k, o in enumerate(out) for n, t in _flat_outputs(o)]
    if dataclasses.is_dataclass(out):
        return [(f.name, getattr(out, f.name)) for f in dataclasses.fields(out) if getattr(out, f.name) is not None]
    return []


def record_segment_calls(tracer) -> list:
    """(name, args) of every call one batch of ``tracer`` makes to the four
    segment wrappers, the arguments copied; the RNG offset put back."""
    import torch

    from theia_tpu_torch.trace import segment as seg

    calls, saved = [], {name: getattr(seg, name) for name in SEGMENT_WRAPPERS}

    def recording(name, fn):
        def wrapper(*args):
            calls.append((name, tuple(_clone_arg(a) for a in args)))
            return fn(*args)
        wrapper.launches = fn.launches  # a wrapper counts on the name it is called by
        return wrapper

    try:
        for name, fn in saved.items():
            setattr(seg, name, recording(name, fn))
        offset = tracer.rng.offset
        tracer.run()
        tracer.rng.offset = offset
    finally:
        for name, fn in saved.items():
            setattr(seg, name, fn)
    _sync(tracer.scene.pack.tri_data)
    return calls


def hold_segment_call(name, args) -> tuple[int, float]:
    """One segment kernel against its plain twin on the card, on the same
    inputs: (outputs compared, the largest absolute difference); raises on
    any bit that differs (a NaN equal to a NaN)."""
    import torch

    from theia_tpu_torch.trace import segment as seg

    got = _flat_outputs(getattr(seg, name)(*args))
    want = _flat_outputs(getattr(seg, f"{name}_plain")(*args))
    _sync(args[1].position)
    assert [n for n, _ in got] == [n for n, _ in want], (name, [n for n, _ in got], [n for n, _ in want])
    worst = 0.0
    for (field, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (name, field, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype == torch.float32:
            bad = same_bits(a, b)
            both = torch.isfinite(a) & torch.isfinite(b)
            if bool(both.any()):
                worst = max(worst, float((a[both] - b[both]).abs().max()))
        else:
            bad = int((a != b).sum())
        assert bad == 0, f"{name}: {field} differs from the plain twin on {bad} of {a.numel()} entries"
    return len(got), worst


def segment_edge_lanes(s, lanes, seed: int):
    """A segment's lanes at the edges of its physics, ``SEGMENT_EDGE_LANES``
    of them: a quarter inside the glass shells near their surfaces in the
    glass's medium (total internal reflection, grazing incidence), a quarter
    anywhere in and around the scene's box in a random medium (mismatches,
    out of the box, misses), a quarter from the batch's own lanes with some
    past ``maxTime``, and a quarter of dead lanes, NaN and infinite positions
    and directions, zero directions; random ``alive`` and ``allow`` on all."""
    import numpy as np
    import torch

    from theia_tpu_torch.material import packed_medium_constants
    from theia_tpu_torch.trace.segment import Lanes

    dev = lanes.position.device
    rng = np.random.default_rng(seed)
    n, q = SEGMENT_EDGE_LANES, SEGMENT_EDGE_LANES // 4
    media = s.pack.media
    glass = media.names.index(next(name for name in media.names if "bk7" in name.lower() or "glass" in name.lower()))
    unit = rng.normal(size=(n, 3))
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    direction = rng.normal(size=(n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    hi = s.pack.upper_bbox.cpu().numpy()
    position = np.empty((n, 3))
    # the glass shell: radii 0.75 to 0.8 around the light (3, 0, 0)
    position[:q] = (3.0, 0.0, 0.0) + unit[:q] * rng.uniform(0.7501, 0.7999, (q, 1))
    position[q:2 * q] = rng.uniform((-2.0, -2.0, -2.0), (6.0, 5.0, 2.0), (q, 3))
    # an eighth of them at the propagation box's face, heading out, and an eighth beyond it
    edge = slice(q, q + q // 8)
    position[edge] = hi * rng.uniform(0.9995, 0.99999, (q // 8, 3))
    direction[edge] = np.abs(direction[edge])
    position[q + q // 8:q + q // 4] = hi * 1.5
    k = rng.integers(0, lanes.wavelength.shape[0], n - 2 * q)
    position[2 * q:] = lanes.position[torch.as_tensor(k, device=dev)].cpu().numpy()
    direction[2 * q:] = lanes.direction[torch.as_tensor(k, device=dev)].cpu().numpy()
    medium = rng.integers(0, len(media.names), n)
    medium[:q] = glass
    medium[2 * q:3 * q] = lanes.medium[torch.as_tensor(k[:q], device=dev)].cpu().numpy()
    bad = slice(3 * q, n)
    position[bad][rng.random(q) < 0.25] = np.nan
    direction[bad][rng.random(q) < 0.25] = np.inf
    direction[bad][rng.random(q) < 0.25] = 0.0
    alive = rng.random(n) < 0.9
    alive[bad] = rng.random(q) < 0.5
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()
    wavelength = f32(rng.uniform(300.0, 700.0, n))
    medium_t = torch.as_tensor(medium.astype(np.int32), device=dev)
    c = packed_medium_constants(media, medium_t, wavelength)
    time = rng.uniform(0.0, 50.0, n)
    time[2 * q:3 * q][rng.random(q) < 0.25] = 1e6  # past maxTime
    out = Lanes(
        position=f32(position), direction=f32(direction), wavelength=wavelength, time=f32(time),
        lin=f32(rng.uniform(0.0, 2.0, n)), log=f32(rng.normal(0.0, 1.0, n)), n=c.n.contiguous(),
        vg=c.vg.contiguous(), mu_s=c.mu_s.contiguous(), mu_e=c.mu_e.contiguous(), medium=medium_t,
        alive=torch.as_tensor(alive, device=dev), allow=torch.as_tensor(rng.random(n) < 0.7, device=dev),
        stream=torch.arange(n, dtype=torch.int32, device=dev),
        dim=torch.as_tensor(rng.integers(0, 60, n).astype(np.int32), device=dev),
    )
    return out


def hold_segment_edges(s, lanes, seed: int) -> dict:
    """The four kernels against their twins on ``segment_edge_lanes``, one
    segment through its scans, and what the lanes met (counted by the
    twins' own helpers)."""
    import torch

    from theia_tpu_torch import accel
    from theia_tpu_torch.trace import scene as tscene
    from theia_tpu_torch.trace import segment as seg

    edge = segment_edge_lanes(s, lanes, seed)
    pre = seg.segment_pre_plain(s, edge)
    hold_segment_call("segment_pre", (s, edge))
    t_hit, tri = seg._nearest(s.pack, edge.position, edge.direction, pre.t_max)
    hold_segment_call("segment_surface", (s, edge, pre, t_hit, tri))
    after, miss, _ = seg.segment_surface_plain(s, edge, pre, t_hit, tri)
    hold_segment_call("segment_scatter", (s, after, miss))
    after, shadow = seg.segment_scatter_plain(s, after, miss)
    t2, tri2 = seg._target(s.pack, shadow.origin, shadow.direction, shadow.t_max, shadow.active)
    hold_segment_call("segment_shadow", (s, after, shadow, t2, tri2))
    # what the lanes met
    hit = accel._reconstruct_hit(s.pack, edge.medium, edge.position, edge.direction, t_hit, tri)
    _, n_t, _, _ = tscene._fresnel(s.pack, edge.ray(), hit)
    cos_i = tscene.dot(edge.direction, hit.ray_nrm).clamp(-1.0, 1.0)
    sin_t = tscene.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0)) * edge.n / n_t
    live = pre.alive & hit.valid
    met = dict(
        lanes=SEGMENT_EDGE_LANES, dead=int((~pre.alive).sum()), nan_or_inf=int((~torch.isfinite(edge.position).all(1)
                                                                              | ~torch.isfinite(edge.direction).all(1)).sum()),
        misses=int((pre.alive & ~hit.valid).sum()), media_mismatch=int((live & (hit.error != 0)).sum()),
        total_internal_reflection=int((live & (hit.error == 0) & (sin_t >= 1.0)).sum()),
        grazing=int((live & (cos_i.abs() < 0.05)).sum()),
        out_of_box=int(((edge.position < s.pack.lower_bbox) | (edge.position > s.pack.upper_bbox)).any(1).sum()),
        past_max_time=int((edge.time > s.prop.max_time).sum()),
        shadow_rays_recorded=int(seg.segment_shadow_plain(s, after, shadow, t2, tri2).mask.sum()),
    )
    assert all(v > 0 for v in met.values()), f"an edge case met no lane: {met}"
    return met


def segment_bound(name: str, args) -> dict:
    """The least time of one call: every lane array the kernel reads once
    and each array it stores written once (not the outputs that are its
    inputs passed through, such as K_scatter's position or K_surface's
    wavelength), the scene's rows and the tables it reads once, against its
    float32 operations and Philox's integer ones (``SEGMENT_FLOP``,
    ``SEGMENT_DRAWS``)."""
    import torch

    from theia_tpu_torch.trace import segment as seg

    s, lanes = args[0], args[1]
    n = lanes.wavelength.shape[0]
    reads, kinds = {
        "segment_pre": (("position", "direction", "mu_s", "alive", "allow", "stream", "dim"), ()),
        "segment_surface": (("position", "direction", "wavelength", "time", "lin", "log", "n", "vg", "mu_s", "mu_e",
                             "medium", "allow", "stream"),
                            ("refractive_index", "absorption_coef", "scattering_coef", "group_velocity")),
        "segment_scatter": (("position", "direction", "lin", "log", "mu_s", "medium", "stream", "dim"),
                            ("phase_sampling", "log_phase_function")),
        "segment_shadow": (("wavelength", "time", "n", "vg", "mu_e"), ("refractive_index",)),
    }[name]
    in_bytes = sum(getattr(lanes, f).numel() * getattr(lanes, f).element_size() for f in reads)
    for a in args[2:]:
        parts = [a] if isinstance(a, torch.Tensor) else (
            [getattr(a, f.name) for f in dataclasses.fields(a) if f.name != "t_max" or name != "segment_shadow"]
            if dataclasses.is_dataclass(a) else [])
        in_bytes += sum(t.numel() * t.element_size() for t in parts if isinstance(t, torch.Tensor))
    # the kernel's outputs that are not its inputs: what it stores (a launch of the wrapper, not counted)
    fn = getattr(seg, name)
    launches, given = fn.launches, {t.data_ptr() for a in args[1:] for _, t in _flat_outputs(a)}
    stored = [t for _, t in _flat_outputs(fn(*args)) if t.data_ptr() not in given]
    fn.launches = launches
    out_bytes = sum(t.numel() * t.element_size() for t in stored)
    media = s.pack.media
    tables = sum(media.tables[k].numel() * 4 + media.sizes[k].numel() * 4 for k in kinds)
    rows = (s.pack.tri_data.numel() + s.pack.inst_data.numel()) * 4 if name in ("segment_surface", "segment_shadow") else 0
    lanes_done = 2 * n if name == "segment_shadow" else n
    int_ops = (PHILOX_KEY_OPS + SEGMENT_DRAWS[name] * PHILOX_DRAW_OPS) * n if SEGMENT_DRAWS[name] else 0
    total_bytes = in_bytes + out_bytes + tables + rows
    by_bytes = total_bytes / PEAK_BYTES * 1e3
    by_ops = (SEGMENT_FLOP[name] * lanes_done / PEAK_F32 + int_ops / PEAK_I32) * 1e3
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_bytes=total_bytes, bound_stored_bytes=out_bytes, bound_flop=SEGMENT_FLOP[name] * lanes_done,
                bound_int_ops=int_ops)


def segment_routes_equal(label, build) -> dict:
    """One batch of ``build()``'s tracer on each route, the staged one
    first: the light curves, every lane's final dim and each segment's end
    state bit for bit (a NaN equal to a NaN)."""
    import torch

    out = {}
    for staged in (True, False):
        tracer = build()
        tracer._debug_rng, tracer._debug_segments = True, []
        assert tracer.segment_route == "eager"  # autograd is on out here
        with torch.no_grad():
            assert tracer.segment_route == "stages", tracer.segment_route
            trace = tracer._trace_batch if staged else tracer._trace_batch_eager
            state, _, dims = trace(tracer.params(), tracer.rng.counter_words, tracer.streams())
        _sync(state)
        out[staged] = (state, dims, tracer._debug_segments)
        del tracer
    (h_s, d_s, seg_s), (h_e, d_e, seg_e) = out[True], out[False]
    assert same_bits(h_s, h_e) == 0, f"{label}: the staged light curve differs from the eager one"
    assert torch.equal(d_s, d_e), f"{label}: final dims differ on {int((d_s != d_e).sum())} lanes"
    assert len(seg_s) == len(seg_e) == MAX_PATH
    fields_checked = 0
    for k, (a, b) in enumerate(zip(seg_s, seg_e)):
        for name in a:
            x, y = a[name], b[name]
            bad = same_bits(x, y) if x.dtype == torch.float32 else int((x != y).sum())
            assert bad == 0, f"{label}: segment {k} {name} differs on {bad} entries"
            fields_checked += 1
    print(f"segment routes ({label}): light curve (sum {float(h_s.sum()):.6g}), {d_s.numel()} final dims and "
          f"{fields_checked} per-segment state arrays of {len(seg_s)} segments bit for bit, staged = eager")
    return dict(light_curve_sum=float(h_s.sum()), dims=int(d_s.numel()), state_arrays=fields_checked)


def segment_runs(mesh, wrappers, kernels, smi, batch: int = BATCH) -> dict:
    """Phase 3p: the staged route (``trace/segment.py``) on flagship-brute
    and flagship-mt at full width: (a) every kernel call of one batch
    against its plain twin bit for bit, and the edge lanes; (b) the routes
    bit for bit; (c) seconds a batch in turns (eager, stages, stages,
    eager) with the launches of the timed batches; (d) one profiled batch
    of each route; (e) each kernel's ms as called and queued, its plain
    twin's, its bound. Phase 4 holds the staged route of both against the
    CPU port's at batch 4096 by ``PERF.md`` section 2's limits."""
    import contextlib

    import torch

    import theia_tpu_torch
    from theia_tpu_torch.trace import segment as seg
    from torch_flagship import build_flagship, eager_route

    runs = {}
    builders = {
        "flagship-brute": lambda dev="cuda", n=batch: build_flagship(theia_tpu_torch, mesh, n, MAX_PATH, accel="auto",
                                                                     device=dev),
        "flagship-mt": lambda dev="cuda", n=batch: build_flagship(theia_tpu_torch, mesh, n, MAX_PATH, device=dev),
    }
    route = lambda tracer, staged: contextlib.nullcontext() if staged else eager_route(tracer)
    wrappers = {**wrappers, **{name: getattr(seg, name) for name in SEGMENT_WRAPPERS}}
    for label, build in builders.items():
        report = runs[label] = {}
        tracer = build()
        # (a) every call of one batch, and the edge lanes
        calls = record_segment_calls(tracer)
        by_name = {name: [a for n, a in calls if n == name] for name in SEGMENT_WRAPPERS}
        assert [len(by_name[n]) for n in SEGMENT_WRAPPERS] == [MAX_PATH, MAX_PATH, MAX_PATH - 1, MAX_PATH - 1], \
            {n: len(v) for n, v in by_name.items()}
        compared, worst = 0, 0.0
        for name, args in calls:
            k, w = hold_segment_call(name, args)
            compared, worst = compared + k, max(worst, w)
        s, mid = by_name["segment_scatter"][MAX_PATH // 2][:2]
        edges = hold_segment_edges(s, mid, seed=11 if label == "flagship-brute" else 12)
        print(f"segment kernels ({label}): the {len(calls)} calls of one batch ({compared} outputs) and "
              f"{SEGMENT_EDGE_LANES} edge lanes ({edges}) bit for bit against the plain twins")
        report.update(calls=len(calls), outputs_compared=compared, edges=edges)
        # (b) the routes
        report["routes_equal"] = segment_routes_equal(label, build)
        # (c) seconds in turns, with the launches of the staged turns' batches
        turns = []
        for staged in (False, True, True, False):
            with route(tracer, staged):
                secs, sums, counts, peak = timed_runs(tracer, wrappers, label)
            turns.append(dict(route="stages" if staged else "eager", seconds_per_batch=secs, histogram_sums=sums,
                              peak_bytes=peak, launches={k: v // 3 for k, v in counts.items() if v}))
            if staged:
                for name in SEGMENT_WRAPPERS:
                    assert counts[name] == 3 * len(by_name[name]), (name, counts)
                if label == "flagship-brute":
                    for name in SEGMENT_WRAPPERS:
                        kernels[name].update(launches=counts[name], launches_per_batch=counts[name] // 3,
                                             path="flagship-brute on the staged route, 3 batches")
            else:
                assert not any(counts[name] for name in SEGMENT_WRAPPERS), counts
        report["turns"] = turns
        med = {r: statistics.median([x for t in turns if t["route"] == r for x in t["seconds_per_batch"]])
               for r in ("eager", "stages")}
        peaks = {r: max(t["peak_bytes"] for t in turns if t["route"] == r) for r in ("eager", "stages")}
        # (d) one profiled batch of each route
        profiles = {}
        for staged in (False, True):
            with route(tracer, staged):
                profiles["stages" if staged else "eager"] = profile_step(lambda: tracer.run(advance=False))
        report["profiles"] = profiles
        launches = {r: p["kernels"] for r, p in profiles.items()}
        print(f"segment routes ({label}), in turns eager/stages/stages/eager: "
              + "; ".join(f"{t['route']} {statistics.median(t['seconds_per_batch']):.4f} s "
                          f"{[round(x, 4) for x in t['seconds_per_batch']]}" for t in turns)
              + f"; median eager {med['eager']:.4f} s, stages {med['stages']:.4f} s ({med['eager'] / med['stages']:.2f}x); "
              f"peak memory eager {peaks['eager'] / 2**20:.1f} MiB, stages {peaks['stages'] / 2**20:.1f} MiB; "
              f"one batch profiled: eager {profiles['eager']['device_busy_ms']:.2f} ms busy in {launches['eager']} "
              f"kernels, stages {profiles['stages']['device_busy_ms']:.2f} ms in {launches['stages']}; {smi}")
        for entry in profiles["stages"]["top"][:10]:
            print(f"    {entry['ms']:9.3f} ms {entry['count']:6d} x {entry['name'][:90]}")
        if label == "flagship-brute":
            assert launches["stages"] <= SEGMENT_LAUNCH_LIMIT, f"a staged batch made {launches['stages']} launches"
        report.update(median_seconds=med, peak_bytes=peaks, launches=launches)
        # (e) each kernel on the batch's middle call, and a batch's calls queued
        if label == "flagship-brute":
            for name in SEGMENT_WRAPPERS:
                args = by_name[name][len(by_name[name]) // 2]
                fn, plain = getattr(seg, name), getattr(seg, f"{name}_plain")
                saved = fn.launches
                ms = cuda_ms(lambda: fn(*args), 20)
                queued = cuda_ms_queued(lambda: fn(*args), 20)
                batch_queued = sum(cuda_ms_queued(lambda a=a: fn(*a), 5) for a in by_name[name])
                plain_ms = cuda_ms(lambda: plain(*args), 3)
                fn.launches = saved
                b = segment_bound(name, args)
                assert fn.launches == saved
                kernels[name].update(
                    max_abs_err=worst, ms=ms, queued_ms=queued, ms_a_batch_queued=batch_queued, plain_ms=plain_ms,
                    library_ms=None, library="none: no PyTorch call computes a segment", **b,
                )
                print(f"kernel {name} (N = {batch}{', 2N shadow rays' if name == 'segment_shadow' else ''}): "
                      f"{ms:.4f} ms as called, {queued:.4f} queued, a batch's {len(by_name[name])} calls "
                      f"{batch_queued:.4f} queued; plain twin {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms by "
                      f"{b['bound_by']} ({b['bound_bytes'] / 2**20:.1f} MiB, {b['bound_stored_bytes'] / 2**20:.1f} MiB "
                      f"of it stored, {b['bound_flop']:.3g} flop, "
                      f"{b['bound_int_ops']:.3g} int ops), share {b['bound_ms'] / queued:.3f} queued, "
                      f"{b['bound_ms'] / ms:.3f} as called")
        del calls, by_name, tracer, s, mid
        torch.cuda.empty_cache()
    return runs


def hold_cpu_vs_card(label, build) -> dict:
    """One batch of ``build(device)``'s tracer on the CPU and on the card,
    held by ``PERF.md``'s histogram agreement: the lanes' RNG dims equal on
    at least 99.5 % of them, the histograms' sums within 1e-3 and their
    per-bin L1 within 1 %, or a ``HitRecorder``'s detections the same in
    number with sorted times within 1e-5 relative."""
    import torch

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
        return dict(dims_equal=same, detections=n_kept, time_rel=t_rel)
    hists = {dev: r.double().cpu() for dev, r in results.items()}
    assert float(hists["cpu"].sum()) > 0.0, f"empty light curve ({label})"
    d_sum = abs(float(hists["cuda"].sum() / hists["cpu"].sum()) - 1.0)
    l1 = float((hists["cuda"] - hists["cpu"]).abs().sum() / hists["cpu"].sum())
    print(f"cpu vs card ({label}) at batch {SMALL_BATCH}: rng dims equal {same:.6f}, "
          f"histogram sum rel diff {d_sum:.3g}, per-bin L1 {l1:.3g}")
    assert same >= 0.995 and d_sum <= 1e-3 and l1 <= 1e-2, f"cpu and card disagree ({label})"
    return dict(dims_equal=same, sum_rel=d_sum, l1=l1)


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
    from theia_tpu_torch.ops.bvh_traverse import nearest_triangle_bvh, occluded_bvh
    from theia_tpu_torch.ops.instanced import nearest_triangle_instanced, occluded_instanced
    from theia_tpu_torch.random import philox_uniform, sobol_owen_uniform
    from theia_tpu_torch.ops.cherenkov_track import track_backward_sample
    from theia_tpu_torch.ops.gamma import sample_gamma
    from theia_tpu_torch.ops._intersect_tiles import scatter_back, sort_rays
    from theia_tpu_torch.ops import table_read
    from theia_tpu_torch.response import histogram_add, histogram_grad
    from theia_tpu_torch.response import (
        KernelHistogramHitResponse, StoreTimeHitResponse, kernel_histogram_add, kernel_histogram_grad,
    )
    from torch_flagship import (
        adversarial_rays, build_array, build_backward_eta2, build_bidirectional, build_cherenkov_backward,
        build_cherenkov_volume, build_direct, build_flagship, build_photon_flagship, build_scene_backward,
        build_scene_backward_target, build_volume_backward, build_volume_flagship, build_volume_photon, cascade_source,
        eager_route, icosphere, track_line_source,
    )
    from theia_tpu_torch.trace import segment

    # the seconds of each phase, printed as it ends
    clock = {"1": time.perf_counter()}

    def phase(name: str) -> None:
        last = list(clock)[-1]
        clock[name] = lap_clock[0] = time.perf_counter()
        print(f"phase {last}: {clock[name] - clock[last]:.1f} s")

    lap_clock, laps = [time.perf_counter()], {}

    def lap(what: str) -> None:
        """The seconds since the last lap, inside a phase."""
        now = time.perf_counter()
        print(f"    ({what}: {now - lap_clock[0]:.1f} s)")
        laps[what] = now - lap_clock[0]
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
    # the SASS of the kernels redesigned last: the records and the backward kernels on their order (their sources),
    # the sort's scatter, the Sobol fold, the gamma draw and the track's one pass
    sass = sass_report(lib, ("record_tiles", "scatter_rays", "sobol_uniform", "sample_gamma", "track_sample",
                             "gather_grad", "lanes_only"))
    for fn, info in sass.items():
        print(f"sass {fn}: {info['instructions']} instructions, atomics {info['atomics']}, most used {info['opcodes']}")

    phase("2")
    # phase 2: kernels against their plain versions at the main path's shapes. The flagship batches recorded
    # here run the eager segment (eager_route), whose reads, draws, queries and records phase 2 replays; phase
    # 3p holds the staged route's calls
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
        "sobol_owen_uniform": dict(
            route="cuda", source="theia_tpu_torch/csrc/sobol.cu",
            replaces="theia_tpu/random.py:385",
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
        **{
            name: dict(route="cuda", source=source, replaces=replaces)
            for name, (source, replaces) in WALK_KERNELS.items()
        },
        "sample_gamma": dict(
            route="cuda", source="theia_tpu_torch/csrc/gamma.cu", replaces="theia_tpu/ops/gamma.py:22",
        ),
        "track_backward_sample": dict(
            route="cuda", source="theia_tpu_torch/csrc/cherenkov_track.cu", replaces="theia_tpu/light.py:654",
        ),
        "sort_rays": dict(
            route="cuda", source="theia_tpu_torch/csrc/wavefront_sort.cu",
            replaces="theia_tpu/ops/_intersect_tiles.py:203",
        ),
        "scatter_back": dict(
            route="cuda", source="theia_tpu_torch/csrc/wavefront_sort.cu",
            replaces="theia_tpu/ops/_intersect_tiles.py:209",
        ),
        **{
            name: dict(route="cuda", source="theia_tpu_torch/csrc/segment.cu", replaces=replaces)
            for name, replaces in SEGMENT_WRAPPERS.items()
        },
    }
    rows = tracer.scene.pack.tri_data[:, 18:27].cpu().numpy()
    adversarial = tuple(
        torch.as_tensor(a, device="cuda")
        for a in (*adversarial_rays(rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], seed=7, per_kind=512),)
    )
    adversarial += (torch.full((adversarial[0].shape[0],), torch.inf, device="cuda"),)
    with eager_route(tracer):
        mt_queries = record_queries(tracer, ("nearest_triangle_mt_rows",))
        mt_records = record_records(tracer)
    woop_queries = record_queries(pol_tracer, ("nearest_triangle_woop",))
    assert len(mt_queries) == len(woop_queries) == 2 * MAX_PATH - 1, (len(mt_queries), len(woop_queries))
    woop_records = record_records(pol_tracer)
    # fused: 10 of N lanes, 9 of 2 N; polarized, unfused: the extension, the surface and two shadow halves
    assert sorted(r[2].shape[0] for r in mt_records) == [BATCH] * MAX_PATH + [2 * BATCH] * (MAX_PATH - 1)
    assert [r[2].shape[0] for r in woop_records] == [BATCH] * POL_RECORDS, len(woop_records)
    lap("recording the flagship batches")
    scan_memo = {}
    for name, queries in (
        ("nearest_triangle_mt", mt_queries),
        ("nearest_triangle_woop", woop_queries),
        ("nearest_triangle_mt_rows", mt_queries),
    ):
        scene_pack = (pol_tracer if name == "nearest_triangle_woop" else tracer).scene.pack
        nearest = Nearest(name, scene_pack)
        check_nearest(nearest, adversarial, queries, kernels[name], scan_memo)
        if name == "nearest_triangle_mt_rows":
            abc_experiment(nearest, kernels[name])
    del mt_queries, woop_queries, queries, nearest, scan_memo
    lap("the three nearest-hit kernels")
    soup_rows = brute_tracer.scene.pack.tri_data[:, 18:27].cpu().numpy()
    assert (soup_rows[:, 0:3] != rows[:, 0:3]).any(), "the brute-force soup is in instance order, not Morton order"
    # the 10 primary queries (every group, no mask) and the 9 shadow pairs (the detector, masked)
    with eager_route(brute_tracer):
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
    soup_memo = {}
    for name in SOUP_KERNELS:
        queries = dict(nearest_in_table_rows=primary, anyhit_in_table=occluder_halves, target_in_table=shadow)
        queries = queries.get(name, primary + shadow)
        check_soup(Soup(name, brute_tracer.scene.pack), adversarial, queries, kernels[name], soup_memo)
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
    del primary, shadow, occluder_halves, queries, soup_memo
    lap("the soup kernels")
    check_philox(kernels["philox_uniform"])
    check_sobol(kernels["sobol_owen_uniform"])
    check_histogram(kernels["histogram_add"], kernels["histogram_grad"])
    with eager_route(brute_tracer):
        brute_records = record_records(brute_tracer)
    assert sorted(r[2].shape[0] for r in brute_records) == [BATCH] * MAX_PATH + [2 * BATCH] * (MAX_PATH - 1)
    for path, records in (("mt", mt_records), ("polarized woop", woop_records), ("brute", brute_records)):
        check_record_replay(records, path, kernels["histogram_add"], kernels["histogram_grad"])
    del mt_records, woop_records, brute_records, records
    lap("philox, sobol and the histogram")
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
    time_kde_path(kernels["kernel_histogram_add"], kde_path_calls(mesh))
    torch.cuda.empty_cache()
    lap("the kernel histogram, synthetic and on its paths' calls")
    check_table_read(kernels, brute_tracer.scene.pack.media, volume_tracer.params()["medium"])
    check_gather_rows(kernels["gather_rows"], kernels["gather_rows_grad"], brute_tracer.scene.pack, shadow_winners)
    lap("the table reads and the row gathers")
    # the walks: flagship-array (example 08's detector array, which accel="auto" sends to the instanced walk)
    # and flagship-bvh (the flagship scene on the threaded BVH, leaf size 8), each on its recorded batch
    array_tracer = build_array(theia_tpu_torch, mesh, BATCH, ARRAY_PATH, device="cuda")
    array_pack = array_tracer.scene.pack
    assert array_tracer.scene.accel == "instanced" and array_pack.tri_data.shape[0] == 26 * 1280, array_tracer.scene.accel
    bvh_tracer = build_flagship(theia_tpu_torch, mesh, BATCH, MAX_PATH, accel="bvh", device="cuda")
    assert bvh_tracer.scene.pack.bvh.leaf_size == 8
    walk_batches = {
        "instanced": walk_queries(array_tracer, "nearest_triangle_instanced"),
        "bvh": walk_queries(bvh_tracer, "nearest_triangle_bvh"),
    }
    # the array's 8 primary queries (no guide, so no shadow query); the flagship's 10 primary and 9 shadow
    assert len(walk_batches["instanced"]) == ARRAY_PATH and len(walk_batches["bvh"]) == 2 * MAX_PATH - 1
    for name in WALK_KERNELS:
        kind = "instanced" if name.endswith("instanced") else "bvh"
        walk_pack = (array_tracer if kind == "instanced" else bvh_tracer).scene.pack
        walk, queries = Walk(name, walk_pack), walk_batches[kind]
        if walk.any_hit:
            queries = anyhit_queries(Walk(name.replace("occluded", "nearest_triangle"), walk_pack), queries)
        check_walk(walk, walk_pack, queries, kernels[name])
    del walk_batches, queries
    lap("the instanced and BVH walks")

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
        "sobol_owen_uniform": sobol_owen_uniform,
        "histogram_add": histogram_add,
        "read_table": table_read.read_table,
        "read_packed": table_read.read_packed,
        "gather_rows": table_read.gather_rows,
        "nearest_triangle_instanced": nearest_triangle_instanced,
        "occluded_instanced": occluded_instanced,
        "nearest_triangle_bvh": nearest_triangle_bvh,
        "occluded_bvh": occluded_bvh,
        "sample_gamma": sample_gamma,
        "track_backward_sample": track_backward_sample,
        "sort_rays": sort_rays,
        "scatter_back": scatter_back,
        **{name: getattr(segment, name) for name in SEGMENT_WRAPPERS},
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
    # the staged route: 10 primary queries and 9 shadow pairs on the query without rows, whose winners the
    # segment kernels rebuild; the table reads run inside the segment kernels
    seconds, sums, counts, peak = timed_runs(tracer, wrappers, "mt path")
    assert counts["nearest_triangle_mt"] == 19 * 3 and counts["nearest_triangle_mt_rows"] == 0, counts
    assert counts["nearest_triangle_woop"] == 0 and not any(counts[name] for name in SOUP_KERNELS), counts
    assert counts["philox_uniform"] > 0 and counts["histogram_add"] == 19 * 3, counts
    assert [counts[name] for name in SEGMENT_WRAPPERS] == [3 * MAX_PATH] * 2 + [3 * (MAX_PATH - 1)] * 2, counts
    med = statistics.median(seconds)
    print(
        f"main path (mt, staged route): batch {BATCH}, path length {MAX_PATH}, {tracer.scene.pack.mt.n_tri} "
        f"triangles: {med:.4f} s/batch (median of {[round(s, 4) for s in seconds]}), "
        f"{BATCH * MAX_PATH / med:.6g} bounces/s, peak memory {peak / 2**20:.1f} MiB, "
        f"launches per batch {{{', '.join(f'{k}: {v // 3}' for k, v in counts.items() if v)}}}, "
        f"histogram sums {sums}"
    )
    for name in ("nearest_triangle_mt", "philox_uniform", "histogram_add"):
        kernels[name].update(launches=counts[name], launches_per_batch=counts[name] // 3,
                             path="mt flagship on the staged route, 3 batches")
    # the eager route (trace_fn()'s forward, and what the staged route is held against): every read site of a
    # batch is one launch, a medium's constants at most two (one read, mu_e's add); then the winners' rows from
    # the kernel and from a separate gather (gather_rows), in turns
    turns = []
    with eager_route(tracer):
        mt_sites = read_sites(tracer.run, SCENE_READS)
        check_read_sites("mt flagship, eager route", mt_sites)
        for from_query in (True, False, False, True):
            accel.ROWS_FROM_QUERY = from_query
            turn_seconds, _, turn_counts, _ = timed_runs(tracer, wrappers, "mt path, eager route")
            own, other = "nearest_triangle_mt_rows", "nearest_triangle_mt"
            if not from_query:
                own, other = other, own
            assert turn_counts[own] == 19 * 3 and turn_counts[other] == 0, turn_counts
            assert not any(turn_counts[name] for name in SEGMENT_WRAPPERS), turn_counts
            turns.append(dict(rows_from_kernel=from_query, seconds_per_batch=turn_seconds,
                              launches={k: v // 3 for k, v in turn_counts.items() if v}))
            if from_query:
                kernels["nearest_triangle_mt_rows"].update(
                    launches=turn_counts[own], launches_per_batch=19,
                    path="mt flagship on the eager route (trace_fn's forward), 3 batches",
                )
    accel.ROWS_FROM_QUERY = True
    print(f"mt flagship, eager route: table-read launches a batch: read_packed {turns[0]['launches']['read_packed']}, "
          f"read_table {turns[0]['launches'].get('read_table', 0)}")
    print("mt flagship, eager route, rows from the kernel / a separate gather, in turns: " + "; ".join(
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
            first_step = absorption_grad(pol_tracer)
            loss, grad, _ = first_step
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
    pol_checks = check_gradient_run("gradient (woop, polarized)", lambda: absorption_grad(pol_tracer),
                                    [first_step, absorption_grad(pol_tracer)])
    del pol_tracer
    torch.cuda.empty_cache()

    phase("3d")
    # phase 3d: the third main path, the brute-force flagship (no accel named), at full width
    # the staged route: 10 primary queries without rows and the 9 shadow pairs in one launch each, no separate
    # any-hit; the segment kernels between them
    brute_seconds, brute_sums, brute_counts, brute_peak = timed_runs(brute_tracer, wrappers, "brute path")
    assert brute_counts["nearest_in_table"] == MAX_PATH * 3 and brute_counts["nearest_in_table_rows"] == 0, brute_counts
    assert brute_counts["target_in_table"] == (MAX_PATH - 1) * 3 and brute_counts["anyhit_in_table"] == 0, brute_counts
    for name in ("nearest_triangle_mt", "nearest_triangle_mt_rows", "nearest_triangle_woop"):
        assert brute_counts[name] == 0, brute_counts
    assert brute_counts["philox_uniform"] > 0 and brute_counts["histogram_add"] == 19 * 3, brute_counts
    assert [brute_counts[name] for name in SEGMENT_WRAPPERS] == [3 * MAX_PATH] * 2 + [3 * (MAX_PATH - 1)] * 2
    brute_med = statistics.median(brute_seconds)
    print(
        f"main path (brute, the default accel, staged route): batch {BATCH}, path length {MAX_PATH}, "
        f"{brute_tracer.scene.pack.soup.n_tri} triangles: "
        f"{brute_med:.4f} s/batch (median of {[round(s, 4) for s in brute_seconds]}), "
        f"{BATCH * MAX_PATH / brute_med:.6g} bounces/s, peak memory {brute_peak / 2**20:.1f} MiB, "
        f"launches per batch {{{', '.join(f'{k}: {v // 3}' for k, v in brute_counts.items() if v)}}}, "
        f"histogram sums {brute_sums}"
    )
    for name in ("nearest_in_table", "target_in_table"):
        kernels[name].update(launches=brute_counts[name], launches_per_batch=brute_counts[name] // 3,
                             path="brute-force flagship on the staged route, 3 batches")
    # the constants tables are read where they lie: nothing stacks them (const4_table is gone)
    assert not hasattr(theia_tpu_torch.material, "const4_table")
    # the eager route (trace_fn()'s forward): its read sites, then the winners' rows from the kernel and from a
    # separate gather (gather_rows), in turns
    brute_turns = []
    with eager_route(brute_tracer):
        brute_sites = read_sites(brute_tracer.run, SCENE_READS)
        check_read_sites("brute flagship, eager route", brute_sites)
        for from_query in (True, False, False, True):
            accel.ROWS_FROM_QUERY = from_query
            turn_seconds, _, turn_counts, _ = timed_runs(brute_tracer, wrappers, "brute path, eager route")
            own, other = "nearest_in_table_rows", "nearest_in_table"
            if not from_query:
                own, other = other, own
            assert turn_counts[own] == MAX_PATH * 3 and turn_counts[other] == 0, turn_counts
            assert turn_counts["target_in_table"] == (MAX_PATH - 1) * 3, turn_counts
            assert not any(turn_counts[name] for name in SEGMENT_WRAPPERS), turn_counts
            brute_turns.append(dict(rows_from_kernel=from_query, seconds_per_batch=turn_seconds,
                                    launches={k: v // 3 for k, v in turn_counts.items() if v}))
            if from_query:
                kernels["nearest_in_table_rows"].update(
                    launches=turn_counts[own], launches_per_batch=MAX_PATH,
                    path="brute-force flagship on the eager route (trace_fn's forward), 3 batches",
                )
    accel.ROWS_FROM_QUERY = True
    print(f"brute flagship, eager route: table-read launches a batch: read_packed "
          f"{brute_turns[0]['launches']['read_packed']}, read_table {brute_turns[0]['launches'].get('read_table', 0)}")
    print("brute flagship, eager route, rows from the kernel / a separate gather, in turns: " + "; ".join(
        f"{'kernel' if t['rows_from_kernel'] else 'gather'} {statistics.median(t['seconds_per_batch']):.4f} s "
        f"{[round(x, 4) for x in t['seconds_per_batch']]}" for t in brute_turns
    ))
    # the three backends in turns, unpolarized: seconds per batch compare only inside one call
    backends = {
        "mt": build_flagship(theia_tpu_torch, mesh, BATCH, MAX_PATH, accel="mt", device="cuda"),
        "woop": build_flagship(theia_tpu_torch, mesh, BATCH, MAX_PATH, accel="woop", device="cuda"),
        "brute": brute_tracer,
        "bvh": bvh_tracer,
    }
    backend_turns = []
    for label in ("mt", "woop", "brute", "bvh", "bvh", "brute", "woop", "mt"):
        turn_seconds, turn_sums, _, _ = timed_runs(backends[label], wrappers, f"{label} path")
        backend_turns.append(dict(accel=label, seconds_per_batch=turn_seconds, histogram_sums=turn_sums))
    print("main paths in turns, unpolarized, each on its default route (mt and brute staged): " + "; ".join(
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

    phase("3j")
    # phase 3j: flagship-array (example 08's detector array: 26 modules of 1280 triangles, accel="auto" ->
    # "instanced", HitRecorder, path length 8) and flagship-bvh (the flagship scene, accel="bvh") at full width
    walk_cells = {}
    for label, cell_tracer, total, own, per_batch in (
        ("flagship-array", array_tracer, recorded_total, "nearest_triangle_instanced", ARRAY_PATH),
        ("flagship-bvh", bvh_tracer, histogram_total, "nearest_triangle_bvh", 2 * MAX_PATH - 1),
    ):
        cell_seconds, cell_sums, cell_counts, cell_peak = timed_runs(cell_tracer, wrappers, label, total)
        assert cell_counts[own] == per_batch * 3, cell_counts
        others = [name for name, n in cell_counts.items() if n and name not in (own, "philox_uniform", "histogram_add",
                                                                                 "read_packed", "read_table", "gather_rows")]
        assert not others, f"{label}: other queries launched: {cell_counts}"
        cell_prof = profile_step(cell_tracer.run)
        cell_med = statistics.median(cell_seconds)
        print(
            f"{label}: batch {BATCH}, path length {cell_tracer.maxPathLength}, {cell_tracer.scene.pack.tri_data.shape[0]} "
            f"triangles, accel {cell_tracer.scene.accel}: {cell_med:.4f} s/batch (median of "
            f"{[round(x, 4) for x in cell_seconds]}), {BATCH * cell_tracer.maxPathLength / cell_med:.6g} bounces/s, peak "
            f"memory {cell_peak / 2**20:.1f} MiB, launches per batch "
            f"{{{', '.join(f'{k}: {v // 3}' for k, v in cell_counts.items() if v)}}}; one batch profiled: device busy "
            f"{cell_prof['device_busy_ms']:.2f} ms, {cell_prof['kernels']} kernels and copies; totals {cell_sums}"
        )
        for entry in cell_prof["top"][:6] + cell_prof["own"]:
            print(f"    {entry['ms']:9.3f} ms {entry['count']:6d} x {entry['name'][:90]}")
        kernels[own].update(launches=cell_counts[own], launches_per_batch=per_batch, path=f"{label}, 3 batches")
        # is_visible on the cell's scene, the any-hit walk's entry point: observers through the scene,
        # targets up to 4 m along random rays
        o, d, _ = walk_rays(cell_tracer.scene.pack, BATCH, 41)
        target = o + 4.0 * d
        for w in wrappers.values():
            w.launches = 0
        seen = [accel.is_visible(cell_tracer.scene.pack, o, target) for _ in range(3)]
        torch.cuda.synchronize()
        vis_counts = {name: w.launches for name, w in wrappers.items() if w.launches}
        anyhit = own.replace("nearest_triangle", "occluded")
        assert vis_counts == {anyhit: 3}, vis_counts
        assert all(torch.equal(v, seen[0]) for v in seen) and 0.0 < float(seen[0].float().mean()) < 1.0
        kernels[anyhit].update(launches=3, launches_per_batch=1, path=f"is_visible on {label}'s scene, 3 calls")
        print(f"is_visible ({label}): {BATCH} observer-target pairs, visible {float(seen[0].float().mean()):.4f}, "
              f"launches {vis_counts}")
        walk_cells[label] = dict(seconds_per_batch=cell_seconds, totals=cell_sums, launches=cell_counts,
                                 peak_bytes=cell_peak, profile=cell_prof, visible=float(seen[0].float().mean()))
    del array_tracer, bvh_tracer, cell_tracer
    torch.cuda.empty_cache()
    # the crossover sweep: brute soup, instanced walk and BVH on 1, 8, 26 and 124 modules
    sweep_report = {}
    sweep(mesh, sweep_report)

    phase("3k")
    # phase 3k: the Sobol generator and the camera tracers at full width
    camera_runs = sobol_and_camera_runs(mesh, wrappers, kernels)

    phase("3l")
    # phase 3l: the scene camera tracers at full width
    scene_runs = scene_camera_runs(mesh, wrappers, grad_wrappers)
    for run, info in scene_runs.items():
        for name, n in (info.get("launches_per_batch") or info.get("launches") or {}).items():
            if name in kernels:
                kernels[name].setdefault("scene_camera_launches", {})[run] = n

    phase("3m")
    # phase 3m: Cherenkov light from a muon, a cascade and a track at full width, and the disk guide
    cherenkov = cherenkov_runs(mesh, wrappers, kernels)

    phase("3n")
    # phase 3n: the last single-card modules: the pipeline and its scheduler, a converging task and its
    # checkpoint, the ocean-water phase functions, scenes from mesh files and the debug renderer
    single_card, single_card_cpu = single_card_runs(mesh, wrappers, smi)
    for run, info in single_card.items():
        for name, n in (info.get("launches_per_batch") or {}).items():
            if name in kernels:
                kernels[name].setdefault("single_card_launches", {})[run] = n

    phase("3o")
    # phase 3o: the multi-device layer (ShardedRunner over NCCL, gloo ranks sharing the card), profiling, and
    # the wavefront sort on its path (flagship-array with accel="mt" and "woop")
    last_slice = last_slice_runs(mesh, wrappers, kernels, smi, brute_med)

    phase("3p")
    # phase 3p: the flagship's segment as four kernels (trace/segment.py) on flagship-brute and flagship-mt
    segments = segment_runs(mesh, wrappers, kernels, smi)

    phase("4")
    # phase 4: the port on the CPU against the port on the card
    cpu_vs_card = dict(single_card_cpu)
    flagship = lambda **kw: lambda dev: build_flagship(theia_tpu_torch, mesh, SMALL_BATCH, MAX_PATH, device=dev, **kw)
    for label, build in (
        ("mt, staged route", flagship()),
        ("brute, staged route", flagship(accel="auto")),
        ("woop polarized off centre", flagship(accel="woop", polarized=True, source_position=OFF_CENTRE)),
        ("volume", lambda dev: build_volume_flagship(theia_tpu_torch, SMALL_BATCH, dev)),
        ("volume polarized", lambda dev: build_volume_flagship(theia_tpu_torch, SMALL_BATCH, dev, polarized=True)),
        ("volume photon", lambda dev: build_volume_photon(theia_tpu_torch, SMALL_BATCH, dev)),
        ("scene photon", lambda dev: build_photon_flagship(theia_tpu_torch, mesh, SMALL_BATCH, dev)),
        ("unguided, StoreTimeHitResponse", flagship(accel="auto", guided=False, response=StoreTimeHitResponse())),
        ("flagship-array (instanced), HitRecorder", lambda dev: build_array(
            theia_tpu_torch, mesh, SMALL_BATCH, ARRAY_PATH, device=dev)),
        ("flagship-bvh", flagship(accel="bvh")),
        ("flagship-brute-sobol", flagship(accel="auto", rng=sobol(FLAGSHIP_SOBOL))),
        ("flagship-volume-sobol", lambda dev: build_volume_flagship(
            theia_tpu_torch, SMALL_BATCH, dev, rng=sobol(EXAMPLE_11_SOBOL))),
        ("volume-backward, HitRecorder", lambda dev: build_volume_backward(theia_tpu_torch, SMALL_BATCH, dev)),
        ("direct", lambda dev: build_direct(theia_tpu_torch, SMALL_BATCH, dev)),
        ("scene-backward-target, HitRecorder", lambda dev: build_scene_backward_target(
            theia_tpu_torch, SMALL_BATCH, dev, mesh=mesh)),
        ("scene-backward, HitRecorder", lambda dev: build_scene_backward(theia_tpu_torch, SMALL_BATCH, dev, mesh=mesh)),
        ("scene-backward (mt), HitRecorder", lambda dev: build_scene_backward(
            theia_tpu_torch, SMALL_BATCH, dev, mesh=mesh, accel="mt")),
        ("bidirectional", lambda dev: build_bidirectional(theia_tpu_torch, SMALL_BATCH, dev, mesh=mesh)),
        ("cherenkov-muon", lambda dev: build_cherenkov_volume(theia_tpu_torch, SMALL_BATCH, dev, source="muon")),
        ("cherenkov-cascade", lambda dev: build_cherenkov_volume(theia_tpu_torch, SMALL_BATCH, dev, source="cascade")),
        ("cascade-backward", lambda dev: build_cherenkov_backward(
            theia_tpu_torch, SMALL_BATCH, dev, source=cascade_source(theia_tpu_torch))),
        ("track-backward", lambda dev: build_cherenkov_backward(
            theia_tpu_torch, SMALL_BATCH, dev, source=track_line_source(theia_tpu_torch, "track"))),
        ("track-backward, 256 segments", lambda dev: build_cherenkov_backward(
            theia_tpu_torch, SMALL_BATCH, dev, source=track_line_source(theia_tpu_torch, "track", 256))),
        ("flagship-brute-disk-guide", flagship(accel="auto", guide="disk")),
        ("flagship-array (mt, binned), HitRecorder", lambda dev: build_array(
            theia_tpu_torch, mesh, SMALL_BATCH, ARRAY_PATH, accel="mt", device=dev, binned=True)),
        ("flagship-array (woop, binned), HitRecorder", lambda dev: build_array(
            theia_tpu_torch, mesh, SMALL_BATCH, ARRAY_PATH, accel="woop", device=dev, binned=True)),
    ):
        cpu_vs_card[label] = hold_cpu_vs_card(label, build)
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
        ("scene-backward-target, glass index", lambda dev: build_backward_eta2(
            theia_tpu_torch, GRAD_BATCH, dev, mesh=mesh, max_path=GRAD_PATH), lambda t: index_step(t, weighted=True)),
    ):
        grads = {dev: make(build(dev))()[1] for dev in ("cpu", "cuda")}
        cpu_vs_card[f"gradient, {label}"] = gradient_agreement(label, grads["cpu"], grads["cuda"])

    phase("end")
    for info in kernels.values():
        assert info["launches"] > 0, info
        info.update(card_ms=info["ms"], share_of_bound=info["bound_ms"] / info["ms"])
    line = {"kernels": [dict(name=name, **info) for name, info in kernels.items()]}
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, build_seconds=lib.build_seconds, sass=sass, sqrt=sqrt_check,
        mt_path=dict(seconds_per_batch=seconds, bounces_per_s=BATCH * MAX_PATH / med,
                     peak_bytes=peak, histogram_sums=sums, launches=counts, row_source_turns=turns),
        brute_path=dict(seconds_per_batch=brute_seconds, bounces_per_s=BATCH * MAX_PATH / brute_med,
                        peak_bytes=brute_peak, histogram_sums=brute_sums, launches=brute_counts,
                        row_source_turns=brute_turns),
        backends_in_turns=backend_turns, walk_cells=walk_cells, crossover_sweep=sweep_report["sweep"],
        read_sites=dict(mt=mt_sites, woop_polarized=pol_sites, brute=brute_sites, volume=vol_sites),
        woop_polarized_path=dict(seconds_per_batch=pol_seconds, bounces_per_s=BATCH * MAX_PATH / pol_med,
                                 peak_bytes=pol_peak, histogram_sums=pol_sums, launches=pol_counts),
        volume_path=dict(seconds_per_batch=vol_seconds, bounces_per_s=BATCH * 10 / vol_med, peak_bytes=vol_peak,
                         histogram_sums=vol_sums, launches=vol_counts, profile=vol_prof),
        photon_path=dict(compacted_vs_run_rel=photon_rel, lanes_after_each_run=photon_lanes, turns=photon_turns,
                         profile=photon_prof),
        gradient=dict(batch=grad_batch, seconds=grad_seconds, peak_bytes=grad_peak, loss=loss,
                      grad_sum=float(grad.sum()), grad=grad.tolist(), histogram_grad_launches=grad_launches,
                      launches=grad_counts, profile=grad_prof, **pol_checks),
        volume_gradient_steps=volume_steps, geometry_gradient_step=geo, sobol_and_camera_runs=camera_runs,
        scene_camera_runs=scene_runs, cherenkov_runs=cherenkov, single_card_runs=single_card,
        last_slice_runs=last_slice, segment_runs=segments,
        cpu_vs_card=cpu_vs_card, phase_seconds={k: clock[n] - clock[k] for k, n in zip(clock, list(clock)[1:])},
        lap_seconds=laps,
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
