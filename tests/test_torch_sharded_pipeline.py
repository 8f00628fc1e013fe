"""The orchestration layer over the sharded runner on the CPU: the cases of
tests/test_sharded_pipeline.py for theia_tpu_torch, with
``Pipeline(tracer, runner=ShardedRunner(tracer))`` on each rank of a world
of 4 gloo processes (tests/_torch_parallel_worker.py, started once for
this file): the pipeline's run, ``ConvergeHistogramTask`` under the
scheduler on its dispatch thread and synchronously, and a checkpoint
resumed mid-task in a fresh pipeline and runner.

Tolerances and why: a sharded batch against the single-device one at
JAX's rtol 2e-4 / atol 1e-3 (4 ranks' float states summed in another
order); against JAX's sharded pipeline on 4 of its 8 devices (the same 4
blocks of lanes) by the port's volume agreement, the sum within rtol 1e-5
and every bin within 1e-5 of the largest bin. The converging task stops
at the same batch as the single-device one; its ``rtol`` is 3e-3 (JAX's
test has 5e-3, which stops at the first decision, 3 batches) so that it
issues extra batches before it stops (7 on the CPU). Every rank holds the
same summed bits, so the stop decision and a resumed run are the same on
every rank, and the resumed run equals the uninterrupted one bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

import theia_tpu
import theia_tpu.parallel as jpar
import theia_tpu.pipeline as jp
import theia_tpu_torch
import theia_tpu_torch.parallel as tpar
import theia_tpu_torch.pipeline as tp
import _torch_parallel_worker as W

torch.set_num_threads(1)

WORLD = 4
JOBS = ("pipeline", "converge", "checkpoint")
RTOL_VOLUME = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The gloo world's results by job, joined at the first request."""
    out = tmp_path_factory.mktemp("gloo")
    procs = W.start_world(out, WORLD, JOBS)
    results = {}

    def get(job):
        if not results:
            results.update(W.join_world(procs, out, JOBS))
        return results[job]

    yield get
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def single():
    return W.build_pipeline_tracer(theia_tpu_torch, W.PIPELINE_BATCH, "cpu")


def test_sharded_pipeline_run_matches_single_device(world):
    h_single, _ = tp.Pipeline(single()).run()
    jt = W.build_pipeline_tracer(theia_tpu, W.PIPELINE_BATCH)
    runner = jpar.ShardedRunner(jt, jpar.make_photon_mesh(jax.devices()[:WORLD]))
    h_jax = np.asarray(jp.Pipeline(jt, runner=runner).run()[0], np.float64)
    ranks = world("pipeline")
    # a world of several processes: the runner's multihost mode, host copies of the results
    h_shard = ranks[0]["hist"]
    for r in ranks:
        assert isinstance(r["hist"], np.ndarray)
        np.testing.assert_array_equal(r["hist"].view(np.int32), h_shard.view(np.int32))
    assert h_single.sum() > 0
    np.testing.assert_allclose(h_shard, h_single.numpy(), rtol=2e-4, atol=1e-3)
    assert abs(h_shard.sum() / h_jax.sum() - 1.0) <= RTOL_VOLUME
    assert np.abs(h_shard - h_jax).max() <= RTOL_VOLUME * h_jax.max()


@pytest.mark.parametrize("threaded", [True, False])
def test_scheduler_converges_task_on_mesh(world, threaded):
    """ConvergeHistogramTask driven by the scheduler on every rank stops at
    the single-device batch with its estimate."""
    tracer = single()
    task = tp.ConvergeHistogramTask({}, **W.CONVERGE)
    tp.PipelineScheduler(tp.Pipeline(tracer), dispatchThread=threaded).schedule([task])
    key = "threaded" if threaded else "sync"
    ranks = world("converge")
    assert task.converged and task.totalBatches > W.CONVERGE["initialBatchCount"]
    for r in ranks:
        assert r[f"{key}_batches"] == task.totalBatches
        assert r[f"{key}_offset"] == tracer.rng.offset
        np.testing.assert_array_equal(r[f"{key}_result"], ranks[0][f"{key}_result"])
    assert ranks[0][f"{key}_result"].sum() > 0
    np.testing.assert_allclose(ranks[0][f"{key}_result"], task.result, rtol=2e-4, atol=1e-3)


def test_sharded_checkpoint_resume_mid_task(world):
    """A sharded task stopped after 2 batches and resumed in a fresh
    pipeline and runner finishes with the uninterrupted run's estimator
    state and RNG cursor."""
    for r in world("checkpoint"):
        assert r["resumed_offset"] == r["saved_offset"]
        assert r["batches"] == r["ref_batches"] == 4
        np.testing.assert_array_equal(r["result"], r["ref_result"])
        assert r["offset"] == r["ref_offset"]


def test_runner_rejects_foreign_tracer():
    tracer = single()
    runner = tpar.ShardedRunner(tracer)
    assert runner.mesh.size == 1 and not runner.multihost
    with pytest.raises(ValueError, match="different tracer"):
        tp.Pipeline(single(), runner=runner)
    with pytest.raises(ValueError, match="not the tracer's"):
        tpar.ShardedRunner(tracer, tpar.PhotonMesh(None, 0, 1, torch.device("cuda")))
