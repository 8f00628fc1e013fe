"""theia_tpu_torch.pipeline against theia_tpu.pipeline on example 03's two
tracers (the flash and the beam in sea water) at 1,024 lanes and 4
scatterings, the cases of tests/test_pipeline.py: parameter routing, the
threaded scheduler against the synchronous one, errors raised on the
calling thread, ConvergeHistogramTask, checkpoint and resume (in the port
and from a JAX checkpoint), the streaming source's cursor and the runtime
batch size.

Tolerances and why: each package traces the same lanes on the same Philox
streams with the same float32 ops, so a batch's light curve agrees with
JAX's by test_torch_volume.py's histogram agreement: sum within rtol 1e-5
and every bin within 1e-5 of the largest bin (transcendentals an ulp
apart, summation order); the Welford state built from such batches
agrees to the same rtol, and so does its error (rtol 1e-3: a difference
of two nearly equal sums). Within the port, on the CPU, the threaded and
synchronous schedulers and a resumed run equal their twins bit for bit."""

import numpy as np
import pytest
import torch

import theia_tpu
import theia_tpu.pipeline as jp
import theia_tpu_torch
import theia_tpu_torch.pipeline as tp
from torch_flagship import build_example03

torch.set_num_threads(1)
BATCH, SCATTER = 1024, 4
RTOL = 1e-5


def tracers(pkg, batch=BATCH):
    return build_example03(pkg, batch, SCATTER, None if pkg is theia_tpu else "cpu")


def curves_agree(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert want.sum() > 0 and np.isfinite(got).all()
    assert abs(got.sum() / want.sum() - 1.0) <= RTOL, got.sum() / want.sum() - 1.0
    assert np.abs(got - want).max() <= RTOL * want.max()


def test_param_routing_matches_jax():
    runs = {}
    for pkg, pl in ((theia_tpu, jp), (theia_tpu_torch, tp)):
        flash, _ = tracers(pkg)
        pipe = pl.Pipeline(flash)
        pipe.setParams({"lightSource__budget": 2e9, "tracer__maxTime": 400.0})
        assert pipe.getParam("lightSource__budget") == 2e9 and flash.maxTime == 400.0
        h1, _ = pipe.run()
        pipe.setParams({"lightSource__budget": 4e9})
        h2, _ = pipe.run()
        with pytest.raises(ValueError, match="not stage-addressed"):
            pipe.setParams({"budget": 1.0})
        with pytest.raises(ValueError, match="unknown stage"):
            pipe.setParams({"noSuchStage__budget": 1.0})
        runs[pkg.__name__] = (np.asarray(h1), np.asarray(h2))
    for a, b in zip(runs["theia_tpu_torch"], runs["theia_tpu"]):
        curves_agree(a, b)
    h1, h2 = runs["theia_tpu_torch"]
    assert 1.5 < h2.sum() / h1.sum() < 2.5


def test_set_params_copies_tensors():
    """A tensor routed to a stage is copied: rewriting the caller's tensor
    in place afterwards reaches no batch."""
    flash, _ = tracers(theia_tpu_torch)
    pipe = tp.Pipeline(flash)
    pos = torch.tensor([-1.0, -7.0, 0.0])
    pipe.setParams({"lightSource__position": pos})
    pos.fill_(100.0)
    assert flash.source.position.tolist() == [-1.0, -7.0, 0.0]


def schedule(pkg, pl, threaded, tasks=None, lookahead=2):
    flash, beam = tracers(pkg)
    results = []
    sched = pl.PipelineScheduler(
        [("flash", pl.Pipeline(flash)), ("beam", pl.Pipeline(beam))],
        processFn=lambda c, b, r: results.append(r), dispatchThread=threaded, lookahead=lookahead,
    )
    sched.schedule(tasks or [("flash", {}), ("beam", {}), ("flash", {"lightSource__budget": 3e9}), ("beam", {})])
    sched.wait()
    return results, (flash, beam)


@pytest.mark.parametrize("lookahead", [1, 2, 3])
def test_threaded_equals_sync_bit_for_bit(lookahead):
    a, (fa, ba) = schedule(theia_tpu_torch, tp, True, lookahead=lookahead)
    b, (fb, bb) = schedule(theia_tpu_torch, tp, False, lookahead=lookahead)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert isinstance(x[0], np.ndarray) and x[0].shape == (100,)
        np.testing.assert_array_equal(x[0], y[0])
    assert (fa.rng.offset, ba.rng.offset) == (fb.rng.offset, bb.rng.offset) == (2 * fa.rng.autoAdvance,) * 2
    assert a[2][0].sum() > 1.5 * a[0][0].sum()  # the third batch had three times the flash's budget


def test_scheduler_matches_jax():
    """Both schedulers on their dispatch threads (the port's synchronous
    mode equals its threaded one bit for bit, above)."""
    a, _ = schedule(theia_tpu_torch, tp, True)
    b, _ = schedule(theia_tpu, jp, True)
    for x, y in zip(a, b):
        curves_agree(x[0], y[0])


def test_errors_raise_on_the_calling_thread():
    flash, _ = tracers(theia_tpu_torch)
    sched = tp.PipelineScheduler(tp.Pipeline(flash), dispatchThread=True)
    with pytest.raises(ValueError, match="unknown stage"):
        sched.schedule([{}, {"noSuchStage__param": 1.0}, {}])

    def boom(config, batch, result):
        raise RuntimeError("processFn failed")

    sched = tp.PipelineScheduler(tp.Pipeline(flash), processFn=boom, dispatchThread=True)
    with pytest.raises(RuntimeError, match="processFn failed"):
        sched.schedule([{}, {}, {}])
    with pytest.raises(KeyError, match="unknown pipeline"):
        tp.PipelineScheduler([("a", tp.Pipeline(flash))]).schedule([("b", {})])


def converge(pkg, pl, threaded=True):
    flash, _ = tracers(pkg)
    done = []
    task = pl.ConvergeHistogramTask({}, initialBatchCount=3, extraBatchCount=2, maxBatchCount=12, atol=0.0,
                                    rtol=3e-2, finishedCallback=done.append)
    pl.PipelineScheduler(pl.Pipeline(flash), dispatchThread=threaded).schedule([task])
    assert done and done[0] is task
    return task, flash


def test_converge_histogram_task_matches_jax():
    jt, jf = converge(theia_tpu, jp)
    tt, tf = converge(theia_tpu_torch, tp)
    st, _ = converge(theia_tpu_torch, tp, threaded=False)
    assert tt.totalBatches == jt.totalBatches == st.totalBatches >= 3
    assert tt.converged and jt.converged and tt.error <= 3e-2 * tt._totalMean
    assert tf.rng.offset == jf.rng.offset
    curves_agree(tt.result, jt.result)
    np.testing.assert_array_equal(tt.result, st.result)
    assert abs(tt.error / jt.error - 1.0) <= 1e-3
    assert tt.state_dict()["totalBatches"] == tt.totalBatches
    with pytest.raises(ValueError):
        tp.ConvergeHistogramTask(initialBatchCount=1)
    with pytest.raises(ValueError):
        tp.ConvergeHistogramTask(extraBatchCount=0)


def _batches(pipe, task, n):
    for _ in range(n):
        task.processBatch(pipe.run())


def test_checkpoint_resume_bit_for_bit(tmp_path):
    """A run broken after 2 batches, checkpointed, rebuilt and resumed ends
    with the unbroken run's estimator and RNG cursor, bit for bit."""
    ref_pipe, ref_task = tp.Pipeline(tracers(theia_tpu_torch)[0]), tp.ConvergeHistogramTask(maxBatchCount=50)
    _batches(ref_pipe, ref_task, 4)
    pipe_a, task_a = tp.Pipeline(tracers(theia_tpu_torch)[0]), tp.ConvergeHistogramTask(maxBatchCount=50)
    _batches(pipe_a, task_a, 2)
    tp.saveCheckpoint(tmp_path / "run.npz", pipe_a, task_a)
    pipe_b, task_b = tp.Pipeline(tracers(theia_tpu_torch)[0]), tp.ConvergeHistogramTask(maxBatchCount=50)
    tp.loadCheckpoint(tmp_path / "run.npz", pipe_b, task_b)
    assert pipe_b.tracer.rng.offset == pipe_a.tracer.rng.offset and task_b.totalBatches == 2
    _batches(pipe_b, task_b, 2)
    assert task_b.totalBatches == ref_task.totalBatches == 4
    np.testing.assert_array_equal(task_b.result, ref_task.result)
    assert task_b.error == ref_task.error
    assert pipe_b.tracer.rng.offset == ref_pipe.tracer.rng.offset
    # a checkpoint with no result yet (the task's None) round-trips too
    fresh = tp.ConvergeHistogramTask()
    tp.saveCheckpoint(tmp_path / "fresh.npz", pipe_b, fresh)
    again = tp.ConvergeHistogramTask()
    tp.loadCheckpoint(tmp_path / "fresh.npz", pipe_b, again)
    assert again.result is None and again.totalBatches == 0


def test_jax_checkpoint_resumed_by_the_port(tmp_path):
    """A checkpoint that theia_tpu wrote after 2 batches, resumed by the
    port for 2 more, against JAX's unbroken 4; and the port's checkpoint
    resumed by JAX."""
    jref, jref_task = jp.Pipeline(tracers(theia_tpu)[0]), jp.ConvergeHistogramTask(maxBatchCount=50)
    _batches(jref, jref_task, 4)
    ja, ja_task = jp.Pipeline(tracers(theia_tpu)[0]), jp.ConvergeHistogramTask(maxBatchCount=50)
    _batches(ja, ja_task, 2)
    jp.saveCheckpoint(tmp_path / "jax.npz", ja, ja_task)
    pipe, task = tp.Pipeline(tracers(theia_tpu_torch)[0]), tp.ConvergeHistogramTask(maxBatchCount=50)
    tp.loadCheckpoint(tmp_path / "jax.npz", pipe, task)
    assert pipe.tracer.rng.offset == ja.tracer.rng.offset and task.totalBatches == 2
    _batches(pipe, task, 2)
    assert pipe.tracer.rng.offset == jref.tracer.rng.offset
    curves_agree(task.result, jref_task.result)
    assert abs(task.error / jref_task.error - 1.0) <= 1e-3
    tp.saveCheckpoint(tmp_path / "port.npz", pipe, task)
    back, back_task = jp.Pipeline(tracers(theia_tpu)[0]), jp.ConvergeHistogramTask(maxBatchCount=50)
    jp.loadCheckpoint(tmp_path / "port.npz", back, back_task)
    assert back.tracer.rng.offset == pipe.tracer.rng.offset and back_task.totalBatches == 4
    np.testing.assert_array_equal(back_task.result, task.result)


def test_checkpoint_keeps_the_streaming_cursor(tmp_path):
    def build(pkg):
        m = lambda name: __import__(f"{pkg.__name__}.{name}", fromlist=["x"])
        wl = np.linspace(400.0, 500.0, 10 * 1024, dtype=np.float32)
        dev = {} if pkg is theia_tpu else {"device": "cpu"}
        mat = m("material")
        medium = m("testing").WaterTestModel(mu_a=0.005, mu_s=0.01, g=0.3).createMedium(num_lambda=16, num_theta=16)
        return m("trace.volume").VolumeForwardTracer(
            1024, m("light").SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
            m("target").InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=50.0),
            m("light").StreamingHostWavelengthSource(wl, batchSize=1024),
            m("response").HistogramHitResponse(nBins=10, t0=0.0, binSize=50.0), m("random").PhiloxRNG(key=0xBEEF),
            medium=medium, nScattering=2, scatterCoefficient=0.02, **dev,
        )

    pipe = tp.Pipeline(build(theia_tpu_torch))
    pipe.run()
    pipe.run()
    assert pipe.stages["photons"].offset == 2 * 1024
    tp.saveCheckpoint(tmp_path / "s.npz", pipe)
    for pkg, pl in ((theia_tpu_torch, tp), (theia_tpu, jp)):
        again = pl.Pipeline(build(pkg))
        pl.loadCheckpoint(tmp_path / "s.npz", again)
        assert again.stages["photons"].offset == 2 * 1024
        assert again.tracer.rng.offset == pipe.tracer.rng.offset


def test_runtime_batch_size_and_aliases():
    full, half = 1024, 512
    flash, _ = build_example03(theia_tpu_torch, full, SCATTER, "cpu")
    pipe = tp.Pipeline(flash)
    pipe.setParams({"tracer__batchSize": half})
    assert flash.normalization == 1.0 / half
    h_half, _ = pipe.run()
    ref, _ = build_example03(theia_tpu_torch, half, SCATTER, "cpu")
    torch.testing.assert_close(h_half, ref.run()[0], rtol=1e-6, atol=0.0)
    with pytest.raises(ValueError):
        pipe.setParams({"tracer__batchSize": 2 * full})
    h, _ = tp.runPipeline(flash, {"lightSource__budget": 1e9})
    assert h.shape == (100,)
    import theia_tpu_torch.task as task

    assert task.ConvergeHistogramTask is tp.ConvergeHistogramTask and task.__all__ == theia_tpu.task.__all__
    assert theia_tpu_torch.trace.Tracer is theia_tpu_torch.trace.TracerBase
