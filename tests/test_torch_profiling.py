"""theia_tpu_torch.profiling on the CPU: tests/test_misc_components.py's
``test_profiling_helpers`` on the port (``profile_batch`` writes a trace
and returns sane statistics; ``batch_timings`` orders its statistics),
with the statistics' keys held equal to ``theia_tpu.profiling``'s, and the
trace holding the annotated region and the tracer's operators."""

import json
import os

import torch

import theia_tpu
import theia_tpu.profiling as jprof
import theia_tpu_torch
from theia_tpu_torch.profiling import batch_timings, profile_batch, trace_profile
import _torch_parallel_worker as W

torch.set_num_threads(1)


def traces(root):
    return [os.path.join(r, f) for r, _, fs in os.walk(root) for f in fs]


def test_profiling_helpers(tmp_path):
    tracer = W.build_pipeline_tracer(theia_tpu_torch, 1024, "cpu")
    offset = tracer.rng.offset
    stats = profile_batch(tracer, str(tmp_path / "prof"), runs=2)
    assert stats["min"] > 0 and stats["bounces_per_s"] > 0
    assert stats["runs"] == 2 and stats["batch_size"] == 1024
    assert tracer.rng.offset == offset + 3 * tracer.rng.autoAdvance  # one batch outside the trace, two in it
    dumped = traces(tmp_path / "prof")
    assert len(dumped) == 1 and dumped[0].endswith(".pt.trace.json"), dumped
    with open(dumped[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "theia_tpu_torch.batch" in names and any(str(n).startswith("aten::") for n in names)

    t = batch_timings(tracer, runs=3, warmup=0)
    assert t["min"] <= t["median"] <= t["max"] and t["min"] <= t["mean"] <= t["max"]
    want = jprof.batch_timings(W.build_pipeline_tracer(theia_tpu, 256), runs=1, warmup=0)
    assert set(t) == set(want)


def test_trace_profile_annotates_the_region(tmp_path):
    tracer = W.build_pipeline_tracer(theia_tpu_torch, 256, "cpu")
    with trace_profile(str(tmp_path), annotate="one batch") as prof:
        tracer.run()
    assert "one batch" in {e.key for e in prof.key_averages()}
    assert len(traces(tmp_path)) == 1
    with trace_profile(str(tmp_path / "plain"), cuda=False) as prof:
        tracer.run()
    assert len(traces(tmp_path / "plain")) == 1
