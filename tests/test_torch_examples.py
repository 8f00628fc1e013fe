"""The port's example scripts (``theia_tpu_torch/examples/``: 05, 06 and
10 of theia_tpu's examples) run end to end on the CPU at a small batch
and print their result lines; each is the script's own ``main`` with
``device="cpu"``. Example 10's calibration is held to its 6 cm only at
its own batch (on the card): here, at 1024 lanes and 6 iterations, its
error must fall below the offset it starts from."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "theia_tpu_torch" / "examples"


def _main(script):
    spec = importlib.util.spec_from_file_location(f"port_example_{script[:2]}", EXAMPLES / script)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize(
    "script,kw,expect",
    [
        ("05_inverse_problem.py", dict(batch=2048), "recovered absorption scale"),
        ("06_timing_calibration.py", dict(batch=2048), "recovered group-velocity scale"),
        ("10_geometry_calibration.py", dict(batch=1024, iterations=6, check=False), "calibrated offset"),
    ],
)
def test_port_example_runs(script, kw, expect, capsys):
    module = _main(script)
    result = module.main(device="cpu", **kw)
    out = capsys.readouterr().out
    assert expect in out, out
    assert np.isfinite(result)
    if script.startswith("10"):
        assert result < float(np.linalg.norm(module.TRUE_OFFSET)), out
    else:  # the scale moved from 1 towards the truth (1.35, 0.92)
        truth = 1.35 if script.startswith("05") else 0.92
        assert abs(result - truth) < abs(1.0 - truth), out
