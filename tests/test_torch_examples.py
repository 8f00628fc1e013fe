"""The port's example scripts (``theia_tpu_torch/examples/``: 01 to 11 of
theia_tpu's examples) run end to end on the CPU at a
small batch and print their result lines; each is the script's own
``main`` with ``device="cpu"``. Example 10's calibration and example 09's
reconstruction are held to their 6 cm and 12 cm only at their own batch
(on the card): here, at 1024 lanes and a few iterations, the error must
fall below the offset it starts from. Example 02 traces on the threaded
BVH, 08 and 09 on the instanced walk (08's ``"auto"`` picks it). Example
04's reflected shares are held to Fresnel's r_s^2 within 1e-4; example
11's Sobol replicates must scatter less than Philox's (its own check,
here at 2048 lanes and 4 replicates). Example 03 schedules its two
pipelines on the dispatch thread and synchronously, with equal light
curves; example 07 renders its scene from the STL files it writes."""

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
        ("02_scene_tracing.py", dict(batch=2048, runs=1), "detector light curve"),
        ("08_detector_array.py", dict(batch=2048, check=False), "accel backend picked by auto: instanced"),
        ("09_source_reconstruction.py", dict(batch=1024, iterations=4, check=False), "reconstructed"),
        ("01_volume_tracing.py", dict(batch=2048, runs=1), "d(total)/d(mu_a)"),
        ("04_polarization.py", dict(), "s-polarized reflected"),
        ("11_quasirandom_sampling.py", dict(batch=2048, reps=4), "sobol variance win confirmed"),
        ("03_multiple_lightsources.py", dict(batch=1024, nScattering=4), "beam arrival window sum"),
        ("07_scene_render.py", dict(width=64, height=48), "of pixels hit geometry"),
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
    elif script.startswith("09"):
        assert result < float(np.linalg.norm(module.TRUE_POS)), out
    elif script.startswith("02"):
        assert result > 0.0, out
    elif script.startswith("08"):
        assert 1 <= result <= 26, out
    elif script.startswith("01"):
        assert result < 0.0, out
    elif script.startswith("04"):
        assert result < 1e-4, out
    elif script.startswith("11"):
        assert result > 1.5, out
    elif script.startswith("03"):
        assert result > 0.0, out
        assert module.main(device="cpu", dispatchThread=False, **kw) == result  # the same batches, bit for bit
    elif script.startswith("07"):
        assert 0.05 < result < 0.9, out
    else:  # the scale moved from 1 towards the truth (1.35, 0.92)
        truth = 1.35 if script.startswith("05") else 0.92
        assert abs(result - truth) < abs(1.0 - truth), out
