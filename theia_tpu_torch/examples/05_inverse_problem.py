"""Inverse problem: recover water absorption from an observed light curve,
on theia_tpu_torch (examples/05_inverse_problem.py of theia_tpu, ported).

Light curves are differentiable with respect to medium parameters, so a
detector's time histogram can drive gradient-based inference. Here an
"observation" is simulated with a hidden absorption coefficient, which is
then recovered by descending the squared light-curve mismatch with Adam,
on common random numbers so that the gradient is exact for the realized
estimator. Each step is one forward and backward pass through
``trace_fn()``.

Run: python theia_tpu_torch/examples/05_inverse_problem.py [--device cpu] [--batch N]
(the card by default).
"""

import argparse
import dataclasses
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch

import theia_tpu_torch.units as u
from theia_tpu_torch.light import SphericalLightSource, UniformWavelengthSource
from theia_tpu_torch.material import HenyeyGreensteinPhaseFunction, MediumModel, WaterBaseModel
from theia_tpu_torch.random import PhiloxRNG
from theia_tpu_torch.response import HistogramHitResponse
from theia_tpu_torch.target import SphereTarget
from theia_tpu_torch.trace import VolumeForwardTracer


class WaterModel(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
    def __init__(self) -> None:
        WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.6)


def main(device="cuda", batch: int = 32 * 1024, steps: int = 15) -> float:
    """Fits the absorption scale; returns the recovered scale."""
    tracer = VolumeForwardTracer(
        batch,
        SphericalLightSource(position=(-1.0, -7.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        SphereTarget(position=(0.0, 0.0, 0.0), radius=5.0 * u.m),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=60, binSize=5.0 * u.ns, t0=0.0),
        PhiloxRNG(key=0xD1CE),
        medium=WaterModel().createMedium(),
        nScattering=8,
        maxTime=300.0 * u.ns,
        device=device,
    )
    trace_fn, (p0, counter, streams) = tracer.trace_fn()

    def curve(log_scale):
        """Light curve with the absorption table scaled by exp(log_scale)."""
        med = dataclasses.replace(p0["medium"], absorption_coef=p0["medium"].absorption_coef * torch.exp(log_scale))
        state, _ = trace_fn({**p0, "medium": med}, counter, streams)
        return tracer.response.result(p0["response"], state)

    # hidden truth: absorption 1.35x the model's table
    with torch.no_grad():
        observed = curve(torch.tensor(math.log(1.35), device=tracer.device))

    def value_and_grad(x):
        s = torch.tensor(x, device=tracer.device, requires_grad=True)
        delta = (curve(s) - observed) / (observed.sum() + 1.0)
        loss = (delta * delta).sum() * 1e6
        loss.backward()
        return loss.item(), s.grad.item()

    x, m, v = 0.0, 0.0, 0.0  # start at scale 1.0; Adam state
    b1, b2 = 0.9, 0.999
    for step in range(1, steps + 1):
        lr = 0.3 / math.sqrt(step)  # decay against stochastic curvature
        value, g = value_and_grad(x)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        x = x - lr * (m / (1 - b1**step)) / (math.sqrt(v / (1 - b2**step)) + 1e-8)
        if step % 5 == 0 or step == 1:
            print(f"step {step:2d}: loss={value:.3e} scale={math.exp(x):.4f} (truth 1.3500)")
    err = abs(math.exp(x) / 1.35 - 1.0)
    print(f"recovered absorption scale: {math.exp(x):.4f} ({err * 100:.2f}% from truth)")
    return math.exp(x)


if __name__ == "__main__":
    args = argparse.ArgumentParser()
    args.add_argument("--device", default="cuda")
    args.add_argument("--batch", type=int, default=32 * 1024)
    main(**vars(args.parse_args()))
