"""Timing inference: recover group velocity from light-curve shape, on
theia_tpu_torch (examples/06_timing_calibration.py of theia_tpu, ported).

Hard-binned histograms freeze arrival times at the bin edges, but the
kernel (KDE) histogram is smooth in time, so gradients flow from the
light curve's shape back into parameters that shift arrival times. Here
a hidden scaling of the medium's group velocity is recovered from the
observed light curve; the kernel histogram's record and its backward run
on ``csrc/kernel_histogram.cu`` on the card.

Run: python theia_tpu_torch/examples/06_timing_calibration.py [--device cpu] [--batch N]
(the card by default).
"""

import argparse
import dataclasses
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch

from theia_tpu_torch.light import SphericalLightSource, UniformWavelengthSource
from theia_tpu_torch.random import PhiloxRNG
from theia_tpu_torch.response import KernelHistogramHitResponse
from theia_tpu_torch.target import SphereTarget
from theia_tpu_torch.testing import WaterTestModel
from theia_tpu_torch.trace import VolumeForwardTracer


def main(device="cuda", batch: int = 16 * 1024, steps: int = 12) -> float:
    """Fits the group-velocity scale; returns the recovered scale."""
    tracer = VolumeForwardTracer(
        batch,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        SphereTarget(position=(15.0, 0.0, 0.0), radius=4.0),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        KernelHistogramHitResponse(nBins=60, binSize=4.0, t0=0.0, bandwidth=4.0),
        PhiloxRNG(key=0x7157),
        medium=WaterTestModel(mu_a=0.001, mu_s=0.02, g=0.4).createMedium(),
        nScattering=6,
        maxTime=250.0,
        device=device,
    )
    trace_fn, (p0, counter, streams) = tracer.trace_fn()

    def curve(log_vg_scale):
        vg = p0["medium"].group_velocity * torch.exp(log_vg_scale)
        state, _ = trace_fn({**p0, "medium": dataclasses.replace(p0["medium"], group_velocity=vg)}, counter, streams)
        return tracer.response.result(p0["response"], state)

    with torch.no_grad():  # hidden: light 8% slower than the model
        observed = curve(torch.tensor(math.log(0.92), device=tracer.device))

    def value_and_grad(x):
        s = torch.tensor(x, device=tracer.device, requires_grad=True)
        d = (curve(s) - observed) / (observed.sum() + 1.0)
        loss = (d * d).sum() * 1e6
        loss.backward()
        return loss.item(), s.grad.item()

    x, m, v = 0.0, 0.0, 0.0
    b1, b2 = 0.9, 0.999
    for step in range(1, steps + 1):
        lr = 0.05 / math.sqrt(step)
        value, g = value_and_grad(x)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        x = x - lr * (m / (1 - b1**step)) / (math.sqrt(v / (1 - b2**step)) + 1e-8)
        if step % 4 == 0 or step == 1:
            print(f"step {step:2d}: loss={value:.3e} vg scale={math.exp(x):.4f} (truth 0.9200)")
    print(f"recovered group-velocity scale: {math.exp(x):.4f} ({abs(math.exp(x) / 0.92 - 1) * 100:.2f}% from truth)")
    return math.exp(x)


if __name__ == "__main__":
    args = argparse.ArgumentParser()
    args.add_argument("--device", default="cuda")
    args.add_argument("--batch", type=int, default=16 * 1024)
    main(**vars(args.parse_args()))
