"""Volume tracing: the light curve of a spherical detector in scattering
water, on theia_tpu_torch (examples/01_volume_tracing.py of theia_tpu,
ported).

A water model, an isotropic source and a sphere target go through the
volume forward tracer into a time histogram; then the gradient of the
detected total with respect to the water's absorption table.

Run: python theia_tpu_torch/examples/01_volume_tracing.py [--device cpu] [--batch N]
(the card by default).
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import theia_tpu_torch.units as u
from theia_tpu_torch.light import SphericalLightSource, UniformWavelengthSource
from theia_tpu_torch.material import HenyeyGreensteinPhaseFunction, MediumModel, WaterBaseModel
from theia_tpu_torch.random import PhiloxRNG
from theia_tpu_torch.response import HistogramHitResponse
from theia_tpu_torch.target import SphereTarget
from theia_tpu_torch.trace import VolumeForwardTracer


class WaterModel(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
    """Sea water at 10 degC, 35 PSU salinity, g = 0.9 HG scattering."""

    def __init__(self) -> None:
        WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.9)


def main(device="cuda", batch: int = 64 * 1024, runs: int = 5) -> float:
    """Traces ``runs`` batches; returns the mean d(total)/d(mu_a)."""
    tracer = VolumeForwardTracer(
        batch,
        SphericalLightSource(position=(-1.0 * u.m, -7.0 * u.m, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        SphereTarget(position=(0.0, 0.0, 0.0), radius=5.0 * u.m),
        UniformWavelengthSource(lambdaRange=(400.0 * u.nm, 500.0 * u.nm)),
        HistogramHitResponse(nBins=100, binSize=5.0 * u.ns, t0=0.0),
        PhiloxRNG(key=0xC0FFEE),
        medium=WaterModel().createMedium(),
        nScattering=10,
        maxTime=500.0 * u.ns,
        device=device,
    )
    hist = sum(tracer.run()[0].double().cpu().numpy() for _ in range(runs)) / runs
    peak = int(hist.argmax())
    print(f"light curve: total={hist.sum():.4g} photons, peak bin={peak} ({peak * 5.0:.0f} ns)")

    # the gradient of the detected total with respect to the absorption table
    trace_fn, (p, counter, streams) = tracer.trace_fn()
    mu_a = p["medium"].absorption_coef.clone().requires_grad_(True)
    state, _ = trace_fn({**p, "medium": dataclasses.replace(p["medium"], absorption_coef=mu_a)}, counter, streams)
    tracer.response.result(p["response"], state).sum().backward()
    dmu = float(mu_a.grad.mean())
    print(f"d(total)/d(mu_a): mean={dmu:.4g} (negative: more absorption, less light)")
    return dmu


if __name__ == "__main__":
    args = argparse.ArgumentParser()
    args.add_argument("--device", default="cuda")
    args.add_argument("--batch", type=int, default=64 * 1024)
    main(**vars(args.parse_args()))
