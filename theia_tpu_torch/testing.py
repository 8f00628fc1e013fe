"""Testing helpers (reference: src/theia/testing.py): the analytic
water model that the gradient tests and examples build their media from.
The samplers of ``theia_tpu.testing`` are not ported yet."""

from __future__ import annotations

from .material import DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel

__all__ = ["WaterTestModel"]


class WaterTestModel(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    """Simple analytic water-like model for tests
    (reference: src/theia/testing.py:641-656)."""

    ModelName = "water_test"

    def __init__(self, *, mu_a=0.01, mu_s=0.05, g=0.9) -> None:
        DispersionFreeMedium.__init__(self, n=1.33, ng=1.36, mu_a=mu_a, mu_s=mu_s)
        HenyeyGreensteinPhaseFunction.__init__(self, g)
