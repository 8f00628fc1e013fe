"""Unit system for theia_tpu_torch (same units and names as ``theia_tpu.units``).

Physical quantities are plain numbers annotated by multiplying with a unit
(``5.0 * u.m``) and converted back by dividing (``x / u.cm``) or via
:func:`convert`.  Internal base units are chosen so the speed of light is
~0.3 (reference conventions: src/theia/units.py:190-223):

* length:      meter  [m]
* time:        nanosecond [ns]
* wavelength:  nanometer [nm]  (its own dimension, like the reference)
* energy:      GeV
* angle:       radian

Units are *float subclasses*: they take part in any numeric expression,
including arithmetic with ``torch.Tensor``, with exact float semantics
while carrying the dimension/display metadata of the reference API
(``Unit``/``InverseUnit``/``CompoundUnit``/``convert``).

Known reference discrepancies (intentional, shared with ``theia_tpu``):
``eV`` is 1e-9 GeV and ``MeV`` exists (the reference scales ``eV`` as
1e-6 GeV and omits ``MeV``, src/theia/units.py:222-226).
"""

from __future__ import annotations

import math
from typing import Iterable, Literal, TypeVar

T = TypeVar("T")

__all__ = [
    "Dimension", "Unit", "InverseUnit", "CompoundUnit", "convert",
    # length
    "km", "m", "dm", "cm", "mm", "um_len", "inch", "ft", "yd", "mi",
    # inverse length
    "per_km", "per_m", "per_dm", "per_cm", "per_mm",
    # area
    "m2", "cm2", "mm2",
    # time
    "s", "ms", "us", "ns", "ps",
    # frequency
    "GHz", "MHz", "kHz", "Hz",
    # wavelength
    "um", "nm",
    # angle
    "rad", "deg",
    # energy
    "PeV", "TeV", "GeV", "MeV", "keV", "eV",
    # physics constants
    "c", "speed_of_light",
]

Dimension = Literal[
    "length", "time", "wavelength", "compound", "energy", "angle",
    "area", "frequency",
]


class Unit(float):
    """A conversion factor to the library's internal unit, usable directly
    in arithmetic (it *is* a float) while carrying dimension metadata
    (reference API: src/theia/units.py:62-117).

    ``value * unit`` annotates (converts into internal units) and
    ``value / unit`` converts back for display; tuples are annotated
    element-wise like the reference allows for positions."""

    _dim: Dimension
    _symbol: str

    def __new__(
        cls, dimension: Dimension, scale: float = 1.0, symbol: str = ""
    ) -> "Unit":
        self = super().__new__(cls, scale)
        self._dim = dimension
        self._symbol = symbol
        return self

    @property
    def dimension(self) -> Dimension:
        """Dimension this unit applies to."""
        return self._dim

    @property
    def scale(self) -> float:
        """Conversion factor to the internal unit."""
        return float(self)

    @property
    def symbol(self) -> str:
        """Display symbol (e.g. ``"cm"``)."""
        return self._symbol

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        sym = self._symbol or "?"
        return f"Unit({sym}: {self._dim}, scale={float(self)!r})"

    # tuple annotation (reference: units.py:100-117); everything else keeps
    # plain float semantics so numpy arrays and tensors are untouched
    def __rmul__(self, value):
        if type(value) is tuple:
            return tuple(v * float(self) for v in value)
        return float.__rmul__(self, value)

    def __rtruediv__(self, value):
        if type(value) is tuple:
            return tuple(v / float(self) for v in value)
        return float.__rtruediv__(self, value)


class InverseUnit(Unit):
    """The inverse of a base unit, e.g. ``per_m`` (reference:
    src/theia/units.py:108-137): multiplying by the inverse unit equals
    dividing by the base unit.  As a float its scale is ``1/base``."""

    def __new__(cls, unit: Unit, symbol: str = "") -> "InverseUnit":
        self = super().__new__(
            cls, unit.dimension, 1.0 / float(unit),
            symbol or (f"1/{unit.symbol}" if unit.symbol else ""),
        )
        self._unit = unit
        return self

    @property
    def base(self) -> Unit:
        """The unit this is the inverse of."""
        return self._unit


class CompoundUnit(Unit):
    """Unit built from a constant and nominator/denominator units, e.g.
    ``c = 299792458 m/s`` (reference: src/theia/units.py:139-185).  The
    scale is evaluated eagerly at construction."""

    def __new__(
        cls,
        const: float,
        nom: Iterable[Unit],
        denom: Iterable[Unit],
        symbol: str = "",
    ) -> "CompoundUnit":
        nom = list(nom)
        denom = list(denom)
        scale = const
        for n in nom:
            scale *= float(n)
        for d in denom:
            scale /= float(d)
        self = super().__new__(cls, "compound", scale, symbol)
        self._const = const
        self._nom = nom
        self._denom = denom
        return self


def convert(data: T, unit: Unit) -> T:
    """Convert internal-unit ``data`` to the given display unit; syntactic
    sugar for ``data / unit`` (reference: src/theia/units.py:226-231)."""
    return data / unit


# length (base: meter)
km = Unit("length", 1e3, "km")
m = Unit("length", 1.0, "m")
dm = Unit("length", 1e-1, "dm")
cm = Unit("length", 1e-2, "cm")
mm = Unit("length", 1e-3, "mm")
um_len = Unit("length", 1e-6, "um")
# imperial length (reference: src/theia/units.py:193-196)
inch = Unit("length", 0.0254, "in")
ft = Unit("length", 0.3048, "ft")
yd = Unit("length", 0.9144, "yd")
mi = Unit("length", 1609.344, "mi")

per_km = InverseUnit(km)
per_m = InverseUnit(m)
per_dm = InverseUnit(dm)
per_cm = InverseUnit(cm)
per_mm = InverseUnit(mm)

m2 = Unit("area", 1.0, "m^2")
cm2 = Unit("area", 1e-4, "cm^2")
mm2 = Unit("area", 1e-6, "mm^2")

# time (base: nanosecond)
s = Unit("time", 1e9, "s")
ms = Unit("time", 1e6, "ms")
us = Unit("time", 1e3, "us")
ns = Unit("time", 1.0, "ns")
ps = Unit("time", 1e-3, "ps")

# frequency (base: 1/ns = GHz)
GHz = Unit("frequency", 1.0, "GHz")
MHz = Unit("frequency", 1e-3, "MHz")
kHz = Unit("frequency", 1e-6, "kHz")
Hz = Unit("frequency", 1e-9, "Hz")

# wavelength (base: nanometer — its own dimension, like the reference)
# NOTE: ``um`` is a *wavelength* micron (1e3 nm) to match the reference API
# (src/theia/units.py:213) — use ``um_len`` for the length micron.
um = Unit("wavelength", 1e3, "um")
nm = Unit("wavelength", 1.0, "nm")

# angle (base: radian)
rad = Unit("angle", 1.0, "rad")
deg = Unit("angle", math.pi / 180.0, "deg")

# energy (base: GeV); physically correct scales (see module docstring)
PeV = Unit("energy", 1e6, "PeV")
TeV = Unit("energy", 1e3, "TeV")
GeV = Unit("energy", 1.0, "GeV")
MeV = Unit("energy", 1e-3, "MeV")
keV = Unit("energy", 1e-6, "keV")
eV = Unit("energy", 1e-9, "eV")

#: speed of light as a compound unit, 299792458 m/s = 0.299792458 m/ns
c = CompoundUnit(299792458.0, [m], [s], "c")
#: speed of light in internal units [m/ns], as a plain float
speed_of_light = float(c)
