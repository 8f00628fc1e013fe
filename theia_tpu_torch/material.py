"""Media, materials and medium models.

A :class:`Medium` describes the optical properties of a medium as lookup
tables over a wavelength range (reference: src/theia/material.py:61-438,
src/theia/shader/material.glsl:11-97). Media and materials are built on
the host with numpy, as in ``theia_tpu.material``; :class:`MediumStore`
packs all media of a scene into stacked, padded tensors on one device,
addressed by integer handles, which :func:`lookup_packed` and
:func:`packed_medium_constants` read per lane.
"""

from __future__ import annotations

import importlib.resources
import re
import warnings
from dataclasses import dataclass, field
from enum import IntFlag
from typing import Final

import numpy as np
import torch

from . import units as u
from .component import resolve_device
from .lookup import as_table
from .ops.table_read import clip01, read_packed, read_table

__all__ = [
    "speed_of_light",
    "Medium",
    "MediumConstants",
    "normalize_lambda",
    "medium_constants",
    "MaterialFlags",
    "parseMaterialFlags",
    "Material",
    "MediumStore",
    "MaterialStore",
    "packed_medium_constants",
    "lookup_packed",
    "MediumModel",
    "SellmeierEquation",
    "BK7Model",
    "HenyeyGreensteinPhaseFunction",
    "DispersionFreeMedium",
    "WaterBaseModel",
]

speed_of_light: Final[float] = 1.0 * u.c
"""speed of light in internal units [m/ns]"""

_TABLE_PROPS = (
    "refractive_index",
    "group_velocity",
    "absorption_coef",
    "scattering_coef",
    "log_phase_function",
    "phase_sampling",
    "phase_m12",
    "phase_m22",
    "phase_m33",
    "phase_m34",
)


@dataclass(frozen=True)
class Medium:
    """Optical properties of a medium as tables over [lambda_min,
    lambda_max]. ``None`` selects the physical default (n=1, vg=c,
    mu_a=mu_s=0, isotropic phase function). Built on the host with numpy;
    :meth:`to` gives the same medium with float32 tensors on a device,
    which is what a single-medium tracer reads (and differentiates)."""

    lambda_min: float
    lambda_max: float
    refractive_index: np.ndarray | None = None
    group_velocity: np.ndarray | None = None
    absorption_coef: np.ndarray | None = None
    scattering_coef: np.ndarray | None = None
    log_phase_function: np.ndarray | None = None
    phase_sampling: np.ndarray | None = None
    phase_m12: np.ndarray | None = None
    phase_m22: np.ndarray | None = None
    phase_m33: np.ndarray | None = None
    phase_m34: np.ndarray | None = None
    name: str = "unnamed"

    def to(self, device) -> "Medium":
        """This medium with the wavelength range and every table as float32
        tensors on ``device``."""
        def f32(a):
            if a is None:
                return None
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a, np.float32)
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return Medium(
            f32(self.lambda_min), f32(self.lambda_max),
            **{k: f32(getattr(self, k)) for k in _TABLE_PROPS}, name=self.name,
        )


@dataclass(frozen=True)
class MediumConstants:
    """Wavelength-resolved medium properties used along a ray
    (reference: src/theia/shader/material.glsl:46-74)."""

    n: torch.Tensor
    vg: torch.Tensor
    mu_s: torch.Tensor
    mu_e: torch.Tensor


def normalize_lambda(medium: Medium, wavelength: torch.Tensor) -> torch.Tensor:
    return clip01((wavelength - medium.lambda_min) / (medium.lambda_max - medium.lambda_min))


def medium_constants(medium: Medium | None, wavelength: torch.Tensor) -> MediumConstants:
    """The medium's constants at each lane's wavelength; ``None`` means
    vacuum (the reference's null-pointer medium). ``medium`` holds tensors
    on the wavelengths' device (:meth:`Medium.to`)."""
    if medium is None:
        one, zero = torch.ones_like(wavelength), torch.zeros_like(wavelength)
        return MediumConstants(n=one, vg=one * speed_of_light, mu_s=zero, mu_e=zero)
    # the four tables at normalize_lambda's t, which each read clips again,
    # in one read
    tables = tuple(as_table(getattr(medium, kind), wavelength.device) for kind in _CONST4_KINDS)
    mu_a, mu_s, n, vg = read_table(
        tables, wavelength, _CONST4_NULLS, bounds=(medium.lambda_min, medium.lambda_max), clips=2
    )
    return MediumConstants(n=n, vg=vg, mu_s=mu_s, mu_e=mu_a + mu_s)


#################################### MATERIAL ##################################


class MaterialFlags(IntFlag):
    """Bit flags specifying ray behavior at a material boundary
    (reference: src/theia/material.py:441-511, material.glsl:79-86).
    All bits are below 2^31, so int32 tensors hold them."""

    BLACK_BODY = 0x01
    DETECTOR = 0x02
    LIGHT_SOURCE = 0x04
    NO_REFLECT_FWD = 0x08
    NO_REFLECT_BWD = 0x10
    NO_REFLECT = 0x18
    NO_TRANSMIT_FWD = 0x20
    NO_TRANSMIT_BWD = 0x40
    NO_TRANSMIT = 0x60
    VOLUME_BORDER = 0x80


_materialFlagsMap = {
    "B": MaterialFlags.BLACK_BODY,
    "D": MaterialFlags.DETECTOR,
    "L": MaterialFlags.LIGHT_SOURCE,
    "R": MaterialFlags.NO_REFLECT,
    "Rbf": MaterialFlags.NO_REFLECT,
    "Rfb": MaterialFlags.NO_REFLECT,
    "Rb": MaterialFlags.NO_REFLECT_BWD,
    "Rf": MaterialFlags.NO_REFLECT_FWD,
    "T": MaterialFlags.NO_TRANSMIT,
    "Tbf": MaterialFlags.NO_TRANSMIT,
    "Tfb": MaterialFlags.NO_TRANSMIT,
    "Tb": MaterialFlags.NO_TRANSMIT_BWD,
    "Tf": MaterialFlags.NO_TRANSMIT_FWD,
    "V": MaterialFlags.VOLUME_BORDER,
}


def parseMaterialFlags(flags: str) -> MaterialFlags:
    """Parse a material-flag string (reference grammar,
    src/theia/material.py:532-557): starts from NO_REFLECT|NO_TRANSMIT and
    each token XORs its flag, so "T" *enables* transmission etc."""
    tokens = re.findall(r"[A-Z][a-z]*", flags)
    result = MaterialFlags.NO_REFLECT | MaterialFlags.NO_TRANSMIT
    for token in tokens:
        if token in _materialFlagsMap:
            result ^= _materialFlagsMap[token]
        else:
            raise ValueError(f"Unknown material flag '{token}'")
    return result


class Material:
    """Assigns media to the two sides of a geometry plus per-direction flags.

    ``inside``/``outside`` may be a Medium, a medium name (resolved by the
    store) or None (vacuum)."""

    def __init__(
        self,
        name: str,
        inside: Medium | str | None,
        outside: Medium | str | None,
        *,
        flags=MaterialFlags(0),
    ) -> None:
        self.name = name
        self.inside = inside
        self.outside = outside
        if isinstance(flags, tuple):
            self.flagsInward = self._parse(flags[0])
            self.flagsOutward = self._parse(flags[1])
        else:
            self.flagsInward = self._parse(flags)
            self.flagsOutward = self._parse(flags)

    @staticmethod
    def _parse(f) -> MaterialFlags:
        return parseMaterialFlags(f) if isinstance(f, str) else MaterialFlags(f)


################################# MEDIUM STORE #################################

#: handle of the vacuum pseudo-medium inside every store
VACUUM_HANDLE: Final[int] = 0

#: the four constants tables fused by packed_medium_constants, with their
#: null-table default values (reference null-pointer semantics)
_CONST4_KINDS = (
    "absorption_coef",
    "scattering_coef",
    "refractive_index",
    "group_velocity",
)
_CONST4_NULLS = (0.0, 0.0, 1.0, speed_of_light)


@dataclass(frozen=True)
class MediumStore:
    """All media packed into stacked, padded tables addressed by handle.

    Row 0 is always vacuum (all tables null). ``sizes[kind][m] == 0`` marks
    a null table, reproducing the reference's null-pointer defaults.
    ``const4_ok``: every medium's four constants tables share one length
    (or are null), so :func:`packed_medium_constants` reads them as one
    row per lane."""

    lambda_min: torch.Tensor  # f32[M]
    lambda_max: torch.Tensor  # f32[M]
    tables: dict[str, torch.Tensor]  # kind -> f32[M, Lmax]
    sizes: dict[str, torch.Tensor]  # kind -> i32[M]
    names: tuple[str, ...]
    const4_ok: bool = False

    @staticmethod
    def pack(media: list[Medium], *, device="cuda") -> "MediumStore":
        device = resolve_device(device)
        names = ["vacuum"] + [m.name for m in media]
        if len(set(names)) != len(names):
            raise ValueError("duplicate medium names")
        M = len(media) + 1
        lam_min = np.zeros(M, np.float32)
        lam_max = np.ones(M, np.float32)
        tables: dict[str, np.ndarray] = {}
        sizes: dict[str, np.ndarray] = {}
        for kind in _TABLE_PROPS:
            lens = [
                0 if getattr(m, kind) is None else int(getattr(m, kind).shape[0])
                for m in media
            ]
            vals = np.zeros((M, max([2, *lens])), np.float32)
            sz = np.zeros(M, np.int32)
            for i, m in enumerate(media):
                t = getattr(m, kind)
                if t is not None:
                    vals[i + 1, : t.shape[0]] = np.asarray(t)
                    sz[i + 1] = t.shape[0]
            tables[kind] = vals
            sizes[kind] = sz
        for i, m in enumerate(media):
            lam_min[i + 1] = float(m.lambda_min)
            lam_max[i + 1] = float(m.lambda_max)
        const4_ok = all(
            len({int(sizes[k][i]) for k in _CONST4_KINDS} - {0}) <= 1
            for i in range(M)
        )
        dev = lambda a: torch.as_tensor(a, device=device)
        return MediumStore(
            lambda_min=dev(lam_min),
            lambda_max=dev(lam_max),
            tables={k: dev(v) for k, v in tables.items()},
            sizes={k: dev(v) for k, v in sizes.items()},
            names=tuple(names),
            const4_ok=const4_ok,
        )

    def handle(self, name: str | None) -> int:
        """Integer handle of the medium with the given name (None = vacuum)."""
        if name is None:
            return VACUUM_HANDLE
        return self.names.index(name)


def lookup_packed(
    values: torch.Tensor, sizes: torch.Tensor, handle: torch.Tensor, t,
    null_value=0.0,
) -> torch.Tensor:
    """Per-lane linear interpolation in packed tables.

    values: f32[M, Lmax]; sizes: i32[M]; handle: integer tensor; t in [0,1].
    Lanes whose table is null (size 0) return ``null_value``. Each lane
    reads row ``j`` of its medium, ``v_j + l * (v_{j+1} - v_j)`` with the
    slope of the last column 0, as ``theia_tpu.material.lookup_packed``
    reads its (value, slope) pair rows; the read and its gradient are
    :func:`~theia_tpu_torch.ops.table_read.read_packed` (kernels on the
    card)."""
    return read_packed(values, sizes, handle, t, null_value)


def packed_medium_constants(
    store: MediumStore, handle: torch.Tensor, wavelength: torch.Tensor
) -> MediumConstants:
    """Per-lane medium constants by handle (handle 0 = vacuum).

    One :func:`~theia_tpu_torch.ops.table_read.read_packed` of the four
    constants tables at each lane's wavelength, normalized by its medium's
    bounds in the read. With ``const4_ok`` the tables are read as
    ``theia_tpu.material.packed_medium_constants`` stacks them into one
    (M, Lmax, 4) table (``shared``: one size, the largest; a null table its
    default across its own width, 0 in the padding) after one clip;
    otherwise as four ``lookup_packed`` reads of the clipped coordinate,
    which clip it again."""
    mu_a, mu_s, n, vg = read_packed(
        tuple(store.tables[k] for k in _CONST4_KINDS), tuple(store.sizes[k] for k in _CONST4_KINDS),
        handle, wavelength, _CONST4_NULLS, bounds=(store.lambda_min, store.lambda_max),
        clips=1 if store.const4_ok else 2, shared=store.const4_ok,
    )
    return MediumConstants(n=n, vg=vg, mu_s=mu_s, mu_e=mu_a + mu_s)


@dataclass(frozen=True)
class MaterialStore:
    """Packed media plus per-material medium handles and flags
    (reference: src/theia/material.py:884-1117)."""

    media: MediumStore
    inside: torch.Tensor  # i32[K] medium handle
    outside: torch.Tensor  # i32[K]
    flags_inward: torch.Tensor  # i32[K]
    flags_outward: torch.Tensor  # i32[K]
    material_names: tuple[str, ...] = field(default=())

    @staticmethod
    def pack(
        materials: list[Material], media: list[Medium] | None = None, *, device="cuda"
    ) -> "MaterialStore":
        """``media``: further media that no material names as an object,
        only by name (or that the scene's medium names)."""
        device = resolve_device(device)
        med: dict[str, Medium] = {}

        def add(m):
            if isinstance(m, Medium):
                if m.name in med and med[m.name] is not m:
                    raise ValueError(f"duplicate medium name {m.name}")
                med[m.name] = m

        for mat in materials:
            add(mat.inside)
            add(mat.outside)
        for m in media or []:
            add(m)
        store = MediumStore.pack(list(med.values()), device=device)

        def handle_of(m) -> int:
            if m is None:
                return VACUUM_HANDLE
            return store.handle(m.name if isinstance(m, Medium) else m)

        names = tuple(m.name for m in materials)
        if len(set(names)) != len(names):
            raise ValueError("duplicate material names")
        i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device=device)
        return MaterialStore(
            media=store,
            inside=i32([handle_of(m.inside) for m in materials]),
            outside=i32([handle_of(m.outside) for m in materials]),
            flags_inward=i32([int(m.flagsInward) for m in materials]),
            flags_outward=i32([int(m.flagsOutward) for m in materials]),
            material_names=names,
        )

    def material_handle(self, name: str) -> int:
        return self.material_names.index(name)


################################ MEDIUM MODELS #################################


def _data_file(name: str):
    return importlib.resources.files("theia_tpu_torch").joinpath("data").joinpath(name)


class MediumModel:
    """Base class for medium models: sampling functions -> Medium tables
    (reference: src/theia/material.py:1123-1256)."""

    ModelName = "noname"

    def refractive_index(self, wavelength):
        return None

    def group_velocity(self, wavelength):
        return None

    def absorption_coef(self, wavelength):
        return None

    def scattering_coef(self, wavelength):
        return None

    def log_phase_function(self, cos_theta):
        return None

    def phase_sampling(self, eta):
        return None

    def phase_m12(self, cos_theta):
        return None

    def phase_m22(self, cos_theta):
        return None

    def phase_m33(self, cos_theta):
        return None

    def phase_m34(self, cos_theta):
        return None

    def createMedium(
        self,
        lambda_min=200.0 * u.nm,
        lambda_max=800.0 * u.nm,
        num_lambda=1024,
        num_theta=1024,
        *,
        name: str | None = None,
    ) -> Medium:
        l = np.linspace(lambda_min, lambda_max, num_lambda)
        t = np.linspace(-1.0, 1.0, num_theta)
        e = np.linspace(0.0, 1.0, num_theta)

        def f32(x):
            return None if x is None else np.asarray(x, np.float32)

        return Medium(
            np.float32(lambda_min),
            np.float32(lambda_max),
            refractive_index=f32(self.refractive_index(l)),
            group_velocity=f32(self.group_velocity(l)),
            absorption_coef=f32(self.absorption_coef(l)),
            scattering_coef=f32(self.scattering_coef(l)),
            log_phase_function=f32(self.log_phase_function(t)),
            phase_sampling=f32(self.phase_sampling(e)),
            phase_m12=f32(self.phase_m12(t)),
            phase_m22=f32(self.phase_m22(t)),
            phase_m33=f32(self.phase_m33(t)),
            phase_m34=f32(self.phase_m34(t)),
            name=name if name is not None else self.ModelName,
        )


class SellmeierEquation:
    """Empirical dispersion model n^2 = 1 + sum_i B_i λ² / (λ² - C_i)
    with λ in nm (reference: src/theia/material.py:1259-1303)."""

    def __init__(self, B1, B2, B3, C1, C2, C3) -> None:
        self.B1, self.B2, self.B3 = B1, B2, B3
        self.C1, self.C2, self.C3 = C1, C2, C3

    def refractive_index(self, wavelength):
        L2 = np.square(np.asarray(wavelength) / u.nm)
        S = (
            self.B1 * L2 / (L2 - self.C1)
            + self.B2 * L2 / (L2 - self.C2)
            + self.B3 * L2 / (L2 - self.C3)
        )
        return np.sqrt(1.0 + S)

    def group_velocity(self, wavelength):
        wavelength = np.asarray(wavelength)
        n = self.refractive_index(wavelength)
        L = wavelength / u.nm
        L2 = np.square(wavelength)
        S = (
            self.B1 * self.C1 * L / np.square(L2 - self.C1)
            + self.B2 * self.C2 * L / np.square(L2 - self.C2)
            + self.B3 * self.C3 * L / np.square(L2 - self.C3)
        )
        grad = -S / n
        return 1.0 / (n - wavelength * grad) * u.c


class BK7Model(SellmeierEquation, MediumModel):
    """Schott N-BK7 glass: Sellmeier refractive index plus absorption from
    published transmission measurements (data: Schott N-BK7 datasheet;
    reference: src/theia/material.py:1305-1358)."""

    ModelName = "bk7"
    TransmissionTable = None

    def __init__(self) -> None:
        super().__init__(
            1.03961212,
            0.231792344,
            1.010469450,
            0.00600069867e6,
            0.0200179144e6,
            103.5606530e6,
        )
        if BK7Model.TransmissionTable is None:
            BK7Model.TransmissionTable = np.loadtxt(
                _data_file("bk7_transmission.csv"), delimiter=",", skiprows=2
            )

    def absorption_coef(self, wavelength):
        # Beer-Lambert on the two probe thicknesses; average the absorption
        # *lengths* weighted by thickness (thicker probe = better estimate)
        wavelength = np.asarray(wavelength)
        tbl = BK7Model.TransmissionTable
        with np.errstate(divide="ignore"):
            tau_10mm = -0.010 / np.log(tbl[:, 1])
            tau_25mm = -0.025 / np.log(tbl[:, 2])
            tau_avg = (10.0 * tau_10mm + 25.0 * tau_25mm) / 35.0
            tau = np.interp(wavelength / u.nm, tbl[:, 0], tau_avg)
            return np.reciprocal(tau) / u.m


class HenyeyGreensteinPhaseFunction:
    """Henyey-Greenstein phase function with analytic inverse-CDF sampling
    (reference: src/theia/material.py:1361-1419)."""

    def __init__(self, g: float = 0.0) -> None:
        if not -1.0 < g < 1.0:
            warnings.warn(
                "Asymmetry parameter outside the valid range (-1,1)!",
                RuntimeWarning,
            )
        self.g = g

    def log_phase_function(self, cos_theta):
        cos_theta = np.asarray(cos_theta)
        g = self.g
        return np.log(
            (1.0 - g**2) / np.power(1.0 + g**2 - 2 * g * cos_theta, 1.5) / (4.0 * np.pi)
        )

    def phase_sampling(self, eta):
        eta = np.asarray(eta)
        g = self.g
        if abs(g) < 1e-7:
            return 1.0 - 2.0 * eta
        return (1.0 + g**2 - ((1.0 - g**2) / (1 + g - 2.0 * g * eta)) ** 2) / (
            2.0 * g
        )


class DispersionFreeMedium(MediumModel):
    """Constant optical properties regardless of wavelength (debugging)
    (reference: src/theia/material.py:1517-1593)."""

    ModelName = "dispersion-free"

    def __init__(self, *, n=1.0, ng=1.0, mu_a=0.0, mu_s=0.0) -> None:
        self.n = n
        self.ng = ng
        self.mu_a = mu_a
        self.mu_s = mu_s

    def refractive_index(self, wavelength):
        return np.ones_like(wavelength) * self.n

    def group_velocity(self, wavelength):
        return np.ones_like(wavelength) / self.ng * u.c

    def absorption_coef(self, wavelength):
        return np.ones_like(wavelength) * self.mu_a

    def scattering_coef(self, wavelength):
        return np.ones_like(wavelength) * self.mu_s


class WaterBaseModel:
    """Optical properties of (sea) water: refractive index after the
    Millard & Seaver fit [MS90], absorption/scattering from Smith & Baker
    1981 measurements (reference: src/theia/material.py:1596-1790)."""

    DataTable = None

    # [MS90] fit coefficients
    A0 = 1.3280657
    L2 = -0.0045536802
    LM2 = 0.0025471707
    LM4 = 0.000007501966
    LM6 = 0.000002802632
    T1 = -0.0000052883907
    T2 = -0.0000030738272
    T3 = 0.000000030124687
    T4 = -2.0863178e-10
    TL = 0.000010508621
    T2L = 0.00000021282248
    T3L = -0.000000001705881
    S0 = 0.00019029121
    S1LM2 = 0.0000024239607
    S1T = -0.00000073960297
    S1T2 = 0.0000000089818478
    S1T3 = 1.2078804e-10
    STL = -0.0000003589495
    P1 = 0.0000015868363
    P2 = -1.574074e-11
    PLM2 = 0.000000010712063
    PT = -0.0000000094634486
    PT2 = 1.0100326e-10
    P2T2 = 5.8085198e-15
    P1S = -0.0000000011177517
    PTS = 5.7311268e-11
    PT2S = -1.5460458e-12

    def __init__(self, temperature: float, pressure: float, salinity: float) -> None:
        if not 0.0 <= temperature <= 30.0:
            warnings.warn(
                "Temperature is outside the models valid range of 0°-30°C",
                RuntimeWarning,
            )
        if not 0.0 <= pressure <= 11_000:
            warnings.warn(
                "Pressure is outside the models valid range of 0-11.000 dbar",
                RuntimeWarning,
            )
        if not 0.0 <= salinity <= 40.0:
            warnings.warn(
                "Salinity is outside the models valid range of 0-40 psu",
                RuntimeWarning,
            )
        self.temperature = temperature
        self.pressure = pressure
        self.salinity = salinity
        if WaterBaseModel.DataTable is None:
            WaterBaseModel.DataTable = np.loadtxt(
                _data_file("water_smith81.csv"), delimiter=",", skiprows=1
            )

    def refractive_index(self, wavelength):
        L = np.asarray(wavelength) / 1e3  # nm -> um (formula expects um)
        T, p, S = self.temperature, self.pressure, self.salinity
        N1 = (
            self.A0
            + self.L2 * L**2
            + self.LM2 / L**2
            + self.LM4 / L**4
            + self.LM6 / L**6
            + self.T1 * T
            + self.T2 * T**2
            + self.T3 * T**3
            + self.T4 * T**4
            + self.TL * T * L
            + self.T2L * T**2 * L
            + self.T3L * T**3 * L
        )
        N2 = (
            self.S0 * S
            + self.S1LM2 * S / L**2
            + self.S1T * S * T
            + self.S1T2 * S * T**2
            + self.S1T3 * S * T**3
            + self.STL * S * T * L
        )
        N3 = (
            self.P1 * p
            + self.P2 * p**2
            + self.PLM2 * p / L**2
            + self.PT * p * T
            + self.PT2 * p * T**2
            + self.P2T2 * p**2 * T**2
        )
        N4 = self.P1S * p * S + self.PTS * p * T * S + self.PT2S * p * T**2 * S
        return N1 + N2 + N3 + N4

    def group_velocity(self, wavelength):
        L = np.asarray(wavelength) / 1e3  # nm -> um
        T, p, S = self.temperature, self.pressure, self.salinity
        G1 = (
            2.0 * self.L2 * L
            - 2.0 * self.LM2 / L**3
            - 4.0 * self.LM4 / L**5
            - 6.0 * self.LM6 / L**7
            + self.TL * T
            + self.T2L * T**2
            + self.T3L * T**3
        )
        G2 = -2.0 * self.S1LM2 * S / L**3 + self.STL * S * T
        G3 = -2.0 * self.PLM2 * p / L**3
        G = G1 + G2 + G3
        n = self.refractive_index(wavelength)
        return 1.0 / (n - L * G) * u.c

    def absorption_coef(self, wavelength):
        tbl = WaterBaseModel.DataTable
        return np.interp(np.asarray(wavelength) / u.nm, tbl[:, 0], tbl[:, 1]) / u.m

    def scattering_coef(self, wavelength):
        tbl = WaterBaseModel.DataTable
        return np.interp(np.asarray(wavelength) / u.nm, tbl[:, 0], tbl[:, 2]) / u.m
