"""Counter-based random number generation (Philox 4x32-10).

Same generator and stream/dimension addressing as ``theia_tpu.random``,
bit for bit (reference: src/theia/shader/random.philox.glsl:15-94,
src/theia/random.py:228-282). Draw ``i`` of stream ``s`` under base key
``K`` (64 bit) and base offset ``C`` (128 bit) is::

    block = philox4x32_10(key = K + s  (mod 2^64, carry rolls into low word),
                          ctr = C + 4*i (mod 2^128, carry rolls into low word))
    value = min(1 - 2^-24, float(block[i mod 4]) * 2^-32)

The key and counter words are host integers; per-lane streams and
dimensions are int32 tensors. On a CUDA tensor :func:`philox_uniform`
launches the hand-written kernel of ``csrc/philox.cu``; on a CPU tensor
it runs :func:`philox_uniform_plain`, which works on uint32 words held in
int64 with masks (torch has no full uint32 arithmetic).
"""

from __future__ import annotations

import struct
import warnings
from dataclasses import dataclass, replace
from os import urandom

import torch

from . import _build

__all__ = [
    "philox4x32",
    "philox_uniform",
    "philox_uniform_plain",
    "uniform_from_bits",
    "PhiloxRNG",
    "RNGState",
    "RNG",
]

# Philox 4x32 round multipliers and Weyl key schedule constants
_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK = 0xFFFFFFFF

#: largest float32 < 1.0
ONE_MINUS_EPSILON = struct.unpack("<f", struct.pack("<I", 0x3F7FFFFF))[0]
#: 2^-32
_EPSILON = 2.0**-32


def _mulhilo(m: int, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """32x32 -> 64 bit unsigned multiply of the constant ``m`` with uint32
    words ``a`` held in int64; returns (hi, lo). ``a`` is split into 16-bit
    halves so no partial product leaves the int64 range."""
    p_lo = m * (a & 0xFFFF)  # < 2^48
    p_hi = m * (a >> 16)  # < 2^48
    low = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (low >> 32), low & _MASK


def philox4x32(key0, key1, c0, c1, c2, c3, rounds: int = 10):
    """Philox 4x32 block cipher on uint32 words held in int64 tensors
    (or Python ints); counter words are little-endian (c0 = lowest).
    Returns the four output words."""
    k0, k1 = key0, key1
    x, y, z, w = c0, c1, c2, c3
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(_M0, torch.as_tensor(x))
        hi1, lo1 = _mulhilo(_M1, torch.as_tensor(z))
        x, y, z, w = hi1 ^ y ^ k0, lo1, hi0 ^ w ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return x, y, z, w


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Map uint32 bits (held in int64) to float32 in [0, 1) exactly like the
    reference (reference: src/theia/shader/random.util.glsl:8-13)."""
    return torch.clamp_max(bits.to(torch.float32) * _EPSILON, ONE_MINUS_EPSILON)


def _check_lanes(stream: torch.Tensor, dim: torch.Tensor) -> None:
    for name, a in (("stream", stream), ("dim", dim)):
        if a.dtype != torch.int32 or a.dim() != 1 or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-d int32 tensor")
    if stream.shape != dim.shape or stream.device != dim.device:
        raise ValueError("stream and dim must share shape and device")


def philox_uniform_plain(
    key: tuple[int, int],
    counter: tuple[int, int, int, int],
    stream: torch.Tensor,
    dim: torch.Tensor,
    width: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`philox_uniform` (any device)."""
    _check_lanes(stream, dim)
    s = stream.to(torch.int64) & _MASK
    # 64-bit key += stream, final carry rolls into the low word
    k0 = key[0] + s
    k1 = key[1] + (k0 >> 32)
    k0 = ((k0 & _MASK) + (k1 >> 32)) & _MASK
    k1 = k1 & _MASK
    out = []
    for j in range(width):
        d = (dim.to(torch.int64) + j) & _MASK
        # 128-bit counter += 4*dim, final carry rolls into the lowest word
        c0 = counter[0] + ((d << 2) & _MASK)
        c1 = counter[1] + (c0 >> 32)
        c2 = counter[2] + (c1 >> 32)
        c3 = counter[3] + (c2 >> 32)
        c0 = ((c0 & _MASK) + (c3 >> 32)) & _MASK
        x, y, z, w = philox4x32(
            k0, k1, c0, c1 & _MASK, c2 & _MASK, c3 & _MASK
        )
        sel = d & 3
        word = torch.where(
            sel == 0, x, torch.where(sel == 1, y, torch.where(sel == 2, z, w))
        )
        out.append(uniform_from_bits(word))
    return out[0] if width == 1 else torch.stack(out, dim=-1)


def philox_uniform(
    key: tuple[int, int],
    counter: tuple[int, int, int, int],
    stream: torch.Tensor,
    dim: torch.Tensor,
    width: int = 1,
) -> torch.Tensor:
    """Draws ``dim .. dim + width - 1`` of each lane's stream as float32 in
    [0, 1): shape (N,) for ``width`` 1, (N, width) otherwise.

    ``key``: base key words (lo, hi); ``counter``: base counter words
    (little-endian); ``stream``, ``dim``: int32 (N,). A CUDA tensor launches
    the kernel of ``csrc/philox.cu``, a CPU tensor runs the plain version."""
    _check_lanes(stream, dim)
    if stream.device.type == "cpu":
        return philox_uniform_plain(key, counter, stream, dim, width)
    if stream.device.type != "cuda":
        raise ValueError(f"philox_uniform: unsupported device {stream.device}")
    n = stream.shape[0]
    shape = (n,) if width == 1 else (n, width)
    out = torch.empty(shape, dtype=torch.float32, device=stream.device)
    lib = _build.library()
    err = lib.theia_philox_uniform(
        *(int(k) & _MASK for k in key),
        *(int(c) & _MASK for c in counter),
        stream.data_ptr(), dim.data_ptr(), n, width, out.data_ptr(),
        _build.stream_handle(stream.device),
    )
    _build.check(err, "philox_uniform")
    philox_uniform.launches += 1
    return out


philox_uniform.launches = 0


@dataclass(frozen=True)
class RNGState:
    """Per-lane RNG cursor: base key/counter words plus (stream, dim).

    Immutable; drawing returns the value(s) and an advanced state::

        u, rng = rng.uniform()
        (u1, u2), rng = rng.uniform2d()
    """

    key: tuple[int, int]
    counter: tuple[int, int, int, int]
    stream: torch.Tensor  # int32 (N,)
    dim: torch.Tensor  # int32 (N,)

    def uniform(self) -> tuple[torch.Tensor, "RNGState"]:
        u = philox_uniform(self.key, self.counter, self.stream, self.dim)
        return u, replace(self, dim=self.dim + 1)

    def uniform2d(self) -> tuple[tuple[torch.Tensor, torch.Tensor], "RNGState"]:
        u = philox_uniform(self.key, self.counter, self.stream, self.dim, width=2)
        return (u[:, 0], u[:, 1]), replace(self, dim=self.dim + 2)

    def skip(self, n: int) -> "RNGState":
        """Advance the dimension counter without drawing."""
        return replace(self, dim=self.dim + n)


class RNG:
    """Base class for random number generators (component interface,
    reference: src/theia/random.py:28-41)."""

    def state(self, stream, dim=0) -> RNGState:  # pragma: no cover - interface
        raise NotImplementedError

    def state_for(self, counter, streams: torch.Tensor) -> RNGState:
        """Per-lane state from one batch's (counter, streams)."""
        raise NotImplementedError

    def configure(self, n_draws: int, n_streams: int) -> None:
        """Called once by the tracer with its per-path draw budget and lane
        capacity; sets the default batch advance."""
        if getattr(self, "autoAdvance", 0) == 0:
            self.autoAdvance = n_draws


@dataclass
class PhiloxRNG(RNG):
    """Philox 4x32-10 generator with host-side offset bookkeeping.

    ``key``: 64-bit base key (random, with a warning, if None);
    ``offset``: draws skipped in every stream; ``autoAdvance``: what
    :meth:`advance` adds to ``offset`` (the tracer's ``nRNGSamples``)."""

    key: int | None = None
    offset: int = 0
    autoAdvance: int = 0

    def __post_init__(self) -> None:
        if self.key is None:
            self.key = int.from_bytes(urandom(8), "big")
            warnings.warn(f"Random RNG key generated: 0x{self.key:016X}")

    @property
    def key_words(self) -> tuple[int, int]:
        k = self.key & 0xFFFFFFFFFFFFFFFF
        return (k & _MASK, (k >> 32) & _MASK)

    @property
    def counter_words(self) -> tuple[int, int, int, int]:
        # the 128-bit counter advances 4 per draw (one philox block per draw)
        c = (4 * self.offset) & (2**128 - 1)
        return tuple((c >> (32 * i)) & _MASK for i in range(4))

    def state(self, stream: torch.Tensor, dim=0) -> RNGState:
        """State for the given int32 stream ids."""
        stream = stream.to(torch.int32)
        return RNGState(
            key=self.key_words,
            counter=self.counter_words,
            stream=stream,
            dim=torch.full_like(stream, dim),
        )

    def state_for(self, counter, streams: torch.Tensor) -> RNGState:
        return RNGState(
            key=self.key_words,
            counter=tuple(int(c) for c in counter),
            stream=streams,
            dim=torch.zeros_like(streams),
        )

    def advance(self, n: int | None = None) -> None:
        """Advance ``offset`` by n draws (default: ``autoAdvance``)."""
        self.offset += self.autoAdvance if n is None else n
