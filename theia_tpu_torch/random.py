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

:class:`SobolQRNG` is ``theia_tpu``'s Owen-scrambled Sobol generator
(Burley, "Practical Hash-based Owen Scrambling", JCGT 2020), bit for
bit: :func:`sobol_owen_uniform` launches ``csrc/sobol.cu`` on a CUDA
tensor and runs :func:`sobol_owen_uniform_plain` on a CPU tensor.
"""

from __future__ import annotations

import struct
import warnings
from dataclasses import dataclass, replace
from os import urandom

import numpy as np
import torch

from . import _build

__all__ = [
    "Key",
    "Counter",
    "RNGBufferSink",
    "rng_buffer",
    "philox4x32",
    "philox_uniform",
    "philox_uniform_plain",
    "uniform_from_bits",
    "PhiloxRNG",
    "RNGState",
    "RNG",
    "SobolQRNG",
    "SobolState",
    "sobol_direction_numbers",
    "sobol_owen_uniform",
    "sobol_owen_uniform_plain",
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


def _lanes(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _int32_bits(words: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 as the int32 tensor of the same bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def rng_buffer(
    rng: "RNG",
    n_streams: int,
    n_draws: int,
    *,
    base_stream: int = 0,
    base_count: int = 0,
    device="cuda",
) -> torch.Tensor:
    """A (n_streams, n_draws) float32 buffer of uniform draws for host-side
    statistical tests (reference: src/theia/random.py:44-199
    RNGBufferSink): draw ``base_count + j`` of stream ``base_stream + i``.

    A generator without the Philox key words (:class:`SobolQRNG`) is sent
    to its own :meth:`~SobolQRNG.sample`, whose draws a stream stop at
    ``dims``: asking for more raises instead of truncating."""
    if not hasattr(rng, "key_words"):
        buf = rng.sample(base_stream + n_streams, device=device)
        if base_count + n_draws > buf.shape[1]:
            raise ValueError(
                f"generator provides {buf.shape[1]} draws per stream but "
                f"{base_count + n_draws} were requested (raise dims=)"
            )
        return buf[base_stream:, base_count : base_count + n_draws]
    lanes = _lanes(n_streams * n_draws, device)
    streams = (lanes // n_draws + base_stream).to(torch.int32)
    draws = (lanes % n_draws + base_count).to(torch.int32)
    out = philox_uniform(rng.key_words, rng.counter_words, streams, draws)
    return out.reshape(n_streams, n_draws)


# ---------------------------------------------------------------------------
# Owen-scrambled Sobol
# ---------------------------------------------------------------------------
#
# theia_tpu's replacement for the reference's broken GPU Sobol sampler
# (reference: src/theia/random.py:285-352): per lane the sample index is
# shuffled with a nested uniform scramble, the Sobol value of the asked
# dimension is an XOR fold of the direction numbers (scipy's Joe-Kuo
# table) over the shuffled index's set bits, and the result is
# Owen-scrambled with a hash seed per dimension. Dimensions past the table
# draw Philox words keyed on the scramble seed. The helpers below take
# uint32 words held in int64 tensors (or Python ints) and keep every
# product inside int64 by splitting the constant into 16-bit halves.

_LK = (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6)
_H1, _H2 = 0x21F0AAAD, 0xD35A2D97
#: xored into the seed before hashing it into the index scramble's seed
_SHUFFLE_SALT = 0xA511E9B3


def _mul32(x, c: int):
    """Low 32 bits of x * c for uint32 words x held in int64 and a
    constant c < 2^32; every partial product stays below 2^49."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK


def _reverse_bits32(x):
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _MASK


def _laine_karras(x, seed):
    """Hash whose output bit i depends only on input bits <= i (Laine and
    Karras 2011 as hashed by Burley 2020)."""
    x = (x + seed) & _MASK
    for c in _LK:
        x = x ^ _mul32(x, c)
    return x


def _nested_uniform_scramble(x, seed):
    """Owen scramble of the binary radical-inverse domain (Burley 2020 §3)."""
    return _reverse_bits32(_laine_karras(_reverse_bits32(x), seed))


def _hash32(x):
    """Finalizing integer hash (Burley 2020, listing 5)."""
    x = x ^ (x >> 16)
    x = _mul32(x, _H1)
    x = x ^ (x >> 15)
    x = _mul32(x, _H2)
    return x ^ (x >> 15)


_SOBOL_DIRECTIONS: dict[int, np.ndarray] = {}
_SOBOL_TABLES: dict[tuple[int, str], torch.Tensor] = {}


def sobol_direction_numbers(dims: int) -> np.ndarray:
    """(dims, 32) uint32 direction numbers (Joe-Kuo, through scipy's
    ``qmc.Sobol``), the table ``theia_tpu`` reads; cached by ``dims``."""
    if dims not in _SOBOL_DIRECTIONS:
        from scipy.stats import qmc

        engine = qmc.Sobol(dims, scramble=False, bits=32)
        _SOBOL_DIRECTIONS[dims] = np.asarray(engine._sv, dtype=np.uint32)
    return _SOBOL_DIRECTIONS[dims]


def _direction_table(dims: int, device) -> torch.Tensor:
    """The direction numbers as an int32 tensor of their bits on
    ``device`` (what the kernel reads); cached by dims and device."""
    key = (dims, str(torch.device(device)))
    if key not in _SOBOL_TABLES:
        words = sobol_direction_numbers(dims).view(np.int32)
        _SOBOL_TABLES[key] = torch.as_tensor(words.copy(), device=device)
    return _SOBOL_TABLES[key]


def _byte_table(dirs: torch.Tensor) -> torch.Tensor:
    """The direction rows of ``dirs`` as XOR tables of the index's bytes,
    what the kernel of ``csrc/sobol.cu`` reads: (dims, 4, 256) int32 on the
    table's device, entry [d, k, x] the XOR of words 8k + j of row d over
    the set bits j of x, so that a draw's fold is four lookups. Made on the
    host from the table's words once, and kept on ``dirs`` until it is
    edited (its version moves)."""
    held = getattr(dirs, "_theia_byte_table", None)
    if held is not None and held[0] == dirs._version:
        return held[1]
    rows = dirs.detach().cpu().numpy().view(np.uint32).reshape(-1, 4, 8)  # (dims, byte k, bit j)
    x = np.arange(256)
    table = np.zeros((rows.shape[0], 4, 256), dtype=np.uint32)
    for j in range(8):
        table ^= np.where(((x >> j) & 1)[None, None, :] == 1, rows[:, :, j, None], np.uint32(0))
    out = torch.as_tensor(table.view(np.int32), device=dirs.device)
    dirs._theia_byte_table = (dirs._version, out)
    return out


def _check_table(dirs: torch.Tensor, stream: torch.Tensor) -> None:
    if dirs.dtype != torch.int32 or dirs.dim() != 2 or dirs.shape[1] != 32 or not dirs.is_contiguous():
        raise ValueError("dirs must be a contiguous (dims, 32) int32 tensor")
    if dirs.shape[0] < 1 or dirs.device != stream.device:
        raise ValueError("dirs must hold at least one dimension on the lanes' device")


def _sobol_words(dirs: torch.Tensor, index: torch.Tensor, dim: torch.Tensor) -> torch.Tensor:
    """XOR of the direction rows of ``dim`` over the set bits of ``index``
    (uint32 words in int64), folded in halves."""
    rows = dirs.to(torch.int64)[dim] & _MASK  # (N, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=index.device)
    folded = torch.where(((index[:, None] >> shifts) & 1) == 1, rows, 0)
    while folded.shape[1] > 1:
        half = folded.shape[1] // 2
        folded = folded[:, :half] ^ folded[:, half:]
    return folded[:, 0]


def sobol_owen_uniform_plain(
    dirs: torch.Tensor,
    seed: int,
    stream: torch.Tensor,
    dim: torch.Tensor,
    width: int = 1,
    offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`sobol_owen_uniform` (any device)."""
    _check_lanes(stream, dim)
    _check_table(dirs, stream)
    n_dims = dirs.shape[0]
    seed = int(seed) & _MASK
    index = ((stream.to(torch.int64) & _MASK) + (int(offset) & _MASK)) & _MASK
    # decorrelate paths: shuffle the sample index (aligned 2^m blocks map
    # to aligned 2^m blocks, which keeps the elementary intervals)
    idx = _nested_uniform_scramble(index, _hash32(seed ^ _SHUFFLE_SALT))
    out = []
    for j in range(width):
        d = (dim.to(torch.int64) + j) & _MASK
        value = _sobol_words(dirs, idx, torch.clamp_max(d, n_dims - 1))
        value = _nested_uniform_scramble(value, _hash32(d ^ _hash32(seed)))
        u = uniform_from_bits(value)
        tail = d >= n_dims
        if bool(tail.any()):
            # dimensions past the table: Philox keyed on (seed, hash(seed)),
            # a zero counter, the shuffled index as the stream
            key = (seed, _hash32(seed))
            words = philox_uniform_plain(
                key, (0, 0, 0, 0), _int32_bits(idx[tail]), _int32_bits(d[tail])
            )
            u = u.masked_scatter(tail, words)
        out.append(u)
    return out[0] if width == 1 else torch.stack(out, dim=-1)


def sobol_owen_uniform(
    dirs: torch.Tensor,
    seed: int,
    stream: torch.Tensor,
    dim: torch.Tensor,
    width: int = 1,
    offset: int = 0,
) -> torch.Tensor:
    """Dimensions ``dim .. dim + width - 1`` of the Owen-scrambled Sobol
    points ``stream + offset`` (mod 2^32) as float32 in [0, 1): shape (N,)
    for ``width`` 1, (N, width) otherwise, bit for bit
    ``theia_tpu.random.sobol_owen_uniform``.

    ``dirs``: the (dims, 32) direction numbers as int32 bits on the lanes'
    device; ``seed``: the scramble seed (host int); ``stream``, ``dim``:
    int32 (N,). A CUDA tensor launches the kernel of ``csrc/sobol.cu``,
    which reads the table's byte tables (:func:`_byte_table`, made at the
    table's first draw), a CPU tensor runs the plain version."""
    _check_lanes(stream, dim)
    _check_table(dirs, stream)
    if stream.device.type == "cpu":
        return sobol_owen_uniform_plain(dirs, seed, stream, dim, width, offset)
    if stream.device.type != "cuda":
        raise ValueError(f"sobol_owen_uniform: unsupported device {stream.device}")
    n = stream.shape[0]
    shape = (n,) if width == 1 else (n, width)
    out = torch.empty(shape, dtype=torch.float32, device=stream.device)
    seed = int(seed) & _MASK
    lib = _build.library()
    err = lib.theia_sobol_uniform(
        _byte_table(dirs).data_ptr(), dirs.shape[0], seed, _hash32(seed ^ _SHUFFLE_SALT), _hash32(seed),
        int(offset) & _MASK, stream.data_ptr(), dim.data_ptr(), n, width, out.data_ptr(),
        _build.stream_handle(stream.device),
    )
    _build.check(err, "sobol_owen_uniform")
    sobol_owen_uniform.launches += 1
    return out


sobol_owen_uniform.launches = 0


@dataclass(frozen=True)
class SobolState:
    """Per-lane cursor of the Owen-scrambled Sobol generator, in the
    tracers in :class:`RNGState`'s place: ``stream`` is the lane id (what
    host-buffer components index rows with), ``offset`` the batch's first
    sample index, their sum (mod 2^32) the lane's Sobol point, ``dim`` the
    Sobol dimension."""

    dirs: torch.Tensor  # int32 (D, 32) on the lanes' device
    seed: int
    offset: int
    stream: torch.Tensor  # int32 (N,)
    dim: torch.Tensor  # int32 (N,)

    @property
    def index(self) -> torch.Tensor:
        """The lanes' Sobol sample indices as int32 bits."""
        return _int32_bits(((self.stream.to(torch.int64) & _MASK) + self.offset) & _MASK)

    def uniform(self) -> tuple[torch.Tensor, "SobolState"]:
        u = sobol_owen_uniform(self.dirs, self.seed, self.stream, self.dim, offset=self.offset)
        return u, replace(self, dim=self.dim + 1)

    def uniform2d(self) -> tuple[tuple[torch.Tensor, torch.Tensor], "SobolState"]:
        u = sobol_owen_uniform(self.dirs, self.seed, self.stream, self.dim, 2, self.offset)
        return (u[:, 0], u[:, 1]), replace(self, dim=self.dim + 2)

    def skip(self, n: int) -> "SobolState":
        return replace(self, dim=self.dim + n)


class SobolQRNG(RNG):
    """Owen-scrambled Sobol quasi-random generator, usable as the ``rng``
    of any tracer (``theia_tpu.random.SobolQRNG``).

    Each light path takes one Sobol point; successive batches take
    successive blocks of ``capacity`` sample indices (keep the lane
    capacity a power of two for exact elementary-interval alignment).
    Dimensions past ``dims`` fall back to Philox words."""

    def __init__(self, *, seed: int = 0, dims: int = 64) -> None:
        self.seed = seed
        self.dims = dims
        self.offset = 0
        self.autoAdvance = 0

    def configure(self, n_draws: int, n_streams: int) -> None:
        if self.autoAdvance == 0:
            self.autoAdvance = n_streams
        if n_draws > self.dims:
            warnings.warn(
                f"tracer draws up to {n_draws} dims/path but SobolQRNG has "
                f"{self.dims} Sobol dims; the tail falls back to hash-based "
                "uniforms (increase dims= to extend QMC coverage)"
            )

    @property
    def counter_words(self) -> tuple[int, int, int, int]:
        """The batch offset and the scramble seed in a Philox counter's
        place (word 0 the offset, word 1 the seed): a new seed is a new
        Owen randomization of the same batch."""
        return (self.offset & _MASK, self.seed & _MASK, 0, 0)

    def state_for(self, counter, streams: torch.Tensor) -> SobolState:
        return SobolState(
            dirs=_direction_table(self.dims, streams.device),
            seed=int(counter[1]) & _MASK,
            offset=int(counter[0]) & _MASK,
            stream=streams,
            dim=torch.zeros_like(streams),
        )

    def state(self, stream: torch.Tensor, dim=0) -> SobolState:
        """State for the given int32 lane ids."""
        stream = stream.to(torch.int32)
        return replace(self.state_for(self.counter_words, stream), dim=torch.full_like(stream, dim))

    def sample(self, n: int, device="cuda") -> torch.Tensor:
        """The (n, dims) float32 buffer of the first ``dims`` dimensions of
        the next n points (the reference's RNGBufferSink analogue)."""
        lanes = _lanes(n * self.dims, device)
        st = self.state((lanes // self.dims).to(torch.int32))
        dims = (lanes % self.dims).to(torch.int32)
        return sobol_owen_uniform(st.dirs, st.seed, st.stream, dims, offset=st.offset).reshape(n, self.dims)

    def advance(self, n: int | None = None) -> None:
        self.offset += self.autoAdvance if n is None else n


# ---------------------------------------------------------------------------
# reference-style key/counter views and buffer sink
# ---------------------------------------------------------------------------


class Key:
    """64-bit Philox key as (lo, hi) 32-bit words
    (reference: src/theia/random.py:200-211)."""

    def __init__(self, value: int = 0) -> None:
        self.value = value

    @property
    def value(self) -> int:
        return self.lo + (self.hi << 32)

    @value.setter
    def value(self, value: int) -> None:
        self.lo = value & _MASK
        self.hi = (value >> 32) & _MASK

    @property
    def words(self) -> tuple[int, int]:
        """The (lo, hi) words the tracers take."""
        return (self.lo, self.hi)


class Counter:
    """128-bit Philox counter as four 32-bit words
    (reference: src/theia/random.py:214-224)."""

    def __init__(self, value: int = 0) -> None:
        self.value = value

    @property
    def value(self) -> int:
        return sum(self.word[i] << (32 * i) for i in range(4))

    @value.setter
    def value(self, value: int) -> None:
        self.word = [(value >> (32 * i)) & _MASK for i in range(4)]

    @property
    def words(self) -> tuple[int, int, int, int]:
        """The four words, lowest first, the tracers take."""
        return tuple(self.word)


class RNGBufferSink:
    """Fills a (streams, samples[, sampleDim]) buffer from a generator,
    consecutive numbers in consecutive streams
    (reference: src/theia/random.py:44-199).

    ``run()`` draws the next block on ``device``, keeps it in
    :attr:`buffer` as a host numpy array and advances the generator."""

    def __init__(
        self,
        generator: RNG,
        streams: int,
        samples: int,
        *,
        baseStream: int = 0,
        baseCount: int = 0,
        sampleDim: int = 1,
        device="cuda",
    ) -> None:
        if sampleDim not in (1, 2):
            raise ValueError("only sampleDim of 1 or 2 supported")
        self.generator = generator
        self.streams = streams
        self.samples = samples
        self.baseStream = baseStream
        self.baseCount = baseCount
        self.sampleDim = sampleDim
        self.device = device
        self.buffer = None

    def run(self) -> np.ndarray:
        draws = self.samples * self.sampleDim
        gen = self.generator
        out = rng_buffer(
            gen, self.streams, draws, base_stream=self.baseStream, base_count=self.baseCount,
            device=self.device,
        )
        if self.sampleDim == 2:
            out = out.reshape(self.streams, self.samples, 2)
        self.buffer = out.cpu().numpy()
        # Philox offsets count draws a stream; a Sobol generator counts
        # rows, so its next block of `streams` rows is the fresh one
        gen.advance(draws if hasattr(gen, "key_words") else self.streams)
        return self.buffer
