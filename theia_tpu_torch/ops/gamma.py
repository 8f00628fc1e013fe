"""Gamma-distribution sampling (Cheng's GA rejection algorithm), as
``theia_tpu.ops.gamma``.

Lanes draw until every lane accepted, so a lane's later draws turn on the
slowest lane's rounds R: after the call every lane's dim is
``dim + 1 + 2 R`` (reference: src/theia/shader/random.gamma.glsl; the
reference documents the draw count as data-dependent,
src/theia/light.py:1633-1640). On a CUDA tensor :func:`sample_gamma`
launches the kernels of ``csrc/gamma.cu`` (a thread a lane runs round 1,
a block's queue the later rounds; R is taken on the card into a word
tagged with the call's number, and a second kernel, the first's
programmatic dependent, writes the new dims: no fill, no add, no host
wait); on a CPU tensor it runs :func:`sample_gamma_plain`,
``theia_tpu``'s loop in torch. The call sites detach the result (sampled
geometry is frozen).
"""

from __future__ import annotations

import threading
from dataclasses import replace

import numpy as np
import torch

from .. import _build
from ..random import RNGState, SobolState, _MASK, _SHUFFLE_SALT, _byte_table, _check_lanes, _hash32
from .math3d import sqrt

__all__ = ["sample_gamma", "sample_gamma_plain", "MAX_ROUNDS"]

#: (device index, stream handle) -> [the int64 word that the kernels' calls
#: on that stream share (the largest 1 + 2 rounds tagged with the call's
#: number), the last call's tag]; ``_SYNC_LOCK`` holds a call's tag and its
#: launches together, so the tags rise in the order of the launches on the
#: stream whatever host thread makes them. (A CUDA graph would replay a
#: captured tag: the port captures none.)
_SYNC: dict = {}
_SYNC_LOCK = threading.Lock()

#: rounds after which a lane that never accepted (alpha < 0 or NaN) exits
#: with NaN; Cheng's GA accepts with probability > 1/3 a round for valid alpha
MAX_ROUNDS = 64
#: float32(log(4)), ``jnp.log(4.0)``
_LOG4 = float(np.float32(np.log(4.0)))
_CLIP = (1e-7, 1.0 - 1e-7)


def sample_gamma_plain(alpha, rng, stats: dict | None = None):
    """Plain PyTorch version of :func:`sample_gamma` (any device): the
    rounds run while a lane has not accepted, each with a host wait.
    ``stats``, a dict, gets each lane's own rounds under ``"rounds"``
    (int32; 64 for a lane that never accepted)."""
    shape = rng.stream.shape
    alpha = torch.broadcast_to(torch.as_tensor(alpha, dtype=torch.float32, device=rng.stream.device), shape)
    # alpha < 1: rescale via Gamma(alpha + 1) * U^(1 / alpha)
    u0, rng = rng.uniform()
    small = alpha < 1.0
    scale = torch.where(small, torch.pow(u0, 1.0 / torch.clamp_min(alpha, 1e-6)), 1.0)
    a_eff = torch.where(small, alpha + 1.0, alpha)
    lam = sqrt(2.0 * a_eff - 1.0)
    b = a_eff - _LOG4
    c = a_eff + lam
    accepted = torch.zeros(shape, dtype=torch.bool, device=alpha.device)
    x = torch.zeros(shape, dtype=torch.float32, device=alpha.device)
    rounds = torch.zeros(shape, dtype=torch.int32, device=alpha.device)
    for _ in range(MAX_ROUNDS):
        if bool(accepted.all()):
            break
        (u1, u2), rng = rng.uniform2d()
        u1 = torch.clamp(u1, *_CLIP)
        v = torch.log(u1 / (1.0 - u1)) / lam
        cand = a_eff * torch.exp(v)
        ok = (b + c * v - cand) >= torch.log(u1 * u1 * u2)
        x = torch.where(~accepted & ok, cand, x)
        rounds = rounds + (~accepted).to(torch.int32)
        accepted = accepted | ok
    if stats is not None:
        stats["rounds"] = torch.where(accepted, rounds, MAX_ROUNDS)
    x = torch.where(accepted, x, torch.nan)
    return scale * x, rng


def sample_gamma(alpha, rng):
    """Gamma(alpha, 1) a lane, ``alpha`` broadcast to the lanes; returns
    (x, rng advanced by ``1 + 2 R``). ``rng``: an :class:`RNGState`
    (Philox) or :class:`SobolState`. A CUDA tensor launches the kernel of
    ``csrc/gamma.cu``, a CPU tensor runs the plain version."""
    stream = rng.stream
    _check_lanes(stream, rng.dim)
    if stream.device.type == "cpu":
        return sample_gamma_plain(alpha, rng)
    if stream.device.type != "cuda":
        raise ValueError(f"sample_gamma: unsupported device {stream.device}")
    n = stream.shape[0]
    a = torch.as_tensor(alpha, dtype=torch.float32, device=stream.device)
    if a.numel() == 1:
        a, a_stride = a.reshape(1).contiguous(), 0
    else:
        a, a_stride = torch.broadcast_to(a, (n,)).contiguous(), 1
    out = torch.empty(n, dtype=torch.float32, device=stream.device)
    dim_out = torch.empty(n, dtype=rng.dim.dtype, device=stream.device)
    if isinstance(rng, SobolState):
        seed = int(rng.seed) & _MASK
        gen = (_byte_table(rng.dirs).data_ptr(), rng.dirs.shape[0], seed, _hash32(seed ^ _SHUFFLE_SALT),
               _hash32(seed), int(rng.offset) & _MASK)
    elif isinstance(rng, RNGState):
        gen = (*(int(k) & _MASK for k in rng.key), *(int(c) & _MASK for c in rng.counter))
    else:
        raise TypeError(f"sample_gamma: no kernel for {type(rng).__name__}")
    lib = _build.library()
    fn = lib.theia_gamma_sobol if isinstance(rng, SobolState) else lib.theia_gamma_philox
    handle = _build.raw_stream(stream)
    key = (stream.get_device(), handle)
    with _SYNC_LOCK:
        sync = _SYNC.get(key)
        if sync is None or sync[1] >= _MASK:  # tags run 1, 2, ... below 2^32: a fill once in 2^32 calls
            sync = _SYNC[key] = [torch.zeros(1, dtype=torch.int64, device=stream.device), 0]
        sync[1] += 1
        word, tag = sync
        err = fn(*gen, a.data_ptr(), a_stride, stream.data_ptr(), rng.dim.data_ptr(), n, out.data_ptr(),
                 dim_out.data_ptr(), word.data_ptr(), tag, handle)
    _build.check(err, "sample_gamma")
    if n:
        sample_gamma.launches += 1
    return out, replace(rng, dim=dim_out)


sample_gamma.launches = 0
