"""Carry a ``theia_tpu`` tracer's parameters over to the PyTorch port.

:func:`params_from_numpy` takes the JAX tracer's ``params()`` as a nested
mapping of numpy arrays keyed by the JAX field names — for example
``scene.tri_data``, ``scene.mt.tri``, ``scene.media.tables[kind]``,
``lightSource._contribFwd`` and ``response.t0`` — with the static fields
(``scene.media.names``, ``scene.media.const4_ok``, ``scene.mt.n_tri``) as
plain Python values, and returns the port tracer's params on ``device``.
Fields the port does not use (the brute-force soup ``w_v0``/``w_e1``/
``w_e2``, ``shadow_split``) are ignored. It imports neither jax nor
theia_tpu: flattening the JAX pytree is the caller's side.
"""

from __future__ import annotations

import numpy as np
import torch

from .material import MediumStore
from .ops.intersect_mt import MTPack
from .scene import ScenePack

__all__ = ["params_from_numpy"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:  # torch has no full uint32 arithmetic
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a), device=device)


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _scene_pack(s, device) -> ScenePack:
    media, mt = s["media"], s["mt"]
    store = MediumStore(
        lambda_min=_tensor(media["lambda_min"], device),
        lambda_max=_tensor(media["lambda_max"], device),
        tables=_tensors(dict(media["tables"]), device),
        sizes=_tensors(dict(media["sizes"]), device),
        names=tuple(media["names"]),
        const4_ok=bool(media["const4_ok"]),
    )
    return ScenePack(
        tri_data=_tensor(s["tri_data"], device),
        inst_data=_tensor(s["inst_data"], device),
        media=store,
        medium=_tensor(s["medium"], device).to(torch.int32),
        lower_bbox=_tensor(s["lower_bbox"], device),
        upper_bbox=_tensor(s["upper_bbox"], device),
        mt=MTPack(
            _tensor(mt["tri"], device),
            mt["aabb"],
            mt["lo"],
            mt["hi"],
            int(mt["n_tri"]),
        ),
    )


def params_from_numpy(tree, device) -> dict:
    """The port's tracer params from a JAX tracer's params as numpy."""
    return {
        stage: _scene_pack(sub, device) if stage == "scene" else _tensors(sub, device)
        for stage, sub in tree.items()
    }
