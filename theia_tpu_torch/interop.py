"""Carry a ``theia_tpu`` tracer's parameters over to the PyTorch port.

:func:`params_from_numpy` takes the JAX tracer's ``params()`` as a nested
mapping of numpy arrays keyed by the JAX field names — for example
``scene.tri_data``, ``scene.mt.tri`` or ``scene.woop.b``,
``scene.media.tables[kind]``, ``lightSource._contribFwd`` and
``response.t0`` — with the static fields (``scene.media.names``,
``scene.media.const4_ok``, ``scene.mt.n_tri``, ``scene.woop.n_tri``,
``scene.cull.spans``, ``scene.cull.is_det``) as plain Python values, and
returns the port tracer's params on ``device``. A volume or photon
tracer's ``medium`` comes as the mapping of a ``theia_tpu`` ``Medium``'s
fields (its tables, ``lambda_min``, ``lambda_max`` and ``name``; None for
vacuum) and becomes a :class:`~theia_tpu_torch.material.Medium` of
tensors; every other stage (``tracer``, ``photons``, ``lightSource``,
``target``, ``response``, ``callback``, ``guide``) maps to tensors.
The Woop pack's chunk-skip boxes come from the world triangles of
``tri_data``, which are in the same Morton order. A pack with ``bvh`` or
``instanced`` tables raises ``NotImplementedError``: those traversals are
not ported. A pack with none of ``mt``, ``woop``, ``bvh`` and
``instanced`` is a brute-force pack: its ``cull`` comes across as it is,
and the soup kernels' table is derived from the soup with one group an
instance. Every pack's soup ``w_v0``/``w_e1``/``w_e2`` and
``shadow_split`` come across as they are. It imports neither jax nor
theia_tpu: flattening the JAX pytree is the caller's side.
"""

from __future__ import annotations

import numpy as np
import torch

from .material import Medium, MediumStore
from .ops.intersect_mt import MTPack, chunk_boxes, sub_boxes
from .ops.intersect_woop import WoopPack
from .ops.intersect_soup import SoupTable
from .scene import CullTables, ScenePack, ShadowSplit, detector_instances, instance_spans

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


def _soup_fields(s, device) -> dict:
    """The world soup and the detector split, which every pack carries."""
    split = s.get("shadow_split")
    if split is not None:
        split = ShadowSplit(**{k: _tensor(v, device) for k, v in split.items()})
    fields = {k: _tensor(s[k], device) for k in ("w_v0", "w_e1", "w_e2")}
    return dict(fields, shadow_split=split)


def _brute_tables(s, device) -> dict:
    """The brute-force fields of the port's pack from the JAX pack's."""
    fields = _soup_fields(s, device)
    inst_data = np.asarray(s["inst_data"])
    spans = instance_spans(np.asarray(s["tri_data"])[:, 27], inst_data.shape[0])
    cull = s.get("cull")
    if cull is not None:
        cull = CullTables(
            _tensor(cull["centers"], device), _tensor(cull["radii"], device),
            spans=tuple(tuple(int(x) for x in span) for span in cull["spans"]),
            is_det=tuple(bool(d) for d in cull["is_det"]),
        )
    return dict(
        fields, soup=SoupTable(fields["w_v0"], fields["w_e1"], fields["w_e2"], spans),
        soup_is_det=detector_instances(inst_data), cull=cull,
    )


def _accel_tables(s, device) -> dict:
    """``{"mt": MTPack}``, ``{"woop": WoopPack}`` or the brute-force
    fields from the JAX pack's; a ``bvh`` or ``instanced`` pack raises, as
    ``Scene`` does for those names."""
    for accel in ("bvh", "instanced"):
        if s.get(accel) is not None:
            raise NotImplementedError(
                f"a theia_tpu pack with accel={accel!r} cannot be carried over: that traversal is not ported "
                "yet (ROADMAP.md: 'Instanced and BVH traversal'); accel='brute', 'mt' and 'woop' are"
            )
    if "mt" in s:
        mt = s["mt"]
        tables = MTPack(_tensor(mt["tri"], device), mt["aabb"], mt["lo"], mt["hi"], int(mt["n_tri"]))
        return dict(_soup_fields(s, device), mt=tables)
    if "woop" not in s:
        return _brute_tables(s, device)
    woop, rows = s["woop"], _tensor(s["tri_data"], device)
    n_tri = int(woop["n_tri"])
    world = [rows[:n_tri, c : c + 3] for c in (18, 21, 24)]
    boxes = chunk_boxes(*world), sub_boxes(*world)
    tables = WoopPack(_tensor(woop["b"], device), woop["aabb"], woop["lo"], woop["hi"], n_tri, *boxes)
    return dict(_soup_fields(s, device), woop=tables)


def _scene_pack(s, device) -> ScenePack:
    media = s["media"]
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
        **_accel_tables(s, device),
    )


def _medium(m, device) -> Medium | None:
    if m is None:
        return None
    fields = {k: v for k, v in m.items() if k != "name"}
    return Medium(**_tensors(fields, device), name=m.get("name", "unnamed"))


def params_from_numpy(tree, device) -> dict:
    """The port's tracer params from a JAX tracer's params as numpy."""
    convert = {"scene": _scene_pack, "medium": _medium}
    return {
        stage: convert.get(stage, _tensors)(sub, device) for stage, sub in tree.items()
    }
