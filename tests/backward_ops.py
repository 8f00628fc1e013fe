#!/usr/bin/env python3
"""Count the aten operations of one geometry gradient step's backward, by
name and by the shapes they take: a helper of
``tests/test_torch_gather_pieces.py``, and a script. Run from the
repository root:

    python3 tests/backward_ops.py [--batch 1024] [--path 4] [--device cpu]

The step is ``tests/test_torch_grad_geometry.py``'s detector case
(``torch_flagship.build_grad_scene(..., "detector", batch)``): the
detector moved by ``ScenePack.translate_instance`` along a leaf, so that
``tri_data`` and ``inst_data`` carry its graph, and a loss linear in the
light curve. ``torch.profiler`` records the backward with shapes; the
script prints the operations that a slice, a select or an accumulation of
the backward makes (``slice_backward``, ``select_backward``, ``add_``,
``add``, ``zeros``, ``fill_``, ``copy_``), each by the shape of its first
input with the lane count written as N, and the ten most frequent
operations. A count, not a time: it says what the eager backward
launches, not how long a device takes for it.
"""

from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import theia_tpu_torch  # noqa: E402
from torch_flagship import build_grad_scene  # noqa: E402

#: the backward's operations that slices, selects and accumulations make
WATCH = ("aten::slice_backward", "aten::select_backward", "aten::add_", "aten::add", "aten::zeros",
         "aten::fill_", "aten::copy_")


def count(batch: int, path: int, device: str = "cpu") -> dict:
    """{(name, shape): count} of the backward's aten operations."""
    torch.manual_seed(0)
    tracer = build_grad_scene(theia_tpu_torch, "detector", batch, device, max_path=path)
    fn, (p, counter, streams) = tracer.trace_fn()
    shift = torch.zeros(3, requires_grad=True, device=device)
    curve = fn({**p, "scene": p["scene"].translate_instance(0, shift)}, counter, streams)[0]
    loss = (curve * torch.exp(-torch.linspace(0.0, 2.0, curve.shape[-1], device=device))).sum()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True) as prof:
        loss.backward()
    counts = collections.Counter()
    for e in prof.events():
        if not e.name.startswith("aten::"):
            continue
        shape = tuple(e.input_shapes[0]) if e.input_shapes and e.input_shapes[0] else ()
        counts[e.name, tuple("N" if d == batch else d for d in shape)] += 1
    return counts


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--path", type=int, default=4)
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    counts = count(args.batch, args.path, args.device)
    print(f"geometry step's backward on {args.device}, batch {args.batch}, path length {args.path}: "
          f"{sum(counts.values())} aten operations")
    for name in WATCH:
        mine = sorted(((shape, n) for (op, shape), n in counts.items() if op == name), key=lambda x: -x[1])
        print(f"  {name}: {sum(n for _, n in mine)}; " + ", ".join(f"{n} of {shape}" for shape, n in mine[:6]))
    by_name = collections.Counter()
    for (op, _), n in counts.items():
        by_name[op] += n
    print("  most frequent: " + ", ".join(f"{op} {n}" for op, n in by_name.most_common(10)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
