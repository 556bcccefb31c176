"""Random weights in the program's parameter layout, made on the device.

The shapes are the program's (`Model.param_shapes`), so the tree drops into
its forward as it is; the values are the benchmark's own: one normal draw
over one flat buffer in the served dtype from a generator seeded by the run's
seed, then each leaf scaled in place. Projections (and the router and the
experts) take ``fan_in ** -0.5``, the embedding and the biases 0.02, and a
norm scale is ``1 + 0.1 * z``, so that a bias or a scale the program drops,
applies twice or takes from the wrong layer moves the served tokens. The
same tree is handed to the program and to the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _leaves(shapes, path=()) -> List[Tuple[tuple, Tuple[int, ...]]]:
    if isinstance(shapes, dict):
        out = []
        for k, v in shapes.items():
            out += _leaves(v, path + (k,))
        return out
    if isinstance(shapes, list):
        out = []
        for i, v in enumerate(shapes):
            out += _leaves(v, path + (i,))
        return out
    return [(path, tuple(shapes))]


def _std(path: tuple, shape: Tuple[int, ...]) -> float:
    """The standard deviation of the leaf's draw (a norm scale's about
    one)."""
    if path[-1] == "scale":
        return 0.1
    if path[-1] == "b" or path[0] == "embed":
        return 0.02
    return float(shape[-2]) ** -0.5


def seed_generator(seed: int, tag: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, tag)``."""
    s = np.random.SeedSequence([int(seed), int(tag)]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(s[0]) << 31 | int(s[1]) >> 1)
    return g


def make_weights(shapes: Dict[str, Any], seed: int, dtype,
                 device) -> Dict[str, Any]:
    """A params tree of ``shapes`` (nested dicts and lists of shape tuples),
    drawn as the module docstring says."""
    leaves = _leaves(shapes)
    total = sum(int(np.prod(s)) for _, s in leaves)
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=seed_generator(seed, 0, device))
    tree: Dict[str, Any] = {}
    off = 0
    for path, shape in leaves:
        n = int(np.prod(shape))
        leaf = flat[off:off + n].view(shape)
        off += n
        leaf.mul_(_std(path, shape))
        if path[-1] == "scale":
            leaf.add_(1.0)
        node: Any = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = [] if isinstance(nxt, int) else {}
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int)
                                       else {})
        node[path[-1]] = leaf
    # an empty list of shapes (no prefix layers) has no leaf to make it
    for k, v in shapes.items():
        tree.setdefault(k, [] if isinstance(v, list) else {})
    return tree
