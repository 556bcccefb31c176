"""The params tree's leaves in the reference's flattening order.

A tree is nested dicts and lists whose leaves are tensors, or shapes
(tuples of ints, as `repro_torch.models.Model.param_shapes` gives them).
`flatten` walks it as ``jax.tree_util.tree_flatten_with_path`` walks the
reference's pytree: dict keys sorted, list items in order, and each path
is the keys and indices joined by ``/`` (``prefix/0/attn/wq/w``). The
optimizer, the train step and the checkpoints share this order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the reference's order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, list):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, node in items:
        out.extend(flatten(node, f"{prefix}/{key}" if prefix else key))
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(template: Any, new_leaves: List[Any]) -> Any:
    """``template``'s nesting with ``new_leaves`` in flattening order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree: Any) -> Any:
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])
