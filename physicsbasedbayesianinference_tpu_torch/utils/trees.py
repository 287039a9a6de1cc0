"""Tree helpers over dicts, lists and tuples of tensors (port of the JAX
package's ``utils/trees.py``). Leaves are visited as ``jax.tree_util``
visits them: dict keys in sorted order, sequences in order."""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _leaves(tree, path: str = ""):
    """``(path, leaf)`` for every leaf, the path in ``jax.tree_util
    .keystr``'s form (``['a'][0]``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return None if tree is None else next(leaves)


def ravel_ensemble(tree) -> Tuple[Tensor, Callable[[Tensor], object]]:
    """Flatten a per-walker tree (``{site: [W, ...]}``) into ``[W, D]``
    and an unravel function, which takes ``[..., D]`` back to the tree's
    structure with leaves ``[..., *site shape]``."""
    leaves = [leaf for _, leaf in _leaves(tree)]
    w = leaves[0].shape[0]
    shapes = [tuple(leaf.shape[1:]) for leaf in leaves]
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    flat = torch.cat([leaf.reshape(w, -1) for leaf in leaves], dim=-1)

    def unravel(q: Tensor):
        chunks = torch.split(q, sizes, dim=-1)
        return _rebuild(tree, iter(
            c.reshape(q.shape[:-1] + s) for c, s in zip(chunks, shapes)))

    return flat, unravel


def tree_bytes(tree) -> int:
    """Total bytes of the tensor (and numpy array) leaves."""
    total = 0
    for _, leaf in _leaves(tree):
        if isinstance(leaf, Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
    return total


def tree_summary(tree) -> str:
    """One line a leaf, its path, dtype, shape and device, for logging
    (the JAX package prints the sharding where this prints the
    device)."""
    lines = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, Tensor):
            dtype = str(leaf.dtype).removeprefix("torch.")
            lines.append(f"  {path}: {dtype}{list(leaf.shape)} @ "
                         f"{leaf.device}")
    return "\n".join(lines)
