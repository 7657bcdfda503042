"""Integer rounding, byte counts of parameter trees, and a readable byte
size: the reference's ``utils/misc.py`` without JAX (a tree here is
nested dicts, lists and tuples of torch tensors or numpy arrays)."""
from __future__ import annotations

import numpy as np


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _itemsize(leaf) -> int:
    dt = leaf.dtype
    if hasattr(dt, "itemsize"):         # torch.dtype (2.1+) or numpy
        return int(dt.itemsize)
    return int(np.dtype(dt).itemsize)


def tree_size_bytes(tree) -> int:
    """Bytes held by the tree's array leaves (leaves without a shape,
    such as Python numbers, count nothing)."""
    return int(sum(int(np.prod(leaf.shape)) * _itemsize(leaf)
                   for leaf in _leaves(tree) if hasattr(leaf, "shape")))


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"
