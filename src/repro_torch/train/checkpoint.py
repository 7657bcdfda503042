"""Flat-npz checkpoints in the reference's key layout (counterpart of
``repro/train/checkpoint.py``).

A tree is saved as the reference's tree (``convert.params_to_numpy`` /
``draft_params_to_numpy``: layers stacked under ``decoder/slots/0``),
one npz entry per leaf keyed by its path joined with ``/``
(``decoder/slots/0/attn/wq``), plus ``__step__``; so the reference's
``load_checkpoint`` reads a checkpoint the port wrote.  numpy has no
bf16, so bf16 leaves are stored as fp32 (exact) and cast back on load to
the dtype of the template's leaf.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import (draft_params_from_numpy,
                                 draft_params_to_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.train.optimizer import tree_leaves


def _is_target(params) -> bool:
    return "layers" in params         # draft trees hold one "layer"


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    """Nested dicts from ``/``-joined keys; a level whose keys are all
    digits becomes a list."""
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(root)


def save_checkpoint(path: str, cfg: ModelConfig, params, step: int = 0
                    ) -> None:
    """Save the port's target or draft params at ``path`` (``.npz``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tree = (params_to_numpy(cfg, params) if _is_target(params)
            else draft_params_to_numpy(params))
    flat = _flatten(tree)
    flat["__step__"] = np.asarray(step)
    np.savez(path, **flat)


def load_checkpoint(path: str, cfg: ModelConfig, template
                    ) -> Tuple[Any, int]:
    """Restore the params saved at ``path`` into the structure, dtypes and
    devices of ``template`` (the port's target or draft params).
    Returns (params, step)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    flat = {k: data[k] for k in data.files if k != "__step__"}
    step = int(data["__step__"]) if "__step__" in data.files else 0
    tree = _unflatten(flat)
    dev = tree_leaves(template)[0].device
    if _is_target(template):
        tree.setdefault("decoder", {}).setdefault("rem", [])
        loaded = params_from_numpy(cfg, tree, device=dev)
    else:
        loaded = draft_params_from_numpy(cfg, tree, device=dev)
    return _cast_like(loaded, template), step


def _cast_like(tree, template):
    if isinstance(template, dict):
        if set(tree) != set(template):
            raise ValueError(f"checkpoint keys {sorted(tree)} differ from "
                             f"the template's {sorted(template)}")
        return {k: _cast_like(tree[k], template[k]) for k in template}
    if isinstance(template, list):
        if len(tree) != len(template):
            raise ValueError("checkpoint layer count differs from the "
                             "template's")
        return [_cast_like(a, b) for a, b in zip(tree, template)]
    if tuple(tree.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {tuple(tree.shape)} against the "
                         f"template's {tuple(template.shape)}")
    return tree.to(template.dtype)
