"""Parameter conversion between the JAX package's trees and the port's
dicts, so both packages compute the same thing from the same weights.

The input is the nested dicts of numpy arrays that
``jax.tree_util.tree_map(np.asarray, params)`` gives.  The reference
stores RWKV-6 layers stacked along a leading axis under ``layers``; that
axis is split into the port's per-layer list.  Its other stacks keep one
stacked ``slots[j]`` per position j of their superblock pattern
(``models.dense.superblock_decomp``; leading axis: the superblocks) and
the remainder layers unstacked under ``rem``: layer ``s * len(pattern)
+ j`` is ``slots[j][s]``, the remainder follows.  A dense or MoE stack
is one slot of ``attn`` layers, the Whisper decoder one slot of ``dec``
layers, the VLM one slot per position of its (``attn`` x 4, ``cross``)
superblock (one superblock of the whole stack at a depth that is not a
multiple of 5); the trunk lives under ``decoder``, Griffin's at the top
level, the Whisper encoder's ``attn`` layers under ``encoder``.  The
other leaves (``embed``, ``head``, ``projector``, ``encoder_norm``,
``frame_pos``, ...) map one to one.  ``params_to_numpy`` and
``draft_params_to_numpy`` go back, re-stacking the layers, so a tree of
the port can be compared leaf for leaf with the reference's (and saved
in its checkpoint layout); bf16 leaves are widened to fp32, which is
exact, since numpy has no bf16 of its own.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.dense import superblock_decomp


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: reinterpret
        t = torch.from_numpy(np.array(a.view(np.uint16), copy=True))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map(tree, device):
    if isinstance(tree, dict):
        return {k: _map(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _pick(node, i, device):
    """Entry ``i`` of the stacked leading axis of every leaf of ``node``."""
    if isinstance(node, dict):
        return {k: _pick(v, i, device) for k, v in node.items()}
    return _tensor(np.asarray(node)[i], device)


def _stack_layers(kinds, tree, device):
    """The per-layer list of a reference stack ``{"slots", "rem"}`` of
    layer ``kinds``."""
    pattern, n_super, rem = superblock_decomp(tuple(kinds))
    if len(tree["slots"]) != len(pattern) or len(tree.get("rem") or []) \
            != len(rem):
        raise ValueError("the tree's slots / rem do not match the config's "
                         "layer pattern")
    for j, slot in enumerate(tree["slots"]):
        for leaf in _leaves(slot):
            if np.asarray(leaf).shape[0] != n_super:
                raise ValueError(f"slot {j}: the leading axis is not the "
                                 f"{n_super} superblocks")
    layers = [_pick(tree["slots"][g % len(pattern)], g // len(pattern),
                    device) for g in range(n_super * len(pattern))]
    return layers + [_map(lp, device) for lp in tree.get("rem") or []]


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device=None) -> Dict[str, Any]:
    """Reference target params (numpy leaves) -> the port's params."""
    dev = resolve_device(device)
    kinds = cfg.layer_kinds()
    if cfg.arch_type == "ssm":
        n = cfg.num_layers
        for leaf in _leaves(tree["layers"]):
            assert np.asarray(leaf).shape[0] == n, "leading axis is layers"
        layers = [_pick(tree["layers"], i, dev) for i in range(n)]
    elif cfg.arch_type == "hybrid":
        layers = _stack_layers(kinds, tree, dev)
    else:
        layers = _stack_layers(kinds, tree["decoder"], dev)
    out = {k: _map(v, dev) for k, v in tree.items()
           if k not in ("layers", "slots", "rem", "decoder", "encoder")}
    out["layers"] = layers
    if "encoder" in tree:
        out["encoder"] = _stack_layers(("attn",) * cfg.encoder_layers,
                                       tree["encoder"], dev)
    return out


def draft_params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                            device=None) -> Dict[str, Any]:
    """Reference draft params (``init_draft_params``, numpy leaves) ->
    the port's draft params (the same nesting)."""
    return _map(tree, resolve_device(device))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return _numpy(tree)


def params_to_numpy(cfg: ModelConfig, params: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """The port's target params -> the reference's tree (numpy leaves):
    the per-layer list stacked along a leading axis under ``layers`` for
    RWKV-6, else per superblock position under ``slots`` with the
    remainder under ``rem`` (under ``decoder`` for the attention trunks,
    at the top for Griffin; the encoder's under ``encoder``).  The
    inverse of ``params_from_numpy``."""
    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack([_numpy(n) for n in nodes])

    def slots(kinds, layers):
        pattern, n_super, _ = superblock_decomp(tuple(kinds))
        p = len(pattern)
        return {"slots": [stack(layers[j: n_super * p: p])
                          for j in range(p)],
                "rem": [_to_numpy(lp) for lp in layers[n_super * p:]]}

    layers = params["layers"]
    out = {k: _numpy(v) for k, v in params.items()
           if k not in ("layers", "encoder")}
    if cfg.arch_type == "ssm":
        out["layers"] = stack(layers)
    elif cfg.arch_type == "hybrid":
        out.update(slots(cfg.layer_kinds(), layers))
    else:
        out["decoder"] = slots(cfg.layer_kinds(), layers)
    if "encoder" in params:
        out["encoder"] = slots(("attn",) * cfg.encoder_layers,
                               params["encoder"])
    return out


def draft_params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's draft params -> the reference's tree (numpy leaves, the
    same nesting).  The inverse of ``draft_params_from_numpy``."""
    return _to_numpy(params)
