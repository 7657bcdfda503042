"""Parameter conversion from the JAX package's trees to the port's dicts,
so both packages compute the same thing from the same weights.

The input is the nested dicts of numpy arrays that
``jax.tree_util.tree_map(np.asarray, params)`` gives.  The reference
stores dense layers stacked along a leading axis under
``decoder/slots[0]`` and RWKV-6 layers under ``layers``; that axis is
split into the port's per-layer list.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


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


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device=None) -> Dict[str, Any]:
    """Reference target params (numpy leaves) -> the port's params."""
    dev = resolve_device(device)
    if cfg.arch_type == "ssm":
        stacked = tree["layers"]
    else:
        dec = tree["decoder"]
        if len(dec["slots"]) != 1 or dec.get("rem"):
            raise NotImplementedError("only dense stacks of one layer kind")
        stacked = dec["slots"][0]
    n = cfg.num_layers

    def layer(i):
        def pick(node):
            if isinstance(node, dict):
                return {k: pick(v) for k, v in node.items()}
            assert np.asarray(node).shape[0] == n, "leading axis is layers"
            return _tensor(np.asarray(node)[i], dev)
        return pick(stacked)

    out = {"embed": _tensor(tree["embed"], dev),
           "final_norm": _tensor(tree["final_norm"], dev),
           "layers": [layer(i) for i in range(n)]}
    if "head" in tree:
        out["head"] = _tensor(tree["head"], dev)
    return out


def draft_params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                            device=None) -> Dict[str, Any]:
    """Reference draft params (``init_draft_params``, numpy leaves) ->
    the port's draft params (the same nesting)."""
    return _map(tree, resolve_device(device))
