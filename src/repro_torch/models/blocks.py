"""Per-layer blocks, dense half: attention projections and the gated MLP
(counterpart of ``repro/models/blocks.py``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm


def init_attn_params(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    pd = cm.dt(cfg.param_dtype)
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    p = {"wq": cm.dense_init(gen, (d, h * dh), pd),
         "wk": cm.dense_init(gen, (d, hk * dh), pd),
         "wv": cm.dense_init(gen, (d, hk * dh), pd),
         "wo": cm.dense_init(gen, (h * dh, d), pd)}
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((h * dh,), dtype=pd, device=dev)
        p["bk"] = torch.zeros((hk * dh,), dtype=pd, device=dev)
        p["bv"] = torch.zeros((hk * dh,), dtype=pd, device=dev)
    return p


def project_q(cfg: ModelConfig, p: Dict, x, positions, inv_freq, mscale):
    """x: [B, T, d] -> roped q: [B, T, H, Dh]"""
    b, t, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim_)
    return cm.apply_rope(q, positions, inv_freq, mscale)


def project_kv(cfg: ModelConfig, p: Dict, x, positions, inv_freq, mscale,
               *, rope: bool = True):
    """x: [B, T, d] -> (k, v): [B, T, Hk, Dh]; k is roped so the cache
    stores position-encoded keys."""
    b, t, _ = x.shape
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim_)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim_)
    if rope:
        k = cm.apply_rope(k, positions, inv_freq, mscale)
    return k, v


def attn_output(cfg: ModelConfig, p: Dict, attn):
    """attn: [B, T, H, Dh] -> [B, T, d]"""
    b, t, h, dh = attn.shape
    return attn.reshape(b, t, h * dh) @ p["wo"].to(attn.dtype)


def init_mlp_params(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    pd = cm.dt(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act in ("silu", "gelu"):  # gated
        return {"wi": cm.dense_init(gen, (d, f), pd),
                "wg": cm.dense_init(gen, (d, f), pd),
                "wo": cm.dense_init(gen, (f, d), pd)}
    return {"wi": cm.dense_init(gen, (d, f), pd),
            "wo": cm.dense_init(gen, (f, d), pd)}


def mlp_fwd(cfg: ModelConfig, p: Dict, x):
    act = cm.act_fn(cfg.act)
    if "wg" in p:
        h = act(x @ p["wg"].to(x.dtype)) * (x @ p["wi"].to(x.dtype))
    else:
        h = act(x @ p["wi"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)
