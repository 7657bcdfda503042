"""Per-layer blocks: attention projections, the gated MLP and the MoE
with the reference's capacity dispatch (counterpart of
``repro/models/blocks.py``)."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

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


# ---------------------------------------------------------------------------
# MoE (top-k router, capacity-based dispatch)
# ---------------------------------------------------------------------------

def init_moe_params(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    """Router fp32 [d, E]; experts ``wi``/``wg`` [E, d, f], ``wo``
    [E, f, d] in the param dtype."""
    pd = cm.dt(cfg.param_dtype)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def einit(shape):
        return torch.stack([cm.dense_init(gen, shape, pd) for _ in range(e)])

    return {"router": cm.dense_init(gen, (d, e), torch.float32),
            "wi": einit((d, f)), "wg": einit((d, f)), "wo": einit((f, d))}


MOE_GROUP = 1024    # tokens per dispatch group (the reference's)
MOE_MAX_OUTER = 64  # sequential dispatch waves for very long token streams

# dropped (token, slot) pairs of real tokens, summed on the card while
# this holds a device tensor (set by a caller that measures; None: off)
MOE_DROPS: Optional[torch.Tensor] = None


def _moe_router(p: Dict, xg):
    """xg [G, g, d] -> the fp32 router's probabilities [G, g, E]."""
    return torch.softmax(xg.float() @ p["router"], dim=-1)


def _moe_topk(cfg: ModelConfig, probs):
    """(top-k weights [G, g, K] renormalised, expert ids [G, g, K]).
    ``jax.lax.top_k`` orders ties by the lower index and ``torch.topk``
    promises no order, so the top-k is a stable descending sort, as the
    block selection's."""
    k = cfg.experts_per_token
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = order.values[..., :k], order.indices[..., :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return topv, topi


def _moe_dispatch(cfg: ModelConfig, xg, topi, cap: int):
    """Each (token, slot) pair's row in the static expert buffer, by
    index.  The reference's position of a pair in its expert is a cumsum
    over the token-major [g*k, E] one-hot; pairs at or past ``cap`` are
    dropped.  Rows are expert-major [E, G, cap], then one row that takes
    every dropped pair.  Returns (xe [E, G*cap, d], slot [G, g*k], keep
    [G, g*k])."""
    ng, g, d = xg.shape
    e, k = cfg.num_experts, topi.shape[-1]
    dev = xg.device
    ei = topi.reshape(ng, g * k)
    # the one-hot laid out [G, E, g*k], so the cumsum runs along the
    # innermost axis (a scan along the outer one takes 0.7 ms per layer
    # for a 256-token chunk on the card)
    onehot = (ei[:, None, :] == torch.arange(e, device=dev)[None, :, None])
    counts = torch.cumsum(onehot.to(torch.int32), dim=-1, dtype=torch.int32)
    pos = torch.gather(counts, 1, ei[:, None, :])[:, 0] - 1
    keep = pos < cap
    grp = torch.arange(ng, device=dev)[:, None]
    slot = torch.where(keep, ei * (ng * cap) + grp * cap + pos,
                       torch.full_like(ei, e * ng * cap))
    tok = grp * g + torch.arange(g * k, device=dev)[None] // k
    # row -> token; a row no pair fills reads the zero row ng*g, and the
    # dropped pairs' row is never read
    src = torch.full((e * ng * cap + 1,), ng * g, dtype=torch.long,
                     device=dev)
    src.scatter_(0, slot.reshape(-1), tok.reshape(-1))
    xpad = torch.cat([xg.reshape(ng * g, d), xg.new_zeros((1, d))])
    return xpad[src[:-1]].view(e, ng * cap, d), slot, keep


def _moe_experts(cfg: ModelConfig, p: Dict, xe):
    """The gated expert MLP as batched products: xe [E, R, d] ->
    [E, R, d]."""
    xd = xe.dtype
    act = cm.act_fn(cfg.act)
    h = act(torch.bmm(xe, p["wg"].to(xd))) * torch.bmm(xe, p["wi"].to(xd))
    return torch.bmm(h, p["wo"].to(xd))


def _moe_combine(ye, slot, keep, topv, lo: int = 0):
    """y [G, g, d] in fp32: each token's kept pairs' expert outputs
    weighted by their top-k weights, the weights rounded to the
    activation dtype first (the reference's ``combine.astype(xd)``),
    summed in fp32 (the caller casts to the activation dtype).  ``ye``
    holds the expert-major rows ``[lo, lo + R)`` of the dispatch buffer:
    all of it (``lo`` 0), or one expert shard's rows, whose pairs routed
    elsewhere weigh 0 (the shards' parts, summed, are the whole
    combine)."""
    ng, g, k = topv.shape
    d = ye.shape[-1]
    xd = ye.dtype
    rows = ye.shape[0] * ye.shape[1]
    yflat = torch.cat([ye.reshape(-1, d), ye.new_zeros((1, d))])
    mine = keep & (slot >= lo) & (slot < lo + rows)
    idx = torch.where(mine, slot - lo, torch.full_like(slot, rows))
    w = torch.where(mine, topv.reshape(ng, -1),
                    torch.zeros_like(mine, dtype=topv.dtype))
    part = yflat[idx].float() * w.to(xd).float()[..., None]
    return part.view(ng, g, k, d).sum(dim=2)


def _moe_groups_fwd(cfg: ModelConfig, p: Dict, xg, capacity_factor: float,
                    want_aux: bool = True, expert_shards=None):
    """Dispatch groups side by side (the reference's ``_moe_group_fwd``
    under ``vmap``).  xg [G, g, d] -> (y [G, g, d], aux [G] (None
    unless ``want_aux``), keep [G, g*k]).  ``expert_shards`` (tensor
    parallelism): a ``TensorParallel`` whose shards each hold ``E/m``
    experts, paired with each shard's expert weights; the router, top-k,
    capacity and dispatch run once, each shard runs its experts over its
    rows of the dispatch buffer and combines its pairs, and one sum joins
    the parts."""
    e, k = cfg.num_experts, cfg.experts_per_token
    g = xg.shape[1]
    cap = max(1, int(math.ceil(g * k / e * capacity_factor)))
    probs = _moe_router(p, xg)
    topv, topi = _moe_topk(cfg, probs)
    xe, slot, keep = _moe_dispatch(cfg, xg, topi, cap)
    if expert_shards is None:
        ye = _moe_experts(cfg, p, xe)
        y = _moe_combine(ye, slot, keep, topv).to(xg.dtype)
    else:
        tp, ps = expert_shards
        per = e // tp.m
        rows = per * xe.shape[1]

        def part(sh):
            xe_s = xe[sh.index * per:(sh.index + 1) * per].to(sh.device)
            ye_s = _moe_experts(cfg, ps[sh.index], xe_s)
            return _moe_combine(ye_s, slot.to(sh.device), keep.to(sh.device),
                                topv.to(sh.device), sh.index * rows)
        y = tp.map_reduce(part).to(xg.dtype)
    if not want_aux:
        return y, None, keep
    frac_tokens = torch.nn.functional.one_hot(topi[..., 0], e).float().mean(1)
    frac_probs = probs.mean(dim=1)
    aux = e * torch.sum(frac_tokens * frac_probs, dim=-1)
    return y, aux, keep


def moe_fwd(cfg: ModelConfig, p: Dict, x, *, capacity_factor: float = 1.25,
            aux: bool = True, expert_shards=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, d] -> (y, aux_loss), the reference's capacity dispatch
    (``aux=False``: the aux loss is not computed and None is returned;
    the reference's jit drops it where nothing reads it).

    Up to ``MOE_GROUP`` tokens form one group; longer streams are cut in
    the flattened (b, t) order into groups of ``MOE_GROUP``, zero-padded
    to a multiple of ``min(groups, MOE_MAX_OUTER)`` groups, and the aux
    loss is the mean over the groups.  Without autograd every group runs
    in one pass; under autograd the groups run in the reference's waves,
    each recomputed in the backward pass (its ``jax.checkpoint``).
    Capacity comes from the host-known token count and the dispatch is
    by index (a scatter into a static [E*C + 1, d] buffer and a gather
    back), so nothing reads the card.  ``expert_shards`` splits the
    experts over tensor-parallel shards (``_moe_groups_fwd``); the drops
    are counted once."""
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    if n <= MOE_GROUP:
        y, loss, keep = _moe_groups_fwd(cfg, p, xf[None], capacity_factor,
                                        aux, expert_shards)
        loss = loss[0] if aux else None
    else:
        g = MOE_GROUP
        ng = -(-n // g)
        outer = min(ng, MOE_MAX_OUTER)
        ng = -(-ng // outer) * outer
        if ng * g > n:
            xf = torch.nn.functional.pad(xf, (0, 0, 0, ng * g - n))
        xg = xf.view(ng, g, d)
        if torch.is_grad_enabled() and x.requires_grad:
            inner = ng // outer
            waves = [torch.utils.checkpoint.checkpoint(
                _moe_groups_fwd, cfg, p, xg[w * inner:(w + 1) * inner],
                capacity_factor, aux, expert_shards, use_reentrant=False)
                for w in range(outer)]
            y = torch.cat([w[0] for w in waves])
            keep = torch.cat([w[2] for w in waves])
            loss = torch.cat([w[1] for w in waves]) if aux else None
        else:
            y, loss, keep = _moe_groups_fwd(cfg, p, xg, capacity_factor, aux,
                                            expert_shards)
        loss = loss.mean() if aux else None
    if MOE_DROPS is not None:
        MOE_DROPS.add_((~keep.reshape(-1)[: n * cfg.experts_per_token]).sum())
    return y.reshape(-1, d)[:n].view(b, t, d), loss
