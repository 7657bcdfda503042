"""Per-layer blocks: attention projections, the gated MLP and the MoE
with the reference's capacity dispatch (counterpart of
``repro/models/blocks.py``).

One MoE body serves inference, tensor parallelism and training: a call
routes its tokens at their place in the batch's dispatch groups
(``MoeRoute``; one data shard's tokens, or the whole batch) and gives
back their routing (``MoeStats``); ``moe_aux`` forms the batch's aux
loss from every shard's stats."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

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


def _moe_router(p: Dict, x):
    """x [..., d] -> the fp32 router's probabilities [..., E]."""
    return torch.softmax(x.float() @ p["router"], dim=-1)


def _moe_topk(cfg: ModelConfig, probs):
    """(top-k weights [..., K] renormalised, expert ids [..., K]).
    ``jax.lax.top_k`` orders ties by the lower index and ``torch.topk``
    promises no order, so the top-k is a stable descending sort, as the
    block selection's."""
    k = cfg.experts_per_token
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = order.values[..., :k], order.indices[..., :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return topv, topi


def _pad_row(t):
    """t [R, d] and a zero row after it."""
    return torch.cat([t, t.new_zeros((1, t.shape[1]))])


class _RowGather(torch.autograd.Function):
    """``out[q] = table[idx[q]]``, a zero row where ``idx[q]`` is
    ``len(table)``.  ``inv`` [R, m] is the transpose: for each table row
    the out rows that read it, ``len(out)`` where fewer.  The backward is
    then a gather too, each row summing its readers in fp32: the
    dispatch's and the combine's indices hold long runs of the zero row
    (empty slots, dropped pairs), which the scatter-add backward of an
    index serialises."""

    @staticmethod
    def forward(ctx, table, idx, inv):
        ctx.save_for_backward(inv)
        return _pad_row(table).index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        inv, = ctx.saved_tensors
        r, m = inv.shape
        g = _pad_row(grad).index_select(0, inv.reshape(-1)).view(r, m, -1)
        return g.sum(1, dtype=torch.float32).to(grad.dtype), None, None


def _gather_rows(table, idx, inv):
    """``_RowGather`` where autograd records, else its forward."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _RowGather.apply(table, idx, inv)
    return _pad_row(table).index_select(0, idx)


def _moe_dispatch(cfg: ModelConfig, xf, topi, cap: int, lead: int, ng: int,
                  g: int, prefix=None):
    """Each (token, slot) pair's row in the static expert buffer, by
    index.  The tokens xf [n_s, d] sit at the places [lead, lead + n_s)
    of ``ng`` groups of ``g`` in the batch's flat order (``MoeRoute``).
    The reference's position of a pair in its expert is a cumsum over
    its group's token-major [g*k, E] one-hot, here started at ``prefix``
    [ng, E] (the assignments of earlier shards' tokens in the group);
    pairs at or past ``cap`` are dropped.  Rows are expert-major [E, ng,
    cap]; a row no pair fills reads a zero row.  Returns (xe [E, ng*cap,
    d], slot [n_s*k] (E*ng*cap for a dropped pair), keep [n_s*k], pair
    [E*ng*cap]: the pair each row holds, n_s*k where none)."""
    n_s, d = xf.shape
    e, k = cfg.num_experts, topi.shape[-1]
    dev = xf.device
    # the places of other shards' tokens and of pads hold expert e, which
    # no one-hot row matches; the one-hot laid out [ng, E, g*k], so the
    # cumsum runs along the innermost axis (a scan along the outer one
    # takes 0.7 ms per layer for a 256-token chunk on the card)
    ei = torch.nn.functional.pad(topi.reshape(-1), (
        lead * k, (ng * g - lead - n_s) * k), value=e).view(ng, g * k)
    onehot = (ei[:, None, :] == torch.arange(e, device=dev)[None, :, None])
    counts = torch.cumsum(onehot.to(torch.int32), dim=-1, dtype=torch.int32)
    if prefix is not None:
        counts = counts + prefix[:, :, None]
    pos = torch.gather(counts, 1, ei.clamp(max=e - 1)[:, None, :])
    pos = pos.reshape(-1)[lead * k:(lead + n_s) * k] - 1
    ei = topi.reshape(-1)
    keep = pos < cap
    grp = (lead + torch.arange(n_s * k, device=dev) // k) // g
    rows = e * ng * cap
    slot = torch.where(keep, ei * (ng * cap) + grp * cap + pos,
                       torch.full_like(ei, rows))
    # row -> pair; the dropped pairs' row is cut off
    pair = torch.full((rows + 1,), n_s * k, dtype=torch.long, device=dev)
    pair.scatter_(0, slot, torch.arange(n_s * k, device=dev))
    pair = pair[:-1]
    xe = _gather_rows(xf, pair // k, slot.view(n_s, k))
    return xe.view(e, ng * cap, d), slot, keep, pair


def _moe_experts(cfg: ModelConfig, p: Dict, xe):
    """The gated expert MLP as batched products: xe [E, R, d] ->
    [E, R, d]."""
    xd = xe.dtype
    act = cm.act_fn(cfg.act)
    h = act(torch.bmm(xe, p["wg"].to(xd))) * torch.bmm(xe, p["wi"].to(xd))
    return torch.bmm(h, p["wo"].to(xd))


def _moe_combine(ye, slot, keep, topv, pair, lo: int = 0):
    """y [n_s, d] in fp32: each token's kept pairs' expert outputs
    weighted by their top-k weights, the weights rounded to the
    activation dtype first (the reference's ``combine.astype(xd)``),
    summed in fp32 (the caller casts to the activation dtype).  ``ye``
    holds the expert-major rows ``[lo, lo + R)`` of the dispatch buffer:
    all of it (``lo`` 0), or one expert shard's rows, whose pairs routed
    elsewhere weigh 0 (the shards' parts, summed, are the whole
    combine)."""
    n_s, k = topv.shape
    d = ye.shape[-1]
    xd = ye.dtype
    rows = ye.shape[0] * ye.shape[1]
    mine = keep & (slot >= lo) & (slot < lo + rows)
    idx = torch.where(mine, slot - lo, torch.full_like(slot, rows))
    w = torch.where(mine, topv.reshape(-1),
                    torch.zeros_like(mine, dtype=topv.dtype))
    got = _gather_rows(ye.reshape(-1, d), idx, pair[lo:lo + rows, None])
    part = got.float() * w.to(xd).float()[:, None]
    return part.view(n_s, k, d).sum(dim=1)


def _moe_groups_fwd(cfg: ModelConfig, p: Dict, xf, cap: int, lead: int,
                    ng: int, g: int, prefix=None, expert_shards=None):
    """The reference's dispatch groups (its ``_moe_group_fwd`` under
    ``vmap``) over the tokens xf [n_s, d] at the places [lead, lead +
    n_s) of ``ng`` groups of ``g`` (``_moe_dispatch``): (y [n_s, d],
    probs [n_s, E], topi [n_s, k], keep [n_s*k]).  ``expert_shards``
    (tensor parallelism): a ``TensorParallel`` whose shards each hold
    ``E/m`` experts, paired with each shard's expert weights; the router,
    top-k, capacity and dispatch run once, each shard runs its experts
    over its rows of the dispatch buffer and combines its pairs, and one
    sum joins the parts."""
    e = cfg.num_experts
    probs = _moe_router(p, xf)
    topv, topi = _moe_topk(cfg, probs)
    xe, slot, keep, pair = _moe_dispatch(cfg, xf, topi, cap, lead, ng, g,
                                         prefix)
    if expert_shards is None:
        y = _moe_combine(_moe_experts(cfg, p, xe), slot, keep, topv, pair)
    else:
        tp, ps = expert_shards
        per = e // tp.m
        rows = per * xe.shape[1]

        def part(sh):
            xe_s = xe[sh.index * per:(sh.index + 1) * per].to(sh.device)
            ye_s = _moe_experts(cfg, ps[sh.index], xe_s)
            return _moe_combine(ye_s, slot.to(sh.device), keep.to(sh.device),
                                topv.to(sh.device), pair.to(sh.device),
                                sh.index * rows)
        y = tp.map_reduce(part)
    return y.to(xf.dtype), probs, topi, keep


def _moe_capacity(cfg: ModelConfig, g: int, capacity_factor: float) -> int:
    """Slots per expert in a group of ``g`` tokens (the reference's)."""
    return max(1, int(math.ceil(g * cfg.experts_per_token / cfg.num_experts
                                * capacity_factor)))


def moe_groups(n: int) -> Tuple[int, int]:
    """(group size, group count) of the reference's dispatch of ``n``
    tokens in the flat (b, t) order: one group of ``n`` up to
    ``MOE_GROUP``; beyond, groups of ``MOE_GROUP``, their count rounded
    up to a multiple of ``min(groups, MOE_MAX_OUTER)`` (its waves) with
    zero rows after the last token."""
    if n <= MOE_GROUP:
        return n, 1
    ng = -(-n // MOE_GROUP)
    outer = min(ng, MOE_MAX_OUTER)
    return MOE_GROUP, -(-ng // outer) * outer


@dataclass(frozen=True)
class MoeRoute:
    """The place of a MoE call's tokens in the batch's dispatch: ``n``
    the batch's tokens (they fix the groups and each group's capacity,
    ``moe_groups``), ``offset`` the first token's place in the batch's
    flat (b, t) order (the tokens are contiguous there: one data
    shard's), and ``prefix`` [G_s, E] int32: for each group the tokens
    touch, the (token, slot) assignments that earlier shards made to each
    expert, dropped ones included (the reference's cumsum runs over the
    whole one-hot); None where no earlier shard shares a group.  A layer
    is recomputed in the backward pass from the route it was given, so a
    prefix is never written after it is handed over."""
    n: int
    offset: int = 0
    prefix: Optional[torch.Tensor] = None


class MoeStats(NamedTuple):
    """A MoE call's routing of its n_s tokens, which touch the batch's
    groups ``[g0, g0 + ng)`` of ``g`` from the place ``lead`` of group
    ``g0`` on: ``probs`` [n_s, E] fp32 the router's probabilities
    (differentiable), ``topi`` [n_s, k] the experts, ``keep`` [n_s*k] the
    kept pairs.  The per-group sums are formed where they are read."""
    g0: int
    lead: int
    g: int
    ng: int
    probs: torch.Tensor
    topi: torch.Tensor
    keep: torch.Tensor

    def drops(self):
        """The dropped (token, slot) pairs."""
        return (~self.keep).sum()

    def _per_group(self, v):
        """v [n_s, c] -> each group's sum [ng, c]."""
        after = self.ng * self.g - self.lead - v.shape[0]
        v = torch.nn.functional.pad(v, (0, 0, self.lead, after))
        return v.view(self.ng, self.g, -1).sum(1)

    def probs_sum(self):
        """[ng, E] fp32: each group's sum of the probabilities."""
        return self._per_group(self.probs)

    def top1(self):
        """[ng, E] fp32: each group's top-1 count per expert."""
        e = self.probs.shape[-1]
        return self._per_group(torch.nn.functional.one_hot(
            self.topi[:, 0], e).float())

    def assignments(self):
        """[ng, E] int32: each group's (token, slot) pairs per expert,
        dropped ones included (the next shard's prefix, added)."""
        e = self.probs.shape[-1]
        return self._per_group(torch.nn.functional.one_hot(
            self.topi, e).sum(1).to(torch.int32))


def count_drops(stats: Optional[MoeStats]):
    """Add a MoE call's dropped pairs to ``MOE_DROPS`` while it counts
    (None: a dense layer).  The trunk calls it once per forward, outside
    the recompute of a checkpointed layer."""
    if MOE_DROPS is not None and stats is not None:
        MOE_DROPS.add_(stats.drops().to(MOE_DROPS.device))


def moe_aux(cfg: ModelConfig, n: int, layers: Sequence[Sequence[MoeStats]],
            device) -> torch.Tensor:
    """The batch's aux loss from its MoE calls' ``MoeStats``: ``layers``
    holds, per MoE layer, the stats of every shard of a batch of ``n``
    tokens.  Per group the reference's ``e * sum(frac_tokens *
    frac_probs)`` is ``e / g^2 * sum(top1 * probs)`` with both summed
    over the shards, so a shard's probabilities get their gradient from
    the whole group's top-1 counts; the zero rows after the batch's last
    token add uniform probabilities and a top-1 on expert 0 (the stable
    order of equal scores).  The mean over the groups, summed over the
    layers, on ``device`` (an fp32 0 without layers)."""
    dev = device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    if not layers:
        return total
    e = cfg.num_experts
    g, ng = moe_groups(n)
    real = torch.clamp(n - torch.arange(ng, device=dev) * g, 0, g)
    pad = (g - real).to(torch.float32)
    for shards in layers:
        probs = pad[:, None].expand(ng, e) / e
        top1 = torch.zeros((ng, e), dtype=torch.float32, device=dev)
        top1[:, 0] = pad
        for st in shards:
            at = torch.arange(st.g0, st.g0 + st.ng, device=dev)
            probs = probs.index_add(0, at, st.probs_sum().to(dev))
            top1 = top1.index_add(0, at, st.top1().to(dev))
        total = total + (e / g ** 2) * (top1 * probs).sum(-1).mean()
    return total


def moe_fwd(cfg: ModelConfig, p: Dict, x, *, capacity_factor: float = 1.25,
            expert_shards=None, route: Optional[MoeRoute] = None):
    """x: [B, T, d] -> (y, ``MoeStats``), the reference's capacity
    dispatch.  ``route`` places the tokens in a larger batch (one data
    shard's, ``api.sharded_train_loss``); without it they are the whole
    batch.

    Up to ``MOE_GROUP`` tokens form one group; longer streams are cut in
    the flattened (b, t) order into groups of ``MOE_GROUP``
    (``moe_groups``; the reference's zero rows after the last token give
    no output, and only ``moe_aux`` counts them).  Without autograd, or
    for one group, every group runs in one pass; under autograd the
    groups run in at most ``MOE_MAX_OUTER`` waves, each recomputed in the
    backward pass (the reference's ``jax.checkpoint``) from the route it
    was given.  Capacity comes from the host-known token count and the
    dispatch is by index (a scatter into a static [E*C, d] buffer and a
    gather back), so nothing reads the card.  ``expert_shards`` splits
    the experts over tensor-parallel shards (``_moe_groups_fwd``).  The
    caller counts the drops (``count_drops``)."""
    b, t, d = x.shape
    n_s = b * t
    route = route if route is not None else MoeRoute(n_s)
    g, _ = moe_groups(route.n)
    cap = _moe_capacity(cfg, g, capacity_factor)
    g0, lead = divmod(route.offset, g)
    ng = -(-(lead + n_s) // g)
    xf = x.reshape(n_s, d)
    pre = route.prefix
    if torch.is_grad_enabled() and x.requires_grad and route.n > MOE_GROUP:
        inner = -(-ng // MOE_MAX_OUTER)
        outs = []
        for w in range(0, ng, inner):
            lo, hi = max(0, w * g - lead), min(n_s, (w + inner) * g - lead)
            outs.append(torch.utils.checkpoint.checkpoint(
                _moe_groups_fwd, cfg, p, xf[lo:hi], cap, lead if w == 0 else 0,
                min(inner, ng - w), g, None if pre is None else
                pre[w:w + inner], expert_shards, use_reentrant=False))
        y, probs, topi, keep = (torch.cat([o[i] for o in outs])
                                for i in range(4))
    else:
        y, probs, topi, keep = _moe_groups_fwd(cfg, p, xf, cap, lead, ng, g,
                                               pre, expert_shards)
    return y.view(b, t, d), MoeStats(g0, lead, g, ng, probs, topi, keep)
