"""EAGLE-3-style self-speculative draft module (counterpart of
``repro/core/draft.py``: greedy or sampled drafting on the paged draft
cache of the dense engine or the contiguous one of the state-arch
engine).

One decoder layer whose input is ``in_proj(concat(token_emb, fused))``
with ``fused = fuse(concat(h_low, h_mid, h_top))``; token prediction
reuses the target's LM head.  The draft keeps its own single-layer KV
cache; tree nodes' K/V live in scratch and are discarded after the step.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import DraftConfig, ModelConfig
from repro_torch.core.sampling import draw
from repro_torch.core.tree import TreeSpec, tree_tensors
from repro_torch.device import resolve_device
from repro_torch.models import blocks as bk
from repro_torch.models import common as cm
from repro_torch.models import dense as dn


def draft_model_config(cfg: ModelConfig, yarn_factor: float = 1.0
                       ) -> ModelConfig:
    """The draft layer's effective config: the target's dims, one layer."""
    return cfg.replace(name=cfg.name + "-draft", num_layers=1,
                       arch_type="dense", num_experts=0, experts_per_token=0,
                       yarn_factor=yarn_factor, layer_pattern=(),
                       cross_attn_every=0, encoder_layers=0)


def init_draft_params(cfg: ModelConfig, dcfg: DraftConfig, seed: int = 0,
                      device=None) -> Dict:
    """Random draft weights from ``seed`` on ``device`` (CUDA unless
    ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pd = cm.dt(cfg.param_dtype)
    d = cfg.d_model
    return {"fuse": cm.dense_init(gen, (3 * d, d), pd),
            "in_proj": cm.dense_init(gen, (2 * d, d), pd),
            "layer": dn._init_layer(draft_model_config(cfg), gen),
            "final_norm": torch.ones((d,), dtype=pd, device=dev)}


def init_draft_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device) -> Dict:
    """Contiguous draft cache: per-row ``[B, S_max, Hk, Dh]`` buffers
    (the state-arch engine's; reads and writes go through
    ``layer_ctx_view`` / ``layer_cache_append`` as for the paged one)."""
    dtype = cm.dt(cfg.dtype)
    hk, dh = cfg.num_kv_heads, cfg.head_dim_
    return {"k": torch.zeros((batch, max_len, hk, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, hk, dh), dtype=dtype,
                             device=device),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def init_paged_draft_cache(cfg: ModelConfig, batch: int, max_len: int,
                           block: int, num_pages: int, device) -> Dict:
    """Paged draft cache: shared single-layer pool + per-slot page tables
    (page 0 is the null page, as in the trunk pool)."""
    dtype = cm.dt(cfg.dtype)
    hk, dh = cfg.num_kv_heads, cfg.head_dim_
    return {"k": torch.zeros((num_pages, block, hk, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((num_pages, block, hk, dh), dtype=dtype,
                             device=device),
            "page_table": torch.zeros((batch, -(-max_len // block)),
                                      dtype=torch.int32, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _draft_inputs(cfg: ModelConfig, dp: Dict, target_embed, tokens,
                  fused_feats):
    """tokens [B, T]; fused_feats [B, T, 3d] -> layer inputs [B, T, d]."""
    dt = cm.dt(cfg.dtype)
    emb = target_embed[tokens.long()].to(dt)
    fused = fused_feats.to(dt) @ dp["fuse"].to(dt)
    return torch.cat([emb, fused], dim=-1) @ dp["in_proj"].to(dt)


def _layer_fwd(cfg: ModelConfig, mcfg: ModelConfig, dp: Dict, x, positions,
               ctx_k, ctx_v, ctx_valid, self_mask, inv_freq, mscale):
    """One decoder layer over x with explicit context + self mask."""
    lp = dp["layer"]
    h = x
    xn = cm.rmsnorm(h, lp["norm1"], cfg.norm_eps)
    q = bk.project_q(mcfg, lp["attn"], xn, positions, inv_freq, mscale)
    k_new, v_new = bk.project_kv(mcfg, lp["attn"], xn, positions, inv_freq,
                                 mscale)
    parts = [cm.dense_attn_part(q, ctx_k, ctx_v,
                                mask=ctx_valid[:, None, None, :]),
             cm.dense_attn_part(q, k_new, v_new, mask=self_mask[:, None])]
    out = cm.combine_attn_parts(parts, h.dtype)
    h = h + bk.attn_output(mcfg, lp["attn"], out)
    xn = cm.rmsnorm(h, lp["norm2"], cfg.norm_eps)
    h = h + bk.mlp_fwd(mcfg, lp["mlp"], xn)
    return h, k_new, v_new


def draft_head(cfg: ModelConfig, dp: Dict, target_params, h):
    h = cm.rmsnorm(h, dp["final_norm"], cfg.norm_eps)
    w = (target_params["embed"].T if cfg.tie_embeddings
         else target_params["head"])
    return (h @ w.to(h.dtype)).float()


def _rope(cfg: ModelConfig, device):
    mcfg = draft_model_config(cfg)
    return mcfg, cm.rope_inv_freq_tensor(mcfg, device), cm.yarn_mscale(mcfg)


def draft_extend(cfg: ModelConfig, dcfg: DraftConfig, dp: Dict,
                 target_params, cache: Dict, tokens, fused_feats, valid,
                 active=None):
    """Append accepted tokens [B, E] (prefix mask ``valid`` [B, E]) to the
    draft cache, in place; a row outside ``active`` [B] bool (a dead
    serving slot) writes nothing and keeps its length.  Returns (cache,
    h_last [B, d], logits_last [B, V]) at the last valid entry."""
    dev = tokens.device
    mcfg, inv_freq, mscale = _rope(cfg, dev)
    b, e = tokens.shape
    if active is not None:
        valid = valid & active[:, None]
    x = _draft_inputs(cfg, dp, target_params["embed"], tokens, fused_feats)
    vi = valid.to(torch.int32)
    nvalid = vi.sum(dim=1, dtype=torch.int32)
    positions = torch.clamp(cache["length"][:, None] + torch.cumsum(
        vi, dim=1) - 1, min=0)
    ctx_k, ctx_v, s = cm.layer_ctx_view(cache)
    ctx_valid = (torch.arange(s, device=dev)[None]
                 < cache["length"][:, None])
    self_mask = (torch.tril(torch.ones((e, e), dtype=torch.bool,
                                       device=dev))[None]
                 & valid[:, None, :] & valid[:, :, None])
    h, k_new, v_new = _layer_fwd(cfg, mcfg, dp, x, positions, ctx_k, ctx_v,
                                 ctx_valid, self_mask, inv_freq, mscale)
    cache = cm.layer_cache_append(cache, k_new, v_new, valid)
    cache["length"] = cache["length"] + nvalid
    last = torch.clamp(nvalid.long() - 1, min=0)
    h_last = h[torch.arange(b, device=dev), last]
    logits_last = draft_head(cfg, dp, target_params, h_last[:, None])[:, 0]
    return cache, h_last, logits_last


def draft_phase(cfg: ModelConfig, dcfg: DraftConfig, dp: Dict, target_params,
                tree: TreeSpec, cache: Dict, ext_tokens, ext_feats, ext_len,
                active=None, u=None, temps=None):
    """The draft half of one step: extend the draft cache with the
    previous step's accepted tokens (rows outside ``active`` [B] bool
    write nothing), then draft a candidate tree from the last valid
    entry (sampled rows with ``u`` / ``temps``, see ``tree_draft``).
    Returns (cache, tree_tokens [B, T], aux): the tree's log-probs
    [B, T] (greedy) or its node logits [B, T+1, V] (sampled)."""
    emax = ext_tokens.shape[1]
    ext_valid = (torch.arange(emax, device=ext_tokens.device)[None]
                 < ext_len[:, None])
    cache, h_root, logits_root = draft_extend(
        cfg, dcfg, dp, target_params, cache, ext_tokens, ext_feats,
        ext_valid, active=active)
    tree_tokens, aux = tree_draft(cfg, dcfg, dp, target_params, cache,
                                  tree, h_root, logits_root, u=u,
                                  temps=temps)
    return cache, tree_tokens, aux


def _top_b(logits, bfac: int):
    """Top-``bfac`` (values, indices) of log_softmax(logits).
    ``jax.lax.top_k`` orders ties by lower index; a stable descending
    sort reproduces that (``torch.topk`` promises no order)."""
    logp = torch.log_softmax(logits, dim=-1)
    srt = torch.sort(logp, dim=-1, descending=True, stable=True)
    return srt.values[:, :bfac], srt.indices[:, :bfac]


def tree_draft(cfg: ModelConfig, dcfg: DraftConfig, dp: Dict, target_params,
               cache: Dict, tree: TreeSpec, h_root, logits_root, u=None,
               temps=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draft the static tree (read-only w.r.t. the cache): greedily, the
    deterministic top-k per parent, or, given the draft uniforms ``u``
    [B, T] and the rows' temperatures ``temps`` [B], sampled: node n is
    drawn at ``u[:, n]`` from softmax(parent logits / T), so a parent's
    children are i.i.d. draws (lossless verification needs them).  Rows
    at temperature 0 keep the top-k tokens bit for bit, so greedy and
    sampled rows draft in one step.  Returns (tree_tokens [B, T],
    tree_logp [B, T]) greedy, or (tree_tokens, node_logits [B, T+1, V]:
    the root's draft logits first, then each node's) sampled."""
    dev = h_root.device
    mcfg, inv_freq, mscale = _rope(cfg, dev)
    b = h_root.shape[0]
    t = tree.size
    dt = cm.dt(cfg.dtype)
    hk, dh = cfg.num_kv_heads, cfg.head_dim_
    ctx_k, ctx_v, s = cm.layer_ctx_view(cache)
    ctx_valid = torch.arange(s, device=dev)[None] < cache["length"][:, None]
    anc = tree_tensors(tree, dev).anc
    root_pos = cache["length"] - 1

    tree_tokens = torch.zeros((b, t), dtype=torch.int32, device=dev)
    tree_logp = torch.zeros((b, t), dtype=torch.float32, device=dev)
    node_k = torch.zeros((b, t, hk, dh), dtype=dt, device=dev)
    node_v = torch.zeros((b, t, hk, dh), dtype=dt, device=dev)
    parent_logits = {-1: logits_root}
    parent_h = {-1: h_root}
    lp = dp["layer"]
    sampled = u is not None
    if sampled:
        sample_rows = temps > 0.0
        # greedy lanes never read their draw; 1.0 keeps the softmax finite
        t_eff = torch.where(sample_rows, torch.clamp(temps, min=1e-6),
                            torch.ones_like(temps))[:, None, None]
    for l, (lo, hi) in enumerate(tree.level_slices):
        bfac = tree.branch[l]
        tops = {}
        new_tokens, new_logp, feats = [], [], []
        for n in range(lo, hi):
            p = tree.parents[n]
            if p not in tops:              # one sort per parent, not per child
                tops[p] = _top_b(parent_logits[p], bfac)
            topv, topi = tops[p]
            rank = (n - lo) % bfac
            new_tokens.append(topi[:, rank])
            new_logp.append(topv[:, rank])
            feats.append(parent_h[p])
        toks_l = torch.stack(new_tokens, dim=1).to(torch.int32)  # [B, n_l]
        if sampled:
            # the level's parents in order, each with its bfac children
            # (``from_branch``'s layout): one softmax per parent
            pids = list(dict.fromkeys(tree.parents[lo:hi]))
            lg = torch.stack([parent_logits[p] for p in pids], dim=1)
            drawn = draw(torch.softmax(lg.float() / t_eff, dim=-1),
                         u[:, lo:hi].reshape(b, len(pids), bfac))
            toks_l = torch.where(sample_rows[:, None],
                                 drawn.reshape(b, hi - lo).to(torch.int32),
                                 toks_l)
        feat_l = torch.stack(feats, dim=1)                       # [B, n_l, d]
        # static level offsets always fit, so the reference's
        # dynamic_update_slice needs no clamp here
        tree_tokens[:, lo:hi] = toks_l
        tree_logp[:, lo:hi] = torch.stack(new_logp, dim=1)

        emb = target_params["embed"][toks_l.long()].to(dt)
        fused = torch.cat([feat_l, feat_l, feat_l], dim=-1) @ dp["fuse"].to(dt)
        x = torch.cat([emb, fused], dim=-1) @ dp["in_proj"].to(dt)
        positions = (root_pos[:, None] + 1 + l).expand(b, hi - lo)
        self_mask = anc[None, lo:hi, :].expand(b, hi - lo, t)
        node_valid = torch.arange(t, device=dev)[None, None, :] < lo
        prev_mask = self_mask & node_valid
        xn = cm.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        q = bk.project_q(mcfg, lp["attn"], xn, positions, inv_freq, mscale)
        k_new, v_new = bk.project_kv(mcfg, lp["attn"], xn, positions,
                                     inv_freq, mscale)
        eye = torch.eye(hi - lo, dtype=torch.bool, device=dev)[None, None]
        parts = [cm.dense_attn_part(q, ctx_k, ctx_v,
                                    mask=ctx_valid[:, None, None, :]),
                 cm.dense_attn_part(q, node_k, node_v,
                                    mask=prev_mask[:, None]),
                 cm.dense_attn_part(q, k_new, v_new, mask=eye)]
        out = cm.combine_attn_parts(parts, x.dtype)
        h = x + bk.attn_output(mcfg, lp["attn"], out)
        xn = cm.rmsnorm(h, lp["norm2"], cfg.norm_eps)
        h = h + bk.mlp_fwd(mcfg, lp["mlp"], xn)
        node_k[:, lo:hi] = k_new
        node_v[:, lo:hi] = v_new
        if l + 1 < tree.depth or sampled:
            lg_l = draft_head(cfg, dp, target_params, h)     # [B, n_l, V]
            for i, n in enumerate(range(lo, hi)):
                parent_logits[n] = lg_l[:, i]
                parent_h[n] = h[:, i]
    if sampled:
        return tree_tokens, torch.stack(
            [logits_root] + [parent_logits[n] for n in range(t)], dim=1)
    return tree_tokens, tree_logp
