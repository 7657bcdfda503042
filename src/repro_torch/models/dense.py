"""Dense GQA trunk (counterpart of ``repro/models/dense.py``, dense
architectures only).

The reference scans stacked superblocks with ``lax.scan``; here the
layers are a list of per-layer param dicts run by a plain Python loop.

Modes (paged cache = shared block pool + page tables; contiguous cache =
per-row buffers):

  prefill        write the chunk's K/V, attend, update block summaries.
                 Paged: through the paged-prefill kernel (K2).
                 Contiguous: the plain flash recurrence (the oracle).
  decode_full    T tree tokens vs the full cache + tree self-mask.
                 Paged: through the paged verify kernel (K1).
  decode_partial T tokens vs the zero-copy partial context: retrieval-
                 selected pool blocks read in place (K1) merged with the
                 dense tail buffer.  Paged only.
  decode_fused   per-row source select between the two above.  Paged only.

Decode modes never mutate the cache; they return the new tokens' K/V.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, SpecPVConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as bk
from repro_torch.models import common as cm

# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _check_dense(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense" or cfg.num_experts or cfg.window_size:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense GQA stacks only; MoE, "
            "windowed, state and cross-attention architectures come with "
            "ROADMAP.md queue 1, 'Other architectures'")


def _init_layer(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    pd = cm.dt(cfg.param_dtype)
    dev = gen.device
    return {"norm1": torch.ones((cfg.d_model,), dtype=pd, device=dev),
            "attn": bk.init_attn_params(cfg, gen),
            "norm2": torch.ones((cfg.d_model,), dtype=pd, device=dev),
            "mlp": bk.init_mlp_params(cfg, gen)}


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from ``seed`` (a ``torch.Generator`` on the target
    device).  Layout: ``embed`` [V, d], ``final_norm`` [d], ``head``
    [d, V] and ``layers``, a list of per-layer dicts."""
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pd = cm.dt(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": cm.embed_init(gen, (cfg.vocab_size, cfg.d_model), pd),
        "final_norm": torch.ones((cfg.d_model,), dtype=pd, device=dev),
        "layers": [_init_layer(cfg, gen) for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        params["head"] = cm.dense_init(gen, (cfg.d_model, cfg.vocab_size), pd)
    return params


def embed_tokens(cfg: ModelConfig, params, tokens):
    return params["embed"][tokens.long()].to(cm.dt(cfg.dtype))


def lm_head(cfg: ModelConfig, params, h):
    h = cm.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (h @ w.to(h.dtype)).float()


# ---------------------------------------------------------------------------
# Quest-style retrieval (paper eqs. (1)-(3))
# ---------------------------------------------------------------------------

def quest_block_scores(q, kmax, kmin, q_weight, *, score_mode: str,
                       reduction: str):
    """q: [B, T, H, Dh]; kmax/kmin: [B, NB, Hk, Dh] fp32; q_weight: [B, T]
    in {0, 1}.  Returns scores [B, Hk, NB] fp32."""
    b, t, h, dh = q.shape
    nb, hk = kmax.shape[1], kmax.shape[2]
    rep = h // hk
    qg = q.reshape(b, t, hk, rep, dh).float()
    if score_mode == "paper":
        smax = torch.einsum("btkrd,bnkd->btkrn", qg, kmax)
        smin = torch.einsum("btkrd,bnkd->btkrn", qg, kmin)
        s = torch.maximum(smax, smin)                     # [B,T,Hk,rep,NB]
    else:
        kx = kmax.movedim(1, 2)
        kn = kmin.movedim(1, 2)
        pm = qg[:, :, :, :, None, :] * kx[:, None, :, None, :, :]
        pn = qg[:, :, :, :, None, :] * kn[:, None, :, None, :, :]
        s = torch.maximum(pm, pn).sum(dim=-1)
    s = s.mean(dim=3)                                     # [B, T, Hk, NB]
    w = q_weight[:, :, None, None].float()
    if reduction == "mean":
        s = (s * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1e-9)
    elif reduction == "max":
        s = torch.where(w > 0, s, torch.full_like(s, -float("inf"))).amax(1)
    elif reduction == "last":
        t_idx = torch.arange(t, device=q.device)[None]
        last = torch.argmax(torch.where(q_weight > 0, t_idx,
                                        torch.full_like(t_idx, -1)), dim=1)
        s = s[torch.arange(b, device=q.device), last]
    else:
        raise ValueError(reduction)
    return s


def _select_block_ids(spec: SpecPVConfig, scores, length):
    """Sink + top-K retrieval + local block selection.  scores:
    [B, Hk, NB]; length: [B].  Returns (idx [B, Hk, NS] logical block
    ids, slot_ok [B, Hk, NS] — False for padded retrieval ranks).

    ``jax.lax.top_k`` breaks ties by the lower index and ``torch.topk``
    promises no order, so the top-K is a stable descending sort: equal
    scores (and the -inf of non-candidates) keep index order and the
    selected set matches the reference."""
    b, hk, nb = scores.shape
    dev = scores.device
    bs = spec.block_size
    n_sink, n_ret, n_loc = (spec.num_sink_blocks, spec.retrieval_budget_blocks,
                            spec.local_window_blocks)
    last_block = (length + bs - 1) // bs
    loc_lo = torch.clamp(last_block - n_loc, min=0)
    blk = torch.arange(nb, device=dev)
    cand = (blk[None] >= n_sink) & (blk[None] < loc_lo[:, None])   # [B, NB]
    masked = torch.where(cand[:, None, :], scores,
                         torch.full_like(scores, -float("inf")))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    ret_idx = order[..., :n_ret]
    n_cand = cand.sum(dim=-1)
    ret_rank_ok = (torch.arange(n_ret, device=dev)[None, None]
                   < n_cand[:, None, None]).expand(b, hk, n_ret)
    ret_idx = torch.where(ret_rank_ok, ret_idx, torch.zeros_like(ret_idx))
    sink_idx = torch.arange(n_sink, device=dev)[None, None].expand(b, hk, n_sink)
    loc_idx = (loc_lo[:, None, None]
               + torch.arange(n_loc, device=dev)[None, None]).expand(b, hk, n_loc)
    idx = torch.cat([sink_idx, ret_idx, loc_idx.to(ret_idx.dtype)], dim=-1)
    slot_ok = torch.cat(
        [torch.ones((b, hk, n_sink), dtype=torch.bool, device=dev),
         ret_rank_ok,
         torch.ones((b, hk, n_loc), dtype=torch.bool, device=dev)], dim=-1)
    return idx, slot_ok


def select_partial_blocks(spec: SpecPVConfig, scores, length):
    """Zero-copy selection: [B, Hk, NS] int32 logical block ids, -1 for
    unused selection slots (padded retrieval ranks)."""
    idx, slot_ok = _select_block_ids(spec, scores, length)
    return torch.where(slot_ok, idx, torch.full_like(idx, -1)).to(torch.int32)


def _routed_partial_context(q, pool_k, pool_v, page_table, pbi, length,
                            pkv_l):
    """Zero-copy partial context partials: the selected blocks read in
    place from the pool through the live page table (``pbi`` [B, Hk, NS]
    logical ids, -1 = unused), merged with the dense tail buffer
    ``pkv_l`` = (pk, pv, ppos) [B, Hk, P, ...].  Returns (m, l, acc)."""
    from repro_torch.kernels import ops as kops
    np_, bs, hk, dh = pool_k.shape
    b, nb = page_table.shape
    pk_buf, pv_buf, ppos_buf = pkv_l[:3]
    # the reference's gather clamps ids into the table; torch would raise
    idxc = torch.clamp(pbi.long(), 0, nb - 1)
    pg = torch.gather(page_table.long()[:, None].expand(b, hk, nb), 2, idxc)
    used = pbi >= 0
    vlen = torch.where(used, torch.clamp(length[:, None, None] - pbi * bs,
                                         0, bs), torch.zeros_like(pbi))
    idx = torch.where(used, pg, torch.zeros_like(pg))
    part_body = kops.routed_partial_attention(q, pool_k, pool_v, idx, vlen)
    part_buf = cm.dense_attn_part_perhead(q, pk_buf, pv_buf, ppos_buf >= 0)
    return cm.merge_attn_partials([part_body, part_buf])


# ---------------------------------------------------------------------------
# per-layer forward
# ---------------------------------------------------------------------------

def _self_attention(cfg: ModelConfig, mode: str, lp: Dict, h, positions,
                    self_mask, cache_kv, pkv, length, inv_freq, mscale,
                    page_table=None, paged_kernel: bool = False,
                    partial_rows=None, pkv_blocks=None):
    """One self-attention sublayer under `mode` (see module docstring).
    With ``page_table`` set, ``cache_kv`` is the layer's pool pair
    [NP, block, Hk, Dh] (prefill writes it in place).  Returns
    (attn_out, updates, q)."""
    from repro_torch.kernels import ops as kops
    x = cm.rmsnorm(h, lp["norm1"], cfg.norm_eps)
    q = bk.project_q(cfg, lp["attn"], x, positions, inv_freq, mscale)
    k_new, v_new = bk.project_kv(cfg, lp["attn"], x, positions, inv_freq,
                                 mscale)
    b, t = positions.shape
    dev = h.device
    upd: Dict[str, Any] = {}
    if page_table is not None and not paged_kernel:
        raise NotImplementedError(
            "the paged cache runs through the kernel route "
            "(SpecPVConfig.use_pallas=True); the gathered-view route is "
            "ROADMAP.md queue 1, 'contiguous SpecPV engine'")

    if mode == "prefill":
        if page_table is not None:
            # K/V go into the pool first: the kernel's causal page walk
            # then covers in-chunk self-attention too
            from repro_torch.kvcache.cache import paged_write_tokens
            pool_k, pool_v = cache_kv
            paged_write_tokens(pool_k, page_table, length, k_new)
            paged_write_tokens(pool_v, page_table, length, v_new)
            tv = torch.full((b,), t, dtype=torch.int32, device=dev)
            out = kops.paged_prefill_attention(q, pool_k, pool_v, page_table,
                                               length, tv)
            return bk.attn_output(cfg, lp["attn"], out), upd, q
        from repro_torch.kvcache.cache import append_layer_kv
        k_layer, v_layer = cache_kv
        append_layer_kv(k_layer, v_layer, k_new, v_new, length)
        s = k_layer.shape[1]
        kv_pos = torch.arange(s, device=dev)[None].expand(b, s)
        kv_valid = kv_pos < (length + t)[:, None]
        out = cm.flash_attention(q, k_layer, v_layer, q_positions=positions,
                                 kv_positions=kv_pos, causal=True,
                                 kv_valid=kv_valid, chunk=512)
        return bk.attn_output(cfg, lp["attn"], out), upd, q

    part_self = cm.dense_attn_part(q, k_new, v_new, mask=self_mask[:, None])
    upd["new_k"] = k_new
    upd["new_v"] = v_new
    if mode == "decode_full":
        if page_table is not None:
            part_ctx = kops.paged_verify_attention(
                q, cache_kv[0], cache_kv[1], page_table, length)
        else:
            k_layer, v_layer = cache_kv
            s = k_layer.shape[1]
            kv_pos = torch.arange(s, device=dev)[None].expand(b, s)
            part_ctx = cm.flash_attention(
                q, k_layer, v_layer, q_positions=positions,
                kv_positions=kv_pos, causal=True,
                kv_valid=kv_pos < length[:, None], chunk=512,
                return_partials=True)
    elif mode in ("decode_partial", "decode_fused"):
        if page_table is None or pkv_blocks is None:
            raise NotImplementedError(
                "partial verification runs zero-copy on the paged cache; "
                "the gathered/contiguous partial cache is ROADMAP.md "
                "queue 1, 'contiguous SpecPV engine'")
        part_part = _routed_partial_context(
            q, cache_kv[0], cache_kv[1], page_table, pkv_blocks, length, pkv)
        if mode == "decode_partial":
            part_ctx = part_part
        else:
            # one launch per source, row-selected partials: partial rows
            # see the full cache at effective length 0 (no pages streamed)
            len_eff = torch.where(partial_rows, torch.zeros_like(length),
                                  length)
            part_full = kops.paged_verify_attention(
                q, cache_kv[0], cache_kv[1], page_table, len_eff)
            sel = partial_rows[:, None, None]
            part_ctx = (torch.where(sel, part_part[0], part_full[0]),
                        torch.where(sel, part_part[1], part_full[1]),
                        torch.where(sel[..., None], part_part[2],
                                    part_full[2]))
    else:
        raise ValueError(mode)
    out = cm.combine_attn_parts([part_ctx, part_self], h.dtype)
    return bk.attn_output(cfg, lp["attn"], out), upd, q


# ---------------------------------------------------------------------------
# trunk forward (plain layer loop)
# ---------------------------------------------------------------------------

@dataclass
class TrunkOut:
    h: Any                          # [B, T, d] final hidden (pre-final-norm)
    features: Any                   # (low, mid, top) each [B, T, d] or None
    cache: Any                      # updated cache dict (prefill) or None
    new_kv: Any                     # (k, v) [L, B, T, Hk, Dh] or None
    queries: Any = None             # [L, B, T, H, Dh] when emit_queries


def _feature_targets(num_layers: int) -> Tuple[int, int, int]:
    """EAGLE-3 taps: low/mid/top decoder hidden states (output of layer
    i, 0-indexed)."""
    return (max(0, num_layers // 4), num_layers // 2, num_layers - 1)


def trunk_fwd(cfg: ModelConfig, layers: List[Dict], h, positions, *,
              mode: str, self_mask=None, cache: Optional[Dict] = None,
              pkv=None, spec: Optional[SpecPVConfig] = None,
              emit_queries: bool = False, partial_rows=None,
              collect_features: bool = True, pkv_blocks=None) -> TrunkOut:
    """Run the layer stack (see module docstring for modes).

    cache: paged {"k","v" [L,NP,bs,Hk,Dh], "kmax","kmin" [L,NP,Hk,Dh],
    "page_table" [B,NB], "length" [B]} or contiguous {"k","v"
    [L,B,S,Hk,Dh], "kmax","kmin" [L,B,NB,Hk,Dh], "length"}.
    pkv: tail buffer (k, v [L,B,Hk,P,Dh], pos [L,B,Hk,P]);
    pkv_blocks: [L, B, Hk, NS] selected logical block ids."""
    spec = spec or SpecPVConfig()
    num_layers = len(layers)
    f_lo, f_mi, f_hi = _feature_targets(num_layers)
    inv_freq = cm.rope_inv_freq_tensor(cfg, h.device)
    mscale = cm.yarn_mscale(cfg)
    b, t = positions.shape
    length = (cache["length"] if cache is not None
              else torch.zeros((b,), dtype=torch.int32, device=h.device))
    paged = cache is not None and "page_table" in cache
    page_table = cache["page_table"] if paged else None
    paged_kernel = paged and spec.use_pallas
    feats = [None, None, None]
    new_k, new_v, queries = [], [], []
    for i, lp in enumerate(layers):
        cache_kv = (cache["k"][i], cache["v"][i]) if cache is not None else None
        pkv_l = ((pkv[0][i], pkv[1][i], pkv[2][i])
                 if mode in ("decode_partial", "decode_fused") else None)
        att, upd, q = _self_attention(
            cfg, mode, lp, h, positions, self_mask, cache_kv, pkv_l, length,
            inv_freq, mscale, page_table=page_table,
            paged_kernel=paged_kernel, partial_rows=partial_rows,
            pkv_blocks=pkv_blocks[i] if pkv_blocks is not None else None)
        h = h + att
        if mode == "prefill":
            if not paged:
                from repro_torch.kvcache.cache import update_layer_summaries
                nkmax, nkmin = update_layer_summaries(
                    cache["kmax"][i], cache["kmin"][i], cache["k"][i],
                    length, length + t, spec.block_size)
                cache["kmax"][i] = nkmax
                cache["kmin"][i] = nkmin
        else:
            new_k.append(upd["new_k"])
            new_v.append(upd["new_v"])
        if emit_queries:
            queries.append(q)
        x = cm.rmsnorm(h, lp["norm2"], cfg.norm_eps)
        h = h + bk.mlp_fwd(cfg, lp["mlp"], x)
        if collect_features:
            for slot, tgt in enumerate((f_lo, f_mi, f_hi)):
                if i == tgt:
                    feats[slot] = h
    new_cache = None
    if mode == "prefill":
        if paged:
            # the prefill reads no summary: one K4 call after the layer
            # loop covers the chunk in every layer
            from repro_torch.kvcache.cache import paged_update_all_summaries
            blk = cache["k"].shape[2]
            paged_update_all_summaries(cache["kmax"], cache["kmin"],
                                       cache["k"], page_table, length,
                                       length + t, n_touch=-(-t // blk) + 1)
        new_cache = dict(cache)
        new_cache["length"] = length + t
    new_kv = ((torch.stack(new_k), torch.stack(new_v)) if new_k else None)
    return TrunkOut(h=h, features=tuple(feats) if collect_features else None,
                    cache=new_cache, new_kv=new_kv,
                    queries=torch.stack(queries) if emit_queries else None)
