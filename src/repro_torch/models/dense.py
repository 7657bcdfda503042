"""GQA trunk (counterpart of ``repro/models/dense.py``, dense and MoE
architectures: a layer's MLP is the gated MLP or, with experts, the
capacity-dispatch MoE, ``blocks.moe_fwd``).

The reference scans stacked superblocks with ``lax.scan``; here the
layers are a list of per-layer param dicts run by a plain Python loop.

Modes (paged cache = shared block pool + page tables; contiguous cache =
per-row buffers, whose rows the kernels read as a pool of blocks through
the identity list):

  prefill        write the chunk's K/V, attend, update block summaries:
                 the causal prefill kernel (K2) over the row's prefix, then
                 one block-summary (K4) call over every layer.  A ragged
                 chunk (``t_valid``) leaves its pads out of the K/V
                 writes, the key masks, the summaries and ``length``.
  decode_full    T tree tokens vs the full cache + tree self-mask, through
                 the verify kernel (K1).
  decode_partial T tokens vs the partial context: the retrieval-selected
                 blocks (K1), read in place from the pool through the page
                 table (zero-copy) or from the gathered body, merged with
                 the dense tail buffer.
  decode_fused   per-row source select between the two above.
  train          causal attention over the sequence, no cache: the plain
                 chunked attention under autograd (the kernels have no
                 backward), each layer rematerialised in the backward pass
                 when ``cfg.remat`` is set (the reference's
                 ``_train_layer`` under ``jax.checkpoint``).

The paged cache reads through the page table in place
(``SpecPVConfig.use_pallas=True``) or, with ``use_pallas=False``, first
materialises each layer's logical view (``gather_page_view``), the
reference's data flow, and runs the contiguous forms over it: in the
port the flag picks the data flow, never the plain code.  The plain
attention and per-layer summaries run only for the autoregressive
oracle (``plain=True``, contiguous cache; ``core.reference``).

Decode modes never mutate the cache; they return the new tokens' K/V.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, SpecPVConfig, roadmap_item
from repro_torch.device import resolve_device
from repro_torch.models import blocks as bk
from repro_torch.models import common as cm

# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _check_dense(cfg: ModelConfig) -> None:
    stack = ((cfg.arch_type == "dense" and not cfg.num_experts)
             or (cfg.arch_type == "moe" and cfg.num_experts > 0))
    if not stack or cfg.window_size:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense and MoE GQA stacks here; "
            f"this one comes with ROADMAP.md queue 1, '{roadmap_item(cfg)}'")


def _init_layer(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    pd = cm.dt(cfg.param_dtype)
    dev = gen.device
    p = {"norm1": torch.ones((cfg.d_model,), dtype=pd, device=dev),
         "attn": bk.init_attn_params(cfg, gen),
         "norm2": torch.ones((cfg.d_model,), dtype=pd, device=dev)}
    if cfg.num_experts:
        p["moe"] = bk.init_moe_params(cfg, gen)
    else:
        p["mlp"] = bk.init_mlp_params(cfg, gen)
    return p


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


def _body_rows(spec: SpecPVConfig, idx, k_rows, page_table=None):
    """Token-major row ids of the gathered body: slot ``(b, j*bs + t,
    kh)`` reads token t of logical block ``idx[b, kh, j]`` (clamped into
    the table, as the reference's gather does).  Contiguous rows
    ``k_rows`` (the allocation's rows per batch row): ``b * k_rows +
    block*bs + t``; paged: ``page*bs + t`` through ``page_table``.
    Returns [B, NS*bs, Hk] int64."""
    b, hk, ns = idx.shape
    bs = spec.block_size
    dev = idx.device
    nb = page_table.shape[1] if page_table is not None else k_rows // bs
    blk = torch.clamp(idx.long(), 0, nb - 1)
    if page_table is not None:
        base = torch.gather(page_table.long()[:, None].expand(b, hk, nb), 2,
                            blk) * bs
    else:
        base = torch.arange(b, device=dev)[:, None, None] * k_rows + blk * bs
    rows = base[..., None] + torch.arange(bs, device=dev)  # [B, Hk, NS, bs]
    return rows.reshape(b, hk, ns * bs).transpose(1, 2)


def gather_partial_body(spec: SpecPVConfig, idx, k, v, page_table=None):
    """The gathered partial body of every layer, token-major: (bk, bv)
    [L, B, NS*bs, Hk, Dh], slot ``(l, b, j*bs + t, kh)`` holding token t
    of the block head kh selected in slot j (``idx`` [L, B, Hk, NS]
    logical ids; -1 reads block 0, masked by its valid length 0).  k/v:
    the contiguous cache [L, B, S, Hk, Dh] or, with ``page_table``, the
    pool [L, NP, bs, Hk, Dh]."""
    from repro_torch.kernels.ops import flat_blocks
    layers = idx.shape[0]
    hk = k.shape[-2]
    if page_table is not None:
        kf = k.reshape(layers, -1, hk, k.shape[-1])
        vf = v.reshape(layers, -1, hk, v.shape[-1])
        k_rows = 0
    else:
        kf, k_rows = flat_blocks(k)
        vf, _ = flat_blocks(v)
        kf = kf.view(layers, -1, hk, k.shape[-1])
        vf = vf.view(layers, -1, hk, v.shape[-1])
    rows = torch.stack([_body_rows(spec, idx[i], k_rows, page_table)
                        for i in range(layers)])         # [L, B, P, Hk]
    lsel = torch.arange(layers, device=idx.device)[:, None, None, None]
    hsel = torch.arange(hk, device=idx.device)
    return kf[lsel, rows, hsel], vf[lsel, rows, hsel]


def body_positions(spec: SpecPVConfig, idx, length):
    """The reference's partial-body positions [B, Hk, NS*bs] of a
    selection ``idx`` [B, Hk, NS] (-1 unused): ``block*bs + t`` where
    below ``length``, else -1."""
    bs = spec.block_size
    pos = (idx.long()[..., None] * bs
           + torch.arange(bs, device=idx.device))        # [B, Hk, NS, bs]
    ok = (idx >= 0)[..., None] & (pos < length.long()[:, None, None, None])
    pos = torch.where(ok, pos, torch.full_like(pos, -1))
    return pos.reshape(idx.shape[0], idx.shape[1], -1).to(torch.int32)


def select_and_gather_partial(spec: SpecPVConfig, scores, k_layer, v_layer,
                              length):
    """The reference's gathered selection: sink + top-K retrieval + local
    blocks of one layer's contiguous cache.  scores: [B, Hk, NB];
    k_layer/v_layer: [B, S, Hk, Dh] (``init_contiguous_kv``); length:
    [B].  Returns (pk, pv, ppos): [B, Hk, P, Dh] x2 and [B, Hk, P] with P
    = spec.partial_budget_tokens, invalid slots at pos -1."""
    idx = select_partial_blocks(spec, scores, length)
    bk_, bv_ = gather_partial_body(spec, idx[None], k_layer[None],
                                   v_layer[None])
    return (bk_[0].transpose(1, 2), bv_[0].transpose(1, 2),
            body_positions(spec, idx, length))


def select_and_gather_partial_paged(spec: SpecPVConfig, scores, pool_k,
                                    pool_v, page_table, length):
    """``select_and_gather_partial`` straight from one layer's pool
    [NP, block, Hk, Dh] through ``page_table`` [B, NB]."""
    idx = select_partial_blocks(spec, scores, length)
    bk_, bv_ = gather_partial_body(spec, idx[None], pool_k[None],
                                   pool_v[None], page_table)
    return (bk_[0].transpose(1, 2), bv_[0].transpose(1, 2),
            body_positions(spec, idx, length))


def _selected_vlen(pbi, length, bs: int):
    """Valid tokens of each selected block [B, Hk, NS]: the part below
    ``length`` (the reference's ``pos < length`` mask), 0 for an unused
    slot."""
    return torch.where(pbi >= 0, torch.clamp(
        length[:, None, None] - pbi * bs, 0, bs), torch.zeros_like(pbi))


def _partial_context(q, cache_kv, page_table, pbi, length, pkv_l, bs: int):
    """Partial-context partials: the body through the verify kernel (K1)
    merged with the dense tail buffer ``pkv_l[:3]`` = (pk, pv, ppos)
    [B, Hk, P, ...] (the plain per-head part).  The body is the selected
    blocks ``pbi`` [B, Hk, NS] (logical ids, -1 = unused), read in place
    from the pool through the live page table (zero-copy), or, when
    ``pkv_l`` also carries the gathered body [B, NS*bs, Hk, Dh] x2, from
    the body: slot j of row b is its block ``b*NS + j``.  Both forms make
    the same K1 launch over the same bytes.  Returns (m, l, acc)."""
    from repro_torch.kernels import ops as kops
    b, hk, ns = pbi.shape
    pk_buf, pv_buf, ppos_buf = pkv_l[:3]
    vlen = _selected_vlen(pbi, length, bs)
    if len(pkv_l) > 3:
        body_k, body_v = pkv_l[3:5]
        idx = (torch.arange(b, device=pbi.device)[:, None, None] * ns
               + torch.arange(ns, device=pbi.device)).expand(b, hk, ns)
        pool_k = body_k.reshape(b * ns, bs, hk, body_k.shape[-1])
        pool_v = body_v.reshape(b * ns, bs, hk, body_v.shape[-1])
    else:
        pool_k, pool_v = cache_kv
        nb = page_table.shape[1]
        # the reference's gather clamps ids into the table; torch raises
        idxc = torch.clamp(pbi.long(), 0, nb - 1)
        pg = torch.gather(page_table.long()[:, None].expand(b, hk, nb), 2,
                          idxc)
        idx = torch.where(pbi >= 0, pg, torch.zeros_like(pg))
    part_body = kops.routed_partial_attention(q, pool_k, pool_v, idx, vlen)
    part_buf = cm.dense_attn_part_perhead(q, pk_buf, pv_buf, ppos_buf >= 0)
    return cm.merge_attn_partials([part_body, part_buf])


# ---------------------------------------------------------------------------
# per-layer forward
# ---------------------------------------------------------------------------

def _self_attention(cfg: ModelConfig, mode: str, lp: Dict, h, positions,
                    self_mask, cache_kv, pkv, length, inv_freq, mscale,
                    page_table=None, paged_kernel: bool = False,
                    partial_rows=None, pkv_blocks=None, block_size: int = 128,
                    plain: bool = False, t_valid=None):
    """One self-attention sublayer under `mode` (see module docstring).
    With ``page_table`` set, ``cache_kv`` is the layer's pool pair
    [NP, block, Hk, Dh] (prefill writes it in place), read through the
    table (``paged_kernel``) or through its materialised view; else the
    layer's contiguous pair [B, S, Hk, Dh].  ``plain``: the oracle's
    plain attention (contiguous only).  ``t_valid`` [B] (prefill only):
    a ragged chunk, row b carrying ``t_valid[b]`` real tokens, then pads
    that write no K/V (paged: the null page; contiguous: zeros, as the
    reference) and that no key mask counts.  Returns (attn_out, updates,
    q)."""
    from repro_torch.kernels import ops as kops
    x = cm.rmsnorm(h, lp["norm1"], cfg.norm_eps)
    q = bk.project_q(cfg, lp["attn"], x, positions, inv_freq, mscale)
    k_new, v_new = bk.project_kv(cfg, lp["attn"], x, positions, inv_freq,
                                 mscale)
    b, t = positions.shape
    dev = h.device
    upd: Dict[str, Any] = {}
    if plain and page_table is not None:
        raise ValueError("the plain route reads the contiguous cache only")

    def layer_view():
        """The contiguous (k, v) the contiguous forms read: the cache
        itself, or the paged cache's materialised logical view."""
        if page_table is None:
            return cache_kv
        from repro_torch.kvcache.cache import gather_page_view
        return (gather_page_view(cache_kv[0], page_table),
                gather_page_view(cache_kv[1], page_table))

    def full_context(len_eff):
        if page_table is not None and paged_kernel:
            return kops.paged_verify_attention(q, cache_kv[0], cache_kv[1],
                                               page_table, len_eff)
        k_layer, v_layer = layer_view()
        if plain:
            s = k_layer.shape[1]
            kv_pos = torch.arange(s, device=dev)[None].expand(b, s)
            return cm.flash_attention(
                q, k_layer, v_layer, q_positions=positions,
                kv_positions=kv_pos, causal=True,
                kv_valid=kv_pos < len_eff[:, None], chunk=512,
                return_partials=True)
        return kops.contiguous_verify_attention(q, k_layer, v_layer, len_eff,
                                                block_size)

    if mode == "prefill":
        if t_valid is None:
            tv, valid = torch.full((b,), t, dtype=torch.int32, device=dev), None
        else:
            tv = t_valid
            valid = torch.arange(t, device=dev)[None] < t_valid[:, None]
        if page_table is not None:
            # K/V go into the pool first: the kernel's causal page walk
            # then covers in-chunk self-attention too
            from repro_torch.kvcache.cache import paged_write_tokens
            pool_k, pool_v = cache_kv
            paged_write_tokens(pool_k, page_table, length, k_new, valid)
            paged_write_tokens(pool_v, page_table, length, v_new, valid)
            if paged_kernel:
                out = kops.paged_prefill_attention(q, pool_k, pool_v,
                                                   page_table, length, tv)
                return bk.attn_output(cfg, lp["attn"], out), upd, q
        else:
            from repro_torch.kvcache.cache import append_layer_kv
            append_layer_kv(cache_kv[0], cache_kv[1], k_new, v_new, length,
                            valid)
        k_layer, v_layer = layer_view()
        if plain:
            s = k_layer.shape[1]
            kv_pos = torch.arange(s, device=dev)[None].expand(b, s)
            kv_valid = kv_pos < (length + tv)[:, None]
            out = cm.flash_attention(q, k_layer, v_layer,
                                     q_positions=positions,
                                     kv_positions=kv_pos, causal=True,
                                     kv_valid=kv_valid, chunk=512)
        else:
            out = kops.contiguous_prefill_attention(q, k_layer, v_layer,
                                                    length, tv, block_size)
        return bk.attn_output(cfg, lp["attn"], out), upd, q

    part_self = cm.dense_attn_part(q, k_new, v_new, mask=self_mask[:, None])
    upd["new_k"] = k_new
    upd["new_v"] = v_new
    if mode == "decode_full":
        part_ctx = full_context(length)
    elif mode in ("decode_partial", "decode_fused"):
        if pkv_blocks is None or plain:
            raise ValueError("partial verification reads a selection "
                             "(pkv_blocks) through the kernels")
        part_part = _partial_context(q, cache_kv, page_table, pkv_blocks,
                                     length, pkv, block_size)
        if mode == "decode_partial":
            part_ctx = part_part
        else:
            # one launch per source, row-selected partials: partial rows
            # see the full cache at effective length 0 (no blocks read)
            part_full = full_context(torch.where(
                partial_rows, torch.zeros_like(length), length))
            sel = partial_rows[:, None, None]
            part_ctx = (torch.where(sel, part_part[0], part_full[0]),
                        torch.where(sel, part_part[1], part_full[1]),
                        torch.where(sel[..., None], part_part[2],
                                    part_full[2]))
    else:
        raise ValueError(mode)
    out = cm.combine_attn_parts([part_ctx, part_self], h.dtype)
    return bk.attn_output(cfg, lp["attn"], out), upd, q


def _mlp_or_moe(cfg: ModelConfig, lp: Dict, h, aux: bool = False):
    """The layer's MLP sublayer: (y, its MoE aux loss; None for a dense
    layer or when ``aux`` is not asked for)."""
    x = cm.rmsnorm(h, lp["norm2"], cfg.norm_eps)
    if "moe" in lp:
        return bk.moe_fwd(cfg, lp["moe"], x, aux=aux)
    return bk.mlp_fwd(cfg, lp["mlp"], x), None


def _train_layer(cfg: ModelConfig, lp: Dict, h, positions, inv_freq,
                 mscale):
    """One stateless layer of the train mode: causal attention over the
    sequence (``cm.flash_attention``, the reference's KV tile of
    ``min(512, max(128, T))`` keys and query tiles of 512), then the
    MLP or MoE.  Returns (h, the layer's aux loss)."""
    x = cm.rmsnorm(h, lp["norm1"], cfg.norm_eps)
    q = bk.project_q(cfg, lp["attn"], x, positions, inv_freq, mscale)
    k, v = bk.project_kv(cfg, lp["attn"], x, positions, inv_freq, mscale)
    t = positions.shape[1]
    out = cm.flash_attention(q, k, v, q_positions=positions,
                             kv_positions=positions, causal=True,
                             chunk=min(512, max(128, t)))
    h = h + bk.attn_output(cfg, lp["attn"], out)
    m, aux = _mlp_or_moe(cfg, lp, h, aux=True)
    return h + m, aux


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
    aux_loss: Any = None            # fp32 scalar, the MoE load balance
                                    # summed over layers (train mode)


def _feature_targets(num_layers: int) -> Tuple[int, int, int]:
    """EAGLE-3 taps: low/mid/top decoder hidden states (output of layer
    i, 0-indexed)."""
    return (max(0, num_layers // 4), num_layers // 2, num_layers - 1)


def trunk_fwd(cfg: ModelConfig, layers: List[Dict], h, positions, *,
              mode: str, self_mask=None, cache: Optional[Dict] = None,
              pkv=None, spec: Optional[SpecPVConfig] = None,
              emit_queries: bool = False, partial_rows=None,
              collect_features: bool = True, pkv_blocks=None,
              plain: bool = False, t_valid=None) -> TrunkOut:
    """Run the layer stack (see module docstring for modes).

    cache: paged {"k","v" [L,NP,bs,Hk,Dh], "kmax","kmin" [L,NP,Hk,Dh],
    "page_table" [B,NB], "length" [B]} or contiguous {"k","v"
    [L,B,S,Hk,Dh], "kmax","kmin" [L,B,NB,Hk,Dh], "length"}.
    pkv: tail buffer (k, v [L,B,Hk,P,Dh], pos [L,B,Hk,P]), followed by
    the gathered body (k, v [L,B,NS*bs,Hk,Dh]) unless zero-copy;
    pkv_blocks: [L, B, Hk, NS] selected logical block ids.  ``plain``:
    the oracle's plain route (contiguous cache only).  ``t_valid`` [B]
    (prefill only): a ragged chunk; pads write no K/V, no summary and do
    not advance ``length``."""
    spec = spec or SpecPVConfig()
    num_layers = len(layers)
    f_lo, f_mi, f_hi = _feature_targets(num_layers)
    inv_freq = cm.rope_inv_freq_tensor(cfg, h.device)
    mscale = cm.yarn_mscale(cfg)
    if mode == "train":
        _check_dense(cfg)
        feats = [None, None, None]
        remat = cfg.remat and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i, lp in enumerate(layers):
            args = (cfg, lp, h, positions, inv_freq, mscale)
            h, aux_l = (torch.utils.checkpoint.checkpoint(
                _train_layer, *args, use_reentrant=False) if remat
                else _train_layer(*args))
            if aux_l is not None:
                aux = aux + aux_l
            for slot, tgt in enumerate((f_lo, f_mi, f_hi)):
                if collect_features and i == tgt:
                    feats[slot] = h
        return TrunkOut(h=h, features=tuple(feats) if collect_features
                        else None, cache=None, new_kv=None, aux_loss=aux)
    b, t = positions.shape
    length = (cache["length"] if cache is not None
              else torch.zeros((b,), dtype=torch.int32, device=h.device))
    paged = cache is not None and "page_table" in cache
    page_table = cache["page_table"] if paged else None
    paged_kernel = paged and spec.use_pallas
    # prefill: the end of each row's real tokens after the chunk
    end = (length + (t if t_valid is None else t_valid)
           if mode == "prefill" else None)
    feats = [None, None, None]
    new_k, new_v, queries = [], [], []
    for i, lp in enumerate(layers):
        cache_kv = (cache["k"][i], cache["v"][i]) if cache is not None else None
        pkv_l = (tuple(p[i] for p in pkv)
                 if mode in ("decode_partial", "decode_fused") else None)
        att, upd, q = _self_attention(
            cfg, mode, lp, h, positions, self_mask, cache_kv, pkv_l, length,
            inv_freq, mscale, page_table=page_table,
            paged_kernel=paged_kernel, partial_rows=partial_rows,
            pkv_blocks=pkv_blocks[i] if pkv_blocks is not None else None,
            block_size=spec.block_size, plain=plain, t_valid=t_valid)
        h = h + att
        if mode == "prefill":
            if plain:
                from repro_torch.kvcache.cache import update_layer_summaries
                nkmax, nkmin = update_layer_summaries(
                    cache["kmax"][i], cache["kmin"][i], cache["k"][i],
                    length, end, spec.block_size)
                cache["kmax"][i] = nkmax
                cache["kmin"][i] = nkmin
        else:
            new_k.append(upd["new_k"])
            new_v.append(upd["new_v"])
        if emit_queries:
            queries.append(q)
        # the MoE routes every row of the padded [B, T] input, pads too,
        # as the reference does: pads earlier in the flattened order take
        # expert capacity from real tokens after them
        h = h + _mlp_or_moe(cfg, lp, h)[0]
        if collect_features:
            for slot, tgt in enumerate((f_lo, f_mi, f_hi)):
                if i == tgt:
                    feats[slot] = h
    new_cache = None
    if mode == "prefill":
        # the prefill reads no summary: one K4 call after the layer loop
        # covers the chunk in every layer
        n_touch = -(-t // spec.block_size) + 1
        if paged:
            from repro_torch.kvcache.cache import paged_update_all_summaries
            paged_update_all_summaries(cache["kmax"], cache["kmin"],
                                       cache["k"], page_table, length, end,
                                       n_touch=n_touch)
        elif not plain:
            from repro_torch.kvcache.cache import (
                contiguous_update_all_summaries)
            contiguous_update_all_summaries(cache["kmax"], cache["kmin"],
                                            cache["k"], length, end,
                                            spec.block_size, n_touch)
        new_cache = dict(cache)
        new_cache["length"] = end
    new_kv = ((torch.stack(new_k), torch.stack(new_v)) if new_k else None)
    return TrunkOut(h=h, features=tuple(feats) if collect_features else None,
                    cache=new_cache, new_kv=new_kv,
                    queries=torch.stack(queries) if emit_queries else None)
