"""Attention trunk (counterpart of ``repro/models/dense.py``): dense and
MoE GQA stacks (a layer's MLP is the gated MLP or, with experts, the
capacity-dispatch MoE, ``blocks.moe_fwd``), the VLM's interleaved gated
cross-attention layers and the Whisper decoder and encoder.

The reference scans stacked superblocks with ``lax.scan``; here the
layers are a list of per-layer param dicts run by a plain Python loop.
Layer kinds (``cfg.layer_kinds()``): ``attn`` (self-attention, MLP),
``cross`` (the VLM's tanh-gated cross-attention and gated MLP, no
self-attention) and ``dec`` (Whisper: self-attention, cross-attention,
MLP, no gates).  Caches index their K/V by attention layer (``attn`` and
``dec``) and their cross K/V by cross layer (``cross`` and ``dec``), in
layer order.

Modes (paged cache = shared block pool + page tables; contiguous cache =
per-row buffers, whose rows the kernels read as a pool of blocks through
the identity list):

  prefill        write the chunk's K/V, attend, update block summaries:
                 the causal prefill kernel (K2) over the row's prefix, then
                 one block-summary (K4) call over every layer.  A ragged
                 chunk (``t_valid``) leaves its pads out of the K/V
                 writes, the key masks, the summaries and ``length``.  A
                 stack with ``window_size`` attends through the plain
                 chunked attention over the row's (materialised) cache
                 with the sliding window instead of K2, as the reference
                 does (its paged kernel only when ``window_size == 0``).
  decode_full    T tree tokens vs the full cache + tree self-mask, through
                 the verify kernel (K1).
  decode_partial T tokens vs the partial context: the retrieval-selected
                 blocks (K1), read in place from the pool through the page
                 table (zero-copy) or from the gathered body, merged with
                 the dense tail buffer; or, with no selection
                 (``pkv_blocks`` None), the reference's materialised
                 per-head partial cache, through its plain per-head
                 attention (the reference has no kernel there).
  decode_fused   per-row source select between the two above.
  train          causal attention over the sequence (sliding-windowed with
                 ``window_size``), no cache: the plain
                 chunked attention under autograd (the kernels have no
                 backward), each layer rematerialised in the backward pass
                 when ``cfg.remat`` is set (the reference's
                 ``_train_layer`` under ``jax.checkpoint``).
  encode         the train mode without the causal mask (the Whisper
                 encoder over its frames).

An int8 contiguous cache (K/V int8 [L, B, S, Hk, Dh] beside bf16 scales
``k_scale`` / ``v_scale`` [L, B, S, Hk]; ``kvcache.quant.quantize_kv``)
is decode-only and read as the reference reads it, with no kernel: a
Full verification of at most 8 tokens folds the scales into the logits
and probabilities (``common.dense_attn_part_quant``), a longer one and
the fused step's full rows dequantise tile by tile to bf16 in the plain
chunked attention.  The verify kernel (K1) reads bf16 and fp32 only, and
a paged cache is never int8 (the reference keeps int8 caches
contiguous).

Cross-attention reads fixed encoder states: in train and encode modes
their K/V are projected from ``encoder_out`` at each cross layer; every
cache mode reads the cache's ``cross_k`` / ``cross_v`` rows, which
``write_cross_kv`` fills once per request (the reference recomputes them
at every prefill chunk from the same inputs, to the same values).  The
reference computes cross-attention and the encoder in plain jnp, outside
any Pallas kernel, so here they are plain torch too.  Under tensor
parallelism the cross layers split by heads as self-attention does
(their rows shard-stacked like the K/V); the encoder (``encode_frames``)
and the VLM projector (``project_image``) run whole, once per request,
from the whole tree.

The paged cache reads through the page table in place
(``SpecPVConfig.use_pallas=True``) or, with ``use_pallas=False``, first
materialises each layer's logical view (``gather_page_view``), the
reference's data flow, and runs the contiguous forms over it: in the
port the flag picks the data flow, never the plain code.  The plain
attention and per-layer summaries run only for the autoregressive
oracle (``plain=True``, contiguous cache; ``core.reference``).

Decode modes never mutate the cache; they return the new tokens' K/V.
They attend the whole context whatever ``window_size`` is: the reference
windows only its train and prefill modes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, SpecPVConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as bk
from repro_torch.models import common as cm

# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _check_dense(cfg: ModelConfig) -> None:
    if cfg.arch_type == "hybrid":
        raise ValueError(f"{cfg.name}: a hybrid stack runs the Griffin "
                         f"trunk (models/griffin.py), not the dense one")
    if (cfg.arch_type == "moe") != (cfg.num_experts > 0):
        raise ValueError(f"{cfg.name}: a {cfg.arch_type} stack with "
                         f"{cfg.num_experts} experts is no configuration of "
                         f"the registry (experts belong to 'moe' stacks)")


def superblock_decomp(kinds: Tuple[str, ...]):
    """The reference's layer layout: the smallest period p such that
    ``kinds`` is p-periodic up to a remainder without attention layers.
    Returns (pattern, n_super, remainder)."""
    n = len(kinds)
    for p in range(1, n + 1):
        n_super = n // p
        if n_super == 0:
            continue
        if all(kinds[i] == kinds[i % p] for i in range(n_super * p)):
            rem = kinds[n_super * p:]
            if not any(k in ("attn", "cross", "dec") for k in rem):
                return kinds[:p], n_super, rem
    return kinds, 1, ()


def attn_layer_count(kinds) -> int:
    """Layers with self-attention (and a K/V cache entry)."""
    return sum(1 for k in kinds if k in ("attn", "dec"))


def cross_layer_count(kinds) -> int:
    """Layers with cross-attention (and a cross K/V cache entry)."""
    return sum(1 for k in kinds if k in ("cross", "dec"))


def is_cross_arch(cfg: ModelConfig) -> bool:
    """Does the stack read per-request encoder states (``extra``)?"""
    return cfg.is_attention_arch and cross_layer_count(cfg.layer_kinds()) > 0


def _init_layer(cfg: ModelConfig, gen: torch.Generator,
                kind: str = "attn") -> Dict:
    """One layer's params under the reference's keys for its kind (a
    ``cross`` layer keeps an unused ``norm1``, as the reference's does;
    its gates start at 0, which makes the layer the identity)."""
    pd = cm.dt(cfg.param_dtype)
    dev = gen.device

    def ones():
        return torch.ones((cfg.d_model,), dtype=pd, device=dev)
    p: Dict[str, Any] = {}
    if kind in ("attn", "dec"):
        p["norm1"] = ones()
        p["attn"] = bk.init_attn_params(cfg, gen)
    if kind in ("cross", "dec"):
        p["normx"] = ones()
        p["xattn"] = bk.init_attn_params(cfg, gen)
        if kind == "cross":
            p["norm1"] = ones()
            p["gate_attn"] = torch.zeros((), dtype=pd, device=dev)
            p["gate_mlp"] = torch.zeros((), dtype=pd, device=dev)
    p["norm2"] = ones()
    if cfg.num_experts and kind == "attn":
        p["moe"] = bk.init_moe_params(cfg, gen)
    else:
        p["mlp"] = bk.init_mlp_params(cfg, gen)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from ``seed`` (a ``torch.Generator`` on the target
    device).  Layout: ``embed`` [V, d], ``final_norm`` [d], ``head``
    [d, V] and ``layers``, a list of per-layer dicts in layer order; a
    VLM adds ``projector`` [vision_dim, d], an encoder-decoder
    ``encoder`` (a list of ``attn`` layers), ``encoder_norm`` [d] and
    ``frame_pos`` [num_audio_frames, d]."""
    _check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pd = cm.dt(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": cm.embed_init(gen, (cfg.vocab_size, cfg.d_model), pd),
        "final_norm": torch.ones((cfg.d_model,), dtype=pd, device=dev),
        "layers": [_init_layer(cfg, gen, kind) for kind in cfg.layer_kinds()],
    }
    if not cfg.tie_embeddings:
        params["head"] = cm.dense_init(gen, (cfg.d_model, cfg.vocab_size), pd)
    if cfg.arch_type == "vlm":
        params["projector"] = cm.dense_init(
            gen, (cfg.vision_dim, cfg.d_model), pd)
    if cfg.has_encoder:
        params["encoder"] = [_init_layer(cfg, gen)
                             for _ in range(cfg.encoder_layers)]
        params["encoder_norm"] = torch.ones((cfg.d_model,), dtype=pd,
                                            device=dev)
        params["frame_pos"] = cm.embed_init(
            gen, (cfg.num_audio_frames, cfg.d_model), pd)
    return params


def embed_tokens(cfg: ModelConfig, params, tokens, tp=None):
    """tokens [B, T] -> [B, T, d].  Under tensor parallelism (``tp``,
    ``distributed.tensor_parallel.TensorParallel``) with ``embed`` split
    on its width, each shard looks up its columns and a gather joins them
    (the same bits as the whole table's rows)."""
    if tp is not None and tp.embed_split:
        return tp.map_gather(lambda sh: sh.params["embed"][
            tokens.to(sh.device).long()].to(cm.dt(cfg.dtype)))
    return params["embed"][tokens.long()].to(cm.dt(cfg.dtype))


def head_logits(cfg: ModelConfig, params, h, tp=None):
    """The LM head of normed ``h`` [..., d] -> fp32 logits [..., V]: a
    tied head reads ``embed.T``.  Under tensor parallelism (``tp``) a
    vocabulary-split head is column-parallel (each shard's logits, then
    a gather) and a tied head over a width-split ``embed`` is
    row-parallel (each shard's width slice of ``h`` against its columns,
    the fp32 partial logits summed)."""
    if tp is not None and cfg.tie_embeddings and tp.embed_split:
        w = cfg.d_model // tp.m

        def part(sh):
            hs = h[..., sh.index * w:(sh.index + 1) * w].to(sh.device)
            return (hs @ sh.params["embed"].T.to(h.dtype)).float()
        return tp.map_reduce(part)
    if tp is not None and not cfg.tie_embeddings and tp.head_split:
        return tp.map_gather(lambda sh: (h.to(sh.device) @ sh.params[
            "head"].to(h.dtype)).float())
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (h @ w.to(h.dtype)).float()


def lm_head(cfg: ModelConfig, params, h, tp=None):
    return head_logits(cfg, params,
                       cm.rmsnorm(h, params["final_norm"], cfg.norm_eps), tp)


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


def uses_score_kernel(spec: SpecPVConfig) -> bool:
    """Paper scores with mean reduction go through the retrieval-score
    kernel (K3) on every route (``use_pallas`` picks the data flow, not
    the plain code); the other score modes have no kernel."""
    return spec.score_mode == "paper" and spec.reduction == "mean"


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
        if body_k.dtype == torch.int8:
            raise ValueError("the verify kernel (K1) reads bf16 or fp32 "
                             "K/V: an int8 partial cache is the "
                             "materialised per-head form (pkv_blocks "
                             "None)")
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
    layer's contiguous pair [B, S, Hk, Dh], followed by its scales
    [B, S, Hk] x2 when the cache is int8.  ``pkv``: the tail buffer
    (zero-copy) or the tail buffer and the gathered body when
    ``pkv_blocks`` selects; without ``pkv_blocks``, the materialised
    per-head partial cache.  ``plain``: the oracle's plain attention
    (contiguous only).  ``t_valid`` [B] (prefill only):
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
        if len(cache_kv) > 2:
            # int8 contiguous cache and its scales: the reference's plain
            # routes (dense.py decode_full / decode_fused), no kernel
            k_layer, v_layer, ksc, vsc = cache_kv
            s = k_layer.shape[1]
            kv_pos = torch.arange(s, device=dev)[None].expand(b, s)
            kv_valid = kv_pos < len_eff[:, None]
            if mode == "decode_full" and t <= 8:
                return cm.dense_attn_part_quant(q, k_layer, v_layer, ksc,
                                                vsc, kv_valid)
            return cm.flash_attention(
                q, k_layer, v_layer, q_positions=positions,
                kv_positions=kv_pos, causal=True, kv_valid=kv_valid,
                chunk=512, return_partials=True, k_scale=ksc, v_scale=vsc)
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
            if paged_kernel and not cfg.window_size:
                out = kops.paged_prefill_attention(q, pool_k, pool_v,
                                                   page_table, length, tv)
                return bk.attn_output(cfg, lp["attn"], out), upd, q
        else:
            from repro_torch.kvcache.cache import append_layer_kv
            append_layer_kv(cache_kv[0], cache_kv[1], k_new, v_new, length,
                            valid)
        k_layer, v_layer = layer_view()
        if plain or cfg.window_size:
            # a sliding window takes the plain chunked attention on every
            # layout, the reference's choice (src/repro/models/dense.py
            # prefill: the paged kernel only when window_size == 0)
            s = k_layer.shape[1]
            kv_pos = torch.arange(s, device=dev)[None].expand(b, s)
            kv_valid = kv_pos < (length + tv)[:, None]
            out = cm.flash_attention(q, k_layer, v_layer,
                                     q_positions=positions,
                                     kv_positions=kv_pos, causal=True,
                                     window=cfg.window_size,
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
        if pkv_blocks is None:
            # the reference's materialised per-head partial cache: (pk,
            # pv, ppos) [B, Hk, P, ...], int8 with (pks, pvs) [B, Hk, P]
            pks, pvs = pkv[3:5] if len(pkv) > 3 else (None, None)
            part_part = cm.dense_attn_part_perhead(
                q, pkv[0], pkv[1], pkv[2] >= 0, k_scale=pks, v_scale=pvs)
        elif plain:
            raise ValueError("the plain route reads no selection "
                             "(pkv_blocks)")
        else:
            part_part = _partial_context(q, cache_kv, page_table,
                                         pkv_blocks, length, pkv, block_size)
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


def _mlp_or_moe(cfg: ModelConfig, lp: Dict, h,
                route: Optional[bk.MoeRoute] = None):
    """The layer's MLP sublayer: (y, the MoE layer's ``MoeStats``; None
    for a dense layer)."""
    x = cm.rmsnorm(h, lp["norm2"], cfg.norm_eps)
    if "moe" in lp:
        return bk.moe_fwd(cfg, lp["moe"], x, route=route)
    return bk.mlp_fwd(cfg, lp["mlp"], x), None


def _mlp_or_moe_tp(tp, i: int, lp: Dict, h):
    """Layer ``i``'s MLP or MoE sublayer under tensor parallelism: the
    norm once, then each shard's columns and rows (the MoE: the router
    and dispatch once, each shard's experts, ``blocks.moe_fwd``) and one
    sum; a block that does not split runs once, whole.  The MoE's drops
    are counted (``blocks.count_drops``)."""
    if not (tp.moe_split if "moe" in lp else tp.mlp_split):
        y, st = _mlp_or_moe(tp.cfg, lp, h)
        bk.count_drops(st)
        return y
    x = cm.rmsnorm(h, lp["norm2"], tp.cfg.norm_eps)
    if "moe" in lp:
        ps = [sh.params["layers"][i]["moe"] for sh in tp.shards]
        y, st = bk.moe_fwd(tp.cfg, lp["moe"], x, expert_shards=(tp, ps))
        bk.count_drops(st)
        return y
    return tp.map_reduce(lambda sh: bk.mlp_fwd(
        sh.cfg, sh.params["layers"][i]["mlp"], x.to(sh.device)))


def _cross_heads(cfg: ModelConfig, xp: Dict, x, cross_kv):
    """The cross-attention of the heads ``xp`` holds (a layer's ``xattn``,
    or one model shard's piece of it, with ``cfg`` its head counts) over
    their cached encoder K/V ``cross_kv`` [B, Te, Hk, Dh]: the
    reference's dense ``sdpa`` for up to 1024 queries, its chunked
    attention (KV tiles of ``min(512, Te)`` keys, query tiles of 512)
    beyond, so no [T, Te] fp32 tensor is held at train length; then the
    rows ``wo``."""
    b, t, _ = x.shape
    q = x @ xp["wq"].to(x.dtype)
    if "bq" in xp:
        q = q + xp["bq"].to(x.dtype)
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim_)
    ck, cv = cross_kv
    if t > 1024:
        te = ck.shape[1]
        zq = torch.zeros((b, t), dtype=torch.int32, device=x.device)
        zk = torch.zeros((b, te), dtype=torch.int32, device=x.device)
        out = cm.flash_attention(q, ck, cv, q_positions=zq, kv_positions=zk,
                                 causal=False, chunk=min(512, te),
                                 q_chunk=512)
    else:
        out = cm.sdpa(q, ck, cv)
    return bk.attn_output(cfg, xp, out)


def _cross_attention(cfg: ModelConfig, lp: Dict, h, cross_kv, tp=None,
                     i: int = 0):
    """Cross-attention over fixed encoder states (no rope on either
    side).  ``cross_kv``: the layer's (k, v) [B, Te, Hk, Dh]; under
    tensor parallelism (``tp`` splitting attention, ``i`` the layer) a
    list with each model shard's (k, v) at its KV heads: the norm once,
    each shard's heads (``wq`` columns, ``wo`` rows), one sum."""
    x = cm.rmsnorm(h, lp["normx"], cfg.norm_eps)
    if tp is None or not tp.attn_split:
        return _cross_heads(cfg, lp["xattn"], x, cross_kv)
    return tp.map_reduce(lambda sh: _cross_heads(
        sh.cfg, sh.params["layers"][i]["xattn"], x, cross_kv[sh.index]))


def _gate(g, h):
    """A cross layer's tanh gate, computed in fp32 and cast to the
    activations' dtype, as the reference's."""
    return torch.tanh(g.float()).to(h.dtype)


def compute_cross_kv(cfg: ModelConfig, lp: Dict, encoder_out):
    """K/V projections [B, Te, Hk, Dh] of the encoder states [B, Te, d]
    for one cross layer."""
    b, te, _ = encoder_out.shape
    k = encoder_out @ lp["xattn"]["wk"].to(encoder_out.dtype)
    v = encoder_out @ lp["xattn"]["wv"].to(encoder_out.dtype)
    if "bk" in lp["xattn"]:
        k = k + lp["xattn"]["bk"].to(encoder_out.dtype)
        v = v + lp["xattn"]["bv"].to(encoder_out.dtype)
    return (k.reshape(b, te, cfg.num_kv_heads, cfg.head_dim_),
            v.reshape(b, te, cfg.num_kv_heads, cfg.head_dim_))


def write_cross_kv(cfg: ModelConfig, layers: List[Dict], cross_k, cross_v,
                   encoder_out, tp=None) -> None:
    """Every cross layer's K/V of ``encoder_out`` [B, Te, d], copied in
    place into ``cross_k`` / ``cross_v`` [L_cross, B, Te, Hk, Dh] (the
    cache's rows, or a view of some of them): a captured graph reads
    these addresses, so they are written, never rebound.  Under tensor
    parallelism (``tp`` splitting attention) the rows are shard-stacked
    ([m * L_cross, B, Te, Hk / m, Dh], shard s's cross layer c at ``s *
    L_cross + c``), each shard's from its ``wk`` / ``wv`` columns."""
    split = tp is not None and tp.attn_split
    n_c = cross_layer_count(cfg.layer_kinds())
    c = 0
    for i, (kind, lp) in enumerate(zip(cfg.layer_kinds(), layers)):
        if kind in ("cross", "dec"):
            units = ([(sh.cfg, sh.params["layers"][i], sh.index * n_c + c)
                      for sh in tp.shards] if split else [(cfg, lp, c)])
            for ucfg, ulp, j in units:
                k, v = compute_cross_kv(ucfg, ulp, encoder_out)
                cross_k[j].copy_(k)
                cross_v[j].copy_(v)
            c += 1


def _train_layer(cfg: ModelConfig, lp: Dict, h, positions, inv_freq,
                 mscale, encoder_out=None, *, kind: str = "attn",
                 causal: bool = True, route: Optional[bk.MoeRoute] = None):
    """One stateless layer of the train (``causal``) or encode mode: the
    self-attention over the sequence (``cm.flash_attention``, the
    reference's KV tile of ``min(512, max(128, T))`` keys and query
    tiles of 512; causal attention keeps ``cfg.window_size``) of an
    ``attn`` or ``dec`` layer, the cross-attention over ``encoder_out``
    of a ``cross`` or ``dec`` layer (a ``cross`` layer's tanh-gated),
    then the MLP or MoE (gated in a ``cross`` layer; an MoE under
    ``route``).  Returns (h, the MoE layer's ``MoeStats`` or None)."""
    if kind in ("attn", "dec"):
        x = cm.rmsnorm(h, lp["norm1"], cfg.norm_eps)
        q = bk.project_q(cfg, lp["attn"], x, positions, inv_freq, mscale)
        k, v = bk.project_kv(cfg, lp["attn"], x, positions, inv_freq,
                             mscale)
        t = positions.shape[1]
        out = cm.flash_attention(q, k, v, q_positions=positions,
                                 kv_positions=positions, causal=causal,
                                 window=cfg.window_size if causal else 0,
                                 chunk=min(512, max(128, t)))
        h = h + bk.attn_output(cfg, lp["attn"], out)
    if kind in ("cross", "dec"):
        xo = _cross_attention(cfg, lp, h,
                              compute_cross_kv(cfg, lp, encoder_out))
        h = h + (_gate(lp["gate_attn"], h) * xo if kind == "cross" else xo)
    m, stats = _mlp_or_moe(cfg, lp, h, route=route)
    if kind == "cross":
        m = _gate(lp["gate_mlp"], h) * m
    return h + m, stats


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
    moe_stats: Any = None           # each MoE layer's MoeStats (train
                                    # mode)
    partial: Any = None             # (pk, pv, ppos) [L, B, Hk, P, ...]
                                    # with select_partial


def _feature_targets(num_layers: int) -> Tuple[int, int, int]:
    """EAGLE-3 taps: low/mid/top decoder hidden states (output of layer
    i, 0-indexed)."""
    return (max(0, num_layers // 4), num_layers // 2, num_layers - 1)


def trunk_fwd(cfg: ModelConfig, layers: List[Dict], h, positions, *,
              mode: str, self_mask=None, cache: Optional[Dict] = None,
              pkv=None, spec: Optional[SpecPVConfig] = None,
              emit_queries: bool = False, partial_rows=None,
              collect_features: bool = True, pkv_blocks=None,
              plain: bool = False, t_valid=None, encoder_out=None,
              kinds: Optional[Tuple[str, ...]] = None,
              select_partial: bool = False, q_weight=None,
              tp=None, moe_routes=None) -> TrunkOut:
    """Run the layer stack (see module docstring for modes).

    cache: paged {"k","v" [L,NP,bs,Hk,Dh], "kmax","kmin" [L,NP,Hk,Dh],
    "page_table" [B,NB], "length" [B]} or contiguous {"k","v"
    [L,B,S,Hk,Dh], "kmax","kmin" [L,B,NB,Hk,Dh], "length"}, L the
    attention layers; a stack with cross layers adds "cross_k",
    "cross_v" [L_cross, B, Te, Hk, Dh], which every cache mode reads.
    An int8 contiguous cache adds "k_scale", "v_scale" [L,B,S,Hk] (decode
    modes only; a paged cache is never int8).
    pkv with pkv_blocks [L, B, Hk, NS] (the selected logical block ids):
    the tail buffer (k, v [L,B,Hk,P,Dh], pos [L,B,Hk,P]), followed by the
    gathered body (k, v [L,B,NS*bs,Hk,Dh]) unless zero-copy; without
    pkv_blocks: the reference's materialised per-head partial cache (k,
    v [L,B,Hk,P,Dh], pos [L,B,Hk,P]), int8 with its scales (ks, vs
    [L,B,Hk,P]).  ``select_partial`` (decode modes): also return the
    partial cache a Refresh would gather, selected by this step's
    queries weighted by ``q_weight`` [B, T] (default all 1).  ``plain``:
    the oracle's plain route (contiguous cache only).  ``t_valid`` [B]
    (prefill only): a ragged chunk; pads write no K/V, no summary and do
    not advance ``length``.  ``encoder_out`` [B, Te, d]: the encoder
    states the train and encode modes' cross layers read.  ``kinds``:
    the layers' kinds (default ``cfg.layer_kinds()``).  ``moe_routes``
    (train mode, one ``blocks.MoeRoute`` per layer, None for a dense
    one): the tokens are one data shard of a larger batch, and
    ``aux_loss`` is None (``api.sharded_train_loss`` forms it from
    ``moe_stats``); without it each MoE layer routes the whole batch.
    The MoE layers' drops are counted here, once per forward, not again
    when a layer is recomputed in the backward pass.

    ``tp`` (``distributed.tensor_parallel.TensorParallel``, cache modes
    only, every shard on one device): each layer runs its attention on
    every model shard, with that shard's heads, weights and per-head
    state (entry ``s * L + a`` of the shard-stacked cache, tail buffer,
    body and ``pkv_blocks``), then one sum at the residual; a cross
    layer's cross-attention the same way over its shard-stacked
    ``cross_k`` / ``cross_v`` rows; then its MLP or MoE on every shard,
    then one sum.  A block that does not split runs once, whole.
    ``new_kv``, ``queries`` and ``partial`` come back shard-stacked the
    same way ([m * L, ...] at the shard's heads).  An int8 cache carries
    its scales ``k_scale`` / ``v_scale`` [m * L, B, S, Hk / m] and an int8
    per-head partial cache its (ks, vs) [m * L, B, Hk / m, P] stacked the
    same way: each shard reads its own payload and scales."""
    spec = spec or SpecPVConfig()
    kinds = kinds if kinds is not None else cfg.layer_kinds()
    f_lo, f_mi, f_hi = _feature_targets(len(layers))
    inv_freq = cm.rope_inv_freq_tensor(cfg, h.device)
    mscale = cm.yarn_mscale(cfg)
    if mode in ("train", "encode"):
        _check_dense(cfg)
        feats = [None, None, None]
        remat = cfg.remat and torch.is_grad_enabled()
        n = h.shape[0] * h.shape[1]
        stats = []
        for i, (kind, lp) in enumerate(zip(kinds, layers)):
            if kind in ("cross", "dec") and encoder_out is None:
                raise ValueError(f"{cfg.name}: a {kind} layer reads encoder "
                                 f"states; pass the request's `extra`")
            args = (cfg, lp, h, positions, inv_freq, mscale, encoder_out)
            # the route is an input of the checkpointed call: the
            # recompute reads the prefix the forward read
            kw = dict(kind=kind, causal=mode == "train",
                      route=None if moe_routes is None else moe_routes[i])
            h, st = (torch.utils.checkpoint.checkpoint(
                _train_layer, *args, use_reentrant=False, **kw) if remat
                else _train_layer(*args, **kw))
            bk.count_drops(st)
            if st is not None:
                stats.append(st)
            for slot, tgt in enumerate((f_lo, f_mi, f_hi)):
                if collect_features and i == tgt:
                    feats[slot] = h
        aux = (None if moe_routes is not None else
               bk.moe_aux(cfg, n, [[st] for st in stats], h.device))
        return TrunkOut(h=h, features=tuple(feats) if collect_features
                        else None, cache=None, new_kv=None, aux_loss=aux,
                        moe_stats=stats)
    if tp is not None:
        if plain:
            raise NotImplementedError(
                "tensor parallelism runs the engine's kernel routes (the "
                "plain oracle under it is not ported yet: ROADMAP.md queue "
                "1, 'Multi-GPU, part 4')")
        tp.require_single_device()
    b, t = positions.shape
    length = (cache["length"] if cache is not None
              else torch.zeros((b,), dtype=torch.int32, device=h.device))
    paged = cache is not None and "page_table" in cache
    page_table = cache["page_table"] if paged else None
    int8 = cache is not None and cache["k"].dtype == torch.int8
    if int8 and (paged or mode == "prefill" or select_partial
                 or "k_scale" not in cache):
        raise ValueError("an int8 K/V cache is contiguous, decode-only and "
                         "carries its scales (k_scale, v_scale); it is "
                         "never prefilled, paged or gathered (the "
                         "reference keeps int8 caches contiguous and would "
                         "read int8 pages without their scales)")
    if select_partial and q_weight is None:
        q_weight = torch.ones((b, t), dtype=torch.float32, device=h.device)
    paged_kernel = paged and spec.use_pallas
    # prefill: the end of each row's real tokens after the chunk
    end = (length + (t if t_valid is None else t_valid)
           if mode == "prefill" else None)
    feats = [None, None, None]
    # the attention units: (config, layer params per layer, state offset);
    # one whole unit, or one per model shard when attention splits
    if tp is not None and tp.attn_split:
        l_attn = attn_layer_count(kinds)
        units = [(sh.cfg, sh.params["layers"], sh.index * l_attn)
                 for sh in tp.shards]
    else:
        units = [(cfg, layers, 0)]
    n_u = len(units)
    new_k, new_v, queries, partial = ([[] for _ in range(n_u)]
                                      for _ in range(4))
    a_i = c_i = 0               # attention / cross layer index
    for i, (kind, lp) in enumerate(zip(kinds, layers)):
        if kind in ("attn", "dec"):
            atts = []
            for u, (ucfg, ulayers, off) in enumerate(units):
                j = off + a_i
                cache_kv = None
                if cache is not None:
                    cache_kv = (cache["k"][j], cache["v"][j])
                    if int8:
                        cache_kv += (cache["k_scale"][j],
                                     cache["v_scale"][j])
                pkv_l = (tuple(p[j] for p in pkv)
                         if mode in ("decode_partial", "decode_fused")
                         else None)
                att, upd, q = _self_attention(
                    ucfg, mode, ulayers[i], h, positions, self_mask,
                    cache_kv, pkv_l, length, inv_freq, mscale,
                    page_table=page_table, paged_kernel=paged_kernel,
                    partial_rows=partial_rows,
                    pkv_blocks=pkv_blocks[j] if pkv_blocks is not None
                    else None, block_size=spec.block_size, plain=plain,
                    t_valid=t_valid)
                atts.append(att)
                if mode == "prefill":
                    if plain:
                        from repro_torch.kvcache.cache import (
                            update_layer_summaries)
                        nkmax, nkmin = update_layer_summaries(
                            cache["kmax"][j], cache["kmin"][j],
                            cache["k"][j], length, end, spec.block_size)
                        cache["kmax"][j] = nkmax
                        cache["kmin"][j] = nkmin
                else:
                    new_k[u].append(upd["new_k"])
                    new_v[u].append(upd["new_v"])
                if emit_queries:
                    queries[u].append(q)
                if select_partial:
                    partial[u].append(_select_partial(spec, q, q_weight,
                                                      cache, j, length))
            # one sum joins the shards' row-split ``wo`` outputs
            h = h + (atts[0] if n_u == 1 else tp.map_reduce(
                lambda sh: atts[sh.index]))
            a_i += 1
        if kind in ("cross", "dec"):
            if tp is not None and tp.attn_split:
                l_cross = cross_layer_count(kinds)
                ckv = [(cache["cross_k"][sh.index * l_cross + c_i],
                        cache["cross_v"][sh.index * l_cross + c_i])
                       for sh in tp.shards]
            else:
                ckv = (cache["cross_k"][c_i], cache["cross_v"][c_i])
            xo = _cross_attention(cfg, lp, h, ckv, tp, i)
            h = h + (_gate(lp["gate_attn"], h) * xo if kind == "cross"
                     else xo)
            c_i += 1
        # the MoE routes every row of the padded [B, T] input, pads too,
        # as the reference does: pads earlier in the flattened order take
        # expert capacity from real tokens after them
        if tp is None:
            m, st = _mlp_or_moe(cfg, lp, h)
            bk.count_drops(st)
        else:
            m = _mlp_or_moe_tp(tp, i, lp, h)
        h = h + (_gate(lp["gate_mlp"], h) * m if kind == "cross" else m)
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
    # unit-major: unit u's layer a at u * L + a (the shard-stacked state)
    new_k, new_v, queries, partial = ([x for xs in lists for x in xs]
                                      for lists in (new_k, new_v, queries,
                                                    partial))
    new_kv = ((torch.stack(new_k), torch.stack(new_v)) if new_k else None)
    return TrunkOut(h=h, features=tuple(feats) if collect_features else None,
                    cache=new_cache, new_kv=new_kv,
                    queries=torch.stack(queries) if emit_queries else None,
                    partial=(tuple(torch.stack(a) for a in zip(*partial))
                             if partial else None))


def _select_partial(spec: SpecPVConfig, q, q_weight, cache: Dict, a_i: int,
                    length):
    """The in-trunk Refresh of attention layer ``a_i`` (the reference's
    ``select_partial``): Quest scores of this step's queries ``q`` [B, T,
    H, Dh], weighted by ``q_weight`` [B, T], over the layer's block
    summaries (K3 where ``uses_score_kernel``), then sink + top-K +
    local selection, gathered from the contiguous cache or through the
    page table.  Returns (pk, pv, ppos) [B, Hk, P, ...]."""
    from repro_torch.kernels import ops as kops
    kmax_l, kmin_l = cache["kmax"][a_i], cache["kmin"][a_i]
    pt = cache.get("page_table")
    if pt is not None:
        kmax_l, kmin_l = kmax_l[pt.long()], kmin_l[pt.long()]
    if uses_score_kernel(spec):
        scores = kops.retrieval_scores(q, kmax_l, kmin_l, q_weight.float())
    else:
        scores = quest_block_scores(q, kmax_l, kmin_l, q_weight,
                                    score_mode=spec.score_mode,
                                    reduction=spec.reduction)
    k_l, v_l = cache["k"][a_i], cache["v"][a_i]
    if pt is not None:
        return select_and_gather_partial_paged(spec, scores, k_l, v_l, pt,
                                               length)
    return select_and_gather_partial(spec, scores, k_l, v_l, length)


def encode_frames(cfg: ModelConfig, params, frame_embeds):
    """The Whisper encoder: frame embeddings [B, Te, d] plus the learned
    frame positions through the encoder stack (non-causal), then its
    norm.  Returns the encoder states [B, Te, d]."""
    h = frame_embeds.to(cm.dt(cfg.dtype))
    h = h + params["frame_pos"][None, : h.shape[1]].to(h.dtype)
    b, te, _ = h.shape
    pos = torch.arange(te, device=h.device)[None].expand(b, te)
    out = trunk_fwd(cfg, params["encoder"], h, pos, mode="encode",
                    kinds=("attn",) * cfg.encoder_layers,
                    collect_features=False)
    return cm.rmsnorm(out.h, params["encoder_norm"], cfg.norm_eps)


def project_image(cfg: ModelConfig, params, image_embeds):
    """The VLM projector: [B, Timg, vision_dim] -> [B, Timg, d_model]."""
    x = image_embeds.to(cm.dt(cfg.dtype))
    return x @ params["projector"].to(x.dtype)
