"""Model API of the port (counterpart of ``repro/models/api.py``: the
dense, MoE, VLM and audio attention architectures and the RWKV-6 and
Griffin state architectures):

  init_params(cfg, seed, device)               -> params dict
  init_cache(cfg, batch, max_len, spec, ...)   -> cache dict
  extra_inputs_for(cfg, batch, seed, device)   -> stub modality inputs
  prefill(cfg, params, tokens, cache, ...)     -> (logits, features, cache)
  decode(cfg, params, tokens, positions, cache, ...) -> DecodeOut
  advance(cfg, params, tokens, cache, valid)   -> cache   (ssm, hybrid)
  train_loss(cfg, params, tokens, extra=...)   -> (loss, metrics)
  sharded_train_loss(cfg, shards)              -> (loss, metrics)

Attention archs expose the SpecPV verification modes through
``decode(mode=...)``; the state archs do read-only chain verification
in ``decode`` and commit the accepted prefix with ``advance``.  A VLM or
audio target is conditioned per request by ``extra`` (image patch or
audio frame embeddings): ``prefill(extra=...)`` writes the cross layers'
K/V of its encoder states into the cache, where decoding reads them.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, SpecPVConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as bk
from repro_torch.models import common as cm
from repro_torch.models import dense as dn
from repro_torch.models import griffin as gf
from repro_torch.models import rwkv6 as rw


class Features(NamedTuple):
    low: Any
    mid: Any
    top: Any

    def fused_input(self):
        """[B, T, 3d] — input to the EAGLE-3 draft fuse layer."""
        return torch.cat([self.low, self.mid, self.top], dim=-1)


class DecodeOut(NamedTuple):
    logits: Any                 # [B, T, V] fp32
    features: Optional[Features]
    new_kv: Any                 # (k, v) [L, B, T, Hk, Dh]
    queries: Any = None         # [L, B, T, H, Dh] when requested
    partial: Any = None         # (pk, pv, ppos) [L, B, Hk, P, ...] when
                                # select_partial


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    if cfg.arch_type == "ssm":
        return rw.init_params(cfg, seed, device)
    if cfg.arch_type == "hybrid":
        return gf.init_params(cfg, seed, device)
    return dn.init_params(cfg, seed, device)


def unstacked_layers(cfg: ModelConfig) -> int:
    """How many trailing entries of ``params["layers"]`` the reference
    keeps unstacked: Griffin's remainder layers (weight decay follows
    the reference's leaf rank, ``train.optimizer``); 0 otherwise."""
    if cfg.arch_type != "hybrid":
        return 0
    return len(gf.superblock_decomp(cfg.layer_kinds())[2])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               spec: Optional[SpecPVConfig] = None, *, paged: bool = False,
               num_pages: Optional[int] = None, device=None,
               kv_shards: int = 1) -> dict:
    """Cache dict.  ``paged=True`` backs it with a shared block pool
    [L, NumPages, block, ...] plus per-slot page tables (page 0 is the
    null page, so ``num_pages`` defaults to ``batch * S_max/block + 1``);
    otherwise per-row K/V [L, B, max_len, ...], views over block-rounded
    rows (``kvcache.cache.init_contiguous_kv``).  The state archs keep
    their bounded recurrent state (Griffin: and its rolling attention
    windows) instead, with no paging.  ``kv_shards`` = m (tensor
    parallelism over m model shards whose attention splits,
    ``TensorParallel.kv_shards``) stacks the shards' K/V, summaries and
    cross rows on the layer axis: [m * L, ..., Hk / m, Dh], shard s's
    layer l at ``s * L + l`` (``distributed.tensor_parallel``); for a
    state arch it stacks the recurrent state the shards split (RWKV-6's
    ``wkv``, Griffin's ``rnn_h`` and ``conv``) the same way."""
    dev = resolve_device(device)
    dtype = cm.dt(cfg.dtype)
    if cfg.arch_type in ("ssm", "hybrid"):
        if paged:
            raise ValueError("paged KV is attention-only (state archs keep "
                             "O(1) state)")
        init = rw.init_state if cfg.arch_type == "ssm" else gf.init_state
        return init(cfg, batch, dtype, dev, shards=kv_shards)
    dn._check_dense(cfg)
    kinds = cfg.layer_kinds()
    l_attn, l_cross = dn.attn_layer_count(kinds), dn.cross_layer_count(kinds)
    hk, dh = cfg.num_kv_heads, cfg.head_dim_
    if kv_shards > 1:
        if hk % kv_shards:
            raise ValueError(f"{cfg.name}: {hk} KV heads do not split over "
                             f"{kv_shards} model shards")
        l_attn, l_cross = l_attn * kv_shards, l_cross * kv_shards
        hk = hk // kv_shards
    block = spec.block_size if spec else 128
    nb = -(-max_len // block)
    if paged:
        from repro_torch.kvcache.cache import init_paged_pool
        np_total = num_pages if num_pages is not None else batch * nb + 1
        cache = init_paged_pool(l_attn, np_total, block, hk, dh, dtype, dev)
        cache["page_table"] = torch.zeros((batch, nb), dtype=torch.int32,
                                          device=dev)
    else:
        from repro_torch.kvcache.cache import init_contiguous_kv
        k, v = init_contiguous_kv(l_attn, batch, max_len, block, hk, dh,
                                  dtype, dev)
        cache = {
            "k": k,
            "v": v,
            "kmax": torch.zeros((l_attn, batch, nb, hk, dh),
                                dtype=torch.float32, device=dev),
            "kmin": torch.zeros((l_attn, batch, nb, hk, dh),
                                dtype=torch.float32, device=dev),
        }
    cache["length"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if l_cross:
        te = (cfg.num_image_tokens if cfg.arch_type == "vlm"
              else cfg.num_audio_frames)
        for n in ("cross_k", "cross_v"):
            cache[n] = torch.zeros((l_cross, batch, te, hk, dh), dtype=dtype,
                                   device=dev)
    return cache


# ---------------------------------------------------------------------------
# stub frontends: pre-computed modality embeddings, as in the reference
# ---------------------------------------------------------------------------

def extra_inputs_for(cfg: ModelConfig, batch: int, seed=None,
                     device=None) -> dict:
    """Pre-computed modality embeddings standing in for the ViT / conv
    frontend: ``image_embeds`` [B, num_image_tokens, vision_dim] (VLM),
    ``frame_embeds`` [B, num_audio_frames, d_model] (encoder-decoder),
    in the activations' dtype.  Zeros without a seed, as the reference's
    without a key; standard normal draws (fp32, then cast) from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` otherwise.
    Empty for the other architectures."""
    dev = resolve_device(device)
    dtype = cm.dt(cfg.dtype)
    gen = None
    if seed is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

    def draw(shape):
        if gen is None:
            return torch.zeros(shape, dtype=dtype, device=dev)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    out = {}
    if cfg.arch_type == "vlm":
        out["image_embeds"] = draw((batch, cfg.num_image_tokens,
                                    cfg.vision_dim))
    if cfg.has_encoder:
        out["frame_embeds"] = draw((batch, cfg.num_audio_frames,
                                    cfg.d_model))
    return out


def _encoder_out(cfg: ModelConfig, params, extra):
    """The encoder states [B, Te, d] the cross layers attend: the
    projected image embeddings (VLM) or the Whisper encoder's output."""
    if cfg.arch_type == "vlm":
        return dn.project_image(cfg, params, extra["image_embeds"])
    if cfg.has_encoder:
        return dn.encode_frames(cfg, params, extra["frame_embeds"])
    return None


def require_extra(cfg: ModelConfig, extra, what: str) -> None:
    """Raise ValueError naming ``what`` when a VLM or audio target (cross
    layers) gets no ``extra``: the reference fails inside
    ``compute_cross_kv`` on a missing encoder output instead."""
    if not extra and dn.is_cross_arch(cfg):
        raise ValueError(f"{cfg.name} ({cfg.arch_type}): {what} needs the "
                         f"per-request conditioning `extra` "
                         f"(api.extra_inputs_for gives stub inputs)")


def write_cross(cfg: ModelConfig, params, cross_k, cross_v, extra,
                tp=None) -> None:
    """Encode ``extra`` and copy every cross layer's K/V into ``cross_k``
    / ``cross_v`` [L_cross, B, Te, Hk, Dh] in place (a cache's rows, or a
    view of one slot's): done once per request, after which prefill and
    decoding read the rows.  ``tp``: the encoder runs whole, once; each
    model shard projects its KV heads into its stacked rows
    (``dense.write_cross_kv``)."""
    require_extra(cfg, extra, "its prefill")
    with torch.no_grad():
        enc = _encoder_out(cfg, params, extra)
        dn.write_cross_kv(cfg, params["layers"], cross_k, cross_v, enc, tp)


def prefill(cfg: ModelConfig, params, tokens, cache, *, extra=None,
            spec: Optional[SpecPVConfig] = None, plain: bool = False,
            t_valid=None, return_logits: str = "last",
            cached_cross: bool = False, tp=None):
    """Process a chunk of prompt tokens [B, T] (written into `cache` in
    place).  Returns (logits, features, the cache with its advanced
    length): the last token's [B, V] by default, every position's
    [B, T, V] with ``return_logits="all"``.  ``plain`` (contiguous cache
    only) runs the plain attention and summaries: the autoregressive
    oracle's route (``core.reference``), never the engine's.

    A VLM or audio target needs ``extra`` (``extra_inputs_for``'s keys):
    its cross K/V are written into the cache's ``cross_k`` / ``cross_v``
    before the chunk runs.  ``cached_cross=True`` reads the rows already
    there instead (the engine writes them once per request); without
    either the call raises ValueError.  Other archs ignore ``extra``, as
    the reference does.

    ``t_valid`` ([B] int32, attention archs only) marks the chunk
    ragged: row b carries ``t_valid[b] >= 1`` real tokens, then
    ``T - t_valid[b]`` trailing pads, which write no K/V, summary or
    ``length``; the last-token logits are row b's at ``t_valid[b] - 1``
    (the fused multi-row prefill packs cursors of unequal chunks so).

    ``tp`` (a ``distributed.tensor_parallel.TensorParallel`` of
    ``params``): run the embedding, the trunk and the head split over its
    model shards (the cache then shard-stacked, see ``init_cache``'s
    ``kv_shards``); None runs ``params`` whole."""
    b, t = tokens.shape
    if cfg.arch_type in ("ssm", "hybrid") and t_valid is not None:
        raise ValueError("ragged prefill is attention-arch only")
    if return_logits not in ("last", "all"):
        raise ValueError(f"return_logits is 'last' or 'all', not "
                         f"{return_logits!r}")
    positions = None
    if cfg.arch_type != "ssm":
        positions = cache["length"][:, None] + torch.arange(
            t, device=tokens.device, dtype=torch.int32)[None]
    if cfg.arch_type == "ssm":
        h, feats, cache = rw.forward(cfg, params, tokens, cache, tp=tp)
        lm = functools.partial(rw.lm_head, tp=tp)
    elif cfg.arch_type == "hybrid":
        h, feats, cache = gf.forward(cfg, params, tokens, positions, cache,
                                     mode="advance", tp=tp)
        lm = functools.partial(gf.lm_head, tp=tp)
    else:
        if "cross_k" in cache and not cached_cross:
            write_cross(cfg, params, cache["cross_k"], cache["cross_v"],
                        extra, tp)
        hh = dn.embed_tokens(cfg, params, tokens, tp)
        out = dn.trunk_fwd(cfg, params["layers"], hh, positions,
                           mode="prefill", cache=cache,
                           spec=spec or SpecPVConfig(), plain=plain,
                           t_valid=t_valid, tp=tp)
        h, feats, cache = out.h, out.features, out.cache
        lm = functools.partial(dn.lm_head, tp=tp)
    if return_logits == "all":
        logits = lm(cfg, params, h)
    elif t_valid is None:
        logits = lm(cfg, params, h[:, -1:])[:, 0]
    else:
        last = torch.clamp(t_valid.long() - 1, min=0)
        logits = lm(cfg, params,
                    h[torch.arange(b, device=tokens.device), last][:, None]
                    )[:, 0]
    return logits, Features(*feats), cache


def decode(cfg: ModelConfig, params, tokens, positions, cache, *,
           mode: str = "full", self_mask=None, pkv=None,
           spec: Optional[SpecPVConfig] = None, emit_queries: bool = False,
           partial_rows=None, pkv_blocks=None,
           plain: bool = False, select_partial: bool = False,
           q_weight=None, tp=None) -> DecodeOut:
    """Forward T new (tree) tokens; ``mode`` is "full" | "partial" |
    "fused" (``partial_rows`` [B] marks the rows that read the partial
    context: the selected blocks ``pkv_blocks`` [L, B, Hk, NS], read in
    place through the page table (zero-copy, ``pkv`` = the tail buffer)
    or from the gathered body (``pkv`` = the tail buffer and the body
    [L, B, NS*block, Hk, Dh])), or, without ``pkv_blocks``, the
    reference's materialised per-head partial cache ``pkv`` = (pk, pv,
    ppos) [L, B, Hk, P, ...], int8 with its scales (pks, pvs) [L, B, Hk,
    P].  A contiguous cache may be int8 with its scales ``k_scale`` /
    ``v_scale`` [L, B, S, Hk].  ``select_partial``: also return, as
    ``partial``, the partial cache (pk, pv, ppos) [L, B, Hk, budget, ...]
    selected by this step's queries weighted by ``q_weight`` [B, T]
    (default all 1): the reference's in-trunk Refresh.  ``plain``: see
    ``prefill``; ``tp``: see ``prefill``.  The state
    archs always do read-only chain verification (Griffin's attention
    over its window and the chain, by ``self_mask``): the state is left
    as it was and ``new_kv`` is None."""
    b, t = tokens.shape
    if cfg.arch_type == "ssm":
        h, feats, _ = rw.forward(cfg, params, tokens, cache, update=False,
                                 tp=tp)
        return DecodeOut(rw.lm_head(cfg, params, h, tp), Features(*feats),
                         None)
    if self_mask is None:
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                       device=tokens.device))
        self_mask = causal[None].expand(b, t, t)
    if cfg.arch_type == "hybrid":
        h, feats, _ = gf.forward(cfg, params, tokens, positions, cache,
                                 mode="verify", self_mask=self_mask, tp=tp)
        return DecodeOut(gf.lm_head(cfg, params, h, tp), Features(*feats),
                         None)
    h = dn.embed_tokens(cfg, params, tokens, tp)
    trunk_mode = {"full": "decode_full", "partial": "decode_partial",
                  "fused": "decode_fused"}[mode]
    out = dn.trunk_fwd(cfg, params["layers"], h, positions, mode=trunk_mode,
                       self_mask=self_mask, cache=cache, pkv=pkv,
                       spec=spec or SpecPVConfig(), emit_queries=emit_queries,
                       partial_rows=partial_rows, pkv_blocks=pkv_blocks,
                       plain=plain, select_partial=select_partial,
                       q_weight=q_weight, tp=tp)
    logits = dn.lm_head(cfg, params, out.h, tp)
    return DecodeOut(logits, Features(*out.features), out.new_kv,
                     out.queries, out.partial)


def advance(cfg: ModelConfig, params, tokens, cache, valid, tp=None):
    """State archs: commit accepted tokens [B, T] (``valid`` [B, T] is a
    prefix mask; padding leaves the state as it was) into the recurrent
    state, in place.  Returns the cache with the advanced length.
    Griffin's tokens sit at ``length + cumsum(valid) - 1`` (clamped at
    0), as in the reference.  ``tp``: see ``prefill``."""
    if cfg.arch_type == "ssm":
        _, _, cache = rw.forward(cfg, params, tokens, cache, valid=valid,
                                 collect_features=False, tp=tp)
        return cache
    if cfg.arch_type != "hybrid":
        raise ValueError("attention archs commit KV explicitly "
                         "(repro_torch.core.verify)")
    positions = torch.clamp(cache["length"][:, None] + torch.cumsum(
        valid.to(torch.int32), dim=1, dtype=torch.int32) - 1, min=0)
    _, _, cache = gf.forward(cfg, params, tokens, positions, cache,
                             mode="advance", valid=valid,
                             collect_features=False, tp=tp)
    return cache


# ---------------------------------------------------------------------------
# training loss (plain torch under autograd: the kernels have no backward)
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, valid=None):
    """logits: [B, T, V] fp32; labels: [B, T].  Mean next-token NLL, over
    the ``valid`` [B, T] positions when given."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if valid is None:
        return torch.mean(nll)
    w = valid.float()
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def chunked_lm_loss(cfg: ModelConfig, params, h, labels, *,
                    chunk: int = 512):
    """Final norm + LM head + cross-entropy over sequence chunks of
    ``chunk`` positions, so the [B, T, V] logits are never held (one
    chunk's are 512 x V fp32 per row: 263 MB at llama3.1-8b's 128256);
    each chunk body is rematerialised in the backward pass when autograd
    records, as the reference's ``jax.checkpoint``'d scan body.  The last
    chunk is shorter where the reference pads it with weight-0 positions,
    so the sums are the same."""
    b, t, _ = h.shape
    scale = params["final_norm"]
    w = params["embed"].T if cfg.tie_embeddings else params["head"]

    def body(hc, lc):
        x = cm.rmsnorm(hc, scale, cfg.norm_eps)
        logits = (x @ w.to(x.dtype)).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
        return torch.sum(logz - gold)

    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, t, chunk):
        args = (h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        nll = nll + (torch.utils.checkpoint.checkpoint(
            body, *args, use_reentrant=False)
            if torch.is_grad_enabled() else body(*args))
    return nll / max(b * t, 1)


def train_loss(cfg: ModelConfig, params, tokens, *, extra=None,
               moe_routes=None):
    """Next-token LM loss over a [B, S] token batch.  Dense, MoE, VLM and
    audio targets: the trunk's train mode (a VLM or audio target's cross
    layers over the encoder states of ``extra``, which it needs; other
    targets ignore it, as the reference's do), then ``chunked_lm_loss``;
    returns (``lm + moe_aux_loss_coef * aux``, {"lm_loss", "aux_loss"}),
    the aux loss summed over the MoE layers (0 for a dense target).  RWKV-6: a
    read-only forward from the zero state (under autograd its WKV
    recurrence is the plain chunked step loop, ``rwkv6.wkv_train``), then
    ``chunked_lm_loss``; returns (loss, {"lm_loss"}).  Griffin: the
    trunk's train mode (windowed attention, the RG-LRU as the chunked
    plain scan), then ``chunked_lm_loss``; returns (loss, {"lm_loss"}).
    ``moe_routes`` (``dense.trunk_fwd``): the tokens are one data shard
    of a larger batch, and the call returns (lm, {"lm_loss",
    "moe_stats"}): the aux loss is the whole batch's
    (``sharded_train_loss``)."""
    b, s = tokens.shape
    inp, lbl = tokens[:, :-1], tokens[:, 1:]
    if cfg.arch_type == "ssm":
        state = rw.init_state(cfg, b, cm.dt(cfg.dtype), tokens.device)
        h, _, _ = rw.forward(cfg, params, inp, state, update=False,
                             collect_features=False)
        loss = chunked_lm_loss(cfg, params, h, lbl)
        return loss, {"lm_loss": loss}
    positions = torch.arange(s - 1, device=tokens.device)[None].expand(
        b, s - 1)
    if cfg.arch_type == "hybrid":
        h, _, _ = gf.forward(cfg, params, inp, positions, None, mode="train",
                             collect_features=False)
        loss = chunked_lm_loss(cfg, params, h, lbl)
        return loss, {"lm_loss": loss}
    dn._check_dense(cfg)
    enc = None
    if dn.is_cross_arch(cfg):
        require_extra(cfg, extra, "its train_loss")
        enc = _encoder_out(cfg, params, extra)
    h = dn.embed_tokens(cfg, params, inp)
    out = dn.trunk_fwd(cfg, params["layers"], h, positions, mode="train",
                       collect_features=False, encoder_out=enc,
                       moe_routes=moe_routes)
    lm = chunked_lm_loss(cfg, params, out.h, lbl)
    if moe_routes is not None:
        return lm, {"lm_loss": lm, "moe_stats": out.moe_stats}
    loss = lm + cfg.moe_aux_loss_coef * out.aux_loss
    return loss, {"lm_loss": lm, "aux_loss": out.aux_loss}


def sharded_train_loss(cfg: ModelConfig, shards):
    """``train_loss`` of a batch held as data shards: ``shards`` is a
    list of (params, tokens [rows, S+1], extra) in the batch's row order,
    each on its shard's device.  Each shard's LM loss is weighted by its
    share of the rows.  An MoE target routes every layer over the whole
    batch: the shards run in order, shard d + 1 starting each group's
    per-expert count from the assignments of the shards before it (a
    fresh tensor each, so a layer's recompute reads what its forward
    read), and the aux loss is formed once from every shard's per-group
    sums (``blocks.moe_aux``), so its gradient reaches each shard's
    router through the whole batch's top-1 counts.  Every shard's graph
    is held until the caller's backward pass.  Returns (loss, {"lm_loss",
    "aux_loss"}) on the first shard's device, ``train_loss``'s numbers
    for the whole batch."""
    b = sum(tok.shape[0] for _, tok, _ in shards)
    t = shards[0][1].shape[1] - 1
    n = b * t
    dev0 = shards[0][1].device
    moe = [i for i, lp in enumerate(shards[0][0].get("layers", ()))
           if "moe" in lp]
    g, ng = bk.moe_groups(n)
    # per MoE layer: each group's assignments so far, per expert
    seen = {i: torch.zeros((ng, cfg.num_experts), dtype=torch.int32,
                           device=dev0) for i in moe}
    lm = torch.zeros((), dtype=torch.float32, device=dev0)
    stats = {i: [] for i in moe}
    offset = 0
    for params, tokens, extra in shards:
        rows, dev = tokens.shape[0], tokens.device
        g0, g1 = offset // g, (offset + rows * t - 1) // g + 1
        routes = None
        if moe:
            routes = [None] * len(params["layers"])
            for i in moe:
                routes[i] = bk.MoeRoute(n, offset,
                                        seen[i][g0:g1].to(dev, copy=True))
        lm_d, m = train_loss(cfg, params, tokens, extra=extra,
                             moe_routes=routes)
        lm = lm + lm_d.to(dev0) * (rows / b)
        for i, st in zip(moe, m.get("moe_stats", ())):
            stats[i].append(st)
            # out of place: earlier routes keep the counts they were given
            seen[i] = torch.cat([seen[i][:g0], seen[i][g0:g1]
                                 + st.assignments().to(dev0), seen[i][g1:]])
        offset += rows * t
    aux = bk.moe_aux(cfg, n, [stats[i] for i in moe], dev0)
    return lm + cfg.moe_aux_loss_coef * aux, {"lm_loss": lm, "aux_loss": aux}
