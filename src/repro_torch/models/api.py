"""Model API of the port (counterpart of ``repro/models/api.py``, dense
and MoE attention and RWKV-6 state architectures):

  init_params(cfg, seed, device)               -> params dict
  init_cache(cfg, batch, max_len, spec, ...)   -> cache dict
  prefill(cfg, params, tokens, cache, ...)     -> (logits_last, features, cache)
  decode(cfg, params, tokens, positions, cache, ...) -> DecodeOut
  advance(cfg, params, tokens, cache, valid)   -> cache   (ssm)
  train_loss(cfg, params, tokens)              -> (loss, metrics)

Attention archs expose the SpecPV verification modes through
``decode(mode=...)``; the state arch does read-only chain verification
in ``decode`` and commits the accepted prefix with ``advance``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, SpecPVConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import dense as dn
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


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    if cfg.arch_type == "ssm":
        return rw.init_params(cfg, seed, device)
    return dn.init_params(cfg, seed, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               spec: Optional[SpecPVConfig] = None, *, paged: bool = False,
               num_pages: Optional[int] = None, device=None) -> dict:
    """Cache dict.  ``paged=True`` backs it with a shared block pool
    [L, NumPages, block, ...] plus per-slot page tables (page 0 is the
    null page, so ``num_pages`` defaults to ``batch * S_max/block + 1``);
    otherwise per-row K/V [L, B, max_len, ...], views over block-rounded
    rows (``kvcache.cache.init_contiguous_kv``).  The state arch keeps
    its O(1) recurrent state instead (no paging)."""
    dev = resolve_device(device)
    dtype = cm.dt(cfg.dtype)
    if cfg.arch_type == "ssm":
        if paged:
            raise ValueError("paged KV is attention-only (state archs keep "
                             "O(1) state)")
        return rw.init_state(cfg, batch, dtype, dev)
    dn._check_dense(cfg)
    l_attn = cfg.num_layers
    hk, dh = cfg.num_kv_heads, cfg.head_dim_
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
    return cache


def prefill(cfg: ModelConfig, params, tokens, cache, *,
            spec: Optional[SpecPVConfig] = None, plain: bool = False,
            t_valid=None):
    """Process a chunk of prompt tokens [B, T] (written into `cache` in
    place).  Returns (logits [B, V] of the last token, features, the
    cache with its advanced length).  ``plain`` (contiguous cache only)
    runs the plain attention and summaries: the autoregressive oracle's
    route (``core.reference``), never the engine's.

    ``t_valid`` ([B] int32, attention archs only) marks the chunk
    ragged: row b carries ``t_valid[b] >= 1`` real tokens, then
    ``T - t_valid[b]`` trailing pads, which write no K/V, summary or
    ``length``; the logits are row b's at ``t_valid[b] - 1`` (the fused
    multi-row prefill packs cursors of unequal chunks so)."""
    b, t = tokens.shape
    if cfg.arch_type == "ssm":
        if t_valid is not None:
            raise ValueError("ragged prefill is attention-arch only")
        h, feats, cache = rw.forward(cfg, params, tokens, cache)
        logits = rw.lm_head(cfg, params, h[:, -1:])[:, 0]
        return logits, Features(*feats), cache
    positions = cache["length"][:, None] + torch.arange(
        t, device=tokens.device, dtype=torch.int32)[None]
    hh = dn.embed_tokens(cfg, params, tokens)
    out = dn.trunk_fwd(cfg, params["layers"], hh, positions, mode="prefill",
                       cache=cache, spec=spec or SpecPVConfig(), plain=plain,
                       t_valid=t_valid)
    if t_valid is None:
        h_last = out.h[:, -1:]
    else:
        last = torch.clamp(t_valid.long() - 1, min=0)
        h_last = out.h[torch.arange(b, device=tokens.device), last][:, None]
    logits = dn.lm_head(cfg, params, h_last)[:, 0]
    return logits, Features(*out.features), out.cache


def decode(cfg: ModelConfig, params, tokens, positions, cache, *,
           mode: str = "full", self_mask=None, pkv=None,
           spec: Optional[SpecPVConfig] = None, emit_queries: bool = False,
           partial_rows=None, pkv_blocks=None,
           plain: bool = False) -> DecodeOut:
    """Forward T new (tree) tokens; ``mode`` is "full" | "partial" |
    "fused" (``partial_rows`` [B] marks the rows that read the partial
    context: the selected blocks ``pkv_blocks`` [L, B, Hk, NS], read in
    place through the page table (zero-copy, ``pkv`` = the tail buffer)
    or from the gathered body (``pkv`` = the tail buffer and the body
    [L, B, NS*block, Hk, Dh])).  ``plain``: see ``prefill``.  The state
    arch always does read-only chain verification: the state is left as
    it was and ``new_kv`` is None."""
    b, t = tokens.shape
    if cfg.arch_type == "ssm":
        h, feats, _ = rw.forward(cfg, params, tokens, cache, update=False)
        return DecodeOut(rw.lm_head(cfg, params, h), Features(*feats), None)
    if self_mask is None:
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                       device=tokens.device))
        self_mask = causal[None].expand(b, t, t)
    h = dn.embed_tokens(cfg, params, tokens)
    trunk_mode = {"full": "decode_full", "partial": "decode_partial",
                  "fused": "decode_fused"}[mode]
    out = dn.trunk_fwd(cfg, params["layers"], h, positions, mode=trunk_mode,
                       self_mask=self_mask, cache=cache, pkv=pkv,
                       spec=spec or SpecPVConfig(), emit_queries=emit_queries,
                       partial_rows=partial_rows, pkv_blocks=pkv_blocks,
                       plain=plain)
    logits = dn.lm_head(cfg, params, out.h)
    return DecodeOut(logits, Features(*out.features), out.new_kv,
                     out.queries)


def advance(cfg: ModelConfig, params, tokens, cache, valid):
    """State archs: commit accepted tokens [B, T] (``valid`` [B, T] is a
    prefix mask; padding leaves the state as it was) into the recurrent
    state, in place.  Returns the cache with the advanced length."""
    if cfg.arch_type != "ssm":
        raise ValueError("attention archs commit KV explicitly "
                         "(repro_torch.core.verify)")
    _, _, cache = rw.forward(cfg, params, tokens, cache, valid=valid,
                             collect_features=False)
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


def train_loss(cfg: ModelConfig, params, tokens, *, extra=None):
    """Next-token LM loss over a [B, S] token batch.  Dense and MoE
    targets: the trunk's train mode, then ``chunked_lm_loss``; returns
    (``lm + moe_aux_loss_coef * aux``, {"lm_loss", "aux_loss"}), the aux
    loss summed over the MoE layers (0 for a dense target).  RWKV-6: a
    read-only forward from the zero state (under autograd its WKV
    recurrence is the plain chunked step loop, ``rwkv6.wkv_train``), then
    ``chunked_lm_loss``; returns (loss, {"lm_loss"})."""
    if extra:
        raise NotImplementedError("VLM and audio inputs come with "
                                  "ROADMAP.md queue 1, 'VLM and audio'")
    b, s = tokens.shape
    inp, lbl = tokens[:, :-1], tokens[:, 1:]
    if cfg.arch_type == "ssm":
        state = rw.init_state(cfg, b, cm.dt(cfg.dtype), tokens.device)
        h, _, _ = rw.forward(cfg, params, inp, state, update=False,
                             collect_features=False)
        loss = chunked_lm_loss(cfg, params, h, lbl)
        return loss, {"lm_loss": loss}
    dn._check_dense(cfg)
    positions = torch.arange(s - 1, device=tokens.device)[None].expand(
        b, s - 1)
    h = dn.embed_tokens(cfg, params, inp)
    out = dn.trunk_fwd(cfg, params["layers"], h, positions, mode="train",
                       collect_features=False)
    lm = chunked_lm_loss(cfg, params, out.h, lbl)
    loss = lm + cfg.moe_aux_loss_coef * out.aux_loss
    return loss, {"lm_loss": lm, "aux_loss": out.aux_loss}
