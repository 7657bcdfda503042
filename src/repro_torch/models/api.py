"""Model API of the port (counterpart of ``repro/models/api.py``, dense
attention and RWKV-6 state architectures):

  init_params(cfg, seed, device)               -> params dict
  init_cache(cfg, batch, max_len, spec, ...)   -> cache dict
  prefill(cfg, params, tokens, cache, ...)     -> (logits_last, features, cache)
  decode(cfg, params, tokens, positions, cache, ...) -> DecodeOut
  advance(cfg, params, tokens, cache, valid)   -> cache   (ssm)

Attention archs expose the SpecPV verification modes through
``decode(mode=...)``; the state arch does read-only chain verification
in ``decode`` and commits the accepted prefix with ``advance``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

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
    null page, so ``num_pages`` defaults to ``batch * S_max/block + 1``).
    The state arch keeps its O(1) recurrent state instead (no paging)."""
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
        cache = {
            "k": torch.zeros((l_attn, batch, max_len, hk, dh), dtype=dtype,
                             device=dev),
            "v": torch.zeros((l_attn, batch, max_len, hk, dh), dtype=dtype,
                             device=dev),
            "kmax": torch.zeros((l_attn, batch, nb, hk, dh),
                                dtype=torch.float32, device=dev),
            "kmin": torch.zeros((l_attn, batch, nb, hk, dh),
                                dtype=torch.float32, device=dev),
        }
    cache["length"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return cache


def prefill(cfg: ModelConfig, params, tokens, cache, *,
            spec: Optional[SpecPVConfig] = None):
    """Process a chunk of prompt tokens [B, T] (written into `cache` in
    place).  Returns (logits [B, V] of the last token, features, the
    cache with its advanced length)."""
    b, t = tokens.shape
    if cfg.arch_type == "ssm":
        h, feats, cache = rw.forward(cfg, params, tokens, cache)
        logits = rw.lm_head(cfg, params, h[:, -1:])[:, 0]
        return logits, Features(*feats), cache
    positions = cache["length"][:, None] + torch.arange(
        t, device=tokens.device, dtype=torch.int32)[None]
    hh = dn.embed_tokens(cfg, params, tokens)
    out = dn.trunk_fwd(cfg, params["layers"], hh, positions, mode="prefill",
                       cache=cache, spec=spec or SpecPVConfig())
    logits = dn.lm_head(cfg, params, out.h[:, -1:])[:, 0]
    return logits, Features(*out.features), out.cache


def decode(cfg: ModelConfig, params, tokens, positions, cache, *,
           mode: str = "full", self_mask=None, pkv=None,
           spec: Optional[SpecPVConfig] = None, emit_queries: bool = False,
           partial_rows=None, pkv_blocks=None) -> DecodeOut:
    """Forward T new (tree) tokens; ``mode`` is "full" | "partial" |
    "fused" (``partial_rows`` [B] marks the rows that read the zero-copy
    partial context, routed by ``pkv_blocks`` [L, B, Hk, NS]).  The
    state arch always does read-only chain verification: the state is
    left as it was and ``new_kv`` is None."""
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
                       partial_rows=partial_rows, pkv_blocks=pkv_blocks)
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
