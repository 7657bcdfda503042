"""RWKV-6 (Finch): attention-free, data-dependent decay
[arXiv:2404.05892] (counterpart of ``repro/models/rwkv6.py``).

Per layer: time mixing (ddlerp token shift, the per-channel decaying WKV
recurrence, per-head groupnorm, silu gate) and channel mixing (squared
relu MLP with token shift).  The WKV recurrence goes through the WKV
kernel (K5, ``kernels.ops.wkv``); the reference runs it as a
``lax.scan``, which computes the same function.  K5 has no backward, and
the reference trains through its plain scan, not its Pallas kernel: so
under autograd (``train_loss``) the recurrence is the plain step loop in
chunks of 256 steps, each recomputed in the backward pass
(``wkv_train``, the reference's ``ckpt_chunked_scan``).

SpecPV on a state architecture: there is no KV cache, so partial
verification does not apply.  A drafted chain is verified by a
read-only pass (``update=False``) and the accepted prefix is then
committed by a second pass with a prefix ``valid`` mask.

State: ``wkv`` [L, B, H, dk, dk] fp32, token shifts ``ts_tm`` / ``ts_cm``
[L, B, d] and ``length`` [B].  The layers are a list of per-layer param
dicts run by a plain loop.  Unlike the reference's functional update,
``forward(update=True)`` writes the state tensors in place (the engine
consumes the state it steps) and returns the dict with the advanced
length.

Under tensor parallelism (``forward(tp=...)``) each model shard runs the
time mixing's heads it holds (K5 at H / m heads over its stacked slice
of ``wkv``) and the channel mixing's columns, with one sum after each
row-split output; the token shifts, the lerps and the gates' whole-width
parts run once.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models.dense import _feature_targets, embed_tokens
from repro_torch.models.dense import lm_head as dense_lm_head

LORA_RANK = 16
DDLERP_TARGETS = 5  # w, k, v, r, g


def _layer_init(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    pd = cm.dt(cfg.param_dtype)
    dev = gen.device
    d = cfg.d_model
    dk = cfg.ssm_head_dim
    h = d // dk
    decay0 = np.linspace(-6.0, -1.0, dk, dtype=np.float32)
    w0 = torch.as_tensor(np.tile(decay0[None, :], (h, 1)), device=dev)

    def zeros(shape, dtype=pd):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(shape, dtype=pd):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "ln1": ones((d,)),
        "mu_first": zeros((d,)),
        "mu_base": zeros((DDLERP_TARGETS, d)),
        "lora_A": cm.dense_init(gen, (DDLERP_TARGETS, d, LORA_RANK), pd),
        "lora_B": zeros((DDLERP_TARGETS, LORA_RANK, d)),
        "w0": w0,
        "u": zeros((h, dk), torch.float32),
        "wd_A": cm.dense_init(gen, (d, 4 * LORA_RANK), pd),
        "wd_B": zeros((4 * LORA_RANK, d)),
        "wr": cm.dense_init(gen, (d, d), pd),
        "wk": cm.dense_init(gen, (d, d), pd),
        "wv": cm.dense_init(gen, (d, d), pd),
        "wg": cm.dense_init(gen, (d, d), pd),
        "wo": cm.dense_init(gen, (d, d), pd),
        "gn_scale": ones((h, dk), torch.float32),
        "gn_bias": zeros((h, dk), torch.float32),
        "ln2": ones((d,)),
        "cm_mu_k": zeros((d,)),
        "cm_mu_r": zeros((d,)),
        "cm_wk": cm.dense_init(gen, (d, cfg.d_ff), pd),
        "cm_wv": cm.dense_init(gen, (cfg.d_ff, d), pd),
        "cm_wr": cm.dense_init(gen, (d, d), pd),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from ``seed`` (a ``torch.Generator`` on the target
    device), with the reference's zero-initialised ``lora_B``, ``wd_B``
    and ``u``.  Layout: ``embed`` [V, d], ``final_norm`` [d], ``head``
    [d, V] and ``layers``, a list of per-layer dicts."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pd = cm.dt(cfg.param_dtype)
    params: Dict[str, Any] = {
        "layers": [_layer_init(cfg, gen) for _ in range(cfg.num_layers)],
        "embed": cm.embed_init(gen, (cfg.vocab_size, cfg.d_model), pd),
        "final_norm": torch.ones((cfg.d_model,), dtype=pd, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = cm.dense_init(gen, (cfg.d_model, cfg.vocab_size), pd)
    return params


def init_state(cfg: ModelConfig, batch: int, dtype, device,
               shards: int = 1) -> Dict:
    """The recurrent state; ``shards`` = m (tensor parallelism whose time
    mixing splits the heads) stacks the model shards' ``wkv`` on the
    layer axis, [m * L, B, H / m, dk, dk] (the token shifts are residual
    width and stay whole)."""
    d = cfg.d_model
    dk = cfg.ssm_head_dim
    h = d // dk
    L = cfg.num_layers
    return {
        "wkv": torch.zeros((shards * L, batch, h // shards, dk, dk),
                           dtype=torch.float32, device=device),
        "ts_tm": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "ts_cm": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _ddlerp(lp, x, xx):
    """Data-dependent lerp.  x/xx: [B, T, d].  Returns the 5 mixed
    inputs [B, T, d] (w, k, v, r, g order)."""
    xd = x.dtype
    base = x + xx * lp["mu_first"].to(xd)
    z = torch.tanh(torch.einsum("btd,sdr->btsr", base, lp["lora_A"].to(xd)))
    mix = lp["mu_base"].to(xd)[None, None] + torch.einsum(
        "btsr,srd->btsd", z, lp["lora_B"].to(xd))
    out = x[:, :, None, :] + xx[:, :, None, :] * mix        # [B, T, 5, d]
    return [out[:, :, i] for i in range(DDLERP_TARGETS)]


def _shift_state(x, ts, last_idx):
    """The token-shift state after the chunk: x at the last valid token,
    or the old state for a row with none."""
    b = x.shape[0]
    at_last = x[torch.arange(b, device=x.device), torch.clamp(last_idx, min=0)]
    return torch.where(last_idx[:, None] >= 0, at_last, ts)


WKV_TRAIN_CHUNK = 256   # steps per recomputed segment (ckpt_chunked_scan)


def wkv_train(r, k, v, w, u, s0, chunk: int = WKV_TRAIN_CHUNK):
    """The WKV recurrence under autograd, every step valid: the plain
    step loop (``models.common.ckpt_chunked_scan``: segments of
    ``chunk`` steps, each recomputed in the backward pass, so
    O(T/chunk + chunk) states stay live), with the state in fp32 and no
    in-place writes.  The counterpart of the reference's training scan
    (``ckpt_chunked_scan`` in ``_time_mix``), not of K5.  r/k/v/w
    [B, T, H, dk] fp32, u [H, dk], s0 [B, H, dk, dk].  Returns
    (y [B, T, H, dk], s [B, H, dk, dk])."""
    uu = u[None, :, :, None]

    def step(s, x):
        r_t, k_t, v_t, w_t = x
        kv = k_t[..., None] * v_t[..., None, :]
        y = torch.einsum("bhi,bhij->bhj", r_t, s + uu * kv)
        return w_t[..., None] * s + kv, y

    s, ys = cm.ckpt_chunked_scan(
        step, s0.float(), tuple(x.transpose(0, 1) for x in (r, k, v, w)),
        chunk=chunk)
    return ys.transpose(0, 1), s


def _tmix_heads(p, xr, xk, xv, xg, dz, wkv, n_valid, update: bool,
                dk: int):
    """The head-local part of the time mixing over the heads of ``p`` (a
    layer's weights, or one model shard's pieces of them): the r / k / v
    / g projections by its columns, the decay from the rank-64 input
    ``dz`` = tanh(xw wd_A), the WKV recurrence (K5) over its state
    ``wkv`` [B, H_p, dk, dk], the per-head group norm, the gate and the
    output rows ``wo``.  Returns (its part of the output [B, T, d], the
    new state)."""
    b, t, _ = xr.shape
    xd = xr.dtype
    h = p["wr"].shape[-1] // dk
    r = (xr @ p["wr"].to(xd)).reshape(b, t, h, dk)
    k = (xk @ p["wk"].to(xd)).reshape(b, t, h, dk)
    v = (xv @ p["wv"].to(xd)).reshape(b, t, h, dk)
    g = F.silu(xg @ p["wg"].to(xd))
    # data-dependent decay (Finch): w = exp(-exp(w0 + tanh(xw A_d) B_d))
    dec = dz @ p["wd_B"].to(xd)
    wlog = p["w0"][None, None] + dec.reshape(b, t, h, dk).float()
    w = torch.exp(-torch.exp(wlog))
    if torch.is_grad_enabled() and w.requires_grad:
        # training: every step is valid and the state is read-only
        y, wkv_new = wkv_train(r.float(), k.float(), v.float(), w,
                               p["u"].float(), wkv)
    else:
        y, wkv_new = ops.wkv(r.float().contiguous(), k.float().contiguous(),
                             v.float().contiguous(), w.contiguous(),
                             p["u"].float().contiguous(), wkv, n_valid,
                             update=update)
    y = cm.groupnorm_heads(y, p["gn_scale"], p["gn_bias"])
    return (y.reshape(b, t, h * dk).to(xd) * g) @ p["wo"].to(xd), wkv_new


def _time_mix(cfg: ModelConfig, lp, x, ts, wkvs, n_valid, last_idx,
              update: bool, units=None, tp=None):
    """x: [B, T, d]; ts: [B, d] previous-token state; n_valid: [B] valid
    prefix (padding never touches the state).  ``units``: the head
    groups, each a parameter dict (default ``[lp]``, the whole layer;
    under tensor parallelism each model shard's pieces, whose outputs
    ``tp`` sums), with ``wkvs`` their states [B, H_u, dk, dk] fp32.  The
    token shift, the data-dependent lerps and the decay's LoRA input run
    once, whole.  Returns (y, new_ts, [each unit's new state])."""
    units = [lp] if units is None else units
    prev = torch.cat([ts[:, None], x[:, :-1]], dim=1)
    xx = prev - x
    xw, xk, xv, xr, xg = _ddlerp(lp, x, xx)
    dz = torch.tanh(xw @ lp["wd_A"].to(x.dtype))
    outs = [_tmix_heads(p, xr, xk, xv, xg, dz, wkv, n_valid, update,
                        cfg.ssm_head_dim) for p, wkv in zip(units, wkvs)]
    y = (outs[0][0] if len(outs) == 1
         else tp.map_reduce(lambda sh: outs[sh.index][0]))
    return y, _shift_state(x, ts, last_idx), [o[1] for o in outs]


def _channel_mix(cfg: ModelConfig, lp, x, ts, last_idx, pieces=None,
                 tp=None):
    """The squared-relu channel mixing with its token shift.  ``pieces``
    (tensor parallelism: each model shard's ``cm_wk`` columns and
    ``cm_wv`` rows) sums the shards' ``relu(x cm_wk)^2 cm_wv`` before the
    receptance gate ``sigmoid(x cm_wr)``, which runs whole."""
    prev = torch.cat([ts[:, None], x[:, :-1]], dim=1)
    xx = prev - x
    xd = x.dtype
    xk = x + xx * lp["cm_mu_k"].to(xd)
    xr = x + xx * lp["cm_mu_r"].to(xd)

    def kv(p):
        return (torch.square(F.relu(xk @ p["cm_wk"].to(xd)))
                @ p["cm_wv"].to(xd))
    vals = kv(lp) if pieces is None else tp.map_reduce(
        lambda sh: kv(pieces[sh.index]))
    out = torch.sigmoid(xr @ lp["cm_wr"].to(xd)) * vals
    return out, _shift_state(x, ts, last_idx)


def forward(cfg: ModelConfig, params, tokens, state, *, valid=None,
            update: bool = True, collect_features: bool = True, tp=None):
    """Process T tokens (prefill chunk / chain verify / post-acceptance
    advance).  ``valid`` [B, T] marks a PREFIX of real tokens; padding
    never touches the state.  ``update=False`` is read-only (chain
    verify).  ``tp`` (``distributed.tensor_parallel.TensorParallel``,
    every model shard on one device): the embedding, the time mixing's
    heads, the channel mixing's columns and the head split over its model
    shards, with the ``wkv`` state shard-stacked on the layer axis
    ([m * L, B, H / m, dk, dk], shard s's layer l at ``s * L + l``;
    ``init_state``'s ``shards``).  Returns (h [B, T, d], features (low,
    mid, top) or None, state)."""
    b, t = tokens.shape
    dev = tokens.device
    if tp is not None:
        tp.require_single_device()
    if valid is None:
        valid = torch.ones((b, t), dtype=torch.bool, device=dev)
    n_valid = valid.to(torch.int32).sum(dim=1, dtype=torch.int32)
    last_idx = n_valid.long() - 1                        # [B], -1 if none
    h = embed_tokens(cfg, params, tokens, tp)
    layers: List[Dict] = params["layers"]
    n_l = len(layers)
    targets = _feature_targets(n_l)
    feats = [None, None, None]
    for i, lp in enumerate(layers):
        x1 = cm.rmsnorm(h, lp["ln1"], cfg.norm_eps)
        units, wkvs = None, [state["wkv"][i]]
        if tp is not None and tp.tmix_split:
            units = [sh.params["layers"][i] for sh in tp.shards]
            wkvs = [state["wkv"][sh.index * n_l + i] for sh in tp.shards]
        y, nts_tm, nwkvs = _time_mix(cfg, lp, x1, state["ts_tm"][i], wkvs,
                                     n_valid, last_idx, update, units, tp)
        h = h + y
        x2 = cm.rmsnorm(h, lp["ln2"], cfg.norm_eps)
        pieces = ([sh.params["layers"][i] for sh in tp.shards]
                  if tp is not None and tp.cmix_split else None)
        y2, nts_cm = _channel_mix(cfg, lp, x2, state["ts_cm"][i], last_idx,
                                  pieces, tp)
        h = h + y2
        if update:
            for wkv, nwkv in zip(wkvs, nwkvs):
                wkv.copy_(nwkv)
            state["ts_tm"][i].copy_(nts_tm)
            state["ts_cm"][i].copy_(nts_cm)
        if collect_features:
            for slot, tgt in enumerate(targets):
                if i == tgt:
                    feats[slot] = h
    out_feats = tuple(feats) if collect_features else None
    if not update:
        return h, out_feats, state
    new_state = dict(state)
    new_state["length"] = state["length"] + n_valid
    return h, out_feats, new_state


def lm_head(cfg: ModelConfig, params, h, tp=None):
    """Final norm and head (``models.dense.lm_head``: under ``tp`` the
    head splits as a dense target's)."""
    return dense_lm_head(cfg, params, h, tp)
