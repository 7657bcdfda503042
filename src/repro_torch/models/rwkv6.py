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
from repro_torch.models.dense import _feature_targets

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


def init_state(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    d = cfg.d_model
    dk = cfg.ssm_head_dim
    h = d // dk
    L = cfg.num_layers
    return {
        "wkv": torch.zeros((L, batch, h, dk, dk), dtype=torch.float32,
                           device=device),
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


def _time_mix(cfg: ModelConfig, lp, x, ts, wkv, n_valid, last_idx,
              update: bool):
    """x: [B, T, d]; ts: [B, d] previous-token state; wkv: [B, H, dk, dk]
    fp32; n_valid: [B] valid prefix (padding never touches the state).
    Returns (y, new_ts, new_wkv)."""
    b, t, d = x.shape
    dk = cfg.ssm_head_dim
    h = d // dk
    prev = torch.cat([ts[:, None], x[:, :-1]], dim=1)
    xx = prev - x
    xw, xk, xv, xr, xg = _ddlerp(lp, x, xx)
    xd = x.dtype
    r = (xr @ lp["wr"].to(xd)).reshape(b, t, h, dk)
    k = (xk @ lp["wk"].to(xd)).reshape(b, t, h, dk)
    v = (xv @ lp["wv"].to(xd)).reshape(b, t, h, dk)
    g = F.silu(xg @ lp["wg"].to(xd))
    # data-dependent decay (Finch): w = exp(-exp(w0 + tanh(xw A_d) B_d))
    dec = torch.tanh(xw @ lp["wd_A"].to(xd)) @ lp["wd_B"].to(xd)
    wlog = lp["w0"][None, None] + dec.reshape(b, t, h, dk).float()
    w = torch.exp(-torch.exp(wlog))
    if torch.is_grad_enabled() and w.requires_grad:
        # training: every step is valid and the state is read-only
        y, wkv_new = wkv_train(r.float(), k.float(), v.float(), w,
                               lp["u"].float(), wkv)
    else:
        y, wkv_new = ops.wkv(r.float().contiguous(), k.float().contiguous(),
                             v.float().contiguous(), w.contiguous(),
                             lp["u"].float().contiguous(), wkv, n_valid,
                             update=update)
    y = cm.groupnorm_heads(y, lp["gn_scale"], lp["gn_bias"])
    y = (y.reshape(b, t, d).to(xd) * g) @ lp["wo"].to(xd)
    return y, _shift_state(x, ts, last_idx), wkv_new


def _channel_mix(cfg: ModelConfig, lp, x, ts, last_idx):
    prev = torch.cat([ts[:, None], x[:, :-1]], dim=1)
    xx = prev - x
    xd = x.dtype
    xk = x + xx * lp["cm_mu_k"].to(xd)
    xr = x + xx * lp["cm_mu_r"].to(xd)
    kk = torch.square(F.relu(xk @ lp["cm_wk"].to(xd)))
    out = torch.sigmoid(xr @ lp["cm_wr"].to(xd)) * (kk @ lp["cm_wv"].to(xd))
    return out, _shift_state(x, ts, last_idx)


def forward(cfg: ModelConfig, params, tokens, state, *, valid=None,
            update: bool = True, collect_features: bool = True):
    """Process T tokens (prefill chunk / chain verify / post-acceptance
    advance).  ``valid`` [B, T] marks a PREFIX of real tokens; padding
    never touches the state.  ``update=False`` is read-only (chain
    verify).  Returns (h [B, T, d], features (low, mid, top) or None,
    state)."""
    b, t = tokens.shape
    dev = tokens.device
    if valid is None:
        valid = torch.ones((b, t), dtype=torch.bool, device=dev)
    n_valid = valid.to(torch.int32).sum(dim=1, dtype=torch.int32)
    last_idx = n_valid.long() - 1                        # [B], -1 if none
    h = params["embed"][tokens.long()].to(cm.dt(cfg.dtype))
    layers: List[Dict] = params["layers"]
    targets = _feature_targets(len(layers))
    feats = [None, None, None]
    for i, lp in enumerate(layers):
        x1 = cm.rmsnorm(h, lp["ln1"], cfg.norm_eps)
        y, nts_tm, nwkv = _time_mix(cfg, lp, x1, state["ts_tm"][i],
                                    state["wkv"][i], n_valid, last_idx,
                                    update)
        h = h + y
        x2 = cm.rmsnorm(h, lp["ln2"], cfg.norm_eps)
        y2, nts_cm = _channel_mix(cfg, lp, x2, state["ts_cm"][i], last_idx)
        h = h + y2
        if update:
            state["wkv"][i].copy_(nwkv)
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


def lm_head(cfg: ModelConfig, params, h):
    h = cm.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (h @ w.to(h.dtype)).float()
