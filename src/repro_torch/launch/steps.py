"""Production step functions (counterpart of ``repro/launch/steps.py``):
``make_train_step`` (loss, gradients, global-norm clip, AdamW),
``make_prefill_step`` and ``make_decode_step`` (one new token against the
cache; the long-context form reads only the SpecPV partial cache, the
reference's materialised per-head form, while the full cache stays
resident for refreshes).

The reference's launchers donate the state to each step
(``donate_argnums``); here every step writes the cache, the partial cache
and ``buf_len`` it is given in place and returns those same tensors, so
no step copies the cache.  The decode steps' bodies make no host sync
and allocate only from the caching allocator: each can be captured as a
CUDA graph (``core.engine.capture_graph``) over the state it is given.

    train:    (params, opt, tokens [B, S+1], extra) -> (params, opt, loss)
    prefill:  (params, cache, tokens [B, S], extra) -> (next [B], cache)
    decode, full:    (params, cache, token [B]) -> (next, cache)
    decode, partial: (params, cache, pkv_k, pkv_v, pkv_pos, buf_len, token)
                     -> (next, cache, pkv_k, pkv_v, pkv_pos, buf_len)
    decode, state archs: (params, cache, token) -> (next, cache)

Tokens are int32, as the reference's.  The steps run whole weights: they
pass no tensor-parallel split to ``models.api`` (its ``tp``), so a mesh
reaches them only as ``make_train_step(grad_shardings=)``, which raises
NotImplementedError (ROADMAP.md queue 1, 'Multi-GPU, part 4').
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, SpecPVConfig
from repro_torch.core import verify as vf
from repro_torch.core.engine import copy_into
from repro_torch.models import api
from repro_torch.train.optimizer import (adamw_update, clip_by_global_norm,
                                         cosine_schedule, tree_leaves,
                                         tree_map)


def make_train_step(cfg: ModelConfig, grad_shardings=None):
    """(params, opt, tokens [B, S+1], extra) -> (params, opt, loss): the
    loss and its gradients (``api.train_loss`` under autograd), the
    global-norm clip at 1.0, the reference's cosine schedule and AdamW,
    the parameters and moments updated in place.  The parameters'
    ``requires_grad`` is set for the step and restored after it."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "sharded gradients are not ported yet: ROADMAP.md queue 1, "
            "'Multi-GPU, part 4'")
    unstacked = api.unstacked_layers(cfg)

    def step(params, opt, tokens, extra):
        leaves = tree_leaves(params)
        was = [p.requires_grad for p in leaves]
        try:
            for p in leaves:
                p.requires_grad_(True)
            with torch.enable_grad():
                loss, _ = api.train_loss(cfg, params, tokens, extra=extra)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p, w in zip(leaves, was):
                p.requires_grad_(w)
        by_id = {id(p): (g if g is not None else torch.zeros_like(p))
                 for p, g in zip(leaves, grads)}
        grads = tree_map(lambda p, stacked: by_id[id(p)], params)
        grads, _ = clip_by_global_norm(grads, 1.0)
        lr = cosine_schedule(opt.step, base_lr=3e-4, warmup=100, total=10000)
        params, opt = adamw_update(params, grads, opt, lr=lr,
                                   unstacked_layers=unstacked)
        return params, opt, loss.detach()

    return step


def make_prefill_step(cfg: ModelConfig, spec: SpecPVConfig):
    """(params, cache, tokens [B, S], extra) -> (next_token [B], cache):
    one prefill call over the whole chunk, written into ``cache``."""

    def step(params, cache, tokens, extra):
        logits, _, new = api.prefill(cfg, params, tokens, cache,
                                     extra=extra, spec=spec)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        copy_into(cache, new)
        return nxt, cache

    return step


def make_decode_step(cfg: ModelConfig, spec: SpecPVConfig, *,
                     partial: bool = False):
    """One-token decode (see the module docstring for the signatures).
    Full: the token verified against the whole cache, then committed to
    it.  Partial: attention reads only the materialised partial cache
    (``pkv_*`` [L, B, Hk, budget + buffer, ...], positions -1 where
    empty), and the token's K/V go to its tail buffer at ``budget +
    buf_len``; the full cache passes through untouched."""
    if not cfg.is_attention_arch:
        def step_state(params, cache, token):
            b = token.shape[0]
            pos = cache["length"][:, None]
            out = api.decode(cfg, params, token[:, None], pos, cache,
                             spec=spec)
            nxt = torch.argmax(out.logits[:, 0], dim=-1).to(torch.int32)
            copy_into(cache, api.advance(
                cfg, params, token[:, None], cache,
                torch.ones((b, 1), dtype=torch.bool, device=token.device)))
            return nxt, cache
        return step_state

    if not partial:
        def step_full(params, cache, token):
            b = token.shape[0]
            pos = cache["length"][:, None]
            out = api.decode(cfg, params, token[:, None], pos, cache,
                             mode="full", spec=spec)
            nxt = torch.argmax(out.logits[:, 0], dim=-1).to(torch.int32)
            copy_into(cache, vf.append_full_cache(
                cache, out.new_kv[0], out.new_kv[1],
                torch.ones((b,), dtype=torch.int32, device=token.device),
                spec))
            return nxt, cache
        return step_full

    def step_partial(params, cache, pkv_k, pkv_v, pkv_pos, buf_len, token):
        b = token.shape[0]
        # position = total sequence length (committed + buffered)
        pos = (cache["length"] + buf_len)[:, None]
        out = api.decode(cfg, params, token[:, None], pos, cache,
                         mode="partial", pkv=(pkv_k, pkv_v, pkv_pos),
                         spec=spec)
        nxt = torch.argmax(out.logits[:, 0], dim=-1).to(torch.int32)
        vf.append_buffer_(pkv_k, pkv_v, pkv_pos, spec.partial_budget_tokens,
                          buf_len, out.new_kv[0], out.new_kv[1], pos,
                          torch.ones((b,), dtype=torch.int32,
                                     device=token.device))
        return nxt, cache, pkv_k, pkv_v, pkv_pos, buf_len

    return step_partial


def partial_state(spec: SpecPVConfig, partial):
    """The partial decode step's state from a selection (``api.decode(...,
    select_partial=True).partial``, (pk, pv, ppos) [L, B, Hk, budget,
    ...]): ``spec.buffer_size`` more slots, K/V 0 and positions -1, as the
    reference's engine pads a refresh, and ``buf_len`` 0.  Returns (pk,
    pv, ppos, buf_len)."""
    pk, pv, ppos = partial
    pad = spec.buffer_size

    def grow(a, fill):
        shape = a.shape[:3] + (pad,) + a.shape[4:]
        return torch.cat([a, torch.full(shape, fill, dtype=a.dtype,
                                        device=a.device)], dim=3)
    buf_len = torch.zeros((pk.shape[1],), dtype=torch.int32, device=pk.device)
    return grow(pk, 0), grow(pv, 0), grow(ppos, -1), buf_len
