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

Tokens are int32, as the reference's.  Under a mesh's ``model`` axis the
prefill and decode steps take the split (``tp=``, a
``distributed.tensor_parallel.TensorParallel`` of the same params) and
pass it to ``models.api``; their state is then shard-stacked ([m * L,
..., Hk / m, ...]) and their call forms stay the same.  Without it they
run whole weights.

``make_train_step(grad_shardings=)`` trains FSDP over a mesh's data axes:
``grad_shardings`` is ``distributed.sharding.param_specs(ShardingRules(
mesh, fsdp=True), params)``.  Each data shard takes its rows of the batch
and computes their loss and gradients on its device (one backward pass
of the batch's loss, ``api.sharded_train_loss``); each gradient is
summed over the data shards (``tensor_parallel.all_reduce``) and cut to
every mesh device's slice (``shard_leaf``), where that device's AdamW
moments live (``train.optimizer.ShardedMoments``); each device updates
its slice of the parameters, and the slices are written back into the
caller's tensors.  The loss is the whole batch's mean (each shard's mean
weighted by its tokens), and the global-norm clip sums the squares of
every distinct slice once.  A target with experts routes over the whole
batch: an MoE layer's groups, capacity, drops and aux loss are those of
the unsharded step, each shard still running only its rows on its
device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, SpecPVConfig
from repro_torch.core import verify as vf
from repro_torch.core.engine import copy_into
from repro_torch.distributed.sharding import (check_specs, piece_index,
                                              shard_leaf, spec_leaves)
from repro_torch.distributed.tensor_parallel import all_reduce
from repro_torch.models import api
from repro_torch.train.optimizer import (OptState, ShardedMoments,
                                         adamw_update, clip_by_global_norm,
                                         cosine_schedule, shard_moments,
                                         tree_leaves, tree_map)


def _loss_and_grads(loss_fn, trees):
    """(loss, a gradient tree per tree) of ``loss_fn()`` under autograd;
    the trees' ``requires_grad`` is set for the pass and restored after
    it."""
    leaves = [p for tree in trees for p in tree_leaves(tree)]
    was = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p, w in zip(leaves, was):
            p.requires_grad_(w)
    by_id = {id(p): (g if g is not None else torch.zeros_like(p))
             for p, g in zip(leaves, grads)}
    return loss.detach(), [tree_map(lambda p, stacked: by_id[id(p)], tree)
                           for tree in trees]


def make_train_step(cfg: ModelConfig, grad_shardings=None):
    """(params, opt, tokens [B, S+1], extra) -> (params, opt, loss): the
    loss and its gradients (``api.train_loss`` under autograd), the
    global-norm clip at 1.0, the reference's cosine schedule and AdamW,
    the parameters and moments updated in place.  The parameters'
    ``requires_grad`` is set for the step and restored after it.
    ``grad_shardings`` (a ``param_specs`` tree) makes it the FSDP step of
    the module docstring; it returns the moments as ``ShardedMoments``
    and takes them so, or whole (``adamw_init``) at its first call."""
    unstacked = api.unstacked_layers(cfg)
    if grad_shardings is not None:
        return _fsdp_train_step(cfg, grad_shardings, unstacked)

    def step(params, opt, tokens, extra):
        loss, (grads,) = _loss_and_grads(
            lambda: api.train_loss(cfg, params, tokens, extra=extra)[0],
            [params])
        grads, _ = clip_by_global_norm(grads, 1.0)
        lr = cosine_schedule(opt.step, base_lr=3e-4, warmup=100, total=10000)
        params, opt = adamw_update(params, grads, opt, lr=lr,
                                   unstacked_layers=unstacked)
        return params, opt, loss

    return step


def _fsdp_train_step(cfg: ModelConfig, specs, unstacked: int):
    rules = getattr(specs, "rules", None)
    if rules is None:
        raise ValueError("grad_shardings must be a spec tree from "
                         "distributed.sharding.param_specs, which carries "
                         "its mesh")
    mesh = rules.mesh
    d_n = rules.data_size
    coords = [mesh.coords(c) for c in range(mesh.size)]

    def data_index(co) -> int:
        i = 0
        for a in rules.data_axes:
            i = i * mesh.shape[a] + co[a]
        return i
    # the device of each data shard: its coordinate at model 0
    shard_dev = {data_index(co): dev for co, dev in zip(coords, mesh.devices)
                 if co["model"] == 0}

    def step(params, opt, tokens, extra):
        check_specs(specs, params)
        b = tokens.shape[0]
        if b % d_n:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{d_n} data shards")
        if not isinstance(opt.mu, ShardedMoments):
            opt = OptState(opt.step, shard_moments(opt.mu, specs, mesh),
                           shard_moments(opt.nu, specs, mesh))
        rows = b // d_n
        leaves = tree_leaves(params)
        shards = []
        for d in range(d_n):
            dev = shard_dev[d]
            part = slice(d * rows, (d + 1) * rows)
            shards.append((
                tree_map(lambda p, stacked: p.detach().to(dev), params),
                tokens[part].to(dev),
                None if extra is None else
                {k: v[part].to(dev) for k, v in extra.items()}))
        # one loss over the shards (an MoE target's routing couples
        # them) and one backward pass: each replica's gradients are its
        # rows' share
        total, g = _loss_and_grads(
            lambda: api.sharded_train_loss(cfg, shards)[0],
            [r for r, _, _ in shards])
        grads = [tree_leaves(x) for x in g]
        del shards
        # every leaf's sum over the data shards, on each shard's device
        sums = [all_reduce([grads[d][i] for d in range(d_n)])
                for i in range(len(leaves))]
        del grads
        sps = spec_leaves(specs)
        index = {id(p): i for i, p in enumerate(leaves)}
        # a piece that several devices hold is owned (counted in the norm
        # and written back) by the first of them
        seen, owned = set(), []
        for co in coords:
            keys = [(i, piece_index(sp, mesh, co)) for i, sp in enumerate(sps)]
            owned.append([k not in seen for k in keys])
            seen.update(keys)
        # each mesh device's slice of every summed gradient
        g_sl = [[shard_leaf(sums[i][data_index(co)], sp, mesh, co).to(
                    dev, copy=True) for i, sp in enumerate(sps)]
                for co, dev in zip(coords, mesh.devices)]
        del sums
        # the global-norm clip: the squares of every distinct slice once
        sq = all_reduce([sum((torch.sum(torch.square(g.float()))
                              for g, own in zip(gs, ow) if own),
                             torch.zeros((), device=dev))
                         for gs, ow, dev in zip(g_sl, owned, mesh.devices)])
        lr = cosine_schedule(opt.step, base_lr=3e-4, warmup=100, total=10000)
        # each device's slice of the parameters, all cut before any update
        p_trees = [tree_map(lambda p, sp, stacked: shard_leaf(
            p, sp, mesh, co).to(dev, copy=True), params, specs)
            for co, dev in zip(coords, mesh.devices)]
        for c, p_tree in enumerate(p_trees):
            scale = torch.clamp(1.0 / torch.clamp(torch.sqrt(sq[c]),
                                                  min=1e-9), max=1.0)
            g_tree = tree_map(lambda p, stacked: (
                g_sl[c][index[id(p)]].float() * scale).to(p.dtype), params)
            adamw_update(p_tree, g_tree,
                         OptState(opt.step, opt.mu[c], opt.nu[c]), lr=lr,
                         unstacked_layers=unstacked)
        # the whole parameters gathered back in place
        with torch.no_grad():
            for co, ow, p_tree in zip(coords, owned, p_trees):
                for p, sp, sl, own in zip(leaves, sps, tree_leaves(p_tree),
                                          ow):
                    if own:
                        shard_leaf(p, sp, mesh, co).copy_(sl)
        return params, OptState(opt.step + 1, opt.mu, opt.nu), total

    return step


def make_prefill_step(cfg: ModelConfig, spec: SpecPVConfig, *, tp=None):
    """(params, cache, tokens [B, S], extra) -> (next_token [B], cache):
    one prefill call over the whole chunk, written into ``cache`` (``tp``:
    the module docstring)."""

    def step(params, cache, tokens, extra):
        logits, _, new = api.prefill(cfg, params, tokens, cache,
                                     extra=extra, spec=spec, tp=tp)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        copy_into(cache, new)
        return nxt, cache

    return step


def make_decode_step(cfg: ModelConfig, spec: SpecPVConfig, *,
                     partial: bool = False, tp=None):
    """One-token decode (see the module docstring for the signatures).
    Full: the token verified against the whole cache, then committed to
    it.  Partial: attention reads only the materialised partial cache
    (``pkv_*`` [L, B, Hk, budget + buffer, ...], positions -1 where
    empty), and the token's K/V go to its tail buffer at ``budget +
    buf_len``; the full cache passes through untouched.  ``tp``: the
    module docstring."""
    if not cfg.is_attention_arch:
        def step_state(params, cache, token):
            b = token.shape[0]
            pos = cache["length"][:, None]
            out = api.decode(cfg, params, token[:, None], pos, cache,
                             spec=spec, tp=tp)
            nxt = torch.argmax(out.logits[:, 0], dim=-1).to(torch.int32)
            copy_into(cache, api.advance(
                cfg, params, token[:, None], cache,
                torch.ones((b, 1), dtype=torch.bool, device=token.device),
                tp=tp))
            return nxt, cache
        return step_state

    if not partial:
        def step_full(params, cache, token):
            b = token.shape[0]
            pos = cache["length"][:, None]
            out = api.decode(cfg, params, token[:, None], pos, cache,
                             mode="full", spec=spec, tp=tp)
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
                         spec=spec, tp=tp)
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
