"""The reference's hillclimbing cases on one card (counterpart of
``repro/launch/hillclimb.py``): its SpecPV verification steps and int8
resident-cache decode steps, step for step, over real state built from a
seed at the reference's shapes.

  A. granite-3-2b, a 32K SpecPV verify step (batch 8, 32768 tokens)
     A0 full-verification tree step (the EAGLE-3 baseline)
     A1 partial verification (the paper)
     A2 partial verification with an int8 partial cache
  B. qwen1.5-32b, decode_32k: B1 an int8 KV cache read without a
     dequantised copy
  C. deepseek-7b, long_500k: C1 an int8 partial cache
  D. deepseek-7b: D1 context-parallel retrieval and partial
     verification (``distributed.cp_retrieval``) over one shard of a
     524288-token layer

The reference lowers and compiles each case on its production mesh and
reads XLA's memory and cost analyses.  Here each case runs: ``run_case``
builds it (``CASES``), steps it eagerly (each step under
``torch.cuda.set_sync_debug_mode("error")``), replays the same steps
from the same state as a CUDA graph, which must give the eager run's
tokens and state bit for bit, and returns the peak and state bytes and
the median device ms of a step both ways (CUDA events).  A case that one
card cannot hold at the reference's shape is cut in depth or batch,
never width; each cut is listed in its ``reduced``.  The lowering, the
cost analysis and the collective parsing have no counterpart on one
card.  The cases A-C take ``mesh=`` (a ``distributed.sharding.DeviceMesh``
of shape (1, m), every model shard on one card; the default is a mesh
of one): the case builds the split of its params over the row's m
shards once (``distributed.tensor_parallel.TensorParallel``) and hands
it to its step as ``tp=``, the cache, its scales and the partial
cache are shard-stacked ([m * L, ..., Hk / m, ...]) from the same random
values as the unsharded case, and ``reduced`` lists the mesh.

Run (from the repo root):

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--case A1]

which writes ``results/hillclimb_torch/<case>.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs import INPUT_SHAPES, SpecPVConfig, get_config
from repro_torch.core import tree as tr
from repro_torch.core import verify as vf
from repro_torch.device import resolve_device
from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                     split_heads)
from repro_torch.kvcache.cache import contiguous_update_all_summaries
from repro_torch.kvcache.quant import quantize_kv
from repro_torch.launch.steps import partial_state
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.models.dense import attn_layer_count

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "hillclimb_torch")

TREE = tr.TreeSpec.from_branch((4, 2, 2, 1, 1))   # 60 nodes, EAGLE-scale
STEPS = 4          # steps timed eagerly and as a graph
_FILL_TOKENS = 1 << 16   # tokens quantised at once when filling a cache


# ---------------------------------------------------------------------------
# verify steps (family A)
# ---------------------------------------------------------------------------

def _write_scales(buf, scale, off):
    """Scales [L, B, W, Hk] of committed tokens into the partial cache's
    scale buffer [L, B, Hk, P] at ``off`` [B], in place (the reference's
    ``dynamic_update_slice`` at (0, off) per layer and row)."""
    cm.update_slice_rows(buf, scale.movedim(3, 2), off, axis=3, batch_axis=1)


def _row(mesh):
    """The model row a case splits over (None for a mesh of one model
    shard); a data axis above 1 raises ValueError."""
    if mesh is None:
        return None
    if mesh.data_size != 1:
        raise ValueError(f"the hillclimb cases split over a mesh's model "
                         f"axis only, not {mesh}")
    row = mesh.model_row(0)
    return row if len(row) > 1 else None


def make_verify_step(cfg, spec, tree, *, partial: bool, int8: bool = False,
                     tp=None):
    """One SpecPV verification step: the tree forward, greedy acceptance
    and the commit (to the full cache, or to the partial cache's buffer),
    in place.

    full:    (params, cache, pending [B], tree_tokens [B, T])
             -> (bonus, cache)
    partial: (params, cache, pkv, buf_len, pending, tree_tokens)
             -> (bonus, cache, pkv, buf_len); ``pkv`` = (pk, pv, ppos),
             int8 (pk, pv, ppos, pks, pvs).

    ``cpos`` are the reference's: the commit slots of an all -1 path
    taken from the verify positions, so every committed entry after the
    first carries the position of pending slot 0.  A partial cache reads
    its positions only as valid (>= 0) or empty (-1), so the tokens do
    not depend on them.  ``tp``: the split of the same params over a
    mesh's model row (``distributed.tensor_parallel.TensorParallel``;
    the state then shard-stacked, the module docstring)."""

    def common_part(params, cache, pending, tree_tokens, pkv=None):
        b = pending.shape[0]
        dev = pending.device
        plen = torch.ones((b,), dtype=torch.int32, device=dev)
        seq_len = cache["length"] + 1
        vin = vf.build_verify_inputs(tree, pending[:, None], plen,
                                     tree_tokens, seq_len)
        out = api.decode(cfg, params, vin["tokens"], vin["positions"],
                         cache, mode=("partial" if partial else "full"),
                         self_mask=vin["self_mask"], pkv=pkv, spec=spec,
                         tp=tp)
        path, acc, bonus, _ = tr.greedy_tree_accept(
            tree, tree_tokens, out.logits, vin["root_slot"],
            vin["node_slots"])
        slots, valid = vf.commit_slots(tree, vin["pend_valid"], path, 1)
        ck, cv = vf.gather_new_kv(out.new_kv, slots, valid)
        count = (1 + acc).to(torch.int32)
        return vin, ck, cv, count, bonus.to(torch.int32)

    if not partial:
        def step_full(params, cache, pending, tree_tokens):
            vin, ck, cv, count, bonus = common_part(params, cache, pending,
                                                    tree_tokens)
            new = vf.append_full_cache(cache, ck, cv, count, spec)
            cache["length"].copy_(new["length"])
            return bonus, cache
        return step_full

    def step_partial(params, cache, pkv_args, buf_len, pending, tree_tokens):
        vin, ck, cv, count, bonus = common_part(params, cache, pending,
                                                tree_tokens, pkv=pkv_args)
        none = torch.full_like(tree_tokens[:, :tree.depth], -1)
        cslots = vf.commit_slots(tree, vin["pend_valid"], none, 1)[0]
        cpos = torch.gather(vin["positions"], 1, cslots)
        body = spec.partial_budget_tokens
        if int8:
            pk, pv, ppos, pks, pvs = pkv_args
            ckq, cks = quantize_kv(ck)
            cvq, cvs = quantize_kv(cv)
            vf.append_buffer_(pk, pv, ppos, body, buf_len, ckq, cvq, cpos,
                              count)
            # the scales follow the same buffer layout
            off = body + buf_len - count
            _write_scales(pks, cks, off)
            _write_scales(pvs, cvs, off)
            return bonus, cache, pkv_args, buf_len
        pk, pv, ppos = pkv_args
        vf.append_buffer_(pk, pv, ppos, body, buf_len, ck, cv, cpos, count)
        return bonus, cache, pkv_args, buf_len
    return step_partial


# ---------------------------------------------------------------------------
# int8 decode steps (families B, C)
# ---------------------------------------------------------------------------

def make_decode_step_int8(cfg, spec, *, partial: bool, tp=None):
    """One-token decode over an int8 resident cache, in place.

    full:    (params, cache, token [B]) -> (next, cache): the token
             verified against the int8 cache (``k_scale`` / ``v_scale``),
             its K/V quantised and written at ``length``;
    partial: (params, cache, pkv, buf_len, token) -> (next, cache, pkv,
             buf_len): against the int8 partial cache (pk, pv, ppos, pks,
             pvs), its K/V quantised into the buffer.

    ``tp``: as ``make_verify_step``'s (payloads and scales
    shard-stacked)."""

    def step_full(params, cache, token):
        pos = cache["length"][:, None]
        out = api.decode(cfg, params, token[:, None], pos, cache,
                         mode="full", spec=spec, tp=tp)
        nxt = torch.argmax(out.logits[:, 0], dim=-1).to(torch.int32)
        kq, ks = quantize_kv(out.new_kv[0])     # [L, B, 1, Hk, Dh]
        vq, vs = quantize_kv(out.new_kv[1])
        length = cache["length"]
        for name, new in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            vf.write_cache_rows(cache[name], new, length)
        length.add_(1)
        return nxt, cache

    def step_partial(params, cache, pkv_args, buf_len, token):
        b = token.shape[0]
        pos = (cache["length"] + buf_len)[:, None]
        out = api.decode(cfg, params, token[:, None], pos, cache,
                         mode="partial", pkv=pkv_args, spec=spec,
                         tp=tp)
        nxt = torch.argmax(out.logits[:, 0], dim=-1).to(torch.int32)
        pk, pv, ppos, pks, pvs = pkv_args
        kq, ks = quantize_kv(out.new_kv[0])
        vq, vs = quantize_kv(out.new_kv[1])
        ones = torch.ones((b,), dtype=torch.int32, device=token.device)
        body = spec.partial_budget_tokens
        vf.append_buffer_(pk, pv, ppos, body, buf_len, kq, vq, pos, ones)
        off = body + buf_len - 1
        _write_scales(pks, ks, off)
        _write_scales(pvs, vs, off)
        return nxt, cache, pkv_args, buf_len

    return step_partial if partial else step_full


# ---------------------------------------------------------------------------
# case state
# ---------------------------------------------------------------------------

@dataclass
class Case:
    """A built case: ``fn(*args)`` is one step; ``feed`` copies its
    outputs into the arguments of the next step (the bonus or next token)
    or into static result buffers; ``probe()`` gives the tokens and the
    state the steps write (views), compared bit for bit between the eager
    and the graph run; ``restore`` (the probed views at build) is the
    state a rerun from the start must get back: every other tensor the
    steps write is rewritten before it is read."""
    name: str
    fn: Callable
    args: tuple
    feed: Callable
    restore: List[torch.Tensor]
    probe: Callable
    reduced: Dict[str, Any]
    reckoned: Dict[str, int]
    info: Dict[str, Any] = field(default_factory=dict)


def _max_len(seq: int, seq_shards: int) -> int:
    """The reference builders' cache length: 2 blocks of 128 past
    ``seq``, rounded up to a whole number of blocks per sequence
    shard."""
    nb = -(-(seq + 2 * 128) // 128)
    nb = -(-nb // seq_shards) * seq_shards
    return nb * 128


def _nbytes(obj) -> int:
    if torch.is_tensor(obj):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return 0


def _layer_param_bytes(cfg):
    """(bytes of one layer's weights, bytes of the rest: embedding, head
    and final norm) of a dense attention stack, from its shapes."""
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    attn = 2 * d * h * dh + 2 * d * hk * dh
    if cfg.qkv_bias:
        attn += h * dh + 2 * hk * dh
    mlp = (3 if cfg.act in ("silu", "gelu") else 2) * d * cfg.d_ff
    isz = cm.dt(cfg.param_dtype).itemsize
    rest = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2) + d
    return (attn + mlp + 2 * d) * isz, rest * isz


def _fit_layers(want: int, per_layer: int, fixed: int, transient: int,
                dev, margin: int = 2 << 30) -> int:
    """The depth to build: ``want`` layers, fewer if the card's free
    memory cannot hold ``fixed + layers * per_layer + transient`` and a
    margin."""
    if dev.type != "cuda":
        return want
    free = torch.cuda.mem_get_info(dev)[0]
    fit = (free - margin - fixed - transient) // per_layer
    return max(1, min(want, int(fit)))


def _cut(cfg, layers: Optional[int], batch: int, full_batch: int,
         reason: str):
    reduced = {}
    if layers is not None and layers != cfg.num_layers:
        reduced["num_layers"] = {"ran": layers, "full": cfg.num_layers}
        cfg = cfg.replace(num_layers=layers)
    if batch != full_batch:
        reduced["global_batch"] = {"ran": batch, "full": full_batch}
    if reduced:
        reduced["why"] = reason
    return cfg, reduced


def _randn(shape, dtype, gen, dev):
    return torch.randn(shape, generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)


def _pieces(seq: int, layers: int, shards: int):
    """(stacked layers of each shard, token range) in fill order: one
    logical layer at a time, ``_FILL_TOKENS`` tokens at a time, so that a
    shard-stacked cache draws the unsharded cache's values."""
    for layer in range(layers):
        for s0 in range(0, seq, _FILL_TOKENS):
            yield ([s * layers + layer for s in range(shards)],
                   slice(s0, min(seq, s0 + _FILL_TOKENS)))


def _fill_bf(k, seq: int, gen, shards: int = 1):
    """Random normal K or V rows [0, seq) of a cache [L, B, S, Hk, Dh]
    (shard-stacked [m * L, ..., Hk / m, Dh] for ``shards`` = m, each
    shard the unsharded values' heads) in place, in pieces of
    ``_FILL_TOKENS`` tokens of one layer."""
    hk = k.shape[3]
    for idx, sl in _pieces(seq, k.shape[0] // shards, shards):
        x = _randn((k.shape[1], sl.stop - sl.start, hk * shards)
                   + tuple(k.shape[4:]), k.dtype, gen, k.device)
        for s, j in enumerate(idx):
            k[j][:, sl].copy_(x[:, :, s * hk:(s + 1) * hk])


def _fill_int8(q, scale, seq: int, gen, shards: int = 1):
    """Rows [0, seq) of an int8 cache [L, B, S, Hk, Dh] and its scales
    [L, B, S, Hk] (shard-stacked as in ``_fill_bf``): random normal K/V
    quantised per (token, head) (``quantize_kv``), in pieces of
    ``_FILL_TOKENS`` tokens."""
    hk = q.shape[3]
    for idx, sl in _pieces(seq, q.shape[0] // shards, shards):
        x = _randn((q.shape[1], sl.stop - sl.start, hk * shards)
                   + tuple(q.shape[4:]), torch.bfloat16, gen, q.device)
        qq, ss = quantize_kv(x)
        for s, j in enumerate(idx):
            q[j][:, sl].copy_(qq[:, :, s * hk:(s + 1) * hk])
            scale[j][:, sl].copy_(ss[:, :, s * hk:(s + 1) * hk])


def _mesh_split(cfg, params, mesh, reduced: Dict[str, Any]):
    """(the split of ``mesh``'s model row or None, how many pieces the
    per-head state falls into); a split mesh is listed in ``reduced``."""
    row = _row(mesh)
    if row is None:
        return None, 1
    tp = TensorParallel(cfg, params, row)
    reduced["mesh"] = {"shape": [1, len(row)],
                       "devices": [str(d) for d in row],
                       "kv_shards": tp.kv_shards}
    return tp, tp.kv_shards


def init_int8_cache(cfg, batch: int, max_len: int, spec: SpecPVConfig,
                    device=None, kv_shards: int = 1) -> dict:
    """The reference case builders' int8 cache: ``api.init_cache``'s
    contiguous layout with K/V int8 [L, B, max_len, Hk, Dh] and their bf16
    scales ``k_scale`` / ``v_scale`` [L, B, max_len, Hk], zeros;
    shard-stacked ([m * L, ..., Hk / m, ...]) for ``kv_shards`` = m."""
    dev = resolve_device(device)
    l_attn = attn_layer_count(cfg.layer_kinds()) * kv_shards
    hk, dh = cfg.num_kv_heads // kv_shards, cfg.head_dim_
    nb = -(-max_len // spec.block_size)
    cache = {n: torch.zeros((l_attn, batch, max_len, hk, dh),
                            dtype=torch.int8, device=dev) for n in ("k", "v")}
    for n in ("k_scale", "v_scale"):
        cache[n] = torch.zeros((l_attn, batch, max_len, hk),
                               dtype=torch.bfloat16, device=dev)
    for n in ("kmax", "kmin"):
        cache[n] = torch.zeros((l_attn, batch, nb, hk, dh),
                               dtype=torch.float32, device=dev)
    cache["length"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return cache


def _token_feed(dst):
    def feed(out):
        dst.copy_(out[0])
    return feed


def _rows_probe(cache, start: int, width: int, names):
    """Views of the cache rows [start, start + width) the steps write."""
    return [cache[n][:, :, start:start + width] for n in names]


# ---------------------------------------------------------------------------
# case builders
# ---------------------------------------------------------------------------

def build_verify_case(arch: str, *, partial: bool, int8: bool, device=None,
                      seed: int = 0, batch: int = 8, seq: int = 32768,
                      layers: Optional[int] = None,
                      spec: Optional[SpecPVConfig] = None,
                      steps: int = STEPS, mesh=None) -> Case:
    """Case A: ``arch`` at full width, a contiguous bf16 cache of ``seq``
    random tokens per row (summaries computed over them), a random
    pending token and draft tree per row.  Partial: the partial cache is
    the step's own selection from the cache (``api.decode(...,
    select_partial=True)``) with the reference's buffer, quantised per
    (token, head) for ``int8``.  ``mesh``: the module docstring."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    spec = spec or SpecPVConfig()
    cfg, reduced = _cut(cfg, layers, batch, 8, "one card")
    max_len = _max_len(seq, 16)
    l_attn = attn_layer_count(cfg.layer_kinds())
    hk, dh = cfg.num_kv_heads, cfg.head_dim_
    isz = cm.dt(cfg.dtype).itemsize
    p_slots = spec.partial_budget_tokens + spec.buffer_size
    nb = -(-max_len // spec.block_size)
    per_layer, fixed = _layer_param_bytes(cfg)
    reckoned = {"weights": fixed + per_layer * cfg.num_layers,
                "kv": 2 * l_attn * batch * max_len * hk * dh * isz,
                "summaries": 2 * l_attn * batch * nb * hk * dh * 4}
    if partial:
        reckoned["pkv"] = l_attn * batch * hk * p_slots * (
            2 * dh * (1 if int8 else isz) + 4 + (4 if int8 else 0))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    params = api.init_params(cfg, seed=seed, device=dev)
    tp, kvs = _mesh_split(cfg, params, mesh, reduced)
    cache = api.init_cache(cfg, batch, max_len, spec, device=dev,
                           kv_shards=kvs)
    _fill_bf(cache["k"], seq, gen, kvs)
    _fill_bf(cache["v"], seq, gen, kvs)
    cache["length"].fill_(seq)
    for i in range(l_attn * kvs):   # one K4 call per layer: <= 65535 blocks
        contiguous_update_all_summaries(
            cache["kmax"][i:i + 1], cache["kmin"][i:i + 1],
            cache["k"][i:i + 1], torch.zeros_like(cache["length"]),
            cache["length"], spec.block_size, -(-seq // spec.block_size))
    pending = torch.randint(0, cfg.vocab_size, (batch,), generator=gen,
                            device=dev, dtype=torch.int32)
    tree_tokens = torch.randint(0, cfg.vocab_size, (batch, TREE.size),
                                generator=gen, device=dev, dtype=torch.int32)
    fn = make_verify_step(cfg, spec, TREE, partial=partial, int8=int8,
                          tp=tp)
    width = steps * (1 + TREE.depth)
    blk0, blk1 = seq // spec.block_size, (seq + width - 1) // spec.block_size
    if not partial:
        def probe():
            return [pending, cache["length"]] + _rows_probe(
                cache, seq, width, ("k", "v")) + [
                cache[n][:, :, blk0:blk1 + 1] for n in ("kmax", "kmin")]
        return Case("A0", fn, (params, cache, pending, tree_tokens),
                    _token_feed(pending), probe(), probe, reduced, reckoned,
                    dict(cfg=cfg, spec=spec))
    with torch.no_grad():
        sel = api.decode(cfg, params, pending[:, None],
                         cache["length"][:, None], cache, mode="full",
                         spec=spec, select_partial=True, tp=tp).partial
    pk, pv, ppos, buf_len = partial_state(spec, sel)
    del sel
    pkv = (pk, pv, ppos)
    if int8:
        (pk, pks), (pv, pvs) = quantize_kv(pk), quantize_kv(pv)
        pkv = (pk, pv, ppos, pks, pvs)
    body = spec.partial_budget_tokens

    def probe():
        return [pending, buf_len] + [
            a[..., body:body + width, :] for a in pkv[:2]] + [
            a[..., body:body + width] for a in pkv[2:]]
    name = "A2" if int8 else "A1"
    return Case(name, fn, (params, cache, pkv, buf_len, pending, tree_tokens),
                _token_feed(pending), probe(), probe, reduced, reckoned,
                dict(cfg=cfg, spec=spec))


def build_int8_decode_case(arch: str, shape: str, *, device=None,
                           seed: int = 0, batch: Optional[int] = None,
                           seq: Optional[int] = None,
                           layers: Optional[int] = None,
                           spec: Optional[SpecPVConfig] = None,
                           steps: int = STEPS, mesh=None) -> Case:
    """Cases B and C: ``arch`` at full width over an int8 cache of
    ``INPUT_SHAPES[shape]``'s tokens (random K/V quantised per (token,
    head)), one token per row.  ``long_500k`` decodes through an int8
    partial cache (random, quantised, every body slot valid), the others
    against the whole int8 cache.  The reference shards the sequence over
    every device of its mesh for ``long_500k`` (16 otherwise); one card
    holds the whole sequence.  ``mesh``: the module docstring."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    spec = spec or SpecPVConfig()
    info = INPUT_SHAPES[shape]
    seq = seq or info["seq_len"]
    full_batch = info["global_batch"]
    batch = batch or full_batch
    partial = shape == "long_500k"
    max_len = _max_len(seq, 1 if partial else 16)
    hk, dh = cfg.num_kv_heads, cfg.head_dim_
    nb = -(-max_len // spec.block_size)
    p_slots = spec.partial_budget_tokens + spec.buffer_size
    cache_layer = (2 * batch * max_len * hk * (dh + 2)
                   + 2 * batch * nb * hk * dh * 4)
    pkv_layer = batch * hk * p_slots * (2 * dh + 4 + 4) if partial else 0
    per_layer, fixed = _layer_param_bytes(cfg)
    # the T=1 read widens one layer's K and V to fp32 (the reference
    # widens the whole span); a partial step reads only its partial cache
    transient = 0 if partial else 2 * 2 * batch * max_len * hk * dh * 4
    want = layers or cfg.num_layers
    fit = _fit_layers(want, per_layer + cache_layer + pkv_layer, fixed,
                      transient, dev)
    cfg, reduced = _cut(cfg, fit, batch, full_batch, "one card: " + (
        f"{want} layers asked, {fit} fit the free memory" if fit < want
        else "the reference's depth and batch do not fit 80 GB"))
    l_attn = attn_layer_count(cfg.layer_kinds())
    reckoned = {"weights": fixed + per_layer * cfg.num_layers,
                "int8_cache": l_attn * cache_layer,
                "widened_kv_per_layer": transient}
    if partial:
        reckoned["pkv"] = l_attn * pkv_layer
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    params = api.init_params(cfg, seed=seed, device=dev)
    tp, kvs = _mesh_split(cfg, params, mesh, reduced)
    cache = init_int8_cache(cfg, batch, max_len, spec, device=dev,
                            kv_shards=kvs)
    _fill_int8(cache["k"], cache["k_scale"], seq, gen, kvs)
    _fill_int8(cache["v"], cache["v_scale"], seq, gen, kvs)
    cache["length"].fill_(seq)
    token = torch.randint(0, cfg.vocab_size, (batch,), generator=gen,
                          device=dev, dtype=torch.int32)
    fn = make_decode_step_int8(cfg, spec, partial=partial, tp=tp)
    name = "C1" if partial else "B1"
    if not partial:
        def probe():
            return [token, cache["length"]] + _rows_probe(
                cache, seq, steps, ("k", "v", "k_scale", "v_scale"))
        return Case(name, fn, (params, cache, token), _token_feed(token),
                    probe(), probe, reduced, reckoned, dict(cfg=cfg, spec=spec))
    body = spec.partial_budget_tokens
    shp = (l_attn, batch, hk, p_slots, dh)
    pk, pks = quantize_kv(_randn(shp, torch.bfloat16, gen, dev))
    pv, pvs = quantize_kv(_randn(shp, torch.bfloat16, gen, dev))
    # the body holds a selection of positions below seq; the buffer is
    # empty (-1, payload and scales 0)
    ppos = torch.full(shp[:4], -1, dtype=torch.int32, device=dev)
    ppos[..., :body] = torch.linspace(0, seq - 1, body, device=dev).to(
        torch.int32)
    for a in (pk, pv, pks, pvs):
        a[:, :, :, body:].zero_()
    buf_len = torch.zeros((batch,), dtype=torch.int32, device=dev)
    pkv = tuple(split_heads(a, kvs, 0, 2)
                for a in (pk, pv, ppos, pks, pvs))

    def probe():
        return [token, buf_len] + [a[..., body:body + steps, :]
                                   for a in pkv[:2]] + [
            a[..., body:body + steps] for a in pkv[2:]]
    return Case(name, fn, (params, cache, pkv, buf_len, token),
                _token_feed(token), probe(), probe, reduced, reckoned,
                dict(cfg=cfg, spec=spec))


def build_cp_retrieval_case(arch: str, *, device=None, seed: int = 0,
                            seq: int = 524288, t: int = 8,
                            spec: Optional[SpecPVConfig] = None,
                            steps: int = STEPS) -> Case:
    """Case D: context-parallel retrieval and partial verification
    (``distributed.cp_retrieval.cp_partial_verify_single``, the function
    the ranks are held to) over one shard: ``arch``'s attention heads, one
    layer's random K/V of ``seq`` tokens and their summaries (K4), T
    random queries, batch 1.  It writes no state."""
    from repro_torch.distributed.cp_retrieval import cp_partial_verify_single
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    cfg = get_config(arch)
    spec = spec or SpecPVConfig()
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    dtype = cm.dt(cfg.dtype)
    nb = seq // spec.block_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    q = _randn((1, t, h, dh), dtype, gen, dev)
    k = torch.zeros((1, 1, seq, hk, dh), dtype=dtype, device=dev)
    v = torch.zeros_like(k)
    _fill_bf(k, seq, gen)
    _fill_bf(v, seq, gen)
    kmax = torch.zeros((1, 1, nb, hk, dh), dtype=torch.float32, device=dev)
    kmin = torch.zeros_like(kmax)
    length = torch.full((1,), seq, dtype=torch.int32, device=dev)
    ops.contiguous_block_summaries(k, torch.zeros_like(length), length, nb,
                                   kmax, kmin, spec.block_size)
    reckoned = {"kv": 2 * seq * hk * dh * dtype.itemsize,
                "summaries": 2 * nb * hk * dh * 4}
    out = torch.zeros_like(q)
    sel = torch.zeros((1, hk, spec.retrieval_budget_blocks),
                      dtype=torch.long, device=dev)

    def fn(q, k, v, kmax, kmin, length):
        return cp_partial_verify_single(spec, spec.retrieval_budget_blocks,
                                        q, [k], [v], [kmax], [kmin], length)

    def feed(res):
        out.copy_(res[0])
        sel.copy_(res[1][0])
    return Case("D1", fn, (q, k[0], v[0], kmax[0], kmin[0], length), feed,
                [], lambda: [out, sel], {}, reckoned, dict(cfg=cfg, spec=spec))


CASES = {
    "A0_granite_verify32k_full":
        lambda **kw: build_verify_case("granite-3-2b", partial=False,
                                       int8=False, **kw),
    "A1_granite_verify32k_partial":
        lambda **kw: build_verify_case("granite-3-2b", partial=True,
                                       int8=False, **kw),
    "A2_granite_verify32k_partial_int8":
        lambda **kw: build_verify_case("granite-3-2b", partial=True,
                                       int8=True, **kw),
    "B1_qwen32b_decode32k_int8":
        lambda **kw: build_int8_decode_case(
            "qwen1.5-32b", "decode_32k",
            **{"layers": 32, "batch": 2, **kw}),
    "C1_deepseek_long500k_int8pkv":
        lambda **kw: build_int8_decode_case(
            "deepseek-7b", "long_500k", **{"layers": 12, **kw}),
    "D1_deepseek_cp_retrieval":
        lambda **kw: build_cp_retrieval_case("deepseek-7b", **kw),
}


# ---------------------------------------------------------------------------
# running a case
# ---------------------------------------------------------------------------

def _steps(case: Case, call, steps: int, dev, no_sync: bool):
    """``steps`` calls of ``call`` (one step each); returns (ms per step,
    the probes after each step).  On the card each step is timed with
    CUDA events and, with ``no_sync``, every step runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    cuda = dev.type == "cuda"
    probes, evs, walls = [], [], []
    if cuda and no_sync:
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(steps):
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            t0 = time.perf_counter()
            call()
            walls.append((time.perf_counter() - t0) * 1e3)
            if cuda:
                e1.record()
                evs.append((e0, e1))
            probes.append([p.clone() for p in case.probe()])
    finally:
        if cuda and no_sync:
            torch.cuda.set_sync_debug_mode(0)
    if cuda:
        torch.cuda.synchronize(dev)
        return [a.elapsed_time(b) for a, b in evs], probes
    return walls, probes


def run_built(case: Case, *, steps: int = STEPS, device=None) -> dict:
    """Step a built case eagerly (after one untimed step, the state then
    restored; on the card every eager step under the sync check), then
    (on the card) as a CUDA graph from the same state;
    the graph's tokens and written state must equal the eager run's bit
    for bit.  Returns its record: the eager tokens, ms per step (medians
    and all), state and peak bytes, the launches of each run."""
    from repro_torch.core.engine import capture_graph
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    res = {"case": case.name, "reduced": case.reduced,
           "mesh": case.reduced.get("mesh", {"shape": [1, 1]}),
           "reckoned_bytes": case.reckoned,
           "state_bytes": _nbytes(case.args)}
    snap = [t.clone() for t in case.restore]

    def body():
        case.feed(case.fn(*case.args))

    def reset():
        for t, c in zip(case.restore, snap):
            t.copy_(c)
    with torch.no_grad():
        # one untimed step first: cached device constants and the
        # libraries' set-up happen once, outside the sync check
        counts = ops.launch_counts()
        body()
        ops.set_launch_counts(counts)
        reset()
        before = ops.launch_counts()
        eager_ms, eager = _steps(case, body, steps, dev, no_sync=True)
        res["launches_eager"] = ops.launch_count_delta(
            before, ops.launch_counts())[0]
        if not eager[0][0].is_floating_point():
            res["tokens"] = [p[0].tolist() for p in eager]
        res["eager_ms"] = eager_ms
        res["eager_ms_median"] = statistics.median(eager_ms)
        if dev.type == "cuda":
            reset()
            graph = capture_graph(body, dev, case.restore,
                                  torch.cuda.graph_pool_handle())
            before = ops.launch_counts()
            graph_ms, replayed = _steps(case, graph.replay, steps, dev,
                                        no_sync=False)
            res["launches_graph"] = ops.launch_count_delta(
                before, ops.launch_counts())[0]
            for i, (a, b) in enumerate(zip(eager, replayed)):
                for j, (x, y) in enumerate(zip(a, b)):
                    if not torch.equal(x, y):
                        raise AssertionError(
                            f"{case.name}: graph step {i} differs from the "
                            f"eager step in probe {j}")
            res["graph_ms"] = graph_ms
            res["graph_ms_median"] = statistics.median(graph_ms)
            res["graph_equals_eager"] = True
            torch.cuda.synchronize(dev)
            res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            del graph
    del snap
    return res


def run_case(name: str, *, steps: int = STEPS, device=None,
             check: Optional[Callable] = None, **kw) -> dict:
    """Build the case ``name`` of ``CASES`` (``kw`` overrides its shape:
    ``batch``, ``seq``, ``layers``, ``spec``, ``seed``), run it
    (``run_built``), call ``check(case, record)`` if given, and free it.
    Returns its record, with the seconds and the peak bytes of the build
    (``peak_bytes`` is the steps' own, from the built state on)."""
    dev = resolve_device(device)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    case = CASES[name](device=dev, steps=steps, **kw)
    build_peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        build_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    build_s = time.perf_counter() - t0
    res = run_built(case, steps=steps, device=dev)
    res.update(name=name, build_s=build_s, build_peak_bytes=build_peak)
    if check is not None:
        check(case, res)
    del case
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", default=None, choices=list(CASES) + [None])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    for name in ([args.case] if args.case else CASES):
        print(f"[hillclimb] {name} ...", flush=True)
        r = run_case(name, device=args.device)
        with open(os.path.join(RESULTS_DIR, f"{name}.json"), "w") as f:
            json.dump(r, f, indent=1)
        print(f"  -> eager {r['eager_ms_median']:.3f} ms/step, graph "
              f"{r.get('graph_ms_median', float('nan')):.3f} ms/step, "
              f"peak {r.get('peak_bytes', 0) / 2**30:.2f} GiB, state "
              f"{r['state_bytes'] / 2**30:.2f} GiB, reduced {r['reduced']}",
              flush=True)


if __name__ == "__main__":
    main()
