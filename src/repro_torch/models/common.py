"""Shared building blocks: inits, norms, RoPE (+YARN), activations, the
plain chunked ("flash-style") attention and the (m, l, acc) softmax
partials that independent context segments combine through.

Counterpart of ``repro/models/common.py``; params are plain dicts of
tensors, activations keep the reference's [B, T, H, Dh] layout.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# dtype helpers / init
# ---------------------------------------------------------------------------

def dt(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               in_axis: int = -2) -> torch.Tensor:
    """Truncated-normal fan-in init on ``gen``'s device (drawn in fp32,
    cast once)."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def groupnorm_heads(x, scale, bias, eps: float = 1e-5):
    """Per-head groupnorm of the RWKV time-mix output.  x: [..., H, Dh]
    (population variance, as ``jnp.var``)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu_sq":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


# ---------------------------------------------------------------------------
# RoPE with optional YARN (NTK-by-parts) scaling
# ---------------------------------------------------------------------------

def rope_inv_freq(cfg: ModelConfig) -> np.ndarray:
    """Inverse frequencies, with YARN NTK-by-parts interpolation when
    cfg.yarn_factor > 1."""
    dim = cfg.head_dim_
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    s = cfg.yarn_factor
    if s > 1.0:
        beta_fast, beta_slow = 32.0, 1.0
        L = cfg.yarn_orig_len

        def corr_dim(n_rot):
            return (dim * math.log(L / (n_rot * 2 * math.pi))
                    / (2 * math.log(cfg.rope_theta)))

        low = max(math.floor(corr_dim(beta_fast)), 0)
        high = min(math.ceil(corr_dim(beta_slow)), dim - 1)
        idx = np.arange(dim // 2, dtype=np.float64)
        ramp = np.clip((idx - low) / max(high - low, 1e-3), 0.0, 1.0)
        inv = inv * (1 - ramp) + (inv / s) * ramp
    return inv.astype(np.float32)


@functools.lru_cache(maxsize=None)
def rope_inv_freq_tensor(cfg: ModelConfig, device: torch.device):
    """``rope_inv_freq(cfg)`` on ``device``, built once per (config,
    device): a step reads it with no host-to-device copy, which a CUDA
    graph capture would refuse.  Read-only."""
    return torch.as_tensor(rope_inv_freq(cfg), device=device)


def yarn_mscale(cfg: ModelConfig) -> float:
    s = cfg.yarn_factor
    if s <= 1.0:
        return 1.0
    return 0.1 * math.log(s) + 1.0


def apply_rope(x, positions, inv_freq, mscale: float = 1.0):
    """x: [..., T, H, Dh]; positions: [..., T]; inv_freq: [Dh/2] fp32."""
    ang = positions[..., None].float() * inv_freq          # [..., T, Dh/2]
    sin = torch.sin(ang)[..., None, :] * mscale
    cos = torch.cos(ang)[..., None, :] * mscale
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# row-wise slice updates (JAX's dynamic_update_slice semantics)
# ---------------------------------------------------------------------------

def update_slice_rows(buf, new, start, axis: int, batch_axis: int = 0):
    """In place: ``buf[b, ..., start[b]:start[b]+W, ...] = new[b]`` along
    ``axis`` for every batch row ``b`` (``batch_axis``).

    ``jax.lax.dynamic_update_slice`` CLAMPS its start index so the whole
    update fits; torch slicing does not, so the clamp to
    ``[0, N - W]`` is reproduced here explicitly (the pending-run,
    tail-buffer and contiguous-cache appends all rely on it)."""
    n, w = buf.shape[axis], new.shape[axis]
    b = buf.shape[batch_axis]
    start = torch.clamp(start.to(torch.long), 0, n - w)
    idx = start[:, None] + torch.arange(w, device=buf.device)[None]
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, w)
    dst = buf.movedim((batch_axis, axis), (0, 1))
    src = new.movedim((batch_axis, axis), (0, 1)).to(buf.dtype)
    dst[rows, idx] = src
    return buf


# ---------------------------------------------------------------------------
# attention math (plain paths)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def ckpt_chunked_scan(step, init, xs, *, chunk: int = 256):
    """A plain scan over the leading (time) axis of every tensor in the
    tuple ``xs``: ``carry, y = step(carry, x_t)``.  Returns (the last
    carry, the ys stacked along time).  When autograd records, the steps
    run in segments of ``chunk``, each under ``torch.utils.checkpoint``
    (recomputed in the backward pass, so O(T/chunk + chunk) carries stay
    live), as the reference's ``ckpt_chunked_scan`` does; otherwise as
    one loop.  Every step must be out of place."""
    def segment(carry, *seg):
        ys = []
        for t in range(seg[0].shape[0]):
            carry, y = step(carry, tuple(x[t] for x in seg))
            ys.append(y)
        return carry, torch.stack(ys)

    t = xs[0].shape[0]
    if not torch.is_grad_enabled() or t <= chunk:
        return segment(init, *xs)
    carry, ys = init, []
    for c0 in range(0, t, chunk):
        carry, y = torch.utils.checkpoint.checkpoint(
            segment, carry, *(x[c0:c0 + chunk] for x in xs),
            use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys)


def repeat_kv(k, n_rep: int):
    """[B, S, Hk, Dh] -> [B, S, Hk*n_rep, Dh]"""
    if n_rep == 1:
        return k
    b, s, hk, dh = k.shape
    return (k[:, :, :, None, :].expand(b, s, hk, n_rep, dh)
            .reshape(b, s, hk * n_rep, dh))


def sdpa(q, k, v, mask=None, scale=None):
    """Dense scaled-dot-product attention, the reference's form: the
    products in the inputs' dtype, the softmax in fp32, the probabilities
    cast back for the value product.  q: [B, T, H, Dh]; k/v: [B, S, Hk,
    Dh]; mask: [B, 1|H, T, S] bool or None.  Returns [B, T, H, Dh]."""
    b, t, h, dh = q.shape
    hk = k.shape[2]
    k = repeat_kv(k, h // hk)
    v = repeat_kv(v, h // hk)
    scale = scale or (1.0 / math.sqrt(dh))
    logits = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v)


def flash_attention(q, k, v, *, q_positions, kv_positions,
                    causal: bool = True, window: int = 0, kv_valid=None,
                    chunk: int = 512, return_partials: bool = False,
                    q_chunk: int = 512, k_scale=None, v_scale=None):
    """Chunked online-softmax attention over KV tiles of ``chunk`` keys
    (the reference's flash recurrence, as a plain loop).

    q: [B, T, H, Dh]; k/v: [B, S, Hk, Dh]; q_positions: [B, T];
    kv_positions: [B, S]; kv_valid: [B, S] bool; ``window`` > 0 keeps
    the keys with kv_pos > q_pos - window (a sliding window).  Returns the partials
    (m, l [B, H, T], acc [B, H, T, Dh]) fp32, or the normalised
    [B, T, H, Dh] output in q's dtype.  A normalised call of more than
    ``q_chunk`` queries runs the reference's outer loop over query tiles
    of ``q_chunk`` rows (the last one shorter, where the reference pads
    rows that it then drops), each tile rematerialised in the backward
    pass when autograd records, as ``jax.checkpoint`` does there: the
    live attention tensor stays [B, H, q_chunk, chunk] whatever T.

    An int8 K/V comes with its per-(token, head) scales ``k_scale`` /
    ``v_scale`` [B, S, Hk] and is dequantised tile by tile, to bf16
    whatever the model's dtype, as the reference does (so no dequantised
    copy of the cache is ever held).  The reference pads K, V, their
    scales and the positions to whole tiles and masks the pads; here the
    last tile is shorter, which leaves out the same keys."""
    b, t, h, dh = q.shape
    if t > q_chunk and not return_partials:
        def tile(qc, pc):
            return flash_attention(qc, k, v, q_positions=pc,
                                   kv_positions=kv_positions, causal=causal,
                                   window=window, kv_valid=kv_valid,
                                   chunk=chunk, q_chunk=q_chunk,
                                   k_scale=k_scale, v_scale=v_scale)
        outs = []
        for q0 in range(0, t, q_chunk):
            args = (q[:, q0:q0 + q_chunk], q_positions[:, q0:q0 + q_chunk])
            outs.append(torch.utils.checkpoint.checkpoint(
                tile, *args, use_reentrant=False)
                if torch.is_grad_enabled() else tile(*args))
        return torch.cat(outs, dim=1)
    s, hk = k.shape[1], k.shape[2]
    n_rep = h // hk
    scale = 1.0 / math.sqrt(dh)
    if kv_valid is None:
        kv_valid = torch.ones((b, s), dtype=torch.bool, device=q.device)
    qf = q.float() * scale
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t, dh), dtype=torch.float32, device=q.device)
    for c0 in range(0, s, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        if k_scale is not None:
            kc = (kc.float() * k_scale[:, c0:c0 + chunk].float()[..., None]
                  ).to(torch.bfloat16)
            vc = (vc.float() * v_scale[:, c0:c0 + chunk].float()[..., None]
                  ).to(torch.bfloat16)
        kc = repeat_kv(kc, n_rep).float()
        vc = repeat_kv(vc, n_rep).float()
        pc = kv_positions[:, c0:c0 + chunk]
        ok = kv_valid[:, c0:c0 + chunk][:, None, None, :]
        if causal:
            ok = ok & (pc[:, None, None, :] <= q_positions[:, None, :, None])
        if window > 0:
            ok = ok & (pc[:, None, None, :]
                       > q_positions[:, None, :, None] - window)
        logits = torch.einsum("bthd,bshd->bhts", qf, kc)
        logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # all-masked rows keep m == NEG_INF; the mask zeroes their p
        p = torch.exp(logits - m_new[..., None]) * ok
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhts,bshd->bhtd", p, vc)
        m = m_new
    if return_partials:
        return m, l, acc
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def dense_attn_part(q, k, v, *, mask=None):
    """q: [B, T, H, Dh]; k/v: [B, S, Hk, Dh]; mask: broadcastable
    [B, 1|H, T, S] bool.  Returns (m, l, acc) fp32."""
    b, t, h, dh = q.shape
    hk = k.shape[2]
    kr = repeat_kv(k, h // hk).float()
    vr = repeat_kv(v, h // hk).float()
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bthd,bshd->bhts", q.float() * scale, kr)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    if mask is not None:
        p = p * mask   # all-masked rows would otherwise get p == 1
    l = p.sum(dim=-1)
    acc = torch.einsum("bhts,bshd->bhtd", p, vr)
    return m, l, acc


def dense_attn_part_perhead(q, kph, vph, valid, *, k_scale=None,
                            v_scale=None):
    """Per-kv-head context slots (the materialised partial cache).
    q: [B, T, H, Dh]; kph/vph: [B, Hk, P, Dh]; valid: [B, Hk, P] bool;
    int8 slots come with their scales ``k_scale`` / ``v_scale`` [B, Hk,
    P], dequantised in fp32.  Returns (m, l, acc)."""
    b, t, h, dh = q.shape
    hk = kph.shape[1]
    rep = h // hk
    scale = 1.0 / math.sqrt(dh)
    if k_scale is not None:
        kph = kph.float() * k_scale.float()[..., None]
        vph = vph.float() * v_scale.float()[..., None]
    qg = q.reshape(b, t, hk, rep, dh).float() * scale
    logits = torch.einsum("btkrd,bkpd->bkrtp", qg, kph.float())
    vmask = valid[:, :, None, None, :]
    logits = torch.where(vmask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None]) * vmask
    l = p.sum(dim=-1)
    acc = torch.einsum("bkrtp,bkpd->bkrtd", p, vph.float())
    return m.reshape(b, h, t), l.reshape(b, h, t), acc.reshape(b, h, t, dh)


def dense_attn_part_quant(q, k_q, v_q, k_scale, v_scale, kv_valid):
    """Context attention over an int8 cache for a few query rows, with no
    dequantised copy of the cache: the per-(token, head) scales fold into
    the logits (k side) and into the probabilities (v side), as the
    reference does.  q: [B, T, H, Dh]; k_q/v_q: [B, S, Hk, Dh] int8;
    k_scale/v_scale: [B, S, Hk]; kv_valid: [B, S] bool.  Returns (m, l,
    acc) fp32."""
    b, t, h, dh = q.shape
    n_rep = h // k_q.shape[2]
    qf = q.float() * (1.0 / math.sqrt(dh))
    logits = torch.einsum("bthd,bshd->bhts", qf,
                          repeat_kv(k_q, n_rep).float())
    ks = repeat_kv(k_scale[..., None], n_rep)[..., 0]        # [B, S, H]
    logits = logits * ks.float().transpose(1, 2)[:, :, None, :]
    mask = kv_valid[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None]) * mask
    l = p.sum(dim=-1)
    vs = repeat_kv(v_scale[..., None], n_rep)[..., 0]
    p = p * vs.float().transpose(1, 2)[:, :, None, :]
    acc = torch.einsum("bhts,bshd->bhtd", p, repeat_kv(v_q, n_rep).float())
    return m, l, acc


def merge_attn_partials(parts):
    """Merge softmax partials of independent segments into one
    un-normalised (m, l, acc) partial."""
    m = parts[0][0]
    for p in parts[1:]:
        m = torch.maximum(m, p[0])
    l = 0.0
    acc = 0.0
    for (mi, li, acci) in parts:
        corr = torch.exp(mi - m)
        l = l + li * corr
        acc = acc + acci * corr[..., None]
    return m, l, acc


def combine_attn_parts(parts, out_dtype):
    """Merge softmax partials from independent segments -> [B, T, H, Dh]."""
    m, l, acc = merge_attn_partials(parts)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(out_dtype)


# ---------------------------------------------------------------------------
# single-layer KV-cache views (draft cache)
# ---------------------------------------------------------------------------

def layer_ctx_view(cache: dict):
    """Logical contiguous (k, v, S) view of a single-layer KV-cache dict
    (paged caches gather the slot's pages through the table; null-page
    entries read stale values that callers mask by ``length``)."""
    if "page_table" in cache:
        from repro_torch.kvcache.cache import gather_page_view
        pt = cache["page_table"]
        k = gather_page_view(cache["k"], pt)
        v = gather_page_view(cache["v"], pt)
        return k, v, k.shape[1]
    return cache["k"], cache["v"], cache["k"].shape[1]


def layer_cache_append(cache: dict, k_new, v_new, valid) -> dict:
    """Write ``k_new``/``v_new`` [B, T, Hk, Dh] at per-row offsets
    ``cache["length"]`` (in place); ``valid`` [B, T] zeroes masked
    entries.  Length bookkeeping stays with the caller."""
    vm = valid[:, :, None, None]
    zk = torch.where(vm, k_new, torch.zeros_like(k_new))
    zv = torch.where(vm, v_new, torch.zeros_like(v_new))
    out = dict(cache)
    if "page_table" in cache:
        from repro_torch.kvcache.cache import paged_write_tokens
        pt = cache["page_table"]
        paged_write_tokens(cache["k"], pt, cache["length"], zk)
        paged_write_tokens(cache["v"], pt, cache["length"], zv)
        return out
    # contiguous: the reference's dynamic_update_slice clamps the offset
    update_slice_rows(cache["k"], zk, cache["length"], axis=1)
    update_slice_rows(cache["v"], zv, cache["length"], axis=1)
    return out
