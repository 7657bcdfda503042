"""Plain PyTorch versions of the port's CUDA kernels (counterpart of
``repro/kernels/ref.py``).

The CPU tests run them, the wrappers in ``kernels/ops.py`` take them for
CPU tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.  The single-row functions keep the reference oracles'
signatures; the ``*_batched`` cores carry a leading batch axis.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -1e30


def block_attention_batched(q, k_flat, v_flat, block_idx, block_valid_len,
                            block_size: int, q_offset: Optional[torch.Tensor]
                            = None):
    """Block-list attention partials for a batch of rows.

    q: [B, T, H, Dh]; k_flat/v_flat: [S, Hk, Dh] flattened pool;
    block_idx/block_valid_len: [B, Hk, N] int (block j of row b, head
    hk reads pool block ``block_idx[b, hk, j]``, clipped to the pool, and
    its first ``block_valid_len`` tokens); q_offset: [B] absolute
    position of query 0 — when given, key ``j*bs + s`` is also masked
    unless it is <= the query's position (paged prefill).

    Returns (m [B, H, T], l [B, H, T], acc [B, H, T, Dh]) fp32; a row
    whose blocks are all empty comes out exactly (-1e30, 0, 0)."""
    b, t, h, dh = q.shape
    s, hk, _ = k_flat.shape
    n = block_idx.shape[-1]
    rep = h // hk
    nb = s // block_size
    scale = 1.0 / math.sqrt(dh)
    kb = k_flat[: nb * block_size].reshape(nb, block_size, hk, dh)
    vb = v_flat[: nb * block_size].reshape(nb, block_size, hk, dh)
    # the reference gather clamps ids into the pool (sparse_attention.py)
    idx = torch.clamp(block_idx.long(), 0, nb - 1)              # [B, Hk, N]
    hsel = torch.arange(hk, device=q.device)[None, :, None]
    kg = kb.permute(2, 0, 1, 3)[hsel, idx]                       # [B,Hk,N,bs,Dh]
    vg = vb.permute(2, 0, 1, 3)[hsel, idx]
    sidx = torch.arange(block_size, device=q.device)
    valid = sidx[None, None, None] < block_valid_len[..., None]  # [B,Hk,N,bs]
    valid = valid[:, :, None]                                    # [B,Hk,1,N,bs]
    if q_offset is not None:
        k_pos = (torch.arange(n, device=q.device)[:, None] * block_size
                 + sidx[None])                                   # [N, bs]
        q_pos = q_offset.long()[:, None] + torch.arange(t, device=q.device)
        causal = k_pos[None, None] <= q_pos[:, :, None, None]   # [B,T,N,bs]
        valid = valid & causal[:, None]                          # [B,Hk,T,N,bs]
    qg = q.reshape(b, t, hk, rep, dh).float() * scale
    logits = torch.einsum("btkrd,bknsd->bkrtns", qg, kg.float())
    logits = torch.where(valid[:, :, None], logits,
                         torch.full_like(logits, NEG))
    logits = logits.reshape(b, hk, rep, t, n * block_size)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None]) * (logits > -1e29)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkrts,bksd->bkrtd", p,
                       vg.reshape(b, hk, n * block_size, dh).float())
    return (m.reshape(b, h, t), l.reshape(b, h, t), acc.reshape(b, h, t, dh))


def sparse_verify_attention_ref(q, k_cache, v_cache, block_idx,
                                block_valid_len, block_size: int):
    """One row: q [T, H, Dh]; k_cache/v_cache [S, Hk, Dh];
    block_idx/block_valid_len [Hk, NSel].  Returns partials
    (m [H, T], l [H, T], acc [H, T, Dh]) fp32."""
    m, l, acc = block_attention_batched(q[None], k_cache, v_cache,
                                        block_idx[None], block_valid_len[None],
                                        block_size)
    return m[0], l[0], acc[0]


def paged_prefill_attention_ref(q, k_cache, v_cache, block_idx,
                                block_valid_len, q_offset, block_size: int):
    """One row, causal: q [T, H, Dh] with query 0 at absolute position
    ``q_offset[0]``; k_cache/v_cache [S, Hk, Dh]; block_idx/
    block_valid_len [Hk, NB] (logical block j reads page
    ``block_idx[h, j]``).  Returns partials (m, l, acc) fp32."""
    m, l, acc = block_attention_batched(q[None], k_cache, v_cache,
                                        block_idx[None], block_valid_len[None],
                                        block_size,
                                        q_offset=q_offset.reshape(1))
    return m[0], l[0], acc[0]


def retrieval_score_batched(q, kmax, kmin, q_weight):
    """Paper eqs. (2)-(3), mean reduction, for a batch of rows.

    q: [B, T, H, Dh]; kmax/kmin: [B, NB, Hk, Dh] fp32; q_weight: [B, T].
    Returns [B, Hk, NB] fp32."""
    b, t, h, dh = q.shape
    nb, hk = kmax.shape[1], kmax.shape[2]
    rep = h // hk
    qg = q.reshape(b, t, hk, rep, dh).float()
    smax = torch.einsum("btkrd,bnkd->btkrn", qg, kmax.float())
    smin = torch.einsum("btkrd,bnkd->btkrn", qg, kmin.float())
    s = torch.maximum(smax, smin).mean(dim=3)                   # [B,T,Hk,NB]
    w = q_weight.float()[:, :, None, None]
    return ((s * w).sum(dim=1)
            / torch.clamp(w.sum(dim=1), min=1e-9))


def retrieval_score_ref(q, kmax, kmin, q_weight):
    """One row: q [T, H, Dh]; kmax/kmin [NB, Hk, Dh]; q_weight [T].
    Returns [Hk, NB] fp32."""
    return retrieval_score_batched(q[None], kmax[None], kmin[None],
                                   q_weight[None])[0]
