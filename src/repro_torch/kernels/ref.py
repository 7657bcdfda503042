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


def kv_split_valid_len(block_valid_len, splits: int):
    """The bf16 kernel's split-KV chunks of each (row, KV head) block
    list: its live blocks (valid length > 0), in list order, cut by live
    rank into ``splits`` contiguous chunks, chunk s taking ranks
    ``[s*L // splits, (s+1)*L // splits)`` of the L live ones.  Returns
    [splits, B, Hk, N] valid lengths, 0 outside each chunk: attention
    over chunk s is ``block_attention_batched`` with these lengths, and
    ``merge_attn_partials`` of the chunks gives the unsplit partials."""
    live = block_valid_len > 0
    rank = torch.cumsum(live.long(), dim=-1) - 1
    total = live.long().sum(dim=-1, keepdim=True)
    zero = torch.zeros_like(block_valid_len)
    return torch.stack([
        torch.where(live & (rank >= s * total // splits)
                    & (rank < (s + 1) * total // splits),
                    block_valid_len, zero)
        for s in range(splits)])


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


# ---------------------------------------------------------------------------
# K4: block summaries (paper eq. (1))
# ---------------------------------------------------------------------------

def block_summary_ref(k, length, block_size: int):
    """One row, the reference oracle's contract: k [S, Hk, Dh]; length
    scalar.  Per-block elementwise key max/min over the valid tokens
    ``< length``; a block with no valid token gives 0 (as the reference
    code does, whatever its docstring says).  Returns (kmax, kmin)
    [S // block_size, Hk, Dh] fp32."""
    s, hk, dh = k.shape
    nb = s // block_size
    kb = k[: nb * block_size].float().reshape(nb, block_size, hk, dh)
    tok = (torch.arange(nb, device=k.device)[:, None] * block_size
           + torch.arange(block_size, device=k.device)[None])
    valid = (tok < length)[..., None, None]
    kmax = torch.where(valid, kb, torch.full_like(kb, NEG)).amax(dim=1)
    kmin = torch.where(valid, kb, torch.full_like(kb, -NEG)).amin(dim=1)
    any_valid = valid.any(dim=1)
    return (torch.where(any_valid, kmax, torch.zeros_like(kmax)),
            torch.where(any_valid, kmin, torch.zeros_like(kmin)))


def block_summary_routed(k_flat, src, vlen, tgt, kmax_out, kmin_out,
                         block_size: int):
    """The routed form of K4, in place.  k_flat: [NP*bs, Hk, Dh]; src,
    vlen, tgt: [N] int.  Entry e reduces the first ``vlen[e]`` tokens of
    pool block ``src[e]`` (clipped to the pool) and writes the fp32
    result to ``kmax_out[tgt[e]]`` / ``kmin_out[tgt[e]]`` ([NT, Hk, Dh]);
    ``vlen`` 0 gives 0 and a negative target is skipped.  Targets of
    the entries that write must be distinct."""
    nb = k_flat.shape[0] // block_size
    hk, dh = k_flat.shape[1:]
    ids = torch.clamp(src.long(), 0, nb - 1)
    kb = k_flat[: nb * block_size].reshape(nb, block_size, hk, dh)[ids]
    kb = kb.float()                                              # [N,bs,Hk,Dh]
    valid = (torch.arange(block_size, device=k_flat.device)[None]
             < vlen.long()[:, None])[..., None, None]
    kmax = torch.where(valid, kb, torch.full_like(kb, NEG)).amax(dim=1)
    kmin = torch.where(valid, kb, torch.full_like(kb, -NEG)).amin(dim=1)
    any_valid = (vlen > 0)[:, None, None]
    kmax = torch.where(any_valid, kmax, torch.zeros_like(kmax))
    kmin = torch.where(any_valid, kmin, torch.zeros_like(kmin))
    # written without a boolean-mask gather, so the host never waits on
    # the device: skipped entries add zeros into row 0 and mark nothing
    keep = tgt >= 0
    t = torch.clamp(tgt.long(), min=0)
    hit = torch.zeros(kmax_out.shape[0], dtype=torch.int32,
                      device=k_flat.device).scatter_reduce(
        0, t, keep.to(torch.int32), "amax")
    hit = (hit > 0)[:, None, None]
    for out, val in ((kmax_out, kmax), (kmin_out, kmin)):
        new = torch.zeros_like(out).index_add_(
            0, t, torch.where(keep[:, None, None], val,
                              torch.zeros_like(val)))
        out.copy_(torch.where(hit, new, out))
    return kmax_out, kmin_out


def paged_block_summaries(pool, page_table, start, end, n_touch: int,
                          kmax_out, kmin_out):
    """The paged form of K4 over every layer, in place: the routing of
    the reference's ``paged_update_summaries`` (logical blocks
    ``start // bs + j``, j < ``n_touch``, live while below
    ``ceil(end / bs)`` and inside the table, valid length
    ``clip(end - tb*bs, 0, bs)``, target the block's page, the null page
    0 skipped), the same in each layer, then one ``block_summary_routed``
    over the layers' pools laid end to end (layer l's page p is row
    ``l*NP + p``).  pool: [L, NP, bs, Hk, Dh]; page_table: [B, NB];
    start/end: [B]; kmax_out/kmin_out: contiguous [L, NP, Hk, Dh] fp32."""
    layers, np_, bs, hk, dh = pool.shape
    nb = page_table.shape[1]
    dev = pool.device
    tb = ((start.long() // bs)[:, None]
          + torch.arange(n_touch, device=dev)[None])             # [B, NT]
    live = (tb < ((end.long() + bs - 1) // bs)[:, None]) & (tb < nb)
    tbc = torch.clamp(tb, max=nb - 1)
    pg = torch.gather(page_table.long(), 1, tbc).reshape(-1)
    vlen = torch.clamp(end.long()[:, None] - tbc * bs, 0, bs).reshape(-1)
    keep = (live.reshape(-1) & (pg > 0) & (pg < np_))[None]
    rows = torch.arange(layers, device=dev)[:, None] * np_ + pg[None]
    tgt = torch.where(keep, rows, torch.full_like(rows, -1))  # [L, B*NT]
    block_summary_routed(pool.reshape(layers * np_ * bs, hk, dh),
                         rows.reshape(-1), vlen.repeat(layers),
                         tgt.reshape(-1),
                         kmax_out.view(layers * np_, hk, dh),
                         kmin_out.view(layers * np_, hk, dh), bs)
    return kmax_out, kmin_out


# ---------------------------------------------------------------------------
# K5: RWKV-6 WKV recurrence
# ---------------------------------------------------------------------------

def wkv_batched(r, k, v, w, u, s0, n_valid):
    """The Finch recurrence for a batch of rows, one step per token:

        y_t = r_t (s + diag(u) k_t v_t^T),   s <- diag(w_t) s + k_t v_t^T

    r/k/v/w: [B, T, H, dk] fp32; u: [H, dk]; s0: [B, H, dk, dk] fp32;
    n_valid: [B] int, the valid prefix of each row.  Steps at or past
    ``n_valid`` still give ``y`` from their own k, v (as the reference's
    masked scan does) but leave the state as it was.  Returns
    (y [B, T, H, dk], s [B, H, dk, dk]) fp32."""
    t_len = r.shape[1]
    s = s0.float()
    uu = u.float()[None, :, :, None]
    ys = []
    for t in range(t_len):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]           # [B,H,dk,dk]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + uu * kv))
        s_new = w[:, t, :, :, None] * s + kv
        s = torch.where((t < n_valid)[:, None, None, None], s_new, s)
    return torch.stack(ys, dim=1), s


def wkv_ref(r, k, v, w, u, s0):
    """One row, the reference oracle's signature: r/k/v/w [T, H, dk];
    u [H, dk]; s0 [H, dk, dk].  Returns (y [T, H, dk], s [H, dk, dk])."""
    n = torch.full((1,), r.shape[0], dtype=torch.long, device=r.device)
    y, s = wkv_batched(r[None], k[None], v[None], w[None], u, s0[None], n)
    return y[0], s[0]
