"""Context-parallel SpecPV retrieval + partial verification attention
(counterpart of ``repro/distributed/cp_retrieval.py``), on
``torch.distributed``.

With the full KV cache split over the ranks by sequence, the selected
blocks stay rank-local:

  per rank:  score the local block summaries (paper eqs. 1-3, the
             retrieval-score kernel K3 with unit query weights)
          -> local top-(budget // ranks) selection (blocks without a
             valid token masked to -inf, ties to the lower index as
             ``jax.lax.top_k``)
          -> block-sparse attention over the local selection (K1's
             block-list form over the shard read as a pool)
  combine:   one ``psum_softmax_merge`` of the (m, l, acc) partials

The selection is the reference's: top-k per shard instead of a global
top-k, the standard distributed-top-k approximation.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import SpecPVConfig
from repro_torch.distributed.cp_verify import check_shard, psum_softmax_merge
from repro_torch.kernels import ops
from repro_torch.models import common as cm


def check_summaries(spec: SpecPVConfig, k_loc, v_loc, kmax_loc,
                    kmin_loc) -> int:
    """A rank's shard and its block summaries [B, S_loc / block, Hk, Dh]
    (the reference assumes both at ``cp_retrieval.py:44-47``).  Returns
    the shard's block count."""
    s_loc = check_shard(k_loc, v_loc, spec.block_size)
    nb_loc = s_loc // spec.block_size
    want = (k_loc.shape[0], nb_loc) + tuple(k_loc.shape[2:])
    for name, a in (("kmax", kmax_loc), ("kmin", kmin_loc)):
        if tuple(a.shape) != want:
            raise ValueError(f"{name} of the shard is {tuple(a.shape)}, "
                             f"expected {want} ({nb_loc} blocks of "
                             f"{spec.block_size})")
    return nb_loc


def local_selection(spec: SpecPVConfig, budget_local: int, q, kmax_loc,
                    kmin_loc, length, shard_idx: int):
    """One shard's retrieval: K3's Quest scores of its blocks (the mean
    over the head group, then over the query rows with unit weights: the
    reference's ``.mean(axis=(1, 3))``), blocks holding no valid token
    masked to -inf, and the top ``min(budget_local, NB_loc)`` by a stable
    descending sort (``jax.lax.top_k``'s tie order).  q: [B, T, H, Dh];
    kmax/kmin: [B, NB_loc, Hk, Dh]; length: [B] global.  Returns (idx, vlen)
    [B, Hk, k]: local block ids and their valid token counts."""
    b, t = q.shape[:2]
    nb_loc, hk = kmax_loc.shape[1], kmax_loc.shape[2]
    bs = spec.block_size
    dev = q.device
    blk_start = (shard_idx * nb_loc + torch.arange(nb_loc, device=dev)) * bs
    n_valid = torch.clamp(length[:, None] - blk_start[None], 0, bs)
    s = ops.retrieval_scores(q, kmax_loc.float().contiguous(),
                             kmin_loc.float().contiguous(),
                             torch.ones((b, t), dtype=torch.float32,
                                        device=dev))
    s = torch.where((n_valid > 0)[:, None, :], s,
                    torch.full_like(s, -float("inf")))
    k_sel = min(budget_local, nb_loc)
    idx = torch.sort(s, dim=-1, descending=True,
                     stable=True).indices[..., :k_sel]
    vlen = torch.gather(n_valid[:, None].expand(b, hk, nb_loc), -1, idx)
    return idx, vlen


def local_partial_partials(spec: SpecPVConfig, budget_local: int, q, k_loc,
                           v_loc, kmax_loc, kmin_loc, length,
                           shard_idx: int):
    """One shard's partials over its own selection (the reference's
    ``_local_partial_attention`` before the merge): ``local_selection``,
    then K1's block-list form over the shard read as a pool
    (``ops.flat_blocks``; row b's block j is pool block ``b * NB_loc +
    j``).  Returns (m, l [B, H, T], acc [B, H, T, Dh]) fp32 and the
    selection's local block ids [B, Hk, k]."""
    nb_loc = check_summaries(spec, k_loc, v_loc, kmax_loc, kmin_loc)
    idx, vlen = local_selection(spec, budget_local, q, kmax_loc, kmin_loc,
                                length, shard_idx)
    kf, _ = ops.flat_blocks(k_loc)
    vf, _ = ops.flat_blocks(v_loc)
    rows = torch.arange(q.shape[0], device=q.device)[:, None, None] * nb_loc
    m, l, acc = ops.block_attention(
        q, kf, vf, (idx + rows).to(torch.int32).contiguous(),
        vlen.to(torch.int32).contiguous(), spec.block_size)
    return m, l, acc, idx


def cp_partial_verify_attention(spec: SpecPVConfig, budget_blocks: int, q,
                                k_loc, v_loc, kmax_loc, kmin_loc, length,
                                group=None):
    """Context-parallel partial verification on this rank: q [B, T, H, Dh]
    replicated; this rank's shard k_loc/v_loc [B, S_loc, Hk, Dh] and its
    summaries kmax/kmin [B, S_loc / block, Hk, Dh] (rank ``r`` holds
    tokens from ``r * S_loc``); length [B] global.  Each rank selects
    ``max(1, budget_blocks // ranks)`` of its blocks (one K3 launch) and
    attends them (one K1 launch); one ``psum_softmax_merge`` combines the
    partials.  Returns [B, T, H, Dh] in q's dtype, the same on every
    rank."""
    # shapes are refused before the group is used
    check_summaries(spec, k_loc, v_loc, kmax_loc, kmin_loc)
    n = dist.get_world_size(group)
    m, l, acc, _ = local_partial_partials(
        spec, max(1, budget_blocks // n), q, k_loc, v_loc, kmax_loc,
        kmin_loc, length, dist.get_rank(group))
    out = psum_softmax_merge(m, l, acc, group)
    return out.transpose(1, 2).to(q.dtype)


def cp_partial_verify_single(spec: SpecPVConfig, budget_blocks: int, q,
                             k_shards: Sequence, v_shards: Sequence,
                             kmax_shards: Sequence, kmin_shards: Sequence,
                             length):
    """Every shard in one process, each with the ranks' budget
    ``max(1, budget_blocks // shards)``: each shard's partials through
    ``local_partial_partials``, merged with ``models.common``'s
    ``combine_attn_parts``.  Returns (out [B, T, H, Dh] in q's dtype, the
    list of each shard's selected block ids).  What the ranks are held
    to; nothing on the path calls it."""
    n = len(k_shards)
    parts, sels = [], []
    for r in range(n):
        m, l, acc, idx = local_partial_partials(
            spec, max(1, budget_blocks // n), q, k_shards[r], v_shards[r],
            kmax_shards[r], kmin_shards[r], length, r)
        parts.append((m, l, acc))
        sels.append(idx)
    return cm.combine_attn_parts(parts, q.dtype), sels
