"""All-gather-free sequence-parallel verification attention (counterpart of
``repro/distributed/cp_verify.py``), on ``torch.distributed``.

The full KV cache is split over the ranks of a process group by sequence:
rank ``r`` of ``n`` holds tokens ``[r*S_loc, (r+1)*S_loc)`` of every row,
as the reference's contiguous ``P(None, axis, ...)`` split does.  Nothing
KV-sized crosses between ranks:

  per rank:  attention over ONLY the locally resident tokens, through the
             verify kernel's contiguous form (K1,
             ``ops.contiguous_verify_attention``) at the shard's valid
             length -> fp32 softmax partials ``(m, l, acc)``
  combine:   ``psum_softmax_merge``: an all-reduce MAX of ``m``, then one
             all-reduce SUM of the rescaled ``l`` and ``acc`` packed into
             one ``[..., Dh + 1]`` fp32 tensor

The merge is exact (the flash-attention identity), so sharding the full
verify is lossless.  The caller builds the group (any backend: gloo stages
CUDA tensors through the host, NCCL runs one rank per card); these
functions never initialise one.  On CPU tensors ``ops`` runs the kernels'
plain versions, as everywhere in the port.

``merged_partials_bytes`` / ``gathered_blocks_bytes`` /
``verify_traffic_report`` are the reference's per-tick traffic model of
the two designs, with the same arithmetic.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.models import common as cm


# ---------------------------------------------------------------------------
# the softmax-partials merge (shared with cp_retrieval)
# ---------------------------------------------------------------------------

def psum_softmax_merge(m, l, acc, group=None):
    """Merge per-rank flash partials across ``group``.

    m/l: [..., T] running max / normaliser, acc: [..., T, Dh] weighted
    value sum, fp32.  A rank with no valid keys contributes the kernel's
    ``m = -1e30`` and zero ``l``/``acc``; its correction factor underflows
    to exactly 0, so empty ranks drop out of the merge.  Two collectives:
    an all-reduce MAX of ``m`` and one all-reduce SUM of ``l * corr`` and
    ``acc * corr`` packed together, ``B*H*T*(2 + Dh)`` floats in all (the
    traffic model's message).  Returns the combined attention output
    ``acc / l`` [..., T, Dh] fp32, the same on every rank."""
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_g)
    packed = torch.cat([acc * corr[..., None], (l * corr)[..., None]], dim=-1)
    dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=group)
    return packed[..., :-1] / torch.clamp(packed[..., -1:], min=1e-30)


# ---------------------------------------------------------------------------
# shard-local full verify (FULL / REFRESH modes)
# ---------------------------------------------------------------------------

def check_shard(k_loc, v_loc, block_size: int) -> int:
    """A rank's K/V shard [B, S_loc, Hk, Dh]: K1 reads it as a pool of
    whole blocks, so ``S_loc`` must be a multiple of the block.  Returns
    ``S_loc``."""
    if k_loc.dim() != 4 or tuple(v_loc.shape) != tuple(k_loc.shape):
        raise ValueError(f"K/V shards must be [B, S_loc, Hk, Dh] alike, got "
                         f"{tuple(k_loc.shape)} and {tuple(v_loc.shape)}")
    s_loc = k_loc.shape[1]
    if s_loc % block_size:
        raise ValueError(f"a shard of {s_loc} tokens is not a whole number "
                         f"of {block_size}-token blocks")
    return s_loc


def local_full_partials(q, k_loc, v_loc, length, shard_idx: int,
                        block_size: int):
    """One shard's softmax partials over its resident key range (the
    reference's ``_local_full_attention``): K1's contiguous form at the
    shard's valid length ``clamp(length - shard_idx*S_loc, 0, S_loc)``.
    q: [B, T, H, Dh]; k_loc/v_loc: [B, S_loc, Hk, Dh]; length: [B] global.
    Returns (m, l [B, H, T], acc [B, H, T, Dh]) fp32."""
    s_loc = check_shard(k_loc, v_loc, block_size)
    local = torch.clamp(length - shard_idx * s_loc, 0, s_loc)
    return ops.contiguous_verify_attention(q, k_loc, v_loc, local,
                                           block_size)


def cp_full_verify_attention(q, k_loc, v_loc, length, block_size: int,
                             group=None):
    """Sequence-parallel FULL-mode verify on this rank: q [B, T, H, Dh]
    replicated, this rank's shard k_loc/v_loc [B, S_loc, Hk, Dh] (rank
    ``dist.get_rank(group)`` holds tokens from ``rank * S_loc``), length
    [B] global.  Each rank attends only its resident keys (one K1 launch);
    one ``psum_softmax_merge`` combines the partials.  Returns [B, T, H,
    Dh] in q's dtype, the same on every rank."""
    check_shard(k_loc, v_loc, block_size)      # before the group is used
    m, l, acc = local_full_partials(q, k_loc, v_loc, length,
                                    dist.get_rank(group), block_size)
    out = psum_softmax_merge(m, l, acc, group)
    return out.transpose(1, 2).to(q.dtype)


def cp_full_verify_single(q, k_shards: Sequence, v_shards: Sequence, length,
                          block_size: int):
    """Every shard in one process: each shard's partials through
    ``local_full_partials``, merged with ``models.common``'s
    ``combine_attn_parts``.  What the ranks are held to; nothing on the
    path calls it."""
    parts = [local_full_partials(q, k, v, length, r, block_size)
             for r, (k, v) in enumerate(zip(k_shards, v_shards))]
    return cm.combine_attn_parts(parts, q.dtype)


# ---------------------------------------------------------------------------
# per-tick interconnect traffic model (merge vs gather)
# ---------------------------------------------------------------------------

def merged_partials_bytes(batch: int, q_tokens: int, num_heads: int,
                          head_dim: int, num_layers: int,
                          n_shards: int) -> int:
    """Interconnect bytes per tick for the partials merge.

    Each layer all-reduces one fp32 message of ``(m, l, acc)`` =
    ``B*H*T*(2 + Dh)`` floats per shard; a ring all-reduce moves
    ~``2*(n-1)/n`` of the message per link, so total link traffic is
    ``2*(n_shards - 1) * message`` per layer.  Zero when unsharded."""
    if n_shards <= 1:
        return 0
    msg = batch * num_heads * q_tokens * (2 + head_dim) * 4
    return 2 * (n_shards - 1) * msg * num_layers


def gathered_blocks_bytes(budget_blocks: int, block_size: int,
                          num_kv_heads: int, head_dim: int,
                          num_layers: int, n_shards: int,
                          kv_itemsize: int = 2) -> int:
    """Interconnect bytes per tick for the baseline design: all-gather
    the selected K/V blocks so every shard verifies against the whole
    selection.  Each shard must receive the ``(n-1)/n`` remote share of
    ``budget_blocks`` blocks (K and V), every layer."""
    if n_shards <= 1:
        return 0
    sel = budget_blocks * block_size * num_kv_heads * head_dim * 2 \
        * kv_itemsize * num_layers
    return (n_shards - 1) * sel


def verify_traffic_report(*, batch: int, q_tokens: int, num_heads: int,
                          num_kv_heads: int, head_dim: int,
                          num_layers: int, n_shards: int,
                          budget_blocks: int, block_size: int,
                          kv_itemsize: int = 2) -> dict:
    """Per-tick cross-shard traffic of the merge path vs the modelled
    gathered-block volume, plus their ratio."""
    merged = merged_partials_bytes(batch, q_tokens, num_heads, head_dim,
                                   num_layers, n_shards)
    gathered = gathered_blocks_bytes(budget_blocks, block_size,
                                     num_kv_heads, head_dim, num_layers,
                                     n_shards, kv_itemsize)
    return dict(merged_partials_bytes=merged,
                gathered_blocks_bytes=gathered,
                traffic_ratio=(gathered / merged) if merged else 0.0)
