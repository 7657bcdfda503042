"""Verification-step plumbing (counterpart of ``repro/core/verify.py``):
verify-input assembly, cache commits, tail-buffer writes and the
zero-copy partial refresh.

Per-row verify layout (fused step): ``[pend (p_eff) | tree (T) | pad]``
inside one width ``S = P + T``; refresh rows use the full pending width,
full/partial rows one pend slot.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, SpecPVConfig
from repro_torch.core.tree import TreeSpec, tree_tensors
from repro_torch.models.common import update_slice_rows
from repro_torch.models.dense import quest_block_scores, select_partial_blocks
from repro_torch.kvcache.cache import (paged_update_all_summaries,
                                       paged_write_tokens,
                                       update_layer_summaries)


def build_verify_inputs_fused(tree: TreeSpec, pending, pending_len, p_eff,
                              tree_tokens, seq_len):
    """pending [B, P]; pending_len [B] (<= p_eff); p_eff [B] in {1, P};
    tree_tokens [B, T]; seq_len [B].  Returns dict(tokens, positions
    [B, S], self_mask [B, S, S], q_valid, root_slot [B], node_slots
    [B, T], pend_valid [B, P])."""
    b, p = pending.shape
    t = tree.size
    s = p + t
    dev = pending.device
    p_eff = p_eff.long()[:, None]
    sidx = torch.arange(s, device=dev)[None]
    pend_q = sidx < p_eff
    tree_q = (sidx >= p_eff) & (sidx < p_eff + t)
    tidx = torch.clamp(sidx - p_eff, 0, t - 1)                # [B, S]
    pend_pad = torch.cat([pending, torch.zeros((b, t), dtype=pending.dtype,
                                               device=dev)], dim=1)
    tree_g = torch.gather(tree_tokens, 1, tidx)
    zero = torch.zeros_like(pend_pad)
    tokens = torch.where(pend_q, pend_pad,
                         torch.where(tree_q, tree_g.to(pend_pad.dtype), zero))
    pend_valid_w = pend_q & (sidx < pending_len.long()[:, None])
    _, depths, anc = tree_tensors(tree, dev)
    pend_pos = seq_len.long()[:, None] - pending_len.long()[:, None] + sidx
    node_pos = seq_len.long()[:, None] + depths[tidx]
    positions = torch.where(pend_q, pend_pos,
                            torch.where(tree_q, node_pos,
                                        torch.zeros_like(node_pos)))
    positions = torch.clamp(positions, min=0)
    anc_q = anc[tidx]                                         # [B, S, T]
    anc_qk = torch.gather(anc_q, 2, tidx[:, None, :].expand(b, s, s))
    causal = sidx[:, :, None] >= sidx[:, None, :]
    m_pp = causal & pend_valid_w[:, None, :] & pend_valid_w[:, :, None]
    m_tp = tree_q[:, :, None] & pend_valid_w[:, None, :]
    m_tt = tree_q[:, :, None] & tree_q[:, None, :] & anc_qk
    m = m_pp | m_tp | m_tt
    return dict(tokens=tokens, positions=positions, self_mask=m,
                q_valid=pend_valid_w | tree_q,
                root_slot=pending_len.long() - 1,
                node_slots=p_eff + torch.arange(t, device=dev)[None],
                pend_valid=pend_valid_w[:, :p])


def commit_slots(tree: TreeSpec, pend_valid, path_nodes, p):
    """Input slots to commit, compacted (valid pending first, then the
    accepted path).  ``p`` [B] is the per-row tree offset.  Returns
    (slots [B, P+D], slot_valid [B, P+D])."""
    b, pw = pend_valid.shape
    dev = pend_valid.device
    path_valid = path_nodes >= 0
    path_slots = p.long()[:, None] + torch.clamp(path_nodes, min=0)
    slots = torch.cat([torch.arange(pw, device=dev)[None].expand(b, pw),
                       path_slots], dim=1)
    valid = torch.cat([pend_valid, path_valid], dim=1)
    # stable compaction: valid entries to the front, order preserved
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    return torch.gather(slots, 1, order), torch.gather(valid, 1, order)


def gather_new_kv(new_kv, slots, slot_valid):
    """new_kv: (k, v) [L, B, S, Hk, Dh]; slots [B, W] -> [L, B, W, Hk, Dh]
    with invalid slots zeroed."""
    out = []
    for a in new_kv:
        l_, b, _, hk, dh = a.shape
        idx = slots[None, :, :, None, None].expand(l_, b, slots.shape[1],
                                                   hk, dh)
        g = torch.gather(a, 2, idx)
        out.append(torch.where(slot_valid[None, :, :, None, None], g,
                               torch.zeros_like(g)))
    return out[0], out[1]


def append_full_cache(cache: Dict, ck, cv, count, spec: SpecPVConfig):
    """Append compacted committed KV [L, B, W, Hk, Dh] (``count`` [B]
    valid entries) to the full cache and its summaries, in place; returns
    the cache dict with the advanced length.  All W entries are written;
    those beyond ``count`` land past the new length and are overwritten
    later, as in the reference."""
    length = cache["length"]
    new_len = length + count.to(length.dtype)
    num_layers = ck.shape[0]
    if "page_table" in cache:
        pt = cache["page_table"]
        blk = cache["k"].shape[2]
        n_touch = -(-ck.shape[2] // blk) + 1
        for i in range(num_layers):
            paged_write_tokens(cache["k"][i], pt, length, ck[i])
            paged_write_tokens(cache["v"][i], pt, length, cv[i])
        # nothing reads a summary before the commit ends: one K4 call
        # covers every layer
        paged_update_all_summaries(cache["kmax"], cache["kmin"], cache["k"],
                                   pt, length, new_len, n_touch)
    else:
        for i in range(num_layers):
            # the reference's dynamic_update_slice clamps the offset
            update_slice_rows(cache["k"][i], ck[i], length, axis=1)
            update_slice_rows(cache["v"][i], cv[i], length, axis=1)
            nkmax, nkmin = update_layer_summaries(
                cache["kmax"][i], cache["kmin"][i], cache["k"][i], length,
                new_len, spec.block_size)
            cache["kmax"][i] = nkmax
            cache["kmin"][i] = nkmin
    cache = dict(cache)
    cache["length"] = new_len
    return cache


def append_buffer(pkv_k, pkv_v, pkv_pos, body_len: int, buf_len, ck, cv,
                  positions, count):
    """Write committed approximate KV into the pkv tail buffer (returns
    new arrays; the inputs are left as they were).

    pkv_*: [L, B, Hk, P, Dh] / [L, B, Hk, P]; ck/cv: [L, B, W, Hk, Dh];
    positions [B, W]; buf_len/count [B].  The write offset
    ``body_len + buf_len`` is clamped to ``[0, P - W]`` as the
    reference's dynamic_update_slice does."""
    off = body_len + buf_len
    w = ck.shape[2]
    nk = update_slice_rows(pkv_k.clone(), ck.movedim(3, 2), off, axis=3,
                           batch_axis=1)
    nv = update_slice_rows(pkv_v.clone(), cv.movedim(3, 2), off, axis=3,
                           batch_axis=1)
    dev = positions.device
    posw = torch.where(torch.arange(w, device=dev)[None] < count[:, None],
                       positions, torch.full_like(positions, -1))
    l_, b_, hk = pkv_pos.shape[:3]
    posw_h = posw[None, :, None, :].expand(l_, b_, hk, w).to(pkv_pos.dtype)
    npos = update_slice_rows(pkv_pos.clone(), posw_h, off, axis=3,
                             batch_axis=1)
    return nk, nv, npos, buf_len + count


def refresh_partial_blocks(cfg: ModelConfig, spec: SpecPVConfig, queries,
                           q_weight, cache: Dict):
    """Zero-copy refresh: Quest scoring over the physical-page summaries
    gathered through the table, then sink + top-K + local selection.

    queries [L, B, T, H, Dh]; q_weight [B, T].  Returns [L, B, Hk, NS]
    int32 logical block ids (-1 for unused selection slots).  Paper
    scores with mean reduction go through the retrieval-score kernel
    (K3)."""
    from repro_torch.kernels import ops as kops
    use_kernel = (spec.use_pallas and spec.score_mode == "paper"
                  and spec.reduction == "mean")
    assert "page_table" in cache, "zero-copy refresh needs the paged cache"
    pt = cache["page_table"].long()
    out = []
    for i in range(queries.shape[0]):
        kmax_l = cache["kmax"][i][pt]
        kmin_l = cache["kmin"][i][pt]
        if use_kernel:
            scores = kops.retrieval_scores(queries[i], kmax_l, kmin_l,
                                           q_weight)
        else:
            scores = quest_block_scores(queries[i], kmax_l, kmin_l, q_weight,
                                        score_mode=spec.score_mode,
                                        reduction=spec.reduction)
        out.append(select_partial_blocks(spec, scores, cache["length"]))
    return torch.stack(out)
