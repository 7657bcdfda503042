"""Verification-step plumbing (counterpart of ``repro/core/verify.py``):
verify-input assembly, cache commits, tail-buffer writes and the partial
refresh (zero-copy: the selected block ids; gathered: the selected
blocks' bytes too).

Verify layouts: one mode for every row, ``[pend (P) | tree (T)]``
(``build_verify_inputs``, the launch steps'); the fused step's per-row
``[pend (p_eff) | tree (T) | pad]`` inside one width ``S = P + T``,
refresh rows with the full pending width, full/partial rows one pend
slot (``build_verify_inputs_fused``, the engine's).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, SpecPVConfig
from repro_torch.core.tree import TreeSpec, tree_tensors
from repro_torch.models.common import update_slice_rows
from repro_torch.models.dense import (body_positions, gather_partial_body,
                                      quest_block_scores,
                                      select_partial_blocks,
                                      uses_score_kernel)
from repro_torch.kvcache.cache import (contiguous_update_all_summaries,
                                       paged_update_all_summaries,
                                       paged_write_tokens,
                                       update_layer_summaries)


def build_verify_inputs(tree: TreeSpec, pending, pending_len, tree_tokens,
                        seq_len, active=None):
    """The verify input of a step in one mode: pending [B, P]
    left-aligned (P = 1 for a Full or Partial step); pending_len [B]
    (>= 1); tree_tokens [B, T]; seq_len [B] tokens accepted so far;
    active: optional [B] bool (a dead row gets an all-False self mask and
    no valid pending or query).  Returns dict(tokens, positions [B, S],
    self_mask [B, S, S], q_valid [B, S], root_slot [B], node_slots
    [B, T], pend_valid [B, P]) with S = P + T."""
    b, p = pending.shape
    t = tree.size
    dev = pending.device
    tokens = torch.cat([pending, tree_tokens.to(pending.dtype)], dim=1)
    pend_valid = (torch.arange(p, device=dev)[None]
                  < pending_len.long()[:, None])
    valid = torch.cat([pend_valid, torch.ones((b, t), dtype=torch.bool,
                                              device=dev)], dim=1)
    if active is not None:
        pend_valid = pend_valid & active[:, None]
        valid = valid & active[:, None]
    tt = tree_tensors(tree, dev)
    pend_pos = (seq_len.long()[:, None] - pending_len.long()[:, None]
                + torch.arange(p, device=dev)[None])
    node_pos = seq_len.long()[:, None] + tt.depths[None]
    positions = torch.clamp(torch.cat([pend_pos, node_pos], dim=1), min=0)
    pidx = torch.arange(p, device=dev)
    m_pp = ((pidx[None, :, None] >= pidx[None, None, :])
            & pend_valid[:, None, :] & pend_valid[:, :, None])
    m_tp = pend_valid[:, None, :].expand(b, t, p)
    m_tt = tt.anc[None].expand(b, t, t)
    m = torch.cat([torch.cat([m_pp, torch.zeros((b, p, t), dtype=torch.bool,
                                                device=dev)], dim=2),
                   torch.cat([m_tp, m_tt], dim=2)], dim=1)
    if active is not None:
        m = m & active[:, None, None]
    return dict(tokens=tokens, positions=positions, self_mask=m,
                q_valid=valid, root_slot=pending_len.long() - 1,
                node_slots=(p + torch.arange(t, device=dev))[None].expand(
                    b, t),
                pend_valid=pend_valid)


def build_verify_inputs_fused(tree: TreeSpec, pending, pending_len, p_eff,
                              tree_tokens, seq_len, active=None):
    """pending [B, P]; pending_len [B] (<= p_eff); p_eff [B] in {1, P};
    tree_tokens [B, T]; seq_len [B]; active: optional [B] bool (a dead
    serving slot gets an all-False self mask, no valid pending and no
    valid query, as in the reference).  Returns dict(tokens, positions
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
    if active is not None:
        pend_valid_w = pend_valid_w & active[:, None]
    tt = tree_tensors(tree, dev)
    depths, anc = tt.depths, tt.anc
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
    q_valid = pend_valid_w | tree_q
    if active is not None:
        m = m & active[:, None, None]
        q_valid = q_valid & active[:, None]
    return dict(tokens=tokens, positions=positions, self_mask=m,
                q_valid=q_valid,
                root_slot=pending_len.long() - 1,
                node_slots=p_eff + torch.arange(t, device=dev)[None],
                pend_valid=pend_valid_w[:, :p])


def commit_slots(tree: TreeSpec, pend_valid, path_nodes, p):
    """Input slots to commit, compacted (valid pending first, then the
    accepted path).  ``p`` is the tree offset: an int for the one-mode
    layout, [B] per row for the fused one.  Returns (slots [B, P+D],
    slot_valid [B, P+D])."""
    b, pw = pend_valid.shape
    dev = pend_valid.device
    path_valid = path_nodes >= 0
    p = p.long()[:, None] if torch.is_tensor(p) else int(p)
    path_slots = p + torch.clamp(path_nodes.long(), min=0)
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


def commit_write_extent(pmax: int, tree_depth: int) -> int:
    """Full-cache tokens one verify commit can touch past the current
    length: the compacted window (pending, at most ``pmax``, then the
    accepted path, at most ``tree_depth``), all of it written.  The
    copy-on-write horizon of ``SpecPVEngine.prepare_cow``."""
    return pmax + tree_depth


def write_cache_rows(buf, new, start):
    """``buf[l, b, start[b]:start[b] + W] = new[l, b]`` in place for a
    contiguous cache tensor [L, B, S, ...] (K, V or their scales), every
    layer in one write ([L, B] merged into the batch axis); the offset is
    clamped as the reference's dynamic_update_slice."""
    update_slice_rows(buf.view((-1,) + buf.shape[2:]), new.flatten(0, 1),
                      start.repeat(buf.shape[0]), axis=1)


def append_full_cache(cache: Dict, ck, cv, count, spec: SpecPVConfig,
                      plain: bool = False):
    """Append compacted committed KV [L, B, W, Hk, Dh] (``count`` [B]
    valid entries) to the full cache and its summaries, in place; returns
    the cache dict with the advanced length.  All W entries are written;
    those beyond ``count`` land past the new length and are overwritten
    later, as in the reference.  Nothing reads a summary before the
    commit ends, so one block-summary (K4) call covers every layer;
    ``plain`` (the oracle's route, contiguous only) recomputes them with
    the plain per-layer version instead."""
    length = cache["length"]
    new_len = length + count.to(length.dtype)
    num_layers, b, w = ck.shape[:3]
    n_touch = -(-w // spec.block_size) + 1
    if "page_table" in cache:
        pt = cache["page_table"]
        for i in range(num_layers):
            paged_write_tokens(cache["k"][i], pt, length, ck[i])
            paged_write_tokens(cache["v"][i], pt, length, cv[i])
        paged_update_all_summaries(cache["kmax"], cache["kmin"], cache["k"],
                                   pt, length, new_len, n_touch)
    else:
        write_cache_rows(cache["k"], ck, length)
        write_cache_rows(cache["v"], cv, length)
        if plain:
            for i in range(num_layers):
                nkmax, nkmin = update_layer_summaries(
                    cache["kmax"][i], cache["kmin"][i], cache["k"][i],
                    length, new_len, spec.block_size)
                cache["kmax"][i] = nkmax
                cache["kmin"][i] = nkmin
        else:
            contiguous_update_all_summaries(cache["kmax"], cache["kmin"],
                                            cache["k"], length, new_len,
                                            spec.block_size, n_touch)
    cache = dict(cache)
    cache["length"] = new_len
    return cache


def append_buffer(pkv_k, pkv_v, pkv_pos, body_len: int, buf_len, ck, cv,
                  positions, count):
    """Write committed approximate KV into the pkv tail buffer (returns
    new arrays; the inputs are left as they were): ``append_buffer_`` on
    copies."""
    nk, nv, npos = pkv_k.clone(), pkv_v.clone(), pkv_pos.clone()
    append_buffer_(nk, nv, npos, body_len, buf_len.clone(), ck, cv,
                   positions, count)
    return nk, nv, npos, buf_len + count


def append_buffer_(pkv_k, pkv_v, pkv_pos, body_len: int, buf_len, ck, cv,
                   positions, count):
    """``append_buffer`` in place: the buffers and ``buf_len`` (advanced
    by ``count``) are written where they live and returned, so a launch
    step's state keeps its addresses (the reference's launchers donate
    it).

    pkv_*: [L, B, Hk, P, Dh] / [L, B, Hk, P]; ck/cv: [L, B, W, Hk, Dh]
    (cast to the buffer's dtype); positions [B, W]; buf_len/count [B].
    The write offset ``body_len + buf_len`` is clamped to ``[0, P - W]``
    as the reference's dynamic_update_slice does."""
    off = body_len + buf_len
    w = ck.shape[2]
    update_slice_rows(pkv_k, ck.movedim(3, 2), off, axis=3, batch_axis=1)
    update_slice_rows(pkv_v, cv.movedim(3, 2), off, axis=3, batch_axis=1)
    dev = positions.device
    posw = torch.where(torch.arange(w, device=dev)[None] < count[:, None],
                       positions, torch.full_like(positions, -1))
    l_, b_, hk = pkv_pos.shape[:3]
    posw_h = posw[None, :, None, :].expand(l_, b_, hk, w).to(pkv_pos.dtype)
    update_slice_rows(pkv_pos, posw_h, off, axis=3, batch_axis=1)
    buf_len.add_(count.to(buf_len.dtype))
    return pkv_k, pkv_v, pkv_pos, buf_len


def refresh_partial_blocks(cfg: ModelConfig, spec: SpecPVConfig, queries,
                           q_weight, cache: Dict):
    """Quest scoring over the block summaries (the physical-page ones
    gathered through the table, or the contiguous cache's), then sink +
    top-K + local selection: the refresh of both partial forms.

    queries [L, B, T, H, Dh]; q_weight [B, T].  Returns [L, B, Hk, NS]
    int32 logical block ids (-1 for unused selection slots)."""
    from repro_torch.kernels import ops as kops
    use_kernel = uses_score_kernel(spec)
    pt = (cache["page_table"].long() if "page_table" in cache else None)
    out = []
    for i in range(queries.shape[0]):
        kmax_l, kmin_l = cache["kmax"][i], cache["kmin"][i]
        if pt is not None:
            kmax_l, kmin_l = kmax_l[pt], kmin_l[pt]
        if use_kernel:
            scores = kops.retrieval_scores(queries[i], kmax_l, kmin_l,
                                           q_weight)
        else:
            scores = quest_block_scores(queries[i], kmax_l, kmin_l, q_weight,
                                        score_mode=spec.score_mode,
                                        reduction=spec.reduction)
        out.append(select_partial_blocks(spec, scores, cache["length"]))
    return torch.stack(out)


def refresh_partial_from_queries(cfg: ModelConfig, spec: SpecPVConfig,
                                 queries, q_weight, cache: Dict):
    """The reference's gathered refresh: score, select and gather the
    partial body of every layer from the contiguous cache or through
    the page table.  Returns (pk, pv, ppos) [L, B, Hk, P, Dh] x2 and
    [L, B, Hk, P] (P = the partial budget; invalid slots at pos -1), the
    reference's layout; the engine keeps the body token-major instead
    (``gather_partial_body``)."""
    idx = refresh_partial_blocks(cfg, spec, queries, q_weight, cache)
    bk_, bv_ = gather_partial_body(spec, idx, cache["k"], cache["v"],
                                   cache.get("page_table"))
    pos = torch.stack([body_positions(spec, idx[i], cache["length"])
                       for i in range(idx.shape[0])])
    return bk_.transpose(2, 3), bv_.transpose(2, 3), pos
