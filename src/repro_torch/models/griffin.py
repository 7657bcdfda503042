"""Griffin / RecurrentGemma hybrid trunk [arXiv:2402.19427] (counterpart
of ``repro/models/griffin.py``).

Layer pattern ("rec", "rec", "attn"): two RG-LRU recurrent blocks per
local (sliding-window) attention layer; recurrentgemma-2b's 26 layers
are 8 superblocks and a (rec, rec) remainder.

* rec block: x branch linear -> causal depthwise conv1d(4) -> RG-LRU;
  gate branch linear -> gelu; their product -> out projection.
  RG-LRU:  r_t = sigma(x W_a + b_a),  i_t = sigma(x W_i + b_i)
           a_t = exp(-c * softplus(L) * r_t),           c = 8
           h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
* attn block: GQA (kv 1) over a sliding window of W keys, cached in a
  rolling window (slot = position mod W).

Forward modes: ``train`` (no state, windowed flash attention),
``advance`` (T tokens with a validity prefix, the state advanced: prefill
chunks and the commit after acceptance) and ``verify`` (read-only chain
verification).  The reference runs the RG-LRU as a ``lax.scan`` and the
window attention as plain jnp, so no kernel is on this path: the scan is
a plain step loop here (under autograd ``models.common.ckpt_chunked_scan``,
its segments recomputed in the backward pass), the attention the plain
``dense_attn_part``.

Params: ``embed`` [V, d], ``final_norm`` [d] and ``layers``, a list of
per-layer dicts in ``cfg.layer_kinds()`` order with the reference's keys
for their kind (the reference stacks each position of the pattern over
the superblocks and keeps the remainder apart: ``convert`` maps between
the two).  State: the reference's dict, ``rnn_h`` [Lr, B, w] fp32,
``conv`` [Lr, B, 3, w], ``win_k`` / ``win_v`` [La, B, W, Hk, Dh],
``win_pos`` [La, B, W] (-1: empty) and ``length`` [B], rec and attn
layers each counted in layer order.  Unlike the reference's functional
update, ``advance`` writes the state tensors in place, each layer after
its own reads, and returns the dict with the advanced length.

Under tensor parallelism (``forward(tp=...)``) each model shard runs its
columns of the recurrent blocks (one gather of the conv output for the
gates, one sum after ``wo``) and of the MLPs; the local attention and its
window run whole.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as bk
from repro_torch.models import common as cm
from repro_torch.models.dense import (  # noqa: F401  (re-exported)
    _feature_targets, embed_tokens, superblock_decomp)
from repro_torch.models.dense import lm_head as dense_lm_head

CONV_W = 4
RGLRU_C = 8.0


# ---------------------------------------------------------------------------
# params / state
# ---------------------------------------------------------------------------

def _rec_init(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    pd = cm.dt(cfg.param_dtype)
    dev = gen.device
    d = cfg.d_model
    w = cfg.rnn_width or d
    return {
        "ln1": torch.ones((d,), dtype=pd, device=dev),
        "wx": cm.dense_init(gen, (d, w), pd),
        "wgate": cm.dense_init(gen, (d, w), pd),
        "conv_w": cm.dense_init(gen, (CONV_W, w), pd),
        "conv_b": torch.zeros((w,), dtype=pd, device=dev),
        "wa": cm.dense_init(gen, (w, w), pd),
        "ba": torch.zeros((w,), dtype=pd, device=dev),
        "wi": cm.dense_init(gen, (w, w), pd),
        "bi": torch.zeros((w,), dtype=pd, device=dev),
        # fp32 whatever the param dtype, as in the reference
        "lam": torch.full((w,), 2.0, dtype=torch.float32, device=dev),
        "wo": cm.dense_init(gen, (w, d), pd),
        "ln2": torch.ones((d,), dtype=pd, device=dev),
        "mlp": bk.init_mlp_params(cfg, gen),
    }


def _attn_init(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    pd = cm.dt(cfg.param_dtype)
    dev = gen.device
    return {"ln1": torch.ones((cfg.d_model,), dtype=pd, device=dev),
            "attn": bk.init_attn_params(cfg, gen),
            "ln2": torch.ones((cfg.d_model,), dtype=pd, device=dev),
            "mlp": bk.init_mlp_params(cfg, gen)}


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Dict:
    """Random weights from ``seed`` (a ``torch.Generator`` on the target
    device) with the reference's zero biases and ``lam`` = 2."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pd = cm.dt(cfg.param_dtype)
    params: Dict[str, Any] = {
        "layers": [(_rec_init if kind == "rec" else _attn_init)(cfg, gen)
                   for kind in cfg.layer_kinds()],
        "embed": cm.embed_init(gen, (cfg.vocab_size, cfg.d_model), pd),
        "final_norm": torch.ones((cfg.d_model,), dtype=pd, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = cm.dense_init(gen, (cfg.d_model, cfg.vocab_size), pd)
    return params


def init_state(cfg: ModelConfig, batch: int, dtype, device,
               shards: int = 1) -> Dict:
    """The recurrent state and rolling windows; ``shards`` = m (tensor
    parallelism whose recurrent blocks split the width) stacks the model
    shards' ``rnn_h`` and ``conv`` on the layer axis ([m * Lr, B, (3,)
    w / m]); the windows stay whole (the local attention runs whole)."""
    kinds = cfg.layer_kinds()
    lr = sum(1 for k in kinds if k == "rec")
    la = sum(1 for k in kinds if k == "attn")
    w = cfg.rnn_width or cfg.d_model
    W = cfg.window_size
    hk, dh = cfg.num_kv_heads, cfg.head_dim_
    return {
        "rnn_h": torch.zeros((shards * lr, batch, w // shards),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((shards * lr, batch, CONV_W - 1, w // shards),
                            dtype=dtype, device=device),
        "win_k": torch.zeros((la, batch, W, hk, dh), dtype=dtype,
                             device=device),
        "win_v": torch.zeros((la, batch, W, hk, dh), dtype=dtype,
                             device=device),
        "win_pos": torch.full((la, batch, W), -1, dtype=torch.int32,
                              device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# rec block
# ---------------------------------------------------------------------------

def rglru_scan(a, g, h0):
    """h_t = a_t * h_{t-1} + g_t over the time axis: a, g [B, T, w] fp32,
    h0 [B, w] fp32.  Returns every h_t, [B, T, w].  Out of place when
    autograd records (the reference's ``ckpt_chunked_scan``); otherwise
    one ``addcmul`` per step into a time-major buffer."""
    if torch.is_grad_enabled() and (a.requires_grad or g.requires_grad):
        def step(s, x):
            s = x[0] * s + x[1]
            return s, s
        _, hs = cm.ckpt_chunked_scan(step, h0, (a.transpose(0, 1),
                                                g.transpose(0, 1)))
        return hs.transpose(0, 1)
    at = a.transpose(0, 1).contiguous()
    gt = g.transpose(0, 1).contiguous()
    hs = torch.empty_like(at)
    s = h0
    for t in range(at.shape[0]):
        s = torch.addcmul(gt[t], at[t], s, out=hs[t])
    return hs.transpose(0, 1)


def _rec_conv(p, x0, conv_st):
    """The x branch of the columns ``p`` holds (a layer's weights, or one
    model shard's pieces): x0 [B, T, d] through ``wx``, then the causal
    depthwise conv over [conv state | x]; and the gate branch.  Returns
    (the conv input [B, T+3, w_p], the gate, the conv output in fp32)."""
    t = x0.shape[1]
    xd = x0.dtype
    x = x0 @ p["wx"].to(xd)                                  # [B, T, w]
    # GELU: jax.nn.gelu's default is the tanh approximation, not erf
    gate = F.gelu(x0 @ p["wgate"].to(xd), approximate="tanh")
    # conv sum order: the reference's ((x0 w0 + x1 w1) + x2 w2) + x3 w3,
    # then the bias, in the activation dtype
    xin = torch.cat([conv_st.to(xd), x], dim=1)              # [B, T+3, w]
    cw = p["conv_w"].to(xd)
    conv = xin[:, 0:t] * cw[0]
    for i in range(1, CONV_W):
        conv = conv + xin[:, i:i + t] * cw[i]
    conv = conv + p["conv_b"].to(xd)
    # fp32 parts of the rec block: the gates and the recurrence run in
    # fp32 from the conv output
    return xin, gate, conv.float()


def _rec_scan(p, cf_all, cf, gate, xin, rnn_h, conv_st, n_valid,
              update: bool):
    """The RG-LRU of the columns ``p`` holds: its gates read the whole
    conv output ``cf_all`` [B, T, w] (``wa`` / ``wi`` widened to fp32,
    ``lam`` fp32), the recurrence its own columns ``cf``; then the output
    rows ``wo``.  Returns (the block's output part, new rnn_h, new conv
    state); the state as it was when not ``update``."""
    b = cf.shape[0]
    xd = gate.dtype
    r = torch.sigmoid(cf_all @ p["wa"].float() + p["ba"].float())
    i = torch.sigmoid(cf_all @ p["wi"].float() + p["bi"].float())
    lam = p["lam"].float()
    sp = torch.logaddexp(lam, torch.zeros_like(lam))         # softplus
    a = torch.exp(-RGLRU_C * sp[None, None] * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0)) * (i * cf)
    # every step runs; a row's state is its h at its last valid step
    # (padding is a suffix, so no valid step reads a padded one)
    hs = rglru_scan(a, gated, rnn_h.float())
    out = (hs.to(xd) * gate) @ p["wo"].to(xd)
    if not update:
        return out, rnn_h, conv_st
    dev = cf.device
    rows = torch.arange(b, device=dev)
    last = hs[rows, torch.clamp(n_valid.long() - 1, min=0)]
    rnn_new = torch.where((n_valid > 0)[:, None], last, rnn_h)
    # conv state: the last CONV_W - 1 *valid* inputs (the old state when
    # no token is valid)
    idx = ((CONV_W - 1) + n_valid.long()[:, None]
           - torch.arange(CONV_W - 1, 0, -1, device=dev)[None])
    conv_new = torch.gather(xin, 1, idx[..., None].expand(
        b, CONV_W - 1, xin.shape[-1]))
    return out, rnn_new, conv_new


def _rec_block(cfg: ModelConfig, lp, h, rnn_h, conv_st, n_valid,
               update: bool):
    """h: [B, T, d]; rnn_h: [B, w] fp32; conv_st: [B, 3, w]; n_valid: [B]
    valid prefix.  Returns (out, new rnn_h, new conv state); the state
    as it was when not ``update``."""
    x0 = cm.rmsnorm(h, lp["ln1"], cfg.norm_eps)
    xin, gate, cf = _rec_conv(lp, x0, conv_st)
    return _rec_scan(lp, cf, cf, gate, xin, rnn_h, conv_st, n_valid, update)


def _rec_block_tp(cfg: ModelConfig, tp, i: int, lp, h, rnn_hs, conv_sts,
                  n_valid, update: bool):
    """Layer ``i``'s recurrent block over the model shards of ``tp``: the
    norm once; each shard's columns of the x and gate branches and the
    conv (its slice of the conv state); one gather of the conv output,
    which the gates' ``wa`` / ``wi`` read whole; each shard's RG-LRU over
    its columns (its slice of ``rnn_h``) and its rows of ``wo``; one sum.
    Returns (out, [each shard's new rnn_h], [new conv state])."""
    x0 = cm.rmsnorm(h, lp["ln1"], cfg.norm_eps)
    ps = [sh.params["layers"][i] for sh in tp.shards]
    convs = [_rec_conv(p, x0, c) for p, c in zip(ps, conv_sts)]
    cf_all = tp.map_gather(lambda sh: convs[sh.index][2])
    outs = [_rec_scan(p, cf_all, cf, gate, xin, rh, cs, n_valid, update)
            for p, (xin, gate, cf), rh, cs in zip(ps, convs, rnn_hs,
                                                 conv_sts)]
    y = tp.map_reduce(lambda sh: outs[sh.index][0])
    return y, [o[1] for o in outs], [o[2] for o in outs]


# ---------------------------------------------------------------------------
# local attention with a rolling window cache
# ---------------------------------------------------------------------------

def rolling_write(win_k, win_v, win_pos, k_new, v_new, positions, valid):
    """Write the chunk's K/V [B, T, Hk, Dh] into the rolling windows
    [B, W, Hk, Dh] at slot ``position mod W``, in place.  Only valid
    tokens within W of the row's last valid position are written: a
    chunk longer than W hits a slot twice, and ``index_put_`` with
    duplicate indices is as undefined as XLA's scatter, so each slot
    keeps its one writer (the latest position; ``scatter_reduce`` amax
    of the token index, order-free) and the windows are rewritten with
    ``where``: no host sync and no data-dependent shape."""
    b, t = positions.shape
    W = win_k.shape[1]
    dev = positions.device
    slots = torch.remainder(positions.long(), W)
    maxp = torch.where(valid, positions, -1).amax(dim=1)
    keep = valid & (positions > maxp[:, None] - W)
    writer = torch.full((b, W + 1), -1, dtype=torch.long, device=dev)
    writer.scatter_reduce_(                 # column W: the dropped tokens
        1, torch.where(keep, slots, W),
        torch.arange(t, device=dev)[None].expand(b, t), reduce="amax")
    writer = writer[:, :W]
    hit = writer >= 0
    src = torch.clamp(writer, min=0)
    rows = torch.arange(b, device=dev)[:, None]
    for win, new in ((win_k, k_new), (win_v, v_new)):
        win.copy_(torch.where(hit[..., None, None],
                              new[rows, src].to(win.dtype), win))
    win_pos.copy_(torch.where(hit, positions[rows, src].to(win_pos.dtype),
                              win_pos))


def _attn_block(cfg: ModelConfig, lp, h, positions, win, valid, self_mask,
                inv_freq, mscale, update: bool):
    """Sliding-window attention; ``win`` = (k, v, pos) rolling window or
    None (train mode).  Returns the block's output."""
    x = cm.rmsnorm(h, lp["ln1"], cfg.norm_eps)
    q = bk.project_q(cfg, lp["attn"], x, positions, inv_freq, mscale)
    k_new, v_new = bk.project_kv(cfg, lp["attn"], x, positions, inv_freq,
                                 mscale)
    t = positions.shape[1]
    W = cfg.window_size
    if win is None:     # train: windowed flash over the sequence itself
        out = cm.flash_attention(q, k_new, v_new, q_positions=positions,
                                 kv_positions=positions, causal=True,
                                 window=W, chunk=min(512, max(128, t)))
        return bk.attn_output(cfg, lp["attn"], out)
    wk, wv, wpos = win
    # attention reads the old window: the context part masks on win_pos
    # (filled, causal, inside the window) ...
    pq = positions[:, None, :, None]
    wp = wpos[:, None, None, :]
    ok = (wp >= 0) & (wp < pq) & (wp > pq - W)
    part_ctx = cm.dense_attn_part(q, wk, wv, mask=ok)
    # ... the self part on the chain mask, the window and validity
    win_ok = pq - positions[:, None, None, :] < W
    sm = self_mask[:, None] & win_ok & valid[:, None, None, :]
    part_self = cm.dense_attn_part(q, k_new, v_new, mask=sm)
    out = cm.combine_attn_parts([part_ctx, part_self], h.dtype)
    if update:          # after both parts read the window
        rolling_write(wk, wv, wpos, k_new, v_new, positions, valid)
    return bk.attn_output(cfg, lp["attn"], out)


# ---------------------------------------------------------------------------
# trunk
# ---------------------------------------------------------------------------

def _train_layer(cfg: ModelConfig, kind: str, lp, h, positions, inv_freq,
                 mscale):
    """One layer of the train mode (no state): block, residual, MLP."""
    b = h.shape[0]
    if kind == "rec":
        w = cfg.rnn_width or cfg.d_model
        zeros_h = torch.zeros((b, w), dtype=torch.float32, device=h.device)
        zeros_c = torch.zeros((b, CONV_W - 1, w), dtype=h.dtype,
                              device=h.device)
        y, _, _ = _rec_block(cfg, lp, h, zeros_h, zeros_c, None, False)
    else:
        y = _attn_block(cfg, lp, h, positions, None, None, None, inv_freq,
                        mscale, False)
    h = h + y
    x2 = cm.rmsnorm(h, lp["ln2"], cfg.norm_eps)
    return h + bk.mlp_fwd(cfg, lp["mlp"], x2)


def forward(cfg: ModelConfig, params, tokens, positions, state, *,
            mode: str, valid=None, self_mask=None,
            collect_features: bool = True, tp=None):
    """``mode`` in {train, advance, verify}; tokens / positions [B, T];
    ``valid`` [B, T] a prefix of real tokens; ``self_mask`` [B, T, T]
    (default causal by position).  ``tp``
    (``distributed.tensor_parallel.TensorParallel``, the state modes,
    every model shard on one device): the embedding, the recurrent
    blocks' columns, the MLPs and the tied head split over its model
    shards (``_rec_block_tp``; the MLP as a dense one's), with ``rnn_h``
    and ``conv`` shard-stacked on the layer axis ([m * Lr, B, (3,) w /
    m], shard s's rec layer l at ``s * Lr + l``; ``init_state``'s
    ``shards``).  The local attention runs whole: its window stays
    unsplit.  Returns (h [B, T, d], features (low, mid, top) or None,
    state)."""
    kinds = cfg.layer_kinds()
    layers: List[Dict] = params["layers"]
    dev = tokens.device
    b, t = tokens.shape
    targets = _feature_targets(len(kinds))
    inv_freq = cm.rope_inv_freq_tensor(cfg, dev)
    mscale = cm.yarn_mscale(cfg)
    if valid is None:
        valid = torch.ones((b, t), dtype=torch.bool, device=dev)
    if self_mask is None:       # causal among the new tokens
        self_mask = positions[:, :, None] >= positions[:, None, :]
    update = mode == "advance"
    n_valid = valid.to(torch.int32).sum(dim=1, dtype=torch.int32)
    if tp is not None:
        if mode == "train":
            raise ValueError("tensor parallelism runs the state modes "
                             "(advance, verify), not train")
        tp.require_single_device()
    n_rec = sum(1 for k in kinds if k == "rec")
    # no embedding scale: the reference does not multiply by sqrt(d),
    # although the RecurrentGemma card does
    h = embed_tokens(cfg, params, tokens, tp)
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    feats = [None, None, None]
    r_i = a_i = 0
    for g, (kind, lp) in enumerate(zip(kinds, layers)):
        if mode == "train":
            args = (cfg, kind, lp, h, positions, inv_freq, mscale)
            h = (torch.utils.checkpoint.checkpoint(
                _train_layer, *args, use_reentrant=False) if remat
                else _train_layer(*args))
        else:
            if kind == "rec" and tp is not None and tp.rec_split:
                js = [sh.index * n_rec + r_i for sh in tp.shards]
                y, nrh, ncs = _rec_block_tp(
                    cfg, tp, g, lp, h, [state["rnn_h"][j] for j in js],
                    [state["conv"][j] for j in js], n_valid, update)
                if update:
                    for j, a, c in zip(js, nrh, ncs):
                        state["rnn_h"][j].copy_(a)
                        state["conv"][j].copy_(c)
                r_i += 1
            elif kind == "rec":
                y, nrh, ncs = _rec_block(cfg, lp, h, state["rnn_h"][r_i],
                                         state["conv"][r_i], n_valid, update)
                if update:
                    state["rnn_h"][r_i].copy_(nrh)
                    state["conv"][r_i].copy_(ncs)
                r_i += 1
            else:
                win = (state["win_k"][a_i], state["win_v"][a_i],
                       state["win_pos"][a_i])
                y = _attn_block(cfg, lp, h, positions, win, valid, self_mask,
                                inv_freq, mscale, update)
                a_i += 1
            h = h + y
            x2 = cm.rmsnorm(h, lp["ln2"], cfg.norm_eps)
            if tp is not None and tp.mlp_split:
                h = h + tp.map_reduce(lambda sh: bk.mlp_fwd(
                    sh.cfg, sh.params["layers"][g]["mlp"], x2))
            else:
                h = h + bk.mlp_fwd(cfg, lp["mlp"], x2)
        # features by global layer index: at 26 layers the top one is
        # the last remainder layer's
        if collect_features:
            for slot, tgt in enumerate(targets):
                if g == tgt:
                    feats[slot] = h
    out_feats = tuple(feats) if collect_features else None
    if not update:
        return h, out_feats, state
    new_state = dict(state)
    new_state["length"] = state["length"] + n_valid
    return h, out_feats, new_state


def lm_head(cfg: ModelConfig, params, h, tp=None):
    """Final norm and head (``models.dense.lm_head``: under ``tp`` the
    tied head is row-parallel over the width-split ``embed``)."""
    return dense_lm_head(cfg, params, h, tp)
