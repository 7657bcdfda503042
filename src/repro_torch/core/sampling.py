"""Lossless speculative sampling over draft trees (counterpart of
``repro/core/sampling.py``) and the per-slot random streams it draws
from.

**Streams.** A slot's stream is a Threefry-2x32 key ``[2]`` (two 32-bit
words held in int64, so every add, xor and rotate stays exact in torch
integer ops, on the CPU and on the card alike: the same bits on both).
``seed_keys`` derives a request's keys from its seed and row index
alone; ``stream_draws`` turns a key into its successor (counter 0) and
``n`` uniforms (counters 1..n), one hash call for all of a step's
draws.  The engine keeps the keys in its state and advances only the
rows that sampled, so a slot's draws depend on nothing but its seed
and how many sampled steps it took.  The port does not reproduce JAX's
bit stream; its checks against the reference are by distribution, or
with the reference's uniforms passed in (the functions below take
their uniforms as tensors).

**Draws.** ``draw`` inverts the cumulative distribution with one
uniform per draw (at llama width, Gumbel noise over the vocabulary
would cost a hash per token per draw), in two levels: chunks of 128
tokens, then a token inside the chosen chunk.  A token of probability 0
is never drawn: its cumulative value repeats its predecessor's exactly.

**Tree acceptance** (SpecInfer's multi-round rejection; Leviathan et al.
for chains).  For a node whose candidate children c_1..c_k were drawn
i.i.d. from its draft distribution q: accept c_i with probability
min(1, p(c_i) / q(c_i)) and recurse; on a rejection p <- norm(max(p - q,
0)); when no child is accepted, the bonus token is drawn from the final
p.  The emitted tokens are then distributed as the target's, whatever
the draft.
"""
from __future__ import annotations

from typing import Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011, as in Random123
    and JAX's ``threefry_2x32``) over int64 tensors holding 32-bit
    words: key (k0, k1), counter (c0, c1) -> two words.  Every sum is
    masked back to 32 bits and a shifted word stays below 2**61, so
    nothing overflows int64."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & _MASK
    x1 = (c1 + ks[1]) & _MASK
    for i in range(20):
        r = _ROTATIONS[i % 8]
        x0 = (x0 + x1) & _MASK
        x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        if i % 4 == 3:
            s = i // 4 + 1
            x0 = (x0 + ks[s % 3]) & _MASK
            x1 = (x1 + ks[(s + 1) % 3] + s) & _MASK
    return x0, x1


def _hash(keys, counters):
    """keys [B, 2], counters [C] -> words (y0, y1) [B, C] each."""
    c = counters[None]
    return threefry2x32(keys[:, :1], keys[:, 1:], c, torch.zeros_like(c))


def seed_keys(seed: int, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A request's keys for ``b`` rows, on the CPU: (first [b, 2], the
    first token's draw; stream [b, 2], the decode stream).  They depend
    on (seed, row) alone, so a request draws the same whether it boots
    by prefill or from a tail entry, alone or beside others."""
    seed = int(seed) & ((1 << 64) - 1)
    base = torch.tensor([[seed >> 32, seed & _MASK]], dtype=torch.long)
    r0, r1 = _hash(base, torch.arange(b))                   # [1, b] each
    y0, y1 = _hash(torch.stack([r0[0], r1[0]], dim=-1), torch.arange(2))
    first = torch.stack([y0[:, 0], y1[:, 0]], dim=-1)
    stream = torch.stack([y0[:, 1], y1[:, 1]], dim=-1)
    return first, stream


def stream_draws(keys, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of each row's stream: (the next keys [B, 2], ``n``
    uniforms [B, n] in [0, 1) with 24 bits each, exact in fp32)."""
    y0, y1 = _hash(keys, torch.arange(n + 1, device=keys.device))
    nxt = torch.stack([y0[:, 0], y1[:, 0]], dim=-1)
    u = (y0[:, 1:] >> 8).float() * (1.0 / (1 << 24))
    return nxt, u


_CHUNK = 128


def _monotone_cdf(w):
    """The cumulative sums of ``w`` [..., N] (non-negative) along the last
    axis, with each zero entry's value replaced by its predecessor's (a
    running maximum): a parallel scan need not repeat a partial sum
    exactly at a zero, and a search must never stop on one."""
    cdf = torch.cumsum(w, dim=-1)
    cdf = torch.where(w > 0, cdf, torch.zeros_like(cdf))
    return torch.cummax(cdf, dim=-1).values.contiguous()


def _search(cdf, t):
    """The first index whose ``cdf`` [..., N] value exceeds ``t`` [..., K],
    or, for a target that rounds to the total, the index of the last
    positive entry."""
    total = cdf[..., -1:].contiguous()
    return torch.minimum(torch.searchsorted(cdf, t.contiguous(), right=True),
                         torch.searchsorted(cdf, total))


def draw(probs, u):
    """K draws from each row of ``probs`` [..., V] (non-negative, not
    necessarily normalised) at the uniforms ``u`` [..., K] in [0, 1), by
    inverting the cumulative distribution in two levels: the chunk of
    128 tokens whose cumulative mass passes u times the total, then the
    token inside it (one short scan over the chunk sums and one over the
    chosen chunk, instead of a scan over the vocabulary).  A token of
    probability 0 is never drawn.  Returns int64 [..., K]."""
    v = probs.shape[-1]
    pad = -v % _CHUNK
    if pad:
        probs = torch.nn.functional.pad(probs, (0, pad))
    chunks = probs.reshape(probs.shape[:-1] + (-1, _CHUNK))  # [..., NC, C]
    ccdf = _monotone_cdf(chunks.sum(-1))                     # [..., NC]
    t = u * ccdf[..., -1:]
    j = _search(ccdf, t)                                     # [..., K]
    before = torch.where(j > 0, torch.gather(
        ccdf, -1, torch.clamp(j - 1, min=0)), torch.zeros_like(t))
    inner = torch.gather(chunks, -2, j[..., None].expand(
        j.shape + (_CHUNK,)))                                # [..., K, C]
    i = _search(_monotone_cdf(inner), (t - before)[..., None])[..., 0]
    return j * _CHUNK + i


def categorical(probs, u):
    """One draw per row of ``probs`` [..., V] at ``u`` [...]: int64 [...]."""
    return draw(probs, u[..., None])[..., 0]


def _norm(p):
    return p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)


def tree_speculative_sample(tree, tree_tokens, draft_logits, target_logits,
                            root_slot, node_slots, u, u_bonus,
                            temperature=1.0, node_valid=None):
    """Stochastic tree verification, batched over B (the reference maps a
    per-row function over the batch).

    tree_tokens [B, T]; draft_logits [B, T+1, V] (entry 0 the root
    parent's draft distribution, entry 1+n node n's); target_logits
    [B, S, V] over the whole verify input; root_slot [B]; node_slots
    [B, T]; u [B, T]: node n's acceptance uniform (the reference draws
    it from ``jax.random.split(row_key, T + 1)[n]``); u_bonus [B];
    temperature a scalar or [B]; node_valid [B, T] bool (optional):
    candidates eligible per row (masked to ``TreeSpec.chain_mask`` it
    reduces to chain acceptance).  Only the root's and the nodes' target
    rows are softmaxed.  The reference walks every node of each level
    and skips those whose parent is not the row's current node; here
    each level tries only the current node's children, rank by rank (a
    node's children are consecutive in ``TreeSpec.from_branch``'s
    layout), with the same arithmetic in the same order.  Returns (path
    [B, depth] node ids padded with -1, accept_len [B], bonus [B])."""
    b, t = tree_tokens.shape
    dev = tree_tokens.device
    temps = (temperature.float() if torch.is_tensor(temperature)
             else torch.full((b,), float(temperature), device=dev))
    temps = torch.clamp(temps.expand(b), min=1e-6)[:, None, None]
    slots = torch.cat([root_slot[:, None], node_slots], dim=1).long()
    lg = torch.gather(target_logits, 1, slots[..., None].expand(
        -1, -1, target_logits.shape[-1]))
    p_all = torch.softmax(lg.float() / temps, dim=-1)        # [B, T+1, V]
    q_all = torch.softmax(draft_logits.float() / temps, dim=-1)
    tokens = tree_tokens.long()
    rows = torch.arange(b, device=dev)
    p_cur, q_cur = p_all[:, 0], q_all[:, 0]
    path = torch.full((b, tree.depth), -1, dtype=torch.long, device=dev)
    acc = torch.zeros((b,), dtype=torch.long, device=dev)
    cur = torch.full((b,), -1, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for level, (lo, _hi) in enumerate(tree.level_slices):
        bfac = tree.branch[level]
        # the current node's first child (a done row's index is in range
        # and never tried)
        plo = tree.level_slices[level - 1][0] if level else 0
        first = lo + torch.clamp(cur - plo, min=0) * bfac
        taken = torch.zeros((b,), dtype=torch.bool, device=dev)
        for r in range(bfac):
            n = first + r
            tried = ~taken & ~done
            if node_valid is not None:
                tried = tried & node_valid[rows, n]
            tok = tokens[rows, n][:, None]
            ratio = (torch.gather(p_cur, 1, tok)[:, 0]
                     / torch.clamp(torch.gather(q_cur, 1, tok)[:, 0],
                                   min=1e-30))
            accept = tried & (u[rows, n] < ratio)
            rej = tried & ~accept
            path[:, level] = torch.where(accept, n, path[:, level])
            acc = torch.where(accept, level + 1, acc)
            cur = torch.where(accept, n, cur)
            # on a rejection the residual; q stays (the children are
            # i.i.d. draws from it)
            res = _norm(torch.clamp(p_cur - q_cur, min=0.0))
            p_cur = torch.where(rej[:, None], res,
                                torch.where(accept[:, None],
                                            p_all[rows, 1 + n], p_cur))
            q_cur = torch.where(accept[:, None], q_all[rows, 1 + n], q_cur)
            taken = taken | accept
        done = done | ~taken
    return path, acc, categorical(p_cur, u_bonus)
