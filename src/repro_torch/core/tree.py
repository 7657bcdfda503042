"""Static draft-tree topology, tree and chain acceptance (counterpart of
``repro/core/tree.py``).  Nodes 0..T-1 are laid out level by level; the
root parent (the last accepted token) is not a node."""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.sampling import categorical


@dataclass(frozen=True)
class TreeSpec:
    branch: Tuple[int, ...]
    parents: Tuple[int, ...]        # -1 for level-0 nodes
    depths: Tuple[int, ...]
    level_slices: Tuple[Tuple[int, int], ...]   # [start, end) per level

    @property
    def size(self) -> int:
        return len(self.parents)

    @property
    def depth(self) -> int:
        return len(self.branch)

    @property
    def max_path(self) -> int:
        """Maximum accepted tokens per verify step (path + bonus)."""
        return self.depth + 1

    @classmethod
    def from_branch(cls, branch: Tuple[int, ...]) -> "TreeSpec":
        parents, depths, slices = [], [], []
        prev_level: list = [-1]
        start = 0
        for l, b in enumerate(branch):
            cur = []
            for p in prev_level:
                for _ in range(b):
                    cur.append(len(parents))
                    parents.append(p)
                    depths.append(l)
            slices.append((start, start + len(cur)))
            start += len(cur)
            prev_level = cur
        return cls(branch=tuple(branch), parents=tuple(parents),
                   depths=tuple(depths), level_slices=tuple(slices))

    @classmethod
    def chain(cls, depth: int) -> "TreeSpec":
        """A single-path draft of ``depth`` tokens (``branch = (1,) *
        depth``), which the state-arch engine verifies."""
        return cls.from_branch((1,) * depth)

    def ancestor_mask(self) -> np.ndarray:
        """[T, T] bool — mask[i, j] = node j is an ancestor of i or i==j."""
        t = self.size
        m = np.zeros((t, t), dtype=bool)
        for i in range(t):
            j = i
            while j != -1:
                m[i, j] = True
                j = self.parents[j]
        return m

    def parents_arr(self) -> np.ndarray:
        return np.asarray(self.parents, np.int64)

    def depths_arr(self) -> np.ndarray:
        return np.asarray(self.depths, np.int64)

    def chain_mask(self) -> np.ndarray:
        """[T] bool: the first node of every level.  ``from_branch`` lays
        children out first-child-first, so these nodes form the leftmost
        root-to-leaf chain, each its parent's rank-0 (top-1) candidate: a
        chain draft is this subset of the tree draft, and acceptance
        masked to it (``node_valid``) verifies a chain within the tree's
        layout, so chain and tree slots verify in one step."""
        m = np.zeros((self.size,), bool)
        for lo, _hi in self.level_slices:
            m[lo] = True
        return m


class TreeTensors(NamedTuple):
    parents: torch.Tensor       # [T] int64, -1 for level-0 nodes
    depths: torch.Tensor        # [T] int64
    anc: torch.Tensor           # [T, T] bool ancestor mask
    chain: torch.Tensor         # [T] bool chain mask


@functools.lru_cache(maxsize=None)
def tree_tensors(tree: TreeSpec, device: torch.device) -> TreeTensors:
    """The tree's index arrays on ``device``, built once per (tree,
    device): a step reads them with no host-to-device copy, which a CUDA
    graph capture would refuse.  Read-only."""
    return TreeTensors(torch.as_tensor(tree.parents_arr(), device=device),
                       torch.as_tensor(tree.depths_arr(), device=device),
                       torch.as_tensor(tree.ancestor_mask(), device=device),
                       torch.as_tensor(tree.chain_mask(), device=device))


def greedy_tree_accept(tree: TreeSpec, tree_tokens, logits, root_slot,
                       input_slots, node_valid=None):
    """Greedy (temperature-0) tree acceptance.

    tree_tokens [B, T]; logits [B, S, V]; root_slot [B]; input_slots
    [B, T]; node_valid [B, T] bool (optional): the nodes eligible per
    row (a row masked to ``TreeSpec.chain_mask`` accepts as a chain
    draft would; an invalid node's subtree is dead).  Returns
    (path_nodes [B, D] padded with -1, accept_len [B], bonus [B],
    bonus_parent_slot [B]).  ``torch.argmax`` returns the first maximal
    index, as ``jnp.argmax`` does."""
    b, t = tree_tokens.shape
    dev = logits.device
    argmax = torch.argmax(logits, dim=-1)                 # [B, S]
    root_slot = root_slot.long()
    input_slots = input_slots.long()
    tt = tree_tensors(tree, dev)
    parents, depths = tt.parents, tt.depths
    parents_b = torch.clamp(parents, min=0)[None].expand(b, t)
    parent_slot = torch.where(parents[None] >= 0,
                              torch.gather(input_slots, 1, parents_b),
                              root_slot[:, None])
    pred_at_parent = torch.gather(argmax, 1, parent_slot)
    match = tree_tokens.long() == pred_at_parent          # [B, T]
    if node_valid is not None:
        match = match & node_valid
    ok_cols = []
    for n in range(t):
        p = tree.parents[n]
        ok_cols.append(match[:, n] if p < 0 else (match[:, n] & ok_cols[p]))
    ok = torch.stack(ok_cols, dim=1)
    node_score = torch.where(ok, depths[None] + 1, torch.zeros_like(ok,
                                                                  dtype=torch.long))
    best = torch.argmax(node_score, dim=1)
    accept_len = node_score.amax(dim=1)
    d = tree.depth
    path = torch.full((b, d), -1, dtype=torch.long, device=dev)
    cur = torch.where(accept_len > 0, best, torch.full_like(best, -1))
    for level in range(d - 1, -1, -1):
        cc = torch.clamp(cur, min=0)
        at_level = (cur >= 0) & (depths[cc] == level)
        path[:, level] = torch.where(at_level, cur, path[:, level])
        cur = torch.where(at_level, parents[cc], cur)
    bonus_parent = torch.where(
        accept_len > 0, torch.gather(input_slots, 1, best[:, None])[:, 0],
        root_slot)
    bonus = torch.gather(argmax, 1, bonus_parent[:, None])[:, 0]
    return path, accept_len, bonus, bonus_parent


def _chain_bonus_parent(accept_len, root_slot, input_slots):
    """The slot whose prediction gives the bonus: the last accepted
    node's, or the root's when nothing was accepted."""
    last = torch.clamp(accept_len - 1, min=0)[:, None]
    return torch.where(accept_len > 0,
                       torch.gather(input_slots, 1, last)[:, 0], root_slot)


def chain_accept_greedy(chain_tokens, logits, root_slot, input_slots):
    """Greedy acceptance of a chain draft (branch 1 everywhere).

    chain_tokens [B, T]; logits [B, S, V]; slots as in tree acceptance.
    Returns (accept_len [B], bonus [B], bonus_parent_slot [B])."""
    argmax = torch.argmax(logits, dim=-1)
    root_slot, input_slots = root_slot.long(), input_slots.long()
    prev = torch.cat([root_slot[:, None], input_slots[:, :-1]], dim=1)
    match = chain_tokens.long() == torch.gather(argmax, 1, prev)
    accept_len = torch.cumprod(match.long(), dim=1).sum(dim=1)
    bonus_parent = _chain_bonus_parent(accept_len, root_slot, input_slots)
    bonus = torch.gather(argmax, 1, bonus_parent[:, None])[:, 0]
    return accept_len, bonus, bonus_parent


def chain_accept_sampling(chain_tokens, draft_logprobs, logits, root_slot,
                          input_slots, u, u_bonus, temperature: float = 1.0,
                          draft_logits=None):
    """Lossless speculative sampling of a chain draft (Leviathan et al.
    2023): candidate i is accepted when log u_i < log p(t_i) - log
    q(t_i), and the run stops at the first rejection.

    draft_logprobs [B, T] = log q(t_i); u [B, T] and u_bonus [B] are the
    acceptance and bonus uniforms.  With ``draft_logits`` [B, T, V] (the
    distributions the candidates were drawn from) the bonus after a
    rejection comes from the exact residual norm(max(p - q, 0)), so the
    output is distributed as the target's; without it the bonus samples
    the target at the bonus parent (exact only when every candidate is
    accepted).  Returns (accept_len, bonus, bonus_parent_slot)."""
    b, t = chain_tokens.shape
    root_slot, input_slots = root_slot.long(), input_slots.long()
    temp = max(temperature, 1e-6)
    logp = torch.log_softmax(logits.float() / temp, dim=-1)
    prev = torch.cat([root_slot[:, None], input_slots[:, :-1]], dim=1)
    lp_prev = torch.gather(logp, 1, prev[..., None].expand(
        -1, -1, logp.shape[-1]))                          # [B, T, V]
    p_tok = torch.gather(lp_prev, 2, chain_tokens.long()[..., None])[..., 0]
    ok = torch.log(torch.clamp(u, min=1e-30)) < (p_tok - draft_logprobs)
    accept_len = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    bonus_parent = _chain_bonus_parent(accept_len, root_slot, input_slots)
    p_bp = torch.exp(torch.gather(logp, 1, bonus_parent[:, None, None].expand(
        -1, 1, logp.shape[-1]))[:, 0])                    # [B, V]
    p_final = p_bp
    if draft_logits is not None:
        # the exact residual at the first rejected position r: the bonus
        # parent is the slot r was verified against, q_r the distribution
        # r was drawn from
        q_all = torch.softmax(draft_logits.float() / temp, dim=-1)
        r = torch.clamp(accept_len, max=t - 1)
        q_r = torch.gather(q_all, 1, r[:, None, None].expand(
            -1, 1, q_all.shape[-1]))[:, 0]
        res = torch.clamp(p_bp - q_r, min=0.0)
        res = res / torch.clamp(res.sum(-1, keepdim=True), min=1e-30)
        p_final = torch.where((accept_len < t)[:, None], res, p_bp)
    return accept_len, categorical(p_final, u_bonus), bonus_parent
