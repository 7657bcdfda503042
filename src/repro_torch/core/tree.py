"""Static draft-tree topology + greedy tree acceptance (counterpart of
``repro/core/tree.py``).  Nodes 0..T-1 are laid out level by level; the
root parent (the last accepted token) is not a node."""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch


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


class TreeTensors(NamedTuple):
    parents: torch.Tensor       # [T] int64, -1 for level-0 nodes
    depths: torch.Tensor        # [T] int64
    anc: torch.Tensor           # [T, T] bool ancestor mask


@functools.lru_cache(maxsize=None)
def tree_tensors(tree: TreeSpec, device: torch.device) -> TreeTensors:
    """The tree's index arrays on ``device``, built once per (tree,
    device): a step reads them with no host-to-device copy, which a CUDA
    graph capture would refuse.  Read-only."""
    return TreeTensors(torch.as_tensor(tree.parents_arr(), device=device),
                       torch.as_tensor(tree.depths_arr(), device=device),
                       torch.as_tensor(tree.ancestor_mask(), device=device))


def greedy_tree_accept(tree: TreeSpec, tree_tokens, logits, root_slot,
                       input_slots):
    """Greedy (temperature-0) tree acceptance.

    tree_tokens [B, T]; logits [B, S, V]; root_slot [B]; input_slots
    [B, T].  Returns (path_nodes [B, D] padded with -1, accept_len [B],
    bonus [B], bonus_parent_slot [B]).  ``torch.argmax`` returns the
    first maximal index, as ``jnp.argmax`` does."""
    b, t = tree_tokens.shape
    dev = logits.device
    argmax = torch.argmax(logits, dim=-1)                 # [B, S]
    root_slot = root_slot.long()
    input_slots = input_slots.long()
    parents, depths, _ = tree_tensors(tree, dev)
    parents_b = torch.clamp(parents, min=0)[None].expand(b, t)
    parent_slot = torch.where(parents[None] >= 0,
                              torch.gather(input_slots, 1, parents_b),
                              root_slot[:, None])
    pred_at_parent = torch.gather(argmax, 1, parent_slot)
    match = tree_tokens.long() == pred_at_parent          # [B, T]
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
