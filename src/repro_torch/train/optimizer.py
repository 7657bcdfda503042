"""AdamW, the cosine learning-rate schedule and global-norm clipping
(counterpart of ``repro/train/optimizer.py``) over the port's parameter
trees: nested dicts and lists of tensors.  Moments are fp32 whatever the
parameter dtype; the update is computed in fp32 and cast back to each
leaf's dtype.

The step count lives on the host, so the bias corrections and the
learning rate are numpy float32 scalars, computed in fp32 as ``jnp``
computes them, and no step reads the card.

Weight decay follows the reference's leaf rank.  The reference stacks
its layers along a leading axis (``decoder/slots/0/norm1`` is [L, d]),
so its ``p.ndim >= 2`` test decays every per-layer norm; the port keeps
a per-layer list, in which ``norm1`` is [d].  A leaf inside a list
(the port's stacked axis) therefore counts one rank more: per-layer
norms are decayed, the top-level ``final_norm`` and the draft's
unstacked ``layer/norm1`` are not.  Griffin's remainder layers are
unstacked in the reference (``rem``): ``adamw_update``'s
``unstacked_layers`` names how many trailing entries of ``layers``
count at their own rank.

FSDP (``launch.steps.make_train_step(grad_shardings=)``): the moments
live as the spec tree's slices, one tree per mesh device
(``ShardedMoments``, cut by ``shard_moments``), and ``adamw_update``
runs on each device's slices.  A slice keeps its leaf's rank and place
in the tree, so weight decay still follows the whole leaf's stacked
rank.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import shard_leaf


class OptState(NamedTuple):
    step: int          # updates applied so far (host)
    mu: Any            # first moment, fp32, the params' tree
    nu: Any            # second moment, fp32


def tree_map(fn: Callable, tree, *rest, stacked: bool = False):
    """``fn(leaf, *rest_leaves, stacked)`` over the leaves of nested dicts
    and lists; ``stacked`` is True under a list (the port's layer axis,
    stacked in the reference).  Returns the tree of results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), stacked=stacked)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest), stacked=True)
                for i, v in enumerate(tree)]
    return fn(tree, *rest, stacked)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in a fixed order (dict keys sorted, as ``jax``
    flattens)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


class ShardedMoments(list):
    """FSDP moments: one moment tree per mesh device (``mesh.devices``
    order), each leaf that device's slice of the whole moment."""


def shard_moments(tree, specs, mesh) -> ShardedMoments:
    """Whole moments ``tree`` cut to every mesh device's slice by the
    spec tree ``specs`` (``distributed.sharding.shard_leaf``), each slice
    a copy on its device."""
    return ShardedMoments(
        tree_map(lambda m, sp, stacked: shard_leaf(
            m, sp, mesh, mesh.coords(c)).to(dev, copy=True), tree, specs)
        for c, dev in enumerate(mesh.devices))


def adamw_init(params) -> OptState:
    def zeros(p, stacked):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(step=0, mu=tree_map(zeros, params),
                    nu=tree_map(zeros, params))


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` (in place) so their global L2 norm is at most
    ``max_norm``.  Returns (grads, the norm before clipping as a 0-dim
    fp32 tensor on the card)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    with torch.no_grad():
        for g in leaves:
            g.copy_((g.float() * scale).to(g.dtype))
    return grads, gn


def cosine_schedule(step: int, *, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> np.float32:
    """Linear warm-up then cosine decay to ``min_frac * base_lr``, in
    float32."""
    f32 = np.float32
    if step < warmup:
        return f32(base_lr) * f32(step + 1) / f32(max(warmup, 1))
    prog = np.clip(f32(step - warmup) / f32(max(total - warmup, 1)),
                   f32(0.0), f32(1.0))
    return f32(base_lr) * (f32(min_frac) + f32((1 - min_frac) * 0.5)
                           * (f32(1) + np.cos(f32(np.pi) * prog)))


def adamw_update(params, grads, opt: OptState, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 unstacked_layers: int = 0) -> Tuple[Any, OptState]:
    """One AdamW step, in place: the parameters and moments are updated
    where they live and returned with the advanced state.  ``lr`` is a
    float32 scalar (``cosine_schedule``); the last ``unstacked_layers``
    entries of ``params["layers"]`` decay by their own rank."""
    step = opt.step + 1
    f32 = np.float32
    b1c = float(f32(1.0) - f32(b1) ** f32(step))
    b2c = float(f32(1.0) - f32(b2) ** f32(step))
    lr = float(f32(lr))

    def upd(p, g, m, v, stacked):
        g32 = g.float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        p32 = p.float()
        if p.dim() + int(stacked) >= 2:   # the reference's stacked rank
            delta = delta + weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))

    trees = (params, grads, opt.mu, opt.nu)
    with torch.no_grad():
        if unstacked_layers:
            cut = len(params["layers"]) - unstacked_layers
            for lay in zip(*(t["layers"][cut:] for t in trees)):
                tree_map(upd, *lay)         # a dict: stacked=False
            trees = tuple(dict(t, layers=t["layers"][:cut]) for t in trees)
        tree_map(upd, *trees)
    return params, OptState(step=step, mu=opt.mu, nu=opt.nu)
