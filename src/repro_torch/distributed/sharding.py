"""Placement rules over a device mesh (counterpart of
``repro/distributed/sharding.py``), and the mesh itself.

``DeviceMesh`` is the port's stand-in for what ``jax.make_mesh`` gives the
reference: a shape over the axis names ``("data", "model")`` (optionally
``"pod"`` first) and one ``torch.device`` per coordinate.  The devices are
listed explicitly and may repeat: two data shards may share one card, and
the CPU tests put every shard on ``cpu``.

The rules return, per leaf, the tuple a ``PartitionSpec`` holds: per
dimension None (replicated), an axis name, or a tuple of axis names (a
one-axis tuple is written as its name, as ``PartitionSpec`` normalises
it).  They follow the reference rule for rule:

* tensor parallelism on ``model``: column-split projections (last dim),
  row-split outputs (``ROW_NAMES``, second to last), expert-split MoE
  weights, embed and head by their widths;
* data parallelism on (``pod``, ``data``): the batch dims of activations
  and caches;
* FSDP (training): each parameter also splits its largest free dim over
  the data axes;
* context parallelism: a full cache's sequence dim over ``model`` (over
  every axis with ``shard_seq_over_all``).

A dim is split only when the axes' size divides it (``_divisible``);
otherwise the next candidate dim is tried, or the dim stays whole.
``shard_leaf`` cuts a leaf to the piece one mesh coordinate holds.
``param_specs`` returns the spec tree with its rules (``ParamSpecs``),
which ``launch.steps.make_train_step(grad_shardings=)`` cuts the
gradients and the AdamW moments by (FSDP).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

# param names whose *second-to-last* dim is the split (row, input) dim
ROW_NAMES = {"wo", "cm_wv", "wd_B", "lora_B"}
# names never split (small, scalar, the router)
REPLICATED_NAMES = {"router", "gate_attn", "gate_mlp", "conv_w", "conv_b",
                    "lam", "w0", "u", "gn_scale", "gn_bias"}

Spec = Tuple[Any, ...]


def _entry(axes) -> Any:
    """One spec entry as ``PartitionSpec`` keeps it: None, a name, or a
    tuple of two or more names."""
    if isinstance(axes, tuple):
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes
    return axes


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class DeviceMesh:
    """A named grid of devices.  ``shape`` maps each axis name to its
    size in ``axis_names`` order; ``devices`` holds one device per
    coordinate, row-major over the axes (the last axis fastest)."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Sequence[str] = ("data", "model"),
                 devices: Sequence = ()):
        axis_names = tuple(axis_names)
        if axis_names not in (("data", "model"), ("pod", "data", "model")):
            raise ValueError(f"mesh axes must be ('data', 'model') or "
                             f"('pod', 'data', 'model'), not {axis_names}")
        shape = tuple(int(n) for n in shape)
        if len(shape) != len(axis_names) or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} does not fit the axes "
                             f"{axis_names}")
        devices = [torch.device(d) for d in devices]
        if len(devices) != math.prod(shape):
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                             f"devices, got {len(devices)}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.devices: List[torch.device] = devices

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes carrying batch data parallelism."""
        return ("pod", "data") if "pod" in self.axis_names else ("data",)

    def axis_size(self, name: str) -> int:
        return self.shape[name] if name in self.axis_names else 1

    @property
    def data_size(self) -> int:
        return math.prod(self.shape[a] for a in self.data_axes)

    def coords(self, index: int) -> Dict[str, int]:
        """The coordinate of the ``index``-th device."""
        out: Dict[str, int] = {}
        for a in reversed(self.axis_names):
            index, out[a] = divmod(index, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def device_at(self, **coords: int) -> torch.device:
        index = 0
        for a in self.axis_names:
            index = index * self.shape[a] + coords.get(a, 0)
        return self.devices[index]

    def data_shard_coords(self, shard: int) -> Dict[str, int]:
        """The coordinate of data shard ``shard`` (the data axes
        flattened as a batch dim split over them is, ``model`` 0)."""
        out = {"model": 0}
        for a in reversed(self.data_axes):
            shard, out[a] = divmod(shard, self.shape[a])
        return out

    def model_shard_coords(self, shard: int, model: int) -> Dict[str, int]:
        """The coordinate of model shard ``model`` of data shard
        ``shard``."""
        return dict(self.data_shard_coords(shard), model=model)

    def model_row(self, shard: int = 0) -> List[torch.device]:
        """The devices of data shard ``shard``'s model shards, in model
        order: the devices its tensor-parallel engine splits over."""
        return [self.device_at(**self.model_shard_coords(shard, j))
                for j in range(self.axis_size("model"))]

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(shape: Sequence[int],
              axis_names: Sequence[str] = ("data", "model"),
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A mesh of ``shape`` over ``devices`` (default: ``cuda:0`` ..
    ``cuda:n-1``, one card per coordinate).  A CUDA device the process
    cannot see raises: no shard runs anywhere else."""
    n = math.prod(shape)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type == "cuda":
            idx = 0 if d.index is None else d.index
            if not torch.cuda.is_available() \
                    or idx >= torch.cuda.device_count():
                raise RuntimeError(f"mesh device {d} is not reachable "
                                   f"from this process")
    return DeviceMesh(shape, axis_names, devices)


@dataclass(frozen=True)
class ShardingRules:
    mesh: Any
    fsdp: bool = False          # also split params over the data axes

    @property
    def model_size(self) -> int:
        return self.mesh.shape["model"]

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return (("pod", "data") if "pod" in self.mesh.axis_names
                else ("data",))

    @property
    def data_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.data_axes)


def _divisible(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


def spec_for_leaf(rules: ShardingRules, names: Sequence[str],
                  shape: Sequence[int]) -> Spec:
    """The spec of one parameter at tree path ``names`` (dict keys and
    list indices as strings) with ``shape``."""
    names = [str(n) for n in names]
    name = names[-1] if names else ""
    shape = tuple(shape)
    nd = len(shape)
    spec: List[Any] = [None] * nd
    if nd <= 1 or name in REPLICATED_NAMES:
        return ()
    if "moe" in names and name in ("wi", "wg", "wo") and nd >= 3:
        # [(n,) E, d, f]: the experts over model
        e_axis = nd - 3
        if _divisible(shape[e_axis], rules.model_size):
            spec[e_axis] = "model"
    elif name == "embed":
        # [V, d]: d over model (vocab sizes rarely divide)
        if _divisible(shape[-1], rules.model_size):
            spec[-1] = "model"
        elif _divisible(shape[-2], rules.model_size):
            spec[-2] = "model"
    elif name == "head":
        if _divisible(shape[-1], rules.model_size):
            spec[-1] = "model"
    elif name in ROW_NAMES:
        if _divisible(shape[-2], rules.model_size):
            spec[-2] = "model"
    else:
        # the column-parallel default (wq, wk, wv, wi, wg, fuse, ...)
        if _divisible(shape[-1], rules.model_size):
            spec[-1] = "model"
        elif _divisible(shape[-2], rules.model_size):
            spec[-2] = "model"
    if rules.fsdp:
        # also the largest free dim over the data axes
        dsz = rules.data_size
        for i in sorted(range(nd), key=lambda i: -shape[i]):
            if spec[i] is None and _divisible(shape[i], dsz):
                spec[i] = _entry(rules.data_axes)
                break
    return tuple(spec)


def _tree_map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


class ParamSpecs(dict):
    """A parameter tree's spec tree (``param_specs``) that also carries
    the ``rules`` it came from: their mesh is what a sharded step cuts by,
    as a ``NamedSharding`` carries its mesh in the reference."""

    def __init__(self, tree: Dict, rules: ShardingRules):
        super().__init__(tree)
        self.rules = rules


def param_specs(rules: ShardingRules, params) -> Any:
    """The spec of every leaf of ``params`` (nested dicts and lists of
    tensors), in the tree's structure (the reference's
    ``param_shardings``); a dict tree comes back as ``ParamSpecs``."""
    tree = _tree_map_path(
        lambda path, leaf: (spec_for_leaf(rules, path, leaf.shape)
                            if hasattr(leaf, "shape") else None), params)
    return ParamSpecs(tree, rules) if isinstance(tree, dict) else tree


def spec_leaves(specs) -> List[Spec]:
    """A spec tree's specs in ``train.optimizer.tree_leaves`` order (dict
    keys sorted): the order of the parameter tree's leaves."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def check_specs(specs, params, path=()) -> None:
    """Raise ValueError unless ``specs`` has ``params``' structure, one
    spec per leaf of no more entries than the leaf has dims."""
    where = "/".join(path) or "the root"
    if isinstance(params, dict):
        if not isinstance(specs, dict) or set(specs) != set(params):
            raise ValueError(f"spec tree does not match the params at "
                             f"{where}")
        for k in params:
            check_specs(specs[k], params[k], path + (str(k),))
    elif isinstance(params, (list, tuple)):
        if not isinstance(specs, (list, tuple)) or len(specs) != len(params):
            raise ValueError(f"spec tree does not match the params at "
                             f"{where}")
        for i, (sp, p) in enumerate(zip(specs, params)):
            check_specs(sp, p, path + (str(i),))
    elif not (isinstance(specs, tuple) and len(specs) <= params.dim()):
        raise ValueError(f"spec {specs!r} does not fit the leaf of shape "
                         f"{tuple(params.shape)} at {where}")


def batch_spec(rules: ShardingRules, batch: int) -> Spec:
    """The batch dim over the data axes when they divide it."""
    if _divisible(batch, rules.data_size):
        return (_entry(rules.data_axes),)
    if _divisible(batch, rules.mesh.shape.get("data", 1)):
        return ("data",)
    return ()


def cache_shardings(rules: ShardingRules, cfg, cache: Dict, *,
                    shard_seq_over_all: bool = False) -> Dict[str, Spec]:
    """Specs of an architecture's cache dict.  Attention caches [L, B,
    S, Hk, Dh]: B over the data axes, S over ``model`` (context
    parallelism; every axis with ``shard_seq_over_all``, as for a
    batch-1 500K context).  State caches are small: batch only."""
    mesh = rules.mesh
    batch = next((v.shape[1] for v in cache.values() if len(v.shape) >= 2),
                 1)
    bspec = batch_spec(rules, batch)
    bax = bspec[0] if len(bspec) else None
    all_axes = tuple(mesh.axis_names)

    def div(a, dim: int, axes) -> bool:
        if axes is None:
            return False
        size = math.prod(mesh.shape[x] for x in _axes_of(axes))
        return a.shape[dim] % size == 0 and a.shape[dim] >= size

    def spec_for(key: str, a) -> Spec:
        nd = len(a.shape)
        if key in ("k", "v", "kmax", "kmin"):       # [L, B, S|NB, Hk, Dh]
            if shard_seq_over_all:
                seq_ax = all_axes if div(a, 2, all_axes) else (
                    "model" if div(a, 2, "model") else None)
                return (None, None, _entry(seq_ax), None, None)
            seq_ax = "model" if div(a, 2, "model") else None
            return (None, bax, seq_ax, None, None)
        if key in ("cross_k", "cross_v", "win_k", "win_v", "wkv"):
            return (None, bax, None, None, None)
        if key == "length":
            return ()                               # lengths replicated
        if key in ("win_pos", "ts_tm", "ts_cm", "rnn_h"):
            return (None, bax, None)
        if key == "conv":                           # [Lr, B, 3, w]
            return (None, bax, None, None)
        return (None,) * nd

    return {k: spec_for(k, v) for k, v in cache.items()}


def pkv_shardings(rules: ShardingRules, pkv_shapes) -> Tuple[Spec, ...]:
    """Specs of the materialised partial cache (k, v: [L, B, Hk, P, Dh];
    pos: [L, B, Hk, P]): B over the data axes, then heads over
    ``model`` when they divide, else slots."""
    b, hk, p = pkv_shapes[0].shape[1:4]
    bspec = batch_spec(rules, b)
    bax = bspec[0] if len(bspec) else None
    if _divisible(hk, rules.model_size):
        head_ax, slot_ax = "model", None
    elif _divisible(p, rules.model_size):
        head_ax, slot_ax = None, "model"
    else:
        head_ax = slot_ax = None
    kv = (None, bax, head_ax, slot_ax, None)
    return kv, kv, kv[:4]


def piece_index(spec: Spec, mesh, coords: Dict[str, int]
                ) -> Tuple[Tuple[int, int, int], ...]:
    """(dim, pieces, index) of every dim ``spec`` splits, for the device
    at ``coords`` (a dim over several axes splits them row-major, as a
    ``PartitionSpec`` does).  Two coordinates with equal tuples hold the
    same piece."""
    out = []
    for dim, entry in enumerate(spec):
        n, idx = 1, 0
        for a in _axes_of(entry):
            idx = idx * mesh.shape[a] + coords.get(a, 0)
            n *= mesh.shape[a]
        if n > 1:
            out.append((dim, n, idx))
    return tuple(out)


def shard_leaf(leaf: torch.Tensor, spec: Spec, mesh,
               coords: Dict[str, int]) -> torch.Tensor:
    """The piece of ``leaf`` that the device at ``coords`` holds under
    ``spec``: each split dim narrowed to the coordinate's slice
    (``piece_index``).  A view; a leaf no axis splits comes back whole."""
    out = leaf
    for dim, n, idx in piece_index(spec, mesh, coords):
        size = leaf.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out


def place_params(rules: ShardingRules, params, coords: Dict[str, int],
                 device) -> Any:
    """``params`` as the device at ``coords`` holds them: every leaf cut
    by its spec (``shard_leaf``) and moved to ``device`` (a leaf already
    there and whole is the same tensor, no copy)."""
    def place(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        piece = shard_leaf(leaf, spec_for_leaf(rules, path, leaf.shape),
                           rules.mesh, coords)
        return piece.to(device)
    return _tree_map_path(place, params)
