"""Tensor parallelism over a mesh's ``model`` axis: the port's counterpart
of what GSPMD does with the reference's weight placement
(``repro/distributed/sharding.py:_spec_for_leaf`` and
``repro/core/engine.py:385-390``, ``jax.device_put`` of the trunk and the
draft by ``param_shardings``).

Each of the ``m`` model shards holds its piece of every weight that the
rules split (``sharding.place_params`` at its coordinate): whole query
heads with their KV heads (column-split ``wq`` / ``wk`` / ``wv``,
row-split ``wo``; a cross layer's ``xattn`` alike), the MLP's columns
(``wi`` / ``wg``) and rows (``wo``), an MoE's ``E/m`` experts, ``embed``
by its width and an untied ``head`` by its vocabulary; RWKV-6's time
mixing by whole heads and its channel mixing by columns, Griffin's
recurrent blocks by the width's columns (``TensorParallel._state_piece``).
A shard runs the unsharded code under its shard config
(``ModelShard.cfg``: the heads, ``d_ff`` or experts divided where the
split is whole), and these collectives join the shards:

* one sum (``all_reduce``) after attention's ``wo`` and one after the
  MLP's or MoE's, both row-parallel (RWKV-6's time and channel mixing
  and Griffin's recurrent block likewise); a tied head (``embed.T``
  split on ``d``) is row-parallel too, so its partial logits are summed;
* a concatenation (``all_gather``) after a column split whose output is
  the residual width (``embed`` on ``d``, the draft's ``fuse`` and
  ``in_proj``), after a vocabulary-split ``head``, and of Griffin's conv
  output, which the dense gates ``wa`` / ``wi`` read whole.

On one device a sum is an add in shard order and a gather a
concatenation.  Across devices every device adds copies of all the parts
in shard order, so every shard holds bit-identical results.  That form
serves the blocks without per-head state (the MLP, the MoE, the
embedding, the head and the draft's projections; a card-and-CPU pair in
``tests/test_torch_cuda.py``).  Attention and the recurrences read one
shard-stacked per-head state, so an engine's model shards share one
card (``core/engine.py:SpecPVEngine``).

The divisibility decision is per block (``TensorParallel``): a block
whose split would not fall on whole heads, whole columns or whole experts
runs whole, once, on the residual's device, so exactly one copy of its
output enters the residual (the reference's "graceful degradation",
``repro/distributed/sharding.py``: tiny-dense's 2 KV heads on 4 shards,
or a rule that would split ``wk`` mid-head).  1-D leaves (``bq`` / ``bk`` / ``bv``) stay whole under the
rules; a shard's piece slices them by its heads.

The KV layout differs from the reference's, not the function: the
reference's ``model`` axis splits a contiguous cache's sequence dim and
leaves paged pools whole over ``model``
(``repro/distributed/sharding.py:cache_shardings``).  Here each shard
keeps the K/V of its own KV heads, which is what column-split ``wk`` /
``wv`` produce without a collective: the engine's per-head state stacks
the shards on the layer axis (shard ``s``'s attention layer ``l`` is
entry ``s * L + l`` of a [``m * L``, ..., ``Hk / m``, Dh] pool), so each
shard's pool is one contiguous block that the kernels read at its head
counts, and one page table, allocator and prefix cache serve all shards.
``merge_heads`` lays such a tensor out as the unsharded [L, ..., Hk, ...]
and ``split_heads`` back.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

import torch

from repro_torch.distributed.sharding import (DeviceMesh, ShardingRules,
                                              place_params, spec_for_leaf)

COL = (None, "model")           # a column split of a [in, out] weight
ROW = ("model", None)           # a row split


def all_reduce(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of every shard's part, for every shard: each device adds
    copies of all the parts in shard order, so every shard gets the same
    bits; shards on one device share one result."""
    done: Dict[torch.device, torch.Tensor] = {}
    out = []
    for p in parts:
        dev = p.device
        if dev not in done:
            acc = parts[0].to(dev)
            for q in parts[1:]:
                acc = acc + q.to(dev)
            done[dev] = acc
        out.append(done[dev])
    return out


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """Every shard's part concatenated along ``dim`` in shard order, for
    every shard (one tensor per device, shared by its shards)."""
    done: Dict[torch.device, torch.Tensor] = {}
    out = []
    for p in parts:
        dev = p.device
        if dev not in done:
            done[dev] = torch.cat([q.to(dev) for q in parts], dim=dim)
        out.append(done[dev])
    return out


def merge_heads(x: torch.Tensor, shards: int, layer_axis: int,
                head_axis: int) -> torch.Tensor:
    """A shard-stacked tensor ([..., m * L, ..., Hk / m, ...], shard ``s``'s
    layer ``l`` at ``s * L + l``) as the unsharded layout [..., L, ...,
    Hk, ...]: the shards' heads concatenated in shard order."""
    if shards == 1:
        return x
    la = layer_axis % x.dim()
    ha = head_axis % x.dim()
    # the shard axis split off at ``la``, moved just before the heads
    y = x.unflatten(la, (shards, x.shape[la] // shards)).movedim(la, ha)
    return y.flatten(ha, ha + 1)


def split_heads(x: torch.Tensor, shards: int, layer_axis: int,
                head_axis: int) -> torch.Tensor:
    """The inverse of ``merge_heads``: an unsharded [..., L, ..., Hk, ...]
    as the shard-stacked layout [..., m * L, ..., Hk / m, ...] (a new
    tensor)."""
    if shards == 1:
        return x
    la = layer_axis % x.dim()
    ha = head_axis % x.dim()
    y = x.unflatten(ha, (shards, x.shape[ha] // shards)).movedim(ha, la)
    return y.flatten(la, la + 1).contiguous()


@dataclass
class ModelShard:
    """One coordinate of the ``model`` axis: its device, its config (the
    split blocks' heads, ``d_ff`` and experts divided) and its piece of
    the parameters."""
    index: int
    device: torch.device
    cfg: Any
    params: Any


def _spec(rules, path, leaf):
    return tuple(spec_for_leaf(rules, path, leaf.shape))


class TensorParallel:
    """The ``model``-axis split of one parameter tree (a target's, or a
    draft's with ``cfg`` its layer's config) over ``devices``, one per
    model shard.  The per-block decision (each flag True when the block
    splits on every shard):

    * ``attn_split``: ``H`` and ``Hk`` divide by ``m`` and the rules
      column-split ``wq`` / ``wk`` / ``wv`` and row-split ``wo`` (of the
      cross layers' ``xattn`` too, which then split with the same heads);
      a hybrid's local attention always runs whole (its rolling window is
      not shard-stacked; recurrentgemma-2b's one KV head cannot split);
    * ``mlp_split``: ``wi`` (and ``wg``) column-split, ``wo`` row-split;
    * ``moe_split``: the experts split ``E / m``;
    * ``tmix_split`` (RWKV-6 time mixing): whole heads per shard and the
      rules column-split ``wr`` / ``wk`` / ``wv`` / ``wg`` and row-split
      ``wo``; ``cmix_split`` (channel mixing): ``cm_wk`` column-split,
      ``cm_wv`` row-split;
    * ``rec_split`` (Griffin's recurrent block): the width ``w`` divides
      by ``m``, ``wx`` / ``wgate`` column-split, ``wo`` row-split;
    * ``embed_split``: ``embed`` split on its width (the tied head is then
      row-parallel), ``head_split``: an untied head split on the
      vocabulary; ``fuse_split``: the draft's ``fuse`` and ``in_proj``
      column-split.

    ``kv_shards`` is how many pieces the engine's per-head (per-channel)
    state falls into: ``m`` when attention splits (the K/V), RWKV-6's
    time mixing (the ``wkv`` state) or Griffin's recurrent block
    (``rnn_h`` and ``conv``), else 1.  ``draft`` (the draft's layer
    config and parameters) splits a target's draft over the same devices
    as ``self.draft``.

    The model code takes the split as an explicit ``tp`` argument beside
    the whole tree (``models.api.prefill`` / ``decode`` / ``advance``,
    the draft's ``draft_extend`` / ``draft_phase``): a block that runs
    whole reads the whole tree, a split block its shards' pieces."""

    def __init__(self, cfg, params, devices: Sequence, draft=None):
        self.cfg = cfg
        self.devices = [torch.device(d) for d in devices]
        m = len(self.devices)
        self.m = m
        self.rules = ShardingRules(DeviceMesh((1, m), devices=self.devices))
        layers = (params["layers"] if "layers" in params
                  else [params["layer"]] if "layer" in params else [])

        def first(key):
            return next((lp for lp in layers if key in lp), None)

        def specs_are(lp, block, names, want):
            return all(_spec(self.rules, (block, n) if block else (n,),
                             (lp[block] if block else lp)[n]) == want
                       for n in names
                       if n in (lp[block] if block else lp))

        h, hk = cfg.num_heads, cfg.num_kv_heads
        attn, xattn = first("attn"), first("xattn")
        self.attn_split = bool(
            attn is not None and cfg.arch_type != "hybrid"
            and h % m == 0 and hk % m == 0
            and all(specs_are(lp, blk, ("wq", "wk", "wv"), COL)
                    and specs_are(lp, blk, ("wo",), ROW)
                    for lp, blk in ((attn, "attn"), (xattn, "xattn"))
                    if lp is not None))
        mlp = first("mlp")
        self.mlp_split = bool(
            mlp is not None and specs_are(mlp, "mlp", ("wi", "wg"), COL)
            and specs_are(mlp, "mlp", ("wo",), ROW))
        moe = first("moe")
        self.moe_split = bool(
            moe is not None and cfg.num_experts % m == 0
            and all(_spec(self.rules, ("moe", n), moe["moe"][n])[0]
                    == "model" for n in ("wi", "wg", "wo")))
        tmix = first("wr") if cfg.arch_type == "ssm" else None
        self.tmix_split = bool(
            tmix is not None and (cfg.d_model // cfg.ssm_head_dim) % m == 0
            and specs_are(tmix, None, ("wr", "wk", "wv", "wg"), COL)
            and specs_are(tmix, None, ("wo",), ROW))
        self.cmix_split = bool(
            tmix is not None and specs_are(tmix, None, ("cm_wk",), COL)
            and specs_are(tmix, None, ("cm_wv",), ROW))
        rec = first("wx")
        self.rec_split = bool(
            rec is not None and rec["wx"].shape[-1] % m == 0
            and specs_are(rec, None, ("wx", "wgate"), COL)
            and specs_are(rec, None, ("wo",), ROW))
        self.embed_split = bool(
            "embed" in params
            and _spec(self.rules, ("embed",), params["embed"]) == COL)
        self.head_split = bool(
            "head" in params
            and _spec(self.rules, ("head",), params["head"]) == COL)
        self.fuse_split = bool(
            "fuse" in params
            and _spec(self.rules, ("fuse",), params["fuse"]) == COL
            and _spec(self.rules, ("in_proj",), params["in_proj"]) == COL)
        self.kv_shards = (m if self.attn_split or self.tmix_split
                          or self.rec_split else 1)
        rep = dict(head_dim=cfg.head_dim_)
        if self.attn_split:
            rep.update(num_heads=h // m, num_kv_heads=hk // m)
        if self.mlp_split:
            rep.update(d_ff=cfg.d_ff // m)
        if self.moe_split:
            rep.update(num_experts=cfg.num_experts // m)
        self.shards = [
            ModelShard(s, dev, cfg.replace(**rep),
                       self._piece(cfg, params, s, dev))
            for s, dev in enumerate(self.devices)]
        self.draft = (TensorParallel(*draft, self.devices)
                      if draft is not None else None)

    def require_single_device(self) -> None:
        """The blocks with per-head state (attention, the recurrences) run
        every model shard on one device: raise NotImplementedError
        otherwise."""
        if len(set(self.devices)) != 1:
            raise NotImplementedError(
                "tensor parallelism runs the engine's kernel routes with "
                "every model shard on one device (shards on several cards "
                "are not ported yet: ROADMAP.md queue 1, 'Multi-GPU, part "
                "4')")

    def _cut(self, w: torch.Tensor, dim: int, s: int, dev) -> torch.Tensor:
        """Shard ``s``'s slice of ``w`` along ``dim`` (a view on the same
        device)."""
        n = w.shape[dim] // self.m
        return w.narrow(dim, s * n, n).to(dev)

    def _state_piece(self, cfg, whole: Dict, s: int, dev) -> Dict:
        """Shard ``s``'s pieces of one state-arch layer.  RWKV-6: the time
        mixing's ``wr`` / ``wk`` / ``wv`` / ``wg`` by whole heads
        (columns), ``wo`` by rows, the decay's ``wd_B`` by the heads'
        columns (its rank-64 input, ``tanh(x wd_A)``, is computed whole
        once: the reference's rank split of ``wd_B`` with a sum after
        gives the same function), ``w0`` / ``u`` / ``gn_scale`` /
        ``gn_bias`` by heads; the channel mixing's ``cm_wk`` by columns
        and ``cm_wv`` by rows (``cm_wr`` gates the summed output, so it
        runs whole).  Griffin's recurrent block: ``wx`` / ``wgate`` and
        the gates' ``wa`` / ``wi`` by the width's columns (the gates read
        the gathered conv output), ``conv_w`` / ``conv_b`` / ``lam`` /
        ``ba`` / ``bi`` by channel, ``wo`` by rows.  The token shift, the
        LoRA mixes and the norms run whole, from the whole tree."""
        out: Dict[str, Any] = {}
        if cfg.arch_type == "ssm":
            if self.tmix_split:
                for n in ("wr", "wk", "wv", "wg", "wd_B"):
                    out[n] = self._cut(whole[n], -1, s, dev)
                out["wo"] = self._cut(whole["wo"], -2, s, dev)
                for n in ("w0", "u", "gn_scale", "gn_bias"):
                    out[n] = self._cut(whole[n], 0, s, dev)
            if self.cmix_split:
                out["cm_wk"] = self._cut(whole["cm_wk"], -1, s, dev)
                out["cm_wv"] = self._cut(whole["cm_wv"], -2, s, dev)
        elif "wx" in whole and self.rec_split:
            for n in ("wx", "wgate", "wa", "wi", "conv_w"):
                out[n] = self._cut(whole[n], -1, s, dev)
            for n in ("conv_b", "lam", "ba", "bi"):
                out[n] = self._cut(whole[n], 0, s, dev)
            out["wo"] = self._cut(whole["wo"], -2, s, dev)
        return out

    def _piece(self, cfg, params, s: int, dev):
        """Shard ``s``'s parameters: the rules' cut (``place_params``) of
        every block that splits, the heads' slice of its 1-D biases, and
        the state archs' pieces (``_state_piece``).  A block that runs
        whole is left out: it runs once, from the whole tree, on the
        device of the residual stream (shard 0's)."""
        piece = place_params(self.rules, params, {"data": 0, "model": s},
                             dev)
        dh = cfg.head_dim_
        blocks = (("attn", self.attn_split), ("xattn", self.attn_split),
                  ("mlp", self.mlp_split), ("moe", self.moe_split))
        if "layers" in piece:
            pairs = list(zip(piece["layers"], params["layers"]))
            if cfg.arch_type in ("ssm", "hybrid"):
                for j, (lp, whole) in enumerate(pairs):
                    sp = self._state_piece(cfg, whole, s, dev)
                    piece["layers"][j] = {
                        **sp, **{k: lp[k] for k in ("attn", "mlp")
                                 if k in lp}}
                    pairs[j] = (piece["layers"][j], whole)
        else:
            pairs = [(piece["layer"], None)] if "layer" in piece else []
        for lp, _ in pairs:
            for name, ok in blocks:
                if name in lp and not ok:
                    del lp[name]
            for blk in ("attn", "xattn"):
                for n, heads in (("bq", cfg.num_heads),
                                 ("bk", cfg.num_kv_heads),
                                 ("bv", cfg.num_kv_heads)):
                    if n in lp.get(blk, {}):
                        w = heads // self.m * dh
                        lp[blk][n] = lp[blk][n].narrow(0, s * w, w)
        for name, ok in (("embed", self.embed_split),
                         ("head", self.head_split),
                         ("fuse", self.fuse_split),
                         ("in_proj", self.fuse_split)):
            if name in piece and not ok:
                del piece[name]
        return piece

    def map_reduce(self, fn) -> torch.Tensor:
        """``fn(shard)`` on every shard, then ``all_reduce``: the sum on
        shard 0's device (the residual stream's)."""
        return all_reduce([fn(sh) for sh in self.shards])[0]

    def map_gather(self, fn, dim: int = -1) -> torch.Tensor:
        """``fn(shard)`` on every shard, then ``all_gather`` along
        ``dim``: the concatenation on shard 0's device."""
        return all_gather([fn(sh) for sh in self.shards], dim)[0]
