"""Data-parallel serving over a mesh's ``data`` axis (counterpart of the
reference's ``SpecPVEngine(mesh=...)`` with a data axis above 1,
``repro/core/engine.py:309-330`` and ``:1142-1270``).

The reference splits its batch rows and page pools over ``data`` and
GSPMD runs one dispatch per device; rows are independent, so nothing is
communicated.  The port is one Python controller, ``DataParallelEngine``
(``SpecPVEngine(..., mesh=mesh)`` builds it when the data axis divides the
batch), over one ``SpecPVEngine`` per data shard:

* shard ``d`` holds rows ``shard_slots(d)`` (contiguous, batch // D of
  them) on the device at its mesh coordinate, with their per-row state,
  their partial cache, their rows of a contiguous cache, its static
  buffers and its CUDA graphs (one per step variant, per shard);
* its trunk and draft pools hold only its range of pages, addressed
  locally: the range's first page is local page 1 and local page 0 its
  own null page;
* its weights are a replica (``distributed.sharding.place_params``) only
  when its device differs from every earlier shard's: shards on one card
  share one copy.

The host state is the controller's: one sharded ``PageAllocator`` per
pool (per-shard ranges, free lists and high-water marks) and one
``PrefixCache``, in global slot and page ids.  Each shard engine sees
them through a window (``ShardPages``, ``ShardPrefix``) that maps its
rows and its pages to the global ids and matches only prefix entries
whose pages its shard holds (``_shard_chain``, ``_tail_on_shard``), so
the engine's own admission, copy-on-write, pin and dedupe code runs
unchanged for each shard.

A tick launches every stepping shard's step (``SpecPVEngine._step_launch``)
before it reads any result back (``_step_finish``), so shards on several
cards overlap; shards on one card queue on its stream.  A fused prefill
runs one round per shard, and the rounds' cursors then register their
blocks in the order the caller gave them, as the reference's one round
does.  Nothing falls back: a shard's device that cannot be reached
raises, and no path merges the shards into one state.

A ``(D, m)`` mesh with ``m > 1`` serves data times tensor parallelism:
each data shard's engine is built on its row of the mesh (a ``(1, m)``
mesh of the row's model shards, ``distributed.tensor_parallel``) from a
whole replica of the weights on the row's device, which it splits itself.

The state architectures (RWKV-6, Griffin) serve lock-step (the wave
path's ``generate``): ``step(st, "state")`` launches every shard's chain
step before it reads any back.  A VLM or audio target's per-request
``extra`` and its once-per-request cross rows go to the shard that holds
the row (``prefill`` splits ``extra`` by rows, a slot admission routes
it with its slot).

The host tier (``tiered=True``) is each shard's own: its engine keeps a
``TierManager`` over its ``ShardPages`` (demotions, promotions and debts
in its local page ids), with its own side stream and pinned buffers,
and every manager bills one ``HostBytes`` account per data shard, so
``tier_stats`` gives the reference's sums and each host's peak.  A tiered
admission's margin and a refresh's deferral are judged against the pool
of the shard that holds the row: a row on shard s never waits on shard
t's promotion debt.  On a ``(D, m)`` mesh each row's engine tiers its
own shard-stacked pool.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (MODE_NAMES, EngineState, PrefillCursor,
                                     SpecPVEngine, StepOutput, mesh_shards)
from repro_torch.distributed.sharding import (DeviceMesh, ShardingRules,
                                              place_params)
from repro_torch.kernels import ops
from repro_torch.kvcache import cache as kvc
from repro_torch.kvcache.offload import HostBytes, TierManager, tier_stats


class ShardPages:
    """Data shard ``shard``'s window on a sharded ``PageAllocator``: its
    rows are slots ``0..b-1`` (global ``slot_base + slot``) and its pages
    are local ids (global page ``shard_base + p - 1``; 0 the null page).
    The engine resets the allocator, so ``reset`` here does nothing.
    Its tier queries (``demote``, ``promote``, ``hosted_*``, ``idle``,
    ``max_hosted``) are the shard's, in local page ids."""

    def __init__(self, al: kvc.PageAllocator, shard: int, slot_base: int):
        self.al = al
        self.shard = shard
        self.slot_base = slot_base
        self._off = al.shard_base(shard) - 1

    def glob(self, page: int) -> int:
        return int(page) + self._off if page else 0

    def loc(self, page: int) -> int:
        if not page:
            return 0
        assert self.al.page_shard(page) == self.shard, \
            f"page {page} is not shard {self.shard}'s"
        return int(page) - self._off

    def _locs(self, pages) -> List[int]:
        return [self.loc(p) for p in pages]

    def _s(self, slot: int) -> int:
        return self.slot_base + int(slot)

    @property
    def capacity(self) -> int:
        return self.al.shard_capacity(self.shard)

    @property
    def free(self) -> int:
        return self.al.free_in(self.shard)

    def reset(self) -> None:
        pass

    def count(self, slot: int) -> int:
        return self.al.count(self._s(slot))

    def page_at(self, slot: int, block: int) -> int:
        return self.loc(self.al.page_at(self._s(slot), block))

    def refcount(self, page: int) -> int:
        return self.al.refcount(self.glob(page))

    def slot_holds_shared(self, slot: int) -> bool:
        return self.al.slot_holds_shared(self._s(slot))

    def alloc(self, slot: int, n: int) -> np.ndarray:
        return np.asarray(self._locs(self.al.alloc(self._s(slot), n)),
                          np.int32)

    def attach(self, slot: int, pages) -> None:
        self.al.attach(self._s(slot), [self.glob(p) for p in pages])

    def rebind_block(self, slot: int, block: int, page: int) -> List[int]:
        return self._locs(self.al.rebind_block(self._s(slot), block,
                                               self.glob(page)))

    def fork(self, src: int, dst: int) -> List[int]:
        return self._locs(self.al.fork(self._s(src), self._s(dst)))

    def cow_write(self, slot: int, block: int) -> Tuple[int, int]:
        old, new = self.al.cow_write(self._s(slot), block)
        return self.loc(old), self.loc(new)

    def free_slot(self, slot: int) -> List[int]:
        return self._locs(self.al.free_slot(self._s(slot)))

    def pin_slot_pages(self, slot: int, pages) -> None:
        self.al.pin_slot_pages(self._s(slot), [self.glob(p) for p in pages])

    # -- the residency tier, on this shard -------------------------------
    @property
    def shards(self) -> int:
        return self.al.shards

    def slot_shard(self, slot: int) -> int:
        return self.shard

    @property
    def idle(self) -> int:
        return self.al.idle_in(self.shard)

    def hosted_count(self, slot: int) -> int:
        return self.al.hosted_count(self._s(slot))

    def hosted_blocks(self, slot: int) -> List[int]:
        return self.al.hosted_blocks(self._s(slot))

    @property
    def hosted_total(self) -> int:
        return self.al.hosted_in(self.shard)

    def max_hosted(self) -> int:
        return self.al.max_hosted(self.shard)

    def demotable(self, slot: int, block: int) -> bool:
        return self.al.demotable(self._s(slot), block)

    def demote(self, slot: int, block: int) -> int:
        return self.loc(self.al.demote(self._s(slot), block))

    def promote(self, slot: int, block: int) -> int:
        return self.loc(self.al.promote(self._s(slot), block))


class _ShardEntry:
    """A prefix entry as one shard sees it: its pages in local ids, or
    None when another shard holds them.  ``tick`` is the entry's own."""
    __slots__ = ("_e", "page", "draft_page")

    def __init__(self, e, page: Optional[int], draft_page: Optional[int]):
        self._e = e
        self.page = page
        self.draft_page = draft_page

    def __getattr__(self, name):
        return getattr(self._e, name)

    @property
    def tick(self):
        return self._e.tick

    @tick.setter
    def tick(self, value):
        self._e.tick = value


class ShardPrefix:
    """Data shard ``shard``'s window on the engine's one ``PrefixCache``:
    matches keep only the chain (and tail) whose pages the shard holds,
    entries come back in local page ids, and registrations store global
    ones.  Eviction runs over the whole cache, as the reference's does;
    the engine clears it, so ``clear`` here does nothing."""

    def __init__(self, owner: "DataParallelEngine", shard: int,
                 pages: ShardPages, dpages: ShardPages):
        self.owner = owner
        self.shard = shard
        self.pages = pages
        self.dpages = dpages

    @property
    def _pc(self) -> kvc.PrefixCache:
        return self.owner._prefix

    def _local(self, e):
        if e is None:
            return None
        mine = self.owner._page_alloc.page_shard(e.page) == self.shard
        return _ShardEntry(e, self.pages.loc(e.page) if mine else None,
                           self.dpages.loc(e.draft_page) if mine else None)

    def chain_keys(self, prompt: np.ndarray, n_blocks: int) -> List[bytes]:
        return self._pc.chain_keys(prompt, n_blocks)

    def new_tick(self) -> int:
        return self._pc.new_tick()

    def match(self, prompt: np.ndarray, max_blocks: int, *,
              touch: bool = True, count: bool = True):
        entries = self._pc.match(prompt, max_blocks, touch=touch, count=count)
        return [self._local(e)
                for e in self.owner._shard_chain(entries, self.shard)]

    def match_tail(self, prompt: np.ndarray, *, touch: bool = True,
                   count: bool = True):
        tail = self._pc.match_tail(prompt, touch=touch, count=count)
        if tail is None or not self.owner._tail_on_shard(tail, self.shard):
            return None
        chain, e = tail
        return [self._local(c) for c in chain], self._local(e)

    def entry(self, key: bytes):
        return self._local(self._pc.entry(key))

    def insert(self, key: bytes, depth: int, page: int, draft_page: int,
               feat, trunk_alloc, draft_alloc, tick: Optional[int] = None,
               tokens: Optional[np.ndarray] = None,
               parent: Optional[bytes] = None):
        return self._local(self._pc.insert(
            key, depth, self.pages.glob(page), self.dpages.glob(draft_page),
            feat, self.pages.al, self.dpages.al, tick=tick, tokens=tokens,
            parent=parent))

    def register_tail(self, parent: bytes, tail_tokens: np.ndarray,
                      depth: int, page: int, draft_page: int, feat,
                      first_token: int, trunk_alloc, draft_alloc):
        return self._local(self._pc.register_tail(
            parent, tail_tokens, depth, self.pages.glob(page),
            self.dpages.glob(draft_page), feat, first_token, self.pages.al,
            self.dpages.al))

    def evict_lru(self, trunk_alloc, draft_alloc, n_pages: int) -> int:
        return self._pc.evict_lru(self.pages.al, self.dpages.al, n_pages)

    def clear(self, trunk_alloc, draft_alloc) -> None:
        pass


class DataParallelState:
    """The controller's state: each data shard's ``EngineState`` (the
    shard engine's static state), never merged."""

    def __init__(self, shards: List[EngineState]):
        self.shards = shards


# attributes a shard engine derives from the configs, the same for all
_DERIVED = ("is_attn", "l_attn", "cross", "partial_enabled", "zero_copy",
            "gathered", "_ns_blocks", "tree", "_tree_branching", "pmax",
            "emax", "_nb_seq", "cuda_graphs", "traffic")


class DataParallelEngine(SpecPVEngine):
    """The engine of a mesh whose data axis splits the batch (see the
    module docstring).  Takes ``SpecPVEngine``'s arguments; ``device``
    may only name the mesh's device type.  ``shards`` holds the shard
    engines, ``shard_launches[d]`` the kernel launches made by shard
    ``d`` (diffs of ``ops.LAUNCHES`` around its calls)."""

    def __init__(self, cfg, spec, dcfg, params, draft_params, *, batch: int,
                 max_len: int, partial_verification: bool = True,
                 draft_chain: Optional[bool] = None,
                 temperature: float = 0.0, paged: bool = False,
                 num_pages: Optional[int] = None,
                 num_draft_pages: Optional[int] = None,
                 prefix_cache: bool = True, tiered: bool = False,
                 tier_lossless: bool = False, tier_codec: str = "int8",
                 zero_copy: bool = False, mesh=None, device=None,
                 cuda_graphs: Optional[bool] = None):
        if tiered and not paged:
            raise ValueError("tiered KV residency needs the paged cache "
                             "(paged=True)")
        self.data_shards, self.model_shards = mesh_shards(mesh, batch)
        d = self.data_shards
        devs = [mesh.device_at(**mesh.data_shard_coords(s))
                for s in range(d)]
        if device is not None and any(torch.device(device).type != x.type
                                      for x in devs):
            raise ValueError(f"device {device} is not the mesh's devices "
                             f"{devs}")
        self.mesh = mesh
        # the replicas: whole weights (each data shard's engine splits its
        # own over its model row)
        self._rules = ShardingRules(DeviceMesh(
            tuple(1 if a == "model" else n for a, n in mesh.shape.items()),
            mesh.axis_names, [mesh.model_row(s)[0]
                              for s in range(mesh.data_size)]))
        self.cfg, self.spec, self.dcfg = cfg, spec, dcfg
        self.params, self.dparams = params, draft_params
        self.batch = batch
        self.max_len = max_len
        self.temperature = float(temperature)
        self.paged = bool(paged)
        self._nb_seq = -(-max_len // spec.block_size)
        self.num_pages = (num_pages if num_pages is not None
                          else batch * self._nb_seq + 1)
        self.num_draft_pages = (num_draft_pages if num_draft_pages is not None
                                else self.num_pages)
        self._page_alloc = self._draft_alloc = self._prefix = None
        if self.paged:
            self._page_alloc = kvc.PageAllocator(
                self.num_pages, shards=d, slot_shard=self.shard_of_slot)
            self._draft_alloc = kvc.PageAllocator(
                self.num_draft_pages, shards=d, slot_shard=self.shard_of_slot)
            if prefix_cache:
                self._prefix = kvc.PrefixCache(spec.block_size)
        self._tier = None           # each shard engine keeps its own
        self.device = devs[0]
        replicas: Dict[torch.device, Tuple] = {}
        self.shards: List[SpecPVEngine] = []
        for s in range(d):
            if devs[s] not in replicas:
                coords = mesh.data_shard_coords(s)
                replicas[devs[s]] = tuple(
                    place_params(self._rules, p, coords, devs[s])
                    for p in (params, draft_params))
            p_s, dp_s = replicas[devs[s]]
            npages = ndpages = None
            if self.paged:
                npages = self._page_alloc.shard_capacity(s) + 1
                ndpages = self._draft_alloc.shard_capacity(s) + 1
            row = (DeviceMesh((1, self.model_shards),
                              devices=mesh.model_row(s))
                   if self.model_shards > 1 else None)
            with self._on_device(devs[s]):
                sub = SpecPVEngine(
                    cfg, spec, dcfg, p_s, dp_s, batch=batch // d,
                    max_len=max_len,
                    partial_verification=partial_verification,
                    draft_chain=draft_chain, temperature=temperature,
                    paged=paged, num_pages=npages, num_draft_pages=ndpages,
                    prefix_cache=prefix_cache, zero_copy=zero_copy,
                    mesh=row, device=devs[s],
                    cuda_graphs=cuda_graphs)
            if self.paged:
                base = self.shard_slots(s).start
                sub._page_alloc = ShardPages(self._page_alloc, s, base)
                sub._draft_alloc = ShardPages(self._draft_alloc, s, base)
                if sub._prefix is not None:
                    sub._prefix = ShardPrefix(self, s, sub._page_alloc,
                                              sub._draft_alloc)
            self.shards.append(sub)
        for name in _DERIVED:
            setattr(self, name, getattr(self.shards[0], name))
        for sub in self.shards[1:]:
            sub.traffic = self.traffic          # one meter for the engine
        # the host tier: a manager per shard over its window, one account
        self._host_bytes = None
        if tiered:
            self._host_bytes = HostBytes(d)
            for sub in self.shards:
                sub._tier = TierManager(
                    sub._page_alloc, lossless=tier_lossless,
                    codec=tier_codec, traffic=self.traffic,
                    host=self._host_bytes)
        self.state = DataParallelState([sub.state for sub in self.shards])
        self.shard_launches: List[Dict[str, int]] = [{} for _ in range(d)]
        self._pkv_active = False
        self.final_state = None

    # ---- routing -------------------------------------------------------
    @staticmethod
    def _on_device(dev):
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def _call(self, s: int, fn, *args, **kw):
        """``fn`` of shard ``s`` on its device, its kernel launches
        tallied into ``shard_launches[s]``."""
        before = dict(ops.LAUNCHES)
        with self._on_device(self.shards[s].device):
            out = fn(*args, **kw)
        tally = self.shard_launches[s]
        for k, n in ops.LAUNCHES.items():
            if n != before.get(k, 0):
                tally[k] = tally.get(k, 0) + n - before.get(k, 0)
        return out

    def _locate(self, slot: int) -> Tuple[int, int, SpecPVEngine]:
        s = self.shard_of_slot(int(slot))
        return s, int(slot) - self.shard_slots(s).start, self.shards[s]

    def _split(self, a: np.ndarray) -> List[np.ndarray]:
        return [a[self.shard_slots(s).start: self.shard_slots(s).stop]
                for s in range(self.data_shards)]

    def _cat(self, name: str) -> np.ndarray:
        return np.concatenate([getattr(sub, name) for sub in self.shards])

    # ---- counters, summed over the shards ------------------------------
    @staticmethod
    def _sum_dicts(ds) -> Dict:
        out: Dict = {}
        for d in ds:
            for k, n in d.items():
                out[k] = out.get(k, 0) + n
        return out

    @property
    def dispatches(self) -> int:
        return sum(sub.dispatches for sub in self.shards)

    @property
    def dispatch_keys(self) -> Dict:
        return self._sum_dicts(sub.dispatch_keys for sub in self.shards)

    @property
    def prefill_dispatches(self) -> int:
        return sum(sub.prefill_dispatches for sub in self.shards)

    @property
    def prefill_keys(self) -> Dict:
        return self._sum_dicts(sub.prefill_keys for sub in self.shards)

    @property
    def cow_copies(self) -> Dict[str, int]:
        return self._sum_dicts(sub.cow_copies for sub in self.shards)

    @property
    def capture_s(self) -> float:
        return sum(sub.capture_s for sub in self.shards)

    @property
    def _host_pending_len(self) -> np.ndarray:
        return self._cat("_host_pending_len")

    @property
    def _host_seq_len(self) -> np.ndarray:
        return self._cat("_host_seq_len")

    # ---- the host tier, shard by shard ---------------------------------
    @property
    def tiered(self) -> bool:
        return self._host_bytes is not None

    def tier_stats(self) -> Dict[str, int]:
        """The reference's tier counters summed over the shards, with each
        host's peak bytes ({} untiered)."""
        if not self.tiered:
            return {}
        return tier_stats([sub._tier for sub in self.shards],
                          self._page_alloc.hosted_total, self._host_bytes)

    def tier_admit_margin(self, prompt_len: int,
                          shard: Optional[int] = None) -> int:
        """The margin of data shard ``shard``'s pool (the worst shard's
        when None)."""
        subs = self.shards if shard is None else [self.shards[shard]]
        return max(sub.tier_admit_margin(prompt_len) for sub in subs)

    def tier_ready_rows(self, rows: np.ndarray, modes: np.ndarray,
                        force: bool = True) -> Tuple[np.ndarray, int]:
        """Each shard defers its own full-cache rows against its own pool
        (and forces its smallest debt only when none of its rows would
        step: another shard's steps free none of its pages)."""
        if not self.tiered:
            return rows, 0
        outs, deferred = [], 0
        for sub, r, m in zip(self.shards, self._split(np.asarray(rows)),
                             self._split(np.asarray(modes))):
            o, n = sub.tier_ready_rows(r, m, force=force)
            outs.append(o)
            deferred += n
        return np.concatenate(outs), deferred

    # ---- state ---------------------------------------------------------
    def _own(self, st) -> None:
        if st is not self.state:
            raise ValueError("an engine steps its own state: the one its "
                             "prefill returned")

    def empty_state(self) -> DataParallelState:
        self._pkv_active = False
        self.final_state = None
        if self.paged:
            self._clear_prefix()
            self._page_alloc.reset()
            self._draft_alloc.reset()
        for s, sub in enumerate(self.shards):
            self._call(s, sub.empty_state)
        return self.state

    def prefill(self, prompt: np.ndarray, chunk: int = 256,
                extra: Optional[Dict] = None) -> DataParallelState:
        """Lock-step prefill: every shard's rows of ``prompt`` (and of a
        VLM or audio target's ``extra``, whose cross rows its shard
        writes), each over its own pools, after one reset of the shared
        allocators."""
        assert prompt.shape[0] == self.batch
        self._pkv_active = False
        self.final_state = None
        if self.paged:
            self._clear_prefix()
            self._page_alloc.reset()
            self._draft_alloc.reset()
        for s, (sub, rows) in enumerate(zip(self.shards,
                                            self._split(np.asarray(prompt)))):
            sl = self.shard_slots(s)
            part = ({k: v[sl.start: sl.stop].to(sub.device)
                     for k, v in extra.items()} if extra else extra)
            self._call(s, sub.prefill, rows, chunk=chunk, extra=part)
        return self.state

    def _first_tokens(self, st) -> np.ndarray:
        return np.concatenate([sub._first_tokens(sub.state)
                               for sub in self.shards])

    def clear_slot_rows(self, st, slot: int):
        self._own(st)
        s, loc, sub = self._locate(slot)
        self._call(s, sub.clear_slot_rows, sub.state, loc)
        return st

    def reset_slot(self, st, slot: int):
        self._own(st)
        s, loc, sub = self._locate(slot)
        self._call(s, sub.reset_slot, sub.state, loc)
        return st

    def release_slot_pages(self, slot: int) -> None:
        s, loc, sub = self._locate(slot)
        sub.release_slot_pages(loc)

    # ---- slot prefill --------------------------------------------------
    def prefill_begin_slot(self, st, slot: int, prompt: np.ndarray,
                           chunk: int = 256, extra: Optional[Dict] = None,
                           max_new_tokens: Optional[int] = None,
                           temperature: Optional[float] = None,
                           seed: int = 0, draft: str = "tree"
                           ) -> Tuple[DataParallelState, PrefillCursor]:
        self._own(st)
        s, loc, sub = self._locate(slot)
        _, cur = self._call(s, sub.prefill_begin_slot, sub.state, loc,
                            prompt, chunk=chunk, extra=extra,
                            max_new_tokens=max_new_tokens,
                            temperature=temperature, seed=seed, draft=draft)
        cur.shard = s
        return st, cur

    def prefill_step_into_slot(self, st, cur: PrefillCursor
                               ) -> Tuple[DataParallelState, int]:
        self._own(st)
        sub = self.shards[cur.shard]
        _, n = self._call(cur.shard, sub.prefill_step_into_slot, sub.state,
                          cur)
        return st, n

    def prefill_step_fused(self, st, cursors: List[PrefillCursor]
                           ) -> Tuple[DataParallelState, int]:
        """One round per shard that has open cursors, every round launched
        before any cursor advances; the cursors then register their
        blocks in the order given (as one fused round would)."""
        self._own(st)
        if any(c.extra is not None for c in cursors):
            raise ValueError("fused prefill cannot batch per-request "
                             "`extra` conditioning")
        groups: Dict[int, List[PrefillCursor]] = {}
        for c in cursors:
            if not c.done:
                groups.setdefault(c.shard, []).append(c)
        if not groups:
            raise ValueError("no open prefill cursor")
        rounds = {}
        for s, group in sorted(groups.items()):
            sub = self.shards[s]
            rounds[s] = self._call(s, sub._prefill_launch, sub.state, group)
        row = {id(c): (s, i) for s, (cs, _) in rounds.items()
               for i, c in enumerate(cs)}
        for c in cursors:
            if id(c) in row:
                s, i = row[id(c)]
                self._call(s, self.shards[s]._prefill_advance, rounds[s][1],
                           i, c)
        return st, sum(ctx["tokens"] for _, ctx in rounds.values())

    def prefill_finalize_slot(self, st, cur: PrefillCursor
                              ) -> Tuple[DataParallelState, int]:
        self._own(st)
        sub = self.shards[cur.shard]
        _, first = self._call(cur.shard, sub.prefill_finalize_slot,
                              sub.state, cur)
        return st, first

    # ---- copy-on-write -------------------------------------------------
    def fork_slot(self, st, src: int, dst: int):
        """A fork within one shard (pages shared by reference); a fork
        across shards raises AssertionError, as the reference's
        allocator asserts, before anything changes."""
        self._own(st)
        s, ls, sub = self._locate(src)
        sd, ld, _ = self._locate(dst)
        if s != sd:
            raise AssertionError(
                f"cross-shard fork {src}->{dst}: a fork shares pages by "
                f"reference, so both slots must live on one shard")
        self._call(s, sub.fork_slot, sub.state, ls, ld)
        return st

    # ---- decode --------------------------------------------------------
    def modes_for_rows(self, st, rows: np.ndarray) -> np.ndarray:
        self._own(st)
        return np.concatenate([
            sub.modes_for_rows(sub.state, r)
            for sub, r in zip(self.shards, self._split(np.asarray(rows,
                                                                  bool)))])

    def step_fused(self, st, rows: np.ndarray, modes: np.ndarray
                   ) -> Tuple[DataParallelState, StepOutput]:
        """One tick: each shard with stepping rows launches its fused step
        (one graph replay on the card), and only then is each read back."""
        if not self.is_attn:
            raise ValueError("state archs step through step(st, 'state')")
        self._own(st)
        rows = np.asarray(rows, bool)
        modes = np.asarray(modes, np.int8)
        if not rows.any():
            raise ValueError("step_fused needs at least one live row")
        launched = []
        for s, (sub, r, m) in enumerate(zip(self.shards, self._split(rows),
                                            self._split(modes))):
            if r.any():
                launched.append((s, self._call(s, sub._step_launch,
                                               sub.state, r, m)))
        w = self.tree.depth + 1
        toks = np.zeros((self.batch, w), np.int64)
        counts = np.zeros((self.batch,), np.int64)
        acc = np.zeros((self.batch,), np.int64)
        out_modes = modes.copy()
        for s, ctx in launched:
            _, so = self._call(s, self.shards[s]._step_finish, *ctx)
            r = slice(self.shard_slots(s).start, self.shard_slots(s).stop)
            toks[r], counts[r], acc[r] = so.tokens, so.counts, so.accept_len
            out_modes[r] = so.modes
        names = sorted({MODE_NAMES[int(m)] for m in modes[rows]})
        return st, StepOutput(tokens=toks, counts=counts, accept_len=acc,
                              mode=names[0] if len(names) == 1 else "fused",
                              modes=out_modes)

    def step(self, st, mode: str) -> Tuple[DataParallelState, StepOutput]:
        """One lock-step round over every shard's rows.  A state arch's
        round (``"state"``) launches every shard's chain step (one graph
        replay each on the card) before it reads any back, as
        ``step_fused`` does; an attention mode is one ``step_fused`` tick
        over every row."""
        if mode != "state":
            return super().step(st, mode)
        self._own(st)
        launched = [self._call(s, sub._state_launch, sub.state)
                    for s, sub in enumerate(self.shards)]
        outs = [self._call(s, self.shards[s]._state_finish, sub_st)[1]
                for s, sub_st in enumerate(launched)]
        return st, StepOutput(
            tokens=np.concatenate([o.tokens for o in outs]),
            counts=np.concatenate([o.counts for o in outs]),
            accept_len=np.concatenate([o.accept_len for o in outs]),
            mode=mode)

    # ---- prefix cache --------------------------------------------------
    def reset_prefix_stats(self) -> None:
        for sub in self.shards:
            sub._prefill_skipped_tokens = 0
            sub._prefix_dedups = 0
        if self._prefix is not None:
            self._prefix.reset_stats()

    def prefix_stats(self) -> Dict[str, int]:
        if self._prefix is None:
            return {}
        out = self._prefix.stats()
        out["prefill_tokens_skipped"] = sum(sub._prefill_skipped_tokens
                                            for sub in self.shards)
        out["dedups"] = sum(sub._prefix_dedups for sub in self.shards)
        return out

    def _page_home(self, page: int, draft_page: int):
        """(shard engine, local trunk page, local draft page)."""
        s = self._page_alloc.page_shard(page)
        sub = self.shards[s]
        return sub, sub._page_alloc.loc(page), sub._draft_alloc.loc(draft_page)

    def save_prefix_state(self, st) -> Optional[dict]:
        if self._prefix is None:
            return None
        self._own(st)

        def page_bytes(page: int, draft_page: int) -> dict:
            sub, p, dp = self._page_home(page, draft_page)
            return {
                "trunk": {k: sub.state.cache[k][:, p].to("cpu", copy=True)
                          for k in kvc.PAGED_POOL_KEYS},
                "draft": {k: sub.state.dcache[k][dp].to("cpu", copy=True)
                          for k in kvc.DRAFT_POOL_KEYS}}
        return self._prefix.save_state(page_bytes)

    def restore_prefix_state(self, st, snap: Optional[dict],
                             shard: int = 0):
        """Re-seat a snapshot's verified entries on data shard ``shard``:
        its pages and its device."""
        if self._prefix is None or snap is None:
            return st, 0
        self._own(st)
        al, dal = self._page_alloc, self._draft_alloc
        sub = self.shards[shard]

        def seat_pages(d: dict, sh: int) -> Tuple[int, int]:
            (page,) = al.alloc_cache(1, sh)
            try:
                (dpage,) = dal.alloc_cache(1, sh)
            except RuntimeError:
                al.dec_ref([page], cache=True)
                raise
            home, p, dp = self._page_home(page, dpage)
            for k, blob in d["pages"]["trunk"].items():
                home.state.cache[k][:, p].copy_(blob)
            for k, blob in d["pages"]["draft"].items():
                home.state.dcache[k][dp].copy_(blob)
            return page, dpage

        def feat(f):
            return torch.as_tensor(f).to(device=sub.device,
                                         dtype=sub.state.ext_feats.dtype)
        return st, self._prefix.load_state(snap, al, dal, seat_pages,
                                           shard=shard, feat=feat)
