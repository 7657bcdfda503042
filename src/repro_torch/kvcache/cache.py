"""Blocked KV cache structures (counterpart of ``repro/kvcache/cache.py``).

Contiguous cache: ``k/v [L, B, S_max, Hk, Dh]`` with per-row lengths and
per-block summaries ``kmax/kmin [L, B, NB, Hk, Dh]`` (paper eq. (1)).

Paged cache: a shared block pool ``k/v [L, NumPages, block, Hk, Dh]`` with
per-slot page tables ``[B, S_max/block]`` and physical-page summaries
``kmax/kmin [L, NumPages, Hk, Dh]``.  Page 0 is the reserved null page:
unallocated entries point at it, pad and invalid writes land in it, and
it is never read unmasked.  Page ownership lives host-side in
``PageAllocator`` (refcounts, prefix-cache references, the zero-copy
partial pins and the blocks demoted to the host tier);
``PrefixCache`` indexes registered prompt blocks.

Unlike the reference's functional updates, the writers here update the
cache tensors in place (the engine consumes the state it steps).
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import update_slice_rows

# ---------------------------------------------------------------------------
# contiguous cache
# ---------------------------------------------------------------------------

def append_layer_kv(k_layer, v_layer, new_k, new_v, length, valid=None):
    """Write new tokens into one layer's cache at per-row offsets, in
    place.  k_layer: [B, S, Hk, Dh]; new_k: [B, T, Hk, Dh]; length: [B].
    The offset is clamped like the reference's dynamic_update_slice.
    A ragged chunk (``valid`` [B, T]) writes zeros at its pad positions,
    as the reference's ``jnp.where(valid, k_new, 0)`` does before the
    same clamped write (so where ``length + T`` passes the end, the
    clamp shifts the row's real tokens too, as in the reference)."""
    if valid is not None:
        vm = valid[:, :, None, None]
        new_k = torch.where(vm, new_k, torch.zeros_like(new_k))
        new_v = torch.where(vm, new_v, torch.zeros_like(new_v))
    update_slice_rows(k_layer, new_k, length, axis=1)
    update_slice_rows(v_layer, new_v, length, axis=1)
    return k_layer, v_layer


def update_layer_summaries(kmax_l, kmin_l, k_layer, start, end, block: int):
    """Recompute the summaries of the blocks covering tokens [start, end)
    of one layer.  kmax_l/kmin_l: [B, NB, Hk, Dh]; k_layer: [B, S, Hk, Dh].
    Returns new (kmax, kmin)."""
    b, s, hk, dh = k_layer.shape
    nb = kmax_l.shape[1]
    if s < nb * block:
        pad = torch.zeros((b, nb * block - s, hk, dh), dtype=k_layer.dtype,
                          device=k_layer.device)
        k_layer = torch.cat([k_layer, pad], dim=1)
    kb = k_layer[:, : nb * block].reshape(b, nb, block, hk, dh).float()
    dev = k_layer.device
    tok = (torch.arange(nb, device=dev)[:, None] * block
           + torch.arange(block, device=dev)[None])            # [NB, blk]
    valid = (tok[None] < end[:, None, None])[..., None, None]  # [B,NB,blk,1,1]
    kmax_new = torch.where(valid, kb, torch.full_like(kb, -1e30)).amax(dim=2)
    kmin_new = torch.where(valid, kb, torch.full_like(kb, 1e30)).amin(dim=2)
    blk = torch.arange(nb, device=dev)
    touched = ((blk[None] >= (start // block)[:, None])
               & (blk[None] < ((end + block - 1) // block)[:, None]))
    tb = touched[..., None, None]
    return (torch.where(tb, kmax_new, kmax_l),
            torch.where(tb, kmin_new, kmin_l))


def init_contiguous_kv(num_layers: int, batch: int, max_len: int, block: int,
                       num_kv_heads: int, head_dim: int, dtype,
                       device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contiguous K/V [L, B, max_len, Hk, Dh]: views of the first max_len
    rows of a zero allocation of ``ceil(max_len / block) * block`` rows,
    so that the rows are a pool of blocks for the kernels
    (``kernels.ops.flat_blocks``) while every write clamps its offset
    at the reference's ``max_len - W`` (``update_slice_rows``), as its
    ``dynamic_update_slice`` does.  The rows past max_len stay 0, the
    reference's padded view."""
    rows = -(-max_len // block) * block
    shape = (num_layers, batch, rows, num_kv_heads, head_dim)
    return tuple(torch.zeros(shape, dtype=dtype, device=device)[:, :, :max_len]
                 for _ in range(2))


def contiguous_update_all_summaries(kmax, kmin, k, start, end, block: int,
                                    n_touch: int):
    """Recompute (in place) every layer's summaries of the blocks covering
    [start, end) of each row: the reference's ``update_layer_summaries``
    mapped over the layers, in one call of the block-summary kernel (K4)
    over the cache rows as one pool.  kmax/kmin: [L, B, NB, Hk, Dh]; k:
    [L, B, S, Hk, Dh] (``init_contiguous_kv``); n_touch: static bound on
    the touched blocks per row (``ceil(W / block) + 1`` for W written
    tokens)."""
    from repro_torch.kernels import ops
    return ops.contiguous_block_summaries(k, start, end, n_touch, kmax, kmin,
                                          block)


# ---------------------------------------------------------------------------
# paged block pool
# ---------------------------------------------------------------------------

class PageAllocator:
    """Host-side refcounted allocator over the shared block pool (the
    reference's allocator).

    Page 0 is the reserved null page and never handed out, so
    ``capacity == num_pages - 1``.  ``_slot_pages[slot][j]`` is the
    physical page of logical block ``j``; every mutation (alloc growth,
    ``attach`` of a matched prefix, ``rebind_block``, ``cow_write``)
    keeps logical-block order, so page tables mirror it.

    Ownership is refcounted: a page may back a block of several slots
    (``fork``, ``attach``) and carry references from the host-side
    ``PrefixCache`` (``add_ref(cache=True)``).  A page returns to the free
    list only when its refcount drops to zero, and a write into a page
    with refcount > 1 goes through ``cow_write`` first.  Pages held only
    by cache references are ``idle`` (reclaimable by LRU eviction); the
    rest of ``in_use`` is ``committed``.  A pin is a real reference plus
    a ``_pin_ref`` count, so a pinned page can never be freed or rebound
    until the slot's next refresh drops the pin.  A block demoted to the
    host tier (``demote``) gives its page back and leaves a null entry
    and a promotion debt (``_hosted``) that ``promote`` repays on a fresh
    page; only pages the slot owns alone, unpinned and uncached, demote.
    ``high_water`` is the
    peak of ``committed`` and ``resident_high_water`` the peak of
    ``in_use``; both move only in ``_track``, where pages can become
    slot-referenced (never in ``fork``), and survive ``reset``.

    Data-parallel serving: with ``shards > 1`` the allocatable pages split
    into contiguous per-shard ranges, shard ``s`` owning ``[max(1,
    s*NP//shards), (s+1)*NP//shards)`` (the null page rides with shard
    0), the ranges a data-axis split of the pool's page dim gives each
    shard.  Every slot maps to one shard (``slot_shard``) and draws pages
    only from its range, so a shard's resident pages never leave it.
    Each shard keeps a LIFO free list; ``high_water_by`` holds each
    shard's peak committed pages and ``peak_pages_per_host`` the worst.
    A fork or a copy-on-write stays within one shard."""

    def __init__(self, num_pages: int, *, shards: int = 1,
                 slot_shard=None):
        assert num_pages >= 2, "need at least one allocatable page"
        assert 1 <= shards <= num_pages - 1, \
            f"cannot split {num_pages - 1} allocatable pages over {shards}"
        self.num_pages = num_pages
        self.shards = shards
        # shard s owns pages [_bounds[s], _bounds[s + 1])
        self._bounds = [max(1, (s * num_pages) // shards)
                        for s in range(shards)] + [num_pages]
        self._slot_shard_fn = slot_shard or (lambda slot: 0)
        self.high_water = 0             # peak committed (live working set)
        self.resident_high_water = 0    # peak physical (incl. idle cached)
        self.high_water_by = [0] * shards   # per-shard peak committed
        self.reset()

    def reset(self) -> None:
        # one LIFO free list per shard: pop() hands out the lowest pages
        # first, and a freed page is reused first
        self._free_by: List[List[int]] = [
            list(range(self._bounds[s + 1] - 1, self._bounds[s] - 1, -1))
            for s in range(self.shards)]
        self._free_set = {p for fl in self._free_by for p in fl}
        self._ref = np.zeros((self.num_pages,), np.int32)
        self._cache_ref = np.zeros((self.num_pages,), np.int32)
        self._slot_pages: dict = {}
        self._hosted: dict = {}         # slot -> set of demoted blocks
        self._pin_ref = np.zeros((self.num_pages,), np.int32)
        self._slot_pins: dict = {}

    # -- shard topology ------------------------------------------------
    def slot_shard(self, slot: int) -> int:
        """The shard `slot` draws its pages from."""
        return (0 if self.shards == 1
                else self._slot_shard_fn(slot) % self.shards)

    def page_shard(self, page: int) -> int:
        """The shard owning physical `page` (pages never migrate)."""
        assert page != 0, "the null page belongs to no shard's budget"
        return bisect.bisect_right(self._bounds, page) - 1

    def shard_capacity(self, shard: int) -> int:
        return self._bounds[shard + 1] - self._bounds[shard]

    def shard_base(self, shard: int) -> int:
        """The first page of `shard`'s range."""
        return self._bounds[shard]

    def free_in(self, shard: int) -> int:
        return len(self._free_by[shard])

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def free(self) -> int:
        return sum(len(fl) for fl in self._free_by)

    @property
    def in_use(self) -> int:
        """Physical pages off the free list (incl. idle cached ones)."""
        return self.capacity - self.free

    @property
    def idle(self) -> int:
        """Pages held only by prefix-cache references (no live slot):
        reclaimable at no cost by LRU prefix eviction."""
        return int(np.sum((self._ref > 0) & (self._ref == self._cache_ref)))

    def idle_in(self, shard: int) -> int:
        """``idle`` over `shard`'s range."""
        lo, hi = self._bounds[shard], self._bounds[shard + 1]
        ref, cref = self._ref[lo:hi], self._cache_ref[lo:hi]
        return int(np.sum((ref > 0) & (ref == cref)))

    @property
    def committed(self) -> int:
        """Pages some live slot references (``high_water`` is its peak)."""
        return self.in_use - self.idle

    def count(self, slot: int) -> int:
        """Pages currently held by `slot`."""
        return len(self._slot_pages.get(slot, ()))

    def pages_of(self, slot: int) -> List[int]:
        return list(self._slot_pages.get(slot, ()))

    def page_at(self, slot: int, block: int) -> int:
        """Physical page backing logical block `block` of `slot`."""
        return self._slot_pages[slot][block]

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def slot_holds_shared(self, slot: int) -> bool:
        """Does `slot` hold any page it does not own exclusively?"""
        return any(self._ref[p] > 1 for p in self._slot_pages.get(slot, ()))

    # -- residency tiers (the bytes: ``kvcache.offload.TierManager``) ---
    def hosted_count(self, slot: int) -> int:
        """Demoted blocks `slot` is owed: the pages a promotion ahead of
        its next full-cache read must seat."""
        return len(self._hosted.get(slot, ()))

    def hosted_blocks(self, slot: int) -> List[int]:
        return sorted(self._hosted.get(slot, ()))

    @property
    def hosted_total(self) -> int:
        return sum(len(v) for v in self._hosted.values())

    def hosted_in(self, shard: int) -> int:
        """The promotion debt of `shard`'s slots."""
        return sum(len(v) for s, v in self._hosted.items()
                   if self.slot_shard(s) == shard)

    def max_hosted(self, shard: Optional[int] = None) -> int:
        """The largest single-slot promotion debt (admission headroom),
        over `shard`'s slots when given."""
        return max((len(v) for s, v in self._hosted.items()
                    if shard is None or self.slot_shard(s) == shard),
                   default=0)

    def demotable(self, slot: int, block: int) -> bool:
        """May logical `block` of `slot` leave the device?  Only a page
        the slot owns alone, with no prefix-cache reference and no pin: a
        shared page is another holder's hot block and must stay servable
        without a host round trip."""
        pages = self._slot_pages.get(slot)
        if pages is None or block >= len(pages):
            return False
        p = pages[block]
        return (p != 0 and self._ref[p] == 1 and self._cache_ref[p] == 0
                and self._pin_ref[p] == 0)

    def demote(self, slot: int, block: int) -> int:
        """Give back the page of a block whose bytes went to the host: the
        page returns to the free list, the slot's entry becomes the null
        page (what the device table must show) and the block joins the
        slot's debt.  Returns the page."""
        assert self.demotable(slot, block), \
            f"demote of non-exclusive block {block} of slot {slot}"
        p = self._slot_pages[slot][block]
        self._slot_pages[slot][block] = 0
        self._ref[p] = 0
        self._free_by[self.page_shard(p)].append(p)
        self._free_set.add(p)
        self._hosted.setdefault(slot, set()).add(block)
        return p

    def promote(self, slot: int, block: int) -> int:
        """Seat a hosted block on a fresh page (refcount 1) and clear its
        debt; raises on exhaustion with state unchanged.  The caller
        writes the page's bytes and repoints the device table."""
        hosted = self._hosted.get(slot, set())
        assert block in hosted, \
            f"promote of non-hosted block {block} of slot {slot}"
        [p] = self._take(1, self.slot_shard(slot))
        self._slot_pages[slot][block] = p
        hosted.discard(block)
        if not hosted:
            self._hosted.pop(slot, None)
        return p

    def _track(self) -> None:
        self.high_water = max(self.high_water, self.committed)
        self.resident_high_water = max(self.resident_high_water, self.in_use)
        if self.shards > 1:
            for s in range(self.shards):
                in_use = self.shard_capacity(s) - len(self._free_by[s])
                self.high_water_by[s] = max(self.high_water_by[s],
                                            in_use - self.idle_in(s))
        else:
            self.high_water_by[0] = self.high_water

    @property
    def peak_pages_per_host(self) -> int:
        """The worst shard's peak committed pages: the per-host memory a
        pool-wide count would hide (one shard per host)."""
        return max(self.high_water_by)

    def _exhausted(self, n: int, shard: int) -> RuntimeError:
        where = f" (shard {shard})" if self.shards > 1 else ""
        return RuntimeError(
            f"page pool exhausted: want {n}, have {self.free_in(shard)} "
            f"free of {self.shard_capacity(shard)}{where}")

    def _take(self, n: int, shard: int = 0) -> List[int]:
        """The only place pages leave a free list (refcount 1 each);
        raises on over-draw with state unchanged."""
        if not 0 <= shard < self.shards:
            raise ValueError(f"no shard {shard} in a pool of {self.shards}")
        fl = self._free_by[shard]
        if n > len(fl):
            raise self._exhausted(n, shard)
        pages = [fl.pop() for _ in range(n)]
        for p in pages:
            assert self._ref[p] == 0, f"free page {p} had refcount"
            self._free_set.discard(p)
            self._ref[p] = 1
        self._track()
        return pages

    def alloc(self, slot: int, n: int) -> np.ndarray:
        """Hand `n` fresh (refcount-1) pages to `slot` from its shard's
        range; raises on over-draw with state unchanged."""
        pages = self._take(n, self.slot_shard(slot))
        self._slot_pages.setdefault(slot, []).extend(pages)
        return np.asarray(pages, np.int32)

    def alloc_cache(self, n: int, shard: int = 0) -> List[int]:
        """Take `n` pages held only by the prefix cache (one cache
        reference each, so idle at once): how a restored snapshot seats
        its pages before any slot references them."""
        pages = self._take(n, shard)
        for p in pages:
            self._cache_ref[p] = 1
        return pages

    def add_ref(self, pages, *, cache: bool = False) -> None:
        """One more reference on allocated pages; ``cache`` marks it a
        prefix-cache reference (pages held only by those are idle)."""
        for p in pages:
            assert self._ref[p] > 0, f"add_ref on free page {p}"
            self._ref[p] += 1
            if cache:
                self._cache_ref[p] += 1

    def dec_ref(self, pages, *, cache: bool = False) -> List[int]:
        """Release one reference per page; pages reaching zero return to
        the free list.  Returns the pages actually freed."""
        freed: List[int] = []
        for p in pages:
            p = int(p)
            assert p != 0, "refcount op on the reserved null page"
            assert p not in self._free_set, \
                f"double free: page {p} is already on the free list"
            assert self._ref[p] > 0, f"refcount underflow on page {p}"
            self._ref[p] -= 1
            if cache:
                assert self._cache_ref[p] > 0
                self._cache_ref[p] -= 1
            assert not (self._ref[p] == 0 and self._pin_ref[p] > 0), \
                f"page {p} freed while partial-pinned"
            if self._ref[p] == 0:
                self._free_by[self.page_shard(p)].append(p)
                self._free_set.add(p)
                freed.append(p)
        return freed

    def attach(self, slot: int, pages) -> None:
        """Share existing pages into `slot`, appended in logical-block
        order (a prefix-cache hit attaches its matched blocks by
        reference).  An idle cached page becomes committed again."""
        self.add_ref(pages)
        self._slot_pages.setdefault(slot, []).extend(int(p) for p in pages)
        self._track()

    def rebind_block(self, slot: int, block: int, page: int) -> List[int]:
        """Repoint logical `block` of `slot` onto the shared `page` (dedupe
        of a block another cursor registered first): the slot references
        `page` and releases its own, which is freed once nobody holds it.
        Returns the pages actually freed."""
        old = self._slot_pages[slot][block]
        assert old != page, "rebind onto the page already held"
        assert old != 0 and block not in self._hosted.get(slot, ()), \
            "rebind of a hosted or null block"
        assert self._pin_ref[old] == 0, \
            f"rebind of partial-pinned page {old}"
        self.add_ref([page])
        self._slot_pages[slot][block] = int(page)
        return self.dec_ref([old])

    def fork(self, src: int, dst: int) -> List[int]:
        """`dst` becomes a full reference-holder of `src`'s pages (the
        copy-on-write fork; `dst` must hold none) and of its pins: its
        partial view routes through the same pages until its next
        refresh, so evicting `src` must not strand it."""
        assert not self._slot_pages.get(dst), \
            f"fork target slot {dst} still holds pages"
        assert not self._hosted.get(src) and not self._hosted.get(dst), \
            "cannot fork a slot with host-demoted blocks (promote first)"
        assert self.slot_shard(src) == self.slot_shard(dst), \
            (f"cross-shard fork {src}->{dst}: a fork shares pages by "
             f"reference, so both slots must live on one shard")
        pages = self.pages_of(src)
        self.attach(dst, pages)
        src_pins = self._slot_pins.get(src)
        if src_pins is not None and len(src_pins):
            self.pin_slot_pages(dst, src_pins)
        return pages

    def cow_write(self, slot: int, block: int) -> Tuple[int, int]:
        """Make logical `block` of `slot` exclusively writable.  Returns
        ``(old_page, new_page)``, equal when the slot already owned it
        alone; otherwise the caller copies the pool contents old -> new
        and repoints the device page table.  The slot's share of the old
        page is dropped before the new one is taken (after a free-list
        check, so exhaustion raises with state unchanged): the copy
        replaces a page one for one and must not raise the high water."""
        old = self._slot_pages[slot][block]
        if self._ref[old] == 1:
            return old, old
        shard = self.slot_shard(slot)
        if not self._free_by[shard]:
            raise self._exhausted(1, shard)
        self._ref[old] -= 1             # ref > 1, so never frees here
        [new] = self._take(1, shard)
        self._slot_pages[slot][block] = new
        return old, new

    def free_slot(self, slot: int) -> List[int]:
        """Release `slot`'s pins and references (idempotent).  Returns
        only the pages actually freed: pages still shared with another
        slot or the prefix cache stay resident.  Hosted blocks (null
        entries) hold no page and drop their debt; their host bytes are
        the ``TierManager``'s to discard."""
        self.unpin_slot(slot)
        pages = self._slot_pages.pop(slot, [])
        self._hosted.pop(slot, None)
        return self.dec_ref([p for p in pages if p != 0])

    def pin_slot_pages(self, slot: int, pages) -> None:
        """Replace `slot`'s partial-pin set with `pages`.  The new pins
        are taken BEFORE the old set is released, so a page in both sets
        never transiently frees."""
        new = np.unique(np.asarray(list(pages), np.int64)).astype(np.int32)
        assert not np.any(new == 0), "pin of the reserved null page"
        self.add_ref(new)
        self._pin_ref[new] += 1
        old = self._slot_pins.get(slot)
        self._slot_pins[slot] = new
        if old is not None and len(old):
            self._pin_ref[old] -= 1
            assert np.all(self._pin_ref >= 0), "pin refcount underflow"
            self.dec_ref(old)

    def unpin_slot(self, slot: int) -> None:
        """Drop `slot`'s partial pins (idempotent)."""
        old = self._slot_pins.pop(slot, None)
        if old is not None and len(old):
            self._pin_ref[old] -= 1
            assert np.all(self._pin_ref >= 0), "pin refcount underflow"
            self.dec_ref(old)

    def pins_of(self, slot: int) -> List[int]:
        return [int(p) for p in self._slot_pins.get(slot, ())]

    @property
    def pinned_pages(self) -> int:
        """Distinct physical pages with a live partial pin."""
        return int(np.sum(self._pin_ref > 0))


# ---------------------------------------------------------------------------
# prefix cache (host side)
# ---------------------------------------------------------------------------

class _PrefixEntry:
    __slots__ = ("key", "depth", "page", "draft_page", "feat", "tick",
                 "tokens", "parent")

    def __init__(self, key, depth, page, draft_page, feat, tick,
                 tokens=None, parent=None):
        self.key = key              # chain hash of blocks [0..depth]
        self.depth = depth          # logical block index
        self.page = page            # trunk pool page (all layers)
        self.draft_page = draft_page
        self.feat = feat            # fused feature of the block's last
                                    # token, on the pools' device
        self.tick = tick            # LRU stamp
        self.tokens = tokens        # the block's prompt tokens and its
        self.parent = parent        # parent key: key == _digest(parent,
                                    # tokens), re-checked at load


class _TailEntry:
    """A whole-prompt entry for a prompt ending in a partial block: the
    pages holding the final sub-block tokens, plus the boot state of a
    greedy admission that skips prefill (the fused feature at the last
    prompt position and the greedy first token)."""

    __slots__ = ("key", "depth", "tail_len", "page", "draft_page", "feat",
                 "first_token", "tick")

    def __init__(self, key, depth, tail_len, page, draft_page, feat,
                 first_token, tick):
        self.key = key              # digest(parent chain key, tail tokens)
        self.depth = depth          # logical block index of the tail block
        self.tail_len = tail_len    # prompt tokens inside the tail block
        self.page = page
        self.draft_page = draft_page
        self.feat = feat
        self.first_token = first_token
        self.tick = tick


class PrefixCache:
    """Host-side prompt-prefix index over the paged pools (the
    reference's ``PrefixCache``, unsharded).

    Keyed by a chained hash of block-aligned prompt chunks (blake2b over
    ``parent_digest || block_tokens``), so a hit at block ``i`` certifies
    the whole prefix ``[0, (i+1)*block)``.  Each entry holds one trunk and
    one draft page (a cache reference each) and the fused boundary
    feature that resumes chunked prefill right after the matched region:
    a tensor on the pools' device, so registering a block reads nothing
    back to the host.  Entries evict LRU-oldest-first, and only when
    nothing but the cache references their pages.  A matched or
    registered chain is re-stamped as one unit, so no child is newer than
    its parent; ties break deepest-first (tails before their chain), so a
    chain never loses an interior block before its tail.
    """

    _ROOT = b"specpv-prefix"

    def __init__(self, block_size: int):
        self.block = block_size
        self._entries: Dict[bytes, _PrefixEntry] = {}
        self._tails: Dict[bytes, _TailEntry] = {}
        self._tick = 0
        self.reset_stats()

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _digest(parent: bytes, tokens: np.ndarray) -> bytes:
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(np.ascontiguousarray(tokens, np.int64).tobytes())
        return h.digest()

    def chain_keys(self, prompt: np.ndarray, n_blocks: int) -> List[bytes]:
        """Chain hashes of the first `n_blocks` full blocks of `prompt`."""
        bs = self.block
        keys, parent = [], self._ROOT
        for j in range(n_blocks):
            parent = self._digest(parent, prompt[j * bs: (j + 1) * bs])
            keys.append(parent)
        return keys

    def match(self, prompt: np.ndarray, max_blocks: int,
              *, touch: bool = True, count: bool = True
              ) -> List[_PrefixEntry]:
        """Longest cached chain over the leading full blocks of `prompt`
        (at most `max_blocks`).  ``touch`` re-stamps the matched chain
        MRU; ``count=False`` makes this a probe that counts nothing."""
        bs = self.block
        n = min(max_blocks, len(prompt) // bs)
        out: List[_PrefixEntry] = []
        parent = self._ROOT
        for j in range(n):
            parent = self._digest(parent, prompt[j * bs: (j + 1) * bs])
            e = self._entries.get(parent)
            if e is None:
                break
            out.append(e)
        if touch and out:
            self._tick += 1
            for e in out:
                e.tick = self._tick
        if count:
            self.lookups += 1
            self.blocks_seen += n
            self.blocks_matched += len(out)
        return out

    def new_tick(self) -> int:
        """A fresh LRU stamp (one per registration or match of a whole
        chain, so the deepest-first tie-break keeps every child no newer
        than its parent)."""
        self._tick += 1
        return self._tick

    def insert(self, key: bytes, depth: int, page: int, draft_page: int,
               feat, trunk_alloc: PageAllocator,
               draft_alloc: PageAllocator,
               tick: Optional[int] = None,
               tokens: Optional[np.ndarray] = None,
               parent: Optional[bytes] = None) -> Optional[_PrefixEntry]:
        """Register one completed prefill block, taking a cache reference
        on each pool page.  Returns the new entry, or None (taking
        nothing) when the chain hash is cached already (``entry(key)``
        fetches that one).  ``tokens`` / ``parent`` record the block's
        provenance for ``save_state``."""
        if key in self._entries:
            return None
        trunk_alloc.add_ref([page], cache=True)
        draft_alloc.add_ref([draft_page], cache=True)
        e = _PrefixEntry(key, depth, int(page), int(draft_page), feat,
                         self.new_tick() if tick is None else tick,
                         None if tokens is None
                         else np.ascontiguousarray(tokens, np.int64),
                         parent)
        self._entries[key] = e
        self.inserted += 1
        return e

    def entry(self, key: bytes) -> Optional[_PrefixEntry]:
        """The cached entry for a chain hash, if any (no LRU touch)."""
        return self._entries.get(key)

    # -- last partial block of a whole prompt ----------------------------
    def _tail_key(self, parent: bytes, tail_tokens: np.ndarray) -> bytes:
        return self._digest(b"tail:" + parent, tail_tokens)

    def register_tail(self, parent: bytes, tail_tokens: np.ndarray,
                      depth: int, page: int, draft_page: int, feat,
                      first_token: int, trunk_alloc: PageAllocator,
                      draft_alloc: PageAllocator) -> Optional[_TailEntry]:
        """Register a prompt's final partial block, keyed by the parent
        chain hash plus the exact tail tokens (a hit certifies the whole
        prompt), with the boot state of an admission that skips prefill.
        Takes a cache reference per pool page; the registering slot must
        then take a private copy of the block (``cow_write``), since its
        next commit writes into it.  Returns None when cached already."""
        key = self._tail_key(parent, tail_tokens)
        if key in self._tails:
            return None
        trunk_alloc.add_ref([page], cache=True)
        draft_alloc.add_ref([draft_page], cache=True)
        e = _TailEntry(key, depth, len(tail_tokens), int(page),
                       int(draft_page), feat, int(first_token),
                       self.new_tick())
        self._tails[key] = e
        self.tails_inserted += 1
        return e

    def match_tail(self, prompt: np.ndarray, *, touch: bool = True,
                   count: bool = True
                   ) -> Optional[Tuple[List[_PrefixEntry], _TailEntry]]:
        """Whole-prompt lookup for a prompt ending in a partial block: a
        hit when every full block chains AND a tail entry holds the exact
        remaining tokens.  Returns (chain entries, tail entry); ``touch``
        re-stamps chain and tail as one unit."""
        bs = self.block
        n_full = len(prompt) // bs
        if len(prompt) == n_full * bs:
            return None
        if count:
            self.tail_lookups += 1
        chain = self.match(prompt, n_full, touch=False, count=False)
        if len(chain) < n_full:
            return None
        parent = chain[-1].key if n_full else self._ROOT
        e = self._tails.get(self._tail_key(parent, prompt[n_full * bs:]))
        if e is None:
            return None
        if count:
            self.tail_hits += 1
        if touch:
            tick = self.new_tick()
            for c in chain:
                c.tick = tick
            e.tick = tick
        return chain, e

    def evict_lru(self, trunk_alloc: PageAllocator,
                  draft_alloc: PageAllocator, n_pages: int) -> int:
        """Drop least-recently-used entries whose pages only the cache
        holds until `n_pages` trunk pages are freed or no candidate is
        left.  Returns the trunk pages freed.  Within one stamp a tail
        evicts before the chain that certifies it."""
        freed = 0
        cands = sorted(
            list(self._entries.values()) + list(self._tails.values()),
            key=lambda e: (e.tick, -e.depth, 0 if isinstance(e, _TailEntry)
                           else 1))
        for e in cands:
            if freed >= n_pages:
                break
            if (trunk_alloc.refcount(e.page) == 1
                    and draft_alloc.refcount(e.draft_page) == 1):
                if isinstance(e, _TailEntry):
                    del self._tails[e.key]
                    self.tails_evicted += 1
                else:
                    del self._entries[e.key]
                    self.evicted += 1
                freed += len(trunk_alloc.dec_ref([e.page], cache=True))
                draft_alloc.dec_ref([e.draft_page], cache=True)
        return freed

    def clear(self, trunk_alloc: PageAllocator,
              draft_alloc: PageAllocator) -> None:
        """Release every entry's references (a pool reset)."""
        for e in list(self._entries.values()) + list(self._tails.values()):
            trunk_alloc.dec_ref([e.page], cache=True)
            draft_alloc.dec_ref([e.draft_page], cache=True)
        self._entries.clear()
        self._tails.clear()

    # -- persistence across engine rebuilds ------------------------------
    def save_state(self, page_bytes=None) -> dict:
        """Host snapshot of the chain entries, parents first.  Only
        entries with provenance are kept (the snapshot must re-verify);
        tail entries are not (their boot state holds only against the
        pool bytes they were registered with).  ``feat`` becomes a
        float32 numpy array (exact for bf16).  ``page_bytes(page,
        draft_page)`` captures the pool contents; without it the snapshot
        is structure only and cannot be re-seated."""
        ents = []
        for e in self._entries.values():
            if e.tokens is None or e.parent is None:
                continue
            ents.append(dict(
                key=e.key, parent=e.parent, depth=int(e.depth),
                tokens=np.ascontiguousarray(e.tokens, np.int64),
                feat=None if e.feat is None else _feat_numpy(e.feat),
                tick=int(e.tick),
                pages=None if page_bytes is None
                else page_bytes(e.page, e.draft_page)))
        ents.sort(key=lambda d: d["depth"])
        return {"block": self.block, "tick": self._tick, "entries": ents}

    def load_state(self, snap: dict, trunk_alloc: PageAllocator,
                   draft_alloc: PageAllocator, seat_pages,
                   shard: int = 0, feat=None) -> int:
        """Re-attach a ``save_state`` snapshot.  Every entry re-verifies
        its chain hash first: ``_digest(parent, tokens)`` must give the
        stored key and the parent must have verified (or be the root), so
        a corrupted or truncated snapshot certifies nothing it does not
        hold.  ``seat_pages(entry_dict, shard) -> (page, draft_page)``
        takes cache-only pages and writes the blob back; a RuntimeError
        from it (pool pressure) stops early.  ``feat`` maps a stored
        feature to what the entry keeps (the engine: a device tensor).
        Returns the number of entries restored."""
        if snap.get("block") != self.block:
            return 0
        ok = {self._ROOT}
        restored = 0
        for d in snap["entries"]:
            if d["parent"] not in ok and d["parent"] not in self._entries:
                continue                      # orphaned: parent refused
            if self._digest(d["parent"], d["tokens"]) != d["key"]:
                continue                      # chain hash mismatch
            if d["key"] in self._entries:
                ok.add(d["key"])
                continue                      # already live
            if d.get("pages") is None:
                continue                      # structure-only snapshot
            try:
                page, draft_page = seat_pages(d, shard)
            except RuntimeError:
                break                         # pool pressure: stop early
            f = d["feat"] if feat is None or d["feat"] is None \
                else feat(d["feat"])
            e = _PrefixEntry(d["key"], d["depth"], int(page),
                             int(draft_page), f, d["tick"], d["tokens"],
                             d["parent"])
            self._entries[d["key"]] = e
            self._tick = max(self._tick, e.tick)
            ok.add(d["key"])
            restored += 1
        return restored

    def stats(self) -> Dict[str, int]:
        return dict(entries=len(self._entries), lookups=self.lookups,
                    blocks_matched=self.blocks_matched,
                    blocks_seen=self.blocks_seen,
                    tokens_reused=self.blocks_matched * self.block,
                    inserted=self.inserted, evicted=self.evicted,
                    tails=len(self._tails),
                    tail_lookups=self.tail_lookups,
                    tail_hits=self.tail_hits,
                    tails_inserted=self.tails_inserted,
                    tails_evicted=self.tails_evicted)

    def reset_stats(self) -> None:
        """Zero the hit and reuse counters (entries and LRU untouched)."""
        self.lookups = 0
        self.blocks_matched = 0
        self.blocks_seen = 0
        self.inserted = 0
        self.evicted = 0
        self.tail_lookups = 0
        self.tail_hits = 0
        self.tails_inserted = 0
        self.tails_evicted = 0


def _feat_numpy(feat) -> np.ndarray:
    """A stored boundary feature as a host float32 array."""
    if isinstance(feat, torch.Tensor):
        return feat.detach().float().cpu().numpy()
    return np.asarray(feat, np.float32)


def init_paged_pool(num_layers: int, num_pages: int, block: int,
                    num_kv_heads: int, head_dim: int, dtype,
                    device) -> dict:
    """Shared pool + physical-page summaries (no page tables)."""
    kv_shape = (num_layers, num_pages, block, num_kv_heads, head_dim)
    sm_shape = (num_layers, num_pages, num_kv_heads, head_dim)
    return {"k": torch.zeros(kv_shape, dtype=dtype, device=device),
            "v": torch.zeros(kv_shape, dtype=dtype, device=device),
            "kmax": torch.zeros(sm_shape, dtype=torch.float32, device=device),
            "kmin": torch.zeros(sm_shape, dtype=torch.float32, device=device)}


def gather_page_view(pool_l, page_table):
    """One layer's logical contiguous view through the page table:
    pool_l [NP, block, Hk, Dh], page_table [B, NB] -> [B, NB*block, Hk,
    Dh].  Null-page entries read whatever it holds; callers mask."""
    b, nb = page_table.shape
    v = pool_l[page_table.long()]
    return v.reshape((b, nb * pool_l.shape[1]) + tuple(pool_l.shape[2:]))


def paged_write_tokens(pool_l, page_table, start, new, valid=None):
    """Scatter `new` [B, T, Hk, Dh] at per-row logical offsets `start`
    through the table, in place.  Positions beyond the table span clamp
    into the last logical block; unallocated entries and (with `valid`
    [B, T]) pad positions land in the null page.  Several writes may hit
    the same null-page slot: which one wins is unspecified, and every
    read of page 0 is masked."""
    np_, blk = pool_l.shape[:2]
    b, nb = page_table.shape
    t = new.shape[1]
    idx = start.long()[:, None] + torch.arange(t, device=pool_l.device)[None]
    idx = torch.clamp(idx, max=nb * blk - 1)
    pg = torch.gather(page_table.long(), 1, idx // blk)
    if valid is not None:
        pg = torch.where(valid, pg, torch.zeros_like(pg))
    flat = (pg * blk + idx % blk).reshape(-1)
    pool_flat = pool_l.view((np_ * blk,) + tuple(pool_l.shape[2:]))
    pool_flat.index_put_((flat,), new.to(pool_l.dtype).reshape(
        (b * t,) + tuple(pool_l.shape[2:])))
    return pool_l


def paged_update_summaries(kmax_p, kmin_p, pool_l, page_table, start, end,
                           n_touch: int):
    """Recompute (in place) one layer's physical-page summaries of the
    logical blocks covering [start, end) of each row.  kmax_p/kmin_p:
    [NP, Hk, Dh]; pool_l: [NP, block, Hk, Dh]; n_touch: static bound on
    touched blocks per row.  The one-layer case of
    ``paged_update_all_summaries``."""
    paged_update_all_summaries(kmax_p[None], kmin_p[None], pool_l[None],
                               page_table, start, end, n_touch)
    return kmax_p, kmin_p


def paged_update_all_summaries(kmax, kmin, pool, page_table, start, end,
                               n_touch: int):
    """Recompute (in place) every layer's physical-page summaries of the
    logical blocks covering [start, end) of each row: the reference's
    ``paged_update_summaries`` mapped over the layers, in one call of
    the block-summary kernel (K4), which reads the routing from the page
    table on the card.  kmax/kmin: [L, NP, Hk, Dh]; pool: [L, NP, block,
    Hk, Dh].  Out-of-range and unallocated blocks route to the null
    page, which the kernel skips, so its summaries stay 0 (the reference
    resets them after its scatter)."""
    from repro_torch.kernels import ops
    ops.paged_block_summaries(pool, page_table, start, end, n_touch, kmax,
                              kmin)
    return kmax, kmin


# ---------------------------------------------------------------------------
# per-slot (batch-row) surgery, in place: continuous batching writes one
# slot's rows into the engine's static tensors.  Pool keys carry no batch
# axis and pass through; a paged slot prefill already wrote its pages.
# The reference's ``merge_cache_rows`` / ``merge_draft_rows`` (a select
# over the whole pool after every masked step) have no counterpart: an
# inactive row's writes land on the null page or past its length (see
# ``SpecPVEngine.step_fused``), so the pools need no merge.
# ---------------------------------------------------------------------------

PAGED_POOL_KEYS = ("k", "v", "kmax", "kmin")
DRAFT_POOL_KEYS = ("k", "v")
CACHE_BATCH_AXIS = {"k": 1, "v": 1, "kmax": 1, "kmin": 1,
                    "cross_k": 1, "cross_v": 1,
                    "page_table": 0, "length": 0}
# a VLM or audio cache's cross K/V rows [L_cross, B, Te, Hk, Dh], per slot
CROSS_KEYS = ("cross_k", "cross_v")


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without a sync: on the card
    through pinned memory and an asynchronous copy."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def write_row(dst, src, slot: int, axis: int):
    """Copy `src` (one row: a size-1 batch dim at `axis`) into batch row
    `slot` of `dst`, in place."""
    dst.narrow(axis, slot, 1).copy_(src)
    return dst


def select_rows(mask, new, old, axis: int):
    """Per-row select: rows where ``mask`` [B] is True come from `new`."""
    shape = [1] * new.dim()
    shape[axis] = mask.shape[0]
    return torch.where(mask.reshape(shape), new, old)


def write_cache_slot(dst: dict, src: dict, slot: int) -> dict:
    """Copy the single batch row of a batch-1 cache dict `src` into row
    `slot` of `dst`, in place (paged: `src` carries the per-row keys
    only and the pools pass through)."""
    paged = "page_table" in dst
    for name, v in src.items():
        if paged and name in PAGED_POOL_KEYS:
            continue
        write_row(dst[name], v, slot, CACHE_BATCH_AXIS.get(name, 0))
    return dst


def write_draft_slot(dst: dict, src: dict, slot: int) -> dict:
    """The draft cache's ``write_cache_slot`` (batch on axis 0 for every
    key; paged pool keys pass through)."""
    paged = "page_table" in dst
    for name, v in src.items():
        if paged and name in DRAFT_POOL_KEYS:
            continue
        write_row(dst[name], v, slot, 0)
    return dst
