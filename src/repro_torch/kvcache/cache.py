"""Blocked KV cache structures (counterpart of ``repro/kvcache/cache.py``,
the parts the lock-step engine uses).

Contiguous cache: ``k/v [L, B, S_max, Hk, Dh]`` with per-row lengths and
per-block summaries ``kmax/kmin [L, B, NB, Hk, Dh]`` (paper eq. (1)).

Paged cache: a shared block pool ``k/v [L, NumPages, block, Hk, Dh]`` with
per-slot page tables ``[B, S_max/block]`` and physical-page summaries
``kmax/kmin [L, NumPages, Hk, Dh]``.  Page 0 is the reserved null page:
unallocated entries point at it, pad and invalid writes land in it, and
it is never read unmasked.  Page ownership lives host-side in
``PageAllocator`` (refcounts plus the zero-copy partial pins).

Unlike the reference's functional updates, the writers here update the
cache tensors in place (the engine consumes the state it steps).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.models.common import update_slice_rows

# ---------------------------------------------------------------------------
# contiguous cache
# ---------------------------------------------------------------------------

def append_layer_kv(k_layer, v_layer, new_k, new_v, length):
    """Write new tokens into one layer's cache at per-row offsets, in
    place.  k_layer: [B, S, Hk, Dh]; new_k: [B, T, Hk, Dh]; length: [B].
    The offset is clamped like the reference's dynamic_update_slice."""
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


# ---------------------------------------------------------------------------
# paged block pool
# ---------------------------------------------------------------------------

class PageAllocator:
    """Host-side refcounted allocator over the shared block pool (the
    reference's allocator without shards, residency tiers, fork or
    copy-on-write: allocation, release, the zero-copy partial pins and
    the occupancy counters the serving scheduler gates admission on).

    Page 0 is the reserved null page and never handed out, so
    ``capacity == num_pages - 1``.  ``_slot_pages[slot][j]`` is the
    physical page of logical block ``j``.  A pin is a real reference plus
    a ``_pin_ref`` count, so a pinned page can never be freed until the
    slot's next refresh drops the pin.  ``high_water`` is the peak of
    ``committed`` pages and ``resident_high_water`` the peak of
    ``in_use``; both move only in ``_track``, where pages leave the free
    list, and survive ``reset``."""

    def __init__(self, num_pages: int):
        assert num_pages >= 2, "need at least one allocatable page"
        self.num_pages = num_pages
        self.high_water = 0             # peak committed (live working set)
        self.resident_high_water = 0    # peak physical (incl. idle cached)
        self.reset()

    def reset(self) -> None:
        # LIFO free list: pop() hands out the lowest pages first
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._ref = np.zeros((self.num_pages,), np.int32)
        self._slot_pages: dict = {}
        self._pin_ref = np.zeros((self.num_pages,), np.int32)
        self._slot_pins: dict = {}

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Physical pages off the free list (incl. idle cached ones)."""
        return self.capacity - self.free

    @property
    def idle(self) -> int:
        """Pages held only by prefix-cache references (no live slot):
        none until prefix sharing is ported, so every page in use is
        committed."""
        return 0

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

    def _track(self) -> None:
        self.high_water = max(self.high_water, self.committed)
        self.resident_high_water = max(self.resident_high_water, self.in_use)

    def alloc(self, slot: int, n: int) -> np.ndarray:
        """Hand `n` fresh (refcount-1) pages to `slot`; raises on
        over-draw with state unchanged."""
        if n > len(self._free):
            raise RuntimeError(f"page pool exhausted: want {n}, have "
                               f"{len(self._free)} free of {self.capacity}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self._ref[p] == 0, f"free page {p} had refcount"
            self._ref[p] = 1
        self._track()
        self._slot_pages.setdefault(slot, []).extend(pages)
        return np.asarray(pages, np.int32)

    def add_ref(self, pages) -> None:
        for p in pages:
            assert self._ref[p] > 0, f"add_ref on free page {p}"
            self._ref[p] += 1

    def dec_ref(self, pages) -> List[int]:
        """Release one reference per page; pages reaching zero return to
        the free list.  Returns the pages actually freed."""
        freed: List[int] = []
        for p in pages:
            assert p != 0, "refcount op on the reserved null page"
            assert self._ref[p] > 0, f"refcount underflow on page {p}"
            self._ref[p] -= 1
            assert not (self._ref[p] == 0 and self._pin_ref[p] > 0), \
                f"page {p} freed while partial-pinned"
            if self._ref[p] == 0:
                self._free.append(int(p))
                freed.append(int(p))
        return freed

    def free_slot(self, slot: int) -> List[int]:
        """Release `slot`'s pins and references (idempotent).  Returns
        the pages actually freed."""
        self.unpin_slot(slot)
        pages = self._slot_pages.pop(slot, [])
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
                    "page_table": 0, "length": 0}


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
