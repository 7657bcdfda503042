"""Cache residency tiers and traffic accounting (counterpart of
``repro/kvcache/offload.py``).

``TrafficMeter`` tallies the bytes of cache each step mode touches (the
quantity a host link or HBM pays for).  ``TierManager`` moves the bytes
of cold trunk pages between the paged pool and host memory: once a slot
has refreshed, the complete blocks below its length are read by no
partial step until the next full-cache pass, so they are demoted
(quantized to int8 or e4m3 with bf16 scales, or raw when lossless, and
copied to the host with their page summaries), their pages recycled,
and promoted back ahead of the refresh that reads them: prefetched one
mode transition ahead, or copied synchronously when a refresh comes
early.  The draft pool is read every step and is never tiered.

On the card the host copies are pinned tensors and every host-link
transfer of a prefetch or demotion runs on one side stream: a demotion
gathers and quantizes on the engine's stream, then the side stream waits
for that work and copies to the host; a prefetch copies back on the side
stream; a promotion makes the engine's stream wait for the prefetch
(or copies on the engine's stream itself after the demotion's copy),
then dequantizes into the pool and writes the summaries and the page
table in place, where the captured graphs read them.  Nothing here reads
the card.  On the CPU the same steps run synchronously on plain tensors.

The pool's leading axis is walked whole, so a tensor-parallel engine's
shard-stacked pool ([m * L, pages, block, Hk / m, Dh]) tiers unchanged:
the scales are per (token, head), so a head split leaves every scale,
every payload byte and the bytes billed as the unsharded pool's.  Host
bytes are billed per data shard (``HostBytes``, through the allocator's
``slot_shard``): one shard is one host, and its peak is what that host
must hold.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kvcache.cache import to_device
from repro_torch.kvcache.quant import (dequantize_kv, quantize_kv,
                                       quantize_kv_fp8)


@dataclass
class TrafficMeter:
    bytes_by_mode: Dict[str, int] = field(default_factory=dict)
    steps_by_mode: Dict[str, int] = field(default_factory=dict)

    def record(self, mode: str, nbytes: int) -> None:
        self.bytes_by_mode[mode] = self.bytes_by_mode.get(mode, 0) + nbytes
        self.steps_by_mode[mode] = self.steps_by_mode.get(mode, 0) + 1

    def total(self) -> int:
        return sum(self.bytes_by_mode.values())

    def modelled_time_s(self, link_gb_s: float) -> float:
        """Time to move the recorded bytes over a link of ``link_gb_s``
        gigabytes (not gigabits) per second."""
        return self.total() / (link_gb_s * 1e9)


def full_step_bytes(num_layers: int, batch: int, ctx_len: int, hk: int,
                    dh: int, itemsize: int) -> int:
    """Bytes of full cache read by one full/refresh verification step
    (heterogeneous rows: ``batch=1`` with ``ctx_len`` the per-row sum)."""
    return 2 * num_layers * batch * ctx_len * hk * dh * itemsize


def partial_step_bytes(num_layers: int, batch: int, partial_tokens: int,
                       hk: int, dh: int, itemsize: int) -> int:
    """Bytes of partial cache read per partial step."""
    return 2 * num_layers * batch * partial_tokens * hk * dh * itemsize


def routed_refresh_bytes(num_layers: int, batch: int, num_blocks: int,
                         num_sel: int, buffer_tokens: int, hk: int,
                         dh: int, itemsize: int) -> int:
    """Zero-copy refresh rebuild bill (on top of the full verify read):
    page summaries scored (fp32 kmax + kmin), the selected-block index
    writes (int32) and the tail-buffer reset (pool dtype)."""
    summaries = 2 * num_layers * num_blocks * hk * dh * 4
    index_writes = num_layers * hk * num_sel * 4
    tail = 2 * num_layers * buffer_tokens * hk * dh * itemsize
    return batch * (summaries + index_writes + tail)


# ---------------------------------------------------------------------------
# tiered residency (host offload of cold pages)
# ---------------------------------------------------------------------------

def _ids(ints, device: torch.device) -> torch.Tensor:
    """Page or block ids as an int64 tensor on ``device``, without a
    sync."""
    return to_device(np.asarray(ints, np.int64), device)


class _HostSegment:
    """One demotion of a slot's cold blocks, held on the host.

    ``arrays`` is (k, v, k scales, v scales, kmax, kmin): k/v int8 or
    e4m3 [L, n, block, Hk, Dh] with bf16 scales [L, n, block, Hk] (raw
    pool-dtype k/v and None scales when lossless), and the fp32 page
    summaries [L, n, Hk, Dh], kept so that promotion restores retrieval
    scoring bit for bit.  On the card they are pinned, ``copied`` is the
    side-stream event after which they hold the bytes, and a prefetch
    leaves its device copies in ``dev`` with ``landed`` the event after
    which those hold them; ``device`` is the pool's."""

    __slots__ = ("blocks", "arrays", "device", "nbytes", "copied", "dev",
                 "landed")

    def __init__(self, blocks: List[int], arrays, device: torch.device,
                 copied=None):
        self.blocks = blocks            # logical block indices
        self.arrays = arrays
        self.device = device
        self.nbytes = sum(a.numel() * a.element_size()
                          for a in arrays if a is not None)
        self.copied = copied
        self.dev = None
        self.landed = None


class HostBytes:
    """The host bytes the tier holds: in all (``total`` and its peak
    ``peak``) and per data shard (``by`` and ``peak_by``; one shard is
    one host).  The tier managers of a data-parallel engine's shards
    share one, so its peaks are those of the whole engine over time."""

    def __init__(self, shards: int = 1):
        self.total = 0
        self.peak = 0
        self.by = [0] * shards
        self.peak_by = [0] * shards

    def bill(self, shard: int, nbytes: int) -> None:
        self.total += nbytes
        self.by[shard] += nbytes
        self.peak = max(self.peak, self.total)
        self.peak_by[shard] = max(self.peak_by[shard], self.by[shard])


def tier_stats(managers, hosted_pages: int, host: HostBytes) -> Dict[str, int]:
    """The reference's tier counters of ``managers`` (summed) over one
    host account: with more than one data shard, also the worst host's
    peak (``tier_host_bytes_peak_per_host``) and each shard's
    (``tier_host_bytes_peak_shard_{s}``)."""
    out = dict(tier_hosted_pages=hosted_pages,
               tier_demoted_pages=sum(m.demoted_pages for m in managers),
               tier_promoted_pages=sum(m.promoted_pages for m in managers),
               tier_prefetch_hits=sum(m.prefetch_hits for m in managers),
               tier_sync_promotes=sum(m.sync_promotes for m in managers),
               tier_host_bytes=host.total,
               tier_host_bytes_peak=host.peak)
    if len(host.peak_by) > 1:
        out["tier_host_bytes_peak_per_host"] = max(host.peak_by)
        for s, b in enumerate(host.peak_by):
            out[f"tier_host_bytes_peak_shard_{s}"] = b
    return out


class TierManager:
    """The host tier over one trunk ``PageAllocator``: the allocator keeps
    the page bookkeeping (``demote`` / ``promote``), this class the bytes
    and the reference's counters, and bills each transfer in ``traffic``
    as the bytes that cross the link (int8/fp8 and scales: about half
    the raw bill).  Only pages a slot owns alone demote: a shared page
    may be another slot's hot prefix.  ``copy_log``, when a list, gets
    ``(what, bytes, start event, end event)`` for each part of a tier
    operation on the card ("quantize", "to_host", "to_device",
    "restore"), timed by CUDA events.  ``host`` is the ``HostBytes``
    account it bills (its own by default, one entry per shard of the
    allocator)."""

    def __init__(self, alloc, *, lossless: bool = False,
                 codec: str = "int8", traffic=None,
                 host: Optional[HostBytes] = None):
        if codec not in ("int8", "fp8"):
            raise ValueError(f"unknown tier codec {codec!r}")
        self.alloc = alloc
        self.lossless = lossless
        self.codec = codec
        self.traffic = traffic
        self.host = host if host is not None else HostBytes(alloc.shards)
        self.copy_log: Optional[list] = None
        self._side: Optional[torch.cuda.Stream] = None
        self._host: Dict[int, List[_HostSegment]] = {}
        self.demoted_pages = 0
        self.promoted_pages = 0
        self.prefetch_hits = 0
        self.sync_promotes = 0

    @property
    def host_bytes(self) -> int:
        return self.host.total

    @property
    def host_bytes_peak(self) -> int:
        return self.host.peak

    def reset(self) -> None:
        """Forget every slot's host copies (a reset pool): their bytes
        leave the account, whose peaks stay."""
        for slot in list(self._host):
            self.drop_slot(slot)

    def hosted(self, slot: int) -> int:
        """Hosted (promotion-owed) pages of `slot`."""
        return self.alloc.hosted_count(slot)

    def _bill_host(self, slot: int, nbytes: int) -> None:
        self.host.bill(self.alloc.slot_shard(slot), nbytes)

    def stats(self) -> Dict[str, int]:
        return tier_stats([self], self.alloc.hosted_total, self.host)

    # ------------------------------------------------------------------
    def _side_stream(self, device) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(device)
        return self._side

    def _event(self, stream):
        """An event recorded on ``stream`` when ``copy_log`` is on."""
        if self.copy_log is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _log(self, what: str, nbytes: int, start, stream) -> None:
        if start is not None:
            self.copy_log.append((what, nbytes, start, self._event(stream)))

    def _encode(self, cache: Dict, pidx: torch.Tensor):
        """The device arrays of pages ``pidx``: gathered (and quantized
        one layer at a time, so no fp32 copy of every layer exists at
        once), in ``_HostSegment`` order."""
        if self.lossless:
            kv = [cache["k"][:, pidx], cache["v"][:, pidx], None, None]
        else:
            qfn = quantize_kv_fp8 if self.codec == "fp8" else quantize_kv
            qdt = torch.float8_e4m3fn if self.codec == "fp8" else torch.int8
            pool = cache["k"]
            shape = (pool.shape[0], pidx.numel()) + tuple(pool.shape[2:])
            q = [torch.empty(shape, dtype=qdt, device=pool.device)
                 for _ in range(2)]
            s = [torch.empty(shape[:-1], dtype=torch.bfloat16,
                             device=pool.device) for _ in range(2)]
            for i, name in enumerate(("k", "v")):
                for layer in range(shape[0]):
                    q[i][layer], s[i][layer] = qfn(cache[name][layer, pidx])
            kv = [q[0], q[1], s[0], s[1]]
        return tuple(kv + [cache["kmax"][:, pidx], cache["kmin"][:, pidx]])

    def demote_slot(self, cache: Dict, slot: int, length: int) -> Dict:
        """Offload `slot`'s cold blocks: the complete blocks strictly
        below `length` (every later write lands at ``[length, ...)``, so
        they are read-only until the next full-cache pass) that the slot
        owns alone.  Their pages return to the free list and the slot's
        page-table entries point at the null page (in place).  Returns
        the cache dict; a no-op when nothing qualifies."""
        al = self.alloc
        bs = cache["k"].shape[2]
        blocks = [j for j in range(min(length // bs, al.count(slot)))
                  if al.demotable(slot, j)]
        if not blocks:
            return cache
        dev = cache["k"].device
        pidx = _ids([al.page_at(slot, j) for j in blocks], dev)
        if dev.type != "cuda":
            seg = _HostSegment(blocks, self._encode(cache, pidx), dev)
        else:
            cur = torch.cuda.current_stream(dev)
            side = self._side_stream(dev)
            t0 = self._event(cur)
            arrays = self._encode(cache, pidx)
            ready = torch.cuda.Event()
            ready.record(cur)
            self._log("quantize", 0, t0, cur)
            side.wait_event(ready)
            host = tuple(None if a is None else
                         torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                         for a in arrays)
            with torch.cuda.stream(side):
                t0 = self._event(side)
                for a, h in zip(arrays, host):
                    if a is not None:
                        h.copy_(a, non_blocking=True)
                        a.record_stream(side)   # freed after the copy
            copied = torch.cuda.Event()
            copied.record(side)
            seg = _HostSegment(blocks, host, dev, copied)
            self._log("to_host", seg.nbytes, t0, side)
        bidx = _ids(blocks, dev)
        cache["page_table"][slot].index_fill_(0, bidx, 0)
        self._host.setdefault(slot, []).append(seg)
        for j in blocks:
            al.demote(slot, j)
        self.demoted_pages += len(blocks)
        self._bill_host(slot, seg.nbytes)
        if self.traffic is not None:
            self.traffic.record("demote", seg.nbytes)
        return cache

    def _upload(self, seg: _HostSegment, stream=None):
        """Device copies of a segment's arrays: on the CPU the arrays
        themselves; on the card copied on ``stream`` after the demotion's
        copy to the host, with ``seg.landed`` recorded after them."""
        dev = seg.device
        if dev.type != "cuda":
            return seg.arrays
        with torch.cuda.stream(stream):
            out = tuple(None if h is None else
                        torch.empty(h.shape, dtype=h.dtype, device=dev)
                        for h in seg.arrays)
            stream.wait_event(seg.copied)
            t0 = self._event(stream)
            for d, h in zip(out, seg.arrays):
                if h is not None:
                    d.copy_(h, non_blocking=True)
            seg.landed = torch.cuda.Event()
            seg.landed.record(stream)
            self._log("to_device", seg.nbytes, t0, stream)
        return out

    def prefetch_slot(self, slot: int) -> None:
        """Start the host-to-device copy of `slot`'s hosted segments (on
        the card on the side stream, overlapping the partial steps still
        to run before the refresh).  Idempotent: a prefetched segment is
        left as it is."""
        for seg in self._host.get(slot, []):
            if seg.dev is None:
                side = (self._side_stream(seg.device)
                        if seg.device.type == "cuda" else None)
                seg.dev = self._upload(seg, side)

    def promote_slot(self, cache: Dict, slot: int) -> Dict:
        """Bring every hosted page of `slot` back ahead of a full-cache
        read: seat fresh pages, dequantize into the pool (its dtype),
        restore the page summaries and repoint the page table, all in
        place.  A segment that was not prefetched is copied on the
        engine's stream first (``sync_promotes``, the early-refresh
        path).  Raises through the allocator when the pool cannot seat
        it; callers reclaim or defer first."""
        segs = self._host.pop(slot, [])
        if not segs:
            return cache
        dev = cache["k"].device
        pool_dtype = cache["k"].dtype
        cur = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        for seg in segs:
            if seg.dev is None:
                self.sync_promotes += 1
                arrays = self._upload(seg, cur)
            else:
                self.prefetch_hits += 1
                arrays = seg.dev
                if cur is not None:
                    cur.wait_event(seg.landed)
                    for a in arrays:
                        if a is not None:
                            a.record_stream(cur)    # made on the side
            t0 = self._event(cur) if cur is not None else None
            pages = [self.alloc.promote(slot, j) for j in seg.blocks]
            pidx = _ids(pages, dev)
            k, v, ks, vs, kmax, kmin = arrays
            for name, q, s in (("k", k, ks), ("v", v, vs)):
                pool = cache[name]
                if s is None:
                    pool[:, pidx] = q.to(pool_dtype)
                else:
                    for layer in range(pool.shape[0]):
                        pool[layer, pidx] = dequantize_kv(
                            q[layer], s[layer], dtype=pool_dtype)
            cache["kmax"][:, pidx] = kmax
            cache["kmin"][:, pidx] = kmin
            cache["page_table"][slot, _ids(seg.blocks, dev)] = \
                pidx.to(torch.int32)
            if cur is not None:
                self._log("restore", 0, t0, cur)
            self.promoted_pages += len(seg.blocks)
            self._bill_host(slot, -seg.nbytes)
            if self.traffic is not None:
                self.traffic.record("promote", seg.nbytes)
        return cache

    def drop_slot(self, slot: int) -> None:
        """Discard `slot`'s host copies (eviction or reset: ``free_slot``
        clears the allocator's side).  A pinned buffer still being
        written is only reused once its copy has finished."""
        for seg in self._host.pop(slot, []):
            self._bill_host(slot, -seg.nbytes)
