"""Batched SpecPV serving engine (counterpart of
``repro/serving/engine.py``), with two schedulers.

* ``"continuous"`` (default): in-flight batching through
  ``ContinuousScheduler`` over one shared ``SpecPVEngine`` (contiguous
  slots, or the paged pool with ``paged_kv=True``); each slot runs its
  own SpecPV automaton and each decode tick is one fused step over the
  decoding rows (one graph replay on the card).
* ``"wave"``: the lock-step baseline.  Pending requests are bucketed by
  prompt length and run as fixed-size waves through the port's
  ``generate`` on a contiguous greedy engine, as in the reference, which
  ignores the requests' sampling fields; a state architecture
  (``rwkv6-3b``, ``recurrentgemma-2b``) always serves this way, since continuous batching
  drives the attention automaton.

Runs on ``device`` (CUDA unless ``"cpu"`` is asked for), where the
params must live; ``cuda_graphs`` goes to the engines as is.  With
``ServingConfig.mesh_shape`` a ``(D, m)`` shape that the local cards can
fill builds a mesh over ``cuda:0`` .. ``cuda:D*m-1``: the engines shard
their rows and page pools over its data axis
(``core.data_parallel.DataParallelEngine``); a shape they cannot fill
serves unsharded, as in the reference.  Such a mesh puts each model
shard on a card of its own, which tensor parallelism does not run yet
(``m > 1`` then raises NotImplementedError in ``core.engine``): it runs
through ``SpecPVEngine(mesh=)`` with every model shard on one card.
The host tier (``tiered_kv``) serves on any such mesh: each data shard
tiers its own pool, and ``stats`` carries the worst host's peaks
(``peak_pages_per_host``, ``tier_host_bytes_peak_per_host``).
"""
from __future__ import annotations

import math
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import DraftConfig, ModelConfig, SpecPVConfig
from repro_torch.core.engine import SpecPVEngine
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import make_mesh
from repro_torch.serving.request import Request, RequestOutput
from repro_torch.serving.scheduler import ContinuousScheduler, trim_output


@dataclass
class ServingConfig:
    """The reference's serving knobs, every field under its name, with
    its defaults.  So by default the continuous engine is contiguous
    (``paged_kv=False``: admission by free slot, no page gate) with the
    gathered partial cache (``zero_copy_partial=False``), and an
    interleaved prefill (``prefill_budget``) advances its open cursors
    in fused multi-row chunks (``fused_prefill=True``; False: one
    cursor's chunk per dispatch); ``paged_kv=True`` serves from the
    paged pool, gathered or zero-copy.  Copy-on-write prefix sharing
    (``prefix_cache=True``, as in the reference) applies to the paged
    pool only, and so does the host tier of cold trunk pages
    (``tiered_kv=True``, with ``tier_codec`` "int8" or "fp8", or
    ``tier_lossless``); unpaged it is ignored, as in the reference.
    ``mesh_shape`` = (data, model) shards the engines over that many
    local cards (``ServingEngine._mesh``)."""
    batch: int = 4
    max_len: int = 4096
    prefill_chunk: int = 256
    # None: an admission prefills its whole prompt before the tick's
    # decode step; N: each tick runs about max(N, prefill_chunk) prompt
    # tokens of the open cursors, interleaved with decode
    prefill_budget: Optional[int] = None
    # one fused masked step per tick (False: one per distinct mode)
    fused_step: bool = True
    # interleaved prefill: one ragged dispatch per round over every open
    # cursor that fits the budget (False: one cursor's chunk each)
    fused_prefill: bool = True
    partial_verification: bool = True
    pad_id: int = 0
    scheduler: str = "continuous"       # "continuous" | "wave"
    paged_kv: bool = False
    num_pages: Optional[int] = None     # None: batch * max_len/block + 1
    num_draft_pages: Optional[int] = None
    tiered_kv: bool = False
    tier_lossless: bool = False
    tier_codec: str = "int8"
    zero_copy_partial: bool = False
    prefix_cache: bool = True
    mesh_shape: Optional[tuple] = None


class ServingEngine:
    def __init__(self, cfg: ModelConfig, spec: SpecPVConfig,
                 dcfg: DraftConfig, params, draft_params,
                 scfg: Optional[ServingConfig] = None, *, device=None,
                 cuda_graphs: Optional[bool] = None):
        self.scfg = scfg or ServingConfig()
        self.cfg = cfg
        self.spec = spec
        self.dcfg = dcfg
        self.params = params
        self.dparams = draft_params
        self.device = device
        self.cuda_graphs = cuda_graphs
        self.queue: List[Request] = []
        self.outputs: Dict[str, RequestOutput] = {}
        self._engines: Dict[tuple, SpecPVEngine] = {}
        self._continuous: Optional[ContinuousScheduler] = None
        self._wave_id = 0
        self.stats = defaultdict(float)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued or (continuous scheduler) in-flight request.
        The wave path honours cancellation at wave boundaries only."""
        for r in self.queue:
            if r.request_id == request_id:
                r.cancel()
                return True
        if self._continuous is not None:
            return self._continuous.cancel(request_id)
        return False

    def _mesh(self):
        """The serving mesh of ``ServingConfig.mesh_shape`` (data, model):
        None when unset or when the local cards (one CPU device) cannot
        fill it, as in the reference; else a mesh over ``cuda:0`` ..
        ``cuda:n-1``, one card per coordinate.  The engines then shard
        their rows over ``data`` and their weights and heads over
        ``model`` (whose shards must share a card: shards on several cards
        raise NotImplementedError in ``SpecPVEngine``)."""
        shape = self.scfg.mesh_shape
        if shape is None:
            return None
        dev = resolve_device(self.device)
        count = torch.cuda.device_count() if dev.type == "cuda" else 1
        if math.prod(shape) > count:
            return None
        return make_mesh(tuple(shape),
                         devices=None if dev.type == "cuda" else [dev])

    def _engine_for(self, batch: int, *, paged: bool = False) -> SpecPVEngine:
        """The engine of ``batch`` rows: paged (the configured pools, pages
        per request, prefix sharing, tiers and zero-copy as configured) or
        contiguous (the wave path always; the continuous one with
        ``paged_kv=False``), as the reference's ``_engine_for``."""
        key = (batch, paged)
        if key not in self._engines:
            self._engines[key] = SpecPVEngine(
                self.cfg, self.spec, self.dcfg, self.params, self.dparams,
                batch=batch, max_len=self.scfg.max_len,
                partial_verification=self.scfg.partial_verification,
                paged=paged, num_pages=self.scfg.num_pages,
                num_draft_pages=self.scfg.num_draft_pages,
                prefix_cache=self.scfg.prefix_cache,
                tiered=paged and self.scfg.tiered_kv,
                tier_lossless=self.scfg.tier_lossless,
                tier_codec=self.scfg.tier_codec,
                zero_copy=paged and self.scfg.zero_copy_partial,
                mesh=self._mesh(), device=self.device,
                cuda_graphs=self.cuda_graphs)
        return self._engines[key]

    def page_stats(self) -> Dict[str, int]:
        """Resident-page accounting of the continuous engine ({} before
        it exists)."""
        key = (self.scfg.batch, True)
        return self._engines[key].page_stats() if key in self._engines else {}

    def prefix_stats(self) -> Dict[str, int]:
        """Prefix-cache hit and reuse counters of the continuous engine
        ({} before it exists or with sharing off)."""
        key = (self.scfg.batch, True)
        return (self._engines[key].prefix_stats()
                if key in self._engines else {})

    def reset_page_high_water(self) -> None:
        """Zero the resident-page high-water marks (after a warm-up run)."""
        key = (self.scfg.batch, True)
        if key in self._engines:
            self._engines[key].reset_high_water()

    def reset_warm(self) -> None:
        """Forget what a warm-up run left: outputs, stats, the continuous
        scheduler (the next ``run()`` boots a fresh one, emptying the
        pools and clearing the prefix cache), and the page and prefix
        counters.  Captured graphs stay."""
        self.stats.clear()
        self.outputs.clear()
        self._continuous = None
        self.reset_page_high_water()
        key = (self.scfg.batch, True)
        if key in self._engines:
            self._engines[key].reset_prefix_stats()

    # ------------------------------------------------------------------
    # continuous (in-flight) scheduler
    # ------------------------------------------------------------------
    def _run_continuous(self) -> List[RequestOutput]:
        sched = self._continuous
        if sched is None:
            sched = ContinuousScheduler(
                self._engine_for(self.scfg.batch, paged=self.scfg.paged_kv),
                prefill_chunk=self.scfg.prefill_chunk,
                prefill_budget=self.scfg.prefill_budget,
                fused=self.scfg.fused_step,
                fused_prefill=self.scfg.fused_prefill)
            self._continuous = sched
        while self.queue:
            sched.submit(self.queue.pop(0))
        done = sched.run()
        self.outputs.update({o.request_id: o for o in done})
        self.stats["peak_active"] = max(self.stats["peak_active"],
                                        sched.stats.pop("peak_active", 0.0))
        for k in list(sched.stats):
            if k in ("tokens", "wall_s", "steps", "admissions",
                     "page_stalls", "prefix_evictions", "prefill_tokens",
                     "prefill_dispatches", "tier_defers") \
                    or k.startswith(("mode_rows_", "ticks_modes_",
                                     "tick_wall_", "ticks_wall_")):
                self.stats[k] += sched.stats.pop(k)
        # data-parallel engines: the residency that counts is the worst
        # shard's, a max over shards and runs (device pages, and the
        # tier's host bytes)
        ps = self.page_stats()
        for k in ("peak_pages_per_host", "tier_host_bytes_peak_per_host"):
            if k in ps:
                self.stats[k] = max(self.stats[k], float(ps[k]))
        return done

    # ------------------------------------------------------------------
    # wave scheduler (lock-step baseline; state archs)
    # ------------------------------------------------------------------
    def _next_wave(self) -> Optional[List[Request]]:
        if not self.queue:
            return None
        buckets: Dict[int, List[Request]] = defaultdict(list)
        for r in self.queue:
            buckets[len(r.prompt)].append(r)
        length = max(buckets, key=lambda k: len(buckets[k]))
        wave = buckets[length][: self.scfg.batch]
        for r in wave:
            self.queue.remove(r)
        # pad the wave to the full batch with its last request (its output
        # is dropped), so the engine's shapes stay fixed
        while len(wave) < self.scfg.batch:
            wave.append(wave[-1])
        return wave

    def run_one_wave(self) -> List[RequestOutput]:
        """Run one wave from the queue through the port's ``generate``.
        Returns its outputs ([] when the queue is empty)."""
        done: List[RequestOutput] = []
        now = time.time()
        for r in list(self.queue):        # honour pre-wave cancellations
            if r.cancelled:
                self.queue.remove(r)
                out = RequestOutput(
                    request_id=r.request_id,
                    tokens=np.zeros((0,), np.int64),
                    prompt_len=len(r.prompt), finished=False,
                    finish_reason="cancelled",
                    latency_s=now - r.arrival_s)
                self.outputs[r.request_id] = out
                done.append(out)
        wave = self._next_wave()
        if wave is None:
            return done
        t0 = time.time()
        engine = self._engine_for(len(wave))
        prompts = np.stack([r.prompt for r in wave])
        max_new = max(r.max_new_tokens for r in wave)
        toks, stats = engine.generate(prompts, max_new, eos_id=wave[0].eos_id,
                                      prefill_chunk=self.scfg.prefill_chunk)
        t_done = time.time()
        seen = set()
        for i, r in enumerate(wave):
            if r.request_id in seen:
                continue
            seen.add(r.request_id)
            raw = toks[i]
            row = trim_output([int(x) for x in raw[raw >= 0]],
                              r.max_new_tokens, r.eos_id)
            reason = ("stop" if r.eos_id >= 0 and row.size
                      and row[-1] == r.eos_id else "length")
            out = RequestOutput(
                request_id=r.request_id, tokens=row,
                prompt_len=len(r.prompt), finished=True,
                wave_id=self._wave_id, finish_reason=reason,
                latency_s=t_done - r.arrival_s,
                mean_accept=stats["mean_accept"],
                tokens_per_step=stats["tokens_per_step"])
            self.outputs[r.request_id] = out
            done.append(out)
        self.stats["waves"] += 1
        self.stats["wall_s"] += t_done - t0
        self.stats["tokens"] += sum(len(o.tokens) for o in done)
        self._wave_id += 1
        return done

    def _run_wave(self) -> List[RequestOutput]:
        done: List[RequestOutput] = []
        while self.queue:
            done.extend(self.run_one_wave())
        return done

    # ------------------------------------------------------------------
    def run(self) -> List[RequestOutput]:
        """Drain the queue; returns outputs in completion order."""
        if self.scfg.scheduler == "continuous":
            if self.cfg.is_attention_arch:
                return self._run_continuous()
            return self._run_wave()        # state archs: lock-step only
        if self.scfg.scheduler == "wave":
            return self._run_wave()
        raise ValueError(f"unknown scheduler {self.scfg.scheduler!r}")

    def throughput_tok_s(self) -> float:
        return self.stats["tokens"] / max(self.stats["wall_s"], 1e-9)
