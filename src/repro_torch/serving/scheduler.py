"""Continuous (in-flight) batching over one shared ``SpecPVEngine``
(counterpart of ``repro/serving/scheduler.py``).

The engine's batch rows are B independent slots.  A request is admitted
into a free slot as soon as one opens and its shared page pools can hold
its prompt and generation budget (``stats["page_stalls"]`` counts the
times a waiter did not fit), prefills into the slot chunk by chunk, runs
the SpecPV mode automaton (Full -> Refresh -> Partial* -> Refresh) on its
own, and is evicted the moment it finishes, cancels or misses its
deadline; the next waiter takes the slot.  Admission order is priority
desc, then earliest deadline, then arrival.

Each decode tick is one fused step over the decoding rows
(``SpecPVEngine.step_fused``: the row mask and the per-row modes are
operands, so the card replays one graph per tick whatever the mix);
``fused=False`` runs one masked step per distinct mode (the grouped A/B
path).  Rows are independent, so each request's tokens equal a solo
``SpecPVEngine.generate`` of it wherever the arithmetic does not depend
on the batch (fp32; bf16 GEMMs on the card choose their algorithm by
the row count).

``prefill_budget=None`` admits blocking: the whole prompt prefills in
the admission tick.  ``prefill_budget=N`` opens a resumable cursor
(phase PREFILLING) and each tick advances the open cursors, oldest
admission first, by whole chunks until about N prompt tokens have run
(the serial pump, ``_pump_prefill_serial``), then steps the decoding
slots.  Chunk boundaries stay absolute, so interleaved tokens equal
blocking ones.  The reference's fused multi-row prefill
(``fused_prefill=True``) is ROADMAP.md queue 1, 'Batched prefill'.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.engine import (MODE_NAMES, MODE_PARTIAL, MODE_REFRESH,
                                     MODE_FULL, PrefillCursor, SpecPVEngine,
                                     _unsupported)
from repro_torch.serving.request import Request, RequestOutput, RequestPhase


def trim_output(tokens: List[int], max_new: int, eos_id: int) -> np.ndarray:
    """Clip a generated-token list to the request contract: at most
    ``max_new`` tokens, truncated just after the first EOS."""
    row = np.asarray(tokens[:max_new], np.int64)
    if eos_id >= 0 and (row == eos_id).any():
        row = row[: int(np.argmax(row == eos_id)) + 1]
    return row


@dataclass
class _Slot:
    req: Request
    admit_s: float
    seq: int = 0                    # admission order (prefill FIFO)
    cursor: Optional[PrefillCursor] = None  # open resumable prefill
    tokens: List[int] = field(default_factory=list)
    accepts: List[int] = field(default_factory=list)
    steps: int = 0
    eos_at: Optional[int] = None    # index of the first EOS

    def append(self, toks: List[int]) -> None:
        if self.req.eos_id >= 0 and self.eos_at is None:
            for j, t in enumerate(toks):
                if t == self.req.eos_id:
                    self.eos_at = len(self.tokens) + j
                    break
        self.tokens.extend(toks)

    def done_reason(self) -> Optional[str]:
        if self.eos_at is not None and self.eos_at < self.req.max_new_tokens:
            return "stop"
        if len(self.tokens) >= self.req.max_new_tokens:
            return "length"
        return None


class ContinuousScheduler:
    """Slot scheduler over one shared ``SpecPVEngine`` (see the module
    docstring).  ``stats["steps"]`` counts decode dispatches,
    ``stats["mode_rows_<mode>"]`` the rows stepped per mode and
    ``stats["ticks_modes_<k>"]`` the decode ticks by their number of
    distinct modes; ``tick_wall`` keeps each decode tick's wall time by
    tick class (``_tick_class``).  ``record_steps`` appends
    ``(clock(), request_id, n_tokens)`` to ``step_log`` for every slot
    that decodes in a tick."""

    def __init__(self, engine: SpecPVEngine, *, prefill_chunk: int = 256,
                 prefill_budget: Optional[int] = None,
                 record_steps: bool = False,
                 fused: bool = True,
                 fused_prefill: bool = False,
                 clock: Callable[[], float] = time.time):
        if not engine.is_attn:
            raise ValueError("continuous batching drives the per-slot "
                             "SpecPV automaton (attention archs); state "
                             "archs use the wave path")
        if fused_prefill:
            _unsupported("the fused multi-row prefill (fused_prefill=True)",
                         "Batched prefill")
        assert prefill_budget is None or prefill_budget > 0, \
            "prefill_budget must be positive (None = blocking prefill)"
        self.engine = engine
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = prefill_budget
        self.record_steps = record_steps
        self.fused = fused
        self.clock = clock
        self.st = engine.empty_state()
        self.slots: List[Optional[_Slot]] = [None] * engine.batch
        self._dirty: set = set()        # evicted, not yet reset/refilled
        self._seq = 0                   # admission counter (prefill FIFO)
        self.waiting: List[Request] = []
        self.outputs: Dict[str, RequestOutput] = {}
        self.done_order: List[RequestOutput] = []
        self.trace: List[tuple] = []        # (event, request_id, slot)
        self.step_log: List[tuple] = []     # (t, request_id, n_tokens)
        self.stats = defaultdict(float)
        self.tick_wall: Dict[str, List[float]] = defaultdict(list)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.temperature != 0.0 or req.draft != "tree":
            _unsupported("sampled or chain requests", "Sampling")
        self.waiting.append(req)

    def cancel(self, request_id: str) -> bool:
        """Mark a waiting or in-flight request cancelled (takes effect at
        the next tick).  Returns False for unknown or finished ones."""
        for r in self.waiting:
            if r.request_id == request_id:
                r.cancel()
                return True
        for s in self.slots:
            if s is not None and s.req.request_id == request_id:
                s.req.cancel()
                return True
        return False

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.num_active > 0

    # ------------------------------------------------------------------
    def _emit(self, req: Request, slot: int, tokens: List[int],
              finished: bool, reason: str, *, accepts=(), steps=0) -> None:
        out = RequestOutput(
            request_id=req.request_id,
            tokens=trim_output(tokens, req.max_new_tokens, req.eos_id),
            prompt_len=len(req.prompt), finished=finished, slot=slot,
            finish_reason=reason,
            latency_s=max(0.0, self.clock() - req.arrival_s),
            mean_accept=float(np.mean(accepts)) if len(accepts) else 0.0,
            tokens_per_step=(len(tokens) / steps if steps else 0.0))
        req.phase = RequestPhase.FINISHED
        self.outputs[req.request_id] = out
        self.done_order.append(out)
        self.stats["tokens"] += len(out.tokens)
        self.trace.append(("finish:" + reason, req.request_id, slot))

    def _evict(self, i: int, reason: str) -> None:
        s = self.slots[i]
        self._emit(s.req, i, s.tokens, finished=(reason in ("stop", "length")),
                   reason=reason, accepts=s.accepts, steps=s.steps)
        self.slots[i] = None
        # pages go back now, so same-tick admission sees them; the row
        # reset waits until after admission (a refill rewrites the row)
        self.engine.release_slot_pages(i)
        self._dirty.add(i)

    # ------------------------------------------------------------------
    def _admissible(self, now: float) -> List[Request]:
        ready = [r for r in self.waiting if r.arrival_s <= now]
        return sorted(ready, key=Request.admission_key)

    def _admit(self) -> None:
        now = self.clock()
        for r in list(self.waiting):            # cancelled / expired first
            if r.cancelled:
                self.waiting.remove(r)
                self._emit(r, -1, [], finished=False, reason="cancelled")
            elif r.deadline_s is not None and r.deadline_s < now:
                self.waiting.remove(r)
                self._emit(r, -1, [], finished=False, reason="deadline")
        eng = self.engine
        free = [i for i, s in enumerate(self.slots) if s is None]
        for req in self._admissible(now):
            if not free:
                break
            need = len(req.prompt) + req.max_new_tokens + eng.pmax
            need_pages = eng.pages_needed(len(req.prompt), req.max_new_tokens)
            if need > eng.max_len or need_pages > eng.page_capacity():
                self.waiting.remove(req)
                self._emit(req, -1, [], finished=False, reason="rejected")
                continue
            # the page gate: the request's whole plan must be free now;
            # one that does not fit stays queued while smaller waiters
            # may proceed
            need_fresh = eng.pages_needed_shared(req.prompt,
                                                 req.max_new_tokens)
            margin = eng.tier_admit_margin(len(req.prompt))
            short = need_fresh + margin - eng.free_pages()
            if short > 0:
                self.stats["prefix_evictions"] += eng.reclaim_pages(short)
            if need_fresh + margin > eng.free_pages():
                self.stats["page_stalls"] += 1
                continue
            i = free.pop(0)
            self.waiting.remove(req)
            req.phase = RequestPhase.PREFILLING
            slot = _Slot(req=req, admit_s=now, seq=self._seq)
            self._seq += 1
            if self.prefill_budget is None:
                # blocking admission: the whole prompt prefills now
                self.st, first = eng.prefill_into_slot(
                    self.st, i, req.prompt, chunk=self.prefill_chunk,
                    max_new_tokens=req.max_new_tokens)
                req.phase = RequestPhase.DECODING
                slot.append([first])
            else:
                # interleaved: chunks run in _pump_prefill_serial
                self.st, slot.cursor = eng.prefill_begin_slot(
                    self.st, i, req.prompt, chunk=self.prefill_chunk,
                    max_new_tokens=req.max_new_tokens)
            self._dirty.discard(i)
            self.slots[i] = slot
            self.stats["admissions"] += 1
            self.trace.append(("admit", req.request_id, i))
        # slots that stayed free get their rows neutralised once
        for i in sorted(self._dirty):
            self.st = eng.reset_slot(self.st, i)
        self._dirty.clear()

    def _finalize_prefill(self, i: int) -> None:
        """Commit an exhausted cursor: the slot enters DECODING and may
        step in this same tick."""
        s = self.slots[i]
        self.st, first = self.engine.prefill_finalize_slot(self.st, s.cursor)
        s.cursor = None
        s.req.phase = RequestPhase.DECODING
        s.append([first])
        self.trace.append(("prefill_done", s.req.request_id, i))

    def _pump_prefill_serial(self) -> int:
        """Advance the open prefill cursors, oldest admission first, by
        whole chunks until the per-tick budget is spent (the first chunk
        always runs, so prefill never starves).  Returns tokens run."""
        spent, d0 = 0, self.engine.prefill_dispatches
        order = sorted((s.seq, i) for i, s in enumerate(self.slots)
                       if s is not None and s.cursor is not None)
        for _, i in order:
            s = self.slots[i]
            while s.cursor is not None:
                if not s.cursor.done:
                    if spent and spent + s.cursor.next_tokens > \
                            self.prefill_budget:
                        break
                    self.st, n = self.engine.prefill_step_into_slot(
                        self.st, s.cursor)
                    spent += n
                if s.cursor.done:
                    self._finalize_prefill(i)
            if spent and spent >= self.prefill_budget:
                break
        if spent:
            self.stats["prefill_tokens"] += spent
            self.stats["prefill_dispatches"] += \
                self.engine.prefill_dispatches - d0
        return spent

    # ------------------------------------------------------------------
    def tick(self) -> bool:
        """One round: evict, admit, pump prefill chunks (when
        interleaving), step the decoding slots.  Returns True when a
        decode step or prefill progress ran."""
        now = self.clock()
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            if s.req.cancelled:
                self._evict(i, "cancelled")
            elif s.done_reason():
                self._evict(i, s.done_reason())
            elif s.req.deadline_s is not None and s.req.deadline_s < now:
                self._evict(i, "deadline")
        self._admit()
        prefilled = (self._pump_prefill_serial() if self.prefill_budget
                     else 0)

        # slots mid-prefill have no automaton state yet: their device rows
        # are neutral and they sit the decode step out
        active = np.array([s is not None and s.cursor is None
                           for s in self.slots], bool)
        self.stats["peak_active"] = max(self.stats["peak_active"],
                                        float(np.sum(active)))
        if not active.any():
            return prefilled > 0
        modes = self.engine.modes_for_rows(self.st, active)
        active, deferred = self.engine.tier_ready_rows(
            active, modes, force=(prefilled == 0))
        if deferred:
            self.stats["tier_defers"] += deferred
        if not active.any():
            return prefilled > 0
        distinct = sorted({int(m) for m in modes[active]})
        self.stats[f"ticks_modes_{len(distinct)}"] += 1
        for mid in distinct:
            self.stats["mode_rows_" + MODE_NAMES[mid]] += int(
                np.sum(active & (modes == mid)))
        t_dec = self.clock()
        if self.fused:
            self.st, so = self.engine.step_fused(self.st, active, modes)
            self.stats["steps"] += 1
            self._harvest(so, active)
        else:
            for mid in distinct:
                mask = active & (modes == mid)
                self.st, so = self.engine.step_rows(self.st,
                                                    MODE_NAMES[mid], mask)
                self.stats["steps"] += 1
                self._harvest(so, mask)
        # the step read its tokens back, so the card has finished it
        cls = self._tick_class(modes, active)
        dt = self.clock() - t_dec
        self.tick_wall[cls].append(dt)
        self.stats["tick_wall_" + cls] += dt
        self.stats["ticks_wall_" + cls] += 1
        return True

    @staticmethod
    def _tick_class(modes: np.ndarray, active: np.ndarray) -> str:
        """"refresh" when any row refreshed, "partial" when every row was
        partial, else "full" or "mixed"."""
        m = modes[active]
        if np.any(m == MODE_REFRESH):
            return "refresh"
        if np.all(m == MODE_PARTIAL):
            return "partial"
        return "full" if np.all(m == MODE_FULL) else "mixed"

    def _harvest(self, so, mask: np.ndarray) -> None:
        """Collect one step's tokens into the stepped slots."""
        t_step = self.clock() if self.record_steps else 0.0
        for i in np.nonzero(mask)[0]:
            s = self.slots[i]
            s.append([int(x) for x in so.tokens[i, : so.counts[i]]])
            s.accepts.append(int(so.accept_len[i]))
            s.steps += 1
            if self.record_steps:
                self.step_log.append((t_step, s.req.request_id,
                                      int(so.counts[i])))

    def run(self) -> List[RequestOutput]:
        """Drive ticks until the queue and every slot drain; returns this
        call's outputs in completion order.  ``clock`` must advance with
        wall time (a frozen clock drives ``tick()`` directly)."""
        t0 = self.clock()
        start = len(self.done_order)
        while self.has_work():
            progressed = self.tick()
            if not progressed and self.waiting:
                # every slot idle; the next request has not arrived yet
                delay = min(r.arrival_s for r in self.waiting) - self.clock()
                if delay > 0:
                    time.sleep(min(delay, 0.02))
        self.stats["wall_s"] += self.clock() - t0
        return self.done_order[start:]
