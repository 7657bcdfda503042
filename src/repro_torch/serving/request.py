"""Request and output records of the serving engine (counterpart of
``repro/serving/request.py``).

A request moves through the ``RequestPhase`` lifecycle

    WAITING -> PREFILLING -> DECODING -> FINISHED

``PREFILLING`` covers the window between slot admission and the first
generated token: one tick under blocking admission, several ticks when
prompt chunks are interleaved with decode steps
(``ServingConfig(prefill_budget=...)``).  Cancellation and deadline
eviction apply in every phase.  ``temperature`` (0: greedy), ``seed``
(the slot's stream) and ``draft`` ("tree" or "chain") are per request.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

import numpy as np


class RequestPhase(str, Enum):
    """Lifecycle phase, kept by the continuous scheduler (the wave path
    runs whole requests lock-step and tracks no phase)."""
    WAITING = "waiting"          # submitted, not yet admitted to a slot
    PREFILLING = "prefilling"    # admitted; prompt chunks still running
    DECODING = "decoding"        # first token emitted; speculative decode
    FINISHED = "finished"        # output emitted (any finish_reason)


@dataclass
class Request:
    request_id: str
    prompt: np.ndarray                  # [S] int token ids
    max_new_tokens: int = 128
    eos_id: int = -1
    arrival_s: float = field(default_factory=time.time)
    priority: int = 0                   # higher admitted first
    deadline_s: Optional[float] = None  # absolute; past it the request is
                                        # evicted (finish_reason "deadline")
    cancelled: bool = False
    phase: RequestPhase = RequestPhase.WAITING
    # sampling knobs, with the reference's names and defaults
    temperature: float = 0.0
    seed: int = 0
    draft: str = "tree"

    def cancel(self) -> None:
        """Mark for cancellation; the scheduler evicts the request at its
        next tick or drops it from the wait queue."""
        self.cancelled = True

    def admission_key(self):
        """Sort key for admission: priority desc, then earliest deadline,
        then arrival order."""
        return (-self.priority,
                self.deadline_s if self.deadline_s is not None else
                float("inf"),
                self.arrival_s)


@dataclass
class RequestOutput:
    request_id: str
    tokens: np.ndarray                  # generated ids
    prompt_len: int
    finished: bool
    wave_id: int = -1                   # wave scheduler only
    slot: int = -1                      # continuous scheduler only
    # stop | length | cancelled | deadline | rejected (prompt + budget
    # exceeds the engine's max_len or its page pool)
    finish_reason: str = ""
    latency_s: float = 0.0              # completion - arrival
    mean_accept: float = 0.0
    tokens_per_step: float = 0.0
