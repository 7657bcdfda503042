"""Cache traffic accounting (counterpart of the billing half of
``repro/kvcache/offload.py``): bytes of cache touched per step mode."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class TrafficMeter:
    bytes_by_mode: Dict[str, int] = field(default_factory=dict)
    steps_by_mode: Dict[str, int] = field(default_factory=dict)

    def record(self, mode: str, nbytes: int) -> None:
        self.bytes_by_mode[mode] = self.bytes_by_mode.get(mode, 0) + nbytes
        self.steps_by_mode[mode] = self.steps_by_mode.get(mode, 0) + 1

    def total(self) -> int:
        return sum(self.bytes_by_mode.values())


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
