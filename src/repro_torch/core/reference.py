"""Greedy autoregressive decoding (counterpart of
``repro/core/reference.py:autoregressive_generate``), in two forms.

``autoregressive_generate`` is the losslessness oracle: on the port's
contiguous cache through the plain attention and summaries
(``plain=True``, a keyword only this oracle passes, so the engine never
takes that route), or, for a state arch, one read-only decode and one
``advance`` per token, eagerly.

``CompiledAR`` is the speed baseline, the counterpart of the reference's
``jax.jit(step)``: the same decoding on the kernel route (the prefill
through K2 and K4, each step a Full verification of one token through
K1 on the contiguous cache and its commit through K4), each decode step
replayed as one CUDA graph on the card.  In fp32 it gives the oracle's
tokens."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, SpecPVConfig
from repro_torch.core import verify as vf
from repro_torch.core.engine import capture_graph
from repro_torch.kernels import ops
from repro_torch.device import resolve_device
from repro_torch.models import api


def autoregressive_generate(cfg: ModelConfig, params, prompt: np.ndarray,
                            max_new_tokens: int, *, max_len: int,
                            prefill_chunk: int = 256,
                            spec: Optional[SpecPVConfig] = None,
                            device=None) -> np.ndarray:
    """Greedy AR decoding.  Returns tokens [B, max_new]."""
    spec = spec or SpecPVConfig()
    dev = resolve_device(device)
    b, s0 = prompt.shape
    cache = api.init_cache(cfg, b, max_len, spec, device=dev)
    prompt_t = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                               device=dev)
    logits = None
    for off in range(0, s0, prefill_chunk):
        logits, _, cache = api.prefill(cfg, params,
                                       prompt_t[:, off: off + prefill_chunk],
                                       cache, spec=spec, plain=True)
    cur = torch.argmax(logits, dim=-1)
    out = [cur]
    ones = torch.ones((b,), dtype=torch.int32, device=dev)
    for _ in range(max_new_tokens - 1):
        pos = cache["length"][:, None]
        o = api.decode(cfg, params, cur[:, None], pos, cache, mode="full",
                       spec=spec, plain=True)
        nxt = torch.argmax(o.logits[:, 0], dim=-1)
        if cfg.is_attention_arch:
            ck, cv = o.new_kv
            cache = vf.append_full_cache(cache, ck, cv, ones, spec,
                                         plain=True)
        else:
            cache = api.advance(cfg, params, cur[:, None], cache,
                                torch.ones((b, 1), dtype=torch.bool,
                                           device=dev))
        cur = nxt
        out.append(cur)
    return torch.stack(out, dim=1).cpu().numpy()


class CompiledAR:
    """Greedy AR decoding on the kernel route with one static state:
    the contiguous cache, the current token, a device step counter and
    the output buffer [B, max_len].  ``generate`` prefills eagerly, then
    runs one decode step per token: on the card (``cuda_graphs``, the
    default there) the step is captured as a CUDA graph at the first
    ``generate`` and replayed, and the host reads the tokens once at the
    end; the CPU runs the same step eagerly through the kernels' plain
    versions.  Attention archs only."""

    def __init__(self, cfg: ModelConfig, params, *, batch: int,
                 max_len: int, spec: Optional[SpecPVConfig] = None,
                 device=None, cuda_graphs: Optional[bool] = None):
        if not cfg.is_attention_arch:
            raise NotImplementedError("the compiled AR decodes attention "
                                      "archs; autoregressive_generate "
                                      "runs the state arch")
        self.cfg, self.params = cfg, params
        self.spec = spec or SpecPVConfig()
        self.device = resolve_device(device)
        self.batch, self.max_len = batch, max_len
        self.cuda_graphs = (self.device.type == "cuda" if cuda_graphs is None
                            else bool(cuda_graphs))
        if self.cuda_graphs and self.device.type != "cuda":
            raise ValueError("CUDA graphs run on the card")
        dev = self.device
        self.cache = api.init_cache(cfg, batch, max_len, self.spec,
                                    device=dev)
        self.cur = torch.zeros((batch,), dtype=torch.long, device=dev)
        self.out = torch.zeros((batch, max_len), dtype=torch.long, device=dev)
        self._i = torch.zeros((1,), dtype=torch.long, device=dev)
        self._ones = torch.ones((batch,), dtype=torch.int32, device=dev)
        self._graph = None
        if dev.type == "cuda":
            ops.reserve_split_counters(ops.split_counter_slots(
                batch, 1, cfg.num_heads, cfg.num_kv_heads,
                -(-max_len // self.spec.block_size)), dev)

    def _step(self) -> None:
        """One decode step into the static state: Full verification of the
        current token (K1), its commit (K4), the next token."""
        c = self.cache
        o = api.decode(self.cfg, self.params, self.cur[:, None],
                       c["length"][:, None], c, mode="full", spec=self.spec)
        nxt = torch.argmax(o.logits[:, 0], dim=-1)
        ck, cv = o.new_kv
        c["length"].copy_(vf.append_full_cache(c, ck, cv, self._ones,
                                               self.spec)["length"])
        self.cur.copy_(nxt)
        self.out.index_copy_(1, self._i, nxt[:, None])
        self._i.add_(1)

    def generate(self, prompt: np.ndarray, max_new_tokens: int,
                 prefill_chunk: int = 256) -> np.ndarray:
        """Greedy AR decoding.  Returns tokens [B, max_new]."""
        b, s0 = prompt.shape
        if b != self.batch or s0 + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {prompt.shape} + {max_new_tokens} new "
                             f"tokens against batch {self.batch}, max_len "
                             f"{self.max_len}")
        c = self.cache
        for k in ("k", "v", "kmax", "kmin", "length"):
            c[k].zero_()
        prompt_t = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                   device=self.device)
        logits = None
        for off in range(0, s0, prefill_chunk):
            logits, _, nc = api.prefill(self.cfg, self.params,
                                        prompt_t[:, off: off + prefill_chunk],
                                        c, spec=self.spec)
            c["length"].copy_(nc["length"])
        self.cur.copy_(torch.argmax(logits, dim=-1))
        self.out[:, 0].copy_(self.cur)
        self._i.fill_(1)
        for _ in range(max_new_tokens - 1):
            if not self.cuda_graphs:
                self._step()
                continue
            if self._graph is None:
                self._graph = capture_graph(
                    self._step, self.device,
                    [c["length"], c["kmax"], c["kmin"], self.cur, self.out,
                     self._i], torch.cuda.graph_pool_handle())
            self._graph.replay()
        return self.out[:, :max_new_tokens].cpu().numpy()
