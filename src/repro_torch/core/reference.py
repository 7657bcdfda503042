"""Plain greedy autoregressive decoding (counterpart of
``repro/core/reference.py:autoregressive_generate``): the losslessness
oracle, on the port's contiguous cache through the plain attention and
summaries (``plain=True``, a keyword only this oracle passes, so the
engine never takes that route), or, for a state arch, one read-only
decode and one ``advance`` per token."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, SpecPVConfig
from repro_torch.core import verify as vf
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
