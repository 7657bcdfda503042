"""KV-cache page codecs for tiered residency (counterpart of
``repro/kvcache/quant.py``).

Per-(token, head) absmax scaling: a payload of the input's shape in one
byte per element (int8 on a rounded grid, or an e4m3 cast) and a bf16
scale per row of the last axis.  The arithmetic is the reference's, in
fp32: the payload and the scales are bit-equal to JAX's.  A tier
demotion quantizes a slot's cold pages before they cross to the host;
its promotion dequantizes them straight into the pool's dtype
(``kvcache/offload.py:TierManager``).
"""
from __future__ import annotations

import torch


def _scale(x: torch.Tensor, top: float) -> torch.Tensor:
    """fp32 absmax over the last axis / ``top``, floored at 1e-8, so an
    all-zero row (padding, an unwritten page) quantizes to exact zeros
    and dequantizes back to exact zeros in any dtype.  ``top`` is divided
    as a tensor on the input's device: CUDA divides by a Python scalar
    as a multiply by its reciprocal, which rounds differently from the
    reference's true division."""
    absmax = x.float().abs().amax(dim=-1)
    top_t = torch.full((), top, dtype=torch.float32, device=x.device)
    return torch.clamp(absmax / top_t, min=1e-8)


def quantize_kv(x: torch.Tensor):
    """x: [..., Dh] float -> (q int8, scale [...] bf16): q =
    clip(round(x / scale), -127, 127), rounding half to even as
    ``jnp.round`` does."""
    scale = _scale(x, 127.0)
    q = torch.clamp(torch.round(x.float() / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def quantize_kv_fp8(x: torch.Tensor):
    """x: [..., Dh] float -> (q float8_e4m3fn, scale [...] bf16): the
    same absmax scheme and byte footprint as ``quantize_kv``, with the row
    absmax mapped onto e4m3's largest finite value (448) and the payload
    an fp8 cast (round to nearest even), which keeps about three mantissa
    bits at every magnitude."""
    scale = _scale(x, 448.0)
    q = (x.float() / scale[..., None]).to(torch.float8_e4m3fn)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_kv`` / ``quantize_kv_fp8`` (the payload's own
    dtype drives the upcast).  The multiply runs in fp32 whatever
    ``dtype`` is, so the bf16 scales round alike either way; a caller
    writing into a pool passes the pool's dtype."""
    out = q.float() * scale.float()[..., None]
    return out.to(dtype)
