#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py            # every phase (needs one CUDA card)

Phases, in order (any failure raises and the script exits non-zero):

1. device check (CUDA, capability 9.0) and the kernels' build from the
   sources under src/repro_torch/csrc;
2. each CUDA kernel against its plain PyTorch version on the card at the
   shapes of its path (K1-K4 at llama3.1-8b: bf16, H=32, Hk=8, Dh=128,
   block 128; K5 at rwkv6-3b: fp32, H=40, dk=64), with its time, its
   plain version's time, the least time the card could take (bound)
   and, where one PyTorch call computes the same function, that call's
   time (SDPA over the gathered keys for the verify attention and the
   paged prefill, ``torch.aminmax`` for the block summaries).  K1 and K2
   run in bf16 on the tensor-core kernel (K1 split over the block list
   and merged in the same launch) and in fp32 on the CUDA-core kernel;
   a kernel's time is the device time of every kernel one wrapper call
   launches.  K4 runs in its paged form over all 32 layers (a prefill
   chunk and a Refresh commit, routed on the card through the page
   table), in its routed form and on one contiguous cache, each bit for
   bit equal to its plain version with the null page left at 0.  K3 is
   also checked at the edges of its tiles, for one
   launch per call and for equal bits from two calls; K5 at T on both
   sides of its 16-token tiles, and for the chain engine's invariant
   (a read-only T=6 verify gives the y of six one-token steps, an
   advance with a valid prefix the state of that many one-token steps,
   bit for bit).  The serving path's inputs are checked too: a batch-4
   K1 call mixing Full rows, a routed Partial row and an empty slot, a
   batch-4 K3 call over ragged block counts, and a K4 call in which one
   row has start = end and one is a neutral slot (bit for bit);
3. greedy SpecPV ``generate`` of the paged zero-copy engine at the full
   width of llama3.1-8b (32 layers, random weights from a seed, batch 1,
   an 8192-token prompt, 128 new tokens), twice: eagerly
   (``cuda_graphs=False``) and with the step variants and the 256-token
   prefill chunk replayed as CUDA graphs (the default, the main path),
   whose tokens and launch counts must equal the eager run's.  For each
   run every kernel's launch count is set to 0 just before and read just
   after (K4 must run once per prefill chunk and once per commit, over
   every layer), the prefill is timed apart from decode (host clock
   after a synchronisation), and every layer's page summaries of the
   final cache are recomputed by the plain version and held to it bit
   for bit; then a fresh prefill (device launches, host ops and host
   launch calls per chunk) and a few decode steps under
   ``torch.profiler`` (device time by kernel, idle share) and two forced
   Refresh steps (K3's share of their device time).  After the eager
   run, one eager run of the prefill chunk's and of each step variant's
   body under ``torch.cuda.set_sync_debug_mode("error")`` (no body may
   wait for the card or read from the host);
4. losslessness at full width, 4 layers, fp32 (TF32 off): ``generate``
   with full verification, replayed as graphs, equals the port's
   autoregressive decoding token for token, then a partial-verification
   run with graphs equals the same run done eagerly;
5. the state-architecture path: greedy chain-speculation ``generate`` of
   rwkv6-3b at full width (32 layers, d 2560, bf16, random weights,
   batch 1, an 8192-token prompt, 128 new tokens), eagerly and with
   graphs (equal tokens and counts), with the launch counts set to 0
   just before and read just after each (the WKV kernel must run 32 x
   (prefill chunks + 2 x steps) times), a profiled prefill and window of
   its steps, the bodies under the sync check, and fp32 losslessness at
   4 layers with graphs (``generate`` equals the port's autoregressive
   decoding);
6. continuous-batching serving of llama3.1-8b at full width
   (``ServingEngine``, batch 4, a 161-page pool, six requests of 2048 to
   8192 prompt tokens arriving together), with graphs and eagerly (equal
   tokens and launch counts), the launch counts set to 0 just before and
   read just after each run and held to what its steps' variants and
   prefill chunks imply; page stalls, mixed-mode ticks and a drained pool
   asserted; each request alone through batch-1 ``generate`` (matches
   reported); a profiled window of batch-4 Partial ticks; the serving
   bodies under the sync check; fp32 losslessness at 4 layers (batch 2,
   interleaved prefill: every request equals its solo ``generate`` and a
   blocking run);
7. one JSON line with every kernel's numbers (each kernel's launches
   from its own path's run, and ``serving_launches`` from phase 6's), the
   card's name and power limit, and the final ``{"ok": true, ...}`` line.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
# the port must stand without JAX and the JAX package: make both unimportable
sys.modules["jax"] = None
sys.modules["repro"] = None

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_S = 989e12            # dense bf16 tensor-core rate
PEAK_FP32_S = 67e12             # fp32 outside the tensor cores
# kernel against its plain version: both widen the same inputs to fp32,
# so they differ only by summation order (~1e-6 relative); 1e-4 of each
# tensor's largest magnitude fails a missing 32-key tile (~0.7% of l)
TOL_KERNEL = 1e-4
PROMPT_LEN = 8192               # phase 3: the paper's long-context regime
NEW_TOKENS = 128
# spin before each timed call (~2 ms at the H100's clock): the host
# enqueues the call's Python work while the card spins, so the event
# window holds device time only
COVER_CYCLES = 4_000_000

KERNEL_META = {
    "sparse_verify_attention": dict(
        source="src/repro_torch/csrc/block_attention.cu",
        replaces="src/repro/kernels/sparse_attention.py:69"),
    "paged_prefill_attention": dict(
        source="src/repro_torch/csrc/block_attention.cu",
        replaces="src/repro/kernels/prefill_attention.py:79"),
    "retrieval_score": dict(
        source="src/repro_torch/csrc/retrieval_score.cu",
        replaces="src/repro/kernels/retrieval_score.py:33"),
    "block_summary": dict(
        source="src/repro_torch/csrc/block_summary.cu",
        replaces="src/repro/kernels/block_summary.py:30"),
    "wkv": dict(
        source="src/repro_torch/csrc/wkv_scan.cu",
        replaces="src/repro/kernels/wkv_scan.py:66"),
}
# the kernels each full-width path must launch
LLAMA_KERNELS = ("sparse_verify_attention", "paged_prefill_attention",
                 "retrieval_score", "block_summary")
RWKV_KERNELS = ("wkv",)
# K5's calls on the rwkv6-3b path, by their ops.WKV_SHAPES key (T, update)
WKV_PATH_SHAPES = {(256, True): "prefill T=256", (6, False): "verify T=6",
                   (6, True): "advance T=6"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def say(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


class Timer:
    """Device time of one call, averaged over ``iters`` calls.  Before
    each call the 50 MB L2 is flushed (the main path meets every layer's
    pool cold) and the card spins for ``COVER_CYCLES``; the CUDA-event
    window opens after the spin, by which time the host has enqueued the
    call, so the window holds device time and no host time.  A call
    whose host work outlasts the spin would let host time in: it is
    dropped and redone behind a spin twice as long.

    ``kernel_ms`` reads the device time of one call, summed over every
    kernel the call launches, from ``torch.profiler`` (CUPTI) over the
    same flushed calls."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
        self.per_call = 0        # kernels the last ``kernel_ms`` call saw

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total, done, cycles = 0.0, 0, COVER_CYCLES
        while done < iters:
            self.flush.zero_()
            ec = torch.cuda.Event(enable_timing=True)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            ec.record()
            torch.cuda._sleep(cycles)
            e0.record()
            h0 = time.perf_counter()
            fn()
            host_ms = (time.perf_counter() - h0) * 1e3
            e1.record()
            e1.synchronize()
            if host_ms >= ec.elapsed_time(e0):
                # host time may be in this window: drop it, spin longer
                if cycles >= 64 * COVER_CYCLES:
                    raise RuntimeError(
                        f"host work {host_ms:.3f} ms outlasts the spin "
                        f"{ec.elapsed_time(e0):.3f} ms")
                cycles *= 2
                continue
            total += e0.elapsed_time(e1)
            done += 1
        return total / iters

    def wall(self, fn, iters: int = 3, warmup: int = 1) -> float:
        """CUDA-event time of one call with no spin in front: for a call
        of more launches than the card's launch queue holds (the host
        then waits on the spin), so the window holds host time too."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            total += e0.elapsed_time(e1)
        return total / iters

    def kernel_ms(self, fn, kernel: str, iters: int = 10) -> float:
        """Device time of one call of ``fn``: the durations of all the
        kernels whose names contain ``kernel`` that the call launches
        (an attention kernel and any merge kernel alike), summed."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages()
                    if getattr(e, "device_type", None) == DeviceType.CUDA
                    and kernel in e.key]
            count = sum(e.count for e in rows)
            if count and count % iters == 0:
                break
        if count == 0:
            raise RuntimeError(f"profiler saw no launch of {kernel}")
        # the profiler has been seen to drop records of ~10 us kernels;
        # after three tries the mean over the records it kept is used
        per_call = -(-count // iters)
        self.per_call = per_call
        if count != per_call * iters:
            print(f"note: profiler kept {count} of {per_call * iters} "
                  f"launches of {kernel}; ms is their mean x {per_call}",
                  flush=True)
        return sum(_dev_us(e) for e in rows) / count * per_call / 1e3


def _close(label, got, want, tol=TOL_KERNEL):
    """|got - want| <= tol * (|want| + max |want|), over the entries that
    are not the masked sentinel -1e30, which must match exactly.
    Returns the largest relative error (to max |want|)."""
    import torch
    masked = want <= -1e29
    if not torch.equal(got[masked], want[masked]):
        raise AssertionError(f"{label}: masked entries differ")
    g, w = got[~masked], want[~masked]
    if w.numel() == 0:
        return 0.0
    scale = w.abs().max().clamp(min=1e-30)
    diff = (g - w).abs()
    if not bool(torch.all(diff <= tol * (w.abs() + scale))):
        raise AssertionError(
            f"{label}: kernel disagrees with its plain version, max abs err "
            f"{diff.max().item():.3e}, max |want| {scale.item():.3e}")
    return (diff.max() / scale).item()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _attn_case(torch, gen, *, t, ctx, routed_ns=0, causal_qoff=None,
               dtype=None):
    """Inputs of one K1/K2 call at llama3.1-8b shapes.  Returns the
    kernel's argument tuple plus the work counts for the bound."""
    h, hk, dh, bs = 32, 8, 128, 128
    dtype = dtype or torch.bfloat16
    nb = -(-ctx // bs)
    np_ = nb + 2
    dev = "cuda"
    q = torch.randn((1, t, h, dh), generator=gen, device=dev).to(dtype)
    pool_k = torch.randn((np_, bs, hk, dh), generator=gen, device=dev).to(dtype)
    pool_v = torch.randn((np_, bs, hk, dh), generator=gen, device=dev).to(dtype)
    table = (torch.randperm(np_ - 1, generator=gen, device=dev)[:nb] + 1)
    table = table.to(torch.int32)[None]                       # [1, NB]
    if routed_ns:
        # zero-copy partial: NS selected logical blocks per head, the last
        # few slots unused (-1), the last valid block ragged
        sel = torch.stack([torch.randperm(nb - 1, generator=gen, device=dev)
                           [:routed_ns] for _ in range(hk)])[None]
        sel[..., -3:] = -1
        sel[..., routed_ns - 4] = nb - 1
        length = torch.tensor([ctx], device=dev)
        used = sel >= 0
        idx = torch.where(used, table[0][sel.clamp(min=0)], 0)
        vlen = torch.where(used, (length[:, None, None] - sel * bs)
                           .clamp(0, bs), 0)
        qoff = None
    else:
        end = torch.tensor([ctx], device=dev)
        vl = (end[:, None] - torch.arange(nb, device=dev)[None] * bs).clamp(0, bs)
        idx = torch.where(vl > 0, table, 0)[:, None].expand(1, hk, nb)
        vlen = vl[:, None].expand(1, hk, nb)
        qoff = (torch.tensor([causal_qoff], device=dev, dtype=torch.int32)
                if causal_qoff is not None else None)
    idx = idx.to(torch.int32).contiguous()
    vlen = vlen.to(torch.int32).contiguous()
    kf = pool_k.reshape(np_ * bs, hk, dh)
    vf = pool_v.reshape(np_ * bs, hk, dh)
    # work: valid (query row, key) pairs, and the distinct KV bytes read
    keys = vlen.sum().item()                  # summed over KV heads
    rep = h // hk
    if qoff is None:
        pairs = keys * rep * t
    else:
        # key at absolute position p is seen by queries qoff+i >= p
        kpos = torch.arange(ctx, device=dev)
        qpos = causal_qoff + torch.arange(t, device=dev)
        pairs = int((kpos[None] <= qpos[:, None]).sum().item()) * hk * rep
    isz = q.element_size()
    nbytes = (q.numel() * isz + 2 * keys * dh * isz
              + 2 * idx.numel() * 4 + (2 + dh) * h * t * 4)
    flops = 4 * pairs * dh
    return (q, kf, vf, idx, vlen, bs, qoff), nbytes, flops, table, pool_k, pool_v


def _bound_ms(nbytes, flops, peak_ops):
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_o = flops / peak_ops * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def phase_kernels(torch, card, timer):
    from repro_torch.kernels import ops, ref
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    results = {}

    def attn_check(label, name, primary=False, timed=True, **kw):
        """One K1/K2 case held to its plain version; a timed case also
        gets its kernel, plain, bound and SDPA times."""
        args, nbytes, flops, table, pool_k, pool_v = _attn_case(torch, gen, **kw)
        q, kf, vf, idx, vlen, bs, qoff = args
        got = ops.block_attention(q, kf, vf, idx, vlen, bs, q_offset=qoff)
        want = ref.block_attention_batched(q, kf, vf, idx, vlen, bs,
                                           q_offset=qoff)
        torch.cuda.synchronize()
        out_g = got[2] / got[1].clamp(min=1e-30)[..., None]
        out_w = want[2] / want[1].clamp(min=1e-30)[..., None]
        rel = max(_close(f"{label} {nm}", g, w) for nm, g, w in
                  (("m", got[0], want[0]), ("l", got[1], want[1]),
                   ("acc", got[2], want[2]), ("out", out_g, out_w)))
        err = max((out_g - out_w).abs().max().item(),
                  (got[0] - want[0]).abs().max().item())
        if not timed:
            say(card, f"kernel {label}: max_abs_err {err:.3e} max_rel_err "
                      f"{rel:.3e} (tol {TOL_KERNEL} of max |plain| on m, l, "
                      f"acc, out)")
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], err)
            return
        before = dict(ops.LAUNCHES)

        def launch():
            return ops.block_attention(q, kf, vf, idx, vlen, bs,
                                       q_offset=qoff)
        ms = timer.kernel_ms(launch, "block_attention")
        if timer.per_call > 2:
            raise AssertionError(f"{label}: {timer.per_call} launches per "
                                 f"call, at most 2 allowed")
        event_ms = timer(launch)
        ops.LAUNCHES.update(before)        # timing launches are not the path's
        plain_ms = timer(lambda: ref.block_attention_batched(
            q, kf, vf, idx, vlen, bs, q_offset=qoff), iters=3, warmup=1)
        bound, by = _bound_ms(nbytes, flops, PEAK_BF16_S)
        # the yardstick: one torch SDPA call over the gathered keys with
        # the same mask (GQA: 4 query heads share each KV head)
        qh = q.transpose(1, 2)
        hk_, dh_ = kf.shape[1:]
        if kw.get("routed_ns"):
            # per-head routed blocks, masked to their valid lengths
            hsel = torch.arange(hk_, device="cuda")[:, None]
            ids = idx[0].long()                                  # [Hk, NS]
            kh_ = pool_k.permute(2, 0, 1, 3)[hsel, ids].reshape(1, hk_, -1,
                                                                  dh_)
            vh_ = pool_v.permute(2, 0, 1, 3)[hsel, ids].reshape(1, hk_, -1,
                                                                  dh_)
            valid = (torch.arange(bs, device="cuda")[None, None]
                     < vlen[0][..., None]).reshape(hk_, -1)
            mask = valid.repeat_interleave(q.shape[2] // hk_, 0)[None, :,
                                                                  None]
        else:
            ctx = kw["ctx"]
            kh_ = pool_k[table[0].long()].reshape(1, -1, hk_, dh_)[:, :ctx] \
                .transpose(1, 2)
            vh_ = pool_v[table[0].long()].reshape(1, -1, hk_, dh_)[:, :ctx] \
                .transpose(1, 2)
            mask = None
            if qoff is not None:
                qpos = kw["causal_qoff"] + torch.arange(q.shape[1],
                                                        device="cuda")
                mask = torch.arange(ctx, device="cuda")[None] <= qpos[:, None]
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qh, kh_, vh_, attn_mask=mask, enable_gqa=True))
        say(card, f"kernel {label}: max_abs_err {err:.3e} max_rel_err "
                  f"{rel:.3e} (tol {TOL_KERNEL} of max |plain| on m, l, acc, "
                  f"out) ms {ms:.4f} (profiler, {timer.per_call} launch(es) "
                  f"per call; events {event_ms:.4f}) "
                  f"plain_ms {plain_ms:.4f} bound_us "
                  f"{bound * 1e3:.2f} ({by}) library_ms {lib_ms:.4f} (SDPA)")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=by, library_ms=lib_ms)
        prev = results.get(name)
        if prev is None or primary:
            if prev is not None:
                row["max_abs_err"] = max(err, prev["max_abs_err"])
            results[name] = row
        else:
            prev["max_abs_err"] = max(prev["max_abs_err"], err)

    k1 = "sparse_verify_attention"
    attn_check("K1 full T=61 ctx=8229", k1, t=61, ctx=8229)
    attn_check("K1 refresh T=156 ctx=8229", k1, t=156, ctx=8229)
    attn_check("K1 routed NS=35 T=61", k1, t=61, ctx=8229, routed_ns=35,
               primary=True)
    k2 = "paged_prefill_attention"
    attn_check("K2 prefill T=256 qoff=0", k2, t=256, ctx=256, causal_qoff=0)
    attn_check("K2 prefill T=256 qoff=7936", k2, t=256, ctx=8192,
               causal_qoff=7936, primary=True)
    # the fp32 route (CUDA cores), checked only: it runs in the fp32
    # losslessness phase, not on the bf16 path
    f32 = torch.float32
    attn_check("K1 routed NS=35 T=61 fp32", k1, t=61, ctx=8229, routed_ns=35,
               dtype=f32, timed=False)
    attn_check("K1 full T=1 ctx=8229 fp32", k1, t=1, ctx=8229, dtype=f32,
               timed=False)
    attn_check("K2 prefill T=256 qoff=7936 fp32", k2, t=256, ctx=8192,
               causal_qoff=7936, dtype=f32, timed=False)

    results["retrieval_score"] = _score_checks(torch, card, timer, gen)
    results["block_summary"] = _summary_checks(torch, card, timer, gen)
    results["wkv"] = _wkv_checks(torch, card, timer, gen)
    err_k1, err_k3 = _serving_kernel_cases(torch, card, gen)
    results[k1]["max_abs_err"] = max(results[k1]["max_abs_err"], err_k1)
    results["retrieval_score"]["max_abs_err"] = max(
        results["retrieval_score"]["max_abs_err"], err_k3)
    return results


def _serving_kernel_cases(torch, card, gen):
    """The kernels' inputs on the serving path (phase 6), each against
    its plain version: a batch-4 K1 call (T=61) whose rows mix two Full
    rows of ragged lengths, a routed Partial row and an empty slot (null
    page table, length 0), in bf16 and fp32; a batch-4 K3 call (T=156)
    over ragged block counts, an empty slot among them, two calls bit
    for bit; a K4 all-layers call over four rows of which one has start
    = end inside a block (it recomputes that block to the same bits) and
    one is a neutral slot (nothing written), bit for bit.  Returns the
    largest abs error of (K1, K3); K4's is 0."""
    from repro_torch.kernels import ops, ref
    h, hk, dh, bs, nb = 32, 8, 128, 128, 66
    dev = "cuda"
    before = dict(ops.LAUNCHES)
    np_ = 4 * nb + 1
    table = (torch.randperm(np_ - 1, generator=gen, device=dev) + 1)[
        : 4 * nb].to(torch.int32).reshape(4, nb).contiguous()
    table[2] = 0                                   # the empty slot
    # rows: Full 3000 tokens, Partial (routed, context 8229), empty, Full
    # 5555 tokens
    full_len = torch.tensor([3000, 0, 0, 5555], device=dev)
    idx, vlen = ops._page_walk(table, full_len, (np_, bs, hk, dh))
    sel = torch.stack([torch.randperm(nb - 1, generator=gen, device=dev)[:35]
                       for _ in range(hk)])             # [Hk, 35] logical
    sel[:, -3:] = -1
    sel[:, 30] = nb - 1                            # the ragged last block
    used = sel >= 0
    idx[1] = 0
    vlen[1] = 0
    idx[1, :, :35] = torch.where(used, table[1][sel.clamp(min=0)], 0)
    vlen[1, :, :35] = torch.where(used, (8229 - sel * bs).clamp(0, bs), 0)
    idx, vlen = idx.contiguous(), vlen.contiguous()
    err_k1 = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((4, 61, h, dh), generator=gen, device=dev).to(dtype)
        pk = torch.randn((np_, bs, hk, dh), generator=gen,
                         device=dev).to(dtype)
        pv = torch.randn((np_, bs, hk, dh), generator=gen,
                         device=dev).to(dtype)
        kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
        got = ops.block_attention(q, kf, vf, idx, vlen, bs)
        want = ref.block_attention_batched(q, kf, vf, idx, vlen, bs)
        torch.cuda.synchronize()
        out_g = got[2] / got[1].clamp(min=1e-30)[..., None]
        out_w = want[2] / want[1].clamp(min=1e-30)[..., None]
        for nm, g, w in (("m", got[0], want[0]), ("l", got[1], want[1]),
                         ("acc", got[2], want[2]), ("out", out_g, out_w)):
            _close(f"K1 mixed batch-4 {dtype} {nm}", g, w)
        if not (bool((got[0][2] <= -1e29).all())
                and float(got[1][2].abs().max()) == 0.0):
            raise AssertionError("K1 mixed batch-4: the empty slot is not "
                                 "masked")
        err_k1 = max(err_k1, (out_g - out_w).abs().max().item(),
                     (got[0] - want[0]).abs().max().item())
    say(card, f"kernel K1 mixed batch-4 T=61 (Full 3000, routed Partial "
              f"NS=35, empty slot, Full 5555) bf16 and fp32: max_abs_err "
              f"{err_k1:.3e} (tol {TOL_KERNEL} of max |plain|), the empty "
              f"slot all masked")
    # K3: ragged live block counts, zero summaries past them (null pages)
    t = 156
    q = torch.randn((4, t, h, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    kmax = torch.randn((4, nb, hk, dh), generator=gen, device=dev).abs()
    kmin = -torch.randn((4, nb, hk, dh), generator=gen, device=dev).abs()
    live = torch.tensor([66, 40, 0, 23], device=dev)
    keep = (torch.arange(nb, device=dev)[None] < live[:, None])[..., None,
                                                                None]
    kmax, kmin = kmax * keep, kmin * keep
    qw = (torch.rand((4, t), generator=gen, device=dev) > 0.5).float()
    qw[:, 0] = 1.0
    got = ops.retrieval_scores(q, kmax, kmin, qw)
    again = ops.retrieval_scores(q, kmax, kmin, qw)
    want = ref.retrieval_score_batched(q, kmax, kmin, qw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("K3 ragged batch-4: two calls differ")
    _close("K3 ragged batch-4", got, want)
    err_k3 = (got - want).abs().max().item()
    say(card, f"kernel K3 batch-4 T=156 NB=66 with live blocks "
              f"{live.tolist()} bf16: max_abs_err {err_k3:.3e} (tol "
              f"{TOL_KERNEL}), two calls bit-equal")
    # K4: every layer, four rows; row 1 start = end mid-block, row 2 neutral
    layers, nbk = 32, 24
    np4 = 4 * nbk + 1
    pool = torch.randn((layers, np4, bs, hk, dh), generator=gen,
                       device=dev).to(torch.bfloat16)
    tab = (torch.randperm(np4 - 1, generator=gen, device=dev) + 1).to(
        torch.int32).reshape(4, nbk).contiguous()
    tab[2] = 0
    start = torch.tensor([2600, 1000, 0, 2304], dtype=torch.int32,
                         device=dev)
    end = torch.tensor([2661, 1000, 0, 2560], dtype=torch.int32, device=dev)
    init = torch.zeros((2, layers, np4, hk, dh), device=dev)
    ref.paged_block_summaries(pool, tab, torch.zeros_like(start), start,
                              nbk, init[0], init[1])
    got, want = init.clone(), init.clone()
    ops.paged_block_summaries(pool, tab, start, end, 3, got[0], got[1])
    ref.paged_block_summaries(pool, tab, start, end, 3, want[0], want[1])
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K4 four rows with start = end: kernel differs "
                             "from its plain version")
    pages1 = tab[1].long()
    if not torch.equal(got[:, :, pages1], init[:, :, pages1]):
        raise AssertionError("K4: the start = end row's summaries moved")
    if float(got[:, :, 0].abs().max()) != 0.0:
        raise AssertionError("K4 wrote the null page")
    say(card, "kernel K4 all 32 layers, rows (commit 2600-2661, start = end "
              "= 1000, neutral slot, prefill chunk 2304-2560) bf16: bit-equal "
              "to plain, the start = end row's summaries unchanged, null page "
              "0")
    ops.LAUNCHES.update(before)
    return err_k1, err_k3


def _score_inputs(torch, gen, t, nb, dtype, h=32, hk=8, dh=128):
    q = torch.randn((1, t, h, dh), generator=gen, device="cuda").to(dtype)
    kmax = torch.randn((1, nb, hk, dh), generator=gen, device="cuda").abs()
    kmin = -torch.randn((1, nb, hk, dh), generator=gen, device="cuda").abs()
    qw = (torch.rand((1, t), generator=gen, device="cuda") > 0.3).float()
    qw[0, 0] = 1.0
    return q, kmax, kmin, qw


def _score_checks(torch, card, timer, gen):
    """K3 at a refresh tick's shapes (T=156, NB=66, llama3.1-8b heads) in
    bf16 (the path's dtype, the row reported) and fp32, each timed with
    one launch per call and two calls giving equal bits; then the edges
    of its 32-block tiles and 64-row slices, checked only."""
    from repro_torch.kernels import ops, ref
    row, err_all = None, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        t, h, hk, dh, nb = 156, 32, 8, 128, 66
        q, kmax, kmin, qw = _score_inputs(torch, gen, t, nb, dtype)
        got = ops.retrieval_scores(q, kmax, kmin, qw)
        again = ops.retrieval_scores(q, kmax, kmin, qw)
        want = ref.retrieval_score_batched(q, kmax, kmin, qw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K3 {dtype}: two calls differ")
        err = (got - want).abs().max().item()
        err_all = max(err_all, err)
        rel = _close(f"K3 scores {dtype}", got, want)
        before = dict(ops.LAUNCHES)

        def launch():
            return ops.retrieval_scores(q, kmax, kmin, qw)
        ms = timer.kernel_ms(launch, "retrieval_score_kernel")
        if timer.per_call != 1:
            raise AssertionError(f"K3: {timer.per_call} launches per call")
        event_ms = timer(launch)
        ops.LAUNCHES.update(before)
        plain_ms = timer(lambda: ref.retrieval_score_batched(q, kmax, kmin,
                                                             qw),
                         iters=3, warmup=1)
        nbytes = q.numel() * 2 + 2 * kmax.numel() * 4 + t * 4 + hk * nb * 4
        flops = 2 * 2 * dh * (h // hk) * t * hk * nb
        bound, by = _bound_ms(nbytes, flops, PEAK_FP32_S)
        say(card, f"kernel K3 retrieval T=156 NB=66 {dtype}: max_abs_err "
                  f"{err:.3e} max_rel_err {rel:.3e} (tol {TOL_KERNEL} of max "
                  f"|plain|; two calls bit-equal) ms {ms:.4f} (profiler, 1 "
                  f"launch per call; events {event_ms:.4f}) plain_ms "
                  f"{plain_ms:.4f} bound_us {bound * 1e3:.2f} ({by}) "
                  f"library_ms none")
        if row is None:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       library_ms=None)
    before = dict(ops.LAUNCHES)
    for dtype in (torch.bfloat16, torch.float32):
        for t in (1, 156, 157):
            for nb in (1, 33, 66):
                q, kmax, kmin, qw = _score_inputs(torch, gen, t, nb, dtype)
                got = ops.retrieval_scores(q, kmax, kmin, qw)
                again = ops.retrieval_scores(q, kmax, kmin, qw)
                want = ref.retrieval_score_batched(q, kmax, kmin, qw)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"K3 T={t} NB={nb} {dtype}: two "
                                         f"calls differ")
                _close(f"K3 T={t} NB={nb} {dtype}", got, want)
                err_all = max(err_all, (got - want).abs().max().item())
    ops.LAUNCHES.update(before)
    say(card, f"kernel K3 edges T in (1, 156, 157) x NB in (1, 33, 66), bf16 "
              f"and fp32: all within tol {TOL_KERNEL}, two calls bit-equal")
    row["max_abs_err"] = err_all
    return row


# K4's paged shapes on the llama path: (label, start, end, n_touch), one
# row of an 8192-token prompt in 66 table blocks of 128 tokens
K4_PAGED_SHAPES = (
    # the last prompt chunk: blocks 62 and 63, the third entry past the span
    ("all-layers prefill chunk", 7936, 8192, 3),
    # a Refresh commit of 37 tokens (width 101: n_touch 2): one ragged block
    ("all-layers Refresh commit", 8192, 8229, 2),
)


def _paged_summary_case(torch, card, timer, gen, dtype, label, start, end,
                        n_touch, layers=32, np_=70, nb=66, hk=8, dh=128,
                        bs=128):
    """One paged all-layers K4 call held to its plain version bit for bit
    (null page 0 still 0 in every layer, one launch per call), timed with
    its plain version, its bound and ``torch.aminmax`` over the same live
    blocks.  Returns the numbers of the case."""
    from repro_torch.kernels import ops, ref
    pool = torch.randn((layers, np_, bs, hk, dh), generator=gen,
                       device="cuda").to(dtype)
    perm = torch.randperm(np_ - 1, generator=gen, device="cuda") + 1
    table = perm[:nb].to(torch.int32)[None].contiguous()
    st = torch.tensor([start], dtype=torch.int32, device="cuda")
    en = torch.tensor([end], dtype=torch.int32, device="cuda")
    got = torch.zeros((2, layers, np_, hk, dh), device="cuda")
    want = torch.zeros_like(got)
    ops.paged_block_summaries(pool, table, st, en, n_touch, got[0], got[1])
    ref.paged_block_summaries(pool, table, st, en, n_touch, want[0], want[1])
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"K4 {label} {dtype}: kernel differs from its "
                             f"plain version, max abs err "
                             f"{(got - want).abs().max().item():.3e}")
    if float(got[:, :, 0].abs().max()) != 0.0:
        raise AssertionError(f"K4 {label} {dtype} wrote the null page")
    # the live entries, as the kernel routes them
    live = [(start // bs + j, min(end - (start // bs + j) * bs, bs))
            for j in range(n_touch)
            if start // bs + j < -(-end // bs) and start // bs + j < nb]
    if not float(got.abs().sum()) > 0 or not live:
        raise AssertionError(f"K4 {label}: nothing written")
    before = dict(ops.LAUNCHES)

    def launch():
        return ops.paged_block_summaries(pool, table, st, en, n_touch,
                                         got[0], got[1])
    ms = timer.kernel_ms(launch, "block_summary_kernel")
    if timer.per_call != 1:
        raise AssertionError(f"K4: {timer.per_call} launches per call")
    ops.LAUNCHES.update(before)
    plain_ms = timer(lambda: ref.paged_block_summaries(
        pool, table, st, en, n_touch, want[0], want[1]), iters=3, warmup=1)
    kb = pool.reshape(layers * np_, bs, hk, dh)
    pages = table[0, [tb for tb, _ in live]].long()
    rows = (torch.arange(layers, device="cuda")[:, None] * np_
            + pages[None]).reshape(-1)
    # the yardstick: one aminmax over the gathered live blocks
    lib_ms = timer(lambda: torch.aminmax(kb[rows], dim=1))
    n_tok = layers * sum(v for _, v in live)
    nbytes = (n_tok * hk * dh * pool.element_size()
              + 2 * layers * len(live) * hk * dh * 4 + n_touch * 4 + 8)
    bound, by = _bound_ms(nbytes, 2 * n_tok * hk * dh, PEAK_FP32_S)
    say(card, f"kernel K4 paged {label} L={layers} n_touch={n_touch} "
              f"(live blocks {[v for _, v in live]} tokens) {dtype}: "
              f"bit-equal to plain, null page 0, 1 launch per call; ms "
              f"{ms:.4f} (profiler) plain_ms {plain_ms:.4f} bound_us "
              f"{bound * 1e3:.3f} ({by}) library_ms {lib_ms:.4f} "
              f"(torch.aminmax over the gathered live blocks)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)


def _summary_checks(torch, card, timer, gen):
    """K4 at the llama path's shapes.  The paged form over all 32 layers,
    the path's only form: a prefill chunk and a Refresh commit
    (``K4_PAGED_SHAPES``), in bf16 and fp32; the row reported is the
    bf16 prefill chunk (32 of the path's 34 launches), and ``shapes``
    holds every timed case.  Then the routed form, a commit (N=2 blocks,
    one ragged) and a prefill chunk (N=3, one entry on the null page),
    in bf16 and fp32, and one whole contiguous cache, the TPU kernel's
    own contract.  Every case is bit-equal to its plain version."""
    from repro_torch.kernels import ops, ref
    row, shapes = None, {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, start, end, n_touch in K4_PAGED_SHAPES:
            vals = _paged_summary_case(torch, card, timer, gen, dtype, label,
                                       start, end, n_touch)
            shapes[f"{label} {str(dtype)[6:]}"] = vals
            if row is None:
                row = dict(vals)
    hk, dh, bs, np_ = 8, 128, 128, 68
    cases = [("commit N=2", [12, 40], [128, 101], [12, 40]),
             ("prefill N=3", [7, 8, 0], [128, 128, 0], [7, 8, 0])]
    for dtype in (torch.bfloat16, torch.float32):
        pool = torch.randn((np_ * bs, hk, dh), generator=gen,
                           device="cuda").to(dtype)
        for label, src, vlen, tgt in cases:
            src_t, vlen_t, tgt_t = (torch.tensor(a, dtype=torch.int32,
                                                 device="cuda")
                                    for a in (src, vlen, tgt))
            outs = [torch.zeros((np_, hk, dh), device="cuda")
                    for _ in range(4)]
            ops.block_summaries_routed(pool, src_t, vlen_t, tgt_t, outs[0],
                                       outs[1], bs)
            ref.block_summary_routed(pool, src_t, vlen_t,
                                     torch.where(tgt_t > 0, tgt_t, -1),
                                     outs[2], outs[3], bs)
            torch.cuda.synchronize()
            if not (torch.equal(outs[0], outs[2])
                    and torch.equal(outs[1], outs[3])):
                raise AssertionError(f"K4 routed {label} {dtype}: kernel "
                                     f"differs from its plain version")
            if float(outs[0][0].abs().max()) != 0.0:
                raise AssertionError("K4 wrote the null page")
            before = dict(ops.LAUNCHES)

            def launch():
                return ops.block_summaries_routed(
                    pool, src_t, vlen_t, tgt_t, outs[0], outs[1], bs)
            ms = timer.kernel_ms(launch, "block_summary_kernel")
            if timer.per_call != 1:
                raise AssertionError(f"K4: {timer.per_call} launches per "
                                     f"call")
            ops.LAUNCHES.update(before)
            plain_ms = timer(lambda: ref.block_summary_routed(
                pool, src_t, vlen_t, tgt_t, outs[2], outs[3], bs), iters=3,
                warmup=1)
            kb = pool.reshape(np_, bs, hk, dh)
            src_l = src_t.long()
            # the yardstick: one aminmax over the gathered full blocks
            lib_ms = timer(lambda: torch.aminmax(kb[src_l], dim=1))
            n_tok = int(vlen_t.sum())
            nbytes = (n_tok * hk * dh * pool.element_size()
                      + 2 * int((tgt_t > 0).sum()) * hk * dh * 4
                      + 3 * len(src) * 4)
            bound, by = _bound_ms(nbytes, 2 * n_tok * hk * dh, PEAK_FP32_S)
            say(card, f"kernel K4 routed {label} {dtype}: bit-equal to "
                      f"plain, 1 launch per call; ms {ms:.4f} (profiler) "
                      f"plain_ms {plain_ms:.4f} bound_us "
                      f"{bound * 1e3:.3f} ({by}) library_ms {lib_ms:.4f} "
                      f"(torch.aminmax over gathered blocks)")
            shapes[f"routed {label} {str(dtype)[6:]}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)
    # one whole contiguous cache: the TPU kernel's own contract
    k = torch.randn((1, 66 * bs, hk, dh), generator=gen,
                    device="cuda").to(torch.bfloat16)
    length = torch.tensor([8229], device="cuda")
    got = ops.block_summaries(k, length, bs)
    want = ref.block_summary_ref(k[0], 8229, bs)
    torch.cuda.synchronize()
    if not (torch.equal(got[0][0], want[0])
            and torch.equal(got[1][0], want[1])):
        raise AssertionError("K4 contiguous: kernel differs from its plain "
                             "version")
    before = dict(ops.LAUNCHES)
    ms = timer.kernel_ms(lambda: ops.block_summaries(k, length, bs),
                         "block_summary_kernel")
    ops.LAUNCHES.update(before)
    say(card, f"kernel K4 contiguous NB=66 length=8229 bf16: bit-equal to "
              f"plain; ms {ms:.4f} (profiler)")
    row["max_abs_err"] = 0.0        # every case above is bit-equal
    row["shapes"] = shapes
    return row


def _wkv_inputs(torch, gen, b, t, h=40, dk=64):
    r, k, v = (torch.randn((b, t, h, dk), generator=gen,
                           device="cuda") * 0.5 for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((b, t, h, dk), generator=gen,
                                         device="cuda") - 2.0))
    u = torch.randn((h, dk), generator=gen, device="cuda") * 0.5
    s0 = torch.randn((b, h, dk, dk), generator=gen, device="cuda")
    return r, k, v, w, u, s0


def _wkv_identity(torch, card, gen):
    """The chain engine's invariant: a read-only T=6 call gives y equal
    bit for bit to six one-token update steps, and an advance of T=6 with
    a valid leaves the state bits of a one-token steps (a = 0, 2, 6)."""
    from repro_torch.kernels import ops
    t = 6
    before = dict(ops.LAUNCHES)
    r, k, v, w, u, s0 = _wkv_inputs(torch, gen, 1, t)
    y6, _ = ops.wkv(r, k, v, w, u, s0, update=False)
    s, ys, states = s0, [], [s0]
    for i in range(t):
        sl = slice(i, i + 1)
        y1, s = ops.wkv(r[:, sl].contiguous(), k[:, sl].contiguous(),
                        v[:, sl].contiguous(), w[:, sl].contiguous(), u, s)
        ys.append(y1)
        states.append(s)
    if not torch.equal(y6, torch.cat(ys, dim=1)):
        raise AssertionError("K5: verify T=6 y differs from 6 one-token steps")
    for a in (0, 2, 6):
        nv = torch.tensor([a], dtype=torch.int32, device="cuda")
        _, s_adv = ops.wkv(r, k, v, w, u, s0, nv)
        if not torch.equal(s_adv, states[a]):
            raise AssertionError(f"K5: advance T=6 valid={a} state differs "
                                 f"from {a} one-token steps")
    ops.LAUNCHES.update(before)
    say(card, "kernel K5 identity: verify T=6 y == 6 one-token steps, "
              "advance T=6 valid=a state == a one-token steps (a = 0, 2, 6), "
              "bit for bit")


def _wkv_checks(torch, card, timer, gen):
    """K5 at rwkv6-3b head shapes (batch 1, H 40, dk 64, fp32): a chain
    verify (T=6, read-only), a prefill chunk (T=256) and an advance with
    a padded valid prefix (T=6, 2 valid), each timed; the verify/advance
    identity; then T on both sides of the kernel's 16-token tiles with
    B=2 and a padded row, checked only.  The row reported is the chain
    verify (the most launches on the path); ``shapes`` holds every timed
    case under its ``WKV_PATH_SHAPES`` label."""
    from repro_torch.kernels import ops, ref
    h, dk = 40, 64
    row, err_all, shapes = None, 0.0, {}
    for t, nv, update in ((6, 6, False), (256, 256, True), (6, 2, True)):
        label = WKV_PATH_SHAPES[(t, update)]
        r, k, v, w, u, s0 = _wkv_inputs(torch, gen, 1, t)
        n_valid = torch.tensor([nv], dtype=torch.int32, device="cuda")
        y, s = ops.wkv(r, k, v, w, u, s0, n_valid, update=update)
        want_y, want_s = ref.wkv_batched(r, k, v, w, u, s0, n_valid)
        torch.cuda.synchronize()
        pairs = [("y", y, want_y)] + ([("s", s, want_s)] if update else [])
        rel = max(_close(f"K5 {label} {nm}", g, wv) for nm, g, wv in pairs)
        if not update and s is not s0:
            raise AssertionError("K5 read-only call replaced the state")
        err = max((g - wv).abs().max().item() for _, g, wv in pairs)
        err_all = max(err_all, err)
        before = dict(ops.LAUNCHES)

        def launch():
            return ops.wkv(r, k, v, w, u, s0, n_valid, update=update)
        ms = timer.kernel_ms(launch, "wkv_kernel")
        if timer.per_call != 1:
            raise AssertionError(f"K5: {timer.per_call} launches per call")
        ops.LAUNCHES.update(before)
        # the plain T=256 loop issues ~2000 launches, more than the launch
        # queue holds behind a spin: its window includes host time
        plain_timer = timer if t <= 6 else timer.wall
        plain_ms = plain_timer(
            lambda: ref.wkv_batched(r, k, v, w, u, s0, n_valid), iters=3,
            warmup=1)
        nbytes = (5 * t * h * dk * 4 + h * dk * 4 + 4
                  + (2 if update else 1) * h * dk * dk * 4)
        flops = 5 * t * h * dk * dk + 2 * nv * h * dk * dk
        bound, by = _bound_ms(nbytes, flops, PEAK_FP32_S)
        say(card, f"kernel K5 wkv {label} ({nv} valid): max_abs_err "
                  f"{err:.3e} max_rel_err "
                  f"{rel:.3e} (tol {TOL_KERNEL}) ms {ms:.4f} (profiler) "
                  f"plain_ms {plain_ms:.4f}"
                  f"{'' if t <= 6 else ' (events incl. host time)'} "
                  f"bound_us {bound * 1e3:.3f} ({by}) library_ms none")
        shapes[label] = dict(valid=nv, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by)
        if row is None:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       library_ms=None)
    _wkv_identity(torch, card, gen)
    before = dict(ops.LAUNCHES)
    for t in (1, 6, 31, 33, 256, 257):
        r, k, v, w, u, s0 = _wkv_inputs(torch, gen, 2, t)
        n_valid = torch.tensor([t, t // 2], dtype=torch.int32, device="cuda")
        y, s = ops.wkv(r, k, v, w, u, s0, n_valid)
        want_y, want_s = ref.wkv_batched(r, k, v, w, u, s0, n_valid)
        torch.cuda.synchronize()
        _close(f"K5 B=2 T={t} y", y, want_y)
        _close(f"K5 B=2 T={t} s", s, want_s)
        err_all = max(err_all, (y - want_y).abs().max().item(),
                      (s - want_s).abs().max().item())
    ops.LAUNCHES.update(before)
    say(card, f"kernel K5 B=2 (one row padded to T//2) at T in (1, 6, 31, 33, "
              f"256, 257): y and state within tol {TOL_KERNEL}")
    row["max_abs_err"] = err_all
    row["shapes"] = shapes
    return row


# ---------------------------------------------------------------------------
# phase 3: full-width generate
# ---------------------------------------------------------------------------

def phase_generate(torch, card, prompt_len: int = PROMPT_LEN,
                   new_tokens: int = NEW_TOKENS):
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.kernels import ops
    from repro_torch.models.api import init_params

    cfg = get_config("llama3.1-8b")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    say(card, f"llama3.1-8b random weights ready in "
              f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (1, prompt_len)).astype(np.int64)
    tree_path = dcfg.tree_depth + 1
    max_len = request_token_need(prompt_len, new_tokens, spec.buffer_size,
                                 tree_path)
    runs = {}
    for graphs in (False, True):
        label = RUN_LABEL[graphs]
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=max_len, paged=True, zero_copy=True,
                           device="cuda", cuda_graphs=graphs)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks, stats = eng.generate(prompt, new_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        memory_line(torch, card, label, eng, params, dparams, peak)
        decode_s = wall - stats["prefill_s"]
        say(card, f"generate llama3.1-8b [{label}] (32 layers, bf16, random "
                  f"weights) prompt {prompt_len} new {new_tokens}: modes "
                  f"{stats['modes']} steps {stats['steps']} mean_accept "
                  f"{stats['mean_accept']:.4f} wall_s {wall:.3f} (prefill_s "
                  f"{stats['prefill_s']:.3f} decode_s {decode_s:.3f}, ms/step "
                  f"{decode_s * 1e3 / max(stats['steps'], 1):.2f}) "
                  f"tokens_per_s {new_tokens / wall:.2f} peak_mem_gib "
                  f"{peak:.2f} capture_s {eng.capture_s:.3f} graphs "
                  f"{sorted(map(str, eng._graphs))} launches {launches}")
        if not (stats["modes"].get("refresh")
                and stats["modes"].get("partial")):
            raise AssertionError(f"Refresh and Partial ticks must both run: "
                                 f"{stats['modes']}")
        for k in LLAMA_KERNELS:
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the "
                                     f"path")
        # K4: one launch per prefill chunk and per commit, over every layer
        chunks = -(-prompt_len // 256)
        commits = (stats["modes"].get("refresh", 0)
                   + stats["modes"].get("full", 0))
        if launches["block_summary"] != chunks + commits:
            raise AssertionError(f"K4 launches {launches['block_summary']} "
                                 f"!= {chunks} prefill chunks + {commits} "
                                 f"commits")
        say(card, f"K4 launches [{label}] {launches['block_summary']} = "
                  f"{chunks} prefill chunks + {commits} commits, each over "
                  f"{cfg.num_layers} layers")
        want_graphs = {("prefill", 256), (True, False, True),
                       (False, True, False)}
        if graphs and set(eng._graphs) != want_graphs:
            raise AssertionError(f"graphs captured: "
                                 f"{sorted(map(str, eng._graphs))}")
        _check_final_summaries(torch, card, eng.final_state.cache)
        eng.final_state = None
        if toks.shape != (1, new_tokens) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"tokens out of range: {toks}")
        prof = profile_steps(torch, card, eng, prompt, label=label,
                             kernel="retrieval_score_kernel", refresh=True,
                             prefill_kernel="block_summary_kernel")
        if not graphs:
            check_sync_free(torch, card, eng, prompt[:, : prompt_len // 2])
        runs[label] = dict(toks=toks, launches=launches, wall_s=wall,
                           tokens_per_s=new_tokens / wall,
                           prefill_s=stats["prefill_s"], peak_gib=peak,
                           capture_s=eng.capture_s, **prof)
        del eng
        torch.cuda.empty_cache()
    compare_runs(card, "llama3.1-8b", runs)
    del params, dparams
    torch.cuda.empty_cache()
    return runs["graphs"]["launches"]


RUN_LABEL = {False: "eager", True: "graphs"}


def _nbytes(obj) -> int:
    """Bytes of every tensor in a nest of dicts and lists."""
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return obj.numel() * obj.element_size() if hasattr(obj, "numel") else 0


def memory_line(torch, card, label, eng, params, dparams, peak):
    """Where a run's device memory went: the weights, the engine's static
    state, what else stays allocated after ``generate`` (the graphs'
    pool, with graphs) and the peak above that (transients: a step's
    intermediates, the warm-up copy of the state at each capture)."""
    gib = 2.0**30
    weights = (_nbytes(params) + _nbytes(dparams)) / gib
    static = sum(t.numel() * t.element_size()
                 for t in eng._static_tensors()) / gib
    held = torch.cuda.memory_allocated() / gib
    say(card, f"memory [{label}]: weights {weights:.3f} GiB, static state "
              f"{static:.3f} GiB, other held after generate "
              f"{held - weights - static:.3f} GiB, peak {peak:.3f} GiB "
              f"({peak - held:.3f} above what stays held)")


def compare_runs(card, name, runs):
    """Graphs against eager on one path: the tokens and launch counts must
    be equal; the numbers of both runs side by side."""
    import numpy as np
    e, g = runs["eager"], runs["graphs"]
    if not np.array_equal(e["toks"], g["toks"]):
        raise AssertionError(f"{name}: graph tokens differ from eager:\n"
                             f"{g['toks']}\n{e['toks']}")
    if e["launches"] != g["launches"]:
        raise AssertionError(f"{name}: graph launch counts {g['launches']} "
                             f"!= eager {e['launches']}")
    say(card, f"{name}: graph generate == eager generate over "
              f"{e['toks'].shape[1]} tokens, launch counts equal")
    for key in ("wall_ms_step", "tokens_per_s", "prefill_s", "idle_share",
                "idle_share_unprofiled", "busy_ms_step",
                "device_launches_step", "host_launch_calls_step",
                "host_ops_step", "prefill_device_launches_chunk",
                "prefill_host_launch_calls_chunk", "prefill_busy_ms",
                "prefill_wall_s", "peak_gib", "capture_s"):
        say(card, f"{name} eager vs graphs: {key} {e[key]:.4f} -> "
                  f"{g[key]:.4f}")


def check_sync_free(torch, card, eng, prompt):
    """After a prefill of ``prompt``, one eager run of each step variant's
    body and of the 256-token prefill chunk's under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    operation that waits for the card (a host read, a copy from pageable
    memory): what a graph captures must not sync."""
    from repro_torch.core.engine import MODE_IDS
    st = eng.prefill(prompt)
    toks = eng._chunk_buf(eng.batch, 256)
    if eng.is_attn:
        eng._rows.fill_(True)
        bodies = [(mode, (lambda mode=mode, key=key: (
            eng._modes.fill_(MODE_IDS[mode]), eng._fused_body(*key))))
            for mode, key in (("full", (True, False, False)),
                              ("refresh", (True, False, True)),
                              ("partial", (False, True, False)))]
    else:
        bodies = [("state", eng._state_body)]
    bodies.append(("prefill chunk", lambda: eng._prefill_body(
        toks, st.cache, st.dcache, eng._prev_feat, eng._logits_last)))
    torch.cuda.synchronize()
    for label, body in bodies:
        torch.cuda.set_sync_debug_mode("error")
        try:
            body()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say(card, f"sync check: the {', '.join(lb for lb, _ in bodies)} bodies "
              f"ran eagerly under set_sync_debug_mode('error') without a "
              f"sync")


def _check_final_summaries(torch, card, cache):
    """Every layer's page summaries in the cache ``generate`` left,
    against the plain version recomputed from its pool: each row's
    blocks over [0, length), bit for bit, and 0 on every page no block of
    a row covers, the null page 0 among them."""
    from repro_torch.kernels import ref
    pt, length = cache["page_table"], cache["length"]
    want = torch.zeros((2,) + tuple(cache["kmax"].shape), device="cuda")
    ref.paged_block_summaries(cache["k"], pt, torch.zeros_like(length),
                              length, pt.shape[1], want[0], want[1])
    torch.cuda.synchronize()
    for name, w in (("kmax", want[0]), ("kmin", want[1])):
        if not torch.equal(cache[name], w):
            bad = (cache[name] != w).reshape(w.shape[0], w.shape[1], -1)
            raise AssertionError(
                f"final cache {name} differs from the plain recomputation "
                f"on (layer, page) {bad.any(-1).nonzero()[:8].tolist()}")
    if float(cache["kmax"][:, 0].abs().max()) != 0.0:
        raise AssertionError("the null page's summaries are not 0")
    say(card, f"final cache summaries ({tuple(cache['kmax'].shape)}, "
              f"length {length.tolist()}) equal the plain recomputation "
              f"bit for bit; the null page is 0 in every layer")


def _device_busy(prof):
    """(busy ms, span ms) of the device events a profiler recorded: the
    union of their intervals, and first start to last end."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    if not spans:
        raise RuntimeError("the profiler recorded no device time")
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    return busy_us / 1e3, (spans[-1][1] - spans[0][0]) / 1e3


# the CUDA API calls (runtime and cu*) by which the host starts device work
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def _launch_counts(prof):
    """(device launches, top-level host ops, host launch calls) a profiler
    recorded: every kernel, copy and set on the card (a graph's too),
    every aten op the host dispatched that no other op called, and every
    runtime call that started device work (a graph replay is one)."""
    from torch.autograd import DeviceType
    dev_n = host_n = calls = 0
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            dev_n += 1
        elif e.name in HOST_LAUNCH_CALLS:
            calls += 1
        elif e.cpu_parent is None and e.name.startswith("aten::"):
            host_n += 1
    return dev_n, host_n, calls


def _named_ms(prof, kernel):
    """Device ms of every kernel whose name contains ``kernel``."""
    from torch.autograd import DeviceType
    return sum(_dev_us(e) for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and kernel in e.key) / 1e3


def profile_steps(torch, card, eng, prompt, warm: int = 2, steps: int = 6,
                  kernel: str = "", refresh: bool = False,
                  prefill_kernel: str = "", label: str = ""):
    """Where the time goes.  The fresh prefill runs under
    ``torch.profiler`` (its device busy time and span, the device time
    of the kernels named ``prefill_kernel`` or else ``kernel``, and its
    device launches, top-level host ops and host launch calls per
    256-token chunk); then after ``warm`` steps, ``steps`` steps timed on
    the host clock, then ``steps`` more under the profiler: device time
    by CUDA kernel, and, over the profiled steps alone, the idle share =
    1 - device busy time (union of the device events' intervals) / the
    device span (first event's start to last event's end), beside the
    host clock around the same steps.  The idle share without the
    profiler is 1 - that busy time / the unprofiled host wall time per
    step (the profiler slows the host, not the card).  With ``refresh``,
    two forced Refresh steps follow under the profiler: their device busy
    time and the share of it in ``kernel``.  Returns the numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        st = eng.prefill(prompt)
        torch.cuda.synchronize()
        pre_wall = time.perf_counter() - t0
    busy, span = _device_busy(prof)
    chunks = -(-prompt.shape[1] // 256)
    dev_n, host_n, calls_n = _launch_counts(prof)
    pk = prefill_kernel or kernel
    say(card, f"profile [{label}] prefill of {prompt.shape[1]} tokens: host "
              f"wall_s {pre_wall:.3f} (profiled) device span_ms {span:.2f} "
              f"device busy_ms {busy:.2f} ({pk} {_named_ms(prof, pk):.3f} "
              f"ms); per chunk of 256 ({chunks} chunks): device launches "
              f"{dev_n / chunks:.1f}, top-level host aten ops "
              f"{host_n / chunks:.1f}, host launch calls "
              f"{calls_n / chunks:.1f}")
    out = dict(prefill_wall_s=pre_wall, prefill_busy_ms=busy,
               prefill_span_ms=span,
               prefill_device_launches_chunk=dev_n / chunks,
               prefill_host_ops_chunk=host_n / chunks,
               prefill_host_launch_calls_chunk=calls_n / chunks)

    def run(st, n):
        modes = []
        for _ in range(n):
            st, so = eng.step(st, eng.next_mode())
            modes.append(so.mode)
        torch.cuda.synchronize()
        return st, modes

    st, _ = run(st, warm)
    t0 = time.perf_counter()
    st, modes = run(st, steps)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        st, pmodes = run(st, steps)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, span_ms = _device_busy(prof)
    dev_n, host_n, calls_n = _launch_counts(prof)
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and _dev_us(e) > 0]
    idle_unprof = 1 - busy_ms / wall_ms
    say(card, f"profile [{label}] decode steps {modes} then {pmodes}: "
              f"unprofiled wall_ms/step {wall_ms / steps:.2f}; profiled "
              f"steps: host wall_ms/step {prof_wall_ms / steps:.2f} device "
              f"span_ms/step {span_ms / steps:.2f} device busy_ms/step "
              f"{busy_ms / steps:.2f} idle_share {1 - busy_ms / span_ms:.3f} "
              f"(unprofiled: {idle_unprof:.3f}) device launches/step "
              f"{dev_n / steps:.1f} host launch calls/step "
              f"{calls_n / steps:.1f} top-level host aten ops/step "
              f"{host_n / steps:.1f}")
    for e in sorted(kernels, key=_dev_us, reverse=True)[:10]:
        say(card, f"profile [{label}]   {_dev_us(e) / 1e3 / steps:8.3f} "
                  f"ms/step {e.count // steps:5d} launches/step  "
                  f"{e.key[:80]}")
    out.update(wall_ms_step=wall_ms / steps, busy_ms_step=busy_ms / steps,
               idle_share=1 - busy_ms / span_ms,
               idle_share_unprofiled=idle_unprof,
               device_launches_step=dev_n / steps,
               host_launch_calls_step=calls_n / steps,
               host_ops_step=host_n / steps)
    if refresh:
        with profile(activities=acts) as prof:
            for _ in range(2):
                st, so = eng.step(st, "refresh")
            torch.cuda.synchronize()
        busy_ms, span_ms = _device_busy(prof)
        k_ms = _named_ms(prof, kernel)
        say(card, f"profile [{label}] 2 forced Refresh steps: device "
                  f"busy_ms/step {busy_ms / 2:.2f} span_ms/step "
                  f"{span_ms / 2:.2f}; {kernel} {k_ms / 2:.4f} ms/step = "
                  f"{k_ms / busy_ms:.4f} of device busy time")
    return out


# ---------------------------------------------------------------------------
# phase 4: losslessness at full width, reduced depth, fp32
# ---------------------------------------------------------------------------

def phase_lossless(torch, card, prompt_len: int, new_tokens: int):
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.core.reference import autoregressive_generate
    from repro_torch.models.api import init_params

    # fp32 results are compared: keep matmuls and convolutions out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3.1-8b").replace(num_layers=4, dtype="float32",
                                            param_dtype="float32")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=2, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=3, device="cuda")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (1, prompt_len)).astype(np.int64)
    max_len = request_token_need(prompt_len, new_tokens, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    t0 = time.perf_counter()
    ar = autoregressive_generate(cfg, params, prompt, new_tokens,
                                 max_len=max_len, spec=spec, device="cuda")
    full = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=max_len, paged=True, zero_copy=True,
                        partial_verification=False, device="cuda")
    toks_full, st_full = full.generate(prompt, new_tokens)
    if not full._graphs:
        raise AssertionError("the full-verification run replayed no graph")
    if not np.array_equal(toks_full, ar):
        raise AssertionError(f"full-verification SpecPV differs from AR:\n"
                             f"{toks_full}\n{ar}")
    del full
    toks_part = {}
    for graphs in (True, False):
        part = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                            max_len=max_len, paged=True, zero_copy=True,
                            device="cuda", cuda_graphs=graphs)
        toks_part[graphs], st_part = part.generate(prompt, new_tokens)
        del part
    if not np.array_equal(toks_part[True], toks_part[False]):
        raise AssertionError(f"partial-verification run: graphs differ from "
                             f"eager:\n{toks_part[True]}\n{toks_part[False]}")
    if toks_part[True].min() < 0 or toks_part[True].max() >= cfg.vocab_size:
        raise AssertionError(f"partial-verification tokens out of range")
    agree = float(np.mean(toks_part[True] == ar))
    say(card, f"lossless llama3.1-8b x4 layers fp32, graphs: full-verify == "
              f"AR over {new_tokens} tokens (modes {st_full['modes']}); "
              f"partial run modes {st_part['modes']} equals its eager run "
              f"and agrees with AR on {agree:.3f} of tokens; "
              f"{time.perf_counter() - t0:.1f} s")
    del params, dparams
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: the state-architecture path (rwkv6-3b chain speculation)
# ---------------------------------------------------------------------------

def phase_rwkv(torch, card, prompt_len: int = PROMPT_LEN,
               new_tokens: int = NEW_TOKENS):
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.kernels import ops
    from repro_torch.models.api import init_params

    cfg = get_config("rwkv6-3b")
    spec = SpecPVConfig()
    dcfg = DraftConfig()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    say(card, f"rwkv6-3b random weights ready in "
              f"{time.perf_counter() - t0:.1f} s")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, prompt_len)).astype(np.int64)
    max_len = request_token_need(prompt_len, new_tokens, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    chunk = 256
    runs = {}
    for graphs in (False, True):
        label = RUN_LABEL[graphs]
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=max_len, paged=False, device="cuda",
                           cuda_graphs=graphs)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks, stats = eng.generate(prompt, new_tokens, prefill_chunk=chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        by_shape = {WKV_PATH_SHAPES.get(key, f"T={key[0]} update={key[1]}"): n
                    for key, n in ops.WKV_SHAPES.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        memory_line(torch, card, label, eng, params, dparams, peak)
        chunks = -(-prompt_len // chunk)
        want_wkv = cfg.num_layers * (chunks + 2 * stats["steps"])
        say(card, f"generate rwkv6-3b [{label}] ({cfg.num_layers} layers, d "
                  f"{cfg.d_model}, {cfg.dtype}, random weights, chain depth "
                  f"{dcfg.tree_depth}) prompt {prompt_len} new "
                  f"{new_tokens}: modes {stats['modes']} steps "
                  f"{stats['steps']} mean_accept {stats['mean_accept']:.4f} "
                  f"wall_s {wall:.3f} (prefill_s {stats['prefill_s']:.3f}) "
                  f"tokens_per_s {new_tokens / wall:.2f} peak_mem_gib "
                  f"{peak:.2f} capture_s {eng.capture_s:.3f} graphs "
                  f"{sorted(map(str, eng._graphs))} wkv_launches "
                  f"{launches['wkv']} (expected {cfg.num_layers} x ({chunks} "
                  f"prefill chunks + 2 x {stats['steps']} steps) = "
                  f"{want_wkv}) launches {launches}")
        say(card, f"wkv launches by shape [{label}] (counted in ops.wkv): "
                  f"{by_shape}")
        if stats["modes"] != {"state": stats["steps"]}:
            raise AssertionError(f"state steps only: {stats['modes']}")
        if launches["wkv"] != want_wkv:
            raise AssertionError(f"WKV launches {launches['wkv']} != "
                                 f"{want_wkv}")
        # one T=256 call per layer and prefill chunk, one read-only T=6
        # verify and one T=6 advance per layer and step
        steps_n = cfg.num_layers * stats["steps"]
        want_shapes = {"prefill T=256": cfg.num_layers * chunks,
                       "verify T=6": steps_n, "advance T=6": steps_n}
        if sum(by_shape.values()) != want_wkv or by_shape != want_shapes:
            raise AssertionError(f"WKV launches by shape {by_shape} != "
                                 f"{want_shapes}")
        if graphs and set(eng._graphs) != {("prefill", 256), "state"}:
            raise AssertionError(f"graphs captured: "
                                 f"{sorted(map(str, eng._graphs))}")
        launches["wkv_shapes"] = by_shape
        if toks.shape != (1, new_tokens) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"tokens out of range: {toks}")
        prof = profile_steps(torch, card, eng, prompt, kernel="wkv_kernel",
                             label=label)
        if not graphs:
            check_sync_free(torch, card, eng, prompt[:, : prompt_len // 2])
        runs[label] = dict(toks=toks, launches=launches, wall_s=wall,
                           tokens_per_s=new_tokens / wall,
                           prefill_s=stats["prefill_s"], peak_gib=peak,
                           capture_s=eng.capture_s, **prof)
        del eng
        torch.cuda.empty_cache()
    compare_runs(card, "rwkv6-3b", runs)
    del params, dparams
    torch.cuda.empty_cache()
    rwkv_lossless(torch, card)
    return runs["graphs"]["launches"]


def rwkv_lossless(torch, card, prompt_len: int = 1024, new_tokens: int = 32):
    """fp32, 4 layers at full width: chain-speculation ``generate`` equals
    the port's autoregressive decoding (one read-only decode and one
    advance per token).  ``u``, ``lora_B`` and ``wd_B``, zero in the
    reference's init, get random values so every term of the recurrence
    and the data-dependent lerp and decay runs."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.core.reference import autoregressive_generate
    from repro_torch.models.api import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("rwkv6-3b").replace(num_layers=4, dtype="float32",
                                         param_dtype="float32")
    spec = SpecPVConfig()
    dcfg = DraftConfig()
    params = init_params(cfg, seed=2, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for lp in params["layers"]:
        for name, scale in (("u", 0.5), ("lora_B", 0.1), ("wd_B", 0.1)):
            lp[name] = torch.randn(lp[name].shape, generator=gen,
                                   device="cuda") * scale
    dparams = init_draft_params(cfg, dcfg, seed=3, device="cuda")
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, prompt_len)).astype(np.int64)
    max_len = request_token_need(prompt_len, new_tokens, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    t0 = time.perf_counter()
    ar = autoregressive_generate(cfg, params, prompt, new_tokens,
                                 max_len=max_len, spec=spec, device="cuda")
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                       max_len=max_len, paged=False, device="cuda")
    toks, st = eng.generate(prompt, new_tokens)
    if set(eng._graphs) != {("prefill", 256), "state"}:
        raise AssertionError(f"graphs: {sorted(map(str, eng._graphs))}")
    if not np.array_equal(toks, ar):
        raise AssertionError(f"rwkv6-3b chain SpecPV differs from AR:\n"
                             f"{toks}\n{ar}")
    say(card, f"lossless rwkv6-3b x4 layers fp32, graphs: chain generate == "
              f"AR over {new_tokens} tokens of a {prompt_len}-token prompt "
              f"(steps "
              f"{st['steps']}, mean_accept {st['mean_accept']:.4f}); "
              f"{time.perf_counter() - t0:.1f} s")
    del params, dparams, eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: continuous-batching serving at full width
# ---------------------------------------------------------------------------

# six requests arriving together (prompt tokens, new tokens): two under
# the 4480-token partial budget, four over it.  With random weights no
# draft token is accepted, so equal budgets would finish on one tick and
# no slot would ever free while the pool is short: the shortest request
# asks for 32 tokens, so its slot frees while the 8192-token waiters
# cannot fit (page stalls)
SERVE_REQS = ((2048, 32), (3072, 64), (4608, 64), (6144, 64), (8192, 64),
              (8192, 64))
SERVE_MAX_LEN = 8448                # 66 blocks of 128
SERVE_PAGES = 161                   # the first four fit, an 8192 does not


def _serve(torch, srv, reqs):
    """Run ``reqs`` through ``srv`` with every launch count set to 0 just
    before and read just after.  Returns (outputs by id, wall s, launch
    counts, peak GiB)."""
    from repro_torch.kernels import ops
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    outs = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return {o.request_id: o for o in outs}, wall, launches, peak


def _expected_serving_launches(eng, layers):
    """K1-K4 launches implied by the steps' variants and the prefill
    chunks: per step K1 once per layer for each context source (full
    pages, routed partial), K3 once per layer with a Refresh row, K4 once
    with a committing (Full or Refresh) row; per chunk K2 once per layer
    and K4 once over all layers."""
    k1 = k3 = k4 = 0
    for (has_full, has_partial, has_refresh), n in eng.dispatch_keys.items():
        k1 += layers * n * (int(has_full) + int(has_partial))
        k3 += layers * n * int(has_refresh)
        k4 += n * int(has_full)
    chunks = eng.prefill_dispatches
    return {"sparse_verify_attention": k1,
            "paged_prefill_attention": layers * chunks,
            "retrieval_score": k3, "block_summary": k4 + chunks}


def _serving_requests(prompts, reqs_spec):
    from repro_torch.serving import Request
    now = time.time()
    return [Request(request_id=f"r{i}", prompt=p, max_new_tokens=new,
                    arrival_s=now)
            for i, (p, (_, new)) in enumerate(zip(prompts, reqs_spec))]


def phase_serving(torch, card):
    """Continuous batching of llama3.1-8b at full width (random bf16
    weights, batch 4, a 161-page pool): the six ``SERVE_REQS`` with
    graphs, then eagerly (equal tokens and launch counts), then each
    alone through batch-1 ``generate`` (matches reported: bf16 rows are
    not batch-invariant); a profiled window of decode ticks; the serving
    bodies under the sync check; fp32 losslessness at 4 layers."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.models.api import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    cfg = get_config("llama3.1-8b")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    say(card, f"serving: llama3.1-8b random weights ready in "
              f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n, _ in SERVE_REQS]
    scfg = ServingConfig(batch=4, max_len=SERVE_MAX_LEN, prefill_chunk=256,
                         num_pages=SERVE_PAGES)
    runs = {}
    for graphs in (True, False):
        label = RUN_LABEL[graphs]
        srv = ServingEngine(cfg, spec, dcfg, params, dparams, scfg,
                            device="cuda", cuda_graphs=graphs)
        outs, wall, launches, peak = _serve(
            torch, srv, _serving_requests(prompts, SERVE_REQS))
        sched = srv._continuous
        eng = sched.engine
        st = srv.stats
        need = [eng.pages_needed(n, new) for n, new in SERVE_REQS]
        if sum(need[:4]) > eng.page_capacity() or \
                sum(need[:4]) + need[4] <= eng.page_capacity():
            raise AssertionError(f"pool of {SERVE_PAGES} pages: the first "
                                 f"four requests ({need[:4]}) must fit and "
                                 f"a fifth ({need[4]}) must not")
        toks = {k: o.tokens for k, o in outs.items()}
        for i, (n, new) in enumerate(SERVE_REQS):
            o = outs[f"r{i}"]
            if (o.finish_reason != "length" or len(o.tokens) != new
                    or o.tokens.min() < 0 or o.tokens.max() >= cfg.vocab_size):
                raise AssertionError(f"request r{i}: {o.finish_reason}, "
                                     f"{len(o.tokens)} tokens")
        ps = eng.page_stats()
        if not st["page_stalls"] > 0:
            raise AssertionError("no admission stalled on pages")
        if ps["pinned_pages"] or ps["in_use"] or ps["draft_in_use"]:
            raise AssertionError(f"pages left after the run: {ps}")
        if not (st["mode_rows_refresh"] and st["mode_rows_partial"]
                and st["mode_rows_full"] and st.get("ticks_modes_2")):
            raise AssertionError(f"the ticks must mix Full, Refresh and "
                                 f"Partial rows: {dict(st)}")
        want = _expected_serving_launches(eng, cfg.num_layers)
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"serving launches {got} != {want} implied "
                                 f"by {eng.dispatch_keys} and "
                                 f"{eng.prefill_dispatches} prefill chunks")
        lat = np.array([o.latency_s for o in outs.values()])
        ntok = int(sum(len(t) for t in toks.values()))
        # a class's first tick may include its graph's capture: the median
        # leaves it out
        ticks = {c: (len(v), 1e3 * float(np.median(v)),
                     1e3 * float(np.mean(v)))
                 for c, v in sched.tick_wall.items()}
        say(card, f"serving llama3.1-8b [{label}] batch 4, {SERVE_PAGES} "
                  f"pages, requests {[n for n, _ in SERVE_REQS]}: answered "
                  f"{len(outs)} tokens {ntok} wall_s {wall:.3f} "
                  f"tokens_per_s {ntok / wall:.2f} latency_s p50 "
                  f"{np.percentile(lat, 50):.3f} p95 "
                  f"{np.percentile(lat, 95):.3f} steps {int(st['steps'])} "
                  f"prefill chunks {eng.prefill_dispatches} peak_mem_gib "
                  f"{peak:.2f} capture_s {eng.capture_s:.3f} graphs "
                  f"{sorted(map(str, eng._graphs))}")
        say(card, f"serving [{label}] tick wall ms by class (ticks: median, "
                  f"mean): " + ", ".join(
                      f"{c} {n}: {med:.2f}, {mean:.2f}"
                      for c, (n, med, mean) in sorted(ticks.items())))
        memory_line(torch, card, f"serving {label}", eng, params, dparams,
                    peak)
        say(card, f"serving [{label}] " + " ".join(
            f"{k} {int(v)}" for k, v in sorted(st.items())
            if k.startswith(("mode_rows_", "ticks_modes_"))
            or k in ("page_stalls", "admissions")))
        say(card, f"serving [{label}] page_stats {ps} variants "
                  f"{ {str(k): n for k, n in eng.dispatch_keys.items()} }")
        say(card, f"serving [{label}] launches {got} == implied by the "
                  f"steps' variants and {eng.prefill_dispatches} chunks")
        if graphs:
            want_graphs = {("slot_prefill", 256)} | set(eng.dispatch_keys)
            if set(eng._graphs) != want_graphs:
                raise AssertionError(f"graphs {sorted(map(str, eng._graphs))}"
                                     f" != {sorted(map(str, want_graphs))}")
            prof = profile_ticks(torch, card, srv, prompts)
            check_sync_free_serving(torch, card, eng, prompts)
        runs[label] = dict(toks=toks, launches=got, wall_s=wall,
                           tokens_per_s=ntok / wall, peak_gib=peak,
                           ticks=ticks, stats=dict(st), pages=ps,
                           p50=float(np.percentile(lat, 50)),
                           p95=float(np.percentile(lat, 95)),
                           capture_s=eng.capture_s)
        if graphs:
            runs[label].update(prof)
        del srv, sched, eng
        torch.cuda.empty_cache()
    g, e = runs["graphs"], runs["eager"]
    for rid in g["toks"]:
        if not np.array_equal(g["toks"][rid], e["toks"][rid]):
            raise AssertionError(f"serving {rid}: graph tokens differ from "
                                 f"eager")
    if g["launches"] != e["launches"]:
        raise AssertionError(f"serving launches: graphs {g['launches']} "
                             f"eager {e['launches']}")
    say(card, "serving: graph tokens == eager tokens for every request, "
              "launch counts equal")
    # each request alone through batch-1 generate on one engine
    solo = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=SERVE_MAX_LEN, device="cuda")
    match, first_diff = 0, {}
    for i, ((n, new), p) in enumerate(zip(SERVE_REQS, prompts)):
        t, _ = solo.generate(p[None], new)
        d = np.nonzero(t[0] != g["toks"][f"r{i}"])[0]
        if d.size:
            first_diff[f"r{i}"] = int(d[0])
        else:
            match += 1
    say(card, f"serving bf16 vs solo batch-1 generate: {match} of "
              f"{len(SERVE_REQS)} requests equal; first diverging position "
              f"{first_diff} (not asserted: cuBLAS picks its GEMM by the row "
              f"count and the split-KV count depends on B)")
    del solo
    torch.cuda.empty_cache()
    del params, dparams
    torch.cuda.empty_cache()
    serving_lossless(torch, card)
    g["solo_match"] = match
    return g


def profile_ticks(torch, card, srv, prompts, warm: int = 3, ticks: int = 6):
    """A fresh scheduler on the graph run's engine with four requests of
    4608 tokens (the first 4608 of prompts 2-5; 4 x 38 pages fit): the
    first tick admits them (blocking prefill) and refreshes every row, then
    after ``warm`` Partial ticks ``ticks`` more on the host clock and
    ``ticks`` more under ``torch.profiler``: device busy ms, device
    launches, host launch calls and device time by kernel per batch-4
    Partial tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ContinuousScheduler
    eng = srv._engine_for(srv.scfg.batch, paged=True)
    sched = ContinuousScheduler(eng, prefill_chunk=srv.scfg.prefill_chunk)
    four = [p[:4608] for p in prompts[2:6]]
    for r in _serving_requests(four, [(4608, 64)] * 4):
        sched.submit(r)
    for _ in range(1 + warm):
        sched.tick()
    torch.cuda.synchronize()
    parts0 = sched.stats["mode_rows_partial"]
    t0 = time.perf_counter()
    for _ in range(ticks):
        sched.tick()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            sched.tick()
        torch.cuda.synchronize()
    if sched.stats["mode_rows_partial"] - parts0 != 2 * ticks * 4:
        raise AssertionError(f"the profiled ticks must be batch-4 Partial "
                             f"ticks: {dict(sched.stats)}")
    busy, span = _device_busy(prof)
    dev_n, host_n, calls_n = _launch_counts(prof)
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and _dev_us(e) > 0]
    for e in sorted(kernels, key=_dev_us, reverse=True)[:10]:
        say(card, f"serving profile   {_dev_us(e) / 1e3 / ticks:8.3f} "
                  f"ms/tick {e.count // ticks:5d} launches/tick  "
                  f"{e.key[:80]}")
    say(card, f"serving profile: {ticks} batch-4 Partial ticks (4 x 4608 "
              f"tokens): unprofiled wall_ms/tick {wall_ms:.2f}; device "
              f"busy_ms/tick {busy / ticks:.2f} idle_share_unprofiled "
              f"{1 - busy / ticks / wall_ms:.3f} device launches/tick "
              f"{dev_n / ticks:.1f} host launch calls/tick "
              f"{calls_n / ticks:.1f} top-level host aten ops/tick "
              f"{host_n / ticks:.1f}")
    return dict(tick_wall_ms=wall_ms, tick_busy_ms=busy / ticks,
                tick_host_launch_calls=calls_n / ticks,
                tick_device_launches=dev_n / ticks)


def check_sync_free_serving(torch, card, eng, prompts):
    """On the serving engine with two slots decoding and two empty: the
    slot prefill chunk's body and each step variant's body with the row
    mask [1, 1, 0, 0] (an empty slot among the masked rows), run eagerly
    under ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.core.engine import MODE_IDS
    st = eng.empty_state()
    for slot in (0, 1):
        st, _ = eng.prefill_into_slot(st, slot, prompts[slot],
                                      max_new_tokens=32)
    toks = eng._chunk_buf(1, 256)
    cache = dict(eng._slot_cache, **{n: st.cache[n]
                                     for n in ("k", "v", "kmax", "kmin")})
    dcache = dict(eng._slot_dcache, k=st.dcache["k"], v=st.dcache["v"])
    bodies = [("slot prefill chunk", None, lambda: eng._prefill_body(
        toks, cache, dcache, eng._slot_prev_feat, eng._slot_logits))]
    for label, modes, key in (
            ("full", ["full"] * 2, (True, False, False)),
            ("refresh", ["refresh"] * 2, (True, False, True)),
            ("partial", ["partial"] * 2, (False, True, False)),
            ("partial + refresh", ["partial", "refresh"], (True, True, True))):
        ops_in = torch.tensor([[MODE_IDS[m] for m in modes] + [0, 0],
                               [1, 1, 0, 0]], dtype=torch.int8,
                              device="cuda")
        bodies.append((f"{label} rows [1, 1, 0, 0]", ops_in,
                       lambda key=key: eng._fused_body(*key)))
    for label, ops_in, body in bodies:
        if ops_in is not None:
            eng._tick_in.copy_(ops_in)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            body()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say(card, f"serving sync check: the {', '.join(b[0] for b in bodies)} "
              f"bodies ran eagerly under set_sync_debug_mode('error') "
              f"without a sync")


def serving_lossless(torch, card, layers: int = 4, new: int = 32):
    """fp32 at full width, ``layers`` layers: batch 2, three requests (one
    under the partial budget, two over), ``prefill_budget=512``
    (interleaved), with graphs: every request equals its solo batch-1
    ``generate`` and a blocking run of the same trace."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.models.api import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3.1-8b").replace(num_layers=layers,
                                            dtype="float32",
                                            param_dtype="float32")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=2, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=3, device="cuda")
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    spec_reqs = ((3000, new), (4800, new), (5300, new))
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n, _ in spec_reqs]
    max_len = 5632
    toks = {}
    for budget in (512, None):
        srv = ServingEngine(cfg, spec, dcfg, params, dparams,
                            ServingConfig(batch=2, max_len=max_len,
                                          prefill_budget=budget),
                            device="cuda")
        for r in _serving_requests(prompts, spec_reqs):
            srv.submit(r)
        srv.run()
        toks[budget] = {k: o.tokens for k, o in srv.outputs.items()}
        modes = {k: int(v) for k, v in srv.stats.items()
                 if k.startswith("mode_rows_")}
        if budget == 512 and not srv.stats["prefill_dispatches"]:
            raise AssertionError("the interleaved run pumped no chunk")
        del srv
    solo = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=max_len, device="cuda")
    for i, p in enumerate(prompts):
        t, _ = solo.generate(p[None], new)
        for budget, label in ((512, "interleaved"), (None, "blocking")):
            if not np.array_equal(toks[budget][f"r{i}"], t[0]):
                raise AssertionError(f"fp32 serving r{i} ({label}) differs "
                                     f"from solo generate:\n"
                                     f"{toks[budget][f'r{i}']}\n{t[0]}")
    say(card, f"serving lossless llama3.1-8b x{layers} layers fp32, graphs, "
              f"batch 2, prompts {[n for n, _ in spec_reqs]}: interleaved "
              f"(prefill_budget 512) == blocking == solo generate for every "
              f"request over {new} tokens (mode rows {modes}); "
              f"{time.perf_counter() - t0:.1f} s")
    del params, dparams, solo
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="2,3,4,5,6",
                    help="comma list of phases 2 (kernels), 3 (llama "
                         "generate), 4 (llama losslessness), 5 (rwkv6-3b "
                         "generate and losslessness), 6 (llama serving); "
                         "1 and 7 always run")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",") if p}

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability 9.0, found {cap}")
    say(card, f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} capability {cap}")

    from repro_torch.kernels import build, ops
    build.load_library()
    info = build.BUILD_INFO
    say(card, f"kernels built in {info['seconds']:.1f} s "
              f"(cached={info['cached']}) -> {info['path']}")
    for line in info.get("ptxas", "").splitlines():
        if ("registers" in line or "spill" in line
                or "entry function" in line):
            say(card, f"ptxas: {line.strip()}")

    timer = Timer(torch)
    kres = phase_kernels(torch, card, timer) if 2 in phases else {}
    llama = (phase_generate(torch, card) if 3 in phases
             else {k: 0 for k in ops.KERNELS})
    if 4 in phases:
        phase_lossless(torch, card, prompt_len=4800, new_tokens=32)
    rwkv = (phase_rwkv(torch, card) if 5 in phases
            else {k: 0 for k in ops.KERNELS})
    serving = (phase_serving(torch, card) if 6 in phases
               else {"launches": {}})

    rows = []
    for name in ops.KERNELS:
        r = kres.get(name, {})
        path = rwkv if name in RWKV_KERNELS else llama
        rows.append(dict(name=name, route="cuda", **KERNEL_META[name],
                         launches=int(path.get(name, 0)),
                         serving_launches=int(
                             serving["launches"].get(name, 0)),
                         max_abs_err=r.get("max_abs_err"), ms=r.get("ms"),
                         plain_ms=r.get("plain_ms"),
                         bound_ms=r.get("bound_ms"),
                         bound_by=r.get("bound_by"),
                         library_ms=r.get("library_ms")))
        if "shapes" in r:      # every timed shape (K5: with its launches)
            by_shape = path.get(f"{name}_shapes")
            rows[-1]["shapes"] = []
            for label, vals in r["shapes"].items():
                sh = dict(shape=label, **vals)
                if by_shape is not None:
                    sh["launches"] = by_shape.get(label, 0)
                rows[-1]["shapes"].append(sh)
                say(card, f"kernel {name} {label}: ms {sh['ms']:.4f} "
                          f"bound_ms {sh['bound_ms']:.5f} plain_ms "
                          f"{sh['plain_ms']:.4f} library_ms "
                          f"{sh.get('library_ms')} launches on the path "
                          f"{sh.get('launches', 'not counted by shape')}")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
