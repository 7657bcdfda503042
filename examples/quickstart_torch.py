"""Quickstart of the PyTorch port: train a tiny target + EAGLE-3-style
draft on the synthetic long-document corpus, then compare

  1. plain autoregressive decoding (the compiled AR: one CUDA graph per
     decode step on the card),
  2. self-speculative decoding with FULL verification (lossless),
  3. SpecPV: partial verification + periodic refresh (the paper),

reporting accept length tau, tokens/step, the target-forward-pass
reduction and cache-traffic bytes by mode.  The counterpart of
``examples/quickstart.py``, with the same flags plus ``--device``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--context 192]
      [--device cpu]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.artifacts import corpus_for, get_trained_pair  # noqa: E402
from repro_torch.configs import SpecPVConfig  # noqa: E402
from repro_torch.core.engine import SpecPVEngine  # noqa: E402
from repro_torch.core.reference import CompiledAR  # noqa: E402
from repro_torch.data import continuation_task  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def _sync(dev):
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--context", type=int, default=192)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--target-steps", type=int, default=200)
    ap.add_argument("--draft-steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, dcfg, params, dparams = get_trained_pair(
        "tiny-dense", target_steps=args.target_steps,
        draft_steps=args.draft_steps, device=dev)
    corpus = corpus_for(cfg)
    spec = SpecPVConfig(block_size=16, num_sink_blocks=1,
                        retrieval_budget_blocks=4, local_window_blocks=2,
                        buffer_size=48)
    prompt, _ = continuation_task(corpus, batch=args.batch,
                                  context_len=args.context)
    max_len = args.context + args.max_new + 128

    ar_dec = CompiledAR(cfg, params, batch=args.batch, max_len=max_len,
                        spec=spec, device=dev)
    t0 = time.time()
    ar = ar_dec.generate(prompt, args.max_new)
    t_ar = time.time() - t0
    print(f"\n[AR      ] {args.max_new} tokens in {t_ar:.1f}s "
          f"({args.max_new} target forwards)")

    rows = {"AR": dict(seconds=t_ar)}
    for name, partial in [("SpecPV-full", False), ("SpecPV-part", True)]:
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams,
                           batch=args.batch, max_len=max_len,
                           partial_verification=partial, device=dev)
        t0 = time.time()
        toks, stats = eng.generate(prompt, args.max_new)
        _sync(dev)
        dt = time.time() - t0
        lossless = np.array_equal(toks, ar)
        agree = float((toks == ar).mean())
        print(f"[{name}] {args.max_new} tokens in {dt:.1f}s | "
              f"steps={stats['steps']} "
              f"(forward-pass reduction {args.max_new / stats['steps']:.2f}x)"
              f" | tau={stats['mean_accept']:.2f} "
              f"tokens/step={stats['tokens_per_step']:.2f} | "
              f"modes={stats['modes']} | "
              + ("LOSSLESS vs AR" if lossless
                 else f"agreement vs AR: {agree:.3f}"))
        if partial:
            tm = eng.traffic
            print(f"           cache traffic by mode: "
                  f"{ {k: f'{v/2**20:.1f}MiB' for k, v in tm.bytes_by_mode.items()} }")
        rows[name] = dict(seconds=dt, lossless=lossless, agree=agree,
                          **stats)
    return rows


if __name__ == "__main__":
    main()
