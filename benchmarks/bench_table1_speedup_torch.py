"""Tab. 1/3 on the PyTorch port: decoding speed-up alpha and accept
length tau across context lengths and partial-KV budgets, against the
autoregressive baseline and against full-verification self-speculation
(EAGLE3-YARN analogue).  The counterpart of
``benchmarks/bench_table1_speedup.py``: the same contexts, budgets,
columns and ``--quick``, on the port's trained tiny-dense pair
(``repro_torch.artifacts``).

alpha_wall is the compiled AR's wall time over the method's
(``core.reference.CompiledAR``: one CUDA graph per decode step on the
card, the counterpart of the reference's jitted step), never the eager
plain oracle's.  On the card every engine and the compiled AR run once
untimed first (their graphs are captured then), and the timed run
replays; the plain oracle runs once per context to hold the compiled AR
to it.  fwd_reduction (new tokens over verify steps) does not depend on
the device.

Run:  PYTHONPATH=src python benchmarks/bench_table1_speedup_torch.py
      [--quick] [--device cpu]
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
from repro_torch.core.reference import (CompiledAR,  # noqa: E402
                                        autoregressive_generate)
from repro_torch.data import continuation_task  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "results")


def _timed(dev, fn, warm: bool):
    """(result, wall seconds) of ``fn()``, after one untimed call when
    ``warm`` (the card: it captures the graphs)."""
    if warm:
        fn()
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def print_table(title, header, rows):
    print(f"\n== {title} ==")
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              for i, h in enumerate(header)]
    print("  " + " | ".join(str(h).ljust(w) for h, w in zip(header, widths)))
    for r in rows:
        print("  " + " | ".join(str(x).ljust(w) for x, w in zip(r, widths)))


def write_rows(path, header, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")
    print(f"  -> {path}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--target-steps", type=int, default=200)
    ap.add_argument("--draft-steps", type=int, default=150)
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  "table1_speedup_torch.csv"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    warm = dev.type == "cuda"
    cfg, dcfg, params, dparams = get_trained_pair(
        "tiny-dense", target_steps=args.target_steps,
        draft_steps=args.draft_steps, device=dev)
    corpus = corpus_for(cfg)
    contexts = [192, 384] if args.quick else [192, 384, 768]
    budgets = {"SpecPV-64": 2, "SpecPV-128": 6} if args.quick else \
        {"SpecPV-64": 2, "SpecPV-128": 6, "SpecPV-256": 14}
    max_new = 32 if args.quick else 64
    base_spec = SpecPVConfig(block_size=16, num_sink_blocks=1,
                             retrieval_budget_blocks=4,
                             local_window_blocks=2, buffer_size=48)
    rows, details, ar_equal = [], [], {}
    for ctx in contexts:
        prompt, _ = continuation_task(corpus, batch=1, context_len=ctx)
        max_len = ctx + max_new + 160
        ar_dec = CompiledAR(cfg, params, batch=1, max_len=max_len,
                            device=dev)
        ar, t_ar = _timed(dev, lambda: ar_dec.generate(prompt, max_new),
                          warm)
        oracle = autoregressive_generate(cfg, params, prompt, max_new,
                                         max_len=max_len, device=dev)
        ar_equal[ctx] = bool(np.array_equal(ar, oracle))
        print(f"context {ctx}: compiled AR {t_ar * 1e3:.1f} ms for "
              f"{max_new} tokens, equal to the plain AR oracle: "
              f"{ar_equal[ctx]}")
        methods = [("EAGLE3-full", base_spec, False)] + [
            (name, base_spec.replace(retrieval_budget_blocks=ret), True)
            for name, ret in budgets.items()]
        for name, spec, partial in methods:
            eng = SpecPVEngine(cfg, spec, dcfg, params, dparams,
                               batch=prompt.shape[0], max_len=max_len,
                               partial_verification=partial, device=dev)
            (toks, stats), dt = _timed(
                dev, lambda: eng.generate(prompt, max_new), warm)
            agree = float((toks == ar).mean())
            lossless = bool(np.array_equal(toks, ar))
            rows.append([ctx, name, f"{t_ar / dt:.2f}x",
                         f"{max_new / stats['steps']:.2f}x",
                         f"{stats['mean_accept']:.2f}",
                         f"agree={agree:.3f}" if partial else
                         ("lossless" if lossless else "DIVERGED")])
            details.append(dict(context=ctx, method=name,
                                alpha_wall=t_ar / dt,
                                fwd_reduction=max_new / stats["steps"],
                                tau=stats["mean_accept"], agree=agree,
                                lossless=lossless, seconds=dt,
                                ar_seconds=t_ar, modes=stats["modes"]))
    header = ["context", "method", "alpha_wall", "fwd_reduction", "tau",
              "vs_AR"]
    print_table("Tab.1 — speedup & accept length (PyTorch port, "
                f"{dev.type})", header, rows)
    write_rows(args.out, header, rows)
    for r in rows:
        print(f"table1_torch/{r[0]}/{r[1]},{0.0},alpha={r[2]};tau={r[4]}")
    return dict(rows=rows, details=details, ar_equal=ar_equal)


if __name__ == "__main__":
    main()
