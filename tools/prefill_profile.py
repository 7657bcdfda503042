#!/usr/bin/env python3
"""Host and device cost of the llama3.1-8b paged prefill, on the card.

    python3 tools/prefill_profile.py [--src DIR] [--repeat N]

Imports the port from ``DIR`` (default: ``src/`` of this checkout), so
that two trees can be compared on one card in one call: run it once per
tree, in turns (parent, change, change, parent).  Each tree builds its
kernels into its own ``build/``.  Builds the engine of ``chip_smoke.py``
phase 3 (llama3.1-8b at full width, 32 layers, bf16, random weights from
seed 0, paged zero-copy, the paper's SpecPV spec, batch 1) and then,
``N`` times, runs a fresh 8192-token prefill (256-token chunks) timed on
the host clock after a synchronisation, and another under
``torch.profiler``: device busy time and span, device launches and
top-level host aten ops per chunk, and the block-summary kernel's (K4)
launches per chunk from ``ops.LAUNCHES``.  Prints the card's name and
power limit first and one JSON line of the numbers last.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_LEN, CHUNK = 8192, 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("prefill_profile.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                 # imports neither JAX nor repro
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import DraftConfig, SpecPVConfig, get_config
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.kernels import build, ops
    from repro_torch.models.api import init_params

    card = cs.card_line()
    print(card, flush=True)
    build.load_library()
    cfg = get_config("llama3.1-8b")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper",
                        reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=0, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=1, device="cuda")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PROMPT_LEN)).astype(np.int64)
    max_len = request_token_need(PROMPT_LEN, 128, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                       max_len=max_len, paged=True, zero_copy=True,
                       device="cuda")
    chunks = -(-PROMPT_LEN // CHUNK)
    eng.prefill(prompt, chunk=CHUNK)        # warm-up
    torch.cuda.synchronize()
    runs = []
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        eng.prefill(prompt, chunk=CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.prefill(prompt, chunk=CHUNK)
            torch.cuda.synchronize()
        busy, span = cs._device_busy(prof)
        dev_n, host_n = cs._launch_counts(prof)
        run = dict(wall_s=wall, device_busy_ms=busy, device_span_ms=span,
                   launches_per_chunk=dev_n / chunks,
                   host_ops_per_chunk=host_n / chunks,
                   k4_per_chunk=ops.LAUNCHES["block_summary"] / chunks)
        runs.append(run)
        print(f"[{card}] src {args.src}: prefill of {PROMPT_LEN} tokens "
              + " ".join(f"{k} {v:.4f}" for k, v in run.items()), flush=True)
    print(json.dumps(dict(src=args.src, card=card, runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
