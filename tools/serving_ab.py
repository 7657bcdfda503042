#!/usr/bin/env python3
"""Serving cost of llama3.1-8b on one configuration, on the card.

    python3 tools/serving_ab.py [--src DIR] [--layout paged|contiguous]
        [--budget N] [--pump fused|serial] [--runs N]

Imports the port from ``DIR`` (default: ``src/`` of this checkout), so
that two trees can be compared on one card in one call: run it once per
tree, in turns (parent, change, change, parent).  Each tree builds its
kernels into its own ``build/``.  Serves ``chip_smoke.py``'s six phase-6
requests (2048 to 8192 prompt tokens, arriving together) at llama3.1-8b's
full width (32 layers, bf16, random weights from seed 0), batch 4,
max_len 8448, 256-token chunks, with graphs: on the paged zero-copy pool
of phase 6 (161 pages, no sharing) or on the reference's contiguous
slots; blocking admission, or interleaved with ``--budget`` prompt
tokens per tick and the fused or serial pump (``--pump serial`` sets
``fused_prefill=False``; a tree without the fused pump takes only that).
Each of the ``N`` runs builds a fresh ``ServingEngine``, so its wall
includes the graphs' captures, as the smoke's serving cells do.  Prints
the card's name and power limit first and one JSON line per run last:
tokens/s, wall, time to first token and latency (p50, p95), peak
memory.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--layout", choices=("paged", "contiguous"),
                    default="contiguous")
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--pump", choices=("fused", "serial"), default="fused")
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("serving_ab.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                 # imports neither JAX nor repro
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    from repro_torch.configs import DraftConfig, SpecPVConfig, get_config
    from repro_torch.core.draft import init_draft_params
    from repro_torch.kernels import build
    from repro_torch.models.api import init_params
    from repro_torch.serving import (ContinuousScheduler, ServingConfig,
                                     ServingEngine)

    card = cs.card_line()
    print(card, flush=True)
    build.load_library()
    cfg = get_config("llama3.1-8b")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper",
                        reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=0, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=1, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n, _ in cs.SERVE_REQS]
    kw = dict(batch=4, max_len=cs.SERVE_MAX_LEN, prefill_chunk=256,
              prefill_budget=args.budget)
    pump = {} if args.pump == "fused" else dict(fused_prefill=False)
    if args.layout == "paged":
        kw.update(num_pages=cs.SERVE_PAGES, paged_kv=True,
                  zero_copy_partial=True, prefix_cache=False)
    rows = []
    for _ in range(args.runs):
        srv = ServingEngine(cfg, spec, dcfg, params, dparams,
                            ServingConfig(**kw, **pump), device="cuda")
        eng = srv._engine_for(4, paged=args.layout == "paged")
        sched = ContinuousScheduler(eng, prefill_chunk=256,
                                    prefill_budget=args.budget, **pump)
        trace = sched.trace = cs._StampedTrace()
        srv._continuous = sched
        reqs = cs._serving_requests(prompts, cs.SERVE_REQS)
        arrival = reqs[0].arrival_s
        outs, wall, _, peak = cs._serve(torch, srv, reqs)
        first = "prefill_done" if args.budget else "admit"
        ttft = np.array([t - arrival for (ev, _, _), t in
                         zip(trace, trace.t) if ev == first])
        lat = np.array([o.latency_s for o in outs.values()])
        ntok = int(sum(len(o.tokens) for o in outs.values()))
        rows.append(dict(tokens_per_s=ntok / wall, wall_s=wall,
                         ttft_p50=float(np.percentile(ttft, 50)),
                         ttft_p95=float(np.percentile(ttft, 95)),
                         p50=float(np.percentile(lat, 50)),
                         p95=float(np.percentile(lat, 95)), peak_gib=peak,
                         prefill_dispatches=eng.prefill_dispatches))
        del srv, sched, eng
        torch.cuda.empty_cache()
    for r in rows:
        print(json.dumps(dict(src=args.src, layout=args.layout,
                              budget=args.budget, pump=args.pump, **r)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
