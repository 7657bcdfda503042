"""End-to-end serving driver of the PyTorch port (the paper's workload
kind): batched story-continuation requests served with SpecPV partial
verification.

Submits a queue of requests at several context lengths and serves them
with either the continuous (in-flight) scheduler, the default: requests
are admitted into any free batch slot the moment one opens, and the
SpecPV mode automaton runs per slot; or the wave scheduler baseline
(--scheduler wave).  Reports per-request latency, accept length,
tokens/step and the full-vs-partial cache traffic split.  The
counterpart of ``examples/serve_longcontext.py``, with the same flags
plus ``--device`` and the trained pair's step counts (``--target-steps``
/ ``--draft-steps``, as in ``examples/quickstart_torch.py``).

Run:  PYTHONPATH=src python examples/serve_longcontext_torch.py
      --requests 6 [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.artifacts import corpus_for, get_trained_pair  # noqa: E402
from repro_torch.configs import SpecPVConfig  # noqa: E402
from repro_torch.data import continuation_task  # noqa: E402
from repro_torch.serving import (Request, ServingConfig,  # noqa: E402
                                 ServingEngine)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--scheduler", choices=["continuous", "wave"],
                    default="continuous")
    ap.add_argument("--contexts", type=int, nargs="+",
                    default=[160, 160, 256, 256, 256, 256])
    ap.add_argument("--target-steps", type=int, default=200)
    ap.add_argument("--draft-steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg, dcfg, params, dparams = get_trained_pair(
        "tiny-dense", target_steps=args.target_steps,
        draft_steps=args.draft_steps, device=args.device)
    corpus = corpus_for(cfg)
    spec = SpecPVConfig(block_size=16, num_sink_blocks=1,
                        retrieval_budget_blocks=4, local_window_blocks=2,
                        buffer_size=48)
    scfg = ServingConfig(batch=args.batch,
                         max_len=max(args.contexts) + args.max_new + 128,
                         prefill_chunk=64, partial_verification=True,
                         scheduler=args.scheduler)
    srv = ServingEngine(cfg, spec, dcfg, params, dparams, scfg,
                        device=args.device)

    for i in range(args.requests):
        ctx = args.contexts[i % len(args.contexts)]
        prompt, _ = continuation_task(corpus, batch=1, context_len=ctx,
                                      seed=100 + i)
        srv.submit(Request(request_id=f"req-{i}", prompt=prompt[0],
                           max_new_tokens=args.max_new))

    outs = srv.run()
    unit = (f"{srv.stats['waves']:.0f} waves" if args.scheduler == "wave"
            else f"{srv.stats['steps']:.0f} step calls")
    print(f"\nserved {len(outs)} requests ({args.scheduler}) in {unit}, "
          f"throughput {srv.throughput_tok_s():.1f} tok/s")
    for o in outs:
        where = (f"wave={o.wave_id}" if args.scheduler == "wave"
                 else f"slot={o.slot}")
        print(f"  {o.request_id}: ctx={o.prompt_len} "
              f"new={len(o.tokens)} {where} "
              f"latency={o.latency_s:.1f}s tau={o.mean_accept:.2f} "
              f"tok/step={o.tokens_per_step:.2f} [{o.finish_reason}]")
    for (bucket, paged), eng in srv._engines.items():
        tm = eng.traffic
        if tm.bytes_by_mode:
            tag = f"batch={bucket}" + (", paged" if paged else "")
            print(f"  cache traffic ({tag}): "
                  f"{ {k: f'{v/2**20:.1f}MiB' for k, v in tm.bytes_by_mode.items()} }")
    return outs


if __name__ == "__main__":
    main()
