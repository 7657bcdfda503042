#!/usr/bin/env python3
"""Where the time of an MoE train step goes, unsharded and FSDP, on the
card.

    python3 tools/moe_train_profile.py [--layers N] [--top K]
        [--only unsharded|fsdp] [--src DIR]

Builds granite-moe-1b-a400m at full width (``--layers`` of its 24, bf16,
random weights from seed 0) and a batch of 2 x 768 tokens, the cell of
``chip_smoke.py`` phase 23 (c).  For the unsharded ``make_train_step``
and the FSDP step on a (2, 1) mesh of ``cuda:0``: one warm-up step, one
step timed with CUDA events, then one step under ``torch.profiler``
with ranges around the step's parts (the loss and its backward pass,
the sum over data shards, the cut into slices, AdamW).  ``--only`` runs
one of the two; ``--src`` imports ``repro_torch`` from another
checkout's ``src`` (an earlier commit unpacked beside this one, timed in
the same call; its unsharded step alone where it has no MoE FSDP step).
Prints the
card's name and power limit first; per step the wall ms, each part's
host ms, the device busy ms (kernels), and the ``--top`` device kernels
and host ops by their own time; one JSON line of the numbers last.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, SEQ = 2, 768
# the parts of the step, each a name that launch/steps.py calls
PARTS = (("loss + backward", "_loss_and_grads"),
         ("sum over shards", "all_reduce"),
         ("cut into slices", "shard_leaf"),
         ("adamw", "adamw_update"))


def _profile_step(torch, step, params, opt, tokens, top):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.launch import steps as st
    saved = []
    for label, fn in PARTS:
        orig = getattr(st, fn)

        def wrapped(*a, __orig=orig, __label=label, **kw):
            with record_function(__label):
                return __orig(*a, **kw)
        saved.append((fn, orig))
        setattr(st, fn, wrapped)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, _ = step(params, opt, tokens, None)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for fn, orig in saved:
            setattr(st, fn, orig)
    events = prof.key_averages()
    labels = {label for label, _ in PARTS}
    parts = {}
    for label, _ in PARTS:
        rows = [e for e in events if e.key == label
                and getattr(e, "device_type", None) == DeviceType.CPU]
        parts[label] = dict(host_ms=sum(e.cpu_time_total for e in rows)
                            / 1e3, calls=sum(e.count for e in rows))
    # the ranges also show on the device's timeline: kernels only here
    kernels = [e for e in events if e.key not in labels
               and getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0)
               for e in kernels) / 1e3
    by_dev = sorted(kernels, key=lambda e: -getattr(
        e, "self_device_time_total", 0))[:top]
    host = [e for e in events
            if getattr(e, "device_type", None) == DeviceType.CPU
            and e.key.startswith("aten::")]
    by_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:top]
    return params, opt, dict(
        wall_ms=wall, busy_ms=busy, parts=parts,
        launches=sum(e.count for e in kernels),
        top_device=[(e.key[:80], e.count, getattr(
            e, "self_device_time_total", 0) / 1e3) for e in by_dev],
        top_host=[(e.key, e.count, e.self_cpu_time_total / 1e3)
                  for e in by_host])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--only", choices=("unsharded", "fsdp"))
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("moe_train_profile.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                 # imports neither JAX nor repro
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.models import api
    from repro_torch.train.optimizer import adamw_init

    card = cs.card_line()
    print(card, flush=True)
    cfg = get_config("granite-moe-1b-a400m").replace(num_layers=args.layers)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (ROWS, SEQ + 1), generator=g,
                           device="cuda")
    mesh = sh.DeviceMesh((2, 1), devices=["cuda:0"] * 2)
    out = {"card": card, "layers": args.layers, "tokens": [ROWS, SEQ],
           "src": os.path.abspath(args.src)}
    labels = {None: ("unsharded", "fsdp (2, 1)"), "unsharded": (
        "unsharded",), "fsdp": ("fsdp (2, 1)",)}[args.only]
    for label in labels:
        params = api.init_params(cfg, seed=0, device="cuda")
        specs = (sh.param_specs(sh.ShardingRules(mesh, fsdp=True), params)
                 if label != "unsharded" else None)
        step = st.make_train_step(cfg, grad_shardings=specs)
        opt = adamw_init(params)
        params, opt, _ = step(params, opt, tokens, None)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        params, opt, _ = step(params, opt, tokens, None)
        e1.record()
        torch.cuda.synchronize()
        params, opt, res = _profile_step(torch, step, params, opt, tokens,
                                         args.top)
        res["event_ms"] = e0.elapsed_time(e1)
        out[label] = res
        print(f"{label}: step {res['event_ms']:.1f} ms (events), profiled "
              f"wall {res['wall_ms']:.1f} ms, device busy "
              f"{res['busy_ms']:.1f} ms in {res['launches']} launches",
              flush=True)
        for part, v in res["parts"].items():
            print(f"  {part}: host {v['host_ms']:.1f} ms, {v['calls']} "
                  f"calls")
        print("  top device kernels (name, launches, ms):")
        for row in res["top_device"]:
            print(f"    {row}")
        print("  top host ops by own time (name, calls, ms):")
        for row in res["top_host"]:
            print(f"    {row}")
        del params, opt, step
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
