"""Repeat an eager ``generate`` of the reduced ``granite-moe-1b-a400m``
on the CPU and count the processes in which two identical runs give
different tokens.

The case: the reduced granite (2 layers, d 256, 4 experts, top-2) in
bf16 with random weights from seed 0 (the draft from seed 1), the block-16
spec and the small draft tree of the CPU tests, a 400-token prompt, 24
new tokens, the paged zero-copy engine without graphs.  Each child
process builds one engine and runs ``generate`` twice on it; the parent
starts ``--runs`` children, ``--jobs`` at a time, each with its own
``PYTHONHASHSEED`` and ``--threads`` intra-op threads, within
``--timeout`` seconds in all.  Prints one JSON line: the processes
that finished, and for each one whose runs differ its hash seed and the
first differing token.

Run:  PYTHONPATH=src python tools/generate_repeat.py [--runs 24]
      [--threads 4] [--jobs 2] [--timeout 600]
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

PROMPT, NEW = 400, 24


def _engine():
    import numpy as np
    from repro_torch.configs import DraftConfig, SpecPVConfig, get_config
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.models.api import init_params
    cfg = get_config("granite-moe-1b-a400m").reduced().replace(
        dtype="bfloat16", param_dtype="bfloat16")
    spec = SpecPVConfig(block_size=16, num_sink_blocks=1,
                        retrieval_budget_blocks=4, local_window_blocks=2,
                        buffer_size=48, use_pallas=True)
    dcfg = DraftConfig(tree_depth=3, tree_branch=(2, 2, 1), ttt_steps=2)
    params = init_params(cfg, seed=0, device="cpu")
    dparams = init_draft_params(cfg, dcfg, seed=1, device="cpu")
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                       max_len=PROMPT + NEW + 160, paged=True,
                       zero_copy=True, device="cpu")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PROMPT)).astype(np.int64)
    return eng, prompt


def child(threads: int) -> dict:
    import numpy as np
    import torch
    torch.set_num_threads(threads)
    eng, prompt = _engine()
    a, sa = eng.generate(prompt, NEW)
    b, sb = eng.generate(prompt, NEW)
    out = dict(hashseed=os.environ.get("PYTHONHASHSEED"), equal=bool(
        np.array_equal(a, b)), steps=[sa["steps"], sb["steps"]])
    if not out["equal"]:
        out["first_token"] = int(np.argmax(a[0] != b[0]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=24)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.threads)))
        return 0
    t0 = time.perf_counter()
    pending = list(range(args.runs))
    running, results = [], []
    while pending or running:
        while pending and len(running) < args.jobs:
            i = pending.pop(0)
            env = dict(os.environ, PYTHONHASHSEED=str(i),
                       PYTHONPATH=os.path.join(ROOT, "src"))
            running.append(subprocess.Popen(
                [sys.executable, __file__, "--child", "--threads",
                 str(args.threads)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        time.sleep(0.2)
        for p in [p for p in running if p.poll() is not None]:
            running.remove(p)
            out, err = p.communicate()
            lines = out.strip().splitlines()
            results.append(json.loads(lines[-1]) if p.returncode == 0
                           and lines else dict(error=err[-400:]))
        if time.perf_counter() - t0 > args.timeout:
            for p in running:
                p.kill()
                p.communicate()
            break
    done = [r for r in results if "equal" in r]
    print(json.dumps(dict(
        processes=len(done), runs_per_process=2,
        threads=args.threads, differing=[r for r in done if not r["equal"]],
        errors=[r for r in results if "error" in r],
        not_started=len(pending), seconds=round(time.perf_counter() - t0,
                                                1))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
