"""How often ``torch.profiler`` keeps no record of a kernel a call did
launch, by the way the profiling session is run.

Each session profiles one wrapper call (K3, ``ops.retrieval_scores``, at
the shapes of ``tests/test_torch_cuda.py``'s edge cases, 10-30 us on an
H100) after one unprofiled call, and counts the CUDA kernel records it
kept.  Session kinds, run in turns so that neither meets the process
in a later state than the other:

* ``plain``: a fresh ``profile()`` around the call and a synchronize,
  its records read from ``key_averages()`` (how the ``cuda`` tests
  counted launches up to slice 19);
* ``events``: the same session, its records read from ``prof.events()``;
* ``settled``: ``profile(schedule=schedule(wait=0, warmup=1, active=1))``
  with one call per step, the records read by ``on_trace_ready`` after
  the active step (torch 2.11 returns the warm-up step's records too, so
  a complete session holds two).

For a session that kept no kernel record it also counts the host-side
launch calls (``cudaLaunchKernel`` and the like) the profiler saw: a
launch call without its kernel record is a record the profiler lost.
Prints one JSON line: per kind, the sessions run, those that kept no
record, more than one, and the first empty sessions with their launch
calls.

    python3 tools/profiler_records.py [--sessions 400]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def _counts(events):
    """(device kernel records, host launch calls) of a list of events."""
    from torch.autograd import DeviceType
    dev = sum(1 for e in events
              if getattr(e, "device_type", None) == DeviceType.CUDA)
    calls = sum(1 for e in events if e.name in LAUNCH_CALLS)
    return dev, calls


def session(torch, fn, kind: str):
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if kind == "settled":
        got = []
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: got.append(
                         _counts(p.events()))) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        return got[0]
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    if kind == "events":
        return _counts(prof.events())
    from torch.autograd import DeviceType
    dev = sum(e.count for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA)
    return dev, _counts(prof.events())[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=400)
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cases = []
    for nb, t in ((31, 15), (32, 16), (33, 17), (66, 156)):
        g = torch.Generator(device=dev)
        g.manual_seed(6 + nb + t)
        q = torch.randn((1, t, 32, 128), generator=g,
                        device=dev).to(torch.bfloat16)
        kmax = torch.randn((1, nb, 8, 128), generator=g, device=dev).abs()
        kmin = -torch.randn((1, nb, 8, 128), generator=g, device=dev).abs()
        qw = torch.ones((1, t), device=dev)
        cases.append(lambda q=q, a=kmax, b=kmin, w=qw:
                     ops.retrieval_scores(q, a, b, w))
    kinds = ("plain", "events", "settled")
    out = {k: dict(sessions=0, zero=0, more=0, first_zero=[]) for k in kinds}
    for i in range(args.sessions * len(kinds)):
        kind = kinds[i % len(kinds)]
        n, calls = session(torch, cases[(i // len(kinds)) % len(cases)],
                           kind)
        o = out[kind]
        o["sessions"] += 1
        if n == 0:
            o["zero"] += 1
            if len(o["first_zero"]) < 10:
                o["first_zero"].append(dict(session=i, launch_calls=calls))
        elif n > 1:
            o["more"] += 1
    print(json.dumps({"profiler_records": out,
                      "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
