"""Rank bodies of the context-parallel tests (``tests/test_torch_cp.py``),
in a module of their own that imports only torch, numpy and
``repro_torch``: the ranks are spawned processes, which import it by
name, and so never import JAX.  Not collected by pytest (no ``test_``
prefix).

Every case's inputs come from a numpy seed, so each rank rebuilds the
same arrays and keeps its own contiguous sequence shard; the test holds
the ranks' outputs to the JAX package's per-shard bodies and to the
port's unsharded route on the same arrays.
"""
from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import SpecPVConfig
from repro_torch.distributed import (cp_full_verify_attention,
                                     cp_partial_verify_attention,
                                     local_selection)
from repro_torch.kernels import ref

BLOCK = 16
SPEC = SpecPVConfig(block_size=BLOCK)

# name -> (kind, dict of the case's sizes).  "short": a row whose length
# leaves most shards empty; "engineered": one standout block per quarter
# of the sequence, so each shard's local top-k is the global top-k at 2
# and at 4 shards ("exact": the shards' selections are the global top-k);
# "random": random keys, a length that leaves the last blocks empty.
CASES = {
    "full_short": ("full", dict(b=2, s=256, hk=2, h=4, dh=16, t=3,
                                length=(20, 256), seed=0)),
    "full_random": ("full", dict(b=1, s=512, hk=2, h=4, dh=16, t=2,
                                 length=(400,), seed=1)),
    "partial_short": ("partial", dict(b=2, s=256, hk=2, h=4, dh=16, t=3,
                                      length=(20, 256), seed=2, budget=4)),
    "partial_engineered": ("partial", dict(b=1, s=512, hk=2, h=4, dh=16,
                                           t=2, length=(512,), seed=3,
                                           budget=4, engineered=True,
                                           exact=True)),
    "partial_random": ("partial", dict(b=1, s=512, hk=2, h=4, dh=16, t=2,
                                       length=(400,), seed=3, budget=8)),
}


def make_case(name):
    """The case's full (unsharded) inputs as numpy arrays: q [B, T, H, Dh],
    k/v [B, S, Hk, Dh], length [B] int32 and, for partial cases, the
    block summaries kmax/kmin [B, S / BLOCK, Hk, Dh] of the keys (the
    plain K4 oracle)."""
    _, c = CASES[name]
    rng = np.random.default_rng(c["seed"])
    b, s, hk, h, dh, t = (c[x] for x in ("b", "s", "hk", "h", "dh", "t"))
    k = rng.standard_normal((b, s, hk, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, dh)).astype(np.float32)
    q = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    length = np.asarray(c["length"], np.int32)
    out = dict(q=q, k=k, v=v, length=length)
    if c.get("engineered"):
        nb = s // BLOCK
        k = k * 0.01
        for quarter in range(4):
            blk = quarter * (nb // 4) + 1
            k[:, blk * BLOCK:(blk + 1) * BLOCK] *= 300.0
        out["k"] = k
    if "budget" in c:
        kt = torch.as_tensor(out["k"])
        sums = [ref.block_summary_ref(kt[i], int(length[i]), BLOCK)
                for i in range(b)]
        out["kmax"] = torch.stack([x[0] for x in sums]).numpy()
        out["kmin"] = torch.stack([x[1] for x in sums]).numpy()
    return out


def shard(a, rank: int, n: int, axis: int = 1):
    """Rank ``rank``'s contiguous share of ``a`` along ``axis``."""
    step = a.shape[axis] // n
    return np.take(a, np.arange(rank * step, (rank + 1) * step), axis=axis)


def run(rank: int, n: int, init_file: str, out_dir: str) -> None:
    """One gloo rank on the CPU: every case through the CP functions on
    this rank's shard; saves {case: {"out", "sel"}} to ``rank<r>.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=60))
    try:
        res = {}
        for name, (kind, c) in CASES.items():
            a = make_case(name)
            q, length = torch.as_tensor(a["q"]), torch.as_tensor(a["length"])
            loc = {x: torch.as_tensor(shard(a[x], rank, n))
                   for x in ("k", "v", "kmax", "kmin") if x in a}
            if kind == "full":
                out = cp_full_verify_attention(q, loc["k"], loc["v"], length,
                                               BLOCK)
                res[name] = dict(out=out)
                continue
            out = cp_partial_verify_attention(SPEC, c["budget"], q, loc["k"],
                                              loc["v"], loc["kmax"],
                                              loc["kmin"], length)
            sel, _ = local_selection(SPEC, max(1, c["budget"] // n), q,
                                     loc["kmax"], loc["kmin"], length, rank)
            res[name] = dict(out=out, sel=sel)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(n: int, out_dir: str, timeout: float = 120.0):
    """Spawn ``n`` ranks of ``run`` over a file store in ``out_dir`` and
    wait for them (each at most ``timeout`` s, then every rank is
    killed); a rank that fails raises here.  Returns each rank's saved
    results."""
    ctx = mp.start_processes(run, args=(n, os.path.join(out_dir, "store"),
                                        out_dir),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(n)]
