#!/usr/bin/env python3
"""Where the bf16 block-attention kernel (K1/K2) spends its time, on the card.

    python3 tools/attention_breakdown.py            # needs one CUDA card

Builds ``src/repro_torch/csrc/block_attention.cu`` as it is and in
variants with one part of the work taken out, then times each at the
llama3.1-8b path's shapes (H=32, Hk=8, Dh=128, block 128; batch 1) and
over a range of split counts S:

- ``full``: the kernel as shipped;
- ``nomerge``: the split chunks are not merged (the counter is still
  reset), so ``full - nomerge`` is the merge's tail;
- ``nolo``: P V without the bf16 ``lo`` half of P;
- ``nopv``: no P V product at all;
- ``noload``: only the first tiles are copied; later tiles reuse what
  shared memory holds, so ``noload`` is the time without waiting on
  loads.

Only ``full`` computes the right function (it is checked against the
same call at S=1); the variants exist to be timed.  Each time is the
mean of 20 calls, CUDA events opened after a spin that hides host time,
the 50 MB L2 flushed before each call.  The kernel's C entry point is
called directly, so S can be set; the port's wrapper chooses S with
``repro_torch.kernels.ops.kv_splits``.  Prints the card's name and power
limit first.  Builds into ``build/attention_breakdown/``.
"""
import ctypes
import math
import sys

import torch

from kernel_variants import build_variants, card_line, time_ms

H, HK, DH, BS = 32, 8, 128, 128
LO_MMA = ("          mma_bf16(o[2 * dp - 2], pl, bp[0], bp[1]);\n",
          "          mma_bf16(o[2 * dp - 1], pl, bp[2], bp[3]);\n",
          "      mma_bf16(o[14], pl, bb[1][0], bb[1][1]);\n",
          "      mma_bf16(o[15], pl, bb[1][2], bb[1][3]);\n")
HI_MMA = ("        mma_bf16(o[2 * dp], ph, bc[0], bc[1]);\n",
          "        mma_bf16(o[2 * dp + 1], ph, bc[2], bc[3]);\n")
# variant -> (text to find, replacement) edits of the source
VARIANTS = {
    "full": [],
    "nomerge": [("  if (!s_last) return;",
                 "  if (s_last && tid == 0) a.counters[slot] = 0;\n"
                 "  return;")],
    "nolo": [(line, "") for line in LO_MMA],
    "nopv": [(line, "") for line in LO_MMA + HI_MMA],
    "noload": [("    issue();                          "
                "// in flight during this tile's math", "    cp_async_commit();")],
}


def _declare(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.block_attention_launch.argtypes = [P] * 13 + [I] * 10 + [F, P]


def make_case(gen, t, ctx, routed_ns=0, qoff=None):
    """The inputs chip_smoke.py builds for the same case."""
    dev = "cuda"
    nb = -(-ctx // BS)
    np_ = nb + 2
    q = torch.randn((1, t, H, DH), generator=gen, device=dev).bfloat16()
    pk = torch.randn((np_ * BS, HK, DH), generator=gen, device=dev).bfloat16()
    pv = torch.randn((np_ * BS, HK, DH), generator=gen, device=dev).bfloat16()
    table = torch.randperm(np_ - 1, generator=gen, device=dev)[:nb] + 1
    if routed_ns:
        sel = torch.stack([torch.randperm(nb - 1, generator=gen, device=dev)
                           [:routed_ns] for _ in range(HK)])[None]
        sel[..., -3:] = -1
        sel[..., routed_ns - 4] = nb - 1
        used = sel >= 0
        idx = torch.where(used, table[sel.clamp(min=0)], 0)
        vlen = torch.where(used, (ctx - sel * BS).clamp(0, BS), 0)
    else:
        vl = (ctx - torch.arange(nb, device=dev) * BS).clamp(0, BS)
        idx = torch.where(vl > 0, table, 0)[None, None].expand(1, HK, nb)
        vlen = vl[None, None].expand(1, HK, nb)
    qo = (None if qoff is None
          else torch.tensor([qoff], dtype=torch.int32, device=dev))
    return (q, pk, pv, idx.to(torch.int32).contiguous(),
            vlen.to(torch.int32).contiguous(), qo)


def launcher(lib, case, splits, counters):
    q, pk, pv, idx, vlen, qo = case
    b, t, h, dh = q.shape
    ntiles = -(-(h // HK) * t // 64)
    m = torch.empty((b, h, t), device="cuda")
    l = torch.empty_like(m)
    acc = torch.empty((b, h, t, dh), device="cuda")
    rows = b * HK * ntiles * splits * 64
    part_ml = torch.empty((2, rows), device="cuda")
    part_acc = torch.empty((rows, dh), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.block_attention_launch(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(), idx.data_ptr(),
            vlen.data_ptr(), None if qo is None else qo.data_ptr(),
            m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            part_ml[0].data_ptr(), part_ml[1].data_ptr(),
            part_acc.data_ptr(), counters.data_ptr(), b, t, h, HK, dh,
            pk.shape[0] // BS, BS, idx.shape[2], splits, 1,
            1.0 / math.sqrt(dh), stream)
        if err:
            raise RuntimeError(f"launch failed with code {err}")
    return call, (m, l, acc)


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_breakdown.py: no CUDA device", file=sys.stderr)
        return 2
    print(card_line())
    libs = build_variants("block_attention.cu", VARIANTS, "attention_breakdown",
                          _declare)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    counters = torch.zeros(4096, dtype=torch.int32, device="cuda")
    cases = [("K1 routed NS=35 T=61", make_case(gen, 61, 8229, routed_ns=35),
              [1, 2, 4, 8, 16]),
             ("K1 full T=61 ctx=8229", make_case(gen, 61, 8229), [1, 4, 8, 16]),
             ("K1 refresh T=156 ctx=8229", make_case(gen, 156, 8229),
              [1, 2, 3, 6]),
             ("K2 T=256 qoff=7936", make_case(gen, 256, 8192, qoff=7936), [1]),
             ("K2 T=256 qoff=0", make_case(gen, 256, 256, qoff=0), [1])]
    print(f"{'case':28s} {'S':>3s} " + " ".join(f"{v:>8s}" for v in VARIANTS)
          + "   (ms per call; full's max rel. diff to S=1)")
    for label, case, splits in cases:
        want = None
        for s in splits:
            times = []
            for name, lib in libs.items():
                call, out = launcher(lib, case, s, counters)
                times.append(time_ms(call, flush))
                if name == "full":
                    call()
                    torch.cuda.synchronize()
                    got = [x.clone() for x in out[1:]]
            want = want or got
            rel = max(((g - w).abs().max() / w.abs().max()).item()
                      for g, w in zip(got, want))
            print(f"{label:28s} {s:3d} "
                  + " ".join(f"{ms:8.4f}" for ms in times) + f"   {rel:.1e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
