#!/usr/bin/env python3
"""Where the WKV-scan kernel (K5) spends its time, on the card.

    python3 tools/wkv_breakdown.py            # needs one CUDA card

Builds ``src/repro_torch/csrc/wkv_scan.cu`` as it is and in variants with
one part of the work taken out, then times each at rwkv6-3b head shapes
(batch 1, H=40, dk=64, fp32) over T:

- ``full``: the kernel as shipped;
- ``nostage``: only the first tile is copied to shared memory; later
  tiles reuse what the buffers hold, so ``nostage`` is the time without
  waiting on loads;
- ``noflush``: y is never summed over row groups nor written;
- ``nostep``: each step stores one staged vector instead of computing,
  so ``nostep`` is the time of the loop around the steps;
- ``stages4``, ``stages2``: the full kernel with a staging ring of 4 or
  2 tiles instead of 3.

Only ``full`` computes the right function; the variants exist to be
timed.  Each time is the mean of 20 calls, CUDA events opened after a
spin that hides host time, the 50 MB L2 flushed before each call; the
per-step time is the slope between the two largest T.  Prints the
card's name and power limit first.  Builds into ``build/wkv_breakdown/``.
"""
import ctypes
import sys

import torch

from kernel_variants import build_variants, card_line, time_ms

H, DK = 40, 64
TS = (6, 256, 1024, 2048)
STEP = ("wkv_step<true>(cur, s, uu);", "wkv_step<false>(cur, s, uu);")
# variant -> (text to find, replacement) edits of the source
VARIANTS = {
    "full": [],
    "nostage": [("    stage(tile + kStages - 1);  // into the buffer the "
                 "tile before read\n", "")],
    "noflush": [("  auto flush = [&](int tile) {\n",
                 "  auto flush = [&](int tile) {\n    return;\n")],
    "nostep": [(call, "cur.r;") for call in STEP],
    "stages4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
}


def _declare(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.wkv_launch.argtypes = [P] * 9 + [I] * 5 + [P]


def make_case(gen, t):
    """The inputs chip_smoke.py builds for the same shapes."""
    r, k, v = (torch.randn((1, t, H, DK), generator=gen, device="cuda") * 0.5
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((1, t, H, DK), generator=gen,
                                         device="cuda") - 2.0))
    u = torch.randn((H, DK), generator=gen, device="cuda") * 0.5
    s0 = torch.randn((1, H, DK, DK), generator=gen, device="cuda")
    nv = torch.tensor([t], dtype=torch.int32, device="cuda")
    return r, k, v, w, u, s0, nv


def launcher(lib, case):
    r, k, v, w, u, s0, nv = case
    y = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.wkv_launch(*(a.data_ptr() for a in (r, k, v, w, u, s0, nv,
                                                      y, s_out)),
                             1, r.shape[1], H, DK, 1, stream)
        if err:
            raise RuntimeError(f"launch failed with code {err}")
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv_breakdown.py: no CUDA device", file=sys.stderr)
        return 2
    print(card_line())
    libs = build_variants("wkv_scan.cu", VARIANTS, "wkv_breakdown",
                          _declare)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    cases = {t: make_case(gen, t) for t in TS}
    print(f"{'variant':10s} " + " ".join(f"{'T=' + str(t):>9s}" for t in TS)
          + "   ns/step (ms per call)")
    for name, lib in libs.items():
        times = [time_ms(launcher(lib, cases[t]), flush) for t in TS]
        slope = (times[-1] - times[-2]) / (TS[-1] - TS[-2]) * 1e6
        print(f"{name:10s} " + " ".join(f"{ms:9.4f}" for ms in times)
              + f"   {slope:7.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
