"""What the kernel breakdown tools (``tools/*_breakdown.py``) share: build
one of the port's kernel sources in variants with a part of the work taken
out, and time one call on the card.

Each variant is compiled with the port's own compiler and flags
(``repro_torch.kernels.build``: ``find_nvcc``, ``NVCC_FLAGS``, ``-I`` the
``csrc/`` directory), one ``nvcc`` per variant, all started together, into
``<build dir>/<name>/``.
"""
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import build as kbuild  # noqa: E402


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def build_variants(source: str, variants: dict, name: str, declare):
    """Compile ``csrc/<source>`` once per entry of ``variants`` (variant ->
    list of (text to find, replacement) edits of the source) into a shared
    library each.  ``declare(lib)`` sets the C signatures.  Returns
    {variant: ctypes library}."""
    out = kbuild.build_dir() / name
    out.mkdir(parents=True, exist_ok=True)
    text0 = (kbuild.CSRC / source).read_text()
    nvcc = kbuild.find_nvcc()
    procs = {}
    for var, edits in variants.items():
        text = text0
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {var}: source line not found: "
                                   f"{old!r}")
            text = text.replace(old, new)
        cu = out / f"{var}.cu"
        cu.write_text(text)
        so = out / f"{var}.so"
        procs[var] = (so, subprocess.Popen(
            [nvcc, *kbuild.NVCC_FLAGS, f"-I{kbuild.CSRC}", "-shared",
             "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for var, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {var}:\n{err}")
        lib = ctypes.CDLL(str(so))
        declare(lib)
        libs[var] = lib
    return libs


def time_ms(call, flush, iters=20):
    """Mean device time of ``call`` in ms: CUDA events opened after a spin
    that hides host time, ``flush`` (a buffer larger than the 50 MB L2)
    zeroed before each call."""
    for _ in range(3):
        call()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        e0.record()
        call()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters
