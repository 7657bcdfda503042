"""Build and load the port's CUDA kernels.

All sources under ``repro_torch/csrc/`` are compiled in ONE ``nvcc`` call
for ``sm_90a`` into one shared library with a plain C interface, loaded
with ``ctypes``.  The build happens at first use (never at import), into
``build/`` beside ``src/`` (or ``$REPRO_TORCH_BUILD_DIR``), keyed by a
hash of the sources so an edited kernel rebuilds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build"


def sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card")


def build() -> Path:
    """Compile the kernels if the current sources have no library yet.
    Returns the library path; ``BUILD_INFO`` records the seconds taken
    and the compiler's ``-Xptxas -v`` report."""
    srcs = sources()
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = build_dir() / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True)
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)       # atomic: concurrent builders never see half
    BUILD_INFO.update(path=str(out), seconds=secs, cached=False,
                      ptxas=res.stderr)
    return out


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with the C
    signatures declared (pointers and the stream as ``c_void_p``)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.block_attention_launch.argtypes = [P, P, P, P, P, P, P, P, P,
                                           I, I, I, I, I, I, I, I, I, F, P]
    lib.block_attention_launch.restype = I
    lib.retrieval_score_launch.argtypes = [P, P, P, P, P,
                                           I, I, I, I, I, I, I, P]
    lib.retrieval_score_launch.restype = I
    lib.block_summary_launch.argtypes = [P, P, P, P, P, P,
                                         I, I, I, I, I, I, P]
    lib.block_summary_launch.restype = I
    lib.wkv_launch.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P]
    lib.wkv_launch.restype = I
    _LIB = lib
    return lib
