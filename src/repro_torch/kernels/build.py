"""Build and load the port's CUDA kernels.

Each ``*.cu`` under ``repro_torch/csrc/`` is compiled for ``sm_90a`` by
its own ``nvcc`` process, all started together (headers under ``csrc/``
are found through ``-I``), and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use (never at import), into ``build/`` beside ``src/``
(or ``$REPRO_TORCH_BUILD_DIR``), keyed by a hash of every file under
``csrc/`` (headers too) so an edited kernel or header rebuilds.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build"


def sources():
    """The translation units: every ``*.cu`` under ``csrc/``."""
    return sorted(CSRC.glob("*.cu"))


def source_files():
    """Every file under ``csrc/`` (the build's hash covers them all)."""
    return sorted(p for p in CSRC.rglob("*") if p.is_file())


def find_nvcc() -> str:
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
    h = hashlib.sha256()
    for p in source_files():
        h.update(str(p.relative_to(CSRC)).encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = build_dir() / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True)
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs, procs = [], []
        for src in sources():        # one nvcc per source, all at once
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        reports = [(p, *p.communicate()) for p in procs]
        failed = [err for p, _, err in reports if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = os.path.join(tmpdir, out.name)
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(lib, out)   # atomic: concurrent builders never see half
    secs = time.perf_counter() - t0
    BUILD_INFO.update(path=str(out), seconds=secs, cached=False,
                      ptxas="".join(err for _, _, err in reports))
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
                                           P, P, P, P,
                                           I, I, I, I, I, I, I, I, I, I, F,
                                           P]
    lib.block_attention_launch.restype = I
    lib.retrieval_score_launch.argtypes = [P, P, P, P, P, P, P,
                                           I, I, I, I, I, I, I, I, I, P]
    lib.retrieval_score_launch.restype = I
    lib.block_summary_launch.argtypes = [P, P, P, P, P, P,
                                         I, I, I, I, I, I, P]
    lib.block_summary_launch.restype = I
    lib.block_summary_paged_launch.argtypes = [P, P, P, P, P, P,
                                               I, I, I, I, I, I, I, I, I, P]
    lib.block_summary_paged_launch.restype = I
    lib.wkv_launch.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P]
    lib.wkv_launch.restype = I
    _LIB = lib
    return lib
