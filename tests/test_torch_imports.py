"""The PyTorch port stands alone and runs on the card by default.

* In a subprocess where ``jax`` and the JAX package ``repro`` cannot be
  imported, every module of ``repro_torch`` imports, and ``chip_smoke.py``
  imports too; neither names ``jax`` or ``repro`` in an import statement.
* The entry-point twins (``examples/*_torch.py``,
  ``benchmarks/*_torch.py``) import only ``repro_torch``, torch, numpy
  and the standard library; ``examples/train_target_torch.py`` trains two steps
  on the CPU in a subprocess where ``jax`` and ``repro`` cannot be
  imported.
* The entry points raise when they are asked for CUDA (explicitly or by
  default) on a machine without a card, instead of running on the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, SYS_SRC)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
sys.path.insert(0, SYS_ROOT)
import chip_smoke
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "repro"
       or m.startswith("repro.")]
assert all(sys.modules[m] is None for m in bad), bad
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    code = _PROBE.replace("SYS_SRC", repr(str(SRC))).replace(
        "SYS_ROOT", repr(str(ROOT)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": "",
                              "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 15


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_import_statement_names_jax_or_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (f, mod)


TWINS = sorted((ROOT / "examples").glob("*_torch.py")) + sorted(
    (ROOT / "benchmarks").glob("*_torch.py"))


@pytest.mark.parametrize("path", TWINS, ids=lambda p: p.name)
def test_twins_import_only_the_port_numpy_and_the_standard_library(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert (top in ("repro_torch", "torch", "numpy")
                or top in sys.stdlib_module_names), (path.name, mod)


def test_twin_set_is_complete():
    names = {p.name for p in TWINS}
    assert {"quickstart_torch.py", "train_target_torch.py",
            "train_draft_torch.py", "serve_longcontext_torch.py",
            "bench_table1_speedup_torch.py"} <= names


_TRAIN_TWIN = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.argv = ["train_target_torch.py", "--arch", "tiny-dense", "--steps", "2",
            "--device", "cpu", "--ckpt", CKPT]
runpy.run_path(SCRIPT, run_name="__main__")
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "repro"
       or m.startswith("repro.")]
assert all(sys.modules[m] is None for m in bad), bad
"""


def test_train_target_twin_runs_on_the_cpu(tmp_path):
    ckpt = tmp_path / "tiny.npz"
    code = _TRAIN_TWIN.replace("CKPT", repr(str(ckpt))).replace(
        "SCRIPT", repr(str(ROOT / "examples" / "train_target_torch.py")))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path),
                         env={**os.environ, "PYTHONPATH": "",
                              "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert "final loss:" in res.stdout
    assert ckpt.exists()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    import numpy as np
    from repro_torch import resolve_device
    from repro_torch.configs import DraftConfig, SpecPVConfig, get_config
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.core.reference import autoregressive_generate
    from repro_torch.models.api import init_cache, init_params

    cfg = get_config("tiny-dense").replace(num_layers=1)
    spec = SpecPVConfig(block_size=16, use_pallas=True)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(dev)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(cfg, device=dev)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_draft_params(cfg, DraftConfig(), device=dev)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_cache(cfg, 1, 64, spec, device=dev)
    params = init_params(cfg, device="cpu")
    dparams = init_draft_params(cfg, DraftConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SpecPVEngine(cfg, spec, DraftConfig(), params, dparams, batch=1,
                     max_len=64, paged=True, zero_copy=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        autoregressive_generate(cfg, params, np.zeros((1, 4), np.int32), 2,
                                max_len=64)
    # the CPU, asked for explicitly, runs
    eng = SpecPVEngine(cfg, spec, DraftConfig(tree_depth=2,
                                              tree_branch=(2, 1)),
                       params, dparams, batch=1, max_len=64, paged=True,
                       zero_copy=True, device="cpu")
    toks, _ = eng.generate(np.arange(20, dtype=np.int32)[None], 4)
    assert toks.shape == (1, 4) and toks.min() >= 0
