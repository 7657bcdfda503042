"""The port's RWKV-6 chain speculation on the trained reduced ``rwkv6-3b``
pair, against the JAX engine, on the CPU: acceptance parity.

The target and the draft are the reference's trained checkpoints
(``repro.artifacts.get_trained_pair("rwkv6-3b")``, the reduced config:
2 layers, d 256), trained in-process on the CPU into a temporary
directory on every run (about 2 minutes): the reference's ``.npz``
checkpoints do not load back bf16 weights ("No cast function
available"), so a cached pair cannot be reused.  Both packages run them
in fp32 (the checkpoints' bf16 values widened alike), batch 2, a
24-token prompt, 32 new tokens, chain drafts of the conftest
``small_spec`` with the draft depth the pair was trained with.  The
port's tokens equal the JAX engine's and the port's own autoregressive
decoding, with the same ``mean_accept``, which is above 1 (drafts are
accepted, so advances of more than one valid token run).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import artifacts
from repro.core import SpecPVEngine as JEngine
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.core.reference import autoregressive_generate as t_ar

B, PROMPT, NEW, MAX_LEN = 2, 24, 32, 256


def _fp32(cfg):
    return cfg.replace(dtype="float32", param_dtype="float32")


def test_trained_chain_speculation_matches_jax(small_spec, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(artifacts, "ART_DIR", str(tmp_path))
    cfg, dcfg, params, dparams = artifacts.get_trained_pair("rwkv6-3b")
    cfg = _fp32(cfg)
    tcfg = _fp32(tcfgs.get_config("rwkv6-3b").reduced())
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    np_p, np_d = (jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), t) for t in (params, dparams))
    jp, jd = (jax.tree_util.tree_map(jnp.asarray, t) for t in (np_p, np_d))
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jeng = JEngine(cfg, small_spec, dcfg, jp, jd, batch=B, max_len=MAX_LEN)
    jtoks, jstats = jeng.generate(prompt, NEW)
    tspec = tcfgs.SpecPVConfig(**dataclasses.asdict(small_spec))
    tdcfg = tcfgs.DraftConfig(**dataclasses.asdict(dcfg))
    tp = params_from_numpy(tcfg, np_p, device="cpu")
    td = draft_params_from_numpy(tcfg, np_d, device="cpu")
    teng = TEngine(tcfg, tspec, tdcfg, tp, td, batch=B, max_len=MAX_LEN,
                   paged=False, device="cpu")
    ttoks, tstats = teng.generate(prompt, NEW)
    tar = t_ar(tcfg, tp, prompt, NEW, max_len=MAX_LEN, spec=tspec,
               device="cpu")
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    np.testing.assert_array_equal(ttoks, tar)
    assert tstats["modes"] == jstats["modes"] == {"state": tstats["steps"]}
    assert tstats["mean_accept"] == pytest.approx(jstats["mean_accept"])
    assert tstats["mean_accept"] > 1.0
