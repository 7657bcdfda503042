"""Per-architecture smoke tests of the PyTorch port, the torch-only twin
of ``tests/test_smoke_archs.py`` (this file imports no JAX): every
assigned architecture the port runs, as its REDUCED variant (<= 2
layers, d_model <= 256, <= 4 experts), takes one train step on the CPU
(finite loss, non-zero finite gradient norm), then prefills and decodes
one token with finite logits of the right shapes.  The assigned ids the
port does not run raise NotImplementedError naming their ROADMAP item.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import (ASSIGNED_ARCHS, NOT_PORTED, SpecPVConfig,
                                 get_config)
from repro_torch.models import api
from repro_torch.train.trainer import grads_of, trainable, tree_leaves

RUN = [a for a in ASSIGNED_ARCHS if a not in NOT_PORTED]
SPEC = SpecPVConfig(block_size=16, num_sink_blocks=1,
                    retrieval_budget_blocks=4, local_window_blocks=2,
                    buffer_size=48)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_port_runs_seven_of_the_ten():
    assert len(ASSIGNED_ARCHS) == 10
    assert sorted(RUN) == sorted(
        ["granite-3-2b", "granite-moe-1b-a400m", "qwen2-0.5b", "rwkv6-3b",
         "qwen1.5-32b", "deepseek-7b", "dbrx-132b"])


@pytest.mark.parametrize("arch", RUN)
def test_reduced_train_step(arch):
    cfg = get_config(arch).reduced()
    assert cfg.num_layers <= 2 and cfg.d_model <= 256
    if cfg.num_experts:
        assert cfg.num_experts <= 4
    params = trainable(api.init_params(cfg, seed=0, device="cpu"))
    b, s = 2, 24
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)))
    loss, metrics = api.train_loss(cfg, params, toks)
    assert loss.shape == ()
    assert bool(torch.isfinite(loss)), f"{arch}: non-finite loss"
    assert bool(torch.isfinite(metrics["lm_loss"]))
    loss.backward()
    gn = sum(float(torch.sum(g.float() ** 2))
             for g in tree_leaves(grads_of(params)))
    assert np.isfinite(gn) and gn > 0, f"{arch}: bad grads"


@pytest.mark.parametrize("arch", RUN)
def test_reduced_prefill_decode(arch):
    cfg = get_config(arch).reduced()
    params = api.init_params(cfg, seed=0, device="cpu")
    b, s = 2, 20
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s + 2)))
    cache = api.init_cache(cfg, b, 128, SPEC, device="cpu")
    logits, feats, cache = api.prefill(cfg, params, toks[:, :s], cache,
                                       spec=SPEC)
    assert logits.shape == (b, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert feats.low.shape == (b, s, cfg.d_model)
    pos = cache["length"][:, None].long()
    out = api.decode(cfg, params, toks[:, s:s + 1], pos, cache, spec=SPEC)
    assert out.logits.shape == (b, 1, cfg.vocab_size)
    assert bool(torch.isfinite(out.logits).all()), f"{arch}: NaN logits"


@pytest.mark.parametrize("arch", sorted(NOT_PORTED))
def test_not_ported_ids_raise(arch):
    assert arch in ASSIGNED_ARCHS
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue 1, '{NOT_PORTED[arch]}'"):
        get_config(arch)
