"""Per-architecture smoke tests of the PyTorch port, the torch-only twin
of ``tests/test_smoke_archs.py`` (this file imports no JAX at module
level): every
assigned architecture the port runs, as its REDUCED variant (<= 2
layers, d_model <= 256, <= 4 experts), takes one train step on the CPU
(finite loss, non-zero finite gradient norm), then prefills and decodes
one token with finite logits of the right shapes (the VLM and audio
ids with their stub ``extra`` from ``api.extra_inputs_for``).  A dense
or MoE stack with a local attention window, the last refusal once, is
admitted: it builds, and its chunked prefill logits equal the JAX
package's, which that test imports inside itself.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import (ASSIGNED_ARCHS, NOT_PORTED, SpecPVConfig,
                                 get_config)
from repro_torch.models import api
from repro_torch.models import dense as dn
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


def test_the_port_runs_eight_of_the_ten():
    """Eight of the ten ran before the VLM and audio slice; since it, all
    ten do and ``NOT_PORTED`` is empty."""
    assert len(ASSIGNED_ARCHS) == 10
    assert NOT_PORTED == {}
    assert sorted(RUN) == sorted(
        ["granite-3-2b", "granite-moe-1b-a400m", "qwen2-0.5b", "rwkv6-3b",
         "llama-3.2-vision-90b", "whisper-small", "qwen1.5-32b",
         "recurrentgemma-2b", "deepseek-7b", "dbrx-132b"])


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
    extra = api.extra_inputs_for(cfg, b, seed=3, device="cpu")
    loss, metrics = api.train_loss(cfg, params, toks, extra=extra)
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
    extra = api.extra_inputs_for(cfg, b, seed=3, device="cpu")
    logits, feats, cache = api.prefill(cfg, params, toks[:, :s], cache,
                                       spec=SPEC, extra=extra)
    assert logits.shape == (b, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert feats.low.shape == (b, s, cfg.d_model)
    pos = cache["length"][:, None].long()
    out = api.decode(cfg, params, toks[:, s:s + 1], pos, cache, spec=SPEC)
    assert out.logits.shape == (b, 1, cfg.vocab_size)
    assert bool(torch.isfinite(out.logits).all()), f"{arch}: NaN logits"


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-1b-a400m"])
def test_not_ported_ids_raise(arch):
    """No assigned id is refused, and no stack either: a dense or MoE stack
    with a local attention window (refused until the windowed dense
    stacks) builds, and its prefill logits over a 160-token prompt in
    chunks of 64, the window 64, equal the JAX package's in fp32."""
    import jax
    import jax.numpy as jnp
    import repro.configs as jcfgs
    from repro.models import api as japi
    from repro_torch.convert import params_from_numpy
    assert arch in ASSIGNED_ARCHS and arch not in NOT_PORTED
    over = dict(window_size=64, dtype="float32", param_dtype="float32")
    cfg = get_config(arch).reduced().replace(**over)
    jcfg = jcfgs.get_config(arch).reduced().replace(**over)
    dn._check_dense(cfg)
    assert api.init_params(cfg, seed=0, device="cpu")["embed"].shape[0] \
        == cfg.vocab_size
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    jspec = jcfgs.SpecPVConfig(block_size=16, num_sink_blocks=1,
                               retrieval_budget_blocks=4,
                               local_window_blocks=2, buffer_size=48)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 160)).astype(np.int32)
    jc = japi.init_cache(jcfg, 2, 192, jspec)
    tc = api.init_cache(cfg, 2, 192, SPEC, device="cpu")
    for off in range(0, 160, 64):
        chunk = prompt[:, off:off + 64]
        jl, _, jc = japi.prefill(jcfg, jp, jnp.asarray(chunk), jc,
                                 spec=jspec)
        tl, _, tc = api.prefill(cfg, params, torch.as_tensor(chunk).long(),
                                tc, spec=SPEC)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
