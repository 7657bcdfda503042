"""Windowed dense and MoE stacks (``window_size`` > 0) in the PyTorch port,
on the CPU against the JAX package.

The reference windows its dense attention in the train and prefill modes
only (``src/repro/models/dense.py``: ``_self_attention``'s train and
prefill branches); its prefill takes the plain chunked attention, never
the paged prefill kernel, when a window is set; decode (Full, Refresh,
Partial) attends the whole context.  Here, for ``tiny-dense`` and the
reduced ``granite-moe-1b-a400m``, each with ``window_size=16`` set on both
sides by ``replace``, in fp32:

* ``train_loss`` and its gradients equal JAX's;
* chunked prefill logits, features and caches on the contiguous and the
  paged layout (the window shorter than the prompt and the chunk) equal
  JAX's;
* ``generate`` with partial verification gives the JAX engine's tokens on
  the reference's default layout and the paged zero-copy pool, and with
  full verification the port's autoregressive decoding;
* a windowed prefill calls no K2 (the causal form of
  ``ops.block_attention``), while the same stack without a window does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import SpecPVEngine as JEngine
from repro.core.draft import init_draft_params as j_init_draft
from repro.models import api as japi
from repro_torch import configs as tcfgs
from repro_torch.convert import (draft_params_from_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.core.reference import autoregressive_generate as t_ar
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.train.trainer import grads_of, trainable

WINDOW = 16
F32 = dict(dtype="float32", param_dtype="float32", window_size=WINDOW)
ARCHS = ("tiny-dense", "granite-moe-1b-a400m")
B, PROMPT, NEW, MAX_LEN, CHUNK = 2, 160, 16, 384, 64
LAYOUTS = {"default": dict(), "zero_copy": dict(paged=True, zero_copy=True)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(arch):
    j, t = jcfgs.get_config(arch), tcfgs.get_config(arch)
    if arch != "tiny-dense":
        j, t = j.reduced(), t.reduced()
    return j.replace(**F32), t.replace(**F32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request, small_spec, small_dcfg):
    cfg, tcfg = _configs(request.param)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    spec = small_spec.replace(use_pallas=True)
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    return dict(
        cfg=cfg, tcfg=tcfg, spec=spec, dcfg=small_dcfg,
        tspec=tcfgs.SpecPVConfig(**dataclasses.asdict(spec)),
        tdcfg=tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg)),
        params=params, dparams=dparams,
        tp=params_from_numpy(tcfg, _np(params), device="cpu"),
        td=draft_params_from_numpy(tcfg, _np(dparams), device="cpu"),
        prompt=np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, PROMPT)).astype(np.int32))


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def test_train_loss_and_grads_match_jax(model):
    """Batch 2 x 63 positions, the window 16: the loss within 1e-5
    relative, each gradient leaf within 1e-4 of its largest magnitude."""
    cfg, tcfg = model["cfg"], model["tcfg"]
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    (jl, _), jg = jax.value_and_grad(
        lambda p: japi.train_loss(cfg, p, jnp.asarray(toks)),
        has_aux=True)(model["params"])
    tp = trainable(params_from_numpy(tcfg, _np(model["params"]),
                                     device="cpu"))
    tl, _ = tapi.train_loss(tcfg, tp, torch.as_tensor(toks))
    tl.backward()
    assert abs(float(tl.detach()) / float(jl) - 1) < 1e-5
    errs = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - b).max() / np.abs(b).max()),
        params_to_numpy(tcfg, grads_of(tp)), _np(jg))
    assert max(jax.tree_util.tree_leaves(errs)) < 1e-4
    # the window changes the loss: it is no unwindowed run in disguise
    full, _ = tapi.train_loss(tcfg.replace(window_size=0),
                              params_from_numpy(tcfg, _np(model["params"]),
                                                device="cpu"),
                              torch.as_tensor(toks))
    assert abs(float(full) - float(tl.detach())) > 1e-4


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_chunked_prefill_matches_jax(model, paged):
    """A 70-token prompt in chunks of 32 (the last short): each chunk's
    logits and features, then the cache's K/V, summaries and length."""
    cfg, tcfg, spec, tspec = (model[k] for k in ("cfg", "tcfg", "spec",
                                                  "tspec"))
    b, max_len = 2, 160
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (b, 70)).astype(np.int32)
    if paged:
        nb = -(-max_len // spec.block_size)
        num_pages = b * nb + 1
        jc = japi.init_cache(cfg, b, max_len, spec, paged=True,
                             num_pages=num_pages)
        tc = tapi.init_cache(tcfg, b, max_len, tspec, paged=True,
                             num_pages=num_pages, device="cpu")
        pt = np.random.default_rng(3).permutation(
            np.arange(1, num_pages)).reshape(b, nb).astype(np.int32)
        jc["page_table"] = jnp.asarray(pt)
        tc["page_table"] = torch.as_tensor(pt)
    else:
        jc = japi.init_cache(cfg, b, max_len, spec)
        tc = tapi.init_cache(tcfg, b, max_len, tspec, device="cpu")
    for off in range(0, prompt.shape[1], 32):
        chunk = prompt[:, off:off + 32]
        jl, jf, jc = japi.prefill(cfg, model["params"], jnp.asarray(chunk),
                                  jc, spec=spec)
        tl, tf, tc = tapi.prefill(tcfg, model["tp"],
                                  torch.as_tensor(chunk).long(), tc,
                                  spec=tspec)
        _close(tl, jl)
        for g, w in zip(tf, jf):
            _close(g, w)
    for key in ("k", "v", "kmax", "kmin", "length"):
        _close(tc[key], jc[key])


@pytest.fixture(scope="module")
def jax_partial(model):
    m = model
    je = JEngine(m["cfg"], m["spec"], m["dcfg"], m["params"], m["dparams"],
                 batch=B, max_len=MAX_LEN, partial_verification=True)
    toks, stats = je.generate(m["prompt"], NEW, prefill_chunk=CHUNK)
    return np.asarray(toks), stats


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_generate_matches_jax_engine(model, jax_partial, layout):
    """Partial verification over a 160-token prompt (past the 112-token
    budget): tokens and mode counts equal the JAX engine's."""
    m = model
    jtoks, jstats = jax_partial
    te = TEngine(m["tcfg"], m["tspec"], m["tdcfg"], m["tp"], m["td"],
                 batch=B, max_len=MAX_LEN, device="cpu", **LAYOUTS[layout])
    toks, stats = te.generate(m["prompt"], NEW, prefill_chunk=CHUNK)
    np.testing.assert_array_equal(toks, jtoks)
    assert stats["modes"] == jstats["modes"]
    assert {"refresh", "partial"} <= set(stats["modes"])


def test_full_verification_equals_autoregressive(model):
    """Full verification reads the whole context, as the AR oracle's
    decode does after the same windowed prefill."""
    m = model
    te = TEngine(m["tcfg"], m["tspec"], m["tdcfg"], m["tp"], m["td"],
                 batch=B, max_len=MAX_LEN, partial_verification=False,
                 device="cpu", paged=True, zero_copy=True)
    toks, stats = te.generate(m["prompt"], NEW, prefill_chunk=CHUNK)
    assert stats["modes"] == {"full": stats["steps"]}
    ar = t_ar(m["tcfg"], m["tp"], m["prompt"], NEW, max_len=MAX_LEN,
              prefill_chunk=CHUNK, spec=m["tspec"], device="cpu")
    np.testing.assert_array_equal(toks, ar)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_windowed_prefill_calls_no_k2(model, paged, monkeypatch):
    """The causal (K2) form of the attention wrapper is not called by a
    windowed prefill on either layout; the unwindowed stack calls it once
    per layer and chunk, so the probe sees K2 where it runs."""
    m = model
    calls = []
    inner = ops.block_attention

    def probe(*a, q_offset=None, **kw):
        if q_offset is not None:
            calls.append(1)
        return inner(*a, q_offset=q_offset, **kw)

    monkeypatch.setattr(ops, "block_attention", probe)
    layout = LAYOUTS["zero_copy"] if paged else LAYOUTS["default"]
    for window, want in ((WINDOW, 0), (0, m["tcfg"].num_layers * 2)):
        tcfg = m["tcfg"].replace(window_size=window)
        eng = TEngine(tcfg, m["tspec"], m["tdcfg"], m["tp"], m["td"],
                      batch=1, max_len=MAX_LEN, device="cpu", **layout)
        calls.clear()
        eng.prefill(m["prompt"][:1, :96], chunk=CHUNK)
        assert len(calls) == want, (window, len(calls))
