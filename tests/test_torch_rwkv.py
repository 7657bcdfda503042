"""The PyTorch port's RWKV-6 path against the JAX package, on the CPU.

Model: the reduced ``rwkv6-3b`` (2 layers, d 256, 4 heads of 64) in fp32,
with the JAX init's weights.  That init leaves ``u``, ``lora_B`` and
``wd_B`` at zero; here they get random numpy values (the same for both
packages) so the bonus term and the data-dependent lerp and decay are
exercised.  Tolerance 1e-4 on hidden states, features and state.

* ``rwkv6.forward`` for a prefill chunk, a read-only chain verify and an
  advance with a padded ``valid`` prefix (the WKV recurrence runs the
  K5 wrapper, whose plain version stands in for the kernel here).
* ``params_from_numpy`` for the ``layers`` stack.
* ``SpecPVEngine(paged=False).generate`` with chain drafts at the sizes
  of ``tests/test_specpv.py::test_state_arch_chain_lossless``: its tokens
  equal the JAX engine's and the port's own autoregressive decoding.
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
from repro.models import rwkv6 as jrw
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.core.reference import autoregressive_generate as t_ar
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import rwkv6 as trw

TOL = 1e-4
B, PROMPT, NEW, MAX_LEN = 2, 24, 16, 256


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t.detach().float()),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _fp32(cfg):
    return cfg.reduced().replace(dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def rw(small_dcfg):
    cfg = _fp32(jcfgs.get_config("rwkv6-3b"))
    tcfg = _fp32(tcfgs.get_config("rwkv6-3b"))
    np_params = jax.tree_util.tree_map(
        np.asarray, japi.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    lay = np_params["layers"]
    for name, scale in (("u", 0.5), ("lora_B", 0.1), ("wd_B", 0.1)):
        lay[name] = (rng.normal(size=lay[name].shape) * scale).astype(
            np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, np_params, device="cpu")
    td = draft_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, dparams), device="cpu")
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return dict(cfg=cfg, tcfg=tcfg, np_params=np_params, params=params,
                dparams=dparams, tp=tp, td=td, prompt=prompt)


@pytest.fixture(scope="module")
def jax_run(rw, small_spec, small_dcfg):
    """One JAX engine generate, shared by the engine tests."""
    eng = JEngine(rw["cfg"], small_spec, small_dcfg, rw["params"],
                  rw["dparams"], batch=B, max_len=MAX_LEN)
    return eng.generate(rw["prompt"], NEW)


def test_rwkv_config_and_groupnorm_match():
    j, t = jcfgs.get_config("rwkv6-3b"), tcfgs.get_config("rwkv6-3b")
    assert t.layer_kinds() == j.layer_kinds() == ("rwkv",) * 32
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    from repro.models import common as jcm
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 4, 64)).astype(np.float32) * 3 + 1
    sc = rng.normal(size=(4, 64)).astype(np.float32)
    bi = rng.normal(size=(4, 64)).astype(np.float32)
    _close(tcm.groupnorm_heads(_t(x), _t(sc), _t(bi)),
           jcm.groupnorm_heads(x, sc, bi))


def test_params_from_numpy_ssm(rw):
    tp, npp, tcfg = rw["tp"], rw["np_params"], rw["tcfg"]
    assert len(tp["layers"]) == tcfg.num_layers
    for i, lp in enumerate(tp["layers"]):
        assert set(lp) == set(npp["layers"])
        for name, a in lp.items():
            np.testing.assert_array_equal(a.numpy(), npp["layers"][name][i])
    for name in ("embed", "final_norm", "head"):
        np.testing.assert_array_equal(tp[name].numpy(), npp[name])
    # the port's own init has the reference's layout, dtypes and zeros
    own = tapi.init_params(tcfg, seed=0, device="cpu")
    assert set(own) == set(tp)
    for lp, lq in zip(own["layers"], tp["layers"]):
        for name in lp:
            assert lp[name].shape == lq[name].shape
            assert lp[name].dtype == lq[name].dtype
    for name in ("u", "lora_B", "wd_B"):
        assert float(own["layers"][0][name].abs().max()) == 0.0


def _state_pair(cfg, tcfg, b):
    js = japi.init_cache(cfg, b, MAX_LEN)
    ts = tapi.init_cache(tcfg, b, MAX_LEN, device="cpu")
    return js, ts


def _check_state(ts, js):
    for name in ("wkv", "ts_tm", "ts_cm"):
        _close(ts[name], js[name])
    np.testing.assert_array_equal(ts["length"].numpy(),
                                  np.asarray(js["length"]))


def _check_out(got, want):
    hg, fg, _ = got
    hw, fw, _ = want
    _close(hg, hw)
    if fw is None:
        assert fg is None
    else:
        for g, w in zip(fg, fw):
            _close(g, w)


@pytest.mark.parametrize("phase", ["prefill", "verify", "advance"])
def test_rwkv_forward_matches(rw, phase):
    """Prefill a chunk, then (verify) a read-only 6-token chain pass or
    (advance) a 6-token commit with rows valid for 6, 2 and 0 tokens."""
    cfg, tcfg, params, tp = rw["cfg"], rw["tcfg"], rw["params"], rw["tp"]
    rng = np.random.default_rng(3)
    b = 3
    js, ts = _state_pair(cfg, tcfg, b)
    toks = rng.integers(0, cfg.vocab_size, (b, 20)).astype(np.int32)
    want = jrw.forward(cfg, params, jnp.asarray(toks), js)
    got = trw.forward(tcfg, tp, _t(toks).long(), ts)
    if phase == "prefill":
        _check_out(got, want)
        _check_state(got[2], want[2])
        return
    js, ts = want[2], got[2]
    chain = rng.integers(0, cfg.vocab_size, (b, 6)).astype(np.int32)
    if phase == "verify":
        before = {k: v.clone() for k, v in ts.items()}
        w2 = jrw.forward(cfg, params, jnp.asarray(chain), js, update=False)
        g2 = trw.forward(tcfg, tp, _t(chain).long(), ts, update=False)
        _check_out(g2, w2)
        for name, v in before.items():      # read-only: the state is unchanged
            assert torch.equal(g2[2][name], v)
        return
    valid = np.arange(6)[None] < np.asarray([6, 2, 0])[:, None]
    w2 = jrw.forward(cfg, params, jnp.asarray(chain), js,
                     valid=jnp.asarray(valid), collect_features=False)
    g2 = trw.forward(tcfg, tp, _t(chain).long(), ts, valid=_t(valid),
                     collect_features=False)
    _close(g2[0][:, :2], w2[0][:, :2])
    assert g2[1] is None
    _check_state(g2[2], w2[2])


def test_generate_matches_jax_engine(rw, jax_run, small_spec, small_dcfg):
    jtoks, jstats = jax_run
    tspec = tcfgs.SpecPVConfig(**dataclasses.asdict(small_spec))
    tdcfg = tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg))
    te = TEngine(rw["tcfg"], tspec, tdcfg, rw["tp"], rw["td"], batch=B,
                 max_len=MAX_LEN, paged=False, device="cpu")
    assert te.tree.branch == (1,) * small_dcfg.tree_depth
    assert not te.partial_enabled and not te.zero_copy
    tops.reset_launch_counts()
    ttoks, tstats = te.generate(rw["prompt"], NEW)
    assert all(v == 0 for v in tops.LAUNCHES.values())   # CPU: plain versions
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    assert tstats["modes"] == jstats["modes"] == {"state": tstats["steps"]}
    assert tstats["steps"] == jstats["steps"]
    assert tstats["mean_accept"] == pytest.approx(jstats["mean_accept"])
    assert te.dispatches == tstats["steps"]
    tar = t_ar(rw["tcfg"], rw["tp"], rw["prompt"], NEW, max_len=MAX_LEN,
               spec=tspec, device="cpu")
    np.testing.assert_array_equal(ttoks, tar)


def test_state_engine_settings(rw, small_spec, small_dcfg):
    tspec = tcfgs.SpecPVConfig(**dataclasses.asdict(small_spec))
    tdcfg = tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg))
    args = (rw["tcfg"], tspec, tdcfg, rw["tp"], rw["td"])
    kw = dict(batch=B, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        TEngine(*args, paged=True, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TEngine(*args, paged=False, temperature=0.5, **kw)
    eng = TEngine(*args, paged=False, **kw)
    assert eng.mode_for(1, 10_000, False) == "state"
    st = eng.prefill(rw["prompt"])
    with pytest.raises(ValueError):
        eng.step(st, "full")
    st, out = eng.step(st, "state")
    assert out.mode == "state" and (out.counts >= 1).all()
    np.testing.assert_array_equal(st.cache["length"].numpy(),
                                  PROMPT + out.counts)
