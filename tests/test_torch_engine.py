"""The PyTorch port's SpecPV engine against the JAX engine, end to end on
the CPU: same weights (converted with ``repro_torch.convert``), batch 2,
a 160-token prompt, 24 new tokens, ``tiny-dense`` in fp32 with the
conftest ``small_spec`` and ``small_dcfg``.

* The port's paged zero-copy ``generate`` (kernel route, plain versions
  on the CPU) gives the JAX engine's greedy tokens, mode counts and
  ``mean_accept`` (JAX: paged, zero-copy, ``use_pallas=True``).
* With full verification the port's ``generate`` equals the port's
  ``autoregressive_generate``, and both equal JAX's.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.configs as jcfgs
from repro.core import SpecPVEngine as JEngine
from repro.core.draft import init_draft_params as j_init_draft
from repro.core.reference import autoregressive_generate as j_ar
from repro.models import api as japi
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.core.reference import autoregressive_generate as t_ar
from repro_torch.kernels import ops as tops

PROMPT, NEW, MAX_LEN, CHUNK = 160, 24, 512, 64


@pytest.fixture(scope="module")
def setup(small_spec, small_dcfg):
    cfg = jcfgs.get_config("tiny-dense")
    tcfg = tcfgs.get_config("tiny-dense")
    spec = small_spec.replace(use_pallas=True)
    tspec = tcfgs.SpecPVConfig(**dataclasses.asdict(spec))
    tdcfg = tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg))
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    td = draft_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, dparams), device="cpu")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    return dict(cfg=cfg, tcfg=tcfg, spec=spec, tspec=tspec,
                dcfg=small_dcfg, tdcfg=tdcfg, params=params, dparams=dparams,
                tp=tp, td=td, prompt=prompt)


def test_zero_copy_generate_matches_jax_engine(setup):
    s = setup
    je = JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                 batch=2, max_len=MAX_LEN, paged=True, zero_copy=True)
    jtoks, jstats = je.generate(s["prompt"], NEW, prefill_chunk=CHUNK)
    te = TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                 batch=2, max_len=MAX_LEN, paged=True, zero_copy=True,
                 device="cpu")
    tops.reset_launch_counts()
    ttoks, tstats = te.generate(s["prompt"], NEW, prefill_chunk=CHUNK)
    assert all(v == 0 for v in tops.LAUNCHES.values())   # CPU: plain versions
    np.testing.assert_array_equal(ttoks, jtoks)
    assert tstats["modes"] == jstats["modes"]
    assert {"refresh", "partial"} <= set(tstats["modes"])
    assert tstats["steps"] == jstats["steps"]
    assert tstats["mean_accept"] == pytest.approx(jstats["mean_accept"])
    assert te.dispatches == tstats["steps"]
    # every refresh re-pinned exactly the pages its routed view reads
    al = te._page_alloc
    for row in range(2):
        assert len(al.pins_of(row)) > 0
    assert al.pinned_pages == sum(len(al.pins_of(r)) for r in range(2))
    # traffic billing matches the reference's per-mode accounting
    assert te.traffic.bytes_by_mode == je.traffic.bytes_by_mode


def test_full_verification_is_lossless(setup):
    s = setup
    te = TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                 batch=2, max_len=MAX_LEN, paged=True, zero_copy=True,
                 partial_verification=False, device="cpu")
    ttoks, tstats = te.generate(s["prompt"], NEW, prefill_chunk=CHUNK)
    assert tstats["modes"] == {"full": tstats["steps"]}
    tar = t_ar(s["tcfg"], s["tp"], s["prompt"], NEW, max_len=MAX_LEN,
               prefill_chunk=CHUNK, spec=s["tspec"], device="cpu")
    jar = j_ar(s["cfg"], s["params"], s["prompt"], NEW, max_len=MAX_LEN,
               prefill_chunk=CHUNK, spec=s["spec"])
    np.testing.assert_array_equal(ttoks, tar)
    np.testing.assert_array_equal(tar, np.asarray(jar))


def test_mixed_mode_fused_tick_matches_jax(setup):
    """One fused tick with a Partial row and a Full row (the
    ``decode_fused`` trunk mode and the masked commit epilogues) after a
    Refresh, against the JAX engine's fused step on the same state."""
    from repro.core.engine import MODE_FULL, MODE_PARTIAL
    s = setup
    je = JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                 batch=2, max_len=MAX_LEN, paged=True, zero_copy=True)
    te = TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                 batch=2, max_len=MAX_LEN, paged=True, zero_copy=True,
                 device="cpu")
    rows = np.ones((2,), bool)
    mixed = np.asarray([MODE_PARTIAL, MODE_FULL], np.int8)
    jst = je.prefill(s["prompt"], chunk=CHUNK)
    tst = te.prefill(s["prompt"], chunk=CHUNK)
    jst, jo = je.step(jst, "refresh")
    tst, to = te.step(tst, "refresh")
    np.testing.assert_array_equal(to.tokens, jo.tokens)
    for _ in range(2):
        jst, jo = je.step_fused(jst, rows, mixed)
        tst, to = te.step_fused(tst, rows, mixed)
        assert to.mode == jo.mode == "fused"
        np.testing.assert_array_equal(to.counts, jo.counts)
        for i in range(2):
            np.testing.assert_array_equal(to.tokens[i, :to.counts[i]],
                                          jo.tokens[i, :jo.counts[i]])
    np.testing.assert_array_equal(tst.pending_len.numpy(),
                                  np.asarray(jst.pending_len))
    np.testing.assert_array_equal(tst.buf_len.numpy(),
                                  np.asarray(jst.buf_len))
    np.testing.assert_array_equal(tst.cache["length"].numpy(),
                                  np.asarray(jst.cache["length"]))


def test_unsupported_settings_raise(setup):
    s = setup
    kw = dict(batch=2, max_len=MAX_LEN, device="cpu")
    args = (s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"])
    for bad in (dict(paged=False), dict(paged=True, zero_copy=False),
                dict(paged=True, zero_copy=True, temperature=0.7),
                dict(paged=True, zero_copy=True, tiered=True),
                dict(paged=True, zero_copy=True, prefix_cache=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TEngine(*args, **bad, **kw)


def test_defaults_are_the_supported_engine(setup):
    s = setup
    te = TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                 batch=2, max_len=MAX_LEN, device="cpu")
    assert te.zero_copy and te.partial_enabled
