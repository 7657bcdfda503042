"""The compiled step of the PyTorch port, on the CPU (no card, no
capture): the same bodies that the card captures as CUDA graphs run
here eagerly on the engine's static state.

* Each in-place step body leaves the engine's static buffers equal, field
  by field, to the next state that the functional ``_step_fused`` /
  ``_step_state`` computes from a copy of the same state, with the same
  tokens, counts and accept lengths; and its tokens equal the JAX
  engine's step for step in fp32 (``tiny-dense`` Full -> Refresh ->
  Partial and a mixed tick; reduced ``rwkv6-3b`` chain steps).
* A second ``prefill`` resets the static state in place: the same tensor
  addresses and the same tokens and state as a fresh engine.
* The hoisted device constants equal the numpy arrays they replace.
* A replay adds its capture's recorded launch counts; the merge counters
  never move once reserved.
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
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core import draft as tdr
from repro_torch.core import tree as ttr
from repro_torch.core.engine import (MODE_FULL, MODE_IDS, MODE_PARTIAL,
                                     CapturedGraph, EngineState)
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.kernels import ops as tops
from repro_torch.models import common as tcm

B, MAX_LEN, CHUNK = 2, 512, 64


def _specs(small_spec, small_dcfg, **kw):
    spec = small_spec.replace(**kw)
    return (spec, tcfgs.SpecPVConfig(**dataclasses.asdict(spec)),
            tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg)))


@pytest.fixture(scope="module")
def dense(small_spec, small_dcfg):
    cfg = jcfgs.get_config("tiny-dense")
    tcfg = tcfgs.get_config("tiny-dense")
    spec, tspec, tdcfg = _specs(small_spec, small_dcfg, use_pallas=True)
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    td = draft_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, dparams), device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, spec=spec, tspec=tspec, dcfg=small_dcfg,
                tdcfg=tdcfg, params=params, dparams=dparams, tp=tp, td=td)


@pytest.fixture(scope="module")
def rwkv(small_spec, small_dcfg):
    """Reduced rwkv6-3b in fp32 with random u, lora_B and wd_B (zero in
    the reference's init), as in tests/test_torch_rwkv.py."""
    def fp32(c):
        return c.reduced().replace(dtype="float32", param_dtype="float32")
    cfg = fp32(jcfgs.get_config("rwkv6-3b"))
    tcfg = fp32(tcfgs.get_config("rwkv6-3b"))
    spec, tspec, tdcfg = _specs(small_spec, small_dcfg)
    np_params = jax.tree_util.tree_map(
        np.asarray, japi.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    lay = np_params["layers"]
    for name, scale in (("u", 0.5), ("lora_B", 0.1), ("wd_B", 0.1)):
        lay[name] = (rng.normal(size=lay[name].shape) * scale).astype(
            np.float32)
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    return dict(cfg=cfg, tcfg=tcfg, spec=spec, tspec=tspec, dcfg=small_dcfg,
                tdcfg=tdcfg,
                params=jax.tree_util.tree_map(jnp.asarray, np_params),
                dparams=dparams, tp=params_from_numpy(tcfg, np_params,
                                                      device="cpu"),
                td=draft_params_from_numpy(
                    tcfg, jax.tree_util.tree_map(np.asarray, dparams),
                    device="cpu"))


def _engines(s, **kw):
    je = JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                 batch=B, max_len=MAX_LEN, **kw)
    te = TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                 batch=B, max_len=MAX_LEN, device="cpu", **kw)
    return je, te


def _clone(st: EngineState) -> EngineState:
    def c(v):
        return {k: t.clone() for k, t in v.items()} if isinstance(v, dict) \
            else v.clone()
    return EngineState(**{f.name: c(getattr(st, f.name))
                          for f in dataclasses.fields(EngineState)})


def _assert_state_equal(got: EngineState, want: EngineState):
    for f in dataclasses.fields(EngineState):
        g, w = getattr(got, f.name), getattr(want, f.name)
        pairs = ([(f"{f.name}[{k}]", g[k], w[k]) for k in w]
                 if isinstance(w, dict) else [(f.name, g, w)])
        assert isinstance(g, dict) == isinstance(w, dict)
        for name, a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), f"{name} differs"


def _check_step(te, so, want):
    """The public step's outputs equal the functional body's."""
    nxt, (toks, counts, acc) = want
    _assert_state_equal(te.state, nxt)
    np.testing.assert_array_equal(so.tokens, toks.numpy())
    np.testing.assert_array_equal(so.counts, counts.numpy())
    np.testing.assert_array_equal(so.accept_len, acc.numpy())


def _same_tokens(to, jo):
    np.testing.assert_array_equal(to.counts, np.asarray(jo.counts))
    for i in range(B):
        np.testing.assert_array_equal(to.tokens[i, :to.counts[i]],
                                      np.asarray(jo.tokens)[i, :to.counts[i]])


def test_inplace_steps_match_functional_dense(dense):
    """Full -> Refresh -> Partial x2 -> mixed (Partial + Full rows) ->
    Full on tiny-dense, the paged zero-copy engine: every step variant's
    in-place body against the functional step on a copy of the state,
    and against the JAX engine's tokens."""
    je, te = _engines(dense, paged=True, zero_copy=True)
    prompt = np.random.default_rng(0).integers(
        0, dense["cfg"].vocab_size, (B, 100)).astype(np.int32)
    jst = je.prefill(prompt, chunk=CHUNK)
    st = te.prefill(prompt, chunk=CHUNK)
    assert st is te.state
    mixed = np.asarray([MODE_PARTIAL, MODE_FULL], np.int8)
    for mode in ("full", "refresh", "partial", "partial", mixed, "full"):
        modes = (mixed if isinstance(mode, np.ndarray)
                 else np.full((B,), MODE_IDS[mode], np.int8))
        has_refresh = bool(np.any(modes == MODE_IDS["refresh"]))
        want = te._step_fused(
            _clone(st), torch.from_numpy(modes),
            has_full=has_refresh or bool(np.any(modes == MODE_FULL)),
            has_partial=bool(np.any(modes == MODE_PARTIAL)),
            has_refresh=has_refresh)
        if isinstance(mode, np.ndarray):
            st2, so = te.step_fused(st, np.ones((B,), bool), mode)
            jst, jo = je.step_fused(jst, np.ones((B,), bool), mode)
        else:
            st2, so = te.step(st, mode)
            jst, jo = je.step(jst, mode)
        assert st2 is st
        _check_step(te, so, want)
        _same_tokens(so, jo)
    for name in ("pending_len", "seq_len", "buf_len", "ext_len"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)))
    np.testing.assert_array_equal(st.cache["length"].numpy(),
                                  np.asarray(jst.cache["length"]))


def test_inplace_chain_steps_match_functional_rwkv(rwkv):
    """Chain steps of reduced rwkv6-3b (``paged=False``): the in-place
    state body against the functional ``_step_state``, and the JAX
    engine's tokens."""
    je, te = _engines(rwkv, paged=False)
    prompt = np.random.default_rng(8).integers(
        0, rwkv["cfg"].vocab_size, (B, 24)).astype(np.int32)
    jst = je.prefill(prompt)
    st = te.prefill(prompt)
    for _ in range(4):
        want = te._step_state(_clone(st))
        _, so = te.step(st, "state")
        jst, jo = je.step(jst, "state")
        _check_step(te, so, want)
        _same_tokens(so, jo)
    np.testing.assert_array_equal(st.cache["length"].numpy(),
                                  np.asarray(jst.cache["length"]))


def test_second_prefill_resets_in_place(dense):
    """Two generates on one engine: the static tensors keep their
    addresses, and the second equals a fresh engine's (tokens, stats and
    every state field)."""
    _, te = _engines(dense, paged=True, zero_copy=True)
    _, fresh = _engines(dense, paged=True, zero_copy=True)
    rng = np.random.default_rng(3)
    p1, p2 = (rng.integers(0, dense["cfg"].vocab_size, (B, 160)).astype(
        np.int32) for _ in range(2))
    te.generate(p1, 16, prefill_chunk=CHUNK)
    ptrs = [t.data_ptr() for t in te._static_tensors()]
    toks, stats = te.generate(p2, 16, prefill_chunk=CHUNK)
    assert [t.data_ptr() for t in te._static_tensors()] == ptrs
    want, wstats = fresh.generate(p2, 16, prefill_chunk=CHUNK)
    np.testing.assert_array_equal(toks, want)
    assert {"refresh", "partial"} <= set(stats["modes"])
    assert {k: stats[k] for k in ("modes", "steps", "mean_accept")} == \
        {k: wstats[k] for k in ("modes", "steps", "mean_accept")}
    _assert_state_equal(te.state, fresh.state)
    for row in range(B):
        assert te._page_alloc.pins_of(row) == fresh._page_alloc.pins_of(row)


def test_hoisted_constants_equal_numpy():
    for branch in ((4, 2, 2, 1, 1), (2, 2, 1), (1,) * 5):
        tree = ttr.TreeSpec.from_branch(branch)
        got = ttr.tree_tensors(tree, torch.device("cpu"))
        assert ttr.tree_tensors(tree, torch.device("cpu")) is got
        for t, a in ((got.parents, tree.parents_arr()),
                     (got.depths, tree.depths_arr()),
                     (got.anc, tree.ancestor_mask())):
            assert t.dtype == torch.from_numpy(a).dtype
            np.testing.assert_array_equal(t.numpy(), a)
    for name in ("tiny-dense", "llama3.1-8b", "rwkv6-3b"):
        cfg = tcfgs.get_config(name)
        for c in (cfg, tdr.draft_model_config(cfg),
                  cfg.replace(yarn_factor=4.0)):
            got = tcm.rope_inv_freq_tensor(c, torch.device("cpu"))
            want = tcm.rope_inv_freq(c)
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy(), want)     # bit for bit
            assert tcm.rope_inv_freq_tensor(c, torch.device("cpu")) is got


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_adds_recorded_launch_counts():
    saved = tops.launch_counts()
    try:
        tops.reset_launch_counts()
        tops.LAUNCHES["block_summary"] = 5
        before = tops.launch_counts()
        # what one captured rwkv step body's wrappers count
        tops.LAUNCHES["wkv"] += 64
        tops.WKV_SHAPES[(6, False)] = 32
        tops.WKV_SHAPES[(6, True)] = 32
        delta = tops.launch_count_delta(before, tops.launch_counts())
        assert delta == ({"wkv": 64}, {(6, False): 32, (6, True): 32})
        tops.set_launch_counts(before)
        assert tops.launch_counts() == before
        fake = _FakeGraph()
        g = CapturedGraph(fake, *delta)
        for _ in range(3):
            g.replay()
        assert fake.replays == 3
        assert tops.LAUNCHES == {**before[0], "wkv": 192}
        assert tops.WKV_SHAPES == {(6, False): 96, (6, True): 96}
    finally:
        tops.set_launch_counts(saved)


def test_split_counters_fixed_once_reserved():
    # llama3.1-8b at batch 1: a Refresh verify (T = 96 + 60 rows) takes
    # 8 heads x 10 row tiles, its K3 call over 66 blocks 8 x 3
    assert tops.split_counter_slots(1, 156, 32, 8, 66) == 80
    assert tops.split_counter_slots(1, 1, 32, 8, 1000) == 8 * 32
    dev = torch.device("cpu")       # the bookkeeping is the device's own
    try:
        c = tops.reserve_split_counters(80, dev)
        assert c.numel() >= 80 and not c.any()
        assert tops._split_counters(80, dev) is c
        assert tops.reserve_split_counters(c.numel(), dev) is c
        with pytest.raises(RuntimeError, match="reserve"):
            tops._split_counters(c.numel() + 1, dev)
        with pytest.raises(RuntimeError, match="reserve"):
            tops.reserve_split_counters(c.numel() + 1, dev)
    finally:
        tops._COUNTERS.pop(dev, None)
        tops._RESERVED.discard(dev)


def test_graph_mode_selection(dense):
    """The CPU route is eager and cannot capture; an engine steps only
    its own state."""
    _, te = _engines(dense, paged=True, zero_copy=True)
    assert te.cuda_graphs is False
    with pytest.raises(ValueError, match="CPU"):
        TEngine(dense["tcfg"], dense["tspec"], dense["tdcfg"], dense["tp"],
                dense["td"], batch=B, max_len=MAX_LEN, device="cpu",
                cuda_graphs=True)
    prompt = np.zeros((B, 20), np.int32)
    te.prefill(prompt)
    with pytest.raises(ValueError, match="own state"):
        te.step(_clone(te.state), "full")
