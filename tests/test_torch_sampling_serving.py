"""Sampled and chain serving of the PyTorch port on the CPU (twins of
``tests/test_sampling_serving.py``): ``tiny-dense`` in fp32 with weights
converted from the JAX parameters, the conftest ``small_spec``
(``use_pallas=True``) and ``small_dcfg``, prefill chunk 64.

* Statistical losslessness: 256 requests of one 24-token prompt with
  seeds 0..255 at temperature 0.9, 4 new tokens, served at batch 8 (every
  tick verifies Full: prompt and budget stay inside the 112-token partial
  budget, so the output is the target's distribution exactly).  Each
  position's token frequencies match JAX's ``autoregressive_sample`` on
  the same weights, and the port's own, within the reference's
  two-sample bound (4 sigma of the pooled frequency plus 0.02).
* Greedy rows in a batch with sampled and chain peers give the tokens of
  an all-greedy run; a sampled request gives the same tokens alone, in a
  mixed batch and admitted in another order; a slot's stream does not
  depend on whether its neighbour samples; a fork replays its source's
  stream; a sampled request never boots from a greedy tail entry.
* Any mix of modes, temperatures and chain rows is one dispatch, keyed
  ``(has_full, has_partial, has_refresh, has_sampled, has_chain)``; the
  continuous scheduler wants a greedy engine (sampling is per request).
* Greedy ``draft="chain"`` requests, beside tree requests, give the JAX
  scheduler's tokens, and ``SpecPVEngine(draft_chain=True).generate``
  gives the JAX engine's.
* The sampled rwkv6 chain ``generate`` (128 rows, each its own stream)
  matches the port's ``autoregressive_sample`` by distribution.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import SpecPVEngine as JEngine
from repro.core.draft import init_draft_params as j_init_draft
from repro.core.reference import autoregressive_sample as j_ar_sample
from repro.models import api as japi
from repro.serving import Request as JRequest
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.draft import init_draft_params
from repro_torch.core.engine import (MODE_FULL, MODE_PARTIAL, MODE_REFRESH,
                                     SpecPVEngine as TEngine)
from repro_torch.core.reference import autoregressive_sample as t_ar_sample
from repro_torch.models import api as tapi
from repro_torch.serving import ContinuousScheduler, Request

pytestmark = [pytest.mark.serving, pytest.mark.sampling_serving]

CHUNK, MAX_LEN = 64, 512
N_STAT, STAT_PROMPT, STAT_NEW, STAT_TEMP = 256, 24, 4, 0.9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(small_spec, small_dcfg):
    cfg = jcfgs.get_config("tiny-dense")
    tcfg = tcfgs.get_config("tiny-dense")
    spec = small_spec.replace(use_pallas=True)
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    td = draft_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, dparams), device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, spec=spec,
                tspec=tcfgs.SpecPVConfig(**dataclasses.asdict(spec)),
                dcfg=small_dcfg,
                tdcfg=tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg)),
                params=params, dparams=dparams, tp=tp, td=td)


def _tengine(s, batch, max_len=MAX_LEN, **kw):
    return TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                   batch=batch, max_len=max_len, device="cpu", **kw)


def _prompt(s, length, seed):
    return np.random.default_rng(seed).integers(
        0, s["cfg"].vocab_size, (length,)).astype(np.int32)


def _req(s, rid, length, new, prompt_seed, cls=Request, **kw):
    return cls(request_id=rid, prompt=_prompt(s, length, prompt_seed),
               max_new_tokens=new, arrival_s=0.0, **kw)


def _serve(engine, reqs, **kw):
    sched = ContinuousScheduler(engine, prefill_chunk=CHUNK,
                                clock=lambda: 0.0, **kw)
    for r in reqs:
        sched.submit(r)
    while sched.has_work():
        sched.tick()
    return sched


def _two_sample_ok(a, b, v):
    """The reference's bound: per position, every token's frequencies in
    the two samples differ by at most 4 sigma of the pooled frequency
    plus 0.02."""
    n = a.shape[0]
    for pos in range(a.shape[1]):
        fa = np.bincount(a[:, pos], minlength=v) / n
        fb = np.bincount(b[:, pos], minlength=v) / n
        p = (fa + fb) / 2
        sig = np.sqrt(2 * p * (1 - p) / n)
        if not (np.abs(fa - fb) <= 4 * sig + 0.02).all():
            return False
    return True


@pytest.fixture(scope="module")
def stat_run(setup):
    s = setup
    prompt = _prompt(s, STAT_PROMPT, 0)
    eng = _tengine(s, 8, max_len=128)
    sched = _serve(eng, [Request(request_id=f"r{i}", prompt=prompt.copy(),
                                 max_new_tokens=STAT_NEW, arrival_s=0.0,
                                 temperature=STAT_TEMP, seed=i)
                         for i in range(N_STAT)])
    toks = np.stack([sched.outputs[f"r{i}"].tokens for i in range(N_STAT)])
    return dict(prompt=prompt, toks=toks, sched=sched)


def test_statistical_losslessness_against_jax(setup, stat_run):
    s = setup
    st = stat_run["sched"].stats
    assert st["mode_rows_full"] > 0 and not st.get("mode_rows_refresh")
    assert stat_run["toks"].shape == (N_STAT, STAT_NEW)
    # disjoint seeds: the claim is about distributions, not streams
    ar = j_ar_sample(s["cfg"], s["params"],
                     np.tile(stat_run["prompt"][None], (N_STAT, 1)),
                     STAT_NEW, max_len=32, temperature=STAT_TEMP,
                     seeds=list(range(10_000, 10_000 + N_STAT)),
                     spec=s["spec"])
    assert _two_sample_ok(stat_run["toks"], np.asarray(ar),
                          s["cfg"].vocab_size)


def test_statistical_losslessness_against_port_ar(setup, stat_run):
    s = setup
    ar = t_ar_sample(s["tcfg"], s["tp"],
                     np.tile(stat_run["prompt"][None], (N_STAT, 1)),
                     STAT_NEW, max_len=32, temperature=STAT_TEMP,
                     seeds=list(range(20_000, 20_000 + N_STAT)),
                     spec=s["tspec"], device="cpu")
    assert _two_sample_ok(stat_run["toks"], ar, s["cfg"].vocab_size)
    # and the spec-sampled tokens are not all one stream
    assert len({tuple(r) for r in stat_run["toks"].tolist()}) > N_STAT // 2


@pytest.fixture(scope="module")
def probe_runs(setup):
    """One sampled probe request alone, in a mixed batch, and admitted
    last beside other peers; a greedy request alone and beside sampled
    and chain peers."""
    s = setup
    probe = dict(length=48, new=12, prompt_seed=2, temperature=0.8, seed=7)
    runs = {"alone": _serve(_tengine(s, 1), [_req(s, "s", **probe)]),
            "greedy_alone": _serve(_tengine(s, 1),
                                   [_req(s, "g", 48, 12, 3)])}
    eng3 = _tengine(s, 3)
    runs["mixed"] = _serve(eng3, [
        _req(s, "s", **probe), _req(s, "g", 48, 12, 3),
        _req(s, "c", 64, 12, 4, temperature=1.0, seed=9, draft="chain")])
    runs["reordered"] = _serve(eng3, [
        _req(s, "g2", 96, 12, 5),
        _req(s, "y", 160, 12, 6, temperature=0.5, seed=11),
        _req(s, "s", **probe)])
    runs["eng3"] = eng3
    return runs


def test_greedy_rows_bit_identical_in_sampled_batch(probe_runs):
    np.testing.assert_array_equal(probe_runs["mixed"].outputs["g"].tokens,
                                  probe_runs["greedy_alone"].outputs["g"]
                                  .tokens)
    keys = probe_runs["eng3"].dispatch_keys
    assert any(k[3] and k[4] for k in keys), keys      # sampled + chain


def test_stream_reproducible_across_batch_composition(probe_runs):
    want = probe_runs["alone"].outputs["s"].tokens
    assert len(want) == 12
    for run in ("mixed", "reordered"):
        np.testing.assert_array_equal(probe_runs[run].outputs["s"].tokens,
                                      want, err_msg=run)


def test_slot_isolation(setup):
    """Slot a's stream is the same whether slot b is greedy or sampled."""
    s = setup
    eng = _tengine(s, 2)
    probe = dict(length=48, new=12, prompt_seed=2, temperature=0.8, seed=7)
    with_greedy = _serve(eng, [_req(s, "a", **probe),
                               _req(s, "b", 64, 12, 3)])
    with_sampled = _serve(eng, [_req(s, "a", **probe),
                                _req(s, "b", 64, 12, 3, temperature=1.0,
                                     seed=9)])
    np.testing.assert_array_equal(with_greedy.outputs["a"].tokens,
                                  with_sampled.outputs["a"].tokens)


def test_fork_replays_identical_stream(setup):
    s = setup
    eng = _tengine(s, 2, paged=True, zero_copy=True)
    st = eng.empty_state()
    st, first = eng.prefill_into_slot(st, 0, _prompt(s, 48, 5), chunk=CHUNK,
                                      temperature=0.8, seed=13)
    st = eng.fork_slot(st, 0, 1)
    rows = np.ones((2,), bool)
    toks = {0: [first], 1: [first]}
    for _ in range(4):
        st, so = eng.step_fused(st, rows, eng.modes_for_rows(st, rows))
        for i in (0, 1):
            toks[i].extend(int(x) for x in so.tokens[i, :so.counts[i]])
    assert toks[0] == toks[1] and len(toks[0]) > 1


def test_sampled_request_never_boots_from_tail_entry(setup):
    """A greedy request registers its prompt's tail entry; the same prompt
    sampled still prefills its last block (it shares the full blocks)
    and draws its first token, and the greedy repeat boots from the
    entry."""
    s = setup
    eng = _tengine(s, 2, paged=True, zero_copy=True)
    prompt = _prompt(s, 70, 8)
    st = eng.empty_state()
    st, g1 = eng.prefill_into_slot(st, 0, prompt, chunk=CHUNK)
    assert eng.prefix_stats()["tails"] == 1
    skipped = eng.prefix_stats()["prefill_tokens_skipped"]
    st = eng.reset_slot(st, 0)
    st, _ = eng.prefill_into_slot(st, 1, prompt, chunk=CHUNK,
                                  temperature=0.9, seed=3)
    assert (eng.prefix_stats()["prefill_tokens_skipped"] - skipped
            == 64)                              # the 4 full blocks only
    st = eng.reset_slot(st, 1)
    st, g2 = eng.prefill_into_slot(st, 0, prompt, chunk=CHUNK)
    assert g2 == g1
    assert (eng.prefix_stats()["prefill_tokens_skipped"] - skipped
            == 64 + 70)


def test_scheduler_wants_a_greedy_engine(setup):
    """Sampling is per request: the continuous scheduler refuses an
    engine built sampled, as the reference asserts; the engine's own
    temperature is the default of a slot admission and of its page
    bill."""
    eng = _tengine(setup, 2, paged=True, zero_copy=True, temperature=0.7)
    with pytest.raises(ValueError, match="greedy"):
        ContinuousScheduler(eng)
    st = eng.empty_state()
    st, cur = eng.prefill_begin_slot(st, 0, _prompt(setup, 40, 1))
    assert cur.temperature == 0.7 and cur.draft == "tree"
    with pytest.raises(ValueError, match="draft"):
        eng.prefill_begin_slot(st, 1, _prompt(setup, 40, 1), draft="chains")


MIXES = [  # (modes, temperatures, chain rows)
    ((MODE_REFRESH, MODE_REFRESH, MODE_REFRESH), (0.0, 0.0, 0.0),
     (False,) * 3),
    ((MODE_FULL, MODE_PARTIAL, MODE_REFRESH), (0.7, 0.0, 1.0),
     (False, True, False)),
    ((MODE_PARTIAL, MODE_PARTIAL, MODE_PARTIAL), (1.0, 1.0, 0.7),
     (True, True, True)),
    ((MODE_FULL, MODE_FULL, MODE_PARTIAL), (0.0, 0.0, 0.0),
     (True, False, False)),
    ((MODE_REFRESH, MODE_PARTIAL, MODE_FULL), (0.0, 0.7, 0.0),
     (False, False, False)),
    ((MODE_PARTIAL, MODE_REFRESH, MODE_PARTIAL), (1.0, 0.0, 0.0),
     (False, False, True)),
]


def test_mixed_rows_one_dispatch(setup):
    """Arbitrary per-row (mode, temperature, chain) vectors: each tick is
    one dispatch under the key its mix implies, and every row emits a
    token."""
    s = setup
    eng = _tengine(s, 3)
    st = eng.empty_state()
    for slot, n in enumerate((48, 160, 176)):
        st, _ = eng.prefill_into_slot(st, slot, _prompt(s, n, 20 + slot),
                                      chunk=CHUNK, temperature=1.0, seed=slot)
    rows = np.ones((3,), bool)
    st, _ = eng.step_fused(st, rows, eng.modes_for_rows(st, rows))
    for modes, temps, chain in MIXES:
        modes = np.asarray(modes, np.int8)
        eng._slot_temp[:] = temps
        eng._slot_chain[:] = chain
        st.temps.copy_(torch.tensor(temps))
        before = eng.dispatches
        keys_before = dict(eng.dispatch_keys)
        st, so = eng.step_fused(st, rows, modes)
        assert eng.dispatches == before + 1
        key = (bool((modes != MODE_PARTIAL).any()),
               bool((modes == MODE_PARTIAL).any()),
               bool((modes == MODE_REFRESH).any()), any(t > 0 for t in temps),
               any(chain))
        assert eng.dispatch_keys[key] == keys_before.get(key, 0) + 1
        assert (so.counts >= 1).all()
        chain_rows = np.asarray(chain)
        assert (so.accept_len[chain_rows] <= eng.tree.depth).all()


@pytest.fixture(scope="module")
def chain_jax_run(setup):
    s = setup
    je = JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                 batch=2, max_len=MAX_LEN, partial_verification=True)
    sched = JScheduler(je, prefill_chunk=CHUNK, clock=lambda: 0.0)
    for r in _chain_reqs(s, JRequest):
        sched.submit(r)
    while sched.has_work():
        sched.tick()
    return sched


def _chain_reqs(s, cls):
    return [_req(s, "c1", 160, 12, 31, cls=cls, draft="chain"),
            _req(s, "t1", 96, 12, 32, cls=cls),
            _req(s, "c2", 48, 12, 33, cls=cls, draft="chain")]


def test_greedy_chain_requests_equal_jax_scheduler(setup, chain_jax_run):
    s = setup
    port = _serve(_tengine(s, 2), _chain_reqs(s, Request))
    for rid in ("c1", "t1", "c2"):
        np.testing.assert_array_equal(
            port.outputs[rid].tokens,
            np.asarray(chain_jax_run.outputs[rid].tokens), err_msg=rid)
    assert port.trace == chain_jax_run.trace
    assert any(k[4] and not k[3] for k in port.engine.dispatch_keys)


def test_draft_chain_generate_equals_jax(setup):
    s = setup
    prompt = np.stack([_prompt(s, 160, 40), _prompt(s, 160, 41)])
    kw = dict(batch=2, max_len=MAX_LEN, draft_chain=True)
    te = _tengine(s, **kw)
    je = JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                 partial_verification=True, **kw)
    assert te.tree.branch == (1,) * s["dcfg"].tree_depth
    ttoks, tstats = te.generate(prompt, 16, prefill_chunk=CHUNK)
    jtoks, jstats = je.generate(prompt, 16, prefill_chunk=CHUNK)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    assert tstats["modes"] == jstats["modes"]
    # a chain tree never keys has_chain
    assert not any(k[4] for k in te.dispatch_keys)


def test_sampled_rwkv_chain_generate_distribution(small_spec, small_dcfg):
    """128 rows of one prompt, each row its own stream (seed 0's row i),
    against the port's AR sampling by distribution."""
    tcfg = tcfgs.get_config("rwkv6-3b").reduced().replace(
        dtype="float32", param_dtype="float32")
    spec = tcfgs.SpecPVConfig(**dataclasses.asdict(small_spec))
    dcfg = tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg))
    tp = tapi.init_params(tcfg, seed=0, device="cpu")
    td = init_draft_params(tcfg, dcfg, seed=1, device="cpu")
    n, new, temp = 128, 3, 0.9
    prompt = np.tile(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (1, 16)), (n, 1))
    eng = TEngine(tcfg, spec, dcfg, tp, td, batch=n, max_len=64,
                  temperature=temp, device="cpu")
    toks, stats = eng.generate(prompt, new)
    assert stats["modes"] == {"state": stats["steps"]}
    assert len({tuple(r) for r in toks.tolist()}) > n // 2
    ar = t_ar_sample(tcfg, tp, prompt, new, max_len=64, temperature=temp,
                     seeds=list(range(1000, 1000 + n)), spec=spec,
                     device="cpu")
    assert _two_sample_ok(toks, ar, tcfg.vocab_size)
