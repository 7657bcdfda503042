"""Serving on the reference's default engine in the PyTorch port, against
the JAX serving stack on the CPU: ``tiny-dense`` in fp32 with weights
converted from the JAX parameters, the conftest ``small_spec``
(``use_pallas=True``) and ``small_dcfg``, ``max_len`` 500 (not a multiple
of the 16-token block), prefill chunk 64, the four budget-straddling
requests of ``tests/test_torch_serving.py``.

* ``ContinuousScheduler`` over a contiguous engine (``paged=False``,
  gathered partial cache; admission by free slot, no page gate) gives the
  JAX scheduler's tokens, admit/finish trace, steps and mode rows,
  blocking and interleaved; each request equals its solo ``generate``.
* The gathered partial cache on the paged pool (``zero_copy=False``)
  gives the JAX scheduler's tokens, trace and page stalls on a pool too
  small for every request at once.
* Two contiguous slot prefills advanced chunk by chunk in turn (each in
  its slot's rows of the prefill carry) equal the same prefills run one
  after the other.
* ``ServingConfig()``'s defaults serve on the contiguous engine, and the
  wave path of an attention arch runs a contiguous engine, as in the
  reference.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import SpecPVEngine as JEngine
from repro.core.draft import init_draft_params as j_init_draft
from repro.models import api as japi
from repro.serving import Request as JRequest
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.kernels import ops as tops
from repro_torch.serving import (ContinuousScheduler, Request, ServingConfig,
                                 ServingEngine)

pytestmark = [pytest.mark.serving]

B, MAX_LEN, CHUNK, NEW = 3, 500, 64, 12
REQS = (("a", 48, 2), ("b", 160, 3), ("c", 96, 4), ("d", 200, 5))
SMALL_POOL = 31         # 30 allocatable pages: c and d wait for a
STAT_KEYS = ("steps", "page_stalls", "admissions", "mode_rows_full",
             "mode_rows_refresh", "mode_rows_partial", "ticks_modes_1",
             "ticks_modes_2", "ticks_modes_3")


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
    tspec = tcfgs.SpecPVConfig(**dataclasses.asdict(spec))
    tdcfg = tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg))
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    td = draft_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, dparams), device="cpu")
    prompts = {rid: np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n,)).astype(np.int32) for rid, n, seed in REQS}
    return dict(cfg=cfg, tcfg=tcfg, spec=spec, tspec=tspec, dcfg=small_dcfg,
                tdcfg=tdcfg, params=params, dparams=dparams, tp=tp, td=td,
                prompts=prompts)


def _jengine(s, **kw):
    return JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                   batch=B, max_len=MAX_LEN, prefix_cache=False, **kw)


def _tengine(s, batch=B, **kw):
    return TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                   batch=batch, max_len=MAX_LEN, prefix_cache=False,
                   device="cpu", **kw)


def _drive(sched, reqs):
    """Submit and tick on a frozen clock until everything drains."""
    for r in reqs:
        sched.submit(r)
    while sched.has_work():
        sched.tick()
    return sched


def _reqs(s, cls):
    return [cls(request_id=rid, prompt=s["prompts"][rid], max_new_tokens=NEW,
                arrival_s=0.0) for rid, _, _ in REQS]


def _run(s, eng, cls, sched_cls, **kw):
    kw.setdefault("clock", lambda: 0.0)
    return _drive(sched_cls(eng, prefill_chunk=CHUNK, **kw), _reqs(s, cls))


def _assert_same_run(port, jax_run):
    for rid, _, _ in REQS:
        np.testing.assert_array_equal(port.outputs[rid].tokens,
                                      np.asarray(jax_run.outputs[rid].tokens),
                                      err_msg=rid)
    assert port.trace == jax_run.trace
    for k in STAT_KEYS:
        assert port.stats.get(k, 0) == jax_run.stats.get(k, 0), k


@pytest.fixture(scope="module")
def jax_contiguous(setup):
    return _jengine(setup, paged=False, zero_copy=False)


@pytest.fixture(scope="module")
def port_blocking(setup):
    return _run(setup, _tengine(setup), Request, ContinuousScheduler)


@pytest.mark.parametrize("budget", [None, 96], ids=["blocking",
                                                     "interleaved"])
def test_contiguous_serving_matches_jax_scheduler(setup, jax_contiguous,
                                                  port_blocking, budget):
    jax_contiguous.traffic.bytes_by_mode.clear()   # one engine, two runs
    jrun = _run(setup, jax_contiguous, JRequest, JScheduler, fused=True,
                fused_prefill=False, prefill_budget=budget)
    port = (port_blocking if budget is None else
            _run(setup, _tengine(setup), Request, ContinuousScheduler,
                 prefill_budget=budget))
    _assert_same_run(port, jrun)
    eng = port.engine
    assert not eng.paged and eng.gathered
    assert port.stats.get("page_stalls", 0) == 0
    assert port.stats["mode_rows_refresh"] > 0
    assert port.stats["mode_rows_partial"] > 0
    assert port.stats["peak_active"] == B       # admission by free slot
    assert eng.dispatches == port.stats["steps"]
    assert eng.page_stats() == {}
    assert all(v == 0 for v in tops.LAUNCHES.values())   # CPU: plain
    assert eng.traffic.bytes_by_mode == jrun.engine.traffic.bytes_by_mode


@pytest.mark.parametrize("rid", [r[0] for r in REQS])
def test_contiguous_request_equals_solo_generate(setup, port_blocking, rid):
    solo = _tengine(setup, batch=1)
    toks, _ = solo.generate(setup["prompts"][rid][None], NEW,
                            prefill_chunk=CHUNK)
    np.testing.assert_array_equal(port_blocking.outputs[rid].tokens, toks[0])


def test_gathered_paged_serving_matches_jax_scheduler(setup):
    je = _jengine(setup, paged=True, zero_copy=False, num_pages=SMALL_POOL)
    jrun = _run(setup, je, JRequest, JScheduler, fused=True,
                fused_prefill=False)
    te = _tengine(setup, paged=True, zero_copy=False, num_pages=SMALL_POOL)
    port = _run(setup, te, Request, ContinuousScheduler)
    _assert_same_run(port, jrun)
    assert port.stats["page_stalls"] > 0
    assert te.gathered and te._page_alloc.pinned_pages == 0
    assert te.page_stats()["in_use"] == 0


def test_interleaved_cursors_hand_over_static_rows(setup):
    """Two contiguous slot prefills advanced chunk by chunk in turn
    equal the two run back to back: each cursor's rows stay in its
    slot's rows of the prefill carry between its chunks."""
    s = setup
    a, b = s["prompts"]["b"], s["prompts"]["d"]
    seq = _tengine(s)
    st = seq.empty_state()
    st, fa = seq.prefill_into_slot(st, 0, a, chunk=CHUNK)
    st, fb = seq.prefill_into_slot(st, 2, b, chunk=CHUNK)
    alt = _tengine(s)
    st2 = alt.empty_state()
    st2, ca = alt.prefill_begin_slot(st2, 0, a, chunk=CHUNK)
    st2, cb = alt.prefill_begin_slot(st2, 2, b, chunk=CHUNK)
    while not (ca.done and cb.done):
        for cur in (ca, cb):
            if not cur.done:
                st2, _ = alt.prefill_step_into_slot(st2, cur)
    assert ca.row_cache is not None and cb.row_cache is not None
    st2, ga = alt.prefill_finalize_slot(st2, ca)
    st2, gb = alt.prefill_finalize_slot(st2, cb)
    assert (ga, gb) == (fa, fb)
    for name in ("k", "v", "kmax", "kmin", "length"):
        torch.testing.assert_close(st2.cache[name], st.cache[name],
                                   rtol=0, atol=0, msg=name)
    for name in ("k", "v", "length"):
        torch.testing.assert_close(st2.dcache[name], st.dcache[name],
                                   rtol=0, atol=0, msg=name)


def test_serving_defaults_run_contiguous(setup):
    """``ServingConfig()``'s layout is the reference's: the continuous
    engine is contiguous and gathered; the wave path of an attention arch
    runs a contiguous engine too.  Both give the port's solo tokens."""
    s = setup
    solo = _tengine(s, batch=1)
    want = {rid: solo.generate(s["prompts"][rid][None], NEW,
                               prefill_chunk=CHUNK)[0][0]
            for rid in ("a", "c")}
    for sched in ("continuous", "wave"):
        srv = ServingEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"],
                            s["td"], ServingConfig(
                                batch=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
                                scheduler=sched), device="cpu")
        for rid in want:
            srv.submit(Request(request_id=rid, prompt=s["prompts"][rid],
                               max_new_tokens=NEW))
        srv.run()
        (eng,) = srv._engines.values()
        assert not eng.paged and eng.gathered, sched
        assert srv.page_stats() == {} and srv.prefix_stats() == {}
        for rid, toks in want.items():
            np.testing.assert_array_equal(srv.outputs[rid].tokens, toks,
                                          err_msg=f"{sched} {rid}")
        if sched == "wave":
            assert srv.stats["waves"] == 2
