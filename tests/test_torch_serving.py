"""Continuous-batching serving of the PyTorch port against the JAX serving
stack, on the CPU: ``tiny-dense`` in fp32 with weights converted from the
JAX parameters, the conftest ``small_spec`` (``use_pallas=True``) and
``small_dcfg``, ``max_len`` 512, prefill chunk 64.  The JAX side is
``SpecPVEngine(paged=True, zero_copy=True, prefix_cache=False)`` under its
``ContinuousScheduler(fused_prefill=False)``.

* On the four budget-straddling requests of ``tests/test_zero_copy.py``
  (batch 3, a pool too small to hold them all at once), each request's
  tokens, the admit/finish trace, ``steps``, ``mode_rows_*`` and
  ``page_stalls`` equal the JAX scheduler's, and each request equals the
  port's batch-1 ``generate``.  Pages and pins drain to zero.
* Fused equals grouped, interleaved prefill equals blocking, and the
  small pool gives the tokens of a pool that holds everything.
* On a frozen clock, cancellation and deadline eviction of waiting,
  prefilling and decoding requests give the JAX scheduler's outputs
  (reasons, partial tokens, slots, latencies) and trace.
* A masked step leaves an empty slot and a masked-out live row as they
  were, bit for bit: row fields, summaries, and pool pages up to their
  lengths.
* ``ServingEngine.run`` on reduced ``rwkv6-3b`` takes the wave path and
  equals the port's ``generate``.
* The allocator's counters follow the reference's ``PageAllocator``.
* Each unsupported setting raises NotImplementedError naming its
  ROADMAP item.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import SpecPVEngine as JEngine
from repro.core.draft import init_draft_params as j_init_draft
from repro.kvcache.cache import PageAllocator as JAllocator
from repro.models import api as japi
from repro.serving import Request as JRequest
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.engine import (MODE_FULL, EngineState,
                                     SpecPVEngine as TEngine)
from repro_torch.kernels import ops as tops
from repro_torch.kvcache.cache import PageAllocator as TAllocator
from repro_torch.models import api as tapi
from repro_torch.serving import (ContinuousScheduler, Request, RequestPhase,
                                 ServingConfig, ServingEngine)

pytestmark = [pytest.mark.serving, pytest.mark.paged]

B, MAX_LEN, CHUNK, NEW = 3, 512, 64, 12
# request (id, prompt length, prompt seed): under, across and over the
# 112-token partial budget of small_spec
REQS = (("a", 48, 2), ("b", 160, 3), ("c", 96, 4), ("d", 200, 5))
# 30 allocatable pages: a (8 pages) and b (15) fit, c (11) and d (17)
# wait for a to finish
SMALL_POOL = 31


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The shapes are tiny, so torch's intra-op threads only add
    synchronisation, and the suite runs several workers per core: with
    them this file runs about 30 times slower under the full suite."""
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
                   batch=B, max_len=MAX_LEN, partial_verification=True,
                   paged=True, zero_copy=True, prefix_cache=False, **kw)


def _tengine(s, batch=B, **kw):
    return TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                   batch=batch, max_len=MAX_LEN, device="cpu", **kw)


def _reqs(s, cls, **kw):
    return [cls(request_id=rid, prompt=s["prompts"][rid], max_new_tokens=NEW,
                arrival_s=0.0, **kw) for rid, _, _ in REQS]


def _drive(sched, reqs):
    """Submit and tick on a frozen clock until everything drains."""
    for r in reqs:
        sched.submit(r)
    while sched.has_work():
        sched.tick()
    return sched


def _port_sched(s, engine=None, **kw):
    eng = engine or _tengine(s, num_pages=SMALL_POOL)
    kw.setdefault("clock", lambda: 0.0)
    return _drive(ContinuousScheduler(eng, prefill_chunk=CHUNK, **kw),
                  _reqs(s, Request))


@pytest.fixture(scope="module")
def jax_run(setup):
    je = _jengine(setup, num_pages=SMALL_POOL)
    return _drive(JScheduler(je, prefill_chunk=CHUNK, fused=True,
                             fused_prefill=False, clock=lambda: 0.0),
                  _reqs(setup, JRequest))


@pytest.fixture(scope="module")
def port_run(setup):
    return _port_sched(setup)


def _tokens(sched):
    return {rid: sched.outputs[rid].tokens for rid, _, _ in REQS}


def _assert_same_tokens(got, want):
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)


STAT_KEYS = ("steps", "page_stalls", "admissions", "mode_rows_full",
             "mode_rows_refresh", "mode_rows_partial", "ticks_modes_1",
             "ticks_modes_2", "ticks_modes_3")


def test_serving_matches_jax_scheduler(setup, jax_run, port_run):
    _assert_same_tokens(_tokens(port_run), {
        rid: np.asarray(jax_run.outputs[rid].tokens) for rid, _, _ in REQS})
    assert port_run.trace == jax_run.trace
    for k in STAT_KEYS:
        assert port_run.stats.get(k, 0) == jax_run.stats.get(k, 0), k
    # the small pool stalled admissions, the ticks mixed modes
    assert port_run.stats["page_stalls"] > 0
    assert port_run.stats["mode_rows_refresh"] > 0
    assert port_run.stats["mode_rows_partial"] > 0
    assert port_run.stats.get("ticks_modes_2", 0) > 0
    for rid, _, _ in REQS:
        out = port_run.outputs[rid]
        assert out.finished and out.finish_reason == "length"
        assert out.slot == jax_run.outputs[rid].slot
    eng = port_run.engine
    assert eng.dispatches == port_run.stats["steps"]
    assert all(v == 0 for v in tops.LAUNCHES.values())   # CPU: plain versions
    # each step bills only the rows it stepped, as the reference does
    assert eng.traffic.bytes_by_mode == jax_run.engine.traffic.bytes_by_mode


@pytest.mark.parametrize("rid", [r[0] for r in REQS])
def test_each_request_equals_solo_generate(setup, port_run, rid):
    solo = _tengine(setup, batch=1)
    toks, _ = solo.generate(setup["prompts"][rid][None], NEW,
                            prefill_chunk=CHUNK)
    np.testing.assert_array_equal(port_run.outputs[rid].tokens, toks[0])


def test_pages_and_pins_drain(setup, port_run):
    eng = port_run.engine
    ps = eng.page_stats()
    assert ps["in_use"] == 0 and ps["draft_in_use"] == 0
    assert ps["pinned_pages"] == 0 and ps["committed"] == 0
    assert 0 < ps["high_water"] <= SMALL_POOL - 1
    assert ps["draft_high_water"] == ps["high_water"]
    for al in (eng._page_alloc, eng._draft_alloc):
        assert al.free == al.capacity
        assert all(al.count(i) == 0 for i in range(B))
    # empty slots hold the neutral row: null-page tables, length 0
    st = eng.state
    assert not st.cache["page_table"].any()
    assert not st.cache["length"].any() and not st.dcache["length"].any()


def test_small_pool_stalls_then_admits_same_tokens(setup, port_run):
    roomy = _port_sched(setup, engine=_tengine(setup))
    assert roomy.stats.get("page_stalls", 0) == 0
    assert port_run.stats["page_stalls"] > 0
    _assert_same_tokens(_tokens(port_run), _tokens(roomy))
    # the roomy pool runs all three first requests at once
    assert roomy.stats["peak_active"] == B > port_run.stats["peak_active"]


def test_fused_equals_grouped(setup, port_run):
    grouped = _port_sched(setup, fused=False)
    _assert_same_tokens(_tokens(grouped), _tokens(port_run))
    assert grouped.trace == port_run.trace
    ticks = sum(v for k, v in grouped.stats.items()
                if k.startswith("ticks_modes_"))
    assert grouped.stats["steps"] > ticks == port_run.stats["steps"]


def test_interleaved_equals_blocking(setup, port_run):
    inter = _port_sched(setup, prefill_budget=CHUNK)
    _assert_same_tokens(_tokens(inter), _tokens(port_run))
    assert inter.stats["prefill_dispatches"] > 0
    assert inter.engine.page_stats()["in_use"] == 0


# ---------------------------------------------------------------------------
# cancellation and deadlines on a frozen clock
# ---------------------------------------------------------------------------

def _lifecycle(s, sched_cls, req_cls, engine):
    """Batch 2, prefill budget 64.  Waiting: C cancelled, D past its
    deadline.  Prefilling: B past its deadline, F cancelled.  Decoding: A
    cancelled, E past its deadline.  Returns the scheduler."""
    now = {"t": 0.0}
    sched = sched_cls(engine, prefill_chunk=CHUNK, prefill_budget=CHUNK,
                      clock=lambda: now["t"], **(
                          {"fused_prefill": False}
                          if sched_cls is JScheduler else {}))
    rng = np.random.default_rng(11)

    def req(rid, n, new, pri, dl=None):
        p = rng.integers(0, s["cfg"].vocab_size, (n,)).astype(np.int32)
        sched.submit(req_cls(request_id=rid, prompt=p, max_new_tokens=new,
                             arrival_s=0.0, priority=pri, deadline_s=dl))
    req("A", 48, 40, 3)
    req("B", 200, 8, 2, dl=2.5)
    req("C", 32, 8, 1)
    req("D", 32, 8, 1, dl=1.5)
    req("E", 32, 30, 1, dl=4.5)
    req("F", 200, 8, 0)
    phases = []
    for t, cancel in ((0, None), (1, None), (2, "C"), (3, "A"), (4, "F"),
                      (5, None)):
        now["t"] = float(t)
        if cancel is not None:
            assert sched.cancel(cancel)
        sched.tick()
        phases.append({s_.req.request_id: s_.req.phase.value
                       for s_ in sched.slots if s_ is not None})
    assert not sched.has_work()
    sched.phases = phases
    return sched


def test_cancel_and_deadline_match_jax(setup):
    js = _lifecycle(setup, JScheduler, JRequest,
                    JEngine(setup["cfg"], setup["spec"], setup["dcfg"],
                            setup["params"], setup["dparams"], batch=2,
                            max_len=MAX_LEN, paged=True, zero_copy=True,
                            prefix_cache=False))
    ts = _lifecycle(setup, ContinuousScheduler, Request,
                    _tengine(setup, batch=2))
    want = {"A": "cancelled", "B": "deadline", "C": "cancelled",
            "D": "deadline", "E": "deadline", "F": "cancelled"}
    assert {k: o.finish_reason for k, o in ts.outputs.items()} == want
    for rid in want:
        t, j = ts.outputs[rid], js.outputs[rid]
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens),
                                      err_msg=rid)
        assert (t.slot, t.finished, t.latency_s) == \
            (j.slot, j.finished, j.latency_s), rid
    assert ts.trace == js.trace
    assert ts.phases == js.phases
    # decoding evictions keep their partial tokens; the rest have none
    assert 0 < len(ts.outputs["A"].tokens) < 40
    assert 0 < len(ts.outputs["E"].tokens) < 30
    assert all(len(ts.outputs[r].tokens) == 0 for r in "BCDF")
    assert ts.phases[1] == {"A": "decoding", "B": "prefilling"}
    assert ts.engine.page_stats()["in_use"] == 0
    assert all(s_ is None for s_ in ts.slots)
    assert ts.outputs["A"].slot >= 0 and ts.outputs["C"].slot == -1


# ---------------------------------------------------------------------------
# masked steps leave untouched rows as they were
# ---------------------------------------------------------------------------

def _row_snapshot(eng, row):
    """Every field of batch row ``row`` and the pool contents it owns:
    trunk pages over [0, length) in every layer with their summaries, and
    draft pages over [0, draft length)."""
    st = eng.state
    bs = eng.spec.block_size
    snap = {}
    for f in dataclasses.fields(EngineState):
        v = getattr(st, f.name)
        if isinstance(v, dict):
            for k in ("page_table", "length"):
                snap[f"{f.name}.{k}"] = v[k][row].clone()
        elif f.name in ("pkv_k", "pkv_v", "pkv_pos"):
            snap[f.name] = v[:, row].clone()
        else:
            snap[f.name] = v[row].clone()
    for name, c in (("cache", st.cache), ("dcache", st.dcache)):
        n = int(c["length"][row])
        pages = c["page_table"][row, : -(-n // bs)].long()
        kk = c["k"][:, pages] if name == "cache" else c["k"][pages]
        vv = c["v"][:, pages] if name == "cache" else c["v"][pages]
        flat = kk.shape[:-4] + (-1,) + kk.shape[-2:]
        snap[f"{name}.k"] = kk.reshape(flat)[..., :n, :, :].clone()
        snap[f"{name}.v"] = vv.reshape(flat)[..., :n, :, :].clone()
        if name == "cache":
            snap["kmax"] = c["kmax"][:, pages].clone()
            snap["kmin"] = c["kmin"][:, pages].clone()
    return snap


def _assert_snap_equal(got, want, label):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), \
            f"{label}: {k} changed"


def test_masked_step_keeps_untouched_rows(setup):
    """Slot 0 long (Refresh, then Partial), slot 1 short (Full), slot 2
    empty.  Masked steps of one live row at a time, in each mode mix:
    the other live row and the empty slot keep every bit, and the empty
    slot stays neutral."""
    eng = _tengine(setup, num_pages=40)
    st = eng.empty_state()
    p = setup["prompts"]
    st, _ = eng.prefill_into_slot(st, 0, p["d"], chunk=CHUNK,
                                  max_new_tokens=40)
    st, _ = eng.prefill_into_slot(st, 1, p["a"], chunk=CHUNK,
                                  max_new_tokens=20)
    live = np.array([True, True, False])
    seen = set()
    for rows in ([True, False, False], [False, True, False],
                 [True, False, False], [True, False, False],
                 [False, True, False], [True, True, False]):
        rows = np.asarray(rows)
        modes = eng.modes_for_rows(st, live)
        before = {r: _row_snapshot(eng, r) for r in range(B) if not rows[r]}
        st, so = eng.step_fused(st, rows, modes)
        seen.add(tuple(modes[rows]))
        for r, snap in before.items():
            _assert_snap_equal(_row_snapshot(eng, r), snap,
                               f"row {r} after stepping rows {rows}")
            assert so.counts[r] == 0 and so.accept_len[r] == 0
        assert (so.counts[rows] > 0).all()
    # the steps covered Refresh, Partial and Full rows
    assert {(1,), (2,), (0,)} <= seen, seen
    assert eng._pkv_active_rows.tolist() == [True, False, False]
    assert int(st.cache["length"][2]) == 0 and int(st.pending_len[2]) == 1
    with pytest.raises(ValueError, match="live row"):
        eng.step_fused(st, np.zeros(B, bool), np.zeros(B, np.int8))


def test_empty_state_empties_both_pools(setup):
    eng = _tengine(setup, batch=2)
    eng.prefill(np.zeros((2, 40), np.int32), chunk=CHUNK)
    assert eng._page_alloc.free == 0        # lock-step rows hold max_len
    eng.empty_state()
    for al in (eng._page_alloc, eng._draft_alloc):
        assert al.free == al.capacity and al.in_use == 0
    assert eng.modes_for_rows(eng.state, np.ones(2, bool)).tolist() == \
        [MODE_FULL, MODE_FULL]


# ---------------------------------------------------------------------------
# the wave path (state architectures)
# ---------------------------------------------------------------------------

def test_rwkv_serves_through_the_wave_path(small_spec, small_dcfg):
    tcfg = tcfgs.get_config("rwkv6-3b").reduced().replace(
        dtype="float32", param_dtype="float32")
    tspec = tcfgs.SpecPVConfig(**dataclasses.asdict(small_spec))
    tdcfg = tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg))
    from repro_torch.core.draft import init_draft_params
    params = tapi.init_params(tcfg, seed=0, device="cpu")
    dparams = init_draft_params(tcfg, tdcfg, seed=1, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab_size, (24,)).astype(np.int32)
               for _ in range(2)]
    srv = ServingEngine(tcfg, tspec, tdcfg, params, dparams,
                        ServingConfig(batch=2, max_len=128, prefill_chunk=16),
                        device="cpu")
    for i, p in enumerate(prompts):
        srv.submit(Request(request_id=f"r{i}", prompt=p, max_new_tokens=6))
    outs = srv.run()
    assert srv._continuous is None and srv.stats["waves"] == 1
    assert [o.request_id for o in outs] == ["r0", "r1"]
    eng = TEngine(tcfg, tspec, tdcfg, params, dparams, batch=2, max_len=128,
                  paged=False, device="cpu")
    want, _ = eng.generate(np.stack(prompts), 6, prefill_chunk=16)
    for i in range(2):
        np.testing.assert_array_equal(srv.outputs[f"r{i}"].tokens, want[i])
        assert srv.outputs[f"r{i}"].finish_reason == "length"
    assert srv.throughput_tok_s() > 0


def test_serving_engine_continuous_path(setup):
    """``ServingEngine.run`` drives the continuous scheduler on the
    configured pool and keeps its stats; ``reset_warm`` boots a fresh
    scheduler that gives the same tokens."""
    scfg = ServingConfig(batch=B, max_len=MAX_LEN, prefill_chunk=CHUNK,
                         num_pages=SMALL_POOL)
    srv = ServingEngine(setup["tcfg"], setup["tspec"], setup["tdcfg"],
                        setup["tp"], setup["td"], scfg, device="cpu")
    reqs = _reqs(setup, Request)
    for r in reqs:
        srv.submit(r)
    srv.run()
    first = {k: o.tokens for k, o in srv.outputs.items()}
    assert srv.stats["page_stalls"] > 0 and srv.stats["tokens"] == 4 * NEW
    assert srv.page_stats()["num_pages"] == SMALL_POOL
    assert all(r.phase is RequestPhase.FINISHED for r in reqs)
    srv.reset_warm()
    assert srv.stats == {} and srv.page_stats()["high_water"] == 0
    for r in _reqs(setup, Request):
        srv.submit(r)
    srv.run()
    _assert_same_tokens({k: o.tokens for k, o in srv.outputs.items()}, first)


# ---------------------------------------------------------------------------
# the allocator, and what the port does not serve yet
# ---------------------------------------------------------------------------

def test_allocator_counters_follow_reference():
    rng = np.random.default_rng(9)
    ja, ta = JAllocator(24), TAllocator(24)
    for _ in range(200):
        slot = int(rng.integers(0, 4))
        op = rng.integers(0, 3)
        if op == 0 and ja.free:
            n = int(rng.integers(1, ja.free + 1))
            np.testing.assert_array_equal(ta.alloc(slot, n),
                                          ja.alloc(slot, n))
        elif op == 1:
            assert ta.free_slot(slot) == ja.free_slot(slot)
        elif ja.count(slot):
            pages = ja.pages_of(slot)
            pick = [pages[int(i)] for i in rng.integers(0, len(pages), 2)]
            ja.pin_slot_pages(slot, pick)
            ta.pin_slot_pages(slot, pick)
        for name in ("free", "in_use", "idle", "committed", "high_water",
                     "resident_high_water", "pinned_pages"):
            assert getattr(ta, name) == getattr(ja, name), name
        assert ta.pages_of(slot) == ja.pages_of(slot)
    with pytest.raises(RuntimeError, match="exhausted"):
        ta.alloc(0, ta.free + 1)


def _bad_config(s, **kw):
    ServingEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                  ServingConfig(**kw), device="cpu")


def _bad_request(s, **kw):
    eng = _tengine(s)
    ContinuousScheduler(eng).submit(Request(
        request_id="x", prompt=s["prompts"]["a"], **kw))


@pytest.mark.parametrize("make, kw, item", [
    (_bad_config, dict(paged_kv=False), "contiguous SpecPV engine"),
    (_bad_config, dict(zero_copy_partial=False), "contiguous SpecPV engine"),
    (_bad_config, dict(prefix_cache=True), "Serving"),
    (_bad_config, dict(fused_prefill=True), "Batched prefill"),
    (_bad_config, dict(tiered_kv=True), "Tiered KV"),
    (_bad_config, dict(mesh_shape=(1, 1)), "Multi-GPU"),
    (_bad_request, dict(temperature=0.7), "Sampling"),
    (_bad_request, dict(draft="chain"), "Sampling"),
], ids=["paged_kv", "zero_copy", "prefix_cache", "fused_prefill", "tiered",
        "mesh", "temperature", "chain"])
def test_unsupported_settings_raise(setup, make, kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*'{item}'"):
        make(setup, **kw)


def test_scheduler_refuses_fused_prefill(setup):
    with pytest.raises(NotImplementedError, match="Batched prefill"):
        ContinuousScheduler(_tengine(setup), fused_prefill=True)
