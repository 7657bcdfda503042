"""The fused multi-row prefill of the PyTorch port against the JAX package,
on the CPU: ``tiny-dense`` in fp32 with weights converted from the JAX
parameters, the conftest ``small_spec`` (block 16, ``use_pallas=True``)
and ``small_dcfg``, prefill chunk 32.  The first layer's K/V and
summaries (projections of the embeddings: where each token was written)
are held at 1e-6; every layer's, the draft's (its input is the trunk's
features), the logits and the features at 1e-4,
as in ``tests/test_torch_model.py`` (the port's plain kernel versions
against the reference's gathered route differ in summation order).

* ``api.prefill(t_valid=...)``: two ragged chunks over paged and
  contiguous caches give the reference's logits, features, K/V in the
  valid region, summaries and lengths.
* ``SpecPVEngine.prefill_step_fused`` over the same cursors gives the
  reference's: paged with prefix sharing (a row whose first chunk starts
  at a prefix match, short and long chunks in one round, a row at its
  prompt's end) and contiguous (rows at staggered offsets).
* A one-cursor fused step equals the serial step bit for bit, and fused
  and serial pumps give equal tokens.
* The continuous scheduler with ``fused_prefill=True`` and a budget gives
  the JAX scheduler's tokens, trace and stats, ``prefill_dispatches``
  included, on paged slots with prefix sharing (dedupes, a tail-entry
  hit) and on contiguous slots; a tick with N open cursors that fit the
  budget makes one dispatch; concurrent cold admissions dedupe.
* Contiguous rows where ``max_len`` is not a multiple of the chunk: a
  short final chunk padded in a round with another row's full chunk
  writes past ``max_len``.  The port's fused result equals its serial
  one and the reference's serial one; the reference's fused path shifts
  the row's write start there (ROADMAP.md queue 3, "Traps").
* ``ServingConfig()`` equals the reference's field for field.
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
from repro.serving import Request as JRequest
from repro.serving.engine import ServingConfig as JServingConfig
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.models import api as tapi
from repro_torch.serving import ContinuousScheduler, Request, ServingConfig

pytestmark = [pytest.mark.serving, pytest.mark.prefill]

CHUNK, MAX_LEN, NEW = 32, 256, 8
TOL_KV, TOL_OUT = 1e-6, 1e-4


def _close_kv(got, want, msg):
    """Trunk K/V or summaries [L, ...]: layer 0 at TOL_KV, all at TOL_OUT."""
    _close(_np(got)[0], _np(want)[0], TOL_KV, msg + " layer 0")
    _close(got, want, TOL_OUT, msg)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(
        np.int32)


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
    return dict(cfg=cfg, tcfg=tcfg, spec=spec, tspec=tspec, dcfg=small_dcfg,
                tdcfg=tdcfg, params=params, dparams=dparams, tp=tp, td=td)


def _jengine(s, **kw):
    kw.setdefault("batch", 3)
    kw.setdefault("max_len", MAX_LEN)
    return JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                   partial_verification=True, **kw)


def _tengine(s, **kw):
    kw.setdefault("batch", 3)
    kw.setdefault("max_len", MAX_LEN)
    return TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                   device="cpu", **kw)


def _np(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor)
                      else a, np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# api.prefill with t_valid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_ragged_prefill_matches_jax(setup, paged):
    s = setup
    cfg, tcfg, spec, tspec = s["cfg"], s["tcfg"], s["spec"], s["tspec"]
    b, max_len, bs = 3, 150, spec.block_size
    nb = -(-max_len // bs)
    if paged:
        num_pages = b * nb + 1
        jc = japi.init_cache(cfg, b, max_len, spec, paged=True,
                             num_pages=num_pages)
        tc = tapi.init_cache(tcfg, b, max_len, tspec, paged=True,
                             num_pages=num_pages, device="cpu")
        pt = np.random.default_rng(3).permutation(
            np.arange(1, num_pages)).reshape(b, nb).astype(np.int32)
        jc["page_table"] = jnp.asarray(pt)
        tc["page_table"] = torch.from_numpy(pt)
    else:
        jc = japi.init_cache(cfg, b, max_len, spec)
        tc = tapi.init_cache(tcfg, b, max_len, tspec, device="cpu")
    rng = np.random.default_rng(4)
    for tv in ([20, 7, 32], [32, 1, 15]):
        toks = rng.integers(0, cfg.vocab_size, (b, CHUNK)).astype(np.int32)
        tv = np.asarray(tv, np.int32)
        toks[np.arange(CHUNK)[None] >= tv[:, None]] = 0
        lj, fj, jc = japi.prefill(cfg, s["params"], jnp.asarray(toks), jc,
                                  spec=spec, t_valid=jnp.asarray(tv))
        lt, ft, tc = tapi.prefill(tcfg, s["tp"], torch.from_numpy(toks).long(),
                                  tc, spec=tspec,
                                  t_valid=torch.from_numpy(tv))
        _close(lt, lj, TOL_OUT, "logits")
        valid = np.arange(CHUNK)[None] < tv[:, None]
        for g, w in zip(ft, fj):          # pad positions are not compared
            _close(_np(g)[valid], _np(w)[valid], TOL_OUT, "features")
        np.testing.assert_array_equal(tc["length"].numpy(),
                                      np.asarray(jc["length"]))
    length = np.asarray(jc["length"])
    for name in ("k", "v"):
        if paged:          # the logical view; pads went to the null page
            got = _np(tc[name])[:, pt].reshape(cfg.num_layers, b, nb * bs,
                                               -1)
            want = _np(jc[name])[:, pt].reshape(got.shape)
        else:
            got, want = _np(tc[name]), _np(jc[name])
        for r in range(b):
            _close_kv(got[:, r, : length[r]], want[:, r, : length[r]], name)
    for name in ("kmax", "kmin"):
        _close_kv(tc[name], jc[name], name)


# ---------------------------------------------------------------------------
# prefill_step_fused against the reference's
# ---------------------------------------------------------------------------

def _cursor_rows(eng, st, cur, paged):
    """A cursor's trunk and draft K/V over its filled prefix, its blocks'
    summaries and its length, as numpy (either package; ``st`` is the
    engine's state, which a JAX engine rebinds at every call)."""
    n = cur.off
    bs = eng.spec.block_size
    nb = -(-eng.max_len // bs)
    if paged or isinstance(eng, TEngine):
        if paged:
            pt, pool, dpool = cur.pt_host, st.cache, st.dcache
        else:                           # the port's contiguous carry
            pt = 1 + cur.slot * nb + np.arange(nb)
            pool, dpool = eng._slot_pools(st)
        k = {m: _np(pool[m])[:, pt] for m in ("k", "v", "kmax", "kmin")}
        dk = {m: _np(dpool[m])[pt] for m in ("k", "v")}
    else:                               # the reference's batch-1 row caches
        def blocks(a):                  # [B=1, S, ...] -> [nb, bs, ...]
            a = _np(a)[0]
            a = np.pad(a, [(0, nb * bs - a.shape[0])] + [(0, 0)] * 2)
            return a.reshape((nb, bs) + a.shape[1:])
        rc, rd = cur.row_cache, cur.row_dcache
        k = {m: np.stack([blocks(x) for x in rc[m]]) for m in ("k", "v")}
        k.update({m: _np(rc[m])[:, 0] for m in ("kmax", "kmin")})
        dk = {m: blocks(rd[m]) for m in ("k", "v")}

    def tok(a):                         # [..., nb, bs, Hk, Dh] -> n tokens
        a = a.reshape(a.shape[:-4] + (-1,) + a.shape[-2:])
        return a[..., :n, :, :]
    return dict(k=tok(k["k"]), v=tok(k["v"]),
                kmax=k["kmax"][:, : -(-n // bs)],
                kmin=k["kmin"][:, : -(-n // bs)],
                dk=tok(dk["k"]), dv=tok(dk["v"]),
                length=int(np.asarray(cur.row_cache["length"])[0]))


def _compare_cursors(jeng, jst, jcurs, teng, tcurs, paged, what):
    for jc, tc in zip(jcurs, tcurs):
        assert tc.off == jc.off and tc.done == jc.done, what
        _close(tc.prev_feat, jc.prev_feat, TOL_OUT, f"{what} prev_feat")
        if tc.done:
            _close(tc.logits_last, jc.logits_last, TOL_OUT, f"{what} logits")
        want = _cursor_rows(jeng, jst, jc, paged)
        got = _cursor_rows(teng, teng.state, tc, paged)
        assert got.pop("length") == want.pop("length") == tc.off, what
        for m in ("k", "v", "kmax", "kmin"):
            _close_kv(got[m], want[m], f"{what} slot {tc.slot} {m}")
        for m in ("dk", "dv"):          # inputs: the trunk's features
            _close(got[m], want[m], TOL_OUT, f"{what} slot {tc.slot} {m}")


def _begin(eng, st, slot, prompt):
    return eng.prefill_begin_slot(st, slot, prompt, chunk=CHUNK,
                                  max_new_tokens=NEW)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_prefill_step_fused_matches_jax(setup, paged):
    """Paged (prefix sharing on): p0 prefills whole and registers its
    blocks; p1 shares p0's first 3 blocks, so its first chunk is the
    16-token [48, 64), run in a round with p2's full cold chunk; p2's
    last chunk is 13 tokens.  Contiguous: p0 runs one chunk serially
    first, so the three rows sit at staggered offsets."""
    s = setup
    v = s["cfg"].vocab_size
    p0 = _prompt(v, 70, 40)
    prompts = [np.concatenate([p0[:48], _prompt(v, 60, 41)]),
               _prompt(v, 45, 42)]
    kw = dict(paged=True, zero_copy=True, prefix_cache=True) if paged else {}
    jeng, teng = _jengine(s, **kw), _tengine(s, **kw)
    jst, tst = jeng.empty_state(), teng.empty_state()
    if paged:
        jst, _ = jeng.prefill_into_slot(jst, 0, p0, chunk=CHUNK,
                                        max_new_tokens=NEW)
        tst, _ = teng.prefill_into_slot(tst, 0, p0, chunk=CHUNK,
                                        max_new_tokens=NEW)
        slots, jcurs, tcurs = (1, 2), [], []
    else:
        jst, jc0 = _begin(jeng, jst, 0, p0)
        tst, tc0 = _begin(teng, tst, 0, p0)
        jst, _ = jeng.prefill_step_into_slot(jst, jc0)
        tst, _ = teng.prefill_step_into_slot(tst, tc0)
        slots, jcurs, tcurs = (1, 2), [jc0], [tc0]
    for slot, p in zip(slots, prompts):
        jst, jc = _begin(jeng, jst, slot, p)
        tst, tc = _begin(teng, tst, slot, p)
        jcurs.append(jc)
        tcurs.append(tc)
    if paged:
        assert tcurs[0].n_match == jcurs[0].n_match == 3
        assert tcurs[0].off == 48 and tcurs[0].next_tokens == 16
    rounds = 0
    while any(not c.done for c in tcurs):
        jst, jn = jeng.prefill_step_fused(jst, jcurs)
        tst, tn = teng.prefill_step_fused(tst, tcurs)
        assert tn == jn
        rounds += 1
        _compare_cursors(jeng, jst, jcurs, teng, tcurs, paged,
                         f"round {rounds}")
    # and p0's chunks before: its three (paged) or its first
    assert teng.prefill_dispatches == rounds + (3 if paged else 1)
    for jc, tc in zip(jcurs, tcurs):
        jst, jf = jeng.prefill_finalize_slot(jst, jc)
        tst, tf = teng.prefill_finalize_slot(tst, tc)
        assert tf == jf
    if paged:
        assert teng.prefix_stats() == jeng.prefix_stats()


def _pump_all(eng, prompts, fused, chunk=CHUNK):
    """Begin every prompt, run the cursors (fused rounds or serially),
    finalise, and decode three steps.  Returns the token streams."""
    st = eng.empty_state()
    curs = []
    for i, p in enumerate(prompts):
        st, c = eng.prefill_begin_slot(st, i, p, chunk=chunk,
                                       max_new_tokens=NEW)
        curs.append(c)
    if fused:
        while any(not c.done for c in curs):
            st, _ = eng.prefill_step_fused(st, curs)
    else:
        for c in curs:
            while not c.done:
                st, _ = eng.prefill_step_into_slot(st, c)
    streams = []
    for c in curs:
        st, f = eng.prefill_finalize_slot(st, c)
        streams.append([f])
    active = np.zeros((eng.batch,), bool)
    active[: len(prompts)] = True
    for _ in range(3):
        st, so = eng.step_fused(st, active, eng.modes_for_rows(st, active))
        for i in range(len(prompts)):
            streams[i] += [int(x) for x in so.tokens[i, : so.counts[i]]]
    return streams


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_fused_one_row_bitwise_and_pumps_equal(setup, paged):
    """A one-cursor fused step (the first row of the batch-3 buffers)
    equals a batch-1 engine's serial steps bit for bit: caches, carried
    feature, logits; fused and serial pumps give equal token streams."""
    s = setup
    v = s["cfg"].vocab_size
    kw = dict(paged=True, zero_copy=True) if paged else {}
    prompt = _prompt(v, 70, 7)
    rows = {}
    for fused in (False, True):
        eng = _tengine(s, batch=3 if fused else 1, **kw)
        st, c = _begin(eng, eng.empty_state(), 0, prompt)
        while not c.done:
            if fused:
                st, _ = eng.prefill_step_fused(st, [c])
            else:
                st, _ = eng.prefill_step_into_slot(st, c)
        rows[fused] = (c, _cursor_rows(eng, st, c, paged))
    (a, ra), (b, rb) = rows[False], rows[True]
    assert torch.equal(a.logits_last, b.logits_last)
    assert torch.equal(a.prev_feat, b.prev_feat)
    for m in ra:
        np.testing.assert_array_equal(ra[m], rb[m], err_msg=m)
    prompts = [np.concatenate([prompt[:40], _prompt(v, 37, 8)]),
               _prompt(v, 91, 9), _prompt(v, 64, 10)]
    streams = {f: _pump_all(_tengine(s, **kw), prompts, f)
               for f in (False, True)}
    assert streams[False] == streams[True]


# ---------------------------------------------------------------------------
# the scheduler with fused_prefill=True against the JAX scheduler
# ---------------------------------------------------------------------------

SCHED_STATS = ("steps", "page_stalls", "admissions", "prefix_evictions",
               "mode_rows_full", "mode_rows_refresh", "mode_rows_partial",
               "ticks_modes_1", "ticks_modes_2", "ticks_modes_3",
               "prefill_dispatches", "prefill_tokens")


def _trace_prompts(v):
    """Two shared 4-block system prompts with their own tails; b and c
    are one prompt admitted together (cold: they dedupe); e repeats a
    (a tail-entry hit once a is done)."""
    sys0, sys1 = _prompt(v, 64, 50), _prompt(v, 64, 51)
    p = {"a": np.concatenate([sys0, _prompt(v, 37, 52)]),
         "b": np.concatenate([sys1, _prompt(v, 53, 53)])}
    p["c"] = p["b"].copy()
    p["d"] = np.concatenate([sys0, _prompt(v, 21, 54)])
    p["e"] = p["a"].copy()
    return p


def _serve(eng, sched_cls, req_cls, prompts, budget, **kw):
    sched = sched_cls(eng, prefill_chunk=CHUNK, prefill_budget=budget,
                      clock=lambda: 0.0, **kw)
    for rid, p in prompts.items():
        sched.submit(req_cls(request_id=rid, prompt=p, max_new_tokens=NEW,
                             arrival_s=0.0))
    while sched.has_work():
        sched.tick()
    return sched


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_fused_serving_matches_jax_scheduler(setup, paged):
    s = setup
    prompts = _trace_prompts(s["cfg"].vocab_size)
    kw = (dict(paged=True, zero_copy=True, prefix_cache=True, num_pages=40)
          if paged else dict(prefix_cache=False))
    budget = 3 * CHUNK
    jrun = _serve(_jengine(s, **kw), JScheduler, JRequest, prompts, budget,
                  fused_prefill=True)
    trun = _serve(_tengine(s, **kw), ContinuousScheduler, Request, prompts,
                  budget)
    assert trun.fused_prefill
    for rid in prompts:
        np.testing.assert_array_equal(
            trun.outputs[rid].tokens, np.asarray(jrun.outputs[rid].tokens),
            err_msg=rid)
    assert trun.trace == jrun.trace
    for k in SCHED_STATS:
        assert trun.stats.get(k, 0) == jrun.stats.get(k, 0), k
    teng = trun.engine
    assert teng.prefill_dispatches == trun.stats["prefill_dispatches"]
    # some round ran several rows: fewer dispatches than serial chunks
    serial = _serve(_tengine(s, **kw), ContinuousScheduler, Request, prompts,
                    budget, fused_prefill=False)
    assert trun.stats["prefill_dispatches"] < \
        serial.stats["prefill_dispatches"]
    for rid in prompts:
        np.testing.assert_array_equal(trun.outputs[rid].tokens,
                                      serial.outputs[rid].tokens, err_msg=rid)
    if paged:
        pre = teng.prefix_stats()
        assert pre == jrun.engine.prefix_stats()
        assert pre["dedups"] > 0 and pre["tail_hits"] > 0
        ps = teng.page_stats()
        assert ps["committed"] == 0 and ps["pinned_pages"] == 0


def test_one_prefill_dispatch_per_tick(setup):
    """A tick with three open cursors whose chunks fit the budget makes
    one fused dispatch."""
    s = setup
    v = s["cfg"].vocab_size
    eng = _tengine(s, paged=True, zero_copy=True)
    sched = ContinuousScheduler(eng, prefill_chunk=CHUNK,
                                prefill_budget=3 * CHUNK, clock=lambda: 0.0)
    for i in range(3):
        sched.submit(Request(request_id=f"r{i}", prompt=_prompt(v, 150,
                                                                100 + i),
                             max_new_tokens=6, arrival_s=0.0))
    d0 = eng.prefill_dispatches
    sched.tick()                    # admits 3, pumps one fused round
    assert sum(s_ is not None and s_.cursor is not None
               for s_ in sched.slots) == 3
    assert eng.prefill_dispatches - d0 == 1
    d1 = eng.prefill_dispatches
    sched.tick()
    assert eng.prefill_dispatches - d1 == 1
    assert sched.stats["prefill_dispatches"] == 2
    assert sched.stats["prefill_tokens"] == 6 * CHUNK


def test_dedupe_concurrent_cold_admissions(setup):
    """Two cold admissions of one prompt advanced in fused rounds: every
    full block both complete collapses onto one page in both pools,
    referenced by both slots and the cache; finalise and a step run on
    the deduped tables."""
    s = setup
    bs = s["spec"].block_size
    prompt = _prompt(s["cfg"].vocab_size, 4 * bs + 8, 21)
    eng = _tengine(s, paged=True, zero_copy=True)
    st = eng.empty_state()
    st, c0 = _begin(eng, st, 0, prompt)
    st, c1 = _begin(eng, st, 1, prompt)
    assert c1.off == 0
    curs = [c0, c1]
    while any(not c.done for c in curs):
        st, _ = eng.prefill_step_fused(st, curs)
    assert eng.prefix_stats()["dedups"] == 4
    al, dal = eng._page_alloc, eng._draft_alloc
    for j in range(4):
        assert al.page_at(0, j) == al.page_at(1, j)
        assert al.refcount(al.page_at(0, j)) == 3    # 2 slots + cache
        assert dal.page_at(0, j) == dal.page_at(1, j)
        assert c0.pt_host[j] == c1.pt_host[j]
        assert int(c1.row_cache["page_table"][0, j]) == al.page_at(1, j)
        assert int(c1.row_dcache["page_table"][0, j]) == dal.page_at(1, j)
    assert al.in_use == al.count(0) + al.count(1) - 4
    for c in curs:
        st, _ = eng.prefill_finalize_slot(st, c)
    active = np.array([True, True, False])
    st, so = eng.step_fused(st, active, eng.modes_for_rows(st, active))
    assert np.array_equal(so.tokens[0], so.tokens[1])


# ---------------------------------------------------------------------------
# contiguous rows past max_len (a trap of the reference)
# ---------------------------------------------------------------------------

def test_contiguous_fused_past_max_len(setup):
    """max_len 250 (chunk 32, block 16): row a's last chunk [224, 240)
    runs padded to 32 beside row b's full chunk [64, 96), so a's padded
    row would end at 256 > 250.  The port's fused round equals its serial
    steps and the reference's serial steps; the reference's fused round
    clamps a's write start to 250 - 32 and so shifts a's real tokens
    (logits off by far more than the tolerance)."""
    s = setup
    v = s["cfg"].vocab_size
    pa, pb = _prompt(v, 240, 60), _prompt(v, 100, 61)
    out = {}
    for name, mk in (("jax", _jengine), ("port", _tengine)):
        for fused in (False, True):
            eng = mk(s, batch=2, max_len=250)
            st = eng.empty_state()
            st, a = _begin(eng, st, 0, pa)
            while a.off < 224:
                st, _ = eng.prefill_step_into_slot(st, a)
            st, b = _begin(eng, st, 1, pb)
            while b.off < 64:
                st, _ = eng.prefill_step_into_slot(st, b)
            if fused:
                st, _ = eng.prefill_step_fused(st, [a, b])
            else:
                st, _ = eng.prefill_step_into_slot(st, a)
                st, _ = eng.prefill_step_into_slot(st, b)
            out[name, fused] = (a, _cursor_rows(eng, st, a, False), b)
    ta, ra, _ = out["port", True]
    sa, rs, _ = out["port", False]
    ja, rj, jb = out["jax", False]
    # two rows against one: the CPU's GEMMs may round differently
    _close(ta.logits_last, sa.logits_last, TOL_OUT, "fused vs serial")
    for m in ("k", "v", "kmax", "kmin"):
        _close_kv(ra[m], rs[m], m)
    for m in ("dk", "dv"):
        _close(ra[m], rs[m], TOL_OUT, m)
    _close(ta.logits_last, ja.logits_last, TOL_OUT, "logits")
    _close(ta.prev_feat, ja.prev_feat, TOL_OUT, "prev_feat")
    for m in ("k", "v", "kmax", "kmin"):
        _close_kv(ra[m], rj[m], m)
    for m in ("dk", "dv"):
        _close(ra[m], rj[m], TOL_OUT, m)
    _close(out["port", True][2].prev_feat, jb.prev_feat, TOL_OUT, "row b")
    fa = out["jax", True][0]
    assert np.abs(_np(fa.logits_last) - _np(ja.logits_last)).max() > 1e-2


def test_serving_config_defaults_equal_reference():
    want = {f.name: f.default for f in dataclasses.fields(JServingConfig)}
    got = {f.name: f.default for f in dataclasses.fields(ServingConfig)}
    assert got == want
    assert ServingConfig().fused_prefill is True
