"""Copy-on-write prefix sharing of the PyTorch port against the JAX package,
on the CPU: ``tiny-dense`` in fp32 with weights converted from the JAX
parameters, the conftest ``small_spec`` (block 16, ``use_pallas=True``) and
``small_dcfg``, ``max_len`` 512, prefill chunk 64.  Both sides are built
with ``prefix_cache=True``.

* ``PageAllocator``: a hypothesis sequence of alloc, fork, cow_write,
  attach, rebind_block, cache references, pins and frees applied to the
  reference's allocator and the port's gives equal return values,
  refcounts, cache references, free lists, ``idle``, ``committed`` and the
  high-water marks; double frees and underflows raise.
* ``PrefixCache``: a hypothesis sequence of chain registrations (match,
  attach, insert, tail entries), frees, LRU evictions and lookups gives
  equal entries, ticks, stats and pages; ``save_state`` / ``load_state``
  round trips equal, a corrupted chain re-verifies the same way.
* The continuous scheduler on a trace of two shared system prompts, a
  repeated prompt and unique tails, blocking and interleaved
  (``prefill_budget``), on one 36-page pool: each request's tokens, the
  admit/finish trace, the step, stall and eviction counters,
  ``prefix_stats()`` and ``page_stats()`` equal the JAX scheduler's (the
  blocking run has a tail-entry hit, the interleaved one dedups), and each
  request equals its solo ``generate`` and its tokens with sharing off.
* Tail-entry admission, admission rollback on a shortfall, fork isolation
  (the fork's pages keep their bytes while the source steps; both engines
  give the same tokens and page tables) and the prefix snapshot round trip.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as hst

import repro.configs as jcfgs
from repro.core import SpecPVEngine as JEngine
from repro.core.draft import init_draft_params as j_init_draft
from repro.kvcache.cache import PageAllocator as JAllocator
from repro.kvcache.cache import PrefixCache as JPrefixCache
from repro.models import api as japi
from repro.serving import Request as JRequest
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.kvcache.cache import PageAllocator as TAllocator
from repro_torch.kvcache.cache import PrefixCache as TPrefixCache
from repro_torch.serving import ContinuousScheduler, Request

pytestmark = [pytest.mark.serving, pytest.mark.paged, pytest.mark.prefix]

B, MAX_LEN, CHUNK, NEW = 3, 512, 64, 12
# 35 allocatable pages: blocking admission evicts idle prefixes and keeps
# the repeated prompt's tail entry; interleaved admission also stalls
POOL = 36
STAT_KEYS = ("steps", "page_stalls", "admissions", "prefix_evictions",
             "mode_rows_full", "mode_rows_refresh", "mode_rows_partial",
             "ticks_modes_1", "ticks_modes_2", "ticks_modes_3",
             "prefill_dispatches", "prefill_tokens")
PAGE_KEYS = ("in_use", "idle", "committed", "high_water",
             "resident_high_water", "draft_in_use", "draft_high_water",
             "pinned_pages")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation."""
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
    v = cfg.vocab_size
    # two 6-block system prompts; a..d and f add their own tails, e
    # repeats a (a tail-entry hit while the entry survives)
    sys0, sys1 = _prompt(v, 96, 20), _prompt(v, 96, 21)
    prompts = {"a": np.concatenate([sys0, _prompt(v, 37, 30)]),
               "b": np.concatenate([sys0, _prompt(v, 53, 31)]),
               "c": np.concatenate([sys1, _prompt(v, 21, 32)]),
               "d": np.concatenate([sys1, _prompt(v, 45, 33)])}
    prompts["e"] = prompts["a"].copy()
    prompts["f"] = np.concatenate([sys0, _prompt(v, 29, 34)])
    return dict(cfg=cfg, tcfg=tcfg, spec=spec, tspec=tspec, dcfg=small_dcfg,
                tdcfg=tdcfg, params=params, dparams=dparams, tp=tp, td=td,
                prompts=prompts)


def _jengine(s, **kw):
    kw.setdefault("batch", B)
    return JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                   max_len=MAX_LEN, partial_verification=True, paged=True,
                   zero_copy=True, prefix_cache=True, **kw)


def _tengine(s, **kw):
    kw.setdefault("batch", B)
    kw.setdefault("paged", True)
    kw.setdefault("zero_copy", True)
    return TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                   max_len=MAX_LEN, device="cpu", **kw)


def _drive(sched, cls, prompts):
    for rid, p in prompts.items():
        sched.submit(cls(request_id=rid, prompt=p, max_new_tokens=NEW,
                         arrival_s=0.0))
    while sched.has_work():
        sched.tick()
    return sched


def _run(sched, cls, prompts):
    """Drive a scheduler on a frozen clock, then record what it left and
    reset its engine's pool (``empty_state``)."""
    _drive(sched, cls, prompts)
    eng = sched.engine
    out = dict(tokens={r: np.asarray(sched.outputs[r].tokens)
                       for r in prompts},
               trace=list(sched.trace), stats=dict(sched.stats),
               prefix=eng.prefix_stats(), pages=eng.page_stats())
    eng.empty_state()
    out["pages_reset"] = eng.page_stats()
    eng.reset_prefix_stats()
    eng.reset_high_water()
    return out


BUDGETS = {"blocking": None, "interleaved": CHUNK}


@pytest.fixture(scope="module")
def jax_runs(setup):
    je = _jengine(setup, num_pages=POOL)
    runs = {name: _run(JScheduler(je, prefill_chunk=CHUNK,
                                  prefill_budget=budget, fused=True,
                                  fused_prefill=False, clock=lambda: 0.0),
                       JRequest, setup["prompts"])
            for name, budget in BUDGETS.items()}
    runs["engine"] = je
    return runs


@pytest.fixture(scope="module")
def port_runs(setup):
    te = _tengine(setup, num_pages=POOL)
    runs = {name: _run(ContinuousScheduler(te, prefill_chunk=CHUNK,
                                           prefill_budget=budget,
                                           fused_prefill=False,
                                           clock=lambda: 0.0),
                       Request, setup["prompts"])
            for name, budget in BUDGETS.items()}
    runs["engine"] = te
    return runs


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------

def _assert_alloc_equal(ta, ja, slots):
    np.testing.assert_array_equal(ta._ref, ja._ref)
    np.testing.assert_array_equal(ta._cache_ref, ja._cache_ref)
    np.testing.assert_array_equal(ta._pin_ref, ja._pin_ref)
    assert ta._free_by == ja._free_by
    for name in ("free", "in_use", "idle", "committed", "high_water",
                 "resident_high_water", "pinned_pages"):
        assert getattr(ta, name) == getattr(ja, name), name
    for s in slots:
        assert ta.pages_of(s) == [int(p) for p in ja.pages_of(s)]
        assert ta.slot_holds_shared(s) == ja.slot_holds_shared(s)
        assert sorted(ta.pins_of(s)) == sorted(int(p) for p in ja.pins_of(s))


_OP = hst.one_of(
    hst.tuples(hst.just("alloc"), hst.integers(0, 3), hst.integers(0, 4)),
    hst.tuples(hst.just("fork"), hst.integers(0, 3), hst.integers(0, 3)),
    hst.tuples(hst.just("cow"), hst.integers(0, 3), hst.integers(0, 7)),
    hst.tuples(hst.just("free"), hst.integers(0, 3), hst.just(0)),
    hst.tuples(hst.just("cache_ref"), hst.integers(0, 3), hst.integers(0, 7)),
    hst.tuples(hst.just("cache_drop"), hst.just(0), hst.just(0)),
    hst.tuples(hst.just("alloc_cache"), hst.just(0), hst.integers(1, 2)),
    hst.tuples(hst.just("attach"), hst.integers(0, 3), hst.integers(0, 7)),
    hst.tuples(hst.just("rebind"), hst.integers(0, 3), hst.integers(0, 7)),
    hst.tuples(hst.just("pin"), hst.integers(0, 3), hst.integers(0, 7)),
)


@settings(max_examples=60, deadline=None)
@given(hst.integers(3, 14), hst.lists(_OP, max_size=40))
def test_allocator_ops_follow_reference(num_pages, ops):
    """Fork, copy-on-write, attach, rebind, cache references and pins on
    both allocators: equal results and equal state after every op."""
    ja, ta = JAllocator(num_pages), TAllocator(num_pages)
    cache_refs = []                     # pages with a cache reference
    for kind, slot, arg in ops:
        pages = ja.pages_of(slot)
        if kind == "alloc":
            if arg > ja.free:
                for al in (ja, ta):
                    with pytest.raises(RuntimeError, match="exhausted"):
                        al.alloc(slot, arg)
            else:
                np.testing.assert_array_equal(ta.alloc(slot, arg),
                                              ja.alloc(slot, arg))
        elif kind == "fork":
            if arg != slot and not ja.count(arg):
                assert ta.fork(slot, arg) == [int(p)
                                              for p in ja.fork(slot, arg)]
        elif kind == "cow" and pages:
            blk = arg % len(pages)
            if ja.refcount(pages[blk]) == 1 or ja.free:
                assert ta.cow_write(slot, blk) == tuple(
                    int(p) for p in ja.cow_write(slot, blk))
        elif kind == "free":
            assert ta.free_slot(slot) == [int(p) for p in ja.free_slot(slot)]
        elif kind == "cache_ref":
            owned = sorted({p for s in range(4) for p in ja.pages_of(s)})
            if owned:
                p = owned[arg % len(owned)]
                ja.add_ref([p], cache=True)
                ta.add_ref([p], cache=True)
                cache_refs.append(p)
        elif kind == "cache_drop" and cache_refs:
            p = cache_refs.pop()
            assert ta.dec_ref([p], cache=True) == ja.dec_ref([p], cache=True)
        elif kind == "alloc_cache" and arg <= ja.free:
            got = ta.alloc_cache(arg)
            assert got == [int(p) for p in ja.alloc_cache(arg)]
            cache_refs.extend(got)
        elif kind == "attach" and cache_refs:
            p = cache_refs[arg % len(cache_refs)]
            ja.attach(slot, [p])
            ta.attach(slot, [p])
        elif kind == "rebind" and pages and cache_refs:
            blk = arg % len(pages)
            p = cache_refs[arg % len(cache_refs)]
            if pages[blk] != p and ja._pin_ref[pages[blk]] == 0:
                assert ta.rebind_block(slot, blk, p) == [
                    int(x) for x in ja.rebind_block(slot, blk, p)]
        elif kind == "pin" and pages:
            pick = [pages[arg % len(pages)], pages[0]]
            ja.pin_slot_pages(slot, pick)
            ta.pin_slot_pages(slot, pick)
        _assert_alloc_equal(ta, ja, range(4))


def test_double_free_and_underflow_detected():
    al = TAllocator(6)
    a = al.alloc(0, 2)
    al.free_slot(0)
    with pytest.raises(AssertionError, match="double free|underflow"):
        al.dec_ref(list(a))
    b = al.alloc(1, 1)
    al.dec_ref(list(b))
    with pytest.raises(AssertionError):
        al.dec_ref(list(b))                 # already on the free list
    with pytest.raises(AssertionError):
        al.add_ref(list(b))                 # no reference on a free page
    c = al.alloc(2, 1)
    with pytest.raises(AssertionError):
        al.dec_ref(list(c), cache=True)     # holds no cache reference
    with pytest.raises(ValueError, match="no shard 1"):
        al.alloc_cache(1, shard=1)


# ---------------------------------------------------------------------------
# the prefix cache
# ---------------------------------------------------------------------------

BS = 4
# prompts built from a few shared block patterns, so chains overlap;
# lengths include block-aligned ones and partial tails
_BLOCKS = [np.arange(BS, dtype=np.int32) + 10 * k for k in range(4)]


def _pc_prompt(code):
    """Blocks chosen by the digits of ``code``, then a tail of
    ``code % 3`` tokens."""
    blocks = [_BLOCKS[int(d) % 4] for d in str(code)[:4]]
    tail = np.arange(code % 3, dtype=np.int32) + 100
    return np.concatenate(blocks + [tail]).astype(np.int32)


class _Side:
    """One framework's cache and allocators, driven by ``_pc_op``."""

    def __init__(self, alloc_cls, cache_cls, feat):
        self.al, self.dal = alloc_cls(24), alloc_cls(24)
        self.pc = cache_cls(BS)
        self.feat = feat

    def register(self, slot, prompt):
        """A cold admission's registrations: match and attach, then insert
        each new full block under one tick and register the tail."""
        al, dal, pc = self.al, self.dal, self.pc
        n_full = len(prompt) // BS
        chain = pc.match(prompt, n_full)
        al.attach(slot, [e.page for e in chain])
        dal.attach(slot, [e.draft_page for e in chain])
        need = n_full - len(chain) + 1
        if need > min(al.free, dal.free):
            pc.evict_lru(al, dal, need - min(al.free, dal.free))
        if need > min(al.free, dal.free):
            return [e.depth for e in chain]
        keys = pc.chain_keys(prompt, n_full)
        tick = pc.new_tick()
        for e in chain:
            e.tick = tick
        for j in range(len(chain), n_full):
            p, dp = int(al.alloc(slot, 1)[0]), int(dal.alloc(slot, 1)[0])
            e = pc.insert(keys[j], j, p, dp, self.feat(j), al, dal,
                          tick=tick, tokens=prompt[j * BS:(j + 1) * BS],
                          parent=keys[j - 1] if j else pc._ROOT)
            chain.append(e if e is not None else pc.entry(keys[j]))
        if len(prompt) > n_full * BS:
            p, dp = int(al.alloc(slot, 1)[0]), int(dal.alloc(slot, 1)[0])
            pc.register_tail(chain[-1].key if n_full else pc._ROOT,
                             prompt[n_full * BS:], n_full, p, dp,
                             self.feat(99), 7, al, dal)
        return [e.depth for e in chain]

    def state(self):
        ents = sorted((e.key, e.depth, e.page, e.draft_page, e.tick)
                      for e in self.pc._entries.values())
        tails = sorted((e.key, e.depth, e.tail_len, e.page, e.draft_page,
                        e.first_token, e.tick)
                       for e in self.pc._tails.values())
        return (ents, tails, self.pc.stats(), self.pc._tick,
                self.al._ref.tolist(), self.dal._ref.tolist(),
                self.al._cache_ref.tolist(), self.al.idle)


def _pc_op(side, kind, slot, arg):
    prompt = _pc_prompt(arg)
    if kind == "register":
        return side.register(slot, prompt)
    if kind == "free":
        return (side.al.free_slot(slot), side.dal.free_slot(slot))
    if kind == "evict":
        return side.pc.evict_lru(side.al, side.dal, arg % 5)
    if kind == "tail":
        hit = side.pc.match_tail(prompt)
        return None if hit is None else ([e.page for e in hit[0]],
                                         hit[1].page, hit[1].first_token)
    return [e.page for e in side.pc.match(prompt, 4, touch=False,
                                          count=False)]


_PC_OP = hst.tuples(hst.sampled_from(["register", "free", "evict", "tail",
                                      "probe"]),
                    hst.integers(0, 2), hst.integers(1, 3333))


@settings(max_examples=40, deadline=None)
@given(hst.lists(_PC_OP, max_size=30))
def test_prefix_cache_follows_reference(ops):
    j = _Side(JAllocator, JPrefixCache, lambda k: np.full((3,), k, np.float32))
    t = _Side(TAllocator, TPrefixCache, lambda k: torch.full((3,), float(k)))
    for kind, slot, arg in ops:
        assert _pc_op(t, kind, slot, arg) == _pc_op(j, kind, slot, arg)
        assert t.state() == j.state()
    for s in range(3):
        for side in (j, t):
            side.al.free_slot(s)
            side.dal.free_slot(s)
    # the snapshot round trip, with one chain corrupted on both sides
    snaps = [side.pc.save_state(lambda p, dp: {"page": p, "draft_page": dp})
             for side in (j, t)]
    for a, b in zip(*(s["entries"] for s in snaps)):
        assert (a["key"], a["parent"], a["depth"], a["tick"]) == \
            (b["key"], b["parent"], b["depth"], b["tick"])
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["feat"], b["feat"])
    if snaps[0]["entries"]:
        for s in snaps:
            s["entries"][0]["tokens"] = s["entries"][0]["tokens"] + 1
    restored = []
    for cls_a, cls_c, snap in ((JAllocator, JPrefixCache, snaps[0]),
                               (TAllocator, TPrefixCache, snaps[1])):
        al, dal, pc = cls_a(24), cls_a(24), cls_c(BS)

        def seat(d, shard, al=al, dal=dal):
            return al.alloc_cache(1, shard)[0], dal.alloc_cache(1, shard)[0]
        restored.append((pc.load_state(snap, al, dal, seat), len(pc),
                         al.idle, al.committed))
    assert restored[0] == restored[1]
    t.pc.clear(t.al, t.dal)
    assert t.al.in_use == 0 and t.dal.in_use == 0


# ---------------------------------------------------------------------------
# the scheduler against the JAX scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(BUDGETS))
def test_scheduler_matches_jax(setup, jax_runs, port_runs, name):
    j, t = jax_runs[name], port_runs[name]
    assert t["tokens"].keys() == j["tokens"].keys()
    for rid in j["tokens"]:
        np.testing.assert_array_equal(t["tokens"][rid], j["tokens"][rid],
                                      err_msg=rid)
        assert len(t["tokens"][rid]) == NEW
    assert t["trace"] == j["trace"]
    for k in STAT_KEYS:
        assert t["stats"].get(k, 0) == j["stats"].get(k, 0), k
    assert t["prefix"] == j["prefix"]
    for k in PAGE_KEYS:
        assert t["pages"][k] == j["pages"][k], k
        assert t["pages_reset"][k] == j["pages_reset"][k], k
    # what the trace is for: shared blocks matched, evictions, and (one
    # run each) a tail-entry hit, dedups and page stalls
    p = t["prefix"]
    assert p["blocks_matched"] > 0 and p["prefill_tokens_skipped"] > 0
    assert t["stats"]["prefix_evictions"] > 0
    if name == "blocking":
        assert p["tail_hits"] == 1 and p["dedups"] == 0
    else:
        assert p["dedups"] > 0 and t["stats"]["page_stalls"] > 0
    # drained: idle cached pages stay, nothing is committed or pinned;
    # the pool reset frees them
    assert t["pages"]["committed"] == 0 and t["pages"]["pinned_pages"] == 0
    assert t["pages"]["idle"] == t["pages"]["in_use"] > 0
    assert t["pages_reset"]["in_use"] == 0
    assert t["pages_reset"]["draft_in_use"] == 0


def test_requests_equal_solo_and_unshared(setup, port_runs):
    """Each shared-prefix request equals its solo ``generate`` and its
    tokens from the same trace served with sharing off."""
    off = _tengine(setup, num_pages=POOL, prefix_cache=False)
    assert off.prefix_stats() == {}
    unshared = _drive(ContinuousScheduler(off, prefill_chunk=CHUNK,
                                          clock=lambda: 0.0),
                      Request, setup["prompts"])
    solo = _tengine(setup, batch=1)
    for rid, p in setup["prompts"].items():
        want, _ = solo.generate(p[None], NEW, prefill_chunk=CHUNK)
        for name in BUDGETS:
            np.testing.assert_array_equal(port_runs[name]["tokens"][rid],
                                          want[0], err_msg=(rid, name))
        np.testing.assert_array_equal(unshared.outputs[rid].tokens, want[0])
    # sharing ran more requests at once on fewer committed pages
    assert unshared.stats.get("page_stalls", 0) > 0


# ---------------------------------------------------------------------------
# engine-level sharing
# ---------------------------------------------------------------------------

def test_tail_entry_admission(setup):
    """A prompt ending in a partial block registers a tail entry; the same
    prompt admitted again attaches the whole prompt (its tail block
    copied into a fresh page, summaries included), skips prefill and
    gives the cold tokens, while the first request's commits into its own
    copy of that block leave the cached page as registered."""
    eng = _tengine(setup, batch=2)
    bs = eng.spec.block_size
    prompt = setup["prompts"]["d"]                  # 8 blocks + 13 tokens
    n_full = len(prompt) // bs
    sched = ContinuousScheduler(eng, prefill_chunk=CHUNK, clock=lambda: 0.0)
    _drive(sched, Request, {"cold": prompt})
    ps = eng.prefix_stats()
    assert ps["tails"] == 1 and ps["tail_hits"] == 0
    (te,) = eng._prefix._tails.values()
    cached = {k: eng.state.cache[k][:, te.page].clone()
              for k in ("k", "v", "kmax", "kmin")}
    skipped = ps["prefill_tokens_skipped"]
    chunks = eng.prefill_dispatches
    assert eng.pages_needed_shared(prompt, NEW) == \
        eng.pages_needed(len(prompt), NEW) - n_full
    _drive(sched, Request, {"warm": prompt.copy()})
    ps = eng.prefix_stats()
    assert ps["tail_hits"] == 1
    assert ps["prefill_tokens_skipped"] - skipped == len(prompt)
    assert eng.prefill_dispatches == chunks          # no prefill chunk ran
    np.testing.assert_array_equal(sched.outputs["warm"].tokens,
                                  sched.outputs["cold"].tokens)
    for k, v in cached.items():
        assert torch.equal(eng.state.cache[k][:, te.page], v), k
    eng.reclaim_pages(1 << 30)
    assert eng._page_alloc.in_use == 0 and eng._draft_alloc.in_use == 0


def test_admission_shortfall_rolls_back(setup):
    """A request that matches cached blocks but cannot get its fresh
    remainder raises, with the attach rolled back and the entries kept."""
    eng = _tengine(setup, batch=1, num_pages=9)       # 8 usable pages
    st = eng.empty_state()
    al, dal, bs = eng._page_alloc, eng._draft_alloc, eng.spec.block_size
    prompt = setup["prompts"]["b"]
    pages, dpages = al.alloc(99, 4), dal.alloc(99, 4)
    feat = torch.zeros(3 * eng.cfg.d_model)
    for j, k in enumerate(eng._prefix.chain_keys(prompt, 4)):
        eng._prefix.insert(k, j, int(pages[j]), int(dpages[j]), feat, al,
                           dal)
    al.free_slot(99)
    dal.free_slot(99)
    assert al.idle == 4 and al.committed == 0
    with pytest.raises(RuntimeError, match="fresh pages"):
        eng.prefill_into_slot(st, 0, prompt, chunk=CHUNK, max_new_tokens=8)
    assert al.count(0) == 0 and dal.count(0) == 0
    assert len(eng._prefix) == 4
    assert all(al.refcount(int(p)) == 1 for p in pages)
    eng.reclaim_pages(1 << 30)
    assert al.in_use == 0 and dal.in_use == 0


def _views(eng, slot):
    """The trunk and draft bytes of `slot` up to its lengths."""
    st, bs = eng.state, eng.spec.block_size
    out = []
    for c, lead in ((st.cache, 1), (st.dcache, 0)):
        n = int(c["length"][slot])
        pages = c["page_table"][slot, : -(-n // bs)].long()
        for k in ("k", "v"):
            a = c[k][:, pages] if lead else c[k][pages]
            flat = a.shape[:lead] + (-1,) + a.shape[-2:]
            out.append(a.reshape(flat)[..., :n, :, :].clone())
    return out


def _check_mirrors(eng, rows):
    """The host mirrors give the device lengths (prepare_cow's windows)."""
    st = eng.state
    for i in np.nonzero(rows)[0]:
        assert eng._host_seq_len[i] - eng._host_pending_len[i] == \
            int(st.cache["length"][i])
        assert eng._host_seq_len[i] - eng._host_ext_len[i] == \
            int(st.dcache["length"][i])


def test_fork_isolation_matches_jax(setup, jax_runs):
    """Admit one request, step it twice and fork it into slot 1; step only
    the source (the fork's bytes stay as they were), then only the fork
    (it replays the source's tokens), then both.  Every step gives the
    JAX engine's tokens, and both end with its page tables and allocator
    state; the source's tokens equal a run with no fork, and the pre-step
    copy-on-write copied pages in both pools."""
    je = jax_runs["engine"]
    te = _tengine(setup, num_pages=POOL)
    prompt = setup["prompts"]["b"]
    jst = je.empty_state()
    tst = te.empty_state()
    jst, jf = je.prefill_into_slot(jst, 0, prompt, chunk=CHUNK,
                                   max_new_tokens=40)
    tst, tf = te.prefill_into_slot(tst, 0, prompt, chunk=CHUNK,
                                   max_new_tokens=40)
    assert jf == tf
    got = {0: [tf], 1: []}

    def step(rows):
        nonlocal jst, tst
        rows = np.asarray(rows, bool)
        jst, jo = je.step_fused(jst, rows, je.modes_for_rows(jst, rows))
        tst, to = te.step_fused(tst, rows, te.modes_for_rows(tst, rows))
        for i in np.nonzero(rows)[0]:
            np.testing.assert_array_equal(to.tokens[i, :to.counts[i]],
                                          jo.tokens[i, :jo.counts[i]])
            got[int(i)].extend(int(x) for x in to.tokens[i, :to.counts[i]])
        _check_mirrors(te, rows)

    for _ in range(2):
        step([1, 0, 0])
    jst = je.fork_slot(jst, 0, 1)
    tst = te.fork_slot(tst, 0, 1)
    assert te._page_alloc.pages_of(1) == te._page_alloc.pages_of(0)
    assert te.cow_copies == {"trunk": 0, "draft": 0}
    at_fork = len(got[0])
    before = _views(te, 1)
    for _ in range(3):
        step([1, 0, 0])
    for a, b in zip(_views(te, 1), before):
        assert torch.equal(a, b)
    assert te.cow_copies["trunk"] > 0 and te.cow_copies["draft"] > 0
    for _ in range(3):
        step([0, 1, 0])
    assert got[1] == got[0][at_fork: at_fork + len(got[1])]
    for _ in range(2):
        step([1, 1, 0])
    for al_t, al_j in ((te._page_alloc, je._page_alloc),
                       (te._draft_alloc, je._draft_alloc)):
        _assert_alloc_equal(al_t, al_j, range(B))
    np.testing.assert_array_equal(te.state.cache["page_table"].numpy(),
                                  np.asarray(jst.cache["page_table"]))
    np.testing.assert_array_equal(te.state.dcache["page_table"].numpy(),
                                  np.asarray(jst.dcache["page_table"]))
    # the source's stream equals a run with no fork
    solo = _tengine(setup, batch=1)
    want, _ = solo.generate(prompt[None], len(got[0]), prefill_chunk=CHUNK)
    assert got[0] == want[0].tolist()
    je.empty_state()
    te.empty_state()
    assert te._page_alloc.in_use == 0 and te._forked_slots == set()


def test_prepare_cow_is_a_noop_without_forks(setup):
    """No forked row: ``prepare_cow`` copies nothing and leaves the state."""
    eng = _tengine(setup, num_pages=POOL)
    st = eng.empty_state()
    st, _ = eng.prefill_into_slot(st, 0, setup["prompts"]["a"], chunk=CHUNK,
                                  max_new_tokens=NEW)
    pt = st.cache["page_table"].clone()
    assert eng.prepare_cow(st, np.array([1, 1, 1], bool)) is st
    assert torch.equal(st.cache["page_table"], pt)
    assert eng.cow_copies == {"trunk": 0, "draft": 0}


def test_copy_pool_page_copies_every_key(setup):
    """``_copy_pool_page`` moves a page's K/V and summaries bit for bit and
    touches no other page."""
    eng = _tengine(setup, num_pages=8)
    g = torch.Generator().manual_seed(0)
    for c, keys in ((eng.state.cache, ("k", "v", "kmax", "kmin")),
                    (eng.state.dcache, ("k", "v"))):
        for k in keys:
            c[k].copy_(torch.randn(c[k].shape, generator=g))
    want = {("t", k): eng.state.cache[k].clone()
            for k in ("k", "v", "kmax", "kmin")}
    want.update({("d", k): eng.state.dcache[k].clone() for k in ("k", "v")})
    eng._copy_pool_page(eng.state.cache, 3, 5, draft=False)
    eng._copy_pool_page(eng.state.dcache, 2, 6, draft=True)
    for (side, k), w in want.items():
        if side == "t":
            w[:, 5] = w[:, 3]
            assert torch.equal(eng.state.cache[k], w), k
        else:
            w[6] = w[2]
            assert torch.equal(eng.state.dcache[k], w), k


def test_prefix_snapshot_round_trip(setup, jax_runs):
    """Save the cache after a shared-prefix run, rebuild the pool, restore:
    as many entries as the JAX engine restores, idle until matched, and a
    request over the restored prefix skips its blocks and gives the cold
    tokens."""
    prompts = setup["prompts"]
    je = jax_runs["engine"]
    te = _tengine(setup, num_pages=POOL)
    counts = []
    for eng, cls, sched_cls, kw in (
            (je, JRequest, JScheduler, dict(fused_prefill=False)),
            (te, Request, ContinuousScheduler, {})):
        sched = sched_cls(eng, prefill_chunk=CHUNK, clock=lambda: 0.0, **kw)
        _drive(sched, cls, {"a": prompts["a"], "c": prompts["c"]})
        snap = eng.save_prefix_state(sched.st)
        # a fresh scheduler empties the pool and the cache
        sched2 = sched_cls(eng, prefill_chunk=CHUNK, clock=lambda: 0.0, **kw)
        assert eng.page_stats()["in_use"] == 0
        sched2.st, n = eng.restore_prefix_state(sched2.st, snap)
        counts.append((n, eng.page_stats()["idle"],
                       eng.page_stats()["committed"]))
        eng.reset_prefix_stats()
        _drive(sched2, cls, {"b": prompts["b"]})
        counts.append((eng.prefix_stats()["blocks_matched"],
                       np.asarray(sched2.outputs["b"].tokens).tolist()))
        eng.empty_state()
    assert counts[:2] == counts[2:]
    assert counts[2][0] > 0 and counts[2][2] == 0
    assert counts[3][0] == 6                  # sys0's six blocks
