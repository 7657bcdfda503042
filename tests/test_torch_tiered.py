"""Tiered KV residency of the PyTorch port against the JAX package, on the
CPU: ``tiny-dense`` in fp32 with weights converted from the JAX
parameters, the conftest ``small_spec`` (``use_pallas=True``, partial
budget 112) and ``small_dcfg``, ``max_len`` 320, prefill chunk 64.

* The codecs: ``quantize_kv`` / ``quantize_kv_fp8`` payloads byte for
  byte and their bf16 scales bit for bit, and ``dequantize_kv`` in fp32
  and bf16, equal JAX's (all-zero rows and tiny values included).
* ``PageAllocator``'s residency half: one seeded sequence of alloc,
  demote, promote, free and fork gives the reference's pages, hosted
  sets and exceptions.
* ``TierManager`` on a random pool: the host bytes of a demotion equal
  the reference's (lossless: the raw bytes), the pools after promotion
  are bit-equal to the reference's (lossless: to the pool before), and
  the counters and the traffic bill equal its own.
* ``SpecPVEngine(paged=True, tiered=True)``: tokens, modes and
  ``tier_stats`` of ``generate`` equal the JAX tiered engine's for every
  codec below and above the partial budget (lossless also the port's
  untiered tokens), through a whole cycle with a prefetch hit and a
  forced early refresh that promotes synchronously.
* Serving: tiered admission under memory pressure, blocking and
  interleaved, gives each request's solo ``generate`` and the JAX
  scheduler's stalls and deferrals; ``tier_ready_rows``' force
  semantics; zero-copy tiering gives the gathered tokens and demotes
  what the reference demotes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import SpecPVEngine as JEngine
from repro.core.draft import init_draft_params as j_init_draft
from repro.kvcache import quant as jquant
from repro.kvcache.cache import PageAllocator as JAllocator
from repro.kvcache.offload import TierManager as JTier
from repro.kvcache.offload import TrafficMeter as JTraffic
from repro.models import api as japi
from repro.serving import Request as JRequest
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.engine import MODE_PARTIAL, MODE_REFRESH
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.kvcache import quant as tquant
from repro_torch.kvcache.cache import PageAllocator as TAllocator
from repro_torch.kvcache.offload import TierManager as TTier
from repro_torch.kvcache.offload import TrafficMeter as TTraffic
from repro_torch.serving import ContinuousScheduler, Request
from repro_torch.serving.scheduler import trim_output

pytestmark = [pytest.mark.tiered, pytest.mark.paged]

MAX_LEN, CHUNK, NEW = 320, 64, 24
# name -> (tier_lossless, tier_codec)
CODECS = {"lossless": (True, "int8"), "int8": (False, "int8"),
          "fp8": (False, "fp8")}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def _bits(a) -> np.ndarray:
    """The raw bytes of a JAX array or a torch tensor, as uint8."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.asarray(a).view(np.uint8).reshape(-1)


@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codecs_bit_equal_to_jax(codec, dtype):
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(3, 5, 4, 64))
         * np.exp(3 * rng.normal(size=(3, 5, 4, 1)))).astype(np.float32)
    x[0, 0] = 0.0                          # all-zero rows: exact zeros
    x[0, 1] = 1e-9                         # below the 1e-8 scale floor
    x[1, 2, 0, :7] = 3e-38                 # tiny entries in a real row
    x[2, 3, 1] = rng.normal(size=64) * 1e-30
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = (jquant.quantize_kv_fp8 if codec == "fp8"
              else jquant.quantize_kv)(jx)
    tq, ts = (tquant.quantize_kv_fp8 if codec == "fp8"
              else tquant.quantize_kv)(tx)
    assert tq.dtype == (torch.float8_e4m3fn if codec == "fp8"
                        else torch.int8)
    assert ts.dtype == torch.bfloat16 and tq.shape == tx.shape
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            _bits(tquant.dequantize_kv(tq, ts, tdt)),
            _bits(jquant.dequantize_kv(jq, js, dtype=jdt)))
    # all-zero rows round-trip exactly
    z = tquant.dequantize_kv(tq[0, 0], ts[0, 0])
    assert not bool(z.any())


# ---------------------------------------------------------------------------
# the allocator's residency half
# ---------------------------------------------------------------------------

def _outcome(fn):
    """(result, exception type) of ``fn``."""
    try:
        return fn(), None
    except (AssertionError, RuntimeError) as e:
        return None, type(e)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_tiers_follow_reference(seed):
    rng = np.random.default_rng(seed)
    ja, ta = JAllocator(14), TAllocator(14)
    raised = set()
    for _ in range(160):
        op = rng.choice(["alloc", "demote", "promote", "free", "fork"],
                        p=[0.3, 0.3, 0.2, 0.1, 0.1])
        slot = int(rng.integers(0, 3))
        if op == "alloc":
            n = int(rng.integers(1, 5))
            calls = (lambda: ja.alloc(slot, n).tolist(),
                     lambda: ta.alloc(slot, n).tolist())
        elif op == "demote":
            j = int(rng.integers(0, 6))
            calls = (lambda: ja.demote(slot, j), lambda: ta.demote(slot, j))
            assert ta.demotable(slot, j) == ja.demotable(slot, j)
        elif op == "promote":
            hosted = ja.hosted_blocks(slot)
            j = (hosted[int(rng.integers(0, len(hosted)))]
                 if hosted and rng.random() < 0.8 else int(rng.integers(0, 6)))
            calls = (lambda: ja.promote(slot, j),
                     lambda: ta.promote(slot, j))
        elif op == "free":
            calls = (lambda: sorted(ja.free_slot(slot)),
                     lambda: sorted(ta.free_slot(slot)))
        else:
            dst = (slot + 1) % 3
            if rng.random() < 0.5:
                ja.free_slot(dst)
                ta.free_slot(dst)
            calls = (lambda: ja.fork(slot, dst), lambda: ta.fork(slot, dst))
        (jr, je), (tr, te) = _outcome(calls[0]), _outcome(calls[1])
        assert te == je, (op, slot)
        assert tr == jr, (op, slot)
        if je is not None:
            raised.add((op, je.__name__))
        for s in range(3):
            assert ta.pages_of(s) == ja.pages_of(s)
            assert ta.hosted_blocks(s) == ja.hosted_blocks(s)
            assert ta.hosted_count(s) == ja.hosted_count(s)
        for name in ("free", "in_use", "committed", "high_water",
                     "hosted_total"):
            assert getattr(ta, name) == getattr(ja, name), name
        assert ta.max_hosted() == ja.max_hosted()
    # the sequence reached the refusals it is meant to compare
    assert {op for op, _ in raised} >= {"demote", "promote"}


def test_shared_pinned_and_cached_pages_stay():
    for al in (JAllocator(10), TAllocator(10)):
        al.alloc(0, 4)
        al.fork(0, 1)
        assert not al.demotable(0, 0) and not al.demotable(1, 3)
        al.free_slot(1)
        al.pin_slot_pages(0, [al.page_at(0, 1)])
        al.add_ref([al.page_at(0, 2)], cache=True)
        assert [al.demotable(0, j) for j in range(5)] == \
            [True, False, False, True, False]
        al.demote(0, 0)
        with pytest.raises(AssertionError):
            al.fork(0, 2)                   # hosted blocks: promote first
        assert al.hosted_count(0) == 1 and al.max_hosted() == 1
        al.free_slot(0)                     # forgives the debt
        assert al.hosted_total == 0


# ---------------------------------------------------------------------------
# TierManager on a random pool
# ---------------------------------------------------------------------------

L, NP, BS, HK, DH = 2, 12, 4, 2, 8


def _pools(seed, dtype):
    rng = np.random.default_rng(seed)
    kv = [rng.normal(size=(L, NP, BS, HK, DH)).astype(np.float32)
          for _ in range(2)]
    sm = [rng.normal(size=(L, NP, HK, DH)).astype(np.float32)
          for _ in range(2)]
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    jc = {"k": jnp.asarray(kv[0].astype(npdt)),
          "v": jnp.asarray(kv[1].astype(npdt)),
          "kmax": jnp.asarray(sm[0]), "kmin": jnp.asarray(sm[1]),
          "page_table": jnp.zeros((2, 6), jnp.int32)}
    tc = {n: torch.from_numpy(np.array(a.astype(jnp.float32))
                              if n in ("k", "v") else np.array(a))
          for n, a in jc.items()}
    for n in ("k", "v"):
        tc[n] = tc[n].to(getattr(torch, dtype))
    return jc, tc


def _jnp_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8).reshape(-1)


def _seat(al, jc, tc, slot, n):
    pages = al[0].alloc(slot, n)
    assert al[1].alloc(slot, n).tolist() == pages.tolist()
    base = al[0].count(slot) - n
    jc["page_table"] = jc["page_table"].at[
        slot, base: base + n].set(jnp.asarray(pages, jnp.int32))
    tc["page_table"][slot, base: base + n] = torch.from_numpy(pages)
    return jc


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tier_manager_matches_reference(codec, dtype):
    lossless, name = CODECS[codec]
    jc, tc = _pools(3, dtype)
    jal, tal = JAllocator(NP), TAllocator(NP)
    jt = JTier(jal, lossless=lossless, codec=name, traffic=JTraffic())
    tt = TTier(tal, lossless=lossless, codec=name, traffic=TTraffic())
    jc = _seat((jal, tal), jc, tc, 0, 5)
    jc = _seat((jal, tal), jc, tc, 1, 2)
    before = {n: tc[n].clone() for n in ("k", "v", "kmax", "kmin")}
    old_pt = tc["page_table"].clone()
    # four complete blocks below a length inside the fifth
    jc = jt.demote_slot(jc, 0, length=4 * BS + 1)
    assert tt.demote_slot(tc, 0, length=4 * BS + 1) is tc
    assert tc["page_table"][0, :4].tolist() == [0] * 4
    (jseg,), (tseg,) = jt._host[0], tt._host[0]
    jarr = (jseg.k, jseg.v, jseg.ks, jseg.vs, jseg.kmax, jseg.kmin)
    for ja, ta in zip(jarr, tseg.arrays):
        assert (ja is None) == (ta is None)
        if ja is not None:
            np.testing.assert_array_equal(_bits(ta), _jnp_bits(ja))
    assert tt.stats() == jt.stats()
    # the recycled pages go to slot 1, so the promotion seats others
    jc = _seat((jal, tal), jc, tc, 1, 3)
    jt.prefetch_slot(0)
    tt.prefetch_slot(0)
    tt.prefetch_slot(0)                     # idempotent
    jc = jt.promote_slot(jc, 0)
    tt.promote_slot(tc, 0)
    assert tt.stats() == jt.stats()
    assert tt.stats()["tier_prefetch_hits"] == 1
    for n in ("k", "v", "kmax", "kmin", "page_table"):
        np.testing.assert_array_equal(_bits(tc[n]), _jnp_bits(jc[n]))
    pt = tc["page_table"][0, :5].long()
    assert bool((pt != old_pt[0, :5].long())[:4].any())
    for n in ("kmax", "kmin") + (("k", "v") if lossless else ()):
        assert torch.equal(tc[n][:, pt], before[n][:, old_pt[0, :5].long()])
    # again, promoted without a prefetch (the early-refresh path)
    jc = jt.demote_slot(jc, 0, length=5 * BS)
    tt.demote_slot(tc, 0, length=5 * BS)
    jc = jt.promote_slot(jc, 0)
    tt.promote_slot(tc, 0)
    assert tt.stats() == jt.stats()
    assert tt.stats()["tier_sync_promotes"] == 1
    for n in ("k", "v", "kmax", "kmin", "page_table"):
        np.testing.assert_array_equal(_bits(tc[n]), _jnp_bits(jc[n]))
    assert tt.traffic.bytes_by_mode == jt.traffic.bytes_by_mode
    assert tt.traffic.steps_by_mode == jt.traffic.steps_by_mode
    assert tt.traffic.modelled_time_s(25.0) == \
        jt.traffic.modelled_time_s(25.0)
    assert tt.host_bytes == 0 and tt.traffic.bytes_by_mode["demote"] \
        == tt.traffic.bytes_by_mode["promote"]


def test_tier_drop_slot_and_codec_check():
    _, tc = _pools(4, "float32")
    tal = TAllocator(NP)
    tt = TTier(tal, codec="fp8")
    tc["page_table"][0, :3] = torch.from_numpy(tal.alloc(0, 3))
    tt.demote_slot(tc, 0, length=3 * BS)
    tt.prefetch_slot(0)
    assert tt.host_bytes > 0 and tt.hosted(0) == 3
    tt.drop_slot(0)
    assert tt.host_bytes == 0 and tt.host_bytes_peak > 0
    assert tt.promote_slot(tc, 0) is tc     # nothing left to promote
    tal.free_slot(0)
    assert tal.hosted_total == 0 and tal.in_use == 0
    with pytest.raises(ValueError, match="codec"):
        TTier(tal, codec="int4")
    with pytest.raises(AssertionError):
        JTier(JAllocator(NP), codec="int4")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

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


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n,)).astype(np.int32)


def _tengine(s, batch=1, **kw):
    return TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                   batch=batch, max_len=MAX_LEN, paged=True, device="cpu",
                   **kw)


def _tiered(codec):
    lossless, name = CODECS[codec]
    return dict(tiered=True, tier_lossless=lossless, tier_codec=name)


@pytest.fixture(scope="module")
def jax_tiered(setup):
    """One JAX tiered engine (paged, gathered); ``_retier`` gives it a
    fresh ``TierManager`` and traffic meter per codec, so its steps
    compile once."""
    s = setup
    return JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                   batch=1, max_len=MAX_LEN, partial_verification=True,
                   paged=True, tiered=True, tier_lossless=True)


def _retier(je, codec):
    lossless, name = CODECS[codec]
    je.traffic = JTraffic()
    je._tier = JTier(je._page_alloc, lossless=lossless, codec=name,
                     traffic=je.traffic)
    return je


@pytest.fixture(scope="module")
def untiered(setup):
    """The port's untiered paged tokens by (prompt length, seed, new)."""
    eng = _tengine(setup)
    memo = {}

    def run(n, seed, new):
        if (n, seed, new) not in memo:
            p = _prompt(setup["cfg"], n, seed)[None]
            memo[(n, seed, new)] = eng.generate(p, new,
                                                prefill_chunk=CHUNK)[0]
        return memo[(n, seed, new)]
    return run


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("ctx", [48, 160])
def test_generate_matches_jax_tiered(setup, jax_tiered, untiered, codec, ctx):
    s = setup
    prompt = _prompt(s["cfg"], ctx, 400 + ctx)[None]
    je = _retier(jax_tiered, codec)
    jt, js = je.generate(prompt, NEW, prefill_chunk=CHUNK)
    te = _tengine(s, **_tiered(codec))
    assert te.tiered and te.page_stats()["tier_demoted_pages"] == 0
    tt, ts = te.generate(prompt, NEW, prefill_chunk=CHUNK)
    np.testing.assert_array_equal(tt, jt)
    assert ts["modes"] == js["modes"]
    assert te.tier_stats() == je.tier_stats()
    assert (te.tier_stats()["tier_demoted_pages"] > 0) == (ctx > 112)
    assert te.traffic.bytes_by_mode == je.traffic.bytes_by_mode
    if codec == "lossless":
        np.testing.assert_array_equal(tt, untiered(ctx, 400 + ctx, NEW))


@pytest.mark.parametrize("codec", ["lossless", "int8"])
def test_full_cycle_prefetch_hit(setup, jax_tiered, untiered, codec):
    """Two refreshes: a demotion after the first, a prefetch one
    transition ahead of the second, which promotes without a copy."""
    s = setup
    prompt = _prompt(s["cfg"], 160, 500)[None]
    je = _retier(jax_tiered, codec)
    jt, _ = je.generate(prompt, 80, prefill_chunk=CHUNK)
    te = _tengine(s, **_tiered(codec))
    tt, ts = te.generate(prompt, 80, prefill_chunk=CHUNK)
    np.testing.assert_array_equal(tt, jt)
    stats = te.tier_stats()
    assert stats == je.tier_stats()
    assert ts["modes"]["refresh"] >= 2
    assert stats["tier_prefetch_hits"] >= 1 and stats["tier_sync_promotes"] == 0
    assert stats["tier_promoted_pages"] > 0
    if codec == "lossless":
        np.testing.assert_array_equal(tt, untiered(160, 500, 80))
    # the host mirrors the epilogue reads give the cache's length
    assert (te._host_seq_len - te._host_pending_len).tolist() == \
        te.final_state.cache["length"].tolist()


@pytest.mark.parametrize("codec", ["lossless", "fp8"])
def test_forced_early_refresh_promotes_synchronously(setup, jax_tiered,
                                                     codec):
    s = setup
    prompt = _prompt(s["cfg"], 160, 600)[None]
    je = _retier(jax_tiered, codec)
    te = _tengine(s, **_tiered(codec))
    ue = _tengine(s)
    jst = je.prefill(prompt, chunk=CHUNK)
    tst = te.prefill(prompt, chunk=CHUNK)
    ust = ue.prefill(prompt, chunk=CHUNK)
    for mode in ("refresh", "refresh", "partial", "refresh"):
        jst, jo = je.step(jst, mode)
        tst, to = te.step(tst, mode)
        ust, uo = ue.step(ust, mode)
        np.testing.assert_array_equal(to.tokens, jo.tokens)
        np.testing.assert_array_equal(to.counts, jo.counts)
        if codec == "lossless":
            np.testing.assert_array_equal(to.tokens, uo.tokens)
        assert te.tier_stats() == je.tier_stats()
    assert te.tier_stats()["tier_sync_promotes"] == 2


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _pressure_pages(eng):
    """One slot's whole bill plus a second slot's hot part and 3 pages
    (and the null page): the second request fits only once the first has
    demoted.  The draft pool, never tiered, keeps its full size."""
    need = eng.pages_needed(160, NEW)
    cold = 160 // eng.spec.block_size
    cap = need + (need - cold) + 3
    assert cap < 2 * need
    return dict(num_pages=cap + 1,
                num_draft_pages=eng.batch * eng._nb_seq + 1)


@pytest.fixture(scope="module")
def jax_serving(setup):
    """The JAX tiered lossless engine under memory pressure, batch 2 (a
    scheduler boots it empty, so both runs share its compiled steps)."""
    s = setup
    pages = _pressure_pages(_tengine(s, batch=2))
    return pages, JEngine(
        s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"], batch=2,
        max_len=MAX_LEN, partial_verification=True, paged=True,
        prefix_cache=False, tiered=True, tier_lossless=True, **pages)


@pytest.mark.parametrize("budget", [None, 64], ids=["blocking", "interleaved"])
def test_tiered_admission_under_pressure(setup, jax_serving, untiered,
                                         budget):
    s = setup
    pages, je = jax_serving
    je._tier = JTier(je._page_alloc, lossless=True, traffic=je.traffic)
    prompts = [_prompt(s["cfg"], 160, 800 + i) for i in range(2)]
    js = JScheduler(je, prefill_chunk=CHUNK, prefill_budget=budget,
                    clock=lambda: 0.0)
    te = _tengine(s, batch=2, prefix_cache=False, **pages,
                  **_tiered("lossless"))
    ts = ContinuousScheduler(te, prefill_chunk=CHUNK, prefill_budget=budget,
                             clock=lambda: 0.0)
    for i, p in enumerate(prompts):
        js.submit(JRequest(request_id=f"t{i}", prompt=p, max_new_tokens=NEW,
                           arrival_s=0.0))
        ts.submit(Request(request_id=f"t{i}", prompt=p, max_new_tokens=NEW,
                          arrival_s=0.0))
    js.run()
    ts.run()
    for i in range(2):
        out = ts.outputs[f"t{i}"]
        assert out.finished
        np.testing.assert_array_equal(out.tokens, js.outputs[f"t{i}"].tokens)
        solo = untiered(160, 800 + i, NEW)[0]
        np.testing.assert_array_equal(
            out.tokens, trim_output([int(x) for x in solo], NEW, -1))
    for k in ("page_stalls", "tier_defers", "peak_active", "steps",
              "admissions"):
        assert ts.stats.get(k, 0) == js.stats.get(k, 0), k
    # the second request waited for the first's demotion, then both ran
    assert ts.stats["page_stalls"] > 0 and ts.stats["peak_active"] == 2
    assert te.tier_stats() == je.tier_stats()
    assert te.tier_stats()["tier_demoted_pages"] > 0
    al = te._page_alloc
    assert al.high_water <= pages["num_pages"] - 1 and al.in_use == 0
    assert al.hosted_total == 0 and te._tier.host_bytes == 0


def test_tier_ready_rows_force_semantics(setup):
    te = _tengine(setup, batch=2, prefix_cache=False, **_tiered("int8"))
    al = TAllocator(8)                      # 7 usable pages
    te._page_alloc = te._tier.alloc = al
    al.alloc(0, 4)
    for j in range(4):                      # slot 0 owes 4 pages ...
        al.demote(0, j)
    al.alloc(1, al.free)                    # ... and nothing is free
    rows = np.array([True, False])
    modes = np.array([MODE_REFRESH, MODE_PARTIAL], np.int8)
    kept, deferred = te.tier_ready_rows(rows, modes, force=False)
    assert not kept.any() and deferred == 1
    kept, deferred = te.tier_ready_rows(rows, modes, force=True)
    assert kept[0] and deferred == 0        # the smallest debt steps
    kept, deferred = te.tier_ready_rows(      # a partial row never defers
        np.array([False, True]),
        np.array([MODE_PARTIAL, MODE_PARTIAL], np.int8), force=False)
    assert kept[1] and deferred == 0
    # the admission margin: the worst live debt, less what a long prompt
    # repays at its first refresh
    assert te.tier_admit_margin(48) == 4
    assert te.tier_admit_margin(160) == 0
    untiered = _tengine(setup, batch=2)
    assert untiered.tier_admit_margin(48) == 0
    assert untiered.tier_ready_rows(rows, modes) == (rows, 0)


def test_zero_copy_tiering_demotes_what_the_reference_does(setup):
    """Zero-copy pins the union of the blocks every layer and KV head
    selected at each refresh; on tiny-dense (4 layers x 2 KV heads, 4
    retrieved blocks each besides sink and local) that union covers every
    complete block, so nothing is demotable: the reference demotes 0
    pages on this trace, and so must the port, with the gathered
    tiered engine's tokens."""
    s = setup
    prompt = _prompt(s["cfg"], 160, 500)[None]
    je = JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                 batch=1, max_len=MAX_LEN, partial_verification=True,
                 paged=True, zero_copy=True, tiered=True, tier_lossless=True)
    jt, _ = je.generate(prompt, 80, prefill_chunk=CHUNK)
    zc = _tengine(s, zero_copy=True, **_tiered("lossless"))
    gathered = _tengine(s, **_tiered("lossless"))
    tt, _ = zc.generate(prompt, 80, prefill_chunk=CHUNK)
    gt, _ = gathered.generate(prompt, 80, prefill_chunk=CHUNK)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tt, gt)
    assert zc.tier_stats() == je.tier_stats()
    assert zc.tier_stats()["tier_demoted_pages"] == 0
    assert gathered.tier_stats()["tier_demoted_pages"] > 0
    assert zc.page_stats()["pinned_pages"] > 0
