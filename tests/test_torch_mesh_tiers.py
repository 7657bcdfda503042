"""The host tier of the PyTorch port under a mesh, on the CPU against the
JAX package: ``tiny-dense`` in fp32 with weights converted from the JAX
parameters, the conftest ``small_spec`` (``use_pallas=True``, partial
budget 112) and ``small_dcfg``, ``max_len`` 320, prefill chunk 64.  The
reference's own mesh engines fail under jax 0.9, so every sharded run is
held to the reference's unsharded behaviour.

* ``TierManager`` over a 2-shard ``PageAllocator`` against the
  reference's over its sharded allocator: one demote / prefetch /
  promote / drop sequence gives equal pools, page tables and ``stats()``
  key for key (the per-shard host peaks too), for int8, fp8 and
  lossless.
* A (1, 2) tiered engine (one tier over the shard-stacked pool):
  ``generate`` gives the JAX unsharded tiered engine's tokens, modes and
  ``tier_stats`` for lossless and int8 (lossless also the port's
  untiered tokens); a forced schedule with synchronous promotions gives
  them too, and its lossless pools come back bit-equal to the untiered
  (1, 2) engine's.
* (2, 1) and (2, 2) tiered serving: every request's tokens equal its
  solo ``generate``; ``tier_stats`` sums the shards and carries each
  host's peak.  Only the shard whose pool binds defers its rows, and the
  admission margin is the shard's own.
"""
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.configs as jcfgs
from repro.core import SpecPVEngine as JEngine
from repro.core.draft import init_draft_params as j_init_draft
from repro.kvcache.cache import PageAllocator as JAllocator
from repro.kvcache.offload import TierManager as JTier
from repro.kvcache.offload import TrafficMeter as JTraffic
from repro.models import api as japi
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.data_parallel import DataParallelEngine
from repro_torch.core.engine import MODE_PARTIAL, MODE_REFRESH
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.distributed.sharding import DeviceMesh
from repro_torch.distributed.tensor_parallel import merge_heads
from repro_torch.kvcache.cache import PageAllocator as TAllocator
from repro_torch.kvcache.offload import TierManager as TTier
from repro_torch.kvcache.offload import TrafficMeter as TTraffic
from repro_torch.serving import ContinuousScheduler, Request
from repro_torch.serving.scheduler import trim_output

pytestmark = [pytest.mark.tiered, pytest.mark.paged]

MAX_LEN, CHUNK, NEW = 320, 64, 24
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


def _bits(a) -> np.ndarray:
    """The raw bytes of a JAX array or a torch tensor, as uint8."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.asarray(a).view(np.uint8).reshape(-1)


def _mesh(data, model):
    return DeviceMesh((data, model), devices=["cpu"] * (data * model))


# ---------------------------------------------------------------------------
# TierManager over a sharded allocator
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


def _seat(als, jc, tc, slot, n):
    pages = als[0].alloc(slot, n)
    assert als[1].alloc(slot, n).tolist() == pages.tolist()
    base = als[0].count(slot) - n
    tc["page_table"][slot, base: base + n] = torch.from_numpy(pages)
    return dict(jc, page_table=jc["page_table"].at[
        slot, base: base + n].set(jnp.asarray(pages, jnp.int32)))


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_tier_manager_matches_reference(codec, dtype):
    """Slot s draws from shard s (pages 1-5 and 6-11): both slots demote,
    slot 1 promotes on a prefetch hit, slot 0 synchronously, slot 0
    demotes again and is dropped.  After every operation the pools, the
    page tables and ``stats()`` equal the reference's."""
    lossless, name = CODECS[codec]
    jc, tc = _pools(5, dtype)
    jal = JAllocator(NP, shards=2, slot_shard=lambda s: s)
    tal = TAllocator(NP, shards=2, slot_shard=lambda s: s)
    jt = JTier(jal, lossless=lossless, codec=name, traffic=JTraffic())
    tt = TTier(tal, lossless=lossless, codec=name, traffic=TTraffic())
    jc = _seat((jal, tal), jc, tc, 0, 4)
    jc = _seat((jal, tal), jc, tc, 1, 5)
    ops = [("demote", 0, 3 * BS + 1), ("demote", 1, 5 * BS),
           ("prefetch", 1, None), ("promote", 1, None),
           ("promote", 0, None), ("demote", 0, 4 * BS), ("drop", 0, None)]
    for op, slot, length in ops:
        if op == "demote":
            jc = jt.demote_slot(jc, slot, length)
            assert tt.demote_slot(tc, slot, length) is tc
        elif op == "prefetch":
            jt.prefetch_slot(slot)
            tt.prefetch_slot(slot)
        elif op == "promote":
            jc = jt.promote_slot(jc, slot)
            tt.promote_slot(tc, slot)
        else:
            jt.drop_slot(slot)
            tt.drop_slot(slot)
            jal.free_slot(slot)
            tal.free_slot(slot)
        for n in ("k", "v", "kmax", "kmin", "page_table"):
            np.testing.assert_array_equal(_bits(tc[n]), _bits(jc[n]),
                                          err_msg=f"{op} {slot} {n}")
        assert tt.stats() == jt.stats(), (op, slot)
    s = tt.stats()
    assert s["tier_prefetch_hits"] == 1 and s["tier_sync_promotes"] == 1
    assert s["tier_host_bytes_peak_shard_0"] > 0
    assert s["tier_host_bytes_peak_shard_1"] > 0
    assert s["tier_host_bytes_peak_per_host"] == max(
        s["tier_host_bytes_peak_shard_0"], s["tier_host_bytes_peak_shard_1"])
    assert tt.traffic.bytes_by_mode == jt.traffic.bytes_by_mode
    tt.reset()
    assert tt.host_bytes == 0 and tt.stats()["tier_host_bytes_peak"] > 0


# ---------------------------------------------------------------------------
# the engine under a model axis
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
    """One JAX unsharded tiered engine, re-tiered per codec so that its
    steps compile once."""
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
def solo(setup):
    """The port's untiered unsharded tokens by (prompt length, seed,
    new)."""
    eng = _tengine(setup)
    memo = {}

    def run(n, seed, new):
        if (n, seed, new) not in memo:
            p = _prompt(setup["cfg"], n, seed)[None]
            memo[(n, seed, new)] = eng.generate(p, new,
                                                prefill_chunk=CHUNK)[0]
        return memo[(n, seed, new)]
    return run


@pytest.mark.parametrize("codec", ["lossless", "int8"])
def test_model_axis_generate_matches_jax_tiered(setup, jax_tiered, solo,
                                                codec):
    """160 tokens and 80 new: two refreshes, a demotion after the first
    and a prefetch hit ahead of the second."""
    s = setup
    prompt = _prompt(s["cfg"], 160, 500)[None]
    je = _retier(jax_tiered, codec)
    jt, js = je.generate(prompt, 80, prefill_chunk=CHUNK)
    te = _tengine(s, mesh=_mesh(1, 2), **_tiered(codec))
    assert te.tp.m == 2 and te.kv_shards == 2 and te.tiered
    tt, ts = te.generate(prompt, 80, prefill_chunk=CHUNK)
    np.testing.assert_array_equal(tt, jt)
    assert ts["modes"] == js["modes"]
    stats = te.tier_stats()
    assert stats == je.tier_stats()
    assert stats["tier_prefetch_hits"] >= 1 and stats["tier_promoted_pages"]
    assert te.traffic.bytes_by_mode == je.traffic.bytes_by_mode
    if codec == "lossless":
        np.testing.assert_array_equal(tt, solo(160, 500, 80))


def _slot_pages(eng, st):
    """The trunk pool's K/V and summaries of slot 0's blocks, heads merged
    (page ids differ once a promotion reseats them)."""
    al = eng._page_alloc
    pages = torch.as_tensor([al.page_at(0, j) for j in range(al.count(0))])
    return {n: merge_heads(st.cache[n][:, pages], eng.kv_shards, 0, -2)
            for n in ("k", "v", "kmax", "kmin")}


def test_model_axis_forced_schedule_lossless_pools(setup, jax_tiered):
    """Refresh, Refresh (a synchronous promotion), Partial, Refresh: tokens
    and ``tier_stats`` equal the JAX tiered engine's; slot 0's blocks,
    promoted back at the end, are bit-equal in the tiered lossless (1, 2)
    pools and the untiered (1, 2) engine's."""
    s = setup
    prompt = _prompt(s["cfg"], 160, 600)[None]
    je = _retier(jax_tiered, "lossless")
    te = _tengine(s, mesh=_mesh(1, 2), **_tiered("lossless"))
    ue = _tengine(s, mesh=_mesh(1, 2))
    jst = je.prefill(prompt, chunk=CHUNK)
    tst = te.prefill(prompt, chunk=CHUNK)
    ust = ue.prefill(prompt, chunk=CHUNK)
    for mode in ("refresh", "refresh", "partial", "refresh"):
        jst, jo = je.step(jst, mode)
        tst, to = te.step(tst, mode)
        ust, uo = ue.step(ust, mode)
        np.testing.assert_array_equal(to.tokens, jo.tokens)
        np.testing.assert_array_equal(to.tokens, uo.tokens)
        assert te.tier_stats() == je.tier_stats()
    assert te.tier_stats()["tier_sync_promotes"] == 2
    assert te._page_alloc.hosted_count(0) > 0
    te._tier.promote_slot(tst.cache, 0)
    got, want = _slot_pages(te, tst), _slot_pages(ue, ust)
    for n in got:
        assert torch.equal(got[n], want[n]), n


# ---------------------------------------------------------------------------
# serving on a data axis
# ---------------------------------------------------------------------------

SERVE = ((160, 700), (150, 701), (60, 702), (170, 703))


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_data_axis_tiered_serving_equals_solo(setup, solo, shape):
    """Four requests, two per data shard, lossless: the long ones demote
    on their shard after each refresh; every request equals its solo
    ``generate``."""
    s = setup
    eng = _tengine(s, batch=4, mesh=_mesh(*shape), prefix_cache=False,
                   **_tiered("lossless"))
    assert isinstance(eng, DataParallelEngine) and eng.tiered
    assert all(sub._tier.host is eng.shards[0]._tier.host
               for sub in eng.shards)
    if shape[1] == 2:
        assert all(sub.tp.m == 2 for sub in eng.shards)
    sched = ContinuousScheduler(eng, prefill_chunk=CHUNK, clock=lambda: 0.0)
    for i, (n, seed) in enumerate(SERVE):
        sched.submit(Request(request_id=f"r{i}",
                             prompt=_prompt(s["cfg"], n, seed),
                             max_new_tokens=NEW, arrival_s=0.0))
    sched.run()
    for i, (n, seed) in enumerate(SERVE):
        want = trim_output([int(x) for x in solo(n, seed, NEW)[0]], NEW, -1)
        np.testing.assert_array_equal(sched.outputs[f"r{i}"].tokens, want)
    st = eng.tier_stats()
    assert st["tier_demoted_pages"] == sum(
        sub._tier.demoted_pages for sub in eng.shards) > 0
    assert all(sub._tier.demoted_pages for sub in eng.shards)
    peaks = [st["tier_host_bytes_peak_shard_0"],
             st["tier_host_bytes_peak_shard_1"]]
    assert min(peaks) > 0 and st["tier_host_bytes_peak_per_host"] == \
        max(peaks) <= st["tier_host_bytes_peak"]
    assert st["tier_host_bytes"] == 0 and st["tier_hosted_pages"] == 0
    ps = eng.page_stats()
    assert ps["tier_host_bytes_peak_per_host"] == max(peaks)
    assert eng._page_alloc.in_use == 0


def test_only_the_binding_shard_defers(setup):
    """Slot 0 (shard 0) owes 4 pages and shard 0 has none free; slot 2
    (shard 1) owes 2 and shard 1 has room: only slot 0 defers, its
    shard's margin is its own debt, and with ``force`` shard 0 steps its
    smallest debt only when none of its rows would step."""
    eng = _tengine(setup, batch=4, mesh=_mesh(2, 1), prefix_cache=False,
                   num_pages=17, **_tiered("int8"))
    eng.empty_state()
    al = eng._page_alloc                 # shard 0: pages 1-7, shard 1: 8-16
    al.alloc(0, 4)
    for j in range(4):
        al.demote(0, j)
    al.alloc(1, al.free_in(0))           # shard 0 is full
    al.alloc(2, 2)
    for j in range(2):
        al.demote(2, j)
    modes = np.array([MODE_REFRESH, MODE_PARTIAL, MODE_REFRESH,
                      MODE_PARTIAL], np.int8)
    rows = np.array([True, False, True, False])
    kept, deferred = eng.tier_ready_rows(rows, modes, force=False)
    assert kept.tolist() == [False, False, True, False] and deferred == 1
    # forced: shard 0 has no other stepping row, so its debt steps
    kept, deferred = eng.tier_ready_rows(rows, modes, force=True)
    assert kept.tolist() == [True, False, True, False] and deferred == 0
    # a partial row of shard 0 steps, so its refresh row waits
    rows = np.array([True, True, True, False])
    kept, deferred = eng.tier_ready_rows(rows, modes, force=True)
    assert kept.tolist() == [False, True, True, False] and deferred == 1
    assert eng.tier_admit_margin(48, 0) == 4
    assert eng.tier_admit_margin(48, 1) == 2
    assert eng.tier_admit_margin(160, 0) == 0
    assert eng.tier_admit_margin(48) == 4
