"""Data-parallel serving of the PyTorch port against the JAX package, on
the CPU (every mesh device ``cpu``).

* **Sharding rules.**  For every registry id, at ``model`` sizes 1, 2, 4
  and 8 with FSDP off and on (and a ``pod`` mesh), the port's spec of
  every parameter leaf equals ``repro.distributed.sharding._spec_for_leaf``
  on the reference's tree (shapes from ``jax.eval_shape``; the reference
  reads a ``jax.sharding.AbstractMesh``).  ``batch_spec``,
  ``cache_shardings`` (with and without ``shard_seq_over_all``) and
  ``pkv_shardings`` agree on the same shapes, and the pieces
  ``shard_leaf`` cuts put back together give the leaf.
* **Allocator.**  The reference's seven sharded-allocator tests
  (``tests/test_sharded.py``) on the port's ``PageAllocator``, and a
  hypothesis sequence of alloc, free, fork, attach, copy-on-write,
  cache-only pages, demote and promote over 1, 2 and 4 shards after
  which the port's pages, free counts, refcounts and high-water marks
  equal the reference allocator's.
* **Engine** (``tiny-dense``, fp32, conftest ``small_spec`` and
  ``small_dcfg``).  A continuous-scheduler trace served on ``(2, 1)`` and
  ``(4, 1)`` meshes at batch 4 and 8, on the paged gathered, paged
  zero-copy and contiguous layouts, gives the reference's unsharded
  engine's tokens, each shard's page high water stays within its range;
  a fork shares pages within a shard and raises across shards; a
  one-shard mesh equals the unsharded engine bit for bit; a prefix
  attaches only on the shard that holds it; what a ``model`` axis above 1
  does not carry yet raises naming ROADMAP.md's 'Multi-GPU, part 4'
  (tensor parallelism itself is ``tests/test_torch_tensor_parallel.py``).
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst
from jax.sharding import AbstractMesh

import repro.configs as jcfgs
import repro.distributed.sharding as jsh
from repro.core import SpecPVEngine as JEngine
from repro.core.draft import init_draft_params as j_init_draft
from repro.kvcache.cache import PageAllocator as JAllocator
from repro.models import api as japi
from repro.serving import Request as JRequest
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.data_parallel import DataParallelEngine
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.distributed import sharding as tsh
from repro_torch.kvcache.cache import PageAllocator
from repro_torch.serving import ContinuousScheduler, Request

pytestmark = pytest.mark.sharded


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    while the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# sharding rules against the reference's
# ---------------------------------------------------------------------------

def _norm(spec):
    """A spec's entries as the port writes them (a one-axis tuple as its
    name), so both packages' conventions compare."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _meshes(shape, axes=("data", "model")):
    return (AbstractMesh(shape, axes),
            tsh.DeviceMesh(shape, axes, ["cpu"] * math.prod(shape)))


@pytest.fixture(scope="module")
def shapes():
    """Every registry id's parameter and cache shapes, abstract."""
    spec = jcfgs.SpecPVConfig()
    out = {}
    for arch in jcfgs.list_archs():
        cfg = jcfgs.get_config(arch)
        p = jax.eval_shape(lambda: japi.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
        c = jax.eval_shape(lambda: japi.init_cache(cfg, 4, 1024, spec))
        out[arch] = (cfg, p, c)
    return out


def test_registry_ids_match():
    assert tcfgs.list_archs() == jcfgs.list_archs()
    assert len(tcfgs.list_archs()) == 14


@pytest.mark.parametrize("shape, axes, fsdp", [
    ((2, 1), ("data", "model"), False), ((2, 1), ("data", "model"), True),
    ((2, 2), ("data", "model"), False), ((2, 2), ("data", "model"), True),
    ((2, 4), ("data", "model"), False), ((2, 4), ("data", "model"), True),
    ((2, 8), ("data", "model"), False), ((2, 8), ("data", "model"), True),
    ((2, 2, 4), ("pod", "data", "model"), True),
], ids=["m1", "m1-fsdp", "m2", "m2-fsdp", "m4", "m4-fsdp", "m8",
        "m8-fsdp", "pod-m4-fsdp"])
def test_param_specs_match_reference(shapes, shape, axes, fsdp):
    jm, tm = _meshes(shape, axes)
    jr, tr = jsh.ShardingRules(jm, fsdp=fsdp), tsh.ShardingRules(tm, fsdp=fsdp)
    assert (tr.model_size, tr.data_axes, tr.data_size) == \
        (jr.model_size, jr.data_axes, jr.data_size)
    n = 0
    for arch, (cfg, params, cache) in shapes.items():
        flat, _ = jax.tree_util.tree_flatten_with_path(params)
        for path, leaf in flat:
            names = [str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path]
            want = _norm(jsh._spec_for_leaf(jr, path, leaf))
            got = tsh.spec_for_leaf(tr, names, leaf.shape)
            assert got == want, (arch, names, leaf.shape, got, want)
            n += 1
        for b in (1, 2, 3, 4, 8, 16):
            assert tsh.batch_spec(tr, b) == _norm(jsh.batch_spec(jr, b))
        for over_all in (False, True):
            want = jsh.cache_shardings(jr, cfg, cache,
                                       shard_seq_over_all=over_all)
            got = tsh.cache_shardings(tr, None, cache,
                                      shard_seq_over_all=over_all)
            assert got == {k: _norm(v.spec) for k, v in want.items()}, arch
        if cfg.is_attention_arch:
            for b, p in ((4, 4576), (2, 35), (1, 8)):
                l, hk, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
                pkv = (jax.ShapeDtypeStruct((l, b, hk, p, dh), np.float32),
                       jax.ShapeDtypeStruct((l, b, hk, p, dh), np.float32),
                       jax.ShapeDtypeStruct((l, b, hk, p), np.int32))
                want = jsh.pkv_shardings(jr, pkv)
                assert tsh.pkv_shardings(tr, pkv) == tuple(
                    _norm(w.spec) for w in want), arch
    assert n > 300


@pytest.mark.parametrize("shape, axes, leaf_shape, spec", [
    ((2, 4), ("data", "model"), (6, 8, 12), (None, "model", "data")),
    ((2, 4), ("data", "model"), (16, 3), (("data", "model"), None)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4),
     (("pod", "data"), "model")),
    ((2, 1), ("data", "model"), (5, 7), (None, "model")),
    ((2, 4), ("data", "model"), (5, 7), ()),
])
def test_cut_pieces_rebuild_the_leaf(shape, axes, leaf_shape, spec):
    """Each coordinate's piece has the reference's shard shape, and the
    pieces laid back at their offsets give the leaf (replicated dims
    write the same values)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    jm, tm = _meshes(shape, axes)
    leaf = torch.arange(math.prod(leaf_shape),
                        dtype=torch.float32).reshape(leaf_shape)
    want_shape = NamedSharding(jm, P(*spec)).shard_shape(leaf_shape)
    out = torch.full(leaf_shape, -1.0)
    full = spec + (None,) * (len(leaf_shape) - len(spec))
    for i in range(tm.size):
        coords = tm.coords(i)
        piece = tsh.shard_leaf(leaf, spec, tm, coords)
        assert tuple(piece.shape) == tuple(want_shape)
        idx = []
        for dim, entry in enumerate(full):
            ax = (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry)
            k = 0
            for a in ax:
                k = k * tm.shape[a] + coords[a]
            size = piece.shape[dim]
            idx.append(slice(k * size, (k + 1) * size))
        region = out[tuple(idx)]
        assert bool(((region == -1) | (region == piece)).all())
        out[tuple(idx)] = piece
    assert torch.equal(out, leaf)


def test_place_params_one_copy_per_device():
    mesh = tsh.DeviceMesh((2, 1), devices=["cpu", "cpu"])
    rules = tsh.ShardingRules(mesh)
    params = {"embed": torch.randn(6, 4),
              "layers": [{"wq": torch.randn(4, 4)}]}
    placed = tsh.place_params(rules, params, mesh.data_shard_coords(1),
                              mesh.devices[1])
    assert placed["embed"] is params["embed"]
    assert placed["layers"][0]["wq"] is params["layers"][0]["wq"]


def test_mesh_devices_and_coordinates():
    mesh = tsh.DeviceMesh((2, 3, 1), ("pod", "data", "model"),
                          [f"cpu:{i}" for i in range(6)])
    assert mesh.data_axes == ("pod", "data") and mesh.data_size == 6
    assert mesh.axis_size("model") == 1 and mesh.axis_size("x") == 1
    assert [mesh.device_at(**mesh.data_shard_coords(s)).index
            for s in range(6)] == list(range(6))
    with pytest.raises(ValueError, match="devices"):
        tsh.DeviceMesh((2, 1), devices=["cpu"])
    with pytest.raises(ValueError, match="axes"):
        tsh.DeviceMesh((2, 1), ("model", "data"), ["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not reachable"):
            tsh.make_mesh((2, 1))


# ---------------------------------------------------------------------------
# the sharded allocator (the reference's seven tests, then a sequence)
# ---------------------------------------------------------------------------

def _slot_shard(batch, shards):
    return lambda slot: slot * shards // batch


def test_shard_ranges_partition_the_pool():
    al = PageAllocator(33, shards=4, slot_shard=_slot_shard(8, 4))
    assert sum(al.shard_capacity(s) for s in range(4)) == al.capacity == 32
    assert sum(al.free_in(s) for s in range(4)) == al.free
    shards_of = [al.page_shard(p) for p in range(1, 33)]
    assert shards_of == sorted(shards_of)
    assert set(shards_of) == {0, 1, 2, 3}


def test_alloc_draws_from_the_slot_shard():
    al = PageAllocator(33, shards=4, slot_shard=_slot_shard(8, 4))
    for slot in range(8):
        pages = al.alloc(slot, 2)
        want = slot * 4 // 8
        assert al.slot_shard(slot) == want
        assert all(al.page_shard(int(p)) == want for p in pages)


def test_exhaustion_is_shard_local():
    al = PageAllocator(9, shards=2, slot_shard=_slot_shard(2, 2))
    al.alloc(0, al.shard_capacity(0))
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        al.alloc(0, 1)
    al.alloc(1, 1)
    assert al.free_in(0) == 0 and al.free_in(1) > 0


def test_per_shard_high_water_and_peak_per_host():
    al = PageAllocator(17, shards=2, slot_shard=_slot_shard(2, 2))
    a = al.alloc(0, 3)
    al.alloc(1, 5)
    assert al.high_water_by == [3, 5]
    assert al.peak_pages_per_host == 5
    al.dec_ref(a)
    assert al.high_water_by == [3, 5]
    assert al.high_water == 8


def test_fork_and_cow_stay_shard_local():
    al = PageAllocator(17, shards=2, slot_shard=_slot_shard(4, 2))
    pages = al.alloc(2, 2)
    with pytest.raises(AssertionError, match="cross-shard fork"):
        al.fork(2, 0)
    assert al.fork(2, 3) == list(pages)
    assert all(al.refcount(int(p)) == 2 for p in pages)
    old, new = al.cow_write(3, 0)
    assert old != new
    assert al.page_shard(new) == 1
    assert al.refcount(int(pages[0])) == 1


def test_alloc_cache_pages_are_idle():
    al = PageAllocator(9, shards=2, slot_shard=_slot_shard(2, 2))
    (p,) = al.alloc_cache(1, 1)
    assert al.page_shard(p) == 1
    assert al.idle == 1 and al.committed == 0
    al.dec_ref([p], cache=True)
    assert al.free == al.capacity


def test_unsharded_allocator_unchanged():
    al = PageAllocator(8)
    assert al.shards == 1
    assert al.slot_shard(123) == 0
    a = al.alloc(0, 3)
    assert al.high_water == 3 and al.peak_pages_per_host == 3
    al.dec_ref(a)
    assert al.free == al.capacity


SLOTS = 8
_AOP = hst.one_of(
    hst.tuples(hst.just("alloc"), hst.integers(0, SLOTS - 1),
               hst.integers(0, 4)),
    hst.tuples(hst.just("free"), hst.integers(0, SLOTS - 1), hst.just(0)),
    hst.tuples(hst.just("fork"), hst.integers(0, SLOTS - 1),
               hst.integers(0, SLOTS - 1)),
    hst.tuples(hst.just("attach"), hst.integers(0, SLOTS - 1),
               hst.integers(0, SLOTS - 1)),
    hst.tuples(hst.just("cow"), hst.integers(0, SLOTS - 1),
               hst.integers(0, 7)),
    hst.tuples(hst.just("alloc_cache"), hst.integers(0, 3),
               hst.integers(1, 2)),
    hst.tuples(hst.just("demote"), hst.integers(0, SLOTS - 1),
               hst.integers(0, 7)),
    hst.tuples(hst.just("promote"), hst.integers(0, SLOTS - 1),
               hst.integers(0, 7)),
)


def _alloc_state(al):
    return dict(
        pages=[[int(p) for p in al.pages_of(s)] for s in range(SLOTS)],
        hosted=[al.hosted_blocks(s) for s in range(SLOTS)],
        free=[al.free_in(s) for s in range(al.shards)], total=al.free,
        ref=[int(x) for x in al._ref], cache=[int(x) for x in al._cache_ref],
        hw=(al.high_water, al.resident_high_water, list(al.high_water_by),
            al.peak_pages_per_host),
        use=(al.in_use, al.idle, al.committed))


def _both(ja, ta, fn):
    """Run ``fn`` on both allocators: equal results, or the same error."""
    outs = []
    for al in (ja, ta):
        try:
            out = fn(al)
            outs.append(("ok", None if out is None else np.asarray(
                out, np.int64).tolist()))
        except (AssertionError, RuntimeError) as e:
            outs.append((type(e).__name__, None))
    assert outs[0] == outs[1]


@settings(max_examples=40, deadline=None)
@given(hst.sampled_from([1, 2, 4]), hst.integers(9, 24),
       hst.lists(_AOP, max_size=40))
def test_sharded_allocator_follows_reference(shards, num_pages, ops):
    """After every operation the port's allocator and the reference's
    hold the same pages, free lists, references and high-water marks."""
    fn = _slot_shard(SLOTS, shards)
    ja = JAllocator(num_pages, shards=shards, slot_shard=fn)
    ta = PageAllocator(num_pages, shards=shards, slot_shard=fn)
    for kind, a, b in ops:
        pages = [int(p) for p in ja.pages_of(a)]
        if kind == "alloc":
            _both(ja, ta, lambda al: al.alloc(a, b))
        elif kind == "free":
            _both(ja, ta, lambda al: al.free_slot(a))
        elif kind == "fork" and a != b and not ja.count(b):
            _both(ja, ta, lambda al: al.fork(a, b))
        elif kind == "attach" and a != b:
            src = [int(p) for p in ja.pages_of(b) if p]
            if src:
                _both(ja, ta, lambda al: al.attach(a, src))
        elif kind == "cow" and pages and pages[b % len(pages)]:
            _both(ja, ta, lambda al: al.cow_write(a, b % len(pages)))
        elif kind == "alloc_cache" and a < shards:
            _both(ja, ta, lambda al: al.alloc_cache(b, a))
        elif kind == "demote" and pages:
            _both(ja, ta, lambda al: al.demote(a, b % len(pages)))
        elif kind == "promote" and ja.hosted_count(a):
            blocks = ja.hosted_blocks(a)
            _both(ja, ta, lambda al: al.promote(a, blocks[b % len(blocks)]))
        assert _alloc_state(ta) == _alloc_state(ja)


# ---------------------------------------------------------------------------
# the data-parallel engine against the reference's unsharded engine
# ---------------------------------------------------------------------------

MAX_LEN, CHUNK, NEW = 256, 64, 6
# prompt lengths under and over the 112-token partial budget, one
# remainder past the 64-token chunks (the reference compiles per shape)
LENS = (96, 160, 32, 160, 96, 160)


@pytest.fixture(scope="module")
def tiny(small_spec, small_dcfg):
    cfg = jcfgs.get_config("tiny-dense")
    tcfg = tcfgs.get_config("tiny-dense")
    spec = small_spec.replace(use_pallas=True)
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size - 1, (n,)).astype(np.int32)
               for n in LENS]
    return dict(
        cfg=cfg, spec=spec, dcfg=small_dcfg, params=params, dparams=dparams,
        targs=(tcfg, tcfgs.SpecPVConfig(**dataclasses.asdict(spec)),
               tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg)),
               params_from_numpy(tcfg, np_params, device="cpu"),
               draft_params_from_numpy(
                   tcfg, jax.tree_util.tree_map(np.asarray, dparams),
                   device="cpu")),
        prompts=prompts)


def _cpu_mesh(data, model=1):
    return tsh.DeviceMesh((data, model), devices=["cpu"] * (data * model))


def _tengine(s, batch, **kw):
    return TEngine(*s["targs"], batch=batch, max_len=MAX_LEN, device="cpu",
                   **kw)


def _serve(sched, reqs):
    for r in reqs:
        sched.submit(r)
    while sched.has_work():
        sched.tick()
    return {k: [int(t) for t in o.tokens] for k, o in sched.outputs.items()}


def _port_serve(eng, s, **kw):
    sched = ContinuousScheduler(eng, prefill_chunk=CHUNK, clock=lambda: 0.0,
                                **kw)
    return _serve(sched, [Request(request_id=f"r{i}", prompt=p,
                                  max_new_tokens=NEW, arrival_s=0.0)
                          for i, p in enumerate(s["prompts"])])


@pytest.fixture(scope="module")
def jax_tokens(tiny):
    """The reference's unsharded engine (its default contiguous layout,
    batch 4) over the trace: each request's tokens."""
    s = tiny
    eng = JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                  batch=4, max_len=MAX_LEN, partial_verification=True)
    sched = JScheduler(eng, prefill_chunk=CHUNK, fused_prefill=False,
                       clock=lambda: 0.0)
    return _serve(sched, [JRequest(request_id=f"r{i}", prompt=p,
                                   max_new_tokens=NEW, arrival_s=0.0)
                          for i, p in enumerate(s["prompts"])])


LAYOUTS = {"paged-gathered": dict(paged=True),
           "paged-zero-copy": dict(paged=True, zero_copy=True),
           "contiguous": dict()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("data, batch", [(2, 4), (4, 8)])
def test_sharded_serving_equals_reference(tiny, jax_tokens, layout, data,
                                          batch):
    """The served tokens equal the reference's unsharded engine's; each
    shard's page high water stays within its own range."""
    eng = _tengine(tiny, batch, mesh=_cpu_mesh(data), **LAYOUTS[layout])
    assert isinstance(eng, DataParallelEngine) and eng.data_shards == data
    assert [len(eng.shard_slots(d)) for d in range(data)] == \
        [batch // data] * data
    # interleaved prefill (fused rounds) on one arm, blocking on the other
    budget = 2 * CHUNK if data == 2 else None
    assert _port_serve(eng, tiny, prefill_budget=budget) == jax_tokens
    if eng.paged:
        # admission picks the shard with the most free pages: all step
        assert all(sub.dispatches for sub in eng.shards)
        ps = eng.page_stats()
        al = eng._page_alloc
        assert ps["data_shards"] == data
        assert ps["peak_pages_per_host"] <= al.capacity // data + eng._nb_seq
        for d in range(data):
            assert 0 < ps[f"high_water_shard_{d}"] <= al.shard_capacity(d)
        assert ps["in_use"] == ps["idle"] and ps["pinned_pages"] == 0


def test_fork_cow_refcounts_under_sharding(tiny):
    """A fork within a shard shares its pages and copy-on-write isolates
    it; a fork across shards raises before anything changes."""
    eng = _tengine(tiny, 8, mesh=_cpu_mesh(4), paged=True, zero_copy=True)
    st = eng.empty_state()
    prompt = tiny["prompts"][1]
    st, _ = eng.prefill_into_slot(st, 2, prompt, chunk=CHUNK,
                                  max_new_tokens=NEW)
    al = eng._page_alloc
    free_before = al.free
    shared = [p for p in al.pages_of(2) if p]
    assert all(al.page_shard(p) == 1 for p in shared)
    rc = [al.refcount(p) for p in shared]
    st = eng.fork_slot(st, 2, 3)
    assert al.free == free_before
    assert [al.refcount(p) for p in shared] == [r + 1 for r in rc]
    with pytest.raises(AssertionError, match="cross-shard fork"):
        eng.fork_slot(st, 2, 4)
    assert not al.count(4) and al.free == free_before
    # both rows step: the fork's writes go to private pages of shard 1
    rows = np.zeros(8, bool)
    rows[[2, 3]] = True
    st, out = eng.step_fused(st, rows, eng.modes_for_rows(st, rows))
    assert np.array_equal(out.tokens[2], out.tokens[3])
    assert eng.cow_copies["trunk"] > 0
    assert all(al.page_shard(p) == 1 for p in al.pages_of(3) if p)
    st = eng.reset_slot(st, 3)
    st = eng.reset_slot(st, 2)
    assert al.committed == 0


def test_mesh_of_one_shard_is_the_unsharded_engine(tiny):
    """A (1, 1) mesh (and a batch the data axis does not divide) runs
    the unsharded engine: the same tokens and the same state, bit for
    bit."""
    base = _tengine(tiny, 3, paged=True, zero_copy=True)
    one = _tengine(tiny, 3, paged=True, zero_copy=True, mesh=_cpu_mesh(1))
    odd = _tengine(tiny, 3, paged=True, zero_copy=True, mesh=_cpu_mesh(2))
    assert type(one) is TEngine and one.data_shards == 1
    assert type(odd) is TEngine and odd.data_shards == 1
    assert _port_serve(one, tiny) == _port_serve(base, tiny)
    for f in dataclasses.fields(base.state):
        a, b = getattr(base.state, f.name), getattr(one.state, f.name)
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(a, b)


def test_prefixes_attach_only_on_their_shard(tiny):
    """A prompt registered on shard 0 attaches to a later slot of shard 0
    (its blocks shared, its prefill skipped) but not to a slot of shard 1,
    which prefills its own copy; the first tokens agree."""
    eng = _tengine(tiny, 4, mesh=_cpu_mesh(2), paged=True, zero_copy=True)
    st = eng.empty_state()
    al = eng._page_alloc
    prompt = tiny["prompts"][3][:150]       # nine blocks and a tail
    firsts = []
    for slot in (0, 2, 1):
        st, first = eng.prefill_into_slot(st, slot, prompt, chunk=CHUNK,
                                          max_new_tokens=NEW)
        firsts.append(first)
    assert len(set(firsts)) == 1
    s0, s1 = eng.shards
    assert s1._prefill_skipped_tokens == 0
    assert s0._prefill_skipped_tokens == len(prompt)     # the tail hit
    assert all(al.page_shard(p) == 1 for p in al.pages_of(2) if p)
    n_full = len(prompt) // eng.spec.block_size
    assert al.pages_of(1)[:n_full] == al.pages_of(0)[:n_full]
    assert not set(al.pages_of(2)) & set(al.pages_of(0))
    assert eng.pages_needed_shared(prompt, NEW, shard=0) < \
        eng.pages_needed_shared(prompt, NEW, shard=1)


def test_lock_step_generate_and_prefix_snapshot(tiny):
    """Lock-step ``generate`` over two shards equals the unsharded one; a
    prefix snapshot restored on shard 1 serves an admission there."""
    prompt = np.stack([tiny["prompts"][1], tiny["prompts"][3]])
    want, _ = _tengine(tiny, 2, paged=True).generate(prompt, NEW)
    # the null page rides with shard 0: one more page for its whole row
    pages = 2 * (-(-MAX_LEN // 16)) + 2
    eng = _tengine(tiny, 2, mesh=_cpu_mesh(2), paged=True, num_pages=pages)
    got, _ = eng.generate(prompt, NEW)
    np.testing.assert_array_equal(got, want)
    st = eng.empty_state()
    st, _ = eng.prefill_into_slot(st, 0, prompt[0], chunk=CHUNK,
                                  max_new_tokens=NEW)
    snap = eng.save_prefix_state(st)
    fresh = _tengine(tiny, 2, mesh=_cpu_mesh(2), paged=True,
                     num_pages=pages)
    st2 = fresh.empty_state()
    st2, n = fresh.restore_prefix_state(st2, snap, shard=1)
    assert n == len(snap["entries"]) > 0
    assert fresh.prefix_match_blocks(prompt[0], shard=1) > 0
    assert fresh.prefix_match_blocks(prompt[0], shard=0) == 0
    st2, first = fresh.prefill_into_slot(st2, 1, prompt[0], chunk=CHUNK,
                                         max_new_tokens=NEW)
    assert fresh.shards[1]._prefill_skipped_tokens > 0
    assert first == want[0, 0]


def test_model_axis_and_unported_options_raise(tiny):
    """A ``model`` axis above 1 builds a tensor-parallel engine (the state
    and cross-attention families too, held in
    ``tests/test_torch_family_tp.py``); what it does not carry yet raises
    naming ROADMAP.md's 'Multi-GPU, part 4': the host tier (and on a
    data-parallel mesh), shards on several devices, an int8 cache and
    the launch steps' sharded gradients (the launch steps take no split:
    they run whole weights)."""
    from repro_torch.distributed.tensor_parallel import TensorParallel
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import api as tapi
    part4 = "ROADMAP.*'Multi-GPU, part 4'"
    assert _tengine(tiny, 4, mesh=_cpu_mesh(1, 2), paged=True).tp.m == 2
    for mesh in (_cpu_mesh(1, 2), _cpu_mesh(2)):
        with pytest.raises(NotImplementedError, match=part4):
            _tengine(tiny, 4, mesh=mesh, paged=True, tiered=True)
    with pytest.raises(NotImplementedError, match=part4):
        _tengine(tiny, 4, mesh=tsh.DeviceMesh((1, 2),
                                              devices=["cpu", "meta"]))
    tcfg, tspec = tiny["targs"][:2]
    with pytest.raises(NotImplementedError, match=part4):
        tsteps.make_train_step(tcfg, grad_shardings={})
    tp = TensorParallel(tcfg, tiny["targs"][3], ["cpu"] * 2)
    cache = tapi.init_cache(tcfg, 1, 64, tspec, device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.long)
    cache.update(k=cache["k"].to(torch.int8), v=cache["v"].to(torch.int8),
                 k_scale=cache["k"][..., 0], v_scale=cache["v"][..., 0])
    with pytest.raises(NotImplementedError, match=part4):
        tapi.decode(tcfg, tiny["targs"][3], tok[:, :1],
                    cache["length"][:, None], cache, mode="full", spec=tspec,
                    tp=tp)
