"""Tensor parallelism of the PyTorch port over a mesh's ``model`` axis,
against the JAX package on the CPU (every mesh device ``cpu``; fp32).

* **Modules** at ``m = 2`` and ``m = 4`` model shards
  (``distributed.tensor_parallel.TensorParallel``): the attention layer
  (prefill, then a Full verification: the layer's output, its new K/V and
  queries), the MLP, the MoE (reduced ``granite-moe-1b-a400m``), the
  embedding and the head (untied ``tiny-dense`` and a tied one) and the
  draft layer with its inputs and head each give the JAX reference
  function's output within 1e-5 of its largest magnitude.  At ``m = 4``
  tiny-dense's 2 KV heads do not split, so its attention runs whole and
  its MLP splits.
* **Engine** (``tiny-dense``, conftest ``small_spec`` and ``small_dcfg``):
  ``generate`` on a ``(1, 2)`` mesh gives the JAX unsharded engine's
  tokens and modes on all three layouts, and its ``pkv_blocks`` (the
  shards' heads put side by side) equal the port's unsharded engine's; a
  continuous-scheduler trace on a ``(2, 2)`` mesh (two data shards, each
  a two-shard tensor-parallel engine) gives the JAX scheduler's tokens on
  all three layouts; sampled rows with their seeds give the unsharded
  engine's tokens; reduced granite on ``(1, 2)`` equals the port's
  unsharded engine.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import SpecPVEngine as JEngine
from repro.core import draft as jdr
from repro.core.draft import init_draft_params as j_init_draft
from repro.models import api as japi
from repro.models import common as jcm
from repro.models import dense as jdn
from repro.serving import Request as JRequest
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core import draft as tdr
from repro_torch.core.data_parallel import DataParallelEngine
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.distributed.sharding import DeviceMesh
from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                     merge_heads)
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import dense as tdn
from repro_torch.serving import ContinuousScheduler, Request

pytestmark = pytest.mark.sharded

F32 = dict(dtype="float32", param_dtype="float32")
REL = 1e-5
MAX_LEN, CHUNK, NEW = 256, 64, 6
# prompt lengths under and over the 112-token partial budget
LENS = (96, 160, 32, 160, 96, 160)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    while the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want):
    """Within ``REL`` of the reference's largest magnitude."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got.detach().float())
    assert got.shape == want.shape
    tol = REL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _cpus(m):
    return ["cpu"] * m


def _model(arch, seed=0, reduced=False, **rep):
    cfg = jcfgs.get_config(arch)
    tcfg = tcfgs.get_config(arch)
    if reduced:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    cfg, tcfg = cfg.replace(**F32, **rep), tcfg.replace(**F32, **rep)
    params = japi.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, tcfg, params, params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _jax_layer(params, i):
    """Layer ``i`` of the reference's one-slot (period 1) stack."""
    return jax.tree_util.tree_map(lambda a: a[i],
                                  params["decoder"]["slots"][0])


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
def test_attention_layer_matches_jax(m, small_spec):
    """One attention layer (its MLP's output weights zeroed, so the
    layer's output is the embedding plus attention): a 40-token prefill
    into the contiguous cache, then a 5-token Full verification; the
    layer's output, new K/V and queries against the reference's."""
    cfg, tcfg, params, tparams = _model("tiny-dense", num_layers=1)
    wo = params["decoder"]["slots"][0]["mlp"]["wo"]
    params["decoder"]["slots"][0]["mlp"]["wo"] = wo * 0
    tparams["layers"][0]["mlp"]["wo"].zero_()
    spec = small_spec.replace(use_pallas=True)
    tspec = tcfgs.SpecPVConfig(**dataclasses.asdict(spec))
    tp = TensorParallel(tcfg, tparams, _cpus(m))
    assert tp.attn_split == (m == 2) and tp.mlp_split
    assert tp.kv_shards == (m if m == 2 else 1)
    rng = np.random.default_rng(3)
    b, s0, t = 2, 40, 5
    prompt = rng.integers(0, cfg.vocab_size, (b, s0)).astype(np.int32)
    jc = japi.init_cache(cfg, b, 96, spec)
    _, _, jc = japi.prefill(cfg, params, prompt, jc, spec=spec)
    tc = tapi.init_cache(tcfg, b, 96, tspec, device="cpu",
                         kv_shards=tp.kv_shards)
    _, _, tc = tapi.prefill(tcfg, tparams, _t(prompt).long(), tc,
                            spec=tspec, tp=tp)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    pos = (s0 + np.arange(t))[None].repeat(b, 0).astype(np.int32)
    mask = np.tril(np.ones((t, t), bool))[None].repeat(b, 0)
    oj = japi.decode(cfg, params, toks, pos, jc, mode="full",
                     self_mask=mask, spec=spec, emit_queries=True)
    ot = tapi.decode(tcfg, tparams, _t(toks).long(), _t(pos), tc,
                     mode="full", self_mask=_t(mask), spec=tspec,
                     emit_queries=True, tp=tp)
    _close(ot.features[2], oj.features[2])
    kvs = tp.kv_shards
    for g, w in zip(ot.new_kv, oj.new_kv):
        _close(merge_heads(g, kvs, 0, 3), w)
    _close(merge_heads(ot.queries, kvs, 0, 3), oj.queries)
    _close(ot.logits, oj.logits)


@pytest.mark.parametrize("arch, m", [("tiny-dense", 2), ("tiny-dense", 4),
                                     ("granite-moe-1b-a400m", 2),
                                     ("granite-moe-1b-a400m", 4)])
def test_mlp_and_moe_match_jax(arch, m):
    """The MLP (columns and rows split) and the MoE (experts split E/m,
    the router and dispatch once) of layer 0 against the reference's
    ``_mlp_or_moe``."""
    cfg, tcfg, params, tparams = _model(
        arch, reduced=arch != "tiny-dense")
    tp = TensorParallel(tcfg, tparams, _cpus(m))
    if cfg.num_experts:
        assert tp.moe_split and tp.shards[0].cfg.num_experts == 4 // m
    else:
        assert tp.mlp_split and tp.shards[0].cfg.d_ff == cfg.d_ff // m
    h = np.random.default_rng(5).normal(
        size=(2, 7, cfg.d_model)).astype(np.float32)
    want, _ = jdn._mlp_or_moe(cfg, _jax_layer(params, 0), h)
    got = tdn._mlp_or_moe_tp(tp, 0, tparams["layers"][0], _t(h))
    _close(got, want)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("tied", [False, True])
def test_embed_and_head_match_jax(m, tied):
    """The embedding (width-split, gathered) and the head: untied
    vocabulary-split (gathered), tied row-parallel (summed)."""
    cfg, tcfg, params, tparams = _model("tiny-dense",
                                        tie_embeddings=tied)
    tp = TensorParallel(tcfg, tparams, _cpus(m))
    assert tp.embed_split and tp.head_split == (not tied)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    np.testing.assert_array_equal(
        tdn.embed_tokens(tcfg, tparams, _t(toks), tp).numpy(),
        np.asarray(jdn.embed_tokens(cfg, params, toks)))
    h = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    _close(tdn.lm_head(tcfg, tparams, _t(h), tp),
           jdn.lm_head(cfg, params, h))


@pytest.mark.parametrize("m", [2, 4])
def test_draft_layer_matches_jax(m, small_dcfg):
    """The draft's inputs (``fuse`` and ``in_proj`` gathered), its decoder
    layer over a context with the heads split and its head."""
    cfg, tcfg, params, tparams = _model("tiny-dense")
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    tdparams = draft_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, dparams), device="cpu")
    tmcfg = tdr.draft_model_config(tcfg)
    ttp = TensorParallel(tcfg, tparams, _cpus(m), draft=(tmcfg, tdparams))
    dtp = ttp.draft
    assert dtp.fuse_split and dtp.attn_split == (m == 2)
    rng = np.random.default_rng(7)
    b, t, s = 2, 4, 11
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    feats = rng.normal(size=(b, t, 3 * cfg.d_model)).astype(np.float32)
    xj = jdr._draft_inputs(cfg, dparams, params["embed"], toks, feats)
    xt = tdr._draft_inputs(tcfg, tdparams, tparams["embed"], _t(toks),
                           _t(feats), dtp)
    _close(xt, xj)
    hk, dh = cfg.num_kv_heads, cfg.head_dim_
    ck = rng.normal(size=(b, s, hk, dh)).astype(np.float32)
    cv = rng.normal(size=(b, s, hk, dh)).astype(np.float32)
    valid = np.arange(s)[None] < np.array([[s], [7]])
    pos = (s + np.arange(t))[None].repeat(b, 0).astype(np.int32)
    mask = np.tril(np.ones((t, t), bool))[None].repeat(b, 0)
    mcfg = jdr.draft_model_config(cfg)
    inv_j = jcm.rope_inv_freq(mcfg)
    inv_t = tcm.rope_inv_freq_tensor(tmcfg, "cpu")
    x = np.asarray(xj)
    hj, kj, vj = jdr._layer_fwd(cfg, mcfg, dparams, x, pos, ck, cv, valid,
                                mask, inv_j, jcm.yarn_mscale(mcfg))
    ht, kt, vt = tdr._layer_fwd(tcfg, tmcfg, tdparams, _t(x), _t(pos),
                                _t(ck), _t(cv), _t(valid), _t(mask), inv_t,
                                tcm.yarn_mscale(tmcfg), dtp)
    for g, w in ((ht, hj), (kt, kj), (vt, vj)):
        _close(g, w)
    _close(tdr.draft_head(tcfg, tdparams, tparams, ht, ttp),
           jdr.draft_head(cfg, dparams, params, hj))


# ---------------------------------------------------------------------------
# the engine against the reference's unsharded engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(small_spec, small_dcfg):
    cfg, tcfg, params, tparams = _model("tiny-dense")
    spec = small_spec.replace(use_pallas=True)
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size - 1, (n,)).astype(np.int32)
               for n in LENS]
    return dict(
        cfg=cfg, spec=spec, dcfg=small_dcfg, params=params, dparams=dparams,
        targs=(tcfg, tcfgs.SpecPVConfig(**dataclasses.asdict(spec)),
               tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg)), tparams,
               draft_params_from_numpy(
                   tcfg, jax.tree_util.tree_map(np.asarray, dparams),
                   device="cpu")),
        prompts=prompts)


def _mesh(data, model):
    return DeviceMesh((data, model), devices=_cpus(data * model))


def _tengine(s, batch, **kw):
    return TEngine(*s["targs"], batch=batch, max_len=MAX_LEN, device="cpu",
                   **kw)


def _serve(sched, reqs):
    for r in reqs:
        sched.submit(r)
    while sched.has_work():
        sched.tick()
    return {k: [int(t) for t in o.tokens] for k, o in sched.outputs.items()}


def _requests(s, cls=Request, **kw):
    return [cls(request_id=f"r{i}", prompt=p, max_new_tokens=NEW,
                arrival_s=0.0, **kw) for i, p in enumerate(s["prompts"])]


@pytest.fixture(scope="module")
def jax_ref(tiny):
    """The reference's unsharded engine (its default contiguous layout,
    batch 4): a lock-step ``generate`` of four prompts, then the serving
    trace through its continuous scheduler."""
    s = tiny
    eng = JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                  batch=4, max_len=MAX_LEN, partial_verification=True)
    prompt = np.stack([s["prompts"][i] for i in (1, 3, 5, 1)])
    toks, stats = eng.generate(prompt, 3 * NEW, prefill_chunk=CHUNK)
    sched = JScheduler(eng, prefill_chunk=CHUNK, fused_prefill=False,
                       clock=lambda: 0.0)
    return dict(prompt=prompt, toks=np.asarray(toks), modes=stats["modes"],
                served=_serve(sched, _requests(s, JRequest)))


LAYOUTS = {"contiguous": dict(),
           "paged-gathered": dict(paged=True),
           "paged-zero-copy": dict(paged=True, zero_copy=True)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_generate_on_two_model_shards_equals_reference(tiny, jax_ref,
                                                       layout):
    """``generate`` on a ``(1, 2)`` mesh gives the reference's tokens and
    modes; the engine's per-head state is shard-stacked and (zero-copy)
    its ``pkv_blocks``, the shards' heads side by side, equal the
    unsharded port engine's."""
    kw = LAYOUTS[layout]
    eng = _tengine(tiny, 4, mesh=_mesh(1, 2), **kw)
    assert eng.tp is not None and eng.kv_shards == 2
    assert eng.state.pkv_blocks.shape[1:3] == (2 * 4, 1)
    toks, stats = eng.generate(jax_ref["prompt"], 3 * NEW,
                               prefill_chunk=CHUNK)
    np.testing.assert_array_equal(toks, jax_ref["toks"])
    assert stats["modes"] == jax_ref["modes"]
    assert {"refresh", "partial"} <= set(stats["modes"])
    if layout == "paged-zero-copy":
        ref = _tengine(tiny, 4, **kw)
        ref.generate(jax_ref["prompt"], 3 * NEW, prefill_chunk=CHUNK)
        got = merge_heads(eng.final_state.pkv_blocks, 2, 1, 2)
        assert torch.equal(got, ref.final_state.pkv_blocks)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_serving_on_a_2x2_mesh_equals_reference(tiny, jax_ref, layout):
    """A continuous-scheduler trace on a ``(2, 2)`` mesh: two data shards,
    each a tensor-parallel engine over its two model shards."""
    eng = _tengine(tiny, 4, mesh=_mesh(2, 2), **LAYOUTS[layout])
    assert isinstance(eng, DataParallelEngine) and eng.data_shards == 2
    assert all(sub.tp is not None and sub.tp.m == 2 for sub in eng.shards)
    sched = ContinuousScheduler(eng, prefill_chunk=CHUNK,
                                clock=lambda: 0.0,
                                prefill_budget=2 * CHUNK)
    assert _serve(sched, _requests(tiny)) == jax_ref["served"]


def test_sampled_rows_equal_unsharded(tiny):
    """Sampled requests, each with its seed, beside a greedy one: the
    same tokens on a ``(1, 2)`` mesh as on the unsharded engine."""
    def run(**kw):
        eng = _tengine(tiny, 4, paged=True, zero_copy=True, **kw)
        sched = ContinuousScheduler(eng, prefill_chunk=CHUNK,
                                    clock=lambda: 0.0)
        reqs = [Request(request_id=f"s{i}", prompt=p, max_new_tokens=NEW,
                        arrival_s=0.0, temperature=0.8 if i % 2 else 0.0,
                        seed=100 + i)
                for i, p in enumerate(tiny["prompts"][:4])]
        return _serve(sched, reqs)
    assert run(mesh=_mesh(1, 2)) == run()


def test_moe_engine_on_two_model_shards_equals_unsharded(small_spec,
                                                         small_dcfg):
    """Reduced granite (tied head, 4 experts top-2) on a ``(1, 2)`` mesh:
    the experts, heads and tied head split, the tokens the unsharded
    port engine's."""
    _, tcfg, _, tparams = _model("granite-moe-1b-a400m", reduced=True)
    spec = tcfgs.SpecPVConfig(**dataclasses.asdict(
        small_spec.replace(use_pallas=True)))
    dcfg = tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg))
    dparams = tdr.init_draft_params(tcfg, dcfg, seed=1, device="cpu")
    prompt = np.random.default_rng(12).integers(
        1, tcfg.vocab_size - 1, (2, 150)).astype(np.int32)
    out = []
    for mesh in (None, _mesh(1, 2)):
        eng = TEngine(tcfg, spec, dcfg, tparams, dparams, batch=2,
                      max_len=MAX_LEN, device="cpu", paged=True,
                      zero_copy=True, mesh=mesh)
        out.append(eng.generate(prompt, 12, prefill_chunk=CHUNK))
    assert eng.tp.moe_split and eng.tp.attn_split and eng.tp.embed_split
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][1]["modes"] == out[0][1]["modes"]
