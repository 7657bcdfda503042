"""The PyTorch port's configs, parameter conversion, model primitives and
trunk against the JAX package, on the same weights and numpy inputs
(fp32, ``tiny-dense`` and the conftest ``small_spec``; allclose 1e-4).

The JAX side runs its CPU routes (the gathered-view trunk); the port's
paged trunk runs its kernel route, whose plain versions stand in for the
CUDA kernels on the CPU — so these tests also hold the kernel route to
the reference's gathered route.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core.draft import init_draft_params as j_init_draft
from repro.kvcache import cache as jkvc
from repro.models import api as japi
from repro.models import blocks as jbk
from repro.models import common as jcm
from repro.models import dense as jdn
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.kvcache import cache as tkvc
from repro_torch.models import api as tapi
from repro_torch.models import blocks as tbk
from repro_torch.models import common as tcm
from repro_torch.models import dense as tdn

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t.detach().float()),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _tspec(spec):
    return tcfgs.SpecPVConfig(**dataclasses.asdict(spec))


@pytest.fixture(scope="module")
def tiny():
    cfg = jcfgs.get_config("tiny-dense")
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = tcfgs.get_config("tiny-dense")
    return cfg, tcfg, params, params_from_numpy(tcfg, np_params, device="cpu")


# ---------------------------------------------------------------------------
# configs and conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tiny-dense", "llama3.1-8b", "qwen3-8b",
                                  "rwkv6-3b"])
def test_model_configs_equal_field_by_field(arch):
    j, t = jcfgs.get_config(arch), tcfgs.get_config(arch)
    jf = [f.name for f in dataclasses.fields(j)]
    assert jf == [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.head_dim_ == t.head_dim_
    assert j.layer_kinds() == t.layer_kinds()
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())


@pytest.mark.parametrize("name", ["SpecPVConfig", "DraftConfig"])
def test_specpv_and_draft_configs_equal(name, small_spec, small_dcfg):
    jc, tc = getattr(jcfgs, name), getattr(tcfgs, name)
    assert ([f.name for f in dataclasses.fields(jc)]
            == [f.name for f in dataclasses.fields(tc)])
    assert dataclasses.asdict(jc()) == dataclasses.asdict(tc())
    small = small_spec if name == "SpecPVConfig" else small_dcfg
    ported = tc(**dataclasses.asdict(small))
    assert dataclasses.asdict(ported) == dataclasses.asdict(small)
    if name == "SpecPVConfig":
        assert ported.partial_budget_tokens == small.partial_budget_tokens
    else:
        assert ported.tree_size == small.tree_size


def test_params_from_numpy_round_trips(tiny, small_dcfg):
    cfg, tcfg, params, tp = tiny
    np_params = jax.tree_util.tree_map(np.asarray, params)
    slots = np_params["decoder"]["slots"][0]
    back = jax.tree_util.tree_map(
        lambda *xs: np.stack(xs),
        *[jax.tree_util.tree_map(lambda a: a.numpy(), lp)
          for lp in tp["layers"]])
    jax.tree_util.tree_map(np.testing.assert_array_equal, slots, back)
    for k in ("embed", "final_norm", "head"):
        np.testing.assert_array_equal(tp[k].numpy(), np_params[k])
    dparams = jax.tree_util.tree_map(
        np.asarray, j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1)))
    td = draft_params_from_numpy(tcfg, dparams, device="cpu")
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(
        a, b.numpy()), dparams, td)


# ---------------------------------------------------------------------------
# common + blocks
# ---------------------------------------------------------------------------

def test_common_primitives_match(tiny):
    cfg, tcfg, _, _ = tiny
    rng = np.random.default_rng(0)
    b, t, s, h, hk, dh = 2, 5, 23, 4, 2, 64
    x = rng.normal(size=(b, t, h, dh)).astype(np.float32)
    scale = rng.normal(size=(dh,)).astype(np.float32)
    _close(tcm.rmsnorm(_t(x), _t(scale)), jcm.rmsnorm(x, scale))
    pos = rng.integers(0, 9000, (b, t)).astype(np.int32)
    inv_j = jnp.asarray(jcm.rope_inv_freq(cfg))
    inv_t = _t(tcm.rope_inv_freq(tcfg))
    np.testing.assert_array_equal(tcm.rope_inv_freq(tcfg),
                                  jcm.rope_inv_freq(cfg))
    yarn = cfg.replace(yarn_factor=4.0)
    np.testing.assert_array_equal(
        tcm.rope_inv_freq(tcfg.replace(yarn_factor=4.0)),
        jcm.rope_inv_freq(yarn))
    assert tcm.yarn_mscale(tcfg.replace(yarn_factor=4.0)) == \
        jcm.yarn_mscale(yarn)
    _close(tcm.apply_rope(_t(x), _t(pos), inv_t, 1.0),
           jcm.apply_rope(x, pos, inv_j, 1.0), 2e-4)
    k = rng.normal(size=(b, s, hk, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, dh)).astype(np.float32)
    np.testing.assert_array_equal(tcm.repeat_kv(_t(k), 2).numpy(),
                                  np.asarray(jcm.repeat_kv(k, 2)))
    kv_pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    qpos = np.asarray([[18, 19, 20, 21, 22], [3, 4, 5, 6, 7]], np.int32)
    kv_valid = kv_pos < np.asarray([[21], [6]])
    for parts in (True, False):
        got = tcm.flash_attention(_t(x), _t(k), _t(v), q_positions=_t(qpos),
                                  kv_positions=_t(kv_pos),
                                  kv_valid=_t(kv_valid), chunk=8,
                                  return_partials=parts)
        want = jcm.flash_attention(x, k, v, q_positions=qpos,
                                   kv_positions=kv_pos, kv_valid=kv_valid,
                                   chunk=8, return_partials=parts)
        for g, w in (zip(got, want) if parts else [(got, want)]):
            _close(g, w)
    mask = rng.random((b, 1, t, s)) > 0.3
    mask[0, 0, 1] = False                     # an all-masked query row
    pa = tcm.dense_attn_part(_t(x), _t(k), _t(v), mask=_t(mask))
    pj = jcm.dense_attn_part(x, k, v, mask=mask)
    for g, w in zip(pa, pj):
        _close(g, w)
    kph = rng.normal(size=(b, hk, s, dh)).astype(np.float32)
    vph = rng.normal(size=(b, hk, s, dh)).astype(np.float32)
    valid = rng.random((b, hk, s)) > 0.4
    pb = tcm.dense_attn_part_perhead(_t(x), _t(kph), _t(vph), _t(valid))
    pbj = jcm.dense_attn_part_perhead(x, kph, vph, valid)
    for g, w in zip(pb, pbj):
        _close(g, w)
    for g, w in zip(tcm.merge_attn_partials([pa, pb]),
                    jcm.merge_attn_partials([pj, pbj])):
        _close(g, w)
    _close(tcm.combine_attn_parts([pa, pb], torch.float32),
           jcm.combine_attn_parts([pj, pbj], jnp.float32))


def test_update_slice_rows_clamps_like_jax():
    buf = np.arange(2 * 7 * 3, dtype=np.float32).reshape(2, 7, 3)
    new = -np.ones((2, 3, 3), np.float32)
    start = np.asarray([6, 2], np.int32)      # row 0 overruns: JAX clamps
    want = jax.vmap(lambda b_, n_, o_: jax.lax.dynamic_update_slice(
        b_, n_, (o_, 0)))(buf, new, start)
    got = tcm.update_slice_rows(_t(buf), _t(new), _t(start), axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_blocks_match(tiny):
    cfg, tcfg, params, tp = tiny
    lp_j = jax.tree_util.tree_map(lambda a: a[1],
                                  params["decoder"]["slots"][0])
    lp_t = tp["layers"][1]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 6)).astype(np.int32)
    inv_j = jnp.asarray(jcm.rope_inv_freq(cfg))
    inv_t = _t(tcm.rope_inv_freq(tcfg))
    _close(tbk.project_q(tcfg, lp_t["attn"], _t(x), _t(pos), inv_t, 1.0),
           jbk.project_q(cfg, lp_j["attn"], x, pos, inv_j, 1.0))
    for g, w in zip(tbk.project_kv(tcfg, lp_t["attn"], _t(x), _t(pos),
                                   inv_t, 1.0),
                    jbk.project_kv(cfg, lp_j["attn"], x, pos, inv_j, 1.0)):
        _close(g, w)
    a = rng.normal(size=(2, 6, cfg.num_heads, cfg.head_dim_)).astype(np.float32)
    _close(tbk.attn_output(tcfg, lp_t["attn"], _t(a)),
           jbk.attn_output(cfg, lp_j["attn"], a))
    _close(tbk.mlp_fwd(tcfg, lp_t["mlp"], _t(x)),
           jbk.mlp_fwd(cfg, lp_j["mlp"], x))


# ---------------------------------------------------------------------------
# Quest scoring + selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("score_mode,reduction", [
    ("paper", "mean"), ("paper", "max"), ("quest", "mean"), ("paper", "last")])
def test_quest_scores_and_selection_match(small_spec, score_mode, reduction):
    rng = np.random.default_rng(2)
    b, t, h, hk, dh, nb = 2, 6, 4, 2, 16, 12
    q = rng.normal(size=(b, t, h, dh)).astype(np.float32)
    kmax = np.abs(rng.normal(size=(b, nb, hk, dh))).astype(np.float32)
    kmin = -np.abs(rng.normal(size=(b, nb, hk, dh))).astype(np.float32)
    qw = (rng.random((b, t)) > 0.3).astype(np.float32)
    qw[:, 0] = 1.0
    got = tdn.quest_block_scores(_t(q), _t(kmax), _t(kmin), _t(qw),
                                 score_mode=score_mode, reduction=reduction)
    want = jdn.quest_block_scores(q, kmax, kmin, qw, score_mode=score_mode,
                                  reduction=reduction)
    _close(got, want, 2e-3)
    # random scores have no ties: the selected ids must be equal
    length = np.asarray([nb * small_spec.block_size - 5, 70], np.int32)
    sel_j = jdn.select_partial_blocks(small_spec, want, length)
    sel_t = tdn.select_partial_blocks(_tspec(small_spec), got, _t(length))
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))


def test_selection_breaks_ties_by_lower_index(small_spec):
    """Equal scores keep index order, as ``jax.lax.top_k`` does."""
    scores = np.zeros((1, 2, 12), np.float32)
    scores[0, 1, 5:] = 1.0
    length = np.asarray([12 * small_spec.block_size], np.int32)
    want = jdn.select_partial_blocks(small_spec, scores, length)
    got = tdn.select_partial_blocks(_tspec(small_spec), _t(scores), _t(length))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# trunk: paged kernel route vs the reference, every mode
# ---------------------------------------------------------------------------

def _prefill_both(cfg, tcfg, params, tp, spec, *, paged, prompt, max_len,
                  chunk):
    b = prompt.shape[0]
    if paged:
        nb = -(-max_len // spec.block_size)
        num_pages = b * nb + 1
        jc = japi.init_cache(cfg, b, max_len, spec, paged=True,
                             num_pages=num_pages)
        tc = tapi.init_cache(tcfg, b, max_len, _tspec(spec), paged=True,
                             num_pages=num_pages, device="cpu")
        # shuffled, non-contiguous page tables
        pt = np.random.default_rng(3).permutation(
            np.arange(1, num_pages)).reshape(b, nb).astype(np.int32)
        jc["page_table"] = jnp.asarray(pt)
        tc["page_table"] = _t(pt)
    else:
        jc = japi.init_cache(cfg, b, max_len, spec)
        tc = tapi.init_cache(tcfg, b, max_len, _tspec(spec), device="cpu")
    tspec = _tspec(spec)
    for off in range(0, prompt.shape[1], chunk):
        toks = prompt[:, off:off + chunk]
        lj, fj, jc = japi.prefill(cfg, params, jnp.asarray(toks), jc,
                                  spec=spec)
        lt, ft, tc = tapi.prefill(tcfg, tp, _t(toks).long(), tc, spec=tspec)
        _close(lt, lj)
        for g, w in zip(ft, fj):
            _close(g, w)
    for key in ("k", "v", "kmax", "kmin", "length"):
        _close(tc[key], jc[key])
    return jc, tc


@pytest.mark.parametrize("paged", [True, False])
def test_trunk_prefill_and_decode_full_match(tiny, small_spec, paged):
    cfg, tcfg, params, tp = tiny
    spec = small_spec.replace(use_pallas=True)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (2, 70)).astype(np.int32)
    jc, tc = _prefill_both(cfg, tcfg, params, tp, spec, paged=paged,
                           prompt=prompt, max_len=160, chunk=32)
    t = 5
    toks = rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
    pos = (70 + np.arange(t))[None].repeat(2, 0).astype(np.int32)
    mask = np.tril(np.ones((t, t), bool))[None].repeat(2, 0)
    oj = japi.decode(cfg, params, jnp.asarray(toks), jnp.asarray(pos), jc,
                     mode="full", self_mask=jnp.asarray(mask), spec=spec,
                     emit_queries=True)
    ot = tapi.decode(tcfg, tp, _t(toks).long(), _t(pos), tc, mode="full",
                     self_mask=_t(mask), spec=_tspec(spec), emit_queries=True)
    _close(ot.logits, oj.logits)
    for g, w in zip(ot.new_kv, oj.new_kv):
        _close(g, w)
    for g, w in zip(ot.features, oj.features):
        _close(g, w)
    _close(ot.queries, oj.queries)


def test_trunk_routed_partial_and_fused_match(tiny, small_spec):
    """decode_partial (zero-copy routed) and decode_fused on a paged cache:
    port kernel route vs the reference's gathered route."""
    cfg, tcfg, params, tp = tiny
    spec = small_spec.replace(use_pallas=True)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (2, 150)).astype(np.int32)
    jc, tc = _prefill_both(cfg, tcfg, params, tp, spec, paged=True,
                           prompt=prompt, max_len=256, chunk=64)
    L, hk, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    ns = spec.partial_budget_tokens // spec.block_size
    nb_filled = -(-150 // spec.block_size)
    pbi = np.stack([[[rng.permutation(nb_filled)[:ns] for _ in range(hk)]
                     for _ in range(2)] for _ in range(L)]).astype(np.int32)
    pbi[:, :, :, -2:] = -1                    # unused selection slots
    p = spec.buffer_size
    pk = rng.normal(size=(L, 2, hk, p, dh)).astype(np.float32)
    pv = rng.normal(size=(L, 2, hk, p, dh)).astype(np.float32)
    ppos = np.full((L, 2, hk, p), -1, np.int32)
    ppos[..., :7] = 150 + np.arange(7)        # a short tail buffer
    t = 4
    toks = rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
    pos = (157 + np.arange(t))[None].repeat(2, 0).astype(np.int32)
    mask = np.tril(np.ones((t, t), bool))[None].repeat(2, 0)
    for mode, rows in (("partial", None), ("fused", np.asarray([True, False]))):
        kw_j = dict(mode=mode, self_mask=jnp.asarray(mask), spec=spec,
                    pkv=(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(ppos)),
                    pkv_blocks=jnp.asarray(pbi))
        kw_t = dict(mode=mode, self_mask=_t(mask), spec=_tspec(spec),
                    pkv=(_t(pk), _t(pv), _t(ppos)), pkv_blocks=_t(pbi))
        if rows is not None:
            kw_j["partial_rows"] = jnp.asarray(rows)
            kw_t["partial_rows"] = _t(rows)
        oj = japi.decode(cfg, params, jnp.asarray(toks), jnp.asarray(pos),
                         jc, **kw_j)
        ot = tapi.decode(tcfg, tp, _t(toks).long(), _t(pos), tc, **kw_t)
        _close(ot.logits, oj.logits)
        for g, w in zip(ot.new_kv, oj.new_kv):
            _close(g, w)


def test_paged_cache_helpers_match():
    rng = np.random.default_rng(6)
    npg, bs, hk, dh = 7, 4, 2, 3
    pool = rng.normal(size=(npg, bs, hk, dh)).astype(np.float32)
    pt = np.asarray([[3, 1, 5], [2, 6, 4]], np.int32)
    start = np.asarray([2, 5], np.int32)
    new = rng.normal(size=(2, 4, hk, dh)).astype(np.float32)
    valid = np.asarray([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    want = jkvc.paged_write_tokens(jnp.asarray(pool), jnp.asarray(pt),
                                   jnp.asarray(start), jnp.asarray(new),
                                   jnp.asarray(valid))
    got = tkvc.paged_write_tokens(_t(pool), _t(pt), _t(start), _t(new),
                                  _t(valid))
    # page 0 collects routed-away writes: only allocated pages must agree
    np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])
    np.testing.assert_array_equal(
        tkvc.gather_page_view(got, _t(pt)).numpy()[:, : 3 * bs],
        np.asarray(jkvc.gather_page_view(want, pt))[:, : 3 * bs])
    kmax = rng.normal(size=(npg, hk, dh)).astype(np.float32)
    kmin = rng.normal(size=(npg, hk, dh)).astype(np.float32)
    end = start + valid.sum(1).astype(np.int32)
    wj = jkvc.paged_update_summaries(jnp.asarray(kmax), jnp.asarray(kmin),
                                     want, jnp.asarray(pt),
                                     jnp.asarray(start), jnp.asarray(end), 3)
    wt = tkvc.paged_update_summaries(_t(kmax), _t(kmin), got, _t(pt),
                                     _t(start), _t(end), 3)
    # the block-summary route skips the null page (it is never written);
    # the reference scatters into it and resets it to 0 afterwards
    for g, w, before in zip(wt, wj, (kmax, kmin)):
        np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])
        np.testing.assert_array_equal(g.numpy()[0], before[0])
