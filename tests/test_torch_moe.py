"""The PyTorch port's MoE family against the JAX package, on the CPU:
``granite-moe-1b-a400m`` reduced (2 layers, d 256, 4 experts, top-2)
in fp32, weights converted from the JAX parameters with
``repro_torch.convert``, inputs made from numpy seeds, the conftest
``small_spec`` (``use_pallas=True``) and ``small_dcfg``.

* The configs (``granite-moe-1b-a400m``, ``dbrx-132b`` and their
  ``reduced()``) equal the reference's field for field.
* ``blocks.moe_fwd`` against the reference's: one binding-capacity group
  with dropped pairs, and a multi-group stream (zero-padded groups of
  1024): the output within 1e-5 of its largest magnitude, the same kept
  (token, slot) pairs of the real tokens, the aux loss
  (``blocks.moe_aux``) within 1e-6 relative.
* ``api.prefill`` and ``decode`` logits within 1e-4.
* ``SpecPVEngine.generate`` with partial verification gives the JAX
  engine's tokens and mode counts on the three layouts (contiguous
  gathered, paged gathered, paged zero-copy); the reference's three
  layouts give the same tokens as each other (its own identity, asserted
  in ``tests/test_zero_copy.py`` and ``tests/test_paged_kv.py``), so one
  JAX engine stands for them.  With full verification the port's
  ``generate`` equals the port's and JAX's autoregressive decoding.
* Served requests equal their solo ``generate`` where capacity cannot
  bind (``experts_per_token = num_experts``): with binding capacity a
  request's tokens depend on its batch, in the reference too.
* ``train_loss`` and its gradients over two dispatch groups (n > 1024).
* The conversion of the ``moe`` leaves round-trips bit for bit.
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
from repro.core.reference import autoregressive_generate as j_ar
from repro.models import api as japi
from repro.models import blocks as jbk
from repro_torch import configs as tcfgs
from repro_torch.convert import (draft_params_from_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.core.reference import autoregressive_generate as t_ar
from repro_torch.models import api as tapi
from repro_torch.models import blocks as tbk
from repro_torch.serving import Request, ServingConfig, ServingEngine
from repro_torch.train.trainer import grads_of, trainable

ARCH = "granite-moe-1b-a400m"
F32 = dict(dtype="float32", param_dtype="float32")
PROMPT, NEW, MAX_LEN, CHUNK = 160, 24, 512, 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(small_spec, small_dcfg):
    cfg = jcfgs.get_config(ARCH).reduced().replace(**F32)
    tcfg = tcfgs.get_config(ARCH).reduced().replace(**F32)
    spec = small_spec.replace(use_pallas=True)
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    return dict(
        cfg=cfg, tcfg=tcfg, spec=spec,
        tspec=tcfgs.SpecPVConfig(**dataclasses.asdict(spec)),
        dcfg=small_dcfg,
        tdcfg=tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg)),
        params=params, dparams=dparams,
        tp=params_from_numpy(tcfg, _np(params), device="cpu"),
        td=draft_params_from_numpy(tcfg, _np(dparams), device="cpu"),
        prompt=np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, PROMPT)).astype(np.int32))


# ---------------------------------------------------------------------------
# configs, conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, "dbrx-132b"])
def test_moe_configs_equal_field_by_field(arch):
    j, t = jcfgs.get_config(arch), tcfgs.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert (t.reduced().num_experts, t.reduced().experts_per_token) == (4, 2)
    assert j.layer_kinds() == t.layer_kinds()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_params_round_trip_bit_equal(setup, dtype):
    """Reference params -> the port -> numpy gives the reference's tree
    (bf16 widened to fp32, which is exact), the router fp32 [L, d, E]
    and the experts [L, E, d, f] / [L, E, f, d] in the param dtype; the
    port's own params go to numpy and back bit for bit."""
    cfg = jcfgs.get_config(ARCH).reduced().replace(dtype=dtype,
                                                   param_dtype=dtype)
    tcfg = tcfgs.get_config(ARCH).reduced().replace(dtype=dtype,
                                                    param_dtype=dtype)
    ref = (_np(setup["params"]) if dtype == "float32"
           else _np(japi.init_params(cfg, jax.random.PRNGKey(2))))
    tp = params_from_numpy(tcfg, ref, device="cpu")
    moe = tp["layers"][0]["moe"]
    pd = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    e, d, f = tcfg.num_experts, tcfg.d_model, tcfg.d_ff
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["router"].shape) == (d, e)
    for k, shape in (("wi", (e, d, f)), ("wg", (e, d, f)), ("wo", (e, f, d))):
        assert moe[k].dtype == pd and tuple(moe[k].shape) == shape
    back = params_to_numpy(tcfg, tp)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a, np.float32), b), ref, back)
    own = tapi.init_params(tcfg.replace(**F32), seed=3, device="cpu")
    again = params_from_numpy(tcfg, params_to_numpy(tcfg, own), device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(again)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# moe_fwd
# ---------------------------------------------------------------------------

def _reference_keep(cfg, p, xg):
    """The reference's kept pairs of each group [G, g*k], from its own
    lines (``repro/models/blocks.py:_moe_group_fwd``): fp32 router,
    softmax, ``jax.lax.top_k``, the token-major cumsum, ``pos < cap``."""
    ng, g, _ = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = max(1, int(np.ceil(g * k / e * 1.25)))
    probs = jax.nn.softmax(jnp.asarray(xg, jnp.float32) @ p["router"], -1)
    _, topi = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(topi, e).reshape(ng, g * k, e)
    pos = jnp.cumsum(onehot, axis=1) - 1.0
    pos = jnp.take_along_axis(pos, topi.reshape(ng, g * k, 1), axis=2)[..., 0]
    return np.asarray(pos < cap)


@pytest.mark.parametrize("shape", [(2, 40), (3, 600)])
def test_moe_fwd_matches_jax(setup, shape):
    """(2, 40): one group of 80 tokens, capacity 50 per expert; (3,
    600): 1800 tokens in two groups of 1024, the second zero-padded.
    The tokens share a direction, as a layer's hidden states do, so the
    router favours the same experts and pairs are dropped."""
    cfg, tcfg = setup["cfg"], setup["tcfg"]
    p = jax.tree_util.tree_map(lambda a: a[0], setup["params"]["decoder"]
                               ["slots"][0]["moe"])
    tp = setup["tp"]["layers"][0]["moe"]
    b, t = shape
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal((1, 1, cfg.d_model))
         + rng.standard_normal((b, t, cfg.d_model))).astype(np.float32)
    jy, jaux = jbk.moe_fwd(cfg, p, jnp.asarray(x))
    ty, st = tbk.moe_fwd(tcfg, tp, torch.as_tensor(x))
    taux = tbk.moe_aux(tcfg, b * t, [[st]], "cpu")
    jy = np.asarray(jy)
    assert np.abs(ty.numpy() - jy).max() <= 1e-5 * np.abs(jy).max()
    assert abs(float(taux) / float(jaux) - 1) < 1e-6
    n, g = b * t, min(b * t, tbk.MOE_GROUP)
    ng = -(-n // g)
    xg = np.zeros((ng * g, cfg.d_model), np.float32)
    xg[:n] = x.reshape(n, -1)
    xg = xg.reshape(ng, g, -1)
    want = _reference_keep(cfg, p, xg)
    real = want.reshape(-1)[: n * cfg.experts_per_token]
    np.testing.assert_array_equal(st.keep.numpy(), real)
    assert not real.all(), "capacity must bind: some pairs dropped"
    tbk.MOE_DROPS = torch.zeros((), dtype=torch.long)
    try:
        tbk.count_drops(st)
        assert int(tbk.MOE_DROPS) == int((~real).sum())
    finally:
        tbk.MOE_DROPS = None


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------

def test_prefill_and_decode_logits_match_jax(setup):
    """A 40-token prefill in chunks of 32 (the last short), then a
    5-token Full decode, on the contiguous cache: logits, features and
    new K/V within 1e-4."""
    cfg, tcfg, spec, tspec = (setup[k] for k in ("cfg", "tcfg", "spec",
                                                  "tspec"))
    params, tp = setup["params"], setup["tp"]
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jc = japi.init_cache(cfg, 2, 96, spec)
    tc = tapi.init_cache(tcfg, 2, 96, tspec, device="cpu")
    for off in range(0, 40, 32):
        chunk = prompt[:, off:off + 32]
        jl, jf, jc = japi.prefill(cfg, params, jnp.asarray(chunk), jc,
                                  spec=spec)
        tl, tf, tc = tapi.prefill(tcfg, tp, torch.as_tensor(chunk).long(),
                                  tc, spec=tspec)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    for g, w in zip(tf, jf):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    t = 5
    toks = rng.integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
    pos = (40 + np.arange(t))[None].repeat(2, 0).astype(np.int32)
    oj = japi.decode(cfg, params, jnp.asarray(toks), jnp.asarray(pos), jc,
                     mode="full", spec=spec)
    ot = tapi.decode(tcfg, tp, torch.as_tensor(toks).long(),
                     torch.as_tensor(pos), tc, mode="full", spec=tspec)
    np.testing.assert_allclose(ot.logits.numpy(), np.asarray(oj.logits),
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(ot.new_kv, oj.new_kv):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# engine, serving
# ---------------------------------------------------------------------------

LAYOUTS = {"contiguous": dict(),
           "paged": dict(paged=True),
           "zero_copy": dict(paged=True, zero_copy=True)}


@pytest.fixture(scope="module")
def jax_partial(setup):
    s = setup
    je = JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                 batch=2, max_len=MAX_LEN)
    return je.generate(s["prompt"], NEW, prefill_chunk=CHUNK)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_generate_matches_jax_engine(setup, jax_partial, layout):
    """Partial verification (Refresh, then Partial steps, capacity
    binding in every step): tokens, mode counts and mean accept equal
    the JAX engine's."""
    s = setup
    jtoks, jstats = jax_partial
    te = TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                 batch=2, max_len=MAX_LEN, device="cpu", **LAYOUTS[layout])
    ttoks, tstats = te.generate(s["prompt"], NEW, prefill_chunk=CHUNK)
    np.testing.assert_array_equal(ttoks, jtoks)
    assert tstats["modes"] == jstats["modes"]
    assert {"refresh", "partial"} <= set(tstats["modes"])
    assert tstats["mean_accept"] == pytest.approx(jstats["mean_accept"])


def test_full_verification_is_lossless(setup):
    s = setup
    te = TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                 batch=2, max_len=MAX_LEN, partial_verification=False,
                 device="cpu")
    ttoks, tstats = te.generate(s["prompt"], NEW, prefill_chunk=CHUNK)
    assert tstats["modes"] == {"full": tstats["steps"]}
    tar = t_ar(s["tcfg"], s["tp"], s["prompt"], NEW, max_len=MAX_LEN,
               prefill_chunk=CHUNK, spec=s["tspec"], device="cpu")
    jar = j_ar(s["cfg"], s["params"], s["prompt"], NEW, max_len=MAX_LEN,
               prefill_chunk=CHUNK, spec=s["spec"])
    np.testing.assert_array_equal(ttoks, tar)
    np.testing.assert_array_equal(tar, np.asarray(jar))


def test_served_requests_equal_solo_generate_without_binding(setup):
    """``ServingConfig()``'s layout at batch 3, four requests of 48-200
    tokens, top-4 of 4 experts: every request's tokens equal its batch-1
    ``generate``."""
    s = setup
    tcfg = s["tcfg"].replace(experts_per_token=s["tcfg"].num_experts)
    prompts = {f"r{i}": np.random.default_rng(10 + i).integers(
        0, tcfg.vocab_size, (n,)).astype(np.int32)
        for i, n in enumerate((48, 160, 96, 200))}
    srv = ServingEngine(tcfg, s["tspec"], s["tdcfg"], s["tp"], s["td"],
                        ServingConfig(batch=3, max_len=MAX_LEN,
                                      prefill_chunk=CHUNK), device="cpu")
    for rid, p in prompts.items():
        srv.submit(Request(rid, p, max_new_tokens=12))
    srv.run()
    outs = srv.outputs
    solo = TEngine(tcfg, s["tspec"], s["tdcfg"], s["tp"], s["td"], batch=1,
                   max_len=MAX_LEN, device="cpu")
    for rid, p in prompts.items():
        want, _ = solo.generate(p[None], 12, prefill_chunk=CHUNK)
        np.testing.assert_array_equal(outs[rid].tokens, want[0])


# requests (id, prompt length, new tokens) for batch 3: "a" finishes
# while "b" and "c" decode, and "d" then prefills into its slot beside
# them, one 64-token chunk per tick
BIND_REQS = (("a", 48, 4), ("b", 160, 20), ("c", 96, 16), ("d", 240, 8))


def _bind_requests(cfg, cls):
    return [cls(request_id=rid, prompt=np.random.default_rng(20 + i).integers(
        0, cfg.vocab_size, (n,)).astype(np.int32), max_new_tokens=new,
        arrival_s=0.0) for i, (rid, n, new) in enumerate(BIND_REQS)]


def _drain(sched, reqs):
    for r in reqs:
        sched.submit(r)
    while sched.has_work():
        sched.tick()
    return sched


@pytest.mark.parametrize("layout", ["contiguous", "zero_copy"])
def test_served_tokens_equal_jax_scheduler_at_binding_capacity(setup,
                                                               layout):
    """Top-2 of 4 experts, where capacity binds, so an inactive row's
    verify input takes capacity from its neighbours: ``ContinuousScheduler``
    at batch 3 on the reference's default layout and on the paged
    zero-copy pool gives the JAX scheduler's tokens for every request, on
    a trace where a slot finishes while the others decode and is refilled
    (a neutral row, then a mid-prefill row, beside decoding ones).  Rows
    outside ``active`` are masked as the reference masks them: the draft
    extension, the pending validity and the self mask."""
    from repro.serving import Request as JRequest
    from repro.serving.scheduler import ContinuousScheduler as JScheduler
    from repro_torch.serving import ContinuousScheduler
    s = setup
    assert (s["tcfg"].num_experts, s["tcfg"].experts_per_token) == (4, 2)
    kw = LAYOUTS[layout]
    je = JEngine(s["cfg"], s["spec"], s["dcfg"], s["params"], s["dparams"],
                 batch=3, max_len=MAX_LEN, partial_verification=True,
                 prefix_cache=False, **kw)
    jsched = _drain(JScheduler(je, prefill_chunk=CHUNK, prefill_budget=CHUNK,
                               fused=True, fused_prefill=False,
                               clock=lambda: 0.0),
                    _bind_requests(s["cfg"], JRequest))
    te = TEngine(s["tcfg"], s["tspec"], s["tdcfg"], s["tp"], s["td"],
                 batch=3, max_len=MAX_LEN, prefix_cache=False, device="cpu",
                 **kw)
    tsched = _drain(ContinuousScheduler(te, prefill_chunk=CHUNK,
                                        prefill_budget=CHUNK,
                                        fused_prefill=False,
                                        clock=lambda: 0.0),
                    _bind_requests(s["tcfg"], Request))
    assert [o.request_id for o in tsched.done_order] == \
        [o.request_id for o in jsched.done_order]
    assert tsched.done_order[0].request_id == "a"
    for rid, _, new in BIND_REQS:
        got = np.asarray(tsched.outputs[rid].tokens)
        assert got.shape == (new,)
        np.testing.assert_array_equal(
            got, np.asarray(jsched.outputs[rid].tokens), err_msg=rid)


def test_masked_verify_inputs_and_draft_extend_match_jax(setup):
    """``build_verify_inputs_fused`` and ``draft_extend`` with a mixed
    ``active`` mask (and per-row pending widths) equal the reference's
    output dicts, the draft cache included (an inactive row keeps its
    length and its entries below it; like the reference's, its masked
    entries write zeros past it)."""
    from repro.core import draft as jdr
    from repro.core import verify as jvf
    from repro.core.tree import TreeSpec as JTree
    from repro_torch.core import draft as tdr
    from repro_torch.core import verify as tvf
    from repro_torch.core.tree import TreeSpec as TTree
    s = setup
    rng = np.random.default_rng(31)
    b, p = 4, 6
    branch = s["dcfg"].tree_branch[: s["dcfg"].tree_depth]
    jt, tt = JTree.from_branch(branch), TTree.from_branch(branch)
    active = np.array([True, False, True, False])
    p_eff = np.array([p, p, 1, 1], np.int32)
    plen = np.array([4, 6, 1, 1], np.int32)
    pending = rng.integers(0, 500, (b, p)).astype(np.int32)
    tree_tokens = rng.integers(0, 500, (b, jt.size)).astype(np.int32)
    seq_len = np.array([90, 1, 40, 200], np.int32)
    want = jvf.build_verify_inputs_fused(
        jt, jnp.asarray(pending), jnp.asarray(plen), jnp.asarray(p_eff),
        jnp.asarray(tree_tokens), jnp.asarray(seq_len),
        active=jnp.asarray(active))
    got = tvf.build_verify_inputs_fused(
        tt, torch.as_tensor(pending, dtype=torch.long),
        torch.as_tensor(plen, dtype=torch.long),
        torch.as_tensor(p_eff, dtype=torch.long),
        torch.as_tensor(tree_tokens), torch.as_tensor(seq_len,
                                                      dtype=torch.long),
        active=torch.as_tensor(active))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert not got["self_mask"][~torch.as_tensor(active)].any()

    cfg, tcfg = s["cfg"], s["tcfg"]
    e = 3
    toks = rng.integers(0, cfg.vocab_size, (b, e)).astype(np.int32)
    feats = rng.standard_normal((b, e, 3 * cfg.d_model)).astype(np.float32)
    valid = np.arange(e)[None] < np.array([3, 2, 1, 3])[:, None]
    lens = np.array([5, 7, 0, 9], np.int32)

    def jcache():
        c = jdr.init_draft_cache(cfg, b, 32)
        c["k"] = jnp.asarray(rng_c.standard_normal(c["k"].shape), jnp.float32)
        c["v"] = jnp.asarray(rng_c.standard_normal(c["v"].shape), jnp.float32)
        c["length"] = jnp.asarray(lens)
        return c
    rng_c = np.random.default_rng(32)
    jc = jcache()
    tc = {k: torch.as_tensor(np.array(v)) for k, v in jc.items()}
    tc["length"] = tc["length"].to(torch.int32)
    jc2, jh, jl = jdr.draft_extend(cfg, s["dcfg"], s["dparams"], s["params"],
                                   jc, jnp.asarray(toks), jnp.asarray(feats),
                                   jnp.asarray(valid),
                                   active=jnp.asarray(active))
    k0 = tc["k"].clone()
    tc2, th, tl = tdr.draft_extend(tcfg, s["tdcfg"], s["td"], s["tp"], tc,
                                   torch.as_tensor(toks),
                                   torch.as_tensor(feats),
                                   torch.as_tensor(valid),
                                   active=torch.as_tensor(active))
    np.testing.assert_array_equal(tc2["length"].numpy(),
                                  np.asarray(jc2["length"]))
    np.testing.assert_array_equal(tc2["length"].numpy()[~active],
                                  lens[~active])
    for name, g, w in (("k", tc2["k"], jc2["k"]), ("v", tc2["v"], jc2["v"]),
                       ("h_last", th, jh), ("logits_last", tl, jl)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    for i in np.nonzero(~active)[0]:
        assert torch.equal(tc2["k"][i, :lens[i]], k0[i, :lens[i]])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_loss_and_grads_match_jax(setup):
    """Batch 2 x 599 positions, 1198 tokens: two dispatch groups (the
    second zero-padded), each recomputed in the backward pass; the
    prefill and decode tests above hold one group.  The loss and the aux
    loss within 1e-5 relative, each gradient leaf within 1e-4 of its
    largest magnitude."""
    cfg, tcfg = setup["cfg"], setup["tcfg"]
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 600)).astype(np.int32)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: japi.train_loss(cfg, p, jnp.asarray(toks)),
        has_aux=True)(setup["params"])
    tp = trainable(params_from_numpy(tcfg, _np(setup["params"]),
                                     device="cpu"))
    tl, tm = tapi.train_loss(tcfg, tp, torch.as_tensor(toks))
    tl.backward()
    assert abs(float(tl.detach()) / float(jl) - 1) < 1e-5
    assert abs(float(tm["aux_loss"].detach()) / float(jm["aux_loss"])
               - 1) < 1e-5
    assert float(jm["aux_loss"]) > 0
    errs = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - b).max() / np.abs(b).max()),
        params_to_numpy(tcfg, grads_of(tp)), _np(jg))
    assert max(jax.tree_util.tree_leaves(errs)) < 1e-4


@pytest.mark.parametrize("arch", ["hybrid", "vlm", "audio", "windowed"])
def test_other_architectures_still_refused(setup, arch):
    """The dense trunk admits dense, MoE, VLM and audio stacks: a windowed
    MoE stack (ported since) builds and its chunked prefill logits equal
    JAX's; a
    hybrid stack is refused by the dense trunk, which points to the
    Griffin trunk, and the engine takes one built with Griffin params;
    the VLM and audio stacks (ported since) are admitted, and the one
    refusal they keep is a prefill without the request's ``extra``
    (engine and API)."""
    from repro_torch.models import dense as tdn
    s = setup
    if arch == "hybrid":
        cfg = tcfgs.get_config("recurrentgemma-2b").reduced().replace(**F32)
        with pytest.raises(ValueError, match="models/griffin.py"):
            tdn._check_dense(cfg)
        tp = tapi.init_params(cfg, seed=0, device="cpu")
        from repro_torch.core.draft import init_draft_params
        td = init_draft_params(cfg, s["tdcfg"], seed=1, device="cpu")
        eng = TEngine(cfg, s["tspec"], s["tdcfg"], tp, td, batch=1,
                      max_len=64, device="cpu")
        assert not eng.is_attn and eng.mode_for(1, 10_000, False) == "state"
        return
    if arch == "windowed":
        cfg, tcfg = (s[k].replace(window_size=24) for k in ("cfg", "tcfg"))
        tdn._check_dense(tcfg)
        prompt = s["prompt"][:, :80]
        jc = japi.init_cache(cfg, 2, 96, s["spec"])
        tc = tapi.init_cache(tcfg, 2, 96, s["tspec"], device="cpu")
        for off in range(0, 80, 32):
            chunk = prompt[:, off:off + 32]
            jl, _, jc = japi.prefill(cfg, s["params"], jnp.asarray(chunk),
                                     jc, spec=s["spec"])
            tl, _, tc = tapi.prefill(tcfg, s["tp"],
                                     torch.as_tensor(chunk).long(), tc,
                                     spec=s["tspec"])
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=1e-4, atol=1e-4)
        return
    name = {"vlm": "llama-3.2-vision-90b", "audio": "whisper-small"}[arch]
    cfg = tcfgs.get_config(name).reduced().replace(**F32)
    tdn._check_dense(cfg)
    tp = tapi.init_params(cfg, seed=0, device="cpu")
    from repro_torch.core.draft import init_draft_params
    td = init_draft_params(cfg, s["tdcfg"], seed=1, device="cpu")
    eng = TEngine(cfg, s["tspec"], s["tdcfg"], tp, td, batch=1,
                  max_len=64, device="cpu")
    assert eng.is_attn and eng.cross
    prompt = np.zeros((1, 8), np.int64)
    with pytest.raises(ValueError, match="conditioning `extra`"):
        eng.prefill(prompt)
    cache = tapi.init_cache(cfg, 1, 64, s["tspec"], device="cpu")
    with pytest.raises(ValueError, match="per-request conditioning"):
        tapi.prefill(cfg, tp, torch.as_tensor(prompt), cache,
                     spec=s["tspec"])
    st = eng.prefill(prompt, extra=tapi.extra_inputs_for(cfg, 1, seed=0,
                                                         device="cpu"))
    assert int(st.seq_len[0]) == 9