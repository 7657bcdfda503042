"""The PyTorch port's Griffin path against the JAX package, on the CPU.

Models, fp32, with the JAX init's weights: the reduced
``recurrentgemma-2b`` (2 layers (rec, attn), d 256, window 128) and a
5-layer variant, one (rec, rec, attn) superblock and a (rec, rec)
remainder.  The init leaves ``ba``, ``bi`` and ``conv_b`` at zero and
``lam`` at 2; here they get random numpy values (the same for both
packages) so the gates are exercised.  Tolerance 1e-4 on hidden states,
features and every state entry; 2e-4 relative on gradients.

* ``params_from_numpy`` / ``params_to_numpy`` between the reference's
  ``slots`` / ``rem`` layout and the per-layer list.
* ``griffin.forward``: ``advance`` over a 256-token chunk (longer than
  the window: slots written twice) and a 44-token one, a read-only
  ``verify`` (the state bitwise unchanged), ``advance`` with padded
  valid prefixes, ``train`` over S > W.
* ``train_loss`` and its gradients against ``jax.grad``; AdamW's weight
  decay by the reference's leaf rank (the remainder layers unstacked);
  the draft trainer's feature pass against the reference's.
* ``SpecPVEngine(paged=False).generate`` with chain drafts over a
  300-token prompt: tokens equal to the JAX engine's and to the port's
  ``autoregressive_generate``; wave serving equal to solo ``generate``;
  a sampled chain repeatable from its seed; the paged cache and the
  continuous scheduler refused.
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
from repro.models import griffin as jgf
from repro_torch import configs as tcfgs
from repro_torch.convert import (draft_params_from_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.core.reference import autoregressive_generate as t_ar
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import griffin as tgf

TOL = 1e-4
B, PROMPT, NEW, MAX_LEN = 2, 300, 16, 384
MODELS = ("reduced", "five")

# the reference's calls compiled whole (op by op they take 3-4x longer)
_jfwd = jax.jit(jgf.forward, static_argnums=(0,),
                static_argnames=("mode", "collect_features"))
_jadvance = jax.jit(japi.advance, static_argnums=(0,))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t.detach().float()),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _cfg(pkg, form):
    cfg = pkg.get_config("recurrentgemma-2b").reduced().replace(
        dtype="float32", param_dtype="float32")
    if form == "five":
        cfg = cfg.replace(num_layers=5, layer_pattern=("rec", "rec", "attn"))
    return cfg


def _gates(np_params, rng):
    """Random ``lam``, ``ba``, ``bi`` and ``conv_b`` in every rec layer
    (stacked slots and the unstacked remainder alike)."""
    for node in list(np_params["slots"]) + list(np_params["rem"]):
        if "lam" not in node:
            continue
        node["lam"] = rng.uniform(-1.0, 3.0, node["lam"].shape).astype(
            np.float32)
        for name, scale in (("ba", 0.5), ("bi", 0.5), ("conv_b", 0.1)):
            node[name] = (rng.normal(size=node[name].shape) * scale).astype(
                np.float32)


@pytest.fixture(scope="module", params=MODELS)
def gm(request, small_dcfg):
    cfg, tcfg = _cfg(jcfgs, request.param), _cfg(tcfgs, request.param)
    np_params = jax.tree_util.tree_map(
        np.asarray, japi.init_params(cfg, jax.random.PRNGKey(0)))
    _gates(np_params, np.random.default_rng(7))
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, np_params, device="cpu")
    td = draft_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, dparams), device="cpu")
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return dict(form=request.param, cfg=cfg, tcfg=tcfg, np_params=np_params,
                params=params, dparams=dparams, tp=tp, td=td, prompt=prompt)


def _specs(small_spec, small_dcfg):
    return (tcfgs.SpecPVConfig(**dataclasses.asdict(small_spec)),
            tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg)))


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

def test_config_and_reduced_match_the_reference():
    j, t = jcfgs.get_config("recurrentgemma-2b"), \
        tcfgs.get_config("recurrentgemma-2b")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.layer_kinds() == j.layer_kinds()
    assert t.layer_kinds()[-2:] == ("rec", "rec") and len(t.layer_kinds()) \
        == 26
    assert t.reduced().layer_kinds() == ("rec", "attn")
    for form in MODELS:
        assert _cfg(tcfgs, form).layer_kinds() == \
            _cfg(jcfgs, form).layer_kinds()
    assert tgf.superblock_decomp(t.layer_kinds()) == (
        ("rec", "rec", "attn"), 8, ("rec", "rec"))
    assert tapi.unstacked_layers(t) == 2
    assert tapi.unstacked_layers(t.reduced()) == 0


def test_params_round_trip(gm):
    """The reference's tree -> the port's list -> the reference's tree,
    bit for bit; the port's own init has the same layout, shapes and
    dtypes (``lam`` fp32 under bf16 params too)."""
    tcfg, npp, tp = gm["tcfg"], gm["np_params"], gm["tp"]
    kinds = tcfg.layer_kinds()
    assert len(tp["layers"]) == len(kinds)
    back = params_to_numpy(tcfg, tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(npp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(npp)):
        np.testing.assert_array_equal(a, b)
    for dtype in ("float32", "bfloat16"):
        cfg = tcfg.replace(param_dtype=dtype, dtype=dtype)
        own = tapi.init_params(cfg, seed=0, device="cpu")
        for kind, lp, lq in zip(kinds, own["layers"], tp["layers"]):
            assert set(lp) == set(lq) == (
                {"ln1", "wx", "wgate", "conv_w", "conv_b", "wa", "ba", "wi",
                 "bi", "lam", "wo", "ln2", "mlp"} if kind == "rec"
                else {"ln1", "attn", "ln2", "mlp"})
            for a, b in zip(_leaves(lp), _leaves(lq)):
                assert a.shape == b.shape
            if kind == "rec":
                assert lp["lam"].dtype == torch.float32
                assert lp["wa"].dtype == tcm.dt(dtype)
        rt = params_from_numpy(cfg, params_to_numpy(cfg, own), device="cpu")
        assert rt["layers"][0]["lam"].dtype == torch.float32


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _check_state(ts, js):
    for name in ("rnn_h", "conv", "win_k", "win_v"):
        _close(ts[name], js[name])
    for name in ("win_pos", "length"):
        np.testing.assert_array_equal(ts[name].numpy(), np.asarray(js[name]))


def _check_feats(fg, fw):
    for g, w in zip(fg, fw):
        _close(g, w)


@pytest.fixture(scope="module")
def advanced(gm):
    """Both packages' states (batch 3) after a 256-token and a 44-token
    chunk from zero state, and each chunk's (h, features) in both."""
    cfg, tcfg, params, tp = gm["cfg"], gm["tcfg"], gm["params"], gm["tp"]
    b = 3
    js = japi.init_cache(cfg, b, MAX_LEN)
    ts = tapi.init_cache(tcfg, b, MAX_LEN, device="cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, 300)).astype(np.int32)
    outs = []
    for off, n in ((0, 256), (256, 44)):
        c = toks[:, off:off + n]
        pos = np.asarray(js["length"])[:, None] + np.arange(n)[None]
        wh, wf, js = _jfwd(cfg, params, jnp.asarray(c), jnp.asarray(pos),
                           js, mode="advance")
        gh, gf, ts = tgf.forward(tcfg, tp, _t(c).long(), _t(pos), ts,
                                 mode="advance")
        outs.append(((gh, gf, {k: v.clone() for k, v in ts.items()}),
                     (wh, wf, js)))
    return outs


@pytest.mark.parametrize("phase", ["advance", "verify", "padded", "train"])
def test_forward_matches(gm, advanced, phase):
    """``advance`` over two chunks from zero state (the first longer than
    the window of 128), then (verify) a read-only T=4 chain pass with
    the chain mask, or (padded) a T=4 advance with rows valid for 4, 2
    and 1 tokens at the reference's advance positions; (train) the train
    mode over S = 300 > W."""
    cfg, tcfg, params, tp = gm["cfg"], gm["tcfg"], gm["params"], gm["tp"]
    rng = np.random.default_rng(4)
    b = 3
    if phase == "train":
        toks = rng.integers(0, cfg.vocab_size, (2, 300)).astype(np.int32)
        pos = np.broadcast_to(np.arange(300)[None], (2, 300))
        wh, wf, _ = _jfwd(cfg, params, jnp.asarray(toks), jnp.asarray(pos),
                          None, mode="train")
        gh, gf, _ = tgf.forward(tcfg, tp, _t(toks).long(), _t(pos), None,
                                mode="train")
        _close(gh, wh)
        _check_feats(gf, wf)
        return
    if phase == "advance":
        for (gh, gf, ts), (wh, wf, js) in advanced:
            _close(gh, wh)
            _check_feats(gf, wf)
            _check_state(ts, js)
        return
    js = advanced[-1][1][2]
    ts = {k: v.clone() for k, v in advanced[-1][0][2].items()}
    chain = rng.integers(0, cfg.vocab_size, (b, 4)).astype(np.int32)
    if phase == "verify":
        pos = np.asarray(js["length"])[:, None] + np.arange(4)[None]
        sm = np.broadcast_to(np.tril(np.ones((4, 4), bool))[None], (b, 4, 4))
        before = {k: v.clone() for k, v in ts.items()}
        wh, wf, _ = _jfwd(cfg, params, jnp.asarray(chain), jnp.asarray(pos),
                          js, mode="verify", self_mask=jnp.asarray(sm))
        gh, gf, _ = tgf.forward(tcfg, tp, _t(chain).long(), _t(pos), ts,
                                mode="verify", self_mask=_t(sm))
        _close(gh, wh)
        _check_feats(gf, wf)
        for name, v in before.items():      # read-only: bitwise unchanged
            assert torch.equal(ts[name], v)
        return
    valid = np.arange(4)[None] < np.asarray([4, 2, 1])[:, None]
    js2 = _jadvance(cfg, params, jnp.asarray(chain), js, jnp.asarray(valid))
    ts2 = tapi.advance(tcfg, tp, _t(chain).long(), ts, _t(valid))
    _check_state(ts2, js2)


def test_rolling_write_matches_the_reference():
    """Random positions, validity and windows: one writer per slot, the
    dropped tokens untouched, bit for bit the reference's writes."""
    rng = np.random.default_rng(11)
    b, t, W, hk, dh = 3, 40, 16, 1, 4
    start = rng.integers(0, 50, (b, 1))
    pos = (start + np.arange(t)[None]).astype(np.int32)
    valid = np.arange(t)[None] < np.asarray([40, 7, 0])[:, None]
    win = rng.normal(size=(b, W, hk, dh)).astype(np.float32)
    wpos = rng.integers(-1, 30, (b, W)).astype(np.int32)
    new = rng.normal(size=(b, t, hk, dh)).astype(np.float32)
    jw, jp = jgf._rolling_write(jnp.asarray(win), jnp.asarray(wpos),
                                jnp.asarray(new), jnp.asarray(pos),
                                jnp.asarray(valid))
    tw, tv, tpos = _t(win), _t(win), _t(wpos)
    tgf.rolling_write(tw, tv, tpos, _t(new), _t(new) * 2, _t(pos),
                      _t(valid))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tv.numpy(), np.where(
        np.asarray(jw) != win, np.asarray(jw) * 2, win))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jp))


def test_rglru_scan_equals_the_step_loop():
    """The in-place loop and the chunked scan under autograd (segments
    of 8 over 37 steps) give the plain recurrence's states to 1e-6, and
    gradients through the recomputed segments equal the unsegmented
    ones."""
    rng = np.random.default_rng(12)
    b, t, w = 2, 37, 5
    a = torch.as_tensor(rng.uniform(0.5, 0.99, (b, t, w)).astype(np.float32))
    g = torch.as_tensor(rng.normal(size=(b, t, w)).astype(np.float32))
    h0 = torch.as_tensor(rng.normal(size=(b, w)).astype(np.float32))
    s, want = h0, []
    for i in range(t):
        s = a[:, i] * s + g[:, i]
        want.append(s)
    want = torch.stack(want, dim=1)
    with torch.no_grad():
        _close(tgf.rglru_scan(a, g, h0), want.numpy(), 1e-6)
    grads = []
    for chunk in (8, 256):
        ar, gr = a.clone().requires_grad_(), g.clone().requires_grad_()

        def step(s, x):
            s = x[0] * s + x[1]
            return s, s
        _, hs = tcm.ckpt_chunked_scan(step, h0, (ar.transpose(0, 1),
                                                 gr.transpose(0, 1)),
                                      chunk=chunk)
        _close(hs.transpose(0, 1), want.numpy(), 1e-6)
        (hs ** 2).sum().backward()
        grads.append((ar.grad, gr.grad))
    for x, y in zip(*grads):
        _close(x, y.numpy(), 1e-6)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _max_rel_err(tree_t, tree_j):
    errs = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                     1e-30)),
        tree_t, jax.tree_util.tree_map(np.asarray, tree_j))
    return max(jax.tree_util.tree_leaves(errs))


def test_train_loss_and_grads_match_jax(gm):
    """``train_loss`` over 299 positions (the window of 128 bites, the
    RG-LRU runs two 256-step segments, each recomputed in the backward
    pass): the loss within 1e-5 relative, every gradient leaf within
    2e-4 of its largest magnitude (``jax.grad``); no kernel launched."""
    from repro_torch.train.trainer import grads_of, trainable
    cfg, tcfg = gm["cfg"], gm["tcfg"]
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 300)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.train_loss(cfg, p, jnp.asarray(toks)),
        has_aux=True))(gm["params"])
    tp = trainable(params_from_numpy(tcfg, gm["np_params"], device="cpu"))
    before = tops.launch_counts()
    tl, tm = tapi.train_loss(tcfg, tp, torch.as_tensor(toks))
    tl.backward()
    assert tops.launch_counts() == before
    assert set(tm) == {"lm_loss"}
    assert abs(float(tl.detach()) / float(jl) - 1) < 1e-5
    assert _max_rel_err(params_to_numpy(tcfg, grads_of(tp)), jg) < 2e-4


def test_weight_decay_follows_the_reference_rank(gm):
    """AdamW with zero gradients, where only the weight decay moves a
    parameter: the reference stacks the superblocks' layers and keeps a
    remainder (the 5-layer stack's (rec, rec)) unstacked, so its
    ``p.ndim >= 2`` decays the superblocks' vectors and spares the
    remainder's.  The port's ``adamw_update`` with ``unstacked_layers``
    (what ``Trainer`` passes, ``api.unstacked_layers``) gives the
    reference's tree to 1e-6."""
    from repro.train import optimizer as jopt
    from repro_torch.train import optimizer as topt
    tcfg, npp, jp = gm["tcfg"], gm["np_params"], gm["params"]
    jz = jax.tree_util.tree_map(jnp.zeros_like, jp)
    want, _ = jax.jit(lambda p, z: jopt.adamw_update(
        p, z, jopt.adamw_init(p), lr=1.0))(jp, jz)
    tp = params_from_numpy(tcfg, npp, device="cpu")
    tz = topt.tree_map(lambda p, stacked: torch.zeros_like(p), tp)
    got, _ = topt.adamw_update(tp, tz, topt.adamw_init(tp),
                               lr=np.float32(1.0),
                               unstacked_layers=tapi.unstacked_layers(tcfg))
    err = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(
        jax.tree_util.tree_leaves(params_to_numpy(tcfg, got)),
        jax.tree_util.tree_leaves(want)))
    assert err < 1e-6
    assert float(got["layers"][0]["ln1"][0]) == pytest.approx(0.9)
    for lp in got["layers"][len(got["layers"]) - tapi.unstacked_layers(
            tcfg):]:
        assert float(lp["ln1"][0]) == 1.0                 # remainder


def test_draft_training_features_match_jax(gm, small_dcfg):
    """The frozen Griffin target's fused features of a [2, 160] batch
    (one prefill of the whole batch: 160 tokens in one advance, past the
    window of 128) within 1e-4 of the reference's ``DraftTrainer``
    feature pass; one port ``DraftTrainer`` step over them gives a
    finite loss and gradient norm."""
    from repro.train.draft_train import DraftTrainer as JDraftTrainer
    from repro_torch.train.draft_train import DraftTrainer, target_features
    cfg, tcfg = gm["cfg"], gm["tcfg"]
    toks = np.random.default_rng(15).integers(
        0, cfg.vocab_size, (2, 160)).astype(np.int32)
    jt = JDraftTrainer(cfg, small_dcfg, gm["params"], dparams=gm["dparams"])
    want = jt._feat(gm["params"], jnp.asarray(toks))
    tp = params_from_numpy(tcfg, gm["np_params"], device="cpu")
    _close(target_features(tcfg, tp, torch.as_tensor(toks)), want)
    tdcfg = tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg))
    dt = DraftTrainer(tcfg, tdcfg, tp, dparams=draft_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, gm["dparams"]),
        device="cpu"), device="cpu")
    m = dt.step(torch.as_tensor(toks))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


# ---------------------------------------------------------------------------
# the engine, serving and sampling
# ---------------------------------------------------------------------------

def _tengine(gm, small_spec, small_dcfg, batch=B, **kw):
    tspec, tdcfg = _specs(small_spec, small_dcfg)
    return TEngine(gm["tcfg"], tspec, tdcfg, gm["tp"], gm["td"], batch=batch,
                   max_len=MAX_LEN, paged=False, device="cpu", **kw)


def test_generate_matches_jax_engine_and_ar(gm, small_spec, small_dcfg):
    """Greedy chain ``generate`` of a 300-token prompt (two prefill
    chunks, the first longer than the window): the JAX engine's tokens,
    steps and acceptance, and the port's own AR tokens."""
    je = JEngine(gm["cfg"], small_spec, small_dcfg, gm["params"],
                 gm["dparams"], batch=B, max_len=MAX_LEN)
    jtoks, jstats = je.generate(gm["prompt"], NEW)
    te = _tengine(gm, small_spec, small_dcfg)
    assert te.tree.branch == (1,) * small_dcfg.tree_depth
    assert not te.partial_enabled and not te.zero_copy
    tops.reset_launch_counts()
    ttoks, tstats = te.generate(gm["prompt"], NEW)
    assert all(v == 0 for v in tops.LAUNCHES.values())
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    assert tstats["modes"] == jstats["modes"] == {"state": tstats["steps"]}
    assert tstats["steps"] == jstats["steps"]
    assert tstats["mean_accept"] == pytest.approx(jstats["mean_accept"])
    tspec, _ = _specs(small_spec, small_dcfg)
    tar = t_ar(gm["tcfg"], gm["tp"], gm["prompt"], NEW, max_len=MAX_LEN,
               spec=tspec, device="cpu")
    np.testing.assert_array_equal(ttoks, tar)
    # the engine's state: the window holds the last W positions
    fs = te.final_state.cache
    W = gm["tcfg"].window_size
    np.testing.assert_array_equal(
        fs["win_pos"].max(dim=-1).values.numpy(),
        np.broadcast_to(fs["length"].numpy()[None] - 1,
                        fs["win_pos"].shape[:2]))
    assert int(fs["win_pos"].min()) >= int(fs["length"].min()) - W


def test_wave_serving_equals_solo_generate(small_spec, small_dcfg):
    """Three requests of different prompt lengths on the reduced model go
    through the wave path (one wave each); each equals its solo
    ``generate``."""
    from repro_torch.core.draft import init_draft_params
    from repro_torch.serving.engine import ServingConfig, ServingEngine
    from repro_torch.serving.request import Request
    tcfg = _cfg(tcfgs, "reduced")
    tspec, tdcfg = _specs(small_spec, small_dcfg)
    tp = tapi.init_params(tcfg, seed=0, device="cpu")
    td = init_draft_params(tcfg, tdcfg, seed=1, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, (n,)).astype(np.int32)
               for n in (40, 150, 90)]
    srv = ServingEngine(tcfg, tspec, tdcfg, tp, td,
                        ServingConfig(batch=2, max_len=256, prefill_chunk=64),
                        device="cpu")
    for i, p in enumerate(prompts):
        srv.submit(Request(request_id=f"r{i}", prompt=p, max_new_tokens=8))
    srv.run()
    assert srv._continuous is None and srv.stats["waves"] == 3
    solo = TEngine(tcfg, tspec, tdcfg, tp, td, batch=1, max_len=256,
                   paged=False, device="cpu")
    for i, p in enumerate(prompts):
        want, _ = solo.generate(p[None], 8, prefill_chunk=64)
        np.testing.assert_array_equal(srv.outputs[f"r{i}"].tokens, want[0])


def test_sampled_chain_is_repeatable(small_spec, small_dcfg):
    """A sampled chain at temperature 0.8 on the reduced model (each row
    its stream from seed 0): two runs give equal tokens, in state steps
    only."""
    from repro_torch.core.draft import init_draft_params
    tcfg = _cfg(tcfgs, "reduced")
    tspec, tdcfg = _specs(small_spec, small_dcfg)
    tp = tapi.init_params(tcfg, seed=0, device="cpu")
    td = init_draft_params(tcfg, tdcfg, seed=1, device="cpu")
    prompt = np.random.default_rng(6).integers(0, tcfg.vocab_size, (B, 100))
    runs = []
    for _ in range(2):
        eng = TEngine(tcfg, tspec, tdcfg, tp, td, batch=B, max_len=MAX_LEN,
                      paged=False, temperature=0.8, device="cpu")
        toks, stats = eng.generate(prompt, 12)
        assert stats["modes"] == {"state": stats["steps"]}
        runs.append(toks)
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].min() >= 0


def test_paged_and_continuous_refused(gm, small_spec, small_dcfg):
    from repro_torch.serving.scheduler import ContinuousScheduler
    with pytest.raises(ValueError, match="attention-only"):
        tapi.init_cache(gm["tcfg"], 1, 64, paged=True, device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        TEngine(gm["tcfg"], *_specs(small_spec, small_dcfg), gm["tp"],
                gm["td"], batch=1, max_len=64, paged=True, device="cpu")
    eng = _tengine(gm, small_spec, small_dcfg, batch=1)
    assert eng.mode_for(1, 10_000, False) == "state"
    with pytest.raises(ValueError, match="state archs"):
        ContinuousScheduler(eng)
    with pytest.raises(ValueError, match="attention-arch only"):
        tapi.prefill(gm["tcfg"], gm["tp"], torch.zeros((1, 4),
                                                       dtype=torch.long),
                     tapi.init_cache(gm["tcfg"], 1, 64, device="cpu"),
                     t_valid=torch.ones((1,), dtype=torch.int32))
