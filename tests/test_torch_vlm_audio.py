"""VLM and audio conditioning in the PyTorch port against the JAX package,
on the CPU.

Models, fp32, with the JAX init's weights: the reduced
``llama-3.2-vision-90b`` (2 layers (attn, cross), d 256, 16 image tokens
of width 64) and the reduced ``whisper-small`` (2 encoder and 2 decoder
layers, 32 frames, QKV bias, tied).  The reference's init leaves the
VLM's cross-attention gates at 0 (which makes a ``cross`` layer the
identity) and Whisper's QKV biases at 0; here they get random numpy
values, the same for both packages.  The per-request conditioning
(``extra``: image or frame embeddings) is drawn with numpy.  Weights
cross over with ``repro_torch.convert``.

* Configs, ``layer_kinds`` and the caches' layouts (cross K/V rows
  indexed by cross layer) equal the reference's; the params round-trip
  through the conversion bit for bit.
* ``project_image``, ``encode_frames`` and ``compute_cross_kv`` within
  1e-5; ``api.prefill(extra=, return_logits="all")`` over two chunks
  (the second reads the cached cross rows) and its cache's ``k`` / ``v``
  / ``kmax`` / ``kmin`` / ``cross_k`` / ``cross_v`` within 1e-4, on both
  layouts; ``api.decode`` in ``full`` / ``partial`` / ``fused`` within
  1e-4; ``train_loss(extra=)`` within 2e-4 and its gradients within
  2e-4 of each leaf's largest; two ``Trainer(extra=)`` steps: losses
  within 2e-4, params within 2e-4.
* ``SpecPVEngine.generate(extra=)`` (``small_spec`` with
  ``use_pallas=True``, ``small_dcfg``, batch 2, a 200-token prompt, 24
  new tokens) gives the JAX engine's tokens and mode counts (its
  default layout's, which its paged zero-copy engine equals) on the
  reference's default layout and on the paged zero-copy pool, with
  partial verification; with full verification it equals the port's
  ``autoregressive_generate(extra=)``.  The engine computes the cross
  K/V once per request; its cached rows equal the JAX cache's.
* Slot-admitted requests with different ``extra`` (two prefilled chunk
  by chunk in turn, one admitted while the others decode) equal their
  solo ``generate``.
* Refusals: a prefix cache with ``extra``, a fused prefill round with an
  ``extra`` cursor, a prefill or ``train_loss`` without ``extra``, and
  the compiled AR.
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
from repro.models import dense as jdn
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch import configs as tcfgs
from repro_torch.convert import (draft_params_from_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.core.reference import CompiledAR
from repro_torch.core.reference import autoregressive_generate as t_ar
from repro_torch.models import api as tapi
from repro_torch.models import dense as tdn
from repro_torch.train.trainer import TrainConfig, Trainer, grads_of, trainable

ARCHS = ("llama-3.2-vision-90b", "whisper-small")
F32 = dict(dtype="float32", param_dtype="float32")
B, PROMPT, NEW, MAX_LEN, CHUNK = 2, 200, 24, 384, 64
LAYOUTS = {"default": dict(),
           "zero_copy": dict(paged=True, zero_copy=True, prefix_cache=False)}


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


def _close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t.detach().float()),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_rel(a, b):
    """The largest leaf error, relative to the leaf's largest magnitude
    (at least a thousandth of the whole tree's: Whisper's cross-attention
    key bias has a gradient of 0 in exact arithmetic, rounding noise in
    both packages)."""
    scale = max(float(np.abs(y).max()) for y in jax.tree_util.tree_leaves(b))
    return max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda x, y: float(np.abs(x - y).max()
                           / max(np.abs(y).max(), 1e-3 * scale)), a, b)))


def _tspec(spec):
    return tcfgs.SpecPVConfig(**dataclasses.asdict(spec))


def _extra(cfg, b, seed):
    """numpy conditioning of ``b`` rows: the JAX and the port's forms."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.arch_type == "vlm":
        out["image_embeds"] = rng.normal(
            size=(b, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.has_encoder:
        out["frame_embeds"] = rng.normal(
            size=(b, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: _t(v) for k, v in out.items()})


def _randomise(cfg, tree):
    """Random gates (VLM) and QKV biases (Whisper: decoder self and
    cross, encoder) where the reference's init leaves zeros."""
    rng = np.random.default_rng(7)
    for slot in tree["decoder"]["slots"]:
        for name in ("gate_attn", "gate_mlp"):
            if name in slot:
                slot[name] = rng.uniform(0.3, 0.9, slot[name].shape).astype(
                    np.float32)
    stacks = [tree["decoder"]] + ([tree["encoder"]] if "encoder" in tree
                                  else [])
    for stack in stacks:
        for slot in stack["slots"]:
            for sub in ("attn", "xattn"):
                for name in ("bq", "bk", "bv"):
                    if name in slot.get(sub, {}):
                        p = slot[sub][name]
                        slot[sub][name] = (rng.normal(size=p.shape)
                                           * 0.3).astype(np.float32)
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def model(request, small_spec, small_dcfg):
    arch = request.param
    cfg = jcfgs.get_config(arch).reduced().replace(**F32)
    tcfg = tcfgs.get_config(arch).reduced().replace(**F32)
    np_params = _randomise(cfg, _np(japi.init_params(cfg,
                                                     jax.random.PRNGKey(0))))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    spec = small_spec.replace(use_pallas=True)
    return dict(
        arch=arch, cfg=cfg, tcfg=tcfg, np_params=np_params, jp=jp,
        tp=params_from_numpy(tcfg, np_params, device="cpu"),
        jd=dparams, spec=spec, tspec=_tspec(spec), dcfg=small_dcfg,
        tdcfg=tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg)),
        td=draft_params_from_numpy(tcfg, _np(dparams), device="cpu"),
        prompt=np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, PROMPT)).astype(np.int32),
        extra=_extra(cfg, B, 11))


def _jax_engine_run(m):
    """The JAX engine's tokens and stats with partial verification, on
    its default (contiguous) layout, once per model: its paged zero-copy
    engine gives the same tokens on these inputs, and its compiles take
    most of this file's time."""
    if "jax" not in m:
        je = JEngine(m["cfg"], m["spec"], m["dcfg"], m["jp"], m["jd"],
                     batch=B, max_len=MAX_LEN, partial_verification=True)
        toks, stats = je.generate(m["prompt"], NEW, prefill_chunk=CHUNK,
                                  extra=m["extra"][0])
        m["jax"] = (np.asarray(toks), stats)
    return m["jax"]


# ---------------------------------------------------------------------------
# configs, caches, conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_layer_kinds_and_superblocks(arch):
    j, t = jcfgs.get_config(arch), tcfgs.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    for depth in (j.num_layers, 35, 7, 5):
        kinds = j.replace(num_layers=depth).layer_kinds()
        assert t.replace(num_layers=depth).layer_kinds() == kinds
        assert tdn.superblock_decomp(kinds) == jdn.superblock_decomp(kinds)
        assert tdn.attn_layer_count(kinds) == jdn.attn_layer_count(kinds)
        assert tdn.cross_layer_count(kinds) == jdn.cross_layer_count(kinds)
    assert t.has_encoder == j.has_encoder
    assert tdn.is_cross_arch(t)


@pytest.mark.parametrize("paged", [False, True])
def test_init_cache_layout_matches_jax(model, paged):
    m = model
    kw = dict(paged=True, num_pages=B * 24 + 1) if paged else {}
    jc = japi.init_cache(m["cfg"], B, MAX_LEN, m["spec"], **kw)
    tc = tapi.init_cache(m["tcfg"], B, MAX_LEN, m["tspec"], device="cpu",
                         **kw)
    assert set(jc) == set(tc)
    for k in jc:
        shape = tuple(tc[k].shape)
        if k in ("k", "v") and not paged:   # block-rounded rows, a view
            shape = shape[:2] + (MAX_LEN,) + shape[3:]
        assert shape == tuple(jc[k].shape), k
    te = (m["cfg"].num_image_tokens if m["cfg"].arch_type == "vlm"
          else m["cfg"].num_audio_frames)
    assert tc["cross_k"].shape[2] == te


def test_params_round_trip_bit_for_bit(model):
    m = model
    back = params_to_numpy(m["tcfg"], m["tp"])
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(m["np_params"])
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b), path
    fresh = tapi.init_params(m["tcfg"], seed=0, device="cpu")
    same = jax.tree_util.tree_map(lambda a, b: a.shape == b.shape,
                                  params_to_numpy(m["tcfg"], fresh),
                                  m["np_params"])
    assert all(jax.tree_util.tree_leaves(same))


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_encoders_and_cross_kv_match_jax(model):
    m = model
    cfg, tcfg = m["cfg"], m["tcfg"]
    jx, tx = m["extra"]
    enc_j = japi._encoder_out(cfg, m["jp"], jx)
    enc_t = tapi._encoder_out(tcfg, m["tp"], tx)
    _close(enc_t, enc_j, 1e-5)
    if cfg.arch_type == "vlm":
        _close(tdn.project_image(tcfg, m["tp"], tx["image_embeds"]),
               jdn.project_image(cfg, m["jp"], jx["image_embeds"]), 1e-5)
    else:
        _close(tdn.encode_frames(tcfg, m["tp"], tx["frame_embeds"]),
               jdn.encode_frames(cfg, m["jp"], jx["frame_embeds"]), 1e-5)
    kinds = cfg.layer_kinds()
    pattern, n_super, _ = jdn.superblock_decomp(kinds)
    for g, (kind, lp) in enumerate(zip(kinds, m["tp"]["layers"])):
        if kind not in ("cross", "dec"):
            continue
        jlp = jax.tree_util.tree_map(
            lambda a: a[g // len(pattern)],
            m["jp"]["decoder"]["slots"][g % len(pattern)])
        for got, want in zip(tdn.compute_cross_kv(tcfg, lp, enc_t),
                             jdn.compute_cross_kv(cfg, jlp, enc_j)):
            _close(got, want, 1e-5)


def _prefill_both(m, *, paged, prompt, extra, chunk=CHUNK):
    cfg, tcfg, spec, tspec = m["cfg"], m["tcfg"], m["spec"], m["tspec"]
    b = prompt.shape[0]
    if paged:
        nb = -(-MAX_LEN // spec.block_size)
        num_pages = b * nb + 1
        jc = japi.init_cache(cfg, b, MAX_LEN, spec, paged=True,
                             num_pages=num_pages)
        tc = tapi.init_cache(tcfg, b, MAX_LEN, tspec, paged=True,
                             num_pages=num_pages, device="cpu")
        pt = np.random.default_rng(3).permutation(
            np.arange(1, num_pages)).reshape(b, nb).astype(np.int32)
        jc["page_table"] = jnp.asarray(pt)
        tc["page_table"] = _t(pt)
    else:
        jc = japi.init_cache(cfg, b, MAX_LEN, spec)
        tc = tapi.init_cache(tcfg, b, MAX_LEN, tspec, device="cpu")
    for off in range(0, prompt.shape[1], chunk):
        toks = prompt[:, off:off + chunk]
        lj, fj, jc = japi.prefill(cfg, m["jp"], jnp.asarray(toks), jc,
                                  extra=extra[0], spec=spec,
                                  return_logits="all")
        # the port writes the cross rows at the first chunk only
        lt, ft, tc = tapi.prefill(tcfg, m["tp"], _t(toks).long(), tc,
                                  extra=extra[1] if off == 0 else None,
                                  cached_cross=off > 0, spec=tspec,
                                  return_logits="all")
        assert lt.shape == (b, toks.shape[1], cfg.vocab_size)
        _close(lt, lj, 1e-4)
        for g, w in zip(ft, fj):
            _close(g, w, 1e-4)
    for key in ("kmax", "kmin", "length", "cross_k", "cross_v"):
        _close(tc[key], jc[key], 1e-4)
    for key in ("k", "v"):
        got = tc[key] if paged else tc[key][:, :, :MAX_LEN]
        _close(got, jc[key], 1e-4)
    return jc, tc


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_with_extra_matches_jax(model, paged):
    m = model
    _prefill_both(m, paged=paged, prompt=m["prompt"][:, :100],
                  extra=m["extra"])


def test_decode_modes_match_jax(model):
    """decode full (with queries), partial (zero-copy routed) and fused on
    the paged cache, cross rows read from the cache."""
    m = model
    cfg, tcfg, spec, tspec = m["cfg"], m["tcfg"], m["spec"], m["tspec"]
    rng = np.random.default_rng(5)
    n = 100
    jc, tc = _prefill_both(m, paged=True, prompt=m["prompt"][:, :n],
                           extra=m["extra"])
    L = jdn.attn_layer_count(cfg.layer_kinds())
    hk, dh = cfg.num_kv_heads, cfg.head_dim_
    ns = spec.partial_budget_tokens // spec.block_size
    nb_filled = -(-n // spec.block_size)
    pbi = np.stack([[[rng.permutation(nb_filled)[:ns] for _ in range(hk)]
                     for _ in range(B)] for _ in range(L)]).astype(np.int32)
    pbi[:, :, :, -2:] = -1
    p = spec.buffer_size
    pk = rng.normal(size=(L, B, hk, p, dh)).astype(np.float32)
    pv = rng.normal(size=(L, B, hk, p, dh)).astype(np.float32)
    ppos = np.full((L, B, hk, p), -1, np.int32)
    ppos[..., :7] = n + np.arange(7)
    t = 5
    toks = rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)
    pos = (n + 7 + np.arange(t))[None].repeat(B, 0).astype(np.int32)
    mask = np.tril(np.ones((t, t), bool))[None].repeat(B, 0)
    for mode, rows in (("full", None), ("partial", None),
                       ("fused", np.asarray([True, False]))):
        kw_j = dict(mode=mode, self_mask=jnp.asarray(mask), spec=spec)
        kw_t = dict(mode=mode, self_mask=_t(mask), spec=tspec)
        if mode == "full":
            kw_j["emit_queries"] = kw_t["emit_queries"] = True
        else:
            kw_j.update(pkv=(jnp.asarray(pk), jnp.asarray(pv),
                             jnp.asarray(ppos)), pkv_blocks=jnp.asarray(pbi))
            kw_t.update(pkv=(_t(pk), _t(pv), _t(ppos)), pkv_blocks=_t(pbi))
        if rows is not None:
            kw_j["partial_rows"] = jnp.asarray(rows)
            kw_t["partial_rows"] = _t(rows)
        oj = japi.decode(cfg, m["jp"], jnp.asarray(toks), jnp.asarray(pos),
                         jc, **kw_j)
        ot = tapi.decode(tcfg, m["tp"], _t(toks).long(), _t(pos), tc,
                         **kw_t)
        _close(ot.logits, oj.logits, 1e-4)
        for g, w in zip(ot.new_kv, oj.new_kv):
            _close(g, w, 1e-4)
        for g, w in zip(ot.features, oj.features):
            _close(g, w, 1e-4)
        if mode == "full":
            _close(ot.queries, oj.queries, 1e-4)


def test_extra_changes_the_first_logits(model):
    """Another image or audio clip gives other first-token logits: the
    conditioning reaches the output."""
    m = model
    toks = _t(m["prompt"][:, :40]).long()
    out = []
    for seed in (11, 12):
        c = tapi.init_cache(m["tcfg"], B, MAX_LEN, m["tspec"], device="cpu")
        out.append(tapi.prefill(m["tcfg"], m["tp"], toks, c,
                                extra=_extra(m["cfg"], B, seed)[1],
                                spec=m["tspec"])[0])
    assert float((out[0] - out[1]).abs().max()) > 1e-3


def test_train_loss_and_grads_match_jax(model):
    m = model
    cfg, tcfg = m["cfg"], m["tcfg"]
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, 48)).astype(np.int32)
    jx, tx = m["extra"]
    # compiled whole: op by op the reference's backward takes 4x longer
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.train_loss(cfg, p, jnp.asarray(toks), extra=jx),
        has_aux=True))(m["jp"])
    tp = trainable(params_from_numpy(tcfg, m["np_params"], device="cpu"))
    tl, tm = tapi.train_loss(tcfg, tp, _t(toks).long(), extra=tx)
    tl.backward()
    assert abs(float(tl.detach()) / float(jl) - 1) < 2e-4
    assert abs(float(tm["lm_loss"].detach()) / float(jm["lm_loss"])
               - 1) < 2e-4
    assert _max_rel(params_to_numpy(tcfg, grads_of(tp)), _np(jg)) < 2e-4


def test_trainer_steps_with_extra_match_jax(model):
    """Two ``Trainer(extra=)`` steps (loss, backward, clip, AdamW) give
    the reference trainer's losses and params."""
    m = model
    cfg, tcfg = m["cfg"], m["tcfg"]
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, 40)).astype(np.int32)
    jx, tx = m["extra"]
    # the reference's step donates its params: give it its own copy
    jt = JTrainer(cfg, JTrainConfig(warmup=1, total_steps=4, log_every=1),
                  params=jax.tree_util.tree_map(jnp.array, m["np_params"]),
                  extra=jx)
    tt = Trainer(tcfg, TrainConfig(warmup=1, total_steps=4, log_every=1),
                 params=params_from_numpy(tcfg, m["np_params"], device="cpu"),
                 device="cpu", extra=tx)
    jr = jt.fit(iter([toks, toks]), steps=2)
    tr = tt.fit(iter([toks, toks]), steps=2)
    for a, b in zip(jr["history"], tr["history"]):
        assert abs(b["loss"] / a["loss"] - 1) < 2e-4
    # AdamW moves a weight of near-zero gradient by about lr in either
    # direction: held absolutely, as tests/test_torch_train.py holds it
    err = max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - b).max()),
        params_to_numpy(tcfg, tt.params), _np(jt.params))))
    assert err < 2e-4


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _tengine(m, batch=B, **kw):
    return TEngine(m["tcfg"], m["tspec"], m["tdcfg"], m["tp"], m["td"],
                   batch=batch, max_len=MAX_LEN, device="cpu", **kw)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_generate_with_extra_matches_jax_engine(model, layout):
    m = model
    jtoks, jstats = _jax_engine_run(m)
    te = _tengine(m, **LAYOUTS[layout])
    toks, stats = te.generate(m["prompt"], NEW, prefill_chunk=CHUNK,
                              extra=m["extra"][1])
    np.testing.assert_array_equal(toks, jtoks)
    assert stats["modes"] == jstats["modes"]
    assert {"refresh", "partial"} <= set(stats["modes"])


def test_engine_cross_rows_equal_jax_cache(model):
    """The engine writes the cross K/V once, before its first chunk; after
    its chunked prefill the state's rows equal the JAX cache's (which
    every chunk rewrites with the same values: a function of ``extra``
    alone)."""
    m = model
    te = _tengine(m, partial_verification=False)
    st = te.prefill(m["prompt"], chunk=CHUNK, extra=m["extra"][1])
    jc = japi.init_cache(m["cfg"], B, MAX_LEN, m["spec"])
    _, _, jc = japi.prefill(m["cfg"], m["jp"],
                            jnp.asarray(m["prompt"][:, :16]), jc,
                            extra=m["extra"][0], spec=m["spec"])
    for n in ("cross_k", "cross_v"):
        _close(st.cache[n], jc[n], 1e-5)


def test_full_verification_equals_port_ar(model):
    m = model
    te = _tengine(m, partial_verification=False)
    toks, stats = te.generate(m["prompt"], NEW, prefill_chunk=CHUNK,
                              extra=m["extra"][1])
    assert stats["modes"] == {"full": stats["steps"]}
    ar = t_ar(m["tcfg"], m["tp"], m["prompt"], NEW, max_len=MAX_LEN,
              prefill_chunk=CHUNK, spec=m["tspec"], device="cpu",
              extra=m["extra"][1])
    np.testing.assert_array_equal(toks, ar)


def _solo(m, layout, prompt, extra, new):
    te = _tengine(m, batch=1, **LAYOUTS[layout])
    return te.generate(prompt[None], new, prefill_chunk=CHUNK,
                       extra=extra)[0][0]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_slot_requests_with_extra_equal_solo(model, layout):
    """Three requests, each with its own ``extra``, at batch 3: two
    prefilled chunk by chunk in turn (each chunk through
    ``prefill_step_into_slot``), the third admitted whole while the
    first two decode; every request's tokens equal its solo
    ``generate``."""
    m = model
    rng = np.random.default_rng(21)
    lens = (150, 200, 90)
    reqs = [(rng.integers(0, m["cfg"].vocab_size, (n,)).astype(np.int32),
             _extra(m["cfg"], 1, 30 + i)[1]) for i, n in enumerate(lens)]
    te = _tengine(m, batch=3, **LAYOUTS[layout])
    st = te.empty_state()
    out = {i: [] for i in range(3)}
    curs = []
    for i in (0, 1):
        st, cur = te.prefill_begin_slot(st, i, reqs[i][0], chunk=CHUNK,
                                        extra=reqs[i][1],
                                        max_new_tokens=NEW)
        curs.append(cur)
    while not all(c.done for c in curs):
        for c in curs:
            if not c.done:
                st, _ = te.prefill_step_into_slot(st, c)
    for i, c in enumerate(curs):
        st, first = te.prefill_finalize_slot(st, c)
        out[i].append(first)

    def step(rows):
        nonlocal st
        st, so = te.step_fused(st, rows, te.modes_for_rows(st, rows))
        for i in np.nonzero(rows)[0]:
            out[i].extend(so.tokens[i, :so.counts[i]].tolist())
    for _ in range(3):
        step(np.asarray([True, True, False]))
    st, first = te.prefill_into_slot(st, 2, reqs[2][0], chunk=CHUNK,
                                     extra=reqs[2][1], max_new_tokens=NEW)
    out[2].append(first)
    while min(len(v) for v in out.values()) < NEW:
        step(np.asarray([len(out[i]) < NEW for i in range(3)]))
    for i, (p, ex) in enumerate(reqs):
        want = _solo(m, layout, p, ex, NEW)
        np.testing.assert_array_equal(np.asarray(out[i][:NEW]), want,
                                      err_msg=f"request {i}")


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_prefix_cache_refuses_extra(model):
    """Prefix sharing keys prompt tokens only: an admission with
    ``extra`` into an engine with a prefix cache is refused, as the
    reference asserts."""
    m = model
    p = m["prompt"][0, :80]
    jx1 = {k: v[:1] for k, v in m["extra"][0].items()}
    tx1 = {k: v[:1] for k, v in m["extra"][1].items()}
    je = JEngine(m["cfg"], m["spec"], m["dcfg"], m["jp"], m["jd"], batch=1,
                 max_len=MAX_LEN, paged=True, prefix_cache=True)
    with pytest.raises(AssertionError, match="prefix sharing cannot key"):
        je.prefill_begin_slot(je.empty_state(), 0, p, chunk=CHUNK,
                              extra=jx1)
    te = _tengine(m, batch=1, paged=True, prefix_cache=True)
    with pytest.raises(ValueError, match="prefix sharing cannot key"):
        te.prefill_begin_slot(te.empty_state(), 0, p, chunk=CHUNK,
                              extra=tx1)


def test_fused_prefill_refuses_extra_cursors(model):
    m = model
    te = _tengine(m, batch=2)
    st = te.empty_state()
    tx1 = {k: v[:1] for k, v in m["extra"][1].items()}
    st, cur = te.prefill_begin_slot(st, 0, m["prompt"][0, :100],
                                    chunk=CHUNK, extra=tx1)
    assert cur.extra is tx1
    with pytest.raises(ValueError, match="cannot batch per-request"):
        te.prefill_step_fused(st, [cur])
    st, n = te.prefill_step_into_slot(st, cur)
    assert n == CHUNK


def test_prefill_and_loss_without_extra_raise(model):
    """The reference fails inside ``compute_cross_kv`` on a None encoder
    output; the port names the missing ``extra``."""
    m = model
    tcfg = m["tcfg"]
    toks = _t(m["prompt"][:, :20]).long()
    c = tapi.init_cache(tcfg, B, MAX_LEN, m["tspec"], device="cpu")
    with pytest.raises(ValueError, match="needs the per-request"):
        tapi.prefill(tcfg, m["tp"], toks, c, spec=m["tspec"])
    with pytest.raises(ValueError, match="needs the per-request"):
        tapi.train_loss(tcfg, m["tp"], toks)
    with pytest.raises(ValueError, match="conditioning `extra`"):
        _tengine(m).generate(m["prompt"][:, :40], 4, prefill_chunk=CHUNK)
    with pytest.raises(NotImplementedError, match="autoregressive_generate"):
        CompiledAR(tcfg, m["tp"], batch=1, max_len=MAX_LEN, spec=m["tspec"],
                   device="cpu")
