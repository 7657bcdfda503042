"""The launch steps and the int8 resident decode cache of the PyTorch port
(``repro_torch.launch``), on the CPU against the JAX package, fp32:

* the three context attentions over an int8 cache with its scales
  (``dense_attn_part_quant``, ``dense_attn_part_perhead``,
  ``flash_attention``) at 1 and 2 query heads per KV head, with ragged
  valid lengths over a span that is not a multiple of the chunk (1e-5);
* ``api.decode`` on an int8 contiguous cache at T = 1 and T = 12 (the
  two routes), the reference's materialised per-head partial cache in
  both forms and the fused step over it with mixed rows, and the
  in-trunk selection (``select_partial``; logits 1e-4, positions equal);
* the one-mode verify layout (``build_verify_inputs``, with ``active``);
* ``launch.steps``' tokens over a prefill and 8 decode steps (full,
  partial, the state arch) and two train steps (loss and parameters
  within 2e-4);
* each hillclimb step builder against the reference's own on the same
  state: bonus tokens equal, int8 payloads, scales and positions bit for
  bit; the case builders run on the CPU at small shapes and write their
  state in place; the reference's ``INPUT_SHAPES`` and case names;
* refusals: a paged int8 cache; sharded gradients without a mesh.

``repro.launch.hillclimb`` sets 512 host devices when imported; it is
imported only after JAX has made its one device, and ``XLA_FLAGS`` is
restored after.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import tree as jtr
from repro.kvcache import quant as jquant
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import common as jcm
from repro.train import optimizer as jopt
from repro_torch import configs as tcfgs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.distributed import sharding as tsh
from repro_torch.core import tree as ttr
from repro_torch.kvcache import quant as tquant
from repro_torch.launch import hillclimb as thc
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.train import optimizer as topt

B = 2
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jhc():
    """``repro.launch.hillclimb``, imported after JAX made its device."""
    assert jax.device_count() == 1
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.hillclimb as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    assert jax.device_count() == 1
    return mod


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy() if a.is_floating_point() \
            else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol)


def _tspec(spec):
    return tcfgs.SpecPVConfig(**dataclasses.asdict(spec))


def _bf16(a):
    """fp32 numpy values -> (jax bf16, torch bf16), the same bits."""
    return jnp.asarray(a).astype(jnp.bfloat16), _t(a).to(torch.bfloat16)


def _quant(x):
    """Random values quantised by the reference: (int8 payload, the bf16
    scales as fp32 numpy, exact)."""
    q, s = jquant.quantize_kv(jnp.asarray(x))
    return np.asarray(q), np.asarray(s.astype(jnp.float32))


@pytest.fixture(scope="module")
def tiny():
    cfg = jcfgs.get_config("tiny-dense")
    tcfg = tcfgs.get_config("tiny-dense")
    np_params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: japi.init_params(cfg, k))(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    return cfg, tcfg, np_params, params


def _jdecode(cfg, params, toks, pos, cache, **kw):
    """The reference's ``api.decode`` compiled once (its ops one by one
    compile each on first use)."""
    arrays = {k: v for k, v in kw.items() if not isinstance(v, (str, bool))
              and k != "spec"}
    static = {k: v for k, v in kw.items() if k not in arrays}
    return jax.jit(lambda p, t, q, c, a: japi.decode(
        cfg, p, t, q, c, **static, **a))(params, jnp.asarray(toks),
                                         jnp.asarray(pos), cache, arrays)


def _tparams(tiny):
    cfg, tcfg, np_params, _ = tiny
    return params_from_numpy(tcfg, np_params, device="cpu")


# ---------------------------------------------------------------------------
# configs, case names
# ---------------------------------------------------------------------------

def test_input_shapes_and_case_names_equal_the_reference(jhc):
    assert tcfgs.INPUT_SHAPES == jcfgs.INPUT_SHAPES
    assert list(thc.CASES) == list(jhc.CASES)
    assert thc.TREE.branch == jhc.TREE.branch
    assert thc.TREE.parents == jhc.TREE.parents


# ---------------------------------------------------------------------------
# the three attentions with scales
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("fn", ["quant", "perhead", "flash"])
def test_attention_with_scales_matches_jax(fn, rep):
    rng = np.random.default_rng(10 + rep)
    h, dh, s, t = 4, 16, 200, 12          # S = 200: not a multiple of 64
    hk = h // rep
    q = rng.normal(size=(B, t, h, dh)).astype(np.float32)
    valid_len = np.array([200, 131])
    if fn == "perhead":
        kq, ks = _quant(rng.normal(size=(B, hk, s, dh)).astype(np.float32))
        vq, vs = _quant(rng.normal(size=(B, hk, s, dh)).astype(np.float32))
        valid = np.arange(s)[None, None] < valid_len[:, None, None]
        valid = np.broadcast_to(valid, (B, hk, s)).copy()
        valid[:, :, 3] = False
        want = jax.jit(lambda *a: jcm.dense_attn_part_perhead(
            *a[:4], k_scale=a[4], v_scale=a[5]))(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
            jnp.asarray(valid), _bf16(ks)[0], _bf16(vs)[0])
        got = tcm.dense_attn_part_perhead(
            _t(q), _t(kq), _t(vq), _t(valid), k_scale=_bf16(ks)[1],
            v_scale=_bf16(vs)[1])
    else:
        kq, ks = _quant(rng.normal(size=(B, s, hk, dh)).astype(np.float32))
        vq, vs = _quant(rng.normal(size=(B, s, hk, dh)).astype(np.float32))
        kv_valid = np.arange(s)[None] < valid_len[:, None]
        if fn == "quant":
            want = jax.jit(jcm.dense_attn_part_quant)(
                jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                _bf16(ks)[0], _bf16(vs)[0], jnp.asarray(kv_valid))
            got = tcm.dense_attn_part_quant(
                _t(q), _t(kq), _t(vq), _bf16(ks)[1], _bf16(vs)[1],
                _t(kv_valid))
        else:
            qpos = np.broadcast_to(190 + np.arange(t), (B, t)).astype(
                np.int32)
            kpos = np.broadcast_to(np.arange(s), (B, s)).astype(np.int32)
            want = jax.jit(lambda q_, k_, v_, qp, kp, kv, a, b: (
                jcm.flash_attention(q_, k_, v_, q_positions=qp,
                                    kv_positions=kp, kv_valid=kv, chunk=64,
                                    return_partials=True, k_scale=a,
                                    v_scale=b)))(
                jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                jnp.asarray(qpos), jnp.asarray(kpos), jnp.asarray(kv_valid),
                _bf16(ks)[0], _bf16(vs)[0])
            got = tcm.flash_attention(
                _t(q), _t(kq), _t(vq), q_positions=_t(qpos),
                kv_positions=_t(kpos), kv_valid=_t(kv_valid), chunk=64,
                return_partials=True, k_scale=_bf16(ks)[1],
                v_scale=_bf16(vs)[1])
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


# ---------------------------------------------------------------------------
# api.decode: the int8 cache, the materialised partial cache, selection
# ---------------------------------------------------------------------------

def _int8_caches(cfg, tcfg, spec, lengths, max_len, seed):
    """The same int8 contiguous cache on both sides: random K/V rows
    quantised by the reference, ``length`` ragged."""
    rng = np.random.default_rng(seed)
    jc = japi.init_cache(cfg, B, max_len, spec)
    shp = jc["k"].shape
    kq, ks = _quant(rng.normal(size=shp).astype(np.float32))
    vq, vs = _quant(rng.normal(size=shp).astype(np.float32))
    jc.update(k=jnp.asarray(kq), v=jnp.asarray(vq), k_scale=_bf16(ks)[0],
              v_scale=_bf16(vs)[0],
              length=jnp.asarray(lengths, jnp.int32))
    tc = thc.init_int8_cache(tcfg, B, max_len, _tspec(spec), device="cpu")
    for n, a in (("k", kq), ("v", vq), ("k_scale", _bf16(ks)[1]),
                 ("v_scale", _bf16(vs)[1]), ("length", np.asarray(lengths))):
        tc[n].copy_(a if torch.is_tensor(a) else _t(a))
    return jc, tc


@pytest.mark.parametrize("t", [1, 12])
def test_decode_on_int8_cache_matches_jax(tiny, small_spec, t):
    """T <= 8 folds the scales into the dot; T = 12 dequantises tile by
    tile in the chunked attention (to bf16 in this fp32 model)."""
    cfg, tcfg, _, params = tiny
    tp = _tparams(tiny)
    jc, tc = _int8_caches(cfg, tcfg, small_spec, [150, 97], 700, 20 + t)
    rng = np.random.default_rng(t)
    toks = rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)
    pos = (np.array([150, 97])[:, None] + np.arange(t)).astype(np.int32)
    oj = _jdecode(cfg, params, toks, pos, jc, mode="full", spec=small_spec)
    ot = tapi.decode(tcfg, tp, _t(toks).long(), _t(pos), tc, mode="full",
                     spec=_tspec(small_spec))
    _close(ot.logits, oj.logits)
    for g, w in zip(ot.new_kv, oj.new_kv):
        _close(g, w, 1e-5)


def _pkv(cfg, spec, rng, int8: bool):
    """A materialised per-head partial cache [L, B, Hk, P, ...] (P =
    budget + buffer) with ragged valid slots, as numpy (fp32 or int8 with
    fp32-exact bf16 scales)."""
    L, hk, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    p = spec.partial_budget_tokens + spec.buffer_size
    k = rng.normal(size=(L, B, hk, p, dh)).astype(np.float32)
    v = rng.normal(size=(L, B, hk, p, dh)).astype(np.float32)
    ppos = np.full((L, B, hk, p), -1, np.int32)
    ppos[:, 0, :, :spec.partial_budget_tokens - 20] = 7
    ppos[:, 1, :, 5:spec.partial_budget_tokens + 9] = 3
    if not int8:
        return (k, v, ppos)
    (kq, ks), (vq, vs) = _quant(k), _quant(v)
    return (kq, vq, ppos, ks, vs)


def _pkv_pair(pkv):
    if len(pkv) == 3:
        return (tuple(jnp.asarray(a) for a in pkv),
                tuple(_t(a) for a in pkv))
    j = tuple(jnp.asarray(a) for a in pkv[:3]) + tuple(
        _bf16(a)[0] for a in pkv[3:])
    t = tuple(_t(a) for a in pkv[:3]) + tuple(_bf16(a)[1] for a in pkv[3:])
    return j, t


def _bf_caches(cfg, tcfg, spec, lengths, max_len, seed):
    """The same fp32 contiguous cache on both sides (random K/V,
    summaries zero), ``length`` ragged."""
    rng = np.random.default_rng(seed)
    jc = japi.init_cache(cfg, B, max_len, spec)
    k = rng.normal(size=jc["k"].shape).astype(np.float32)
    v = rng.normal(size=jc["v"].shape).astype(np.float32)
    jc.update(k=jnp.asarray(k), v=jnp.asarray(v),
              length=jnp.asarray(lengths, jnp.int32))
    tc = tapi.init_cache(tcfg, B, max_len, _tspec(spec), device="cpu")
    tc["k"].copy_(_t(k))
    tc["v"].copy_(_t(v))
    tc["length"].copy_(_t(np.asarray(lengths, np.int32)))
    return jc, tc


@pytest.mark.parametrize("int8, mode", [(False, "partial"), (True, "fused")])
def test_materialised_partial_cache_matches_jax(tiny, small_spec, int8, mode):
    """The reference's materialised partial cache, with no
    ``pkv_blocks``: its bf16 (here fp32) form through ``mode="partial"``,
    its int8 form through ``"fused"`` with rows [partial, full] (the
    hillclimb tests below read both forms through ``"partial"`` too)."""
    cfg, tcfg, _, params = tiny
    tp = _tparams(tiny)
    jc, tc = _bf_caches(cfg, tcfg, small_spec, [180, 121], 320, 30)
    rng = np.random.default_rng(31 + int8)
    jpkv, tpkv = _pkv_pair(_pkv(cfg, small_spec, rng, int8))
    t = 5
    toks = rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)
    pos = (np.array([190, 130])[:, None] + np.arange(t)).astype(np.int32)
    kw = {}
    if mode == "fused":
        kw = dict(partial_rows=np.array([True, False]))
    oj = _jdecode(cfg, params, toks, pos, jc, mode=mode, pkv=jpkv,
                  spec=small_spec, **{k: jnp.asarray(v) for k, v in kw.items()})
    ot = tapi.decode(tcfg, tp, _t(toks).long(), _t(pos), tc, mode=mode,
                     pkv=tpkv, spec=_tspec(small_spec),
                     **{k: _t(v) for k, v in kw.items()})
    _close(ot.logits, oj.logits)
    for g, w in zip(ot.new_kv, oj.new_kv):
        _close(g, w, 1e-5)


def test_select_partial_matches_jax(tiny, small_spec):
    """The in-trunk Refresh: the selection's positions equal JAX's, the
    gathered K/V within 1e-6, on the contiguous cache of a real prefill
    (the reference's K/V and summaries copied into the port's cache, so
    that the gather reads the same bits)."""
    cfg, tcfg, _, params = tiny
    tp = _tparams(tiny)
    spec = small_spec
    rng = np.random.default_rng(40)
    prompt = rng.integers(0, cfg.vocab_size, (B, 200)).astype(np.int32)
    jc = japi.init_cache(cfg, B, 320, spec)
    tc = tapi.init_cache(tcfg, B, 320, _tspec(spec), device="cpu")
    _, _, jc = jax.jit(lambda p, t, c: japi.prefill(cfg, p, t, c, spec=spec))(
        params, jnp.asarray(prompt), jc)
    _, _, tc = tapi.prefill(tcfg, tp, _t(prompt).long(), tc,
                            spec=_tspec(spec))
    for n in ("k", "v", "kmax", "kmin"):
        _close(tc[n], jc[n])
        tc[n].copy_(_t(jc[n]))
    toks = rng.integers(0, cfg.vocab_size, (B, 3)).astype(np.int32)
    pos = (200 + np.arange(3))[None].repeat(B, 0).astype(np.int32)
    qw = np.array([[1, 1, 0], [1, 0, 1]], np.float32)
    oj = _jdecode(cfg, params, toks, pos, jc, mode="full", spec=spec,
                  select_partial=True, q_weight=jnp.asarray(qw))
    ot = tapi.decode(tcfg, tp, _t(toks).long(), _t(pos), tc, mode="full",
                     spec=_tspec(spec), select_partial=True,
                     q_weight=_t(qw))
    np.testing.assert_array_equal(_np(ot.partial[2]), _np(oj.partial[2]))
    for g, w in zip(ot.partial[:2], oj.partial[:2]):
        _close(g, w, 1e-6)
    _close(ot.logits, oj.logits)


def test_build_verify_inputs_matches_jax():
    """The one-mode verify layout: three pending slots (row 1 with one
    valid), the hillclimb tree, one dead row (``active``); every field
    equal to the reference's."""
    from repro.core import verify as jvf
    from repro_torch.core import verify as tvf
    rng = np.random.default_rng(45)
    b, p = 3, 3
    pending = rng.integers(0, 500, (b, p)).astype(np.int32)
    plen = np.array([3, 1, 2], np.int32)
    tree = rng.integers(0, 500, (b, thc.TREE.size)).astype(np.int32)
    seq = np.array([40, 17, 3], np.int32)
    active = np.array([True, True, False])
    jtree = jtr.TreeSpec.from_branch((4, 2, 2, 1, 1))
    want = jvf.build_verify_inputs(jtree, jnp.asarray(pending),
                                   jnp.asarray(plen), jnp.asarray(tree),
                                   jnp.asarray(seq), jnp.asarray(active))
    got = tvf.build_verify_inputs(thc.TREE, _t(pending), _t(plen), _t(tree),
                                  _t(seq), _t(active))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# launch.steps
# ---------------------------------------------------------------------------

def _rwkv():
    def fp32(c):
        return c.reduced().replace(dtype="float32", param_dtype="float32")
    cfg = fp32(jcfgs.get_config("rwkv6-3b"))
    tcfg = fp32(tcfgs.get_config("rwkv6-3b"))
    np_params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: japi.init_params(cfg, k))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    for name, scale in (("u", 0.5), ("lora_B", 0.1), ("wd_B", 0.1)):
        lay = np_params["layers"]
        lay[name] = (rng.normal(size=lay[name].shape) * scale).astype(
            np.float32)
    return (cfg, tcfg, jax.tree_util.tree_map(jnp.asarray, np_params),
            params_from_numpy(tcfg, np_params, device="cpu"))


@pytest.mark.parametrize("kind", ["full", "partial", "state"])
def test_steps_tokens_match_jax(tiny, small_spec, kind):
    """A prefill step over 160 tokens, then 8 decode steps, each side
    feeding its own next token; the partial steps start from the
    reference's selection padded with its buffer.  Every step returns
    the tensors it was given."""
    if kind == "state":
        cfg, tcfg, params, tp = _rwkv()
    else:
        cfg, tcfg, _, params = tiny
        tp = _tparams(tiny)
    spec, tspec = small_spec, _tspec(small_spec)
    prompt = np.random.default_rng(50).integers(
        0, cfg.vocab_size, (B, 160)).astype(np.int32)
    jc = japi.init_cache(cfg, B, 320, spec)
    tc = tapi.init_cache(tcfg, B, 320, tspec, device="cpu")
    jn, jc = jax.jit(jsteps.make_prefill_step(cfg, spec))(
        params, jc, jnp.asarray(prompt), None)
    tn, tc2 = tsteps.make_prefill_step(tcfg, tspec)(
        tp, tc, _t(prompt).long(), None)
    assert tc2 is tc and tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    partial = kind == "partial"
    jstep = jax.jit(jsteps.make_decode_step(cfg, spec, partial=partial))
    tstep = tsteps.make_decode_step(tcfg, tspec, partial=partial)
    jtok, ttok = jn, tn
    if partial:
        sel = _jdecode(cfg, params, jn[:, None], jc["length"][:, None], jc,
                       mode="full", spec=spec, select_partial=True).partial
        p = tuple(np.asarray(a) for a in sel)
        pad = spec.buffer_size
        jpkv = (jnp.pad(sel[0], ((0, 0),) * 3 + ((0, pad), (0, 0))),
                jnp.pad(sel[1], ((0, 0),) * 3 + ((0, pad), (0, 0))),
                jnp.pad(sel[2], ((0, 0),) * 3 + ((0, pad),),
                        constant_values=-1),
                jnp.zeros((B,), jnp.int32))
        tpkv = tsteps.partial_state(tspec, tuple(_t(a) for a in p))
        for g, w in zip(tpkv, jpkv):
            np.testing.assert_array_equal(_np(g), _np(w))
    for _ in range(8):
        if partial:
            jtok, jc, *jpkv = jstep(params, jc, *jpkv, jtok)
            out = tstep(tp, tc, *tpkv, ttok)
            assert all(a is b for a, b in zip(out[2:], tpkv))
            ttok = out[0]
        else:
            jtok, jc = jstep(params, jc, jtok)
            ttok, tc2 = tstep(tp, tc, ttok)
            assert tc2 is tc
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray(jc["length"]))
    if partial:
        np.testing.assert_array_equal(_np(tpkv[2]), _np(jpkv[2]))
        np.testing.assert_array_equal(_np(tpkv[3]), _np(jpkv[3]))


def test_train_step_matches_jax(tiny):
    """Two train steps from the same init on the same batches: loss and
    every parameter within 2e-4; the parameters are updated in place and
    left without ``requires_grad``."""
    cfg, tcfg, np_params, params = tiny
    tp = _tparams(tiny)
    rng = np.random.default_rng(60)
    batches = [rng.integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
               for _ in range(2)]
    jstep = jax.jit(jsteps.make_train_step(cfg))
    tstep = tsteps.make_train_step(tcfg)
    jp, jo = params, jopt.adamw_init(params)
    to = topt.adamw_init(tp)
    ptr = tp["embed"].data_ptr()
    for toks in batches:
        jp, jo, jl = jstep(jp, jo, jnp.asarray(toks), None)
        tp2, to, tl = tstep(tp, to, _t(toks), None)
        assert tp2 is tp
        assert abs(float(tl) - float(jl)) < 2e-4
    assert tp["embed"].data_ptr() == ptr
    assert not any(p.requires_grad for p in topt.tree_leaves(tp))
    got = jax.tree_util.tree_leaves(params_to_numpy(tcfg, tp))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jp))
    assert max(float(np.abs(a - b).max()) for a, b in zip(got, want)) < 2e-4
    # sharded gradients (FSDP, tests/test_torch_fsdp.py) take a spec tree
    # from param_specs, which carries its mesh
    mesh = tsh.DeviceMesh((2, 1), devices=["cpu"] * 2)
    specs = tsh.param_specs(tsh.ShardingRules(mesh, fsdp=True), tp)
    assert callable(tsteps.make_train_step(tcfg, grad_shardings=specs))
    with pytest.raises(ValueError, match="param_specs"):
        tsteps.make_train_step(tcfg, grad_shardings={})


# ---------------------------------------------------------------------------
# hillclimb steps against the reference's
# ---------------------------------------------------------------------------

def _verify_state(cfg, tcfg, spec, seed):
    """A cache of 260 random tokens per row (summaries from the
    reference), pending tokens, draft trees, a materialised partial cache
    (fp32 and int8)."""
    jc, tc = _bf_caches(cfg, tcfg, spec, [260, 260], 640, seed)
    from repro.kvcache.cache import update_layer_summaries
    nkmax, nkmin = jax.vmap(lambda kx, kn, kl: update_layer_summaries(
        kx, kn, kl, jnp.zeros((B,), jnp.int32), jc["length"],
        spec.block_size))(jc["kmax"], jc["kmin"], jc["k"])
    jc.update(kmax=nkmax, kmin=nkmin)
    tc["kmax"].copy_(_t(nkmax))
    tc["kmin"].copy_(_t(nkmin))
    rng = np.random.default_rng(seed + 1)
    pending = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
    tree = rng.integers(0, cfg.vocab_size, (B, thc.TREE.size)).astype(
        np.int32)
    return jc, tc, pending, tree, rng


@pytest.mark.parametrize("case", ["A0", "A1", "A2", "B1", "C1"])
def test_hillclimb_steps_match_the_reference(tiny, small_spec, jhc, case):
    """Three steps of each step builder, the next pending (or token) the
    step's own output: tokens equal JAX's every step; the int8 payloads,
    scales and positions written equal the reference's bit for bit (the
    fp32 ones within 1e-5); each step returns the tensors it was given."""
    cfg, tcfg, _, params = tiny
    tp = _tparams(tiny)
    spec, tspec = small_spec, _tspec(small_spec)
    jtree = jtr.TreeSpec.from_branch((4, 2, 2, 1, 1))
    if case == "A0":
        jc, tc, pend, tree, _ = _verify_state(cfg, tcfg, spec, 70)
        jf = jax.jit(jhc.make_verify_step(cfg, spec, jtree, partial=False))
        tf = thc.make_verify_step(tcfg, tspec, thc.TREE, partial=False)
        jt, tt = jnp.asarray(pend), _t(pend)
        for _ in range(3):
            jt, jc = jf(params, jc, jt, jnp.asarray(tree))
            tt, tc2 = tf(tp, tc, tt, _t(tree))
            assert tc2 is tc
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tc["length"].numpy(),
                                      np.asarray(jc["length"]))
        for n in ("k", "v", "kmax", "kmin"):
            _close(tc[n], jc[n], 1e-5)
        return
    if case in ("A1", "A2"):
        int8 = case == "A2"
        jc, tc, pend, tree, rng = _verify_state(cfg, tcfg, spec, 80)
        jpkv, tpkv = _pkv_pair(_pkv(cfg, spec, rng, int8))
        jf = jax.jit(jhc.make_verify_step(cfg, spec, jtree, partial=True,
                                          int8=int8))
        tf = thc.make_verify_step(tcfg, tspec, thc.TREE, partial=True,
                                  int8=int8)
        jbl, tbl = jnp.zeros((B,), jnp.int32), torch.zeros(B,
                                                            dtype=torch.int32)
        jt, tt = jnp.asarray(pend), _t(pend)
        for _ in range(3):
            jt, jc, jpkv, jbl = jf(params, jc, jpkv, jbl, jt,
                                   jnp.asarray(tree))
            out = tf(tp, tc, tpkv, tbl, tt, _t(tree))
            assert out[2] is tpkv and out[3] is tbl
            tt = out[0]
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    else:
        partial = case == "C1"
        shape = "long_500k" if partial else "decode_32k"
        jc, tc = _int8_caches(cfg, tcfg, spec, [230, 173], 448, 90)
        rng = np.random.default_rng(91)
        jpkv = tpkv = None
        if partial:
            jpkv, tpkv = _pkv_pair(_pkv(cfg, spec, rng, True))
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jf = jax.jit(jhc.make_decode_step_int8(cfg, spec, partial=partial))
        tf = thc.make_decode_step_int8(tcfg, tspec, partial=partial)
        jbl, tbl = jnp.zeros((B,), jnp.int32), torch.zeros(B,
                                                            dtype=torch.int32)
        jt, tt = jnp.asarray(tok), _t(tok)
        for _ in range(3):
            if partial:
                jt, jc, jpkv, jbl = jf(params, jc, jpkv, jbl, jt)
                out = tf(tp, tc, tpkv, tbl, tt)
                assert out[2] is tpkv and out[3] is tbl
                tt = out[0]
            else:
                jt, jc = jf(params, jc, jt)
                tt, tc2 = tf(tp, tc, tt)
                assert tc2 is tc
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert shape in tcfgs.INPUT_SHAPES
        if not partial:
            np.testing.assert_array_equal(tc["length"].numpy(),
                                          np.asarray(jc["length"]))
            for n in ("k", "v", "k_scale", "v_scale"):
                np.testing.assert_array_equal(_np(tc[n]), _np(jc[n]))
            return
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(jbl))
    np.testing.assert_array_equal(_np(tpkv[2]), _np(jpkv[2]))
    if len(tpkv) > 3:
        for g, w in zip(tpkv[:2] + tpkv[3:], jpkv[:2] + jpkv[3:]):
            np.testing.assert_array_equal(_np(g), _np(w))
    else:
        for g, w in zip(tpkv[:2], jpkv[:2]):
            _close(g, w, 1e-5)


@pytest.mark.parametrize("name", list(thc.CASES))
def test_case_builders_run_on_the_cpu(small_spec, name):
    """Each case at a small shape (tiny-dense, the conftest spec): it
    builds, steps eagerly, writes its state in place and reports what it
    was cut to.  (The card runs them at the reference's shapes, with the
    graph replay held to the eager steps.)"""
    spec = _tspec(small_spec)
    kw = dict(device="cpu", spec=spec, steps=2)
    if name.startswith("A"):
        case = thc.build_verify_case(
            "tiny-dense", partial=name[1] != "0", int8=name[1] == "2",
            batch=2, seq=300, **kw)
    elif name.startswith("B"):
        case = thc.build_int8_decode_case("tiny-dense", "decode_32k",
                                          batch=2, seq=300, **kw)
    elif name.startswith("C"):
        case = thc.build_int8_decode_case("tiny-dense", "long_500k",
                                          seq=2000, **kw)
    else:
        case = thc.build_cp_retrieval_case("tiny-dense", seq=2048, **kw)
    ptrs = [a.data_ptr() for a in case.restore]
    res = thc.run_built(case, steps=2, device="cpu")
    assert [a.data_ptr() for a in case.restore] == ptrs
    assert res["state_bytes"] > 0 and len(res["eager_ms"]) == 2
    if name[0] in "ABC":
        assert np.asarray(res["tokens"]).shape == (2, 1 if name[0] == "C"
                                                   else 2)
    if name[0] == "B":
        assert res["reduced"]["global_batch"] == {"ran": 2, "full": 128}
        assert int(case.args[1]["length"][0]) == 302


def test_paged_int8_cache_raises(tiny, small_spec):
    cfg, tcfg, _, _ = tiny
    tp = _tparams(tiny)
    tc = tapi.init_cache(tcfg, B, 64, _tspec(small_spec), paged=True,
                         device="cpu")
    tc["k"] = tc["k"].to(torch.int8)
    tc["v"] = tc["v"].to(torch.int8)
    tc["k_scale"] = torch.ones(tc["k"].shape[:-1], dtype=torch.bfloat16)
    tc["v_scale"] = torch.ones(tc["v"].shape[:-1], dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        tapi.decode(tcfg, tp, torch.zeros((B, 1), dtype=torch.long),
                    torch.zeros((B, 1), dtype=torch.int32), tc, mode="full",
                    spec=_tspec(small_spec))
