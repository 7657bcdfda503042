"""The int8 resident cache and the launch steps of the PyTorch port under
a mesh's ``model`` axis, on the CPU against the JAX package's unsharded
functions (its own mesh runs fail under jax 0.9): ``tiny-dense`` in fp32
(2 KV heads, one per shard on a (1, 2) mesh) and the reduced rwkv6-3b,
the conftest ``small_spec``.  The port's state is the JAX state's
``split_heads``; what it writes is compared after ``merge_heads``.

* ``api.decode`` on an int8 contiguous cache with its scales at T = 1
  and T = 12 (logits 1e-4, new K/V 1e-5);
* ``launch.steps``' prefill and decode steps with ``tp=`` (full, partial,
  state): tokens equal JAX's step for step;
* the hillclimb int8 steps with ``tp=`` (``make_verify_step(int8=True)``
  and ``make_decode_step_int8`` full and partial): bonus tokens equal
  JAX's every step, the int8 scales and positions written equal the
  reference's bit for bit, the payloads too but for values on a
  rounding boundary (one quantum, at most one in 10^4).

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
from repro_torch import configs as tcfgs
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.sharding import DeviceMesh
from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                     merge_heads, split_heads)
from repro_torch.launch import hillclimb as thc
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi

B = 2
TOL = 1e-4
MESH = DeviceMesh((1, 2), devices=["cpu"] * 2)
# the head axis of each cache entry and partial-cache field (layer axis 0)
HEAD_AXIS = {"k": 3, "v": 3, "kmax": 3, "kmin": 3, "k_scale": 3,
             "v_scale": 3}


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


@pytest.fixture(scope="module")
def tiny():
    cfg = jcfgs.get_config("tiny-dense")
    tcfg = tcfgs.get_config("tiny-dense")
    np_params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: japi.init_params(cfg, k))(jax.random.PRNGKey(0)))
    tp = params_from_numpy(tcfg, np_params, device="cpu")
    return (cfg, tcfg, jax.tree_util.tree_map(jnp.asarray, np_params), tp,
            TensorParallel(tcfg, tp, MESH.model_row(0)))


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


def _split_cache(tc):
    """The port's cache shard-stacked over the mesh's two model shards."""
    return {n: (split_heads(a, 2, 0, HEAD_AXIS[n]) if n in HEAD_AXIS
                else a) for n, a in tc.items()}


def _jdecode(cfg, params, toks, pos, cache, **kw):
    arrays = {k: v for k, v in kw.items() if not isinstance(v, (str, bool))
              and k != "spec"}
    static = {k: v for k, v in kw.items() if k not in arrays}
    return jax.jit(lambda p, t, q, c, a: japi.decode(
        cfg, p, t, q, c, **static, **a))(params, jnp.asarray(toks),
                                         jnp.asarray(pos), cache, arrays)


def _int8_caches(cfg, tcfg, spec, lengths, max_len, seed):
    """The same int8 contiguous cache on both sides (random K/V quantised
    by the reference, ``length`` ragged), the port's shard-stacked."""
    rng = np.random.default_rng(seed)
    jc = japi.init_cache(cfg, B, max_len, spec)
    shp = jc["k"].shape
    kq, ks = _quant(rng.normal(size=shp).astype(np.float32))
    vq, vs = _quant(rng.normal(size=shp).astype(np.float32))
    jc.update(k=jnp.asarray(kq), v=jnp.asarray(vq), k_scale=_bf16(ks)[0],
              v_scale=_bf16(vs)[0], length=jnp.asarray(lengths, jnp.int32))
    tc = thc.init_int8_cache(tcfg, B, max_len, _tspec(spec), device="cpu")
    for n, a in (("k", kq), ("v", vq), ("k_scale", _bf16(ks)[1]),
                 ("v_scale", _bf16(vs)[1]), ("length", np.asarray(lengths))):
        tc[n].copy_(a if torch.is_tensor(a) else _t(a))
    return jc, _split_cache(tc)


@pytest.mark.parametrize("t", [1, 12])
def test_decode_on_int8_cache_under_tp(tiny, small_spec, t):
    """Both int8 routes (T <= 8 folds the scales into the dot, T = 12
    dequantises tile by tile), each shard reading its own payload and
    scales."""
    cfg, tcfg, params, tparams, tp = tiny
    jc, tc = _int8_caches(cfg, tcfg, small_spec, [150, 97], 700, 20 + t)
    assert tc["k_scale"].shape[0] == 2 * cfg.num_layers
    rng = np.random.default_rng(t)
    toks = rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)
    pos = (np.array([150, 97])[:, None] + np.arange(t)).astype(np.int32)
    oj = _jdecode(cfg, params, toks, pos, jc, mode="full", spec=small_spec)
    ot = tapi.decode(tcfg, tparams, _t(toks).long(), _t(pos), tc,
                     mode="full", spec=_tspec(small_spec), tp=tp)
    _close(ot.logits, oj.logits)
    for g, w in zip(ot.new_kv, oj.new_kv):
        _close(merge_heads(g, 2, 0, 3), w, 1e-5)


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
    tparams = params_from_numpy(tcfg, np_params, device="cpu")
    return (cfg, tcfg, jax.tree_util.tree_map(jnp.asarray, np_params),
            tparams, TensorParallel(tcfg, tparams, MESH.model_row(0)))


@pytest.mark.parametrize("kind", ["full", "partial", "state"])
def test_launch_steps_with_tp_match_jax(tiny, small_spec, kind):
    """A prefill step over 160 tokens, then 6 decode steps, each side
    feeding its own next token; the partial steps start from the
    selection of the port's own split decode, held to the reference's
    (positions equal, K/V 1e-5)."""
    cfg, tcfg, params, tparams, tp = _rwkv() if kind == "state" else tiny
    assert tp.kv_shards == 2
    spec, tspec = small_spec, _tspec(small_spec)
    prompt = np.random.default_rng(50).integers(
        0, cfg.vocab_size, (B, 160)).astype(np.int32)
    jc = japi.init_cache(cfg, B, 320, spec)
    tc = tapi.init_cache(tcfg, B, 320, tspec, device="cpu", kv_shards=2)
    jn, jc = jax.jit(jsteps.make_prefill_step(cfg, spec))(
        params, jc, jnp.asarray(prompt), None)
    tn, tc2 = tsteps.make_prefill_step(tcfg, tspec, tp=tp)(
        tparams, tc, _t(prompt).long(), None)
    assert tc2 is tc
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    partial = kind == "partial"
    jstep = jax.jit(jsteps.make_decode_step(cfg, spec, partial=partial))
    tstep = tsteps.make_decode_step(tcfg, tspec, partial=partial, tp=tp)
    jtok, ttok = jn, tn
    if partial:
        sel = _jdecode(cfg, params, jn[:, None], jc["length"][:, None], jc,
                       mode="full", spec=spec, select_partial=True).partial
        tsel = tapi.decode(tcfg, tparams, tn[:, None].long(),
                           tc["length"][:, None], tc, mode="full",
                           spec=tspec, select_partial=True, tp=tp).partial
        np.testing.assert_array_equal(_np(merge_heads(tsel[2], 2, 0, 2)),
                                      _np(sel[2]))
        for g, w in zip(tsel[:2], sel[:2]):
            _close(merge_heads(g, 2, 0, 2), w, 1e-5)
        pad = spec.buffer_size
        jpkv = (jnp.pad(sel[0], ((0, 0),) * 3 + ((0, pad), (0, 0))),
                jnp.pad(sel[1], ((0, 0),) * 3 + ((0, pad), (0, 0))),
                jnp.pad(sel[2], ((0, 0),) * 3 + ((0, pad),),
                        constant_values=-1),
                jnp.zeros((B,), jnp.int32))
        tpkv = tsteps.partial_state(tspec, tsel)
    for _ in range(6):
        if partial:
            jtok, jc, *jpkv = jstep(params, jc, *jpkv, jtok)
            out = tstep(tparams, tc, *tpkv, ttok)
            assert all(a is b for a, b in zip(out[2:], tpkv))
            ttok = out[0]
        else:
            jtok, jc = jstep(params, jc, jtok)
            ttok, tc2 = tstep(tparams, tc, ttok)
            assert tc2 is tc
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray(jc["length"]))
    if partial:
        np.testing.assert_array_equal(
            _np(merge_heads(tpkv[2], 2, 0, 2)), _np(jpkv[2]))


def _pkv(cfg, spec, rng):
    """An int8 materialised per-head partial cache [L, B, Hk, P, ...] with
    ragged valid slots: (jax, port shard-stacked)."""
    L, hk, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    p = spec.partial_budget_tokens + spec.buffer_size
    (kq, ks), (vq, vs) = (_quant(rng.normal(size=(L, B, hk, p, dh))
                                 .astype(np.float32)) for _ in range(2))
    ppos = np.full((L, B, hk, p), -1, np.int32)
    ppos[:, 0, :, :spec.partial_budget_tokens - 20] = 7
    ppos[:, 1, :, 5:spec.partial_budget_tokens + 9] = 3
    j = tuple(jnp.asarray(a) for a in (kq, vq, ppos)) + tuple(
        _bf16(a)[0] for a in (ks, vs))
    t = tuple(_t(a) for a in (kq, vq, ppos)) + tuple(
        _bf16(a)[1] for a in (ks, vs))
    return j, tuple(split_heads(a, 2, 0, 2) for a in t)


def _verify_state(cfg, tcfg, spec, seed):
    """A fp32 cache of 260 random tokens per row with the reference's
    summaries (the port's shard-stacked), pending tokens, draft trees."""
    from repro.kvcache.cache import update_layer_summaries
    rng = np.random.default_rng(seed)
    jc = japi.init_cache(cfg, B, 640, spec)
    k = rng.normal(size=jc["k"].shape).astype(np.float32)
    v = rng.normal(size=jc["v"].shape).astype(np.float32)
    jc.update(k=jnp.asarray(k), v=jnp.asarray(v),
              length=jnp.full((B,), 260, jnp.int32))
    nkmax, nkmin = jax.vmap(lambda kx, kn, kl: update_layer_summaries(
        kx, kn, kl, jnp.zeros((B,), jnp.int32), jc["length"],
        spec.block_size))(jc["kmax"], jc["kmin"], jc["k"])
    jc.update(kmax=nkmax, kmin=nkmin)
    tc = tapi.init_cache(tcfg, B, 640, _tspec(spec), device="cpu")
    for n in ("k", "v", "kmax", "kmin", "length"):
        tc[n].copy_(_t(jc[n]))
    pending = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
    tree = rng.integers(0, cfg.vocab_size, (B, thc.TREE.size)).astype(
        np.int32)
    return jc, _split_cache(tc), pending, tree, rng


@pytest.mark.parametrize("case", ["A2", "B1", "C1"])
def test_hillclimb_int8_steps_on_a_mesh(tiny, small_spec, jhc, case):
    """Three steps of each int8 step builder with ``tp=`` the split over
    a (1, 2) mesh, the
    next pending (or token) the step's own output, against the
    reference's unsharded builder: tokens equal every step; the scales
    and positions written equal the reference's bit for bit, and so do
    the payloads but for a value on the int8 grid's rounding boundary,
    which may land one quantum away (at most one in 10^4): each shard's
    column slice of ``wk`` / ``wv`` is a narrower product than the whole
    one, which can round its fp32 K/V differently in the last bit."""
    cfg, tcfg, params, tparams, _ = tiny
    spec, tspec = small_spec, _tspec(small_spec)
    jbl, tbl = jnp.zeros((B,), jnp.int32), torch.zeros(B, dtype=torch.int32)
    jpkv = tpkv = None
    tsplit = TensorParallel(tcfg, tparams, MESH.model_row(0))
    if case == "A2":
        jc, tc, pend, tree, rng = _verify_state(cfg, tcfg, spec, 80)
        jpkv, tpkv = _pkv(cfg, spec, rng)
        jtree = jtr.TreeSpec.from_branch((4, 2, 2, 1, 1))
        jf = jax.jit(jhc.make_verify_step(cfg, spec, jtree, partial=True,
                                          int8=True))
        tf = thc.make_verify_step(tcfg, tspec, thc.TREE, partial=True,
                                  int8=True, tp=tsplit)

        def jstep(jt):
            nonlocal jc, jpkv, jbl
            jt, jc, jpkv, jbl = jf(params, jc, jpkv, jbl, jt,
                                   jnp.asarray(tree))
            return jt

        def tstep(tt):
            out = tf(tparams, tc, tpkv, tbl, tt, _t(tree))
            assert out[2] is tpkv and out[3] is tbl
            return out[0]
        jt, tt = jnp.asarray(pend), _t(pend)
    else:
        partial = case == "C1"
        jc, tc = _int8_caches(cfg, tcfg, spec, [230, 173], 448, 90)
        rng = np.random.default_rng(91)
        if partial:
            jpkv, tpkv = _pkv(cfg, spec, rng)
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jf = jax.jit(jhc.make_decode_step_int8(cfg, spec, partial=partial))
        tf = thc.make_decode_step_int8(tcfg, tspec, partial=partial,
                                       tp=tsplit)

        def jstep(jt):
            nonlocal jc, jpkv, jbl
            if partial:
                jt, jc, jpkv, jbl = jf(params, jc, jpkv, jbl, jt)
            else:
                jt, jc = jf(params, jc, jt)
            return jt

        def tstep(tt):
            if partial:
                out = tf(tparams, tc, tpkv, tbl, tt)
                assert out[2] is tpkv and out[3] is tbl
                return out[0]
            tt, tc2 = tf(tparams, tc, tt)
            assert tc2 is tc
            return tt
        jt, tt = jnp.asarray(tok), _t(tok)
    for _ in range(3):
        jt, tt = jstep(jt), tstep(tt)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    if tpkv is None:
        np.testing.assert_array_equal(tc["length"].numpy(),
                                      np.asarray(jc["length"]))
        for n in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(
                _np(merge_heads(tc[n], 2, 0, 3)), _np(jc[n]))
        return
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(jbl))
    got = [_np(merge_heads(g, 2, 0, 2)) for g in tpkv]
    want = [_np(w) for w in jpkv]
    for i in (2, 3, 4):                 # positions and scales
        np.testing.assert_array_equal(got[i], want[i])
    for i in (0, 1):                    # payloads: see the docstring
        diff = np.abs(got[i].astype(np.int32) - want[i].astype(np.int32))
        assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-4 * diff.size
