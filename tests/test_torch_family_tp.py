"""Tensor and data parallelism of the PyTorch port for the state and
cross-attention families, against the JAX package on the CPU (every mesh
device ``cpu``; fp32, the reduced configs: 2 layers, d 256, 4 heads).

* **Blocks** at ``m = 2`` model shards
  (``distributed.tensor_parallel.TensorParallel``), each against the
  reference's own function on the same weights (random where the
  reference's init leaves zeros or constants): RWKV-6's time mixing (its
  output, token shift and the ``wkv`` state, whose shards' heads put side
  by side give the reference's state) and channel mixing; Griffin's
  recurrent block (the gates' dense ``wa`` / ``wi`` over the gathered conv
  output, ``rnn_h`` and ``conv`` split by columns) and its trunk, whose
  one-KV-head local attention runs whole; Whisper's cross-attention layer
  over each shard's cached rows, and its encoder with the cross rows each
  shard writes.  The per-head parts (K5's plain version, the group norm,
  the RG-LRU scan) on a shard's slice of the inputs give the slice of the
  whole output bit for bit.
* **Engines**: ``generate`` on a ``(1, 2)`` mesh gives the port's
  unsharded engine's tokens and the JAX engine's for rwkv6-3b,
  recurrentgemma-2b, whisper-small and llama-3.2-vision-90b (with
  ``extra``); on a ``(2, 1)`` mesh the wave serving of rwkv6-3b and the
  slot serving of whisper-small (each request's ``extra`` on its shard)
  give the unsharded engine's outputs.
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
from repro.models import common as jcm
from repro.models import dense as jdn
from repro.models import griffin as jgf
from repro.models import rwkv6 as jrw
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.data_parallel import DataParallelEngine
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.distributed.sharding import DeviceMesh
from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                     merge_heads)
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import dense as tdn
from repro_torch.models import griffin as tgf
from repro_torch.models import rwkv6 as trw
from repro_torch.serving import Request, ServingConfig, ServingEngine

pytestmark = pytest.mark.sharded

F32 = dict(dtype="float32", param_dtype="float32")
REL = 1e-5
MAX_LEN, CHUNK, NEW = 192, 64, 10
ARCHS = ("rwkv6-3b", "recurrentgemma-2b", "whisper-small",
         "llama-3.2-vision-90b")

# the reference's blocks compiled whole (op by op they take longer)
_jtime_mix = jax.jit(jrw._time_mix, static_argnums=(0,))
_jchannel_mix = jax.jit(jrw._channel_mix, static_argnums=(0,))
_jrec_block = jax.jit(jgf._rec_block, static_argnums=(0, 6))
_jgf_forward = jax.jit(jgf.forward, static_argnums=(0,),
                       static_argnames=("mode", "collect_features"))


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


def _cpus(n):
    return ["cpu"] * n


def _randomise(cfg, tree, rng):
    """Random values where the reference's init leaves zeros or
    constants, so every weight matters: RWKV-6's ``u``, ``lora_B``,
    ``wd_B``; Griffin's ``lam``, ``ba``, ``bi``, ``conv_b``; the VLM's
    gates and Whisper's QKV biases."""
    if cfg.arch_type == "ssm":
        lay = tree["layers"]
        for name, scale in (("u", 0.5), ("lora_B", 0.1), ("wd_B", 0.1)):
            lay[name] = (rng.normal(size=lay[name].shape) * scale).astype(
                np.float32)
        return tree
    if cfg.arch_type == "hybrid":
        for node in list(tree["slots"]) + list(tree["rem"]):
            if "lam" in node:
                node["lam"] = rng.uniform(-1.0, 3.0, node["lam"].shape
                                          ).astype(np.float32)
                for name, scale in (("ba", 0.5), ("bi", 0.5),
                                    ("conv_b", 0.1)):
                    node[name] = (rng.normal(size=node[name].shape)
                                  * scale).astype(np.float32)
        return tree
    stacks = [tree["decoder"]] + ([tree["encoder"]] if "encoder" in tree
                                  else [])
    for stack in stacks:
        for slot in stack["slots"]:
            for name in ("gate_attn", "gate_mlp"):
                if name in slot:
                    slot[name] = rng.uniform(0.3, 0.9, slot[name].shape
                                             ).astype(np.float32)
            for sub in ("attn", "xattn"):
                for name in ("bq", "bk", "bv"):
                    if name in slot.get(sub, {}):
                        slot[sub][name] = (rng.normal(
                            size=slot[sub][name].shape) * 0.3).astype(
                                np.float32)
    return tree


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _build(arch, small_spec, small_dcfg):
    cfg = jcfgs.get_config(arch).reduced().replace(**F32)
    tcfg = tcfgs.get_config(arch).reduced().replace(**F32)
    npp = _randomise(cfg, _np(japi.init_params(cfg, jax.random.PRNGKey(0))),
                     np.random.default_rng(7))
    jd = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    spec = small_spec.replace(use_pallas=True)
    return dict(
        arch=arch, cfg=cfg, tcfg=tcfg, npp=npp,
        jp=jax.tree_util.tree_map(jnp.asarray, npp), jd=jd,
        tp=params_from_numpy(tcfg, npp, device="cpu"),
        td=draft_params_from_numpy(tcfg, _np(jd), device="cpu"),
        spec=spec, tspec=tcfgs.SpecPVConfig(**dataclasses.asdict(spec)),
        dcfg=small_dcfg,
        tdcfg=tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg)))


@pytest.fixture(scope="module")
def models(small_spec, small_dcfg):
    """Each reduced target's weights and configs, built once."""
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = _build(arch, small_spec, small_dcfg)
        return built[arch]
    return get


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a[i]), tree)


def _valid(b, t):
    """A valid prefix per row: the last row pads its final two tokens."""
    v = np.ones((b, t), bool)
    v[-1, t - 2:] = False
    return v


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def test_rwkv_mixes_match_jax(models):
    """RWKV-6's time mixing (output, token shift, ``wkv`` state with its
    shards' heads side by side) and channel mixing on two model shards
    against the reference's ``_time_mix`` / ``_channel_mix``."""
    model = models("rwkv6-3b")
    cfg, tcfg = model["cfg"], model["tcfg"]
    tp = TensorParallel(tcfg, model["tp"], _cpus(2))
    assert tp.tmix_split and tp.cmix_split and tp.kv_shards == 2
    assert not (tp.attn_split or tp.mlp_split or tp.rec_split)
    rng = np.random.default_rng(3)
    b, t, d, dk = 2, 7, cfg.d_model, cfg.ssm_head_dim
    h = d // dk
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    ts = rng.normal(size=(b, d)).astype(np.float32)
    wkv = (rng.normal(size=(b, h, dk, dk)) * 0.1).astype(np.float32)
    valid = _valid(b, t)
    last = valid.sum(1).astype(np.int32) - 1
    jlp = _layer(model["npp"]["layers"], 1)
    jy, jts, jwkv = _jtime_mix(cfg, jlp, x, ts, wkv, valid, last)
    lp = model["tp"]["layers"][1]
    units = [sh.params["layers"][1] for sh in tp.shards]
    assert units[0]["wr"].shape == (d, d // 2)
    wkvs = [_t(wkv[:, s * h // 2:(s + 1) * h // 2]) for s in range(2)]
    y, nts, nw = trw._time_mix(tcfg, lp, _t(x), _t(ts), wkvs,
                               _t(valid.sum(1).astype(np.int32)),
                               _t(last).long(), True, units, tp)
    _close(y, jy)
    _close(nts, jts)
    _close(torch.cat(nw, dim=1), jwkv)
    jy2, jts2 = _jchannel_mix(cfg, jlp, x, ts, last)
    y2, nts2 = trw._channel_mix(tcfg, lp, _t(x), _t(ts), _t(last).long(),
                                units, tp)
    _close(y2, jy2)
    _close(nts2, jts2)


def test_griffin_rec_block_and_trunk_match_jax(models):
    """Griffin's recurrent block on two model shards (each shard's
    columns of ``wx`` / ``wgate`` / the conv, one gather of the conv
    output for the dense gates ``wa`` / ``wi``, each shard's RG-LRU
    columns and ``wo`` rows) against the reference's ``_rec_block``; then
    a 40-token ``advance`` and a read-only ``verify`` of the whole trunk,
    whose local attention (one KV head) runs whole, against the
    reference's ``forward``: hidden states and every state entry."""
    model = models("recurrentgemma-2b")
    cfg, tcfg = model["cfg"], model["tcfg"]
    tp = TensorParallel(tcfg, model["tp"], _cpus(2))
    assert tp.rec_split and tp.mlp_split and tp.kv_shards == 2
    assert not tp.attn_split            # 1 KV head: the MQA block is whole
    assert "attn" not in tp.shards[0].params["layers"][1]
    rng = np.random.default_rng(4)
    b, t = 2, 9
    w = cfg.rnn_width or cfg.d_model
    x = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
    rnn_h = rng.normal(size=(b, w)).astype(np.float32)
    conv = rng.normal(size=(b, 3, w)).astype(np.float32)
    valid = _valid(b, t)
    jlp = _layer(model["npp"]["slots"][0], 0)
    jout, jrh, jcs = _jrec_block(cfg, jlp, x, rnn_h, conv, valid, True)
    half = w // 2
    out, rhs, css = tgf._rec_block_tp(
        tcfg, tp, 0, model["tp"]["layers"][0], _t(x),
        [_t(rnn_h[:, s * half:(s + 1) * half]) for s in range(2)],
        [_t(conv[..., s * half:(s + 1) * half]) for s in range(2)],
        _t(valid.sum(1).astype(np.int32)), True)
    # padded steps hold the state in the reference and run on here: the
    # outputs are compared where the tokens are real
    _close(out[torch.from_numpy(valid)], np.asarray(jout)[valid])
    _close(torch.cat(rhs, dim=-1), jrh)
    _close(torch.cat(css, dim=-1), jcs)
    # the trunk: advance, then a read-only verify
    toks = rng.integers(0, cfg.vocab_size, (b, 40)).astype(np.int32)
    pos = np.arange(40, dtype=np.int32)[None].repeat(b, 0)
    jst = jgf.init_state(cfg, b, jnp.float32)
    jh, _, jst = _jgf_forward(cfg, model["jp"], toks, pos, jst,
                              mode="advance")
    tst = tapi.init_cache(tcfg, b, MAX_LEN, device="cpu", kv_shards=2)
    th, _, tst = tgf.forward(tcfg, model["tp"], _t(toks).long(), _t(pos),
                             tst, mode="advance", tp=tp)
    _close(th, jh)
    for k in ("rnn_h", "conv"):
        _close(merge_heads(tst[k], 2, 0, -1), jst[k])
    for k in ("win_k", "win_v"):
        _close(tst[k], jst[k])
    assert torch.equal(tst["win_pos"], _t(jst["win_pos"]))
    vt = rng.integers(0, cfg.vocab_size, (b, 4)).astype(np.int32)
    vp = 40 + np.arange(4, dtype=np.int32)[None].repeat(b, 0)
    mask = np.tril(np.ones((4, 4), bool))[None].repeat(b, 0)
    before = {k: v.clone() for k, v in tst.items()}
    jv, _, _ = _jgf_forward(cfg, model["jp"], vt, vp, jst, mode="verify",
                            self_mask=mask)
    tv, _, _ = tgf.forward(tcfg, model["tp"], _t(vt).long(), _t(vp), tst,
                           mode="verify", self_mask=_t(mask), tp=tp)
    _close(tv, jv)
    assert all(torch.equal(before[k], tst[k]) for k in before)


def test_cross_attention_and_encoder_match_jax(models):
    """Whisper's cross-attention layer on two model shards (each shard's
    query heads over its KV heads' cached rows, ``wo`` rows, one sum)
    against the reference's ``_cross_attention``; the encoder runs whole
    once and each shard writes its KV heads' cross rows
    (``api.write_cross``), which put side by side are the reference's
    ``compute_cross_kv`` of its ``encode_frames``."""
    model = models("whisper-small")
    cfg, tcfg = model["cfg"], model["tcfg"]
    tp = TensorParallel(tcfg, model["tp"], _cpus(2))
    assert tp.attn_split and tp.kv_shards == 2
    assert tp.shards[0].params["layers"][0]["xattn"]["bq"].shape == (
        cfg.d_model // 2,)
    rng = np.random.default_rng(5)
    b = 2
    frames = rng.normal(size=(b, cfg.num_audio_frames, cfg.d_model)
                        ).astype(np.float32)
    enc = jdn.encode_frames(cfg, model["jp"], frames)
    lc = jdn.cross_layer_count(cfg.layer_kinds())
    te, hk, dh = cfg.num_audio_frames, cfg.num_kv_heads, cfg.head_dim_
    ck = torch.zeros((2 * lc, b, te, hk // 2, dh))
    cv = torch.zeros_like(ck)
    tapi.write_cross(tcfg, model["tp"], ck, cv,
                     {"frame_embeds": _t(frames)}, tp)
    x = rng.normal(size=(b, 5, cfg.d_model)).astype(np.float32)
    inv = jcm.rope_inv_freq(cfg)
    for c in range(lc):
        jlp = _layer(model["npp"]["decoder"]["slots"][0], c)
        jk, jv = jdn.compute_cross_kv(cfg, jlp, enc)
        _close(merge_heads(ck, 2, 0, 3)[c], jk)
        _close(merge_heads(cv, 2, 0, 3)[c], jv)
        want = jdn._cross_attention(cfg, jlp, x, (jk, jv), inv)
        kvs = [(ck[s * lc + c], cv[s * lc + c]) for s in range(2)]
        got = tdn._cross_attention(tcfg, model["tp"]["layers"][c], _t(x),
                                   kvs, tp, c)
        _close(got, want)


def test_per_head_parts_split_bit_for_bit():
    """K5's plain version, the per-head group norm and the RG-LRU scan on
    one shard's slice of the inputs give that slice of the whole
    output, bit for bit."""
    rng = np.random.default_rng(6)
    b, t, h, dk, m = 2, 6, 4, 64, 2
    r, k, v = (_t(rng.normal(size=(b, t, h, dk)).astype(np.float32))
               for _ in range(3))
    w = _t(rng.uniform(0.5, 1.0, (b, t, h, dk)).astype(np.float32))
    u = _t(rng.normal(size=(h, dk)).astype(np.float32))
    s0 = _t((rng.normal(size=(b, h, dk, dk)) * 0.1).astype(np.float32))
    nv = torch.tensor([t, t - 2], dtype=torch.int32)
    y, s = tops.wkv(r, k, v, w, u, s0, nv)
    sc = _t(rng.normal(size=(h, dk)).astype(np.float32))
    bi = _t(rng.normal(size=(h, dk)).astype(np.float32))
    g = tcm.groupnorm_heads(y, sc, bi)
    a = _t(rng.uniform(0.0, 1.0, (b, t, 8)).astype(np.float32))
    gg = _t(rng.normal(size=(b, t, 8)).astype(np.float32))
    h0 = _t(rng.normal(size=(b, 8)).astype(np.float32))
    hs = tgf.rglru_scan(a, gg, h0)
    for j in range(m):
        hh = slice(j * h // m, (j + 1) * h // m)
        ys, ss = tops.wkv(r[:, :, hh].contiguous(), k[:, :, hh].contiguous(),
                          v[:, :, hh].contiguous(), w[:, :, hh].contiguous(),
                          u[hh].contiguous(), s0[:, hh].contiguous(), nv)
        assert torch.equal(ys, y[:, :, hh]) and torch.equal(ss, s[:, hh])
        assert torch.equal(tcm.groupnorm_heads(ys, sc[hh], bi[hh]),
                           g[:, :, hh])
        cc = slice(j * 4, (j + 1) * 4)
        assert torch.equal(tgf.rglru_scan(a[..., cc], gg[..., cc],
                                          h0[:, cc]), hs[..., cc])


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _extra(cfg, b, seed):
    """numpy conditioning of ``b`` rows: the JAX and the port's forms
    (None for a target without cross layers)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.arch_type == "vlm":
        out["image_embeds"] = rng.normal(
            size=(b, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.has_encoder:
        out["frame_embeds"] = rng.normal(
            size=(b, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)
    if not out:
        return None, None
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: _t(v) for k, v in out.items()})


def _tengine(m, **kw):
    kw.setdefault("batch", 2)
    if not m["tcfg"].is_attention_arch:
        kw["paged"] = False
    return TEngine(m["tcfg"], m["tspec"], m["tdcfg"], m["tp"], m["td"],
                   max_len=MAX_LEN, device="cpu", prefix_cache=False, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_on_two_model_shards_equals_reference(models, arch):
    """``generate`` on a ``(1, 2)`` mesh equals the port's unsharded
    engine's tokens and the JAX engine's (the attention targets' prompts
    run past the partial budget: Refresh and Partial steps)."""
    m = models(arch)
    cfg = m["cfg"]
    # the attention prompts pass the 112-token partial budget in whole
    # 64-token chunks (one prefill shape to compile)
    plen = 40 if not cfg.is_attention_arch else 128
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, plen)).astype(np.int32)
    jx, tx = _extra(cfg, 2, 11)
    je = JEngine(cfg, m["spec"], m["dcfg"], m["jp"], m["jd"], batch=2,
                 max_len=MAX_LEN, partial_verification=True)
    jt, js = je.generate(prompt, NEW, prefill_chunk=CHUNK, extra=jx)
    want, ws = _tengine(m).generate(prompt, NEW, prefill_chunk=CHUNK,
                                    extra=tx)
    eng = _tengine(m, mesh=DeviceMesh((1, 2), devices=_cpus(2)))
    assert eng.tp is not None and eng.tp.kv_shards == 2
    got, gs = eng.generate(prompt, NEW, prefill_chunk=CHUNK, extra=tx)
    np.testing.assert_array_equal(want, np.asarray(jt))
    np.testing.assert_array_equal(got, want)
    assert gs["modes"] == ws["modes"] == js["modes"]
    if cfg.is_attention_arch:
        assert {"refresh", "partial"} <= set(gs["modes"])
        assert eng.state.cache["cross_k"].shape[0] == \
            2 * tdn.cross_layer_count(cfg.layer_kinds())
    else:
        state = eng.state.cache
        key = "wkv" if cfg.arch_type == "ssm" else "rnn_h"
        assert state[key].shape[0] == 2 * _tengine(m).state.cache[
            key].shape[0]


def test_wave_serving_on_two_data_shards(models, monkeypatch):
    """rwkv6-3b's wave serving on a ``(2, 1)`` mesh (each wave's rows
    split over two data shards, one lock-step round launching both)
    gives the unsharded server's outputs."""
    m = models("rwkv6-3b")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, m["cfg"].vocab_size, (n,)).astype(np.int32)
               for n in (40, 40, 40, 56)]

    def serve(mesh):
        srv = ServingEngine(m["tcfg"], m["tspec"], m["tdcfg"], m["tp"],
                            m["td"], ServingConfig(batch=2, max_len=MAX_LEN,
                                                   scheduler="wave"),
                            device="cpu")
        monkeypatch.setattr(srv, "_mesh", lambda: mesh)
        for i, p in enumerate(prompts):
            srv.submit(Request(request_id=f"r{i}", prompt=p,
                               max_new_tokens=NEW, arrival_s=0.0))
        srv.run()
        return srv, {k: o.tokens.tolist() for k, o in srv.outputs.items()}
    _, want = serve(None)
    srv, got = serve(DeviceMesh((2, 1), devices=_cpus(2)))
    eng = srv._engines[(2, False)]
    assert isinstance(eng, DataParallelEngine) and eng.data_shards == 2
    assert all(sub.dispatches for sub in eng.shards)
    assert got == want


def test_slot_serving_with_extra_on_two_data_shards(models):
    """whisper-small on a ``(2, 1)`` mesh: four requests, each with its
    own ``extra``, admitted into slots of both shards (the cross rows
    written on the shard that holds the slot) and stepped together; each
    request's tokens equal its solo ``generate`` on the unsharded
    engine."""
    m = models("whisper-small")
    rng = np.random.default_rng(10)
    reqs = [(rng.integers(0, m["cfg"].vocab_size, (n,)).astype(np.int32),
             _extra(m["cfg"], 1, 30 + i)[1])
            for i, n in enumerate((40, 130, 70, 40))]
    eng = _tengine(m, batch=4, paged=True, zero_copy=True,
                   mesh=DeviceMesh((2, 1), devices=_cpus(2)))
    assert isinstance(eng, DataParallelEngine)
    st = eng.empty_state()
    out = {i: [] for i in range(4)}
    for i, (p, ex) in enumerate(reqs):
        st, first = eng.prefill_into_slot(st, i, p, chunk=CHUNK, extra=ex,
                                          max_new_tokens=NEW)
        out[i].append(first)
    while min(len(v) for v in out.values()) < NEW:
        rows = np.asarray([len(out[i]) < NEW for i in range(4)])
        st, so = eng.step_fused(st, rows, eng.modes_for_rows(st, rows))
        for i in np.nonzero(rows)[0]:
            out[i].extend(so.tokens[i, :so.counts[i]].tolist())
    assert all(sub.dispatches for sub in eng.shards)
    solo = _tengine(m, batch=1)
    for i, (p, ex) in enumerate(reqs):
        want, _ = solo.generate(p[None], NEW, prefill_chunk=CHUNK, extra=ex)
        assert out[i][:NEW] == want[0].tolist(), i
