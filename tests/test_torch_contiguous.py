"""The reference's default engine in the PyTorch port, against the JAX
package on the CPU: the contiguous KV cache (``paged=False``) and the
gathered partial cache (``zero_copy=False``), on the contiguous cache and
on the paged pool, with the page table read in place
(``use_pallas=True``) or through each layer's materialised view
(``use_pallas=False``).  ``tiny-dense`` in fp32, weights converted from
the JAX parameters, the conftest ``small_spec`` (block 16) and
``small_dcfg``; inputs made from a seed with numpy.

* ``select_and_gather_partial`` / ``_paged`` give the reference's bytes
  and positions exactly (the port keeps the body token-major; the test
  transposes it to the reference's [B, Hk, P, Dh]).
* ``refresh_partial_from_queries``: scores within 2e-3 (the port's K3
  plain version), gathered bytes exact, contiguous and paged.
* ``append_buffer`` with ``body_len > 0`` exact.
* The contiguous ``append_full_cache`` and prefill summaries (one K4
  call over every layer) within 1e-6, at a ``max_len`` that is not a
  multiple of the block, an offset that clamps included.
* ``generate`` tokens equal JAX's ``SpecPVEngine(paged=False)`` and
  ``(paged=True, zero_copy=False)``, with full and with partial
  verification, and the port's AR where verification is exact.
* Inside the port: contiguous == paged, gathered == routed (tokens,
  modes, ``mean_accept``), the contiguous K/V and summaries after
  prefill equal the paged ones through the page table, and the gathered
  body's partial attention equals the routed one bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import SpecPVEngine as JEngine
from repro.core import verify as jvf
from repro.core.draft import init_draft_params as j_init_draft
from repro.models import api as japi
from repro.models import dense as jdn
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core import verify as tvf
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.core.reference import autoregressive_generate as t_ar
from repro_torch.kernels import ops as tops
from repro_torch.kvcache import cache as tkvc
from repro_torch.models import dense as tdn

# max_len 505 is not a multiple of the 16-token block
PROMPT, NEW, MAX_LEN, CHUNK = 160, 24, 505, 64
B, HK, DH, L = 2, 2, 16, 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(small_spec, small_dcfg):
    cfg = jcfgs.get_config("tiny-dense")
    tcfg = tcfgs.get_config("tiny-dense")
    tdcfg = tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg))
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    td = draft_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, dparams), device="cpu")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return dict(cfg=cfg, tcfg=tcfg, spec=small_spec, dcfg=small_dcfg,
                tdcfg=tdcfg, params=params, dparams=dparams, tp=tp, td=td,
                prompt=prompt)


def _tspec(spec):
    return tcfgs.SpecPVConfig(**dataclasses.asdict(spec))


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------------------
# the gathered selection, refresh, buffer and commit, op by op
# ---------------------------------------------------------------------------

def _contiguous_kv(rng, s, layers=None):
    """A filled contiguous cache: JAX arrays [.., B, S, Hk, Dh] and the
    port's views over block-rounded rows holding the same values."""
    lead = (layers,) if layers else ()
    k = rng.standard_normal(lead + (B, s, HK, DH)).astype(np.float32)
    v = rng.standard_normal(lead + (B, s, HK, DH)).astype(np.float32)
    tk, tv = tkvc.init_contiguous_kv(layers or 1, B, s, 16, HK, DH,
                                     torch.float32, "cpu")
    if not layers:
        tk, tv = tk[0], tv[0]
    tk.copy_(_t(k))
    tv.copy_(_t(v))
    return k, v, tk, tv


def _paged_kv(rng, nb, num_pages):
    """A pool [NP, bs, Hk, Dh] with a shuffled page table [B, NB]."""
    k = rng.standard_normal((num_pages, 16, HK, DH)).astype(np.float32)
    v = rng.standard_normal((num_pages, 16, HK, DH)).astype(np.float32)
    pt = rng.permutation(np.arange(1, num_pages))[: B * nb].reshape(B, nb)
    return k, v, pt.astype(np.int32)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_select_and_gather_partial_matches_jax(small_spec, paged):
    rng = np.random.default_rng(11)
    s = MAX_LEN
    nb = -(-s // 16)
    scores = rng.standard_normal((B, HK, nb)).astype(np.float32)
    scores[0, 0, 5] = scores[0, 0, 9]             # a tie: lower id first
    length = np.array([s - 3, 200], np.int32)     # last block partly past S
    spec = _tspec(small_spec)
    if paged:
        k, v, pt = _paged_kv(rng, nb, B * nb + 3)
        want = jdn.select_and_gather_partial_paged(
            small_spec, jnp.asarray(scores), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(pt), jnp.asarray(length))
        got = tdn.select_and_gather_partial_paged(
            spec, _t(scores), _t(k), _t(v), _t(pt), _t(length))
    else:
        k, v, tk, tv = _contiguous_kv(rng, s)
        want = jdn.select_and_gather_partial(
            small_spec, jnp.asarray(scores), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(length))
        got = tdn.select_and_gather_partial(spec, _t(scores), tk, tv,
                                            _t(length))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[2] >= 0).any() and (got[2] < 0).any()


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_refresh_partial_from_queries_matches_jax(small_spec, paged):
    rng = np.random.default_rng(12)
    spec = small_spec.replace(use_pallas=True)
    tspec = _tspec(spec)
    s, t, h = MAX_LEN, 7, 4
    nb = -(-s // 16)
    q = rng.standard_normal((L, B, t, h, DH)).astype(np.float32)
    qw = (rng.random((B, t)) < 0.7).astype(np.float32)
    qw[:, 0] = 1.0
    length = np.array([s - 9, 300], np.int32)
    if paged:
        npg = B * nb + 1
        k = rng.standard_normal((L, npg, 16, HK, DH)).astype(np.float32)
        v = rng.standard_normal((L, npg, 16, HK, DH)).astype(np.float32)
        kx = rng.standard_normal((L, npg, HK, DH)).astype(np.float32)
        kn = kx - np.abs(rng.standard_normal(kx.shape)).astype(np.float32)
        pt = (1 + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
        jc = dict(k=k, v=v, kmax=kx, kmin=kn, page_table=pt, length=length)
        tc = {n: _t(a) for n, a in jc.items()}
        kmax_l = [kx[i][pt] for i in range(L)]
        kmin_l = [kn[i][pt] for i in range(L)]
    else:
        k, v, tk, tv = _contiguous_kv(rng, s, layers=L)
        kx = rng.standard_normal((L, B, nb, HK, DH)).astype(np.float32)
        kn = kx - np.abs(rng.standard_normal(kx.shape)).astype(np.float32)
        jc = dict(k=k, v=v, kmax=kx, kmin=kn, length=length)
        tc = dict(k=tk, v=tv, kmax=_t(kx), kmin=_t(kn), length=_t(length))
        kmax_l, kmin_l = list(kx), list(kn)
    jc = {n: jnp.asarray(a) for n, a in jc.items()}
    want = jvf.refresh_partial_from_queries(None, spec, jnp.asarray(q),
                                            jnp.asarray(qw), jc)
    got = tvf.refresh_partial_from_queries(None, tspec, _t(q), _t(qw), tc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the scores behind the selection: the K3 plain version against the
    # reference's eq. (2)-(3) scores
    for i in range(L):
        ts = tops.retrieval_scores(_t(q[i]), _t(kmax_l[i]), _t(kmin_l[i]),
                                   _t(qw))
        js = jdn.quest_block_scores(
            jnp.asarray(q[i]), jnp.asarray(kmax_l[i]), jnp.asarray(kmin_l[i]),
            jnp.asarray(qw), score_mode="paper", reduction="mean")
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-3,
                                   atol=2e-3)


def test_append_buffer_with_body_matches_jax():
    rng = np.random.default_rng(13)
    body, buf, w = 32, 12, 4
    p = body + buf
    pk = rng.standard_normal((L, B, HK, p, DH)).astype(np.float32)
    pv = rng.standard_normal((L, B, HK, p, DH)).astype(np.float32)
    ppos = rng.integers(-1, 400, (L, B, HK, p)).astype(np.int32)
    ck = rng.standard_normal((L, B, w, HK, DH)).astype(np.float32)
    cv = rng.standard_normal((L, B, w, HK, DH)).astype(np.float32)
    pos = rng.integers(0, 400, (B, w)).astype(np.int32)
    # row 1's offset body + 10 clamps to P - W, as dynamic_update_slice
    buf_len = np.array([3, 10], np.int32)
    count = np.array([2, 4], np.int32)
    want = jvf.append_buffer(*(jnp.asarray(a) for a in (pk, pv, ppos)), body,
                             jnp.asarray(buf_len), jnp.asarray(ck),
                             jnp.asarray(cv), jnp.asarray(pos),
                             jnp.asarray(count))
    got = tvf.append_buffer(_t(pk), _t(pv), _t(ppos), body, _t(buf_len),
                            _t(ck), _t(cv), _t(pos), _t(count))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("max_len, length", [
    (100, (40, 63)),        # 100 = 6.25 blocks; writes inside
    (100, (97, 90)),        # offsets clamp at S - W = 94
], ids=["inside", "clamped"])
def test_contiguous_append_full_cache_matches_jax(small_spec, max_len,
                                                  length):
    rng = np.random.default_rng(14)
    tspec = _tspec(small_spec)
    w = 6
    nb = -(-max_len // 16)
    k, v, _, _ = _contiguous_kv(rng, max_len, layers=L)
    kx = rng.standard_normal((L, B, nb, HK, DH)).astype(np.float32)
    kn = rng.standard_normal((L, B, nb, HK, DH)).astype(np.float32)
    ck = rng.standard_normal((L, B, w, HK, DH)).astype(np.float32)
    cv = rng.standard_normal((L, B, w, HK, DH)).astype(np.float32)
    length = np.asarray(length, np.int32)
    count = np.array([4, 6], np.int32)
    jc = {n: jnp.asarray(a) for n, a in
          dict(k=k, v=v, kmax=kx, kmin=kn, length=length).items()}
    want = jvf.append_full_cache(jc, jnp.asarray(ck), jnp.asarray(cv),
                                 jnp.asarray(count), small_spec)
    def port_cache():
        ck_, cv_ = tkvc.init_contiguous_kv(L, B, max_len, 16, HK, DH,
                                           torch.float32, "cpu")
        ck_.copy_(_t(k))
        cv_.copy_(_t(v))
        return dict(k=ck_, v=cv_, kmax=_t(kx), kmin=_t(kn),
                    length=_t(length))
    got = tvf.append_full_cache(port_cache(), _t(ck), _t(cv), _t(count),
                                tspec)
    for n in ("k", "v", "length"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]),
                                      err_msg=n)
    for n in ("kmax", "kmin"):
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
    # the rows past max_len stay 0 (the reference's padded view)
    flat, rows = tops.flat_blocks(got["k"])
    assert rows == nb * 16
    assert not flat.view(L, B, rows, HK, DH)[:, :, max_len:].any()
    # one K4 call over every layer equals the plain per-layer version
    plain = tvf.append_full_cache(port_cache(), _t(ck), _t(cv), _t(count),
                                  tspec, plain=True)
    for n in ("k", "kmax", "kmin"):
        torch.testing.assert_close(got[n], plain[n], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the engine: tokens against JAX, and the port's layouts against each other
# ---------------------------------------------------------------------------

def _jgen(s, spec, **kw):
    je = JEngine(s["cfg"], spec, s["dcfg"], s["params"], s["dparams"],
                 batch=B, max_len=MAX_LEN, **kw)
    toks, stats = je.generate(s["prompt"], NEW, prefill_chunk=CHUNK)
    return np.asarray(toks), stats, je


def _tengine(s, spec, **kw):
    return TEngine(s["tcfg"], _tspec(spec), s["tdcfg"], s["tp"], s["td"],
                   batch=B, max_len=MAX_LEN, device="cpu", **kw)


def _tgen(s, spec, **kw):
    te = _tengine(s, spec, **kw)
    tops.reset_launch_counts()
    toks, stats = te.generate(s["prompt"], NEW, prefill_chunk=CHUNK)
    assert all(v == 0 for v in tops.LAUNCHES.values())   # CPU: plain
    return toks, stats, te


@pytest.mark.parametrize("paged", [False, True],
                         ids=["contiguous", "paged_gathered"])
@pytest.mark.parametrize("partial", [True, False], ids=["partial", "full"])
def test_generate_matches_jax_engine(setup, paged, partial):
    s = setup
    kw = dict(paged=paged, zero_copy=False, partial_verification=partial)
    jtoks, jstats, je = _jgen(s, s["spec"], **kw)
    ttoks, tstats, te = _tgen(s, s["spec"], **kw)
    np.testing.assert_array_equal(ttoks, jtoks)
    assert tstats["modes"] == jstats["modes"]
    assert tstats["steps"] == jstats["steps"]
    assert tstats["mean_accept"] == pytest.approx(jstats["mean_accept"])
    # a gathered refresh bills its copy of the budget, as the
    # reference's _record_traffic does
    assert te.traffic.bytes_by_mode == je.traffic.bytes_by_mode
    if partial:
        assert {"refresh", "partial"} <= set(tstats["modes"])
        assert te.gathered and not te.zero_copy
    else:
        assert tstats["modes"] == {"full": tstats["steps"]}
        tar = t_ar(s["tcfg"], s["tp"], s["prompt"], NEW, max_len=MAX_LEN,
                   prefill_chunk=CHUNK, spec=_tspec(s["spec"]), device="cpu")
        np.testing.assert_array_equal(ttoks, tar)


def test_layouts_agree_inside_port(setup):
    """Contiguous == paged gathered == paged zero-copy, through the page
    table and through the materialised view: tokens, modes and
    mean_accept."""
    s = setup
    runs = {}
    for up in (True, False):
        spec = s["spec"].replace(use_pallas=up)
        for paged, zc in ((False, False), (True, False), (True, True)):
            toks, stats, _ = _tgen(s, spec, paged=paged, zero_copy=zc)
            runs[(up, paged, zc)] = (toks, stats)
    base_toks, base_stats = runs[(True, False, False)]
    assert {"refresh", "partial"} <= set(base_stats["modes"])
    for key, (toks, stats) in runs.items():
        np.testing.assert_array_equal(toks, base_toks, err_msg=str(key))
        assert stats["modes"] == base_stats["modes"], key
        assert stats["mean_accept"] == base_stats["mean_accept"], key


def test_prefill_contiguous_equals_paged_through_table(setup):
    """After the same prefill, the contiguous K/V and summaries equal the
    paged pool's read through the page table, bit for bit."""
    s = setup
    spec = s["spec"].replace(use_pallas=True)
    con = _tengine(s, spec, paged=False)
    pag = _tengine(s, spec, paged=True, zero_copy=True)
    con.prefill(s["prompt"], chunk=CHUNK)
    pag.prefill(s["prompt"], chunk=CHUNK)
    cc, pc = con.state.cache, pag.state.cache
    pt = pc["page_table"].long()
    n = PROMPT
    for name in ("k", "v"):
        view = pc[name][:, pt].flatten(2, 3)[:, :, :n]
        torch.testing.assert_close(cc[name][:, :, :n], view, rtol=0, atol=0)
    for name in ("kmax", "kmin"):
        nb = -(-n // 16)
        torch.testing.assert_close(cc[name][:, :, :nb],
                                   pc[name][:, pt][:, :, :nb], rtol=0, atol=0)
    np.testing.assert_array_equal(cc["length"].numpy(), pc["length"].numpy())


def test_gathered_body_partial_equals_routed(setup):
    """One Refresh on a gathered and a zero-copy engine (same paged pool
    contents): the same selection, and the body's partial attention
    through K1's plain version equals the routed read, bit for bit."""
    s = setup
    spec = s["spec"].replace(use_pallas=True)
    ga = _tengine(s, spec, paged=True, zero_copy=False)
    zc = _tengine(s, spec, paged=True, zero_copy=True)
    for e in (ga, zc):
        st = e.prefill(s["prompt"], chunk=CHUNK)
        e.step(st, "refresh")
    torch.testing.assert_close(ga.state.pkv_blocks, zc.state.pkv_blocks,
                               rtol=0, atol=0)
    assert (ga.state.pkv_blocks >= 0).any()
    rng = np.random.default_rng(15)
    cfg = s["tcfg"]
    q = _t(rng.standard_normal((B, 5, cfg.num_heads, cfg.head_dim_))
           .astype(np.float32))
    length = zc.state.cache["length"]
    for layer in (0, cfg.num_layers - 1):
        pbi = zc.state.pkv_blocks[:, layer]
        bufs = tuple(a[layer] for a in (zc.state.pkv_k, zc.state.pkv_v,
                                        zc.state.pkv_pos))
        routed = tdn._partial_context(
            q, (zc.state.cache["k"][layer], zc.state.cache["v"][layer]),
            zc.state.cache["page_table"], pbi, length, bufs, 16)
        body = (ga.state.pkv_body_k[layer], ga.state.pkv_body_v[layer])
        gathered = tdn._partial_context(q, None, None, pbi, length,
                                        bufs + body, 16)
        for a, b in zip(gathered, routed):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
