"""The PyTorch port's kernel modules against the JAX package.

On the CPU the port's wrappers run their kernels' plain versions
(``repro_torch/kernels/ref.py``); these are held against the JAX oracles
(``repro/kernels/ref.py``) and the JAX wrappers with ``use_pallas=True``
(Pallas interpret mode, as ``tests/test_kernels.py`` runs them), on the
same numpy inputs.  Tolerances are the reference's: attention partials
1e-4 in fp32 and 3e-2 in bf16, scores 2e-3, summaries 1e-6.  The WKV
recurrence (K5) is held to ``repro/kernels/wkv_scan.py:wkv_ref`` at 1e-5
in fp32 (the Pallas form fails under the installed jax).

The CUDA kernels themselves are held against these plain versions in
``tests/test_torch_cuda.py`` (on the card only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.prefill_attention import paged_prefill_attention_pallas
from repro.kernels.retrieval_score import retrieval_score_pallas
from repro.kernels.sparse_attention import sparse_verify_attention_pallas
from repro.kernels.wkv_scan import wkv_ref as j_wkv_ref
from repro.kvcache import cache as jkvc
from repro_torch.kvcache import cache as tkvc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """The same numpy values as a JAX array and a torch tensor."""
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a, JDT[dtype]),
            torch.from_numpy(a.copy()).to(TDT[dtype]))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _routed_case(rng, *, b=2, t=5, h=4, hk=2, dh=16, bs=16, npg=7, ns=4):
    """Random pool with ragged valid lengths, unused slots (vlen 0, page
    0) and one row whose slots are all empty."""
    q = rng.normal(size=(b, t, h, dh))
    pool_k = rng.normal(size=(npg, bs, hk, dh))
    pool_v = rng.normal(size=(npg, bs, hk, dh))
    idx = rng.integers(0, npg, (b, hk, ns)).astype(np.int32)
    vlen = rng.integers(0, bs + 1, (b, hk, ns)).astype(np.int32)
    vlen[0, 0, -1] = 0
    idx[0, 0, -1] = 0                    # unused slot on the null page
    vlen[1, 1] = 0                       # an all-empty (row, head)
    return q, pool_k, pool_v, idx, vlen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_verify_ref_matches_jax_oracle_and_pallas(dtype):
    rng = np.random.default_rng(0)
    q, pk, pv, idx, vlen = _routed_case(rng)
    npg, bs, hk, dh = pk.shape
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(pk.reshape(npg * bs, hk, dh), dtype)
    jv, tv = _pair(pv.reshape(npg * bs, hk, dh), dtype)
    for r in range(q.shape[0]):
        want = jref.sparse_verify_attention_ref(
            jq[r], jk, jv, jnp.asarray(idx[r]), jnp.asarray(vlen[r]), bs)
        pal = sparse_verify_attention_pallas(
            jq[r], jk, jv, jnp.asarray(idx[r]), jnp.asarray(vlen[r]), bs,
            interpret=True)
        got = tref.sparse_verify_attention_ref(
            tq[r], tk, tv, torch.from_numpy(idx[r]),
            torch.from_numpy(vlen[r]), bs)
        for g, w, p in zip(got, want, pal):
            _close(g, w, TOL[dtype])
            _close(g, p, TOL[dtype])


def test_all_masked_row_is_exact():
    """A row whose blocks all have length 0 comes out exactly
    (m=-1e30, l=0, acc=0), never NaN."""
    rng = np.random.default_rng(1)
    q, pk, pv, idx, vlen = _routed_case(rng)
    npg, bs, hk, dh = pk.shape
    m, l, acc = tops.routed_partial_attention(
        torch.from_numpy(q).float(), torch.from_numpy(pk).float(),
        torch.from_numpy(pv).float(), torch.from_numpy(idx),
        torch.from_numpy(vlen))
    rep = q.shape[2] // hk
    heads = slice(1 * rep, 2 * rep)      # kv head 1 of row 1 is all empty
    assert torch.all(m[1, heads] == -1e30)
    assert torch.all(l[1, heads] == 0) and torch.all(acc[1, heads] == 0)
    assert torch.isfinite(acc).all() and torch.isfinite(l).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routed_and_paged_wrappers_match_jax(dtype):
    rng = np.random.default_rng(2)
    q, pk, pv, idx, vlen = _routed_case(rng)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(pk, dtype)
    jv, tv = _pair(pv, dtype)
    want = jops.routed_partial_attention(jq, jk, jv, jnp.asarray(idx),
                                         jnp.asarray(vlen), use_pallas=True)
    got = tops.routed_partial_attention(tq, tk, tv, torch.from_numpy(idx),
                                        torch.from_numpy(vlen))
    for g, w in zip(got, want):
        _close(g, w, TOL[dtype])
    # paged: ragged per-row lengths, one row at length 0 (a partial row
    # of a fused tick) that streams only the null page
    npg, bs = pk.shape[:2]
    pt = np.stack([rng.permutation(np.arange(1, npg))[:4]
                   for _ in range(2)]).astype(np.int32)
    length = np.asarray([2 * bs + 3, 0], np.int32)
    want = jops.paged_verify_attention(jq, jk, jv, jnp.asarray(pt),
                                       jnp.asarray(length), use_pallas=True)
    got = tops.paged_verify_attention(tq, tk, tv, torch.from_numpy(pt),
                                      torch.from_numpy(length))
    for g, w in zip(got, want):
        _close(g, w, TOL[dtype])
    assert torch.all(got[0][1] == -1e30) and torch.all(got[1][1] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_matches_jax(dtype):
    rng = np.random.default_rng(3)
    b, t, h, hk, dh, bs, npg = 2, 12, 4, 2, 16, 16, 9
    q = rng.normal(size=(b, t, h, dh))
    pk = rng.normal(size=(npg, bs, hk, dh))
    pv = rng.normal(size=(npg, bs, hk, dh))
    pt = np.stack([rng.permutation(np.arange(1, npg))[:5]
                   for _ in range(b)]).astype(np.int32)
    length = np.asarray([bs + bs // 2, 0], np.int32)     # resumed + fresh
    t_valid = np.asarray([t, t - 3], np.int32)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(pk, dtype)
    jv, tv = _pair(pv, dtype)
    want = jops.paged_prefill_attention(jq, jk, jv, jnp.asarray(pt),
                                        jnp.asarray(length),
                                        jnp.asarray(t_valid), use_pallas=True)
    got = tops.paged_prefill_attention(tq, tk, tv, torch.from_numpy(pt),
                                       torch.from_numpy(length),
                                       torch.from_numpy(t_valid))
    rows = np.arange(t)[None] < t_valid[:, None]        # pad rows are garbage
    g = got.float().numpy()[rows]
    w = np.asarray(want, np.float32)[rows]
    np.testing.assert_allclose(g, w, rtol=TOL[dtype], atol=TOL[dtype])
    # the single-row oracle, partials and all
    kf = pk.reshape(npg * bs, hk, dh)
    vf = pv.reshape(npg * bs, hk, dh)
    vl = np.clip(length[0] + t_valid[0] - np.arange(5) * bs, 0, bs)
    idx = np.broadcast_to(np.where(vl > 0, pt[0], 0), (hk, 5)).astype(np.int32)
    vlh = np.broadcast_to(vl, (hk, 5)).astype(np.int32)
    qo = np.asarray([length[0]], np.int32)
    args_j = (jnp.asarray(kf, JDT[dtype]), jnp.asarray(vf, JDT[dtype]),
              jnp.asarray(idx), jnp.asarray(vlh), jnp.asarray(qo))
    want = jref.paged_prefill_attention_ref(jq[0], *args_j, block_size=bs)
    pal = paged_prefill_attention_pallas(jq[0], *args_j, block_size=bs,
                                         interpret=True)
    got = tref.paged_prefill_attention_ref(
        tq[0], torch.from_numpy(kf).to(TDT[dtype]),
        torch.from_numpy(vf).to(TDT[dtype]), torch.from_numpy(idx.copy()),
        torch.from_numpy(vlh.copy()), torch.from_numpy(qo), bs)
    for g_, w_, p_ in zip(got, want, pal):
        _close(g_, w_, TOL[dtype])
        _close(g_, p_, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_retrieval_scores_match_jax(dtype):
    rng = np.random.default_rng(4)
    b, t, h, hk, dh, nb = 2, 7, 4, 2, 16, 6
    q = rng.normal(size=(b, t, h, dh))
    kmax = np.abs(rng.normal(size=(b, nb, hk, dh))).astype(np.float32)
    kmin = -np.abs(rng.normal(size=(b, nb, hk, dh))).astype(np.float32)
    qw = (rng.random((b, t)) > 0.4).astype(np.float32)
    qw[1] = 0.0                          # an all-zero weight row
    jq, tq = _pair(q, dtype)
    want = jops.retrieval_scores(jq, jnp.asarray(kmax), jnp.asarray(kmin),
                                 jnp.asarray(qw), use_pallas=True)
    got = tops.retrieval_scores(tq, torch.from_numpy(kmax),
                                torch.from_numpy(kmin), torch.from_numpy(qw))
    _close(got, want, 2e-3)
    w1 = jref.retrieval_score_ref(jq[0], jnp.asarray(kmax[0]),
                                  jnp.asarray(kmin[0]), jnp.asarray(qw[0]))
    p1 = retrieval_score_pallas(jq[0], jnp.asarray(kmax[0]),
                                jnp.asarray(kmin[0]), jnp.asarray(qw[0]),
                                interpret=True)
    g1 = tref.retrieval_score_ref(tq[0], torch.from_numpy(kmax[0]),
                                  torch.from_numpy(kmin[0]),
                                  torch.from_numpy(qw[0]))
    _close(g1, w1, 2e-3)
    _close(g1, p1, 2e-3)


def test_wrappers_reject_bad_inputs():
    q = torch.zeros((1, 2, 4, 16))
    pool = torch.zeros((3, 16, 2, 16))
    with pytest.raises(ValueError):
        tops.block_attention(q, pool.reshape(48, 2, 16),
                             pool.reshape(48, 2, 16),
                             torch.zeros((1, 3, 2), dtype=torch.int32),
                             torch.zeros((1, 3, 2), dtype=torch.int32), 16)
    with pytest.raises(TypeError):
        tops.block_attention(q, pool.reshape(48, 2, 16).double(),
                             pool.reshape(48, 2, 16),
                             torch.zeros((1, 2, 2), dtype=torch.int32),
                             torch.zeros((1, 2, 2), dtype=torch.int32), 16)
    with pytest.raises(ValueError):
        tops.retrieval_scores(q, torch.zeros((1, 3, 2, 16)),
                              torch.zeros((1, 3, 2, 16)), torch.zeros((1, 5)))
    x = torch.zeros((1, 3, 2, 8))
    with pytest.raises(ValueError):
        tops.wkv(x, x, x, x, torch.zeros((2, 8)), torch.zeros((1, 2, 8, 4)))
    with pytest.raises(TypeError):
        tops.wkv(x.double(), x, x, x, torch.zeros((2, 8)),
                 torch.zeros((1, 2, 8, 8)))
    with pytest.raises(ValueError):
        tops.block_summaries_routed(pool.reshape(48, 2, 16),
                                    torch.zeros(2, dtype=torch.int32),
                                    torch.zeros(3, dtype=torch.int32),
                                    torch.zeros(2, dtype=torch.int32),
                                    torch.zeros((3, 2, 16)),
                                    torch.zeros((3, 2, 16)), 16)


# ---------------------------------------------------------------------------
# K4: block summaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_summaries_match_pallas_interpret(dtype):
    """The contiguous contract: full, ragged, empty and length-0 rows."""
    rng = np.random.default_rng(11)
    bs, nb, hk, dh = 16, 5, 2, 8
    k = rng.normal(size=(4, nb * bs + 3, hk, dh))   # a ragged tail past NB
    length = np.asarray([nb * bs, 37, 0, 16], np.int32)
    kj, kt = _pair(k, dtype)
    want = jops.block_summaries(kj, jnp.asarray(length), block_size=bs,
                                use_pallas=True)
    got = tops.block_summaries(kt.contiguous(), torch.from_numpy(length), bs)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
    oracle = tref.block_summary_ref(kt[1], 37, bs)
    for g, w in zip(oracle, jref.block_summary_ref(kj[1], 37, bs)):
        _close(g, w, 1e-6)
    assert float(got[0][2].abs().max()) == 0.0      # length 0: all zero


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routed_block_summaries_match_oracle(dtype):
    """Routed entries (ragged, length 0, a clipped id, null-page target)
    against the reference oracle on each source block."""
    rng = np.random.default_rng(12)
    npg, bs, hk, dh = 6, 16, 2, 8
    pool = rng.normal(size=(npg, bs, hk, dh))
    src = np.asarray([3, 1, 5, 2, 9], np.int32)     # 9 clips to page 5
    vlen = np.asarray([16, 7, 0, 3, 16], np.int32)
    tgt = np.asarray([3, 1, 5, 0, 4], np.int32)     # entry 3 hits the null page
    pj, pt = _pair(pool, dtype)
    kmax = torch.zeros((npg, hk, dh))
    kmin = torch.zeros((npg, hk, dh))
    tops.block_summaries_routed(pt.reshape(npg * bs, hk, dh),
                                torch.from_numpy(src), torch.from_numpy(vlen),
                                torch.from_numpy(tgt), kmax, kmin, bs)
    for e in range(len(src)):
        if tgt[e] == 0:
            continue
        w = jref.block_summary_ref(pj[min(src[e], npg - 1)], int(vlen[e]), bs)
        _close(kmax[tgt[e]], w[0][0], 1e-6)
        _close(kmin[tgt[e]], w[1][0], 1e-6)
    untouched = [p for p in range(npg) if p not in tgt[tgt > 0]]
    assert all(float(kmax[p].abs().max()) == 0.0 for p in untouched)
    assert 0 in untouched


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_update_summaries_matches_jax(dtype):
    """The paged cache's summary update (the K4 route on the card)
    against the reference's, from a zeroed pool: the null page stays 0."""
    rng = np.random.default_rng(13)
    npg, bs, hk, dh = 9, 8, 2, 4
    pool = rng.normal(size=(npg, bs, hk, dh))
    pt = np.asarray([[3, 1, 5, 0], [2, 6, 4, 8]], np.int32)
    start = np.asarray([6, 13], np.int32)
    end = np.asarray([21, 30], np.int32)
    pj, ptt = _pair(pool, dtype)
    z = np.zeros((npg, hk, dh), np.float32)
    wj = jkvc.paged_update_summaries(jnp.asarray(z), jnp.asarray(z), pj,
                                     jnp.asarray(pt), jnp.asarray(start),
                                     jnp.asarray(end), 3)
    wt = tkvc.paged_update_summaries(torch.zeros(npg, hk, dh),
                                     torch.zeros(npg, hk, dh), ptt,
                                     torch.from_numpy(pt),
                                     torch.from_numpy(start),
                                     torch.from_numpy(end), 3)
    for g, w in zip(wt, wj):
        _close(g, w, 1e-6)
        assert float(g[0].abs().max()) == 0.0


# (start, end, n_touch) per case, B=2 rows of a 4-block table at block 8:
# prefill: row 0 writes blocks 0-2, the ragged third on the null page; row
#   1 ends past its table (block 3 full, blocks 4 and 5 outside it);
# commit: row 0 ends in a ragged block, row 1 runs past its table.
_SPANS = {"prefill": ([0, 24], [20, 37], 3),
          "commit": ([5, 26], [13, 35], 2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("span", sorted(_SPANS))
def test_all_layer_summaries_match_jax_vmap(dtype, span):
    """The all-layers summary update (one K4 call on the card) against the
    reference's ``paged_update_summaries`` mapped over L=3 layers with
    ``jax.vmap``, as the reference's commit does: untouched pages keep
    their summaries and page 0 stays 0 in every layer."""
    import jax
    rng = np.random.default_rng(14)
    layers, npg, bs, hk, dh = 3, 11, 8, 2, 4
    pool = rng.normal(size=(layers, npg, bs, hk, dh))
    pt = np.asarray([[3, 1, 0, 5], [2, 6, 4, 8]], np.int32)
    start, end, n_touch = (np.asarray(a, np.int32) if isinstance(a, list)
                           else a for a in _SPANS[span])
    init = rng.normal(size=(2, layers, npg, hk, dh)).astype(np.float32)
    init[:, :, 0] = 0.0                                  # the null page
    pj, ptt = _pair(pool, dtype)
    wj = jax.vmap(lambda kx, kn, p: jkvc.paged_update_summaries(
        kx, kn, p, jnp.asarray(pt), jnp.asarray(start), jnp.asarray(end),
        n_touch))(jnp.asarray(init[0]), jnp.asarray(init[1]), pj)
    got = torch.from_numpy(init.copy())
    tkvc.paged_update_all_summaries(got[0], got[1], ptt, torch.from_numpy(pt),
                                    torch.from_numpy(start),
                                    torch.from_numpy(end), n_touch)
    for g, w in zip(got, wj):
        _close(g, w, 1e-6)
        assert float(g[:, 0].abs().max()) == 0.0
    touched = {int(pt[b, t // bs]) for b in range(2)
               for t in range(start[b], end[b]) if t // bs < pt.shape[1]}
    for p in set(range(1, npg)) - touched:
        assert torch.equal(got[:, :, p], torch.from_numpy(init[:, :, p]))
    assert not torch.equal(got, torch.from_numpy(init))


def _tiny_paged_cache(seed):
    from repro_torch import configs as tcfgs
    from repro_torch.models import api as tapi
    cfg = tcfgs.get_config("tiny-dense")
    spec = tcfgs.SpecPVConfig(block_size=16, use_pallas=True)
    params = tapi.init_params(cfg, seed=seed, device="cpu")
    cache = tapi.init_cache(cfg, 2, 160, spec, paged=True, device="cpu")
    nb = cache["page_table"].shape[1]
    cache["page_table"] = torch.randperm(
        cache["k"].shape[1] - 1, generator=torch.Generator().manual_seed(
            seed))[: 2 * nb].reshape(2, nb).to(torch.int32) + 1
    return cfg, spec, params, cache


def _per_layer_summaries(before, pool, table, start, end, n_touch):
    """The per-layer update, once per layer, from the summaries ``before``."""
    kmax, kmin = (a.clone() for a in before)
    for i in range(pool.shape[0]):
        tkvc.paged_update_summaries(kmax[i], kmin[i], pool[i], table, start,
                                    end, n_touch)
    return kmax, kmin


@pytest.mark.parametrize("where", ["prefill", "append_full_cache"])
def test_one_summary_call_equals_one_per_layer(where):
    """The paged prefill and ``append_full_cache`` update the summaries of
    all layers in one call after the layer loop; one call per layer on
    the same pool gives the same bits."""
    from repro_torch.core import verify as tvf
    from repro_torch.models import api as tapi
    cfg, spec, params, cache = _tiny_paged_cache(seed=3)
    rng = np.random.default_rng(15)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    _, _, cache = tapi.prefill(cfg, params, toks[:, :21], cache, spec=spec)
    start = cache["length"].clone()
    before = (cache["kmax"].clone(), cache["kmin"].clone())
    if where == "prefill":
        t = 19
        _, _, cache = tapi.prefill(cfg, params, toks[:, 21:], cache,
                                   spec=spec)
    else:
        t = 7
        shape = (cfg.num_layers, 2, t) + tuple(cache["k"].shape[3:])
        ck, cv = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                  for _ in range(2))
        cache = tvf.append_full_cache(cache, ck, cv,
                                      torch.tensor([t, 3], dtype=torch.int32),
                                      spec)
    end = cache["length"]
    assert bool((end > start).all())
    want = _per_layer_summaries(before, cache["k"], cache["page_table"],
                                start, end, -(-t // spec.block_size) + 1)
    assert torch.equal(cache["kmax"], want[0])
    assert torch.equal(cache["kmin"], want[1])
    assert not torch.equal(cache["kmax"], before[0])


# ---------------------------------------------------------------------------
# K5: WKV recurrence
# ---------------------------------------------------------------------------

def _wkv_case(rng, b, t, h=3, dk=8):
    r, k, v = (rng.normal(size=(b, t, h, dk)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(-2.0, 1.0, (b, t, h, dk)))).astype(
        np.float32)
    u = rng.normal(size=(h, dk)).astype(np.float32)
    s0 = rng.normal(size=(b, h, dk, dk)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("t", [1, 6, 70])
def test_wkv_matches_reference_oracle(t):
    rng = np.random.default_rng(20 + t)
    r, k, v, w, u, s0 = _wkv_case(rng, 2, t)
    y, s = tops.wkv(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)))
    for i in range(2):
        yj, sj = j_wkv_ref(r[i], k[i], v[i], w[i], u, s0[i])
        _close(y[i], yj, 1e-5)
        _close(s[i], sj, 1e-5)
    y1, s1 = tref.wkv_ref(*(torch.from_numpy(a) for a in
                            (r[0], k[0], v[0], w[0], u, s0[0])))
    _close(y1, y[0], 0)
    _close(s1, s[0], 0)


def test_wkv_padded_valid_and_read_only():
    """Steps past a row's valid prefix give y from their own k, v over
    the state left at the prefix, and leave that state bit for bit;
    ``update=False`` returns the initial state itself."""
    rng = np.random.default_rng(30)
    t = 6
    r, k, v, w, u, s0 = _wkv_case(rng, 3, t)
    n_valid = np.asarray([6, 2, 0], np.int32)
    args = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    y, s = tops.wkv(*args, torch.from_numpy(n_valid))
    for i, n in enumerate(n_valid):
        yj, sj = j_wkv_ref(r[i, :n], k[i, :n], v[i, :n], w[i, :n], u, s0[i])
        _close(y[i, :n], yj, 1e-5)
        _close(s[i], sj, 1e-5)
        for tt in range(n, t):     # padded: one step from the prefix state
            yp, _ = j_wkv_ref(r[i, tt:tt + 1], k[i, tt:tt + 1],
                              v[i, tt:tt + 1], w[i, tt:tt + 1], u, sj)
            _close(y[i, tt], yp[0], 1e-5)
    np.testing.assert_array_equal(s[2].numpy(), s0[2])
    y_ro, s_ro = tops.wkv(*args, update=False)
    assert s_ro is args[5]
    y_full, _ = tops.wkv(*args)
    np.testing.assert_array_equal(y_ro.numpy(), y_full.numpy())


def test_cpu_tensors_never_launch():
    tops.reset_launch_counts()
    rng = np.random.default_rng(5)
    q, pk, pv, idx, vlen = _routed_case(rng)
    tops.routed_partial_attention(torch.from_numpy(q).float(),
                                  torch.from_numpy(pk).float(),
                                  torch.from_numpy(pv).float(),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(vlen))
    r, k, v, w, u, s0 = _wkv_case(rng, 1, 4)
    tops.wkv(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)))
    tops.block_summaries(torch.from_numpy(pk).float(),
                         torch.tensor([20, 3, 0, 5, 9, 1, 16]), 16)
    assert all(v == 0 for v in tops.LAUNCHES.values())
    assert not tops.WKV_SHAPES


# ---------------------------------------------------------------------------
# K1 split-KV and the bf16 kernel's numerics (plain models of the kernel)
# ---------------------------------------------------------------------------

def _rel_close(got, want, tol):
    """The kernel check: |got - want| <= tol * (|want| + max |want|) off
    the masked sentinel -1e30, which must match exactly."""
    masked = want <= -1e29
    if not torch.equal(got[masked], want[masked]):
        return False
    g, w = got[~masked], want[~masked]
    if w.numel() == 0:
        return True
    scale = w.abs().max().clamp(min=1e-30)
    return bool(torch.all((g - w).abs() <= tol * (w.abs() + scale)))


@pytest.mark.parametrize("splits", [1, 2, 3, 8, "auto", 40])
def test_kv_split_merge_matches_unsplit(splits):
    """The kernel's split: attention over each chunk of
    ``ref.kv_split_valid_len``, merged by ``merge_attn_partials``, equals
    the unsplit partials to 1e-6, with an all-empty (row, head) exact
    and chunks that hold no live block (6 slots, up to 40 chunks)."""
    from repro_torch.models.common import merge_attn_partials
    rng = np.random.default_rng(40)
    q, pk, pv, idx, vlen = _routed_case(rng, t=7, ns=6)
    vlen[1, 0, 2:] = 0                    # a list with 2 live blocks
    b, t, h, _ = q.shape
    npg, bs, hk, dh = pk.shape
    if splits == "auto":
        splits = tops.kv_splits(b, t, h, hk, idx.shape[2])
    tq = torch.from_numpy(q).float()
    tk = torch.from_numpy(pk).float().reshape(npg * bs, hk, dh)
    tv = torch.from_numpy(pv).float().reshape(npg * bs, hk, dh)
    ti, tl = torch.from_numpy(idx), torch.from_numpy(vlen)
    want = tref.block_attention_batched(tq, tk, tv, ti, tl, bs)
    chunks = tref.kv_split_valid_len(tl, splits)
    assert chunks.shape == (splits, *tl.shape)
    # every live block in exactly one chunk, chunks contiguous in the list
    assert torch.equal(chunks.sum(0), tl)
    owner = torch.where(chunks > 0, torch.arange(splits)[:, None, None, None],
                        -1).amax(0)
    live_owner = [owner[r, k][tl[r, k] > 0] for r in range(b)
                  for k in range(hk)]
    assert all(torch.all(o[1:] >= o[:-1]) for o in live_owner)
    got = merge_attn_partials([
        tref.block_attention_batched(tq, tk, tv, ti, c, bs) for c in chunks])
    for g, w in zip(got, want):
        assert _rel_close(g, w, 1e-6)
    rep = h // hk
    assert torch.all(got[0][1, rep:2 * rep] == -1e30)
    assert torch.all(got[1][1, rep:2 * rep] == 0)
    assert torch.all(got[2][1, rep:2 * rep] == 0)


@pytest.mark.parametrize("b,t,nsel,causal,want", [
    (1, 61, 35, False, 8),       # routed Partial: 8 heads x 4 row tiles x 8
    (1, 61, 66, False, 8),       # Full
    (1, 156, 66, False, 3),      # Refresh: 10 row tiles
    (1, 1, 3, False, 3),         # more chunks wanted than slots
    (4, 156, 66, False, 1),      # batch fills the card alone
    (1, 256, 64, True, 1),       # causal prefill is never split
])
def test_kv_splits_fill_the_card(b, t, nsel, causal, want):
    """``kv_splits`` at llama3.1-8b heads (H 32, Hk 8): at most
    ``TARGET_CTAS`` CTAs, and at least half of them unless the list or
    the causal form caps the split."""
    s = tops.kv_splits(b, t, 32, 8, nsel, causal)
    assert s == want
    ctas = b * 8 * -(-4 * t // tops.ROWS_PER_CTA) * s
    assert ctas <= max(tops.TARGET_CTAS, b * 8 * -(-4 * t // 64))
    if not causal and s < nsel and s > 1:
        assert ctas * 2 > tops.TARGET_CTAS


@pytest.mark.parametrize("b,t,nb,want", [
    (1, 156, 66, (3, 10, 8)),    # a refresh tick: 240 CTAs
    (1, 157, 66, (3, 10, 8)),    # a ragged last slice
    (1, 16, 33, (2, 1, 8)),      # one slice: scores written directly
    (1, 1, 1, (1, 1, 8)),
    (2, 0, 5, (1, 1, 16)),       # no queries: still one slice
])
def test_score_grid_covers_rows_and_blocks(b, t, nb, want):
    """K3's grid at llama3.1-8b heads (H 32, Hk 8): every (row, head,
    block) falls in one CTA, and a refresh tick fills the card's 132
    SMs."""
    tiles, slices, groups = tops.score_grid(b, t, 32, 8, nb)
    assert (tiles, slices, groups) == want
    assert tiles * tops.SCORE_BLOCKS >= nb > (tiles - 1) * tops.SCORE_BLOCKS
    assert slices * tops.SCORE_ROWS >= 4 * t
    if t == 156:
        assert tiles * slices * groups >= 132


def _bf16_values(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
        .to(torch.bfloat16).float()


@pytest.mark.parametrize("case", ["routed", "prefill"])
def test_pv_product_needs_hi_lo_split(case):
    """Why the bf16 kernel splits P: with fp32 accumulation, P rounded
    once to bf16 in the P V product misses the kernel check (1e-4 of the
    largest magnitude), while P = bf16 hi + bf16 lo meets it.  Shapes:
    the routed Partial tick (4 heads x 61 queries, 35 blocks of 128 keys)
    and a causal prefill chunk (4 x 256 queries after 7936 tokens)."""
    rng = np.random.default_rng(50)
    dh = 128
    if case == "routed":
        rows, keys = 4 * 61, 35 * 128
        mask = torch.ones((rows, keys), dtype=torch.bool)
    else:
        rows, keys = 4 * 256, 8192
        qpos = 7936 + torch.arange(rows) % 256
        mask = torch.arange(keys)[None] <= qpos[:, None]
    q, k, v = (_bf16_values(rng, (n, dh)) for n in (rows, keys, keys))
    logits = torch.where(mask, (q @ k.T) / np.sqrt(dh),
                         torch.full((rows, keys), -1e30))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m) * mask
    l = p.sum(-1, keepdim=True)
    want = p @ v
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    for prod, ok in ((hi @ v + lo @ v, True), (hi @ v, False)):
        passes = _rel_close(prod, want, 1e-4) and \
            _rel_close(prod / l, want / l, 1e-4)
        assert passes == ok
