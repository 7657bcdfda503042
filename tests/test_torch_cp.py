"""Context-parallel verification in the PyTorch port
(``repro_torch.distributed``), on the CPU against the JAX package.

Ranks are real processes: gloo ranks spawned by
``tests/_torch_cp_ranks.py`` (which imports no JAX) over a file store,
each holding a contiguous sequence shard of the K/V cache, at 2 and at 4
ranks.  The reference's own multi-shard bodies need ``shard_map``, which
its single-shard tests show failing under this JAX; its per-shard bodies
run here under ``jax.vmap(body, axis_name="model")`` over the stacked
shards, where ``axis_index``, ``pmax`` and ``psum`` work.

* Each rank's output equals the reference's per-shard body
  (``_local_full_attention`` + ``psum_softmax_merge``, and
  ``_local_partial_attention`` with its ``budget // shards``) within
  1e-4, and every rank's output is bit-equal to rank 0's.
* The ranks equal the port's single-process form within 1e-5, and its
  unsharded route within 1e-5 (the reference's own bar,
  ``tests/test_sharded.py``) where sharding is exact: the full verify,
  and the retrieval case with one standout block per shard.  Elsewhere
  the shard-local selection stays within 1.5x the global top-k's error
  against full attention, the reference's bounded divergence.
* Each shard's selected block ids equal the reference's.
* The traffic model equals the reference's functions, integer for
  integer; a shard that is not a whole number of blocks, or summaries of
  another block count, raise ValueError.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cp_ranks as R
import repro.configs as jcfgs
import repro.distributed.cp_retrieval as jcr
import repro.distributed.cp_verify as jcv
from repro_torch import distributed as tdist
from repro_torch.kernels import ops
from repro_torch.models import common as cm

RANKS = (2, 4)
JSPEC = jcfgs.SpecPVConfig(block_size=R.BLOCK)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world's per-rank results: {n: [rank 0's, rank 1's, ...]}."""
    return {n: R.spawn_ranks(n, str(tmp_path_factory.mktemp(f"cp{n}")))
            for n in RANKS}


def _stack(a, n):
    """[B, S, ...] -> [n, B, S/n, ...]: the shards, stacked."""
    return np.stack([R.shard(a, r, n) for r in range(n)])


def _jax_full(d, n):
    """The reference's full-verify body on each of n shards."""
    sl = d["k"].shape[1] // n
    q, length = jnp.asarray(d["q"]), jnp.asarray(d["length"])

    def body(k_, v_):
        sid = jax.lax.axis_index("model")
        m, l, acc = jcv._local_full_attention(q, k_, v_, length, sid, sl)
        out = jcv.psum_softmax_merge(m, l, acc, "model")
        return out.transpose(0, 2, 1, 3)

    return np.asarray(jax.vmap(body, axis_name="model")(
        _stack(d["k"], n), _stack(d["v"], n)))


def _jax_partial(d, n, budget):
    """The reference's partial-verify body on each of n shards, with its
    ``max(1, budget // n)``."""
    sl = d["k"].shape[1] // n
    q, length = jnp.asarray(d["q"]), jnp.asarray(d["length"])

    def body(k_, v_, kx, kn):
        sid = jax.lax.axis_index("model")
        return jcr._local_partial_attention(JSPEC, max(1, budget // n), q,
                                            k_, v_, kx, kn, length, sid, sl,
                                            "model")

    return np.asarray(jax.vmap(body, axis_name="model")(
        _stack(d["k"], n), _stack(d["v"], n), _stack(d["kmax"], n),
        _stack(d["kmin"], n)))


def _jax_selection(d, n, budget, r):
    """Shard r's selection as the reference's body computes it (its
    scoring and ``jax.lax.top_k``, ``cp_retrieval.py``)."""
    bs = R.BLOCK
    kx, kn = R.shard(d["kmax"], r, n), R.shard(d["kmin"], r, n)
    b, t, h, dh = d["q"].shape
    nb_loc, hk = kx.shape[1], kx.shape[2]
    blk_start = r * (d["k"].shape[1] // n) + jnp.arange(nb_loc) * bs
    n_valid = jnp.clip(jnp.asarray(d["length"])[:, None] - blk_start[None],
                       0, bs)
    qg = jnp.asarray(d["q"]).reshape(b, t, hk, h // hk, dh)
    smax = jnp.einsum("btkrd,bnkd->btkrn", qg, jnp.asarray(kx))
    smin = jnp.einsum("btkrd,bnkd->btkrn", qg, jnp.asarray(kn))
    s = jnp.maximum(smax, smin).mean(axis=(1, 3))
    s = jnp.where((n_valid > 0)[:, None, :], s, -jnp.inf)
    _, idx = jax.lax.top_k(s, min(max(1, budget // n), nb_loc))
    return np.asarray(idx)


def _torch(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _unsharded(name, d):
    """The port's unsharded route over the whole cache: K1's contiguous
    form (full), or the global top-``budget`` selection and K1's
    block-list form (one shard holding everything)."""
    kind, c = R.CASES[name]
    t = _torch(d)
    if kind == "full":
        part = ops.contiguous_verify_attention(t["q"], t["k"], t["v"],
                                               t["length"], R.BLOCK)
    else:
        m, l, acc, _ = tdist.local_partial_partials(
            R.SPEC, c["budget"], t["q"], t["k"], t["v"], t["kmax"],
            t["kmin"], t["length"], 0)
        part = (m, l, acc)
    return cm.combine_attn_parts([part], torch.float32).numpy()


def _single(name, d, n):
    kind, c = R.CASES[name]
    t = _torch(d)
    sh = {k: [torch.as_tensor(R.shard(d[k], r, n)) for r in range(n)]
          for k in ("k", "v", "kmax", "kmin") if k in d}
    if kind == "full":
        return tdist.cp_full_verify_single(t["q"], sh["k"], sh["v"],
                                           t["length"], R.BLOCK).numpy()
    out, _ = tdist.cp_partial_verify_single(
        R.SPEC, c["budget"], t["q"], sh["k"], sh["v"], sh["kmax"],
        sh["kmin"], t["length"])
    return out.numpy()


def _full_attention(d):
    """Softmax attention over every valid key (the oracle the retrieval
    approximates)."""
    t = _torch(d)
    part = ops.contiguous_verify_attention(t["q"], t["k"], t["v"],
                                           t["length"], R.BLOCK)
    return cm.combine_attn_parts([part], torch.float32).numpy()


CASE_IDS = list(itertools.product(RANKS, R.CASES))


@pytest.mark.parametrize("n,name", CASE_IDS,
                         ids=[f"{n}ranks-{c}" for n, c in CASE_IDS])
def test_ranks_match_reference_bodies(ranks, n, name):
    kind, c = R.CASES[name]
    d = R.make_case(name)
    want = (_jax_full(d, n) if kind == "full"
            else _jax_partial(d, n, c["budget"]))
    outs = [res[name]["out"] for res in ranks[n]]
    for r, out in enumerate(outs):
        assert out.shape == d["q"].shape and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), want[r], rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(out, outs[0]), f"rank {r} differs from rank 0"


@pytest.mark.parametrize("n,name", CASE_IDS,
                         ids=[f"{n}ranks-{c}" for n, c in CASE_IDS])
def test_ranks_match_the_ports_routes(ranks, n, name):
    kind, c = R.CASES[name]
    d = R.make_case(name)
    out = ranks[n][0][name]["out"].numpy()
    np.testing.assert_allclose(out, _single(name, d, n), rtol=1e-5,
                               atol=1e-5)
    whole = _unsharded(name, d)
    if kind == "full" or c.get("exact"):
        np.testing.assert_allclose(out, whole, rtol=1e-5, atol=1e-5)
    else:
        full = _full_attention(d)
        e_sh = np.linalg.norm(out - full)
        e_gl = np.linalg.norm(whole - full)
        assert e_sh <= 1.5 * e_gl + 1e-6, (e_sh, e_gl)


@pytest.mark.parametrize("n", RANKS)
def test_selections_match_reference_per_shard(ranks, n):
    for name, (kind, c) in R.CASES.items():
        if kind != "partial":
            continue
        d = R.make_case(name)
        for r in range(n):
            got = ranks[n][r][name]["sel"].numpy()
            np.testing.assert_array_equal(
                got, _jax_selection(d, n, c["budget"], r),
                err_msg=f"{name}, shard {r} of {n}")


def test_engineered_case_selects_each_shards_standout(ranks):
    """One standout block per quarter of the sequence: at 4 ranks each
    shard keeps its own (local block 1), which together are the global
    top 4; at 2 ranks each keeps its two (local blocks 1 and 9)."""
    for r, res in enumerate(ranks[4]):
        sel = res["partial_engineered"]["sel"].numpy()
        assert (sel == 1).all(), (r, sel)
    for r, res in enumerate(ranks[2]):
        sel = np.sort(res["partial_engineered"]["sel"].numpy(), axis=-1)
        assert (sel == [1, 9]).all(), (r, sel)


def test_traffic_model_equals_reference():
    grid = itertools.product((1, 8), (1, 8), (8, 32), (64, 128), (1, 32),
                             (1, 2, 8))
    for b, t, h, dh, layers, n in grid:
        assert tdist.merged_partials_bytes(b, t, h, dh, layers, n) == \
            jcv.merged_partials_bytes(b, t, h, dh, layers, n)
        for budget, bs, hk, item in itertools.product((8, 32), (16, 128),
                                                      (2, 8), (1, 2)):
            args = (budget, bs, hk, dh, layers, n, item)
            assert tdist.gathered_blocks_bytes(*args) == \
                jcv.gathered_blocks_bytes(*args)
            kw = dict(batch=b, q_tokens=t, num_heads=h, num_kv_heads=hk,
                      head_dim=dh, num_layers=layers, n_shards=n,
                      budget_blocks=budget, block_size=bs, kv_itemsize=item)
            assert tdist.verify_traffic_report(**kw) == \
                jcv.verify_traffic_report(**kw)
    assert tdist.merged_partials_bytes(8, 8, 32, 128, 32, 1) == 0
    assert tdist.gathered_blocks_bytes(128, 128, 8, 128, 32, 1) == 0


def test_shards_not_whole_blocks_raise():
    """Refused before any collective: no process group is needed."""
    d = _torch(R.make_case("partial_short"))
    k, v = d["k"][:, :40], d["v"][:, :40]
    with pytest.raises(ValueError, match="whole number"):
        tdist.cp_full_verify_attention(d["q"], k, v, d["length"], R.BLOCK)
    with pytest.raises(ValueError, match="whole number"):
        tdist.cp_partial_verify_attention(R.SPEC, 4, d["q"], k, v,
                                          d["kmax"][:, :3], d["kmin"][:, :3],
                                          d["length"])
    k, v = d["k"][:, :64], d["v"][:, :64]
    with pytest.raises(ValueError, match="kmax of the shard"):
        tdist.cp_partial_verify_attention(R.SPEC, 4, d["q"], k, v,
                                          d["kmax"][:, :3], d["kmin"][:, :3],
                                          d["length"])
