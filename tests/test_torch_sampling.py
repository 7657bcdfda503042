"""The port's sampling functions against the JAX package's, on the CPU in
fp32 (twins of ``tests/test_sampling.py`` and of the chain cases of
``tests/test_tree.py``), inputs made from seeds with numpy.

* ``tree_speculative_sample`` given the acceptance uniforms JAX's own
  function draws (node n's from ``jax.random.split(row_key, T + 1)[n]``)
  gives JAX's path and accept length exactly, per-row temperatures and
  the chain mask included; its first emitted token follows the target
  distribution (4-sigma multinomial bound plus 0.01, as the reference's
  test); it reduces to greedy acceptance at temperature 1e-5; a row's
  result does not depend on the other rows.
* ``greedy_tree_accept`` with ``node_valid`` and ``chain_accept_greedy``
  equal JAX's; ``chain_accept_sampling`` reduces to greedy acceptance at
  temperature 1e-5 and, with the exact residual, its first token follows
  the target distribution.
* The stream: Threefry-2x32's published answers, keys that depend on
  (seed, row) alone, uniforms within a stated bound of uniform; the
  two-level draw picks a float64 inverse CDF's token (99% or more of
  draws) and never a zero-probability token.
* The sampled ``tree_draft`` with every row at temperature 0 drafts the
  greedy draft's tokens and JAX's, and its node logits [B, T+1, V] equal
  JAX's within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import draft as jdraft
from repro.core import tree as jtree
from repro.core.sampling import tree_speculative_sample as j_tss
from repro.models import api as japi
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core import draft as tdraft
from repro_torch.core import sampling as smp
from repro_torch.core import tree as ttree


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _case(seed, branch=(2, 1), b=3, v=10, scale=1.0):
    """A random verify case: tree, tokens [B, T], draft logits [B, T+1,
    V], target logits [B, 1+T, V] (slot 0 the root), root and node
    slots."""
    rng = np.random.default_rng(seed)
    tree = ttree.TreeSpec.from_branch(branch)
    t = tree.size
    return dict(
        branch=branch,
        tokens=rng.integers(0, v, (b, t)).astype(np.int32),
        draft=(rng.standard_normal((b, 1 + t, v)) * scale).astype(np.float32),
        target=(rng.standard_normal((b, 1 + t, v)) * scale).astype(
            np.float32),
        root=np.zeros((b,), np.int32),
        slots=np.broadcast_to(1 + np.arange(t)[None], (b, t)).astype(
            np.int32))


def _jax_uniforms(keys, t):
    """The acceptance uniforms JAX's ``tree_speculative_sample`` draws:
    row b's node n from ``split(keys[b], T + 1)[n]``."""
    return np.stack([np.asarray(jax.vmap(jax.random.uniform)(
        jax.random.split(k, t + 1)[:t])) for k in keys])


def _port_tss(c, u, u_bonus, temperature=1.0, node_valid=None):
    """The port's ``tree_speculative_sample`` on a ``_case``."""
    if np.ndim(temperature):
        temperature = _t(temperature, torch.float32)
    return smp.tree_speculative_sample(
        ttree.TreeSpec.from_branch(c["branch"]), _t(c["tokens"]),
        _t(c["draft"]), _t(c["target"]), _t(c["root"], torch.long),
        _t(c["slots"], torch.long), _t(u, torch.float32),
        _t(u_bonus, torch.float32), temperature=temperature,
        node_valid=None if node_valid is None else _t(node_valid))


@pytest.mark.parametrize("branch, seed, temps, chain", [
    ((2, 1), 1, 1.0, False),
    ((2, 2, 1), 2, [0.7, 1.0, 1.3], False),
    ((3, 2), 3, [0.5, 0.9, 2.0], False),
    ((2, 2, 1), 4, [1.0, 0.8, 1.2], True),
    ((1, 1, 1), 5, 1.0, False),
], ids=["b21", "b221-temps", "b32-temps", "b221-chain", "chain3"])
def test_tree_sample_path_equals_jax_given_its_uniforms(branch, seed, temps,
                                                        chain):
    """The port's acceptance on JAX's acceptance uniforms: the same path
    and accept length, row by row."""
    c = _case(seed, branch, b=24, v=8, scale=0.8)
    b, t = c["tokens"].shape
    tree_j = jtree.TreeSpec.from_branch(branch)
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    valid = (np.broadcast_to(tree_j.chain_mask()[None], (b, t))
             if chain else None)
    if np.ndim(temps):                  # one temperature per row
        temps = np.tile(np.asarray(temps, np.float32), b // len(temps))
    jp, ja, _ = j_tss(tree_j, jnp.asarray(c["tokens"]),
                      jnp.asarray(c["draft"]), jnp.asarray(c["target"]),
                      jnp.asarray(c["root"]), jnp.asarray(c["slots"]), keys,
                      temperature=(jnp.asarray(temps) if np.ndim(temps)
                                   else temps),
                      node_valid=None if valid is None else jnp.asarray(valid))
    tp, ta, tb = _port_tss(c, _jax_uniforms(keys, t),
                           np.full((b,), 0.5, np.float32), temperature=temps,
                           node_valid=valid)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert (ta.numpy() > 0).any() and (ta.numpy() < tree_j.depth).any()
    assert ((tb >= 0) & (tb < c["target"].shape[-1])).all()


@pytest.mark.parametrize("branch", [(1, 1), (2, 1), (3,)])
def test_first_token_distribution(branch):
    """Over 4000 trials, each a fresh i.i.d. draft from q with fresh
    uniforms (the trials are the batch rows), the first emitted token
    follows softmax(target at the root)."""
    v, n = 8, 4000
    tree = ttree.TreeSpec.from_branch(branch)
    t = tree.size
    rng = np.random.default_rng(0)
    target = rng.standard_normal((1, 1 + t, v)).astype(np.float32) * 1.5
    draft = rng.standard_normal((1, 1 + t, v)).astype(np.float32) * 1.5
    parent_rows = [1 + p if p >= 0 else 0 for p in tree.parents]
    q_nodes = torch.softmax(_t(draft[0, parent_rows]), dim=-1)   # [T, V]
    u_draft = _t(rng.random((n, t)), torch.float32)
    toks = smp.categorical(q_nodes[None].expand(n, t, v), u_draft)
    c = dict(branch=branch, tokens=toks.numpy(),
             draft=np.repeat(draft, n, 0), target=np.repeat(target, n, 0),
             root=np.zeros((n,), np.int32),
             slots=np.broadcast_to(1 + np.arange(t)[None], (n, t)))
    path, acc, bonus = _port_tss(c, rng.random((n, t)), rng.random((n,)))
    first = torch.where(acc > 0, toks.gather(
        1, torch.clamp(path[:, :1], min=0))[:, 0], bonus).numpy()
    emp = np.bincount(first, minlength=v) / n
    expect = torch.softmax(_t(target[0, 0]), dim=-1).numpy()
    sigma = np.sqrt(expect * (1 - expect) / n)
    assert (np.abs(emp - expect) < 4 * sigma + 0.01).all(), (emp, expect)


def test_greedy_limit():
    """At temperature 1e-5 the sampled acceptance is the greedy one."""
    c = _case(3, (2, 1), b=2, v=12)
    rng = np.random.default_rng(30)
    tree = ttree.TreeSpec.from_branch((2, 1))
    _, acc_s, bonus_s = _port_tss(c, rng.random((2, tree.size)),
                                  rng.random((2,)), temperature=1e-5)
    _, acc_g, bonus_g, _ = ttree.greedy_tree_accept(
        tree, _t(c["tokens"]), _t(c["target"]), _t(c["root"], torch.long),
        _t(c["slots"], torch.long))
    np.testing.assert_array_equal(acc_s.numpy(), acc_g.numpy())
    np.testing.assert_array_equal(bonus_s.numpy(), bonus_g.numpy())


def test_node_valid_restricts_acceptance_to_chain():
    c = _case(8, (2, 2), b=3)
    tree = ttree.TreeSpec.from_branch((2, 2))
    chain = set(np.nonzero(tree.chain_mask())[0])
    valid = np.broadcast_to(tree.chain_mask()[None], (3, tree.size))
    rng = np.random.default_rng(8)
    path, acc, _ = _port_tss(c, rng.random((3, tree.size)), rng.random((3,)),
                             node_valid=valid)
    pa = path.numpy()
    assert all(x in chain for x in pa[pa >= 0])
    assert (acc.numpy() <= tree.depth).all()


def test_per_row_isolation():
    """A row's result depends only on its own inputs and uniforms."""
    c = _case(6, (2, 1), b=3)
    tree = ttree.TreeSpec.from_branch((2, 1))
    rng = np.random.default_rng(6)
    u, ub = rng.random((3, tree.size)), rng.random((3,))
    temps = np.asarray([0.7, 1.0, 1.3], np.float32)
    full = _port_tss(c, u, ub, temperature=temps)
    solo = _port_tss({k: (v[:1] if isinstance(v, np.ndarray) else v)
                      for k, v in c.items()}, u[:1], ub[:1],
                     temperature=temps[:1])
    for f, s in zip(full, solo):
        np.testing.assert_array_equal(f.numpy()[:1], s.numpy())


@pytest.mark.parametrize("branch", [(2, 2, 1), (3, 2), (2, 1)])
def test_chain_masked_greedy_accept_equals_jax(branch):
    """``greedy_tree_accept`` masked to the chain and
    ``chain_accept_greedy`` on the chain's nodes equal JAX's and each
    other."""
    rng = np.random.default_rng(17)
    tree = ttree.TreeSpec.from_branch(branch)
    b, v, t = 3, 10, tree.size
    chain = np.nonzero(tree.chain_mask())[0]
    np.testing.assert_array_equal(
        tree.chain_mask(), jtree.TreeSpec.from_branch(branch).chain_mask())
    logits = rng.standard_normal((b, 1 + t, v)).astype(np.float32)
    toks = rng.integers(0, v, (b, t)).astype(np.int32)
    # make acceptances likely: most chain tokens are the argmax
    am = logits.argmax(-1)
    for l, n in enumerate(chain):
        prev = 0 if l == 0 else 1 + chain[l - 1]
        toks[:2, n] = am[:2, prev]
    root = np.zeros((b,), np.int32)
    slots = np.broadcast_to(1 + np.arange(t)[None], (b, t)).astype(np.int32)
    valid = np.broadcast_to(tree.chain_mask()[None], (b, t))
    tp, ta, tbon, tbp = ttree.greedy_tree_accept(
        tree, _t(toks), _t(logits), _t(root, torch.long),
        _t(slots, torch.long), node_valid=_t(valid))
    jp, ja, jbon, jbp = jtree.greedy_tree_accept(
        jtree.TreeSpec.from_branch(branch), jnp.asarray(toks),
        jnp.asarray(logits), jnp.asarray(root), jnp.asarray(slots),
        node_valid=jnp.asarray(valid))
    for a, j in zip((tp, ta, tbon, tbp), (jp, ja, jbon, jbp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    ca, cbon, cbp = ttree.chain_accept_greedy(
        _t(toks[:, chain]), _t(logits), _t(root, torch.long),
        _t(slots[:, chain], torch.long))
    ja2, jbon2, jbp2 = jtree.chain_accept_greedy(
        jnp.asarray(toks[:, chain]), jnp.asarray(logits), jnp.asarray(root),
        jnp.asarray(slots[:, chain]))
    for a, j in zip((ca, cbon, cbp), (ja2, jbon2, jbp2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    np.testing.assert_array_equal(ca.numpy(), ta.numpy())
    np.testing.assert_array_equal(cbon.numpy(), tbon.numpy())
    assert ta.numpy()[:2].min() == tree.depth


def test_chain_accept_sampling_greedy_limit():
    """At temperature 1e-5 with a point-mass draft the sampled chain
    acceptance is the greedy one (the reference's test)."""
    rng = np.random.default_rng(4)
    b, t, v = 3, 4, 12
    target = rng.standard_normal((b, 1 + t, v)).astype(np.float32)
    draft = rng.standard_normal((b, t, v)).astype(np.float32)
    chain = _t(draft.argmax(-1))
    root = torch.zeros((b,), dtype=torch.long)
    slots = 1 + torch.arange(t)[None].expand(b, t)
    got = ttree.chain_accept_sampling(
        chain, torch.zeros((b, t)), _t(target), root, slots,
        _t(rng.random((b, t)), torch.float32),
        _t(rng.random((b,)), torch.float32), temperature=1e-5,
        draft_logits=_t(draft))
    want = ttree.chain_accept_greedy(chain, _t(target), root, slots)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_chain_first_token_distribution():
    """Leviathan correctness with the exact-residual bonus: the first
    emitted token follows the target at the root, over 4000 trials."""
    rng = np.random.default_rng(9)
    t, v, n = 3, 8, 4000
    target = rng.standard_normal((1, 1 + t, v)).astype(np.float32) * 1.5
    draft = rng.standard_normal((1, t, v)).astype(np.float32) * 1.5
    q = torch.softmax(_t(draft[0]), dim=-1)                     # [T, V]
    toks = smp.categorical(q[None].expand(n, t, v),
                           _t(rng.random((n, t)), torch.float32))
    dlp = torch.log(torch.gather(q[None].expand(n, t, v), 2,
                                 toks[..., None])[..., 0])
    acc, bonus, _ = ttree.chain_accept_sampling(
        toks, dlp, _t(np.repeat(target, n, 0)),
        torch.zeros((n,), dtype=torch.long),
        1 + torch.arange(t)[None].expand(n, t),
        _t(rng.random((n, t)), torch.float32),
        _t(rng.random((n,)), torch.float32),
        draft_logits=_t(np.repeat(draft, n, 0)))
    first = torch.where(acc > 0, toks[:, 0], bonus).numpy()
    emp = np.bincount(first, minlength=v) / n
    expect = torch.softmax(_t(target[0, 0]), dim=-1).numpy()
    sigma = np.sqrt(expect * (1 - expect) / n)
    assert (np.abs(emp - expect) < 4 * sigma + 0.01).all(), (emp, expect)


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key, ctr, want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, ctr, want):
    """Threefry-2x32 (20 rounds) gives Random123's published answers,
    which JAX's ``threefry_2x32`` is tested against too."""
    args = [torch.tensor([x], dtype=torch.long) for x in key + ctr]
    assert tuple(int(y) for y in smp.threefry2x32(*args)) == want


def test_seed_keys_depend_on_seed_and_row_only():
    f3, s3 = smp.seed_keys(7, 3)
    f5, s5 = smp.seed_keys(7, 5)
    np.testing.assert_array_equal(f3.numpy(), f5[:3].numpy())
    np.testing.assert_array_equal(s3.numpy(), s5[:3].numpy())
    f8, s8 = smp.seed_keys(8, 3)
    assert not np.array_equal(s3.numpy(), s8.numpy())
    assert not np.array_equal(f3.numpy(), f8.numpy())
    assert not np.array_equal(f3.numpy(), s3.numpy())
    assert len({tuple(r) for r in s5.numpy().tolist()}) == 5
    assert ((s5 >= 0) & (s5 <= 0xFFFFFFFF)).all()
    # a row's step depends on its key alone
    nxt, u = smp.stream_draws(s5, 7)
    nxt1, u1 = smp.stream_draws(s5[2:3], 7)
    np.testing.assert_array_equal(nxt[2:3].numpy(), nxt1.numpy())
    np.testing.assert_array_equal(u[2:3].numpy(), u1.numpy())


def test_stream_uniforms_are_uniform():
    """1000 streams x 20 steps x 8 draws: every decile holds 10% of the
    160000 uniforms within 4 sigma, the mean is 1/2 within 4 sigma, and
    consecutive steps of one stream are uncorrelated within 4 sigma."""
    _, keys = smp.seed_keys(3, 1000)
    us = []
    for _ in range(20):
        keys, u = smp.stream_draws(keys, 8)
        us.append(u)
    u = torch.stack(us, dim=1).numpy().astype(np.float64)   # [1000, 20, 8]
    n = u.size
    assert ((u >= 0) & (u < 1)).all()
    counts = np.bincount((u * 10).astype(int).ravel(), minlength=10)
    sig = np.sqrt(n * 0.1 * 0.9)
    assert (np.abs(counts - n / 10) < 4 * sig).all(), counts
    assert abs(u.mean() - 0.5) < 4 * np.sqrt(1 / 12 / n)
    a, b = u[:, :-1, 0].ravel() - 0.5, u[:, 1:, 0].ravel() - 0.5
    assert abs(np.mean(a * b) / (1 / 12)) < 4 / np.sqrt(a.size)


def test_zero_probability_tokens_never_drawn():
    """Many zeros (as a residual has), edge uniforms included: every draw
    lands on a positive-probability token, and the draws follow the
    distribution within 4 sigma plus 0.005."""
    rng = np.random.default_rng(5)
    v, n = 64, 20000
    p = rng.random(v) * (rng.random(v) < 0.3)
    p[0] = p[-1] = 0.0
    probs = _t(p, torch.float32)[None].expand(n, v)
    u = rng.random(n).astype(np.float32)
    u[:4] = [0.0, 1.0 - 2.0 ** -24, 0.5, 2.0 ** -24]
    tok = smp.categorical(probs, _t(u)).numpy()
    assert (p[tok] > 0).all()
    emp = np.bincount(tok, minlength=v) / n
    expect = p / p.sum()
    sigma = np.sqrt(expect * (1 - expect) / n)
    assert (np.abs(emp - expect) < 4 * sigma + 0.005).all()
    # a residual-like row whose mass sits on one token draws it always
    one = torch.zeros((3, v))
    one[:, 17] = 1e-30
    assert (smp.categorical(one, _t([0.0, 0.5, 0.99999994])) == 17).all()


@pytest.mark.parametrize("v", [512, 1000, 4099])
def test_draw_inverts_the_cumulative_distribution(v):
    """The two-level draw (chunks of 128 tokens, padded, then a token
    inside the chunk) picks the token a float64 inverse CDF picks, at 99%
    of 2000 draws or more (the rest sit on a float32 rounding boundary),
    K draws per row at once."""
    rng = np.random.default_rng(v)
    p = rng.random((500, v)) * (rng.random((500, v)) < 0.5)
    u = rng.random((500, 4))
    got = smp.draw(_t(p, torch.float32), _t(u, torch.float32)).numpy()
    cdf = np.cumsum(p, axis=-1)
    want = np.stack([np.searchsorted(cdf[r], u[r] * cdf[r, -1], side="right")
                     for r in range(500)])
    assert (got == want).mean() >= 0.99
    assert (np.take_along_axis(p, got, axis=1) > 0).all()


# ---------------------------------------------------------------------------
# the sampled draft
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def draft_case(small_dcfg):
    cfg = jcfgs.get_config("tiny-dense")
    tcfg = tcfgs.get_config("tiny-dense")
    tdcfg = tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg))
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    dparams = jdraft.init_draft_params(cfg, small_dcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    td = draft_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, dparams), device="cpu")
    rng = np.random.default_rng(11)
    b, e = 3, 24
    ext = rng.integers(0, cfg.vocab_size, (b, e)).astype(np.int32)
    feats = (rng.standard_normal((b, e, 3 * cfg.d_model)) * 0.5).astype(
        np.float32)
    lens = np.asarray([24, 17, 9], np.int32)
    return dict(cfg=cfg, tcfg=tcfg, dcfg=small_dcfg, tdcfg=tdcfg,
                params=params, dparams=dparams, tp=tp, td=td, ext=ext,
                feats=feats, lens=lens)


def test_sampled_draft_at_temperature_zero(draft_case):
    s = draft_case
    b = s["ext"].shape[0]
    branch = s["dcfg"].tree_branch[: s["dcfg"].tree_depth]
    jt, tt = jtree.TreeSpec.from_branch(branch), ttree.TreeSpec.from_branch(
        branch)

    def port(**kw):
        cache = tdraft.init_draft_cache(s["tcfg"], b, 64, "cpu")
        return tdraft.draft_phase(
            s["tcfg"], s["tdcfg"], s["td"], s["tp"], tt, cache,
            _t(s["ext"], torch.long), _t(s["feats"]),
            _t(s["lens"], torch.long), **kw)[1:]

    def jax_(**kw):
        def run(dp, params, ext, feats, lens, kw):
            cache = jdraft.init_draft_cache(s["cfg"], b, 64)
            return jdraft.draft_phase(s["cfg"], s["dcfg"], dp, params, jt,
                                      cache, ext, feats, lens, **kw)[1:]
        return jax.jit(run)(s["dparams"], s["params"], jnp.asarray(s["ext"]),
                            jnp.asarray(s["feats"]), jnp.asarray(s["lens"]),
                            kw)

    g_toks, _ = port()
    u = _t(np.random.default_rng(12).random((b, tt.size)), torch.float32)
    s_toks, node_logits = port(u=u, temps=torch.zeros((b,)))
    j_toks, _ = jax_()
    js_toks, j_logits = jax_(sample_key=jax.random.split(
        jax.random.PRNGKey(5), b), temperature=jnp.zeros((b,)))
    np.testing.assert_array_equal(s_toks.numpy(), g_toks.numpy())
    np.testing.assert_array_equal(s_toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(s_toks.numpy(), np.asarray(js_toks))
    assert node_logits.shape == (b, tt.size + 1, s["cfg"].vocab_size)
    np.testing.assert_allclose(node_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-5, atol=1e-5)
    # sampled rows draw, greedy rows keep the top-k
    m_toks, _ = port(u=u, temps=torch.tensor([0.0, 0.9, 0.0]))
    np.testing.assert_array_equal(m_toks.numpy()[[0, 2]],
                                  g_toks.numpy()[[0, 2]])
    assert not np.array_equal(m_toks.numpy()[1], g_toks.numpy()[1])
