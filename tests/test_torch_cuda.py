"""The port's CUDA kernels against their plain PyTorch versions, and the
engine's CUDA graphs against its eager steps, on the card.  The file
imports no JAX (the card's machine has none); each test decides inside
itself whether a card is present and skips without one.  Run on the
card with::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

A kernel and its plain version widen the same inputs to fp32 and differ
only in summation order, so in both dtypes each output (m, l, acc, the
normalised attention, the scores) must agree to 1e-4 of its largest
magnitude: tight enough that a dropped 32-key tile fails.  The masked
sentinel m = -1e30 must match exactly.  The block summaries (K4) are
max/min and the WKV recurrence (K5) is fp32 throughout, so both are held
to the same check.  (The reference's 3e-2 bf16
tolerance is for comparisons with JAX, whose q scaling differs.)  fp32
results are compared, so the fixture turns TF32 off for matmuls and
convolutions (the plain versions' products).
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 1e-4
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want):
    masked = want <= -1e29
    assert torch.equal(got[masked], want[masked])
    g, w = got[~masked], want[~masked]
    if w.numel():
        scale = w.abs().max().clamp(min=1e-30)
        diff = (g - w).abs()
        assert torch.all(diff <= TOL * (w.abs() + scale)), (
            f"max abs err {diff.max().item():.3e}, "
            f"max |plain| {scale.item():.3e}")


def _assert_partials_close(got, want):
    for g, w in zip(got, want):
        _assert_close(g, w)
    _assert_close(got[2] / got[1].clamp(min=1e-30)[..., None],
                  want[2] / want[1].clamp(min=1e-30)[..., None])


def _cuda_case(dev, dtype, *, b=2, t=61, h=32, hk=8, dh=128, bs=128,
               npg=12, ns=9, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.randn((b, t, h, dh), generator=g, device=dev).to(dtype)
    pk = torch.randn((npg, bs, hk, dh), generator=g, device=dev).to(dtype)
    pv = torch.randn((npg, bs, hk, dh), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, npg, (b, hk, ns), generator=g, device=dev,
                        dtype=torch.int32)
    vlen = torch.randint(0, bs + 1, (b, hk, ns), generator=g, device=dev,
                         dtype=torch.int32)
    vlen[1, 3] = 0                       # an all-empty (row, head)
    return q, pk, pv, idx, vlen


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 6, 61, 156])
def test_cuda_block_attention_matches_plain(cuda, dtype, t):
    q, pk, pv, idx, vlen = _cuda_case(cuda, TDT[dtype], t=t)
    npg, bs, hk, dh = pk.shape
    kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
    before = tops.LAUNCHES["sparse_verify_attention"]
    got = tops.block_attention(q, kf, vf, idx, vlen, bs)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["sparse_verify_attention"] == before + 1
    want = tref.block_attention_batched(q, kf, vf, idx, vlen, bs)
    _assert_partials_close(got, want)
    rep = q.shape[2] // hk
    assert torch.all(got[0][1, 3 * rep:4 * rep] == -1e30)
    assert torch.all(got[1][1, 3 * rep:4 * rep] == 0)


def _kernel_launches(fn):
    """Device kernels launched by one call of ``fn`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(e.count for e in prof.key_averages()
                    if getattr(e, "device_type", None) == DeviceType.CUDA)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_routed_lists_split_and_launches(cuda, dtype):
    """K1 on routed lists: unused (vlen 0) slots at the end of every list,
    a list with fewer live blocks than the split count, and an all-empty
    (row, head); exact (-1e30, 0, 0) rows and at most two device launches
    per wrapper call (the split merges inside the kernel)."""
    q, pk, pv, idx, vlen = _cuda_case(cuda, TDT[dtype], t=61, ns=35,
                                      npg=40, seed=5)
    npg, bs, hk, dh = pk.shape
    b, t, h, _ = q.shape
    vlen[:, :, -3:] = 0                  # unused slots
    idx[:, :, -3:] = 0
    vlen[0, 2, 1:] = 0                   # one live block
    vlen[0, 5, :] = 0
    vlen[0, 5, 30] = 77                  # one live block, late in the list
    splits = tops.kv_splits(b, t, h, hk, idx.shape[2])
    if dtype == "bfloat16":
        assert splits > 1
    kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
    before = tops.LAUNCHES["sparse_verify_attention"]
    got, n = _kernel_launches(
        lambda: tops.block_attention(q, kf, vf, idx, vlen, bs))
    assert n <= 2
    assert tops.LAUNCHES["sparse_verify_attention"] == before + 2
    want = tref.block_attention_batched(q, kf, vf, idx, vlen, bs)
    _assert_partials_close(got, want)
    rep = h // hk
    empty = slice(3 * rep, 4 * rep)      # row 1, head 3 (from _cuda_case)
    assert torch.all(got[0][1, empty] == -1e30)
    assert torch.all(got[1][1, empty] == 0)
    assert torch.all(got[2][1, empty] == 0)
    # the counters are left at 0: a second call gives the same bits
    again = tops.block_attention(q, kf, vf, idx, vlen, bs)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qoff", [0, 700, 7936])
def test_cuda_paged_prefill_matches_plain(cuda, dtype, qoff):
    bs, t = 128, 256
    nbt = max(8, -(-(qoff + t) // bs))   # table pages per row
    q, pk, pv, _, _ = _cuda_case(cuda, TDT[dtype], t=t, seed=1,
                                 npg=nbt + 4)
    npg, bs, hk, dh = pk.shape
    b = q.shape[0]
    pt = torch.stack([torch.randperm(npg - 1, device=cuda)[:nbt] + 1
                      for _ in range(b)]).to(torch.int32)
    length = torch.tensor([qoff, 0], dtype=torch.int32, device=cuda)
    t_valid = torch.tensor([t, 200], dtype=torch.int32, device=cuda)
    end = length + t_valid
    vl = (end[:, None] - torch.arange(nbt, device=cuda)[None] * bs).clamp(0, bs)
    idx = torch.where(vl > 0, pt, 0)[:, None].expand(b, hk, nbt)
    idx = idx.to(torch.int32).contiguous()
    vlen = vl[:, None].expand(b, hk, nbt).to(torch.int32).contiguous()
    kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
    got, n = _kernel_launches(lambda: tops.block_attention(
        q, kf, vf, idx, vlen, bs, q_offset=length))
    assert n <= 2
    want = tref.block_attention_batched(q, kf, vf, idx, vlen, bs,
                                        q_offset=length)
    _assert_partials_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_retrieval_scores_match_plain(cuda, dtype):
    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    b, t, h, hk, dh, nb = 2, 156, 32, 8, 128, 37
    q = torch.randn((b, t, h, dh), generator=g, device=cuda).to(TDT[dtype])
    kmax = torch.randn((b, nb, hk, dh), generator=g, device=cuda).abs()
    kmin = -torch.randn((b, nb, hk, dh), generator=g, device=cuda).abs()
    qw = (torch.rand((b, t), generator=g, device=cuda) > 0.3).float()
    before = tops.LAUNCHES["retrieval_score"]
    got = tops.retrieval_scores(q, kmax, kmin, qw)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["retrieval_score"] == before + 1
    want = tref.retrieval_score_batched(q, kmax, kmin, qw)
    _assert_close(got, want)
    assert math.isfinite(got.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nb", [1, 33, 66])
@pytest.mark.parametrize("t", [1, 156, 157])
def test_cuda_retrieval_scores_edges_deterministic(cuda, dtype, nb, t):
    """K3 at the edges of its tiles (32 blocks) and row slices (64 rows =
    16 tokens of 4 heads), llama3.1-8b heads, batch 1: one device launch
    per call, agreement with the plain version, and equal bits from two
    calls (the slices merge in a fixed order, no float atomics)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(6 + nb + t)
    h, hk, dh = 32, 8, 128
    q = torch.randn((1, t, h, dh), generator=g, device=cuda).to(TDT[dtype])
    kmax = torch.randn((1, nb, hk, dh), generator=g, device=cuda).abs()
    kmin = -torch.randn((1, nb, hk, dh), generator=g, device=cuda).abs()
    qw = (torch.rand((1, t), generator=g, device=cuda) > 0.3).float()
    qw[0, 0] = 1.0
    before = tops.LAUNCHES["retrieval_score"]
    got, n = _kernel_launches(lambda: tops.retrieval_scores(q, kmax, kmin, qw))
    assert n == 1
    assert tops.LAUNCHES["retrieval_score"] == before + 2
    _assert_close(got, tref.retrieval_score_batched(q, kmax, kmin, qw))
    again = tops.retrieval_scores(q, kmax, kmin, qw)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles_off, slices_off",
                         [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)])
def test_cuda_retrieval_score_checks_the_grid(cuda, tiles_off, slices_off):
    """K3's C entry point launches only the grid it computes itself, so
    scratch and counters sized by ``ops.score_grid`` match what it
    writes: the wrapper's grid returns 0, any other -1 (nothing
    launched)."""
    from repro_torch.kernels.build import load_library
    b, t, h, hk, dh, nb = 1, 156, 32, 8, 128, 66
    q = torch.zeros((b, t, h, dh), device=cuda, dtype=torch.bfloat16)
    kmax = torch.zeros((b, nb, hk, dh), device=cuda)
    kmin = torch.zeros_like(kmax)
    qw = torch.ones((b, t), device=cuda)
    out = torch.zeros((b, hk, nb), device=cuda)
    tiles, slices, groups = tops.score_grid(b, t, h, hk, nb)
    assert (tiles, slices) == (3, 10)
    part = torch.empty((groups * (slices + 1) * nb,), device=cuda)
    counters = torch.zeros((groups * (tiles + 1),), dtype=torch.int32,
                           device=cuda)
    err = load_library().retrieval_score_launch(
        q.data_ptr(), kmax.data_ptr(), kmin.data_ptr(), qw.data_ptr(),
        out.data_ptr(), part.data_ptr(), counters.data_ptr(), b, t, h, hk,
        dh, nb, tiles + tiles_off, slices + slices_off, 1,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == (0 if (tiles_off, slices_off) == (0, 0) else -1)
    assert not counters.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_block_summaries_match_plain(cuda, dtype):
    """K4, routed (ragged, empty, clipped, null-page target) and
    contiguous, against its plain versions."""
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    npg, bs, hk, dh = 12, 128, 8, 128
    pool = torch.randn((npg * bs, hk, dh), generator=g,
                       device=cuda).to(TDT[dtype])
    src = torch.tensor([5, 2, 11, 7, 40], dtype=torch.int32, device=cuda)
    vlen = torch.tensor([128, 37, 0, 1, 128], dtype=torch.int32, device=cuda)
    tgt = torch.tensor([5, 2, 11, 0, 9], dtype=torch.int32, device=cuda)
    outs = [torch.zeros((npg, hk, dh), device=cuda) for _ in range(4)]
    before = tops.LAUNCHES["block_summary"]
    tops.block_summaries_routed(pool, src, vlen, tgt, outs[0], outs[1], bs)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["block_summary"] == before + 1
    tref.block_summary_routed(pool, src, vlen, torch.where(tgt > 0, tgt, -1),
                              outs[2], outs[3], bs)
    _assert_close(outs[0], outs[2])
    _assert_close(outs[1], outs[3])
    assert float(outs[0][0].abs().max()) == 0.0       # null page untouched
    k = pool.reshape(2, npg * bs // 2, hk, dh)
    length = torch.tensor([700, 129], device=cuda)
    got = tops.block_summaries(k, length, bs)
    torch.cuda.synchronize()
    for i in range(2):
        want = tref.block_summary_ref(k[i], int(length[i]), bs)
        _assert_close(got[0][i], want[0])
        _assert_close(got[1][i], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["prefill", "commit"])
def test_cuda_paged_block_summaries_match_plain(cuda, dtype, case):
    """K4's paged form over every layer (llama3.1-8b widths, 32 layers,
    two rows) against its plain version, bit for bit: a prefill chunk
    (n_touch 3, the third entry out of range) or a ragged commit, with a
    null page in one row's table and a span past the other row's table.
    One launch per call, page 0 still 0 in every layer, and two calls
    from the same state give the same bits."""
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    layers, npg, bs, hk, dh, nb = 32, 12, 128, 8, 128, 5
    pool = torch.randn((layers, npg, bs, hk, dh), generator=g,
                       device=cuda).to(TDT[dtype])
    table = torch.tensor([[3, 7, 0, 9, 1], [2, 11, 4, 6, 10]],
                         dtype=torch.int32, device=cuda)
    if case == "prefill":
        start, end, n_touch = [256, 512], [512, 768], 3
    else:
        start, end, n_touch = [390, 600], [433, 650], 2
    start, end = (torch.tensor(a, dtype=torch.int32, device=cuda)
                  for a in (start, end))
    init = torch.rand((2, layers, npg, hk, dh), generator=g, device=cuda)
    init[:, :, 0] = 0.0                                  # the null page
    got, again, want = (init.clone() for _ in range(3))
    before = tops.LAUNCHES["block_summary"]
    tops.paged_block_summaries(pool, table, start, end, n_touch, got[0],
                               got[1])
    torch.cuda.synchronize()
    assert tops.LAUNCHES["block_summary"] == before + 1
    tops.paged_block_summaries(pool, table, start, end, n_touch, again[0],
                               again[1])
    tref.paged_block_summaries(pool, table, start, end, n_touch, want[0],
                               want[1])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    assert float(got[:, :, 0].abs().max()) == 0.0
    assert not torch.equal(got, init)                   # something written


def _wkv_inputs(dev, b, t, seed, h=40, dk=64):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    r, k, v = (torch.randn((b, t, h, dk), generator=g, device=dev) * 0.5
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((b, t, h, dk), generator=g,
                                         device=dev) - 2.0))
    u = torch.randn((h, dk), generator=g, device=dev) * 0.5
    s0 = torch.randn((b, h, dk, dk), generator=g, device=dev)
    return r, k, v, w, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 6, 31, 33, 256, 257])
def test_cuda_wkv_matches_plain(cuda, t):
    """K5 at rwkv6-3b head shapes (H 40, dk 64), fp32, with one full row
    and one padded row, and the read-only form; T on both sides of the
    kernel's 32-token tiles."""
    b = 2
    r, k, v, w, u, s0 = _wkv_inputs(cuda, b, t, 4)
    n_valid = torch.tensor([t, t // 2], dtype=torch.int32, device=cuda)
    before = tops.LAUNCHES["wkv"]
    y, s = tops.wkv(r, k, v, w, u, s0, n_valid)
    y_ro, s_ro = tops.wkv(r, k, v, w, u, s0, n_valid, update=False)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["wkv"] == before + 2
    want_y, want_s = tref.wkv_batched(r, k, v, w, u, s0, n_valid)
    _assert_close(y, want_y)
    _assert_close(s, want_s)
    assert torch.equal(y_ro, y) and s_ro is s0
    if t // 2 == 0:
        assert torch.equal(s[1], s0[1])


@pytest.mark.cuda
@pytest.mark.parametrize("a", [0, 2, 6])
def test_cuda_wkv_verify_advance_identity(cuda, a):
    """What the chain engine relies on: a read-only T=6 call gives y equal
    bit for bit to six one-token update steps, and an advance of T=6
    with ``n_valid`` = a leaves the state bits that a one-token steps
    leave (rwkv6-3b heads, batch 1)."""
    t = 6
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 1, t, 7)
    y6, s_ro = tops.wkv(r, k, v, w, u, s0, update=False)
    assert s_ro is s0
    s, ys = s0, []
    for i in range(t):
        sl = slice(i, i + 1)
        y1, s = tops.wkv(r[:, sl].contiguous(), k[:, sl].contiguous(),
                         v[:, sl].contiguous(), w[:, sl].contiguous(), u, s)
        ys.append(y1)
        if i + 1 == a:
            s_a = s
    assert torch.equal(y6, torch.cat(ys, dim=1))
    n_valid = torch.tensor([a], dtype=torch.int32, device=cuda)
    _, s_adv = tops.wkv(r, k, v, w, u, s0, n_valid)
    torch.cuda.synchronize()
    assert torch.equal(s_adv, s0 if a == 0 else s_a)


# ---------------------------------------------------------------------------
# the compiled step: CUDA graphs of the engine's step bodies
# ---------------------------------------------------------------------------

def _model(dev, name):
    """``name`` cut to 2 layers at full widths (the kernels need head dim
    128 / 64), random bf16 weights, with its spec and draft config."""
    from repro_torch.configs import DraftConfig, SpecPVConfig, get_config
    from repro_torch.core.draft import init_draft_params
    from repro_torch.models.api import init_params
    cfg = get_config(name).replace(num_layers=2)
    spec = (SpecPVConfig(use_pallas=True, score_mode="paper",
                         reduction="mean") if name != "rwkv6-3b"
            else SpecPVConfig())
    dcfg = DraftConfig()
    return (cfg, spec, dcfg, init_params(cfg, seed=0, device=dev),
            init_draft_params(cfg, dcfg, seed=1, device=dev))


def _engine(model, prompt_len, new, **kw):
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    cfg, spec, dcfg, params, dparams = model
    max_len = request_token_need(prompt_len, new, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    return SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=max_len, paged=cfg.arch_type == "dense",
                        device="cuda", **kw)


# llama: a prompt 6 tokens under the partial budget, so Full, Refresh and
# Partial steps all run (nothing is accepted with random weights)
GRAPH_CASES = {"llama3.1-8b": (35 * 128 - 6, 24), "rwkv6-3b": (600, 16)}


@pytest.fixture(scope="module")
def models():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return {}


def _get_model(models, name):
    if name not in models:
        models.clear()              # one model on the card at a time
        torch.cuda.empty_cache()
        models[name] = _model(torch.device("cuda"), name)
    return models[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_cuda_graph_generate_equals_eager(cuda, models, name):
    """Graph ``generate`` (the default on the card) equals eager
    ``generate`` token for token from the first step on, the steps that
    captured a graph included, with the same launch counts and state;
    one graph per step variant that ran and one for the 256-token
    prefill chunk."""
    import numpy as np
    model = _get_model(models, name)
    prompt_len, new = GRAPH_CASES[name]
    prompt = np.random.default_rng(0).integers(
        0, model[0].vocab_size, (1, prompt_len)).astype(np.int64)
    runs = []
    for graphs in (False, True):
        eng = _engine(model, prompt_len, new, cuda_graphs=graphs)
        assert eng.cuda_graphs is graphs
        tops.reset_launch_counts()
        toks, stats = eng.generate(prompt, new)
        torch.cuda.synchronize()
        runs.append((eng, toks, stats, tops.launch_counts()))
    (eager, et, es, ec), (graph, gt, gs, gc) = runs
    assert np.array_equal(gt, et)
    assert gs["modes"] == es["modes"] and gc == ec
    if name == "rwkv6-3b":
        keys = {"state"}
        assert ec[1] and sum(ec[1].values()) == ec[0]["wkv"]
    else:
        assert set(gs["modes"]) == {"full", "refresh", "partial"}
        keys = {(True, False, False), (True, False, True),
                (False, True, False)}
        assert all(ec[0][k] > 0 for k in ("sparse_verify_attention",
                                          "paged_prefill_attention",
                                          "retrieval_score", "block_summary"))
    assert set(graph._graphs) == keys | {("prefill", 256)}
    # the whole state, K/V pools included (the warm-up before each
    # capture restores all but the pools), bit for bit; the paged pools'
    # null page 0 takes pad writes in no fixed order and is left out
    for f in dataclasses.fields(graph.state):
        g, e = getattr(graph.state, f.name), getattr(eager.state, f.name)
        for k in (g if isinstance(g, dict) else [None]):
            a, b = (g, e) if k is None else (g[k], e[k])
            if k in ("k", "v") and "page_table" in g:
                a, b = a[..., 1:, :, :, :], b[..., 1:, :, :, :]
            assert torch.equal(a, b), (f.name, k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_cuda_step_bodies_do_not_sync(cuda, models, name):
    """One eager run of the prefill chunk and of each step variant's body
    under ``torch.cuda.set_sync_debug_mode("error")``: nothing a graph
    captures reads from the host or waits for the card."""
    import numpy as np
    from repro_torch.core.engine import MODE_IDS
    model = _get_model(models, name)
    prompt_len, new = GRAPH_CASES[name]
    eng = _engine(model, prompt_len, new, cuda_graphs=False)
    prompt = np.random.default_rng(1).integers(
        0, model[0].vocab_size, (1, prompt_len)).astype(np.int64)
    st = eng.prefill(prompt)
    toks = torch.zeros((1, 256), dtype=torch.long, device=cuda)
    bodies = [lambda: eng._prefill_body(toks, st.cache, st.dcache,
                                        eng._prev_feat, eng._logits_last)]
    if name == "rwkv6-3b":
        bodies.append(eng._state_body)
    else:
        eng._rows.fill_(True)
        for mode, key in (("full", (True, False, False)),
                          ("refresh", (True, False, True)),
                          ("partial", (False, True, False))):
            bodies.append(lambda mode=mode, key=key: (
                eng._modes.fill_(MODE_IDS[mode]), eng._fused_body(*key)))
    torch.cuda.synchronize()
    for body in bodies:
        torch.cuda.set_sync_debug_mode("error")
        try:
            body()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_split_counters_keep_their_address(cuda, models):
    """The K1/K3 merge counters are reserved when the engine is built and
    do not move across a generate that captured graphs (a Refresh runs
    K3 and split K1), and they are zero after it."""
    import numpy as np
    model = _get_model(models, "llama3.1-8b")
    prompt_len, new = GRAPH_CASES["llama3.1-8b"]
    eng = _engine(model, prompt_len, new)
    c = tops._COUNTERS[model[3]["embed"].device]
    ptr = c.data_ptr()
    prompt = np.random.default_rng(2).integers(
        0, model[0].vocab_size, (1, prompt_len)).astype(np.int64)
    _, stats = eng.generate(prompt, 12)
    torch.cuda.synchronize()
    assert stats["modes"].get("refresh") and (True, False, True) in eng._graphs
    c2 = tops._COUNTERS[c.device]
    assert c2 is c and c2.data_ptr() == ptr
    assert not bool(c.any())


# ---------------------------------------------------------------------------
# continuous-batching serving: masked rows in the graph step
# ---------------------------------------------------------------------------

# 2-layer llama at full width, batch 3: one request under the partial
# budget, two over it, a fourth that waits for a slot (pages for all)
SERVE_CASE = ((2000, 20), (4700, 24), (5000, 16), (600, 24))
SERVE_MAX_LEN = 5376


def _serve(model, graphs, prefill_budget=None):
    import numpy as np
    from repro_torch.serving import Request, ServingConfig, ServingEngine
    cfg, spec, dcfg, params, dparams = model
    rng = np.random.default_rng(5)
    srv = ServingEngine(cfg, spec, dcfg, params, dparams,
                        ServingConfig(batch=3, max_len=SERVE_MAX_LEN,
                                      prefill_budget=prefill_budget),
                        device="cuda", cuda_graphs=graphs)
    for i, (n, new) in enumerate(SERVE_CASE):
        srv.submit(Request(request_id=f"r{i}", max_new_tokens=new,
                           prompt=rng.integers(0, cfg.vocab_size, (n,))))
    tops.reset_launch_counts()
    srv.run()
    torch.cuda.synchronize()
    return srv, tops.launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("prefill_budget", [None, 512])
def test_cuda_serving_graphs_equal_eager(cuda, models, prefill_budget):
    """The same trace served with graphs and eagerly: equal tokens per
    request, launch counts and final static state, the K/V pools included
    (page 0 left out: null-page writes land in no fixed order); one graph
    per step variant that ran and one for the slot prefill chunk."""
    import numpy as np
    model = _get_model(models, "llama3.1-8b")
    (eager, ec), (graph, gc) = (_serve(model, g, prefill_budget)
                                for g in (False, True))
    for rid, o in eager.outputs.items():
        assert np.array_equal(graph.outputs[rid].tokens, o.tokens), rid
        assert len(o.tokens) == dict(
            (f"r{i}", new) for i, (_, new) in enumerate(SERVE_CASE))[rid]
    assert gc == ec and all(ec[0][k] > 0 for k in (
        "sparse_verify_attention", "paged_prefill_attention",
        "retrieval_score", "block_summary"))
    for k in ("mode_rows_full", "mode_rows_refresh", "mode_rows_partial"):
        assert graph.stats[k] == eager.stats[k] > 0, k
    ge = graph._continuous.engine
    ee = eager._continuous.engine
    assert set(ge._graphs) == set(ge.dispatch_keys) | {("slot_prefill", 256)}
    for f in dataclasses.fields(ge.state):
        g, e = getattr(ge.state, f.name), getattr(ee.state, f.name)
        for k in (g if isinstance(g, dict) else [None]):
            a, b = (g, e) if k is None else (g[k], e[k])
            if k in ("k", "v"):
                a, b = a[..., 1:, :, :, :], b[..., 1:, :, :, :]
            assert torch.equal(a, b), (f.name, k)
    assert ge.page_stats()["in_use"] == 0


def _row_snapshot(eng, row):
    """Row ``row``'s fields and the pool contents it owns (trunk pages over
    [0, length) in every layer with their summaries, draft pages over
    [0, draft length))."""
    st = eng.state
    bs = eng.spec.block_size
    snap = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, dict):
            for k in ("page_table", "length"):
                snap[f"{f.name}.{k}"] = v[k][row].clone()
        elif f.name in ("pkv_k", "pkv_v", "pkv_pos"):
            snap[f.name] = v[:, row].clone()
        else:
            snap[f.name] = v[row].clone()
    for name, c in (("cache", st.cache), ("dcache", st.dcache)):
        n = int(c["length"][row])
        pages = c["page_table"][row, : -(-n // bs)].long()
        kk = c["k"][:, pages] if name == "cache" else c["k"][pages]
        vv = c["v"][:, pages] if name == "cache" else c["v"][pages]
        flat = kk.shape[:-4] + (-1,) + kk.shape[-2:]
        snap[f"{name}.k"] = kk.reshape(flat)[..., :n, :, :].clone()
        snap[f"{name}.v"] = vv.reshape(flat)[..., :n, :, :].clone()
        if name == "cache":
            snap["kmax"] = c["kmax"][:, pages].clone()
            snap["kmin"] = c["kmin"][:, pages].clone()
    return snap


@pytest.mark.cuda
def test_cuda_masked_step_keeps_untouched_rows(cuda, models):
    """Slot 0 over the partial budget (Refresh, then Partial), slot 1 under
    it (Full), slot 2 empty; graph steps of one live row at a time: the
    other live row and the empty slot keep every bit."""
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine
    cfg, spec, dcfg, params, dparams = _get_model(models, "llama3.1-8b")
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=3,
                       max_len=SERVE_MAX_LEN, device="cuda")
    rng = np.random.default_rng(6)
    st = eng.empty_state()
    st, _ = eng.prefill_into_slot(
        st, 0, rng.integers(0, cfg.vocab_size, (4700,)), max_new_tokens=40)
    st, _ = eng.prefill_into_slot(
        st, 1, rng.integers(0, cfg.vocab_size, (2000,)), max_new_tokens=40)
    live = np.array([True, True, False])
    seen = set()
    for rows in ([1, 0, 0], [0, 1, 0], [1, 0, 0], [1, 0, 0], [0, 1, 0],
                 [1, 1, 0]):
        rows = np.asarray(rows, bool)
        modes = eng.modes_for_rows(st, live)
        before = {r: _row_snapshot(eng, r) for r in range(3) if not rows[r]}
        st, so = eng.step_fused(st, rows, modes)
        seen.add(tuple(int(m) for m in modes[rows]))
        for r, snap in before.items():
            after = _row_snapshot(eng, r)
            for k in snap:
                assert torch.equal(after[k], snap[k]), (rows, r, k)
    assert {(1,), (2,), (0,)} <= seen
    assert eng._graphs                      # the steps replayed graphs


@pytest.mark.cuda
def test_cuda_serving_bodies_do_not_sync(cuda, models):
    """The slot prefill chunk's body and each step variant's body with the
    row mask [1, 1, 0] run eagerly under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import numpy as np
    from repro_torch.core.engine import MODE_IDS, SpecPVEngine
    cfg, spec, dcfg, params, dparams = _get_model(models, "llama3.1-8b")
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=3,
                       max_len=SERVE_MAX_LEN, device="cuda",
                       cuda_graphs=False)
    rng = np.random.default_rng(7)
    st = eng.empty_state()
    for slot, n in ((0, 4700), (1, 2000)):
        st, _ = eng.prefill_into_slot(
            st, slot, rng.integers(0, cfg.vocab_size, (n,)),
            max_new_tokens=16)
    toks = eng._chunk_buf(1, 256)
    cache = dict(eng._slot_cache, **{n: st.cache[n]
                                     for n in ("k", "v", "kmax", "kmin")})
    dcache = dict(eng._slot_dcache, k=st.dcache["k"], v=st.dcache["v"])
    runs = [(None, lambda: eng._prefill_body(
        toks, cache, dcache, eng._slot_prev_feat, eng._slot_logits))]
    for modes, key in ((["full"] * 2, (True, False, False)),
                       (["refresh"] * 2, (True, False, True)),
                       (["partial"] * 2, (False, True, False)),
                       (["partial", "refresh"], (True, True, True))):
        ops_in = torch.tensor([[MODE_IDS[m] for m in modes] + [0],
                               [1, 1, 0]], dtype=torch.int8, device=cuda)
        runs.append((ops_in, lambda key=key: eng._fused_body(*key)))
    for ops_in, body in runs:
        if ops_in is not None:
            eng._tick_in.copy_(ops_in)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            body()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
