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


# host calls that launch one kernel each (the profiler's runtime records)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def _session(fn):
    """``fn`` under torch.profiler, synchronised: (its result, the device
    kernel records, the host launch calls).  Copies and sets are left out
    of the kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e.name for e in events
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    return out, kernels, sum(1 for e in events if e.name in LAUNCH_CALLS)


def _kernel_launches(fn, tries: int = 3):
    """Device kernels launched by one call of ``fn``, after one warm call:
    the kernel records of a profiled call.  The profiler loses a kernel's
    record now and then although it saw the launch on the host (about 1
    in 400 one-call sessions, ``tools/profiler_records.py``); a session
    holding fewer kernel records than host launch calls is therefore
    incomplete and runs again, at most ``tries`` times, its call's counts
    taken back out of ``ops.LAUNCHES``, so the counts stay those of the
    warm call and the kept one."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        saved = tops.launch_counts()
        out, kernels, calls = _session(fn)
        if len(kernels) >= calls:
            break
        tops.set_launch_counts(saved)
    return out, len(kernels)


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
                        zero_copy=cfg.arch_type == "dense", device="cuda",
                        **kw)


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
        # greedy tree steps: no sampled or chain rows
        keys = {(True, False, False, False, False),
                (True, False, True, False, False),
                (False, True, False, False, False)}
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
    assert stats["modes"].get("refresh") and \
        (True, False, True, False, False) in eng._graphs
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
                                      prefill_budget=prefill_budget,
                                      paged_kv=True, zero_copy_partial=True,
                                      prefix_cache=False),
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
    per step variant that ran and one per row count of the full-width
    slot prefill chunks (interleaved: fused rounds of several rows)."""
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
    assert set(ge._graphs) == set(ge.dispatch_keys) | _prefill_graphs(ge)
    if prefill_budget:
        assert max(k for k, _ in ge.prefill_keys) > 1
    for f in dataclasses.fields(ge.state):
        g, e = getattr(ge.state, f.name), getattr(ee.state, f.name)
        for k in (g if isinstance(g, dict) else [None]):
            a, b = (g, e) if k is None else (g[k], e[k])
            if k in ("k", "v"):
                a, b = a[..., 1:, :, :, :], b[..., 1:, :, :, :]
            assert torch.equal(a, b), (f.name, k)
    assert ge.page_stats()["in_use"] == 0


def _prefill_graphs(eng, chunk=256):
    """The graph keys of the slot prefill chunks that ran at full width."""
    return {("fused_prefill", k, t) for k, t in eng.prefill_keys
            if t == chunk}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged-zero-copy", "contiguous"])
def test_cuda_data_parallel_serving_equals_unsharded(cuda, models, layout):
    """Two data shards on ``cuda:0`` (a (2, 1) mesh), llama3.1-8b at full
    width and 2 layers in fp32, with graphs: every request's tokens equal
    the unsharded engine's; each shard's launches are what its own steps
    and chunks imply, and each shard captured one graph per variant it
    ran; the weights are one copy."""
    import numpy as np
    from repro_torch.configs import DraftConfig, SpecPVConfig, get_config
    from repro_torch.core.data_parallel import DataParallelEngine
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.models.api import init_params
    from repro_torch.serving import ContinuousScheduler, Request
    models.clear()
    torch.cuda.empty_cache()
    cfg = get_config("llama3.1-8b").replace(num_layers=2, dtype="float32",
                                            param_dtype="float32")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper",
                        reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=0, device=cuda)
    dparams = init_draft_params(cfg, dcfg, seed=1, device=cuda)
    kw = (dict(paged=True, zero_copy=True) if layout == "paged-zero-copy"
          else {})
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n, _ in SERVE_CASE]
    toks, engines = {}, {}
    for mesh in (None, make_mesh((2, 1), devices=["cuda:0"] * 2)):
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=4,
                           max_len=SERVE_MAX_LEN, mesh=mesh, device="cuda",
                           **kw)
        sched = ContinuousScheduler(eng, prefill_chunk=256)
        for i, ((_, new), p) in enumerate(zip(SERVE_CASE, prompts)):
            sched.submit(Request(request_id=f"r{i}", prompt=p,
                                 max_new_tokens=new))
        tops.reset_launch_counts()
        if mesh is not None:
            eng.shard_launches = [{} for _ in eng.shards]
        sched.run()
        torch.cuda.synchronize()
        toks[mesh is None] = {k: o.tokens for k, o in sched.outputs.items()}
        engines[mesh is None] = (eng, dict(tops.LAUNCHES))
    for rid, t in toks[True].items():
        assert np.array_equal(toks[False][rid], t), rid
    eng, launches = engines[False]
    assert isinstance(eng, DataParallelEngine) and eng.data_shards == 2
    total = {}
    for s, sub in enumerate(eng.shards):
        assert sub.params["embed"] is params["embed"]
        want = {"sparse_verify_attention": 0, "paged_prefill_attention": 0,
                "retrieval_score": 0, "block_summary": 0}
        for key, n in sub.dispatch_keys.items():
            has_full, has_partial, has_refresh = key[:3]
            want["sparse_verify_attention"] += 2 * n * (has_full
                                                        + has_partial)
            want["retrieval_score"] += 2 * n * has_refresh
            want["block_summary"] += n * has_full
        want["paged_prefill_attention"] = 2 * sub.prefill_dispatches
        want["block_summary"] += sub.prefill_dispatches
        assert {k: eng.shard_launches[s].get(k, 0) for k in want} == want
        assert set(sub._graphs) == set(sub.dispatch_keys) | \
            _prefill_graphs(sub)
        for k, n in want.items():
            total[k] = total.get(k, 0) + n
    assert {k: launches[k] for k in total} == total
    assert total["retrieval_score"] > 0


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
        elif f.name in ("pkv_k", "pkv_v", "pkv_pos", "pkv_body_k",
                        "pkv_body_v"):          # [L, B, ...]
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
                       max_len=SERVE_MAX_LEN, paged=True, zero_copy=True,
                       device="cuda", prefix_cache=False)
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
    """A fused slot prefill round of two cursors (one mid-prompt, one at a
    short last chunk) and each step variant's body with the row mask
    [1, 1, 0] run eagerly under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import numpy as np
    from repro_torch.core.engine import MODE_IDS, SpecPVEngine
    cfg, spec, dcfg, params, dparams = _get_model(models, "llama3.1-8b")
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=3,
                       max_len=SERVE_MAX_LEN, paged=True, zero_copy=True,
                       device="cuda", cuda_graphs=False, prefix_cache=False)
    rng = np.random.default_rng(7)
    st = eng.empty_state()
    curs = []
    for slot, n in ((0, 4700), (1, 2000)):
        st, c = eng.prefill_begin_slot(
            st, slot, rng.integers(0, cfg.vocab_size, (n,)),
            max_new_tokens=16)
        curs.append(c)
    while curs[1].next_tokens == 256:       # to 2000's 208-token last chunk
        st, _ = eng.prefill_step_into_slot(st, curs[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:                    # staging, the ragged body, the copies out
        st, n = eng.prefill_step_fused(st, curs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert n == 256 + 208 and curs[1].done
    while not curs[0].done:
        st, _ = eng.prefill_step_into_slot(st, curs[0])
    for c in curs:
        st, _ = eng.prefill_finalize_slot(st, c)
    runs = []
    for modes, key in ((["full"] * 2, (True, False, False)),
                       (["refresh"] * 2, (True, False, True)),
                       (["partial"] * 2, (False, True, False)),
                       (["partial", "refresh"], (True, True, True))):
        ops_in = torch.tensor([[MODE_IDS[m] for m in modes] + [0],
                               [1, 1, 0]], dtype=torch.int8, device=cuda)
        runs.append((ops_in, lambda key=key: eng._fused_body(*key)))
    for ops_in, body in runs:
        if ops_in is not None:      # modes and rows; no chain row
            eng._tick_in[:2].copy_(ops_in)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            body()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# copy-on-write prefix sharing
# ---------------------------------------------------------------------------

def _shared_table(dev, npg, nb, shared, seed):
    """Two rows' page tables whose first `shared` entries are the same
    pages (a prefix attached from the cache)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    perm = (torch.randperm(npg - 1, generator=g, device=dev) + 1).to(
        torch.int32)
    table = torch.stack([perm[:nb], perm[nb: 2 * nb]])
    table[1, :shared] = table[0, :shared]
    return table.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t, qoffs", [(256, (6400, 6144)),
                                      (128, (6272, 6272))])
def test_cuda_prefill_over_shared_pages_matches_plain(cuda, dtype, t, qoffs):
    """K2 over page tables whose leading 48 entries both rows hold: the
    tail prefill after an attach, and the short chunk after a match that
    ends inside a chunk."""
    nb, bs = 52, 128
    q, pk, pv, _, _ = _cuda_case(cuda, TDT[dtype], t=t, seed=3,
                                 npg=2 * nb + 1)
    hk, dh = pk.shape[2:]
    table = _shared_table(cuda, pk.shape[0], nb, 48, seed=4)
    qoff = torch.tensor(qoffs, dtype=torch.int32, device=cuda)
    idx, vlen = tops._page_walk(table, qoff + t, pk.shape)
    kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
    before = tops.LAUNCHES["paged_prefill_attention"]
    got = tops.block_attention(q, kf, vf, idx, vlen, bs, q_offset=qoff)
    assert tops.LAUNCHES["paged_prefill_attention"] == before + 1
    want = tref.block_attention_batched(q, kf, vf, idx, vlen, bs,
                                        q_offset=qoff)
    _assert_partials_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_routed_over_shared_pages_matches_plain(cuda, dtype):
    """K1 routed (Partial) over pages two rows both select."""
    nb, bs, ns = 52, 128, 35
    q, pk, pv, _, _ = _cuda_case(cuda, TDT[dtype], t=61, seed=5,
                                 npg=2 * nb + 1)
    hk, dh = pk.shape[2:]
    table = _shared_table(cuda, pk.shape[0], nb, 48, seed=6)
    g = torch.Generator(device=cuda)
    g.manual_seed(7)
    sel = torch.stack([torch.stack([torch.randperm(51, generator=g,
                                                   device=cuda)[:ns]
                                    for _ in range(hk)]) for _ in range(2)])
    sel[..., -3:] = -1
    sel[..., 30] = 51
    used = sel >= 0
    rows = torch.arange(2, device=cuda)[:, None, None]
    idx = torch.where(used, table[rows, sel.clamp(min=0)], 0).to(
        torch.int32).contiguous()
    vlen = torch.where(used, (6644 - sel * bs).clamp(0, bs), 0).to(
        torch.int32).contiguous()
    assert bool(((idx[0][..., None] == idx[1][..., None, :])
                 & (idx[0] > 0)[..., None]).any())
    kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
    before = tops.LAUNCHES["sparse_verify_attention"]
    got = tops.block_attention(q, kf, vf, idx, vlen, bs)
    assert tops.LAUNCHES["sparse_verify_attention"] == before + 1
    _assert_partials_close(got, tref.block_attention_batched(
        q, kf, vf, idx, vlen, bs))


def _forked_engine(models, **kw):
    """A 2-layer full-width llama engine (batch 2, prefix sharing on) with
    one request over the partial budget admitted into slot 0, stepped
    twice and forked into slot 1."""
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine
    cfg, spec, dcfg, params, dparams = _get_model(models, "llama3.1-8b")
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=2,
                       max_len=SERVE_MAX_LEN, paged=True, zero_copy=True,
                       device="cuda", **kw)
    st = eng.empty_state()
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (4700,))
    st, _ = eng.prefill_into_slot(st, 0, prompt, max_new_tokens=24)
    rows = np.array([True, False])
    for _ in range(2):
        st, _ = eng.step_fused(st, rows, eng.modes_for_rows(st, rows))
    return eng, eng.fork_slot(st, 0, 1)


@pytest.mark.cuda
def test_cuda_prepare_cow_and_page_copy_bit_exact(cuda, models):
    """``prepare_cow`` of both forked rows and ``_copy_pool_page`` leave
    the pools equal, bit for bit, to a plain per-page copy of the pages
    they move (every pool key, the summaries included) and every other
    page as it was."""
    import numpy as np
    eng, st = _forked_engine(models, cuda_graphs=False)
    keys = {"cache": ("k", "v", "kmax", "kmin"), "dcache": ("k", "v")}

    def pools():
        return {(c, k): getattr(st, c)[k].clone()
                for c, ks in keys.items() for k in ks}
    before = pools()
    tables = {c: getattr(st, c)["page_table"].clone() for c in keys}
    eng.prepare_cow(st, np.array([True, True]))
    moved = 0
    for c, ks in keys.items():
        pt = getattr(st, c)["page_table"]
        where = (pt != tables[c]).nonzero().tolist()
        moved += len(where)
        for k in ks:
            want = before[(c, k)].clone()
            for r, j in where:
                new, old = int(pt[r, j]), int(tables[c][r, j])
                if c == "cache":
                    want[:, new] = before[(c, k)][:, old]
                else:
                    want[new] = before[(c, k)][old]
            assert torch.equal(getattr(st, c)[k], want), (c, k)
    assert eng.cow_copies["trunk"] > 0 and eng.cow_copies["draft"] > 0
    assert moved >= 2
    before = pools()
    eng._copy_pool_page(st.cache, 5, 9, draft=False)
    eng._copy_pool_page(st.dcache, 4, 8, draft=True)
    for (c, k), a in before.items():
        if c == "cache":
            a[:, 9] = a[:, 5]
        else:
            a[8] = a[4]
        assert torch.equal(getattr(st, c)[k], a), (c, k)


@pytest.mark.cuda
def test_cuda_prefix_host_paths_do_not_sync(cuda, models):
    """Block registration (``_register_blocks``: clones of the boundary
    features, a dedupe's page-table writes) and a copying ``prepare_cow``
    run under ``torch.cuda.set_sync_debug_mode("error")``; with no forked
    row ``prepare_cow`` launches nothing."""
    import numpy as np
    eng, _ = _forked_engine(models, cuda_graphs=False)
    prompt = np.random.default_rng(8).integers(0, eng.cfg.vocab_size,
                                               (4700,))
    # two cursors of one prompt, admitted before either registered: the
    # second one's first chunk dedups both of its blocks
    st = eng.empty_state()
    st, cur_a = eng.prefill_begin_slot(st, 0, prompt, max_new_tokens=8)
    st, cur_b = eng.prefill_begin_slot(st, 1, prompt, max_new_tokens=8)
    st, _ = eng.prefill_step_into_slot(st, cur_a)
    register = eng._register_blocks
    eng._register_blocks = lambda *a: None      # run it below, checked
    st, _ = eng.prefill_step_into_slot(st, cur_b)
    del eng._register_blocks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        register(cur_b, 0, 256, eng._pf_block_feats[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eng.prefix_stats()["dedups"] == 2
    assert int(cur_b.row_cache["page_table"][0, 0]) == int(cur_a.pt_host[0])
    # a copying prepare_cow, then one with no forked row
    eng2, st2 = _forked_engine(models, cuda_graphs=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng2.prepare_cow(st2, np.array([True, True]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eng2.cow_copies["trunk"] > 0
    for slot in (0, 1):
        eng2.release_slot_pages(slot)
    copies = dict(eng2.cow_copies)

    def no_device(a):
        raise AssertionError("prepare_cow moved indices to the card")
    eng2._to_device = no_device     # every copy starts with this move
    assert eng2.prepare_cow(st2, np.array([True, True])) is st2
    assert eng2.cow_copies == copies



# ---------------------------------------------------------------------------
# the reference's default engine: the contiguous cache and gathered body
# ---------------------------------------------------------------------------

def _contiguous_kv(dev, dtype, layers, b, max_len, seed, hk=8, dh=128,
                   bs=128):
    """A filled contiguous cache [L, B, max_len, Hk, Dh] over
    block-rounded rows (the rows past max_len stay 0)."""
    from repro_torch.kvcache.cache import init_contiguous_kv
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    k, v = init_contiguous_kv(layers, b, max_len, bs, hk, dh, dtype, dev)
    for a in (k, v):
        a.copy_(torch.randn(a.shape, generator=g, device=dev).to(dtype))
    return k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 61, 156])
def test_cuda_contiguous_verify_attention_matches_plain(cuda, dtype, t):
    """K1 over a contiguous cache through the identity list (a max_len of
    2000, not a multiple of the block; rows of 1999 and 700 tokens)
    against the plain version of the same launch."""
    k, v = _contiguous_kv(cuda, TDT[dtype], 1, 2, 2000, seed=20)
    k, v = k[0], v[0]
    g = torch.Generator(device=cuda)
    g.manual_seed(21)
    q = torch.randn((2, t, 32, 128), generator=g, device=cuda).to(TDT[dtype])
    length = torch.tensor([1999, 700], dtype=torch.int32, device=cuda)
    got = tops.contiguous_verify_attention(q, k, v, length, 128)
    kf, rows = tops.flat_blocks(k)
    vf, _ = tops.flat_blocks(v)
    idx, vlen = tops._identity_walk(2, 8, rows // 128, length, 2000, 128)
    want = tref.block_attention_batched(q, kf, vf, idx, vlen, 128)
    torch.cuda.synchronize()
    _assert_partials_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_gathered_body_attention_matches_plain(cuda, dtype):
    """K1 over the gathered body (token-major [B, NS*bs, Hk, Dh], block
    ids b*NS + j, unused slots at valid length 0) against its plain
    version, and bit-equal to the routed read of the same blocks."""
    from repro_torch.configs import SpecPVConfig
    from repro_torch.models import dense as dn
    dt = TDT[dtype]
    g = torch.Generator(device=cuda)
    g.manual_seed(22)
    b, hk, dh, bs, ns, npg = 2, 8, 128, 128, 7, 20
    pool_k = torch.randn((npg, bs, hk, dh), generator=g, device=cuda).to(dt)
    pool_v = torch.randn((npg, bs, hk, dh), generator=g, device=cuda).to(dt)
    table = (torch.randperm(npg - 1, generator=g, device=cuda)[: 2 * 9] + 1
             ).to(torch.int32).reshape(2, 9)
    pbi = torch.stack([torch.stack([torch.randperm(9, generator=g,
                                                   device=cuda)[:ns]
                                    for _ in range(hk)])
                       for _ in range(b)]).to(torch.int32)
    pbi[..., -2:] = -1
    length = torch.tensor([9 * bs - 50, 9 * bs], dtype=torch.int32,
                          device=cuda)
    spec = SpecPVConfig(block_size=bs)
    body_k, body_v = dn.gather_partial_body(spec, pbi[None], pool_k[None],
                                            pool_v[None], table)
    q = torch.randn((b, 61, 32, dh), generator=g, device=cuda).to(dt)
    bufk = torch.zeros((b, hk, 4, dh), device=cuda, dtype=dt)
    bufpos = torch.full((b, hk, 4), -1, dtype=torch.int32, device=cuda)
    gathered = dn._partial_context(q, None, None, pbi, length,
                                   (bufk, bufk, bufpos, body_k[0],
                                    body_v[0]), bs)
    routed = dn._partial_context(q, (pool_k, pool_v), table, pbi, length,
                                 (bufk, bufk, bufpos), bs)
    idx = (torch.arange(b, device=cuda)[:, None, None] * ns
           + torch.arange(ns, device=cuda)).expand(b, hk, ns)
    vlen = dn._selected_vlen(pbi, length, bs)
    got = tops.routed_partial_attention(
        q, body_k[0].reshape(b * ns, bs, hk, dh),
        body_v[0].reshape(b * ns, bs, hk, dh), idx, vlen)
    want = tref.block_attention_batched(
        q, body_k[0].reshape(-1, hk, dh), body_v[0].reshape(-1, hk, dh),
        idx.to(torch.int32), vlen.to(torch.int32), bs)
    torch.cuda.synchronize()
    _assert_partials_close(got, want)
    for a, c in zip(gathered, routed):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qoff", [0, 700, 1536])
def test_cuda_contiguous_prefill_matches_plain(cuda, dtype, qoff):
    """K2 over a contiguous cache (max_len 2000): the wrapper's output is
    its launch's normalised partials, which match the plain version."""
    dt = TDT[dtype]
    k, v = _contiguous_kv(cuda, dt, 1, 1, 2000, seed=23)
    k, v = k[0], v[0]
    g = torch.Generator(device=cuda)
    g.manual_seed(24)
    t = 256
    q = torch.randn((1, t, 32, 128), generator=g, device=cuda).to(dt)
    length = torch.tensor([qoff], dtype=torch.int32, device=cuda)
    tv = torch.tensor([t], dtype=torch.int32, device=cuda)
    out = tops.contiguous_prefill_attention(q, k, v, length, tv, 128)
    kf, rows = tops.flat_blocks(k)
    vf, _ = tops.flat_blocks(v)
    idx, vlen = tops._identity_walk(1, 8, rows // 128, length + tv, 2000,
                                    128)
    got = tops.block_attention(q, kf, vf, idx, vlen, 128, q_offset=length)
    want = tref.block_attention_batched(q, kf, vf, idx, vlen, 128,
                                        q_offset=length)
    torch.cuda.synchronize()
    _assert_partials_close(got, want)
    assert torch.equal(out, (got[2] / got[1].clamp(min=1e-30)[..., None])
                       .transpose(1, 2).to(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start, end, n_touch", [
    (1536, 1792, 3), (1700, 1801, 2), (1990, 2010, 2)],
    ids=["prefill", "commit", "past_max_len"])
def test_cuda_contiguous_block_summaries_bit_exact(cuda, dtype, start, end,
                                                   n_touch):
    """K4's all-layer contiguous form (one launch, 4 layers x 2 rows of a
    max_len-2000 cache) against the plain per-layer recomputation, bit
    for bit; blocks outside [start, end) keep their values."""
    from repro_torch.kvcache.cache import update_layer_summaries
    layers, b, bs = 4, 2, 128
    k, _ = _contiguous_kv(cuda, TDT[dtype], layers, b, 2000, seed=25)
    nb = -(-2000 // bs)
    g = torch.Generator(device=cuda)
    g.manual_seed(26)
    old = torch.randn((2, layers, b, nb, 8, 128), generator=g, device=cuda)
    st = torch.tensor([start, start - 300], dtype=torch.int32, device=cuda)
    en = torch.tensor([end, end - 300], dtype=torch.int32, device=cuda)
    got = old.clone()
    tops.reset_launch_counts()
    tops.contiguous_block_summaries(k, st, en, n_touch, got[0], got[1], bs)
    assert tops.LAUNCHES["block_summary"] == 1
    for i in range(layers):
        wx, wn = update_layer_summaries(old[0, i], old[1, i], k[i], st, en,
                                        bs)
        assert torch.equal(got[0, i], wx) and torch.equal(got[1, i], wn)


def _layout_engine(model, prompt_len, new, layout, **kw):
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    cfg, spec, dcfg, params, dparams = model
    max_len = request_token_need(prompt_len, new, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    return SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=max_len, device="cuda", **layout, **kw)


@pytest.mark.cuda
def test_cuda_contiguous_prefill_equals_paged(cuda, models):
    """2-layer full-width llama: after the same prefill the contiguous
    engine's K/V and summaries equal the paged engine's read through the
    page table, bit for bit (the same K2 and K4 work on the same
    bytes)."""
    import numpy as np
    model = _get_model(models, "llama3.1-8b")
    prompt_len, new = GRAPH_CASES["llama3.1-8b"]
    prompt = np.random.default_rng(2).integers(
        0, model[0].vocab_size, (1, prompt_len)).astype(np.int64)
    con = _layout_engine(model, prompt_len, new, dict(paged=False))
    pag = _layout_engine(model, prompt_len, new,
                         dict(paged=True, zero_copy=True))
    sc, sp = con.prefill(prompt), pag.prefill(prompt)
    torch.cuda.synchronize()
    pt = sp.cache["page_table"][0].long()
    n = prompt_len
    nb = -(-n // 128)
    for name in ("k", "v"):
        view = sp.cache[name][:, pt].flatten(1, 2)[:, :n]
        assert torch.equal(sc.cache[name][:, 0, :n], view), name
    for name in ("kmax", "kmin"):
        assert torch.equal(sc.cache[name][:, 0, :nb],
                           sp.cache[name][:, pt[:nb]]), name


@pytest.mark.cuda
def test_cuda_contiguous_graph_generate_equals_eager(cuda, models):
    """The contiguous gathered engine: graph ``generate`` equals eager
    token for token with the same launch counts, one graph per variant
    and the prefill chunk."""
    import numpy as np
    model = _get_model(models, "llama3.1-8b")
    prompt_len, new = GRAPH_CASES["llama3.1-8b"]
    prompt = np.random.default_rng(3).integers(
        0, model[0].vocab_size, (1, prompt_len)).astype(np.int64)
    runs = []
    for graphs in (False, True):
        eng = _layout_engine(model, prompt_len, new, dict(paged=False),
                             cuda_graphs=graphs)
        tops.reset_launch_counts()
        toks, stats = eng.generate(prompt, new)
        torch.cuda.synchronize()
        runs.append((eng, toks, stats, tops.launch_counts()))
    (_, et, es, ec), (graph, gt, gs, gc) = runs
    assert np.array_equal(gt, et) and gs["modes"] == es["modes"]
    assert gc == ec and set(gs["modes"]) == {"full", "refresh", "partial"}
    assert set(graph._graphs) == {("prefill", 256),
                                  (True, False, False, False, False),
                                  (True, False, True, False, False),
                                  (False, True, False, False, False)}
    assert all(ec[0][k] > 0 for k in ("sparse_verify_attention",
                                      "paged_prefill_attention",
                                      "retrieval_score", "block_summary"))


@pytest.mark.cuda
def test_cuda_contiguous_step_bodies_do_not_sync(cuda, models):
    """The contiguous gathered engine's prefill chunk, each step variant
    and a contiguous slot-prefill chunk over the prefill carry (staging
    included) run eagerly under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import numpy as np
    from repro_torch.core.engine import MODE_IDS
    model = _get_model(models, "llama3.1-8b")
    prompt_len, new = GRAPH_CASES["llama3.1-8b"]
    eng = _layout_engine(model, prompt_len, new, dict(paged=False),
                         cuda_graphs=False)
    prompt = np.random.default_rng(4).integers(
        0, model[0].vocab_size, (1, prompt_len)).astype(np.int64)
    st = eng.prefill(prompt)
    toks = torch.zeros((1, 256), dtype=torch.long, device=cuda)
    bodies = [lambda: eng._prefill_body(toks, st.cache, st.dcache,
                                        eng._prev_feat, eng._logits_last)]
    eng._rows.fill_(True)
    for mode, key in (("full", (True, False, False)),
                      ("refresh", (True, False, True)),
                      ("partial", (False, True, False))):
        bodies.append(lambda mode=mode, key=key: (
            eng._modes.fill_(MODE_IDS[mode]), eng._fused_body(*key)))
    _, cur = eng.prefill_begin_slot(eng.state, 0, prompt[0, :300])
    bodies.append(lambda: eng.prefill_step_fused(eng.state, [cur]))
    torch.cuda.synchronize()
    for body in bodies:
        torch.cuda.set_sync_debug_mode("error")
        try:
            body()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the fused multi-row prefill: ragged K-row chunks
# ---------------------------------------------------------------------------

def _ragged_rows(dev, dtype, seed, *, nb=66, bs=128, hk=8, dh=128, h=32,
                 t=256, layers=1, carry=False):
    """Four prefill rows of one ragged [4, 256] chunk at llama widths:
    (length, t_valid) = (7936, 256), (48, 16), (0, 200), (4000, 1).  The
    pool is the contiguous prefill carry (row s's block j is page
    1 + s*nb + j after the null page) or random pages of a shared pool."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    b = 4
    npg = b * nb + 1
    q = torch.randn((b, t, h, dh), generator=g, device=dev).to(dtype)
    pk = torch.randn((layers, npg, bs, hk, dh), generator=g,
                     device=dev).to(dtype)
    pv = torch.randn((layers, npg, bs, hk, dh), generator=g,
                     device=dev).to(dtype)
    if carry:
        pt = 1 + torch.arange(b * nb, device=dev).view(b, nb)
    else:
        pt = torch.randperm(npg - 1, generator=g, device=dev)[: b * nb]
        pt = (pt + 1).view(b, nb)
    length = torch.tensor([7936, 48, 0, 4000], dtype=torch.int32,
                          device=dev)
    t_valid = torch.tensor([256, 16, 200, 1], dtype=torch.int32, device=dev)
    return q, pk, pv, pt.to(torch.int32).contiguous(), length, t_valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carry", [False, True], ids=["pool", "carry"])
def test_cuda_ragged_prefill_rows_match_plain(cuda, dtype, carry):
    """K2's ragged K-row form (``ops.paged_prefill_attention`` with
    t_valid < T, as a fused round calls it): one launch whose output is
    its partials normalised, and those partials (each row's causal
    attention over its own blocks, ending at length + t_valid) against
    the plain version."""
    q, pk, pv, pt, length, t_valid = _ragged_rows(cuda, TDT[dtype], 11,
                                                  carry=carry)
    before = tops.LAUNCHES["paged_prefill_attention"]
    got = tops.paged_prefill_attention(q, pk[0], pv[0], pt, length, t_valid)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["paged_prefill_attention"] == before + 1
    idx, vlen = tops._page_walk(pt, length + t_valid, pk[0].shape)
    kf, vf = tops._flat_pool(pk[0]), tops._flat_pool(pv[0])
    parts = tops.block_attention(q, kf, vf, idx, vlen, 128, q_offset=length)
    m, l, acc = parts
    assert torch.equal(got, (acc / torch.clamp(l, min=1e-30)[..., None])
                       .transpose(1, 2).to(q.dtype))
    _assert_partials_close(parts, tref.block_attention_batched(
        q, kf, vf, idx, vlen, 128, q_offset=length))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carry", [False, True], ids=["pool", "carry"])
def test_cuda_ragged_block_summaries_bit_exact(cuda, dtype, carry):
    """K4 over all 32 layers with per-row ends length + t_valid (a fused
    round's one launch) against its plain version bit for bit; page 0
    stays 0 and pages outside the rows' touched blocks keep their
    bytes."""
    _, pk, _, pt, length, t_valid = _ragged_rows(cuda, TDT[dtype], 12,
                                                 layers=32, carry=carry)
    g = torch.Generator(device=cuda)
    g.manual_seed(13)
    layers, npg, _, hk, dh = pk.shape
    init = torch.rand((2, layers, npg, hk, dh), generator=g, device=cuda)
    init[:, :, 0] = 0.0
    got, want = init.clone(), init.clone()
    before = tops.LAUNCHES["block_summary"]
    tops.paged_block_summaries(pk, pt, length, length + t_valid, 3, got[0],
                               got[1])
    torch.cuda.synchronize()
    assert tops.LAUNCHES["block_summary"] == before + 1
    tref.paged_block_summaries(pk, pt, length, length + t_valid, 3, want[0],
                               want[1])
    assert torch.equal(got, want)
    assert float(got[:, :, 0].abs().max()) == 0.0
    touched = torch.zeros(npg, dtype=torch.bool, device=cuda)
    for r in range(4):
        lo = int(length[r]) // 128
        hi = -(-int(length[r] + t_valid[r]) // 128)
        touched[pt[r, lo:hi].long()] = True
    assert torch.equal(got[:, :, ~touched], init[:, :, ~touched])


@pytest.mark.cuda
def test_cuda_fused_prefill_contiguous_graphs_equal_eager(cuda, models):
    """Contiguous slots (``ServingConfig()``'s layout), interleaved with
    a budget of three chunks: fused rounds replayed as graphs give the
    eager run's tokens, launch counts and prefill keys; several rounds
    ran two or more rows."""
    import numpy as np
    from repro_torch.serving import Request, ServingConfig, ServingEngine
    cfg, spec, dcfg, params, dparams = _get_model(models, "llama3.1-8b")
    runs = []
    for graphs in (False, True):
        rng = np.random.default_rng(9)
        srv = ServingEngine(cfg, spec, dcfg, params, dparams, ServingConfig(
            batch=3, max_len=SERVE_MAX_LEN, prefill_budget=768),
            device="cuda", cuda_graphs=graphs)
        for i, (n, new) in enumerate(SERVE_CASE):
            srv.submit(Request(request_id=f"r{i}", max_new_tokens=new,
                               prompt=rng.integers(0, cfg.vocab_size, (n,))))
        tops.reset_launch_counts()
        srv.run()
        torch.cuda.synchronize()
        runs.append((srv, tops.launch_counts()))
    (eager, ec), (graph, gc) = runs
    for rid, o in eager.outputs.items():
        assert np.array_equal(graph.outputs[rid].tokens, o.tokens), rid
    assert gc == ec
    ge, ee = graph._continuous.engine, eager._continuous.engine
    assert not ge.paged and ge.prefill_keys == ee.prefill_keys
    assert sum(n for (k, _), n in ge.prefill_keys.items() if k > 1) > 1
    assert set(ge._graphs) == set(ge.dispatch_keys) | _prefill_graphs(ge)
    assert ec[0]["paged_prefill_attention"] == \
        cfg.num_layers * ee.prefill_dispatches


# ---------------------------------------------------------------------------
# head dim 64 (the trained tiny-dense pair: H=4, Hk=2, block 16), the full
# prefill of a training feature pass (T=2048) and the compiled AR baseline
# ---------------------------------------------------------------------------

def _dh64_case(dev, dtype, *, b=2, t=21, npg=40, ns=20, seed=30):
    """A K1 call at tiny-dense shapes (H=4, Hk=2, Dh=64, block 16): lists
    of pages with ragged valid lengths, an all-empty (row, head)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    h, hk, dh, bs = 4, 2, 64, 16
    q = torch.randn((b, t, h, dh), generator=g, device=dev).to(dtype)
    pk = torch.randn((npg, bs, hk, dh), generator=g, device=dev).to(dtype)
    pv = torch.randn((npg, bs, hk, dh), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, npg, (b, hk, ns), generator=g, device=dev,
                        dtype=torch.int32)
    vlen = torch.randint(0, bs + 1, (b, hk, ns), generator=g, device=dev,
                         dtype=torch.int32)
    vlen[1, 1] = 0
    return q, pk, pv, idx, vlen


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 6, 21, 71])
def test_cuda_block_attention_head_dim_64(cuda, dtype, t):
    """K1 at head dim 64 with blocks of 16 under the kernels' larger key
    tiles (every tile partial), against the plain version; the empty
    (row, head) comes out exactly (-1e30, 0, 0)."""
    q, pk, pv, idx, vlen = _dh64_case(cuda, TDT[dtype], t=t)
    npg, bs, hk, dh = pk.shape
    kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
    got, n = _kernel_launches(lambda: tops.block_attention(
        q, kf, vf, idx, vlen, bs))
    assert n <= 2
    want = tref.block_attention_batched(q, kf, vf, idx, vlen, bs)
    _assert_partials_close(got, want)
    assert torch.all(got[0][1, 2:4] == -1e30)
    assert torch.all(got[1][1, 2:4] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qoff, t", [(0, 48), (40, 48), (200, 37),
                                     (0, 128)])
def test_cuda_prefill_head_dim_64(cuda, dtype, qoff, t):
    """K2 at head dim 64, block 16: a chunk of T queries after ``qoff``
    tokens (not on a block boundary), through a permuted page table,
    against the plain version."""
    g = torch.Generator(device=cuda)
    g.manual_seed(31)
    dt = TDT[dtype]
    b, h, hk, dh, bs = 2, 4, 2, 64, 16
    nbt = -(-(qoff + t) // bs) + 1
    npg = nbt + 5
    q = torch.randn((b, t, h, dh), generator=g, device=cuda).to(dt)
    pk = torch.randn((npg, bs, hk, dh), generator=g, device=cuda).to(dt)
    pv = torch.randn((npg, bs, hk, dh), generator=g, device=cuda).to(dt)
    pt = torch.stack([torch.randperm(npg - 1, generator=g, device=cuda)[:nbt]
                      + 1 for _ in range(b)]).to(torch.int32)
    length = torch.tensor([qoff, qoff // 2], dtype=torch.int32, device=cuda)
    t_valid = torch.tensor([t, max(1, t - 9)], dtype=torch.int32,
                           device=cuda)
    idx, vlen = tops._page_walk(pt, length + t_valid, pk.shape)
    kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
    got, n = _kernel_launches(lambda: tops.block_attention(
        q, kf, vf, idx, vlen, bs, q_offset=length))
    assert n <= 2
    want = tref.block_attention_batched(q, kf, vf, idx, vlen, bs,
                                        q_offset=length)
    _assert_partials_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t, nb", [(1, 3), (21, 24), (70, 37)])
def test_cuda_retrieval_scores_head_dim_64(cuda, dtype, t, nb):
    """K3 at head dim 64 with two query heads per KV head, against the
    plain version, one launch; two calls give the same bits."""
    g = torch.Generator(device=cuda)
    g.manual_seed(32)
    b, h, hk, dh = 2, 4, 2, 64
    q = torch.randn((b, t, h, dh), generator=g, device=cuda).to(TDT[dtype])
    kmax = torch.randn((b, nb, hk, dh), generator=g, device=cuda).abs()
    kmin = -torch.randn((b, nb, hk, dh), generator=g, device=cuda).abs()
    qw = (torch.rand((b, t), generator=g, device=cuda) > 0.3).float()
    qw[:, -1] = 1.0
    before = tops.LAUNCHES["retrieval_score"]
    got = tops.retrieval_scores(q, kmax, kmin, qw)
    again = tops.retrieval_scores(q, kmax, kmin, qw)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["retrieval_score"] == before + 2
    assert torch.equal(got, again)
    _assert_close(got, tref.retrieval_score_batched(q, kmax, kmin, qw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_contiguous_summaries_head_dim_64(cuda, dtype):
    """K4's all-layer contiguous form at tiny-dense shapes (4 layers, Hk=2,
    Dh=64, block 16, max_len 250), bit for bit against the plain
    per-layer recomputation."""
    from repro_torch.kvcache.cache import update_layer_summaries
    layers, b, bs, max_len = 4, 2, 16, 250
    k, _ = _contiguous_kv(cuda, TDT[dtype], layers, b, max_len, seed=33,
                          hk=2, dh=64, bs=bs)
    nb = -(-max_len // bs)
    g = torch.Generator(device=cuda)
    g.manual_seed(34)
    old = torch.randn((2, layers, b, nb, 2, 64), generator=g, device=cuda)
    st = torch.tensor([37, 120], dtype=torch.int32, device=cuda)
    en = torch.tensor([101, 125], dtype=torch.int32, device=cuda)
    got = old.clone()
    tops.reset_launch_counts()
    tops.contiguous_block_summaries(k, st, en, 6, got[0], got[1], bs)
    assert tops.LAUNCHES["block_summary"] == 1
    for i in range(layers):
        wx, wn = update_layer_summaries(old[0, i], old[1, i], k[i], st, en,
                                        bs)
        assert torch.equal(got[0, i], wx) and torch.equal(got[1, i], wn)


@pytest.mark.cuda
def test_cuda_prefill_t2048_matches_plain(cuda):
    """K2 as a training feature pass calls it at llama3.1-8b widths: the
    whole 2048-token sequence in one call (qoff 0) over a contiguous
    cache of 2048 tokens, bf16, against the plain version."""
    k, v = _contiguous_kv(cuda, torch.bfloat16, 1, 1, 2048, seed=35)
    k, v = k[0], v[0]
    g = torch.Generator(device=cuda)
    g.manual_seed(36)
    t = 2048
    q = torch.randn((1, t, 32, 128), generator=g, device=cuda).to(
        torch.bfloat16)
    length = torch.zeros((1,), dtype=torch.int32, device=cuda)
    tv = torch.tensor([t], dtype=torch.int32, device=cuda)
    kf, rows = tops.flat_blocks(k)
    vf, _ = tops.flat_blocks(v)
    idx, vlen = tops._identity_walk(1, 8, rows // 128, length + tv, 2048,
                                    128)
    before = tops.LAUNCHES["paged_prefill_attention"]
    got = tops.block_attention(q, kf, vf, idx, vlen, 128, q_offset=length)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["paged_prefill_attention"] == before + 1
    want = tref.block_attention_batched(q, kf, vf, idx, vlen, 128,
                                        q_offset=length)
    _assert_partials_close(got, want)


@pytest.mark.cuda
def test_cuda_compiled_ar_equals_plain_oracle(cuda):
    """The compiled AR baseline (K2/K4 prefill, one graph per decode step
    over K1 and K4) gives the plain oracle's tokens in fp32 on a random
    tiny-dense model at block 16, eagerly and replayed, and launches K1
    once and K4 once per decode step."""
    import numpy as np
    from repro_torch.configs import SpecPVConfig, get_config
    from repro_torch.core.reference import (CompiledAR,
                                            autoregressive_generate)
    from repro_torch.models.api import init_params
    cfg = get_config("tiny-dense")
    spec = SpecPVConfig(block_size=16)
    params = init_params(cfg, seed=3, device="cuda")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 150))
    want = autoregressive_generate(cfg, params, prompt, 24, max_len=256,
                                   prefill_chunk=64, spec=spec, device="cuda")
    eager = CompiledAR(cfg, params, batch=2, max_len=256, spec=spec,
                       device="cuda", cuda_graphs=False)
    graphs = CompiledAR(cfg, params, batch=2, max_len=256, spec=spec,
                        device="cuda")
    runs = []
    for ar in (eager, graphs, graphs):      # capture, then a replay
        tops.reset_launch_counts()
        runs.append((ar.generate(prompt, 24, prefill_chunk=64),
                     dict(tops.LAUNCHES)))
    for toks, launches in runs:
        assert np.array_equal(toks, want)
        assert launches["sparse_verify_attention"] == 23 * cfg.num_layers
        assert launches["block_summary"] == 23 + 3
        assert launches["paged_prefill_attention"] == 3 * cfg.num_layers


# ---------------------------------------------------------------------------
# sampling: per-slot streams, sampled and chain steps
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_stream_bits_equal_cpu(cuda):
    """The streams' Threefry words and uniforms are the same bits on the
    card as on the CPU; the card's draws never land on a token of
    probability 0 and pick the CPU's token at 99% of draws or more (the
    parallel scans may round a boundary the other way)."""
    from repro_torch.core import sampling as smp
    first, stream = smp.seed_keys(12345, 64)
    g = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 2**32, (64, 2), generator=g, dtype=torch.long)
    for k in (first, stream, keys):
        nxt, u = smp.stream_draws(k, 127)
        nxt_c, u_c = smp.stream_draws(k.to(cuda), 127)
        assert torch.equal(nxt_c.cpu(), nxt) and torch.equal(u_c.cpu(), u)
    probs = torch.rand((256, 128256), generator=g)
    probs[:, ::3] = 0.0
    probs[:, :1000] = 0.0
    u = torch.rand((256,), generator=g)
    u[:3] = torch.tensor([0.0, 1.0 - 2.0 ** -24, 0.5])
    tok = smp.categorical(probs.to(cuda), u.to(cuda)).cpu()
    assert (probs.gather(1, tok[:, None]) > 0).all()
    assert (tok == smp.categorical(probs, u)).float().mean() >= 0.99


def _kinds_engine(model, graphs, temps, drafts, prompts, new):
    """A batch-3 engine with a slot of each (temperature, draft) kind,
    seeds 0-2, stepped ``new`` ticks.  Returns (engine, tokens by slot)."""
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine
    cfg, spec, dcfg, params, dparams = model
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=3,
                       max_len=SERVE_MAX_LEN, device="cuda",
                       cuda_graphs=graphs)
    st = eng.empty_state()
    toks = {}
    for i, (t, d, p) in enumerate(zip(temps, drafts, prompts)):
        st, first = eng.prefill_into_slot(st, i, p, temperature=t, seed=i,
                                          draft=d, max_new_tokens=new + 8)
        toks[i] = [first]
    rows = np.ones((3,), bool)
    for _ in range(new):
        st, so = eng.step_fused(st, rows, eng.modes_for_rows(st, rows))
        for i in range(3):
            toks[i].extend(int(x) for x in so.tokens[i, :so.counts[i]])
    torch.cuda.synchronize()
    return eng, toks


SAMPLED_KINDS = ((0.0, 0.8, 0.8), ("tree", "chain", "tree"))


def _kinds_prompts(cfg, lens=(2000, 4700, 5000)):
    import numpy as np
    rng = np.random.default_rng(9)
    return [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]


@pytest.mark.cuda
def test_cuda_sampled_graph_equals_eager(cuda, models):
    """Slots of greedy tree, sampled chain and sampled tree kinds stepped
    through Full, Refresh and Partial ticks: the replayed graphs give the
    eager bodies' tokens and launch counts, one graph per variant key,
    sampled and chain keys among them."""
    model = _get_model(models, "llama3.1-8b")
    prompts = _kinds_prompts(model[0])
    runs = []
    for graphs in (False, True):
        tops.reset_launch_counts()
        eng, toks = _kinds_engine(model, graphs, *SAMPLED_KINDS, prompts, 12)
        runs.append((eng, toks, tops.launch_counts()))
    (_, et, ec), (ge, gt, gc) = runs
    assert et == gt and ec == gc
    assert set(ge._graphs) == set(ge.dispatch_keys) | _prefill_graphs(ge)
    assert any(k[3] and k[4] for k in ge.dispatch_keys)
    assert any(k[1] for k in ge.dispatch_keys)          # Partial ticks ran


@pytest.mark.cuda
def test_cuda_sampled_step_bodies_do_not_sync(cuda, models):
    """Each sampled or chain step variant's body (Full, Refresh, Partial
    and their mix, over greedy, sampled and chain rows and a masked-out
    row), and the sampled rwkv6 state body, run eagerly under
    ``set_sync_debug_mode("error")``."""
    import numpy as np
    from repro_torch.core.engine import MODE_IDS, SpecPVEngine
    model = _get_model(models, "llama3.1-8b")
    eng, _ = _kinds_engine(model, False, *SAMPLED_KINDS,
                           _kinds_prompts(model[0]), 1)
    for modes, key3 in ((["full"] * 3, (True, False, False)),
                        (["refresh"] * 3, (True, False, True)),
                        (["partial"] * 3, (False, True, False)),
                        (["partial", "refresh", "full"], (True, True, True))):
        for flags in ((True, False), (True, True), (False, True)):
            eng._tick_in.copy_(torch.tensor(
                [[MODE_IDS[m] for m in modes], [1, 1, 0], [0, 1, 0]],
                dtype=torch.int8, device=cuda))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng._fused_body(*key3, *flags)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    cfg, spec, dcfg, params, dparams = _get_model(models, "rwkv6-3b")
    reng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=2,
                        max_len=700, temperature=0.8, device="cuda",
                        cuda_graphs=False)
    reng.prefill(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 300)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        reng._state_body()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_greedy_rows_in_mixed_graph_tick_fp32(cuda):
    """fp32 (``tiny-dense``, block 16), with graphs: a greedy slot stepped
    beside sampled chain and tree slots gives the tokens it gives beside
    greedy slots, and the sampled slots draw (their tokens differ from
    the greedy run's)."""
    from repro_torch.configs import DraftConfig, SpecPVConfig, get_config
    from repro_torch.core.draft import init_draft_params
    from repro_torch.models.api import init_params
    cfg = get_config("tiny-dense")
    spec = SpecPVConfig(block_size=16, num_sink_blocks=1,
                        retrieval_budget_blocks=4, local_window_blocks=2,
                        buffer_size=48, use_pallas=True)
    dcfg = DraftConfig(tree_depth=3, tree_branch=(2, 2, 1))
    model = (cfg, spec, dcfg, init_params(cfg, seed=0, device=cuda),
             init_draft_params(cfg, dcfg, seed=1, device=cuda))
    prompts = _kinds_prompts(cfg, (90, 160, 200))
    _, mixed = _kinds_engine(model, True, *SAMPLED_KINDS, prompts, 16)
    _, greedy = _kinds_engine(model, True, (0.0,) * 3, ("tree",) * 3,
                              prompts, 16)
    assert mixed[0] == greedy[0]
    assert mixed[1] != greedy[1] and mixed[2] != greedy[2]


# ---------------------------------------------------------------------------
# tiered KV residency: the codecs and the host tier on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_cuda_quantize_bit_equal_cpu(cuda, codec):
    """The codecs on the card give the CPU route's payload and scales,
    and dequantize to its bf16 and fp32 values, bit for bit."""
    from repro_torch.kvcache import quant
    g = torch.Generator(device=cuda)
    g.manual_seed(11)
    x = (torch.randn((4, 128, 8, 128), generator=g, device=cuda)
         * torch.randn((4, 128, 8, 1), generator=g, device=cuda).exp()
         ).to(torch.bfloat16)
    x[0, :3] = 0
    x[1, 0, 0, :9] = 1e-30
    fn = quant.quantize_kv_fp8 if codec == "fp8" else quant.quantize_kv
    qd, sd = fn(x)
    qc, sc = fn(x.cpu())
    assert torch.equal(qd.view(torch.uint8).cpu(), qc.view(torch.uint8))
    assert torch.equal(sd.view(torch.int16).cpu(), sc.view(torch.int16))
    for dt in (torch.bfloat16, torch.float32):
        assert torch.equal(quant.dequantize_kv(qd, sd, dt).cpu(),
                           quant.dequantize_kv(qc, sc, dt))


def _tier_pool(dev, seed, npg=40, layers=4, bs=128, hk=8, dh=128):
    """A random bf16 paged pool with page summaries and a 2-slot table."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    kv = (layers, npg, bs, hk, dh)
    sm = (layers, npg, hk, dh)
    return {"k": torch.randn(kv, generator=g, device=dev).to(torch.bfloat16),
            "v": torch.randn(kv, generator=g, device=dev).to(torch.bfloat16),
            "kmax": torch.randn(sm, generator=g, device=dev),
            "kmin": torch.randn(sm, generator=g, device=dev),
            "page_table": torch.zeros((2, 16), dtype=torch.int32,
                                      device=dev)}


def _tier_cycle(cache, tm, prefetch):
    """Seat 12 + 4 pages, demote slot 0's 10 complete blocks, overwrite
    the recycled pages through slot 1 at once (on the engine's stream),
    then prefetch (or not) and promote, every tier call under
    ``set_sync_debug_mode("error")`` on the card."""
    al = tm.alloc
    cuda = cache["k"].is_cuda

    def no_sync(fn):
        if not cuda:
            return fn()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    cache["page_table"][0, :12] = torch.from_numpy(al.alloc(0, 12))
    cache["page_table"][1, :4] = torch.from_numpy(al.alloc(1, 4))
    if cuda:
        torch.cuda.synchronize()
    no_sync(lambda: tm.demote_slot(cache, 0, 10 * 128 + 5))
    taken = al.alloc(1, 10)                # the recycled pages, at once
    for name in ("k", "v"):
        cache[name][:, torch.from_numpy(taken).long().to(cache[name].device)] \
            = 7.0
    if prefetch:
        no_sync(lambda: tm.prefetch_slot(0))
    no_sync(lambda: tm.promote_slot(cache, 0))
    if cuda:
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["lossless", "int8", "fp8"])
@pytest.mark.parametrize("prefetch", [True, False])
def test_cuda_tier_side_stream_round_trip(cuda, codec, prefetch):
    """Demote, then prefetch on the side stream (or promote with a copy on
    the engine's stream), and promote, with the demoted pages reused and
    overwritten in between and no tier call syncing: lossless restores
    the pool's K/V, summaries and page table bit for bit; int8 and fp8
    give the CPU route's pool bit for bit."""
    from repro_torch.kvcache.cache import PageAllocator
    from repro_torch.kvcache.offload import TierManager
    kw = (dict(lossless=True) if codec == "lossless"
          else dict(codec=codec))
    cache = _tier_pool(cuda, 21)
    cpu = {n: t.cpu() for n, t in cache.items()}
    before = {n: t.clone() for n, t in cache.items()}
    tm = TierManager(PageAllocator(40), **kw)
    tc = TierManager(PageAllocator(40), **kw)
    _tier_cycle(cache, tm, prefetch)
    _tier_cycle(cpu, tc, prefetch)
    assert tm.stats() == tc.stats()
    assert tm.stats()["tier_prefetch_hits" if prefetch
                      else "tier_sync_promotes"] == 1
    for n in ("k", "v", "kmax", "kmin", "page_table"):
        assert torch.equal(cache[n].cpu(), cpu[n]), n
    pt = cache["page_table"][0, :12].long()
    assert torch.equal(pt[10:], torch.arange(1, 3, device=cuda) + 10)
    names = ("kmax", "kmin") + (("k", "v") if codec == "lossless" else ())
    old = torch.arange(1, 13, device=cuda)      # the pages seated first
    for n in names:
        assert torch.equal(cache[n][:, pt], before[n][:, old]), n


@pytest.mark.cuda
def test_cuda_tiered_graphs_equal_untiered(cuda, models):
    """2-layer llama at full width, with graphs: tiered lossless
    ``generate`` through a demotion, a prefetch hit and a second demotion
    gives the untiered tokens, captures the same graphs and launches the
    same kernels; a Partial step in which no tier work runs makes the
    untiered step's device launches, with 3 host launch calls."""
    from collections import Counter

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    host_calls = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaMemcpyAsync",
                  "cudaMemsetAsync", "cudaLaunchKernelExC")
    model = _get_model(models, "llama3.1-8b")
    prompt_len, new = 4700, 100
    prompt = np.random.default_rng(9).integers(
        0, model[0].vocab_size, (1, prompt_len)).astype(np.int64)
    runs = []
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    cfg, spec, dcfg, params, dparams = model
    max_len = request_token_need(prompt_len, new, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    for tiered in (False, True):
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=max_len, paged=True, tiered=tiered,
                           tier_lossless=True, device="cuda")
        tops.reset_launch_counts()
        toks, stats = eng.generate(prompt, new)
        torch.cuda.synchronize()
        launches = tops.launch_counts()
        st = eng.final_state
        st, _ = eng.step(st, "refresh")
        torch.cuda.synchronize()
        # a session may lose kernel records (``_kernel_launches``): each
        # side's device events are those of two consecutive profiled
        # Partial steps that agree, as ``_graph_step_launches`` takes
        # them; copies and sets are counted, not named (their records'
        # names vary from session to session)
        prev = None
        for _ in range(4):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                st, so = eng.step(st, "partial")
                torch.cuda.synchronize()
            assert so.mode == "partial"
            events = prof.events()
            names = [e.name for e in events
                     if getattr(e, "device_type", None) == DeviceType.CUDA]
            kernels = Counter(n for n in names if not n.lower().startswith(
                ("memset", "memcpy")))
            seen = (kernels, len(names))
            calls = sum(1 for e in events if e.name in host_calls)
            if seen == prev:
                break
            prev = seen
        runs.append((eng, toks, stats, launches, seen, calls))
    (ue, ut, us, ul, (uk, ud), uc), (te, tt, ts, tl, (tk, td), tc) = runs
    assert np.array_equal(tt, ut) and ts["modes"] == us["modes"]
    assert us["modes"]["refresh"] >= 2
    assert set(te._graphs) == set(ue._graphs) and tl == ul
    stats = te.tier_stats()
    assert stats["tier_demoted_pages"] > 0 and stats["tier_prefetch_hits"] >= 1
    assert sum(uk.values()) > 0
    assert tk == uk, (tk - uk, uk - tk)
    assert td == ud and tc == uc == 3, (td, ud, tc, uc)


# ---------------------------------------------------------------------------
# the MoE family: granite-moe-1b-a400m (H=16, Hk=8, Dh=64, 32 experts top-8)
# ---------------------------------------------------------------------------

MOE = "granite-moe-1b-a400m"


def _moe_input(b, t, d, seed):
    """Tokens that share a direction, as a layer's hidden states do, so
    the router favours the same experts and capacity binds."""
    g = torch.Generator().manual_seed(seed)
    return (3.0 * torch.randn((1, 1, d), generator=g)
            + torch.randn((b, t, d), generator=g))


@pytest.mark.cuda
@pytest.mark.parametrize("b, t", [(1, 61), (1, 256), (5, 256)])
def test_cuda_moe_layer_matches_cpu_fp32(cuda, b, t):
    """One MoE layer at granite width in fp32 on the card against the CPU
    route on the same weights: a verify step's 61 tokens, a prefill
    chunk, and 1280 tokens (two dispatch groups, the second padded).  The
    same kept (token, slot) pairs, pairs dropped, and the output within
    1e-4 of its largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as bk
    cfg = get_config(MOE).replace(dtype="float32", param_dtype="float32")
    p = bk.init_moe_params(cfg, torch.Generator().manual_seed(0))
    pc = {k: v.to(cuda) for k, v in p.items()}
    x = _moe_input(b, t, cfg.d_model, 1)
    want, _ = bk.moe_fwd(cfg, p, x, aux=False)
    got, _ = bk.moe_fwd(cfg, pc, x.to(cuda), aux=False)
    _assert_close(got.cpu(), want)
    n, g = b * t, min(b * t, bk.MOE_GROUP)
    ng = -(-n // g)
    xg = torch.zeros((ng * g, cfg.d_model))
    xg[:n] = x.reshape(n, -1)
    xg = xg.view(ng, g, -1)
    _, _, kc = bk._moe_groups_fwd(cfg, p, xg, 1.25, False)
    _, _, kg = bk._moe_groups_fwd(cfg, pc, xg.to(cuda), 1.25, False)
    assert torch.equal(kg.cpu(), kc)
    assert not bool(kc.reshape(-1)[: n * cfg.experts_per_token].all())


@pytest.mark.cuda
def test_cuda_moe_partial_step_graph_launches_eager_body(cuda, models):
    """granite-moe-1b-a400m cut to 2 layers at full width, bf16, on the
    paged zero-copy pool: the Partial step body runs eagerly under
    ``torch.cuda.set_sync_debug_mode("error")``, and a replayed Partial
    step launches on the card the kernels an eager Partial step launches,
    name for name (copies and sets aside); graph ``generate`` equals
    eager ``generate`` (tokens, modes, K1-K4 launches)."""
    _graph_step_launches(models, MOE, seed=14)


def _graph_step_launches(models, name, seed):
    """``name`` cut to 2 layers at full width on the paged zero-copy pool,
    eager and with graphs: equal tokens, modes and K1-K4 launches; the
    eager Partial body under the sync check; the kernels of one replayed
    Partial step equal an eager one's, name for name."""
    from collections import Counter

    import numpy as np
    from repro_torch.core.engine import (MODE_IDS, SpecPVEngine,
                                         request_token_need)
    cfg, spec, dcfg, params, dparams = _get_model(models, name)
    prompt_len, new = 35 * 128 - 6, 24
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, prompt_len)).astype(np.int64)
    max_len = request_token_need(prompt_len, new, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    runs = []
    for graphs in (False, True):
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=max_len, paged=True, zero_copy=True,
                           device="cuda", cuda_graphs=graphs)
        tops.reset_launch_counts()
        toks, stats = eng.generate(prompt, new)
        torch.cuda.synchronize()
        counts = tops.launch_counts()
        st = eng.final_state
        if not graphs:
            eng._rows.fill_(True)
            eng._modes.fill_(MODE_IDS["partial"])
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng._fused_body(False, True, False)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        st, _ = eng.step(st, "partial")
        torch.cuda.synchronize()
        # a session may lose kernel records (``_kernel_launches``), and a
        # replay's cannot be checked against its one host launch call:
        # each side's kernels are those of two consecutive profiled
        # Partial steps that agree
        prev = None
        for _ in range(4):
            (st, so), names, _ = _session(
                lambda st=st: eng.step(st, "partial"))
            assert so.mode == "partial"
            kernels = Counter(names)
            if kernels == prev:
                break
            prev = kernels
        runs.append((toks, stats, counts, kernels))
    (et, es, ec, ed), (gt, gs, gc, gd) = runs
    assert np.array_equal(gt, et) and gs["modes"] == es["modes"]
    assert set(es["modes"]) == {"full", "refresh", "partial"}
    assert gc == ec and all(ec[0][k] > 0 for k in (
        "sparse_verify_attention", "paged_prefill_attention",
        "retrieval_score", "block_summary"))
    assert sum(ed.values()) > 0
    assert gd == ed, (gd - ed, ed - gd)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 61, 156])
def test_cuda_block_attention_granite_heads(cuda, t):
    """K1 at granite's heads (H=16, Hk=8, Dh=64, block 128, bf16) over
    routed lists of 35 pages with ragged valid lengths and an all-empty
    (row, head), batch 2, against the plain version; at most two
    launches per call."""
    q, pk, pv, idx, vlen = _cuda_case(cuda, torch.bfloat16, b=2, t=t, h=16,
                                      hk=8, dh=64, npg=70, ns=35, seed=40)
    npg, bs, hk, dh = pk.shape
    kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
    got, n = _kernel_launches(lambda: tops.block_attention(
        q, kf, vf, idx, vlen, bs))
    assert n <= 2
    _assert_partials_close(got, tref.block_attention_batched(
        q, kf, vf, idx, vlen, bs))


@pytest.mark.cuda
def test_cuda_prefill_granite_heads(cuda):
    """K2 at granite's heads: the last 256-token chunk of an 8192-token
    prompt through a permuted page table (the paged prefill's page walk
    and causal offset), bf16, against the plain version."""
    g = torch.Generator(device=cuda)
    g.manual_seed(41)
    h, hk, dh, bs, t, qoff = 16, 8, 64, 128, 256, 7936
    nbt = (qoff + t) // bs
    npg = nbt + 3
    q = torch.randn((1, t, h, dh), generator=g, device=cuda).bfloat16()
    pk = torch.randn((npg, bs, hk, dh), generator=g, device=cuda).bfloat16()
    pv = torch.randn((npg, bs, hk, dh), generator=g, device=cuda).bfloat16()
    pt = (torch.randperm(npg - 1, generator=g, device=cuda)[:nbt] + 1)[None]
    pt = pt.to(torch.int32).contiguous()
    length = torch.tensor([qoff], dtype=torch.int32, device=cuda)
    tv = torch.tensor([t], dtype=torch.int32, device=cuda)
    idx, vlen = tops._page_walk(pt, length + tv, pk.shape)
    kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
    got, n = _kernel_launches(lambda: tops.block_attention(
        q, kf, vf, idx, vlen, bs, q_offset=length))
    assert n <= 2
    _assert_partials_close(got, tref.block_attention_batched(
        q, kf, vf, idx, vlen, bs, q_offset=length))


@pytest.mark.cuda
def test_cuda_scores_and_summaries_granite_heads(cuda):
    """K3 at granite's heads for a Refresh (T=156 over 66 blocks), two
    calls bit-equal and within tolerance of the plain version; K4's
    paged form over 24 layers (the last prompt chunk of 8192 tokens) bit
    for bit, the null page left at 0."""
    g = torch.Generator(device=cuda)
    g.manual_seed(42)
    b, t, h, hk, dh, nb = 1, 156, 16, 8, 64, 66
    q = torch.randn((b, t, h, dh), generator=g, device=cuda).bfloat16()
    kmax = torch.randn((b, nb, hk, dh), generator=g, device=cuda).abs()
    kmin = -torch.randn((b, nb, hk, dh), generator=g, device=cuda).abs()
    qw = (torch.rand((b, t), generator=g, device=cuda) > 0.3).float()
    got = tops.retrieval_scores(q, kmax, kmin, qw)
    assert torch.equal(got, tops.retrieval_scores(q, kmax, kmin, qw))
    _assert_close(got, tref.retrieval_score_batched(q, kmax, kmin, qw))
    layers, npg, bs = 24, 70, 128
    pool = torch.randn((layers, npg, bs, hk, dh), generator=g,
                       device=cuda).bfloat16()
    table = (torch.randperm(npg - 1, generator=g, device=cuda)[:nb]
             + 1).to(torch.int32)[None].contiguous()
    st = torch.tensor([7936], dtype=torch.int32, device=cuda)
    en = torch.tensor([8192], dtype=torch.int32, device=cuda)
    got4 = torch.zeros((2, layers, npg, hk, dh), device=cuda)
    want4 = torch.zeros_like(got4)
    before = tops.LAUNCHES["block_summary"]
    tops.paged_block_summaries(pool, table, st, en, 3, got4[0], got4[1])
    tref.paged_block_summaries(pool, table, st, en, 3, want4[0], want4[1])
    torch.cuda.synchronize()
    assert tops.LAUNCHES["block_summary"] == before + 1
    assert torch.equal(got4, want4) and float(got4.abs().sum()) > 0
    assert float(got4[:, :, 0].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the rest of the dense registry: head groups of 1 and 7 query heads per
# KV head (deepseek-7b and qwen1.5-32b MHA, qwen2-0.5b 14/2)
# ---------------------------------------------------------------------------

HEAD_GROUPS = {"rep7": (14, 2, 64), "rep1": (32, 32, 128),
               "rep1-h40": (40, 40, 128),
               # llama-3.2-vision-90b (64/8) and whisper-small (12/12)
               "rep8": (64, 8, 128), "rep1-h12": (12, 12, 64)}
ATTN_FORMS = ("full", "refresh", "routed", "contiguous", "gathered",
              "prefill", "contiguous_prefill", "ragged")


def _group_attention(dev, dtype, h, hk, dh, form, seed):
    """One call of a K1/K2 call form at heads (H, Hk, Dh), block 128,
    batch 2 (4 ragged rows for ``ragged``), and the plain version of the
    same launch: returns (got partials, want partials)."""
    from repro_torch.configs import SpecPVConfig
    from repro_torch.models import dense as dn
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bs, b, nbt = 128, 2, 17
    t = {"refresh": 156, "prefill": 256, "contiguous_prefill": 256,
         "ragged": 256}.get(form, 61)
    rows = 4 if form == "ragged" else b
    npg = rows * nbt + 3

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    q = rnd(rows, t, h, dh)
    pk, pv = rnd(npg, bs, hk, dh), rnd(npg, bs, hk, dh)
    kf, vf = tops._flat_pool(pk), tops._flat_pool(pv)
    pt = (torch.randperm(npg - 1, generator=g, device=dev)[: rows * nbt]
          + 1).to(torch.int32).view(rows, nbt).contiguous()

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)
    if form in ("full", "refresh"):
        length = i32(nbt * bs - 77, 900)
        got = tops.paged_verify_attention(q, pk, pv, pt, length)
        idx, vlen = tops._page_walk(pt, length, pk.shape)
        return got, tref.block_attention_batched(q, kf, vf, idx, vlen, bs)
    if form in ("routed", "gathered"):
        ns = 12
        pbi = torch.stack([torch.stack([
            torch.randperm(nbt, generator=g, device=dev)[:ns]
            for _ in range(hk)]) for _ in range(b)]).to(torch.int32)
        pbi[..., -2:] = -1
        length = i32(nbt * bs - 50, nbt * bs)
        vlen = dn._selected_vlen(pbi, length, bs).to(torch.int32)
        if form == "routed":
            idx = torch.gather(pt.long()[:, None].expand(b, hk, nbt), 2,
                               pbi.clamp(min=0).long())
            idx = torch.where(vlen > 0, idx, 0).to(torch.int32).contiguous()
            got = tops.routed_partial_attention(q, pk, pv, idx, vlen)
            return got, tref.block_attention_batched(q, kf, vf, idx, vlen,
                                                     bs)
        body_k, body_v = dn.gather_partial_body(
            SpecPVConfig(block_size=bs), pbi[None], pk[None], pv[None], pt)
        bk_, bv_ = (x[0].reshape(b * ns, bs, hk, dh) for x in (body_k,
                                                               body_v))
        idx = (torch.arange(b, device=dev)[:, None, None] * ns
               + torch.arange(ns, device=dev)).expand(b, hk, ns)
        idx = idx.to(torch.int32).contiguous()
        got = tops.routed_partial_attention(q, bk_, bv_, idx, vlen)
        return got, tref.block_attention_batched(
            q, tops._flat_pool(bk_), tops._flat_pool(bv_), idx, vlen, bs)
    if form == "contiguous":
        k, v = _contiguous_kv(dev, dtype, 1, b, 2000, seed + 1, hk=hk,
                              dh=dh)
        length = i32(1999, 700)
        got = tops.contiguous_verify_attention(q, k[0], v[0], length, bs)
        ckf, s_alloc = tops.flat_blocks(k[0])
        cvf, _ = tops.flat_blocks(v[0])
        idx, vlen = tops._identity_walk(b, hk, s_alloc // bs, length, 2000,
                                        bs)
        return got, tref.block_attention_batched(q, ckf, cvf, idx, vlen, bs)
    if form == "contiguous_prefill":
        k, v = _contiguous_kv(dev, dtype, 1, b, 2000, seed + 1, hk=hk,
                              dh=dh)
        ckf, s_alloc = tops.flat_blocks(k[0])
        cvf, _ = tops.flat_blocks(v[0])
        length, tv = i32(1536, 0), i32(256, 200)
        idx, vlen = tops._identity_walk(b, hk, s_alloc // bs, length + tv,
                                        2000, bs)
        got = tops.block_attention(q, ckf, cvf, idx, vlen, bs,
                                   q_offset=length)
        return got, tref.block_attention_batched(q, ckf, cvf, idx, vlen, bs,
                                                 q_offset=length)
    if form == "prefill":
        length, tv = i32(nbt * bs - 256 - 61, 700), i32(256, 256)
    else:                                  # ragged: a fused round's rows
        length, tv = i32(1900, 48, 0, 1000), i32(256, 16, 200, 1)
    idx, vlen = tops._page_walk(pt, length + tv, pk.shape)
    got = tops.block_attention(q, kf, vf, idx, vlen, bs, q_offset=length)
    return got, tref.block_attention_batched(q, kf, vf, idx, vlen, bs,
                                             q_offset=length)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ATTN_FORMS)
@pytest.mark.parametrize("group", sorted(HEAD_GROUPS))
def test_cuda_attention_call_forms_at_head_groups(cuda, group, form, dtype):
    """Every K1/K2 call form (paged Full T=61 and Refresh T=156, routed
    zero-copy Partial, the contiguous identity list, the gathered body,
    the causal paged and contiguous prefill T=256, a ragged four-row
    fused round) at 7 query heads per KV head (qwen2-0.5b: 14/2, Dh 64:
    a 64-row tile straddles two query heads when T is not a multiple of
    64) and at 1 (deepseek-7b 32/32 and qwen1.5-32b 40/40, Dh 128:
    split-KV with 32 and 40 KV heads in the grid) against the plain
    version of the same launch; a second call gives the same bits."""
    h, hk, dh = HEAD_GROUPS[group]
    seed = 50 + ATTN_FORMS.index(form)
    got, want = _group_attention(cuda, TDT[dtype], h, hk, dh, form, seed)
    torch.cuda.synchronize()
    _assert_partials_close(got, want)
    again, _ = _group_attention(cuda, TDT[dtype], h, hk, dh, form, seed)
    for a, c in zip(got, again):
        assert torch.equal(a, c)


def _score_case(dev, dtype, b, t, h, hk, dh, nb, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.randn((b, t, h, dh), generator=g, device=dev).to(dtype)
    kmax = torch.randn((b, nb, hk, dh), generator=g, device=dev).abs()
    kmin = -torch.randn((b, nb, hk, dh), generator=g, device=dev).abs()
    qw = (torch.rand((b, t), generator=g, device=dev) > 0.3).float()
    qw[:, 0] = 1.0
    return q, kmax, kmin, qw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b, t, h, hk, dh, nb", [
    (1, 156, 14, 2, 64, 66),       # qwen2-0.5b Refresh: rep 7
    (2, 61, 14, 2, 64, 40),
    (1, 9, 21, 1, 64, 5),          # rep 21: one token spans two slices
    (1, 156, 32, 32, 128, 66),     # deepseek-7b: rep 1
    (1, 156, 40, 40, 128, 17),     # qwen1.5-32b: rep 1
    (2, 5, 64, 1, 64, 33),         # rep 64, the largest
    (1, 156, 32, 8, 128, 66),      # llama3.1-8b: rep 4
    (1, 156, 64, 8, 128, 66),      # llama-3.2-vision-90b: rep 8
    (1, 156, 12, 12, 64, 66),      # whisper-small: rep 1, Dh 64
])
def test_cuda_retrieval_scores_any_rep(cuda, dtype, b, t, h, hk, dh, nb):
    """K3 at any head group from 1 to 64 (qwen2-0.5b's 7, MHA's 1, 21
    and 64) against the plain version, one launch per call, two calls
    bit-equal; a group over 64 raises."""
    q, kmax, kmin, qw = _score_case(cuda, TDT[dtype], b, t, h, hk, dh, nb,
                                    60 + h + t)
    before = tops.LAUNCHES["retrieval_score"]
    got = tops.retrieval_scores(q, kmax, kmin, qw)
    again = tops.retrieval_scores(q, kmax, kmin, qw)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["retrieval_score"] == before + 2
    assert torch.equal(got, again)
    _assert_close(got, tref.retrieval_score_batched(q, kmax, kmin, qw))


@pytest.mark.cuda
def test_cuda_retrieval_scores_refuse_rep_over_64(cuda):
    q, kmax, kmin, qw = _score_case(cuda, torch.bfloat16, 1, 4, 65, 1, 64,
                                    3, 61)
    with pytest.raises(ValueError, match="up to 64"):
        tops.retrieval_scores(q, kmax, kmin, qw)


# the index arithmetic of K3 before it took any head group: a power of
# two only, rows mapped by shifts and masks
_K3_SHIFT_FORM = [
    ("    ok ? (qrow0 + rg / rep) * h + kh * rep + rg % rep : 0;",
     "    ok ? (qrow0 + (rg >> (__ffs(rep) - 1))) * h"
     " + (kh << (__ffs(rep) - 1)) + (rg & (rep - 1)) : 0;"),
    ("      const size_t row = (qrow0 + rg / rep) * h + kh * rep + rg % rep;",
     "      const size_t row = (qrow0 + (rg >> (__ffs(rep) - 1))) * h"
     " + (kh << (__ffs(rep) - 1)) + (rg & (rep - 1));"),
    ("qw[(size_t)b * t_len + rg / rep]",
     "qw[(size_t)b * t_len + (rg >> (__ffs(rep) - 1))]"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_cuda_retrieval_scores_power_of_two_bits_unchanged(cuda, rep):
    """At a power-of-two head group K3 gives the bits of its earlier
    shift-and-mask row mapping: the kernel built with that index
    arithmetic (``tools/kernel_variants.py``) and the library's agree bit
    for bit, in both dtypes, at a Refresh over 66 blocks."""
    import ctypes
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import kernel_variants as kv
    from repro_torch.kernels.build import load_library
    P, I = ctypes.c_void_p, ctypes.c_int

    def declare(lib):
        lib.retrieval_score_launch.argtypes = [P] * 7 + [I] * 9 + [P]
        lib.retrieval_score_launch.restype = I
    shift = kv.build_variants("retrieval_score.cu",
                              {"shift": _K3_SHIFT_FORM}, "k3_shift",
                              declare)["shift"]
    hk = 8 if rep <= 4 else 4
    for dtype in (torch.float32, torch.bfloat16):
        q, kmax, kmin, qw = _score_case(cuda, dtype, 1, 156, hk * rep, hk,
                                        128, 66, 70 + rep)
        b, t, h, dh = q.shape
        nb = kmax.shape[1]
        outs = []
        for lib in (load_library(), shift):
            out = torch.empty((b, hk, nb), dtype=torch.float32, device=cuda)
            tiles, slices, groups = tops.score_grid(b, t, h, hk, nb)
            part = torch.empty(groups * slices * nb, dtype=torch.float32,
                               device=cuda)
            ctr = torch.zeros(groups * tiles, dtype=torch.int32,
                              device=cuda)
            err = lib.retrieval_score_launch(
                q.data_ptr(), kmax.data_ptr(), kmin.data_ptr(),
                qw.data_ptr(), out.data_ptr(), part.data_ptr(),
                ctr.data_ptr(), b, t, h, hk, dh, nb, tiles, slices,
                tops._DTYPES[dtype], torch.cuda.current_stream().cuda_stream)
            assert err == 0
            outs.append(out)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("layers, hk", [(30, 32), (64, 40)],
                         ids=["deepseek-7b", "qwen1.5-32b"])
def test_cuda_paged_summaries_mha_widths(cuda, layers, hk):
    """K4's paged form over every layer at multi-head widths (Hk 32 over
    30 layers, Hk 40 over 64: a row of 5120 columns), the last prompt
    chunk of 2048 tokens, bf16, against its plain version bit for bit;
    the null page stays 0."""
    g = torch.Generator(device=cuda)
    g.manual_seed(80 + hk)
    npg, bs, dh, nb = 20, 128, 128, 17
    pool = torch.randn((layers, npg, bs, hk, dh), generator=g,
                       device=cuda).bfloat16()
    table = (torch.randperm(npg - 1, generator=g, device=cuda)[:nb]
             + 1).to(torch.int32)[None].contiguous()
    st = torch.tensor([1792], dtype=torch.int32, device=cuda)
    en = torch.tensor([2048], dtype=torch.int32, device=cuda)
    got = torch.zeros((2, layers, npg, hk, dh), device=cuda)
    want = torch.zeros_like(got)
    before = tops.LAUNCHES["block_summary"]
    tops.paged_block_summaries(pool, table, st, en, 3, got[0], got[1])
    tref.paged_block_summaries(pool, table, st, en, 3, want[0], want[1])
    torch.cuda.synchronize()
    assert tops.LAUNCHES["block_summary"] == before + 1
    assert torch.equal(got, want) and float(got.abs().sum()) > 0
    assert float(got[:, :, 0].abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_rep7_partial_step_graph_launches_eager_body(cuda, models):
    """qwen2-0.5b (7 query heads per KV head, vocab 151936 tied, QKV
    bias) cut to 2 layers at full width, bf16, on the paged zero-copy
    pool: the Partial step body runs eagerly under the sync check, a
    replayed Partial step launches on the card the kernels an eager
    Partial step launches, name for name, and graph ``generate`` equals
    eager ``generate`` (tokens, modes, K1-K4 launches)."""
    _graph_step_launches(models, "qwen2-0.5b", seed=15)


@pytest.mark.cuda
def test_cuda_rwkv_train_loss_matches_cpu_fp32(cuda):
    """The reduced ``rwkv6-3b`` ``train_loss`` and its gradients on the
    card (the plain chunked WKV under autograd, 299 positions: two
    segments) against the CPU route in fp32: the loss within 1e-5
    relative, each gradient leaf within 1e-3 of its largest magnitude
    (the card's fp32 products and reductions sum in another order than
    the CPU's, and 299 recurrent steps amplify that: the largest gap
    measured on an H100 was 1.3e-4); K5 is not launched."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.trainer import grads_of, trainable, tree_leaves
    cfg = get_config("rwkv6-3b").reduced().replace(dtype="float32",
                                                   param_dtype="float32")
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 300))
    cpu = trainable(api.init_params(cfg, seed=0, device="cpu"))
    for lp in cpu["layers"]:                # exercise u, lora_B, wd_B
        for name in ("u", "lora_B", "wd_B"):
            with torch.no_grad():
                lp[name].copy_(torch.randn(lp[name].shape,
                                           generator=torch.Generator()
                                           .manual_seed(3)) * 0.1)
    card = trainable(tree_map(lambda p, _: p.detach().to(cuda), cpu))
    before = tops.launch_counts()
    out = []
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        loss, _ = api.train_loss(cfg, params, torch.as_tensor(toks,
                                                              device=dev))
        loss.backward()
        out.append((float(loss.detach()),
                    [g.detach().cpu() for g in tree_leaves(grads_of(params))]))
    assert tops.launch_counts() == before
    (lc, gc), (lg, gg) = out
    assert np.isfinite(lg) and abs(lg / lc - 1) < 1e-5
    for a, c in zip(gg, gc):
        scale = c.abs().max().clamp(min=1e-30)
        assert float((a - c).abs().max() / scale) < 1e-3


REGISTRY_SERVE_LAYOUTS = {
    "default": dict(),                                   # ServingConfig()
    "paged": dict(paged_kv=True),
    "zero_copy": dict(paged_kv=True, zero_copy_partial=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-3-2b", "deepseek-7b",
                                  "qwen2-0.5b", "qwen1.5-32b"])
def test_cuda_registry_targets_serve_on_every_layout(cuda, models, name):
    """Each new dense target, cut to 2 layers at full width, bf16, served
    by ``ServingEngine`` on the card on the three layouts (the reference's
    contiguous default, the paged pool gathered and zero-copy), with
    graphs and eagerly: three requests at batch 2 (one past the partial
    budget, so Refresh and Partial steps run; one waits for a slot),
    equal tokens and K1-K4 launch counts between the two, and K1-K4
    launched on every layout."""
    import numpy as np
    from repro_torch.serving import Request, ServingConfig, ServingEngine
    cfg, spec, dcfg, params, dparams = _get_model(models, name)
    case = ((4700, 12), (600, 8), (300, 8))
    for layout, kw in REGISTRY_SERVE_LAYOUTS.items():
        runs = []
        for graphs in (False, True):
            rng = np.random.default_rng(7)
            srv = ServingEngine(cfg, spec, dcfg, params, dparams,
                                ServingConfig(batch=2, max_len=5120, **kw),
                                device="cuda", cuda_graphs=graphs)
            for i, (n, new) in enumerate(case):
                srv.submit(Request(request_id=f"r{i}", max_new_tokens=new,
                                   prompt=rng.integers(0, cfg.vocab_size,
                                                       (n,))))
            tops.reset_launch_counts()
            srv.run()
            torch.cuda.synchronize()
            runs.append((srv, tops.launch_counts()[0]))
            del srv
        (eager, ec), (graph, gc) = runs
        for i, (_, new) in enumerate(case):
            a, b = eager.outputs[f"r{i}"].tokens, graph.outputs[f"r{i}"].tokens
            assert len(a) == new and np.array_equal(a, b), (layout, i)
        assert gc == ec, layout
        assert all(ec[k] > 0 for k in (
            "sparse_verify_attention", "paged_prefill_attention",
            "retrieval_score", "block_summary")), (layout, ec)
        assert graph._continuous.engine._graphs, layout
        del eager, graph
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_captures_share_one_warmup_stream(cuda):
    """Every capture warms up on one side stream per device: cuBLAS keeps
    a workspace (32 MiB on the H100) for each stream it ran on, so a new
    stream per capture held 32 MiB more after each (about 1 GiB over the
    smoke's phases 2-14).  Four more captures of a GEMM body, their
    graphs dropped, leave less than one workspace behind."""
    import gc
    from repro_torch.core.engine import _warmup_stream, capture_graph
    assert _warmup_stream(cuda) is _warmup_stream(cuda)
    x = torch.randn((256, 256), device=cuda, dtype=torch.bfloat16)
    out = torch.empty_like(x)

    def body():
        out.copy_(x @ x)
    capture_graph(body, cuda, [], None).replay()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    for _ in range(4):
        g = capture_graph(body, cuda, [], None)
        g.replay()
        del g
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() - base < 32 * 2**20
    assert torch.equal(out, x @ x)


# ---------------------------------------------------------------------------
# VLM and audio: K4 at their widths, per-request cross rows under graphs
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("layers, hk, dh", [(28, 8, 128), (12, 12, 64)],
                         ids=["llama-3.2-vision-90b", "whisper-small"])
def test_cuda_paged_summaries_vlm_audio_widths(cuda, layers, hk, dh):
    """K4's paged form over every attention layer of the VLM at 35
    layers (28 with self-attention, Hk 8) and of whisper-small (12, Hk
    12, Dh 64), the last chunk of an 8192-token prompt, bf16, against
    its plain version bit for bit; the null page stays 0."""
    g = torch.Generator(device=cuda)
    g.manual_seed(90 + hk)
    npg, bs, nb = 70, 128, 66
    pool = torch.randn((layers, npg, bs, hk, dh), generator=g,
                       device=cuda).bfloat16()
    table = (torch.randperm(npg - 1, generator=g, device=cuda)[:nb]
             + 1).to(torch.int32)[None].contiguous()
    st = torch.tensor([7936], dtype=torch.int32, device=cuda)
    en = torch.tensor([8192], dtype=torch.int32, device=cuda)
    got = torch.zeros((2, layers, npg, hk, dh), device=cuda)
    want = torch.zeros_like(got)
    before = tops.LAUNCHES["block_summary"]
    tops.paged_block_summaries(pool, table, st, en, 3, got[0], got[1])
    tref.paged_block_summaries(pool, table, st, en, 3, want[0], want[1])
    torch.cuda.synchronize()
    assert tops.LAUNCHES["block_summary"] == before + 1
    assert torch.equal(got, want) and float(got.abs().sum()) > 0
    assert float(got[:, :, 0].abs().max()) == 0.0


def _xattn_serve(model, graphs, reqs, new, mesh=None):
    """Two slots of a cross-attention target, each admitted with its own
    ``extra`` (the second while the first decodes), stepped to the end
    on the paged zero-copy pool (over ``mesh`` when given); returns each
    request's tokens and the engine."""
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    cfg, spec, dcfg, params, dparams = model
    max_len = request_token_need(max(len(p) for p, _ in reqs), new,
                                 spec.buffer_size, dcfg.tree_depth + 1)
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=2,
                       max_len=max_len, paged=True, zero_copy=True,
                       prefix_cache=False, device="cuda", cuda_graphs=graphs,
                       mesh=mesh)
    st = eng.empty_state()
    out = {0: [], 1: []}

    def tick():
        nonlocal st
        rows = np.asarray([0 < len(out[i]) < new for i in (0, 1)])
        st, so = eng.step_fused(st, rows, eng.modes_for_rows(st, rows))
        for i in np.nonzero(rows)[0]:
            out[i].extend(so.tokens[i, :so.counts[i]].tolist())
    for i, (p, ex) in enumerate(reqs):
        st, first = eng.prefill_into_slot(st, i, p, extra=ex,
                                          max_new_tokens=new)
        out[i].append(first)
        for _ in range(2):
            tick()
    while min(len(v) for v in out.values()) < new:
        tick()
    return [np.asarray(out[i][:new]) for i in (0, 1)], eng


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["whisper-small", "llama-3.2-vision-90b"])
def test_cuda_cross_rows_follow_the_slot_in_graphs(cuda, models, name):
    """A cross-attention target at full width and 2 layers (whisper's two
    ``dec`` layers; the VLM's (attn, cross), a cross layer every 2nd),
    gates set, bf16: two requests with different ``extra`` served with
    graphs equal the same served eagerly, and the second equals its solo
    ``generate``: the slot prefill graph replays for the second slot
    over its own cross rows, which are written in place."""
    import numpy as np
    from repro_torch.models import api
    key = f"{name}-xattn"
    if key not in models:
        models.clear()
        torch.cuda.empty_cache()
        cfg, spec, dcfg, params, dparams = _model(cuda, name)
        if cfg.arch_type == "vlm":
            cfg = cfg.replace(cross_attn_every=2)
            from repro_torch.models.api import init_params
            params = init_params(cfg, seed=0, device=cuda)
        for lp in params["layers"]:
            for gname in ("gate_attn", "gate_mlp"):
                if gname in lp:
                    lp[gname].fill_(0.5)
        models[key] = (cfg, spec, dcfg, params, dparams)
    model = models[key]
    cfg = model[0]
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64),
             api.extra_inputs_for(cfg, 1, seed=20 + i, device=cuda))
            for i, n in enumerate((600, 900))]
    got, eng = _xattn_serve(model, True, reqs, 12)
    assert any("fused_prefill" in str(k) for k in eng._graphs)
    want, _ = _xattn_serve(model, False, reqs, 12)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    spec, dcfg = model[1], model[2]
    solo = SpecPVEngine(*model, batch=1, max_len=request_token_need(
        900, 12, spec.buffer_size, dcfg.tree_depth + 1), paged=True,
        zero_copy=True, prefix_cache=False, device="cuda")
    toks, _ = solo.generate(reqs[1][0][None], 12, extra=reqs[1][1])
    np.testing.assert_array_equal(got[1], toks[0])


# ---------------------------------------------------------------------------
# context-parallel verification: the shard call forms, windowed stacks
# ---------------------------------------------------------------------------

def _shard_case(dev, dtype, *, s_loc=8192, t=8, h=32, hk=32, dh=128,
                seed=11):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.randn((1, t, h, dh), generator=g, device=dev).to(dtype)
    k = torch.randn((1, s_loc, hk, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((1, s_loc, hk, dh), generator=g, device=dev).to(dtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [8192 + 5000, 3 * 8192, 100])
def test_cuda_cp_full_shard_form_matches_plain(cuda, dtype, length):
    """K1's contiguous form on rank 1's shard of 8192 tokens at
    deepseek-7b's heads (32/32, Dh 128): the shard's valid length is the
    global one less the shard offset, clamped (partly filled, full,
    empty); one launch, against the plain version over the same blocks."""
    from repro_torch.distributed import local_full_partials
    q, k, v = _shard_case(cuda, TDT[dtype])
    bs = 128
    length_t = torch.tensor([length], dtype=torch.int32, device=cuda)
    before = tops.LAUNCHES["sparse_verify_attention"]
    got = local_full_partials(q, k, v, length_t, 1, bs)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["sparse_verify_attention"] == before + 1
    local = torch.clamp(length_t - 8192, 0, 8192)
    idx, vlen = tops._identity_walk(1, 32, 8192 // bs, local, 8192, bs)
    want = tref.block_attention_batched(q, k.reshape(-1, 32, 128),
                                        v.reshape(-1, 32, 128), idx, vlen, bs)
    _assert_partials_close(got, want)
    if length <= 8192:
        assert torch.all(got[0] == -1e30) and torch.all(got[1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_cp_partial_shard_form_matches_plain(cuda, dtype):
    """A shard's retrieval: K3 over its 64 block summaries with unit
    weights against the plain scores, the selection (top 16 of the blocks
    holding valid tokens) equal to the plain scores' selection, and K1's
    block-list form over it against the plain version; one launch each."""
    from repro_torch.configs import SpecPVConfig
    from repro_torch.distributed import local_partial_partials
    spec = SpecPVConfig()
    q, k, v = _shard_case(cuda, TDT[dtype])
    bs, nb = spec.block_size, 8192 // spec.block_size
    kb = k.float().reshape(1, nb, bs, 32, 128)
    kmax, kmin = kb.amax(dim=2).contiguous(), kb.amin(dim=2).contiguous()
    length = torch.tensor([8192 + 6000], dtype=torch.int32, device=cuda)
    before = tops.launch_counts()
    m, l, acc, idx = local_partial_partials(spec, 16, q, k, v, kmax, kmin,
                                            length, 1)
    torch.cuda.synchronize()
    runs = tops.launch_count_delta(before, tops.launch_counts())[0]
    assert runs == {"sparse_verify_attention": 1, "retrieval_score": 1}
    got_s = tops.retrieval_scores(q, kmax, kmin, torch.ones(
        (1, 8), dtype=torch.float32, device=cuda))
    want_s = tref.retrieval_score_batched(q, kmax, kmin, torch.ones(
        (1, 8), dtype=torch.float32, device=cuda))
    _assert_close(got_s, want_s)
    valid = torch.arange(nb, device=cuda) * bs + 8192 < length
    masked = torch.where(valid[None, None], want_s,
                         torch.full_like(want_s, -float("inf")))
    want_idx = torch.sort(masked, dim=-1, descending=True,
                          stable=True).indices[..., :16]
    assert torch.equal(idx, want_idx)
    n_valid = torch.clamp(length - 8192 - torch.arange(nb, device=cuda) * bs,
                          0, bs)
    vlen = n_valid[idx].to(torch.int32)
    want = tref.block_attention_batched(q, k.reshape(-1, 32, 128),
                                        v.reshape(-1, 32, 128),
                                        idx.to(torch.int32), vlen, bs)
    _assert_partials_close((m, l, acc), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_k1_pool_past_2_31_elements(cuda, dtype):
    """K1 over a pool of just over 2^31 elements (4097 blocks of 128 x 32
    x 128), reading its last blocks: every offset into the pool is 64-bit
    in the kernel, so the far end reads right against the plain version."""
    from repro_torch.configs import SpecPVConfig
    bs, hk, dh = SpecPVConfig().block_size, 32, 128
    npg = (1 << 31) // (bs * hk * dh) + 1
    assert npg * bs * hk * dh > 1 << 31
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    kf = torch.empty((npg * bs, hk, dh), dtype=TDT[dtype], device=cuda)
    vf = torch.empty_like(kf)
    kf[-4 * bs:].copy_(torch.randn((4 * bs, hk, dh), generator=g,
                                   device=cuda))
    vf[-4 * bs:].copy_(torch.randn((4 * bs, hk, dh), generator=g,
                                   device=cuda))
    q = torch.randn((1, 8, 32, dh), generator=g, device=cuda).to(TDT[dtype])
    idx = torch.arange(npg - 4, npg, dtype=torch.int32, device=cuda)
    idx = idx[None, None].expand(1, hk, 4).contiguous()
    vlen = torch.full((1, hk, 4), bs, dtype=torch.int32, device=cuda)
    vlen[..., -1] = 77
    got = tops.block_attention(q, kf, vf, idx, vlen, bs)
    want = tref.block_attention_batched(q, kf, vf, idx, vlen, bs)
    _assert_partials_close(got, want)


@pytest.mark.cuda
def test_cuda_windowed_graphs_equal_eager(cuda, models):
    """llama3.1-8b at full width and 2 layers with ``window_size=1024``
    (set by ``replace``), a 2304-token prompt (nine chunks, the window
    shorter than the prompt): ``generate`` with graphs equals eager token
    for token with the same launch counts, and the windowed prefill makes
    no K2 launch."""
    import numpy as np
    cfg, spec, dcfg, params, dparams = _get_model(models, "llama3.1-8b")
    model = (cfg.replace(window_size=1024), spec, dcfg, params, dparams)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 2304)).astype(np.int64)
    runs = []
    for graphs in (False, True):
        eng = _engine(model, 2304, 16, cuda_graphs=graphs)
        tops.reset_launch_counts()
        toks, stats = eng.generate(prompt, 16)
        torch.cuda.synchronize()
        runs.append((toks, stats["modes"], tops.launch_counts()))
    (et, em, ec), (gt, gm, gc) = runs
    np.testing.assert_array_equal(gt, et)
    assert gm == em and gc == ec
    assert ec[0]["paged_prefill_attention"] == 0
    assert ec[0]["sparse_verify_attention"] > 0


# ---------------------------------------------------------------------------
# launch steps and the int8 resident decode cache
# ---------------------------------------------------------------------------

_LAUNCH_SPEC = dict(block_size=16, num_sink_blocks=1,
                    retrieval_budget_blocks=4, local_window_blocks=2,
                    buffer_size=48)


def _small_case(name, dev, steps=3, seed=0):
    """A hillclimb case at a small shape on ``dev``: tiny-dense (fp32,
    Dh 64) with a block of 16."""
    from repro_torch.configs import SpecPVConfig
    from repro_torch.launch import hillclimb as hc
    spec = SpecPVConfig(**_LAUNCH_SPEC)
    kw = dict(device=dev, spec=spec, steps=steps, seed=seed)
    if name == "A0":
        return hc.build_verify_case("tiny-dense", partial=False, int8=False,
                                    batch=2, seq=300, **kw)
    if name in ("A1", "A2"):
        return hc.build_verify_case("tiny-dense", partial=True,
                                    int8=name == "A2", batch=2, seq=300,
                                    **kw)
    if name == "B1":
        return hc.build_int8_decode_case("tiny-dense", "decode_32k",
                                         batch=2, seq=300, **kw)
    if name == "C1":
        return hc.build_int8_decode_case("tiny-dense", "long_500k",
                                         seq=2000, **kw)
    return hc.build_cp_retrieval_case("tiny-dense", seq=2048, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["A0", "A1", "A2", "B1", "C1", "D1"])
def test_cuda_hillclimb_graph_equals_eager(cuda, name):
    """Each hillclimb case at a small shape: three steps eagerly (each
    under the sync check), then the same steps from the same state
    replayed as a CUDA graph, equal bit for bit in tokens and written
    state (``run_built`` asserts it)."""
    from repro_torch.launch import hillclimb as hc
    res = hc.run_built(_small_case(name, cuda), steps=3, device=cuda)
    assert res["graph_equals_eager"]
    assert len(res["graph_ms"]) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["full", "partial", "state"])
def test_cuda_launch_decode_steps_are_sync_free(cuda, kind):
    """``launch.steps``: a prefill step, then decode steps whose bodies
    run under ``torch.cuda.set_sync_debug_mode("error")`` (tiny-dense;
    the reduced rwkv6-3b for the state arch)."""
    from repro_torch.configs import SpecPVConfig, get_config
    from repro_torch.launch import steps as st
    from repro_torch.models import api
    spec = SpecPVConfig(**_LAUNCH_SPEC)
    cfg = (get_config("rwkv6-3b").reduced() if kind == "state"
           else get_config("tiny-dense"))
    params = api.init_params(cfg, seed=0, device=cuda)
    cache = api.init_cache(cfg, 2, 320, spec, device=cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (2, 160), generator=g,
                           device=cuda)
    tok, _ = st.make_prefill_step(cfg, spec)(params, cache, prompt, None)
    step = st.make_decode_step(cfg, spec, partial=kind == "partial")
    args = (params, cache)
    if kind == "partial":
        sel = api.decode(cfg, params, tok[:, None], cache["length"][:, None],
                         cache, mode="full", spec=spec,
                         select_partial=True).partial
        args = args + st.partial_state(spec, sel)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            out = step(*args, tok)
            tok = out[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out[1] is cache
    assert int(cache["length"][0]) == 160 + (0 if kind == "partial" else 3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["B1", "C1"])
def test_cuda_int8_step_matches_cpu(cuda, name):
    """An fp32 int8 decode step on the card against the same step on the
    CPU, from the same state (built on the CPU, copied to the card): the
    step's logits within 1e-4 of the largest and its next token equal
    (each device steps its own copy of the state)."""
    from repro_torch.models import api

    def to(obj, dev):
        if torch.is_tensor(obj):
            return obj.to(dev, copy=True)
        if isinstance(obj, dict):
            return {k: to(v, dev) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(to(v, dev) for v in obj)
        return obj
    case = _small_case(name, torch.device("cpu"), steps=1)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        args = to(case.args, dev)
        params, cache, tok = args[0], args[1], args[-1]
        from repro_torch.configs import get_config
        cfg = get_config("tiny-dense")
        pkv = args[2] if name == "C1" else None
        pos = (cache["length"] + (args[3] if name == "C1" else 0))[:, None]
        o = api.decode(cfg, params, tok[:, None].long(), pos, cache,
                       mode="partial" if pkv is not None else "full",
                       pkv=pkv)
        nxt = case.fn(*args)[0]
        outs.append((o.logits.cpu(), nxt.cpu()))
    (lc, tc), (lg, tg) = outs
    _assert_close(lg, lc)
    assert torch.equal(tg, tc)


# ---------------------------------------------------------------------------
# tensor parallelism: one model shard of llama3.1-8b on two (H 16, Hk 4,
# Dh 128: rep 4 at Dh 128, a call form no registry id launches)
# ---------------------------------------------------------------------------

TP_SHARD = (16, 4, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ATTN_FORMS)
def test_cuda_tp_shard_attention_call_forms(cuda, form, dtype):
    """Every K1/K2 call form at one tensor-parallel shard's heads of
    llama3.1-8b (H 16, Hk 4, Dh 128) against the plain version of the
    same launch; a second call gives the same bits."""
    h, hk, dh = TP_SHARD
    seed = 70 + ATTN_FORMS.index(form)
    got, want = _group_attention(cuda, TDT[dtype], h, hk, dh, form, seed)
    torch.cuda.synchronize()
    _assert_partials_close(got, want)
    again, _ = _group_attention(cuda, TDT[dtype], h, hk, dh, form, seed)
    for a, c in zip(got, again):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_tp_shard_scores_and_summaries(cuda):
    """K3 at one shard's heads for a Refresh (T=156 over 66 blocks), two
    calls bit-equal and within tolerance of the plain version; K4's
    paged form over the shard-stacked pool of both shards' 32 layers (64
    entries at Hk 4, one launch) bit for bit, the null page left at 0."""
    h, hk, dh = TP_SHARD
    q, kmax, kmin, qw = _score_case(cuda, torch.bfloat16, 1, 156, h, hk, dh,
                                    66, 71)
    got = tops.retrieval_scores(q, kmax, kmin, qw)
    assert torch.equal(got, tops.retrieval_scores(q, kmax, kmin, qw))
    _assert_close(got, tref.retrieval_score_batched(q, kmax, kmin, qw))
    g = torch.Generator(device=cuda)
    g.manual_seed(72)
    layers, npg, bs, nb = 64, 70, 128, 66
    pool = torch.randn((layers, npg, bs, hk, dh), generator=g,
                       device=cuda).bfloat16()
    table = (torch.randperm(npg - 1, generator=g, device=cuda)[:nb]
             + 1).to(torch.int32)[None].contiguous()
    st = torch.tensor([7936], dtype=torch.int32, device=cuda)
    en = torch.tensor([8192], dtype=torch.int32, device=cuda)
    got4 = torch.zeros((2, layers, npg, hk, dh), device=cuda)
    want4 = torch.zeros_like(got4)
    before = tops.LAUNCHES["block_summary"]
    tops.paged_block_summaries(pool, table, st, en, 3, got4[0], got4[1])
    tref.paged_block_summaries(pool, table, st, en, 3, want4[0], want4[1])
    torch.cuda.synchronize()
    assert tops.LAUNCHES["block_summary"] == before + 1
    assert torch.equal(got4, want4) and float(got4.abs().sum()) > 0
    assert float(got4[:, :, 0].abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_tp_graphs_equal_eager(cuda, models):
    """2-layer llama at full width on a (1, 2) mesh of two ``cuda:0``
    model shards, paged zero-copy: ``generate`` with graphs equals it
    eagerly token for token with equal K1-K4 launches (K1-K3 twice per
    layer, one K4 per chunk and commit over both shards' layers); the
    eager Partial body runs under the sync check."""
    import numpy as np
    from repro_torch.core.engine import (MODE_IDS, SpecPVEngine,
                                         request_token_need)
    from repro_torch.distributed.sharding import make_mesh
    cfg, spec, dcfg, params, dparams = _get_model(models, "llama3.1-8b")
    prompt_len, new = 35 * 128 - 6, 24
    prompt = np.random.default_rng(73).integers(
        0, cfg.vocab_size, (1, prompt_len)).astype(np.int64)
    max_len = request_token_need(prompt_len, new, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    runs = []
    for graphs in (False, True):
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=max_len, paged=True, zero_copy=True,
                           device="cuda", cuda_graphs=graphs,
                           mesh=make_mesh((1, 2), devices=["cuda:0"] * 2))
        assert eng.tp.m == 2 and eng.kv_shards == 2
        tops.reset_launch_counts()
        toks, stats = eng.generate(prompt, new)
        torch.cuda.synchronize()
        counts = tops.launch_counts()[0]
        if not graphs:
            eng._rows.fill_(True)
            eng._modes.fill_(MODE_IDS["partial"])
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng._fused_body(False, True, False)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        runs.append((toks, stats, counts))
    (et, es, ec), (gt, gs, gc) = runs
    assert np.array_equal(gt, et) and gs["modes"] == es["modes"]
    assert gc == ec
    chunks = -(-prompt_len // 256)
    refresh = es["modes"].get("refresh", 0)
    commits = refresh + es["modes"].get("full", 0)
    assert refresh and es["modes"].get("partial")
    assert {k: ec[k] for k in ("sparse_verify_attention",
                               "paged_prefill_attention", "retrieval_score",
                               "block_summary")} == {
        "sparse_verify_attention": 2 * 2 * es["steps"],
        "paged_prefill_attention": 2 * 2 * chunks,
        "retrieval_score": 2 * 2 * refresh,
        "block_summary": chunks + commits}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tiny-dense", "granite-moe-1b-a400m"])
def test_cuda_tp_collectives_across_devices(cuda, arch):
    """Tensor parallelism's cross-device form, with model shard 0 on the
    card and shard 1 on the CPU: ``all_reduce`` / ``all_gather`` give
    every device the same bits (shards on one device share one result),
    and the split MLP or MoE (reduced granite: experts split, tied head),
    the embedding, the head and the draft's inputs equal the unsplit
    blocks on the card within 1e-4 of their largest magnitude (fp32, TF32
    off).  Attention, whose per-head state is one shard-stacked tensor,
    runs with every shard on one device."""
    from repro_torch import configs as tcfgs
    from repro_torch.core import draft as tdr
    from repro_torch.distributed.tensor_parallel import (TensorParallel,
                                                         all_gather,
                                                         all_reduce)
    from repro_torch.models import api as tapi
    from repro_torch.models import dense as tdn
    from repro_torch.train.optimizer import tree_leaves
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(74)
    parts = [torch.randn((3, 5), generator=g).to(d)
             for d in (cuda, cpu, cuda)]
    for out in (all_reduce(parts), all_gather(parts, 1)):
        assert [o.device.type for o in out] == ["cuda", "cpu", "cuda"]
        assert out[0] is out[2] and torch.equal(out[0].cpu(), out[1])
    cfg = tcfgs.get_config(arch)
    cfg = (cfg if arch == "tiny-dense" else cfg.reduced()).replace(
        dtype="float32", param_dtype="float32")
    params = tapi.init_params(cfg, 0, cuda)
    dparams = tdr.init_draft_params(cfg, tcfgs.DraftConfig(), 1, cuda)
    tp = TensorParallel(cfg, params, [cuda, cpu],
                        draft=(tdr.draft_model_config(cfg), dparams))
    assert tp.embed_split and tp.draft.fuse_split
    assert (tp.moe_split if cfg.num_experts else tp.mlp_split)
    assert all(t.device == cpu for sp in (tp, tp.draft)
               for t in tree_leaves(sp.shards[1].params))
    h = torch.randn((2, 7, cfg.d_model), generator=g).to(cuda)
    lp = params["layers"][0]
    toks = torch.randint(0, cfg.vocab_size, (2, 7), generator=g).to(cuda)
    feats = torch.randn((2, 7, 3 * cfg.d_model), generator=g).to(cuda)
    assert torch.equal(tdn.embed_tokens(cfg, params, toks, tp),
                       tdn.embed_tokens(cfg, params, toks))
    for got, want in (
            (tdn._mlp_or_moe_tp(tp, 0, lp, h), tdn._mlp_or_moe(cfg, lp, h)[0]),
            (tdn.lm_head(cfg, params, h, tp), tdn.lm_head(cfg, params, h)),
            (tdr._draft_inputs(cfg, dparams, params["embed"], toks, feats,
                               tp.draft),
             tdr._draft_inputs(cfg, dparams, params["embed"], toks, feats))):
        assert got.device.type == "cuda"
        _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [6, 256])
def test_cuda_tp_wkv_at_shard_heads_matches_plain(cuda, t):
    """K5 at one tensor-parallel shard's heads (rwkv6-3b's 40 over two
    model shards: H 20, dk 64), fp32, a full and a padded row, the
    update and the read-only form; ``ops.WKV_HEADS`` counts both at H
    20."""
    b = 2
    r, k, v, w, u, s0 = _wkv_inputs(cuda, b, t, 5, h=20)
    n_valid = torch.tensor([t, t // 2], dtype=torch.int32, device=cuda)
    before = dict(tops.WKV_HEADS)
    y, s = tops.wkv(r, k, v, w, u, s0, n_valid)
    y_ro, s_ro = tops.wkv(r, k, v, w, u, s0, n_valid, update=False)
    torch.cuda.synchronize()
    assert tops.WKV_HEADS[20] == before.get(20, 0) + 2
    want_y, want_s = tref.wkv_batched(r, k, v, w, u, s0, n_valid)
    _assert_close(y, want_y)
    _assert_close(s, want_s)
    assert torch.equal(y_ro, y) and s_ro is s0


def _family_model(dev, name, layers):
    """``name`` at full width and ``layers`` layers, random bf16 weights
    (the VLM's and Whisper's gates set), with its spec and draft
    config."""
    from repro_torch.configs import DraftConfig, SpecPVConfig, get_config
    from repro_torch.core.draft import init_draft_params
    from repro_torch.models.api import init_params
    cfg = get_config(name).replace(num_layers=layers)
    if cfg.arch_type == "vlm":
        cfg = cfg.replace(cross_attn_every=2)
    spec = (SpecPVConfig(use_pallas=True, score_mode="paper",
                         reduction="mean") if cfg.is_attention_arch
            else SpecPVConfig())
    dcfg = DraftConfig()
    params = init_params(cfg, seed=0, device=dev)
    for lp in params["layers"]:
        for gname in ("gate_attn", "gate_mlp"):
            if gname in lp:
                lp[gname].fill_(0.5)
    return (cfg, spec, dcfg, params,
            init_draft_params(cfg, dcfg, seed=1, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("name, layers", [("rwkv6-3b", 2),
                                          ("recurrentgemma-2b", 3)])
def test_cuda_tp_state_step_graph_equals_eager(cuda, models, name, layers):
    """A state arch at full width on a (1, 2) mesh of two ``cuda:0``
    model shards (rwkv6-3b: K5 at 20 heads per shard; Griffin: one
    (rec, rec, attn) superblock, the recurrence split by columns, the
    local attention whole): ``generate`` with graphs (one ``"state"``
    graph, one prefill chunk graph) equals it eagerly bit for bit, the
    tokens, the launch counts and every state tensor; the eager state
    body runs under the sync check."""
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.distributed.sharding import make_mesh
    key = f"{name}-tp"
    if key not in models:
        models.clear()
        torch.cuda.empty_cache()
        models[key] = _family_model(cuda, name, layers)
    cfg, spec, dcfg, params, dparams = models[key]
    prompt = np.random.default_rng(75).integers(
        0, cfg.vocab_size, (1, 600)).astype(np.int64)
    runs = []
    for graphs in (False, True):
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=1024, paged=False, device="cuda",
                           cuda_graphs=graphs,
                           mesh=make_mesh((1, 2), devices=["cuda:0"] * 2))
        assert eng.tp.m == 2 and eng.kv_shards == 2
        tops.reset_launch_counts()
        toks, stats = eng.generate(prompt, 16)
        torch.cuda.synchronize()
        counts = tops.launch_counts()
        state = {k: v.clone() for k, v in eng.state.cache.items()}
        if not graphs:
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng._state_body()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            assert set(eng._graphs) == {("prefill", 256), "state"}
        runs.append((toks, stats, counts, state))
    (et, es, ec, est), (gt, gs, gc, gst) = runs
    assert np.array_equal(gt, et) and gs["modes"] == es["modes"]
    assert gc == ec
    assert all(torch.equal(gst[k], est[k]) for k in est)
    if cfg.arch_type == "ssm":
        calls = cfg.num_layers * 2 * (3 + 2 * es["steps"])
        assert ec[0]["wkv"] == calls and ec[2] == {20: calls}
    else:
        assert sum(ec[0].values()) == 0


@pytest.mark.cuda
def test_cuda_tp_cross_rows_per_shard(cuda, models, monkeypatch):
    """whisper-small at full width and 2 layers on a (1, 2) mesh of two
    ``cuda:0`` model shards: two requests with different ``extra``, each
    admitted into a slot, write their cross rows once per request (one
    ``api.write_cross`` each), at each shard's 6 KV heads; the rows put
    side by side equal the unsharded engine's within 1e-4 of their
    largest magnitude, and serving with graphs equals serving eagerly."""
    import numpy as np
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.distributed.tensor_parallel import merge_heads
    from repro_torch.models import api
    key = "whisper-small-tp"
    if key not in models:
        models.clear()
        torch.cuda.empty_cache()
        models[key] = _family_model(cuda, "whisper-small", 2)
    model = models[key]
    cfg = model[0]
    rng = np.random.default_rng(76)
    reqs = [(rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64),
             api.extra_inputs_for(cfg, 1, seed=30 + i, device=cuda))
            for i, n in enumerate((700, 300))]
    calls = []
    write = api.write_cross
    monkeypatch.setattr(api, "write_cross",
                        lambda *a, **kw: (calls.append(1), write(*a, **kw)))
    mesh = make_mesh((1, 2), devices=["cuda:0"] * 2)
    outs, rows = [], []
    for graphs, m in ((False, mesh), (True, mesh), (False, None)):
        calls.clear()
        toks, eng = _xattn_serve(model, graphs, reqs, 16, mesh=m)
        assert len(calls) == 2
        ck = eng.state.cache["cross_k"]
        if m is not None:
            assert ck.shape[0] == 2 * 2 and ck.shape[3] == 6
            ck = merge_heads(ck, 2, 0, 3)
        outs.append(toks)
        rows.append(ck.float())
    assert all(np.array_equal(a, b) for a, b in zip(outs[0], outs[1]))
    assert torch.equal(rows[0], rows[1])
    _assert_close(rows[0], rows[2])
