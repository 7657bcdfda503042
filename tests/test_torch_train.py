"""The port's training stack against the JAX package's, on the CPU:
the synthetic corpus, AdamW, the LM loss and its gradients, ``Trainer``,
the EAGLE-3 TTT loss and ``DraftTrainer``, checkpoints, the compiled AR
baseline and the two entry-point twins (``examples/quickstart_torch.py``
and ``benchmarks/bench_table1_speedup_torch.py``).

Inputs are numpy arrays made from a seed; weights cross over with
``repro_torch.convert``.  Everything runs in fp32 on ``tiny-dense``.
Tolerances are stated in each test: the two frameworks round the same
fp32 arithmetic in different orders, so per-step losses agree to about
1e-7 relative and parameters after a few AdamW steps to about 3e-5
absolute; the bounds below leave a margin of a few times that.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DraftConfig as JDraftConfig
from repro.configs import get_config as jget_config
from repro.core.draft import init_draft_params as jinit_draft
from repro.data import SyntheticCorpus as JCorpus
from repro.data import batch_iterator as jbatches
from repro.data import continuation_task as jcontinuation
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro.train.checkpoint import load_checkpoint as jload_checkpoint
from repro.train.draft_train import DraftTrainConfig as JDTC
from repro.train.draft_train import DraftTrainer as JDraftTrainer
from repro.train.draft_train import draft_ttt_loss as jttt_loss
from repro.train.trainer import TrainConfig as JTC
from repro.train.trainer import Trainer as JTrainer
from repro_torch import configs as tcfgs
from repro_torch.convert import (draft_params_from_numpy,
                                 draft_params_to_numpy, params_from_numpy,
                                 params_to_numpy)
from repro_torch.data import SyntheticCorpus, batch_iterator, \
    continuation_task
from repro_torch.models import api as tapi
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.draft_train import (DraftTrainConfig, DraftTrainer,
                                           draft_ttt_loss, target_features)
from repro_torch.train.trainer import (TrainConfig, Trainer, grads_of,
                                       trainable)

ROOT = Path(__file__).resolve().parents[1]
DCFG = dict(tree_depth=3, tree_branch=(2, 2, 1), ttt_steps=3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _max_leaf(fn, a, b):
    return max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(fn, a, b)))


@pytest.fixture(scope="module")
def tiny():
    cfg = jget_config("tiny-dense")
    tcfg = tcfgs.get_config("tiny-dense")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    params = _np(japi.init_params(cfg, jax.random.PRNGKey(0)))
    dparams = _np(jinit_draft(cfg, JDraftConfig(**DCFG),
                              jax.random.PRNGKey(1)))
    return cfg, tcfg, params, dparams


def _corpora():
    kw = dict(vocab_size=512, order=1, branching=4, seed=0)
    return JCorpus(**kw), SyntheticCorpus(**kw)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_corpus_batches_and_continuations_bit_equal():
    """Documents, flat streams, packed batches and continuation pairs are
    bit-equal to the reference's within one process (both seed with the
    same salted string hash), for both Markov orders."""
    for order in (1, 2):
        kw = dict(vocab_size=97, order=order, branching=3, seed=4)
        jc, tc = JCorpus(**kw), SyntheticCorpus(**kw)
        np.testing.assert_array_equal(tc._cand, jc._cand)
        np.testing.assert_array_equal(tc.document(5, 300),
                                      jc.document(5, 300))
        np.testing.assert_array_equal(tc.tokens(9000, seed=2),
                                      jc.tokens(9000, seed=2))
    jc, tc = _corpora()
    jb, tb = jbatches(jc, batch=3, seq_len=40, seed=7), \
        batch_iterator(tc, batch=3, seq_len=40, seed=7)
    for _ in range(3):
        a, b = next(jb), next(tb)
        assert a.shape == b.shape == (3, 41) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for x, y in zip(jcontinuation(jc, batch=2, context_len=100, seed=1),
                    continuation_task(tc, batch=2, context_len=100, seed=1)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_cosine_schedule_matches_jax():
    """Warm-up, cosine and floor: float32 values within 1e-6 relative of
    ``jnp``'s (its cos may round the last bit differently)."""
    for step in range(0, 260, 3):
        want = float(jopt.cosine_schedule(jnp.int32(step), base_lr=3e-4,
                                          warmup=10, total=200))
        got = topt.cosine_schedule(step, base_lr=3e-4, warmup=10, total=200)
        assert isinstance(got, np.float32)
        assert abs(float(got) - want) <= 1e-6 * want, step


def _grads_like(tree, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(a.dtype),
        tree)


def test_clip_by_global_norm_matches_jax(tiny):
    """The global norm and the clipped gradients of the tiny-dense tree
    (clipped, and below the limit) within 1e-6 relative."""
    cfg, tcfg, params, _ = tiny
    g = _grads_like(params, 0, scale=0.01)
    for max_norm in (1.0, 1e6):
        jg, jn = jopt.clip_by_global_norm(_jx(g), max_norm)
        tg, tn = topt.clip_by_global_norm(
            params_from_numpy(tcfg, g, device="cpu"), max_norm)
        assert abs(float(tn) / float(jn) - 1) < 1e-6
        err = _max_leaf(lambda a, b: float(np.abs(a - b).max()
                                            / np.abs(b).max()),
                        params_to_numpy(tcfg, tg), _np(jg))
        assert err < 1e-6, max_norm


def test_adamw_update_matches_jax_and_decays_stacked_norms(tiny):
    """Two AdamW updates of the tiny-dense tree at lr 1e-2 and weight
    decay 0.5: parameters and moments within 1e-6 absolute of JAX's.  The
    reference decays every per-layer norm (stacked [L, d], rank 2) and
    not ``final_norm`` ([d]); the decay moves the norms by lr * wd =
    5e-3, far above the tolerance, so a port that tested its own [d]
    ranks would fail here."""
    cfg, tcfg, params, _ = tiny
    jp, jo = _jx(params), jopt.adamw_init(_jx(params))
    tp = params_from_numpy(tcfg, params, device="cpu")
    to = topt.adamw_init(tp)
    for i in range(2):
        g = _grads_like(params, 10 + i, scale=0.1)
        jp, jo = jopt.adamw_update(jp, _jx(g), jo, lr=1e-2,
                                   weight_decay=0.5)
        tp, to = topt.adamw_update(tp, params_from_numpy(tcfg, g,
                                                         device="cpu"),
                                   to, lr=np.float32(1e-2),
                                   weight_decay=0.5)
    assert to.step == int(jo.step) == 2
    close = lambda a, b: float(np.abs(a - b).max())  # noqa: E731
    assert _max_leaf(close, params_to_numpy(tcfg, tp), _np(jp)) < 1e-6
    assert _max_leaf(close, params_to_numpy(tcfg, to.mu), _np(jo.mu)) < 1e-6
    assert _max_leaf(close, params_to_numpy(tcfg, to.nu), _np(jo.nu)) < 1e-6
    # the decay term itself: JAX without decay differs by ~lr*wd on norms
    jn, _ = jopt.adamw_update(_jx(params), _jx(_grads_like(params, 10,
                                                           scale=0.1)),
                              jopt.adamw_init(_jx(params)), lr=1e-2,
                              weight_decay=0.0)
    jd, _ = jopt.adamw_update(_jx(params), _jx(_grads_like(params, 10,
                                                           scale=0.1)),
                              jopt.adamw_init(_jx(params)), lr=1e-2,
                              weight_decay=0.5)
    norm1 = lambda t: np.asarray(t["decoder"]["slots"][0]["norm1"])  # noqa
    assert np.abs(norm1(jd) - norm1(jn)).min() > 4e-3
    assert np.array_equal(np.asarray(jd["final_norm"]),
                          np.asarray(jn["final_norm"]))


# ---------------------------------------------------------------------------
# loss, gradients and the trainers
# ---------------------------------------------------------------------------

def test_train_loss_and_grads_match_jax(tiny):
    """``train_loss`` and its gradients against ``jax.value_and_grad`` of
    the reference's, fp32, T = 599 (not a multiple of 512: two query
    tiles and two LM-loss chunks, the last ones short): the loss within
    1e-6 relative, each gradient leaf within 1e-4 of its largest
    magnitude."""
    cfg, tcfg, params, _ = tiny
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 600)).astype(np.int32)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: japi.train_loss(cfg, p, jnp.asarray(toks)),
        has_aux=True)(_jx(params))
    tp = trainable(params_from_numpy(tcfg, params, device="cpu"))
    tl, tm = tapi.train_loss(tcfg, tp, torch.as_tensor(toks))
    tl.backward()
    assert abs(float(tl.detach()) / float(jl) - 1) < 1e-6
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    err = _max_leaf(lambda a, b: float(np.abs(a - b).max()
                                        / np.abs(b).max()),
                    params_to_numpy(tcfg, grads_of(tp)), _np(jg))
    assert err < 1e-4


def test_trainer_five_steps_match_jax(tiny):
    """Five ``Trainer`` steps from the same init on the same batches
    (batch 2, sequence 64, warm-up 2): per-step loss, lr and gradient
    norm within 1e-4 relative, and every parameter within 2e-4 absolute
    of JAX's after ``params_to_numpy``; the history has the reference's
    keys.

    The batches are drawn from numpy seed 11, not from the corpus, whose
    documents follow the process's string-hash salt: as in the draft
    trainer's test below, AdamW's first step moves an element whose
    gradient lies within fp32 rounding of zero by about lr either way,
    and on the corpus batches of some salts (``PYTHONHASHSEED=39``) that
    took the largest difference past the bound.  The corpus itself is
    held bit for bit above."""
    cfg, tcfg, params, _ = tiny
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
               for _ in range(5)]
    jt = JTrainer(cfg, JTC(total_steps=5, warmup=2, log_every=1),
                  params=_jx(params))
    jr = jt.fit(iter(batches), steps=5)
    tt = Trainer(tcfg, TrainConfig(total_steps=5, warmup=2, log_every=1),
                 params=params_from_numpy(tcfg, params, device="cpu"),
                 device="cpu")
    tr = tt.fit(iter(batches), steps=5)
    assert len(tr["history"]) == len(jr["history"]) == 5
    for a, b in zip(jr["history"], tr["history"]):
        assert set(a) == set(b)
        for k in ("loss", "lm_loss", "lr", "grad_norm"):
            assert abs(b[k] / a[k] - 1) < 1e-4, (k, a[k], b[k])
    err = _max_leaf(lambda a, b: float(np.abs(a - b).max()),
                    params_to_numpy(tcfg, tt.params), _np(jt.params))
    assert err < 2e-4


def test_draft_ttt_loss_and_trainer_match_jax(tiny):
    """The frozen target's features (one prefill of the whole batch)
    within 1e-4 of their largest magnitude; ``draft_ttt_loss`` and each
    step's loss within 1e-5 relative; three ``DraftTrainer`` steps (batch
    2, sequence 96, TTT steps 3): per-step losses within 1e-4 relative
    and draft parameters within 2e-4 absolute of JAX's.

    The batches are drawn from a numpy seed, not from the corpus, whose
    documents follow the process's string-hash salt: AdamW's first step
    moves a parameter by about lr * g / (|g| + 1e-8), so an element whose
    gradient lies within the frameworks' fp32 rounding (about 5e-8 here)
    of zero moves differently in the two, by up to 2.3e-4 on the corpus
    batches of 3 of 40 salts.  The corpus itself is held bit for bit
    above."""
    cfg, tcfg, params, dparams = tiny
    jd, td = JDraftConfig(**DCFG), tcfgs.DraftConfig(**DCFG)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, cfg.vocab_size, (2, 97)).astype(np.int32)
               for _ in range(4)]
    jt = JDraftTrainer(cfg, jd, _jx(params),
                       JDTC(total_steps=3, warmup=1, log_every=1),
                       dparams=_jx(dparams))
    toks = batches[0][:, :-1]
    jf = np.array(jt._feat(jt.target_params, jnp.asarray(toks)))
    tp = params_from_numpy(tcfg, params, device="cpu")
    tf = target_features(tcfg, tp, torch.as_tensor(toks)).numpy()
    assert np.abs(tf - jf).max() <= 1e-4 * np.abs(jf).max()
    jl, jm = jttt_loss(cfg, jd, _jx(dparams), _jx(params),
                       jnp.asarray(toks), jnp.asarray(jf))
    tl, tm = draft_ttt_loss(tcfg, td, draft_params_from_numpy(
        tcfg, dparams, device="cpu"), tp, torch.as_tensor(toks),
        torch.as_tensor(jf))
    assert abs(float(tl) / float(jl) - 1) < 1e-5
    for k in jm:
        assert abs(float(tm[k]) / float(jm[k]) - 1) < 1e-5, k

    jr = jt.fit(iter(batches[1:]), steps=3)
    tt = DraftTrainer(tcfg, td, params_from_numpy(tcfg, params,
                                                  device="cpu"),
                      DraftTrainConfig(total_steps=3, warmup=1, log_every=1),
                      dparams=draft_params_from_numpy(tcfg, dparams,
                                                      device="cpu"),
                      device="cpu")
    tr = tt.fit(iter(batches[1:]), steps=3)
    for a, b in zip(jr["history"], tr["history"]):
        assert set(a) == set(b)
        for k in ("loss", "ttt_loss_0", "ttt_loss_2", "grad_norm"):
            assert abs(b[k] / a[k] - 1) < 1e-4, (k, a[k], b[k])
    err = _max_leaf(lambda a, b: float(np.abs(a - b).max()),
                    draft_params_to_numpy(tt.dparams), _np(jt.dparams))
    assert err < 2e-4
    assert not any(p.requires_grad for p in jax.tree_util.tree_leaves(
        tt.target_params))


def test_train_loss_refuses_other_architectures():
    """Dense, MoE, RWKV-6, Griffin, VLM and audio targets train
    (``rwkv6-3b``, ``recurrentgemma-2b``, ``llama-3.2-vision-90b`` and
    ``whisper-small`` since they were ported: ``tests/test_torch_rwkv.py``,
    ``tests/test_torch_griffin.py``, ``tests/test_torch_vlm_audio.py``):
    the reduced Griffin's and Whisper's losses are finite near log V; a
    Whisper loss without its ``extra`` raises naming it, and a dense
    target ignores ``extra``, as the reference's does."""
    cfg = tcfgs.get_config("recurrentgemma-2b").reduced()
    loss, metrics = tapi.train_loss(
        cfg, tapi.init_params(cfg, seed=0, device="cpu"),
        torch.arange(40).reshape(2, 20) % cfg.vocab_size)
    assert set(metrics) == {"lm_loss"}
    assert abs(float(loss.detach()) - np.log(cfg.vocab_size)) < 1.0
    cfg = tcfgs.get_config("whisper-small").reduced()
    params = tapi.init_params(cfg, seed=0, device="cpu")
    toks = torch.arange(40).reshape(2, 20) % cfg.vocab_size
    loss, metrics = tapi.train_loss(
        cfg, params, toks,
        extra=tapi.extra_inputs_for(cfg, 2, seed=1, device="cpu"))
    assert set(metrics) == {"lm_loss", "aux_loss"}
    assert abs(float(loss.detach()) - np.log(cfg.vocab_size)) < 1.0
    with pytest.raises(ValueError, match="per-request conditioning"):
        tapi.train_loss(cfg, params, toks)
    dense = tcfgs.get_config("tiny-dense")
    dp = tapi.init_params(dense, seed=0, device="cpu")
    dt = torch.zeros((1, 8), dtype=torch.long)
    assert torch.equal(tapi.train_loss(dense, dp, dt)[0],
                       tapi.train_loss(dense, dp, dt,
                                       extra={"image": None})[0])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_and_reference_reads_it(tiny, tmp_path, dtype):
    """A port checkpoint of target and draft params (fp32, or bf16 stored
    as fp32) loads back bit-equal in the template's dtype, and the
    reference's ``load_checkpoint`` reads it into its own tree, leaf for
    leaf equal to ``params_to_numpy`` of the port's."""
    _, tcfg, params, dparams = tiny
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    cfg = tcfg.replace(param_dtype=dtype, dtype=dtype)
    cast = lambda tree: topt.tree_map(  # noqa: E731
        lambda p, stacked: p.to(dt), tree)
    tp = cast(params_from_numpy(cfg, params, device="cpu"))
    td = cast(draft_params_from_numpy(cfg, dparams, device="cpu"))
    for name, tree, kind in (("t", tp, params), ("d", td, dparams)):
        path = str(tmp_path / f"{name}.npz")
        save_checkpoint(path, cfg, tree, step=7)
        tmpl = topt.tree_map(lambda p, stacked: torch.zeros_like(p), tree)
        back, step = load_checkpoint(path, cfg, tmpl)
        assert step == 7
        for a, b in zip(topt.tree_leaves(back), topt.tree_leaves(tree)):
            assert a.dtype == dt and torch.equal(a, b)
        jt = jax.tree_util.tree_map(
            lambda a: jnp.zeros(a.shape, jnp.dtype(dtype)), kind)
        jback, jstep = jload_checkpoint(path, jt)
        assert jstep == 7
        want = (params_to_numpy(cfg, tree) if name == "t"
                else draft_params_to_numpy(tree))
        assert jax.tree_util.tree_structure(_np(jback)) == \
            jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(jback),
                        jax.tree_util.tree_leaves(want)):
            assert np.array_equal(np.asarray(a).astype(np.float32), b)


# ---------------------------------------------------------------------------
# the compiled AR baseline and the entry points
# ---------------------------------------------------------------------------

def test_compiled_ar_equals_plain_oracle_on_cpu(tiny):
    """``CompiledAR`` (the kernel route: here the kernels' plain versions,
    eagerly) gives the plain oracle's tokens, fp32, block 16, over two
    calls of one decoder."""
    from repro_torch.core.reference import (CompiledAR,
                                            autoregressive_generate)
    _, tcfg, params, _ = tiny
    tp = params_from_numpy(tcfg, params, device="cpu")
    spec = tcfgs.SpecPVConfig(block_size=16)
    prompt = np.random.default_rng(5).integers(0, 512, (2, 90))
    want = autoregressive_generate(tcfg, tp, prompt, 16, max_len=160,
                                   prefill_chunk=32, spec=spec,
                                   device="cpu")
    ar = CompiledAR(tcfg, tp, batch=2, max_len=160, spec=spec,
                    device="cpu")
    for _ in range(2):
        np.testing.assert_array_equal(
            ar.generate(prompt, 16, prefill_chunk=32), want)


def _load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_point_twins_run_on_cpu(tmp_path, monkeypatch):
    """The quickstart twin and the table-1 twin end to end with ``--device
    cpu`` on a pair trained for 2 + 2 steps (cached in a temporary
    directory): the compiled AR equals the plain oracle, full
    verification is lossless, every row of Tab. 1 is there."""
    import repro_torch.artifacts as art
    monkeypatch.setattr(art, "ART_DIR", str(tmp_path / "art"))
    steps = ["--target-steps", "2", "--draft-steps", "2"]
    rows = _load("examples/quickstart_torch.py").main(
        ["--context", "96", "--max-new", "8", "--batch", "1", "--device",
         "cpu", *steps])
    assert set(rows) == {"AR", "SpecPV-full", "SpecPV-part"}
    assert rows["SpecPV-full"]["lossless"]
    res = _load("benchmarks/bench_table1_speedup_torch.py").main(
        ["--quick", "--device", "cpu", "--out", str(tmp_path / "t1.csv"),
         *steps])
    assert res["ar_equal"] == {192: True, 384: True}
    assert [(d["context"], d["method"]) for d in res["details"]] == [
        (c, m) for c in (192, 384)
        for m in ("EAGLE3-full", "SpecPV-64", "SpecPV-128")]
    assert all(d["lossless"] for d in res["details"]
               if d["method"] == "EAGLE3-full")
    assert (tmp_path / "t1.csv").read_text().startswith(
        "context,method,alpha_wall,fwd_reduction,tau,vs_AR")
