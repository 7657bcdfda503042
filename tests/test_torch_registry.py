"""The rest of the reference's dense registry in the PyTorch port, on the
CPU against the JAX package.

* ``granite-3-2b``, ``deepseek-7b``, ``qwen2-0.5b``, ``qwen1.5-32b`` and
  ``target-100m`` and their ``reduced()`` equal the reference's field for
  field; ``ASSIGNED_ARCHS`` equals the reference's, and the ids the port
  does not run (``configs.NOT_PORTED``) raise NotImplementedError naming
  their ROADMAP item.
* ``SpecPVEngine.generate`` in fp32 with partial verification (the
  conftest ``small_spec`` with ``use_pallas=True``, ``small_dcfg``, a
  160-token prompt past the 112-token budget, 16 new tokens) gives the
  JAX engine's tokens and mode counts, on the reference's default layout
  and the paged zero-copy pool: the reduced ``deepseek-7b`` (multi-head,
  rep 1, untied), the reduced ``qwen1.5-32b`` (multi-head with QKV
  bias) and a rep-7 form of the reduced ``qwen2-0.5b`` (7 query heads
  over 1 KV head of 64, tied, QKV bias).  The JAX init leaves the QKV
  biases at zero; here they get the same random numpy values in both
  packages.  Weights cross over with ``repro_torch.convert``.
* With full verification the port's tokens equal its autoregressive
  decoding.
* ``ServingEngine`` on the reference's ``ServingConfig()`` layout and on
  the paged zero-copy pool serves three requests at batch 2 (one waits
  for a slot), each equal to its batch-1 ``generate`` on that layout.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.core import SpecPVEngine as JEngine
from repro.core.draft import init_draft_params as j_init_draft
from repro.models import api as japi
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.core.reference import autoregressive_generate as t_ar
from repro_torch.serving import Request, ServingConfig, ServingEngine

NEW_ARCHS = ("granite-3-2b", "deepseek-7b", "qwen2-0.5b", "qwen1.5-32b",
             "target-100m")
F32 = dict(dtype="float32", param_dtype="float32")
B, PROMPT, NEW, MAX_LEN, CHUNK = 2, 160, 16, 384, 64
# the reduced forms the engine runs: (arch, replace() on top of reduced())
FORMS = {
    "deepseek-7b": {},
    "qwen1.5-32b": {},
    "qwen2-0.5b-rep7": dict(d_model=448, num_heads=7, num_kv_heads=1),
}
LAYOUTS = {"default": dict(), "zero_copy": dict(paged=True, zero_copy=True)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_field_by_field(arch):
    j, t = jcfgs.get_config(arch), tcfgs.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert j.layer_kinds() == t.layer_kinds()


def test_assigned_archs_and_refusals():
    assert tcfgs.ASSIGNED_ARCHS == jcfgs.ASSIGNED_ARCHS
    assert set(tcfgs.NOT_PORTED) < set(tcfgs.ASSIGNED_ARCHS)
    for arch in tcfgs.ASSIGNED_ARCHS:
        if arch in tcfgs.NOT_PORTED:
            item = tcfgs.NOT_PORTED[arch]
            with pytest.raises(NotImplementedError,
                               match=f"ROADMAP.md queue 1, '{item}'"):
                tcfgs.get_config(arch)
        else:
            assert dataclasses.asdict(tcfgs.get_config(arch)) == \
                dataclasses.asdict(jcfgs.get_config(arch))


def _configs(form):
    arch = form.replace("-rep7", "")
    over = dict(FORMS[form], **F32)
    cfg = jcfgs.get_config(arch).reduced().replace(**over)
    tcfg = tcfgs.get_config(arch).reduced().replace(**over)
    return cfg, tcfg


@pytest.fixture(scope="module", params=list(FORMS))
def model(request, small_spec, small_dcfg):
    form = request.param
    cfg, tcfg = _configs(form)
    np_params = jax.tree_util.tree_map(
        np.asarray, japi.init_params(cfg, jax.random.PRNGKey(0)))
    if cfg.qkv_bias:
        attn = np_params["decoder"]["slots"][0]["attn"]
        rng = np.random.default_rng(3)
        for name in ("bq", "bk", "bv"):
            attn[name] = (rng.normal(size=attn[name].shape) * 0.3).astype(
                np.float32)
    dparams = j_init_draft(cfg, small_dcfg, jax.random.PRNGKey(1))
    spec = small_spec.replace(use_pallas=True)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    je = JEngine(cfg, spec, small_dcfg,
                 jax.tree_util.tree_map(jax.numpy.asarray, np_params),
                 dparams, batch=B, max_len=MAX_LEN, partial_verification=True)
    jtoks, jstats = je.generate(prompt, NEW, prefill_chunk=CHUNK)
    return dict(
        form=form, cfg=cfg, tcfg=tcfg,
        tspec=tcfgs.SpecPVConfig(**dataclasses.asdict(spec)),
        tdcfg=tcfgs.DraftConfig(**dataclasses.asdict(small_dcfg)),
        tp=params_from_numpy(tcfg, np_params, device="cpu"),
        td=draft_params_from_numpy(
            tcfg, jax.tree_util.tree_map(np.asarray, dparams), device="cpu"),
        prompt=prompt, jtoks=np.asarray(jtoks), jstats=jstats)


def test_forms_have_the_head_groups(model):
    t = model["tcfg"]
    rep = t.num_heads // t.num_kv_heads
    want = {"deepseek-7b": (1, False, False), "qwen1.5-32b": (1, True, False),
            "qwen2-0.5b-rep7": (7, True, True)}[model["form"]]
    assert (rep, t.qkv_bias, t.tie_embeddings) == want
    assert t.head_dim_ == 64


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_generate_matches_jax_engine(model, layout):
    m = model
    te = TEngine(m["tcfg"], m["tspec"], m["tdcfg"], m["tp"], m["td"],
                 batch=B, max_len=MAX_LEN, device="cpu", **LAYOUTS[layout])
    toks, stats = te.generate(m["prompt"], NEW, prefill_chunk=CHUNK)
    np.testing.assert_array_equal(toks, m["jtoks"])
    assert stats["modes"] == m["jstats"]["modes"]
    assert {"refresh", "partial"} <= set(stats["modes"])


def test_full_verification_equals_port_ar(model):
    m = model
    te = TEngine(m["tcfg"], m["tspec"], m["tdcfg"], m["tp"], m["td"],
                 batch=B, max_len=MAX_LEN, partial_verification=False,
                 device="cpu")
    toks, stats = te.generate(m["prompt"], NEW, prefill_chunk=CHUNK)
    assert stats["modes"] == {"full": stats["steps"]}
    ar = t_ar(m["tcfg"], m["tp"], m["prompt"], NEW, max_len=MAX_LEN,
              prefill_chunk=CHUNK, spec=m["tspec"], device="cpu")
    np.testing.assert_array_equal(toks, ar)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_served_requests_equal_solo_generate(model, layout):
    m = model
    zc = layout == "zero_copy"
    prompts = {f"r{i}": np.random.default_rng(30 + i).integers(
        0, m["tcfg"].vocab_size, (n,)).astype(np.int32)
        for i, n in enumerate((48, 150, 120))}
    srv = ServingEngine(m["tcfg"], m["tspec"], m["tdcfg"], m["tp"], m["td"],
                        ServingConfig(batch=2, max_len=MAX_LEN,
                                      prefill_chunk=CHUNK, paged_kv=zc,
                                      zero_copy_partial=zc), device="cpu")
    for rid, p in prompts.items():
        srv.submit(Request(rid, p, max_new_tokens=8))
    srv.run()
    solo = TEngine(m["tcfg"], m["tspec"], m["tdcfg"], m["tp"], m["td"],
                   batch=1, max_len=MAX_LEN, device="cpu", **LAYOUTS[layout])
    for rid, p in prompts.items():
        want, _ = solo.generate(p[None], 8, prefill_chunk=CHUNK)
        np.testing.assert_array_equal(srv.outputs[rid].tokens, want[0])
