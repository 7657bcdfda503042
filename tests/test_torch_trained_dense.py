"""The port's SpecPV engine on the trained ``tiny-dense`` pair, against the
JAX engine, on the CPU: acceptance parity.

With random weights the draft is almost never accepted, so the engine
tests elsewhere barely run multi-token commits.  Here the target and the
EAGLE-3 draft are the reference's trained checkpoints
(``repro.artifacts.get_trained_pair``: trained in-process on the CPU at
first use, then cached under ``results/artifacts/``), converted with
``repro_torch.convert``; fp32, batch 2, a 160-token prompt, 24 new
tokens, the conftest ``small_spec`` with the draft config the pair was
trained with.

* Paged zero-copy ``generate`` with partial verification: the port's
  tokens, modes and ``mean_accept`` equal the JAX engine's, and
  ``mean_accept`` is above 1 (drafts are accepted).
* With full verification: the port's tokens equal the JAX engine's and
  the port's own autoregressive decoding, again with ``mean_accept``
  above 1.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.artifacts import get_trained_pair
from repro.core import SpecPVEngine as JEngine
from repro_torch import configs as tcfgs
from repro_torch.convert import draft_params_from_numpy, params_from_numpy
from repro_torch.core.engine import SpecPVEngine as TEngine
from repro_torch.core.reference import autoregressive_generate as t_ar

B, PROMPT, NEW, MAX_LEN, CHUNK = 2, 160, 24, 512, 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only add synchronisation
    when the suite runs several workers per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(small_spec):
    cfg, dcfg, params, dparams = get_trained_pair("tiny-dense")
    tcfg = tcfgs.get_config("tiny-dense")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    spec = small_spec.replace(use_pallas=True)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return dict(cfg=cfg, dcfg=dcfg, spec=spec, params=params,
                dparams=dparams, tcfg=tcfg,
                tspec=tcfgs.SpecPVConfig(**dataclasses.asdict(spec)),
                tdcfg=tcfgs.DraftConfig(**dataclasses.asdict(dcfg)),
                tp=params_from_numpy(tcfg, to_np(params), device="cpu"),
                td=draft_params_from_numpy(tcfg, to_np(dparams),
                                           device="cpu"),
                prompt=prompt)


def _engines(p, **kw):
    je = JEngine(p["cfg"], p["spec"], p["dcfg"], p["params"], p["dparams"],
                 batch=B, max_len=MAX_LEN, paged=True, zero_copy=True, **kw)
    te = TEngine(p["tcfg"], p["tspec"], p["tdcfg"], p["tp"], p["td"],
                 batch=B, max_len=MAX_LEN, paged=True, zero_copy=True,
                 device="cpu", **kw)
    return je, te


def test_trained_partial_verification_matches_jax(pair):
    je, te = _engines(pair)
    jtoks, jstats = je.generate(pair["prompt"], NEW, prefill_chunk=CHUNK)
    ttoks, tstats = te.generate(pair["prompt"], NEW, prefill_chunk=CHUNK)
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    assert tstats["modes"] == jstats["modes"]
    assert {"refresh", "partial"} <= set(tstats["modes"])
    assert tstats["mean_accept"] == pytest.approx(jstats["mean_accept"])
    assert tstats["mean_accept"] > 1.0


def test_trained_full_verification_is_lossless(pair):
    je, te = _engines(pair, partial_verification=False)
    jtoks, jstats = je.generate(pair["prompt"], NEW, prefill_chunk=CHUNK)
    ttoks, tstats = te.generate(pair["prompt"], NEW, prefill_chunk=CHUNK)
    tar = t_ar(pair["tcfg"], pair["tp"], pair["prompt"], NEW,
               max_len=MAX_LEN, prefill_chunk=CHUNK, spec=pair["tspec"],
               device="cpu")
    np.testing.assert_array_equal(ttoks, np.asarray(jtoks))
    np.testing.assert_array_equal(ttoks, tar)
    assert tstats["mean_accept"] == pytest.approx(jstats["mean_accept"])
    assert tstats["mean_accept"] > 1.0
