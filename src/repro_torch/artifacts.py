"""Trained (target, draft) pairs of the port (counterpart of
``repro/artifacts.py``), with the reference's recipe: on the synthetic
corpus, a target of 200 steps and a draft of 150 at batch 8, sequence
128.

Pairs are trained in-process on ``device`` and cached as checkpoints in
the reference's layout under ``results/artifacts_torch/``, apart from
the JAX package's ``results/artifacts/``, so neither package loads the
other's pairs by accident.  The corpus is seeded with a salted string
hash (``data.pipeline``), so two processes train on different batches
unless ``PYTHONHASHSEED`` is set, and a pair's accept length varies from
one run to the next.
"""
from __future__ import annotations

import os
from typing import Tuple

from repro_torch.configs import DraftConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.draft import init_draft_params
from repro_torch.data import SyntheticCorpus, batch_iterator
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.draft_train import DraftTrainConfig, DraftTrainer
from repro_torch.train.trainer import Trainer, TrainConfig, frozen

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "results",
                       "artifacts_torch")

DEFAULT_DCFG = DraftConfig(tree_depth=3, tree_branch=(2, 2, 1), ttt_steps=3)


def corpus_for(cfg: ModelConfig) -> SyntheticCorpus:
    return SyntheticCorpus(vocab_size=cfg.vocab_size, order=1, branching=4,
                           seed=0)


def get_trained_pair(arch: str = "tiny-dense", *,
                     target_steps: int = 200, draft_steps: int = 150,
                     force: bool = False, device=None) -> Tuple:
    """Returns (cfg, DEFAULT_DCFG, target_params, draft_params) on
    ``device`` (CUDA unless ``"cpu"`` is asked for): loaded from
    ``ART_DIR`` when cached there and not ``force``, else trained (batch
    8, sequence 128) and saved.  The params come back detached from
    autograd.  The reference's ``dcfg``, ``batch``, ``seq_len`` and
    ``yarn_factor`` keywords, which none of its callers passes (and
    which its cache names do not record), are left out."""
    dev = resolve_device(device)
    dcfg, batch, seq_len = DEFAULT_DCFG, 8, 128
    cfg = get_config(arch)
    if cfg.num_layers > 8:
        cfg = cfg.reduced()
    os.makedirs(ART_DIR, exist_ok=True)
    tpath = os.path.join(ART_DIR, f"{cfg.name}_t{target_steps}.npz")
    dpath = os.path.join(ART_DIR,
                         f"{cfg.name}_t{target_steps}_d{draft_steps}.npz")
    corpus = corpus_for(cfg)

    tmpl = api.init_params(cfg, seed=0, device=dev)
    if os.path.exists(tpath) and not force:
        params, _ = load_checkpoint(tpath, cfg, tmpl)
    else:
        tr = Trainer(cfg, TrainConfig(total_steps=target_steps, warmup=10,
                                      log_every=max(target_steps // 4, 1)),
                     params=tmpl, device=dev)
        tr.fit(batch_iterator(corpus, batch=batch, seq_len=seq_len),
               steps=target_steps)
        params = tr.params
        save_checkpoint(tpath, cfg, params, step=target_steps)
    params = frozen(params)

    dtmpl = init_draft_params(cfg, dcfg, seed=1, device=dev)
    if os.path.exists(dpath) and not force:
        dparams, _ = load_checkpoint(dpath, cfg, dtmpl)
    else:
        dtr = DraftTrainer(cfg, dcfg, params,
                           DraftTrainConfig(total_steps=draft_steps,
                                            warmup=10,
                                            log_every=max(draft_steps // 4,
                                                          1)),
                           dparams=dtmpl, device=dev)
        dtr.fit(batch_iterator(corpus, batch=batch, seq_len=seq_len, seed=7),
                steps=draft_steps)
        dparams = dtr.dparams
        save_checkpoint(dpath, cfg, dparams, step=draft_steps)
    return cfg, dcfg, params, frozen(dparams)
