"""EAGLE-3-style draft training with the training-time-test (TTT)
multi-step loss  L = sum_k alpha^k L_k  (paper eq. (5), App. A);
counterpart of ``repro/train/draft_train.py``.

Step 0 consumes (token embedding, fused target features); step k feeds
the draft layer's own hidden state back as the feature, as inference
does beyond tree level 0, with queries shifted one position per step and
attention over the step-0 keys (EAGLE's approximation).

The target is frozen and only the draft trains.  Its features come from
one ``api.prefill`` of the whole [B, S] batch into a contiguous cache of
S tokens, under ``torch.no_grad()`` (the reference computes them outside
``value_and_grad``): on the card that pass runs the prefill attention
(K2, once per layer) and the block summaries (K4, once), which have no
backward.  The TTT loss runs plain torch under autograd, reusing the
draft's inference pieces (``core.draft._draft_inputs``, ``draft_head``,
``models.blocks``, ``cm.dense_attn_part``), none of which writes in place
into a tensor that autograd saved.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import DraftConfig, ModelConfig
from repro_torch.core import draft as dr
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models import blocks as bk
from repro_torch.models import common as cm
from repro_torch.train.optimizer import adamw_init, cosine_schedule
from repro_torch.train.trainer import (frozen, log_metrics, optimizer_step,
                                       trainable)


def draft_ttt_loss(cfg: ModelConfig, dcfg: DraftConfig, dparams,
                   target_params, tokens, features):
    """tokens: [B, S]; features: fused target features [B, S, 3d] aligned
    so features[i] belongs to token i.  Draft input i = (emb(tokens[i]),
    feat[i-1]) predicts tokens[i+1].  Returns (loss, {"ttt_loss_k"})."""
    mcfg = dr.draft_model_config(cfg)
    dev = tokens.device
    inv_freq = cm.rope_inv_freq_tensor(mcfg, dev)
    mscale = cm.yarn_mscale(mcfg)
    b, s = tokens.shape
    dt = cm.dt(cfg.dtype)
    feats_prev = torch.cat([torch.zeros_like(features[:, :1]),
                            features[:, :-1]], dim=1)
    x = dr._draft_inputs(cfg, dparams, target_params["embed"], tokens,
                         feats_prev)
    positions = torch.arange(s, device=dev)[None].expand(b, s)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=dev))[None, None]
    lp = dparams["layer"]
    total, weight, denom = 0.0, 1.0, 0.0
    losses = []
    step0_kv = None
    for step in range(dcfg.ttt_steps):
        xn = cm.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        q = bk.project_q(mcfg, lp["attn"], xn, positions, inv_freq, mscale)
        k_new, v_new = bk.project_kv(mcfg, lp["attn"], xn, positions,
                                     inv_freq, mscale)
        if step == 0:
            step0_kv = (k_new, v_new)
        kk, vv = step0_kv
        part = cm.dense_attn_part(q, kk, vv, mask=causal)
        out = cm.combine_attn_parts([part], x.dtype)
        h = x + bk.attn_output(mcfg, lp["attn"], out)
        xn = cm.rmsnorm(h, lp["norm2"], cfg.norm_eps)
        h = h + bk.mlp_fwd(mcfg, lp["mlp"], xn)
        logits = dr.draft_head(cfg, dparams, target_params, h)
        # step k at index i predicts tokens[i + 1 + k]
        shift = 1 + step
        loss_k = api.cross_entropy(logits[:, : s - shift], tokens[:, shift:])
        losses.append(loss_k)
        total = total + weight * loss_k
        denom += weight
        weight *= dcfg.ttt_alpha
        if step + 1 < dcfg.ttt_steps:
            # next-step input: ground-truth next token + own hidden as feat
            nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
            emb = target_params["embed"][nxt.long()].to(dt)
            fused = torch.cat([h, h, h], dim=-1) @ dparams["fuse"].to(dt)
            x = torch.cat([emb, fused], dim=-1) @ dparams["in_proj"].to(dt)
    return total / denom, {f"ttt_loss_{i}": l for i, l in enumerate(losses)}


@torch.no_grad()
def target_features(cfg: ModelConfig, target_params, tokens):
    """The frozen target's fused features [B, S, 3d] of a [B, S] batch:
    one prefill of the whole batch into a fresh contiguous cache of S
    tokens (the reference's ``feat_fn``)."""
    b, s = tokens.shape
    cache = api.init_cache(cfg, b, s, None, device=tokens.device)
    _, feats, _ = api.prefill(cfg, target_params, tokens, cache)
    return feats.fused_input()


@dataclass
class DraftTrainConfig:
    base_lr: float = 2e-5 * 50     # paper LR is for 8B; scaled for tiny
    warmup: int = 20
    total_steps: int = 300
    max_grad_norm: float = 1.0
    log_every: int = 20


class DraftTrainer:
    """Trains the draft on (tokens, target-features) batches."""

    def __init__(self, cfg: ModelConfig, dcfg: DraftConfig, target_params,
                 tcfg: Optional[DraftTrainConfig] = None, seed: int = 0,
                 dparams=None, device=None):
        """``target_params`` are frozen (detached in place); ``dparams``
        (random from ``seed`` when None) are trained in place, on
        ``device`` (CUDA unless ``"cpu"`` is asked for)."""
        self.cfg, self.dcfg = cfg, dcfg
        self.tcfg = tcfg or DraftTrainConfig()
        self.device = resolve_device(device)
        self.target_params = frozen(target_params)
        if dparams is None:
            dparams = dr.init_draft_params(cfg, dcfg, seed, self.device)
        self.dparams = trainable(dparams)
        self.opt = adamw_init(dparams)
        self.history: list = []

    def features(self, tokens: torch.Tensor) -> torch.Tensor:
        return target_features(self.cfg, self.target_params, tokens)

    def loss_and_grads(self, tokens: torch.Tensor, feats: torch.Tensor):
        """The TTT loss and its backward: leaves the gradients on the
        draft params.  Returns (loss, metrics), detached."""
        loss, metrics = draft_ttt_loss(self.cfg, self.dcfg, self.dparams,
                                       self.target_params, tokens, feats)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def update(self) -> Dict[str, Any]:
        """Clip and AdamW (no weight decay, as the reference)."""
        tc = self.tcfg
        lr = cosine_schedule(self.opt.step, base_lr=tc.base_lr,
                             warmup=tc.warmup, total=tc.total_steps)
        self.opt, gnorm = optimizer_step(self.dparams, self.opt,
                                         tc.max_grad_norm, lr, 0.0)
        return {"grad_norm": gnorm, "lr": lr}

    def step(self, tokens: torch.Tensor) -> Dict[str, Any]:
        """One step on a [B, S] token batch (the labels are the batch
        itself, shifted inside the loss)."""
        feats = self.features(tokens)
        loss, metrics = self.loss_and_grads(tokens, feats)
        return dict(metrics, **self.update(), loss=loss)

    def fit(self, data: Iterator[np.ndarray], steps: Optional[int] = None):
        steps = steps or self.tcfg.total_steps
        t0 = time.time()
        for i in range(steps):
            tokens = torch.as_tensor(np.asarray(next(data))[:, :-1],
                                     device=self.device)
            metrics = self.step(tokens)
            if i % self.tcfg.log_every == 0 or i == steps - 1:
                m = log_metrics(metrics, i, t0)
                self.history.append(m)
                print(f"[draft {self.cfg.name}] step={i} "
                      f"loss={m['loss']:.4f} "
                      f"L0={m['ttt_loss_0']:.3f} ({m['wall_s']:.0f}s)")
        return {"final_loss": self.history[-1]["loss"],
                "history": self.history}
