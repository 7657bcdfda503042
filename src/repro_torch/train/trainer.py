"""Target-model trainer (counterpart of ``repro/train/trainer.py``): each
step is loss -> ``backward`` -> clip -> AdamW, in plain torch under
autograd (the CUDA kernels have no backward and training never calls
them); no ``torch.compile``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         clip_by_global_norm,
                                         cosine_schedule, tree_leaves,
                                         tree_map)


@dataclass
class TrainConfig:
    base_lr: float = 3e-4
    warmup: int = 50
    total_steps: int = 500
    max_grad_norm: float = 1.0
    weight_decay: float = 0.1
    log_every: int = 20
    ckpt_path: Optional[str] = None
    ckpt_every: int = 500


def trainable(params):
    """Mark every leaf of ``params`` as trained (in place); returns it."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def frozen(params):
    """Detach every leaf of ``params`` from autograd (in place), as the
    inference path expects; returns it."""
    for p in tree_leaves(params):
        p.requires_grad_(False)
        p.grad = None
    return params


def grads_of(params):
    """The gradient tree of ``params`` after ``backward`` (zeros for a
    leaf the loss does not reach)."""
    return tree_map(lambda p, stacked: p.grad if p.grad is not None
                    else torch.zeros_like(p), params)


def optimizer_step(params, opt, max_grad_norm: float, lr,
                   weight_decay: float):
    """Clip the gradients ``backward`` left and apply AdamW, in place.
    Returns (opt, grad norm as a 0-dim tensor)."""
    grads, gnorm = clip_by_global_norm(grads_of(params), max_norm=max_grad_norm)
    params, opt = adamw_update(params, grads, opt, lr=lr,
                               weight_decay=weight_decay)
    for p in tree_leaves(params):
        p.grad = None
    return opt, gnorm


def log_metrics(metrics: Dict[str, Any], step: int, t0: float
                ) -> Dict[str, Any]:
    """Read a step's metrics to the host (one sync), with the step and
    the wall seconds since ``t0``."""
    m = {k: float(v) for k, v in metrics.items()}
    m["step"] = step
    m["wall_s"] = time.time() - t0
    return m


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, params=None,
                 seed: int = 0, device=None):
        """Trains ``params`` (the port's target tree, updated in place;
        random from ``seed`` when None) on ``device`` (CUDA unless
        ``"cpu"`` is asked for; the params must live there)."""
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        if params is None:
            params = api.init_params(cfg, seed, self.device)
        self.params = trainable(params)
        self.opt = adamw_init(params)
        self.history: list = []

    def loss_and_grads(self, tokens: torch.Tensor):
        """Forward and backward of one [B, S] token batch: leaves the
        gradients on the params.  Returns (loss, metrics), detached."""
        loss, metrics = api.train_loss(self.cfg, self.params, tokens)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def update(self) -> Dict[str, Any]:
        """Clip the gradients and apply AdamW at this step's learning
        rate.  Returns {"grad_norm", "lr"}."""
        tc = self.tcfg
        lr = cosine_schedule(self.opt.step, base_lr=tc.base_lr,
                             warmup=tc.warmup, total=tc.total_steps)
        self.opt, gnorm = optimizer_step(self.params, self.opt,
                                         tc.max_grad_norm, lr,
                                         tc.weight_decay)
        return {"grad_norm": gnorm, "lr": lr}

    def step(self, tokens: torch.Tensor) -> Dict[str, Any]:
        """One training step on a [B, S] token batch; returns its metrics
        (tensors stay on the card: no sync)."""
        loss, metrics = self.loss_and_grads(tokens)
        return dict(metrics, **self.update(), loss=loss)

    def fit(self, data: Iterator[np.ndarray], steps: Optional[int] = None
            ) -> Dict[str, Any]:
        steps = steps or self.tcfg.total_steps
        t0 = time.time()
        for i in range(steps):
            tokens = torch.as_tensor(np.asarray(next(data)),
                                     device=self.device)
            metrics = self.step(tokens)
            if i % self.tcfg.log_every == 0 or i == steps - 1:
                m = log_metrics(metrics, i, t0)
                self.history.append(m)
                print(f"[train {self.cfg.name}] step={i} "
                      f"loss={m['loss']:.4f} lr={m['lr']:.2e} "
                      f"gnorm={m['grad_norm']:.2f} ({m['wall_s']:.0f}s)")
            if (self.tcfg.ckpt_path and i > 0
                    and i % self.tcfg.ckpt_every == 0):
                save_checkpoint(self.tcfg.ckpt_path, self.cfg, self.params,
                                step=i)
        if self.tcfg.ckpt_path:
            save_checkpoint(self.tcfg.ckpt_path, self.cfg, self.params,
                            step=steps)
        return {"final_loss": self.history[-1]["loss"],
                "history": self.history}
