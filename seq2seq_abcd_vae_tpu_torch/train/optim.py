"""Optimiser and learning-rate schedule (PyTorch port of
seq2seq_abcd_vae_tpu/train/optim.py).

Global-norm gradient clipping (``torch.nn.utils.clip_grad_norm_``), then
``torch.optim.SGD`` with the configured momentum, and ReduceLROnPlateau
stepped on the mean validation loss, including the ``best = inf`` reset
at the end of pretraining.  The plateau scheduler is the JAX package's
own copy of torch's (mode 'min', rel threshold 1e-4, factor 0.1,
cooldown 0), with the same state-dict keys, so that a checkpoint's
scheduler state reads in either package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch


def make_optimizer(params: list, learning_rate: float,
                   momentum: float) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum)


def clip_and_step(optimizer: torch.optim.SGD, params: list,
                  gradient_clip: float) -> torch.Tensor:
    """Clip the gradients of ``params`` to global norm ``gradient_clip``,
    then take one SGD step.  Returns the norm before clipping (a tensor on
    the parameters' device; reading it is left to the caller)."""
    norm = torch.nn.utils.clip_grad_norm_(params, gradient_clip)
    optimizer.step()
    return norm


def get_learning_rate(optimizer: torch.optim.SGD) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.SGD, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclass
class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau (mode='min'); step()
    takes the metric and the current lr and returns the new lr."""
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    min_lr: float = 0.0
    eps: float = 1e-8
    best: float = math.inf
    num_bad_epochs: int = 0
    cooldown_counter: int = 0
    last_epoch: int = 0
    num_reductions: int = 0

    def is_better(self, current: float) -> bool:
        if self.threshold_mode == "rel":
            return current < self.best * (1.0 - self.threshold)
        return current < self.best - self.threshold

    def step(self, metric: float, lr: float) -> float:
        current = float(metric)
        self.last_epoch += 1
        if self.is_better(current):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(lr * self.factor, self.min_lr)
            if lr - new_lr > self.eps:
                lr = new_lr
                self.num_reductions += 1
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return lr

    def reset_best(self) -> None:
        """Forget the best value at the end of pretraining."""
        self.best = math.inf

    def state_dict(self) -> dict[str, Any]:
        return {k: getattr(self, k) for k in (
            "factor", "patience", "threshold", "threshold_mode", "cooldown",
            "min_lr", "eps", "best", "num_bad_epochs", "cooldown_counter",
            "last_epoch", "num_reductions")}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        for k, v in state.items():
            setattr(self, k, v)
