"""Echo-state network (ESN) layers with fixed weights (PyTorch port of
seq2seq_abcd_vae_tpu/models/esn.py, the port's own copy).

Reference: ABCD-VAE/modules/model.py:336-535 (the ``ESN`` module and
``ESNCell``).  The weights are built as the reference builds them:

- input -> hidden entries are +-3/q with q = binom.ppf(0.95, fan_in, 0.5)
  (model.py:362-388,495-504);
- hidden -> hidden is randn sparsified by a train-mode Dropout(p=1-sparsity),
  i.e. kept entries scaled by 1/sparsity, then scaled so that its spectral
  radius is 0.99 (model.py:390-401,510-518), the radius from
  ``numpy.linalg.eigvals`` once at init;
- update: h' = (1 - leak) h + leak tanh(x W_ih + h W_hh), no biases
  (model.py:444,529-531).

The layers run on the Elman kernels (``ops/elman_kernel``) with zero
biases and the leak: both directions over the raw input, or one direction
over the hoisted x @ W_ih.  The reservoir is FROZEN (model.py:376,396
``requires_grad=False``):
``models/vae.set_trainable`` leaves its tensors without gradients, so the
optimiser neither updates them nor counts them in the global-norm clip,
which is what the JAX package's zero gradient does.  Matrices keep the
JAX layout (in, out); the draws come from an explicit CPU
``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import elman_kernel


def _input_weight(gen: torch.Generator, fan_in: int, hidden: int,
                  q: float) -> torch.Tensor:
    """(fan_in, hidden) matrix of +-3/quantile entries."""
    # imported here: scipy.stats takes seconds to import, and only a fresh
    # ESN needs it (not serving, encoding or resuming)
    from scipy import stats
    quantile = float(stats.binom.ppf(q, fan_in, 0.5))
    bits = torch.randint(0, 2, (fan_in, hidden), generator=gen).float()
    return bits * (6.0 / quantile) - (3.0 / quantile)


def _hidden_weight(gen: torch.Generator, hidden: int,
                   sparsity: float) -> torch.Tensor:
    w = torch.randn((hidden, hidden), generator=gen)
    keep = torch.rand((hidden, hidden), generator=gen) < sparsity
    w = torch.where(keep, w / sparsity, 0.0)  # train-mode dropout scaling
    radius = float(np.abs(np.linalg.eigvals(w.double().numpy())).max())
    return w / (radius / 0.99)


def esn_layer_init(gen: torch.Generator, fan_in: int, hidden: int,
                   q: float = 0.95, sparsity: float = 0.1) -> dict:
    """One direction's ``{"w_ih" (fan_in, H), "w_hh" (H, H)}``."""
    return {"w_ih": _input_weight(gen, fan_in, hidden, q),
            "w_hh": _hidden_weight(gen, hidden, sparsity)}


def run_esn_layer_bidir(layer: dict, x: torch.Tensor, lengths: torch.Tensor,
                        leak: float):
    """Both ESN directions of one layer on the Elman kernel, with zero
    biases and the leak (the JAX function's fused path).

    Args:
      layer: ``{"w_ih" (2, F, H), "w_hh" (2, H, H)}``, directions stacked.
      x: (B, T, F) inputs; lengths: (B,) int32 valid steps per row.

    Returns (outs_fwd (B, T, H), outs_bwd (B, T, H), h_n_fwd, h_n_bwd).
    The reservoir takes no gradient; one flows to ``x`` when it needs one
    (a lower layer's output), through the backward kernel.
    """
    w_ih, w_hh = layer["w_ih"].detach(), layer["w_hh"].detach()
    zeros = w_hh.new_zeros((2, w_hh.shape[-1]))
    args = (x.transpose(0, 1).contiguous(), lengths, w_ih, zeros, w_hh,
            zeros)
    if torch.is_grad_enabled() and x.requires_grad:
        outs, h_n = elman_kernel.rnn_layer_bidir_fused_train(*args, leak)
    else:
        outs, h_n = elman_kernel.rnn_layer_bidir_fused(*args, leak)
    outs_f = outs[:, 0].transpose(0, 1)
    outs_b = outs[:, 1].flip(0).transpose(0, 1)
    return outs_f, outs_b, h_n[0], h_n[1]


def run_esn_layer(params: dict, x: torch.Tensor, lengths: torch.Tensor,
                  leak: float, reverse: bool = False):
    """One ESN direction of one layer on the one-direction Elman kernel
    over the hoisted x @ W_ih (no bias), with a zero bias and the leak (the
    JAX function's kernel path).

    Args:
      params: ``{"w_ih" (F, H), "w_hh" (H, H)}``.
      x: (B, T, F) inputs; lengths: (B,) int32 valid steps per row.
      reverse: run t = T-1 .. 0.

    Returns (outs (B, T, H), h_n (B, H)).  The reservoir takes no
    gradient; one flows to ``x`` when it needs one (a lower layer's
    output), through the backward kernel, so a layer over the raw
    spectrogram launches no backward.
    """
    w_ih, w_hh = params["w_ih"].detach(), params["w_hh"].detach()
    xp = (x @ w_ih).transpose(0, 1)
    if reverse:
        xp = xp.flip(0)
    args = (xp.contiguous(), lengths, w_hh, w_hh.new_zeros(w_hh.shape[-1]))
    if torch.is_grad_enabled() and x.requires_grad:
        outs, h_n = elman_kernel.rnn_layer_train(*args, reverse, leak)
    else:
        outs, h_n = elman_kernel.rnn_layer(*args, reverse, leak)
    if reverse:
        outs = outs.flip(0)
    return outs.transpose(0, 1), h_n
