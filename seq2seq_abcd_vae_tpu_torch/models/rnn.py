"""Masked recurrent layers over padded batches (PyTorch port of
seq2seq_abcd_vae_tpu/models/rnn.py: the LSTM, the GRU and the Elman RNN in
one or both directions).

Variable lengths are padded arrays plus row lengths: a row's carries are
frozen once it ends, which reproduces the reference's packed-sequence
"shrinking batch" exactly, and the reverse direction joins short rows
late.  Both directions of a layer run in one call of
``ops/lstm_kernel.lstm_layer_bidir_fused``,
``ops/gru_kernel.gru_layer_bidir_fused`` or
``ops/elman_kernel.rnn_layer_bidir_fused``; one direction runs in
``ops/lstm_kernel.lstm_layer``, ``ops/gru_kernel.gru_layer`` or
``ops/elman_kernel.rnn_layer`` over the hoisted input projection.  Each is
the CUDA kernel for tensors on the card, its plain twin for tensors on the
CPU.  When autograd needs a gradient the call goes through the ``_train``
variant, whose backward is the hand-written reverse-time kernel.  Gates
are in torch order: LSTM (i, f, g, o), GRU (r, z, n); the Elman cell has
one, tanh.
"""

from __future__ import annotations

import torch

from ..ops import elman_kernel, gru_kernel, lstm_kernel
from ..ops.lstm_kernel import lstm_step  # noqa: F401  (the cell, re-exported)


def lengths_to_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) bool validity mask, True while t < length."""
    return (torch.arange(t, device=lengths.device)[None, :]
            < lengths[:, None])


def run_rnn_layer_bidir(layer: dict, x: torch.Tensor,
                        lengths: torch.Tensor, rnn_type: str = "LSTM"):
    """Both directions of one LSTM, GRU or Elman layer.

    Args:
      layer: ``{"w_ih" (2, F, gH), "b_ih" (2, gH), "w_hh" (2, H, gH),
        "b_hh" (2, gH)}``, directions stacked, g = 4 (LSTM), 3 (GRU) or 1
        (RNN).
      x: (B, T, F) inputs; lengths: (B,) int32 valid steps per row (the
        JAX function takes the equivalent prefix mask).
      rnn_type: ``LSTM``, ``GRU`` or ``RNN``.

    Returns (outs_fwd (B, T, H), outs_bwd (B, T, H),
    [(h, c)_fwd, (h, c)_bwd]) as the JAX function does; the c of the GRU
    and the Elman cell is zeros.
    """
    args = (x.transpose(0, 1).contiguous(), lengths, layer["w_ih"],
            layer["b_ih"], layer["w_hh"], layer["b_hh"])
    grad = _needs_grad(args)
    if rnn_type == "LSTM":
        outs, h_n, c_n = (lstm_kernel.lstm_layer_bidir_fused_train if grad
                          else lstm_kernel.lstm_layer_bidir_fused)(*args)
    else:
        if rnn_type == "GRU":
            layer_fn = (gru_kernel.gru_layer_bidir_fused_train if grad
                        else gru_kernel.gru_layer_bidir_fused)
        elif rnn_type == "RNN":
            layer_fn = (elman_kernel.rnn_layer_bidir_fused_train if grad
                        else elman_kernel.rnn_layer_bidir_fused)
        else:
            raise ValueError(f"no bidirectional layer for {rnn_type!r}")
        outs, h_n = layer_fn(*args)
        c_n = torch.zeros_like(h_n)
    outs_f = outs[:, 0].transpose(0, 1)
    outs_b = outs[:, 1].flip(0).transpose(0, 1)
    return outs_f, outs_b, [(h_n[0], c_n[0]), (h_n[1], c_n[1])]


def _needs_grad(args) -> bool:
    return torch.is_grad_enabled() and any(a.requires_grad for a in args)


def run_rnn_layer(params: dict, x: torch.Tensor, lengths: torch.Tensor,
                  reverse: bool = False, rnn_type: str = "LSTM"):
    """One direction of one LSTM, GRU or Elman layer over a padded batch.

    Args:
      params: ``{"w_ih" (F, gH), "b_ih" (gH,), "w_hh" (H, gH),
        "b_hh" (gH,)}``, g = 4 (LSTM), 3 (GRU) or 1 (RNN).
      x: (B, T, F) inputs; lengths: (B,) int32 valid steps per row (the
        JAX function takes the equivalent prefix mask).
      reverse: run t = T-1 .. 0 (the right-to-left direction).
      rnn_type: ``LSTM``, ``GRU`` or ``RNN``.

    Returns (outputs (B, T, H), (h_n, c_n)) as the JAX function does: the
    hidden state at each position (frozen after a row ends; zero before it
    joins in reverse) and the state after the row's last processed
    position; the c of the GRU and the Elman cell is zeros.
    """
    # the hoisted input projection: one large product outside the kernel
    # (b_ih only: the GRU's b_hh sits inside the reset product)
    xp = (x @ params["w_ih"] + params["b_ih"]).transpose(0, 1)
    if reverse:
        xp = xp.flip(0)
    args = (xp.contiguous(), lengths, params["w_hh"], params["b_hh"])
    grad = _needs_grad(args)
    if rnn_type == "LSTM":
        outs, h_n, c_n = (lstm_kernel.lstm_layer_train if grad
                          else lstm_kernel.lstm_layer)(*args, reverse)
    else:
        if rnn_type == "GRU":
            layer_fn = (gru_kernel.gru_layer_train if grad
                        else gru_kernel.gru_layer)
        elif rnn_type == "RNN":
            layer_fn = (elman_kernel.rnn_layer_train if grad
                        else elman_kernel.rnn_layer)
        else:
            raise ValueError(f"no layer for {rnn_type!r}")
        outs, h_n = layer_fn(*args, reverse)
        c_n = torch.zeros_like(h_n)
    if reverse:
        outs = outs.flip(0)
    return outs.transpose(0, 1), (h_n, c_n)
