"""Masked recurrent layers over padded batches (PyTorch port of
seq2seq_abcd_vae_tpu/models/rnn.py, bidirectional LSTM only).

Variable lengths are padded arrays plus row lengths: a row's carries are
frozen once it ends, which reproduces the reference's packed-sequence
"shrinking batch" exactly, and the reverse direction joins short rows
late.  Both directions of a layer run in one call of
``ops/lstm_kernel.lstm_layer_bidir_fused``: the CUDA kernel for tensors on
the card, its plain twin for tensors on the CPU.  When autograd needs a
gradient the call goes through ``lstm_layer_bidir_fused_train``, whose
backward is the hand-written reverse-time kernel.  Gates are in torch
order (i, f, g, o).
"""

from __future__ import annotations

import torch

from ..ops import lstm_kernel
from ..ops.lstm_kernel import lstm_step  # noqa: F401  (the cell, re-exported)


def lengths_to_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) bool validity mask, True while t < length."""
    return (torch.arange(t, device=lengths.device)[None, :]
            < lengths[:, None])


def run_rnn_layer_bidir(layer: dict, x: torch.Tensor,
                        lengths: torch.Tensor):
    """Both directions of one LSTM layer.

    Args:
      layer: ``{"w_ih" (2, F, 4H), "b_ih" (2, 4H), "w_hh" (2, H, 4H),
        "b_hh" (2, 4H)}``, directions stacked.
      x: (B, T, F) inputs; lengths: (B,) int32 valid steps per row (the
        JAX function takes the equivalent prefix mask).

    Returns (outs_fwd (B, T, H), outs_bwd (B, T, H),
    [(h, c)_fwd, (h, c)_bwd]) as the JAX function does.
    """
    args = (x.transpose(0, 1).contiguous(), lengths, layer["w_ih"],
            layer["b_ih"], layer["w_hh"], layer["b_hh"])
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        outs, h_n, c_n = lstm_kernel.lstm_layer_bidir_fused_train(*args)
    else:
        outs, h_n, c_n = lstm_kernel.lstm_layer_bidir_fused(*args)
    outs_f = outs[:, 0].transpose(0, 1)
    outs_b = outs[:, 1].flip(0).transpose(0, 1)
    return outs_f, outs_b, [(h_n[0], c_n[0]), (h_n[1], c_n[1])]
