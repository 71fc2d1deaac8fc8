"""Variational sequence encoder (PyTorch port of
seq2seq_abcd_vae_tpu/models/encoder.py: the LSTM encoder in one or both
directions, the GRU encoder in both).

The output is the flattened final state: for each (layer, direction) the
LSTM's h and c are concatenated (the GRU has h only), and the blocks are
flattened row-major in torch order, so the width is layers * hidden *
(2 if bidirectional) * (2 if LSTM).  Inter-layer dropout is not ported
(``configs.check_served`` refuses it for training).
"""

from __future__ import annotations

import torch

from ..configs import EncoderConfig, check_served
from . import initializers as init
from . import rnn as rnn_mod

NUM_GATES = {"LSTM": 4, "GRU": 3}


def encoder_init(gen: torch.Generator, cfg: EncoderConfig) -> list:
    """Fresh layers.  Bidirectional: each ``{"w_ih" (2, F, gH), "b_ih"
    (2, gH), "w_hh" (2, H, gH), "b_hh" (2, gH)}`` with the two directions
    stacked (drawn forward direction first, as the JAX package stores
    them), g = 4 gates for the LSTM and 3 for the GRU; unidirectional: the
    same without the leading axis."""
    check_served(cfg)
    dirs = 2 if cfg.bidirectional else 1
    layers = []
    for index in range(cfg.rnn_layers):
        in_size = (cfg.input_size if index == 0
                   else dirs * cfg.rnn_hidden_size)
        drawn = [init.rnn_gate_params(gen, in_size, cfg.rnn_hidden_size,
                                      NUM_GATES[cfg.rnn_type])
                 for _ in range(dirs)]
        layers.append({k: torch.stack([p[k] for p in drawn])
                       for k in drawn[0]} if cfg.bidirectional
                      else drawn[0])
    return layers


def encoder_apply(params: list, cfg: EncoderConfig, x: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, F) padded inputs + (B,) lengths -> (B, hidden_size_total).

    Rows with length 0 (batch padding) give the zero initial state.
    """
    check_served(cfg)
    lengths = lengths.to(torch.int32)
    finals = []
    y = x
    for layer in params:
        if cfg.bidirectional:
            outs_f, outs_b, both = rnn_mod.run_rnn_layer_bidir(
                layer, y, lengths, cfg.rnn_type)
            finals.extend(both)
            y = torch.cat([outs_f, outs_b], dim=-1)
        else:
            y, final = rnn_mod.run_rnn_layer(layer, y, lengths)
            finals.append(final)
    return _flatten_final(cfg, finals)


def _flatten_final(cfg: EncoderConfig, finals) -> torch.Tensor:
    """Per-(layer, direction) blocks, [h | c] for the LSTM and h for the
    GRU, flattened row-major."""
    blocks = [torch.cat([h, c], dim=-1) if cfg.rnn_type == "LSTM" else h
              for h, c in finals]
    stacked = torch.stack(blocks, dim=1)          # (B, layers*dirs, width)
    return stacked.reshape(stacked.shape[0], -1)
