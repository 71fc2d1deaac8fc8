"""Variational sequence encoder (PyTorch port of
seq2seq_abcd_vae_tpu/models/encoder.py: the LSTM, GRU, Elman RNN and
echo-state (ESN) encoders in one or both directions).

The output is the flattened final state: for each (layer, direction) the
LSTM's h and c are concatenated (the other cells have h only), and the
blocks are flattened row-major in torch order, so the width is layers *
hidden * (2 if bidirectional) * (2 if LSTM).  Inter-layer dropout is not
ported (``configs.check_served`` refuses it for training).
"""

from __future__ import annotations

import torch

from ..configs import EncoderConfig, check_served
from . import esn as esn_mod
from . import initializers as init
from . import rnn as rnn_mod

# gate blocks per cell; the ESN's one block is its reservoir, without biases
NUM_GATES = {"LSTM": 4, "GRU": 3, "RNN": 1, "ESN": 1}


def encoder_init(gen: torch.Generator, cfg: EncoderConfig) -> list:
    """Fresh layers.  Bidirectional: each ``{"w_ih" (2, F, gH), "b_ih"
    (2, gH), "w_hh" (2, H, gH), "b_hh" (2, gH)}`` with the two directions
    stacked (drawn forward direction first, as the JAX package stores
    them), g = 4 gates for the LSTM, 3 for the GRU and 1 for the Elman
    RNN; the ESN's reservoir layers ``{"w_ih", "w_hh"}`` have no biases;
    unidirectional: the same without the leading axis."""
    check_served(cfg)
    dirs = 2 if cfg.bidirectional else 1
    layers = []
    for index in range(cfg.rnn_layers):
        in_size = (cfg.input_size if index == 0
                   else dirs * cfg.rnn_hidden_size)
        if cfg.rnn_type == "ESN":
            drawn = [esn_mod.esn_layer_init(gen, in_size, cfg.rnn_hidden_size)
                     for _ in range(dirs)]
        else:
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
        if cfg.rnn_type == "ESN" and cfg.bidirectional:
            outs_f, outs_b, h_f, h_b = esn_mod.run_esn_layer_bidir(
                layer, y, lengths, cfg.esn_leak)
            finals.extend([(h_f, None), (h_b, None)])
            y = torch.cat([outs_f, outs_b], dim=-1)
        elif cfg.rnn_type == "ESN":
            y, h_f = esn_mod.run_esn_layer(layer, y, lengths, cfg.esn_leak)
            finals.append((h_f, None))
        elif cfg.bidirectional:
            outs_f, outs_b, both = rnn_mod.run_rnn_layer_bidir(
                layer, y, lengths, cfg.rnn_type)
            finals.extend(both)
            y = torch.cat([outs_f, outs_b], dim=-1)
        else:
            y, final = rnn_mod.run_rnn_layer(layer, y, lengths,
                                             rnn_type=cfg.rnn_type)
            finals.append(final)
    return _flatten_final(cfg, finals)


def _flatten_final(cfg: EncoderConfig, finals) -> torch.Tensor:
    """Per-(layer, direction) blocks, [h | c] for the LSTM and h for the
    other cells, flattened row-major."""
    blocks = [torch.cat([h, c], dim=-1) if cfg.rnn_type == "LSTM" else h
              for h, c in finals]
    stacked = torch.stack(blocks, dim=1)          # (B, layers*dirs, width)
    return stacked.reshape(stacked.shape[0], -1)
