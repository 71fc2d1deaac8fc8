"""Weight initialisers with the reference's PyTorch distributions (port of
seq2seq_abcd_vae_tpu/models/initializers.py), drawn from an explicit
``torch.Generator`` on the CPU so that a seed gives the same weights on
any device:

- torch.nn.Linear: W, b ~ U(-1/sqrt(fan_in), +1/sqrt(fan_in));
- torch.nn.LSTM and its cell: every tensor ~ U(-1/sqrt(hidden), ...);
- embeddings and raw parameters: N(0, 1).

Matrices keep the JAX layout (in, out), so a layer is ``x @ w + b``.
"""

from __future__ import annotations

import math

import torch


def uniform_fan(gen: torch.Generator, shape, fan: int) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan)
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def linear_params(gen: torch.Generator, in_size: int, out_size: int) -> dict:
    return {"w": uniform_fan(gen, (in_size, out_size), in_size),
            "b": uniform_fan(gen, (out_size,), in_size)}


def rnn_gate_params(gen: torch.Generator, in_size: int, hidden: int,
                    num_gates: int) -> dict:
    g = num_gates * hidden
    return {"w_ih": uniform_fan(gen, (in_size, g), hidden),
            "w_hh": uniform_fan(gen, (hidden, g), hidden),
            "b_ih": uniform_fan(gen, (g,), hidden),
            "b_hh": uniform_fan(gen, (g,), hidden)}


def normal_params(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen)
