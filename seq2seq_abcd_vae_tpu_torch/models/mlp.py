"""MLP (Linear -> Tanh -> Linear) and the k-stacked MLP_To_k_Vecs,
PyTorch port of seq2seq_abcd_vae_tpu/models/mlp.py.  Weights keep the JAX
(in, out) layout, so a layer is ``x @ w + b``; the k parallel MLPs are
stacked on a leading axis."""

from __future__ import annotations

import torch

from . import initializers as init


def mlp_init(gen: torch.Generator, input_size: int, hidden_size: int,
             output_size: int) -> dict:
    return {"lin1": init.linear_params(gen, input_size, hidden_size),
            "lin2": init.linear_params(gen, hidden_size, output_size)}


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(x @ params["lin1"]["w"] + params["lin1"]["b"])
    return h @ params["lin2"]["w"] + params["lin2"]["b"]


def mlp_k_init(gen: torch.Generator, input_size: int, hidden_size: int,
               output_size: int, k: int) -> dict:
    """k parallel MLPs, parameters stacked on axis 0."""
    each = [mlp_init(gen, input_size, hidden_size, output_size)
            for _ in range(k)]
    return {lin: {p: torch.stack([e[lin][p] for e in each])
                  for p in ("w", "b")} for lin in ("lin1", "lin2")}


def mlp_k_apply(params: dict, x: torch.Tensor) -> tuple:
    """x (..., in) -> tuple of k tensors (..., out)."""
    lead = [1] * (x.dim() - 1)
    k = params["lin1"]["w"].shape[0]
    b1 = params["lin1"]["b"].reshape(k, *lead, -1)
    b2 = params["lin2"]["b"].reshape(k, *lead, -1)
    h = torch.tanh(torch.einsum("...i,kih->k...h", x, params["lin1"]["w"])
                   + b1)
    out = torch.einsum("k...h,kho->k...o", h, params["lin2"]["w"]) + b2
    return tuple(out.unbind(0))
