"""Distribution-parameterising head (port of
seq2seq_abcd_vae_tpu/models/sampler.py, as far as the decoder's emission
needs it): an MLP_To_k_Vecs giving the k parameters of the noise model
(k = 2 for the isotropic Gaussian: mean, log variance)."""

from __future__ import annotations

import torch

from . import mlp as mlp_mod

NUM_PARAMETERS = {"isotropic_gaussian": 2}


def sampler_init(gen: torch.Generator, input_size: int, mlp_hidden: int,
                 output_size: int,
                 distribution_name: str = "isotropic_gaussian") -> dict:
    return {"to_parameters": mlp_mod.mlp_k_init(
        gen, input_size, mlp_hidden, output_size,
        NUM_PARAMETERS[distribution_name])}


def sampler_apply(params: dict, x: torch.Tensor) -> tuple:
    """x -> distribution parameter tuple (mean, log_variance)."""
    return mlp_mod.mlp_k_apply(params["to_parameters"], x)
