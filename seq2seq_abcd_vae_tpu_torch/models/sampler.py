"""Distribution-parameterising head (PyTorch port of
seq2seq_abcd_vae_tpu/models/sampler.py): an MLP_To_k_Vecs giving the k
parameters of a registered noise model (k = 2 for the isotropic Gaussian:
mean, log variance), with sampling, log-pdf and KL through the registry
(``distributions.choose_distribution``).  It is the decoder's emission
head and the plain VAE's latent head."""

from __future__ import annotations

import torch

from .. import distributions as dist
from . import mlp as mlp_mod


def sampler_init(gen: torch.Generator, input_size: int, mlp_hidden: int,
                 output_size: int,
                 distribution_name: str = "isotropic_gaussian") -> dict:
    k = dist.choose_distribution(distribution_name).num_parameters
    return {"to_parameters": mlp_mod.mlp_k_init(
        gen, input_size, mlp_hidden, output_size, k)}


def sampler_apply(params: dict, x: torch.Tensor) -> tuple:
    """x -> distribution parameter tuple (mean, log_variance)."""
    return mlp_mod.mlp_k_apply(params["to_parameters"], x)


def sampler_sample(normals: torch.Tensor, parameters: tuple,
                   distribution_name: str) -> torch.Tensor:
    """A reparameterised draw from presampled standard ``normals`` (the
    JAX package draws them from its key inside the call)."""
    return dist.choose_distribution(distribution_name).sample(normals,
                                                              *parameters)


def sampler_kl(parameters: tuple, distribution_name: str,
               mask=None) -> torch.Tensor:
    return dist.choose_distribution(distribution_name).kl_to_standard(
        *parameters, mask=mask)


def sampler_log_pdf(samples: torch.Tensor, parameters: tuple,
                    distribution_name: str, mask=None) -> torch.Tensor:
    return dist.choose_distribution(distribution_name).log_pdf(
        samples, *parameters, mask=mask)
