"""Distribution registry of the latent and emission noise models (PyTorch
port of seq2seq_abcd_vae_tpu/distributions.py): each name maps to
``Distribution(sample, log_pdf, kl_to_standard, num_parameters, noise,
from_noise)``; the isotropic Gaussian is registered, and
``register_distribution`` adds others.

All reductions are unnormalised sums over every element, with an optional
``mask`` broadcastable against the value so that padding adds exactly
zero.  Randomness is an input: ``sample`` takes presampled standard
normals in place of the JAX package's key, and ``noise`` draws them from
an explicit ``torch.Generator`` (the JAX package's threefry streams cannot
be reproduced in torch, so the parity tests hand both packages the same
normals).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def log_pdf_isotropic_gaussian(value, mean, log_variance, mask=None):
    """Sum-reduced diagonal-Gaussian log density."""
    diff = value - mean
    ll = -0.5 * (_LOG_2PI + log_variance
                 + diff * torch.exp(-log_variance) * diff)
    if mask is not None:
        ll = ll * mask
    return ll.sum()


def kl_isotropic_to_standard_gaussian(mean, log_variance, mask=None):
    """Sum-reduced KL( N(mean, diag exp(logvar)) || N(0, I) )."""
    kl = -0.5 * (1.0 + log_variance - mean * mean - torch.exp(log_variance))
    if mask is not None:
        kl = kl * mask
    return kl.sum()


def gaussian_noise(generator: torch.Generator, shape, device=None,
                   dtype=torch.float32):
    """Standard normals from ``generator`` (on its device by default)."""
    device = generator.device if device is None else device
    return torch.randn(shape, generator=generator, device=device,
                       dtype=dtype)


def gaussian_from_noise(noise, mean, log_variance):
    """Reparameterised draw ``mean + exp(logvar / 2) * noise``."""
    return mean + torch.exp(0.5 * log_variance) * noise


class Distribution(NamedTuple):
    sample: Callable[..., torch.Tensor]
    log_pdf: Callable[..., torch.Tensor]
    kl_to_standard: Callable[..., torch.Tensor]
    num_parameters: int
    noise: Callable[..., torch.Tensor]
    from_noise: Callable[..., torch.Tensor]


_REGISTRY: dict[str, Distribution] = {
    # the port's sample takes the standard normals the JAX package draws
    # from its key: the same function as from_noise
    "isotropic_gaussian": Distribution(
        sample=gaussian_from_noise,
        log_pdf=log_pdf_isotropic_gaussian,
        kl_to_standard=kl_isotropic_to_standard_gaussian,
        num_parameters=2,
        noise=gaussian_noise,
        from_noise=gaussian_from_noise,
    ),
}


def choose_distribution(distribution_name: str) -> Distribution:
    """Name -> Distribution."""
    return _REGISTRY[distribution_name]


def register_distribution(name: str, dist: Distribution) -> None:
    """Add a noise model under ``name`` (the JAX package's extension
    hook)."""
    _REGISTRY[name] = dist
