"""Isotropic-Gaussian noise model of the decoder's emission (PyTorch port
of seq2seq_abcd_vae_tpu/distributions.py, the one entry the training
slice uses).

All reductions are unnormalised sums over every element, with an optional
``mask`` broadcastable against the value so that padding adds exactly
zero.  Noise is drawn from an explicit ``torch.Generator``, or passed in:
the JAX package's threefry streams cannot be reproduced in torch, so the
parity tests hand both packages the same noise.
"""

from __future__ import annotations

import math

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
