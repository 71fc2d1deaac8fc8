"""ABCD latent head: "A"ttention-"B"ased "C"ategorical sampler with a
"D"irichlet prior (PyTorch port of seq2seq_abcd_vae_tpu/models/abcd.py).

- logits = MLP(x) @ codebook / sqrt(feature_dim);
- sample = GumbelSoftmax(logits, tau) @ codebook^T, or the plain softmax
  when ``no_sample`` (pretraining); the Gumbel noise is passed in;
- mean-field Dirichlet-Categorical KL with a learnable global posterior
  shape, the global train-set size N and row masks;
- tau = min(min_temperature, exp(-anneal_rate * steps)), steps floored to
  the update frequency.
"""

from __future__ import annotations

import math

import torch

from ..configs import ABCDSamplerConfig
from . import initializers as init
from . import mlp as mlp_mod


def abcd_init(gen: torch.Generator, cfg: ABCDSamplerConfig) -> dict:
    return {
        "to_code_like": mlp_mod.mlp_init(gen, cfg.input_size,
                                         cfg.mlp_hidden_size,
                                         cfg.feature_dim),
        "posterior_shape_logits": init.normal_params(
            gen, (cfg.num_categories,)),
        "codebook": init.normal_params(gen, (cfg.feature_dim,
                                             cfg.num_categories)),
    }


def abcd_code(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Pre-logit feature vector (the ``features`` encode mode)."""
    return mlp_mod.mlp_apply(params["to_code_like"], x)


def abcd_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Unnormalised log posterior over the K categories."""
    code = abcd_code(params, x)
    return (code @ params["codebook"]) * (1.0 / math.sqrt(code.shape[-1]))


def gumbel_noise(generator: torch.Generator, shape, device=None):
    """Standard Gumbel draws -log(-log(u)), u ~ U(0, 1) from ``generator``
    (u kept inside (0, 1) so that both logs are finite)."""
    device = generator.device if device is None else device
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp(min=tiny, max=1.0 - 2.0 ** -24)
    return -torch.log(-torch.log(u))


def gumbel_softmax(logits: torch.Tensor, noise: torch.Tensor,
                   temperature) -> torch.Tensor:
    """Soft Gumbel-Softmax sample with the Gumbel ``noise`` passed in."""
    return torch.softmax((logits + noise) / temperature, dim=-1)


def abcd_sample(params: dict, logits: torch.Tensor, temperature,
                noise: torch.Tensor | None = None,
                no_sample: bool = False) -> torch.Tensor:
    """Latent feature = (soft one-hot) @ codebook^T; ``no_sample`` uses the
    posterior probabilities (pretraining)."""
    if no_sample:
        weights = torch.softmax(logits, dim=-1)
    else:
        weights = gumbel_softmax(logits, noise, temperature)
    return weights @ params["codebook"].T


def abcd_kl(params: dict, cfg: ABCDSamplerConfig, logits: torch.Tensor,
            entire_data_size, row_mask: torch.Tensor | None = None):
    """KL( q(pi) q(z|x) || p(pi) p(z|pi) ), mean-field
    Dirichlet-Categorical; ``row_mask`` drops batch-padding rows from the
    per-row terms and from the batch size."""
    lgamma, digamma = torch.special.gammaln, torch.special.digamma
    prior = torch.tensor(cfg.prior_concentration, dtype=logits.dtype,
                         device=logits.device)
    k = cfg.num_categories
    shape = torch.softmax(params["posterior_shape_logits"], dim=-1)
    conc = shape * entire_data_size + prior
    sum_conc = conc.sum()
    expected_log_pi = digamma(conc) - digamma(sum_conc)
    eq_log_q_pi = (lgamma(sum_conc) - lgamma(conc).sum()
                   + ((conc - 1.0) * expected_log_pi).sum())
    eq_log_p_pi = (lgamma(prior * k) - lgamma(prior) * k
                   + ((prior - 1.0) * expected_log_pi).sum())
    q_z = torch.softmax(logits, dim=-1)
    log_q_z = torch.log_softmax(logits, dim=-1)
    per_row_q = (q_z * log_q_z).sum(-1)
    per_row_p = q_z @ expected_log_pi
    if row_mask is not None:
        per_row_q = per_row_q * row_mask
        per_row_p = per_row_p * row_mask
        batch_size = row_mask.sum()
    else:
        batch_size = logits.shape[0]
    return ((eq_log_q_pi - eq_log_p_pi) * (batch_size / entire_data_size)
            + per_row_q.sum() - per_row_p.sum())


def temperature_for_iter(cfg: ABCDSamplerConfig, iter_counts: int) -> float:
    """tau as a pure function of the persisted iteration counter."""
    steps = (int(iter_counts) // cfg.temperature_update_freq
             ) * cfg.temperature_update_freq
    return min(cfg.min_temperature,
               math.exp(-cfg.temperature_anneal_rate * steps))
