"""Assembled seq2seq VAE: encoder -> latent head -> decoder, one loss
(PyTorch port of seq2seq_abcd_vae_tpu/models/vae.py), for both model
families:

- ``latent_type`` ``abcd``: the ABCD head; its KL uses the train-set size
  and the Gumbel-Softmax temperature; pretraining (``no_sample``) bypasses
  the Gumbel sample;
- ``latent_type`` ``gaussian``: the plain VAE; the Gaussian head's
  parameters, masked by the real rows, are sampled by reparameterisation
  and their KL to the standard normal is masked too.

The losses are unnormalised sums; ``training_loss`` divides them by the
number of real rows.  The randomness is an input: the head's noise (the
Gumbel noise (B, K), or the standard normals (B, f) of the Gaussian) and
the decoder's noise (T, B, F), so that the parity tests can hand both
packages the same draws.  ``set_trainable`` marks the leaves that take
gradients: all but the echo-state (ESN) reservoirs, which stay frozen.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

from ..configs import (ABCDSamplerConfig, DecoderConfig, EncoderConfig,
                       GaussianSamplerConfig, check_served)
from ..tree import tree_map
from . import abcd as abcd_mod
from . import decoder as dec_mod
from . import encoder as enc_mod
from . import sampler as sampler_mod


@dataclass(frozen=True)
class ModelConfig:
    encoder: EncoderConfig
    latent: Union[ABCDSamplerConfig, GaussianSamplerConfig]
    decoder: DecoderConfig

    @property
    def latent_type(self) -> str:
        return ("abcd" if isinstance(self.latent, ABCDSamplerConfig)
                else "gaussian")

    def check(self) -> None:
        if not isinstance(self.latent, (ABCDSamplerConfig,
                                        GaussianSamplerConfig)):
            raise NotImplementedError(
                f"latent head {type(self.latent).__name__} is not ported")
        check_served(self.encoder, self.latent_type, self.decoder)


def model_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Fresh weights, drawn from ``gen`` in the order encoder, latent head,
    decoder."""
    cfg.check()
    encoder = enc_mod.encoder_init(gen, cfg.encoder)
    lat = cfg.latent
    if cfg.latent_type == "abcd":
        latent = abcd_mod.abcd_init(gen, lat)
    else:
        latent = sampler_mod.sampler_init(gen, lat.input_size,
                                          lat.mlp_hidden_size,
                                          lat.output_size,
                                          lat.distribution_name)
    return {"encoder": encoder, "feature_sampler": latent,
            "decoder": dec_mod.decoder_init(gen, cfg.decoder)}


def set_trainable(params: dict, cfg: ModelConfig) -> dict:
    """Let every leaf of ``params`` require a gradient but the ESN
    reservoirs (the encoder's layers of an ESN encoder, the ESN decoder's
    cell): frozen, as the reference's ``requires_grad=False``, so the
    optimiser neither steps them nor counts them in the clip (the JAX
    package's zero gradient does the same).  Returns ``params``."""
    tree_map(lambda p: p.requires_grad_(True), params)
    frozen = []
    if cfg.encoder.rnn_type == "ESN":
        frozen += params["encoder"]
    if cfg.decoder.rnn_type == "ESN":
        frozen.append(params["decoder"]["rnn_cell"])
    tree_map(lambda p: p.requires_grad_(False), frozen)
    return params


def forward_losses(params: dict, cfg: ModelConfig, *, inputs, lengths,
                   speakers, decoder_noise, entire_data_size,
                   gumbel_noise=None, latent_normals=None, temperature=1.0,
                   no_sample: bool = False,
                   fused_cells=dec_mod.CELLS) -> dict:
    """One forward pass: the three unnormalised loss sums and the head's
    diagnostics (the ABCD logits, or the Gaussian's masked parameters).

    inputs: (B, T, F) padded log-spectrograms; lengths: (B,) frame counts
    (0 marks batch-padding rows); gumbel_noise (B, K) for the ABCD head
    (unused when ``no_sample``); latent_normals (B, f) standard normals for
    the Gaussian head; decoder_noise (T, B, F), or the fused-loss kernels'
    (1, 1) seed; fused_cells: the decoder cells that train on the
    fused-loss kernels (``decoder_losses``).  The Gaussian head ignores
    ``entire_data_size``, ``temperature`` and ``no_sample``.
    """
    row_mask = (lengths > 0).to(inputs.dtype)
    last_hidden = enc_mod.encoder_apply(params["encoder"], cfg.encoder,
                                        inputs, lengths)
    head = params["feature_sampler"]
    if cfg.latent_type == "abcd":
        logits = abcd_mod.abcd_logits(head, last_hidden)
        features = abcd_mod.abcd_sample(head, logits, temperature,
                                        gumbel_noise, no_sample=no_sample)
        kl = abcd_mod.abcd_kl(head, cfg.latent, logits, entire_data_size,
                              row_mask=row_mask)
        latent_info = {"category_logits": logits}
    else:
        name = cfg.latent.distribution_name
        feat_params = tuple(p * row_mask[:, None] for p in
                            sampler_mod.sampler_apply(head, last_hidden))
        features = sampler_mod.sampler_sample(latent_normals, feat_params,
                                              name)
        kl = sampler_mod.sampler_kl(feat_params, name,
                                    mask=row_mask[:, None])
        latent_info = {"feature_parameters": feat_params}
    emission_loss, offset_loss = dec_mod.decoder_losses(
        params["decoder"], cfg.decoder, features, lengths, inputs,
        decoder_noise, speaker=speakers, fused_cells=fused_cells)
    return {"emission_loss": emission_loss, "offset_loss": offset_loss,
            "kl_loss": kl, "num_rows": row_mask.sum(), **latent_info}


def training_loss(params: dict, cfg: ModelConfig, batch: dict, noise: dict,
                  entire_data_size, temperature=1.0, no_sample: bool = False,
                  fused_cells=dec_mod.CELLS):
    """Scalar loss = (emission + offset + KL) / real rows, and the aux
    dict.  ``batch`` holds inputs, lengths, speakers; ``noise`` holds
    ``gumbel`` (the ABCD head) or ``normal`` (the Gaussian head's (B, f)
    standard normals), and ``decoder`` (the (T, B, F) stream, or the
    fused-loss kernels' (1, 1) seed: ``models/decoder.decoder_losses``)."""
    out = forward_losses(params, cfg, inputs=batch["inputs"],
                         lengths=batch["lengths"],
                         speakers=batch.get("speakers"),
                         gumbel_noise=noise.get("gumbel"),
                         latent_normals=noise.get("normal"),
                         decoder_noise=noise["decoder"],
                         entire_data_size=entire_data_size,
                         temperature=temperature, no_sample=no_sample,
                         fused_cells=fused_cells)
    total = out["emission_loss"] + out["offset_loss"] + out["kl_loss"]
    return total / out["num_rows"], out
