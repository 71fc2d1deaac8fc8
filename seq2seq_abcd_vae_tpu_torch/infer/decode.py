"""Post-training decoding: generate spectrograms from latents (PyTorch port
of seq2seq_abcd_vae_tpu/infer/decode.py).

``decode_features`` runs the decoder generatively, deterministically,
from latent features of either head (the ABCD head's codes or the plain
VAE's Gaussian features), in
``sample`` mode (the sampled emission is fed back, through the
hand-written loop kernel of the decoder's cell on the card:
``decoder_loop`` for the LSTM, ``gru_decoder_loop`` for the GRU,
``rnn_decoder_loop`` for the Elman RNN and the ESN) or ``mean`` mode (the
reference's ``sampler2mean``: the emission mean is fed back and
returned).  Being deterministic, it decodes checkpoints trained with
decoder input dropout or ``--greedy_decoder`` as the JAX package does: on
the same sampled loop, since both act only in training.  The JAX function
draws its noise inside the call from a key;
here the noise is an argument, or drawn from a ``torch.Generator``, so a
caller (and a parity test) can hand both packages the same draws.
"""

from __future__ import annotations

import torch

from .. import distributions as dist
from ..configs import (DecoderConfig, EncoderConfig, check_decoder,
                       latent_config)
from ..models import decoder as dec_mod
from ..models import vae
from ..train import checkpoint as ckpt
from ..train.from_jax import params_from_jax
from .encode import resolve_device


def load_model(model_path: str, device: str = "cuda"):
    """(params, cfg) of a ``checkpoint.pt`` written by either package (an
    ABCD-VAE or a plain Gaussian VAE), on ``device`` (the card unless the
    CPU is asked for)."""
    c = ckpt.load_checkpoint(model_path)
    cfg = vae.ModelConfig(
        EncoderConfig.from_init_parameters(c["encoder_init_parameters"]),
        latent_config(c.get("latent_type", "abcd"),
                      c["feature_sampler_init_parameters"]),
        DecoderConfig.from_init_parameters(c["decoder_init_parameters"]))
    check_decoder(cfg.decoder, training=False)
    params = params_from_jax(c, cfg.encoder, resolve_device(device),
                             decoder_cfg=cfg.decoder)
    return params, cfg


@torch.inference_mode()
def decode_features(params: dict, cfg, features: torch.Tensor,
                    lengths: torch.Tensor, total_steps: int, *,
                    noise: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    speaker: torch.Tensor | None = None,
                    emission_mode: str = "sample") -> dec_mod.DecoderOutput:
    """Run the decoder generatively from latent features.

    Args:
      params: the model's parameters (``params["decoder"]`` is used).
      cfg: the model's ``vae.ModelConfig``.
      features: (B, feature_size) latents; lengths: (B,) valid steps.
      total_steps: T.
      noise: (T, B, F) standard normals for ``sample`` mode; drawn from
        ``generator`` (on the features' device) when None.
      speaker: (B,) int ids when the decoder embeds speakers.

    Returns the DecoderOutput with (B, T, F) arrays; positions at or past
    ``lengths`` are padding.
    """
    if emission_mode == "sample" and noise is None:
        if generator is None:
            raise ValueError("sample mode needs noise or a generator")
        noise = dist.gaussian_noise(
            generator, (total_steps, features.shape[0],
                        cfg.decoder.output_size), features.device)
    return dec_mod.decoder_apply(
        params["decoder"], cfg.decoder, features, lengths, total_steps,
        noise=noise, speaker=speaker, emission_mode=emission_mode)
