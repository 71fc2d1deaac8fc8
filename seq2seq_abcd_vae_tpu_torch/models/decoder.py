"""Autoregressive variational decoder, training losses (PyTorch port of
seq2seq_abcd_vae_tpu/models/decoder.py, unidirectional LSTM only).

- latent (+ the speaker embedding, a concatenation) -> initial (h, c) via
  a Linear; the LSTM state is the torch interleave hidden.view(B, H, 2):
  h = [..., 0], c = [..., 1];
- the first input is zero, then the *sampled* emission is fed back: step
  s uses the noise that sampled position s-1;
- losses are unnormalised sums over valid steps: the Gaussian emission
  NLL and the offset BCE against (t == len - 1).

Training runs the JAX package's ``loss_only`` fast path: the whole loop
with both losses in one hand-written kernel
(``ops/decoder_kernel.decoder_loop_fused_losses``, its plain twin on the
CPU), and position T-1's emission term recomputed here from the last
step's hidden state.
"""

from __future__ import annotations

import torch

from .. import distributions as dist
from ..configs import DecoderConfig
from ..ops import decoder_kernel
from . import initializers as init
from . import mlp as mlp_mod
from . import sampler as sampler_mod


def decoder_init(gen: torch.Generator, cfg: DecoderConfig) -> dict:
    feat = cfg.feature_size
    if cfg.has_speaker_embedding:
        feat += cfg.speaker_embed_dim
    params = {
        "feature2hidden": init.linear_params(gen, feat,
                                             cfg.hidden_size_total),
        "rnn_cell": init.rnn_gate_params(gen, cfg.output_size,
                                         cfg.rnn_hidden_size, 4),
        "emission_sampler": sampler_mod.sampler_init(
            gen, cfg.rnn_hidden_size, cfg.mlp_hidden_size, cfg.output_size,
            cfg.emission_distr_name),
        "offset_predictor": mlp_mod.mlp_init(gen, cfg.rnn_hidden_size,
                                             cfg.mlp_hidden_size, 1),
    }
    if cfg.has_speaker_embedding:
        params["embed_speaker"] = init.normal_params(
            gen, (cfg.num_speakers, cfg.speaker_embed_dim))
    return params


def split_hidden(cfg: DecoderConfig, hidden: torch.Tensor):
    """Torch-interleave split of the initial LSTM state."""
    hc = hidden.reshape(hidden.shape[0], cfg.rnn_hidden_size, 2)
    return hc[..., 0].contiguous(), hc[..., 1].contiguous()


def decoder_losses(params: dict, cfg: DecoderConfig, features: torch.Tensor,
                   lengths: torch.Tensor, ground_truth_out: torch.Tensor,
                   noise: torch.Tensor, speaker: torch.Tensor | None = None):
    """(emission_loss, offset_loss) of a batch, unnormalised sums.

    Args:
      features: (B, feature_size) latents.
      lengths: (B,) valid steps (0 for batch-padding rows).
      ground_truth_out: (B, T, F) padded targets; T is the bucket.
      noise: (T, B, F) standard normals; position p's sample uses
        ``noise[p]``.
      speaker: (B,) int ids when the config embeds speakers.
    """
    if cfg.has_speaker_embedding:
        # a dense gather: padding rows' id -1 takes the last row, as in
        # the JAX package, and their losses are masked
        emb = params["embed_speaker"][speaker.long()]
        features = torch.cat([features, emb], dim=-1)
    lin = params["feature2hidden"]
    h0, c0 = split_hidden(cfg, features @ lin["w"] + lin["b"])
    cell = params["rnn_cell"]
    em = params["emission_sampler"]["to_parameters"]
    off = params["offset_predictor"]
    w1 = em["lin1"]["w"]                                   # (2, H, m)
    w_cat = torch.cat([cell["w_hh"],
                       w1.permute(1, 0, 2).reshape(w1.shape[1], -1)],
                      dim=1)
    t = ground_truth_out.shape[1]
    lengths = lengths.to(torch.int32)
    out_last, nll, bce = decoder_kernel.decoder_loop_fused_losses(
        noise.contiguous(), lengths, w_cat, cell["b_ih"] + cell["b_hh"],
        em["lin1"]["b"].reshape(-1), em["lin2"]["w"][0], em["lin2"]["w"][1],
        em["lin2"]["b"].reshape(-1), cell["w_ih"],
        ground_truth_out.transpose(0, 1).contiguous(), off["lin1"]["w"],
        off["lin1"]["b"], off["lin2"]["w"].reshape(-1), off["lin2"]["b"],
        h0, c0)
    # position T-1's emission term, from the last step's hidden state
    last = sampler_mod.sampler_apply(params["emission_sampler"], out_last)
    mask_last = (lengths > t - 1).to(out_last.dtype)[:, None]
    emission_loss = nll - dist.log_pdf_isotropic_gaussian(
        ground_truth_out[:, -1], *last, mask=mask_last)
    return emission_loss, bce
