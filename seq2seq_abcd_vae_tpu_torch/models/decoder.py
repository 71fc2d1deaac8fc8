"""Autoregressive variational decoder (PyTorch port of
seq2seq_abcd_vae_tpu/models/decoder.py, the unidirectional LSTM, GRU,
Elman RNN and echo-state (ESN) cells).

- latent (+ the speaker embedding, a concatenation) -> initial state via a
  Linear; the LSTM state is the torch interleave hidden.view(B, H, 2):
  h = [..., 0], c = [..., 1]; the other cells' is h = hidden.view(B, H);
- the first input is zero, then the *sampled* emission is fed back: step
  s uses the noise that sampled position s-1;
- losses are unnormalised sums over valid steps: the Gaussian emission
  NLL and the offset BCE against (t == len - 1).

Training (``decoder_losses``) runs the JAX package's ``loss_only`` paths.
A cell in ``fused_cells`` (by default all four) takes the fast path: the
whole loop with both losses in one hand-written kernel
(``ops/decoder_kernel.decoder_loop_fused_losses`` for the LSTM,
``gru_decoder_loop_fused_losses`` for the GRU,
``rnn_decoder_loop_fused_losses`` for the Elman cell and, with its leak
and no biases, the ESN; their plain twins on the CPU), and position T-1's
emission term recomputed here from the last step's hidden state.  Any
other cell takes the stream path (the JAX package's
``SEQ2SEQ_NLL_FUSION=0`` / ``SEQ2SEQ_FUSED_CELLS``, which the training CLI
reads once into that argument): the sampled loop with its hand-written
backward (``decoder_loop``, ``gru_decoder_loop``, ``rnn_decoder_loop``),
then the emission NLL and the offset BCE over its streams.  Both paths
draw on the same noise, so their losses agree up to summation order.
With the JAX package's ``SEQ2SEQ_KERNEL_RNG=1`` (the training CLI's
``kernel_rng``) the noise of a fused cell is a (1, 1) seed, from which the
fused-loss kernels draw each step's noise themselves
(``ops/decoder_kernel.decoder_noise_dump``); only that path takes a seed.
Without offset targets (the JAX ``decoder_apply(loss_only=True,
ground_truth_offset=None)``), the fused LSTM takes
``decoder_loop_fused_nll`` and the offset logits are returned.  The
ESN's reservoir (the cell's ``w_ih`` and ``w_hh``) is frozen: it enters
the loop detached, so gradients reach only the initial state (the latent)
and the emission and offset MLPs, as in the JAX package.

Decoding (``decoder_apply``, every cell) returns the streams, as the JAX
function's non-``loss_only`` path does: ``sample`` mode runs the sampled
loop in one hand-written kernel (``ops/decoder_kernel.decoder_loop`` for
the LSTM, ``gru_decoder_loop`` for the GRU, ``rnn_decoder_loop`` for the
Elman cell and, with its leak and no biases, the ESN).  The LSTM's kernel
writes the position-indexed emission streams, whose slot T-1 is
overwritten from the last step's pre-mask hidden state; the other cells'
kernels return the pre-mask hidden states alone, and the emission MLP then
runs over all (B, T) rows, as in the JAX package.  ``mean`` mode feeds the
emission mean back and runs the JAX package's scan body as a loop of
batched products on the tensors' device (the JAX package takes its
kernels for ``sample`` only).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import distributions as dist
from ..configs import DecoderConfig, check_decoder
from ..ops import decoder_kernel
from . import esn as esn_mod
from . import initializers as init
from . import mlp as mlp_mod
from . import sampler as sampler_mod
from .encoder import NUM_GATES

# the decoder cells; by default each trains on its fused-loss kernels
CELLS = ("LSTM", "GRU", "RNN", "ESN")


class DecoderOutput(NamedTuple):
    emission_loss: Optional[torch.Tensor]  # scalar sum over valid steps
    offset_loss: Optional[torch.Tensor]    # scalar sum over valid steps
    out: torch.Tensor                      # (B, T, F) emitted samples
    emission_params: tuple                 # (mean, log_variance) (B, T, F)
    offset_weights: torch.Tensor           # (B, T) pre-sigmoid logits


def decoder_init(gen: torch.Generator, cfg: DecoderConfig) -> dict:
    feat = cfg.feature_size
    if cfg.has_speaker_embedding:
        feat += cfg.speaker_embed_dim
    params = {
        "feature2hidden": init.linear_params(gen, feat,
                                             cfg.hidden_size_total),
        "rnn_cell": _cell_init(gen, cfg),
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


def _cell_init(gen: torch.Generator, cfg: DecoderConfig) -> dict:
    if cfg.rnn_type == "ESN":
        return esn_mod.esn_layer_init(gen, cfg.output_size,
                                      cfg.rnn_hidden_size)
    return init.rnn_gate_params(gen, cfg.output_size, cfg.rnn_hidden_size,
                                NUM_GATES[cfg.rnn_type])


def split_hidden(cfg: DecoderConfig, hidden: torch.Tensor):
    """(h0, c0) of the initial state: the torch-interleave split of the
    LSTM's; the other cells' h alone, with a zero c."""
    if cfg.rnn_type != "LSTM":
        h = hidden.reshape(hidden.shape[0], cfg.rnn_hidden_size)
        return h.contiguous(), torch.zeros_like(h)
    hc = hidden.reshape(hidden.shape[0], cfg.rnn_hidden_size, 2)
    return hc[..., 0].contiguous(), hc[..., 1].contiguous()


def _initial_state(params: dict, cfg: DecoderConfig, features, speaker):
    """(h0, c0) from the latent (+ the speaker embedding)."""
    if cfg.has_speaker_embedding:
        # a dense gather: padding rows' id -1 takes the last row, as in
        # the JAX package, and their losses are masked
        emb = params["embed_speaker"][speaker.long()]
        features = torch.cat([features, emb], dim=-1)
    lin = params["feature2hidden"]
    return split_hidden(cfg, features @ lin["w"] + lin["b"])


def _loop_weights(params: dict, rnn_type: str = "LSTM") -> dict:
    """The loop's fused operands in decoder_pallas.decoder_loop's layout
    (the GRU's in gru_decoder_loop's: b_ih and b_hh apart, since b_hh sits
    inside the reset product; the ESN's reservoir detached, with a zero
    bias)."""
    cell = params["rnn_cell"]
    if rnn_type == "ESN":
        # frozen before it joins w_cat: the concatenation's gradient then
        # reaches the emission MLP's columns only
        cell = {k: v.detach() for k, v in cell.items()}
    em = params["emission_sampler"]["to_parameters"]
    w1 = em["lin1"]["w"]                                   # (2, H, m)
    w = {"w_cat": torch.cat([cell["w_hh"], w1.permute(1, 0, 2).reshape(
             w1.shape[1], -1)], dim=1),
         "b1": em["lin1"]["b"].reshape(-1), "w2m": em["lin2"]["w"][0],
         "w2v": em["lin2"]["w"][1], "b2": em["lin2"]["b"].reshape(-1),
         "w_ih": cell["w_ih"]}
    if rnn_type == "GRU":
        w.update(b_ih=cell["b_ih"], b_hh=cell["b_hh"])
    elif rnn_type == "ESN":
        w["bias"] = cell["w_hh"].new_zeros(cell["w_hh"].shape[0])
    else:
        w["bias"] = cell["b_ih"] + cell["b_hh"]
    return w


def _sampled(params: dict, cfg: DecoderConfig, w: dict, h0, c0, lengths,
             noise):
    """The sampled loop's pre-mask hidden states (T, B, H) and the
    emission (mean, logvar) of every position (B, T, F), as the kernel
    branch of the JAX package's ``_run_direction``: the LSTM's kernel
    writes the position-indexed emission streams, whose slot T-1 is
    overwritten from the last step's pre-mask hidden state; the other
    cells' return the hidden states alone, and the emission MLP runs over
    all (B, T) rows."""
    loop = (w["b1"], w["w2m"], w["w2v"], w["b2"], w["w_ih"], h0)
    if cfg.rnn_type == "LSTM":
        outs, mean_s, logvar_s = decoder_kernel.decoder_loop(
            noise, lengths, w["w_cat"], w["bias"], *loop, c0)
        # slot T-1 holds step 0's parked emission: the final position's
        # comes from the last step's pre-mask hidden state
        last = sampler_mod.sampler_apply(params["emission_sampler"], outs[-1])
        return outs, tuple(
            torch.cat([p_s[:-1], p_last[None]]).transpose(0, 1)
            for p_s, p_last in zip((mean_s, logvar_s), last))
    if cfg.rnn_type == "GRU":
        outs = decoder_kernel.gru_decoder_loop(
            noise, lengths, w["w_cat"], w["b_ih"], w["b_hh"], *loop)
    else:
        outs = decoder_kernel.rnn_decoder_loop(
            noise, lengths, w["w_cat"], w["bias"], *loop,
            leak=cfg.esn_leak if cfg.rnn_type == "ESN" else 1.0)
    return outs, sampler_mod.sampler_apply(params["emission_sampler"],
                                           outs.transpose(0, 1))


def _bce_sum(z, y, mask):
    """The offset BCE of logits ``z`` against ``y``, summed where
    ``mask``."""
    per = (torch.clamp(z, min=0.0) - z * y
           + torch.log1p(torch.exp(-torch.abs(z))))
    return (per * mask).sum()


def _step_mask(lengths, t: int, dtype):
    return (torch.arange(t, device=lengths.device)[None, :]
            < lengths[:, None]).to(dtype)


def decoder_losses(params: dict, cfg: DecoderConfig, features: torch.Tensor,
                   lengths: torch.Tensor, ground_truth_out: torch.Tensor,
                   noise: torch.Tensor, speaker: torch.Tensor | None = None,
                   *, fused_cells=CELLS, with_offset: bool = True):
    """(emission_loss, offset_loss) of a batch, unnormalised sums: the JAX
    package's ``decoder_apply(loss_only=True)`` with the training offset
    target (t == len - 1).

    Args:
      features: (B, feature_size) latents.
      lengths: (B,) valid steps (0 for batch-padding rows).
      ground_truth_out: (B, T, F) padded targets; T is the bucket.
      noise: (T, B, F) standard normals; position p's sample uses
        ``noise[p]``.  Or, for a cell in ``fused_cells`` with offset
        targets, a (1, 1) float32 seed: the fused-loss kernels' seed mode;
        any other path raises ValueError for it.
      speaker: (B,) int ids when the config embeds speakers.
      fused_cells: the cells that take the fused-loss kernels; any other
        takes the stream path (the sampled loop, then the losses over its
        streams).
      with_offset: False is ``decoder_apply(loss_only=True,
        ground_truth_offset=None)``: returns (emission_loss, offset_logits
        (B, T)), the fused LSTM on ``decoder_loop_fused_nll``.
    """
    h0, c0 = _initial_state(params, cfg, features, speaker)
    w = _loop_weights(params, cfg.rnn_type)
    off = params["offset_predictor"]
    t = ground_truth_out.shape[1]
    lengths = lengths.to(torch.int32)
    noise = noise.contiguous()
    fused_losses = cfg.rnn_type in fused_cells and with_offset
    if noise.dim() == 2 and not fused_losses:
        raise ValueError(
            "a (1, 1) noise seed is the fused-loss kernels' seed mode; the "
            f"{cfg.rnn_type} decoder here takes the "
            + ("fused-NLL loop" if cfg.rnn_type in fused_cells
               else "stream path") + ", which needs the (T, B, F) noise")
    if cfg.rnn_type in fused_cells and (with_offset
                                        or cfg.rnn_type == "LSTM"):
        emission = (w["b1"], w["w2m"], w["w2v"], w["b2"], w["w_ih"],
                    ground_truth_out.transpose(0, 1).contiguous())
        offset = (off["lin1"]["w"], off["lin1"]["b"],
                  off["lin2"]["w"].reshape(-1), off["lin2"]["b"])
        if not with_offset:
            outs, nll = decoder_kernel.decoder_loop_fused_nll(
                noise, lengths, w["w_cat"], w["bias"], *emission, h0, c0)
            out_last = outs[-1]
        elif cfg.rnn_type == "GRU":
            out_last, nll, bce = decoder_kernel.gru_decoder_loop_fused_losses(
                noise, lengths, w["w_cat"], w["b_ih"], w["b_hh"], *emission,
                *offset, h0)
        elif cfg.rnn_type in ("RNN", "ESN"):
            out_last, nll, bce = decoder_kernel.rnn_decoder_loop_fused_losses(
                noise, lengths, w["w_cat"], w["bias"], *emission, *offset,
                h0, leak=cfg.esn_leak if cfg.rnn_type == "ESN" else 1.0)
        else:
            out_last, nll, bce = decoder_kernel.decoder_loop_fused_losses(
                noise, lengths, w["w_cat"], w["bias"], *emission, *offset,
                h0, c0)
        # position T-1's emission term, from the last step's hidden state
        last = sampler_mod.sampler_apply(params["emission_sampler"], out_last)
        mask_last = (lengths > t - 1).to(out_last.dtype)[:, None]
        emission_loss = nll - dist.log_pdf_isotropic_gaussian(
            ground_truth_out[:, -1], *last, mask=mask_last)
        if with_offset:
            return emission_loss, bce
        return emission_loss, mlp_mod.mlp_apply(
            off, outs.transpose(0, 1)).squeeze(-1)
    outs, em = _sampled(params, cfg, w, h0, c0, lengths, noise)
    mask = _step_mask(lengths, t, outs.dtype)
    emission_loss = -dist.log_pdf_isotropic_gaussian(
        ground_truth_out, *em, mask=mask[..., None])
    offset_logits = mlp_mod.mlp_apply(off, outs.transpose(0, 1)).squeeze(-1)
    if not with_offset:
        return emission_loss, offset_logits
    y = (torch.arange(t, device=lengths.device)[None, :]
         == lengths.long()[:, None] - 1).to(offset_logits.dtype)
    return emission_loss, _bce_sum(offset_logits, y, mask)


def _mean_cell(cfg: DecoderConfig, cell: dict, x, big, h, c):
    """(h2, c2) of one step of the JAX package's ``_gate_activations``
    from the fed-back input ``x`` and ``big`` = h @ w_cat; c is the LSTM's
    (passed through by the other cells)."""
    gh = NUM_GATES[cfg.rnn_type] * cfg.rnn_hidden_size
    hp = big[:, :gh]
    if cfg.rnn_type == "ESN":  # no biases
        u = torch.tanh(x @ cell["w_ih"] + hp)
        return (1.0 - cfg.esn_leak) * h + cfg.esn_leak * u, c
    xp = x @ cell["w_ih"] + cell["b_ih"]
    hp = hp + cell["b_hh"]
    if cfg.rnn_type == "LSTM":
        i, f, g, o = (xp + hp).chunk(4, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c2), c2
    if cfg.rnn_type == "GRU":  # b_hh inside the reset product
        xr, xz, xn = xp.chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        return (1.0 - z) * torch.tanh(xn + r * hn) + z * h, c
    return torch.tanh(xp + hp), c


def _mean_loop(params: dict, cfg: DecoderConfig, w: dict, h0, c0, lengths,
               t: int):
    """The JAX scan body in mean mode (models/decoder.py:_run_direction)
    for any cell: the emission mean of the previous position is fed back.
    Returns the pre-mask h2 of every step, (T, B, H)."""
    cell = params["rnn_cell"]
    gh = NUM_GATES[cfg.rnn_type] * cfg.rnn_hidden_size
    f_dim = w["w_ih"].shape[0]
    m = w["w2m"].shape[0]
    steps = torch.arange(t, device=h0.device)[:, None]
    lens = lengths.long()[None, :]
    mt = (steps < lens).unsqueeze(-1)
    pmt = ((steps >= 1) & (steps - 1 < lens)).unsqueeze(-1)
    h, c = h0, c0
    outs = []
    for s in range(t):
        big = h @ w["w_cat"]
        emh = torch.tanh(big[:, gh:] + w["b1"])
        mean = emh[:, :m] @ w["w2m"] + w["b2"][:f_dim]
        x = torch.where(pmt[s], mean, 0.0)
        h2, c2 = _mean_cell(cfg, cell, x, big, h, c)
        h = torch.where(mt[s], h2, h)
        c = torch.where(mt[s], c2, c)
        outs.append(h2)
    return torch.stack(outs)


def decoder_apply(params: dict, cfg: DecoderConfig, features: torch.Tensor,
                  lengths: torch.Tensor, total_steps: int, *,
                  noise: torch.Tensor | None = None,
                  speaker: torch.Tensor | None = None,
                  ground_truth_out: torch.Tensor | None = None,
                  ground_truth_offset: torch.Tensor | None = None,
                  emission_mode: str = "sample") -> DecoderOutput:
    """Decode a batch of latents (the JAX function's deterministic,
    non-``loss_only`` path).

    Args:
      features: (B, feature_size) latents; lengths: (B,) valid steps.
      total_steps: T.
      noise: (T, B, F) standard normals, UNSHIFTED (position p's sample
        uses ``noise[p]``); needed in ``sample`` mode only.
      speaker: (B,) int ids when the config embeds speakers.
      ground_truth_out (B, T, F) / ground_truth_offset (B, T): targets of
        the optional losses.
      emission_mode: ``sample`` (the kernel) or ``mean``.

    Returns a DecoderOutput whose (B, T, .) streams are padding at and
    past ``lengths``.
    """
    check_decoder(cfg, training=False)
    if emission_mode not in ("sample", "mean"):
        raise ValueError(f"unknown emission mode {emission_mode!r}")
    h0, c0 = _initial_state(params, cfg, features, speaker)
    w = _loop_weights(params, cfg.rnn_type)
    lengths = lengths.to(torch.int32)
    if emission_mode == "sample":
        if noise is None or tuple(noise.shape) != (
                total_steps, features.shape[0], cfg.output_size):
            raise ValueError("sample mode needs noise of shape (T, B, F)")
        noise = noise.contiguous()
        outs, em = _sampled(params, cfg, w, h0, c0, lengths, noise)
        out = dist.gaussian_from_noise(noise.transpose(0, 1), *em)
    else:
        outs = _mean_loop(params, cfg, w, h0, c0, lengths, total_steps)
        em = sampler_mod.sampler_apply(params["emission_sampler"],
                                       outs.transpose(0, 1))
        out = em[0]
    rnn_out = outs.transpose(0, 1)                         # (B, T, H)
    offset_logits = mlp_mod.mlp_apply(params["offset_predictor"],
                                      rnn_out).squeeze(-1)
    mask = _step_mask(lengths, total_steps, rnn_out.dtype)
    emission_loss = offset_loss = None
    if ground_truth_out is not None:
        emission_loss = -dist.log_pdf_isotropic_gaussian(
            ground_truth_out, *em, mask=mask[..., None])
    if ground_truth_offset is not None:
        offset_loss = _bce_sum(offset_logits, ground_truth_offset, mask)
    return DecoderOutput(emission_loss, offset_loss, out, em, offset_logits)
