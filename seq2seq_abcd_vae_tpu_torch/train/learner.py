"""Learner: the training and validation runtime (PyTorch port of
seq2seq_abcd_vae_tpu/train/learner.py on one device): the ABCD-VAE, or with
``latent_type="gaussian"`` the plain Gaussian VAE (the reference's
plain/learning.py), which has no pretraining, no temperature and no
clustering metrics.

Contract kept from the JAX package:

- ``save_dir/history.log`` is both the metric log (same line formats) and
  the resume marker;
- one rolling self-describing ``checkpoint.pt`` (v2) with every module's
  init-parameter dict, the optimiser state as the JAX package's optax
  leaves (step count, learning rate, momentum traces), the scheduler
  state, the gradient clip and the random key;
- global-norm clip, SGD, ReduceLROnPlateau on the mean validation loss;
  pretraining epochs run the ABCD head without Gumbel sampling and do not
  advance the temperature counter; the scheduler's best is reset at the
  end of pretraining;
- losses are per-batch sums over the real rows divided by their count;
  epoch lines report per-string means.

A step is eager PyTorch around the hand-written kernels: the STFT
frontend, the encoder (the LSTM's two directions in one kernel or one
direction over the hoisted input projection, or the two directions of the
GRU, the Elman RNN or the echo-state network in one kernel; forward and
backward, the frozen ESN reservoir forward only), the fused-loss LSTM,
GRU or Elman / ESN decoder loop (forward and backward), or, for the cells
left out of ``fused_cells``, the sampled decoder loop (forward and
backward) with the losses over its streams.  Per-batch
metrics stay on the device and are read once per epoch.  The random
draws (the Gumbel noise or the Gaussian head's standard normals, then the
decoder's sampling noise) come from a
``torch.Generator`` on the device, seeded per (epoch, phase) from the
run's key, so a resumed run draws what an uninterrupted one would.  With
``kernel_rng`` (the JAX package's ``SEQ2SEQ_KERNEL_RNG=1``, which the
training CLI honours on the card only) a decoder cell on the fused-loss
path draws a (1, 1) seed below 2^24 in place of its (T, B, F) noise, and
its kernels draw each step's noise from it (``ops/decoder_kernel.
decoder_noise_dump``), in training and validation steps alike.

On the card the Learner owns a ``utils/backend_select.BackendSelector``:
it probes the launch cost when it starts and logs ``Kernel backend:
{report}``, and at each epoch boundary after the first probes again and
logs ``Kernel backend decision: ...``, in the JAX package's formats.  A
decision for ``scan`` stops the run (the port has no scan path on the
card).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import distributions as dist
from ..configs import (ABCDSamplerConfig, DecoderConfig, EncoderConfig,
                       GaussianSamplerConfig, latent_config)
from ..data.batching import DataLoader, FrontendSpec, RawBatch
from ..infer.encode import STFT_METHODS, resolve_device
from ..models import abcd as abcd_mod
from ..models import vae
from ..models.decoder import CELLS
from ..ops import stft as stft_ops
from ..tree import tree_leaves, tree_map, tree_unflatten
from ..utils import backend_select
from . import checkpoint as ckpt
from . import optim
from .from_jax import params_from_jax, params_to_jax
from .logging_utils import close_log_handlers, logger, update_log_handler

@dataclass(frozen=True)
class StepStatics:
    """Everything about a step that is fixed for a run."""
    model: vae.ModelConfig
    frame_length: int
    step_size: int
    window: str
    epsilon: float
    normalizer: float
    stft_method: str = "fft"
    # the decoder cells that train on the fused-loss kernels; the others
    # take the stream path (cli/flags.fused_loss_cells)
    fused_cells: tuple = CELLS
    # the selector's backend (utils/backend_select.py); "scan" on the CPU
    rnn_backend: str = "scan"
    # a fused-loss decoder draws its noise in-kernel from a seed
    # (cli/flags.kernel_rng)
    kernel_rng: bool = False

    @property
    def decoder_seed(self) -> bool:
        """Whether a step draws the decoder's (1, 1) seed in place of its
        (T, B, F) noise: kernel_rng on, the decoder on the fused-loss
        path (the only one that takes a seed, as in the JAX package)."""
        return self.kernel_rng and self.model.decoder.rnn_type in \
            self.fused_cells


def frontend(statics: StepStatics, audio: torch.Tensor,
             bucket_frames: int) -> torch.Tensor:
    with torch.no_grad():
        return stft_ops.log_spectrogram(
            audio, statics.frame_length, statics.step_size, bucket_frames,
            statics.epsilon, statics.normalizer, window=statics.window,
            method=statics.stft_method)


def draw_noise(gen: torch.Generator, cfg: vae.ModelConfig, rows: int,
               bucket_frames: int, device, seed: bool = False) -> dict:
    """The step's random draws, the head's first: Gumbel (B, K) for the
    ABCD head (``gumbel``) or standard normals (B, f) for the Gaussian
    (``normal``), then the decoder's noise (T, B, F) or, with ``seed``, its
    (1, 1) float32 seed below 2^24 (the JAX package's
    ``SEQ2SEQ_KERNEL_RNG`` draw)."""
    if cfg.latent_type == "abcd":
        head = {"gumbel": abcd_mod.gumbel_noise(
            gen, (rows, cfg.latent.num_categories), device)}
    else:
        head = {"normal": dist.gaussian_noise(
            gen, (rows, cfg.latent.output_size), device)}
    if seed:
        decoder = torch.randint(0, 1 << 24, (1, 1), generator=gen,
                                device=device).to(torch.float32)
    else:
        decoder = dist.gaussian_noise(
            gen, (bucket_frames, rows, cfg.decoder.output_size), device)
    return dict(head, decoder=decoder)


def losses_and_metrics(params, statics: StepStatics, audio, num_frames,
                       speakers, noise, entire_n, temperature, no_sample,
                       bucket_frames):
    """The scalar loss and the batch's metrics (detached device scalars:
    the three loss sums, the row count and, for the ABCD head, the three
    perplexities)."""
    inputs = frontend(statics, audio, bucket_frames)
    batch = {"inputs": inputs, "lengths": num_frames, "speakers": speakers}
    loss, aux = vae.training_loss(params, statics.model, batch, noise,
                                  entire_n, temperature=temperature,
                                  no_sample=no_sample,
                                  fused_cells=statics.fused_cells)
    metrics = {k: aux[k].detach() for k in ("emission_loss", "offset_loss",
                                            "kl_loss", "num_rows")}
    metrics["loss"] = loss.detach()
    if statics.model.latent_type != "abcd":
        return loss, metrics
    with torch.no_grad():
        row_mask = (num_frames > 0).to(inputs.dtype)
        probs = torch.softmax(aux["category_logits"], -1)
        ent = -(probs * torch.log(probs)).sum(-1)
        metrics["clustering_perplex"] = torch.exp(
            (ent * row_mask).sum() / aux["num_rows"])
        mean_probs = (probs * row_mask[:, None]).sum(0) / aux["num_rows"]
        mean_probs = mean_probs / mean_probs.sum()
        metrics["batch_perplex"] = torch.exp(
            -(mean_probs * torch.log(mean_probs)).sum())
        shape = torch.softmax(
            params["feature_sampler"]["posterior_shape_logits"], -1)
        metrics["posterior_shape_perplex"] = torch.exp(
            -(shape * torch.log(shape)).sum())
    return loss, metrics


def _fetch(pending: list) -> list:
    """Per-batch metric dicts of device scalars -> host floats, in one
    transfer."""
    if not pending:
        return []
    keys = list(pending[0])
    stacked = torch.stack([torch.stack([m[k].float() for k in keys])
                           for m in pending]).cpu().numpy()
    return [dict(zip(keys, map(float, row))) for row in stacked]


class Learner:
    """Builds (or retrieves) the model and runs the training loop."""

    def __init__(self,
                 input_size: Optional[int] = None,
                 encoder_rnn_hidden_size: int = 256,
                 decoder_rnn_hidden_size: int = 256,
                 mlp_hidden_size: int = 256,
                 num_feature_categories: int = 128,  # abcd
                 feature_dim: int = 256,             # abcd
                 feature_size: Optional[int] = None,  # gaussian
                 save_dir: str = ".",
                 latent_type: str = "abcd",
                 feature_distribution: str = "isotropic_gaussian",
                 encoder_rnn_type: str = "LSTM",
                 decoder_rnn_type: str = "LSTM",
                 encoder_rnn_layers: int = 1,
                 bidirectional_encoder: bool = True,
                 bidirectional_decoder: bool = False,
                 right2left_decoder_weight: float = 0.5,
                 encoder_hidden_dropout: float = 0.0,
                 decoder_input_dropout: float = 0.0,
                 device: str = "cuda",
                 seed: int = 1111,
                 emission_distribution: str = "isotropic_gaussian",
                 decoder_self_feedback: bool = True,
                 esn_leak: float = 1.0,
                 num_speakers: Optional[int] = None,
                 speaker_embed_dim: Optional[int] = None,
                 prior_concentration: float = 1.0,
                 stft_method: str = "fft",
                 batching_mode: Optional[str] = None,
                 fused_cells: tuple = CELLS,
                 kernel_rng: bool = False):
        if stft_method not in STFT_METHODS:
            raise ValueError(f"unknown stft method: {stft_method}")
        self.device = resolve_device(device)
        self.fused_cells = tuple(fused_cells)
        self.kernel_rng = kernel_rng
        self.retrieval, self.log_file_path = update_log_handler(save_dir)
        self.save_dir = save_dir
        self.stft_method = stft_method
        self.batching_mode = batching_mode or "bucket_shuffled"
        self.steps = {"train": 0, "eval": 0}
        self.epoch_seconds: list[tuple[int, float, int]] = []
        logger.info("Device: {device}".format(device=self.device))
        # the launch-cost probe and backend decision, once, before the
        # model
        self.selector = backend_select.for_device(self.device)
        self.rnn_backend = "scan"
        if self.selector.platform != "cpu":
            logger.info("Kernel backend: {r}".format(
                r=self.selector.report()))
            self.rnn_backend = backend_select.require_kernels(
                self.selector, self.selector.current())

        if self.retrieval:
            self.last_epoch = self.retrieve_model()
            logger.info("Model retrieved.")
            return

        # the JAX package's PRNGKey(seed) layout: the run's key
        self.key = np.asarray([0, seed & 0xFFFFFFFF], np.uint32)
        if encoder_hidden_dropout > 0.0 and encoder_rnn_layers == 1:
            logger.warning(
                "Non-zero dropout cannot be used for the single-layer "
                "encoder RNN (because there is no non-top hidden layers).")
            logger.info("encoder_hidden_dropout reset from {do} to "
                        "0.0.".format(do=encoder_hidden_dropout))
            encoder_hidden_dropout = 0.0
        enc_cfg = EncoderConfig(
            input_size, encoder_rnn_hidden_size, rnn_type=encoder_rnn_type,
            rnn_layers=encoder_rnn_layers,
            hidden_dropout=encoder_hidden_dropout,
            bidirectional=bidirectional_encoder, esn_leak=esn_leak)
        if latent_type == "abcd":
            latent_cfg = ABCDSamplerConfig(
                enc_cfg.hidden_size_total, mlp_hidden_size,
                num_feature_categories, feature_dim,
                prior_concentration=prior_concentration)
            latent_width = feature_dim
        elif latent_type == "gaussian":
            if feature_size is None:
                raise ValueError("the plain VAE needs a feature_size")
            latent_cfg = GaussianSamplerConfig(
                enc_cfg.hidden_size_total, mlp_hidden_size, feature_size,
                distribution_name=feature_distribution)
            latent_width = feature_size
        else:
            raise ValueError(f"unknown latent type {latent_type!r}")
        dec_cfg = DecoderConfig(
            input_size, decoder_rnn_hidden_size, mlp_hidden_size,
            latent_width, emission_distr_name=emission_distribution,
            rnn_type=decoder_rnn_type, input_dropout=decoder_input_dropout,
            self_feedback=decoder_self_feedback,
            bidirectional=bidirectional_decoder,
            right2left_weight=right2left_decoder_weight, esn_leak=esn_leak,
            num_speakers=num_speakers, speaker_embed_dim=speaker_embed_dim)
        self.model_cfg = vae.ModelConfig(enc_cfg, latent_cfg, dec_cfg)
        gen = torch.Generator().manual_seed(seed)
        self.params = vae.set_trainable(
            tree_map(lambda t: t.to(self.device),
                     vae.model_init(gen, self.model_cfg)), self.model_cfg)
        self.iter_counts = 0
        self.epoch_init_iter_counts = 0
        self.step_count = 0

        if latent_type == "abcd":
            logger.info("Data are encoded into one of {num_cat} possible "
                        "{feature_dim}-dim feature vectors.".format(
                            num_cat=num_feature_categories,
                            feature_dim=feature_dim))
            logger.info("Discrete categories are assumed to be distributed "
                        "according to Categorical(pi), with Dirichlet({}) "
                        "prior on pi.".format(prior_concentration))
            logger.info("Conditioned on the RNN-transformed features, data "
                        "are assumed to be distributed according to "
                        "{emission_distribution}".format(
                            emission_distribution=emission_distribution))
        else:
            logger.info("Data to be encoded into {feature_size}-dim "
                        "features.".format(feature_size=feature_size))
            logger.info("Features are assumed to be distributed according "
                        "to {feature_distribution}.".format(
                            feature_distribution=feature_distribution))
            logger.info("Conditioned on the features, data are assumed to "
                        "be distributed according to "
                        "{emission_distribution}".format(
                            emission_distribution=emission_distribution))
        logger.info("Random seed: {seed}".format(seed=seed))
        logger.info("Type of RNN used for the encoder: {rnn_type}".format(
            rnn_type=encoder_rnn_type))
        logger.info("Type of RNN used for the decoder: {rnn_type}".format(
            rnn_type=decoder_rnn_type))
        logger.info("# of RNN hidden layers in the encoder RNN: {hl}".format(
            hl=encoder_rnn_layers))
        logger.info("# of hidden units in the encoder RNNs: {hs}".format(
            hs=encoder_rnn_hidden_size))
        logger.info("# of hidden units in the decoder RNNs: {hs}".format(
            hs=decoder_rnn_hidden_size))
        logger.info("# of hidden units in the MLPs: {hs}".format(
            hs=mlp_hidden_size))
        if latent_type == "abcd":
            if bidirectional_encoder:
                logger.info("Encoder is bidirectional.")
        else:
            # the reference's plain/learning.py:102-103
            logger.info("Encoder is bidirectional: "
                        "{bidirectional_encoder}".format(
                            bidirectional_encoder=bidirectional_encoder))
            logger.info("Decoder is bidirectional: "
                        "{bidirectional_decoder}".format(
                            bidirectional_decoder=bidirectional_decoder))
        logger.info("Dropout rate in the non-top layers of the encoder "
                    "RNN: {do}".format(do=encoder_hidden_dropout))
        logger.info("Self-feedback to the decoder: "
                    "{decoder_self_feedback}".format(
                        decoder_self_feedback=decoder_self_feedback))
        if decoder_self_feedback:
            logger.info("Dropout rate in the input to the decoder RNN: "
                        "{do}".format(do=decoder_input_dropout))
        if encoder_rnn_type == "ESN" or decoder_rnn_type == "ESN":
            logger.info("ESN leak: {leak}".format(leak=esn_leak))
        if speaker_embed_dim is not None:
            logger.info("Speaker ID # is embedded and fed to the decoder.")
            logger.info("# of speakers: {num_speakers}".format(
                num_speakers=num_speakers))
            logger.info("Embedding dimension: {speaker_embed_dim}".format(
                speaker_embed_dim=speaker_embed_dim))

    # ------------------------------------------------------------------
    def _leaves(self) -> list:
        return tree_leaves(self.params)

    def _trainable(self) -> list:
        """The leaves the optimiser steps and clips: all but a frozen ESN
        reservoir's."""
        return [p for p in self._leaves() if p.requires_grad]

    def _generator(self, epoch: int, phase: int) -> torch.Generator:
        """The draws of one (epoch, phase), seeded from the run's key."""
        k0, k1 = (int(v) for v in np.asarray(self.key).reshape(-1)[:2])
        seed = ((k0 << 32 | k1) * 1000003 + epoch * 2 + phase) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(seed)

    @property
    def latent_type(self) -> str:
        return self.model_cfg.latent_type

    def _temperature(self) -> float:
        if self.latent_type != "abcd":
            return 1.0
        return abcd_mod.temperature_for_iter(self.model_cfg.latent,
                                             self.iter_counts)

    def _place(self, batch: RawBatch):
        dev = self.device
        return (torch.from_numpy(batch.audio).to(dev),
                torch.from_numpy(batch.num_frames).to(dev),
                torch.from_numpy(batch.speakers).to(dev))

    # ------------------------------------------------------------------
    def train_step(self, batch: RawBatch, statics: StepStatics,
                   gen: torch.Generator, entire_n: float,
                   no_sample: bool) -> dict:
        audio, num_frames, speakers = self._place(batch)
        noise = draw_noise(gen, self.model_cfg, len(batch.num_frames),
                           batch.bucket_frames, self.device,
                           seed=statics.decoder_seed)
        loss, metrics = losses_and_metrics(
            self.params, statics, audio, num_frames, speakers, noise,
            entire_n, self._temperature(), no_sample, batch.bucket_frames)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optim.clip_and_step(self.optimizer, self._trainable(),
                            self.gradient_clip)
        self.step_count += 1
        self.steps["train"] += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: RawBatch, statics: StepStatics,
                  gen: torch.Generator, entire_n: float,
                  no_sample: bool) -> dict:
        audio, num_frames, speakers = self._place(batch)
        noise = draw_noise(gen, self.model_cfg, len(batch.num_frames),
                           batch.bucket_frames, self.device,
                           seed=statics.decoder_seed)
        _, metrics = losses_and_metrics(
            self.params, statics, audio, num_frames, speakers, noise,
            entire_n, self._temperature(), no_sample, batch.bucket_frames)
        self.steps["eval"] += 1
        return metrics

    def train(self, dataloader: DataLoader, statics: StepStatics,
              epoch: int, is_pretraining: bool = False) -> None:
        """One training epoch."""
        num_batches = dataloader.get_num_batches()
        num_strings = len(dataloader.dataset)
        abcd = self.latent_type == "abcd"
        gen = self._generator(epoch, 0)
        t0 = time.perf_counter()
        pending = []
        for batch in dataloader:
            pending.append(self.train_step(batch, statics, gen,
                                           float(num_strings),
                                           is_pretraining))
            if abcd and not is_pretraining:
                self.iter_counts += 1
        fetched = _fetch(pending)  # waits for the epoch's last step
        self.epoch_seconds.append((epoch, time.perf_counter() - t0,
                                   num_strings))
        sums = {"emission_loss": 0.0, "offset_loss": 0.0, "kl_loss": 0.0}
        for batch_ix, m in enumerate(fetched, 1):
            for k in sums:
                sums[k] += m[k]
            if not abcd:
                logger.info("{batch_ix}/{num_batches} training batches "
                            "complete. mean loss: {loss:5.4f}".format(
                                batch_ix=batch_ix, num_batches=num_batches,
                                loss=m["loss"]))
                continue
            logger.info(
                "{batch_ix}/{num_batches} training batches complete. "
                "mean loss: {loss:5.4f}. Perplexity of the posterior "
                "clustering probs.: {cluster_perplex:5.4f}. Perplexity "
                "of the mean clustering probs. over minibatch: "
                "{batch_perplex:5.4f}. Perplexity of the posterior "
                "Dirichlet shape: {shape_perplex:5.4f}".format(
                    batch_ix=batch_ix, num_batches=num_batches,
                    loss=m["loss"],
                    shape_perplex=m["posterior_shape_perplex"],
                    batch_perplex=m["batch_perplex"],
                    cluster_perplex=m["clustering_perplex"]))
        emission, offset, kl = (sums[k] / num_strings for k in sums)
        logger.info("mean training emission negative pdf loss (per string): "
                    "{:5.4f}".format(emission))
        logger.info("mean training end-prediction loss (per string): "
                    "{:5.4f}".format(offset))
        logger.info("mean training KL (per string): {:5.4f}".format(kl))
        logger.info("mean training total loss (per string): "
                    "{:5.4f}".format(emission + offset + kl))
        self.epoch_init_iter_counts = self.iter_counts

    def test_or_validate(self, dataloader: DataLoader, statics: StepStatics,
                         epoch: int, is_pretraining: bool = False) -> float:
        num_batches = dataloader.get_num_batches()
        num_strings = len(dataloader.dataset)
        gen = self._generator(epoch, 1)
        pending = [self.eval_step(batch, statics, gen, float(num_strings),
                                  is_pretraining)
                   for batch in dataloader]
        sums = {"emission_loss": 0.0, "offset_loss": 0.0, "kl_loss": 0.0}
        for batch_ix, m in enumerate(_fetch(pending), 1):
            for k in sums:
                sums[k] += m[k]
            logger.info("{batch_ix}/{num_batches} validation batches "
                        "complete.".format(batch_ix=batch_ix,
                                           num_batches=num_batches))
        emission, offset, kl = (sums[k] / num_strings for k in sums)
        mean_loss = emission + offset + kl
        logger.info("mean validation emission negative pdf loss (per "
                    "string): {:5.4f}".format(emission))
        logger.info("mean validation end-prediction loss (per string): "
                    "{:5.4f}".format(offset))
        logger.info("mean validation KL (per string): "
                    "{:5.4f}".format(kl))
        logger.info("mean validation total loss (per string): "
                    "{:5.4f}".format(mean_loss))
        return mean_loss

    # ------------------------------------------------------------------
    def learn(self, train_dataset, valid_dataset, num_epochs,
              batch_size_train, batch_size_valid, frontend: FrontendSpec,
              epsilon: float = 2.0 ** -15, data_normalizer: float = 1.0,
              pretrain_epochs: int = 0, learning_rate: float = 0.1,
              momentum: float = 0.9, gradient_clip: float = 0.25,
              patience: int = 0) -> None:
        mode = self.batching_mode
        train_dataloader = DataLoader(train_dataset, frontend,
                                      batch_size=batch_size_train,
                                      shuffle=True, batching_mode=mode)
        valid_dataloader = DataLoader(
            valid_dataset, frontend, batch_size=batch_size_valid,
            batching_mode="uniform" if mode == "uniform" else
            "length_sorted")
        statics = StepStatics(self.model_cfg, frontend.frame_length,
                              frontend.step_size, frontend.window, epsilon,
                              data_normalizer, self.stft_method,
                              self.fused_cells, self.rnn_backend,
                              self.kernel_rng)

        if self.retrieval:
            initial_epoch = self.last_epoch + 1
            logger.info("To be restarted from the beginning of epoch #: "
                        "{epoch}".format(epoch=initial_epoch))
            self.gradient_clip = self.checkpoint["gradient_clip"]
            momentum = self.checkpoint.get("momentum", momentum)
            self.optimizer = optim.make_optimizer(self._trainable(),
                                                  learning_rate, momentum)
            saved = self.checkpoint.get("optimizer")
            if isinstance(saved, ckpt.OptimizerLeaves):
                self._load_optimizer_leaves(saved.leaves, momentum)
            self.lr_scheduler = optim.ReduceLROnPlateau()
            self.lr_scheduler.load_state_dict(
                self.checkpoint["lr_scheduler"])
        else:
            self.gradient_clip = gradient_clip
            self.optimizer = optim.make_optimizer(self._trainable(),
                                                  learning_rate, momentum)
            self.lr_scheduler = optim.ReduceLROnPlateau(patience=patience)
            logger.info("START LEARNING.")
            logger.info("max # of epochs: {ep}".format(ep=num_epochs))
            if self.latent_type == "abcd":
                logger.info("first {} epochs are for pretraining w/o "
                            "gumbel-softmax sampling.".format(
                                pretrain_epochs))
            logger.info("batch size for training data: {size}".format(
                size=batch_size_train))
            logger.info("batch size for validation data: {size}".format(
                size=batch_size_valid))
            logger.info("initial learning rate: {lr}".format(
                lr=learning_rate))
            logger.info("momentum for SGD: {momentum}".format(
                momentum=momentum))
            logger.info("gradient clipping: {gc}".format(
                gc=self.gradient_clip))
            initial_epoch = 1
        self._momentum = momentum

        for epoch in range(initial_epoch, num_epochs + 1):
            if epoch > initial_epoch and self.selector.platform != "cpu":
                self._reprobe(epoch)
            logger.info("START OF EPOCH: {:3d}".format(epoch))
            logger.info("current learning rate: {lr}".format(
                lr=optim.get_learning_rate(self.optimizer)))
            is_pretrain = (self.latent_type == "abcd"
                           and epoch <= pretrain_epochs)
            logger.info("start of TRAINING phase.")
            self.train(train_dataloader, statics, epoch, is_pretrain)
            logger.info("end of TRAINING phase.")
            logger.info("start of VALIDATION phase.")
            mean_valid_loss = self.test_or_validate(valid_dataloader,
                                                    statics, epoch,
                                                    is_pretrain)
            logger.info("end of VALIDATION phase.")
            new_lr = self.lr_scheduler.step(
                mean_valid_loss, optim.get_learning_rate(self.optimizer))
            optim.set_learning_rate(self.optimizer, new_lr)
            if self.latent_type == "abcd" and epoch == pretrain_epochs:
                self.lr_scheduler.reset_best()
                logger.info("END OF PRETRAINING.")
            self.save_model(epoch)
            logger.info("END OF EPOCH: {:3d}".format(epoch))
        logger.info("END OF TRAINING")
        close_log_handlers()

    def _reprobe(self, epoch: int) -> None:
        """The epoch boundary's probe and its history.log line, in the
        JAX package's format (train/learner.py:686-705); a decision for
        ``scan`` raises (require_kernels)."""
        prev = self.rnn_backend
        choice = self.selector.maybe_reprobe(context=f"epoch {epoch}")
        if self.selector.decisions:
            d = self.selector.decisions[-1]
            logger.info("Kernel backend decision: {b} (dispatch {ms} ms)"
                        "{sw}".format(
                            b=d["backend"], ms=d["dispatch_ms"],
                            sw=(" -- SWITCHED from %s" % prev)
                            if d["switched"] else ""))
        self.rnn_backend = backend_select.require_kernels(self.selector,
                                                          choice)

    # ------------------------------------------------------------------
    def _optimizer_leaves(self) -> list:
        """The optax leaves of the JAX package's optimiser state: step
        count, learning rate, then (with momentum) the traces in its
        parameter order (zeros for a frozen ESN reservoir, as the JAX
        package's zero gradients leave them)."""
        leaves = [np.asarray(self.step_count, np.int32),
                  np.asarray(optim.get_learning_rate(self.optimizer),
                             np.float32)]
        if self._momentum:
            def trace(p):
                buf = self.optimizer.state.get(p, {}).get("momentum_buffer")
                return torch.zeros_like(p) if buf is None else buf
            leaves += tree_leaves(params_to_jax(tree_map(trace,
                                                         self.params)))
        return leaves

    def _load_optimizer_leaves(self, leaves: list, momentum: float) -> None:
        self.step_count = int(np.asarray(leaves[0]))
        optim.set_learning_rate(self.optimizer, float(np.asarray(leaves[1])))
        if not momentum or len(leaves) <= 2:
            return
        template = params_to_jax(self.params)
        traces = tree_unflatten(template, list(leaves[2:]))
        cfg = self.model_cfg
        buffers = params_from_jax(traces, cfg.encoder, self.device,
                                  decoder_cfg=cfg.decoder)
        for p, buf in zip(self._leaves(), tree_leaves(buffers)):
            if p.requires_grad:
                self.optimizer.state[p]["momentum_buffer"] = buf

    def save_model(self, epoch: int) -> None:
        cfg = self.model_cfg
        latent_init = cfg.latent.pack_init_parameters()
        if self.latent_type == "abcd":
            latent_init["epoch_init_iter_counts"] = (
                self.epoch_init_iter_counts)
        tree = params_to_jax(self.params)
        payload = {
            "epoch": epoch,
            "latent_type": self.latent_type,
            "encoder": tree["encoder"],
            "encoder_init_parameters": cfg.encoder.pack_init_parameters(),
            "feature_sampler": tree["feature_sampler"],
            "feature_sampler_init_parameters": latent_init,
            "decoder": tree["decoder"],
            "decoder_init_parameters": cfg.decoder.pack_init_parameters(),
            "optimizer": ckpt.OptimizerLeaves(self._optimizer_leaves()),
            "momentum": self._momentum,
            "lr_scheduler": self.lr_scheduler.state_dict(),
            "gradient_clip": self.gradient_clip,
            "random_state": np.asarray(self.key, np.uint32),
        }
        ckpt.save_checkpoint(self.save_dir, payload)
        logger.info("Config successfully saved.")

    def retrieve_model(self, checkpoint_path: Optional[str] = None) -> int:
        """Rebuild the model from the self-describing checkpoint (written
        by either package)."""
        if checkpoint_path is None:
            checkpoint_path = os.path.join(self.save_dir,
                                           ckpt.CHECKPOINT_NAME)
        self.checkpoint = c = ckpt.load_checkpoint(checkpoint_path)
        enc_cfg = EncoderConfig.from_init_parameters(
            c["encoder_init_parameters"])
        latent_cfg = latent_config(c.get("latent_type", "abcd"),
                                   c["feature_sampler_init_parameters"])
        dec_cfg = DecoderConfig.from_init_parameters(
            c["decoder_init_parameters"])
        self.model_cfg = vae.ModelConfig(enc_cfg, latent_cfg, dec_cfg)
        self.model_cfg.check()
        counts = getattr(latent_cfg, "epoch_init_iter_counts", 0)
        self.iter_counts = self.epoch_init_iter_counts = counts
        self.params = vae.set_trainable(
            params_from_jax(c, enc_cfg, self.device, decoder_cfg=dec_cfg),
            self.model_cfg)
        self.gradient_clip = c["gradient_clip"]
        self.key = np.asarray(c["random_state"]).astype(np.uint32)
        self.step_count = 0
        return c["epoch"]
