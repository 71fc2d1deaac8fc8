"""Training entry point of the port, the ABCD-VAE:

    python -m seq2seq_abcd_vae_tpu_torch.cli.learning_main INPUT_ROOT \\
        ANNOTATION.csv -S SAVE_ROOT -j JOB [-d cuda|cpu] [options]

and the plain Gaussian VAE (the reference's plain/learning.py; ``-f`` is
the feature size, default 16):

    python -m seq2seq_abcd_vae_tpu_torch.cli.plain_learning INPUT_ROOT \\
        ANNOTATION.csv -S SAVE_ROOT -j JOB [-f 16] [-d cuda|cpu] [options]

The flow of seq2seq_abcd_vae_tpu/cli/learning_main.py: save-dir layout,
speaker_coding.json persistence (the ABCD-VAE's only), STFT geometry
derived from the first wav's sampling rate, the decoder's cell defaulting to the encoder's, the
validation batch defaulting to the training batch.  Runs on the card
unless ``-d cpu``.  ``SEQ2SEQ_NLL_FUSION=0`` (every decoder cell) or
``SEQ2SEQ_FUSED_CELLS`` (the GRU, RNN and ESN cells it does not list)
trains the decoder on its stream path instead of the fused-loss kernels,
as in the JAX package (``cli/flags.fused_loss_cells``).  On the card,
``SEQ2SEQ_KERNEL_RNG=1`` makes the fused-loss kernels draw the decoder's
sampling noise in-kernel from a seed (``cli/flags.kernel_rng``), and the
Learner probes the launch cost and logs its ``Kernel backend`` decisions
(``utils/backend_select.py``).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..data.annotations import AnnotationParser
from ..data.batching import FrontendSpec
from ..train.learner import Learner
from ..train.logging_utils import logger
from . import flags


def get_save_dir(save_root: str, job_id_str: str) -> str:
    save_dir = os.path.join(save_root, job_id_str)
    os.makedirs(save_dir, exist_ok=True)
    return save_dir


def main(argv=None, variant: str = "abcd") -> Learner:
    """Train the ``abcd`` or the ``plain`` variant from the command line
    ``argv``; returns the Learner."""
    parameters = flags.build_learning_parser(variant).parse_args(argv)
    flags.refuse_unported(parameters, os.environ, "learning")
    # the JAX package's switches of the decoder's training path, read once
    fused_cells = flags.fused_loss_cells(os.environ)
    kernel_rng = flags.kernel_rng(os.environ, parameters.device)
    flags.apply_matmul_precision(parameters)

    save_root = parameters.save_root
    if save_root is None:
        save_root = parameters.input_root
    save_dir = get_save_dir(save_root, parameters.job_id)

    speaker2ix = None
    speaker_coding_path = os.path.join(save_dir, "speaker_coding.json")
    if variant == "abcd" and os.path.isfile(speaker_coding_path):
        with open(speaker_coding_path, "r") as f:
            speaker2ix = json.load(f)
    data_parser = AnnotationParser(parameters.input_root,
                                   parameters.annotation_file,
                                   annotation_sep=parameters.annotation_sep,
                                   speaker2ix=speaker2ix)
    fs = data_parser.get_sample_freq()
    num_speakers = data_parser.get_num_speakers()
    if variant == "abcd" and num_speakers > 0 and speaker2ix is None:
        with open(speaker_coding_path, "w") as f:
            json.dump(data_parser.speaker2ix, f)

    fft_frame_length = int(np.floor(parameters.fft_frame_length * fs))
    fft_step_size = int(np.floor(parameters.fft_step_size * fs))
    if parameters.decoder_rnn_type is None:
        parameters.decoder_rnn_type = parameters.encoder_rnn_type
    batching_mode = parameters.batching_mode or (
        "length_sorted" if parameters.length_sorted_batches else None)

    if variant == "abcd":
        latent = dict(
            num_feature_categories=parameters.num_feature_categories,
            feature_dim=parameters.feature_dim,
            prior_concentration=parameters.prior_concentration)
    else:
        latent = dict(latent_type="gaussian",
                      feature_size=parameters.feature_size)
    learner = Learner(
        input_size=int(fft_frame_length / 2 + 1),
        encoder_rnn_hidden_size=parameters.encoder_rnn_hidden_size,
        decoder_rnn_hidden_size=parameters.decoder_rnn_hidden_size,
        mlp_hidden_size=parameters.mlp_hidden_size,
        save_dir=save_dir,
        encoder_rnn_type=parameters.encoder_rnn_type,
        decoder_rnn_type=parameters.decoder_rnn_type,
        encoder_rnn_layers=parameters.encoder_rnn_layers,
        encoder_hidden_dropout=parameters.encoder_hidden_dropout,
        decoder_input_dropout=parameters.decoder_input_dropout,
        device=parameters.device,
        seed=parameters.seed,
        decoder_self_feedback=not parameters.greedy_decoder,
        bidirectional_encoder=not parameters.unidirectional_encoder,
        bidirectional_decoder=parameters.bidirectional_decoder,
        right2left_decoder_weight=parameters.right2left_decoder_weight,
        esn_leak=parameters.esn_leak,
        num_speakers=num_speakers if num_speakers > 0 else None,
        speaker_embed_dim=parameters.speaker_embed_dim,
        stft_method=parameters.stft_method,
        batching_mode=batching_mode, fused_cells=fused_cells,
        kernel_rng=kernel_rng, **latent)

    frontend = FrontendSpec(fft_frame_length, fft_step_size,
                            centering=not parameters.fft_no_centering,
                            window=parameters.fft_window_type)
    logger.info("log(abs(STFT(wav))) + {eps}) / {normalizer} will be the "
                "input.".format(eps=parameters.epsilon,
                                normalizer=parameters.data_normalizer))
    logger.info("Sampling frequency of data: {fs}".format(fs=fs))
    logger.info("STFT window type: {fft_window}".format(
        fft_window=parameters.fft_window_type))
    logger.info("STFT frame lengths: {fft_frame_length_in_sec} sec".format(
        fft_frame_length_in_sec=parameters.fft_frame_length))
    logger.info("STFT step size: {fft_step_size_in_sec} sec".format(
        fft_step_size_in_sec=parameters.fft_step_size))

    train_dataset = data_parser.get_data(data_type="train",
                                         channel=parameters.channel)
    valid_dataset = data_parser.get_data(data_type="valid",
                                         channel=parameters.channel)
    if parameters.validation_batch_size is None:
        parameters.validation_batch_size = parameters.batch_size
    learner.learn(train_dataset, valid_dataset, parameters.epochs,
                  parameters.batch_size, parameters.validation_batch_size,
                  frontend=frontend, epsilon=parameters.epsilon,
                  data_normalizer=parameters.data_normalizer,
                  pretrain_epochs=getattr(parameters, "pretrain_epochs", 0),
                  learning_rate=parameters.learning_rate,
                  momentum=parameters.momentum,
                  gradient_clip=parameters.clip,
                  patience=parameters.patience)
    return learner


if __name__ == "__main__":
    main(sys.argv[1:])
