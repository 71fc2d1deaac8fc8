"""Encode entry point of the port, shared by the four encode CLIs:

    python -m seq2seq_abcd_vae_tpu_torch.cli.encode_main MODE MODEL_PATH \\
        INPUT_ROOT ANNOTATION.csv NORMALIZER [-S OUT] [-b B] \\
        [-d cuda|cpu] [--save_format csv|npz] [-p NAMES] [options]

MODE is ``probs`` (the reference's ABCD-VAE/encode.py), ``logits``
(encode_logit.py), ``features`` (encode_features.py) or ``params``
(plain/encode.py: the plain Gaussian VAE's (mean, log_variance), named by
``-p/--parameter_names``, the plain parser's option); the flow is
seq2seq_abcd_vae_tpu/cli/encode_main.py's: the result goes to ``-S`` or
``INPUT_ROOT/autoencoded.csv``, the STFT geometry follows the first wav's
sampling rate, every annotation row is encoded and, when the annotation
has a ``label`` column, the CSV carries the annotation's columns.  Runs on
the card unless ``-d cpu``.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..data.annotations import AnnotationParser
from ..data.batching import FrontendSpec
from ..infer.encode import Encoder, check_mode
from . import flags


def main(mode: str, argv=None) -> None:
    check_mode(mode)
    variant = "plain" if mode == "params" else "abcd"
    parameters = flags.build_encode_parser(variant).parse_args(argv)
    flags.refuse_unported(parameters, os.environ, "encode")
    flags.apply_matmul_precision(parameters)

    save_path = parameters.save_path
    if save_path is None:
        save_path = os.path.join(parameters.input_root, "autoencoded.csv")
    save_dir = os.path.dirname(save_path)
    if save_dir and not os.path.isdir(save_dir):
        os.makedirs(save_dir)

    data_parser = AnnotationParser(parameters.input_root,
                                   parameters.annotation_file,
                                   annotation_sep=parameters.annotation_sep)
    fs = data_parser.get_sample_freq()
    fft_frame_length = int(np.floor(parameters.fft_frame_length * fs))
    fft_step_size = int(np.floor(parameters.fft_step_size * fs))

    encoder = Encoder(parameters.model_path, device=parameters.device,
                      stft_method=parameters.stft_method)
    encoder.check_mode(mode)
    frontend = FrontendSpec(fft_frame_length, fft_step_size,
                            centering=not parameters.fft_no_centering,
                            window=parameters.fft_window_type)
    dataset = data_parser.get_data(channel=parameters.channel)
    common = dict(mode=mode, batch_size=parameters.batch_size)
    if parameters.save_format == "npz":
        encoder.encode_dataset_npz(dataset, save_path, frontend,
                                   parameters.epsilon,
                                   parameters.data_normalizer, **common)
        return
    labelled = "label" in data_parser.columns
    annotation = dict(
        suffixes=data_parser.csv_suffixes() if labelled else None,
        columns=data_parser.columns if labelled else None)
    if mode == "params":
        names = parameters.parameter_names
        encoder.encode_dataset_params(
            dataset, save_path, frontend, parameters.epsilon,
            parameters.data_normalizer,
            parameter_ix2name=dict(enumerate(names.split(",")))
            if names is not None else {},
            batch_size=parameters.batch_size, **annotation)
        return
    encoder.encode_dataset(
        dataset, save_path, frontend, parameters.epsilon,
        parameters.data_normalizer, **annotation, **common)


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit("usage: python -m seq2seq_abcd_vae_tpu_torch.cli.encode_main "
                 "{probs,logits,features,params} MODEL_PATH INPUT_ROOT "
                 "ANNOTATION_FILE DATA_NORMALIZER [options]")
    main(sys.argv[1], sys.argv[2:])
