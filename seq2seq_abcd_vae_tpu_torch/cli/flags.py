"""The argparse parsers of the training and encode CLIs (the port's own copy
of seq2seq_abcd_vae_tpu/cli/flags.py, ABCD variant).

Flag names, defaults and help strings match the JAX package's, but for
``-d/--device``: the port's entry points run on the card (``cuda``)
unless the caller asks for the CPU.  Options of the JAX CLI that the port
does not run yet are accepted and refused with NotImplementedError where
they would change the result (see ``refuse_unported``).
"""

from __future__ import annotations

import argparse

from ..models.decoder import CELLS

EPSILON_DEFAULT = 2.0 ** -15


def _extras(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("Options beyond the reference")
    g.add_argument("--matmul_precision", type=str, default="highest",
                   choices=["highest", "float32", "bfloat16_3x", "default",
                            "bfloat16"],
                   help="Matmul precision outside the kernels. 'highest' "
                        "and 'float32' keep full float32 (TF32 off); the "
                        "others allow TF32 on the card.")
    g.add_argument("--stft_method", type=str, default="fft",
                   choices=["fft", "matmul", "pallas"],
                   help="STFT frontend implementation: rfft, windowed DFT "
                        "matmuls, or the hand-written CUDA kernel (the "
                        "JAX package's name for its fused kernel).")
    g.add_argument("--num_data_partitions", type=int, default=None,
                   help="Data-parallel training (not ported yet; only 1).")
    g.add_argument("--length_sorted_batches", action="store_true",
                   help="Group length-similar segments into batches.")
    g.add_argument("--batching_mode", type=str, default=None,
                   choices=["uniform", "bucket_shuffled", "length_sorted"],
                   help="Training batch composition: 'bucket_shuffled' "
                        "(default), 'uniform' or 'length_sorted'.")
    g.add_argument("--profile_dir", type=str, default=None,
                   help="Profiler trace directory (not ported yet).")
    g.add_argument("--save_format", type=str, default="csv",
                   choices=["csv", "npz"],
                   help="Encode result format; training ignores it.")
    g.add_argument("--device_corpus_cache", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="Device-resident corpus cache (not ported yet: "
                        "'auto' and 'off' keep it off, 'on' is refused).")


def build_learning_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    a = p.add_argument
    a("input_root", type=str,
      help="Path to the root directory under which inputs are located.")
    a("annotation_file", type=str,
      help="Path to the annotation csv file.")
    a("--annotation_sep", type=str, default=",",
      help='Separator symbol of the annotation file. Comma "," by default '
           "(i.e., csv).")
    a("-S", "--save_root", type=str, default=None,
      help="Path to the directory where results are saved.")
    a("-j", "--job_id", type=str, default="NO_JOB_ID",
      help="Job ID. For users of computing clusters.")
    a("-s", "--seed", type=int, default=1111, help="random seed")
    a("-d", "--device", type=str, default="cuda", help="Computing device.")
    a("-e", "--epochs", type=int, default=20,
      help="# of epochs to train the model.")
    a("--pretrain_epochs", type=int, default=5,
      help="# of initial epochs to pretrain the model w/o "
           "gumbel-softmax sampling.")
    a("-b", "--batch_size", type=int, default=512,
      help="Batch size for training.")
    a("--validation_batch_size", type=int, default=None,
      help="Batch size for validation. Same as for training by default.")
    a("-l", "--learning_rate", type=float, default=1.0,
      help="Initial learning rate.")
    a("-M", "--momentum", type=float, default=0.0,
      help="Momentum for the storchastic gradient descent.")
    a("-c", "--clip", type=float, default=1.0, help="Gradient clipping.")
    a("-p", "--patience", type=int, default=0,
      help="# of epochs before updating the learning rate.")
    a("-R", "--encoder_rnn_type", type=str, default="LSTM",
      help="Name of RNN to be used for the encoder.")
    a("--decoder_rnn_type", type=str, default=None,
      help="Name of RNN to be used for the decoder. Same as the encoder "
           "by default.")
    a("-K", "--num_feature_categories", type=int, default=128,
      help="# of possible discrete values token on by latent features "
           "into which data are encoded.")
    a("-f", "--feature_dim", type=int, default=256,
      help="# of dimensions of features into which the discrete "
           "feature are linear-transformed.")
    a("--encoder_rnn_layers", type=int, default=1,
      help="# of hidden layers in the encoder RNN.")
    a("--encoder_rnn_hidden_size", type=int, default=256,
      help="# of the RNN units in the encoder RNN.")
    a("--decoder_rnn_hidden_size", type=int, default=256,
      help="# of the RNN units in the decoder RNN.")
    a("--mlp_hidden_size", type=int, default=256,
      help="# of neurons in the hidden layer of the MLP transforms.")
    a("--speaker_embed_dim", type=int, default=None,
      help="If specified, the decoder receives an embedding of the speaker "
           "ID with the specified dim. No embedding by default.")
    a("--encoder_hidden_dropout", type=float, default=0.0,
      help="Dropout rate in the non-top layers of the encoder RNN.")
    a("--decoder_input_dropout", type=float, default=0.0,
      help="Dropout rate in the input to the decoder RNN.")
    a("--greedy_decoder", action="store_true",
      help="If selected, decoder becomes greedy and will not receive "
           "self-feedback.")
    a("--esn_leak", type=float, default=1.0,
      help="Leak for the echo-state network. Ignored if the RNN type is "
           "not ESN.")
    a("--unidirectional_encoder", action="store_true",
      help="If selected, the RNN encoder is unidirectional.")
    a("--bidirectional_decoder", action="store_true",
      help="If selected, use the weighted sum of losses from left-to-right "
           "and right-to-left decoders (to avoid the uninformative latent "
           "variable problem).")
    a("--right2left_decoder_weight", type=float, default=0.5,
      help="The weight of the right-to-left decoder when "
           "bidirectional_decoder==True.")
    a("--fft_frame_length", type=float, default=0.008,
      help="FFT frame length in sec.")
    a("--fft_step_size", type=float, default=0.004,
      help="FFT step size in sec.")
    a("--fft_window_type", type=str, default="hann_window",
      help='Window type for FFT. "hann_window" by default.')
    a("--fft_no_centering", action="store_true",
      help="If selected, no centering in FFT.")
    a("--channel", type=int, default=0,
      help="Channel ID # (starting from 0) of multichannel recordings "
           "to use.")
    a("-N", "--data_normalizer", type=float, default=1.0,
      help="Normalizing constant to devide the data.")
    a("-E", "--epsilon", type=float, default=EPSILON_DEFAULT,
      help="Small positive real number to add to avoid log(0).")
    a("--prior_concentration", type=float, default=1.0,
      help="Concentration of the Dirichlet prior on the probability "
           "of the discrete feature.")
    _extras(p)
    return p


def fused_loss_cells(environ) -> tuple:
    """The decoder cells that train on the fused-loss kernels, from the JAX
    package's two variables as its ``models/decoder.py`` reads them:
    ``SEQ2SEQ_NLL_FUSION=0`` sends every cell to the stream path (the
    sampled loop and its backward, the losses over its streams); otherwise
    the LSTM is fused and so are the cells that ``SEQ2SEQ_FUSED_CELLS``
    lists (comma separated, default ``GRU,RNN,ESN``; empty for none).  A
    listed name that is not a cell is refused."""
    if environ.get("SEQ2SEQ_NLL_FUSION", "1") == "0":
        return ()
    raw = environ.get("SEQ2SEQ_FUSED_CELLS", "GRU,RNN,ESN")
    listed = tuple(c.strip() for c in raw.split(",") if c.strip())
    unknown = [c for c in listed if c not in CELLS]
    if unknown:
        raise ValueError(f"SEQ2SEQ_FUSED_CELLS lists {unknown}, which are "
                         f"not decoder cells (the cells: {', '.join(CELLS)})")
    return ("LSTM",) + tuple(c for c in CELLS[1:] if c in listed)


def refuse_unported(parameters) -> None:
    """Raise NotImplementedError for a JAX CLI option the port does not
    run yet."""
    if parameters.num_data_partitions not in (None, 1):
        raise NotImplementedError(
            "data-parallel training is not ported yet")
    if parameters.device_corpus_cache == "on":
        raise NotImplementedError(
            "the device-resident corpus cache is not ported yet")
    if parameters.profile_dir is not None:
        raise NotImplementedError("--profile_dir is not ported yet")


def build_encode_parser() -> argparse.ArgumentParser:
    """The encode CLIs' parser (abcd variant; the plain VAE's ``-p`` waits
    for its port)."""
    p = argparse.ArgumentParser()
    a = p.add_argument
    a("model_path", type=str,
      help="Path to the configuration file of a trained model.")
    a("input_root", type=str,
      help="Path to the root directory under which inputs are located.")
    a("annotation_file", type=str,
      help="Path to the annotation csv file.")
    a("data_normalizer", type=float,
      help="Normalizing constant to devide the data.")
    a("--annotation_sep", type=str, default=",",
      help='Separator symbol of the annotation file. Comma "," by default '
           "(i.e., csv).")
    a("-d", "--device", type=str, default="cuda", help="Computing device.")
    a("-S", "--save_path", type=str, default=None,
      help="Path to the file where results are saved.")
    a("--fft_frame_length", type=float, default=0.008,
      help="FFT frame length in sec.")
    a("--fft_step_size", type=float, default=0.004,
      help="FFT step size in sec.")
    a("--fft_window_type", type=str, default="hann_window",
      help='Window type for FFT. "hann_window" by default.')
    a("--fft_no_centering", action="store_true",
      help="If selected, no centering in FFT.")
    a("--channel", type=int, default=0,
      help="Channel ID # (starting from 0) of multichannel recordings "
           "to use.")
    a("-E", "--epsilon", type=float, default=EPSILON_DEFAULT,
      help="Small positive real number to add to avoid log(0).")
    a("-b", "--batch_size", type=int, default=1, help="Batch size.")
    _extras(p)
    return p
