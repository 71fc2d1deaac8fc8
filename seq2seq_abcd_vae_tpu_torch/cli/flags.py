"""The argparse parsers of the training and encode CLIs (the port's own copy
of seq2seq_abcd_vae_tpu/cli/flags.py), in the ABCD-VAE's variant
(``abcd``) and the plain Gaussian VAE's (``plain``).

Flag names, defaults and help strings match the JAX package's, but for
``-d/--device``: the port's entry points run on the card (``cuda``)
unless the caller asks for the CPU.  Options of the JAX CLI that the port
does not run yet, and the JAX package's ``SEQ2SEQ_*`` switches that would
change the result, are refused with NotImplementedError (see
``refuse_unported``).  ``--matmul_precision`` means the same in the
training, encode and serve CLIs (``MATMUL_PRECISION``,
``apply_matmul_precision``).
"""

from __future__ import annotations

import argparse

import torch

from ..models.decoder import CELLS

EPSILON_DEFAULT = 2.0 ** -15

# --matmul_precision keeps the JAX CLI's names; each maps onto the float32
# matmul precision PyTorch offers on the card ("high" allows TF32,
# "medium" bf16 where cuBLAS has it).  The hand-written kernels always
# compute in float32 FMA, and on the CPU every product stays float32.
MATMUL_PRECISION = {"highest": "highest", "float32": "highest",
                    "bfloat16_3x": "high", "default": "high",
                    "bfloat16": "medium"}
MATMUL_PRECISION_HELP = (
    "Matmul precision of the plain PyTorch products outside the kernels, "
    "on the card: 'highest' and 'float32' keep full float32 (torch "
    "'highest', TF32 off; for reference parity), 'bfloat16_3x' and "
    "'default' become torch 'high' (TF32), 'bfloat16' torch 'medium'. "
    "The kernels compute in float32 whatever the flag; on the CPU every "
    "product is float32.")


ENVIRONMENT_HELP = (
    "Environment: SEQ2SEQ_RNN_BACKEND / SEQ2SEQ_ENCODER_BACKEND = auto "
    "(default: on the card a launch-cost probe must find the kernels' "
    "launches under SEQ2SEQ_PALLAS_DISPATCH_MS_MAX ms, default 20, or the "
    "run stops; the port never falls back to its CPU twins) | pallas (the "
    "kernels, no probe) | scan (refused on the card: the twins run on the "
    "CPU only). SEQ2SEQ_KERNEL_MXU=bf16 (with a --matmul_precision other "
    "than highest/float32), SEQ2SEQ_STREAM_DTYPE=bf16 and "
    "SEQ2SEQ_ENCODE_FETCH_DTYPE=bf16 are not ported yet: each is refused "
    "by the CLIs whose results it changes in the JAX package.")


def add_matmul_precision(group) -> None:
    group.add_argument("--matmul_precision", type=str, default="highest",
                       choices=sorted(MATMUL_PRECISION),
                       help=MATMUL_PRECISION_HELP)


def apply_matmul_precision(parameters) -> None:
    """Set torch's float32 matmul precision from ``--matmul_precision``
    when the entry point runs on the card (``-d cuda``)."""
    if torch.device(parameters.device).type == "cuda":
        torch.set_float32_matmul_precision(
            MATMUL_PRECISION[parameters.matmul_precision])


def _extras(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("Options beyond the reference")
    add_matmul_precision(g)
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


VARIANTS = ("abcd", "plain")


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (known: "
                         f"{', '.join(VARIANTS)})")


def build_learning_parser(variant: str = "abcd") -> argparse.ArgumentParser:
    """The training CLI's parser: ``abcd`` (the reference's
    ABCD-VAE/learning.py) or ``plain`` (plain/learning.py: ``-f`` is the
    feature size, and no pretraining, ``-K`` or Dirichlet prior)."""
    _check_variant(variant)
    p = argparse.ArgumentParser(epilog=ENVIRONMENT_HELP + (
        " SEQ2SEQ_NLL_FUSION=0 / SEQ2SEQ_FUSED_CELLS send decoder cells to "
        "the stream path; SEQ2SEQ_KERNEL_RNG=1 (on the card only) draws "
        "the fused-loss kernels' noise in-kernel from a seed."))
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
    if variant == "abcd":
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
    if variant == "abcd":
        a("-K", "--num_feature_categories", type=int, default=128,
          help="# of possible discrete values token on by latent features "
               "into which data are encoded.")
        a("-f", "--feature_dim", type=int, default=256,
          help="# of dimensions of features into which the discrete "
               "feature are linear-transformed.")
    else:
        a("-f", "--feature_size", type=int, default=16,
          help="# of dimensions of features into which data are encoded.")
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
    if variant == "abcd":
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


def kernel_rng(environ, device) -> bool:
    """Whether the fused-loss decoder kernels draw their noise in-kernel
    from a seed (the JAX package's ``SEQ2SEQ_KERNEL_RNG=1``).  The JAX
    package honours it on its accelerator only (models/decoder.py:439-440),
    so the port honours it on the card (``-d cuda``) and ignores it on the
    CPU."""
    return (environ.get("SEQ2SEQ_KERNEL_RNG", "0") == "1"
            and torch.device(device).type == "cuda")


# the JAX package's precision switches the port does not run yet, with the
# CLIs whose results they change there
_BF16_SWITCHES = (
    ("SEQ2SEQ_KERNEL_MXU", ("learning", "encode", "serve"),
     "bf16 operands in the recurrent kernels (JAX models/rnn.py:57)"),
    ("SEQ2SEQ_STREAM_DTYPE", ("learning",),
     "bf16 saved carry streams in the decoder kernels (JAX "
     "ops/decoder_pallas.py:72-74)"),
    ("SEQ2SEQ_ENCODE_FETCH_DTYPE", ("encode", "serve"),
     "bf16 encode results (JAX infer/encode.py:249-251)"),
)


def refuse_unported(parameters, environ, cli: str) -> None:
    """Raise NotImplementedError for a JAX CLI option, or a switch of the
    JAX package's environment that the CLI ``cli`` (``learning``,
    ``encode`` or ``serve``) would read there, that the port does not run:

    - ``SEQ2SEQ_KERNEL_MXU=bf16`` with ``--matmul_precision`` other than
      ``highest`` / ``float32`` (where the JAX package takes bf16 kernel
      operands), ``SEQ2SEQ_STREAM_DTYPE=bf16`` (training) and
      ``SEQ2SEQ_ENCODE_FETCH_DTYPE=bf16`` (encode, serve);
    - on the card, ``SEQ2SEQ_RNN_BACKEND=scan`` or
      ``SEQ2SEQ_ENCODER_BACKEND=scan``: the plain twins run on the CPU
      only (utils/backend_select.py);
    - for the training and encode CLIs, data-parallel training, the
      device-resident corpus cache and ``--profile_dir``.

    Reads only ``parameters`` and ``environ``: nothing touches a device."""
    for name, clis, what in _BF16_SWITCHES:
        if cli not in clis or environ.get(name) != "bf16":
            continue
        if (name == "SEQ2SEQ_KERNEL_MXU" and parameters.matmul_precision
                in ("highest", "float32")):
            continue  # the JAX package keeps float32 operands then
        raise NotImplementedError(f"{name}=bf16 ({what}) is not ported yet")
    if torch.device(parameters.device).type == "cuda":
        for name in ("SEQ2SEQ_RNN_BACKEND", "SEQ2SEQ_ENCODER_BACKEND"):
            if environ.get(name) == "scan":
                raise NotImplementedError(
                    f"{name}=scan: the port's scan path is its plain "
                    "PyTorch twins, which run on the CPU only (-d cpu); "
                    "on the card use 'auto' or 'pallas' (the kernels)")
    if cli == "serve":
        return  # the server accepts the options below and reads none
    if parameters.num_data_partitions not in (None, 1):
        raise NotImplementedError(
            "data-parallel training is not ported yet")
    if parameters.device_corpus_cache == "on":
        raise NotImplementedError(
            "the device-resident corpus cache is not ported yet")
    if parameters.profile_dir is not None:
        raise NotImplementedError("--profile_dir is not ported yet")


def build_encode_parser(variant: str = "abcd") -> argparse.ArgumentParser:
    """The encode CLIs' parser: ``abcd`` (probs, logits, features) or
    ``plain`` (params mode, with ``-p/--parameter_names``)."""
    _check_variant(variant)
    p = argparse.ArgumentParser(epilog=ENVIRONMENT_HELP)
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
    if variant == "plain":
        a("-p", "--parameter_names", type=str, default=None,
          help="Comma-separated parameter names.")
    a("-E", "--epsilon", type=float, default=EPSILON_DEFAULT,
      help="Small positive real number to add to avoid log(0).")
    a("-b", "--batch_size", type=int, default=1, help="Batch size.")
    _extras(p)
    return p
