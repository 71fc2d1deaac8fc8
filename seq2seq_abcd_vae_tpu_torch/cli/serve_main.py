"""Persistent encode server entry point (PyTorch port of
seq2seq_abcd_vae_tpu/cli/serve_main.py).

    python -m seq2seq_abcd_vae_tpu_torch.cli.serve_main \\
        <checkpoint> <data_normalizer> <sample_freq> --socket /run/abcd.sock \\
        [--stft_method pallas] [-b 64] [-d cuda]

keeps one process resident, weights on the card, and answers NDJSON
encode requests over a Unix domain socket with dynamic micro-batching
(``serve/server.py``).  The flags are the JAX CLI's; ``--stft_method
pallas`` selects the port's CUDA frontend kernel, and ``-d`` defaults to
``cuda``.
"""

from __future__ import annotations

import argparse
import logging
import os

from ..serve import EncodeService, serve_forever
from . import flags

EPSILON_DEFAULT = 2.0 ** -15

logger = logging.getLogger(__name__)


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(epilog=flags.ENVIRONMENT_HELP)
    a = p.add_argument
    a("model_path", type=str,
      help="Path to the configuration file of a trained model.")
    a("data_normalizer", type=float,
      help="Normalizing constant to devide the data.")
    a("sample_freq", type=int,
      help="Sampling rate the service runs at; requests with a different "
           "fs are rejected.")
    a("--socket", type=str, default="abcd-vae.sock",
      help="Unix domain socket path to listen on.")
    a("--mode", type=str, default="probs",
      choices=["probs", "logits", "features", "params"],
      help="Which encode head to serve (the four encode CLIs).")
    a("-d", "--device", type=str, default="cuda", help="Computing device.")
    a("--fft_frame_length", type=float, default=0.008,
      help="FFT frame length in sec.")
    a("--fft_step_size", type=float, default=0.004,
      help="FFT step size in sec.")
    a("--fft_window_type", type=str, default="hann_window",
      help='Window type for FFT. "hann_window" by default.')
    a("--fft_no_centering", action="store_true",
      help="If selected, no centering in FFT.")
    a("-E", "--epsilon", type=float, default=EPSILON_DEFAULT,
      help="Small positive real number to add to avoid log(0).")
    a("-b", "--batch_size", type=int, default=64,
      help="Batch size per bucket (requests are padded to it).")
    a("--buckets", type=str, default=None,
      help="Comma-separated frame-count buckets (ascending). Default: "
           "16,32,64,96,128,192,256,384,512.")
    a("--max_wait_ms", type=float, default=5.0,
      help="Straggler window: after the first queued request, wait this "
           "long for companions before running the micro-batch.")
    a("--no_warmup", action="store_true",
      help="Skip running every bucket shape once at startup.")
    g = p.add_argument_group("Options of the JAX CLI")
    flags.add_matmul_precision(g)
    g.add_argument("--stft_method", type=str, default="fft",
                   choices=["fft", "matmul", "pallas"],
                   help="STFT frontend: torch.fft.rfft, windowed DFT "
                        "matmuls, or the fused CUDA kernel.")
    # accepted so that the JAX CLI's command lines run unchanged; its
    # server does not read them either
    for flag, kw in (("--num_data_partitions", {"type": int}),
                     ("--length_sorted_batches", {"action": "store_true"}),
                     ("--batching_mode", {"type": str}),
                     ("--profile_dir", {"type": str}),
                     ("--save_format", {"type": str}),
                     ("--device_corpus_cache", {"type": str})):
        g.add_argument(flag, help=argparse.SUPPRESS, **kw)
    return p


def main(argv=None) -> None:
    parameters = build_serve_parser().parse_args(argv)
    flags.refuse_unported(parameters, os.environ, "serve")
    flags.apply_matmul_precision(parameters)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")

    kw = {}
    if parameters.buckets:
        kw["buckets"] = tuple(
            int(x) for x in parameters.buckets.split(","))
    service = EncodeService(
        parameters.model_path, parameters.data_normalizer,
        parameters.sample_freq, device=parameters.device,
        mode=parameters.mode,
        fft_frame_length=parameters.fft_frame_length,
        fft_step_size=parameters.fft_step_size,
        window=parameters.fft_window_type,
        epsilon=parameters.epsilon,
        centering=not parameters.fft_no_centering,
        stft_method=parameters.stft_method,
        batch_size=parameters.batch_size,
        max_wait_ms=parameters.max_wait_ms, **kw)
    try:
        if not parameters.no_warmup:
            logger.info("warming up %d bucket shapes (batch %d)...",
                        len(service.buckets), service.batch_size)
            service.warmup()
        logger.info("serving mode=%s fs=%d on %s", service.mode, service.fs,
                    parameters.socket)
        serve_forever(service, parameters.socket)
    finally:
        service.close()


if __name__ == "__main__":
    main()
