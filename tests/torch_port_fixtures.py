"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_port_*).

Weights are drawn by the port's initialisers (the reference's
distributions, from a seeded ``torch.Generator``), laid out as the JAX
package's tree by ``params_to_jax`` and handed to both packages as numpy
arrays: the JAX initialisers would compile every draw, which costs
seconds per configuration (the trees' equality with the JAX initialisers'
is tested on its own).  Audio is made from a seed with numpy.  The helpers
touch no global state of either framework; ``reference_jit`` compiles a
JAX reference computation once, with options of that compilation alone.
"""

import numpy as np

import jax

from seq2seq_abcd_vae_tpu.configs import (ABCDSamplerConfig, DecoderConfig,
                                          EncoderConfig)
from seq2seq_abcd_vae_tpu.models import vae
from seq2seq_abcd_vae_tpu.train import checkpoint as jax_ckpt

FS = 16000           # frame 128 samples, step 64, 65 bins
FRAME, STEP, BINS = 128, 64, 65
EPS = 2.0 ** -15
NORMALIZER = 11.0


def port_init_tree(cfg, seed=0) -> dict:
    """Fresh weights for the JAX ``ModelConfig`` ``cfg`` (the ABCD head or
    the plain VAE's Gaussian), drawn by the
    port's initialisers in ``model_init``'s order, as the JAX package's
    tree of float32 numpy arrays.  Decoder options that change no shape
    (the greedy decoder, input dropout) are taken as they are."""
    import torch
    from seq2seq_abcd_vae_tpu_torch import configs as port_configs
    from seq2seq_abcd_vae_tpu_torch.models import (abcd, decoder, encoder,
                                                   sampler)
    from seq2seq_abcd_vae_tpu_torch.train.from_jax import params_to_jax
    gen = torch.Generator().manual_seed(seed)
    encoder_params = encoder.encoder_init(
        gen, port_configs.EncoderConfig.from_init_parameters(
            cfg.encoder.pack_init_parameters()))
    if cfg.latent_type == "abcd":
        head = abcd.abcd_init(
            gen, port_configs.ABCDSamplerConfig.from_init_parameters(
                cfg.latent.pack_init_parameters()))
    else:
        lat = cfg.latent
        head = sampler.sampler_init(gen, lat.input_size, lat.mlp_hidden_size,
                                    lat.output_size, lat.distribution_name)
    tree = {
        "encoder": encoder_params,
        "feature_sampler": head,
        "decoder": decoder.decoder_init(
            gen, port_configs.DecoderConfig.from_init_parameters(
                cfg.decoder.pack_init_parameters())),
    }
    return params_to_jax(tree)


def small_model(hidden=8, layers=1, k=6, feature_dim=10, mlp_hidden=12,
                seed=0):
    """A small ABCD model: (ModelConfig, params as numpy arrays)."""
    enc = EncoderConfig(BINS, hidden, rnn_layers=layers)
    lat = ABCDSamplerConfig(enc.hidden_size_total, mlp_hidden, k,
                            feature_dim)
    dec = DecoderConfig(BINS, hidden, mlp_hidden, feature_dim)
    cfg = vae.ModelConfig(enc, lat, dec)
    return cfg, port_init_tree(cfg, seed)


def write_jax_checkpoint(save_dir, cfg, params) -> str:
    """checkpoint.pt written by the JAX package's writer (either latent
    head)."""
    latent_init = dict(cfg.latent.pack_init_parameters())
    payload = {
        "epoch": 1,
        "latent_type": cfg.latent_type,
        "encoder": params["encoder"],
        "encoder_init_parameters": cfg.encoder.pack_init_parameters(),
        "feature_sampler": params["feature_sampler"],
        "feature_sampler_init_parameters": latent_init,
        "decoder": params["decoder"],
        "decoder_init_parameters": cfg.decoder.pack_init_parameters(),
        "gradient_clip": 1.0,
        "random_state": np.asarray(jax.random.PRNGKey(0)),
    }
    return jax_ckpt.save_checkpoint(str(save_dir), payload)


def padded_batch(rng, frames, bucket):
    """Centred audio rows for segments of the given frame counts, padded
    to ``bucket`` frames (rows past ``len(frames)`` stay silent), and the
    (B,) frame counts; the server's layout."""
    from seq2seq_abcd_vae_tpu.data import audio as jax_audio
    pad = FRAME // 2
    audio = np.zeros((len(frames) + 1, bucket * STEP + FRAME), np.float32)
    num_frames = np.zeros(len(frames) + 1, np.int32)
    for i, f in enumerate(frames):
        n = (f - 1) * STEP + int(rng.integers(0, STEP))
        seg = (rng.normal(size=n) * 1000).astype(np.float32)
        jax_audio.center_pad_segment(seg, pad, audio[i])
        num_frames[i] = 1 + n // STEP
    return audio, num_frames


# The XLA CPU backend's lowest LLVM optimisation level: the JAX reference
# programs of these tests are tiny and run once, and compile in about half
# the time; their values agree with the default compilation's to float32
# rounding, far inside the tests' tolerances.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def reference_jit(fn, **kwargs):
    """``jax.jit(fn)`` compiled with ``FAST_COMPILE``: one compilation of a
    JAX reference computation (an eager call compiles each operation and
    each scan on its own, and an interpret-mode Pallas kernel runs its grid
    step by step in Python)."""
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kwargs)


def one_step_scans(monkeypatch):
    """Roll the JAX package's scans one step an iteration (its
    ``SCAN_UNROLL``, read at call time): the same values, compiled in about
    half the time of the default unroll of 4."""
    from seq2seq_abcd_vae_tpu.models import rnn as jax_rnn
    monkeypatch.setattr(jax_rnn, "SCAN_UNROLL", 1)


def few_torch_threads_fixture():
    """Hold torch to 2 intra-op threads for a port test and restore the
    setting afterwards, so that the port's tests load the CPU lightly."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)
