"""Encoder and ABCD head of the PyTorch port against the JAX package, on
the JAX package's own initial weights carried across by
``train/from_jax.params_from_jax``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.models import abcd as jax_abcd
from seq2seq_abcd_vae_tpu.models import encoder as jax_encoder
from seq2seq_abcd_vae_tpu_torch.configs import (DecoderConfig, EncoderConfig,
                                                check_served)
from seq2seq_abcd_vae_tpu_torch.models import abcd as port_abcd
from seq2seq_abcd_vae_tpu_torch.models import encoder as port_encoder
from seq2seq_abcd_vae_tpu_torch.train.from_jax import params_from_jax
from torch_port_fixtures import (BINS, one_step_scans, reference_jit,
                                 small_model)

# float32 products in another order through <= 2 layers of <= 11 steps
# and a two-layer MLP
TOL = dict(rtol=1e-5, atol=1e-5)


def _port_cfg(jax_cfg):
    return EncoderConfig.from_init_parameters(
        jax_cfg.encoder.pack_init_parameters())


@pytest.mark.parametrize("layers", [1, 2])
def test_encoder_matches_jax(rng, monkeypatch, layers):
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    one_step_scans(monkeypatch)
    cfg, params = small_model(hidden=8, layers=layers)
    x = rng.normal(size=(4, 11, BINS)).astype(np.float32)
    lengths = np.asarray([11, 4, 0, 9], np.int32)
    with jax.default_matmul_precision("highest"):
        want = reference_jit(
            lambda p, xx, n: jax_encoder.encoder_apply(p, cfg.encoder, xx,
                                                       n))(
                params["encoder"], jnp.asarray(x), jnp.asarray(lengths))
    port = params_from_jax(params, _port_cfg(cfg))
    got = port_encoder.encoder_apply(port["encoder"], _port_cfg(cfg),
                                     torch.from_numpy(x),
                                     torch.from_numpy(lengths))
    assert tuple(got.shape) == want.shape == (4, cfg.encoder.hidden_size_total)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[2].any()  # a length-0 row keeps the zero state


def test_abcd_head_matches_jax(rng):
    cfg, params = small_model()
    x = rng.normal(size=(5, cfg.encoder.hidden_size_total)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        want_code = jax_abcd.abcd_code(params["feature_sampler"],
                                       jnp.asarray(x))
        want_logits = jax_abcd.abcd_logits(params["feature_sampler"],
                                           jnp.asarray(x))
    head = params_from_jax(params, _port_cfg(cfg))["feature_sampler"]
    np.testing.assert_allclose(
        port_abcd.abcd_code(head, torch.from_numpy(x)).numpy(),
        np.asarray(want_code), **TOL)
    np.testing.assert_allclose(
        port_abcd.abcd_logits(head, torch.from_numpy(x)).numpy(),
        np.asarray(want_logits), **TOL)


def test_params_from_jax_layout():
    cfg, params = small_model(hidden=8, layers=2)
    port = params_from_jax(params, _port_cfg(cfg))
    for index, layer in enumerate(port["encoder"]):
        src = params["encoder"]["layers"][index]
        for name, tensor in layer.items():
            assert tensor.dtype == torch.float32 and tensor.is_contiguous()
            for d, direction in enumerate(("fwd", "bwd")):
                np.testing.assert_array_equal(tensor[d].numpy(),
                                              src[direction][name])
    assert tuple(port["encoder"][1]["w_ih"].shape) == (2, 16, 32)
    wrong = EncoderConfig(BINS + 1, 8, rnn_layers=2)
    with pytest.raises(ValueError, match="w_ih"):
        params_from_jax(params, wrong)


@pytest.mark.parametrize("kwargs", [
    dict(latent_type="vq", match="latent type"),
    dict(hidden_dropout=0.5, match="dropout"),
    dict(decoder_bidirectional=True, match="bidirectional decoder")])
def test_later_slices_raise(kwargs):
    """What the port refuses: a latent type the JAX package does not have,
    and what waits for a later slice: encoder inter-layer dropout in
    training and the bidirectional decoder (every cell's encoder, in either
    direction, and both latent heads are ported)."""
    cfg = EncoderConfig(BINS, 8, rnn_layers=2,
                        hidden_dropout=kwargs.get("hidden_dropout", 0.0))
    decoder = DecoderConfig(BINS, 8, 8, 4, bidirectional=kwargs.get(
        "decoder_bidirectional", False))
    with pytest.raises(NotImplementedError, match=kwargs["match"]):
        check_served(cfg, kwargs.get("latent_type", "abcd"), decoder)
