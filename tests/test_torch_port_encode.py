"""The whole served answer of the PyTorch port against the JAX package:
``encode_step`` in probs / logits / features mode on a checkpoint written
by the JAX package's writer, and the v2 checkpoint format read and
written by both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.infer.encode import _encode_step as jax_encode_step
from seq2seq_abcd_vae_tpu.train import checkpoint as jax_ckpt
from seq2seq_abcd_vae_tpu.train.learner import StepStatics as JaxStatics
from seq2seq_abcd_vae_tpu_torch.configs import EncoderConfig, check_served
from seq2seq_abcd_vae_tpu_torch.data.batching import FrontendSpec
from seq2seq_abcd_vae_tpu_torch.infer import encode as port_encode
from seq2seq_abcd_vae_tpu_torch.train import checkpoint as port_ckpt
from torch_port_fixtures import (EPS, FRAME, NORMALIZER, STEP,
                                 one_step_scans, padded_batch, small_model,
                                 write_jax_checkpoint)

# The frontend's quiet-bin cancellation bound (tests/test_stft_pallas.py)
# would dominate a tolerance on the outputs, so both packages run the same
# stft method; what remains is float32 products in another order through
# the encoder and the head: logits and features are O(1), probs sum to 1.
TOL = {"probs": dict(rtol=1e-5, atol=1e-6),
       "logits": dict(rtol=1e-5, atol=1e-5),
       "features": dict(rtol=1e-5, atol=1e-5)}
BUCKET = 16


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    cfg, params = small_model(hidden=8, k=6, feature_dim=10)
    path = write_jax_checkpoint(tmp_path_factory.mktemp("jax_ckpt"), cfg,
                                params)
    return cfg, params, path


@pytest.mark.parametrize("method", ["fft", "pallas"])
@pytest.mark.parametrize("mode", ["probs", "logits", "features"])
def test_encode_step_matches_jax(rng, monkeypatch, jax_checkpoint, mode,
                                 method):
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    one_step_scans(monkeypatch)
    cfg, params, path = jax_checkpoint
    audio, num_frames = padded_batch(rng, [16, 3, 9], BUCKET)
    statics = JaxStatics(cfg, FRAME, STEP, "hann_window", EPS, NORMALIZER,
                         stft_method=method)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_encode_step(
            {k: params[k] for k in ("encoder", "feature_sampler")},
            jnp.asarray(audio), jnp.asarray(num_frames), statics=statics,
            bucket_frames=BUCKET, mode=mode))
    enc = port_encode.Encoder(path, device="cpu", stft_method=method)
    got = port_encode.encode_step(
        enc.params, torch.from_numpy(audio), torch.from_numpy(num_frames),
        enc.statics(FrontendSpec(FRAME, STEP), EPS, NORMALIZER), BUCKET,
        mode)
    width = cfg.latent.feature_dim if mode == "features" else 6
    assert tuple(got.shape) == want.shape == (4, width)
    np.testing.assert_allclose(got.numpy(), want, **TOL[mode])
    if mode == "probs":
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


def test_checkpoint_format_round_trips_between_packages(tmp_path,
                                                        jax_checkpoint):
    _, params, path = jax_checkpoint
    loaded = port_ckpt.load_checkpoint(path)
    ref = jax_ckpt.load_checkpoint(path)
    assert loaded.keys() == ref.keys()
    np.testing.assert_array_equal(
        loaded["encoder"]["layers"][0]["bwd"]["w_hh"],
        ref["encoder"]["layers"][0]["bwd"]["w_hh"])
    payload = {"epoch": 3, "nested": {"t": torch.arange(4.0), "n": None},
               "items": [np.eye(2, dtype=np.float32), "x", 1.5, True],
               "optimizer": port_ckpt.OptimizerLeaves(
                   [np.ones(3, np.float32), np.zeros((2, 2))])}
    out = port_ckpt.save_checkpoint(str(tmp_path), payload)
    for back in (port_ckpt.load_checkpoint(out),
                 jax_ckpt.load_checkpoint(out)):
        assert back["epoch"] == 3 and back["nested"]["n"] is None
        np.testing.assert_array_equal(back["nested"]["t"], np.arange(4.0))
        np.testing.assert_array_equal(back["items"][0], np.eye(2))
        assert back["items"][1:] == ["x", 1.5, True]
        np.testing.assert_array_equal(back["optimizer"].leaves[0],
                                      np.ones(3))
    with open(tmp_path / "old.pt", "wb") as f:
        f.write(b"\x80\x04not a zip")
    with pytest.raises(ValueError, match="not a v2"):
        port_ckpt.load_checkpoint(str(tmp_path / "old.pt"))


def test_device_and_mode_contract(monkeypatch, jax_checkpoint):
    """Entry points run on the card unless the CPU is asked for; without a
    card they raise rather than fall back.  A mode the checkpoint's head
    cannot answer, or an unknown latent type, says so."""
    _, _, path = jax_checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_encode.Encoder(path)
    assert port_encode.resolve_device("cpu") == torch.device("cpu")
    port_encode.check_mode("params")
    with pytest.raises(ValueError, match="needs a 'gaussian' model"):
        port_encode.check_mode("params", "abcd")
    with pytest.raises(ValueError, match="unknown mode"):
        port_encode.check_mode("sample")
    with pytest.raises(ValueError, match="stft method"):
        port_encode.Encoder(path, device="cpu", stft_method="custom:x")
    cfg, _, _ = jax_checkpoint
    enc_cfg = EncoderConfig.from_init_parameters(
        cfg.encoder.pack_init_parameters())
    check_served(enc_cfg, "gaussian")
    with pytest.raises(NotImplementedError, match="latent type"):
        check_served(enc_cfg, "vq")
