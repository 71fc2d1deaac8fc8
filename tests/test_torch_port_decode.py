"""Generative decoding of the PyTorch port against the JAX package: the
``decoder_loop`` twin (what the kernel wrapper runs on the CPU) against
the Pallas kernel ``decoder_pallas.decoder_loop`` in interpret mode, and
``infer/decode.decode_features`` in ``sample`` and ``mean`` modes against
the JAX ``decoder_apply`` on its kernel path (sample) and its scan body
(mean), with the JAX call's own noise rebuilt and handed to the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.configs import (
    ABCDSamplerConfig as JaxABCDConfig, DecoderConfig as JaxDecoderConfig,
    EncoderConfig as JaxEncoderConfig)
from seq2seq_abcd_vae_tpu.models import decoder as jax_decoder
from seq2seq_abcd_vae_tpu.models import vae as jax_vae
from seq2seq_abcd_vae_tpu.ops import decoder_pallas
from seq2seq_abcd_vae_tpu_torch.configs import (ABCDSamplerConfig,
                                                DecoderConfig, EncoderConfig)
from seq2seq_abcd_vae_tpu_torch.infer.decode import (decode_features,
                                                     load_model)
from seq2seq_abcd_vae_tpu_torch.models import decoder as dec_mod
from seq2seq_abcd_vae_tpu_torch.models import vae as port_vae
from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel
from seq2seq_abcd_vae_tpu_torch.train.from_jax import params_from_jax
from torch_port_fixtures import (few_torch_threads_fixture, one_step_scans,
                                 port_init_tree, reference_jit,
                                 write_jax_checkpoint)

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

# float32 products in another order through T sampled steps (the fed-back
# sample carries each step's rounding into the next)
TOL = dict(rtol=1e-5, atol=1e-5)
F, H, MLP, K, FEAT, SPK, EMB = 9, 8, 12, 6, 10, 2, 3


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_decoder_loop_twin_matches_pallas_interpret(rng):
    """Pre-mask outs and the position-indexed emission streams, slot T-1
    (step 0's parked emission) included; ragged lengths, an empty row."""
    tt, b, f, h, m = 7, 5, 4, 6, 5
    lens = np.asarray([7, 0, 3, 1, 6], np.int32)
    u = lambda bound, *shape: rng.uniform(-bound, bound, size=shape).astype(
        np.float32)
    args = [rng.normal(size=(tt, b, f)).astype(np.float32), lens,
            u(0.4, h, 4 * h + 2 * m), u(0.4, 4 * h), u(0.4, 2 * m),
            u(0.4, m, f), u(0.4, m, f), u(0.4, 2 * f), u(0.4, f, 4 * h),
            rng.normal(size=(b, h)).astype(np.float32) * 0.5,
            rng.normal(size=(b, h)).astype(np.float32) * 0.5]
    want = reference_jit(lambda *a: decoder_pallas.decoder_loop(
        *a, interpret=True, precision=jax.lax.Precision.HIGHEST))(
            *[jnp.asarray(a) for a in args])
    got = decoder_kernel.decoder_loop(
        *[torch.from_numpy(a) for a in args])
    for name, g, w in zip(("outs", "mean_s", "logvar_s"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_decoder_loop_wrapper_rejects_what_the_kernel_does_not_take():
    tt, b, f, h, m = 3, 2, 4, 5, 3
    good = [torch.zeros(tt, b, f), torch.tensor([3, 1], dtype=torch.int32),
            torch.zeros(h, 4 * h + 2 * m), torch.zeros(4 * h),
            torch.zeros(2 * m), torch.zeros(m, f), torch.zeros(m, f),
            torch.zeros(2 * f), torch.zeros(f, 4 * h), torch.zeros(b, h),
            torch.zeros(b, h)]
    decoder_kernel.decoder_loop(*good)
    for i, bad in ((1, good[1].long()), (2, torch.zeros(h, 4 * h)),
                   (9, torch.zeros(b, h).double()),
                   (0, torch.zeros(b, tt, f).transpose(0, 1))):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            decoder_kernel.decoder_loop(*args)


@pytest.fixture(scope="module")
def model():
    enc, lat, dec = (F, H), (4 * H, MLP, K, FEAT), (F, H, MLP, FEAT)
    dkw = dict(num_speakers=SPK, speaker_embed_dim=EMB)
    jcfg = jax_vae.ModelConfig(JaxEncoderConfig(*enc), JaxABCDConfig(*lat),
                               JaxDecoderConfig(*dec, **dkw))
    pcfg = port_vae.ModelConfig(EncoderConfig(*enc), ABCDSamplerConfig(*lat),
                                DecoderConfig(*dec, **dkw))
    params = port_init_tree(jcfg, 4)
    port = params_from_jax(params, pcfg.encoder, decoder_cfg=pcfg.decoder)
    return jcfg, pcfg, params, port


@pytest.mark.parametrize("mode", ["sample", "mean"])
def test_decode_features_matches_jax(rng, monkeypatch, model, mode):
    """The JAX package decodes ``sample`` on its ``decoder_loop`` kernel
    (interpret mode here) and ``mean`` on its scan body."""
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND",
                       "pallas" if mode == "sample" else "scan")
    one_step_scans(monkeypatch)
    jcfg, pcfg, params, port = model
    tt = 8
    lens = np.asarray([8, 5, 0, 1, 7], np.int32)
    b = len(lens)
    feats = rng.normal(size=(b, FEAT)).astype(np.float32)
    speaker = np.asarray([1, 0, 1, 1, 0], np.int32)
    gt_out = rng.normal(size=(b, tt, F)).astype(np.float32)
    gt_offset = (np.arange(tt)[None, :] == lens[:, None] - 1).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    with jax.default_matmul_precision("highest"):
        want = reference_jit(
            lambda p, *a: jax_decoder.decoder_apply(
                p, jcfg.decoder, a[0], a[1], tt, speaker=a[2], key=key,
                deterministic=True, emission_mode=mode,
                ground_truth_out=a[3], ground_truth_offset=a[4]))(
                    params["decoder"], *(jnp.asarray(a) for a in (
                        feats, lens, speaker, gt_out, gt_offset)))
    # the call's own draw: fold_in(key, 0), then split, then (T, B, F)
    k_noise, _ = jax.random.split(jax.random.fold_in(key, 0))
    noise = np.asarray(jax.random.normal(k_noise, (tt, b, F)))
    got = decode_features(port, pcfg, t(feats), torch.from_numpy(lens), tt,
                          noise=t(noise), speaker=torch.from_numpy(speaker),
                          emission_mode=mode)
    for name in ("out", "offset_weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **TOL)
    for g, w in zip(got.emission_params, want.emission_params):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert got.out.shape == (b, tt, F)
    assert got.emission_loss is None and got.offset_loss is None
    # the losses against given targets (sums of B * T * F terms)
    lossy = dec_mod.decoder_apply(
        port["decoder"], pcfg.decoder, t(feats), torch.from_numpy(lens), tt,
        noise=t(noise), speaker=torch.from_numpy(speaker),
        ground_truth_out=t(gt_out), ground_truth_offset=t(gt_offset),
        emission_mode=mode)
    for name in ("emission_loss", "offset_loss"):
        np.testing.assert_allclose(getattr(lossy, name).item(),
                                   float(getattr(want, name)), rtol=1e-5,
                                   err_msg=name)


def test_decode_features_draws_from_a_generator(model, tmp_path):
    """Noise drawn from a generator repeats with its seed; a checkpoint
    written by the JAX package loads for decoding."""
    jcfg, pcfg, params, port = model
    loaded, cfg = load_model(write_jax_checkpoint(tmp_path, jcfg, params),
                             device="cpu")
    assert cfg == pcfg
    feats = torch.ones(3, FEAT)
    lens = torch.tensor([4, 2, 0], dtype=torch.int32)
    speaker = torch.tensor([0, 1, 0], dtype=torch.int32)
    draws = [decode_features(p, pcfg, feats, lens, 4, speaker=speaker,
                             generator=torch.Generator().manual_seed(5)).out
             for p in (port, loaded)]
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    assert torch.isfinite(draws[0]).all()
    with pytest.raises(ValueError, match="noise or a generator"):
        decode_features(port, pcfg, feats, lens, 4, speaker=speaker)
    # decoding is deterministic: a greedy decoder's checkpoint decodes on
    # the same sampled loop (its option acts only in training)
    noise = torch.randn(4, 3, F, generator=torch.Generator().manual_seed(6))
    greedy = port_vae.ModelConfig(
        pcfg.encoder, pcfg.latent,
        DecoderConfig(F, H, MLP, FEAT, self_feedback=False,
                      num_speakers=SPK, speaker_embed_dim=EMB))
    torch.testing.assert_close(
        decode_features(port, greedy, feats, lens, 4, noise=noise,
                        speaker=speaker).out,
        decode_features(port, pcfg, feats, lens, 4, noise=noise,
                        speaker=speaker).out, rtol=0, atol=0)
    # a GRU decoder decodes on its own loop (gru_decoder_loop): the
    # generator's draw is the noise its seed gives, and the sample is the
    # reparameterised draw from the emission it returns
    gru = port_vae.ModelConfig(
        pcfg.encoder, pcfg.latent,
        DecoderConfig(F, H, MLP, FEAT, rnn_type="GRU"))
    gru_port = dict(port, decoder=dec_mod.decoder_init(
        torch.Generator().manual_seed(7), gru.decoder))
    noise = torch.randn(4, 3, F, generator=torch.Generator().manual_seed(5))
    drawn = decode_features(gru_port, gru, feats, lens, 4,
                            generator=torch.Generator().manual_seed(5))
    given = decode_features(gru_port, gru, feats, lens, 4, noise=noise)
    torch.testing.assert_close(drawn.out, given.out, rtol=0, atol=0)
    mean, logvar = drawn.emission_params
    torch.testing.assert_close(
        drawn.out, mean + torch.exp(0.5 * logvar) * noise.transpose(0, 1),
        rtol=0, atol=0)
    assert torch.isfinite(drawn.out).all() and drawn.out.shape == (3, 4, F)
