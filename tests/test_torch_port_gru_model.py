"""The GRU model of the PyTorch port against the JAX package: the
bidirectional GRU ``encoder_apply``, parameter trees in both directions and
fresh trees of the JAX shapes, one training loss with two clipped SGD
steps against ``vae.training_loss`` and ``optim.make_optimizer`` (the JAX
side on its scan paths), the CLI training, resuming and encoding a GRU
model on the CPU; and ``decode_features`` on checkpoints trained with the
greedy decoder or decoder input dropout, against the JAX
``decode_features``."""

import csv
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.configs import (
    ABCDSamplerConfig as JaxABCDConfig, DecoderConfig as JaxDecoderConfig,
    EncoderConfig as JaxEncoderConfig)
from seq2seq_abcd_vae_tpu.infer import decode as jax_decode
from seq2seq_abcd_vae_tpu.models import encoder as jax_encoder
from seq2seq_abcd_vae_tpu.models import vae as jax_vae
from seq2seq_abcd_vae_tpu.train import optim as jax_optim
from seq2seq_abcd_vae_tpu_torch.cli import encode_main, learning_main
from seq2seq_abcd_vae_tpu_torch.configs import (ABCDSamplerConfig,
                                                DecoderConfig, EncoderConfig)
from seq2seq_abcd_vae_tpu_torch.infer.decode import (decode_features,
                                                     load_model)
from seq2seq_abcd_vae_tpu_torch.models import encoder as port_encoder
from seq2seq_abcd_vae_tpu_torch.models import vae as port_vae
from seq2seq_abcd_vae_tpu_torch.train import optim as port_optim
from seq2seq_abcd_vae_tpu_torch.train.from_jax import (params_from_jax,
                                                       params_to_jax)
from seq2seq_abcd_vae_tpu_torch.tree import tree_leaves, tree_map
from torch_port_fixtures import (few_torch_threads_fixture, one_step_scans,
                                 port_init_tree, reference_jit,
                                 write_jax_checkpoint)

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOY = os.path.join(ROOT, "fixtures", "toy_data")
CSV = os.path.join(TOY, "annotation_20170806-080002_89.2-94.22.csv")
# float32 sums in another order: values to 1e-5 relative; gradients and
# updated parameters to 1e-5 of each leaf's largest magnitude
TOL = dict(rtol=1e-5, atol=1e-6)
FRACTION = 1e-5
F, H, MLP, K, FEAT, SPK, EMB = 9, 8, 12, 6, 10, 2, 3


def close_to_scale(got, want, name, fraction=FRACTION):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= fraction * max(np.abs(want).max(), 1e-12), (name, err)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_gru_encoder_and_trees_match_jax(rng, monkeypatch):
    """Two bidirectional GRU layers (the first one's outs feed the
    second): encoder_apply against the JAX scan path; the layers cross to
    the port and back unchanged; a fresh tree has the JAX shapes."""
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    one_step_scans(monkeypatch)
    jcfg = JaxEncoderConfig(7, 5, rnn_type="GRU", rnn_layers=2)
    pcfg = EncoderConfig(7, 5, rnn_type="GRU", rnn_layers=2)
    params = params_to_jax({"encoder": port_encoder.encoder_init(
        torch.Generator().manual_seed(2), pcfg), "feature_sampler": {}}
    )["encoder"]
    assert (jax.tree_util.tree_map(np.shape, params)
            == jax.tree_util.tree_map(np.shape, jax.eval_shape(
                lambda k: jax_encoder.encoder_init(k, jcfg),
                jax.random.PRNGKey(2))))
    lens = np.asarray([11, 0, 6, 1], np.int32)
    x = rng.normal(size=(4, 11, 7)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = reference_jit(
            lambda p, xx, n: jax_encoder.encoder_apply(p, jcfg, xx, n))(
                params, jnp.asarray(x), jnp.asarray(lens))
    port = params_from_jax({"encoder": params, "feature_sampler": {}}, pcfg)
    assert tuple(port["encoder"][1]["w_ih"].shape) == (2, 10, 15)
    got = port_encoder.encoder_apply(port["encoder"], pcfg, t(x),
                                     torch.from_numpy(lens))
    # h only: layers * directions * hidden
    assert got.shape == (4, pcfg.hidden_size_total) == (4, 2 * 2 * 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    back = params_to_jax(port)["encoder"]
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(g, w)
    fresh = port_encoder.encoder_init(torch.Generator().manual_seed(0), pcfg)
    assert (tree_map(lambda a: tuple(a.shape), params_to_jax(
        {"encoder": fresh, "feature_sampler": {}})["encoder"])
        == jax.tree_util.tree_map(np.shape, params))


def _configs(enc_kw=None, dec_kw=None):
    enc_kw = dict(rnn_type="GRU") if enc_kw is None else enc_kw
    dec_kw = dict(rnn_type="GRU") if dec_kw is None else dec_kw
    dkw = dict(num_speakers=SPK, speaker_embed_dim=EMB, **dec_kw)
    jenc = JaxEncoderConfig(F, H, **enc_kw)
    penc = EncoderConfig(F, H, **enc_kw)
    lat = (jenc.hidden_size_total, MLP, K, FEAT)
    dec = (F, H, MLP, FEAT)
    jcfg = jax_vae.ModelConfig(jenc, JaxABCDConfig(*lat),
                               JaxDecoderConfig(*dec, **dkw))
    pcfg = port_vae.ModelConfig(penc, ABCDSamplerConfig(*lat),
                                DecoderConfig(*dec, **dkw))
    return jcfg, pcfg


def test_gru_model_tree_and_training_steps_match_jax(rng, monkeypatch):
    """A fresh GRU model has the JAX tree; one training loss, its
    gradients and two clipped SGD steps with momentum match the JAX
    package's on the same weights, inputs and noise."""
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    one_step_scans(monkeypatch)
    jcfg, pcfg = _configs()
    want_shapes = jax.tree_util.tree_map(
        lambda a: a.shape,
        jax.eval_shape(lambda k: jax_vae.model_init(k, jcfg),
                       jax.random.PRNGKey(0)))
    fresh = port_vae.model_init(torch.Generator().manual_seed(0), pcfg)
    assert tree_map(lambda a: a.shape, params_to_jax(fresh)) == want_shapes
    # feature2hidden is H wide for the GRU (no c)
    assert tuple(fresh["decoder"]["feature2hidden"]["w"].shape) == (
        FEAT + EMB, H)

    tt = 10
    lens = np.asarray([10, 7, 0, 3, 9], np.int32)
    b = len(lens)
    valid = np.arange(tt)[None, :] < lens[:, None]
    inputs = (rng.normal(size=(b, tt, F)) * valid[..., None]).astype(
        np.float32)
    speakers = np.asarray([1, 0, -1, 1, 0], np.int32)
    is_offset = (np.arange(tt)[None, :] == lens[:, None] - 1).astype(
        np.float32)
    n_data, temperature, lr, momentum, clip = 40.0, 0.8, 0.5, 0.9, 1.0
    params = port_init_tree(jcfg, 7)
    tx = jax_optim.make_optimizer(lr, momentum, clip)
    opt_state = tx.init(params)
    batch = {"inputs": jnp.asarray(inputs), "lengths": jnp.asarray(lens),
             "speakers": jnp.asarray(speakers),
             "is_offset": jnp.asarray(is_offset)}

    @reference_jit
    def jax_step(p, state, key):
        (loss, aux), grads = jax.value_and_grad(
            lambda q: jax_vae.training_loss(q, jcfg, batch, key, n_data,
                                            temperature=temperature),
            has_aux=True)(p)
        updates, state = tx.update(grads, state, p)
        new = jax.tree_util.tree_map(lambda a, u: a + u, p, updates)
        # forward_losses' key flow: (encoder, latent, decoder) keys; the
        # Gumbel draw of the latent key; the decoder's fold_in(., 0) split
        _, k_lat, k_dec = jax.random.split(key, 3)
        k_noise, _ = jax.random.split(jax.random.fold_in(k_dec, 0))
        noise = (jax.random.gumbel(k_lat, (b, K)),
                 jax.random.normal(k_noise, (tt, b, F)))
        return loss, aux, grads, new, state, noise

    port_params = tree_map(lambda a: a.requires_grad_(True),
                           params_from_jax(params, pcfg.encoder,
                                           decoder_cfg=pcfg.decoder))
    optimizer = port_optim.make_optimizer(tree_leaves(port_params), lr,
                                          momentum)
    for step in range(2):
        with jax.default_matmul_precision("highest"):
            want_loss, aux, grads, params, opt_state, noise = jax_step(
                params, opt_state, jax.random.PRNGKey(100 + step))
        params = jax.tree_util.tree_map(np.asarray, params)
        gumbel, dec_noise = (np.asarray(a) for a in noise)
        loss, out = port_vae.training_loss(
            port_params, pcfg,
            {"inputs": t(inputs), "lengths": torch.from_numpy(lens),
             "speakers": torch.from_numpy(speakers)},
            {"gumbel": t(gumbel), "decoder": t(dec_noise)}, n_data,
            temperature=temperature)
        np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
        for k in ("emission_loss", "offset_loss", "kl_loss"):
            np.testing.assert_allclose(out[k].item(), float(aux[k]), **TOL)
        optimizer.zero_grad()
        loss.backward()
        got_grads = params_to_jax(tree_map(lambda p: p.grad, port_params))
        for (path, g), w in zip(
                jax.tree_util.tree_leaves_with_path(got_grads),
                jax.tree_util.tree_leaves(grads)):
            close_to_scale(g, w, f"step {step} grad "
                           + jax.tree_util.keystr(path))
        port_optim.clip_and_step(optimizer, tree_leaves(port_params), clip)
        for (path, g), w in zip(
                jax.tree_util.tree_leaves_with_path(
                    params_to_jax(port_params)),
                jax.tree_util.tree_leaves(params)):
            close_to_scale(g, w, f"step {step} param "
                           + jax.tree_util.keystr(path))


def test_cli_trains_resumes_and_encodes_gru(tmp_path):
    """``-R GRU`` trains (the decoder follows the encoder's cell), resumes
    and encodes through the encode CLI on the CPU; its checkpoint decodes
    in both modes."""
    argv = [TOY, CSV, "-S", str(tmp_path), "-j", "gru", "-b", "4",
            "--pretrain_epochs", "1", "-d", "cpu", "-R", "GRU",
            "--stft_method", "pallas", "-K", "5", "-f", "6",
            "--encoder_rnn_hidden_size", "6", "--decoder_rnn_hidden_size",
            "6", "--mlp_hidden_size", "6", "-N", "11.0"]
    first = learning_main.main(argv + ["-e", "2"])
    assert first.model_cfg.encoder.rnn_type == "GRU"
    assert first.model_cfg.decoder.rnn_type == "GRU"
    assert first.steps == {"train": 4, "eval": 2}
    again = learning_main.main(argv + ["-e", "3"])
    run = tmp_path / "gru"
    log = (run / "history.log").read_text()
    assert "LEARNING RETRIEVED." in log and log.rstrip().endswith(
        "END OF TRAINING")
    assert "Type of RNN used for the decoder: GRU" in log
    assert all(np.isfinite(float(v)) for v in re.findall(
        r"total loss \(per string\): (\S+)", log))
    assert again.steps == {"train": 2, "eval": 1}
    assert tuple(again.params["encoder"][0]["w_hh"].shape) == (2, 6, 18)
    assert tuple(again.params["decoder"]["rnn_cell"]["w_hh"].shape) == (
        6, 18)
    ckpt = str(run / "checkpoint.pt")
    out = tmp_path / "probs.csv"
    encode_main.main("probs", [ckpt, TOY, CSV, "11.0", "-S", str(out),
                               "-b", "4", "-d", "cpu"])
    with open(out) as f:
        rows = list(csv.DictReader(f))
    sums = {}
    for row in rows:
        sums[row["data_ix"]] = sums.get(row["data_ix"], 0.0) + float(
            row["prob"])
    assert len(rows) == 5 * len(sums) and len(sums) == 8
    np.testing.assert_allclose(list(sums.values()), 1.0, atol=1e-5)
    # the GRU decoder decodes (gru_decoder_loop), in both modes
    params, mcfg = load_model(ckpt, device="cpu")
    assert mcfg.decoder.rnn_type == "GRU"
    feats = torch.randn(3, 6, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([5, 0, 3], dtype=torch.int32)
    speaker = torch.tensor([0, 1, 1], dtype=torch.int32)
    noise = torch.randn(5, 3, mcfg.decoder.output_size,
                        generator=torch.Generator().manual_seed(2))
    for mode in ("sample", "mean"):
        got = decode_features(params, mcfg, feats, lens, 5, noise=noise,
                              speaker=speaker, emission_mode=mode)
        mean, logvar = got.emission_params
        assert torch.isfinite(got.out).all()
        torch.testing.assert_close(
            got.out, mean if mode == "mean" else
            mean + torch.exp(0.5 * logvar) * noise.transpose(0, 1),
            rtol=0, atol=0)


@pytest.mark.parametrize("kind,mode", [("greedy", "sample"),
                                       ("greedy", "mean"),
                                       ("input_dropout", "sample"),
                                       ("input_dropout", "mean")])
def test_decode_admits_training_only_decoder_options(rng, monkeypatch,
                                                     tmp_path, kind, mode):
    """A checkpoint trained with ``--greedy_decoder`` or decoder input
    dropout decodes as in the JAX package: deterministically, on the
    sampled loop (sample mode) or the scan body (mean mode); training such
    a decoder stays refused."""
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND",
                       "pallas" if mode == "sample" else "scan")
    one_step_scans(monkeypatch)
    dec_kw = (dict(self_feedback=False) if kind == "greedy"
              else dict(input_dropout=0.3))
    jcfg, pcfg = _configs(enc_kw={}, dec_kw=dec_kw)
    params = port_init_tree(jcfg, 4)
    port, cfg = load_model(write_jax_checkpoint(tmp_path, jcfg, params),
                           device="cpu")
    # the checkpoint keeps input_dropout (1.0 for the greedy decoder)
    assert (cfg.encoder, cfg.latent) == (pcfg.encoder, pcfg.latent)
    assert cfg.decoder.input_dropout == pcfg.decoder.input_dropout > 0
    tt = 8
    lens = np.asarray([8, 5, 0, 1, 7], np.int32)
    b = len(lens)
    feats = rng.normal(size=(b, FEAT)).astype(np.float32)
    speaker = np.asarray([1, 0, 1, 1, 0], np.int32)
    key = jax.random.PRNGKey(9)
    with jax.default_matmul_precision("highest"):
        want = reference_jit(
            lambda p, f, n, s: jax_decode.decode_features(
                p, jcfg, f, n, tt, key, speaker=s, emission_mode=mode))(
                    params, jnp.asarray(feats), jnp.asarray(lens),
                    jnp.asarray(speaker))
    # the call's own draw: fold_in(key, 0), then split, then (T, B, F)
    k_noise, _ = jax.random.split(jax.random.fold_in(key, 0))
    noise = np.asarray(jax.random.normal(k_noise, (tt, b, F)))
    got = decode_features(port, cfg, t(feats), torch.from_numpy(lens), tt,
                          noise=t(noise), speaker=torch.from_numpy(speaker),
                          emission_mode=mode)
    for name in ("out", "offset_weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, rtol=1e-5, atol=1e-5)
    for g, w in zip(got.emission_params, want.emission_params):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(NotImplementedError, match="training"):
        pcfg.check()
