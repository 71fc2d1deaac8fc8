"""The unidirectional LSTM encoder of the PyTorch port against the JAX
package: the one-direction layer's twin (``ops/lstm_kernel.lstm_layer``,
what the kernel wrapper runs on the CPU) forward and gradients against the
Pallas kernel ``lstm_pallas.lstm_layer`` in interpret mode and
``jax.grad`` through it; ``encoder_apply``; one training loss and a
clipped SGD step against ``vae.training_loss`` and
``optim.make_optimizer``; the CLI training, resuming and serving such a
model."""

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
from seq2seq_abcd_vae_tpu.models import encoder as jax_encoder
from seq2seq_abcd_vae_tpu.models import vae as jax_vae
from seq2seq_abcd_vae_tpu.ops import lstm_pallas
from seq2seq_abcd_vae_tpu.train import optim as jax_optim
from seq2seq_abcd_vae_tpu_torch.cli import learning_main
from seq2seq_abcd_vae_tpu_torch.configs import (ABCDSamplerConfig,
                                                DecoderConfig, EncoderConfig)
from seq2seq_abcd_vae_tpu_torch.models import encoder as port_encoder
from seq2seq_abcd_vae_tpu_torch.models import vae as port_vae
from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel
from seq2seq_abcd_vae_tpu_torch.serve import EncodeService
from seq2seq_abcd_vae_tpu_torch.train import optim as port_optim
from seq2seq_abcd_vae_tpu_torch.train.from_jax import (params_from_jax,
                                                       params_to_jax)
from seq2seq_abcd_vae_tpu_torch.tree import tree_leaves, tree_map
from torch_port_fixtures import (few_torch_threads_fixture, one_step_scans,
                                 port_init_tree, reference_jit)

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOY = os.path.join(ROOT, "fixtures", "toy_data")
CSV = os.path.join(TOY, "annotation_20170806-080002_89.2-94.22.csv")
# float32 sums in another order: values to 1e-5 relative; gradients and
# updated parameters to 1e-5 of each leaf's largest magnitude
TOL = dict(rtol=1e-5, atol=1e-6)
FRACTION = 1e-5


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close_to_scale(got, want, name, fraction=FRACTION):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= fraction * max(np.abs(want).max(), 1e-12), (name, err)


@pytest.mark.parametrize("with_outs", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_twin_matches_pallas_interpret(rng, reverse, with_outs):
    """Forward against the Pallas kernel, gradients against jax.grad
    through its custom VJP; ragged lengths and an empty row.  Without outs
    in the loss the outs cotangent is None (the encoder's single layer)."""
    tt, b, h = 9, 5, 6
    lens = np.asarray([9, 4, 0, 1, 7], np.int32)
    xp = rng.normal(size=(tt, b, 4 * h)).astype(np.float32)
    w_hh = rng.uniform(-0.4, 0.4, size=(h, 4 * h)).astype(np.float32)
    b_hh = rng.uniform(-0.4, 0.4, size=(4 * h,)).astype(np.float32)
    w_out = rng.normal(size=(h, 3)).astype(np.float32)

    def loss_of(outs, h_n, c_n, w, tanh, sin, s):
        out_term = s(tanh(outs @ w)) if with_outs else 0.0
        return out_term + s(h_n * h_n) + s(sin(c_n))

    def jax_loss(xp_, w_, b_):
        outs, h_n, c_n = lstm_pallas.lstm_layer(
            xp_, jnp.asarray(lens), w_, b_, interpret=True, reverse=reverse)
        return loss_of(outs, h_n, c_n, jnp.asarray(w_out), jnp.tanh, jnp.sin,
                       jnp.sum), (outs, h_n, c_n)

    with jax.default_matmul_precision("highest"):
        (want_loss, want), want_grads = reference_jit(jax.value_and_grad(
            jax_loss, argnums=(0, 1, 2), has_aux=True))(
                jnp.asarray(xp), jnp.asarray(w_hh), jnp.asarray(b_hh))
    got = lstm_kernel.lstm_layer(t(xp), torch.from_numpy(lens), t(w_hh),
                                 t(b_hh), reverse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    args = [t(a).requires_grad_(True) for a in (xp, w_hh, b_hh)]
    outs, h_n, c_n = lstm_kernel.lstm_layer_train(
        args[0], torch.from_numpy(lens), args[1], args[2], reverse)
    loss = loss_of(outs, h_n, c_n, t(w_out), torch.tanh, torch.sin,
                   torch.sum)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    loss.backward()
    for a, w, name in zip(args, want_grads, ("dxp", "dw_hh", "db_hh")):
        close_to_scale(a.grad.numpy(), w, name)


def test_lstm_layer_wrapper_rejects_what_the_kernel_does_not_take():
    xp, w, b = torch.zeros(3, 2, 8), torch.zeros(2, 8), torch.zeros(8)
    lens = torch.tensor([3, 1], dtype=torch.int32)
    lstm_kernel.lstm_layer(xp, lens, w, b)
    for bad in ((xp, lens.long(), w, b), (xp.double(), lens, w, b),
                (xp, lens, torch.zeros(3, 8), b),
                (xp.transpose(0, 1), lens, w, b)):
        with pytest.raises(ValueError):
            lstm_kernel.lstm_layer(*bad)


def _encoder(layers, input_size=7, hidden=5, seed=2):
    jcfg = JaxEncoderConfig(input_size, hidden, rnn_layers=layers,
                            bidirectional=False)
    pcfg = EncoderConfig(input_size, hidden, rnn_layers=layers,
                         bidirectional=False)
    params = params_to_jax({"encoder": port_encoder.encoder_init(
        torch.Generator().manual_seed(seed), pcfg), "feature_sampler": {}}
    )["encoder"]
    return jcfg, pcfg, params


@pytest.mark.parametrize("layers", [1, 2])
def test_unidirectional_encoder_matches_jax(rng, monkeypatch, layers):
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    one_step_scans(monkeypatch)
    jcfg, pcfg, params = _encoder(layers)
    lens = np.asarray([11, 0, 6, 1], np.int32)
    x = rng.normal(size=(4, 11, 7)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = reference_jit(
            lambda p, xx, n: jax_encoder.encoder_apply(p, jcfg, xx, n))(
                params, jnp.asarray(x), jnp.asarray(lens))
    tree = {"encoder": params, "feature_sampler": {}}
    port = params_from_jax(tree, pcfg)
    got = port_encoder.encoder_apply(port["encoder"], pcfg, t(x),
                                     torch.from_numpy(lens))
    assert got.shape == (4, pcfg.hidden_size_total) == (4, 2 * 5 * layers)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the layers cross back to the JAX tree ("fwd" only) unchanged
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


F, H, MLP, K, FEAT, SPK, EMB = 9, 8, 12, 6, 10, 2, 3


def test_unidirectional_training_step_matches_jax(rng, monkeypatch):
    """One training loss, its gradients and a clipped SGD step with
    momentum, the JAX side on its scan paths with its own noise draws."""
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    one_step_scans(monkeypatch)
    enc, lat, dec = (F, H), (2 * H, MLP, K, FEAT), (F, H, MLP, FEAT)
    dkw = dict(num_speakers=SPK, speaker_embed_dim=EMB)
    jcfg = jax_vae.ModelConfig(
        JaxEncoderConfig(*enc, bidirectional=False), JaxABCDConfig(*lat),
        JaxDecoderConfig(*dec, **dkw))
    pcfg = port_vae.ModelConfig(
        EncoderConfig(*enc, bidirectional=False), ABCDSamplerConfig(*lat),
        DecoderConfig(*dec, **dkw))
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
    batch = {"inputs": jnp.asarray(inputs), "lengths": jnp.asarray(lens),
             "speakers": jnp.asarray(speakers),
             "is_offset": jnp.asarray(is_offset)}
    key = jax.random.PRNGKey(100)

    @reference_jit
    def jax_step(p):
        (loss, aux), grads = jax.value_and_grad(
            lambda q: jax_vae.training_loss(q, jcfg, batch, key, n_data,
                                            temperature=temperature),
            has_aux=True)(p)
        # forward_losses' key flow: (encoder, latent, decoder) keys; the
        # Gumbel draw of the latent key; the decoder's fold_in(., 0) split
        _, k_lat, k_dec = jax.random.split(key, 3)
        k_noise, _ = jax.random.split(jax.random.fold_in(k_dec, 0))
        noise = (jax.random.gumbel(k_lat, (b, K)),
                 jax.random.normal(k_noise, (tt, b, F)))
        return loss, aux, grads, tx.update(grads, tx.init(p), p)[0], noise

    with jax.default_matmul_precision("highest"):
        want_loss, aux, grads, updates, noise = jax_step(params)
    new = jax.tree_util.tree_map(lambda a, u: np.asarray(a + u), params,
                                 updates)
    gumbel, dec_noise = (np.asarray(a) for a in noise)

    port_params = tree_map(lambda a: a.requires_grad_(True),
                           params_from_jax(params, pcfg.encoder,
                                           decoder_cfg=pcfg.decoder))
    optimizer = port_optim.make_optimizer(tree_leaves(port_params), lr,
                                          momentum)
    loss, out = port_vae.training_loss(
        port_params, pcfg,
        {"inputs": t(inputs), "lengths": torch.from_numpy(lens),
         "speakers": torch.from_numpy(speakers)},
        {"gumbel": t(gumbel), "decoder": t(dec_noise)}, n_data,
        temperature=temperature)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    for k in ("emission_loss", "offset_loss", "kl_loss"):
        np.testing.assert_allclose(out[k].item(), float(aux[k]), **TOL)
    loss.backward()
    got_grads = params_to_jax(tree_map(lambda p: p.grad, port_params))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got_grads),
                            jax.tree_util.tree_leaves(grads)):
        close_to_scale(g, w, "grad " + jax.tree_util.keystr(path))
    port_optim.clip_and_step(optimizer, tree_leaves(port_params), clip)
    for (path, g), w in zip(
            jax.tree_util.tree_leaves_with_path(params_to_jax(port_params)),
            jax.tree_util.tree_leaves(new)):
        close_to_scale(g, w, "param " + jax.tree_util.keystr(path))


def test_cli_trains_resumes_and_serves_unidirectional(tmp_path):
    argv = [TOY, CSV, "-S", str(tmp_path), "-j", "uni", "-b", "4",
            "--pretrain_epochs", "1", "-d", "cpu", "--unidirectional_encoder",
            "-K", "5", "-f", "6", "--encoder_rnn_hidden_size", "6",
            "--decoder_rnn_hidden_size", "6", "--mlp_hidden_size", "6",
            "-N", "11.0"]
    first = learning_main.main(argv + ["-e", "2"])
    assert not first.model_cfg.encoder.bidirectional
    assert first.steps == {"train": 4, "eval": 2}
    again = learning_main.main(argv + ["-e", "3"])
    with open(tmp_path / "uni" / "history.log") as f:
        log = f.read()
    assert "LEARNING RETRIEVED." in log and log.rstrip().endswith(
        "END OF TRAINING")
    assert all(np.isfinite(float(v)) for v in re.findall(
        r"total loss \(per string\): (\S+)", log))
    assert again.steps == {"train": 2, "eval": 1}
    layer = again.params["encoder"][0]
    assert tuple(layer["w_hh"].shape) == (6, 24)  # one direction
    service = EncodeService(str(tmp_path / "uni" / "checkpoint.pt"), 11.0,
                            16000, device="cpu", mode="probs",
                            buckets=(8, 16), batch_size=2)
    try:
        audio = np.random.default_rng(0).normal(size=900).astype(
            np.float32) * 1000
        probs = np.asarray(service.encode(audio, 16000))
    finally:
        service.close()
    assert probs.shape == (5,) and abs(probs.sum() - 1) < 1e-5
