"""The unidirectional GRU, Elman RNN and echo-state (ESN) encoders and the
generative decoding of GRU, Elman and ESN decoders in the PyTorch port,
against the JAX package.

- The one-direction layers' twins (``ops/gru_kernel.gru_layer``,
  ``ops/elman_kernel.rnn_layer``: what the wrappers run on CPU tensors and
  what the card's kernels are held to), forward and backward, against the
  Pallas kernels ``gru_pallas.gru_layer`` and ``elman_pallas.rnn_layer`` in
  interpret mode and ``jax.grad`` through their custom VJPs, in both span
  directions, the Elman cell at leak 1.0 and the ESN's 0.5.
- The sampled loops' twins (``ops/decoder_kernel.gru_decoder_loop``,
  ``rnn_decoder_loop``) against ``decoder_pallas.gru_decoder_loop`` and
  ``rnn_decoder_loop`` in interpret mode, on the same noise.
- For each cell: ``encoder_apply`` of two unidirectional layers, the
  parameter trees both ways, one training loss with one clipped SGD step
  (the ESN's reservoir frozen), and ``decode_features`` in sample and mean
  modes against the JAX package on its scan paths.
- The CLI training, resuming, encoding and decoding a unidirectional GRU
  and ESN model on the CPU, and a JAX-written unidirectional checkpoint
  resuming in the port.
"""

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
from seq2seq_abcd_vae_tpu.ops import decoder_pallas, elman_pallas, gru_pallas
from seq2seq_abcd_vae_tpu.train import checkpoint as jax_ckpt
from seq2seq_abcd_vae_tpu.train import optim as jax_optim
from seq2seq_abcd_vae_tpu_torch.cli import encode_main, learning_main
from seq2seq_abcd_vae_tpu_torch.configs import (ABCDSamplerConfig,
                                                DecoderConfig, EncoderConfig)
from seq2seq_abcd_vae_tpu_torch.infer.decode import (decode_features,
                                                     load_model)
from seq2seq_abcd_vae_tpu_torch.models import encoder as port_encoder
from seq2seq_abcd_vae_tpu_torch.models import vae as port_vae
from seq2seq_abcd_vae_tpu_torch.ops import (decoder_kernel, elman_kernel,
                                            gru_kernel)
from seq2seq_abcd_vae_tpu_torch.train import checkpoint as port_ckpt
from seq2seq_abcd_vae_tpu_torch.train import optim as port_optim
from seq2seq_abcd_vae_tpu_torch.train.from_jax import (params_from_jax,
                                                       params_to_jax)
from seq2seq_abcd_vae_tpu_torch.train.learner import Learner
from seq2seq_abcd_vae_tpu_torch.tree import tree_leaves, tree_map
from torch_port_fixtures import (few_torch_threads_fixture, one_step_scans,
                                 port_init_tree, reference_jit)

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOY = os.path.join(ROOT, "fixtures", "toy_data")
CSV = os.path.join(TOY, "annotation_20170806-080002_89.2-94.22.csv")
HIGHEST = jax.lax.Precision.HIGHEST
# float32 sums in another order through at most 10 recurrent steps: layer
# values to 1e-5 absolute (|h| <= 1); losses, encodings and decoded
# streams to 1e-5 relative (1e-5 absolute near 0); each gradient leaf and
# each updated parameter to 1e-4 (kernel twins) or 1e-5 (model steps) of
# its largest magnitude (a leaf sums every step's and row's contribution)
LAYER_ATOL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_FRACTION = 1e-4
STEP_FRACTION = 1e-5
F, H, MLP, K, FEAT, SPK, EMB = 9, 16, 12, 6, 10, 2, 3
LEAK = {"GRU": 1.0, "RNN": 1.0, "ESN": 0.5}


@pytest.fixture
def scan_paths(monkeypatch):
    """The JAX package's scan paths."""
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    one_step_scans(monkeypatch)


def close_to_scale(got, want, name, fraction):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= fraction * max(np.abs(want).max(), 1e-12), (name, err)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# the kernels' twins
# ---------------------------------------------------------------------------

def _uniform(rng, bound, *shape):
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def _layer_args(rng, gates, leak, t=6, h=8, lens=(6, 0, 4)):
    """xp (T, B, gH), lengths, w_hh and b_hh of one direction (a zero
    b_hh at an ESN's leak)."""
    b_hh = _uniform(rng, 1 / np.sqrt(h), gates * h)
    if leak < 1.0:
        b_hh[:] = 0.0
    return (rng.normal(size=(t, len(lens), gates * h)).astype(np.float32),
            np.asarray(lens, np.int32),
            _uniform(rng, 1 / np.sqrt(h), h, gates * h), b_hh)


@pytest.mark.parametrize("cell,leak", [("GRU", 1.0), ("RNN", 1.0),
                                       ("RNN", 0.5)])
def test_layer_twins_match_pallas_interpret_and_grad(rng, cell, leak):
    """outs and h_n of the one-direction layer's twin against the Pallas
    kernel in interpret mode, and the gradients of xp, w_hh and b_hh
    through the explicit adjoint against jax.grad through the kernel's own
    backward: with ``reverse`` False a lower layer's case (an outs
    cotangent), with True a final layer's (h_n's alone); a ragged batch
    with an empty row."""
    gates = 3 if cell == "GRU" else 1
    for reverse in (False, True):
        xp, lens, w_hh, b_hh = _layer_args(rng, gates, leak)
        tt, b, _ = xp.shape
        h = w_hh.shape[0]
        c_outs = rng.normal(size=(tt, b, h)).astype(np.float32)
        c_hn = rng.normal(size=(b, h)).astype(np.float32)

        def total(outs, h_n, xnp):
            s = (h_n * xnp.asarray(c_hn)).sum()
            if not reverse:
                s = s + (outs * xnp.asarray(c_outs)).sum()
            return s

        def jax_loss(*args):
            if cell == "GRU":
                outs, h_n = gru_pallas.gru_layer(
                    args[0], jnp.asarray(lens), *args[1:], interpret=True,
                    precision=HIGHEST, reverse=reverse)
            else:
                outs, h_n = elman_pallas.rnn_layer(
                    args[0], jnp.asarray(lens), *args[1:], interpret=True,
                    precision=HIGHEST, reverse=reverse, leak=leak)
            return total(outs, h_n, jnp), (outs, h_n)

        (want_val, want_out), want_grads = reference_jit(
            jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(a) for a in (xp, w_hh, b_hh)))
        leaves = [torch.from_numpy(a).requires_grad_(True)
                  for a in (xp, w_hh, b_hh)]
        if cell == "GRU":
            got_out = gru_kernel.gru_layer_train(
                leaves[0], torch.from_numpy(lens), *leaves[1:], reverse)
        else:
            got_out = elman_kernel.rnn_layer_train(
                leaves[0], torch.from_numpy(lens), *leaves[1:], reverse,
                leak)
        assert got_out[0].shape == (tt, b, h)
        for g, w in zip(got_out, want_out):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=0, atol=LAYER_ATOL)
        np.testing.assert_array_equal(got_out[1][1].detach().numpy(), 0.0)
        got_val = total(*got_out, torch)
        got_val.backward()
        np.testing.assert_allclose(got_val.item(), float(want_val),
                                   rtol=1e-5, atol=1e-6)
        for name, leaf, want in zip(("xp", "w_hh", "b_hh"), leaves,
                                    want_grads):
            close_to_scale(leaf.grad.numpy(), want,
                           f"{cell} leak {leak} reverse {reverse} {name}",
                           GRAD_FRACTION)


def _loop_args(rng, cell, leak, t=7, f=4, h=6, m=5, lens=(7, 0, 3, 1, 6)):
    """The sampled loop's arguments in the JAX function's order (the GRU's
    b_ih and b_hh apart; the Elman / ESN loop's one bias, zero for the
    ESN)."""
    gh = (3 if cell == "GRU" else 1) * h
    b = len(lens)
    biases = ([_uniform(rng, 0.4, gh), _uniform(rng, 0.4, gh)]
              if cell == "GRU" else
              [_uniform(rng, 0.4, gh) if leak == 1.0
               else np.zeros(gh, np.float32)])
    return ([rng.normal(size=(t, b, f)).astype(np.float32),
             np.asarray(lens, np.int32), _uniform(rng, 0.4, h, gh + 2 * m)]
            + biases
            + [_uniform(rng, 0.4, 2 * m), _uniform(rng, 0.4, m, f),
               _uniform(rng, 0.4, m, f), _uniform(rng, 0.4, 2 * f),
               _uniform(rng, 0.4, f, gh),
               rng.normal(size=(b, h)).astype(np.float32) * 0.5])


@pytest.mark.parametrize("cell,leak", [("GRU", 1.0), ("RNN", 1.0),
                                       ("RNN", 0.5)])
def test_decoder_loop_twins_match_pallas_interpret(rng, cell, leak):
    """The pre-mask h2 of every step, step t fed position t-1's sample
    (noise[t-1]) and a zero input on a row's first step; ragged lengths,
    an empty row."""
    args = _loop_args(rng, cell, leak)
    jargs = [jnp.asarray(a) for a in args]
    if cell == "GRU":
        want = reference_jit(lambda *a: decoder_pallas.gru_decoder_loop(
            *a, interpret=True, precision=HIGHEST))(*jargs)
        got = decoder_kernel.gru_decoder_loop(
            *(torch.from_numpy(a) for a in args))
    else:
        want = reference_jit(lambda *a: decoder_pallas.rnn_decoder_loop(
            *a, interpret=True, precision=HIGHEST, leak=leak))(*jargs)
        got = decoder_kernel.rnn_decoder_loop(
            *(torch.from_numpy(a) for a in args), leak=leak)
    assert got.shape == (7, 5, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_new_wrappers_reject_what_the_kernels_do_not_take(rng):
    xp, lens, w_hh, b_hh = (torch.from_numpy(a)
                            for a in _layer_args(rng, 3, 1.0, t=3, h=4))
    gru_kernel.gru_layer(xp, lens, w_hh, b_hh)
    for bad in ((xp[..., :-1].contiguous(), lens, w_hh, b_hh),  # not 3H
                (xp, lens.long(), w_hh, b_hh),
                (xp, lens, w_hh.double(), b_hh),
                (xp.transpose(0, 1).contiguous().transpose(0, 1), lens,
                 w_hh, b_hh)):
        with pytest.raises(ValueError):
            gru_kernel.gru_layer(*bad)
    outs, h_n = gru_kernel.gru_layer(xp, lens, w_hh, b_hh)
    with pytest.raises(ValueError, match="douts"):
        gru_kernel.gru_layer_bwd(xp, lens, w_hh, b_hh, outs,
                                 outs[:-1].contiguous(), h_n)
    xp, lens, w_hh, b_hh = (torch.from_numpy(a)
                            for a in _layer_args(rng, 1, 1.0, t=3, h=4))
    elman_kernel.rnn_layer(xp, lens, w_hh, b_hh)
    with pytest.raises(ValueError, match="xp"):  # a GRU's 3H
        elman_kernel.rnn_layer(xp.repeat(1, 1, 3), lens, w_hh, b_hh)
    for leak in (0.0, 1.5):
        with pytest.raises(ValueError, match="leak"):
            elman_kernel.rnn_layer(xp, lens, w_hh, b_hh, False, leak)
    gru = [torch.from_numpy(a) for a in _loop_args(rng, "GRU", 1.0)]
    decoder_kernel.gru_decoder_loop(*gru)
    with pytest.raises(ValueError, match="b_hh"):
        decoder_kernel.gru_decoder_loop(*gru[:4], gru[4][:-1], *gru[5:])
    with pytest.raises(TypeError, match="arguments"):
        decoder_kernel.gru_decoder_loop(*gru, gru[-1])  # an LSTM c0
    rnn = [torch.from_numpy(a) for a in _loop_args(rng, "RNN", 1.0)]
    decoder_kernel.rnn_decoder_loop(*rnn)
    with pytest.raises(ValueError, match="w_cat"):  # the GRU's width
        decoder_kernel.rnn_decoder_loop(rnn[0], rnn[1], gru[2], *rnn[3:])
    with pytest.raises(ValueError, match="leak"):
        decoder_kernel.rnn_decoder_loop(*rnn, leak=0.0)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _configs(cell, layers=1):
    enc_kw = dict(rnn_type=cell, bidirectional=False, esn_leak=LEAK[cell],
                  rnn_layers=layers)
    dkw = dict(num_speakers=SPK, speaker_embed_dim=EMB, rnn_type=cell,
               esn_leak=LEAK[cell])
    jenc, penc = JaxEncoderConfig(F, H, **enc_kw), EncoderConfig(F, H,
                                                                 **enc_kw)
    lat = (jenc.hidden_size_total, MLP, K, FEAT)
    dec = (F, H, MLP, FEAT)
    return (jax_vae.ModelConfig(jenc, JaxABCDConfig(*lat),
                                JaxDecoderConfig(*dec, **dkw)),
            port_vae.ModelConfig(penc, ABCDSamplerConfig(*lat),
                                 DecoderConfig(*dec, **dkw)))


def _reservoir(tree: dict) -> list:
    """The ESN tensors of a JAX-layout tree."""
    return ([layer["fwd"][k] for layer in tree["encoder"]["layers"]
             for k in ("w_hh", "w_ih")]
            + [tree["decoder"]["rnn_cell"][k] for k in ("w_hh", "w_ih")])


@pytest.mark.parametrize("cell", ["GRU", "RNN", "ESN"])
def test_model_encoder_step_and_decode_match_jax(rng, scan_paths, cell):
    """For a unidirectional encoder of two layers (the first one's outs
    feed the second): the fresh tree has the JAX shapes ("fwd" only; no
    biases in the ESN's) and crosses to the port and back unchanged;
    ``encoder_apply`` matches; one training loss, its gradients and one
    clipped SGD step with momentum match ``vae.training_loss`` and
    ``optim.make_optimizer`` (the ESN's reservoir takes no gradient, no
    update and no share of the clip); and ``decode_features`` matches in
    sample and mean modes, the JAX call's own noise handed to the port."""
    jcfg, pcfg = _configs(cell, layers=2)
    params = port_init_tree(jcfg, 7)
    layer0 = params["encoder"]["layers"][0]
    assert set(layer0) == {"fwd"}
    assert set(layer0["fwd"]) == ({"w_ih", "w_hh"} if cell == "ESN" else
                                  {"w_ih", "w_hh", "b_ih", "b_hh"})
    if cell != "ESN":  # the JAX ESN initialiser needs concrete arrays
        assert (jax.tree_util.tree_map(np.shape, params)
                == jax.tree_util.tree_map(
                    lambda a: a.shape,
                    jax.eval_shape(lambda k: jax_vae.model_init(k, jcfg),
                                   jax.random.PRNGKey(0))))
    port = port_vae.set_trainable(
        params_from_jax(params, pcfg.encoder, decoder_cfg=pcfg.decoder),
        pcfg)
    gates = {"GRU": 3, "RNN": 1, "ESN": 1}[cell]
    assert tuple(port["encoder"][1]["w_ih"].shape) == (H, gates * H)
    for g, w in zip(jax.tree_util.tree_leaves(params_to_jax(port)),
                    jax.tree_util.tree_leaves(params), strict=True):
        np.testing.assert_array_equal(g, w)

    tt = 10
    lens = np.asarray([10, 7, 0, 3, 9], np.int32)
    b = len(lens)
    valid = np.arange(tt)[None, :] < lens[:, None]
    inputs = (rng.normal(size=(b, tt, F)) * valid[..., None]).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        want_enc = reference_jit(
            lambda p, x, n: jax_encoder.encoder_apply(p, jcfg.encoder, x, n))(
                params["encoder"], jnp.asarray(inputs), jnp.asarray(lens))
    with torch.no_grad():
        got_enc = port_encoder.encoder_apply(
            port["encoder"], pcfg.encoder, t(inputs),
            torch.from_numpy(lens))
    # h only: layers * hidden
    assert got_enc.shape == (b, pcfg.encoder.hidden_size_total) == (b, 2 * H)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc), **TOL)

    # one training step
    speakers = np.asarray([1, 0, -1, 1, 0], np.int32)
    is_offset = (np.arange(tt)[None, :] == lens[:, None] - 1).astype(
        np.float32)
    n_data, temperature, lr, momentum, clip = 40.0, 0.8, 0.5, 0.9, 1.0
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
        updates, _ = tx.update(grads, tx.init(p), p)
        # forward_losses' key flow: (encoder, latent, decoder) keys; the
        # Gumbel draw of the latent key; the decoder's fold_in(., 0) split
        _, k_lat, k_dec = jax.random.split(key, 3)
        k_noise, _ = jax.random.split(jax.random.fold_in(k_dec, 0))
        noise = (jax.random.gumbel(k_lat, (b, K)),
                 jax.random.normal(k_noise, (tt, b, F)))
        return loss, aux, grads, jax.tree_util.tree_map(
            lambda a, u: a + u, p, updates), noise

    with jax.default_matmul_precision("highest"):
        want_loss, aux, grads, stepped, (gumbel, dec_noise) = jax_step(params)
    trainable = [p for p in tree_leaves(port) if p.requires_grad]
    assert len(tree_leaves(port)) - len(trainable) == (
        2 + 2 + 2 if cell == "ESN" else 0)   # two layers and the decoder
    optimizer = port_optim.make_optimizer(trainable, lr, momentum)
    loss, out = port_vae.training_loss(
        port, pcfg, {"inputs": t(inputs), "lengths": torch.from_numpy(lens),
                     "speakers": torch.from_numpy(speakers)},
        {"gumbel": t(gumbel), "decoder": t(dec_noise)}, n_data,
        temperature=temperature)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    for k in ("emission_loss", "offset_loss", "kl_loss"):
        np.testing.assert_allclose(out[k].item(), float(aux[k]), **TOL)
    optimizer.zero_grad()
    loss.backward()
    port_grads = params_to_jax(tree_map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad, port))
    for (path, g), w, p in zip(
            jax.tree_util.tree_leaves_with_path(port_grads),
            jax.tree_util.tree_leaves(grads), tree_leaves(port)):
        name = "grad " + jax.tree_util.keystr(path)
        if not p.requires_grad:
            assert p.grad is None, name
            np.testing.assert_array_equal(np.asarray(w), 0.0)
        close_to_scale(g, w, name, STEP_FRACTION)
    port_optim.clip_and_step(optimizer, trainable, clip)
    after = params_to_jax(port)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(after),
                            jax.tree_util.tree_leaves(stepped)):
        close_to_scale(g, w, "param " + jax.tree_util.keystr(path),
                       STEP_FRACTION)
    if cell == "ESN":
        for got, was in zip(_reservoir(after), _reservoir(params),
                            strict=True):
            assert got.tobytes() == was.tobytes()

    # decoding, from the stepped weights
    feats = rng.normal(size=(b, FEAT)).astype(np.float32)
    stepped = jax.tree_util.tree_map(np.asarray, stepped)
    dkey = jax.random.PRNGKey(9)
    # the decode call's own draw: fold_in(key, 0), split, normal (T, B, F)
    noise = t(reference_jit(lambda k: jax.random.normal(
        jax.random.split(jax.random.fold_in(k, 0))[0], (tt, b, F)))(dkey))
    for mode in ("sample", "mean"):
        with jax.default_matmul_precision("highest"):
            want = reference_jit(
                lambda p, f, n, s, m=mode: jax_decode.decode_features(
                    p, jcfg, f, n, tt, dkey, speaker=s, emission_mode=m))(
                        stepped, jnp.asarray(feats), jnp.asarray(lens),
                        jnp.asarray(speakers))
        got = decode_features(port, pcfg, t(feats), torch.from_numpy(lens),
                              tt, noise=noise,
                              speaker=torch.from_numpy(speakers),
                              emission_mode=mode)
        assert got.out.shape == (b, tt, F)
        for name, g, w in (("out", got.out, want.out),
                           ("offset", got.offset_weights,
                            want.offset_weights),
                           ("mean", got.emission_params[0],
                            want.emission_params[0]),
                           ("logvar", got.emission_params[1],
                            want.emission_params[1])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"{mode} {name}", **TOL)


@pytest.mark.parametrize("cell", ["GRU", "ESN"])
def test_cli_trains_resumes_encodes_and_decodes(tmp_path, cell):
    """``--unidirectional_encoder -R GRU`` (or ``-R ESN --esn_leak 0.5``)
    trains, resumes and encodes through the encode CLI on the CPU, and its
    checkpoint decodes in both modes; the same checkpoint as the JAX
    package writes it resumes in the port; the ESN's reservoir is the
    first run's bit for bit."""
    argv = [TOY, CSV, "-S", str(tmp_path), "-j", "uni", "-b", "4",
            "--pretrain_epochs", "1", "-d", "cpu", "-R", cell,
            "--unidirectional_encoder", "--stft_method", "pallas", "-K", "5",
            "-f", "6", "--encoder_rnn_hidden_size", "16",
            "--decoder_rnn_hidden_size", "16", "--mlp_hidden_size", "6",
            "-N", "11.0"]
    if cell == "ESN":
        argv += ["--esn_leak", "0.5"]
    first = learning_main.main(argv + ["-e", "2"])
    cfg = first.model_cfg
    assert (cfg.encoder.rnn_type, cfg.decoder.rnn_type) == (cell, cell)
    assert not cfg.encoder.bidirectional
    assert first.steps == {"train": 4, "eval": 2}
    run = tmp_path / "uni"
    ckpt = str(run / "checkpoint.pt")
    c1 = port_ckpt.load_checkpoint(ckpt)
    assert set(c1["encoder"]["layers"][0]) == {"fwd"}
    again = learning_main.main(argv + ["-e", "3"])
    log = (run / "history.log").read_text()
    assert "LEARNING RETRIEVED." in log and log.rstrip().endswith(
        "END OF TRAINING")
    assert "Encoder is bidirectional." not in log
    assert all(np.isfinite(float(v)) for v in re.findall(
        r"total loss \(per string\): (\S+)", log))
    assert again.steps == {"train": 2, "eval": 1}
    c2 = port_ckpt.load_checkpoint(ckpt)
    if cell == "ESN":
        for a, b in zip(_reservoir(c1), _reservoir(c2), strict=True):
            assert a.tobytes() == b.tobytes()
    assert not np.array_equal(c1["decoder"]["feature2hidden"]["w"],
                              c2["decoder"]["feature2hidden"]["w"])

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

    params, mcfg = load_model(ckpt, device="cpu")
    lens = torch.tensor([5, 0, 3], dtype=torch.int32)
    feats = torch.randn(3, 6, generator=torch.Generator().manual_seed(1))
    speaker = torch.tensor([0, 1, 1], dtype=torch.int32)
    for mode in ("sample", "mean"):
        got = decode_features(params, mcfg, feats, lens, 5,
                              generator=torch.Generator().manual_seed(2),
                              speaker=speaker, emission_mode=mode)
        assert got.out.shape == (3, 5, mcfg.decoder.output_size)
        assert torch.isfinite(got.out).all()
        if mode == "mean":
            torch.testing.assert_close(got.out, got.emission_params[0],
                                       rtol=0, atol=0)

    # the same checkpoint as the JAX package writes it resumes in the port
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    jax_ckpt.save_checkpoint(str(jax_dir), dict(
        c2, optimizer=jax_ckpt.OptimizerLeaves(c2["optimizer"].leaves)))
    (jax_dir / "history.log").write_text("")  # the resume marker
    resumed = Learner(save_dir=str(jax_dir), device="cpu")
    assert resumed.last_epoch == 3
    assert ((resumed.model_cfg.encoder, resumed.model_cfg.decoder)
            == (again.model_cfg.encoder, again.model_cfg.decoder))
    for g, w in zip(jax.tree_util.tree_leaves(params_to_jax(resumed.params)),
                    jax.tree_util.tree_leaves(
                        {k: c2[k] for k in ("encoder", "feature_sampler",
                                            "decoder")})):
        np.testing.assert_array_equal(g, w)
