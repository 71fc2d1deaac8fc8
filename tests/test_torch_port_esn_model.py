"""The Elman RNN and echo-state (ESN) models of the PyTorch port against the
JAX package: the bidirectional ``encoder_apply`` of each, parameter trees
in both directions and fresh trees of the JAX shapes, the ESN's weight
statistics, one training loss with two clipped SGD steps against
``vae.training_loss`` and ``optim.make_optimizer`` (the JAX side on its
scan paths) with the reservoir frozen, and the CLI training, resuming and
encoding an ESN model on the CPU, with checkpoints that either package
resumes."""

import csv
import os
import re

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.configs import (
    ABCDSamplerConfig as JaxABCDConfig, DecoderConfig as JaxDecoderConfig,
    EncoderConfig as JaxEncoderConfig)
from seq2seq_abcd_vae_tpu.models import encoder as jax_encoder
from seq2seq_abcd_vae_tpu.models import vae as jax_vae
from seq2seq_abcd_vae_tpu.train import checkpoint as jax_ckpt
from seq2seq_abcd_vae_tpu.train import optim as jax_optim
from seq2seq_abcd_vae_tpu_torch.cli import encode_main, learning_main
from seq2seq_abcd_vae_tpu_torch.configs import (ABCDSamplerConfig,
                                                DecoderConfig, EncoderConfig)
from seq2seq_abcd_vae_tpu_torch.infer.decode import (decode_features,
                                                     load_model)
from seq2seq_abcd_vae_tpu_torch.models import encoder as port_encoder
from seq2seq_abcd_vae_tpu_torch.models import vae as port_vae
from seq2seq_abcd_vae_tpu_torch.train import checkpoint as port_ckpt
from seq2seq_abcd_vae_tpu_torch.train import optim as port_optim
from seq2seq_abcd_vae_tpu_torch.train.from_jax import (params_from_jax,
                                                       params_to_jax)
from seq2seq_abcd_vae_tpu_torch.train.learner import Learner
from seq2seq_abcd_vae_tpu_torch.tree import tree_leaves, tree_map
from torch_port_fixtures import (few_torch_threads_fixture, one_step_scans,
                                 reference_jit)

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOY = os.path.join(ROOT, "fixtures", "toy_data")
CSV = os.path.join(TOY, "annotation_20170806-080002_89.2-94.22.csv")
# float32 sums in another order: values to 1e-5 relative; gradients and
# updated parameters to 1e-5 of each leaf's largest magnitude
TOL = dict(rtol=1e-5, atol=1e-6)
FRACTION = 1e-5
F, H, MLP, K, FEAT, SPK, EMB = 9, 16, 12, 6, 10, 2, 3
LEAK = {"RNN": 1.0, "ESN": 0.5}


@pytest.fixture
def scan_paths(monkeypatch):
    """The JAX package's scan paths."""
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    one_step_scans(monkeypatch)


def close_to_scale(got, want, name, fraction=FRACTION):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= fraction * max(np.abs(want).max(), 1e-12), (name, err)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _configs(cell):
    enc_kw = dict(rnn_type=cell, esn_leak=LEAK[cell])
    dkw = dict(num_speakers=SPK, speaker_embed_dim=EMB, **enc_kw)
    jenc = JaxEncoderConfig(F, H, **enc_kw)
    penc = EncoderConfig(F, H, **enc_kw)
    lat = (jenc.hidden_size_total, MLP, K, FEAT)
    dec = (F, H, MLP, FEAT)
    jcfg = jax_vae.ModelConfig(jenc, JaxABCDConfig(*lat),
                               JaxDecoderConfig(*dec, **dkw))
    pcfg = port_vae.ModelConfig(penc, ABCDSamplerConfig(*lat),
                                DecoderConfig(*dec, **dkw))
    return jcfg, pcfg


@pytest.mark.parametrize("cell", ["RNN", "ESN"])
def test_encoder_and_trees_match_jax(rng, scan_paths, cell):
    """Two bidirectional layers (the first one's outs feed the second):
    encoder_apply against the JAX scan path; the layers cross to the port
    and back unchanged; a fresh tree has the JAX initialiser's shapes (no
    biases in the ESN's)."""
    kw = dict(rnn_type=cell, rnn_layers=2, esn_leak=LEAK[cell])
    jcfg, pcfg = JaxEncoderConfig(7, 5, **kw), EncoderConfig(7, 5, **kw)
    want_tree = jax_encoder.encoder_init(jax.random.PRNGKey(2), jcfg)
    params = params_to_jax({"encoder": port_encoder.encoder_init(
        torch.Generator().manual_seed(2), pcfg), "feature_sampler": {}}
    )["encoder"]
    assert (jax.tree_util.tree_map(np.shape, params)
            == jax.tree_util.tree_map(np.shape, want_tree))
    assert set(params["layers"][0]["fwd"]) == (
        {"w_ih", "w_hh"} if cell == "ESN"
        else {"w_ih", "w_hh", "b_ih", "b_hh"})
    lens = np.asarray([11, 0, 6, 1], np.int32)
    x = rng.normal(size=(4, 11, 7)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = reference_jit(
            lambda p, xx, n: jax_encoder.encoder_apply(p, jcfg, xx, n))(
                params, jnp.asarray(x), jnp.asarray(lens))
    port = params_from_jax({"encoder": params, "feature_sampler": {}}, pcfg)
    assert tuple(port["encoder"][1]["w_ih"].shape) == (2, 10, 5)
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


def test_esn_init_statistics():
    """The reference's reservoir recipe: input entries +-3/q with
    q = binom.ppf(0.95, fan_in, 0.5), a hidden matrix with about a tenth of
    its entries kept and spectral radius 0.99, in the encoder's layers and
    the decoder's cell."""
    _, pcfg = _configs("ESN")
    enc = EncoderConfig(F, 32, rnn_type="ESN", rnn_layers=2)
    params = port_vae.model_init(
        torch.Generator().manual_seed(5),
        port_vae.ModelConfig(enc, ABCDSamplerConfig(
            enc.hidden_size_total, MLP, K, FEAT), pcfg.decoder))
    cells = [(F, {k: v[d] for k, v in params["encoder"][0].items()})
             for d in range(2)]
    cells += [(64, {k: v[d] for k, v in params["encoder"][1].items()})
              for d in range(2)]
    cells.append((F, params["decoder"]["rnn_cell"]))
    for fan_in, cell in cells:
        assert set(cell) == {"w_ih", "w_hh"}
        q = stats.binom.ppf(0.95, fan_in, 0.5)
        w_ih = cell["w_ih"].numpy()
        np.testing.assert_allclose(np.sort(np.unique(w_ih)),
                                   [-3.0 / q, 3.0 / q], rtol=1e-6)
        w_hh = cell["w_hh"].numpy().astype(np.float64)
        radius = np.abs(np.linalg.eigvals(w_hh)).max()
        assert abs(radius - 0.99) <= 1e-4, radius
        kept = (w_hh != 0).mean()
        assert 0.03 <= kept <= 0.2, kept


@pytest.mark.parametrize("cell", ["RNN", "ESN"])
def test_training_steps_match_jax(rng, scan_paths, cell):
    """One training loss, its gradients and two clipped SGD steps with
    momentum match the JAX package's on the same weights, inputs and
    noise; the ESN's reservoir takes no gradient (zero in the JAX
    package), no update and no share of the clip, and stays unchanged."""
    jcfg, pcfg = _configs(cell)
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
    params = initial = params_to_jax(port_vae.model_init(
        torch.Generator().manual_seed(7), pcfg))
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

    # a fresh tree has the JAX tree's shapes (the ESN's reservoirs have no
    # biases; the JAX ESN initialiser needs concrete arrays, so its shapes
    # are the reference's, written out) and crosses both ways unchanged
    shapes = jax.tree_util.tree_map(np.shape, params)
    if cell == "RNN":
        assert shapes == jax.tree_util.tree_map(
            lambda a: a.shape,
            jax.eval_shape(lambda k: jax_vae.model_init(k, jcfg),
                           jax.random.PRNGKey(0)))
    else:
        assert shapes["decoder"]["rnn_cell"] == {"w_ih": (F, H),
                                                 "w_hh": (H, H)}
    port_params = port_vae.set_trainable(
        params_from_jax(params, pcfg.encoder, decoder_cfg=pcfg.decoder),
        pcfg)
    for g, w in zip(jax.tree_util.tree_leaves(params_to_jax(port_params)),
                    jax.tree_util.tree_leaves(params), strict=True):
        np.testing.assert_array_equal(g, w)
    trainable = [p for p in tree_leaves(port_params) if p.requires_grad]
    n_frozen = len(tree_leaves(port_params)) - len(trainable)
    assert n_frozen == (4 if cell == "ESN" else 0)
    optimizer = port_optim.make_optimizer(trainable, lr, momentum)
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
        port_grads = params_to_jax(tree_map(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
            port_params))
        for (path, g), w, p in zip(
                jax.tree_util.tree_leaves_with_path(port_grads),
                jax.tree_util.tree_leaves(grads),
                tree_leaves(port_params)):
            name = f"step {step} grad " + jax.tree_util.keystr(path)
            if not p.requires_grad:
                assert p.grad is None, name
                np.testing.assert_array_equal(np.asarray(w), 0.0)
            close_to_scale(g, w, name)
        port_optim.clip_and_step(optimizer, trainable, clip)
        for (path, g), w in zip(
                jax.tree_util.tree_leaves_with_path(
                    params_to_jax(port_params)),
                jax.tree_util.tree_leaves(params)):
            close_to_scale(g, w, f"step {step} param "
                           + jax.tree_util.keystr(path))
    # the reservoir is bit for bit what it was, in both packages
    if cell == "ESN":
        for got, want, was in zip(
                _reservoir(params_to_jax(port_params)), _reservoir(params),
                _reservoir(initial), strict=True):
            assert got.tobytes() == was.tobytes() == want.tobytes()


def _reservoir(tree: dict) -> list:
    """The ESN tensors of a JAX-layout tree."""
    layers = tree["encoder"]["layers"]
    return ([layer[d][k] for layer in layers for d in ("fwd", "bwd")
             for k in ("w_hh", "w_ih")]
            + [tree["decoder"]["rnn_cell"][k] for k in ("w_hh", "w_ih")])


def test_cli_trains_resumes_and_encodes_esn(tmp_path):
    """``-R ESN --esn_leak 0.5`` trains (the decoder follows the
    encoder's cell), resumes and encodes through the encode CLI on the
    CPU: the reservoir in the resumed run's checkpoint equals the first
    run's bit for bit, the checkpoint's momentum traces have the JAX
    optimiser's layout with zeros for the reservoir, a checkpoint the JAX
    package writes resumes in the port, and the model decodes in both
    modes."""
    argv = [TOY, CSV, "-S", str(tmp_path), "-j", "esn", "-b", "4",
            "--pretrain_epochs", "1", "-d", "cpu", "-R", "ESN",
            "--esn_leak", "0.5", "-M", "0.9", "--stft_method", "pallas",
            "-K", "5", "-f", "6", "--encoder_rnn_hidden_size", "6",
            "--decoder_rnn_hidden_size", "6", "--mlp_hidden_size", "6",
            "-N", "11.0"]
    first = learning_main.main(argv + ["-e", "2"])
    cfg = first.model_cfg
    assert (cfg.encoder.rnn_type, cfg.decoder.rnn_type) == ("ESN", "ESN")
    assert cfg.encoder.esn_leak == cfg.decoder.esn_leak == 0.5
    assert first.steps == {"train": 4, "eval": 2}
    run = tmp_path / "esn"
    ckpt = str(run / "checkpoint.pt")
    c1 = port_ckpt.load_checkpoint(ckpt)
    assert c1["encoder_init_parameters"]["esn_leak"] == 0.5
    assert c1["decoder_init_parameters"]["esn_leak"] == 0.5
    # the optimiser leaves line up with the JAX optimiser's state
    tree = {k: c1[k] for k in ("encoder", "feature_sampler", "decoder")}
    template = jax.tree_util.tree_leaves(
        jax_optim.make_optimizer(1.0, 0.9, 1.0).init(tree))
    opt = c1["optimizer"].leaves
    assert [np.shape(a) for a in opt] == [np.shape(a) for a in template]
    traces = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree), opt[2:])
    assert all(not np.any(a) for a in _reservoir(traces))
    assert any(np.any(a) for a in jax.tree_util.tree_leaves(
        traces["feature_sampler"]))

    again = learning_main.main(argv + ["-e", "3"])
    log = (run / "history.log").read_text()
    assert "LEARNING RETRIEVED." in log and log.rstrip().endswith(
        "END OF TRAINING")
    assert "Type of RNN used for the decoder: ESN" in log
    assert "ESN leak: 0.5" in log
    assert all(np.isfinite(float(v)) for v in re.findall(
        r"total loss \(per string\): (\S+)", log))
    assert again.steps == {"train": 2, "eval": 1}
    c2 = port_ckpt.load_checkpoint(ckpt)
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
    # the ESN decoder decodes (rnn_decoder_loop at its leak), in both modes
    params, mcfg = load_model(ckpt, device="cpu")
    assert mcfg.decoder.rnn_type == "ESN"
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

    # the same checkpoint as the JAX package writes it resumes in the port
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    payload = dict(c2, optimizer=jax_ckpt.OptimizerLeaves(
        c2["optimizer"].leaves))
    jax_ckpt.save_checkpoint(str(jax_dir), payload)
    (jax_dir / "history.log").write_text("")  # the resume marker
    resumed = Learner(save_dir=str(jax_dir), device="cpu")
    assert resumed.last_epoch == 3
    assert ((resumed.model_cfg.encoder, resumed.model_cfg.decoder)
            == (again.model_cfg.encoder, again.model_cfg.decoder))
    for g, w in zip(_reservoir(params_to_jax(resumed.params)),
                    _reservoir(c2)):
        np.testing.assert_array_equal(g, w)
    assert not any(p.requires_grad
                   for p in resumed.params["decoder"]["rnn_cell"].values())
