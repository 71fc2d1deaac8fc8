"""The plain Gaussian VAE of the PyTorch port against the JAX package: the
Gaussian head's sample, KL and log-pdf and the distribution registry; one
training loss with every leaf's gradient against ``vae.training_loss`` on
the Gaussian latent (the JAX side on its scan paths, the same normals and
decoder noise); ``latent_type: gaussian`` checkpoints both ways; the plain
parsers' options against ``build_*_parser("plain")``; the ``params`` CSV
against the JAX writer (its ``Encoder.encode_dataset_params`` and its
CLI's sort and merge, in-process on an Encoder whose ``__init__`` never
ran) and the npz sidecar; a served ``params`` answer; ``decode_features`` from a Gaussian
checkpoint against the JAX ``decode_features``; and the plain training CLI
trained and resumed on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu import distributions as jax_dist
from seq2seq_abcd_vae_tpu.cli import flags as jax_flags
from seq2seq_abcd_vae_tpu.configs import (
    DecoderConfig as JaxDecoderConfig, EncoderConfig as JaxEncoderConfig,
    GaussianSamplerConfig as JaxGaussianConfig)
from seq2seq_abcd_vae_tpu.data.annotations import (
    AnnotationParser as JaxParser)
from seq2seq_abcd_vae_tpu.data.batching import FrontendSpec as JaxFrontend
from seq2seq_abcd_vae_tpu.infer import decode as jax_decode
from seq2seq_abcd_vae_tpu.infer.encode import Encoder as JaxEncoder
from seq2seq_abcd_vae_tpu.models import sampler as jax_sampler
from seq2seq_abcd_vae_tpu.models import vae as jax_vae
from seq2seq_abcd_vae_tpu.train import checkpoint as jax_ckpt
from seq2seq_abcd_vae_tpu_torch import distributions as port_dist
from seq2seq_abcd_vae_tpu_torch.cli import encode_main, flags, learning_main
from seq2seq_abcd_vae_tpu_torch.configs import (DecoderConfig, EncoderConfig,
                                                GaussianSamplerConfig)
from seq2seq_abcd_vae_tpu_torch.infer import encode as port_encode
from seq2seq_abcd_vae_tpu_torch.infer.decode import (decode_features,
                                                     load_model)
from seq2seq_abcd_vae_tpu_torch.models import sampler as port_sampler
from seq2seq_abcd_vae_tpu_torch.models import vae as port_vae
from seq2seq_abcd_vae_tpu_torch.serve import EncodeService
from seq2seq_abcd_vae_tpu_torch.serve.server import _handle_line
from seq2seq_abcd_vae_tpu_torch.train.from_jax import (params_from_jax,
                                                       params_to_jax)
from seq2seq_abcd_vae_tpu_torch.tree import tree_map
from torch_port_fixtures import (BINS, EPS, FRAME, NORMALIZER, STEP,
                                 few_torch_threads_fixture, one_step_scans,
                                 port_init_tree, reference_jit,
                                 write_jax_checkpoint)

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOY = os.path.join(ROOT, "fixtures", "toy_data")
ANN = os.path.join(TOY, "annotation_20170806-080002_89.2-94.22.csv")
# float32 sums in another order: values to 1e-5 relative; gradients to
# 1e-4 of each leaf's largest magnitude
TOL = dict(rtol=1e-5, atol=1e-6)
FRACTION = 1e-4
F, H, MLP, FEAT, SPK, EMB = 9, 8, 12, 5, 2, 3


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close_to_scale(got, want, name, fraction=FRACTION):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= fraction * max(np.abs(want).max(), 1e-12), (name, err)


def _configs(input_size=F, speakers=True):
    enc = (input_size, H)
    lat = (4 * H, MLP, FEAT)
    dec = (input_size, H, MLP, FEAT)
    dkw = dict(num_speakers=SPK, speaker_embed_dim=EMB) if speakers else {}
    jcfg = jax_vae.ModelConfig(JaxEncoderConfig(*enc), JaxGaussianConfig(*lat),
                               JaxDecoderConfig(*dec, **dkw))
    pcfg = port_vae.ModelConfig(EncoderConfig(*enc),
                                GaussianSamplerConfig(*lat),
                                DecoderConfig(*dec, **dkw))
    return jcfg, pcfg


@pytest.fixture(scope="module")
def toy_checkpoint(tmp_path_factory):
    """A Gaussian model at the toy corpus' width (fs 16000), written by the
    JAX package's writer."""
    jcfg, pcfg = _configs(BINS, speakers=False)
    params = port_init_tree(jcfg, 11)
    path = write_jax_checkpoint(tmp_path_factory.mktemp("plain"), jcfg,
                                params)
    return jcfg, pcfg, params, path


def test_gaussian_head_matches_jax(rng, monkeypatch):
    """Sample, KL and log-pdf through both registries, the sample from the
    JAX key's own normals; a registered model is found by name."""
    cfg = JaxGaussianConfig(6, 5, 4)
    gen = torch.Generator().manual_seed(2)
    params = tree_map(lambda a: a.numpy(), port_sampler.sampler_init(
        gen, 6, 5, 4))
    x = rng.normal(size=(3, 6)).astype(np.float32)
    mask = np.asarray([[1.0], [0.0], [1.0]], np.float32)
    key = jax.random.PRNGKey(4)
    name = cfg.distribution_name
    with jax.default_matmul_precision("highest"):
        want = reference_jit(lambda p, xx, m: (
            jax_sampler.sampler_apply(p, xx),
            jax_sampler.sampler_sample(key, jax_sampler.sampler_apply(p, xx),
                                       name),
            jax_sampler.sampler_kl(jax_sampler.sampler_apply(p, xx), name,
                                   mask=m),
            jax_sampler.sampler_log_pdf(xx[:, :4],
                                        jax_sampler.sampler_apply(p, xx),
                                        name, mask=m)))(params, x, mask)
    normals = np.asarray(jax.random.normal(key, (3, 4)))  # the same draw
    tparams = tree_map(t, params)
    got_params = port_sampler.sampler_apply(tparams, t(x))
    for g, w in zip(got_params, want[0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(
        port_sampler.sampler_sample(t(normals), got_params, name).numpy(),
        np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(
        port_sampler.sampler_kl(got_params, name, mask=t(mask)).item(),
        float(want[2]), **TOL)
    np.testing.assert_allclose(
        port_sampler.sampler_log_pdf(t(x[:, :4]), got_params, name,
                                     mask=t(mask)).item(),
        float(want[3]), **TOL)
    gauss = port_dist.choose_distribution(name)
    assert (gauss.num_parameters
            == jax_dist.choose_distribution(name).num_parameters == 2)
    monkeypatch.setattr(port_dist, "_REGISTRY", dict(port_dist._REGISTRY))
    port_dist.register_distribution("wider", gauss._replace(
        num_parameters=3))
    assert len(port_sampler.sampler_init(gen, 6, 5, 4, "wider")[
        "to_parameters"]["lin1"]["w"]) == 3


def _batch(rng, tt=10):
    lens = np.asarray([10, 7, 0, 3, 9], np.int32)
    b = len(lens)
    valid = np.arange(tt)[None, :] < lens[:, None]
    inputs = (rng.normal(size=(b, tt, F)) * valid[..., None]).astype(
        np.float32)
    speakers = np.asarray([1, 0, -1, 1, 0], np.int32)
    is_offset = (np.arange(tt)[None, :] == lens[:, None] - 1).astype(
        np.float32)
    return inputs, lens, speakers, is_offset


def test_training_loss_and_gradients_match_jax(rng, monkeypatch):
    """The plain VAE's loss, its three parts and every leaf's gradient
    against JAX ``vae.training_loss`` on its scan paths, with the normals
    of its latent key and its decoder's noise handed to the port."""
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    one_step_scans(monkeypatch)
    jcfg, pcfg = _configs()
    inputs, lens, speakers, is_offset = _batch(rng)
    b, tt = lens.shape[0], inputs.shape[1]
    params = port_init_tree(jcfg, 7)
    batch = {"inputs": jnp.asarray(inputs), "lengths": jnp.asarray(lens),
             "speakers": jnp.asarray(speakers),
             "is_offset": jnp.asarray(is_offset)}
    key = jax.random.PRNGKey(21)

    def jax_step(p):
        (loss, aux), grads = jax.value_and_grad(
            lambda q: jax_vae.training_loss(q, jcfg, batch, key, 40.0),
            has_aux=True)(p)
        # forward_losses' keys: (encoder, latent, decoder); the latent
        # key's (B, f) normals; the decoder's fold_in(., 0) split
        _, k_lat, k_dec = jax.random.split(key, 3)
        k_noise, _ = jax.random.split(jax.random.fold_in(k_dec, 0))
        noise = (jax.random.normal(k_lat, (b, FEAT)),
                 jax.random.normal(k_noise, (tt, b, F)))
        return loss, aux, grads, noise

    with jax.default_matmul_precision("highest"):
        want_loss, aux, grads, noise = reference_jit(jax_step)(params)
    normals, dec_noise = (np.asarray(a) for a in noise)
    port_params = tree_map(lambda a: a.requires_grad_(True),
                           params_from_jax(params, pcfg.encoder,
                                           decoder_cfg=pcfg.decoder))
    loss, out = port_vae.training_loss(
        port_params, pcfg,
        {"inputs": t(inputs), "lengths": torch.from_numpy(lens),
         "speakers": torch.from_numpy(speakers)},
        {"normal": t(normals), "decoder": t(dec_noise)}, 40.0)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    for k in ("emission_loss", "offset_loss", "kl_loss", "num_rows"):
        np.testing.assert_allclose(out[k].item(), float(aux[k]), **TOL)
    for g, w in zip(out["feature_parameters"], aux["feature_parameters"]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    assert not out["feature_parameters"][0][2].any()  # the padding row
    loss.backward()
    got = params_to_jax(tree_map(lambda p: p.grad, port_params))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(grads)):
        close_to_scale(g, w, "grad " + jax.tree_util.keystr(path))
    fresh = port_vae.model_init(torch.Generator().manual_seed(0), pcfg)
    want_shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda k: jax_vae.model_init(k, jcfg), jax.random.PRNGKey(0)))
    assert tree_map(lambda a: a.shape, params_to_jax(fresh)) == want_shapes


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """A Gaussian checkpoint the JAX package writes loads in the port, tree
    for tree (the other way: ``test_plain_cli_trains_and_resumes``)."""
    jcfg, pcfg = _configs()
    params = port_init_tree(jcfg, 3)
    path = write_jax_checkpoint(tmp_path, jcfg, params)
    loaded, cfg = load_model(path, device="cpu")
    assert cfg == pcfg and cfg.latent_type == "gaussian"
    back = params_to_jax(loaded)
    for (p, g), w in zip(jax.tree_util.tree_leaves_with_path(back),
                         jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(p))
    enc = port_encode.Encoder(path, device="cpu")
    assert enc.latent_type == "gaussian"
    with pytest.raises(ValueError, match="needs a 'abcd' model"):
        enc.check_mode("probs")


def _options(parser):
    """{dest: (option strings, default)} of a parser, but for -h and the
    device's default (the port runs on the card unless asked)."""
    return {a.dest: (tuple(a.option_strings),
                     None if a.dest == "device" else a.default)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("variant", ["abcd", "plain"])
def test_parsers_match_jax(variant):
    for port_build, jax_build in (
            (flags.build_learning_parser, jax_flags.build_learning_parser),
            (flags.build_encode_parser, jax_flags.build_encode_parser)):
        assert (_options(port_build(variant))
                == _options(jax_build(variant))), port_build.__name__
    plain = _options(flags.build_learning_parser("plain"))
    assert plain["feature_size"] == (("-f", "--feature_size"), 16)
    assert not {"num_feature_categories", "feature_dim",
                "prior_concentration", "pretrain_epochs"} & set(plain)
    assert (_options(flags.build_encode_parser("plain"))["parameter_names"]
            == (("-p", "--parameter_names"), None))
    with pytest.raises(ValueError, match="variant"):
        flags.build_learning_parser("vq")


def _split(text: str):
    """(header, [(data_ix, name, dim, rest)], values) of the params CSV."""
    lines = text.splitlines()
    rows = [line.split(",", 4) for line in lines[1:]]
    return (lines[0], [(r[0], r[1], r[2], r[4] if len(r) > 4 else None)
                       for r in rows], np.asarray([float(r[3]) for r in rows]))


def _jax_params_csv(jcfg, params, names, batch_size) -> str:
    """The JAX package's params CSV: its ``Encoder.encode_dataset_params``
    (on an instance whose ``__init__``, which sets process-wide JAX state,
    never ran; the corpus cache off), then its CLI's sort, merge and
    ``to_csv`` (``cli/encode_main.py``)."""
    import io
    parser = JaxParser(TOY, ANN)
    encoder = JaxEncoder.__new__(JaxEncoder)
    encoder.params = {k: params[k] for k in ("encoder", "feature_sampler")}
    encoder.model_cfg, encoder.stft_method = jcfg, "fft"
    encoder.device = jax.devices("cpu")[0]
    encoder.device_corpus_cache, encoder.mesh = "off", None
    with jax.default_matmul_precision("highest"):
        df = encoder.encode_dataset_params(
            parser.get_data(), JaxFrontend(FRAME, STEP), EPS, NORMALIZER,
            parameter_ix2name=dict(enumerate(names)),
            batch_size=batch_size)
    df = df.sort_values(["data_ix", "parameter_name", "feature_dim"])
    df = df.merge(parser.df_annotation, how="left", left_on="data_ix",
                  right_index=True)
    buf = io.StringIO()
    df.to_csv(buf, index=False)
    return buf.getvalue()


def test_params_csv_matches_jax_writer(tmp_path, monkeypatch,
                                       toy_checkpoint):
    """The plain encode CLI on the toy corpus from a JAX-written
    checkpoint, with parameter names, against the JAX writer: every byte
    but the values equal, the values within float32 tolerance; the npz
    holds the CSV's values bit for bit."""
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    one_step_scans(monkeypatch)
    jcfg, _, params, path = toy_checkpoint
    names = ("mu", "log_sigma2")
    argv = [path, TOY, ANN, str(NORMALIZER), "-b", "3", "-d", "cpu", "-p",
            ",".join(names)]
    got_path = tmp_path / "port.csv"
    encode_main.main("params", argv + ["-S", str(got_path)])
    g_head, g_keys, g_vals = _split(got_path.read_text())
    w_head, w_keys, w_vals = _split(_jax_params_csv(jcfg, params, names, 3))
    assert g_head == w_head
    assert g_keys == w_keys
    assert len(g_keys) == 8 * 2 * FEAT
    assert g_keys[0][1] == "log_sigma2"  # sorted by name, as pandas sorts
    np.testing.assert_allclose(g_vals, w_vals, rtol=0, atol=1e-5)
    npz = tmp_path / "port.npz"
    encode_main.main("params", argv + ["-S", str(npz), "--save_format",
                                       "npz"])
    with np.load(npz) as z:
        assert sorted(z.files) == ["data_ix", "log_variance", "mean", "mode"]
        assert str(z["mode"]) == "params"
        ixs, arrays = z["data_ix"], {k: z[k] for k in ("mean",
                                                       "log_variance")}
    parsed = {(int(ix), name, int(dim)): np.float32(v)
              for (ix, name, dim, _), v in zip(
                  g_keys, got_path.read_text().splitlines()[1:])
              for v in [v.split(",")[3]]}
    for key, name in zip(("mean", "log_variance"), names):
        back = np.asarray([[parsed[(int(ix), name, j)] for j in range(FEAT)]
                           for ix in ixs], np.float32)
        assert back.tobytes() == arrays[key].tobytes()


def test_params_mode_serves_and_refuses_a_mismatched_head(toy_checkpoint):
    """``serve`` in params mode answers {"id", "params": [mean, logvar]}
    equal to the encode step's; an ABCD mode on a Gaussian checkpoint is
    refused when the service starts."""
    _, pcfg, _, path = toy_checkpoint
    service = EncodeService(path, NORMALIZER, 16000, device="cpu",
                            mode="params", buckets=(16, 64), batch_size=2,
                            autostart=False)
    rng = np.random.default_rng(3)
    samples = (rng.normal(size=1500) * 1000).astype(np.float32)
    fut = service.submit(samples)
    service.drain_once()
    mean, logvar = fut.result(timeout=10)
    assert mean.shape == logvar.shape == (FEAT,)
    line = json.dumps({"id": 7, "samples": samples.tolist(),
                       "fs": 16000}).encode()
    service.start()
    try:
        answer = json.loads(_handle_line(service, line, lambda: None))
    finally:
        service.close()
    assert answer["id"] == 7 and set(answer) == {"id", "params"}
    np.testing.assert_allclose(answer["params"][0], mean, rtol=0, atol=0)
    np.testing.assert_allclose(answer["params"][1], logvar, rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs a 'abcd' model"):
        EncodeService(path, NORMALIZER, 16000, device="cpu", mode="probs",
                      autostart=False)


def test_decode_features_from_a_gaussian_checkpoint_matches_jax(
        rng, monkeypatch, tmp_path):
    """``load_model`` on a JAX-written Gaussian checkpoint, then
    ``decode_features`` in ``mean`` mode against JAX
    ``infer/decode.decode_features`` on its scan body (the sampled loop of
    either package's decoder is held to the other in
    tests/test_torch_port_decode.py; the latent's head does not reach
    it)."""
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    one_step_scans(monkeypatch)
    jcfg, pcfg = _configs()
    params = port_init_tree(jcfg, 5)
    port, cfg = load_model(write_jax_checkpoint(tmp_path, jcfg, params),
                           device="cpu")
    tt = 8
    lens = np.asarray([8, 5, 0, 1], np.int32)
    b = len(lens)
    feats = rng.normal(size=(b, FEAT)).astype(np.float32)
    speaker = np.asarray([1, 0, 1, 0], np.int32)
    with jax.default_matmul_precision("highest"):
        want = jax_decode.decode_features(
            params, jcfg, jnp.asarray(feats), jnp.asarray(lens), tt,
            jax.random.PRNGKey(9), speaker=jnp.asarray(speaker),
            emission_mode="mean")
    got = decode_features(port, cfg, t(feats), torch.from_numpy(lens), tt,
                          speaker=torch.from_numpy(speaker),
                          emission_mode="mean")
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out), **tol)
    for g, w in zip(got.emission_params, want.emission_params):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_plain_cli_trains_and_resumes(tmp_path):
    """The plain training CLI on the toy corpus: the plain variant's log
    lines, no pretraining, no speaker_coding.json, and a resume; its
    Gaussian checkpoint read by the JAX package's reader and laid strictly
    over the JAX initialiser's tree."""
    argv = [TOY, ANN, "-S", str(tmp_path), "-j", "p", "-b", "4", "-f", "3",
            "--encoder_rnn_hidden_size", "5", "--decoder_rnn_hidden_size",
            "5", "--mlp_hidden_size", "6", "-N", "11.0", "-d", "cpu"]
    learning_main.main(argv + ["-e", "1"], variant="plain")
    learner = learning_main.main(argv + ["-e", "2"], variant="plain")
    run = tmp_path / "p"
    log = (run / "history.log").read_text()
    for needle in ("Data to be encoded into 3-dim features.",
                   "Encoder is bidirectional: True",
                   "Decoder is bidirectional: False",
                   "LEARNING RETRIEVED.",
                   "To be restarted from the beginning of epoch #: 2",
                   "END OF TRAINING"):
        assert needle in log, needle
    for absent in ("PRETRAINING", "pretraining", "Perplexity"):
        assert absent not in log, absent
    assert not (run / "speaker_coding.json").exists()
    c = jax_ckpt.load_checkpoint(str(run / "checkpoint.pt"))
    assert c["latent_type"] == "gaussian" and c["epoch"] == 2
    assert c["feature_sampler_init_parameters"] == {
        "input_size": 20, "mlp_hidden_size": 6, "output_size": 3,
        "distribution_name": "isotropic_gaussian"}
    assert learner.latent_type == "gaussian" and learner.iter_counts == 0
    jcfg = jax_vae.ModelConfig(
        JaxEncoderConfig.from_init_parameters(c["encoder_init_parameters"]),
        JaxGaussianConfig.from_init_parameters(
            c["feature_sampler_init_parameters"]),
        JaxDecoderConfig.from_init_parameters(c["decoder_init_parameters"]))
    template = jax.eval_shape(lambda k: jax_vae.model_init(k, jcfg),
                              jax.random.PRNGKey(0))
    port = params_to_jax(learner.params)
    for name in ("encoder", "feature_sampler", "decoder"):
        merged = jax_ckpt.overlay_params(template[name], c[name], name,
                                         strict=True)
        for g, w in zip(jax.tree_util.tree_leaves(merged),
                        jax.tree_util.tree_leaves(port[name])):
            np.testing.assert_array_equal(np.asarray(g), w)
    with pytest.raises(SystemExit):
        learning_main.main(argv + ["-e", "1", "-K", "4"], variant="plain")
