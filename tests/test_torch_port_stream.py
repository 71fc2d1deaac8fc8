"""The decoder's stream training path of the port against the JAX package:
``models/decoder.decoder_losses`` with a cell left out of ``fused_cells``
(the JAX package's ``SEQ2SEQ_NLL_FUSION=0`` / ``SEQ2SEQ_FUSED_CELLS``) runs
the sampled loop (``ops/decoder_kernel.decoder_loop``,
``gru_decoder_loop``, ``rnn_decoder_loop``) with its hand-written backward
and the losses over its streams; without offset targets the fused LSTM
runs ``decoder_loop_fused_nll``.

Held here: both losses and every gradient against ``decoder_apply(...,
loss_only=True)`` on the JAX scan paths (the interpret-mode kernels' own
gradients do not trace under this jax: their custom VJPs return a flat bias
cotangent for a (1, .) bias); each hand-written backward twin against
autograd through its own forward twin; the fused-NLL twin against the
interpret-mode Pallas forward; the stream path against the fused path in
the port; the switch as the JAX package reads it; one whole training step
with the switch off against the JAX ``training_loss``.  The twins are what
the kernel wrappers run on CPU tensors, and what the card's kernels are
held to."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.configs import DecoderConfig as JaxDecoderConfig
from seq2seq_abcd_vae_tpu.models import decoder as jax_decoder
from seq2seq_abcd_vae_tpu.models import vae as jax_vae
from seq2seq_abcd_vae_tpu.ops import decoder_pallas
from seq2seq_abcd_vae_tpu_torch.cli import flags, learning_main
from seq2seq_abcd_vae_tpu_torch.configs import (ABCDSamplerConfig,
                                                DecoderConfig, EncoderConfig)
from seq2seq_abcd_vae_tpu_torch.models import decoder as port_decoder
from seq2seq_abcd_vae_tpu_torch.models import vae as port_vae
from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
from seq2seq_abcd_vae_tpu_torch.train import learner as port_learner
from seq2seq_abcd_vae_tpu_torch.train.from_jax import (_to_np,
                                                       params_from_jax,
                                                       params_to_jax)
from seq2seq_abcd_vae_tpu_torch.tree import tree_leaves, tree_map
from torch_port_fixtures import (BINS, EPS, FRAME, NORMALIZER, STEP,
                                 few_torch_threads_fixture, one_step_scans,
                                 padded_batch, reference_jit, small_model)

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

# float32 sums in another order through at most 9 recurrent steps: the
# losses to 1e-5 relative; each gradient leaf to 1e-4 of its largest
# magnitude (a leaf sums every step's and row's contribution); the loop's
# values to 1e-5 absolute (|h| <= 1, emissions O(1)).
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_FRACTION = 1e-4
OUT_ATOL = 1e-5
SPEAKERS = 3
CELL_LEAK = {"LSTM": 1.0, "GRU": 1.0, "RNN": 1.0, "ESN": 0.5}


def assert_grad_close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= GRAD_FRACTION * scale, (name, err, scale)


@pytest.fixture
def stream_scan(monkeypatch):
    """The JAX package's stream path (no loss fusion) on its scan body."""
    monkeypatch.setenv("SEQ2SEQ_NLL_FUSION", "0")
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    one_step_scans(monkeypatch)


def _decoder_case(rng, cell, t=9, f=6, h=8, m=7, feat=5, embed=4,
                  lens=(9, 0, 4, 1, 7)):
    """Configs of both packages, port-drawn weights as numpy, features,
    lengths, speakers, padded targets and the (t == len - 1) offsets."""
    kw = dict(num_speakers=SPEAKERS, speaker_embed_dim=embed, rnn_type=cell,
              esn_leak=CELL_LEAK[cell])
    jcfg, pcfg = (JaxDecoderConfig(f, h, m, feat, **kw),
                  DecoderConfig(f, h, m, feat, **kw))
    params = tree_map(_to_np, port_decoder.decoder_init(
        torch.Generator().manual_seed(3), pcfg))
    lens = np.asarray(lens, np.int32)
    b = len(lens)
    features = rng.normal(size=(b, feat)).astype(np.float32)
    speakers = np.asarray([0, -1, 2, 1, 0][:b], np.int32)
    valid = np.arange(t)[None, :] < lens[:, None]
    gt = (rng.normal(size=(b, t, f)) * valid[..., None]).astype(np.float32)
    is_offset = (np.arange(t)[None, :] == lens[:, None] - 1).astype(
        np.float32)
    return jcfg, pcfg, params, features, lens, speakers, gt, is_offset


def _jax_reference(jax_loss, key, params, features, noise_shape):
    """One compilation of ``jax_loss``'s value, aux and gradients in
    (params, features), and of decoder_apply's noise for ``key``
    (fold_in(key, 0), split, normal (T, B, F))."""
    def reference(p, feats):
        (_, aux), grads = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                             has_aux=True)(p, feats)
        k_noise, _ = jax.random.split(jax.random.fold_in(key, 0))
        return aux, grads, jax.random.normal(k_noise, noise_shape)

    with jax.default_matmul_precision("highest"):
        aux, grads, noise = reference_jit(reference)(
            params, jnp.asarray(features))
    return aux, grads, np.asarray(noise)


def _port_losses(pcfg, params, features, lens, gt, noise, speakers,
                 **kwargs):
    """decoder_losses on leaves that require gradients: (losses, leaves,
    features)."""
    leaves = tree_map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(True), params)
    feats = torch.from_numpy(features).requires_grad_(True)
    out = port_decoder.decoder_losses(
        leaves, pcfg, feats, torch.from_numpy(lens), torch.from_numpy(gt),
        torch.from_numpy(noise.copy()), speaker=torch.from_numpy(speakers),
        **kwargs)
    return out, leaves, feats


def _assert_tree_grads(cell, leaves, g_p):
    got_flat = jax.tree_util.tree_leaves_with_path(leaves)
    want_flat = jax.tree_util.tree_leaves(g_p)
    assert len(got_flat) == len(want_flat)
    for (path, leaf), want in zip(got_flat, want_flat):
        name = jax.tree_util.keystr(path)
        if cell == "ESN" and "rnn_cell" in name:
            # the frozen reservoir: no gradient (zeros in the JAX package)
            assert leaf.grad is None, name
            np.testing.assert_array_equal(np.asarray(want), 0.0)
        else:
            assert_grad_close(leaf.grad.numpy(), want, name)


# ---- (a) the stream path against decoder_apply(loss_only=True), no fusion

@pytest.mark.parametrize("cell", ["LSTM", "GRU", "RNN", "ESN"])
def test_stream_losses_and_gradients_match_jax(rng, stream_scan, cell):
    jcfg, pcfg, params, features, lens, speakers, gt, is_offset = (
        _decoder_case(rng, cell))
    b, t, f = gt.shape
    key = jax.random.PRNGKey(11)

    def jax_loss(p, feats):
        out = jax_decoder.decoder_apply(
            p, jcfg, feats, jnp.asarray(lens), t,
            speaker=jnp.asarray(speakers), ground_truth_out=jnp.asarray(gt),
            ground_truth_offset=jnp.asarray(is_offset), key=key,
            loss_only=True)
        return (0.7 * out.emission_loss + 1.3 * out.offset_loss,
                (out.emission_loss, out.offset_loss))

    (want_em, want_off), (g_p, g_feat), noise = _jax_reference(
        jax_loss, key, params, features, (t, b, f))
    (em, off), leaves, feats = _port_losses(
        pcfg, params, features, lens, gt, noise, speakers, fused_cells=())
    np.testing.assert_allclose(em.item(), float(want_em), **VALUE_TOL)
    np.testing.assert_allclose(off.item(), float(want_off), **VALUE_TOL)
    (0.7 * em + 1.3 * off).backward()
    assert_grad_close(feats.grad.numpy(), g_feat, "features")
    _assert_tree_grads(cell, leaves, g_p)


# ---- (b) each hand-written backward twin against autograd of its forward

def _loop_args(rng, cell, t=8, b=5, f=5, h=7, m=4, lens=(8, 0, 3, 1, 6)):
    """The sampled loop's (or, for "NLL", decoder_loop_fused_nll's)
    arguments as tensors; weights at O(1 / sqrt(fan in))."""
    gh = {"LSTM": 4, "NLL": 4, "GRU": 3}.get(cell, 1) * h

    def uni(bound, *shape):
        return torch.from_numpy(rng.uniform(-bound, bound, size=shape)
                                .astype(np.float32))
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32))
    args = [normal(t, b, f), torch.tensor(lens, dtype=torch.int32),
            uni(0.4, h, gh + 2 * m)]
    if cell == "GRU":
        args += [uni(0.4, gh), uni(0.4, gh)]
    else:
        args.append(torch.zeros(gh) if cell == "ESN" else uni(0.5, gh))
    args += [uni(0.4, 2 * m), uni(0.4, m, f), uni(0.4, m, f),
             uni(0.4, 2 * f), uni(0.4, f, gh)]
    if cell == "NLL":
        args.append(normal(t, b, f))                     # targets
    args += [normal(b, h) * 0.5
             for _ in range(2 if cell in ("LSTM", "NLL") else 1)]
    return args


@pytest.mark.parametrize("cell", ["LSTM", "GRU", "RNN", "ESN", "NLL"])
def test_backward_twins_match_autograd_of_forward_twins(rng, cell):
    """The explicit reverse-time adjoints (``*_bwd_plain``, the backward
    kernels' twins) against torch.autograd through the step-by-step
    forward twins, at the kernels' own interfaces: every output's
    cotangent non-zero; the LSTM loop's emission slot T-1 (the caller's
    overwrite) is never read, so its cotangent there is dropped from the
    autograd side."""
    args = _loop_args(rng, cell)
    leak = CELL_LEAK.get(cell, 1.0)
    kw = {"leak": leak} if cell in ("RNN", "ESN") else {}
    t, b, f = args[0].shape
    h = args[2].shape[0]
    wrt = [i for i in range(2, len(args)) if not (cell == "NLL" and i == 9)]
    leaves = [a.clone().requires_grad_(True) if i in wrt else a
              for i, a in enumerate(args)]
    cot = torch.from_numpy(rng.normal(size=(t, b, h)).astype(np.float32))
    if cell == "NLL":
        outs, nll, hs, cs = dk.decoder_fused_nll_fwd_plain(*leaves)
        loss = (outs * cot).sum() + 0.7 * nll
        carries, extra = (hs, cs), (cot, torch.tensor([0.7]))
        bwd_plain = dk.decoder_fused_nll_bwd_plain
    elif cell == "LSTM":
        outs, mean_s, logvar_s, hs, cs = dk.decoder_loop_plain(
            *leaves, return_carries=True)
        em_cots = [torch.from_numpy(rng.normal(size=(t, b, f)).astype(
            np.float32)) for _ in range(2)]
        loss = (outs * cot).sum() + sum(
            (s[:-1] * c[:-1]).sum() for s, c in zip((mean_s, logvar_s),
                                                    em_cots))
        carries, extra = (hs, cs), (cot, *em_cots)
        bwd_plain = dk.decoder_loop_bwd_plain
    else:
        prefix = "gru_" if cell == "GRU" else "rnn_"
        outs, hs = getattr(dk, prefix + "decoder_loop_plain")(
            *leaves, return_carries=True, **kw)
        loss = (outs * cot).sum()
        carries, extra = (hs,), (cot,)
        bwd_plain = getattr(dk, prefix + "decoder_loop_bwd_plain")
    want = torch.autograd.grad(loss, [leaves[i] for i in wrt])
    got = bwd_plain(*args, *(c.detach() for c in carries), *extra, **kw)
    assert len(got) == len(want)
    for i, g, w in zip(wrt, got, want):
        assert_grad_close(g.numpy(), w.numpy(), f"argument {i}")


# ---- (c) the fused NLL against decoder_apply(loss_only=True) without
# offset targets and the interpret-mode Pallas forward

def test_fused_nll_matches_jax(rng, monkeypatch):
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    one_step_scans(monkeypatch)
    jcfg, pcfg, params, features, lens, speakers, gt, _ = _decoder_case(
        rng, "LSTM")
    b, t, f = gt.shape
    key = jax.random.PRNGKey(5)
    cot = rng.normal(size=(b, t)).astype(np.float32)

    def jax_loss(p, feats):
        out = jax_decoder.decoder_apply(
            p, jcfg, feats, jnp.asarray(lens), t,
            speaker=jnp.asarray(speakers), ground_truth_out=jnp.asarray(gt),
            key=key, loss_only=True)
        return (out.emission_loss + (out.offset_weights * cot).sum(),
                (out.emission_loss, out.offset_weights))

    (want_em, want_logits), (g_p, g_feat), noise = _jax_reference(
        jax_loss, key, params, features, (t, b, f))
    (em, logits), leaves, feats = _port_losses(
        pcfg, params, features, lens, gt, noise, speakers, with_offset=False)
    np.testing.assert_allclose(em.item(), float(want_em), **VALUE_TOL)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=0,
                               atol=OUT_ATOL)
    (em + (logits * torch.from_numpy(cot)).sum()).backward()
    assert_grad_close(feats.grad.numpy(), g_feat, "features")
    _assert_tree_grads("LSTM", leaves, g_p)

    # the twin's outs and nll against the interpret-mode kernel
    args = _loop_args(rng, "NLL", t=t, lens=tuple(lens))
    np_args = [np.asarray(a) for a in args]
    with jax.default_matmul_precision("highest"):
        want_outs, want_nll = reference_jit(
            lambda *a: decoder_pallas.decoder_loop_fused_nll(
                *a, interpret=True, precision=jax.lax.Precision.HIGHEST))(
                    *np_args)
    outs, nll, _, _ = dk.decoder_fused_nll_fwd_plain(*args)
    np.testing.assert_allclose(outs.numpy(), np.asarray(want_outs), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(nll.item(), float(want_nll), **VALUE_TOL)


# ---- (d) the stream path equals the fused path in the port

@pytest.mark.parametrize("cell,with_offset", [
    ("LSTM", True), ("GRU", True), ("RNN", True), ("ESN", True),
    ("LSTM", False)])
def test_stream_path_equals_fused_path(rng, cell, with_offset):
    """The same weights and noise through both paths: the same losses (the
    offset logits without offset targets) up to summation order, and the
    same gradients."""
    _, pcfg, params, features, lens, speakers, gt, _ = _decoder_case(
        rng, cell)
    b, t, f = gt.shape
    noise = rng.normal(size=(t, b, f)).astype(np.float32)
    cot = (torch.tensor(1.3) if with_offset else torch.from_numpy(
        rng.normal(size=(b, t)).astype(np.float32)))
    runs = []
    for fused_cells in (port_decoder.CELLS, ()):
        (a, z), leaves, feats = _port_losses(
            pcfg, params, features, lens, gt, noise, speakers,
            fused_cells=fused_cells, with_offset=with_offset)
        (a + (z * cot).sum()).backward()
        runs.append((a.item(), z.detach().numpy(), feats.grad.numpy(),
                     [leaf.grad for leaf in tree_leaves(leaves)]))
    (a_f, z_f, df_f, g_f), (a_s, z_s, df_s, g_s) = runs
    np.testing.assert_allclose(a_s, a_f, **VALUE_TOL)
    np.testing.assert_allclose(z_s, z_f, rtol=1e-5, atol=OUT_ATOL)
    assert_grad_close(df_s, df_f, "features")
    for i, (gs, gf) in enumerate(zip(g_s, g_f)):
        assert (gs is None) == (gf is None), i
        if gs is not None:
            assert_grad_close(gs.numpy(), gf.numpy(), f"leaf {i}")


# ---- (e) the switch: the JAX package's variables, read once

@pytest.mark.parametrize("env", [
    {}, {"SEQ2SEQ_NLL_FUSION": "0"}, {"SEQ2SEQ_FUSED_CELLS": ""},
    {"SEQ2SEQ_FUSED_CELLS": " ESN,GRU "},
    {"SEQ2SEQ_NLL_FUSION": "0", "SEQ2SEQ_FUSED_CELLS": "GRU,RNN,ESN"}])
def test_fused_cells_read_as_the_jax_package_reads_them(monkeypatch, env):
    """A cell trains on its fused-loss kernels in the port exactly when
    the JAX package's decoder_apply would take its fused path for it
    (models/decoder.py: SEQ2SEQ_NLL_FUSION not "0", and the LSTM or a cell
    that _fused_loss_cells lists)."""
    for name in ("SEQ2SEQ_NLL_FUSION", "SEQ2SEQ_FUSED_CELLS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = flags.fused_loss_cells(os.environ)
    fusion = os.environ.get("SEQ2SEQ_NLL_FUSION", "1") != "0"
    jax_cells = jax_decoder._fused_loss_cells()
    for cell in port_decoder.CELLS:
        assert (cell in got) == (fusion and (cell == "LSTM"
                                             or cell in jax_cells)), cell


def test_unknown_fused_cell_is_refused():
    """A name the JAX parser keeps (it splits on commas and strips) but
    that is no cell is refused with the cells named."""
    env = {"SEQ2SEQ_FUSED_CELLS": "GRU, gru"}
    with pytest.raises(ValueError, match=r"\['gru'\].*LSTM, GRU, RNN, ESN"):
        flags.fused_loss_cells(env)


def test_cli_hands_the_switch_to_the_learner_and_no_model_reads_it(
        monkeypatch, tmp_path):
    """The training CLI reads the variables once into ``fused_cells``; the
    Learner's StepStatics carry it to the decoder; no model module reads
    the environment."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_learner(**kwargs):
        seen.update(kwargs)
        raise Stop

    monkeypatch.setattr(learning_main, "Learner", fake_learner)
    monkeypatch.setenv("SEQ2SEQ_FUSED_CELLS", "RNN")
    toy = os.path.join(os.path.dirname(__file__), os.pardir, "fixtures",
                       "toy_data")
    ann = os.path.join(toy, "annotation_20170806-080002_89.2-94.22.csv")
    with pytest.raises(Stop):
        learning_main.main([toy, ann, "-S", str(tmp_path), "-j", "r", "-d",
                            "cpu"])
    assert seen["fused_cells"] == ("LSTM", "RNN")
    fields = port_learner.StepStatics.__dataclass_fields__
    assert fields["fused_cells"].default == port_decoder.CELLS
    models = os.path.join(os.path.dirname(port_decoder.__file__))
    for name in sorted(os.listdir(models)):
        if name.endswith(".py"):
            with open(os.path.join(models, name)) as src:
                text = src.read()
            assert "environ" not in text and "getenv" not in text, name


# ---- (f) one whole training step with the switch off

def test_training_step_without_fusion_matches_jax(rng, stream_scan):
    """learner.losses_and_metrics with StepStatics(fused_cells=()) (the
    decoder on its stream path: the sampled loop's forward and hand-written
    backward) against the JAX training_loss with SEQ2SEQ_NLL_FUSION=0, on
    the same spectrogram, weights and noise: the loss, its three terms and
    every gradient."""
    jcfg, params = small_model(hidden=8, k=6, feature_dim=10)
    frames = [9, 4, 7, 3]
    bucket = 10
    audio, num_frames = padded_batch(rng, frames, bucket)
    b = len(num_frames)
    pcfg_model = port_vae.ModelConfig(*(
        port.from_init_parameters(dict(part.pack_init_parameters()))
        for port, part in ((EncoderConfig, jcfg.encoder),
                           (ABCDSamplerConfig, jcfg.latent),
                           (DecoderConfig, jcfg.decoder))))
    statics = port_learner.StepStatics(
        pcfg_model, FRAME, STEP, "hann_window", EPS, NORMALIZER, "fft",
        flags.fused_loss_cells({"SEQ2SEQ_NLL_FUSION": "0"}))
    assert statics.fused_cells == ()
    inputs = port_learner.frontend(statics, torch.from_numpy(audio),
                                   bucket).numpy()
    lens = num_frames.astype(np.int32)
    speakers = np.zeros(b, np.int32)
    is_offset = (np.arange(bucket)[None, :] == lens[:, None] - 1).astype(
        np.float32)
    batch = {"inputs": jnp.asarray(inputs), "lengths": jnp.asarray(lens),
             "speakers": jnp.asarray(speakers),
             "is_offset": jnp.asarray(is_offset)}
    n_data, temperature = 40.0, 0.8
    key = jax.random.PRNGKey(21)

    def jax_step(p):
        (loss, aux), grads = jax.value_and_grad(
            lambda q: jax_vae.training_loss(q, jcfg, batch, key, n_data,
                                            temperature=temperature),
            has_aux=True)(p)
        # forward_losses' key flow: (encoder, latent, decoder) keys; the
        # Gumbel draw of the latent key; the decoder's fold_in(., 0) split
        _, k_lat, k_dec = jax.random.split(key, 3)
        k_noise, _ = jax.random.split(jax.random.fold_in(k_dec, 0))
        noise = (jax.random.gumbel(k_lat, (b, jcfg.latent.num_categories)),
                 jax.random.normal(k_noise, (bucket, b, BINS)))
        return loss, aux, grads, noise

    with jax.default_matmul_precision("highest"):
        want_loss, aux, grads, noise = reference_jit(jax_step)(params)
    port_params = tree_map(lambda a: a.requires_grad_(True), params_from_jax(
        params, pcfg_model.encoder, decoder_cfg=pcfg_model.decoder))
    gumbel, dec_noise = (torch.from_numpy(np.array(a)) for a in noise)
    loss, metrics = port_learner.losses_and_metrics(
        port_params, statics, torch.from_numpy(audio),
        torch.from_numpy(num_frames), torch.from_numpy(speakers),
        {"gumbel": gumbel, "decoder": dec_noise}, n_data, temperature, False,
        bucket)
    np.testing.assert_allclose(loss.item(), float(want_loss), **VALUE_TOL)
    for k in ("emission_loss", "offset_loss", "kl_loss"):
        np.testing.assert_allclose(metrics[k].item(), float(aux[k]),
                                   **VALUE_TOL)
    loss.backward()
    got = params_to_jax(tree_map(lambda p: p.grad, port_params))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(grads)):
        assert_grad_close(g, w, jax.tree_util.keystr(path))
