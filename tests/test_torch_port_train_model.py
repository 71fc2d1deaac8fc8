"""The training model of the PyTorch port against the JAX package: the
emission's noise model, the k-stacked MLP, the ABCD head's sample, KL and
temperature (the cases of tests/test_abcd.py), fresh parameters of the
right shapes, and one whole training loss with two clipped SGD steps held
to vae.training_loss and optim.make_optimizer on the same weights, inputs
and noise (the JAX side on its scan paths)."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu import distributions as jax_dist
from seq2seq_abcd_vae_tpu.configs import (
    ABCDSamplerConfig as JaxABCDConfig, DecoderConfig as JaxDecoderConfig,
    EncoderConfig as JaxEncoderConfig)
from seq2seq_abcd_vae_tpu.models import abcd as jax_abcd
from seq2seq_abcd_vae_tpu.models import sampler as jax_sampler
from seq2seq_abcd_vae_tpu.models import vae as jax_vae
from seq2seq_abcd_vae_tpu.configs import GaussianSamplerConfig
from seq2seq_abcd_vae_tpu.train import optim as jax_optim
from seq2seq_abcd_vae_tpu_torch import distributions as port_dist
from seq2seq_abcd_vae_tpu_torch.configs import (ABCDSamplerConfig,
                                                DecoderConfig, EncoderConfig,
                                                check_decoder)
from seq2seq_abcd_vae_tpu_torch.models import abcd as port_abcd
from seq2seq_abcd_vae_tpu_torch.models import sampler as port_sampler
from seq2seq_abcd_vae_tpu_torch.models import vae as port_vae
from seq2seq_abcd_vae_tpu_torch.train import optim as port_optim
from seq2seq_abcd_vae_tpu_torch.train.from_jax import (params_from_jax,
                                                       params_to_jax)
from seq2seq_abcd_vae_tpu_torch.tree import tree_leaves, tree_map
from torch_port_fixtures import (few_torch_threads_fixture, one_step_scans,
                                 port_init_tree, reference_jit)

few_torch_threads = pytest.fixture(few_torch_threads_fixture)
pytestmark = pytest.mark.usefixtures("few_torch_threads")

# float32 sums in another order: values to 1e-5 relative; gradients and
# updated parameters to 1e-5 of each leaf's largest magnitude
TOL = dict(rtol=1e-5, atol=1e-6)
FRACTION = 1e-5


def close_to_scale(got, want, name, fraction=FRACTION):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= fraction * max(np.abs(want).max(), 1e-12), (name, err)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_gaussian_noise_model_matches_jax(rng):
    value, mean, logvar = (rng.normal(size=(4, 3, 5)).astype(np.float32)
                           for _ in range(3))
    noise = rng.normal(size=(4, 3, 5)).astype(np.float32)
    mask = (rng.random(size=(4, 3, 1)) > 0.4).astype(np.float32)
    want = jax_dist.log_pdf_isotropic_gaussian(value, mean, logvar, mask)
    got = port_dist.log_pdf_isotropic_gaussian(t(value), t(mean), t(logvar),
                                               t(mask))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    want = jax_dist.kl_isotropic_to_standard_gaussian(mean, logvar, mask)
    got = port_dist.kl_isotropic_to_standard_gaussian(t(mean), t(logvar),
                                                      t(mask))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(
        port_dist.gaussian_from_noise(t(noise), t(mean), t(logvar)).numpy(),
        np.asarray(jax_dist.gaussian_from_noise(noise, mean, logvar)), **TOL)
    gen = torch.Generator().manual_seed(0)
    draw = port_dist.gaussian_noise(gen, (2000,))
    assert abs(draw.mean().item()) < 0.1 and abs(draw.std().item() - 1) < 0.1


def test_emission_sampler_matches_jax(rng):
    cfg = GaussianSamplerConfig(6, 5, 4)
    # the JAX initialiser's draws, compiled once (jit keeps them)
    params = reference_jit(lambda k: jax_sampler.sampler_init(k, cfg))(
        jax.random.PRNGKey(1))
    x = rng.normal(size=(3, 7, 6)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = reference_jit(jax_sampler.sampler_apply)(params,
                                                        jnp.asarray(x))
    got = port_sampler.sampler_apply(tree_map(t, params), t(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    gen = torch.Generator().manual_seed(0)
    fresh = port_sampler.sampler_init(gen, 6, 5, 4)
    assert (jax.tree_util.tree_map(np.shape, params)
            == tree_map(lambda a: tuple(a.shape), fresh))


def _abcd(prior=1.0):
    jcfg = JaxABCDConfig(12, 9, 7, 11, prior_concentration=prior)
    pcfg = ABCDSamplerConfig(12, 9, 7, 11, prior_concentration=prior)
    params = reference_jit(lambda k: jax_abcd.abcd_init(k, jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, pcfg, params, tree_map(t, params)


@pytest.mark.parametrize("masked", [False, True])
def test_abcd_kl_matches_jax(rng, masked):
    jcfg, pcfg, params, tparams = _abcd(prior=0.7)
    logits = rng.normal(size=(5, 7)).astype(np.float32)
    mask = np.asarray([1, 1, 1, 0, 0], np.float32) if masked else None
    want = jax_abcd.abcd_kl(params, jcfg, jnp.asarray(logits), 100.0,
                            row_mask=None if mask is None
                            else jnp.asarray(mask))
    got = port_abcd.abcd_kl(tparams, pcfg, t(logits), 100.0,
                            row_mask=None if mask is None else t(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_abcd_sample_matches_jax(rng):
    _, _, params, tparams = _abcd()
    logits = rng.normal(size=(4, 7)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    with jax.default_matmul_precision("highest"):
        want = jax_abcd.abcd_sample(params, jnp.asarray(logits), 0.6,
                                    key=key)
        want_ns = jax_abcd.abcd_sample(params, jnp.asarray(logits), 1.0,
                                       no_sample=True)
    gumbel = np.asarray(jax.random.gumbel(key, (4, 7)))  # the same draws
    got = port_abcd.abcd_sample(tparams, t(logits), 0.6, t(gumbel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got_ns = port_abcd.abcd_sample(tparams, t(logits), 1.0, no_sample=True)
    np.testing.assert_allclose(got_ns.numpy(), np.asarray(want_ns), **TOL)
    gen = torch.Generator().manual_seed(1)
    g = port_abcd.gumbel_noise(gen, (20000,))
    # a standard Gumbel has mean Euler's gamma and variance pi^2 / 6
    assert abs(g.mean().item() - 0.5772) < 0.05
    assert abs(g.var().item() - math.pi ** 2 / 6) < 0.1


def test_temperature_schedule_matches_jax():
    kw = dict(min_temperature=1.0, temperature_update_freq=1000,
              temperature_anneal_rate=1e-5)
    jcfg = JaxABCDConfig(4, 4, 4, 4, **kw)
    pcfg = ABCDSamplerConfig(4, 4, 4, 4, **kw)
    for n in (0, 999, 1000, 2500, 123456):
        assert port_abcd.temperature_for_iter(pcfg, n) == pytest.approx(
            float(jax_abcd.temperature_for_iter(jcfg, n)), rel=1e-6)
    assert port_abcd.temperature_for_iter(pcfg, 999) == 1.0


F, H, MLP, K, FEAT, SPK, EMB = 9, 8, 12, 6, 10, 2, 3


def _configs():
    enc = (F, H)
    lat = (4 * H, MLP, K, FEAT)
    dec = (F, H, MLP, FEAT)
    dkw = dict(num_speakers=SPK, speaker_embed_dim=EMB)
    jcfg = jax_vae.ModelConfig(JaxEncoderConfig(*enc), JaxABCDConfig(*lat),
                               JaxDecoderConfig(*dec, **dkw))
    pcfg = port_vae.ModelConfig(EncoderConfig(*enc), ABCDSamplerConfig(*lat),
                                DecoderConfig(*dec, **dkw))
    return jcfg, pcfg


def test_fresh_parameters_have_the_jax_tree():
    jcfg, pcfg = _configs()
    want = jax.tree_util.tree_map(
        lambda a: a.shape,
        jax.eval_shape(lambda k: jax_vae.model_init(k, jcfg),
                       jax.random.PRNGKey(0)))
    fresh = port_vae.model_init(torch.Generator().manual_seed(0), pcfg)
    got = tree_map(lambda a: a.shape, params_to_jax(fresh))
    assert got == want
    with pytest.raises(NotImplementedError, match="bidirectional"):
        check_decoder(DecoderConfig(F, H, MLP, FEAT, bidirectional=True),
                      training=False)
    with pytest.raises(NotImplementedError, match="greedy"):
        port_vae.ModelConfig(
            pcfg.encoder, pcfg.latent,
            DecoderConfig(F, H, MLP, FEAT, self_feedback=False)).check()


def test_training_loss_and_sgd_steps_match_jax(rng, monkeypatch):
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    one_step_scans(monkeypatch)
    jcfg, pcfg = _configs()
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

    jax_step = reference_jit(jax_step)  # one compile for both steps
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
        got_params = params_to_jax(port_params)
        for (path, g), w in zip(
                jax.tree_util.tree_leaves_with_path(got_params),
                jax.tree_util.tree_leaves(params)):
            close_to_scale(g, w, f"step {step} param "
                           + jax.tree_util.keystr(path))


def test_plateau_scheduler_matches_jax():
    jax_s = jax_optim.ReduceLROnPlateau(patience=1)
    port_s = port_optim.ReduceLROnPlateau(patience=1)
    lr_j = lr_p = 1.0
    for metric in (5.0, 4.0, 4.5, 4.4, 4.6, 3.0, 3.1, 3.2, 3.3):
        lr_j = jax_s.step(metric, lr_j)
        lr_p = port_s.step(metric, lr_p)
        assert lr_p == lr_j
    jax_s.reset_best()
    port_s.reset_best()
    assert port_s.state_dict() == jax_s.state_dict()
