"""The GRU kernels' plain twins against the JAX package: the
bidirectional GRU layer (``ops/gru_kernel``) forward against the Pallas
kernel ``gru_pallas.gru_layer_bidir_fused`` in interpret mode and against
the scan path of ``rnn.run_rnn_layer_bidir``, its backward against
``jax.grad`` through the interpret-mode kernel; the GRU fused-loss decoder
loop (``ops/decoder_kernel.gru_decoder_loop_fused_losses``) forward against
``decoder_pallas.gru_decoder_loop_fused_losses`` in interpret mode and its
gradients against ``jax.grad`` through ``decoder_apply``'s scan path.
These twins are what the kernel wrappers run on CPU tensors, and what the
card's kernels are held to."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.configs import DecoderConfig as JaxDecoderConfig
from seq2seq_abcd_vae_tpu.models import decoder as jax_decoder
from seq2seq_abcd_vae_tpu.models import initializers as jax_init
from seq2seq_abcd_vae_tpu.models import rnn as jax_rnn
from seq2seq_abcd_vae_tpu.ops import decoder_pallas, gru_pallas
from seq2seq_abcd_vae_tpu_torch.configs import DecoderConfig
from seq2seq_abcd_vae_tpu_torch.models import decoder as port_decoder
from seq2seq_abcd_vae_tpu_torch.models import rnn as port_rnn
from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel, gru_kernel
from seq2seq_abcd_vae_tpu_torch.tree import tree_map
from torch_port_fixtures import (few_torch_threads_fixture, one_step_scans,
                                 reference_jit)

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

# float32 sums in another order, through at most 10 recurrent steps:
# values to 1e-5 relative; each gradient leaf to 1e-5 of its largest
# magnitude (a leaf sums every step's and row's contribution).
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_FRACTION = 1e-5
HIGHEST = jax.lax.Precision.HIGHEST


def assert_grad_close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= GRAD_FRACTION * scale, (name, err, scale)


def _layer(rng, t=8, f=5, h=6, lens=(8, 0, 3, 1)):
    """x (T, B, F), lengths and stacked GRU weights (the JAX initialiser's
    draws for the two directions)."""
    keys = jax.random.split(jax.random.PRNGKey(5))
    per_dir = [jax_init.rnn_gate_params(k, f, h, 3) for k in keys]
    w = {k: np.stack([np.asarray(p[k]) for p in per_dir])
         for k in ("w_ih", "b_ih", "w_hh", "b_hh")}
    lens = np.asarray(lens, np.int32)
    x = rng.normal(size=(t, len(lens), f)).astype(np.float32)
    return x, lens, w, per_dir


def test_gru_layer_twin_matches_pallas_interpret_and_scan(rng, monkeypatch):
    """outs (direction 1 in flipped time) and h_n: the twin against the
    Pallas kernel in interpret mode, and models/rnn against the JAX
    function's scan path; a ragged batch with an empty row."""
    x, lens, w, per_dir = _layer(rng)
    names = ("w_ih", "b_ih", "w_hh", "b_hh")
    want = reference_jit(lambda *a: gru_pallas.gru_layer_bidir_fused(
        *a, interpret=True, precision=HIGHEST))(
            jnp.asarray(x), jnp.asarray(lens),
            *(jnp.asarray(w[k]) for k in names))
    got = gru_kernel.gru_layer_bidir_fused(
        torch.from_numpy(x), torch.from_numpy(lens),
        *(torch.from_numpy(w[k]) for k in names))
    assert got[0].shape == (8, 2, 4, 6) and got[1].shape == (2, 4, 6)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **VALUE_TOL)
    np.testing.assert_array_equal(got[1][:, 1].numpy(), 0.0)  # empty row

    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    one_step_scans(monkeypatch)
    xb = np.ascontiguousarray(x.transpose(1, 0, 2))
    mask = jax_rnn.lengths_to_mask(jnp.asarray(lens), x.shape[0])
    with jax.default_matmul_precision("highest"):
        want_f, want_b, want_fin = reference_jit(
            lambda *a: jax_rnn.run_rnn_layer_bidir("GRU", *a))(
                *per_dir, jnp.asarray(xb), mask)
    got_f, got_b, got_fin = port_rnn.run_rnn_layer_bidir(
        {k: torch.from_numpy(v) for k, v in w.items()},
        torch.from_numpy(xb), torch.from_numpy(lens), "GRU")
    for g, wnt in zip((got_f, got_b), (want_f, want_b)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **VALUE_TOL)
    for (gh, gc), (wh, wc) in zip(got_fin, want_fin):
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **VALUE_TOL)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("with_douts", [False, True])
def test_gru_layer_backward_twin_matches_jax_grad(rng, with_douts):
    """Gradients of x and the four weights through the explicit adjoint,
    against jax.grad through the interpret-mode Pallas kernel (its own
    hand-derived backward)."""
    x, lens, w, _ = _layer(rng)
    t, b, _ = x.shape
    h = w["w_hh"].shape[1]
    c_outs = rng.normal(size=(t, 2, b, h)).astype(np.float32)
    c_hn = rng.normal(size=(2, b, h)).astype(np.float32)
    names = ("w_ih", "b_ih", "w_hh", "b_hh")

    def total(outs, h_n, xp):
        s = (h_n * xp.asarray(c_hn)).sum()
        if with_douts:
            s = s + (outs * xp.asarray(c_outs)).sum()
        return s

    def jax_loss(xx, *ws):
        outs, h_n = gru_pallas.gru_layer_bidir_fused(
            xx, jnp.asarray(lens), *ws, interpret=True, precision=HIGHEST)
        return total(outs, h_n, jnp)

    want_val, want_grads = reference_jit(jax.value_and_grad(
        jax_loss, argnums=tuple(range(5))))(
            jnp.asarray(x), *(jnp.asarray(w[k]) for k in names))
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        torch.from_numpy(w[k]).requires_grad_(True) for k in names]
    outs, h_n = gru_kernel.gru_layer_bidir_fused_train(
        leaves[0], torch.from_numpy(lens), *leaves[1:])
    got_val = total(outs, h_n, torch)
    got_val.backward()
    np.testing.assert_allclose(got_val.item(), float(want_val), **VALUE_TOL)
    for name, leaf, want in zip(("x",) + names, leaves, want_grads):
        assert_grad_close(leaf.grad.numpy(), want, name)


def test_gru_layer_wrappers_reject_what_the_kernels_do_not_take(rng):
    x, lens, w, _ = _layer(rng, t=3, f=2, h=3, lens=(3, 1))
    args = [torch.from_numpy(a) for a in (x, lens, w["w_ih"], w["b_ih"],
                                          w["w_hh"], w["b_hh"])]
    outs, h_n = gru_kernel.gru_layer_bidir_fused(*args)
    for i, bad, err in ((1, args[1].long(), ValueError),
                        (2, torch.zeros(2, 2, 12), ValueError),  # 4H gates
                        (5, args[5].double(), TypeError)):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(err):
            gru_kernel.gru_layer_bidir_fused(*wrong)
    with pytest.raises(ValueError, match="douts"):
        gru_kernel.gru_layer_bidir_fused_bwd(*args, outs,
                                             outs[:-1].contiguous(), h_n)


SPEAKERS = 3


def _decoder_case(rng, t=10, f=6, h=8, m=7, feat=5, embed=4,
                  lens=(10, 0, 4, 1, 8)):
    cfg_kw = dict(num_speakers=SPEAKERS, speaker_embed_dim=embed,
                  rnn_type="GRU")
    jcfg = JaxDecoderConfig(f, h, m, feat, **cfg_kw)
    pcfg = DecoderConfig(f, h, m, feat, **cfg_kw)
    params = tree_map(lambda a: a.numpy(), port_decoder.decoder_init(
        torch.Generator().manual_seed(3), pcfg))
    lens = np.asarray(lens, np.int32)
    b = len(lens)
    features = rng.normal(size=(b, feat)).astype(np.float32)
    speakers = np.asarray([0, -1, 2, 1, 0][:b], np.int32)
    valid = np.arange(t)[None, :] < lens[:, None]
    gt = (rng.normal(size=(b, t, f)) * valid[..., None]).astype(np.float32)
    return jcfg, pcfg, params, features, lens, speakers, gt


def test_gru_decoder_twins_match_jax_scan_and_grad(rng, monkeypatch):
    """decoder_losses on the GRU twins (the fused loop, then position T-1's
    term from out_last) against decoder_apply's scan path: both losses
    and every gradient, the JAX call's own noise handed to the port."""
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    one_step_scans(monkeypatch)
    jcfg, pcfg, params, features, lens, speakers, gt = _decoder_case(rng)
    b, t, f = gt.shape
    key = jax.random.PRNGKey(11)
    is_offset = (np.arange(t)[None, :] == lens[:, None] - 1).astype(
        np.float32)

    def jax_loss(p, feats):
        out = jax_decoder.decoder_apply(
            p, jcfg, feats, jnp.asarray(lens), t,
            speaker=jnp.asarray(speakers), ground_truth_out=jnp.asarray(gt),
            ground_truth_offset=jnp.asarray(is_offset), key=key,
            loss_only=False)
        return (0.7 * out.emission_loss + 1.3 * out.offset_loss,
                (out.emission_loss, out.offset_loss))

    with jax.default_matmul_precision("highest"):
        (_, (want_em, want_off)), (g_p, g_feat) = reference_jit(
            jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
                params, jnp.asarray(features))
    # the scan path's noise: fold_in(key, 0), split, normal (T, B, F)
    k_noise, _ = jax.random.split(jax.random.fold_in(key, 0))
    noise = np.asarray(jax.random.normal(k_noise, (t, b, f)))

    leaves = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), params)
    feats = torch.from_numpy(features).requires_grad_(True)
    em, off = port_decoder.decoder_losses(
        leaves, pcfg, feats, torch.from_numpy(lens), torch.from_numpy(gt),
        torch.from_numpy(noise.copy()), speaker=torch.from_numpy(speakers))
    np.testing.assert_allclose(em.item(), float(want_em), **VALUE_TOL)
    np.testing.assert_allclose(off.item(), float(want_off), **VALUE_TOL)
    (0.7 * em + 1.3 * off).backward()
    assert_grad_close(feats.grad.numpy(), g_feat, "features")
    got_flat = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda x: x.grad.numpy(), leaves))
    for (path, got), want in zip(got_flat, jax.tree_util.tree_leaves(g_p)):
        assert_grad_close(got, want, jax.tree_util.keystr(path))


def _kernel_args(rng, t, b, f, h, m, mo, lens):
    def uni(bound, *shape):
        return rng.uniform(-bound, bound, size=shape).astype(np.float32)
    return [rng.normal(size=(t, b, f)).astype(np.float32),
            np.asarray(lens, np.int32), uni(0.35, h, 3 * h + 2 * m),
            uni(0.5, 3 * h), uni(0.5, 3 * h), uni(0.35, 2 * m),
            uni(0.4, m, f), uni(0.4, m, f), uni(0.4, 2 * f),
            uni(0.35, f, 3 * h), rng.normal(size=(t, b, f)).astype(
                np.float32), uni(0.35, h, mo), uni(0.35, mo), uni(0.4, mo),
            uni(0.4, 1), rng.normal(size=(b, h)).astype(np.float32) * 0.5]


def test_gru_decoder_forward_twin_matches_pallas_interpret(rng):
    """out_last (the last step's pre-mask h2), nll over positions 0..T-2
    and bce over all, against the Pallas kernel in interpret mode."""
    t, b, f, h, m, mo = 9, 5, 7, 8, 6, 5
    args = _kernel_args(rng, t, b, f, h, m, mo, [9, 0, 5, 1, 8])
    jargs = [jnp.asarray(a) for a in args]
    for i in (12, 13):                                   # bo1, wo2 (1, Mo)
        jargs[i] = jargs[i].reshape(1, -1)
    jargs[14] = jargs[14].reshape(1, 1)                  # bo2
    want = reference_jit(
        lambda *a: decoder_pallas.gru_decoder_loop_fused_losses(
            *a, interpret=True, precision=HIGHEST))(*jargs)
    got = decoder_kernel.gru_decoder_loop_fused_losses(
        *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **VALUE_TOL)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g.item(), float(w), **VALUE_TOL)


def test_gru_decoder_backward_twin_matches_autograd_of_forward_twin(rng):
    """The explicit adjoint (the backward kernel's twin) against autograd
    through the step-by-step forward twin, at the kernel's own interface:
    out_last's cotangent and both loss cotangents non-zero."""
    t, b, f, h, m, mo = 8, 4, 5, 6, 4, 5
    args = [torch.from_numpy(a)
            for a in _kernel_args(rng, t, b, f, h, m, mo, [8, 3, 0, 6])]
    diff = [i for i in range(len(args)) if i not in (0, 1, 10)]
    leaf = [a.clone().requires_grad_(True) if i in diff else a
            for i, a in enumerate(args)]
    out_last, nll, bce, _ = decoder_kernel.gru_decoder_fused_losses_fwd_plain(
        *leaf)
    dlast = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32))
    (0.7 * nll + 1.3 * bce + (out_last * dlast).sum()).backward()
    hs = decoder_kernel.gru_decoder_fused_losses_fwd(*args)[3]
    got = decoder_kernel.gru_decoder_fused_losses_bwd(
        *args, hs, dlast, torch.tensor([0.7, 1.3]))
    assert len(got) == len(diff) == 13
    for i, g in zip(diff, got):
        assert_grad_close(g.numpy(), leaf[i].grad.numpy(), str(i))
    # without autograd the forward saves no trajectory
    assert decoder_kernel.gru_decoder_fused_losses_fwd(
        *args, save=False)[3] is None


def test_gru_decoder_wrapper_rejects_what_the_kernel_does_not_take(rng):
    args = [torch.from_numpy(a)
            for a in _kernel_args(rng, 4, 3, 2, 3, 2, 2, [4, 1, 0])]
    call = decoder_kernel.gru_decoder_fused_losses_fwd
    call(*args)
    for i, bad, err, match in (
            (1, args[1].long(), TypeError, "lengths"),
            (2, torch.zeros(3, 4 * 3 + 4), ValueError, "w_cat"),  # LSTM's
            (4, torch.zeros(12), ValueError, "b_hh"),
            (15, args[15].t().contiguous().t(), ValueError, "contiguous")):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(err, match=match):
            call(*wrong)
