"""The training kernels' plain twins against the JAX package: the
bidirectional LSTM's backward (held to jax.grad through the scan path of
run_rnn_layer_bidir) and the fused-loss LSTM decoder loop (forward and
backward held to jax.grad through decoder_apply's scan path, with its
noise reproduced from the same key; the forward also held to the Pallas
kernel in interpret mode).  These twins are what the kernel wrappers run
on CPU tensors, and what the card's kernels are held to."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.configs import DecoderConfig as JaxDecoderConfig
from seq2seq_abcd_vae_tpu.models import decoder as jax_decoder
from seq2seq_abcd_vae_tpu.models import initializers as jax_init
from seq2seq_abcd_vae_tpu.models import rnn as jax_rnn
from seq2seq_abcd_vae_tpu.ops import decoder_pallas
from seq2seq_abcd_vae_tpu_torch.configs import DecoderConfig
from seq2seq_abcd_vae_tpu_torch.models import decoder as port_decoder
from seq2seq_abcd_vae_tpu_torch.models import rnn as port_rnn
from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel, lstm_kernel
from seq2seq_abcd_vae_tpu_torch.tree import tree_map
from torch_port_fixtures import (few_torch_threads_fixture, one_step_scans,
                                 reference_jit)

few_torch_threads = pytest.fixture(few_torch_threads_fixture)
pytestmark = pytest.mark.usefixtures("few_torch_threads")

# float32 sums in another order, through at most 12 recurrent steps:
# values to 1e-5 relative; each gradient leaf to 1e-5 of its largest
# magnitude (a leaf sums every step's and row's contribution).
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_FRACTION = 1e-5


def assert_grad_close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= GRAD_FRACTION * scale, (name, err, scale)


@pytest.mark.parametrize("with_douts", [False, True])
def test_lstm_backward_twin_matches_jax_grad(rng, monkeypatch, with_douts):
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    one_step_scans(monkeypatch)
    t, f, h = 9, 5, 8
    lens = np.asarray([9, 0, 4, 1, 7], np.int32)
    b = len(lens)
    keys = jax.random.split(jax.random.PRNGKey(4))
    p_fwd = jax_init.rnn_gate_params(keys[0], f, h, 4)
    p_bwd = jax_init.rnn_gate_params(keys[1], f, h, 4)
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((b, t, h), (b, t, h), (b, h), (b, h), (b, h), (b, h))]
    mask = jax_rnn.lengths_to_mask(jnp.asarray(lens), t)

    def total(outs_f, outs_b, fin, xp):
        (hf, cf), (hb, cb) = fin
        s = sum((a * xp.asarray(g)).sum()
                for a, g in zip((hf, cf, hb, cb), cot[2:]))
        if with_douts:
            s = s + (outs_f * xp.asarray(cot[0])).sum() + (
                outs_b * xp.asarray(cot[1])).sum()
        return s

    def jax_loss(pf, pb, xx):
        outs_f, outs_b, fin = jax_rnn.run_rnn_layer_bidir("LSTM", pf, pb, xx,
                                                          mask)
        return total(outs_f, outs_b, fin, jnp)

    with jax.default_matmul_precision("highest"):
        want_val, (g_f, g_b, g_x) = reference_jit(jax.value_and_grad(
            jax_loss, argnums=(0, 1, 2)))(p_fwd, p_bwd, jnp.asarray(x))

    w = {k: torch.from_numpy(np.stack([np.asarray(p_fwd[k]),
                                       np.asarray(p_bwd[k])])
                             ).requires_grad_(True)
         for k in ("w_ih", "b_ih", "w_hh", "b_hh")}
    xt = torch.from_numpy(x).requires_grad_(True)
    outs_f, outs_b, fin = port_rnn.run_rnn_layer_bidir(w, xt,
                                                       torch.from_numpy(lens))
    got_val = total(outs_f, outs_b, fin, torch)
    got_val.backward()
    np.testing.assert_allclose(got_val.item(), float(want_val), **VALUE_TOL)
    assert_grad_close(xt.grad.numpy(), g_x, "dx")
    for k in w:
        assert_grad_close(w[k].grad[0].numpy(), g_f[k], "fwd " + k)
        assert_grad_close(w[k].grad[1].numpy(), g_b[k], "bwd " + k)


def test_lstm_training_path_saves_no_state_when_serving(rng):
    """Without autograd the layer runs the forward alone (no cs), and with
    it the forward's saved cs are the twin's."""
    t, f, h = 6, 4, 5
    lens = torch.tensor([6, 2, 0], dtype=torch.int32)
    x = torch.from_numpy(rng.normal(size=(t, 3, f)).astype(np.float32))
    w = [torch.from_numpy(rng.uniform(-0.4, 0.4, size=s).astype(np.float32))
         for s in ((2, f, 4 * h), (2, 4 * h), (2, h, 4 * h), (2, 4 * h))]
    assert len(lstm_kernel.lstm_layer_bidir_fused(x, lens, *w)) == 3
    outs, h_n, c_n, cs = lstm_kernel.lstm_layer_bidir_fused(
        x, lens, *w, return_cs=True)
    np.testing.assert_array_equal(cs[-1].numpy(), c_n.numpy())
    with pytest.raises(ValueError, match="douts"):
        lstm_kernel.lstm_layer_bidir_fused_bwd(
            x, lens, *w, outs, cs, outs[:-1].contiguous(), h_n, c_n)


SPEAKERS = 3


def _decoder_case(rng, t=10, f=6, h=8, m=7, feat=5, embed=4,
                  lens=(10, 0, 4, 1, 8)):
    cfg_kw = dict(num_speakers=SPEAKERS, speaker_embed_dim=embed)
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


def test_decoder_twins_match_jax_scan_and_grad(rng, monkeypatch):
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
            np.asarray(lens, np.int32), uni(0.35, h, 4 * h + 2 * m),
            uni(0.5, 4 * h), uni(0.35, 2 * m), uni(0.4, m, f),
            uni(0.4, m, f), uni(0.4, 2 * f), uni(0.35, f, 4 * h),
            rng.normal(size=(t, b, f)).astype(np.float32), uni(0.35, h, mo),
            uni(0.35, mo), uni(0.4, mo), uni(0.4, 1),
            rng.normal(size=(b, h)).astype(np.float32) * 0.5,
            rng.normal(size=(b, h)).astype(np.float32) * 0.5]


def test_decoder_forward_twin_matches_pallas_interpret(rng):
    t, b, f, h, m, mo = 12, 5, 9, 16, 6, 7
    args = _kernel_args(rng, t, b, f, h, m, mo, [12, 0, 5, 1, 11])
    (noise, lens, w_cat, bias, b1, w2m, w2v, b2, w_ih, targets, wo1, bo1,
     wo2, bo2, h0, c0) = args
    with jax.default_matmul_precision("highest"):
        want = reference_jit(
            lambda *a: decoder_pallas.decoder_loop_fused_losses(
                *a, interpret=True, precision=jax.lax.Precision.HIGHEST))(
                    *(jnp.asarray(a) for a in (noise, lens, w_cat, bias, b1,
                                               w2m, w2v, b2, w_ih, targets,
                                               wo1)),
                    jnp.asarray(bo1.reshape(1, -1)),
                    jnp.asarray(wo2.reshape(1, -1)),
                    jnp.asarray(bo2.reshape(1, 1)), jnp.asarray(h0),
                    jnp.asarray(c0))
    got = decoder_kernel.decoder_fused_losses_fwd(
        *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **VALUE_TOL)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g.item(), float(w), **VALUE_TOL)


def test_decoder_backward_twin_matches_autograd_of_forward_twin(rng):
    """The explicit adjoint against autograd through the step-by-step
    forward twin, at the kernel's own interface (dlast and both loss
    cotangents non-zero)."""
    t, b, f, h, m, mo = 8, 4, 5, 6, 4, 5
    args = [torch.from_numpy(a)
            for a in _kernel_args(rng, t, b, f, h, m, mo, [8, 3, 0, 6])]
    diff = [i for i, a in enumerate(args) if i not in (0, 1, 9)]
    leaf = [a.clone().requires_grad_(True) if i in diff else a
            for i, a in enumerate(args)]
    out_last, nll, bce = decoder_kernel.decoder_loop_fused_losses(*leaf)
    dlast = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32))
    (0.7 * nll + 1.3 * bce + (out_last * dlast).sum()).backward()
    _, _, _, hs, cs = decoder_kernel.decoder_fused_losses_fwd(*args)
    got = decoder_kernel.decoder_fused_losses_bwd(
        *args, hs, cs, dlast, torch.tensor([0.7, 1.3]))
    for i, g in zip(diff, got):
        assert_grad_close(g.numpy(), leaf[i].grad.numpy(), str(i))


def test_decoder_wrapper_rejects_what_the_kernel_does_not_take(rng):
    args = [torch.from_numpy(a)
            for a in _kernel_args(rng, 4, 3, 2, 3, 2, 2, [4, 1, 0])]
    call = decoder_kernel.decoder_fused_losses_fwd
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(TypeError, match="lengths"):
        call(*bad)
    bad = list(args)
    bad[2] = bad[2][:, :-1].contiguous()
    with pytest.raises(ValueError, match="w_cat"):
        call(*bad)
    bad = list(args)
    bad[14] = bad[14].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        call(*bad)
