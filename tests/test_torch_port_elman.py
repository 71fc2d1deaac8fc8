"""The Elman / ESN kernels' plain twins against the JAX package: the
bidirectional Elman layer (``ops/elman_kernel``) forward against the Pallas
kernel ``elman_pallas.rnn_layer_bidir_fused`` in interpret mode and against
the scan paths of ``rnn.run_rnn_layer_bidir`` and
``esn.run_esn_layer_bidir``, its backward against ``jax.grad`` through the
interpret-mode kernel, at leak 1.0 (the Elman cell) and 0.5 (the ESN's);
the Elman / ESN fused-loss decoder loop
(``ops/decoder_kernel.rnn_decoder_loop_fused_losses``) forward against
``decoder_pallas.rnn_decoder_loop_fused_losses`` in interpret mode, its
gradients against ``jax.grad`` through ``decoder_apply``'s scan path
(the interpret-mode kernel's own gradient does not trace under this jax:
its custom VJP returns a flat bias cotangent for a (1, H) bias), and its
hand-written adjoint against autograd of the forward twin.  These twins
are what the kernel wrappers run on CPU tensors, and what the card's
kernels are held to."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.configs import DecoderConfig as JaxDecoderConfig
from seq2seq_abcd_vae_tpu.models import decoder as jax_decoder
from seq2seq_abcd_vae_tpu.models import esn as jax_esn
from seq2seq_abcd_vae_tpu.models import rnn as jax_rnn
from seq2seq_abcd_vae_tpu.ops import decoder_pallas, elman_pallas
from seq2seq_abcd_vae_tpu_torch.configs import DecoderConfig
from seq2seq_abcd_vae_tpu_torch.models import decoder as port_decoder
from seq2seq_abcd_vae_tpu_torch.models import esn as port_esn
from seq2seq_abcd_vae_tpu_torch.models import rnn as port_rnn
from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel, elman_kernel
from seq2seq_abcd_vae_tpu_torch.train.from_jax import _to_np
from seq2seq_abcd_vae_tpu_torch.tree import tree_map
from torch_port_fixtures import (few_torch_threads_fixture, one_step_scans,
                                 reference_jit)

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

# float32 sums in another order, through at most 10 recurrent steps: values
# to 1e-5 absolute (|h| <= 1) and the losses to 1e-5 relative; each
# gradient leaf to 1e-4 of its largest magnitude (a leaf sums every step's
# and row's contribution).
LAYER_ATOL = 1e-5
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_FRACTION = 1e-4
HIGHEST = jax.lax.Precision.HIGHEST
NAMES = ("w_ih", "b_ih", "w_hh", "b_hh")


@pytest.fixture
def scan_paths(monkeypatch):
    """The JAX package's scan paths."""
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    monkeypatch.setenv("SEQ2SEQ_RNN_BACKEND", "scan")
    one_step_scans(monkeypatch)


def assert_grad_close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= GRAD_FRACTION * scale, (name, err, scale)


def _layer(rng, leak, t=9, f=6, h=8, lens=(9, 0, 4, 1, 7)):
    """x (T, B, F), lengths and stacked weights: uniform(+-1/sqrt(H)) as
    torch.nn.RNN draws them, or the ESN's zero biases at leak < 1."""
    bound = 1.0 / np.sqrt(h)
    w = {k: rng.uniform(-bound, bound, size=s).astype(np.float32)
         for k, s in (("w_ih", (2, f, h)), ("b_ih", (2, h)),
                      ("w_hh", (2, h, h)), ("b_hh", (2, h)))}
    if leak < 1.0:
        w["b_ih"][:] = 0.0
        w["b_hh"][:] = 0.0
    lens = np.asarray(lens, np.int32)
    x = rng.normal(size=(t, len(lens), f)).astype(np.float32)
    return x, lens, w


@pytest.mark.parametrize("leak", [1.0, 0.5])
def test_elman_layer_twin_matches_pallas_interpret_and_scan(rng, scan_paths,
                                                            leak):
    """outs (direction 1 in flipped time) and h_n: the twin against the
    Pallas kernel in interpret mode; then models/rnn (leak 1) or
    models/esn (leak 0.5) against the JAX function's scan path; a ragged
    batch with an empty row."""
    x, lens, w = _layer(rng, leak)
    want = reference_jit(lambda *a: elman_pallas.rnn_layer_bidir_fused(
        *a, interpret=True, precision=HIGHEST, leak=leak))(
            jnp.asarray(x), jnp.asarray(lens),
            *(jnp.asarray(w[k]) for k in NAMES))
    got = elman_kernel.rnn_layer_bidir_fused(
        torch.from_numpy(x), torch.from_numpy(lens),
        *(torch.from_numpy(w[k]) for k in NAMES), leak)
    assert got[0].shape == (9, 2, 5, 8) and got[1].shape == (2, 5, 8)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                   atol=LAYER_ATOL)
    np.testing.assert_array_equal(got[1][:, 1].numpy(), 0.0)  # empty row

    xb = np.ascontiguousarray(x.transpose(1, 0, 2))
    mask = jax_rnn.lengths_to_mask(jnp.asarray(lens), x.shape[0])
    per_dir = [{k: jnp.asarray(w[k][d]) for k in NAMES} for d in range(2)]
    port_layer = {k: torch.from_numpy(v) for k, v in w.items()}
    with jax.default_matmul_precision("highest"):
        if leak == 1.0:
            want_f, want_b, want_fin = reference_jit(
                lambda *a: jax_rnn.run_rnn_layer_bidir("RNN", *a))(
                    *per_dir, jnp.asarray(xb), mask)
            want_h = [h for h, _ in want_fin]
        else:
            reservoirs = [{k: p[k] for k in ("w_ih", "w_hh")}
                          for p in per_dir]
            want_f, want_b, *want_h = reference_jit(
                lambda *a: jax_esn.run_esn_layer_bidir(*a, leak))(
                    *reservoirs, jnp.asarray(xb), mask)
    if leak == 1.0:
        got_f, got_b, got_fin = port_rnn.run_rnn_layer_bidir(
            port_layer, torch.from_numpy(xb), torch.from_numpy(lens), "RNN")
        got_h = [h for h, _ in got_fin]
        for _, c in got_fin:
            np.testing.assert_array_equal(c.numpy(), 0.0)
    else:
        got_f, got_b, *got_h = port_esn.run_esn_layer_bidir(
            {k: port_layer[k] for k in ("w_ih", "w_hh")},
            torch.from_numpy(xb), torch.from_numpy(lens), leak)
    for g, wnt in zip([got_f, got_b] + got_h, [want_f, want_b] + want_h):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                   atol=LAYER_ATOL)


@pytest.mark.parametrize("leak,with_douts", [(1.0, False), (0.5, True)])
def test_elman_layer_backward_twin_matches_jax_grad(rng, leak, with_douts):
    """Gradients of x and the four weights through the explicit adjoint,
    against jax.grad through the interpret-mode Pallas kernel (its own
    hand-derived backward): the final layer's case (no outs cotangent) of
    the Elman cell, and a lower layer's of the ESN cell."""
    x, lens, w = _layer(rng, leak)
    t, b, _ = x.shape
    h = w["w_hh"].shape[1]
    c_outs = rng.normal(size=(t, 2, b, h)).astype(np.float32)
    c_hn = rng.normal(size=(2, b, h)).astype(np.float32)

    def total(outs, h_n, xp):
        s = (h_n * xp.asarray(c_hn)).sum()
        if with_douts:
            s = s + (outs * xp.asarray(c_outs)).sum()
        return s

    def jax_loss(xx, *ws):
        outs, h_n = elman_pallas.rnn_layer_bidir_fused(
            xx, jnp.asarray(lens), *ws, interpret=True, precision=HIGHEST,
            leak=leak)
        return total(outs, h_n, jnp)

    want_val, want_grads = reference_jit(jax.value_and_grad(
        jax_loss, argnums=tuple(range(5))))(
            jnp.asarray(x), *(jnp.asarray(w[k]) for k in NAMES))
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        torch.from_numpy(w[k]).requires_grad_(True) for k in NAMES]
    outs, h_n = elman_kernel.rnn_layer_bidir_fused_train(
        leaves[0], torch.from_numpy(lens), *leaves[1:], leak)
    got_val = total(outs, h_n, torch)
    got_val.backward()
    np.testing.assert_allclose(got_val.item(), float(want_val), **VALUE_TOL)
    for name, leaf, want in zip(("x",) + NAMES, leaves, want_grads):
        assert_grad_close(leaf.grad.numpy(), want, name)
    # both biases add to one pre-activation: one gradient
    np.testing.assert_array_equal(leaves[2].grad.numpy(),
                                  leaves[4].grad.numpy())


def test_elman_layer_wrappers_reject_what_the_kernels_do_not_take(rng):
    x, lens, w = _layer(rng, 1.0, t=3, f=2, h=3, lens=(3, 1))
    args = [torch.from_numpy(a) for a in (x, lens, w["w_ih"], w["b_ih"],
                                          w["w_hh"], w["b_hh"])]
    outs, h_n = elman_kernel.rnn_layer_bidir_fused(*args)
    for i, bad, err in ((1, args[1].long(), ValueError),
                        (2, torch.zeros(2, 2, 9), ValueError),  # 3H gates
                        (5, args[5].double(), TypeError)):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(err):
            elman_kernel.rnn_layer_bidir_fused(*wrong)
    for leak in (0.0, 1.5):
        with pytest.raises(ValueError, match="leak"):
            elman_kernel.rnn_layer_bidir_fused(*args, leak)
    with pytest.raises(ValueError, match="douts"):
        elman_kernel.rnn_layer_bidir_fused_bwd(*args, outs,
                                               outs[:-1].contiguous(), h_n)


SPEAKERS = 3


def _kernel_args(rng, t, b, f, h, m, mo, lens, leak=1.0):
    """The loop's arguments in rnn_decoder_loop_fused_losses's order; a
    zero bias for the ESN (leak < 1)."""
    def uni(bound, *shape):
        return rng.uniform(-bound, bound, size=shape).astype(np.float32)
    bias = uni(0.5, h) if leak == 1.0 else np.zeros(h, np.float32)
    return [rng.normal(size=(t, b, f)).astype(np.float32),
            np.asarray(lens, np.int32), uni(0.35, h, h + 2 * m), bias,
            uni(0.35, 2 * m), uni(0.4, m, f), uni(0.4, m, f),
            uni(0.4, 2 * f), uni(0.35, f, h),
            rng.normal(size=(t, b, f)).astype(np.float32), uni(0.35, h, mo),
            uni(0.35, mo), uni(0.4, mo), uni(0.4, 1),
            rng.normal(size=(b, h)).astype(np.float32) * 0.5]


@pytest.mark.parametrize("leak", [1.0, 0.5])
def test_rnn_decoder_forward_twin_matches_pallas_interpret(rng, leak):
    """out_last (the last step's pre-mask h2), nll over positions 0..T-2
    and bce over all, against the Pallas kernel in interpret mode (its
    forward needs no VJP)."""
    t, b, f, h, m, mo = 9, 5, 7, 8, 6, 5
    args = _kernel_args(rng, t, b, f, h, m, mo, [9, 0, 5, 1, 8], leak)
    jargs = [jnp.asarray(a) for a in args]
    for i in (11, 12):                                   # bo1, wo2 (1, Mo)
        jargs[i] = jargs[i].reshape(1, -1)
    jargs[13] = jargs[13].reshape(1, 1)                  # bo2
    want = reference_jit(
        lambda *a: decoder_pallas.rnn_decoder_loop_fused_losses(
            *a, interpret=True, precision=HIGHEST, leak=leak))(*jargs)
    got = decoder_kernel.rnn_decoder_loop_fused_losses(
        *(torch.from_numpy(a) for a in args), leak=leak)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **VALUE_TOL)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g.item(), float(w), **VALUE_TOL)


@pytest.mark.parametrize("cell", ["RNN", "ESN"])
def test_rnn_decoder_twins_match_jax_scan_and_grad(rng, scan_paths, cell):
    """decoder_losses on the Elman / ESN twins (the fused loop, then
    position T-1's term from out_last) against decoder_apply's scan path:
    both losses and every gradient, the JAX call's own noise handed to the
    port.  The ESN's reservoir takes no gradient (None in the port, zeros
    in the JAX package)."""
    t, f, h, m, feat, embed = 10, 6, 8, 7, 5, 4
    cfg_kw = dict(num_speakers=SPEAKERS, speaker_embed_dim=embed,
                  rnn_type=cell, esn_leak=0.5 if cell == "ESN" else 1.0)
    jcfg = JaxDecoderConfig(f, h, m, feat, **cfg_kw)
    pcfg = DecoderConfig(f, h, m, feat, **cfg_kw)
    params = tree_map(_to_np, port_decoder.decoder_init(
        torch.Generator().manual_seed(3), pcfg))
    lens = np.asarray([10, 0, 4, 1, 8], np.int32)
    b = len(lens)
    features = rng.normal(size=(b, feat)).astype(np.float32)
    speakers = np.asarray([0, -1, 2, 1, 0], np.int32)
    valid = np.arange(t)[None, :] < lens[:, None]
    gt = (rng.normal(size=(b, t, f)) * valid[..., None]).astype(np.float32)
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
    got_flat = jax.tree_util.tree_leaves_with_path(leaves)
    want_flat = jax.tree_util.tree_leaves(g_p)
    assert len(got_flat) == len(want_flat)
    for (path, leaf), want in zip(got_flat, want_flat):
        name = jax.tree_util.keystr(path)
        if cell == "ESN" and "rnn_cell" in name:
            assert leaf.grad is None, name
            np.testing.assert_array_equal(np.asarray(want), 0.0)
        else:
            assert_grad_close(leaf.grad.numpy(), want, name)


@pytest.mark.parametrize("leak", [1.0, 0.5])
def test_rnn_decoder_backward_twin_matches_autograd_of_forward_twin(rng,
                                                                    leak):
    """The explicit adjoint (the backward kernel's twin) against autograd
    through the step-by-step forward twin, at the kernel's own interface:
    out_last's cotangent and both loss cotangents non-zero."""
    t, b, f, h, m, mo = 8, 4, 5, 6, 4, 5
    args = [torch.from_numpy(a) for a in _kernel_args(
        rng, t, b, f, h, m, mo, [8, 3, 0, 6], leak)]
    diff = [i for i in range(len(args)) if i not in (0, 1, 9)]
    leaf = [a.clone().requires_grad_(True) if i in diff else a
            for i, a in enumerate(args)]
    out_last, nll, bce, _ = decoder_kernel.rnn_decoder_fused_losses_fwd_plain(
        *leaf, leak=leak)
    dlast = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32))
    (0.7 * nll + 1.3 * bce + (out_last * dlast).sum()).backward()
    hs = decoder_kernel.rnn_decoder_fused_losses_fwd(*args, leak=leak)[3]
    got = decoder_kernel.rnn_decoder_fused_losses_bwd(
        *args, hs, dlast, torch.tensor([0.7, 1.3]), leak=leak)
    assert len(got) == len(diff) == 12
    for i, g in zip(diff, got):
        assert_grad_close(g.numpy(), leaf[i].grad.numpy(), str(i))
    # without autograd the forward saves no trajectory
    assert decoder_kernel.rnn_decoder_fused_losses_fwd(
        *args, leak=leak, save=False)[3] is None


def test_rnn_decoder_wrapper_rejects_what_the_kernel_does_not_take(rng):
    args = [torch.from_numpy(a)
            for a in _kernel_args(rng, 4, 3, 2, 3, 2, 2, [4, 1, 0])]
    call = decoder_kernel.rnn_decoder_fused_losses_fwd
    call(*args)
    for i, bad, err, match in (
            (1, args[1].long(), TypeError, "lengths"),
            (2, torch.zeros(3, 3 * 3 + 4), ValueError, "w_cat"),  # GRU's
            (3, torch.zeros(9), ValueError, "bias"),
            (14, args[14].t().contiguous().t(), ValueError, "contiguous")):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(err, match=match):
            call(*wrong)
    with pytest.raises(TypeError, match="arguments"):
        call(*args, args[14])                            # an LSTM c0
    with pytest.raises(ValueError, match="leak"):
        call(*args, leak=0.0)
