"""The two-direction LSTM layer over a projected input of the PyTorch port
(``ops/lstm_kernel.lstm_layer_bidir``, the public function of the CUDA
kernel, which takes its twin on the CPU) against the Pallas kernel
``lstm_pallas.lstm_layer_bidir`` in interpret mode: the forward, and the
gradients through the port's backward against ``jax.grad`` through the
Pallas custom VJP; the backward twin against torch autograd through the
forward twin; the wrapper's refusals.  Rows of full length, short rows and
an empty row."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.ops import lstm_pallas
from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel
from torch_port_fixtures import few_torch_threads_fixture, reference_jit

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

# float32 sums in another order: values within 1e-5; gradients within 1e-4
# of each leaf's largest magnitude
ATOL = 1e-5
FRACTION = 1e-4
T, B, H = 7, 4, 6
LENS = np.asarray([7, 3, 0, 1], np.int32)   # full, short, empty, one step


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close_to_scale(got, want, name, fraction=FRACTION):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= fraction * max(np.abs(want).max(), 1e-12), (name, err)


def _inputs(rng):
    xp = rng.normal(size=(T, 2, B, 4 * H)).astype(np.float32)
    w_hh = rng.uniform(-0.4, 0.4, size=(2, H, 4 * H)).astype(np.float32)
    b_hh = rng.uniform(-0.4, 0.4, size=(2, 4 * H)).astype(np.float32)
    w_out = rng.normal(size=(H, 3)).astype(np.float32)
    return xp, w_hh, b_hh, w_out


def _loss(outs, h_n, c_n, w, with_outs, tanh, sin, s):
    out_term = s(tanh(outs @ w)) if with_outs else 0.0
    return out_term + s(h_n * h_n) + s(sin(c_n))


@pytest.mark.parametrize("with_outs", [False, True])
def test_lstm_layer_bidir_matches_pallas_interpret(rng, with_outs):
    """outs, h_n and c_n against the interpret-mode kernel; the gradients
    to xp, w_hh and b_hh through the port's autograd Function against
    jax.grad through the kernel's custom VJP.  Without outs in the loss the
    outs cotangent is None."""
    xp, w_hh, b_hh, w_out = _inputs(rng)

    def jax_loss(xp_, w_, b_):
        outs, h_n, c_n = lstm_pallas.lstm_layer_bidir(
            xp_, jnp.asarray(LENS), w_, b_, interpret=True)
        return _loss(outs, h_n, c_n, jnp.asarray(w_out), with_outs, jnp.tanh,
                     jnp.sin, jnp.sum), (outs, h_n, c_n)

    with jax.default_matmul_precision("highest"):
        (want_loss, want), want_grads = reference_jit(jax.value_and_grad(
            jax_loss, argnums=(0, 1, 2), has_aux=True))(
                jnp.asarray(xp), jnp.asarray(w_hh), jnp.asarray(b_hh))
    got = lstm_kernel.lstm_layer_bidir(t(xp), torch.from_numpy(LENS),
                                       t(w_hh), t(b_hh))
    for g, w, name in zip(got, want, ("outs", "h_n", "c_n")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=name)
    # the empty row's carries stay zero; a short row's h is held, not
    # zeroed, through its inactive steps
    assert not got[0][:, :, 2].any()
    np.testing.assert_array_equal(got[0][-1, 0, 1].numpy(),
                                  got[0][2, 0, 1].numpy())
    args = [t(a).requires_grad_(True) for a in (xp, w_hh, b_hh)]
    outs, h_n, c_n = lstm_kernel.lstm_layer_bidir_train(
        args[0], torch.from_numpy(LENS), args[1], args[2])
    loss = _loss(outs, h_n, c_n, t(w_out), with_outs, torch.tanh, torch.sin,
                 torch.sum)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    for a, w, name in zip(args, want_grads, ("dxp", "dw_hh", "db_hh")):
        close_to_scale(a.grad.numpy(), w, name)


def test_lstm_layer_bidir_backward_twin_matches_autograd(rng):
    """The explicit adjoint (``lstm_layer_bidir_bwd``, its twin on the CPU)
    against torch autograd through the forward twin, with cotangents on
    outs, h_n and c_n, and with none on outs."""
    xp, w_hh, b_hh, _ = _inputs(rng)
    lens = torch.from_numpy(LENS)
    outs, h_n, c_n, cs = lstm_kernel.lstm_layer_bidir(
        t(xp), lens, t(w_hh), t(b_hh), return_cs=True)
    douts = t(rng.normal(size=outs.shape))
    dh_n, dc_n = (t(rng.normal(size=h_n.shape)) for _ in range(2))
    for cot in (douts, None):
        args = [t(a).requires_grad_(True) for a in (xp, w_hh, b_hh)]
        ref = lstm_kernel.lstm_layer_bidir_plain(args[0], lens, *args[1:])
        torch.autograd.backward(
            ref[1:] if cot is None else ref,
            (dh_n, dc_n) if cot is None else (cot, dh_n, dc_n))
        got = lstm_kernel.lstm_layer_bidir_bwd(t(xp), lens, t(w_hh),
                                               t(b_hh), outs, cs, cot, dh_n,
                                               dc_n)
        for g, a, name in zip(got, args, ("dxp", "dw_hh", "db_hh")):
            assert g.shape == a.shape, name
            close_to_scale(g.numpy(), a.grad.numpy(), name, 1e-5)


def test_lstm_layer_bidir_wrapper_rejects_what_the_kernel_does_not_take():
    xp, w, b = torch.zeros(3, 2, 2, 8), torch.zeros(2, 2, 8), torch.zeros(2, 8)
    lens = torch.tensor([3, 0], dtype=torch.int32)
    outs, h_n, c_n = lstm_kernel.lstm_layer_bidir(xp, lens, w, b)
    assert outs.shape == (3, 2, 2, 2) and h_n.shape == c_n.shape == (2, 2, 2)
    for bad in ((xp, lens.long(), w, b), (xp.double(), lens, w, b),
                (xp[:, :1], lens, w, b), (xp, lens, w[0], b),
                (xp.transpose(1, 2), lens, w, b), (xp, lens, w, b[0])):
        with pytest.raises(ValueError):
            lstm_kernel.lstm_layer_bidir(*bad)
    zeros = torch.zeros(3, 2, 2, 2)
    with pytest.raises(ValueError, match="cs"):
        lstm_kernel.lstm_layer_bidir_bwd(xp, lens, w, b, zeros, zeros[:2],
                                         None, h_n, c_n)
