"""Fused bidirectional LSTM layer of the PyTorch port against the JAX
package: the CUDA kernel's plain twin (what the wrapper runs on CPU
tensors) held to the Pallas kernel in interpret mode and to the
lax.scan path, plus the wrapper's argument checks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.models import initializers as jax_init
from seq2seq_abcd_vae_tpu.models import rnn as jax_rnn
from seq2seq_abcd_vae_tpu.ops import lstm_pallas
from seq2seq_abcd_vae_tpu_torch.models import rnn as port_rnn
from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel
from torch_port_fixtures import one_step_scans, reference_jit

# float32 dot products of F + H terms per gate summed in another order,
# carried through at most 13 recurrent steps (the JAX package holds its
# own kernel to its scan with the same bound, tests/test_lstm_pallas.py)
TOL = dict(rtol=1e-5, atol=1e-6)

CASES = {  # (T, F, H, lengths): full, partial, one-step and empty rows
    "small": (7, 5, 8, [7, 5, 3, 1]),
    "wider": (13, 9, 16, [13, 0, 6, 12, 2]),
}


def _layer(rng, t, f, h, lengths, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed))
    p_fwd = jax_init.rnn_gate_params(keys[0], f, h, 4)
    p_bwd = jax_init.rnn_gate_params(keys[1], f, h, 4)
    x = rng.normal(size=(len(lengths), t, f)).astype(np.float32)
    return p_fwd, p_bwd, x, np.asarray(lengths, np.int32)


def _stacked(p_fwd, p_bwd):
    return {k: torch.from_numpy(np.stack([np.asarray(p_fwd[k]),
                                          np.asarray(p_bwd[k])]))
            for k in ("w_ih", "b_ih", "w_hh", "b_hh")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_pallas_kernel_interpret(rng, case):
    t, f, h, lengths = CASES[case]
    p_fwd, p_bwd, x, lens = _layer(rng, t, f, h, lengths)
    w = _stacked(p_fwd, p_bwd)
    x_t = np.ascontiguousarray(np.swapaxes(x, 0, 1))
    with jax.default_matmul_precision("highest"):
        want = reference_jit(
            lambda *a: lstm_pallas.lstm_layer_bidir_fused(
                *a, interpret=True, precision=jax.lax.Precision.HIGHEST))(
                    jnp.asarray(x_t), jnp.asarray(lens),
                    *(jnp.asarray(w[k].numpy())
                      for k in ("w_ih", "b_ih", "w_hh", "b_hh")))
    got = lstm_kernel.lstm_layer_bidir_fused(
        torch.from_numpy(x_t), torch.from_numpy(lens), w["w_ih"], w["b_ih"],
        w["w_hh"], w["b_hh"])
    for g, ref, name in zip(got, want, ("outs", "h_n", "c_n")):
        assert tuple(g.shape) == ref.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax_scan(rng, monkeypatch, case):
    """models/rnn.run_rnn_layer_bidir against the JAX function on its scan
    path (the encoder backend forced without touching the JAX selector)."""
    monkeypatch.setenv("SEQ2SEQ_ENCODER_BACKEND", "scan")
    one_step_scans(monkeypatch)
    t, f, h, lengths = CASES[case]
    p_fwd, p_bwd, x, lens = _layer(rng, t, f, h, lengths, seed=1)
    with jax.default_matmul_precision("highest"):
        mask = jax_rnn.lengths_to_mask(jnp.asarray(lens), t)
        want_f, want_b, want_fin = reference_jit(
            lambda *a: jax_rnn.run_rnn_layer_bidir("LSTM", *a))(
                p_fwd, p_bwd, jnp.asarray(x), mask)
    port_mask = port_rnn.lengths_to_mask(torch.from_numpy(lens), t)
    np.testing.assert_array_equal(port_mask.numpy(), np.asarray(mask))
    got_f, got_b, got_fin = port_rnn.run_rnn_layer_bidir(
        _stacked(p_fwd, p_bwd), torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **TOL)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **TOL)
    for (gh, gc), (wh, wc) in zip(got_fin, want_fin):
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **TOL)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **TOL)


def test_lstm_step_matches_jax(rng):
    params = jax_init.rnn_gate_params(jax.random.PRNGKey(2), 5, 8, 4)
    xp = rng.normal(size=(3, 32)).astype(np.float32)
    h = rng.normal(size=(3, 8)).astype(np.float32)
    c = rng.normal(size=(3, 8)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax_rnn.lstm_step(params, jnp.asarray(xp), jnp.asarray(h),
                                 jnp.asarray(c))
    got = port_rnn.lstm_step(torch.from_numpy(np.array(params["w_hh"])),
                             torch.from_numpy(np.array(params["b_hh"])),
                             torch.from_numpy(xp), torch.from_numpy(h),
                             torch.from_numpy(c))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    p_fwd, p_bwd, x, lens = _layer(rng, 4, 3, 8, [4, 2])
    w = _stacked(p_fwd, p_bwd)
    x_t = torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 0, 1)))
    lengths = torch.from_numpy(lens)
    call = lstm_kernel.lstm_layer_bidir_fused
    with pytest.raises(ValueError, match="int32"):
        call(x_t, lengths.long(), w["w_ih"], w["b_ih"], w["w_hh"],
             w["b_hh"])
    with pytest.raises(TypeError):
        call(x_t.double(), lengths, w["w_ih"], w["b_ih"], w["w_hh"],
             w["b_hh"])
    with pytest.raises(ValueError, match="shape"):
        call(x_t, lengths, w["w_ih"][:, :2].contiguous(), w["b_ih"],
             w["w_hh"], w["b_hh"])
    with pytest.raises(ValueError, match="contiguous"):
        call(x_t.transpose(0, 1).contiguous().transpose(0, 1), lengths,
             w["w_ih"], w["b_ih"], w["w_hh"], w["b_hh"])
