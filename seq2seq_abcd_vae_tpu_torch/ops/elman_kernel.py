"""Masked Elman (tanh RNN) layers, forward and backward: the CUDA kernels
of ``csrc/elman.cu`` and their plain PyTorch twins; with a leak below 1
and zero biases they are the echo-state (ESN) layers.

- ``rnn_layer_bidir_fused`` replaces
  seq2seq_abcd_vae_tpu/ops/elman_pallas.py:rnn_layer_bidir_fused, forward
  (``_fwdf_call`` / ``_fwdf_kernel``) and backward (``_bwdf_call`` /
  ``_bwdf_kernel``): both directions of one layer over RAW inputs, the
  input projection x_t @ W_ih run per step inside the kernel, direction 1
  reading time reversed.
- ``rnn_layer`` replaces seq2seq_abcd_vae_tpu/ops/elman_pallas.py:rnn_layer,
  forward (``_fwd_call`` / ``_fwd_kernel``) and backward (``_bwd_call`` /
  ``_bwd_kernel``): one direction over a precomputed xp = x @ W_ih + b_ih
  (the ESN's x @ W_ih), with ``reverse`` selecting the flipped span
  [T - len, T).

torch.nn.RNN's tanh cell, generalised by the ESN's leak (reference
ABCD-VAE/modules/model.py:444,529-531):

    u  = tanh(x W_ih + b_ih + h W_hh + b_hh)
    h' = (1 - leak) h + leak u

``leak`` is a runtime float; at 1.0 the update is exactly h' = u (the
plain Elman cell), since (1 - 1) h adds a zero for every finite h.  A
row's h is frozen outside its span and ``outs`` holds the masked carry.
The kernels' time loops are sequential and re-read the weights from L2
every step, which bounds them (see the source).  The backwards recompute u
from the saved h trajectory and leave the weight-gradient sums to
``ops/wgrad.py``; b_ih and b_hh get the same gradient, since both add to
the same pre-activation.  ``rnn_layer_bidir_fused_train`` and
``rnn_layer_train`` wire them into ``torch.autograd``.  Each wrapper
launches its kernel for CUDA tensors and takes its twin only for CPU
tensors.  The kernels pick their row tile (8, 4 or 2 rows a block) at
launch so that shared memory fits the card (``_build.row_tile`` raises
when even 2 rows do not).

Layouts are the JAX package's: w_ih (2, F, H), w_hh (2, H, H), b_ih /
b_hh (2, H) for the pair, w_hh (H, H) and b_hh (H,) for one direction.
"""

from __future__ import annotations

import torch

from . import _build, wgrad
from .lstm_kernel import _active, _check, _check_layer, _span

# kernel kinds of csrc/elman.cu (abcd_elman_rows)
_FWD, _BWD, _PROJ_FWD, _PROJ_BWD = 0, 1, 2, 3


def _check_leak(leak) -> float:
    leak = float(leak)
    if not 0.0 < leak <= 1.0:
        raise ValueError(f"leak must lie in (0, 1], got {leak}")
    return leak


def rnn_layer_bidir_fused_plain(x, lengths, w_ih, b_ih, w_hh, b_hh,
                                leak=1.0):
    """Plain PyTorch twin of the forward kernel: same signature, same
    result.  Returns (outs (T, 2, B, H) with direction 1 in its own
    flipped time, h_n (2, B, H))."""
    t, b, _ = x.shape
    hidden = w_hh.shape[1]
    xs = torch.stack([x, x.flip(0)], dim=1)                  # (T, 2, B, F)
    active = _active(t, lengths, x.device)                   # (T, 2, B, 1)
    h = x.new_zeros((2, b, hidden))
    outs = []
    for s in range(t):
        pre = ((torch.matmul(xs[s], w_ih) + b_ih.unsqueeze(-2))
               + torch.matmul(h, w_hh)) + b_hh.unsqueeze(-2)
        h2 = (1.0 - leak) * h + leak * torch.tanh(pre)
        h = torch.where(active[s], h2, h)
        outs.append(h)
    return torch.stack(outs), h


def rnn_layer_bidir_fused(x, lengths, w_ih, b_ih, w_hh, b_hh, leak=1.0):
    """Both directions of one masked Elman (or ESN) layer over raw inputs.

    Args:
      x: (T, B, F) float32, original time order.
      lengths: (B,) int32 valid steps per row.
      w_ih (2, F, H), b_ih (2, H), w_hh (2, H, H), b_hh (2, H).
      leak: in (0, 1]; 1.0 is the Elman cell, below 1 the ESN's (pass zero
        biases for the ESN, which has none).

    Returns (outs (T, 2, B, H), h_n (2, B, H)), as
    ``elman_pallas.rnn_layer_bidir_fused``.  CUDA tensors launch the kernel
    on the current stream (and count one launch); CPU tensors take
    ``rnn_layer_bidir_fused_plain``.
    """
    _check(x, lengths, w_ih, b_ih, w_hh, b_hh, gates=1)
    leak = _check_leak(leak)
    if x.device.type == "cpu":
        return rnn_layer_bidir_fused_plain(x, lengths, w_ih, b_ih, w_hh,
                                           b_hh, leak)
    t, b, f = x.shape
    hidden = w_hh.shape[1]
    lib = _build.load("elman")
    rows = _build.row_tile(lib, "elman", _FWD, (f, hidden),
                           "rnn_layer_bidir_fused")
    outs = torch.empty((t, 2, b, hidden), dtype=x.dtype, device=x.device)
    h_n = torch.empty((2, b, hidden), dtype=x.dtype, device=x.device)
    if b == 0:
        return outs, h_n
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_elman_bidir_fwd(
            x.data_ptr(), lengths.data_ptr(), w_ih.data_ptr(),
            b_ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            outs.data_ptr(), h_n.data_ptr(), t, b, f, hidden, leak, rows,
            stream)
    _build.check(lib, err, "rnn_layer_bidir_fused")
    rnn_layer_bidir_fused.launches += 1
    return outs, h_n


rnn_layer_bidir_fused.launches = 0


def rnn_layer_bidir_fused_bwd_plain(x, lengths, w_ih, b_ih, w_hh, b_hh, outs,
                                    douts, dh_n, leak=1.0):
    """Plain PyTorch twin of the backward kernel: the explicit
    reverse-time adjoint of ``rnn_layer_bidir_fused_plain`` (not autograd
    through it), in the order of operations of elman_pallas._bwdf_kernel.

    Args as the forward's, plus its saved ``outs`` (T, 2, B, H), ``douts``
    (T, 2, B, H) or None for a zero cotangent, and ``dh_n`` (2, B, H).
    Returns (dx (T, B, F), dw_ih, db_ih, dw_hh, db_hh) in the weights'
    layouts.
    """
    t, b, _ = x.shape
    hidden = w_hh.shape[1]
    xs = torch.stack([x, x.flip(0)], dim=1)                  # (T, 2, B, F)
    active = _active(t, lengths, x.device)
    zero = x.new_zeros((2, b, hidden))
    w_ih_t, w_hh_t = w_ih.transpose(1, 2), w_hh.transpose(1, 2)
    dh = dh_n
    dpres, hps, dxs = [None] * t, [None] * t, [None] * t
    for s in reversed(range(t)):
        h_prev = outs[s - 1] if s > 0 else zero
        act = active[s]
        pre = ((torch.matmul(xs[s], w_ih) + b_ih.unsqueeze(-2))
               + torch.matmul(h_prev, w_hh)) + b_hh.unsqueeze(-2)
        u = torch.tanh(pre)
        dh_t = dh if douts is None else dh + douts[s]
        dh2 = torch.where(act, dh_t, 0.0)
        dpre = (leak * dh2) * (1.0 - u * u)
        dh = ((torch.where(act, 0.0, dh_t) + (1.0 - leak) * dh2)
              + torch.matmul(dpre, w_hh_t))
        dpres[s], hps[s] = dpre, h_prev
        dxs[s] = torch.matmul(dpre, w_ih_t)
    dpre, hp, dx_own = torch.stack(dpres), torch.stack(hps), torch.stack(dxs)
    dx = dx_own[:, 0] + dx_own[:, 1].flip(0)
    dw_ih = torch.einsum("tdbf,tdbg->dfg", xs, dpre)
    dw_hh = torch.einsum("tdbh,tdbg->dhg", hp, dpre)
    db = dpre.sum(dim=(0, 2))
    return dx, dw_ih, db, dw_hh, db.clone()


def rnn_layer_bidir_fused_bwd(x, lengths, w_ih, b_ih, w_hh, b_hh, outs,
                              douts, dh_n, leak=1.0):
    """The layer's backward: (dx, dw_ih, db_ih, dw_hh, db_hh).

    CUDA tensors launch the reverse-time kernel, then ``ops/wgrad.py``'s
    reductions of its streams (counted as one launch of this wrapper);
    CPU tensors take ``rnn_layer_bidir_fused_bwd_plain``.  ``douts`` may be
    None: the final layer's outs feed nothing, and the kernel then reads no
    (T, 2, B, H) zero stream.
    """
    _check(x, lengths, w_ih, b_ih, w_hh, b_hh, gates=1)
    leak = _check_leak(leak)
    t, b, f = x.shape
    hidden = w_hh.shape[1]
    state = (t, 2, b, hidden)
    for name, tensor, shape in (("outs", outs, state),
                                ("douts", douts, state),
                                ("dh_n", dh_n, state[1:])):
        if tensor is None and name == "douts":
            continue
        if (tuple(tensor.shape) != shape or tensor.dtype != torch.float32
                or tensor.device != x.device or not tensor.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{x.device}")
    if x.device.type == "cpu":
        return rnn_layer_bidir_fused_bwd_plain(
            x, lengths, w_ih, b_ih, w_hh, b_hh, outs, douts, dh_n, leak)
    lib = _build.load("elman")
    rows = _build.row_tile(lib, "elman", _BWD, (f, hidden),
                           "rnn_layer_bidir_fused backward")
    w_ih_t = w_ih.transpose(1, 2).contiguous()
    w_hh_t = w_hh.transpose(1, 2).contiguous()
    empty = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
    dpre = empty(2, t, b, hidden)
    hp = empty(2, t, b, hidden)
    dx_dir = empty(2, t, b, f)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_elman_bidir_bwd(
            x.data_ptr(), lengths.data_ptr(), w_ih.data_ptr(),
            b_ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            w_ih_t.data_ptr(), w_hh_t.data_ptr(), outs.data_ptr(),
            None if douts is None else douts.data_ptr(), dh_n.data_ptr(),
            dpre.data_ptr(), hp.data_ptr(), dx_dir.data_ptr(), t, b, f,
            hidden, leak, rows, stream)
        _build.check(lib, err, "rnn_layer_bidir_fused backward")
        dx = wgrad.add2(dx_dir[0], dx_dir[1])
        x_rows = x.view(t * b, f)
        dw_ih, db, dw_hh = [], [], []
        for d in range(2):
            dpre_d = dpre[d].view(t * b, hidden)
            dw_ih.append(wgrad.at_b(x_rows, dpre_d))
            db.append(wgrad.at_b(None, dpre_d).reshape(-1))
            dw_hh.append(wgrad.at_b(hp[d].view(t * b, hidden), dpre_d))
    rnn_layer_bidir_fused_bwd.launches += 1
    db = torch.stack(db)
    return dx, torch.stack(dw_ih), db, torch.stack(dw_hh), db.clone()


rnn_layer_bidir_fused_bwd.launches = 0


class _ElmanBidirFused(torch.autograd.Function):
    """Forward kernel and backward kernel as one differentiable op;
    ``lengths`` and ``leak`` get no gradient."""

    @staticmethod
    def forward(ctx, x, lengths, w_ih, b_ih, w_hh, b_hh, leak):
        outs, h_n = rnn_layer_bidir_fused(x, lengths, w_ih, b_ih, w_hh, b_hh,
                                          leak)
        ctx.save_for_backward(x, lengths, w_ih, b_ih, w_hh, b_hh, outs)
        ctx.leak = leak
        # an unused output (the final layer's outs) arrives as None, and
        # the backward kernel then reads no zero stream
        ctx.set_materialize_grads(False)
        return outs, h_n

    @staticmethod
    def backward(ctx, douts, dh_n):
        x, lengths, w_ih, b_ih, w_hh, b_hh, outs = ctx.saved_tensors
        dh_n = (outs.new_zeros(outs.shape[1:]) if dh_n is None
                else dh_n.contiguous())
        douts = None if douts is None else douts.contiguous()
        dx, dw_ih, db_ih, dw_hh, db_hh = rnn_layer_bidir_fused_bwd(
            x, lengths, w_ih, b_ih, w_hh, b_hh, outs, douts, dh_n, ctx.leak)
        return dx, None, dw_ih, db_ih, dw_hh, db_hh, None


def rnn_layer_bidir_fused_train(x, lengths, w_ih, b_ih, w_hh, b_hh,
                                leak=1.0):
    """``rnn_layer_bidir_fused`` with gradients to x and the four weights,
    through the backward kernel (or its twin on the CPU)."""
    return _ElmanBidirFused.apply(x, lengths, w_ih, b_ih, w_hh, b_hh,
                                  _check_leak(leak))


# ---------------------------------------------------------------------------
# one direction over a precomputed input projection (elman_pallas.rnn_layer)
# ---------------------------------------------------------------------------

def rnn_layer_plain(xp, lengths, w_hh, b_hh, reverse: bool = False,
                    leak=1.0):
    """Plain PyTorch twin of the one-direction forward kernel: same
    signature, same result.  Returns (outs (T, B, H), the masked carry
    after each step, h_n (B, H))."""
    t, b, _ = xp.shape
    hidden = w_hh.shape[0]
    active = _span(t, lengths, reverse, xp.device)
    h = xp.new_zeros((b, hidden))
    outs = []
    for s in range(t):
        u = torch.tanh((xp[s] + torch.matmul(h, w_hh)) + b_hh)
        h = torch.where(active[s], (1.0 - leak) * h + leak * u, h)
        outs.append(h)
    return torch.stack(outs), h


def rnn_layer(xp, lengths, w_hh, b_hh, reverse: bool = False, leak=1.0):
    """One direction of a masked Elman (or ESN) layer over a projected
    input.

    Args:
      xp: (T, B, H) float32, x @ W_ih + b_ih (the ESN's x @ W_ih),
        time-flipped by the caller for the reverse direction.
      lengths: (B,) int32 valid steps per row.
      w_hh (H, H), b_hh (H,) (zeros for the ESN).
      reverse: active on [T - len, T) instead of [0, len).
      leak: in (0, 1]; 1.0 is the Elman cell, below 1 the ESN's.

    Returns (outs (T, B, H), h_n (B, H)), as ``elman_pallas.rnn_layer``.
    CUDA tensors launch the kernel on the current stream (and count one
    launch); CPU tensors take ``rnn_layer_plain``.
    """
    _check_layer(xp, lengths, w_hh, b_hh, gates=1)
    leak = _check_leak(leak)
    if xp.device.type == "cpu":
        return rnn_layer_plain(xp, lengths, w_hh, b_hh, reverse, leak)
    t, b, _ = xp.shape
    hidden = w_hh.shape[0]
    lib = _build.load("elman")
    rows = _build.row_tile(lib, "elman", _PROJ_FWD, (0, hidden), "rnn_layer")
    outs = torch.empty((t, b, hidden), dtype=xp.dtype, device=xp.device)
    h_n = torch.empty((b, hidden), dtype=xp.dtype, device=xp.device)
    if b == 0:
        return outs, h_n
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_elman_fwd(
            xp.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), outs.data_ptr(), h_n.data_ptr(), t, b, hidden,
            leak, int(reverse), rows, stream)
    _build.check(lib, err, "rnn_layer")
    rnn_layer.launches += 1
    return outs, h_n


rnn_layer.launches = 0


def rnn_layer_bwd_plain(xp, lengths, w_hh, b_hh, outs, douts, dh_n,
                        reverse: bool = False, leak=1.0):
    """Plain PyTorch twin of the one-direction backward kernel: the
    explicit reverse-time adjoint of ``rnn_layer_plain`` (not autograd
    through it), in the order of operations of elman_pallas._bwd_kernel.

    Args as the forward's, plus its saved ``outs`` (T, B, H), ``douts``
    (T, B, H) or None for a zero cotangent, and ``dh_n`` (B, H).  Returns
    (dxp (T, B, H), dw_hh (H, H), db_hh (H,)).
    """
    t, b, _ = xp.shape
    hidden = w_hh.shape[0]
    active = _span(t, lengths, reverse, xp.device)
    zero = xp.new_zeros((b, hidden))
    w_hh_t = w_hh.transpose(0, 1)
    dh = dh_n
    dpres, hps = [None] * t, [None] * t
    for s in reversed(range(t)):
        h_prev = outs[s - 1] if s > 0 else zero
        act = active[s]
        u = torch.tanh((xp[s] + torch.matmul(h_prev, w_hh)) + b_hh)
        dh_t = dh if douts is None else dh + douts[s]
        dh2 = torch.where(act, dh_t, 0.0)
        dpre = (leak * dh2) * (1.0 - u * u)
        dh = ((torch.where(act, 0.0, dh_t) + (1.0 - leak) * dh2)
              + torch.matmul(dpre, w_hh_t))
        dpres[s], hps[s] = dpre, h_prev
    dpre, hp = torch.stack(dpres), torch.stack(hps)
    dw_hh = torch.einsum("tbh,tbg->hg", hp, dpre)
    return dpre, dw_hh, dpre.sum(dim=(0, 1))


def rnn_layer_bwd(xp, lengths, w_hh, b_hh, outs, douts, dh_n,
                  reverse: bool = False, leak=1.0):
    """The one-direction layer's backward: (dxp, dw_hh, db_hh).

    CUDA tensors launch the reverse-time kernel, then ``ops/wgrad.py``'s
    reductions of its streams (counted as one launch of this wrapper); CPU
    tensors take ``rnn_layer_bwd_plain``.  ``douts`` may be None: the final
    layer's outs feed nothing, and the kernel then reads no (T, B, H) zero
    stream.
    """
    _check_layer(xp, lengths, w_hh, b_hh, gates=1, outs=outs, douts=douts,
                 dh_n=dh_n)
    leak = _check_leak(leak)
    if xp.device.type == "cpu":
        return rnn_layer_bwd_plain(xp, lengths, w_hh, b_hh, outs, douts,
                                   dh_n, reverse, leak)
    t, b, _ = xp.shape
    hidden = w_hh.shape[0]
    lib = _build.load("elman")
    rows = _build.row_tile(lib, "elman", _PROJ_BWD, (0, hidden),
                           "rnn_layer backward")
    w_hh_t = w_hh.transpose(0, 1).contiguous()
    dxp = torch.empty((t, b, hidden), dtype=xp.dtype, device=xp.device)
    hp = torch.empty_like(dxp)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_elman_bwd(
            xp.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), w_hh_t.data_ptr(), outs.data_ptr(),
            None if douts is None else douts.data_ptr(), dh_n.data_ptr(),
            dxp.data_ptr(), hp.data_ptr(), t, b, hidden, leak, int(reverse),
            rows, stream)
        _build.check(lib, err, "rnn_layer backward")
        rows_dp = dxp.view(t * b, hidden)
        dw_hh = wgrad.at_b(hp.view(t * b, hidden), rows_dp)
        db_hh = wgrad.at_b(None, rows_dp).reshape(-1)
    rnn_layer_bwd.launches += 1
    return dxp, dw_hh, db_hh


rnn_layer_bwd.launches = 0


class _ElmanLayer(torch.autograd.Function):
    """One-direction forward kernel and backward kernel as one
    differentiable op; ``lengths``, ``reverse`` and ``leak`` get no
    gradient."""

    @staticmethod
    def forward(ctx, xp, lengths, w_hh, b_hh, reverse, leak):
        outs, h_n = rnn_layer(xp, lengths, w_hh, b_hh, reverse, leak)
        ctx.save_for_backward(xp, lengths, w_hh, b_hh, outs)
        ctx.reverse, ctx.leak = reverse, leak
        # an unused output (a final layer's outs) arrives as None, and the
        # backward kernel then reads no zero stream
        ctx.set_materialize_grads(False)
        return outs, h_n

    @staticmethod
    def backward(ctx, douts, dh_n):
        xp, lengths, w_hh, b_hh, outs = ctx.saved_tensors
        dh_n = (outs.new_zeros(outs.shape[1:]) if dh_n is None
                else dh_n.contiguous())
        douts = None if douts is None else douts.contiguous()
        dxp, dw_hh, db_hh = rnn_layer_bwd(xp, lengths, w_hh, b_hh, outs,
                                          douts, dh_n, ctx.reverse, ctx.leak)
        return dxp, None, dw_hh, db_hh, None, None


def rnn_layer_train(xp, lengths, w_hh, b_hh, reverse: bool = False,
                    leak=1.0):
    """``rnn_layer`` with gradients to xp, w_hh and b_hh, through the
    backward kernel (or its twin on the CPU)."""
    return _ElmanLayer.apply(xp, lengths, w_hh, b_hh, reverse,
                             _check_leak(leak))
