"""Masked GRU layers, forward and backward: the CUDA kernels of
``csrc/gru.cu`` and their plain PyTorch twins.

- ``gru_layer_bidir_fused`` replaces
  seq2seq_abcd_vae_tpu/ops/gru_pallas.py:gru_layer_bidir_fused, forward
  (``_fwdf_call`` / ``_fwdf_kernel``) and backward (``_bwdf_call`` /
  ``_bwdf_kernel``): both directions of one layer over RAW inputs, the
  input projection x_t @ W_ih run per step inside the kernel, direction 1
  reading time reversed.
- ``gru_layer`` replaces seq2seq_abcd_vae_tpu/ops/gru_pallas.py:gru_layer,
  forward (``_fwd_call`` / ``_fwd_kernel``) and backward (``_bwd_call`` /
  ``_bwd_kernel``): one direction over a precomputed xp = x @ W_ih + b_ih,
  with ``reverse`` selecting the flipped span [T - len, T).

torch's GRU semantics, gate order (r, z, n):

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

so b_hh stays apart from b_ih.  A row's h is frozen outside its span and
``outs`` holds the masked carry.  The kernels' time loops are sequential
and re-read the weights from L2 every step, which bounds them (see the
source).  The backwards recompute the gates from the saved h trajectory
and leave the weight-gradient sums to ``ops/wgrad.py``; the cotangents of
xp and of h @ W_hh + b_hh differ in their candidate third (``_adjoint``),
so dW_hh is reduced from dxp's first two thirds and a separate stream.
``gru_layer_bidir_fused_train`` and ``gru_layer_train`` wire them into
``torch.autograd``.  Each wrapper launches its kernel for CUDA tensors and
takes its twin only for CPU tensors.  The kernels pick their row tile (8,
4 or 2 rows a block) at launch so that shared memory fits the card
(``_build.row_tile`` raises when even 2 rows do not).

Layouts are the JAX package's: w_ih (2, F, 3H), w_hh (2, H, 3H), b_ih /
b_hh (2, 3H) for the pair, w_hh (H, 3H) and b_hh (3H,) for one direction.
"""

from __future__ import annotations

import torch

from . import _build, wgrad
from .lstm_kernel import _active, _check, _check_layer, _span

# kernel kinds of csrc/gru.cu (abcd_gru_rows)
_FWD, _BWD, _PROJ_FWD, _PROJ_BWD = 0, 1, 2, 3


def gru_step(w_hh: torch.Tensor, b_hh: torch.Tensor, x_proj: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
    """One GRU cell step from a precomputed ``x @ w_ih + b_ih``.

    Works on one direction (h (B, H), w_hh (H, 3H), b_hh (3H,)) or on the
    stacked pair (h (2, B, H), w_hh (2, H, 3H), b_hh (2, 3H)).
    """
    hp = torch.matmul(h, w_hh) + b_hh.unsqueeze(-2)
    xr, xz, xn = x_proj.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    return (1.0 - z) * torch.tanh(xn + r * hn) + z * h


def _adjoint(xp, hp, h_prev, act, dh_t):
    """One step of gru_pallas._gru_adjoint from the step's input and hidden
    pre-activations ``xp`` and ``hp`` (= h_prev @ W_hh + b_hh) and the
    cotangent ``dh_t`` of its masked output.

    Returns (dxp, dhg, dh_prev without its dhg @ W_hh^T term): dxp =
    [drpre, dzpre, dnpre] is the cotangent of xp, dhg = [drpre, dzpre,
    dnpre * r] that of hp.
    """
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn_pre = hp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn_pre)
    dh_step = torch.where(act, dh_t, 0.0)
    dn = dh_step * (1.0 - z)
    dz = dh_step * (h_prev - n)
    dnpre = dn * (1.0 - n * n)
    drpre = dnpre * hn_pre * r * (1.0 - r)
    dzpre = dz * z * (1.0 - z)
    dxp = torch.cat([drpre, dzpre, dnpre], dim=-1)
    dhg = torch.cat([drpre, dzpre, dnpre * r], dim=-1)
    return dxp, dhg, torch.where(act, 0.0, dh_t) + dh_step * z


def gru_layer_bidir_fused_plain(x, lengths, w_ih, b_ih, w_hh, b_hh):
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
        x_proj = torch.matmul(xs[s], w_ih) + b_ih.unsqueeze(-2)
        h = torch.where(active[s], gru_step(w_hh, b_hh, x_proj, h), h)
        outs.append(h)
    return torch.stack(outs), h


def gru_layer_bidir_fused(x, lengths, w_ih, b_ih, w_hh, b_hh):
    """Both directions of one masked GRU layer over raw inputs.

    Args:
      x: (T, B, F) float32, original time order.
      lengths: (B,) int32 valid steps per row.
      w_ih (2, F, 3H), b_ih (2, 3H), w_hh (2, H, 3H), b_hh (2, 3H).

    Returns (outs (T, 2, B, H), h_n (2, B, H)), as
    ``gru_pallas.gru_layer_bidir_fused``.  CUDA tensors launch the kernel
    on the current stream (and count one launch); CPU tensors take
    ``gru_layer_bidir_fused_plain``.
    """
    _check(x, lengths, w_ih, b_ih, w_hh, b_hh, gates=3)
    if x.device.type == "cpu":
        return gru_layer_bidir_fused_plain(x, lengths, w_ih, b_ih, w_hh,
                                           b_hh)
    t, b, f = x.shape
    hidden = w_hh.shape[1]
    lib = _build.load("gru")
    rows = _build.row_tile(lib, "gru", _FWD, (f, hidden),
                           "gru_layer_bidir_fused")
    outs = torch.empty((t, 2, b, hidden), dtype=x.dtype, device=x.device)
    h_n = torch.empty((2, b, hidden), dtype=x.dtype, device=x.device)
    if b == 0:
        return outs, h_n
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_gru_bidir_fwd(
            x.data_ptr(), lengths.data_ptr(), w_ih.data_ptr(),
            b_ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            outs.data_ptr(), h_n.data_ptr(), t, b, f, hidden, rows, stream)
    _build.check(lib, err, "gru_layer_bidir_fused")
    gru_layer_bidir_fused.launches += 1
    return outs, h_n


gru_layer_bidir_fused.launches = 0


def gru_layer_bidir_fused_bwd_plain(x, lengths, w_ih, b_ih, w_hh, b_hh, outs,
                                    douts, dh_n):
    """Plain PyTorch twin of the backward kernel: the explicit
    reverse-time adjoint of ``gru_layer_bidir_fused_plain`` (not autograd
    through it), in the order of operations of gru_pallas._bwdf_kernel
    (``_gru_adjoint``).

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
    dxps, dhgs, hps, dxs = [None] * t, [None] * t, [None] * t, [None] * t
    for s in reversed(range(t)):
        h_prev = outs[s - 1] if s > 0 else zero
        act = active[s]
        xp = torch.matmul(xs[s], w_ih) + b_ih.unsqueeze(-2)
        hp = torch.matmul(h_prev, w_hh) + b_hh.unsqueeze(-2)
        dh_t = dh if douts is None else dh + douts[s]
        dxp, dhg, dh = _adjoint(xp, hp, h_prev, act, dh_t)
        dh = dh + torch.matmul(dhg, w_hh_t)
        dxps[s], dhgs[s], hps[s] = dxp, dhg, h_prev
        dxs[s] = torch.matmul(dxp, w_ih_t)
    dxp, dhg = torch.stack(dxps), torch.stack(dhgs)
    hp, dx_own = torch.stack(hps), torch.stack(dxs)
    dx = dx_own[:, 0] + dx_own[:, 1].flip(0)
    dw_ih = torch.einsum("tdbf,tdbg->dfg", xs, dxp)
    dw_hh = torch.einsum("tdbh,tdbg->dhg", hp, dhg)
    return dx, dw_ih, dxp.sum(dim=(0, 2)), dw_hh, dhg.sum(dim=(0, 2))


def gru_layer_bidir_fused_bwd(x, lengths, w_ih, b_ih, w_hh, b_hh, outs,
                              douts, dh_n):
    """The layer's backward: (dx, dw_ih, db_ih, dw_hh, db_hh).

    CUDA tensors launch the reverse-time kernel, then ``ops/wgrad.py``'s
    reductions of its streams (counted as one launch of this wrapper);
    CPU tensors take ``gru_layer_bidir_fused_bwd_plain``.  ``douts`` may be
    None: the final layer's outs feed nothing, and the kernel then reads no
    (T, 2, B, H) zero stream.
    """
    _check(x, lengths, w_ih, b_ih, w_hh, b_hh, gates=3)
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
        return gru_layer_bidir_fused_bwd_plain(
            x, lengths, w_ih, b_ih, w_hh, b_hh, outs, douts, dh_n)
    lib = _build.load("gru")
    rows = _build.row_tile(lib, "gru", _BWD, (f, hidden),
                           "gru_layer_bidir_fused backward")
    g = 3 * hidden
    w_ih_t = w_ih.transpose(1, 2).contiguous()
    w_hh_t = w_hh.transpose(1, 2).contiguous()
    empty = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
    dxp = empty(2, t, b, g)
    hp = empty(2, t, b, hidden)
    dhn = empty(2, t, b, hidden)
    dx_dir = empty(2, t, b, f)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_gru_bidir_bwd(
            x.data_ptr(), lengths.data_ptr(), w_ih.data_ptr(),
            b_ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            w_ih_t.data_ptr(), w_hh_t.data_ptr(), outs.data_ptr(),
            None if douts is None else douts.data_ptr(), dh_n.data_ptr(),
            dxp.data_ptr(), hp.data_ptr(), dhn.data_ptr(),
            dx_dir.data_ptr(), t, b, f, hidden, rows, stream)
        _build.check(lib, err, "gru_layer_bidir_fused backward")
        dx = wgrad.add2(dx_dir[0], dx_dir[1])
        x_rows = x.view(t * b, f)
        dw_ih, db_ih, dw_hh, db_hh = [], [], [], []
        for d in range(2):
            dxp_d = dxp[d].view(t * b, g)
            hp_d = hp[d].view(t * b, hidden)
            dhn_d = dhn[d].view(t * b, hidden)
            dw_ih.append(wgrad.at_b(x_rows, dxp_d))
            db_ih.append(wgrad.at_b(None, dxp_d).reshape(-1))
            # dhg = [dxp_r, dxp_z, dhn]: its first two thirds are dxp's
            dw_hh.append(torch.cat([wgrad.at_b(hp_d, dxp_d[:, :2 * hidden]),
                                    wgrad.at_b(hp_d, dhn_d)], dim=1))
            db_hh.append(torch.cat([db_ih[d][:2 * hidden],
                                    wgrad.at_b(None, dhn_d).reshape(-1)]))
    gru_layer_bidir_fused_bwd.launches += 1
    return (dx, torch.stack(dw_ih), torch.stack(db_ih), torch.stack(dw_hh),
            torch.stack(db_hh))


gru_layer_bidir_fused_bwd.launches = 0


class _GRUBidirFused(torch.autograd.Function):
    """Forward kernel and backward kernel as one differentiable op;
    ``lengths`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, lengths, w_ih, b_ih, w_hh, b_hh):
        outs, h_n = gru_layer_bidir_fused(x, lengths, w_ih, b_ih, w_hh, b_hh)
        ctx.save_for_backward(x, lengths, w_ih, b_ih, w_hh, b_hh, outs)
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
        dx, dw_ih, db_ih, dw_hh, db_hh = gru_layer_bidir_fused_bwd(
            x, lengths, w_ih, b_ih, w_hh, b_hh, outs, douts, dh_n)
        return dx, None, dw_ih, db_ih, dw_hh, db_hh


def gru_layer_bidir_fused_train(x, lengths, w_ih, b_ih, w_hh, b_hh):
    """``gru_layer_bidir_fused`` with gradients to x and the four weights,
    through the backward kernel (or its twin on the CPU)."""
    return _GRUBidirFused.apply(x, lengths, w_ih, b_ih, w_hh, b_hh)


# ---------------------------------------------------------------------------
# one direction over a precomputed input projection (gru_pallas.gru_layer)
# ---------------------------------------------------------------------------

def gru_layer_plain(xp, lengths, w_hh, b_hh, reverse: bool = False):
    """Plain PyTorch twin of the one-direction forward kernel: same
    signature, same result.  Returns (outs (T, B, H), the masked carry
    after each step, h_n (B, H))."""
    t, b, _ = xp.shape
    hidden = w_hh.shape[0]
    active = _span(t, lengths, reverse, xp.device)
    h = xp.new_zeros((b, hidden))
    outs = []
    for s in range(t):
        h = torch.where(active[s], gru_step(w_hh, b_hh, xp[s], h), h)
        outs.append(h)
    return torch.stack(outs), h


def gru_layer(xp, lengths, w_hh, b_hh, reverse: bool = False):
    """One direction of a masked GRU layer over a projected input.

    Args:
      xp: (T, B, 3H) float32, x @ W_ih + b_ih (time-flipped by the caller
        for the reverse direction).
      lengths: (B,) int32 valid steps per row.
      w_hh (H, 3H), b_hh (3H,) (kept apart from b_ih: it sits inside the
        reset product).
      reverse: active on [T - len, T) instead of [0, len).

    Returns (outs (T, B, H), h_n (B, H)), as ``gru_pallas.gru_layer``.
    CUDA tensors launch the kernel on the current stream (and count one
    launch); CPU tensors take ``gru_layer_plain``.
    """
    _check_layer(xp, lengths, w_hh, b_hh, gates=3)
    if xp.device.type == "cpu":
        return gru_layer_plain(xp, lengths, w_hh, b_hh, reverse)
    t, b, _ = xp.shape
    hidden = w_hh.shape[0]
    lib = _build.load("gru")
    rows = _build.row_tile(lib, "gru", _PROJ_FWD, (0, hidden), "gru_layer")
    outs = torch.empty((t, b, hidden), dtype=xp.dtype, device=xp.device)
    h_n = torch.empty((b, hidden), dtype=xp.dtype, device=xp.device)
    if b == 0:
        return outs, h_n
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_gru_fwd(
            xp.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), outs.data_ptr(), h_n.data_ptr(), t, b, hidden,
            int(reverse), rows, stream)
    _build.check(lib, err, "gru_layer")
    gru_layer.launches += 1
    return outs, h_n


gru_layer.launches = 0


def gru_layer_bwd_plain(xp, lengths, w_hh, b_hh, outs, douts, dh_n,
                        reverse: bool = False):
    """Plain PyTorch twin of the one-direction backward kernel: the
    explicit reverse-time adjoint of ``gru_layer_plain`` (not autograd
    through it), in the order of operations of gru_pallas._bwd_kernel.

    Args as the forward's, plus its saved ``outs`` (T, B, H), ``douts``
    (T, B, H) or None for a zero cotangent, and ``dh_n`` (B, H).  Returns
    (dxp (T, B, 3H), dw_hh (H, 3H), db_hh (3H,)).
    """
    t, b, _ = xp.shape
    hidden = w_hh.shape[0]
    active = _span(t, lengths, reverse, xp.device)
    zero = xp.new_zeros((b, hidden))
    w_hh_t = w_hh.transpose(0, 1)
    dh = dh_n
    dxps, dhgs, hps = [None] * t, [None] * t, [None] * t
    for s in reversed(range(t)):
        h_prev = outs[s - 1] if s > 0 else zero
        hp = torch.matmul(h_prev, w_hh) + b_hh
        dh_t = dh if douts is None else dh + douts[s]
        dxp, dhg, dh = _adjoint(xp[s], hp, h_prev, active[s], dh_t)
        dh = dh + torch.matmul(dhg, w_hh_t)
        dxps[s], dhgs[s], hps[s] = dxp, dhg, h_prev
    dxp, dhg, hp = torch.stack(dxps), torch.stack(dhgs), torch.stack(hps)
    dw_hh = torch.einsum("tbh,tbg->hg", hp, dhg)
    return dxp, dw_hh, dhg.sum(dim=(0, 1))


def gru_layer_bwd(xp, lengths, w_hh, b_hh, outs, douts, dh_n,
                  reverse: bool = False):
    """The one-direction layer's backward: (dxp, dw_hh, db_hh).

    CUDA tensors launch the reverse-time kernel, then ``ops/wgrad.py``'s
    reductions of its streams (counted as one launch of this wrapper): the
    cotangent of h @ W_hh + b_hh is dxp's first two thirds and the kernel's
    dhn stream (dnpre * r), not dxp; CPU tensors take
    ``gru_layer_bwd_plain``.  ``douts`` may be None: the final layer's outs
    feed nothing, and the kernel then reads no (T, B, H) zero stream.
    """
    _check_layer(xp, lengths, w_hh, b_hh, gates=3, outs=outs, douts=douts,
                 dh_n=dh_n)
    if xp.device.type == "cpu":
        return gru_layer_bwd_plain(xp, lengths, w_hh, b_hh, outs, douts,
                                   dh_n, reverse)
    t, b, g = xp.shape
    hidden = w_hh.shape[0]
    lib = _build.load("gru")
    rows = _build.row_tile(lib, "gru", _PROJ_BWD, (0, hidden),
                           "gru_layer backward")
    w_hh_t = w_hh.transpose(0, 1).contiguous()
    dxp = torch.empty((t, b, g), dtype=xp.dtype, device=xp.device)
    hp = torch.empty((t, b, hidden), dtype=xp.dtype, device=xp.device)
    dhn = torch.empty_like(hp)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_gru_bwd(
            xp.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), w_hh_t.data_ptr(), outs.data_ptr(),
            None if douts is None else douts.data_ptr(), dh_n.data_ptr(),
            dxp.data_ptr(), hp.data_ptr(), dhn.data_ptr(), t, b, hidden,
            int(reverse), rows, stream)
        _build.check(lib, err, "gru_layer backward")
        # dhg = [dxp_r, dxp_z, dhn]: its first two thirds are dxp's
        dxp_rz = dxp.view(t * b, g)[:, :2 * hidden]
        hp_rows = hp.view(t * b, hidden)
        dhn_rows = dhn.view(t * b, hidden)
        dw_hh = torch.cat([wgrad.at_b(hp_rows, dxp_rz),
                           wgrad.at_b(hp_rows, dhn_rows)], dim=1)
        db_hh = torch.cat([wgrad.at_b(None, dxp_rz).reshape(-1),
                           wgrad.at_b(None, dhn_rows).reshape(-1)])
    gru_layer_bwd.launches += 1
    return dxp, dw_hh, db_hh


gru_layer_bwd.launches = 0


class _GRULayer(torch.autograd.Function):
    """One-direction forward kernel and backward kernel as one
    differentiable op; ``lengths`` gets no gradient."""

    @staticmethod
    def forward(ctx, xp, lengths, w_hh, b_hh, reverse):
        outs, h_n = gru_layer(xp, lengths, w_hh, b_hh, reverse)
        ctx.save_for_backward(xp, lengths, w_hh, b_hh, outs)
        ctx.reverse = reverse
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
        dxp, dw_hh, db_hh = gru_layer_bwd(xp, lengths, w_hh, b_hh, outs,
                                          douts, dh_n, ctx.reverse)
        return dxp, None, dw_hh, db_hh, None


def gru_layer_train(xp, lengths, w_hh, b_hh, reverse: bool = False):
    """``gru_layer`` with gradients to xp, w_hh and b_hh, through the
    backward kernel (or its twin on the CPU)."""
    return _GRULayer.apply(xp, lengths, w_hh, b_hh, reverse)
