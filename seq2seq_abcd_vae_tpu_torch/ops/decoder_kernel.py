"""The decoder's sampled time loop: the CUDA kernels of
``csrc/decoder.cu`` and their plain PyTorch twins.

Replaces seq2seq_abcd_vae_tpu/ops/decoder_pallas.py:
decoder_loop_fused_losses (``_fused_fwd_call`` / ``_fused_fwd_kernel``,
``_fused_bwd_call`` / ``_fused_bwd_kernel``, with_offset=True),
gru_decoder_loop_fused_losses (``_gru_floss_fwd_call`` /
``_gru_floss_bwd_call``), for which see
:func:`gru_decoder_loop_fused_losses`, rnn_decoder_loop_fused_losses
(``_rnn_floss_fwd_call`` / ``_rnn_floss_bwd_call``), for which see
:func:`rnn_decoder_loop_fused_losses`; the plain sampled loops
decoder_loop (``_fwd_call`` / ``_bwd_call``), gru_decoder_loop
(``_gru_fwd_call`` / ``_gru_bwd_call``) and rnn_decoder_loop
(``_rnn_fwd_call`` / ``_rnn_bwd_call``), forward and backward, for which
see :func:`decoder_loop`, :func:`gru_decoder_loop` and
:func:`rnn_decoder_loop`; and decoder_loop_fused_nll (the fused-loss
calls with with_offset=False, ``_fused_loop_cvjp``), for which see
:func:`decoder_loop_fused_nll`.  The fused loop
samples its own feedback (zero first input, then the sampled emission of
the previous position with the presampled ``noise``), accumulates the
Gaussian emission NLL of positions 0..T-2 against ``targets`` and the
offset MLP's BCE against (t == len - 1), and returns the last step's
pre-mask h2, from which the caller adds position T-1's emission term.
:func:`decoder_loop_fused_losses` wires both kernels into
``torch.autograd``, as do the sampled loops and the fused-NLL loop theirs;
each wrapper launches its kernel for CUDA tensors and takes its twin only
for CPU tensors.

Arguments, in the JAX function's order and layouts ((in, out) matrices):
noise and targets (T, B, F) position-major; lengths (B,) int32; w_cat
(H, 4H + 2m) = [W_hh | emission lin1]; bias (4H,) = b_ih + b_hh; b1 (2m,);
w2m, w2v (m, F); b2 (2F,); w_ih (F, 4H); the offset MLP's wo1 (H, Mo),
bo1 (Mo,), wo2 (Mo,) and bo2 (1,); h0, c0 (B, H).  The GRU loop takes
w_cat (H, 3H + 2m), b_ih and b_hh (3H,) apart (b_hh sits inside the reset
product), w_ih (F, 3H) and h0 alone.  The Elman / ESN loop takes w_cat
(H, H + 2m), bias (H,) = b_ih + b_hh (zeros for the ESN), w_ih (F, H), h0
alone and the leak.

Seed mode (the JAX package's ``SEQ2SEQ_KERNEL_RNG=1``): the three
fused-loss loops also take a (1, 1) float32 seed below 2^24 in place of
the (T, B, F) noise, as the TPU kernels do (``noise.ndim == 2``).  The
kernels then draw each step's noise in-kernel and draw it again, the
same, in the backward; :func:`decoder_noise_dump` (replacing
decoder_pallas.decoder_noise_dump) writes the stream they draw:

    (w0, w1, -, -) = Philox4x32-10(counter = (t, b, f, 0), key = (seed, 0))
    noise[t, b, f] = sqrt(-2 log u1) * cos(2 pi u2),
    u1 = (w0 >> 8) 2^-24 + 2^-25,   u2 = (w1 >> 8) 2^-24

(:func:`philox4x32` is the plain twin of the generator, in int64
arithmetic kept to 32 bits).  This is the port's own stream: the TPU's
bits cannot be had on a GPU.  On CPU tensors the seed mode runs the dump's
twin, then the stream-mode twin; the seed's cotangent is zero.  Seed-mode
launches are counted apart, on each wrapper's ``seed`` counter.
"""

from __future__ import annotations

import math

import torch

from . import _build, wgrad
from .elman_kernel import _check_leak

_LOG_2PI = math.log(2.0 * math.pi)
# kernel kinds of csrc/decoder.cu (abcd_decoder_rows)
(_FUSED_FWD, _FUSED_BWD, _LOOP_FWD, _GRU_FUSED_FWD, _GRU_FUSED_BWD,
 _RNN_FUSED_FWD, _RNN_FUSED_BWD, _GRU_LOOP_FWD, _RNN_LOOP_FWD, _LOOP_BWD,
 _GRU_LOOP_BWD, _RNN_LOOP_BWD, _NLL_FWD, _NLL_BWD) = range(14)
# the fused-loss kinds in seed mode (kinds 14-19 of csrc/decoder.cu)
_SEED_KIND = {_FUSED_FWD: 14, _FUSED_BWD: 15, _GRU_FUSED_FWD: 16,
              _GRU_FUSED_BWD: 17, _RNN_FUSED_FWD: 18, _RNN_FUSED_BWD: 19}

_NAMES = ("noise", "lengths", "w_cat", "bias", "b1", "w2m", "w2v", "b2",
          "w_ih", "targets", "wo1", "bo1", "wo2", "bo2", "h0", "c0")
_GRU_NAMES = ("noise", "lengths", "w_cat", "b_ih", "b_hh", "b1", "w2m",
              "w2v", "b2", "w_ih", "targets", "wo1", "bo1", "wo2", "bo2",
              "h0")
_RNN_NAMES = _NAMES[:-1]
# argument names and gate blocks of each cell's loop
_CELLS = {"LSTM": (_NAMES, 4), "GRU": (_GRU_NAMES, 3), "RNN": (_RNN_NAMES, 1)}


def _shapes(args, cell: str = "LSTM"):
    """(T, B, F, H, m, Mo) of an LSTM, GRU or Elman argument list."""
    by_name = dict(zip(_CELLS[cell][0], args))
    t, b, f = by_name["targets"].shape
    hidden = by_name["w_cat"].shape[0]
    m = by_name["w2m"].shape[0]
    mo = by_name["wo1"].shape[1]
    return t, b, f, hidden, m, mo


def _check(args, cell: str = "LSTM"):
    names, gates = _CELLS[cell]
    if len(args) != len(names):
        raise TypeError(f"expected {len(names)} arguments")
    if args[0].dim() not in (2, 3):
        raise ValueError("noise must be (T, B, F), or a (1, 1) seed")
    t, b, f, hidden, m, mo = _shapes(args, cell)
    gh = gates * hidden
    want = {"noise": (t, b, f) if args[0].dim() == 3 else (1, 1),
            "lengths": (b,),
            "w_cat": (hidden, gh + 2 * m), "bias": (gh,), "b_ih": (gh,),
            "b_hh": (gh,), "b1": (2 * m,), "w2m": (m, f), "w2v": (m, f),
            "b2": (2 * f,), "w_ih": (f, gh), "targets": (t, b, f),
            "wo1": (hidden, mo), "bo1": (mo,), "wo2": (mo,), "bo2": (1,),
            "h0": (b, hidden), "c0": (b, hidden)}
    device = args[0].device
    for name, tensor in zip(names, args):
        if tuple(tensor.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(tensor.shape)}, "
                             f"expected {want[name]}")
        dtype = torch.int32 if name == "lengths" else torch.float32
        if tensor.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {tensor.dtype}")
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, noise on "
                             f"{device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if t < 1 or b < 1:
        raise ValueError("need at least one step and one row")


# ---------------------------------------------------------------------------
# in-kernel noise (decoder_pallas._kernel_noise, decoder_noise_dump)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_TWO_PI = 2.0 * math.pi


def _mulhilo(a: int, b: torch.Tensor):
    """The high and low 32-bit words of ``a * b`` for a 32-bit constant
    ``a`` and an int64 tensor of 32-bit words ``b``, without overflowing
    int64 (b is split into 16-bit halves)."""
    p_hi, p_lo = a * (b >> 16), a * (b & 0xFFFF)        # each < 2^48
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    return hi, lo


def philox4x32(counter, key):
    """Philox4x32-10 (Random123's philox4x32, 10 rounds): ``counter`` four
    and ``key`` two int64 tensors (or ints) of 32-bit words, broadcast
    together; returns the four output words as int64 tensors.  The plain
    twin of ``philox4x32_10`` in csrc/decoder.cu."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for round_ in range(10):
        if round_:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def box_muller(i1: torch.Tensor, i2: torch.Tensor) -> torch.Tensor:
    """Standard normals from two 24-bit integers, in float32 with each
    operation rounded on its own (the kernel's ``box_muller``)."""
    u1 = i1.to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    u2 = i2.to(torch.float32) * 2.0 ** -24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def decoder_noise_dump_plain(seed: torch.Tensor, t: int, b: int, f: int,
                             with_bits: bool = False):
    """Plain PyTorch twin of the dump kernel: (T, B, F) float32 standard
    normals, element (t, b, f) from Philox4x32-10 of counter (t, b, f, 0)
    and key (seed, 0); with ``with_bits`` also the (T, B, F, 2) int32
    24-bit integers of the uniforms."""
    idx = lambda n: torch.arange(n, dtype=torch.int64, device=seed.device)
    tt, bb, ff = torch.broadcast_tensors(idx(t)[:, None, None],
                                         idx(b)[None, :, None],
                                         idx(f)[None, None, :])
    key = seed.reshape(()).to(torch.int64)
    w0, w1, _, _ = philox4x32((tt, bb, ff, torch.zeros_like(tt)), (key, 0))
    i1, i2 = w0 >> 8, w1 >> 8
    out = box_muller(i1, i2)
    if not with_bits:
        return out
    return out, torch.stack([i1, i2], dim=-1).to(torch.int32)


def decoder_noise_dump(seed: torch.Tensor, t: int, b: int, f: int,
                       with_bits: bool = False):
    """The (T, B, F) noise stream the seed mode draws for the (1, 1)
    float32 ``seed`` (below 2^24), as decoder_pallas.decoder_noise_dump;
    with ``with_bits``, also the (T, B, F, 2) int32 24-bit integers whose
    uniforms it transforms (a check of the generator).  CUDA tensors
    launch the dump kernel (one count); CPU tensors take
    ``decoder_noise_dump_plain``."""
    if (tuple(seed.shape) != (1, 1) or seed.dtype != torch.float32
            or seed.device.type not in ("cpu", "cuda")):
        raise ValueError("the seed must be a (1, 1) float32 tensor on the "
                         f"CPU or a card, got {seed.dtype} "
                         f"{tuple(seed.shape)} on {seed.device}")
    if min(t, b, f) < 1:
        raise ValueError(f"need a positive (T, B, F), got {(t, b, f)}")
    if seed.device.type == "cpu":
        return decoder_noise_dump_plain(seed, t, b, f, with_bits)
    lib = _build.load("decoder")
    out = torch.empty((t, b, f), dtype=torch.float32, device=seed.device)
    bits = (torch.empty((t, b, f, 2), dtype=torch.int32, device=seed.device)
            if with_bits else None)
    with torch.cuda.device(seed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_decoder_noise_dump(
            seed.data_ptr(), out.data_ptr(),
            None if bits is None else bits.data_ptr(), t, b, f, stream)
    _build.check(lib, err, "decoder_noise_dump")
    decoder_noise_dump.launches += 1
    return (out, bits) if with_bits else out


decoder_noise_dump.launches = 0


def _stream_args(args, cell: str = "LSTM"):
    """A fused-loss argument list with a (1, 1) seed in place of the noise
    turned into stream mode: the seed becomes the (T, B, F) stream it
    stands for (the dump's twin); the CPU path of the seed mode."""
    if args[0].dim() == 3:
        return args
    t, b, f = args[_CELLS[cell][0].index("targets")].shape
    return (decoder_noise_dump_plain(args[0], t, b, f),) + tuple(args[1:])


def _check_more(device, named):
    """The backward's extra operands: each ``(name, tensor, shape)`` a
    contiguous float32 tensor of that shape on ``device``."""
    for name, tensor, shape in named:
        if (tuple(tensor.shape) != shape or tensor.dtype != torch.float32
                or tensor.device != device or not tensor.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{device}")


def _masks(t, lengths, device):
    """(T, B, 1) step masks: mt (t < len), pmt (1 <= t <= len: the step
    carries position t-1's emission) and the offset target (t == len-1)."""
    steps = torch.arange(t, device=device)[:, None]
    lens = lengths.to(device).long()[None, :]
    mt = steps < lens
    pmt = (steps >= 1) & (steps - 1 < lens)
    y = (steps == lens - 1).float()
    return mt.unsqueeze(-1), pmt.unsqueeze(-1), y.unsqueeze(-1)


def _cell(big, x, w_ih, bias, c, hidden):
    gates = (big[:, :4 * hidden] + x @ w_ih) + bias
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                  torch.sigmoid(o))
    c2 = f * c + i * g
    return i, f, g, o, c2, o * torch.tanh(c2)


def _emission(big, gh, m, b1, w2m, w2v, b2, f_dim):
    """The emission MLP of the previous position from ``big`` = h @ w_cat,
    whose first ``gh`` columns are the recurrent gates."""
    emh = torch.tanh(big[:, gh:] + b1)
    mean = emh[:, :m] @ w2m + b2[:f_dim]
    logvar = emh[:, m:] @ w2v + b2[f_dim:]
    return emh, mean, logvar


def _bce(z, y):
    return (torch.clamp(z, min=0.0) - z * y
            + torch.log1p(torch.exp(-torch.abs(z))))


def decoder_fused_losses_fwd_plain(noise, lengths, w_cat, bias, b1, w2m,
                                   w2v, b2, w_ih, targets, wo1, bo1, wo2,
                                   bo2, h0, c0):
    """Plain PyTorch twin of the forward kernel: the scan body of
    models/decoder.py:_run_direction with the losses of
    decoder_pallas._fused_fwd_kernel, step by step.

    Returns (out_last (B, H), nll (), bce (), hs (T, B, H), cs (T, B, H));
    hs / cs are the masked carries after each step.
    """
    t, b, f, hidden, m, _ = _shapes((noise, lengths, w_cat, bias, b1, w2m,
                                     w2v, b2, w_ih, targets, wo1))
    mt, pmt, y = _masks(t, lengths, noise.device)
    h, c = h0, c0
    nll = noise.new_zeros(())
    bce = noise.new_zeros(())
    zero = noise.new_zeros((b, f))
    hs, cs = [], []
    for s in range(t):
        big = h @ w_cat
        _, mean, logvar = _emission(big, 4 * hidden, m, b1, w2m, w2v, b2,
                                    f)
        eps = noise[s - 1] if s > 0 else zero
        tgt = targets[s - 1] if s > 0 else zero
        x = torch.where(pmt[s], mean + torch.exp(0.5 * logvar) * eps, 0.0)
        diff = tgt - mean
        nll_s = 0.5 * (_LOG_2PI + logvar + diff * torch.exp(-logvar) * diff)
        nll = nll + torch.where(pmt[s], nll_s, 0.0).sum()
        _, _, _, _, c2, h2 = _cell(big, x, w_ih, bias, c, hidden)
        oh = torch.tanh(h2 @ wo1 + bo1)
        z = (oh * wo2).sum(-1, keepdim=True) + bo2
        bce = bce + torch.where(mt[s], _bce(z, y[s]), 0.0).sum()
        h = torch.where(mt[s], h2, h)
        c = torch.where(mt[s], c2, c)
        hs.append(h)
        cs.append(c)
    return h2, nll, bce, torch.stack(hs), torch.stack(cs)


def decoder_fused_losses_fwd(*args, save: bool = True):
    """The forward: (out_last, nll, bce, hs, cs); hs / cs are None when
    ``save`` is False (no backward follows, so the kernel writes neither).
    CUDA tensors launch the kernel (one count; a (1, 1) seed in place of
    the noise, the seed mode's, on ``.seed``); CPU tensors take
    ``decoder_fused_losses_fwd_plain``."""
    _check(args)
    noise = args[0]
    if noise.device.type == "cpu":
        out = decoder_fused_losses_fwd_plain(*_stream_args(args))
        return out if save else out[:3] + (None, None)
    t, b, f, hidden, m, mo = _shapes(args)
    seed = noise.dim() == 2
    lib = _build.load("decoder")
    kind = _SEED_KIND[_FUSED_FWD] if seed else _FUSED_FWD
    rows = _build.row_tile(lib, "decoder", kind, (f, hidden, m, mo),
                           "decoder_loop_fused_losses")
    dev = noise.device
    out_last = torch.empty((b, hidden), dtype=torch.float32, device=dev)
    hs = (torch.empty((t, b, hidden), dtype=torch.float32, device=dev)
          if save else None)
    cs = torch.empty_like(hs) if save else None
    blocks = -(-b // rows)
    partial = torch.empty((blocks, 2), dtype=torch.float64, device=dev)
    losses = torch.empty((2,), dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_decoder_fwd(*[a.data_ptr() for a in args],
                                   out_last.data_ptr(), ptr(hs), ptr(cs),
                                   partial.data_ptr(), losses.data_ptr(),
                                   t, b, f, hidden, m, mo, int(seed), rows,
                                   stream)
    _build.check(lib, err, "decoder_loop_fused_losses")
    (decoder_fused_losses_fwd.seed if seed
     else decoder_fused_losses_fwd).launches += 1
    return out_last, losses[0].clone(), losses[1].clone(), hs, cs


decoder_fused_losses_fwd.launches = 0
decoder_fused_losses_fwd.seed = _build.Launches()


def decoder_fused_losses_bwd_plain(noise, lengths, w_cat, bias, b1, w2m,
                                   w2v, b2, w_ih, targets, wo1, bo1, wo2,
                                   bo2, h0, c0, hs, cs, dlast, gscale):
    """Plain PyTorch twin of the backward kernel: the explicit
    reverse-time adjoint of the forward (not autograd through it), in the
    order of operations of decoder_pallas._fused_bwd_kernel.

    ``gscale`` is (2,): the cotangents of (nll, bce); ``dlast`` (B, H) that
    of out_last.  Returns (dw_cat, dbias, db1, dw2m, dw2v, db2, dw_ih, dwo1,
    dbo1, dwo2, dbo2, dh0, dc0) in the arguments' layouts.
    """
    t, b, f, hidden, m, _ = _shapes((noise, lengths, w_cat, bias, b1, w2m,
                                     w2v, b2, w_ih, targets, wo1))
    mt, pmt, y = _masks(t, lengths, noise.device)
    gnll, gbce = gscale[0], gscale[1]
    zero_f = noise.new_zeros((b, f))
    dh = h0.new_zeros((b, hidden))
    dc = h0.new_zeros((b, hidden))
    streams = {k: [None] * t for k in ("hp", "dbig", "x", "emh", "dem",
                                       "h2", "doh", "oh", "dzo")}
    for s in reversed(range(t)):
        h_prev = hs[s - 1] if s > 0 else h0
        c_prev = cs[s - 1] if s > 0 else c0
        eps = noise[s - 1] if s > 0 else zero_f
        tgt = targets[s - 1] if s > 0 else zero_f
        big = h_prev @ w_cat
        emh, mean, logvar = _emission(big, 4 * hidden, m, b1, w2m, w2v, b2,
                                      f)
        std = torch.exp(0.5 * logvar)
        x = torch.where(pmt[s], mean + std * eps, 0.0)
        i, fg, g, o, c2, h2 = _cell(big, x, w_ih, bias, c_prev, hidden)
        tc = torch.tanh(c2)
        oh = torch.tanh(h2 @ wo1 + bo1)
        z = (oh * wo2).sum(-1, keepdim=True) + bo2
        dzo = torch.where(mt[s], gbce * (torch.sigmoid(z) - y[s]), 0.0)
        doh = (dzo * wo2) * (1.0 - oh * oh)
        dl = dlast if s == t - 1 else 0.0
        dh2 = (doh @ wo1.T + dl) + torch.where(mt[s], dh, 0.0)
        do = dh2 * tc
        dc2 = torch.where(mt[s], dc, 0.0) + dh2 * o * (1.0 - tc * tc)
        df, di, dg = dc2 * c_prev, dc2 * g, dc2 * i
        dz = torch.cat([di * i * (1.0 - i), df * fg * (1.0 - fg),
                        dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        dx = torch.where(pmt[s], dz @ w_ih.T, 0.0)
        inv_var = torch.exp(-logvar)
        diff = tgt - mean
        gm = torch.where(pmt[s], gnll, 0.0)
        dmean = dx - gm * diff * inv_var
        dlogvar = dx * 0.5 * std * eps + gm * 0.5 * (1.0 - diff * inv_var
                                                     * diff)
        demh = torch.cat([dmean @ w2m.T, dlogvar @ w2v.T], dim=-1)
        dbig = torch.cat([dz, demh * (1.0 - emh * emh)], dim=-1)
        dh = torch.where(mt[s], 0.0, dh) + dbig @ w_cat.T
        dc = torch.where(mt[s], 0.0, dc) + dc2 * fg
        for k, v in (("hp", h_prev), ("dbig", dbig), ("x", x), ("emh", emh),
                     ("dem", torch.cat([dmean, dlogvar], -1)), ("h2", h2),
                     ("doh", doh), ("oh", oh), ("dzo", dzo)):
            streams[k][s] = v
    st = {k: torch.cat(v) for k, v in streams.items()}  # (T * B, .)
    return _weight_grads(st, hidden, m, f, wgrad.at_b_plain) + (dh, dc)


def _weight_grads(st, hidden, m, f, at_b, cell: str = "LSTM"):
    """Every weight gradient from the (T * B, .) streams: for the LSTM and
    the Elman cell (dw_cat, dbias, db1, ...), for the GRU (dw_cat, db_ih,
    db_hh, db1, ...), whose dbig stream holds dhp, the cotangent of
    h @ W_hh + b_hh, and whose ``dnp`` stream the candidate third of dxp,
    that of x @ W_ih + b_ih; the offset MLP's (dwo1, dbo1, dwo2, dbo2)
    last, where the streams hold them (the fused-loss backwards)."""
    gru = cell == "GRU"
    gh = _CELLS[cell][1] * hidden
    dbig = st["dbig"]
    dw_cat = at_b(st["hp"], dbig)
    dbig_sum = at_b(None, dbig).reshape(-1)
    if gru:
        h2 = 2 * hidden
        dw_ih = torch.cat([at_b(st["x"], dbig[:, :h2]),
                           at_b(st["x"], st["dnp"])], dim=1)
        biases = (torch.cat([dbig_sum[:h2],
                             at_b(None, st["dnp"]).reshape(-1)]),
                  dbig_sum[:gh])
    else:
        dw_ih = at_b(st["x"], dbig[:, :gh])
        biases = (dbig_sum[:gh],)
    dw2m = at_b(st["emh"][:, :m], st["dem"][:, :f])
    dw2v = at_b(st["emh"][:, m:], st["dem"][:, f:])
    db2 = at_b(None, st["dem"]).reshape(-1)
    grads = (dw_cat, *biases, dbig_sum[gh:], dw2m, dw2v, db2, dw_ih)
    if "doh" not in st:
        return grads
    dwo1 = at_b(st["h2"], st["doh"])
    dbo1 = at_b(None, st["doh"]).reshape(-1)
    dwo2 = at_b(st["oh"], st["dzo"]).reshape(-1)
    dbo2 = at_b(None, st["dzo"]).reshape(-1)
    return grads + (dwo1, dbo1, dwo2, dbo2)


def decoder_fused_losses_bwd(*args):
    """The backward: args as the forward's, then hs, cs, dlast (B, H) and
    gscale (2,) = the cotangents of (nll, bce).  Returns the 13 gradients
    of ``decoder_fused_losses_bwd_plain``.  CUDA tensors launch the
    reverse-time kernel, then ``ops/wgrad.py``'s reductions of its streams
    (one count; the seed mode's on ``.seed``); CPU tensors take the
    twin."""
    fwd_args, (hs, cs, dlast, gscale) = args[:16], args[16:]
    _check(fwd_args)
    t, b, f, hidden, m, mo = _shapes(fwd_args)
    dev = fwd_args[0].device
    _check_more(dev, (("hs", hs, (t, b, hidden)), ("cs", cs, (t, b, hidden)),
                      ("dlast", dlast, (b, hidden)), ("gscale", gscale, (2,))))
    if dev.type == "cpu":
        return decoder_fused_losses_bwd_plain(*_stream_args(fwd_args),
                                              *args[16:])
    seed = fwd_args[0].dim() == 2
    lib = _build.load("decoder")
    kind = _SEED_KIND[_FUSED_BWD] if seed else _FUSED_BWD
    rows = _build.row_tile(lib, "decoder", kind, (f, hidden, m, mo),
                           "decoder_loop_fused_losses backward")
    w_cat, w2m, w2v, w_ih, wo1 = (fwd_args[i] for i in (2, 5, 6, 8, 10))
    g = w_cat.shape[1]
    transposed = [w.transpose(0, 1).contiguous()
                  for w in (w_cat, w_ih, w2m, w2v, wo1)]
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=dev)
    dh0, dc0 = empty(b, hidden), empty(b, hidden)
    st = {"hp": empty(t, b, hidden), "dbig": empty(t, b, g),
          "x": empty(t, b, f), "emh": empty(t, b, 2 * m),
          "dem": empty(t, b, 2 * f), "h2": empty(t, b, hidden),
          "doh": empty(t, b, mo), "oh": empty(t, b, mo),
          "dzo": empty(t, b, 1)}
    order = ("hp", "dbig", "x", "emh", "dem", "h2", "doh", "oh", "dzo")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_decoder_bwd(
            *[a.data_ptr() for a in fwd_args],
            *[w.data_ptr() for w in transposed],
            hs.data_ptr(), cs.data_ptr(), dlast.data_ptr(),
            gscale.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            *[st[k].data_ptr() for k in order], t, b, f, hidden, m, mo,
            int(seed), rows, stream)
        _build.check(lib, err, "decoder_loop_fused_losses backward")
        rows = {k: v.view(t * b, v.shape[-1]) for k, v in st.items()}
        grads = _weight_grads(rows, hidden, m, f, wgrad.at_b)
    (decoder_fused_losses_bwd.seed if seed
     else decoder_fused_losses_bwd).launches += 1
    return grads + (dh0, dc0)


decoder_fused_losses_bwd.launches = 0
decoder_fused_losses_bwd.seed = _build.Launches()


class _DecoderFusedLosses(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        out_last, nll, bce, hs, cs = decoder_fused_losses_fwd(*args)
        ctx.save_for_backward(*args, hs, cs)
        return out_last, nll, bce

    @staticmethod
    def backward(ctx, dlast, dnll, dbce):
        saved = ctx.saved_tensors
        gscale = torch.stack([dnll.reshape(()), dbce.reshape(())]).float()
        grads = decoder_fused_losses_bwd(*saved, dlast.contiguous(),
                                         gscale.contiguous())
        (dw_cat, dbias, db1, dw2m, dw2v, db2, dw_ih, dwo1, dbo1, dwo2, dbo2,
         dh0, dc0) = grads
        return (None, None, dw_cat, dbias, db1, dw2m, dw2v, db2, dw_ih, None,
                dwo1, dbo1, dwo2, dbo2, dh0, dc0)


def decoder_loop_fused_losses(noise, lengths, w_cat, bias, b1, w2m, w2v, b2,
                              w_ih, targets, wo1, bo1, wo2, bo2, h0, c0):
    """(out_last (B, H), nll (), bce ()), differentiable in every weight and
    in h0 / c0: nll covers positions 0..T-2 (the caller adds T-1's term
    from out_last), bce every position.  ``noise`` is the (T, B, F) stream
    or a (1, 1) float32 seed (the seed mode).  Without autograd only the
    forward runs, and it saves no trajectories."""
    args = (noise, lengths, w_cat, bias, b1, w2m, w2v, b2, w_ih, targets,
            wo1, bo1, wo2, bo2, h0, c0)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _DecoderFusedLosses.apply(*args)
    return decoder_fused_losses_fwd(*args, save=False)[:3]


# ---------------------------------------------------------------------------
# the GRU loop with both losses fused
# (decoder_pallas.gru_decoder_loop_fused_losses)
# ---------------------------------------------------------------------------

def _gru_cell(big, x, w_ih, b_ih, b_hh, h, hidden):
    """r, z, n, hp_n and h2 of one GRU step, in the order of
    decoder_pallas._gru_floss_fwd_kernel."""
    hp = big[:, :3 * hidden] + b_hh
    xp = x @ w_ih + b_ih
    hn = hp[:, 2 * hidden:]
    r = torch.sigmoid(xp[:, :hidden] + hp[:, :hidden])
    z = torch.sigmoid(xp[:, hidden:2 * hidden] + hp[:, hidden:2 * hidden])
    n = torch.tanh(xp[:, 2 * hidden:] + r * hn)
    return r, z, n, hn, (1.0 - z) * n + z * h


def gru_decoder_fused_losses_fwd_plain(noise, lengths, w_cat, b_ih, b_hh, b1,
                                       w2m, w2v, b2, w_ih, targets, wo1, bo1,
                                       wo2, bo2, h0):
    """Plain PyTorch twin of the GRU forward kernel: the loop of
    decoder_pallas._gru_floss_fwd_kernel, step by step.

    Returns (out_last (B, H), nll (), bce (), hs (T, B, H)); hs are the
    masked carries after each step.
    """
    args = (noise, lengths, w_cat, b_ih, b_hh, b1, w2m, w2v, b2, w_ih,
            targets, wo1, bo1, wo2, bo2, h0)
    t, b, f, hidden, m, _ = _shapes(args, "GRU")
    mt, pmt, y = _masks(t, lengths, noise.device)
    h = h0
    nll = noise.new_zeros(())
    bce = noise.new_zeros(())
    zero = noise.new_zeros((b, f))
    hs = []
    for s in range(t):
        big = h @ w_cat
        _, mean, logvar = _emission(big, 3 * hidden, m, b1, w2m, w2v, b2, f)
        eps = noise[s - 1] if s > 0 else zero
        tgt = targets[s - 1] if s > 0 else zero
        x = torch.where(pmt[s], mean + torch.exp(0.5 * logvar) * eps, 0.0)
        diff = tgt - mean
        nll_s = 0.5 * (_LOG_2PI + logvar + diff * torch.exp(-logvar) * diff)
        nll = nll + torch.where(pmt[s], nll_s, 0.0).sum()
        h2 = _gru_cell(big, x, w_ih, b_ih, b_hh, h, hidden)[-1]
        oh = torch.tanh(h2 @ wo1 + bo1)
        z = (oh * wo2).sum(-1, keepdim=True) + bo2
        bce = bce + torch.where(mt[s], _bce(z, y[s]), 0.0).sum()
        h = torch.where(mt[s], h2, h)
        hs.append(h)
    return h2, nll, bce, torch.stack(hs)


def gru_decoder_fused_losses_fwd(*args, save: bool = True):
    """The GRU forward: (out_last, nll, bce, hs); hs is None when ``save``
    is False (no backward follows, so the kernel writes none).  CUDA
    tensors launch the kernel (one count; the seed mode's on ``.seed``);
    CPU tensors take ``gru_decoder_fused_losses_fwd_plain``."""
    _check(args, "GRU")
    noise = args[0]
    if noise.device.type == "cpu":
        out = gru_decoder_fused_losses_fwd_plain(*_stream_args(args, "GRU"))
        return out if save else out[:3] + (None,)
    t, b, f, hidden, m, mo = _shapes(args, "GRU")
    seed = noise.dim() == 2
    lib = _build.load("decoder")
    kind = _SEED_KIND[_GRU_FUSED_FWD] if seed else _GRU_FUSED_FWD
    rows = _build.row_tile(lib, "decoder", kind, (f, hidden, m, mo),
                           "gru_decoder_loop_fused_losses")
    dev = noise.device
    out_last = torch.empty((b, hidden), dtype=torch.float32, device=dev)
    hs = (torch.empty((t, b, hidden), dtype=torch.float32, device=dev)
          if save else None)
    blocks = -(-b // rows)
    partial = torch.empty((blocks, 2), dtype=torch.float64, device=dev)
    losses = torch.empty((2,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_gru_decoder_fwd(
            *[a.data_ptr() for a in args], out_last.data_ptr(),
            None if hs is None else hs.data_ptr(), partial.data_ptr(),
            losses.data_ptr(), t, b, f, hidden, m, mo, int(seed), rows,
            stream)
    _build.check(lib, err, "gru_decoder_loop_fused_losses")
    (gru_decoder_fused_losses_fwd.seed if seed
     else gru_decoder_fused_losses_fwd).launches += 1
    return out_last, losses[0].clone(), losses[1].clone(), hs


gru_decoder_fused_losses_fwd.launches = 0
gru_decoder_fused_losses_fwd.seed = _build.Launches()


def gru_decoder_fused_losses_bwd_plain(noise, lengths, w_cat, b_ih, b_hh, b1,
                                       w2m, w2v, b2, w_ih, targets, wo1, bo1,
                                       wo2, bo2, h0, hs, dlast, gscale):
    """Plain PyTorch twin of the GRU backward kernel: the explicit
    reverse-time adjoint of the forward (not autograd through it), in the
    order of operations of decoder_pallas._gru_floss_bwd_kernel.

    ``gscale`` is (2,): the cotangents of (nll, bce); ``dlast`` (B, H) that
    of out_last.  Returns (dw_cat, db_ih, db_hh, db1, dw2m, dw2v, db2,
    dw_ih, dwo1, dbo1, dwo2, dbo2, dh0) in the arguments' layouts.
    """
    args = (noise, lengths, w_cat, b_ih, b_hh, b1, w2m, w2v, b2, w_ih,
            targets, wo1, bo1, wo2, bo2, h0)
    t, b, f, hidden, m, _ = _shapes(args, "GRU")
    mt, pmt, y = _masks(t, lengths, noise.device)
    gnll, gbce = gscale[0], gscale[1]
    zero_f = noise.new_zeros((b, f))
    dh = h0.new_zeros((b, hidden))
    streams = {k: [None] * t for k in ("hp", "dbig", "x", "emh", "dem",
                                       "h2", "doh", "oh", "dzo", "dnp")}
    for s in reversed(range(t)):
        h_prev = hs[s - 1] if s > 0 else h0
        eps = noise[s - 1] if s > 0 else zero_f
        tgt = targets[s - 1] if s > 0 else zero_f
        big = h_prev @ w_cat
        emh, mean, logvar = _emission(big, 3 * hidden, m, b1, w2m, w2v, b2,
                                      f)
        std = torch.exp(0.5 * logvar)
        x = torch.where(pmt[s], mean + std * eps, 0.0)
        r, z, n, hn, h2 = _gru_cell(big, x, w_ih, b_ih, b_hh, h_prev, hidden)
        oh = torch.tanh(h2 @ wo1 + bo1)
        zo = (oh * wo2).sum(-1, keepdim=True) + bo2
        dzo = torch.where(mt[s], gbce * (torch.sigmoid(zo) - y[s]), 0.0)
        doh = (dzo * wo2) * (1.0 - oh * oh)
        dl = dlast if s == t - 1 else 0.0
        dh2 = (doh @ wo1.T + dl) + torch.where(mt[s], dh, 0.0)
        dn = dh2 * (1.0 - z)
        dz = dh2 * (h_prev - n)
        dh_prev = torch.where(mt[s], 0.0, dh) + dh2 * z
        dnpre = dn * (1.0 - n * n)
        drpre = dnpre * hn * r * (1.0 - r)
        dzpre = dz * z * (1.0 - z)
        dxp = torch.cat([drpre, dzpre, dnpre], dim=-1)
        dhp = torch.cat([drpre, dzpre, dnpre * r], dim=-1)
        dx = torch.where(pmt[s], dxp @ w_ih.T, 0.0)
        inv_var = torch.exp(-logvar)
        diff = tgt - mean
        gm = torch.where(pmt[s], gnll, 0.0)
        dmean = dx - gm * diff * inv_var
        dlogvar = dx * 0.5 * std * eps + gm * 0.5 * (1.0 - diff * inv_var
                                                     * diff)
        demh = torch.cat([dmean @ w2m.T, dlogvar @ w2v.T], dim=-1)
        dbig = torch.cat([dhp, demh * (1.0 - emh * emh)], dim=-1)
        dh = dh_prev + dbig @ w_cat.T
        for k, v in (("hp", h_prev), ("dbig", dbig), ("x", x), ("emh", emh),
                     ("dem", torch.cat([dmean, dlogvar], -1)), ("h2", h2),
                     ("doh", doh), ("oh", oh), ("dzo", dzo),
                     ("dnp", dnpre)):
            streams[k][s] = v
    st = {k: torch.cat(v) for k, v in streams.items()}  # (T * B, .)
    return _weight_grads(st, hidden, m, f, wgrad.at_b_plain,
                         "GRU") + (dh,)


def gru_decoder_fused_losses_bwd(*args):
    """The GRU backward: args as the forward's, then hs, dlast (B, H) and
    gscale (2,) = the cotangents of (nll, bce).  Returns the 13 gradients
    of ``gru_decoder_fused_losses_bwd_plain``.  CUDA tensors launch the
    reverse-time kernel, then ``ops/wgrad.py``'s reductions of its streams
    (one count; the seed mode's on ``.seed``); CPU tensors take the
    twin."""
    fwd_args, (hs, dlast, gscale) = args[:16], args[16:]
    _check(fwd_args, "GRU")
    t, b, f, hidden, m, mo = _shapes(fwd_args, "GRU")
    dev = fwd_args[0].device
    _check_more(dev, (("hs", hs, (t, b, hidden)),
                      ("dlast", dlast, (b, hidden)), ("gscale", gscale, (2,))))
    if dev.type == "cpu":
        return gru_decoder_fused_losses_bwd_plain(
            *_stream_args(fwd_args, "GRU"), *args[16:])
    seed = fwd_args[0].dim() == 2
    lib = _build.load("decoder")
    kind = _SEED_KIND[_GRU_FUSED_BWD] if seed else _GRU_FUSED_BWD
    rows = _build.row_tile(lib, "decoder", kind, (f, hidden, m, mo),
                           "gru_decoder_loop_fused_losses backward")
    w_cat, w2m, w2v, w_ih, wo1 = (fwd_args[i] for i in (2, 6, 7, 9, 11))
    g = w_cat.shape[1]
    transposed = [w.transpose(0, 1).contiguous()
                  for w in (w_cat, w_ih, w2m, w2v, wo1)]
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=dev)
    dh0 = empty(b, hidden)
    order = ("hp", "dbig", "x", "emh", "dem", "h2", "doh", "oh", "dzo",
             "dnp")
    widths = {"hp": hidden, "dbig": g, "x": f, "emh": 2 * m, "dem": 2 * f,
              "h2": hidden, "doh": mo, "oh": mo, "dzo": 1, "dnp": hidden}
    st = {k: empty(t, b, widths[k]) for k in order}
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_gru_decoder_bwd(
            *[a.data_ptr() for a in fwd_args],
            *[w.data_ptr() for w in transposed], hs.data_ptr(),
            dlast.data_ptr(), gscale.data_ptr(), dh0.data_ptr(),
            *[st[k].data_ptr() for k in order], t, b, f, hidden, m, mo,
            int(seed), rows, stream)
        _build.check(lib, err, "gru_decoder_loop_fused_losses backward")
        rows = {k: v.view(t * b, v.shape[-1]) for k, v in st.items()}
        grads = _weight_grads(rows, hidden, m, f, wgrad.at_b, "GRU")
    (gru_decoder_fused_losses_bwd.seed if seed
     else gru_decoder_fused_losses_bwd).launches += 1
    return grads + (dh0,)


gru_decoder_fused_losses_bwd.launches = 0
gru_decoder_fused_losses_bwd.seed = _build.Launches()


class _GRUDecoderFusedLosses(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        out_last, nll, bce, hs = gru_decoder_fused_losses_fwd(*args)
        ctx.save_for_backward(*args, hs)
        return out_last, nll, bce

    @staticmethod
    def backward(ctx, dlast, dnll, dbce):
        saved = ctx.saved_tensors
        gscale = torch.stack([dnll.reshape(()), dbce.reshape(())]).float()
        (dw_cat, db_ih, db_hh, db1, dw2m, dw2v, db2, dw_ih, dwo1, dbo1, dwo2,
         dbo2, dh0) = gru_decoder_fused_losses_bwd(
            *saved, dlast.contiguous(), gscale.contiguous())
        return (None, None, dw_cat, db_ih, db_hh, db1, dw2m, dw2v, db2,
                dw_ih, None, dwo1, dbo1, dwo2, dbo2, dh0)


def gru_decoder_loop_fused_losses(noise, lengths, w_cat, b_ih, b_hh, b1, w2m,
                                  w2v, b2, w_ih, targets, wo1, bo1, wo2, bo2,
                                  h0):
    """The GRU decoder loop with both losses: (out_last (B, H), nll (),
    bce ()), differentiable in every weight and in h0, as
    decoder_pallas.gru_decoder_loop_fused_losses: nll covers positions
    0..T-2 (the caller adds T-1's term from out_last), bce every position.
    ``noise`` is the (T, B, F) stream or a (1, 1) float32 seed.  Without
    autograd only the forward runs, and it saves no trajectory."""
    args = (noise, lengths, w_cat, b_ih, b_hh, b1, w2m, w2v, b2, w_ih,
            targets, wo1, bo1, wo2, bo2, h0)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _GRUDecoderFusedLosses.apply(*args)
    return gru_decoder_fused_losses_fwd(*args, save=False)[:3]


# ---------------------------------------------------------------------------
# the Elman / ESN loop with both losses fused
# (decoder_pallas.rnn_decoder_loop_fused_losses)
# ---------------------------------------------------------------------------

def _rnn_cell(big, x, w_ih, bias, h, hidden, leak):
    """u and h2 of one Elman / ESN step, in the order of
    decoder_pallas._rnn_floss_fwd_kernel; at leak 1.0, h2 is exactly u."""
    u = torch.tanh((big[:, :hidden] + x @ w_ih) + bias)
    return u, (1.0 - leak) * h + leak * u


def rnn_decoder_fused_losses_fwd_plain(noise, lengths, w_cat, bias, b1, w2m,
                                       w2v, b2, w_ih, targets, wo1, bo1, wo2,
                                       bo2, h0, leak=1.0):
    """Plain PyTorch twin of the Elman / ESN forward kernel: the loop of
    decoder_pallas._rnn_floss_fwd_kernel, step by step.

    Returns (out_last (B, H), nll (), bce (), hs (T, B, H)); hs are the
    masked carries after each step.
    """
    args = (noise, lengths, w_cat, bias, b1, w2m, w2v, b2, w_ih, targets,
            wo1, bo1, wo2, bo2, h0)
    t, b, f, hidden, m, _ = _shapes(args, "RNN")
    mt, pmt, y = _masks(t, lengths, noise.device)
    h = h0
    nll = noise.new_zeros(())
    bce = noise.new_zeros(())
    zero = noise.new_zeros((b, f))
    hs = []
    for s in range(t):
        big = h @ w_cat
        _, mean, logvar = _emission(big, hidden, m, b1, w2m, w2v, b2, f)
        eps = noise[s - 1] if s > 0 else zero
        tgt = targets[s - 1] if s > 0 else zero
        x = torch.where(pmt[s], mean + torch.exp(0.5 * logvar) * eps, 0.0)
        diff = tgt - mean
        nll_s = 0.5 * (_LOG_2PI + logvar + diff * torch.exp(-logvar) * diff)
        nll = nll + torch.where(pmt[s], nll_s, 0.0).sum()
        h2 = _rnn_cell(big, x, w_ih, bias, h, hidden, leak)[1]
        oh = torch.tanh(h2 @ wo1 + bo1)
        z = (oh * wo2).sum(-1, keepdim=True) + bo2
        bce = bce + torch.where(mt[s], _bce(z, y[s]), 0.0).sum()
        h = torch.where(mt[s], h2, h)
        hs.append(h)
    return h2, nll, bce, torch.stack(hs)


def rnn_decoder_fused_losses_fwd(*args, leak=1.0, save: bool = True):
    """The Elman / ESN forward: (out_last, nll, bce, hs); hs is None when
    ``save`` is False (no backward follows, so the kernel writes none).
    CUDA tensors launch the kernel (one count; the seed mode's on
    ``.seed``); CPU tensors take ``rnn_decoder_fused_losses_fwd_plain``."""
    _check(args, "RNN")
    leak = _check_leak(leak)
    noise = args[0]
    if noise.device.type == "cpu":
        out = rnn_decoder_fused_losses_fwd_plain(*_stream_args(args, "RNN"),
                                                 leak=leak)
        return out if save else out[:3] + (None,)
    t, b, f, hidden, m, mo = _shapes(args, "RNN")
    seed = noise.dim() == 2
    lib = _build.load("decoder")
    kind = _SEED_KIND[_RNN_FUSED_FWD] if seed else _RNN_FUSED_FWD
    rows = _build.row_tile(lib, "decoder", kind, (f, hidden, m, mo),
                           "rnn_decoder_loop_fused_losses")
    dev = noise.device
    out_last = torch.empty((b, hidden), dtype=torch.float32, device=dev)
    hs = (torch.empty((t, b, hidden), dtype=torch.float32, device=dev)
          if save else None)
    blocks = -(-b // rows)
    partial = torch.empty((blocks, 2), dtype=torch.float64, device=dev)
    losses = torch.empty((2,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_rnn_decoder_fwd(
            *[a.data_ptr() for a in args], out_last.data_ptr(),
            None if hs is None else hs.data_ptr(), partial.data_ptr(),
            losses.data_ptr(), t, b, f, hidden, m, mo, leak, int(seed), rows,
            stream)
    _build.check(lib, err, "rnn_decoder_loop_fused_losses")
    (rnn_decoder_fused_losses_fwd.seed if seed
     else rnn_decoder_fused_losses_fwd).launches += 1
    return out_last, losses[0].clone(), losses[1].clone(), hs


rnn_decoder_fused_losses_fwd.launches = 0
rnn_decoder_fused_losses_fwd.seed = _build.Launches()


def rnn_decoder_fused_losses_bwd_plain(noise, lengths, w_cat, bias, b1, w2m,
                                       w2v, b2, w_ih, targets, wo1, bo1, wo2,
                                       bo2, h0, hs, dlast, gscale, leak=1.0):
    """Plain PyTorch twin of the Elman / ESN backward kernel: the explicit
    reverse-time adjoint of the forward (not autograd through it), in the
    order of operations of decoder_pallas._rnn_floss_bwd_kernel.

    ``gscale`` is (2,): the cotangents of (nll, bce); ``dlast`` (B, H) that
    of out_last.  Returns (dw_cat, dbias, db1, dw2m, dw2v, db2, dw_ih, dwo1,
    dbo1, dwo2, dbo2, dh0) in the arguments' layouts.
    """
    args = (noise, lengths, w_cat, bias, b1, w2m, w2v, b2, w_ih, targets,
            wo1, bo1, wo2, bo2, h0)
    t, b, f, hidden, m, _ = _shapes(args, "RNN")
    mt, pmt, y = _masks(t, lengths, noise.device)
    gnll, gbce = gscale[0], gscale[1]
    zero_f = noise.new_zeros((b, f))
    dh = h0.new_zeros((b, hidden))
    streams = {k: [None] * t for k in ("hp", "dbig", "x", "emh", "dem",
                                       "h2", "doh", "oh", "dzo")}
    for s in reversed(range(t)):
        h_prev = hs[s - 1] if s > 0 else h0
        eps = noise[s - 1] if s > 0 else zero_f
        tgt = targets[s - 1] if s > 0 else zero_f
        big = h_prev @ w_cat
        emh, mean, logvar = _emission(big, hidden, m, b1, w2m, w2v, b2, f)
        std = torch.exp(0.5 * logvar)
        x = torch.where(pmt[s], mean + std * eps, 0.0)
        u, h2 = _rnn_cell(big, x, w_ih, bias, h_prev, hidden, leak)
        oh = torch.tanh(h2 @ wo1 + bo1)
        zo = (oh * wo2).sum(-1, keepdim=True) + bo2
        dzo = torch.where(mt[s], gbce * (torch.sigmoid(zo) - y[s]), 0.0)
        doh = (dzo * wo2) * (1.0 - oh * oh)
        dl = dlast if s == t - 1 else 0.0
        dh2 = (doh @ wo1.T + dl) + torch.where(mt[s], dh, 0.0)
        dpre = (leak * dh2) * (1.0 - u * u)
        dh_prev = torch.where(mt[s], 0.0, dh) + (1.0 - leak) * dh2
        dx = torch.where(pmt[s], dpre @ w_ih.T, 0.0)
        inv_var = torch.exp(-logvar)
        diff = tgt - mean
        gm = torch.where(pmt[s], gnll, 0.0)
        dmean = dx - gm * diff * inv_var
        dlogvar = dx * 0.5 * std * eps + gm * 0.5 * (1.0 - diff * inv_var
                                                     * diff)
        demh = torch.cat([dmean @ w2m.T, dlogvar @ w2v.T], dim=-1)
        dbig = torch.cat([dpre, demh * (1.0 - emh * emh)], dim=-1)
        dh = dh_prev + dbig @ w_cat.T
        for k, v in (("hp", h_prev), ("dbig", dbig), ("x", x), ("emh", emh),
                     ("dem", torch.cat([dmean, dlogvar], -1)), ("h2", h2),
                     ("doh", doh), ("oh", oh), ("dzo", dzo)):
            streams[k][s] = v
    st = {k: torch.cat(v) for k, v in streams.items()}  # (T * B, .)
    return _weight_grads(st, hidden, m, f, wgrad.at_b_plain, "RNN") + (dh,)


def rnn_decoder_fused_losses_bwd(*args, leak=1.0):
    """The Elman / ESN backward: args as the forward's, then hs, dlast
    (B, H) and gscale (2,) = the cotangents of (nll, bce).  Returns the 12
    gradients of ``rnn_decoder_fused_losses_bwd_plain``.  CUDA tensors
    launch the reverse-time kernel, then ``ops/wgrad.py``'s reductions of
    its streams (one count; the seed mode's on ``.seed``); CPU tensors take
    the twin."""
    fwd_args, (hs, dlast, gscale) = args[:15], args[15:]
    _check(fwd_args, "RNN")
    leak = _check_leak(leak)
    t, b, f, hidden, m, mo = _shapes(fwd_args, "RNN")
    dev = fwd_args[0].device
    _check_more(dev, (("hs", hs, (t, b, hidden)),
                      ("dlast", dlast, (b, hidden)), ("gscale", gscale, (2,))))
    if dev.type == "cpu":
        return rnn_decoder_fused_losses_bwd_plain(
            *_stream_args(fwd_args, "RNN"), *args[15:], leak=leak)
    seed = fwd_args[0].dim() == 2
    lib = _build.load("decoder")
    kind = _SEED_KIND[_RNN_FUSED_BWD] if seed else _RNN_FUSED_BWD
    rows = _build.row_tile(lib, "decoder", kind, (f, hidden, m, mo),
                           "rnn_decoder_loop_fused_losses backward")
    w_cat, w2m, w2v, w_ih, wo1 = (fwd_args[i] for i in (2, 5, 6, 8, 10))
    g = w_cat.shape[1]
    transposed = [w.transpose(0, 1).contiguous()
                  for w in (w_cat, w_ih, w2m, w2v, wo1)]
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=dev)
    dh0 = empty(b, hidden)
    order = ("hp", "dbig", "x", "emh", "dem", "h2", "doh", "oh", "dzo")
    widths = {"hp": hidden, "dbig": g, "x": f, "emh": 2 * m, "dem": 2 * f,
              "h2": hidden, "doh": mo, "oh": mo, "dzo": 1}
    st = {k: empty(t, b, widths[k]) for k in order}
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_rnn_decoder_bwd(
            *[a.data_ptr() for a in fwd_args],
            *[w.data_ptr() for w in transposed], hs.data_ptr(),
            dlast.data_ptr(), gscale.data_ptr(), dh0.data_ptr(),
            *[st[k].data_ptr() for k in order], t, b, f, hidden, m, mo,
            leak, int(seed), rows, stream)
        _build.check(lib, err, "rnn_decoder_loop_fused_losses backward")
        rows = {k: v.view(t * b, v.shape[-1]) for k, v in st.items()}
        grads = _weight_grads(rows, hidden, m, f, wgrad.at_b, "RNN")
    (rnn_decoder_fused_losses_bwd.seed if seed
     else rnn_decoder_fused_losses_bwd).launches += 1
    return grads + (dh0,)


rnn_decoder_fused_losses_bwd.launches = 0
rnn_decoder_fused_losses_bwd.seed = _build.Launches()


class _RNNDecoderFusedLosses(torch.autograd.Function):
    @staticmethod
    def forward(ctx, leak, *args):
        out_last, nll, bce, hs = rnn_decoder_fused_losses_fwd(*args,
                                                              leak=leak)
        ctx.save_for_backward(*args, hs)
        ctx.leak = leak
        return out_last, nll, bce

    @staticmethod
    def backward(ctx, dlast, dnll, dbce):
        saved = ctx.saved_tensors
        gscale = torch.stack([dnll.reshape(()), dbce.reshape(())]).float()
        (dw_cat, dbias, db1, dw2m, dw2v, db2, dw_ih, dwo1, dbo1, dwo2, dbo2,
         dh0) = rnn_decoder_fused_losses_bwd(
            *saved, dlast.contiguous(), gscale.contiguous(), leak=ctx.leak)
        return (None, None, None, dw_cat, dbias, db1, dw2m, dw2v, db2, dw_ih,
                None, dwo1, dbo1, dwo2, dbo2, dh0)


def rnn_decoder_loop_fused_losses(noise, lengths, w_cat, bias, b1, w2m, w2v,
                                  b2, w_ih, targets, wo1, bo1, wo2, bo2, h0,
                                  leak=1.0):
    """The Elman / ESN decoder loop with both losses: (out_last (B, H),
    nll (), bce ()), differentiable in every weight and in h0, as
    decoder_pallas.rnn_decoder_loop_fused_losses: nll covers positions
    0..T-2 (the caller adds T-1's term from out_last), bce every position.
    ``leak`` below 1.0 selects the ESN cell (pass a zero ``bias``; the
    ESN has none).  ``noise`` is the (T, B, F) stream or a (1, 1) float32
    seed.  Without autograd only the forward runs, and it saves no
    trajectory."""
    args = (noise, lengths, w_cat, bias, b1, w2m, w2v, b2, w_ih, targets,
            wo1, bo1, wo2, bo2, h0)
    leak = _check_leak(leak)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _RNNDecoderFusedLosses.apply(leak, *args)
    return rnn_decoder_fused_losses_fwd(*args, leak=leak, save=False)[:3]


# ---------------------------------------------------------------------------
# the plain sampled loops (decoder_pallas.decoder_loop, gru_decoder_loop and
# rnn_decoder_loop), forward and backward
# ---------------------------------------------------------------------------

_LOOP_NAMES = {
    "LSTM": ("noise", "lengths", "w_cat", "bias", "b1", "w2m", "w2v", "b2",
             "w_ih", "h0", "c0"),
    "GRU": ("noise", "lengths", "w_cat", "b_ih", "b_hh", "b1", "w2m", "w2v",
            "b2", "w_ih", "h0"),
    "RNN": ("noise", "lengths", "w_cat", "bias", "b1", "w2m", "w2v", "b2",
            "w_ih", "h0")}


def _check_loop(args, cell: str = "LSTM"):
    """Shapes, types and devices of a ``decoder_loop`` call
    (``gru_decoder_loop``'s for the GRU, ``rnn_decoder_loop``'s for the
    Elman / ESN cell)."""
    names, gates = _LOOP_NAMES[cell], _CELLS[cell][1]
    if len(args) != len(names):
        raise TypeError(f"expected {len(names)} arguments")
    by_name = dict(zip(names, args))
    noise, w_cat, w2m = by_name["noise"], by_name["w_cat"], by_name["w2m"]
    if noise.dim() != 3 or w_cat.dim() != 2 or w2m.dim() != 2:
        raise ValueError(f"noise must be (T, B, F), w_cat (H, {gates}H + 2m) "
                         "and w2m (m, F)")
    t, b, f = noise.shape
    hidden, m = w_cat.shape[0], w2m.shape[0]
    gh = gates * hidden
    want = {"noise": (t, b, f), "lengths": (b,),
            "w_cat": (hidden, gh + 2 * m), "bias": (gh,), "b_ih": (gh,),
            "b_hh": (gh,), "b1": (2 * m,), "w2m": (m, f), "w2v": (m, f),
            "b2": (2 * f,), "w_ih": (f, gh), "h0": (b, hidden),
            "c0": (b, hidden)}
    for name, tensor in zip(names, args):
        dtype = torch.int32 if name == "lengths" else torch.float32
        if (tuple(tensor.shape) != want[name] or tensor.dtype != dtype
                or tensor.device != noise.device
                or not tensor.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} "
                             f"{want[name]} on {noise.device}, got "
                             f"{tensor.dtype} {tuple(tensor.shape)} on "
                             f"{tensor.device}")
    if noise.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {noise.device}")
    if t < 1 or b < 1:
        raise ValueError("need at least one step and one row")
    return t, b, f, hidden, m



def _sampled_input(noise, s, pmt, mean, logvar):
    """The fed-back input of step ``s``: position s-1's sampled emission
    (noise[s - 1]), zero on a row's first step and past its end."""
    if s == 0:
        return torch.zeros_like(mean)
    return torch.where(pmt[s], mean + torch.exp(0.5 * logvar) * noise[s - 1],
                       0.0)


def decoder_loop_plain(noise, lengths, w_cat, bias, b1, w2m, w2v, b2, w_ih,
                       h0, c0, return_carries: bool = False):
    """Plain PyTorch twin of the ``decoder_loop`` forward kernel: the scan
    body of models/decoder.py:_run_direction in sample mode, with the
    output slot map of decoder_pallas._fwd_call.

    Returns (outs (T, B, H) the PRE-mask h2 of each step, mean_s and
    logvar_s (T, B, F) position-indexed: slot p holds the emission computed
    at step p + 1, slot T - 1 step 0's), and with ``return_carries`` the
    masked carries hs, cs (T, B, H) after each step (the backward's
    residuals).
    """
    t, b, f, hidden, m = _check_loop((noise, lengths, w_cat, bias, b1, w2m,
                                      w2v, b2, w_ih, h0, c0))
    mt, pmt, _ = _masks(t, lengths, noise.device)
    h, c = h0, c0
    outs, means, logvars, hs, cs = [], [], [], [], []
    for s in range(t):
        big = h @ w_cat
        _, mean, logvar = _emission(big, 4 * hidden, m, b1, w2m, w2v, b2,
                                    f)
        x = _sampled_input(noise, s, pmt, mean, logvar)
        _, _, _, _, c2, h2 = _cell(big, x, w_ih, bias, c, hidden)
        h = torch.where(mt[s], h2, h)
        c = torch.where(mt[s], c2, c)
        outs.append(h2)
        means.append(mean)
        logvars.append(logvar)
        hs.append(h)
        cs.append(c)
    # step s's emission belongs to position s - 1; step 0's parks on T - 1
    shift = lambda xs: torch.stack(xs[1:] + xs[:1])
    out = (torch.stack(outs), shift(means), shift(logvars))
    return out + (torch.stack(hs), torch.stack(cs)) if return_carries else out


def decoder_loop_fwd(*args, save: bool = True):
    """The forward of ``decoder_loop``: (outs, mean_s, logvar_s, hs, cs);
    hs / cs are None when ``save`` is False (no backward follows, so the
    kernel writes neither).  CUDA tensors launch the kernel (one count on
    ``decoder_loop``); CPU tensors take the twin."""
    t, b, f, hidden, m = _check_loop(args)
    if args[0].device.type == "cpu":
        out = decoder_loop_plain(*args, return_carries=True)
        return out if save else out[:3] + (None, None)
    lib = _build.load("decoder")
    rows = _build.row_tile(lib, "decoder", _LOOP_FWD, (f, hidden, m, 0),
                           "decoder_loop")
    dev = args[0].device
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=dev)
    outs, mean_s, logvar_s = empty(t, b, hidden), empty(t, b, f), empty(t, b,
                                                                        f)
    hs, cs = (empty(t, b, hidden), empty(t, b, hidden)) if save else (None,
                                                                      None)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_decoder_loop_fwd(
            *[a.data_ptr() for a in args], outs.data_ptr(),
            mean_s.data_ptr(), logvar_s.data_ptr(), ptr(hs), ptr(cs), t, b,
            f, hidden, m, rows, stream)
    _build.check(lib, err, "decoder_loop")
    decoder_loop.launches += 1
    return outs, mean_s, logvar_s, hs, cs


def _loop_adjoint_plain(cell, noise, lengths, w_cat, biases, b1, w2m, w2v,
                        b2, w_ih, h0, c0, hs, cs, douts, dmean_s=None,
                        dlogvar_s=None, targets=None, gnll=None, leak=1.0):
    """The explicit reverse-time adjoint of a sampled loop without the
    offset MLP (not autograd through it), in the order of operations of
    decoder_pallas._bwd_kernel (the LSTM loop, with the position-indexed
    ``dmean_s`` / ``dlogvar_s``: step t's emission reads slot t - 1, none at
    t == 0), _gru_bwd_kernel, _rnn_bwd_kernel (``douts`` alone) and
    _fused_bwd_kernel with_offset=False (the LSTM's fused NLL: the
    emission's cotangents from ``targets`` and ``gnll``).  ``douts`` is the
    cotangent of each step's pre-mask h2; ``biases`` the cell's (bias,) or
    the GRU's (b_ih, b_hh).  Returns the weight gradients in the arguments'
    layouts, then dh0 (and the LSTM's dc0)."""
    t, b, f = noise.shape
    hidden, m = w_cat.shape[0], w2m.shape[0]
    gh = _CELLS[cell][1] * hidden
    mt, pmt, _ = _masks(t, lengths, noise.device)
    zero_f = noise.new_zeros((b, f))
    dh = h0.new_zeros((b, hidden))
    dc = h0.new_zeros((b, hidden))
    names = ("hp", "dbig", "x", "emh", "dem") + (("dnp",) if cell == "GRU"
                                                 else ())
    streams = {k: [None] * t for k in names}
    for s in reversed(range(t)):
        h_prev = hs[s - 1] if s > 0 else h0
        eps = noise[s - 1] if s > 0 else zero_f
        big = h_prev @ w_cat
        emh, mean, logvar = _emission(big, gh, m, b1, w2m, w2v, b2, f)
        std = torch.exp(0.5 * logvar)
        x = torch.where(pmt[s], mean + std * eps, 0.0)
        dh2 = douts[s] + torch.where(mt[s], dh, 0.0)
        dh_pass = torch.where(mt[s], 0.0, dh)
        if cell == "LSTM":
            c_prev = cs[s - 1] if s > 0 else c0
            i, fg, g, o, c2, _ = _cell(big, x, w_ih, biases[0], c_prev,
                                       hidden)
            tc = torch.tanh(c2)
            do = dh2 * tc
            dc2 = torch.where(mt[s], dc, 0.0) + dh2 * o * (1.0 - tc * tc)
            df, di, dg = dc2 * c_prev, dc2 * g, dc2 * i
            dgate = dxp = torch.cat([di * i * (1.0 - i), df * fg * (1.0 - fg),
                                     dg * (1.0 - g * g), do * o * (1.0 - o)],
                                    dim=-1)
            dc = torch.where(mt[s], 0.0, dc) + dc2 * fg
        elif cell == "GRU":
            r, z, n, hn, _ = _gru_cell(big, x, w_ih, *biases, h_prev, hidden)
            dn = dh2 * (1.0 - z)
            dz = dh2 * (h_prev - n)
            dh_pass = dh_pass + dh2 * z
            dnpre = dn * (1.0 - n * n)
            drpre = dnpre * hn * r * (1.0 - r)
            dzpre = dz * z * (1.0 - z)
            dxp = torch.cat([drpre, dzpre, dnpre], dim=-1)
            dgate = torch.cat([drpre, dzpre, dnpre * r], dim=-1)
            streams["dnp"][s] = dnpre
        else:
            u, _ = _rnn_cell(big, x, w_ih, biases[0], h_prev, hidden, leak)
            dgate = dxp = (leak * dh2) * (1.0 - u * u)
            dh_pass = dh_pass + (1.0 - leak) * dh2
        dx = torch.where(pmt[s], dxp @ w_ih.T, 0.0)
        if targets is not None:
            inv_var = torch.exp(-logvar)
            diff = (targets[s - 1] if s > 0 else zero_f) - mean
            gm = torch.where(pmt[s], gnll, 0.0)
            dmean = dx - gm * diff * inv_var
            dlogvar = dx * 0.5 * std * eps + gm * 0.5 * (1.0 - diff * inv_var
                                                         * diff)
        else:
            dmean, dlogvar = dx, dx * 0.5 * std * eps
        if dmean_s is not None and s > 0:
            dmean = dmean + dmean_s[s - 1]
            dlogvar = dlogvar + dlogvar_s[s - 1]
        demh = torch.cat([dmean @ w2m.T, dlogvar @ w2v.T], dim=-1)
        dbig = torch.cat([dgate, demh * (1.0 - emh * emh)], dim=-1)
        dh = dh_pass + dbig @ w_cat.T
        for k, v in (("hp", h_prev), ("dbig", dbig), ("x", x), ("emh", emh),
                     ("dem", torch.cat([dmean, dlogvar], -1))):
            streams[k][s] = v
    st = {k: torch.cat(v) for k, v in streams.items()}  # (T * B, .)
    grads = _weight_grads(st, hidden, m, f, wgrad.at_b_plain, cell)
    return grads + ((dh, dc) if cell == "LSTM" else (dh,))


def _loop_streams(t, b, f, hidden, m, g, dev, cell):
    """The (T, B, .) streams a loop backward kernel writes, in the order
    of its arguments."""
    widths = {"hp": hidden, "dbig": g, "x": f, "emh": 2 * m, "dem": 2 * f,
              "dnp": hidden}
    order = ("hp", "dbig", "x", "emh", "dem") + (("dnp",) if cell == "GRU"
                                                 else ())
    return {k: torch.empty((t, b, widths[k]), dtype=torch.float32,
                           device=dev) for k in order}


def _loop_bwd_launch(entry, what, kind, cell, fwd_args, w_idx, extra,
                     n_state, dims, scalars=()):
    """Launch a loop backward kernel (``lib.<entry>``): the forward's
    arguments, the transposes of the weights at ``w_idx`` (w_cat, w_ih,
    w2m, w2v), the ``extra`` tensors, the n_state initial-state cotangents
    and the streams, then ``dims`` (T, B, F, H, m), ``scalars`` and the row
    tile; then the weight gradients from the streams.  Returns the
    gradients and the initial-state cotangents."""
    t, b, f, hidden, m = dims
    dev = fwd_args[0].device
    lib = _build.load("decoder")
    rows = _build.row_tile(lib, "decoder", kind, (f, hidden, m, 0), what)
    transposed = [fwd_args[i].transpose(0, 1).contiguous() for i in w_idx]
    g = fwd_args[2].shape[1]
    st = _loop_streams(t, b, f, hidden, m, g, dev, cell)
    states = [torch.empty((b, hidden), dtype=torch.float32, device=dev)
              for _ in range(n_state)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            *[a.data_ptr() for a in fwd_args],
            *[w.data_ptr() for w in transposed],
            *[x.data_ptr() for x in extra], *[x.data_ptr() for x in states],
            *[v.data_ptr() for v in st.values()], t, b, f, hidden, m,
            *scalars, rows, stream)
        _build.check(lib, err, what)
        flat = {k: v.view(t * b, v.shape[-1]) for k, v in st.items()}
        grads = _weight_grads(flat, hidden, m, f, wgrad.at_b, cell)
    return grads + tuple(states)


def decoder_loop_bwd_plain(noise, lengths, w_cat, bias, b1, w2m, w2v, b2,
                           w_ih, h0, c0, hs, cs, douts, dmean_s, dlogvar_s):
    """Plain PyTorch twin of the ``decoder_loop`` backward kernel: the
    reverse-time adjoint of decoder_pallas._bwd_kernel.  ``douts`` (T, B, H)
    is the cotangent of outs, ``dmean_s`` / ``dlogvar_s`` (T, B, F) those of
    the position-indexed emission streams (slot T - 1, the caller's
    overwrite, is never read).  Returns (dw_cat, dbias, db1, dw2m, dw2v,
    db2, dw_ih, dh0, dc0)."""
    return _loop_adjoint_plain("LSTM", noise, lengths, w_cat, (bias,), b1,
                               w2m, w2v, b2, w_ih, h0, c0, hs, cs, douts,
                               dmean_s=dmean_s, dlogvar_s=dlogvar_s)


def decoder_loop_bwd(*args):
    """The backward of ``decoder_loop``: the forward's arguments, then hs,
    cs (the saved carries), douts, dmean_s and dlogvar_s.  Returns the 9
    gradients of ``decoder_loop_bwd_plain``.  CUDA tensors launch the
    reverse-time kernel, then ``ops/wgrad.py``'s reductions of its streams
    (one count); CPU tensors take the twin."""
    fwd_args, more = args[:11], args[11:]
    t, b, f, hidden, m = _check_loop(fwd_args)
    dev = fwd_args[0].device
    _check_more(dev, zip(("hs", "cs", "douts", "dmean_s", "dlogvar_s"), more,
                         ((t, b, hidden),) * 3 + ((t, b, f),) * 2))
    if dev.type == "cpu":
        return decoder_loop_bwd_plain(*args)
    grads = _loop_bwd_launch("abcd_decoder_loop_bwd", "decoder_loop backward",
                             _LOOP_BWD, "LSTM", fwd_args, (2, 8, 5, 6), more,
                             2, (t, b, f, hidden, m))
    decoder_loop_bwd.launches += 1
    return grads


decoder_loop_bwd.launches = 0


class _DecoderLoop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        outs, mean_s, logvar_s, hs, cs = decoder_loop_fwd(*args)
        ctx.save_for_backward(*args, hs, cs)
        return outs, mean_s, logvar_s

    @staticmethod
    def backward(ctx, douts, dmean_s, dlogvar_s):
        grads = decoder_loop_bwd(*ctx.saved_tensors, douts.contiguous(),
                                 dmean_s.contiguous(), dlogvar_s.contiguous())
        return (None, None) + grads


def decoder_loop(noise, lengths, w_cat, bias, b1, w2m, w2v, b2, w_ih, h0,
                 c0):
    """The whole sampled decoder loop, differentiable in every weight and
    in h0 / c0.

    Args in the order and layouts of decoder_pallas.decoder_loop: noise
    (T, B, F) UNSHIFTED (step t consumes noise[t - 1]), lengths (B,) int32,
    w_cat (H, 4H + 2m), bias (4H,) = b_ih + b_hh, b1 (2m,), w2m / w2v
    (m, F), b2 (2F,), w_ih (F, 4H), h0 / c0 (B, H).

    Returns (outs, mean_s, logvar_s) as :func:`decoder_loop_plain`.  CUDA
    tensors launch the kernel (one count); CPU tensors take the twin.
    Without autograd only the forward runs, and it saves no carries; with
    it, the backward is :func:`decoder_loop_bwd`.
    """
    args = (noise, lengths, w_cat, bias, b1, w2m, w2v, b2, w_ih, h0, c0)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _DecoderLoop.apply(*args)
    return decoder_loop_fwd(*args, save=False)[:3]


decoder_loop.launches = 0


def gru_decoder_loop_plain(noise, lengths, w_cat, b_ih, b_hh, b1, w2m, w2v,
                           b2, w_ih, h0, return_carries: bool = False):
    """Plain PyTorch twin of the ``gru_decoder_loop`` forward kernel: the
    loop of decoder_pallas._gru_fwd_kernel, step by step.  Returns outs
    (T, B, H), the PRE-mask h2 of each step, and with ``return_carries``
    also hs (T, B, H), the masked carries."""
    args = (noise, lengths, w_cat, b_ih, b_hh, b1, w2m, w2v, b2, w_ih, h0)
    t, b, f, hidden, m = _check_loop(args, "GRU")
    mt, pmt, _ = _masks(t, lengths, noise.device)
    h = h0
    outs, hs = [], []
    for s in range(t):
        big = h @ w_cat
        _, mean, logvar = _emission(big, 3 * hidden, m, b1, w2m, w2v, b2, f)
        x = _sampled_input(noise, s, pmt, mean, logvar)
        h2 = _gru_cell(big, x, w_ih, b_ih, b_hh, h, hidden)[-1]
        h = torch.where(mt[s], h2, h)
        outs.append(h2)
        hs.append(h)
    if return_carries:
        return torch.stack(outs), torch.stack(hs)
    return torch.stack(outs)


def gru_decoder_loop_fwd(*args, save: bool = True):
    """The forward of ``gru_decoder_loop``: (outs, hs); hs is None when
    ``save`` is False.  CUDA tensors launch the kernel (one count on
    ``gru_decoder_loop``); CPU tensors take the twin."""
    t, b, f, hidden, m = _check_loop(args, "GRU")
    if args[0].device.type == "cpu":
        outs, hs = gru_decoder_loop_plain(*args, return_carries=True)
        return outs, hs if save else None
    lib = _build.load("decoder")
    rows = _build.row_tile(lib, "decoder", _GRU_LOOP_FWD, (f, hidden, m, 0),
                           "gru_decoder_loop")
    dev = args[0].device
    outs = torch.empty((t, b, hidden), dtype=torch.float32, device=dev)
    hs = torch.empty_like(outs) if save else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_gru_decoder_loop_fwd(
            *[a.data_ptr() for a in args], outs.data_ptr(),
            None if hs is None else hs.data_ptr(), t, b, f, hidden, m, rows,
            stream)
    _build.check(lib, err, "gru_decoder_loop")
    gru_decoder_loop.launches += 1
    return outs, hs


def gru_decoder_loop_bwd_plain(noise, lengths, w_cat, b_ih, b_hh, b1, w2m,
                               w2v, b2, w_ih, h0, hs, douts):
    """Plain PyTorch twin of the ``gru_decoder_loop`` backward kernel: the
    reverse-time adjoint of decoder_pallas._gru_bwd_kernel; ``douts``
    (T, B, H) is the cotangent of outs.  Returns (dw_cat, db_ih, db_hh,
    db1, dw2m, dw2v, db2, dw_ih, dh0)."""
    return _loop_adjoint_plain("GRU", noise, lengths, w_cat, (b_ih, b_hh),
                               b1, w2m, w2v, b2, w_ih, h0, None, hs, None,
                               douts)


def gru_decoder_loop_bwd(*args):
    """The backward of ``gru_decoder_loop``: the forward's arguments, then
    hs (the saved carries) and douts.  Returns the 9 gradients of
    ``gru_decoder_loop_bwd_plain``.  CUDA tensors launch the reverse-time
    kernel, then ``ops/wgrad.py``'s reductions of its streams (one count);
    CPU tensors take the twin."""
    fwd_args, more = args[:11], args[11:]
    t, b, f, hidden, m = _check_loop(fwd_args, "GRU")
    dev = fwd_args[0].device
    _check_more(dev, zip(("hs", "douts"), more, ((t, b, hidden),) * 2))
    if dev.type == "cpu":
        return gru_decoder_loop_bwd_plain(*args)
    grads = _loop_bwd_launch("abcd_gru_decoder_loop_bwd",
                             "gru_decoder_loop backward", _GRU_LOOP_BWD,
                             "GRU", fwd_args, (2, 9, 6, 7), more, 1,
                             (t, b, f, hidden, m))
    gru_decoder_loop_bwd.launches += 1
    return grads


gru_decoder_loop_bwd.launches = 0


class _GRUDecoderLoop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        outs, hs = gru_decoder_loop_fwd(*args)
        ctx.save_for_backward(*args, hs)
        return outs

    @staticmethod
    def backward(ctx, douts):
        return (None, None) + gru_decoder_loop_bwd(*ctx.saved_tensors,
                                                   douts.contiguous())


def gru_decoder_loop(noise, lengths, w_cat, b_ih, b_hh, b1, w2m, w2v, b2,
                     w_ih, h0):
    """The whole sampled GRU decoder loop, differentiable in every weight
    and in h0.

    Args in the order and layouts of decoder_pallas.gru_decoder_loop: noise
    (T, B, F) UNSHIFTED (step t consumes noise[t - 1]), lengths (B,) int32,
    w_cat (H, 3H + 2m), b_ih and b_hh (3H,) apart (b_hh sits inside the
    reset product), b1 (2m,), w2m / w2v (m, F), b2 (2F,), w_ih (F, 3H),
    h0 (B, H).

    Returns outs (T, B, H), the pre-mask h2 of each step, as the JAX
    function does (the caller computes the emissions from them).  CUDA
    tensors launch the kernel (one count); CPU tensors take
    ``gru_decoder_loop_plain``.  Without autograd only the forward runs,
    and it saves no carries; with it, the backward is
    :func:`gru_decoder_loop_bwd`.
    """
    args = (noise, lengths, w_cat, b_ih, b_hh, b1, w2m, w2v, b2, w_ih, h0)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _GRUDecoderLoop.apply(*args)
    return gru_decoder_loop_fwd(*args, save=False)[0]


gru_decoder_loop.launches = 0


def rnn_decoder_loop_plain(noise, lengths, w_cat, bias, b1, w2m, w2v, b2,
                           w_ih, h0, leak=1.0, return_carries: bool = False):
    """Plain PyTorch twin of the ``rnn_decoder_loop`` forward kernel: the
    loop of decoder_pallas._rnn_fwd_kernel, step by step.  Returns outs
    (T, B, H), the PRE-mask h2 of each step, and with ``return_carries``
    also hs (T, B, H), the masked carries."""
    args = (noise, lengths, w_cat, bias, b1, w2m, w2v, b2, w_ih, h0)
    t, b, f, hidden, m = _check_loop(args, "RNN")
    mt, pmt, _ = _masks(t, lengths, noise.device)
    h = h0
    outs, hs = [], []
    for s in range(t):
        big = h @ w_cat
        _, mean, logvar = _emission(big, hidden, m, b1, w2m, w2v, b2, f)
        x = _sampled_input(noise, s, pmt, mean, logvar)
        h2 = _rnn_cell(big, x, w_ih, bias, h, hidden, leak)[1]
        h = torch.where(mt[s], h2, h)
        outs.append(h2)
        hs.append(h)
    if return_carries:
        return torch.stack(outs), torch.stack(hs)
    return torch.stack(outs)


def rnn_decoder_loop_fwd(*args, leak=1.0, save: bool = True):
    """The forward of ``rnn_decoder_loop``: (outs, hs); hs is None when
    ``save`` is False.  CUDA tensors launch the kernel (one count on
    ``rnn_decoder_loop``); CPU tensors take the twin."""
    t, b, f, hidden, m = _check_loop(args, "RNN")
    leak = _check_leak(leak)
    if args[0].device.type == "cpu":
        outs, hs = rnn_decoder_loop_plain(*args, leak=leak,
                                          return_carries=True)
        return outs, hs if save else None
    lib = _build.load("decoder")
    rows = _build.row_tile(lib, "decoder", _RNN_LOOP_FWD, (f, hidden, m, 0),
                           "rnn_decoder_loop")
    dev = args[0].device
    outs = torch.empty((t, b, hidden), dtype=torch.float32, device=dev)
    hs = torch.empty_like(outs) if save else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_rnn_decoder_loop_fwd(
            *[a.data_ptr() for a in args], outs.data_ptr(),
            None if hs is None else hs.data_ptr(), t, b, f, hidden, m, leak,
            rows, stream)
    _build.check(lib, err, "rnn_decoder_loop")
    rnn_decoder_loop.launches += 1
    return outs, hs


def rnn_decoder_loop_bwd_plain(noise, lengths, w_cat, bias, b1, w2m, w2v,
                               b2, w_ih, h0, hs, douts, leak=1.0):
    """Plain PyTorch twin of the ``rnn_decoder_loop`` backward kernel: the
    reverse-time adjoint of decoder_pallas._rnn_bwd_kernel; ``douts``
    (T, B, H) is the cotangent of outs.  Returns (dw_cat, dbias, db1, dw2m,
    dw2v, db2, dw_ih, dh0)."""
    return _loop_adjoint_plain("RNN", noise, lengths, w_cat, (bias,), b1,
                               w2m, w2v, b2, w_ih, h0, None, hs, None, douts,
                               leak=leak)


def rnn_decoder_loop_bwd(*args, leak=1.0):
    """The backward of ``rnn_decoder_loop``: the forward's arguments, then
    hs (the saved carries) and douts.  Returns the 8 gradients of
    ``rnn_decoder_loop_bwd_plain``.  CUDA tensors launch the reverse-time
    kernel, then ``ops/wgrad.py``'s reductions of its streams (one count);
    CPU tensors take the twin."""
    fwd_args, more = args[:10], args[10:]
    t, b, f, hidden, m = _check_loop(fwd_args, "RNN")
    leak = _check_leak(leak)
    dev = fwd_args[0].device
    _check_more(dev, zip(("hs", "douts"), more, ((t, b, hidden),) * 2))
    if dev.type == "cpu":
        return rnn_decoder_loop_bwd_plain(*args, leak=leak)
    grads = _loop_bwd_launch("abcd_rnn_decoder_loop_bwd",
                             "rnn_decoder_loop backward", _RNN_LOOP_BWD,
                             "RNN", fwd_args, (2, 8, 5, 6), more, 1,
                             (t, b, f, hidden, m), (leak,))
    rnn_decoder_loop_bwd.launches += 1
    return grads


rnn_decoder_loop_bwd.launches = 0


class _RNNDecoderLoop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, leak, *args):
        outs, hs = rnn_decoder_loop_fwd(*args, leak=leak)
        ctx.save_for_backward(*args, hs)
        ctx.leak = leak
        return outs

    @staticmethod
    def backward(ctx, douts):
        return (None, None, None) + rnn_decoder_loop_bwd(
            *ctx.saved_tensors, douts.contiguous(), leak=ctx.leak)


def rnn_decoder_loop(noise, lengths, w_cat, bias, b1, w2m, w2v, b2, w_ih, h0,
                     leak=1.0):
    """The whole sampled Elman / ESN decoder loop, differentiable in every
    weight and in h0.

    Args in the order and layouts of decoder_pallas.rnn_decoder_loop: noise
    (T, B, F) UNSHIFTED, lengths (B,) int32, w_cat (H, H + 2m), bias (H,)
    = b_ih + b_hh (zeros for the ESN), b1 (2m,), w2m / w2v (m, F), b2
    (2F,), w_ih (F, H), h0 (B, H); ``leak`` in (0, 1] (below 1 the ESN's).

    Returns outs (T, B, H), the pre-mask h2 of each step.  CUDA tensors
    launch the kernel (one count); CPU tensors take
    ``rnn_decoder_loop_plain``.  Without autograd only the forward runs,
    and it saves no carries; with it, the backward is
    :func:`rnn_decoder_loop_bwd`.
    """
    args = (noise, lengths, w_cat, bias, b1, w2m, w2v, b2, w_ih, h0)
    leak = _check_leak(leak)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _RNNDecoderLoop.apply(leak, *args)
    return rnn_decoder_loop_fwd(*args, leak=leak, save=False)[0]


rnn_decoder_loop.launches = 0


# ---------------------------------------------------------------------------
# the LSTM loop with the emission NLL fused (decoder_pallas.
# decoder_loop_fused_nll: the fused-loss kernels with with_offset=False)
# ---------------------------------------------------------------------------

_NLL_NAMES = ("noise", "lengths", "w_cat", "bias", "b1", "w2m", "w2v", "b2",
              "w_ih", "targets", "h0", "c0")


def _check_nll(args):
    """Shapes, types and devices of a ``decoder_loop_fused_nll`` call: the
    ``decoder_loop`` arguments and targets (T, B, F)."""
    if len(args) != len(_NLL_NAMES):
        raise TypeError(f"expected {len(_NLL_NAMES)} arguments")
    dims = _check_loop(args[:9] + args[10:])
    targets = args[9]
    _check_more(args[0].device, (("targets", targets, tuple(args[0].shape)),))
    return dims


def decoder_fused_nll_fwd_plain(noise, lengths, w_cat, bias, b1, w2m, w2v,
                                b2, w_ih, targets, h0, c0):
    """Plain PyTorch twin of the fused-NLL forward kernel
    (decoder_pallas._fused_fwd_kernel with with_offset=False): the sampled
    loop, and the Gaussian NLL of positions 0..T-2 of its position-indexed
    emissions against ``targets`` where the position is valid.

    Returns (outs (T, B, H) the pre-mask h2 of each step, nll (), hs, cs
    (T, B, H) the masked carries).
    """
    outs, mean_s, logvar_s, hs, cs = decoder_loop_plain(
        noise, lengths, w_cat, bias, b1, w2m, w2v, b2, w_ih, h0, c0,
        return_carries=True)
    t = noise.shape[0]
    valid = (torch.arange(t - 1, device=noise.device)[:, None]
             < lengths.long()[None, :]).unsqueeze(-1)
    mean, logvar = mean_s[:-1], logvar_s[:-1]
    diff = targets[:-1] - mean
    nll_s = 0.5 * (_LOG_2PI + logvar + diff * torch.exp(-logvar) * diff)
    return outs, torch.where(valid, nll_s, 0.0).sum(), hs, cs


def decoder_fused_nll_fwd(*args, save: bool = True):
    """The fused-NLL forward: (outs, nll, hs, cs); hs / cs are None when
    ``save`` is False (no backward follows, so the kernel writes neither).
    CUDA tensors launch the kernel (one count); CPU tensors take
    ``decoder_fused_nll_fwd_plain``."""
    t, b, f, hidden, m = _check_nll(args)
    dev = args[0].device
    if dev.type == "cpu":
        out = decoder_fused_nll_fwd_plain(*args)
        return out if save else out[:2] + (None, None)
    lib = _build.load("decoder")
    rows = _build.row_tile(lib, "decoder", _NLL_FWD, (f, hidden, m, 0),
                           "decoder_loop_fused_nll")
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=dev)
    outs = empty(t, b, hidden)
    hs, cs = (empty(t, b, hidden), empty(t, b, hidden)) if save else (None,
                                                                      None)
    blocks = -(-b // rows)
    partial = torch.empty((blocks, 2), dtype=torch.float64, device=dev)
    losses = empty(2)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_decoder_nll_fwd(
            *[a.data_ptr() for a in args], outs.data_ptr(), ptr(hs), ptr(cs),
            partial.data_ptr(), losses.data_ptr(), t, b, f, hidden, m, rows,
            stream)
    _build.check(lib, err, "decoder_loop_fused_nll")
    decoder_fused_nll_fwd.launches += 1
    return outs, losses[0].clone(), hs, cs


decoder_fused_nll_fwd.launches = 0


def decoder_fused_nll_bwd_plain(noise, lengths, w_cat, bias, b1, w2m, w2v,
                                b2, w_ih, targets, h0, c0, hs, cs, douts,
                                gscale):
    """Plain PyTorch twin of the fused-NLL backward kernel: the reverse-time
    adjoint of decoder_pallas._fused_bwd_kernel with with_offset=False.
    ``douts`` (T, B, H) is the cotangent of outs, ``gscale`` (1,) that of
    nll; the emission's cotangents come from the targets.  Returns (dw_cat,
    dbias, db1, dw2m, dw2v, db2, dw_ih, dh0, dc0)."""
    return _loop_adjoint_plain("LSTM", noise, lengths, w_cat, (bias,), b1,
                               w2m, w2v, b2, w_ih, h0, c0, hs, cs, douts,
                               targets=targets, gnll=gscale[0])


def decoder_fused_nll_bwd(*args):
    """The fused-NLL backward: the forward's arguments, then hs, cs (the
    saved carries), douts (T, B, H) and gscale (1,) = the cotangent of nll.
    Returns the 9 gradients of ``decoder_fused_nll_bwd_plain``.  CUDA
    tensors launch the reverse-time kernel, then ``ops/wgrad.py``'s
    reductions of its streams (one count); CPU tensors take the twin."""
    fwd_args, more = args[:12], args[12:]
    t, b, f, hidden, m = _check_nll(fwd_args)
    dev = fwd_args[0].device
    _check_more(dev, zip(("hs", "cs", "douts", "gscale"), more,
                         ((t, b, hidden),) * 3 + ((1,),)))
    if dev.type == "cpu":
        return decoder_fused_nll_bwd_plain(*args)
    grads = _loop_bwd_launch("abcd_decoder_nll_bwd",
                             "decoder_loop_fused_nll backward", _NLL_BWD,
                             "LSTM", fwd_args, (2, 8, 5, 6), more, 2,
                             (t, b, f, hidden, m))
    decoder_fused_nll_bwd.launches += 1
    return grads


decoder_fused_nll_bwd.launches = 0


class _DecoderFusedNll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        outs, nll, hs, cs = decoder_fused_nll_fwd(*args)
        ctx.save_for_backward(*args, hs, cs)
        return outs, nll

    @staticmethod
    def backward(ctx, douts, dnll):
        grads = decoder_fused_nll_bwd(*ctx.saved_tensors, douts.contiguous(),
                                      dnll.reshape(1).float().contiguous())
        return (None, None) + grads[:7] + (None,) + grads[7:]


def decoder_loop_fused_nll(noise, lengths, w_cat, bias, b1, w2m, w2v, b2,
                           w_ih, targets, h0, c0):
    """The LSTM decoder loop with the Gaussian emission NLL fused, as
    decoder_pallas.decoder_loop_fused_nll: (outs (T, B, H) the pre-mask h2
    of each step, nll ()), differentiable in every weight and in h0 / c0.
    nll covers positions 0..T-2 (the caller adds T-1's term from outs[-1]);
    targets are (T, B, F) position-major.  Without autograd only the
    forward runs, and it saves no carries."""
    args = (noise, lengths, w_cat, bias, b1, w2m, w2v, b2, w_ih, targets,
            h0, c0)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _DecoderFusedNll.apply(*args)
    return decoder_fused_nll_fwd(*args, save=False)[:2]
