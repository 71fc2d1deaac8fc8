"""Masked LSTM layers, forward and backward: the CUDA kernels of
``csrc/lstm.cu`` and their plain PyTorch twins.

- ``lstm_layer_bidir_fused`` replaces
  seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:lstm_layer_bidir_fused, forward
  (``_fwdf_call`` / ``_fwdf_kernel``) and backward (``_bwdf_call`` /
  ``_bwdf_kernel``): both directions of one layer over RAW inputs, the
  input projection x_t @ W_ih run per step inside the kernel, direction 1
  reading time reversed.
- ``lstm_layer`` replaces seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:lstm_layer,
  forward (``_fwd_call`` / ``_fwd_kernel``) and backward (``_bwd_call`` /
  ``_bwd_kernel``): one direction over a precomputed xp = x @ W_ih + b_ih,
  with ``reverse`` selecting the flipped span [T - len, T).
- ``lstm_layer_bidir`` replaces
  seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:lstm_layer_bidir, forward
  (``_fwd2_call`` / ``_fwd2_kernel``) and backward (``_bwd2_call`` /
  ``_bwd2_kernel``): both directions over a precomputed xp (T, 2, B, 4H),
  direction 1 already flipped in time, in one launch.  Nothing in either
  package calls it; it is a public function of its own.

A row's carries are frozen outside its span and ``outs`` holds the masked
carry.  The kernels' time loops are sequential.  The forwards have two
designs (one direction) or three (raw), chosen by a shape rule before the
launch (``forward_design``, ``layer_design``): W_hh (and the raw
forward's W_ih) split across a thread-block cluster and held in its shared
memory for the whole sequence, or one block per row tile re-reading the
weights from L2 every step (see the source).  The raw forward's third
design, ``"proj"``, takes the widths whose W_ih slice does not fit a
cluster (F=177 at 44.1 kHz, F=193 at 48 kHz, a second layer's F = 2H): the
input projection of every active row-step of both directions as one tiled
product, then both directions' recurrence over it in the cluster design's
projected mode, one launch.  The backwards of both layers (raw and one
direction) have two designs, by ``backward_design``: both recompute the
gates of every active row-step at once as one tiled product, so only dh's
recurrence stays sequential; ``"cluster"`` (H a multiple of 32 up to 256)
runs it in thread-block clusters holding W_hh, ``"tile"`` (H=1024, H=200,
any other H) as one tiled product a step over the whole grid, issued from
a C loop; the raw layer then forms dx after the loop, and the weight
gradients are taken over the active row-steps only (``"cluster"`` of the
raw layer still reduces its streams with ``ops/wgrad.py``).  The
backwards recompute the gates from the saved h/c trajectories;
``lstm_layer_bidir_fused_train``, ``lstm_layer_train`` and
``lstm_layer_bidir_train`` wire them into ``torch.autograd``.  Each
wrapper
launches its kernel for CUDA tensors and takes its twin only for CPU
tensors.  The kernels pick their row tile (8, 4 or 2 rows a block) at
launch so that shared memory fits the card; the widest hidden size is what
shared memory admits (``_build.row_tile`` says so when it does not).

Layouts are the JAX package's: w_ih (2, F, 4H), w_hh (2, H, 4H) and
b_ih / b_hh (2, 4H) for a pair, w_hh (H, 4H) and b_hh (4H,) for one
direction, gates in torch order (i, f, g, o).
"""

from __future__ import annotations

import functools

import torch

from . import _build, wgrad

# kernel kinds of csrc/lstm.cu's per-tile kernels (abcd_lstm_rows)
_BIDIR_FWD, _FWD, _PAIR_FWD, _PAIR_BWD = 0, 2, 4, 5

# The raw forward's cluster design (csrc/lstm.cu, lstm_fwd_cluster_kernel):
# batch rows a cluster's tile (kClusterRows there), and the most waves of
# resident clusters the shape rule lets it take (``forward_design``).  On
# an H100 (700 W) a wave of cluster steps takes ~6.2 us a step and the
# per-tile kernel ~47 us a step at any batch up to 1,056 rows, so seven
# waves (B <= 520 with 15 resident clusters) is where the cluster design
# stops winning against it (PERF.md); a larger batch takes the "proj"
# design where it takes H.
CLUSTER_ROWS = 10
CLUSTER_MAX_WAVES = 7
# The raw backward's cluster recurrence (lstm_bwd_cluster_kernel): batch
# rows a cluster's tile (kBwdClusterRows there; B=512 in two waves of the
# 15 resident clusters of an H100).  The one-direction forward's cluster
# design (lstm_fwd_cluster_kernel's projected mode): the row tiles built
# for it, a narrow one that fills a wave with the served batches and a
# wide one that pays less a row (on an H100 at 700 W, ~5.1 us a step at
# 12 rows, ~11.6 us at 36; PERF.md).  Both cluster designs take every
# batch: at B=512 a row-step costs about a quarter (backward) and half
# (forward) of the per-tile kernels', whose grids also run in waves.
BWD_CLUSTER_ROWS = 36
PROJ_CLUSTER_TILES = (12, 36)


def lstm_step(w_hh: torch.Tensor, b_hh: torch.Tensor, x_proj: torch.Tensor,
              h: torch.Tensor, c: torch.Tensor):
    """One LSTM cell step from a precomputed ``x @ w_ih + b_ih``.

    Works on one direction (h (B, H), w_hh (H, 4H), b_hh (4H,)) or on the
    stacked pair (h (2, B, H), w_hh (2, H, 4H), b_hh (2, 4H)).
    """
    gates = x_proj + torch.matmul(h, w_hh) + b_hh.unsqueeze(-2)
    i, f, g, o = gates.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, c2


def _span(t: int, lengths: torch.Tensor, reverse: bool,
          device) -> torch.Tensor:
    """(T, B, 1) step masks: active while t < len, or, reversed, while
    t >= T - len (ops/_mask_utils.span_mask)."""
    steps = torch.arange(t, device=device)[:, None]
    lengths = lengths.to(device)[None, :]
    active = steps >= t - lengths if reverse else steps < lengths
    return active.unsqueeze(-1)


def _active(t: int, lengths: torch.Tensor, device) -> torch.Tensor:
    """(T, 2, B, 1) step masks of the two directions, direction 1 in its
    own flipped time."""
    return torch.stack([_span(t, lengths, False, device),
                        _span(t, lengths, True, device)], dim=1)


def lstm_layer_bidir_fused_plain(x, lengths, w_ih, b_ih, w_hh, b_hh,
                                 return_cs: bool = False):
    """Plain PyTorch twin of the forward kernel: same signature, same
    result.

    Returns (outs (T, 2, B, H) with direction 1 in its own flipped time,
    h_n (2, B, H), c_n (2, B, H)), and the saved cell states ``cs``
    (T, 2, B, H) after them when ``return_cs``.
    """
    t, b, _ = x.shape
    hidden = w_hh.shape[1]
    xs = torch.stack([x, x.flip(0)], dim=1)                  # (T, 2, B, F)
    active = _active(t, lengths, x.device)                   # (T, 2, B, 1)
    h = x.new_zeros((2, b, hidden))
    c = x.new_zeros((2, b, hidden))
    outs, cs = [], []
    for s in range(t):
        x_proj = torch.matmul(xs[s], w_ih) + b_ih.unsqueeze(-2)
        h2, c2 = lstm_step(w_hh, b_hh, x_proj, h, c)
        h = torch.where(active[s], h2, h)
        c = torch.where(active[s], c2, c)
        outs.append(h)
        cs.append(c)
    if return_cs:
        return torch.stack(outs), h, c, torch.stack(cs)
    return torch.stack(outs), h, c


def _check(x, lengths, w_ih, b_ih, w_hh, b_hh, gates: int = 4):
    """Shapes, types and devices of a two-direction layer over raw x with
    ``gates`` gate blocks (4 for the LSTM, 3 for the GRU)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (T, B, F), got {tuple(x.shape)}")
    t, b, f = x.shape
    hidden = w_hh.shape[-2] if w_hh.dim() == 3 else -1
    g = gates * hidden
    want = {"x": (x, (t, b, f)), "w_ih": (w_ih, (2, f, g)),
            "b_ih": (b_ih, (2, g)), "w_hh": (w_hh, (2, hidden, g)),
            "b_hh": (b_hh, (2, g))}
    for name, (tensor, shape) in want.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensor.shape)}, "
                             f"expected {shape}")
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
        if tensor.device != x.device:
            raise ValueError(f"{name} is on {tensor.device}, x on "
                             f"{x.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be int32 of shape (B,), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if lengths.device != x.device:
        raise ValueError(f"lengths is on {lengths.device}, x on {x.device}")
    if t < 1 or hidden < 1:
        raise ValueError("need at least one step and one hidden unit")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def forward_design(max_active: int, batch: int, pair_active: dict) -> str:
    """The shape rule of the raw forward, in this order: ``"cluster"`` when
    the raw cluster design fits these widths (``max_active`` > 0, the
    card's ``cudaOccupancyMaxActiveClusters`` for it: F <= 129 at H=256)
    and its 2 * ceil(B / R) clusters run in at most ``CLUSTER_MAX_WAVES``
    waves; else ``"proj"`` when the pair's projected mode takes H
    (``pair_active`` maps each tile of ``PROJ_CLUSTER_TILES`` to the card's
    resident clusters for it, 0 where it does not: H a multiple of 8 up to
    256, any F, any B); else ``"tile"`` (the per-tile kernel: H=1024, H
    not a multiple of 8)."""
    if max_active > 0:
        clusters = 2 * -(-batch // CLUSTER_ROWS)
        if -(-clusters // max_active) <= CLUSTER_MAX_WAVES:
            return "cluster"
    return "proj" if any(n > 0 for n in pair_active.values()) else "tile"


def backward_design(max_active: int) -> str:
    """The shape rule of both backwards (raw and one direction):
    ``"cluster"`` when the cluster recurrence takes these widths
    (``max_active`` > 0, the card's resident clusters for it at
    ``BWD_CLUSTER_ROWS``: H a multiple of 32 up to 256, the W_hh slice in
    shared memory; F does not count), else ``"tile"``, the grid design,
    which takes any H."""
    return "cluster" if max_active > 0 else "tile"


def layer_design(active: dict, batch: int, directions: int = 1):
    """The shape rule of the one-direction forward: (``"cluster"``, row
    tile) when the projected mode of the cluster design takes these widths
    (``active`` maps each tile of ``PROJ_CLUSTER_TILES`` to the card's
    resident clusters, 0 where it does not: H a multiple of 8 up to 256):
    the smallest tile whose ``directions`` * ceil(B / rows) clusters run
    in one wave, else the widest; (``"tile"``, 0) otherwise, H=1024 among
    others.  With ``directions`` = 2 it picks the raw forward's ``"proj"``
    row tile."""
    fits = sorted(rows for rows, n in active.items() if n > 0)
    for rows in fits:
        if directions * -(-batch // rows) <= active[rows]:
            return "cluster", rows
    return ("cluster", fits[-1]) if fits else ("tile", 0)


def backward_design_for(lib, device_index: int, hidden: int) -> str:
    """The design ``backward_design`` picks for both backwards on this card
    at hidden size H."""
    return backward_design(_cluster_active(lib, device_index, "bwd", 0,
                                           hidden, BWD_CLUSTER_ROWS))


@functools.lru_cache(maxsize=None)
def _cluster_active(lib, device_index: int, kind: str, f: int, hidden: int,
                    rows: int) -> int:
    """Resident clusters of a cluster design on this card (0: it does not
    take these widths), queried once per card, design and widths: ``kind``
    is the raw forward (``"fwd"``), the one-direction forward
    (``"layer"``), the raw forward's pair recurrence (``"pair"``) or the
    raw backward's recurrence (``"bwd"``)."""
    with torch.cuda.device(device_index):
        if kind == "fwd":
            return lib.abcd_lstm_cluster_max_active(f, hidden)
        if kind == "layer":
            return lib.abcd_lstm_fwd_cluster_max_active(hidden, rows)
        if kind == "pair":
            return lib.abcd_lstm_pair_cluster_max_active(hidden, rows)
        return lib.abcd_lstm_bwd_cluster_max_active(hidden, rows)


def _tile_active(lib, device, kind: str, hidden: int) -> dict:
    """Resident clusters of each tile of ``PROJ_CLUSTER_TILES`` for the
    projected mode of one direction (``"layer"``) or two (``"pair"``)."""
    return {rows: _cluster_active(lib, device.index, kind, 0, hidden, rows)
            for rows in PROJ_CLUSTER_TILES}


def _layer_design(lib, device, hidden: int, batch: int):
    """(design, row tile) of the one-direction forward by ``layer_design``
    on this card."""
    return layer_design(_tile_active(lib, device, "layer", hidden), batch)


def lstm_layer_bidir_fused(x, lengths, w_ih, b_ih, w_hh, b_hh,
                           return_cs: bool = False):
    """Both directions of one masked LSTM layer over raw inputs.

    Args:
      x: (T, B, F) float32, original time order.
      lengths: (B,) int32 valid steps per row.
      w_ih (2, F, 4H), b_ih (2, 4H), w_hh (2, H, 4H), b_hh (2, 4H).

    Returns (outs (T, 2, B, H), h_n (2, B, H), c_n (2, B, H)), as
    ``lstm_pallas.lstm_layer_bidir_fused``, and with ``return_cs`` the
    saved cell states (T, 2, B, H) for the backward (serving asks for
    none, so it writes no extra bytes).  CUDA tensors launch the design
    that ``forward_design`` picks for the shape on the current stream (and
    count one launch, on the wrapper and on ``.cluster``, ``.proj`` or
    ``.tile``); CPU tensors take ``lstm_layer_bidir_fused_plain``.
    """
    _check(x, lengths, w_ih, b_ih, w_hh, b_hh)
    if x.device.type == "cpu":
        return lstm_layer_bidir_fused_plain(x, lengths, w_ih, b_ih, w_hh,
                                            b_hh, return_cs)
    lib = _build.load("lstm")
    hidden = w_hh.shape[1]
    active = _cluster_active(lib, x.device.index, "fwd", x.shape[2], hidden,
                             CLUSTER_ROWS)
    design = forward_design(active, x.shape[1],
                            _tile_active(lib, x.device, "pair", hidden))
    return lstm_layer_bidir_fused_on(design, x, lengths, w_ih, b_ih, w_hh,
                                     b_hh, return_cs)


def lstm_layer_bidir_fused_on(design: str, x, lengths, w_ih, b_ih, w_hh,
                              b_hh, return_cs: bool = False, marks=None):
    """``lstm_layer_bidir_fused`` on CUDA tensors through the named design,
    ``"cluster"``, ``"proj"`` or ``"tile"``, whatever the shape rule says:
    for timing one design against another.  Raises when the design does
    not take the shape or its launch fails.  ``marks``, a list, gets CUDA
    events recorded on the current stream around the ``"proj"`` design's
    parts, (a) the input projection (with the span prefix) and (b) the
    recurrence (three events)."""
    _check(x, lengths, w_ih, b_ih, w_hh, b_hh)
    if x.device.type != "cuda" or design not in ("cluster", "proj", "tile"):
        raise ValueError(f"design {design!r} on {x.device}: a CUDA tensor "
                         "and 'cluster', 'proj' or 'tile' are needed")
    t, b, f = x.shape
    hidden = w_hh.shape[1]
    lib = _build.load("lstm")
    outs = torch.empty((t, 2, b, hidden), dtype=x.dtype, device=x.device)
    cs = torch.empty_like(outs) if return_cs else None
    h_n = torch.empty((2, b, hidden), dtype=x.dtype, device=x.device)
    c_n = torch.empty((2, b, hidden), dtype=x.dtype, device=x.device)
    result = (outs, h_n, c_n, cs) if return_cs else (outs, h_n, c_n)
    if b == 0:
        return result
    what = f"lstm_layer_bidir_fused ({design})"
    ptrs = (x.data_ptr(), lengths.data_ptr(), w_ih.data_ptr(),
            b_ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            outs.data_ptr(), None if cs is None else cs.data_ptr(),
            h_n.data_ptr(), c_n.data_ptr(), t, b, f, hidden)
    if design == "tile":
        rows = _build.row_tile(lib, "lstm", _BIDIR_FWD, (f, hidden),
                               "lstm_layer_bidir_fused")
    elif design == "proj":
        picked, rows = layer_design(_tile_active(lib, x.device, "pair",
                                                 hidden), b, directions=2)
        if picked != "cluster":
            raise RuntimeError(f"{what} refused: no cluster of its "
                               f"recurrence is resident at H={hidden} on "
                               "this card")

    mark = _marker(marks)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if design == "tile":
            err = lib.abcd_lstm_bidir_fwd(*ptrs, rows, stream)
        elif design == "cluster":
            err = lib.abcd_lstm_bidir_fwd_cluster(*ptrs, stream)
        else:
            # (a) xp of every active row-step (the others unwritten, and
            # never read), then (b) the pair recurrence over it
            mark()
            prefix = _span_prefix(lib, lengths, t, b, stream, what)
            xp = torch.empty((t, 2, b, 4 * hidden), dtype=x.dtype,
                             device=x.device)
            err = lib.abcd_lstm_bidir_xp(x.data_ptr(), prefix.data_ptr(),
                                         w_ih.data_ptr(), b_ih.data_ptr(),
                                         xp.data_ptr(), t, b, f, hidden,
                                         stream)
            _build.check(lib, err, what)
            mark()
            err = lib.abcd_lstm_bidir_fwd_proj(
                xp.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
                b_hh.data_ptr(), *ptrs[6:10], t, b, hidden, rows, stream)
            mark()
    _build.check(lib, err, what)
    lstm_layer_bidir_fused.launches += 1
    getattr(lstm_layer_bidir_fused, design).launches += 1
    return result


lstm_layer_bidir_fused.launches = 0
lstm_layer_bidir_fused.cluster = _build.Launches()
lstm_layer_bidir_fused.proj = _build.Launches()
lstm_layer_bidir_fused.tile = _build.Launches()


def lstm_layer_bidir_fused_bwd_plain(x, lengths, w_ih, b_ih, w_hh, b_hh,
                                     outs, cs, douts, dh_n, dc_n):
    """Plain PyTorch twin of the backward kernel: the explicit
    reverse-time adjoint of ``lstm_layer_bidir_fused_plain`` (not autograd
    through it), in the TPU kernel's order of operations.

    Args as the forward's, plus its saved ``outs`` and ``cs``
    (T, 2, B, H), ``douts`` (T, 2, B, H) or None for a zero cotangent, and
    ``dh_n`` / ``dc_n`` (2, B, H).  Returns (dx (T, B, F), dw_ih, db_ih,
    dw_hh, db_hh) in the weights' layouts.
    """
    t, b, _ = x.shape
    hidden = w_hh.shape[1]
    xs = torch.stack([x, x.flip(0)], dim=1)                  # (T, 2, B, F)
    active = _active(t, lengths, x.device)
    zero = x.new_zeros((2, b, hidden))
    w_ih_t, w_hh_t = w_ih.transpose(1, 2), w_hh.transpose(1, 2)
    dh, dc = dh_n, dc_n
    dzs, hps, dxs = [None] * t, [None] * t, [None] * t
    for s in reversed(range(t)):
        h_prev = outs[s - 1] if s > 0 else zero
        c_prev = cs[s - 1] if s > 0 else zero
        act = active[s]
        gates = (((torch.matmul(xs[s], w_ih) + b_ih.unsqueeze(-2))
                  + torch.matmul(h_prev, w_hh)) + b_hh.unsqueeze(-2))
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c2 = torch.where(act, cs[s], f * c_prev + i * g)
        tc = torch.tanh(c2)
        dh_t = dh if douts is None else dh + douts[s]
        dh_step = torch.where(act, dh_t, 0.0)
        dc_step = torch.where(act, dc, 0.0)
        do = dh_step * tc
        dc2 = dc_step + dh_step * o * (1.0 - tc * tc)
        df, di, dg = dc2 * c_prev, dc2 * g, dc2 * i
        dz = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                        dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        dh = torch.where(act, 0.0, dh_t) + torch.matmul(dz, w_hh_t)
        dc = torch.where(act, dc2 * f, dc)
        dzs[s], hps[s], dxs[s] = dz, h_prev, torch.matmul(dz, w_ih_t)
    dz, hp, dx_own = torch.stack(dzs), torch.stack(hps), torch.stack(dxs)
    dx = dx_own[:, 0] + dx_own[:, 1].flip(0)
    dw_ih = torch.einsum("tdbf,tdbg->dfg", xs, dz)
    dw_hh = torch.einsum("tdbh,tdbg->dhg", hp, dz)
    db = dz.sum(dim=(0, 2))
    return dx, dw_ih, db, dw_hh, db.clone()


def _check_bwd_state(x, w_hh, outs, cs, douts, dh_n, dc_n):
    """The raw backward's saved states and cotangents (douts may be
    None)."""
    t, b, _ = x.shape
    state = (t, 2, b, w_hh.shape[1])
    for name, tensor, shape in (("outs", outs, state), ("cs", cs, state),
                                ("douts", douts, state),
                                ("dh_n", dh_n, state[1:]),
                                ("dc_n", dc_n, state[1:])):
        if tensor is None and name == "douts":
            continue
        if (tuple(tensor.shape) != shape or tensor.dtype != torch.float32
                or tensor.device != x.device or not tensor.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{x.device}")


def lstm_layer_bidir_fused_bwd(x, lengths, w_ih, b_ih, w_hh, b_hh, outs, cs,
                               douts, dh_n, dc_n):
    """The layer's backward: (dx, dw_ih, db_ih, dw_hh, db_hh).

    CUDA tensors launch the design that ``backward_design`` picks for the
    shape, then ``ops/wgrad.py``'s reductions of its streams (counted as
    one launch of this wrapper, and one on ``.cluster`` or ``.tile``); CPU
    tensors take ``lstm_layer_bidir_fused_bwd_plain``.  ``douts`` may be
    None: the final layer's outs feed nothing, and the kernel then reads no
    (T, 2, B, H) zero stream.
    """
    _check(x, lengths, w_ih, b_ih, w_hh, b_hh)
    _check_bwd_state(x, w_hh, outs, cs, douts, dh_n, dc_n)
    if x.device.type == "cpu":
        return lstm_layer_bidir_fused_bwd_plain(
            x, lengths, w_ih, b_ih, w_hh, b_hh, outs, cs, douts, dh_n, dc_n)
    lib = _build.load("lstm")
    design = backward_design_for(lib, x.device.index, w_hh.shape[1])
    return _bidir_fused_bwd(lib, design, x, lengths, w_ih, b_ih, w_hh, b_hh,
                            outs, cs, douts, dh_n, dc_n, None)


def lstm_layer_bidir_fused_bwd_on(design: str, x, lengths, w_ih, b_ih, w_hh,
                                  b_hh, outs, cs, douts, dh_n, dc_n,
                                  marks=None):
    """``lstm_layer_bidir_fused_bwd`` on CUDA tensors through the named
    design, ``"cluster"`` or ``"tile"``, whatever the shape rule says: for
    timing one design against the other.  Raises when the design does not
    take the shape (before any launch) or a launch fails.

    ``marks``, a list, gets CUDA events recorded on the current stream
    around the parts of either design: (a) gate recompute (with the span
    prefix), (b) recurrence, (c) dx, (d) weight gradients (five
    events)."""
    _check(x, lengths, w_ih, b_ih, w_hh, b_hh)
    _check_bwd_state(x, w_hh, outs, cs, douts, dh_n, dc_n)
    if x.device.type != "cuda" or design not in ("cluster", "tile"):
        raise ValueError(f"design {design!r} on {x.device}: a CUDA tensor "
                         "and 'cluster' or 'tile' are needed")
    return _bidir_fused_bwd(_build.load("lstm"), design, x, lengths, w_ih,
                            b_ih, w_hh, b_hh, outs, cs, douts, dh_n, dc_n,
                            marks)


def _marker(marks):
    """A function recording a CUDA event into ``marks`` (None: nothing)."""
    def mark():
        if marks is not None:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            marks.append(event)
    return mark


def _span_prefix(lib, lengths, t, b, stream, what):
    """(B + 1,) active steps of the rows before each row (either span)."""
    prefix = torch.empty(b + 1, dtype=torch.int32, device=lengths.device)
    err = lib.abcd_lstm_span_prefix(lengths.data_ptr(), prefix.data_ptr(), t,
                                    b, stream)
    _build.check(lib, err, what)
    return prefix


def _grid_recurrence(lib, lengths, w_hh, cs, douts, dh_n, dc_n, dz, reverse,
                     stream, what):
    """The grid design's part (b) over the gates in ``dz``, which become dz:
    w_hh (D, H, 4H), the streams (T, D, B, .), D = 1 or 2."""
    d, hidden = w_hh.shape[0], w_hh.shape[1]
    b = lengths.shape[0]
    w_hh_t = w_hh.transpose(1, 2).contiguous()
    order = torch.empty(b, dtype=torch.int32, device=dz.device)
    dh_s = torch.empty((d, b, hidden), dtype=dz.dtype, device=dz.device)
    dc_s = torch.empty_like(dh_s)
    err = lib.abcd_lstm_bwd_grid(
        lengths.data_ptr(), order.data_ptr(), w_hh_t.data_ptr(),
        cs.data_ptr(), None if douts is None else douts.data_ptr(),
        dh_n.data_ptr(), dc_n.data_ptr(), dz.data_ptr(), dh_s.data_ptr(),
        dc_s.data_ptr(), cs.shape[0], b, hidden, d, int(reverse), stream)
    _build.check(lib, err, what)


def _prefix_wgrad(lib, x, prefix, outs, dz, d, hidden, reverse, stream,
                  what):
    """Part (d) over the active row-steps: (dw_ih (D, F, 4H) or None
    without x, dw_hh (D, H, 4H), db (D, 4H))."""
    t, b = outs.shape[0], outs.shape[-2]
    f = 0 if x is None else x.shape[2]
    g = 4 * hidden
    dev = dz.device
    splits = lib.abcd_lstm_wgrad_splits(t, b, f, hidden, d)
    part = torch.empty((splits, d, f + hidden + 1, g), dtype=dz.dtype,
                       device=dev)
    dw_ih = (None if x is None else
             torch.empty((d, f, g), dtype=dz.dtype, device=dev))
    dw_hh = torch.empty((d, hidden, g), dtype=dz.dtype, device=dev)
    db = torch.empty((d, g), dtype=dz.dtype, device=dev)
    err = lib.abcd_lstm_wgrad(
        None if x is None else x.data_ptr(), prefix.data_ptr(),
        outs.data_ptr(), dz.data_ptr(), part.data_ptr(),
        None if dw_ih is None else dw_ih.data_ptr(), dw_hh.data_ptr(),
        db.data_ptr(), t, b, f, hidden, d, int(reverse), splits, stream)
    _build.check(lib, err, what)
    return dw_ih, dw_hh, db


def _bidir_fused_bwd(lib, design, x, lengths, w_ih, b_ih, w_hh, b_hh, outs,
                     cs, douts, dh_n, dc_n, marks):
    """The backward's launches on checked CUDA tensors (see
    ``lstm_layer_bidir_fused_bwd_on``)."""
    t, b, f = x.shape
    hidden = w_hh.shape[1]
    g = 4 * hidden
    what = f"lstm_layer_bidir_fused backward ({design})"
    if design == "cluster" and _cluster_active(
            lib, x.device.index, "bwd", 0, hidden, BWD_CLUSTER_ROWS) <= 0:
        raise RuntimeError(f"{what} refused: no cluster of its recurrence "
                           f"is resident at H={hidden} on this card")
    douts_ptr = None if douts is None else douts.data_ptr()
    mark = _marker(marks)
    # the gates of every active row-step, then dz over them; rows outside
    # every span keep dx's zeros
    dz = torch.empty((2, t, b, g), dtype=x.dtype, device=x.device)
    dx = torch.zeros((t, b, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        mark()
        # (a) the gates (and, for the cluster design's weight gradients,
        # the h_prev stream)
        prefix = _span_prefix(lib, lengths, t, b, stream, what)
        hp = (torch.zeros((2, t, b, hidden), dtype=x.dtype, device=x.device)
              if design == "cluster" else None)
        err = lib.abcd_lstm_bidir_gates(
            x.data_ptr(), prefix.data_ptr(), w_ih.data_ptr(),
            b_ih.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            outs.data_ptr(), dz.data_ptr(),
            None if hp is None else hp.data_ptr(), t, b, f, hidden, stream)
        _build.check(lib, err, what)
        mark()
        # (b) the recurrence
        if design == "tile":
            _grid_recurrence(lib, lengths, w_hh, cs, douts, dh_n, dc_n, dz,
                             False, stream, what)
        else:
            err = lib.abcd_lstm_bidir_bwd_cluster(
                lengths.data_ptr(), w_hh.data_ptr(), cs.data_ptr(),
                douts_ptr, dh_n.data_ptr(), dc_n.data_ptr(), dz.data_ptr(),
                t, b, hidden, BWD_CLUSTER_ROWS, stream)
            _build.check(lib, err, what)
        mark()
        # (c) dx
        err = lib.abcd_lstm_bidir_dx(dz.data_ptr(), prefix.data_ptr(),
                                     w_ih.data_ptr(), dx.data_ptr(), t, b, f,
                                     hidden, stream)
        _build.check(lib, err, what)
        mark()
        # (d) the weight gradients
        if design == "tile":
            dw_ih, dw_hh, db = _prefix_wgrad(lib, x, prefix, outs, dz, 2,
                                             hidden, False, stream, what)
        else:
            x_rows = x.view(t * b, f)
            dw_ih = torch.stack([wgrad.at_b(x_rows, dz[d].view(t * b, g))
                                 for d in range(2)])
            dw_hh = torch.stack([wgrad.at_b(hp[d].view(t * b, hidden),
                                            dz[d].view(t * b, g))
                                 for d in range(2)])
            db = torch.cat([wgrad.at_b(None, dz[d].view(t * b, g))
                            for d in range(2)])
        mark()
    lstm_layer_bidir_fused_bwd.launches += 1
    getattr(lstm_layer_bidir_fused_bwd, design).launches += 1
    return dx, dw_ih, db, dw_hh, db.clone()


lstm_layer_bidir_fused_bwd.launches = 0
lstm_layer_bidir_fused_bwd.cluster = _build.Launches()
lstm_layer_bidir_fused_bwd.tile = _build.Launches()


class _LSTMBidirFused(torch.autograd.Function):
    """Forward kernel (saving ``cs``) and backward kernel as one
    differentiable op; ``lengths`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, lengths, w_ih, b_ih, w_hh, b_hh):
        outs, h_n, c_n, cs = lstm_layer_bidir_fused(
            x, lengths, w_ih, b_ih, w_hh, b_hh, return_cs=True)
        ctx.save_for_backward(x, lengths, w_ih, b_ih, w_hh, b_hh, outs, cs)
        # an unused output (the final layer's outs) arrives as None, and
        # the backward kernel then reads no zero stream
        ctx.set_materialize_grads(False)
        return outs, h_n, c_n

    @staticmethod
    def backward(ctx, douts, dh_n, dc_n):
        x, lengths, w_ih, b_ih, w_hh, b_hh, outs, cs = ctx.saved_tensors
        zero = outs.new_zeros(outs.shape[1:])
        dh_n = zero if dh_n is None else dh_n.contiguous()
        dc_n = zero if dc_n is None else dc_n.contiguous()
        douts = None if douts is None else douts.contiguous()
        dx, dw_ih, db_ih, dw_hh, db_hh = lstm_layer_bidir_fused_bwd(
            x, lengths, w_ih, b_ih, w_hh, b_hh, outs, cs, douts, dh_n, dc_n)
        return dx, None, dw_ih, db_ih, dw_hh, db_hh


def lstm_layer_bidir_fused_train(x, lengths, w_ih, b_ih, w_hh, b_hh):
    """``lstm_layer_bidir_fused`` with gradients to x and the four
    weights, through the backward kernel (or its twin on the CPU)."""
    return _LSTMBidirFused.apply(x, lengths, w_ih, b_ih, w_hh, b_hh)


# ---------------------------------------------------------------------------
# one direction over a precomputed input projection (lstm_pallas.lstm_layer)
# ---------------------------------------------------------------------------

def lstm_layer_plain(xp, lengths, w_hh, b_hh, reverse: bool = False,
                     return_cs: bool = False):
    """Plain PyTorch twin of the one-direction forward kernel: same
    signature, same result.

    Returns (outs (T, B, H), h_n (B, H), c_n (B, H)), outs the masked
    carry after each step, and the saved cell states ``cs`` (T, B, H) after
    them when ``return_cs``.
    """
    t, b, _ = xp.shape
    hidden = w_hh.shape[0]
    active = _span(t, lengths, reverse, xp.device)
    h = xp.new_zeros((b, hidden))
    c = xp.new_zeros((b, hidden))
    outs, cs = [], []
    for s in range(t):
        h2, c2 = lstm_step(w_hh, b_hh, xp[s], h, c)
        h = torch.where(active[s], h2, h)
        c = torch.where(active[s], c2, c)
        outs.append(h)
        cs.append(c)
    if return_cs:
        return torch.stack(outs), h, c, torch.stack(cs)
    return torch.stack(outs), h, c


def _check_layer(xp, lengths, w_hh, b_hh, gates: int = 4, **state):
    """Shapes, types and devices of a one-direction call with ``gates``
    gate blocks (4 for the LSTM, 3 for the GRU, 1 for the Elman cell), and
    of the backward's saved states and cotangents, passed by name (None
    skips)."""
    if xp.dim() != 3 or w_hh.dim() != 2:
        raise ValueError(f"xp must be (T, B, {gates}H) and w_hh (H, "
                         f"{gates}H), got {tuple(xp.shape)} and "
                         f"{tuple(w_hh.shape)}")
    t, b, g = xp.shape
    hidden = w_hh.shape[0]
    if t < 1 or hidden < 1 or g != gates * hidden:
        raise ValueError(f"xp {tuple(xp.shape)} does not match w_hh "
                         f"{tuple(w_hh.shape)}")
    want = {"xp": (xp, (t, b, g)), "w_hh": (w_hh, (hidden, g)),
            "b_hh": (b_hh, (g,))}
    for name, tensor in state.items():
        if tensor is not None:
            want[name] = (tensor, (t, b, hidden) if name in (
                "outs", "cs", "douts") else (b, hidden))
    for name, (tensor, shape) in want.items():
        if (tuple(tensor.shape) != shape or tensor.dtype != torch.float32
                or tensor.device != xp.device
                or not tensor.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{xp.device}, got {tensor.dtype} "
                             f"{tuple(tensor.shape)} on {tensor.device}")
    if (tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32
            or lengths.device != xp.device):
        raise ValueError(f"lengths must be int32 of shape ({b},) on "
                         f"{xp.device}")
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xp.device}")


def lstm_layer(xp, lengths, w_hh, b_hh, reverse: bool = False,
               return_cs: bool = False):
    """One direction of a masked LSTM layer over a projected input.

    Args:
      xp: (T, B, 4H) float32, x @ W_ih + b_ih (time-flipped by the caller
        for the reverse direction).
      lengths: (B,) int32 valid steps per row.
      w_hh (H, 4H), b_hh (4H,).
      reverse: active on [T - len, T) instead of [0, len).

    Returns (outs (T, B, H), h_n (B, H), c_n (B, H)), as
    ``lstm_pallas.lstm_layer``, and with ``return_cs`` the saved cell
    states (T, B, H) for the backward.  CUDA tensors launch the design that
    ``layer_design`` picks for the shape on the current stream (and count
    one launch, on the wrapper and on ``.cluster`` or ``.tile``); CPU
    tensors take ``lstm_layer_plain``.
    """
    _check_layer(xp, lengths, w_hh, b_hh)
    if xp.device.type == "cpu":
        return lstm_layer_plain(xp, lengths, w_hh, b_hh, reverse, return_cs)
    lib = _build.load("lstm")
    design, rows = _layer_design(lib, xp.device, w_hh.shape[0], xp.shape[1])
    return lstm_layer_on(design, xp, lengths, w_hh, b_hh, reverse,
                         return_cs, rows=rows)


def lstm_layer_on(design: str, xp, lengths, w_hh, b_hh,
                  reverse: bool = False, return_cs: bool = False,
                  rows=None):
    """``lstm_layer`` on CUDA tensors through the named design,
    ``"cluster"`` or ``"tile"``, whatever the shape rule says: for timing
    one design against the other.  Raises when the design does not take
    the shape or its launch fails.  ``rows``: the cluster's row tile (one
    of ``PROJ_CLUSTER_TILES``; by default the rule's, or the widest where
    the rule keeps the per-tile kernel, whose launch then fails)."""
    _check_layer(xp, lengths, w_hh, b_hh)
    if xp.device.type != "cuda" or design not in ("cluster", "tile"):
        raise ValueError(f"design {design!r} on {xp.device}: a CUDA tensor "
                         "and 'cluster' or 'tile' are needed")
    t, b, _ = xp.shape
    hidden = w_hh.shape[0]
    lib = _build.load("lstm")
    if design == "tile":
        rows = _build.row_tile(lib, "lstm", _FWD, (0, hidden), "lstm_layer")
    elif not rows:
        picked, rows = _layer_design(lib, xp.device, hidden, b)
        rows = rows if picked == "cluster" else max(PROJ_CLUSTER_TILES)
    outs = torch.empty((t, b, hidden), dtype=xp.dtype, device=xp.device)
    cs = torch.empty_like(outs) if return_cs else None
    h_n = torch.empty((b, hidden), dtype=xp.dtype, device=xp.device)
    c_n = torch.empty_like(h_n)
    result = (outs, h_n, c_n, cs) if return_cs else (outs, h_n, c_n)
    if b == 0:
        return result
    ptrs = (xp.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), outs.data_ptr(),
            None if cs is None else cs.data_ptr(), h_n.data_ptr(),
            c_n.data_ptr(), t, b, hidden, int(reverse))
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        if design == "tile":
            err = lib.abcd_lstm_fwd(*ptrs, rows, stream)
        else:
            err = lib.abcd_lstm_fwd_cluster(*ptrs, rows, stream)
    _build.check(lib, err, f"lstm_layer ({design})")
    lstm_layer.launches += 1
    getattr(lstm_layer, design).launches += 1
    return result


lstm_layer.launches = 0
lstm_layer.cluster = _build.Launches()
lstm_layer.tile = _build.Launches()


def lstm_layer_bwd_plain(xp, lengths, w_hh, b_hh, outs, cs, douts, dh_n,
                         dc_n, reverse: bool = False):
    """Plain PyTorch twin of the one-direction backward kernel: the
    explicit reverse-time adjoint of ``lstm_layer_plain`` (not autograd
    through it), in the order of operations of lstm_pallas._bwd_kernel.

    Args as the forward's, plus its saved ``outs`` and ``cs`` (T, B, H),
    ``douts`` (T, B, H) or None for a zero cotangent, and ``dh_n`` /
    ``dc_n`` (B, H).  Returns (dxp (T, B, 4H), dw_hh (H, 4H), db_hh (4H,)).
    """
    t, b, _ = xp.shape
    hidden = w_hh.shape[0]
    active = _span(t, lengths, reverse, xp.device)
    zero = xp.new_zeros((b, hidden))
    w_hh_t = w_hh.transpose(0, 1)
    dh, dc = dh_n, dc_n
    dzs, hps = [None] * t, [None] * t
    for s in reversed(range(t)):
        h_prev = outs[s - 1] if s > 0 else zero
        c_prev = cs[s - 1] if s > 0 else zero
        act = active[s]
        gates = (xp[s] + torch.matmul(h_prev, w_hh)) + b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c2 = torch.where(act, cs[s], f * c_prev + i * g)
        tc = torch.tanh(c2)
        dh_t = dh if douts is None else dh + douts[s]
        dh_step = torch.where(act, dh_t, 0.0)
        dc_step = torch.where(act, dc, 0.0)
        do = dh_step * tc
        dc2 = dc_step + dh_step * o * (1.0 - tc * tc)
        df, di, dg = dc2 * c_prev, dc2 * g, dc2 * i
        dz = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                        dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        dh = torch.where(act, 0.0, dh_t) + torch.matmul(dz, w_hh_t)
        dc = torch.where(act, dc2 * f, dc)
        dzs[s], hps[s] = dz, h_prev
    dxp, hp = torch.stack(dzs), torch.stack(hps)
    dw_hh = torch.einsum("tbh,tbg->hg", hp, dxp)
    return dxp, dw_hh, dxp.sum(dim=(0, 1))


def lstm_layer_bwd(xp, lengths, w_hh, b_hh, outs, cs, douts, dh_n, dc_n,
                   reverse: bool = False):
    """The one-direction layer's backward: (dxp, dw_hh, db_hh).

    CUDA tensors launch the design that ``backward_design`` picks for the
    shape (the raw backward's rule and values), counted as one launch of
    this wrapper and one on ``.cluster`` or ``.tile``; CPU tensors take
    ``lstm_layer_bwd_plain``.  ``douts`` may be None: the final layer's outs
    feed nothing, and the kernels then read no (T, B, H) zero stream.
    """
    _check_layer(xp, lengths, w_hh, b_hh, outs=outs, cs=cs, douts=douts,
                 dh_n=dh_n, dc_n=dc_n)
    if xp.device.type == "cpu":
        return lstm_layer_bwd_plain(xp, lengths, w_hh, b_hh, outs, cs,
                                    douts, dh_n, dc_n, reverse)
    lib = _build.load("lstm")
    design = backward_design_for(lib, xp.device.index, w_hh.shape[0])
    return _layer_bwd(lib, design, xp, lengths, w_hh, b_hh, outs, cs, douts,
                      dh_n, dc_n, reverse, None)


def lstm_layer_bwd_on(design: str, xp, lengths, w_hh, b_hh, outs, cs, douts,
                      dh_n, dc_n, reverse: bool = False, marks=None):
    """``lstm_layer_bwd`` on CUDA tensors through the named design,
    ``"cluster"`` or ``"tile"``, whatever the shape rule says: for timing
    one design against the other.  Raises when the design does not take
    the shape (before any launch) or a launch fails.  ``marks``, a list,
    gets CUDA events recorded on the current stream around (a) the gate
    recompute (with the span prefix), (b) the recurrence and (d) the
    weight gradients (four events)."""
    _check_layer(xp, lengths, w_hh, b_hh, outs=outs, cs=cs, douts=douts,
                 dh_n=dh_n, dc_n=dc_n)
    if xp.device.type != "cuda" or design not in ("cluster", "tile"):
        raise ValueError(f"design {design!r} on {xp.device}: a CUDA tensor "
                         "and 'cluster' or 'tile' are needed")
    return _layer_bwd(_build.load("lstm"), design, xp, lengths, w_hh, b_hh,
                      outs, cs, douts, dh_n, dc_n, reverse, marks)


def _layer_bwd(lib, design, xp, lengths, w_hh, b_hh, outs, cs, douts, dh_n,
               dc_n, reverse, marks):
    """Row 3b's launches on checked CUDA tensors: (a) the gates of every
    active row-step, (b) the recurrence over them (dz, which is dxp), (d)
    the weight gradients over the active row-steps."""
    t, b, g = xp.shape
    hidden = w_hh.shape[0]
    what = f"lstm_layer backward ({design})"
    if design == "cluster" and _cluster_active(
            lib, xp.device.index, "bwd", 0, hidden, BWD_CLUSTER_ROWS) <= 0:
        raise RuntimeError(f"{what} refused: no cluster of its recurrence "
                           f"is resident at H={hidden} on this card")
    mark = _marker(marks)
    dxp = torch.empty((t, b, g), dtype=xp.dtype, device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        mark()
        prefix = _span_prefix(lib, lengths, t, b, stream, what)
        err = lib.abcd_lstm_layer_gates(
            xp.data_ptr(), prefix.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), outs.data_ptr(), dxp.data_ptr(), t, b, hidden,
            int(reverse), stream)
        _build.check(lib, err, what)
        mark()
        if design == "tile":
            _grid_recurrence(lib, lengths, w_hh.unsqueeze(0),
                             cs.unsqueeze(1), douts, dh_n, dc_n, dxp,
                             reverse, stream, what)
        else:
            err = lib.abcd_lstm_bwd_cluster(
                lengths.data_ptr(), w_hh.data_ptr(), cs.data_ptr(),
                None if douts is None else douts.data_ptr(),
                dh_n.data_ptr(), dc_n.data_ptr(), dxp.data_ptr(), t, b,
                hidden, int(reverse), BWD_CLUSTER_ROWS, stream)
            _build.check(lib, err, what)
        mark()
        _, dw_hh, db_hh = _prefix_wgrad(lib, None, prefix, outs, dxp, 1,
                                        hidden, reverse, stream, what)
        mark()
    lstm_layer_bwd.launches += 1
    getattr(lstm_layer_bwd, design).launches += 1
    return dxp, dw_hh[0], db_hh[0]


lstm_layer_bwd.launches = 0
lstm_layer_bwd.cluster = _build.Launches()
lstm_layer_bwd.tile = _build.Launches()


class _LSTMLayer(torch.autograd.Function):
    """One-direction forward kernel (saving ``cs``) and backward kernel as
    one differentiable op; ``lengths`` gets no gradient."""

    @staticmethod
    def forward(ctx, xp, lengths, w_hh, b_hh, reverse):
        outs, h_n, c_n, cs = lstm_layer(xp, lengths, w_hh, b_hh, reverse,
                                        return_cs=True)
        ctx.save_for_backward(xp, lengths, w_hh, b_hh, outs, cs)
        ctx.reverse = reverse
        # an unused output (a final layer's outs) arrives as None, and the
        # backward kernel then reads no zero stream
        ctx.set_materialize_grads(False)
        return outs, h_n, c_n

    @staticmethod
    def backward(ctx, douts, dh_n, dc_n):
        xp, lengths, w_hh, b_hh, outs, cs = ctx.saved_tensors
        zero = outs.new_zeros(outs.shape[1:])
        dh_n = zero if dh_n is None else dh_n.contiguous()
        dc_n = zero if dc_n is None else dc_n.contiguous()
        douts = None if douts is None else douts.contiguous()
        dxp, dw_hh, db_hh = lstm_layer_bwd(xp, lengths, w_hh, b_hh, outs,
                                           cs, douts, dh_n, dc_n,
                                           ctx.reverse)
        return dxp, None, dw_hh, db_hh, None


def lstm_layer_train(xp, lengths, w_hh, b_hh, reverse: bool = False):
    """``lstm_layer`` with gradients to xp, w_hh and b_hh, through the
    backward kernel (or its twin on the CPU)."""
    return _LSTMLayer.apply(xp, lengths, w_hh, b_hh, reverse)


# ---------------------------------------------------------------------------
# both directions over a precomputed input projection, in one launch
# (lstm_pallas.lstm_layer_bidir)
# ---------------------------------------------------------------------------

def lstm_layer_bidir_plain(xp, lengths, w_hh, b_hh, return_cs: bool = False):
    """Plain PyTorch twin of the two-direction forward kernel over xp: same
    signature, same result.

    Returns (outs (T, 2, B, H), h_n (2, B, H), c_n (2, B, H)), outs the
    masked carry after each step (direction 1 in its own flipped time), and
    the saved cell states ``cs`` (T, 2, B, H) after them when
    ``return_cs``.
    """
    t, _, b, _ = xp.shape
    hidden = w_hh.shape[1]
    active = _active(t, lengths, xp.device)                  # (T, 2, B, 1)
    h = xp.new_zeros((2, b, hidden))
    c = xp.new_zeros((2, b, hidden))
    outs, cs = [], []
    for s in range(t):
        h2, c2 = lstm_step(w_hh, b_hh, xp[s], h, c)
        h = torch.where(active[s], h2, h)
        c = torch.where(active[s], c2, c)
        outs.append(h)
        cs.append(c)
    if return_cs:
        return torch.stack(outs), h, c, torch.stack(cs)
    return torch.stack(outs), h, c


def _check_pair(xp, lengths, w_hh, b_hh, **state):
    """Shapes, types and devices of a two-direction call over xp, and of the
    backward's saved states and cotangents, passed by name (None skips)."""
    if xp.dim() != 4 or w_hh.dim() != 3:
        raise ValueError(f"xp must be (T, 2, B, 4H) and w_hh (2, H, 4H), "
                         f"got {tuple(xp.shape)} and {tuple(w_hh.shape)}")
    t, two, b, g = xp.shape
    hidden = w_hh.shape[1]
    if t < 1 or hidden < 1 or two != 2 or g != 4 * hidden:
        raise ValueError(f"xp {tuple(xp.shape)} does not match w_hh "
                         f"{tuple(w_hh.shape)}")
    want = {"xp": (xp, (t, 2, b, g)), "w_hh": (w_hh, (2, hidden, g)),
            "b_hh": (b_hh, (2, g))}
    for name, tensor in state.items():
        if tensor is not None:
            want[name] = (tensor, (t, 2, b, hidden) if name in (
                "outs", "cs", "douts") else (2, b, hidden))
    for name, (tensor, shape) in want.items():
        if (tuple(tensor.shape) != shape or tensor.dtype != torch.float32
                or tensor.device != xp.device
                or not tensor.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{xp.device}, got {tensor.dtype} "
                             f"{tuple(tensor.shape)} on {tensor.device}")
    if (tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32
            or lengths.device != xp.device):
        raise ValueError(f"lengths must be int32 of shape ({b},) on "
                         f"{xp.device}")
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xp.device}")


def lstm_layer_bidir(xp, lengths, w_hh, b_hh, return_cs: bool = False):
    """Both directions of a masked LSTM layer over a projected input, in one
    launch.

    Args:
      xp: (T, 2, B, 4H) float32, x @ W_ih + b_ih per direction, direction 1
        already flipped in time (models/rnn.run_rnn_layer_bidir's layout).
      lengths: (B,) int32 valid steps per row.
      w_hh (2, H, 4H), b_hh (2, 4H).

    Returns (outs (T, 2, B, H), h_n (2, B, H), c_n (2, B, H)), as
    ``lstm_pallas.lstm_layer_bidir``, and with ``return_cs`` the saved cell
    states (T, 2, B, H) for the backward.  CUDA tensors launch the kernel on
    the current stream (and count one launch); CPU tensors take
    ``lstm_layer_bidir_plain``.
    """
    _check_pair(xp, lengths, w_hh, b_hh)
    if xp.device.type == "cpu":
        return lstm_layer_bidir_plain(xp, lengths, w_hh, b_hh, return_cs)
    t, _, b, _ = xp.shape
    hidden = w_hh.shape[1]
    lib = _build.load("lstm")
    rows = _build.row_tile(lib, "lstm", _PAIR_FWD, (0, hidden),
                           "lstm_layer_bidir")
    outs = torch.empty((t, 2, b, hidden), dtype=xp.dtype, device=xp.device)
    cs = torch.empty_like(outs) if return_cs else None
    h_n = torch.empty((2, b, hidden), dtype=xp.dtype, device=xp.device)
    c_n = torch.empty_like(h_n)
    result = (outs, h_n, c_n, cs) if return_cs else (outs, h_n, c_n)
    if b == 0:
        return result
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_lstm_bidir_proj_fwd(
            xp.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), outs.data_ptr(),
            None if cs is None else cs.data_ptr(), h_n.data_ptr(),
            c_n.data_ptr(), t, b, hidden, rows, stream)
    _build.check(lib, err, "lstm_layer_bidir")
    lstm_layer_bidir.launches += 1
    return result


lstm_layer_bidir.launches = 0


def lstm_layer_bidir_bwd_plain(xp, lengths, w_hh, b_hh, outs, cs, douts,
                               dh_n, dc_n):
    """Plain PyTorch twin of the two-direction backward kernel: the explicit
    reverse-time adjoint of ``lstm_layer_bidir_plain`` (not autograd through
    it), in the order of operations of lstm_pallas._bwd2_kernel: ``douts``
    adds at every step, inactive ones too, and dh passes through an
    inactive step unchanged.

    Args as the forward's, plus its saved ``outs`` and ``cs``
    (T, 2, B, H), ``douts`` (T, 2, B, H) or None for a zero cotangent, and
    ``dh_n`` / ``dc_n`` (2, B, H).  Returns (dxp (T, 2, B, 4H),
    dw_hh (2, H, 4H), db_hh (2, 4H)).
    """
    t, _, b, _ = xp.shape
    hidden = w_hh.shape[1]
    active = _active(t, lengths, xp.device)
    zero = xp.new_zeros((2, b, hidden))
    w_hh_t = w_hh.transpose(1, 2)
    dh, dc = dh_n, dc_n
    dzs, hps = [None] * t, [None] * t
    for s in reversed(range(t)):
        h_prev = outs[s - 1] if s > 0 else zero
        c_prev = cs[s - 1] if s > 0 else zero
        act = active[s]
        gates = (xp[s] + torch.matmul(h_prev, w_hh)) + b_hh.unsqueeze(-2)
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c2 = torch.where(act, cs[s], f * c_prev + i * g)
        tc = torch.tanh(c2)
        dh_t = dh if douts is None else dh + douts[s]
        dh_step = torch.where(act, dh_t, 0.0)
        dc_step = torch.where(act, dc, 0.0)
        do = dh_step * tc
        dc2 = dc_step + dh_step * o * (1.0 - tc * tc)
        df, di, dg = dc2 * c_prev, dc2 * g, dc2 * i
        dz = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                        dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        dh = torch.where(act, 0.0, dh_t) + torch.matmul(dz, w_hh_t)
        dc = torch.where(act, dc2 * f, dc)
        dzs[s], hps[s] = dz, h_prev
    dxp, hp = torch.stack(dzs), torch.stack(hps)
    dw_hh = torch.einsum("tdbh,tdbg->dhg", hp, dxp)
    return dxp, dw_hh, dxp.sum(dim=(0, 2))


def lstm_layer_bidir_bwd(xp, lengths, w_hh, b_hh, outs, cs, douts, dh_n,
                         dc_n):
    """The two-direction layer's backward: (dxp, dw_hh, db_hh).

    CUDA tensors launch the reverse-time kernel once for both directions,
    then ``ops/wgrad.py``'s reductions of its streams per direction, in a
    fixed order (counted as one launch of this wrapper); dxp comes back as
    a (T, 2, B, 4H) view of the kernel's direction-major dz stream.  CPU
    tensors take ``lstm_layer_bidir_bwd_plain``.  ``douts`` may be None
    (a zero cotangent): the kernel then reads no (T, 2, B, H) zero stream.
    """
    _check_pair(xp, lengths, w_hh, b_hh, outs=outs, cs=cs, douts=douts,
                dh_n=dh_n, dc_n=dc_n)
    if xp.device.type == "cpu":
        return lstm_layer_bidir_bwd_plain(xp, lengths, w_hh, b_hh, outs, cs,
                                          douts, dh_n, dc_n)
    t, _, b, g = xp.shape
    hidden = w_hh.shape[1]
    lib = _build.load("lstm")
    rows = _build.row_tile(lib, "lstm", _PAIR_BWD, (0, hidden),
                           "lstm_layer_bidir backward")
    w_hh_t = w_hh.transpose(1, 2).contiguous()
    dz = torch.empty((2, t, b, g), dtype=xp.dtype, device=xp.device)
    hp = torch.empty((2, t, b, hidden), dtype=xp.dtype, device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_lstm_bidir_proj_bwd(
            xp.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), w_hh_t.data_ptr(), outs.data_ptr(),
            cs.data_ptr(), None if douts is None else douts.data_ptr(),
            dh_n.data_ptr(), dc_n.data_ptr(), dz.data_ptr(), hp.data_ptr(),
            t, b, hidden, rows, stream)
        _build.check(lib, err, "lstm_layer_bidir backward")
        dw_hh = torch.stack([wgrad.at_b(hp[d].view(t * b, hidden),
                                        dz[d].view(t * b, g))
                             for d in range(2)])
        db_hh = torch.cat([wgrad.at_b(None, dz[d].view(t * b, g))
                           for d in range(2)])
    lstm_layer_bidir_bwd.launches += 1
    return dz.transpose(0, 1), dw_hh, db_hh


lstm_layer_bidir_bwd.launches = 0


class _LSTMBidir(torch.autograd.Function):
    """Two-direction forward kernel over xp (saving ``cs``) and its backward
    kernel as one differentiable op; ``lengths`` gets no gradient."""

    @staticmethod
    def forward(ctx, xp, lengths, w_hh, b_hh):
        outs, h_n, c_n, cs = lstm_layer_bidir(xp, lengths, w_hh, b_hh,
                                              return_cs=True)
        ctx.save_for_backward(xp, lengths, w_hh, b_hh, outs, cs)
        # an unused output arrives as None, and the backward kernel then
        # reads no zero stream
        ctx.set_materialize_grads(False)
        return outs, h_n, c_n

    @staticmethod
    def backward(ctx, douts, dh_n, dc_n):
        xp, lengths, w_hh, b_hh, outs, cs = ctx.saved_tensors
        zero = outs.new_zeros(outs.shape[1:])
        dh_n = zero if dh_n is None else dh_n.contiguous()
        dc_n = zero if dc_n is None else dc_n.contiguous()
        douts = None if douts is None else douts.contiguous()
        dxp, dw_hh, db_hh = lstm_layer_bidir_bwd(xp, lengths, w_hh, b_hh,
                                                 outs, cs, douts, dh_n, dc_n)
        return dxp, None, dw_hh, db_hh


def lstm_layer_bidir_train(xp, lengths, w_hh, b_hh):
    """``lstm_layer_bidir`` with gradients to xp, w_hh and b_hh, through
    the backward kernel (or its twin on the CPU)."""
    return _LSTMBidir.apply(xp, lengths, w_hh, b_hh)
