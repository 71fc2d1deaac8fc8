"""The LSTM backwards' grid design and row 3b's cluster route
(``csrc/lstm.cu``), checked on the CPU: plain PyTorch copies of their
decompositions, written here for the tests only, held to the JAX package's
Pallas kernels in interpret mode.

- Row 2b's grid route (design ``"tile"``): (a) the gates of every row-step
  recomputed at once from the saved ``outs``; (b) one product a step over
  the whole batch, dh_{t-1} = pass-through + dz_t W_hh^T, its depth 4H cut
  in eight parts whose partial sums are added in rank order (the
  cluster's reduce over distributed shared memory), with the step's
  elementwise backward in its epilogue; (c) dx after the loop; (d) the
  weight gradients summed over the active row-steps in the span prefix's
  order; against ``jax.grad`` through ``lstm_pallas.lstm_layer_bidir_fused``.
- Row 3b, the one-direction backward over xp: its cluster route (C CTAs'
  partial products over their own gate columns, added in rank order) and
  its grid route, both after (a) the gates (xp + h W_hh) + b_hh at once,
  with (d) over the active row-steps; against ``jax.grad`` through
  ``lstm_pallas.lstm_layer``, both span directions.
- Row 3b's shape rule, the forced-design entry point, the CPU twins.

Rows of full length, short rows, an empty row and a one-step row, at H=32
and at H=20 (not a multiple of 8)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.ops import lstm_pallas
from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel
from torch_port_fixtures import few_torch_threads_fixture, reference_jit

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

# float32 sums in another order: gradients within 1e-4 of each leaf's
# largest magnitude (the tolerance the card's routes are held to); the
# decompositions against the CPU twin, which sums in the same float32, 1e-5
FRACTION = 1e-4
TWIN_FRACTION = 1e-5
C = 8                                       # CTAs of a backward cluster
SPLIT = 8                                   # depth parts of a grid step
T, B, F = 6, 5, 9
LENS = np.asarray([6, 3, 0, 1, 6], np.int32)  # full, short, empty, one step


def t_(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close_to_scale(got, want, name, fraction=FRACTION):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= fraction * max(np.abs(want).max(), 1e-12), (name, err)


def _active(lengths, t, reverse):
    steps = torch.arange(t)[:, None]
    lens = lengths.long()[None, :]
    return (steps >= t - lens) if reverse else (steps < lens)   # (T, B)


def _prefix_rows(lengths, t, reverse):
    """The active row-steps of one direction in the span prefix's order:
    (batch rows, own times)."""
    rows, times = [], []
    for b, n in enumerate(lengths.tolist()):
        n = min(max(n, 0), t)
        for j in range(n):
            rows.append(b)
            times.append(t - n + j if reverse else j)
    return torch.tensor(rows, dtype=torch.long), torch.tensor(
        times, dtype=torch.long)


def _gates(z):
    i, f, g, o = z.chunk(4, dim=-1)
    return torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o)], dim=-1)


def _step_bwd(gates, c, c_prev, dh, dc, act):
    """One step's elementwise backward for every (row, unit): (dz, the
    pass-through part of dh_{t-1}, dc_{t-1})."""
    ig, fg, gg, og = gates.chunk(4, dim=-1)
    tc = torch.tanh(c)
    dc2 = dc + dh * og * (1.0 - tc * tc)
    dz = torch.cat([dc2 * gg * ig * (1.0 - ig), dc2 * c_prev * fg * (1.0 - fg),
                    dc2 * ig * (1.0 - gg * gg), dh * tc * og * (1.0 - og)],
                   dim=-1)
    return (torch.where(act, dz, 0.0), torch.where(act, 0.0, dh),
            torch.where(act, dc2 * fg, dc))


def _grid_product(dz, w_hh):
    """dz (..., 4H) W_hh^T over the depth in SPLIT parts, added in rank
    order (each part one sum in order)."""
    g = dz.shape[-1]
    chunks = -(-g // 16)                    # the depth staged 16 at a time
    per = -(-chunks // SPLIT) * 16          # a SPLIT-th of the chunks each
    total = None
    for r in range(SPLIT):
        cols = slice(r * per, min(g, (r + 1) * per))
        part = torch.einsum("...j,...hj->...h", dz[..., cols],
                            w_hh[..., cols])
        total = part if total is None else total + part
    return total


def _cluster_product(dz, w_hh):
    """The cluster recurrence's reduce-scatter: each CTA's partial over its
    own gate columns for all H units, added in rank order."""
    hidden = w_hh.shape[-2]
    u = hidden // C
    total = None
    for c in range(C):
        cols = torch.cat([torch.arange(g * hidden + c * u,
                                       g * hidden + (c + 1) * u)
                          for g in range(4)])
        part = torch.einsum("...j,...hj->...h", dz[..., cols],
                            w_hh[..., cols])
        total = part if total is None else total + part
    return total


def _recurrence(gates, cs, act, douts, dh_n, dc_n, w_hh, product):
    """Part (b): the gates (T, ..., 4H) become dz; only dh and dc are
    carried.  The step's elementwise backward follows each product (the
    grid design's epilogue)."""
    dh, dc = dh_n, dc_n
    dz = torch.zeros_like(gates)
    for s in reversed(range(gates.shape[0])):
        c_prev = cs[s - 1] if s > 0 else torch.zeros_like(cs[0])
        dht = dh if douts is None else dh + douts[s]
        dz[s], passed, dc = _step_bwd(gates[s], cs[s], c_prev, dht, dc,
                                      act[s])
        if s > 0:
            dh = passed + product(dz[s], w_hh)
    return dz


def grid_bidir_bwd_plain(x, lengths, w_ih, b_ih, w_hh, b_hh, outs, cs, douts,
                         dh_n, dc_n):
    """Row 2b's grid route in PyTorch.  Returns (dx, dw_ih, db_ih, dw_hh,
    db_hh)."""
    t, b, f = x.shape
    hidden = w_hh.shape[1]
    xs = torch.stack([x, x.flip(0)], dim=1)                    # own time
    h_prev = torch.cat([outs.new_zeros((1, 2, b, hidden)), outs[:-1]])
    # (a) every row-step at once: x over F, then b_ih, then h over H
    gates = _gates((torch.einsum("tdbf,dfg->tdbg", xs, w_ih) + b_ih[:, None]
                    + torch.einsum("tdbh,dhg->tdbg", h_prev, w_hh))
                   + b_hh[:, None])
    act = torch.stack([_active(lengths, t, False), _active(lengths, t, True)],
                      dim=1)[..., None]                         # (T, 2, B, 1)
    # (b) one product a step over both directions
    dz = _recurrence(gates, cs, act, douts, dh_n, dc_n, w_hh[:, None],
                     _grid_product)
    # (c) dx after the loop from both directions' dz at original time
    dz_orig = torch.stack([dz[:, 0], dz[:, 1].flip(0)], dim=1)
    dx = torch.einsum("tbk,kf->tbf",
                      torch.cat([dz_orig[:, 0], dz_orig[:, 1]], dim=-1),
                      torch.cat([w_ih[0].T, w_ih[1].T], dim=0))
    # (d) over the active row-steps in the span prefix's order
    dw_ih, dw_hh, db = [], [], []
    for d in range(2):
        rows, times = _prefix_rows(lengths, t, d == 1)
        z = dz[times, d, rows]
        dw_ih.append(xs[times, d, rows].T @ z)
        dw_hh.append(h_prev[times, d, rows].T @ z)
        db.append(z.sum(0))
    db = torch.stack(db)
    return dx, torch.stack(dw_ih), db, torch.stack(dw_hh), db.clone()


def layer_bwd_plain(xp, lengths, w_hh, b_hh, outs, cs, douts, dh_n, dc_n,
                    reverse, product):
    """Row 3b's cluster (``_cluster_product``) or grid (``_grid_product``)
    route in PyTorch.  Returns (dxp, dw_hh, db_hh)."""
    t, b, _ = xp.shape
    hidden = w_hh.shape[0]
    h_prev = torch.cat([outs.new_zeros((1, b, hidden)), outs[:-1]])
    # (a) every row-step at once: (xp + h W_hh) + b_hh
    gates = _gates((xp + torch.einsum("tbh,hg->tbg", h_prev, w_hh)) + b_hh)
    act = _active(lengths, t, reverse)[..., None]
    dz = _recurrence(gates, cs, act, douts, dh_n, dc_n, w_hh, product)
    rows, times = _prefix_rows(lengths, t, reverse)
    z = dz[times, rows]
    return dz, h_prev[times, rows].T @ z, z.sum(0)


def _loss(outs, h_n, c_n, w, with_outs, tanh, sin, s):
    out_term = s(tanh(outs @ w)) if with_outs else 0.0
    return out_term + s(h_n * h_n) + s(sin(c_n))


def _uniform(rng, hidden, *shape):
    bound = 1 / np.sqrt(hidden)
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def _cotangents(outs, h_n, c_n, w_out, with_outs):
    """The loss's cotangents on outs, h_n and c_n, by autograd on the
    twin's outputs: (douts or None, dh_n, dc_n)."""
    leaves = [a.clone().requires_grad_(True) for a in (outs, h_n, c_n)]
    torch.autograd.backward(_loss(*leaves, t_(w_out), with_outs, torch.tanh,
                                  torch.sin, torch.sum))
    return (leaves[0].grad if with_outs else None, leaves[1].grad,
            leaves[2].grad)


@pytest.mark.parametrize("hidden,with_outs", [(32, False), (32, True),
                                              (20, True)])
def test_grid_backward_decomposition_matches_pallas_grad(rng, hidden,
                                                         with_outs):
    """Row 2b's grid route against jax.grad through the interpret-mode
    kernel's custom VJP, with a cotangent on outs and without (douts
    None), and against the CPU twin."""
    x = rng.normal(size=(T, B, F)).astype(np.float32)
    w = [_uniform(rng, hidden, *s) for s in ((2, F, 4 * hidden),
                                             (2, 4 * hidden),
                                             (2, hidden, 4 * hidden),
                                             (2, 4 * hidden))]
    w_out = rng.normal(size=(hidden, 3)).astype(np.float32)

    def jax_loss(x_, w_ih, b_ih, w_hh, b_hh):
        outs, h_n, c_n = lstm_pallas.lstm_layer_bidir_fused(
            x_, jnp.asarray(LENS), w_ih, b_ih, w_hh, b_hh, interpret=True,
            precision=jax.lax.Precision.HIGHEST)
        return _loss(outs, h_n, c_n, jnp.asarray(w_out), with_outs,
                     jnp.tanh, jnp.sin, jnp.sum)

    with jax.default_matmul_precision("highest"):
        want = reference_jit(jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4)))(
            jnp.asarray(x), *(jnp.asarray(a) for a in w))
    lens = torch.from_numpy(LENS)
    outs, h_n, c_n, cs = lstm_kernel.lstm_layer_bidir_fused(
        t_(x), lens, *(t_(a) for a in w), return_cs=True)
    cot = _cotangents(outs, h_n, c_n, w_out, with_outs)
    args = (t_(x), lens, *(t_(a) for a in w), outs, cs, *cot)
    got = grid_bidir_bwd_plain(*args)
    twin = lstm_kernel.lstm_layer_bidir_fused_bwd(*args)
    for name, g, r, q in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"), got,
                             want, twin):
        close_to_scale(g.numpy(), r, name)
        close_to_scale(g.numpy(), q.numpy(), name, TWIN_FRACTION)


@pytest.mark.parametrize("hidden,reverse", [(32, False), (32, True),
                                            (20, True)])
def test_layer_backward_decompositions_match_pallas_grad(rng, hidden,
                                                         reverse):
    """Row 3b's grid route (and, at H=32, its cluster route: H=20 splits
    across no cluster) against jax.grad through the interpret-mode
    ``lstm_pallas.lstm_layer``, both span directions, with a cotangent on
    outs, and against the CPU twin."""
    xp = rng.normal(size=(T, B, 4 * hidden)).astype(np.float32)
    w_hh = _uniform(rng, hidden, hidden, 4 * hidden)
    b_hh = _uniform(rng, hidden, 4 * hidden)
    w_out = rng.normal(size=(hidden, 3)).astype(np.float32)

    def jax_loss(xp_, w_, b_):
        outs, h_n, c_n = lstm_pallas.lstm_layer(
            xp_, jnp.asarray(LENS), w_, b_, interpret=True,
            precision=jax.lax.Precision.HIGHEST, reverse=reverse)
        return _loss(outs, h_n, c_n, jnp.asarray(w_out), True, jnp.tanh,
                     jnp.sin, jnp.sum)

    with jax.default_matmul_precision("highest"):
        want = reference_jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(
            jnp.asarray(xp), jnp.asarray(w_hh), jnp.asarray(b_hh))
    lens = torch.from_numpy(LENS)
    outs, h_n, c_n, cs = lstm_kernel.lstm_layer(
        t_(xp), lens, t_(w_hh), t_(b_hh), reverse, return_cs=True)
    cot = _cotangents(outs, h_n, c_n, w_out, True)
    args = (t_(xp), lens, t_(w_hh), t_(b_hh), outs, cs, *cot)
    twin = lstm_kernel.lstm_layer_bwd(*args, reverse)
    products = [_grid_product] + ([_cluster_product] if hidden % C == 0
                                  else [])
    for product in products:
        got = layer_bwd_plain(*args, reverse, product)
        for name, g, r, q in zip(("dxp", "dw_hh", "db_hh"), got, want, twin):
            close_to_scale(g.numpy(), r, name)
            close_to_scale(g.numpy(), q.numpy(), name, TWIN_FRACTION)


def test_layer_backward_shape_rule(monkeypatch):
    """Row 3b asks the card for the raw backward's cluster recurrence at
    the same row tile and takes the same rule: the cluster route where
    the card holds it (H a multiple of 32 up to 256), the grid route
    otherwise (H=1024, H=200)."""
    asked = []

    def resident(lib, device_index, kind, f, hidden, rows):
        asked.append((kind, f, rows))
        return 15 if hidden % 32 == 0 and hidden <= 256 else 0

    monkeypatch.setattr(lstm_kernel, "_cluster_active", resident)
    rule = lstm_kernel.backward_design
    picked = {h: lstm_kernel.backward_design_for(None, 0, h)
              for h in (256, 128, 1024, 200, 20)}
    assert picked == {256: "cluster", 128: "cluster", 1024: "tile",
                      200: "tile", 20: "tile"}
    assert set(asked) == {("bwd", 0, lstm_kernel.BWD_CLUSTER_ROWS)}
    assert (rule(15), rule(0)) == ("cluster", "tile")


def test_layer_backward_forced_designs_need_cuda_tensors():
    """``lstm_layer_bwd_on`` takes CUDA tensors only and names a design; on
    the CPU the public wrappers return the twins' shapes."""
    t, b, h = 3, 2, 4
    xp, lens = torch.zeros(t, b, 4 * h), torch.tensor([3, 0],
                                                      dtype=torch.int32)
    w, bias = torch.zeros(h, 4 * h), torch.zeros(4 * h)
    outs, h_n, c_n, cs = lstm_kernel.lstm_layer(xp, lens, w, bias,
                                                return_cs=True)
    for design in ("cluster", "tile", "grid"):
        with pytest.raises(ValueError, match="CUDA"):
            lstm_kernel.lstm_layer_bwd_on(design, xp, lens, w, bias, outs,
                                          cs, None, h_n, c_n)
    for reverse in (False, True):
        got = lstm_kernel.lstm_layer_bwd(xp, lens, w, bias, outs, cs, outs,
                                         h_n, c_n, reverse)
        assert [tuple(g.shape) for g in got] == [(t, b, 4 * h), (h, 4 * h),
                                                 (4 * h,)]
    x = torch.zeros(t, b, 5)
    ws = [torch.zeros(s) for s in ((2, 5, 4 * h), (2, 4 * h), (2, h, 4 * h),
                                   (2, 4 * h))]
    outs, h_n, c_n, cs = lstm_kernel.lstm_layer_bidir_fused(x, lens, *ws,
                                                            return_cs=True)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_kernel.lstm_layer_bidir_fused_bwd_on(
            "tile", x, lens, *ws, outs, cs, outs, h_n, c_n)
    got = lstm_kernel.lstm_layer_bidir_fused_bwd(x, lens, *ws, outs, cs, outs,
                                                 h_n, c_n)
    assert [tuple(g.shape) for g in got] == [(t, b, 5), (2, 5, 4 * h),
                                             (2, 4 * h), (2, h, 4 * h),
                                             (2, 4 * h)]
