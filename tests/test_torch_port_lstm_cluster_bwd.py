"""The LSTM cluster designs of rows 2b and 3 (``csrc/lstm.cu``), checked on
the CPU: plain PyTorch copies of their decompositions, written here for
the tests only, held to the JAX package's Pallas kernels in interpret mode.

- Row 2b, the raw backward's cluster route: (a) the gates of every
  row-step recomputed at once from the saved ``outs`` (one chain a dot
  product: x, then b_ih, then h), (b) the recurrence carrying only dh and
  dc, whose dh_{t-1} is the C CTAs' partial products over their own gate
  columns added in rank order (the reduce-scatter), (c) dx after the loop
  from both directions' dz at once; against ``jax.grad`` through
  ``lstm_pallas.lstm_layer_bidir_fused``.
- Row 3, the one-direction forward's projected mode: each CTA's units'
  gates from its own W_hh columns and the whole gathered h; against
  ``lstm_pallas.lstm_layer``.
- The shape rules that pick the cluster route and its row tile.

Rows of full length, short rows, an empty row and a one-step row, at H=32
with C=8 CTAs (4 units each)."""

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
C = 8                                       # CTAs of a cluster
T, B, H = 6, 5, 32
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


def _slice_cols(c, hidden):
    """Gate columns of CTA c: its units' four gates, gate-major."""
    u = hidden // C
    return torch.cat([torch.arange(g * hidden + c * u, g * hidden + (c + 1) * u)
                      for g in range(4)])


def cluster_bwd_plain(x, lengths, w_ih, b_ih, w_hh, b_hh, outs, cs, douts,
                      dh_n, dc_n):
    """Row 2b's cluster route in PyTorch: (a), (b), (c), then the weight
    gradients over the streams.  Returns (dx, dw_ih, db_ih, dw_hh,
    db_hh)."""
    t, b, f = x.shape
    hidden = w_hh.shape[1]
    xs = torch.stack([x, x.flip(0)], dim=1)                    # own time
    h_prev = torch.cat([outs.new_zeros((1, 2, b, hidden)), outs[:-1]])
    # (a) every row-step at once: x over F, then b_ih, then h over H
    z = (torch.einsum("tdbf,dfg->tdbg", xs, w_ih) + b_ih[:, None]
         + torch.einsum("tdbh,dhg->tdbg", h_prev, w_hh)) + b_hh[:, None]
    i, f_, g, o = z.chunk(4, dim=-1)
    gates = torch.cat([torch.sigmoid(i), torch.sigmoid(f_), torch.tanh(g),
                       torch.sigmoid(o)], dim=-1)
    act = torch.stack([_active(lengths, t, False), _active(lengths, t, True)],
                      dim=1)[..., None]                         # (T, 2, B, 1)
    # (b) the recurrence: only dh and dc are carried
    dh, dc = dh_n, dc_n
    dz = torch.zeros((t, 2, b, 4 * hidden))
    for s in reversed(range(t)):
        ig, fg, gg, og = gates[s].chunk(4, dim=-1)
        c_prev = cs[s - 1] if s > 0 else torch.zeros_like(cs[0])
        dht = dh if douts is None else dh + douts[s]
        tc = torch.tanh(cs[s])
        dc2 = dc + dht * og * (1.0 - tc * tc)
        dzs = torch.cat([dc2 * gg * ig * (1.0 - ig),
                         dc2 * c_prev * fg * (1.0 - fg),
                         dc2 * ig * (1.0 - gg * gg),
                         dht * tc * og * (1.0 - og)], dim=-1)
        a = act[s]
        dz[s] = torch.where(a, dzs, 0.0)
        dc = torch.where(a, dc2 * fg, dc)
        if s == 0:
            break
        # the reduce-scatter: each CTA's partial over its own gate columns
        # for all H units, added in rank order
        total = torch.zeros_like(dh)
        for c in range(C):
            cols = _slice_cols(c, hidden)
            total = total + torch.einsum("dbj,dhj->dbh", dz[s][..., cols],
                                         w_hh[..., cols])
        dh = torch.where(a, 0.0, dht) + total
    # the streams at original time (direction 1 flipped back)
    dz_orig = torch.stack([dz[:, 0], dz[:, 1].flip(0)], dim=1)
    hp_orig = torch.stack([h_prev[:, 0], h_prev[:, 1].flip(0)], dim=1)
    # (c) dx after the loop, both directions in one product
    dx = torch.einsum("tbk,kf->tbf",
                      torch.cat([dz_orig[:, 0], dz_orig[:, 1]], dim=-1),
                      torch.cat([w_ih[0].T, w_ih[1].T], dim=0))
    dw_ih = torch.einsum("tbf,tdbg->dfg", x, dz_orig)
    dw_hh = torch.einsum("tdbh,tdbg->dhg", hp_orig, dz_orig)
    db = dz_orig.sum(dim=(0, 2))
    return dx, dw_ih, db, dw_hh, db.clone()


def _layer_inputs(rng, f):
    x = rng.normal(size=(T, B, f)).astype(np.float32)
    bound = 1 / np.sqrt(H)
    w = [rng.uniform(-bound, bound, size=s).astype(np.float32)
         for s in ((2, f, 4 * H), (2, 4 * H), (2, H, 4 * H), (2, 4 * H))]
    w_out = rng.normal(size=(H, 3)).astype(np.float32)
    return x, w, w_out


def _loss(outs, h_n, c_n, w, with_outs, tanh, sin, s):
    out_term = s(tanh(outs @ w)) if with_outs else 0.0
    return out_term + s(h_n * h_n) + s(sin(c_n))


@pytest.mark.parametrize("f,with_outs", [(129, False), (129, True),
                                         (2 * H, True)])
def test_cluster_backward_decomposition_matches_pallas_grad(rng, f,
                                                            with_outs):
    """(a), (b), (c) and the weight gradients against jax.grad through the
    interpret-mode kernel's custom VJP, with a cotangent on outs and
    without (douts None), at F=129 and at a second layer's F = 2H."""
    x, w, w_out = _layer_inputs(rng, f)

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
    # the loss's cotangents on outs, h_n and c_n, by autograd on the twin's
    # outputs
    leaves = [a.clone().requires_grad_(True) for a in (outs, h_n, c_n)]
    torch.autograd.backward(_loss(*leaves, t_(w_out), with_outs, torch.tanh,
                                  torch.sin, torch.sum))
    douts = leaves[0].grad if with_outs else None
    got = cluster_bwd_plain(t_(x), lens, *(t_(a) for a in w), outs, cs, douts,
                            leaves[1].grad, leaves[2].grad)
    names = ("dx", "dw_ih", "db_ih", "dw_hh", "db_hh")
    for g, r, name in zip(got, want, names):
        close_to_scale(g.numpy(), r, name)
    # and against the per-tile design's twin (what the wrapper runs on the
    # CPU)
    twin = lstm_kernel.lstm_layer_bidir_fused_bwd(
        t_(x), lens, *(t_(a) for a in w), outs, cs, douts, leaves[1].grad,
        leaves[2].grad)
    for g, r, name in zip(got, twin, names):
        close_to_scale(g.numpy(), r.numpy(), name, 1e-5)


def cluster_layer_plain(xp, lengths, w_hh, b_hh, reverse):
    """Row 3's projected mode in PyTorch: at each step every CTA computes
    its units' four gates from its own W_hh columns and the gathered h,
    then h is gathered again.  Returns (outs, h_n, c_n, cs)."""
    t, b, _ = xp.shape
    hidden = w_hh.shape[0]
    u = hidden // C
    act = _active(lengths, t, reverse)[..., None]
    h = xp.new_zeros((b, hidden))
    c = xp.new_zeros((b, hidden))
    outs, cs = [], []
    for s in range(t):
        h_next, c_next = torch.empty_like(h), torch.empty_like(c)
        for r in range(C):
            cols = _slice_cols(r, hidden)
            z = (xp[s][:, cols] + h @ w_hh[:, cols]) + b_hh[cols]
            ig, fg, gg, og = z.chunk(4, dim=-1)
            units = slice(r * u, (r + 1) * u)
            c2 = (torch.sigmoid(fg) * c[:, units]
                  + torch.sigmoid(ig) * torch.tanh(gg))
            h2 = torch.sigmoid(og) * torch.tanh(c2)
            h_next[:, units] = torch.where(act[s], h2, h[:, units])
            c_next[:, units] = torch.where(act[s], c2, c[:, units])
        h, c = h_next, c_next
        outs.append(h)
        cs.append(c)
    return torch.stack(outs), h, c, torch.stack(cs)


@pytest.mark.parametrize("reverse", [False, True])
def test_cluster_layer_projected_mode_matches_pallas(rng, reverse):
    """The projected mode's slices and gathers against the interpret-mode
    ``lstm_pallas.lstm_layer`` (outs, h_n, c_n) and against the wrapper's
    twin (and its saved cell states)."""
    xp = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    bound = 1 / np.sqrt(H)
    w_hh = rng.uniform(-bound, bound, size=(H, 4 * H)).astype(np.float32)
    b_hh = rng.uniform(-bound, bound, size=(4 * H,)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = reference_jit(lambda *a: lstm_pallas.lstm_layer(
            *a, interpret=True, precision=jax.lax.Precision.HIGHEST,
            reverse=reverse))(jnp.asarray(xp), jnp.asarray(LENS),
                              jnp.asarray(w_hh), jnp.asarray(b_hh))
    lens = torch.from_numpy(LENS)
    got = cluster_layer_plain(t_(xp), lens, t_(w_hh), t_(b_hh), reverse)
    for g, w, name in zip(got, want, ("outs", "h_n", "c_n")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=name)
    twin = lstm_kernel.lstm_layer(t_(xp), lens, t_(w_hh), t_(b_hh), reverse,
                                  return_cs=True)
    for g, w, name in zip(got, twin, ("outs", "h_n", "c_n", "cs")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=ATOL,
                                   err_msg=name)


def test_backward_shape_rule():
    """The cluster recurrence wherever the card reports resident clusters
    for the widths; the per-tile kernel otherwise."""
    rule = lstm_kernel.backward_design
    assert lstm_kernel.BWD_CLUSTER_ROWS == 36
    assert rule(15) == "cluster"       # H=256: B=512 in two waves
    assert rule(1) == "cluster"
    assert rule(0) == "tile"           # H=1024, H=200


def test_layer_shape_rule_skips_tiles_the_card_does_not_take():
    """A tile with no resident cluster is never picked: the other tile
    takes every batch, and with none the per-tile kernel does."""
    rule = lstm_kernel.layer_design
    small, wide = lstm_kernel.PROJ_CLUSTER_TILES
    assert rule({small: 15, wide: 0}, 64) == ("cluster", small)
    assert rule({small: 15, wide: 0}, 512) == ("cluster", small)  # 3 waves
    assert rule({small: 0, wide: 15}, 64) == ("cluster", wide)
    assert rule({small: 0, wide: 0}, 0) == ("tile", 0)


def test_layer_shape_rule():
    """The projected forward's rule: one direction, ceil(B / R) clusters;
    the smallest tile that runs in one wave, else the widest."""
    rule = lstm_kernel.layer_design
    small, wide = lstm_kernel.PROJ_CLUSTER_TILES
    card = {small: 15, wide: 15}
    assert rule(card, 64) == ("cluster", small)        # served batches
    assert rule(card, 15 * small) == ("cluster", small)
    assert rule(card, 15 * small + 1) == ("cluster", wide)
    assert rule(card, 512) == ("cluster", wide)        # 15 clusters, a wave
    assert rule(card, 10 ** 6) == ("cluster", wide)    # many waves
    assert rule({small: 0, wide: 0}, 64) == ("tile", 0)  # H=1024


def test_forced_designs_need_cuda_tensors():
    """The timing entry points take CUDA tensors only and name a design;
    on the CPU the public wrappers take their twins."""
    xp, lens = torch.zeros(3, 2, 8), torch.tensor([3, 0], dtype=torch.int32)
    w, b = torch.zeros(2, 8), torch.zeros(8)
    for design in ("cluster", "tile", "pair"):
        with pytest.raises(ValueError, match="CUDA"):
            lstm_kernel.lstm_layer_on(design, xp, lens, w, b)
    x = torch.zeros(3, 2, 4)
    w = [torch.zeros(s) for s in ((2, 4, 8), (2, 8), (2, 2, 8), (2, 8))]
    outs, h_n, c_n, cs = lstm_kernel.lstm_layer_bidir_fused(x, lens, *w,
                                                            return_cs=True)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_kernel.lstm_layer_bidir_fused_bwd_on(
            "cluster", x, lens, *w, outs, cs, None, h_n, c_n)
    got = lstm_kernel.lstm_layer_bidir_fused_bwd(x, lens, *w, outs, cs, None,
                                                 h_n, c_n)
    assert [tuple(g.shape) for g in got] == [(3, 2, 4), (2, 4, 8), (2, 8),
                                             (2, 2, 8), (2, 8)]
