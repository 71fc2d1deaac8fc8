"""The raw LSTM forward's "proj" design (``csrc/lstm.cu``: the input
projection by ``lstm_gates_kernel`` with ``kXp``, then the pair recurrence,
``lstm_fwd_cluster_kernel`` in its projected mode over both directions),
checked on the CPU: a plain PyTorch copy of the decomposition, written here
for the tests only, held to the JAX package's ``lstm_layer_bidir_fused`` in
interpret mode and to the wrapper's twin; and the shape rule that picks the
design and its row tile.

- (a) xp = x W_ih[d] + b_ih[d] at the active row-steps only, in the span
  prefix's order, direction 1 at its own flipped time; every other entry
  of the buffer is left unwritten (NaN here, to show it is never read).
- (b) both directions' recurrences in one grid: at each step every CTA of
  a cluster forms its units' four gates from its own W_hh columns and the
  gathered h, (xp + h W_hh) + b_hh, with the xp of a step outside a row's
  span loaded as zeros.

Rows of full length, short rows, an empty row and a one-step row, at H=32
with C=8 CTAs (4 units each), at F=177 (44.1 kHz's bins) and F = 2H (a
second layer)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.ops import lstm_pallas
from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel
from torch_port_fixtures import few_torch_threads_fixture, reference_jit

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)

# float32 sums in another order through T steps
ATOL = 1e-5
C = 8                                       # CTAs of a cluster
T, B, H = 6, 5, 32
LENS = np.asarray([6, 3, 0, 1, 6], np.int32)  # full, short, empty, one step


def t_(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def span_prefix(lengths, t):
    """prefix[b] = the active steps of rows before b (span_prefix_kernel)."""
    lens = lengths.long().clamp(0, t)
    return torch.cat([torch.zeros(1, dtype=torch.long), lens.cumsum(0)])


def projection_plain(x, lengths, w_ih, b_ih):
    """(a): xp (T, 2, B, 4H) of every active row-step, one row at a time in
    the span prefix's order: row m of a direction is step j of batch row b
    (the last b with prefix[b] <= m), at its own time t = j (direction 0)
    or T - len + j (direction 1, reading x at T - 1 - t); x over F, then
    b_ih.  The other entries stay NaN."""
    t, b, _ = x.shape
    g = w_ih.shape[-1]
    prefix = span_prefix(lengths, t)
    xp = torch.full((t, 2, b, g), float("nan"))
    for d in range(2):
        for m in range(int(prefix[-1])):
            row = int(torch.searchsorted(prefix, m, right=True)) - 1
            j = m - int(prefix[row])
            length = int(prefix[row + 1] - prefix[row])
            own = j if d == 0 else t - length + j
            tx = own if d == 0 else t - 1 - own
            xp[own, d, row] = x[tx, row] @ w_ih[d] + b_ih[d]
    return xp


def _slice_cols(c, hidden):
    """Gate columns of CTA c: its units' four gates, gate-major."""
    u = hidden // C
    return torch.cat([torch.arange(g * hidden + c * u, g * hidden + (c + 1) * u)
                      for g in range(4)])


def pair_recurrence_plain(xp, lengths, w_hh, b_hh, return_cs=False):
    """(b): both directions over xp at once, each CTA's units from its own
    W_hh columns and the gathered h; a step outside a row's span loads
    zeros for its xp (the select discards its gates)."""
    t, _, b, _ = xp.shape
    hidden = w_hh.shape[1]
    u = hidden // C
    steps = torch.arange(t)[:, None]
    lens = lengths.long()[None, :]
    act = torch.stack([steps < lens, steps >= t - lens], dim=1)[..., None]
    h = xp.new_zeros((2, b, hidden))
    c = xp.new_zeros((2, b, hidden))
    outs, cs = [], []
    for s in range(t):
        x_s = torch.where(act[s], xp[s], 0.0)
        h_next, c_next = torch.empty_like(h), torch.empty_like(c)
        for r in range(C):
            cols = _slice_cols(r, hidden)
            z = (x_s[..., cols] + torch.matmul(h, w_hh[..., cols])
                 ) + b_hh[:, None, cols]
            ig, fg, gg, og = z.chunk(4, dim=-1)
            units = slice(r * u, (r + 1) * u)
            c2 = (torch.sigmoid(fg) * c[..., units]
                  + torch.sigmoid(ig) * torch.tanh(gg))
            h2 = torch.sigmoid(og) * torch.tanh(c2)
            h_next[..., units] = torch.where(act[s], h2, h[..., units])
            c_next[..., units] = torch.where(act[s], c2, c[..., units])
        h, c = h_next, c_next
        outs.append(h)
        cs.append(c)
    if return_cs:
        return torch.stack(outs), h, c, torch.stack(cs)
    return torch.stack(outs), h, c


def _weights(rng, f):
    x = rng.normal(size=(T, B, f)).astype(np.float32)
    bound = 1 / np.sqrt(H)
    w = [rng.uniform(-bound, bound, size=s).astype(np.float32)
         for s in ((2, f, 4 * H), (2, 4 * H), (2, H, 4 * H), (2, 4 * H))]
    return x, w


@pytest.mark.parametrize("f,return_cs", [(177, False), (177, True),
                                         (2 * H, True)])
def test_proj_design_matches_pallas(rng, f, return_cs):
    """Projection then pair recurrence against the interpret-mode
    ``lstm_pallas.lstm_layer_bidir_fused`` (outs, h_n, c_n), and against the
    wrapper's twin (with the saved cell states when ``return_cs``)."""
    x, w = _weights(rng, f)
    with jax.default_matmul_precision("highest"):
        want = reference_jit(lambda *a: lstm_pallas.lstm_layer_bidir_fused(
            *a, interpret=True, precision=jax.lax.Precision.HIGHEST))(
                jnp.asarray(x), jnp.asarray(LENS), *map(jnp.asarray, w))
    lens = torch.from_numpy(LENS)
    xp = projection_plain(t_(x), lens, t_(w[0]), t_(w[1]))
    got = pair_recurrence_plain(xp, lens, t_(w[2]), t_(w[3]), return_cs)
    assert len(got) == (4 if return_cs else 3)
    for g, r, name in zip(got, want, ("outs", "h_n", "c_n")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL, err_msg=name)
    twin = lstm_kernel.lstm_layer_bidir_fused(
        t_(x), lens, *(t_(a) for a in w), return_cs=return_cs)
    for g, r, name in zip(got, twin, ("outs", "h_n", "c_n", "cs")):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=ATOL,
                                   err_msg=name)


def test_projection_skips_row_steps_outside_the_spans(rng):
    """(a) writes exactly the active row-steps of each direction (the
    prefix's count, the same for both), which the recurrence alone reads."""
    x, w = _weights(rng, 177)
    lens = torch.from_numpy(LENS)
    xp = projection_plain(t_(x), lens, t_(w[0]), t_(w[1]))
    written = ~torch.isnan(xp[..., 0])                        # (T, 2, B)
    steps = torch.arange(T)[:, None]
    assert torch.equal(written[:, 0], steps < lens.long()[None])
    assert torch.equal(written[:, 1], steps >= T - lens.long()[None])
    assert int(written.sum()) == 2 * int(span_prefix(lens, T)[-1])


def test_forward_rule_three_outcomes():
    """The raw cluster design where its slices fit and its grid runs in few
    waves; else "proj" where the pair recurrence takes H (F=177 at H=256:
    no raw cluster fits); the per-tile kernel otherwise (H=1024)."""
    rule = lstm_kernel.forward_design
    small, wide = lstm_kernel.PROJ_CLUSTER_TILES
    card = {small: 15, wide: 15}
    assert rule(15, 64, card) == "cluster"          # F=129, B=64
    assert rule(15, 512, card) == "cluster"         # 104 clusters, 7 waves
    assert rule(0, 64, card) == "proj"              # F=177, B=64
    assert rule(0, 512, card) == "proj"             # F=177 or 2H, B=512
    assert rule(15, 10 ** 4, card) == "proj"        # too many waves
    assert rule(0, 64, {small: 0, wide: 0}) == "tile"   # H=1024


def test_proj_row_tile():
    """The pair recurrence's row tile: the smallest whose 2 * ceil(B / R)
    clusters run in one wave, else the widest."""
    rule = lstm_kernel.layer_design
    small, wide = lstm_kernel.PROJ_CLUSTER_TILES
    card = {small: 15, wide: 15}
    assert rule(card, 64, directions=2) == ("cluster", small)   # 12 clusters
    assert rule(card, 7 * small, directions=2) == ("cluster", small)
    assert rule(card, 7 * small + 1, directions=2) == ("cluster", wide)
    assert rule(card, 512, directions=2) == ("cluster", wide)   # two waves
    assert rule({small: 0, wide: 15}, 64, directions=2) == ("cluster", wide)
    assert rule({small: 0, wide: 0}, 64, directions=2) == ("tile", 0)


def test_proj_design_needs_cuda_tensors():
    """The timing entry point names the design and takes CUDA tensors only;
    on the CPU the public wrapper takes its twin."""
    x, lens = torch.zeros(3, 2, 4), torch.tensor([3, 0], dtype=torch.int32)
    w = [torch.zeros(s) for s in ((2, 4, 8), (2, 8), (2, 2, 8), (2, 8))]
    for design in ("proj", "pair"):
        with pytest.raises(ValueError, match="CUDA"):
            lstm_kernel.lstm_layer_bidir_fused_on(design, x, lens, *w)
    assert lstm_kernel.lstm_layer_bidir_fused.proj.launches == 0
