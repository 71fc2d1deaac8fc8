"""The port's CUDA kernels on the card, against their plain twins, at the
served publication width.  Marked ``gpu``: on a machine without a card
every test skips.  On the card, from the repository root (the suite's
conftest imports jax, which that machine does not have):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel, stft, stft_kernel

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("fs", [16000, 32000])
def test_stft_kernel_matches_twin(cuda, fs):
    rng = np.random.default_rng(fs)
    frame, t, b = int(0.008 * fs), 512, 64
    step = frame // 2
    audio = torch.from_numpy(rng.integers(
        -3000, 3000, size=(b, t * step + frame)).astype(np.float32)).to(cuda)
    audio[-2:] = 0.0
    cos_b, sin_b = stft.basis_tensors(frame, "hann_window", cuda)
    args = (audio, cos_b, sin_b, frame, step, t, 2.0 ** -15, 11.0)
    before = stft_kernel.log_spectrogram_kernel.launches
    got = stft_kernel.log_spectrogram_kernel(*args)
    want = stft_kernel.log_spectrogram_plain(*args)
    torch.cuda.synchronize()
    assert stft_kernel.log_spectrogram_kernel.launches == before + 1
    # same float32 products summed in another order
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("f", [65, 129])
def test_lstm_kernel_matches_twin(cuda, f):
    rng = np.random.default_rng(f)
    t, b, h = 512, 64, 256
    x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32))
    lengths = rng.integers(0, t + 1, size=b).astype(np.int32)
    lengths[:2] = (t, 0)
    bound = 1.0 / np.sqrt(h)
    w = [torch.from_numpy(rng.uniform(-bound, bound, size=s).astype(
        np.float32)).to(cuda)
        for s in ((2, f, 4 * h), (2, 4 * h), (2, h, 4 * h), (2, 4 * h))]
    args = (x.to(cuda), torch.from_numpy(lengths).to(cuda), *w)
    got = lstm_kernel.lstm_layer_bidir_fused(*args)
    want = lstm_kernel.lstm_layer_bidir_fused_plain(*args)
    torch.cuda.synchronize()
    # float32 dot products in another order through 512 steps
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)


def test_kernels_on_ragged_shapes(cuda):
    """Edges the served shapes do not reach: a partial row tile, a hidden
    size that is not a multiple of 32, a partial frame and bin tile."""
    rng = np.random.default_rng(7)
    t, b, f, h = 7, 5, 9, 40
    x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32))
    lengths = torch.tensor([7, 0, 3, 1, 6], dtype=torch.int32)
    w = [torch.from_numpy(rng.uniform(-0.3, 0.3, size=s).astype(
        np.float32)).to(cuda)
        for s in ((2, f, 4 * h), (2, 4 * h), (2, h, 4 * h), (2, 4 * h))]
    args = (x.to(cuda), lengths.to(cuda), *w)
    for g, r in zip(lstm_kernel.lstm_layer_bidir_fused(*args),
                    lstm_kernel.lstm_layer_bidir_fused_plain(*args)):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    frame, step, frames = 100, 50, 33
    audio = torch.from_numpy(rng.normal(size=(3, frames * step + frame))
                             .astype(np.float32) * 100).to(cuda)
    cos_b, sin_b = stft.basis_tensors(frame, "hann_window", cuda)
    args = (audio, cos_b, sin_b, frame, step, frames, 2.0 ** -15, 11.0)
    torch.testing.assert_close(stft_kernel.log_spectrogram_kernel(*args),
                               stft_kernel.log_spectrogram_plain(*args),
                               rtol=0, atol=1e-3)


def test_lstm_kernel_hidden_limit(cuda):
    """The widest hidden size the JAX CLI takes (1024) runs through the
    bidirectional forward and backward kernels and matches the twins (the
    backward by its grid design, which needs no row tile: the per-tile raw
    backward, kind 1, is no longer built); a hidden size whose shared
    memory no row tile of a per-tile kernel fits is refused by the
    wrapper's row-tile choice, not by a launch failure."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    rng = np.random.default_rng(11)
    t, b, f, h = 5, 6, 129, 1024
    w = [torch.from_numpy(rng.uniform(-0.03, 0.03, size=s).astype(
        np.float32)).to(cuda)
        for s in ((2, f, 4 * h), (2, 4 * h), (2, h, 4 * h), (2, 4 * h))]
    x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32))
    args = (x.to(cuda), torch.tensor([5, 2, 0, 1, 4, 5], dtype=torch.int32,
                                     device=cuda), *w)
    got = lstm_kernel.lstm_layer_bidir_fused(*args, return_cs=True)
    want = lstm_kernel.lstm_layer_bidir_fused_plain(*args, return_cs=True)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    outs, h_n, c_n, cs = want
    dh_n = torch.from_numpy(rng.normal(size=h_n.shape).astype(
        np.float32)).to(cuda)
    bwd = (*args, outs, cs, None, dh_n, torch.zeros_like(dh_n))
    for g, r in zip(lstm_kernel.lstm_layer_bidir_fused_bwd(*bwd),
                    lstm_kernel.lstm_layer_bidir_fused_bwd_plain(*bwd)):
        assert _rel_max_err(g, r) <= 1e-4
    lib = _build.load("lstm")
    assert lib.abcd_lstm_rows(1, f, h) == 0
    with pytest.raises(ValueError, match="shared memory"):
        _build.row_tile(lib, "lstm", 5, (0, 4200),
                        "lstm_layer_bidir backward")


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h,with_douts", [(256, False), (256, True),
                                          (1024, False), (2304, False)])
def test_lstm_layer_kernels_match_twins(cuda, reverse, h, with_douts):
    """The one-direction layer (the unidirectional encoder): forward with
    the saved cell states and backward, against the twins, with ragged
    lengths and an empty row; H=1024 takes 4 rows a block in the backward
    and H=2304 takes 2."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    rng = np.random.default_rng(h + reverse)
    t, b = (37, 21) if h == 256 else (4, 5)
    xp = torch.from_numpy(rng.normal(size=(t, b, 4 * h)).astype(np.float32)
                          ).to(cuda)
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[:2] = (t, 0)
    lengths = torch.from_numpy(lengths).to(cuda)
    w_hh = _uniform(rng, cuda, 1 / np.sqrt(h), h, 4 * h)
    b_hh = _uniform(rng, cuda, 1 / np.sqrt(h), 4 * h)
    before = lk.lstm_layer.launches
    got = lk.lstm_layer(xp, lengths, w_hh, b_hh, reverse, return_cs=True)
    want = lk.lstm_layer_plain(xp, lengths, w_hh, b_hh, reverse,
                               return_cs=True)
    torch.cuda.synchronize()
    assert lk.lstm_layer.launches == before + 1
    # float32 dot products of H terms in another order through T steps
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
    outs, h_n, c_n, cs = want
    normal = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda)
    douts = normal(outs.shape) if with_douts else None
    bwd = (xp, lengths, w_hh, b_hh, outs, cs, douts, normal(h_n.shape),
           normal(c_n.shape), reverse)
    before = lk.lstm_layer_bwd.launches
    g_all = lk.lstm_layer_bwd(*bwd)
    r_all = lk.lstm_layer_bwd_plain(*bwd)
    torch.cuda.synchronize()
    assert lk.lstm_layer_bwd.launches == before + 1
    for name, g, r in zip(("dxp", "dw_hh", "db_hh"), g_all, r_all):
        assert g.shape == r.shape, name
        assert _rel_max_err(g, r) <= 1e-4, name


# ---------------------------------------------------------------------------
# training kernels: the LSTM's backward, the fused-loss decoder, and the
# weight-gradient reductions they share
# ---------------------------------------------------------------------------

def _rel_max_err(got, want):
    """max |got - want| over max |want|: the tolerance is a fraction of each
    leaf's largest value (sums of many float32 terms in another order)."""
    scale = max(want.abs().max().item(), 1e-30)
    return (got - want).abs().max().item() / scale


def _uniform(rng, cuda, bound, *shape):
    return torch.from_numpy(rng.uniform(-bound, bound, size=shape).astype(
        np.float32)).to(cuda)


@pytest.mark.parametrize("with_douts", [False, True])
def test_lstm_backward_kernel_matches_twin(cuda, with_douts):
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    rng = np.random.default_rng(21)
    t, b, f, h = 37, 21, 129, 256
    x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32)
                         ).to(cuda)
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[:2] = (t, 0)
    lengths = torch.from_numpy(lengths).to(cuda)
    w = [_uniform(rng, cuda, 1 / 16, *s)
         for s in ((2, f, 4 * h), (2, 4 * h), (2, h, 4 * h), (2, 4 * h))]
    outs, h_n, c_n, cs = lk.lstm_layer_bidir_fused(x, lengths, *w,
                                                   return_cs=True)
    want_fwd = lk.lstm_layer_bidir_fused_plain(x, lengths, *w,
                                               return_cs=True)
    for g, r in zip((outs, h_n, c_n, cs), want_fwd):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
    douts = (torch.from_numpy(rng.normal(size=outs.shape).astype(
        np.float32)).to(cuda) if with_douts else None)
    dh_n = torch.from_numpy(rng.normal(size=h_n.shape).astype(
        np.float32)).to(cuda)
    dc_n = torch.from_numpy(rng.normal(size=c_n.shape).astype(
        np.float32)).to(cuda)
    before = lk.lstm_layer_bidir_fused_bwd.launches
    got = lk.lstm_layer_bidir_fused_bwd(x, lengths, *w, outs, cs, douts,
                                        dh_n, dc_n)
    want = lk.lstm_layer_bidir_fused_bwd_plain(x, lengths, *w, outs, cs,
                                               douts, dh_n, dc_n)
    torch.cuda.synchronize()
    assert lk.lstm_layer_bidir_fused_bwd.launches == before + 1
    for name, g, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"), got,
                          want):
        assert _rel_max_err(g, r) <= 1e-4, name


def _decoder_args(rng, cuda, t, b, f, h, m, mo, lengths):
    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(cuda)
    return [normal(t, b, f), torch.tensor(lengths, dtype=torch.int32,
                                          device=cuda),
            _uniform(rng, cuda, 1 / np.sqrt(h), h, 4 * h + 2 * m),
            _uniform(rng, cuda, 2 / np.sqrt(h), 4 * h),
            _uniform(rng, cuda, 1 / np.sqrt(h), 2 * m),
            _uniform(rng, cuda, 1 / np.sqrt(m), m, f),
            _uniform(rng, cuda, 1 / np.sqrt(m), m, f),
            _uniform(rng, cuda, 1 / np.sqrt(m), 2 * f),
            _uniform(rng, cuda, 1 / np.sqrt(h), f, 4 * h),
            normal(t, b, f),
            _uniform(rng, cuda, 1 / np.sqrt(h), h, mo),
            _uniform(rng, cuda, 1 / np.sqrt(h), mo),
            _uniform(rng, cuda, 1 / np.sqrt(mo), mo),
            _uniform(rng, cuda, 1 / np.sqrt(mo), 1),
            normal(b, h, scale=0.5), normal(b, h, scale=0.5)]


@pytest.mark.parametrize("shape", [(33, 21, 129, 256, 256, 256),
                                   (7, 5, 9, 40, 12, 10),
                                   (6, 11, 129, 1024, 256, 256)])
def test_decoder_kernels_match_twins(cuda, shape):
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    rng = np.random.default_rng(31)
    t, b, f, h, m, mo = shape
    lengths = rng.integers(1, t + 1, size=b)
    lengths[:2] = (t, 0)
    args = _decoder_args(rng, cuda, t, b, f, h, m, mo, lengths)
    before = dk.decoder_fused_losses_fwd.launches
    got = dk.decoder_fused_losses_fwd(*args)
    want = dk.decoder_fused_losses_fwd_plain(*args)
    torch.cuda.synchronize()
    assert dk.decoder_fused_losses_fwd.launches == before + 1
    # loss sums of many float32 terms: 1e-5 relative
    for g, r in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=0)
    for g, r in zip((got[0], got[3], got[4]), (want[0], want[3], want[4])):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
    dlast = torch.from_numpy(rng.normal(size=(b, h)).astype(
        np.float32)).to(cuda)
    gscale = torch.tensor([0.7, 1.3], device=cuda)
    before = dk.decoder_fused_losses_bwd.launches
    g_all = dk.decoder_fused_losses_bwd(*args, want[3], want[4], dlast,
                                        gscale)
    r_all = dk.decoder_fused_losses_bwd_plain(*args, want[3], want[4], dlast,
                                              gscale)
    torch.cuda.synchronize()
    assert dk.decoder_fused_losses_bwd.launches == before + 1
    names = ("dw_cat", "dbias", "db1", "dw2m", "dw2v", "db2", "dw_ih",
             "dwo1", "dbo1", "dwo2", "dbo2", "dh0", "dc0")
    for name, g, r in zip(names, g_all, r_all):
        assert g.shape == r.shape, name
        assert _rel_max_err(g, r) <= 1e-4, name


def test_decoder_forward_repeats_exactly(cuda):
    """Per-block partial sums added in a fixed order: no atomics, so two
    runs give the same bits."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    rng = np.random.default_rng(41)
    args = _decoder_args(rng, cuda, 20, 40, 9, 16, 8, 8,
                         rng.integers(0, 21, size=40))
    a = dk.decoder_fused_losses_fwd(*args)
    b = dk.decoder_fused_losses_fwd(*args)
    assert a[1].item() == b[1].item() and a[2].item() == b[2].item()


@pytest.mark.parametrize("rows,k,n", [(5000, 129, 1024), (33, 1, 70),
                                      (70000, 3, 1)])
def test_wgrad_matches_plain(cuda, rows, k, n):
    from seq2seq_abcd_vae_tpu_torch.ops import wgrad
    rng = np.random.default_rng(rows)
    a = torch.from_numpy(rng.normal(size=(rows, k + 3)).astype(
        np.float32)).to(cuda)[:, :k]
    b = torch.from_numpy(rng.normal(size=(rows, n)).astype(
        np.float32)).to(cuda)
    for aa in (a, None):
        got = wgrad.at_b(aa, b)
        want = wgrad.at_b_plain(aa, b)
        assert _rel_max_err(got, want) <= 1e-5


@pytest.mark.parametrize("shape", [(33, 21, 129, 256, 256),
                                   (7, 5, 9, 40, 12),
                                   (6, 11, 129, 1024, 256)])
def test_decoder_loop_kernel_matches_twin(cuda, shape):
    """The plain sampled loop (generative decode): the pre-mask outs and
    the position-indexed emission streams, with ragged lengths and an
    empty row."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    rng = np.random.default_rng(51)
    t, b, f, h, m = shape
    lengths = rng.integers(1, t + 1, size=b)
    lengths[:2] = (t, 0)
    full = _decoder_args(rng, cuda, t, b, f, h, m, m, lengths)
    args = full[:9] + full[14:]
    before = dk.decoder_loop.launches
    got = dk.decoder_loop(*args)
    want = dk.decoder_loop_plain(*args)
    torch.cuda.synchronize()
    assert dk.decoder_loop.launches == before + 1
    # float32 products in another order through T sampled steps
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)


def _gru_layer_args(rng, cuda, t, b, f, h):
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[:2] = (t, 0)
    x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32)
                         ).to(cuda)
    w = [_uniform(rng, cuda, 1 / np.sqrt(h), *s)
         for s in ((2, f, 3 * h), (2, 3 * h), (2, h, 3 * h), (2, 3 * h))]
    return [x, torch.from_numpy(lengths).to(cuda), *w]


@pytest.mark.parametrize("shape", [(125, 512, 129, 256), (37, 21, 129, 256),
                                   (7, 5, 9, 40), (9, 11, 129, 1024)])
def test_gru_layer_kernels_match_twins(cuda, shape):
    """The bidirectional GRU layer's forward and backward kernels against
    their twins: the training shape, a partial row tile with a hidden size
    that is not a multiple of 32, and H=1024 (fewer rows a block)."""
    from seq2seq_abcd_vae_tpu_torch.ops import gru_kernel as gk
    rng = np.random.default_rng(61)
    t, b, f, h = shape
    args = _gru_layer_args(rng, cuda, t, b, f, h)
    before = gk.gru_layer_bidir_fused.launches
    got = gk.gru_layer_bidir_fused(*args)
    want = gk.gru_layer_bidir_fused_plain(*args)
    torch.cuda.synchronize()
    assert gk.gru_layer_bidir_fused.launches == before + 1
    # float32 dot products of F + H terms in another order through T steps
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
    outs, h_n = want
    for douts in (None, torch.from_numpy(rng.normal(size=outs.shape).astype(
            np.float32)).to(cuda)):
        dh_n = torch.from_numpy(rng.normal(size=h_n.shape).astype(
            np.float32)).to(cuda)
        before = gk.gru_layer_bidir_fused_bwd.launches
        g_all = gk.gru_layer_bidir_fused_bwd(*args, outs, douts, dh_n)
        r_all = gk.gru_layer_bidir_fused_bwd_plain(*args, outs, douts, dh_n)
        torch.cuda.synchronize()
        assert gk.gru_layer_bidir_fused_bwd.launches == before + 1
        for name, g, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"),
                              g_all, r_all):
            assert g.shape == r.shape, name
            assert _rel_max_err(g, r) <= 1e-4, name


def _gru_decoder_args(rng, cuda, t, b, f, h, m, mo, lengths):
    lstm = _decoder_args(rng, cuda, t, b, f, h, m, mo, lengths)
    return (lstm[:2] + [_uniform(rng, cuda, 1 / np.sqrt(h), h, 3 * h + 2 * m),
                        _uniform(rng, cuda, 1 / np.sqrt(h), 3 * h),
                        _uniform(rng, cuda, 1 / np.sqrt(h), 3 * h)]
            + lstm[4:8] + [_uniform(rng, cuda, 1 / np.sqrt(h), f, 3 * h)]
            + lstm[9:15])


@pytest.mark.parametrize("shape", [(125, 512, 129, 256, 256, 256),
                                   (33, 21, 129, 256, 256, 256),
                                   (7, 5, 9, 40, 12, 10),
                                   (6, 11, 129, 1024, 256, 256)])
def test_gru_decoder_kernels_match_twins(cuda, shape):
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    rng = np.random.default_rng(71)
    t, b, f, h, m, mo = shape
    lengths = rng.integers(1, t + 1, size=b)
    lengths[:2] = (t, 0)
    args = _gru_decoder_args(rng, cuda, t, b, f, h, m, mo, lengths)
    before = dk.gru_decoder_fused_losses_fwd.launches
    got = dk.gru_decoder_fused_losses_fwd(*args)
    want = dk.gru_decoder_fused_losses_fwd_plain(*args)
    torch.cuda.synchronize()
    assert dk.gru_decoder_fused_losses_fwd.launches == before + 1
    # loss sums of many float32 terms: 1e-5 relative
    for g, r in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=0)
    for g, r in zip((got[0], got[3]), (want[0], want[3])):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
    repeat = dk.gru_decoder_fused_losses_fwd(*args)
    assert (repeat[1].item(), repeat[2].item()) == (got[1].item(),
                                                    got[2].item())
    dlast = torch.from_numpy(rng.normal(size=(b, h)).astype(
        np.float32)).to(cuda)
    gscale = torch.tensor([0.7, 1.3], device=cuda)
    before = dk.gru_decoder_fused_losses_bwd.launches
    g_all = dk.gru_decoder_fused_losses_bwd(*args, want[3], dlast, gscale)
    r_all = dk.gru_decoder_fused_losses_bwd_plain(*args, want[3], dlast,
                                                  gscale)
    torch.cuda.synchronize()
    assert dk.gru_decoder_fused_losses_bwd.launches == before + 1
    names = ("dw_cat", "db_ih", "db_hh", "db1", "dw2m", "dw2v", "db2",
             "dw_ih", "dwo1", "dbo1", "dwo2", "dbo2", "dh0")
    for name, g, r in zip(names, g_all, r_all):
        assert g.shape == r.shape, name
        assert _rel_max_err(g, r) <= 1e-4, name


def test_gru_kernels_refuse_a_width_no_row_tile_fits(cuda):
    """At H=5000 the GRU layer's forward fits 2 rows a block but its
    backward does not, nor the GRU decoder's backward: the wrappers raise
    with both byte counts rather than launch."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    from seq2seq_abcd_vae_tpu_torch.ops import gru_kernel as gk
    rng = np.random.default_rng(81)
    t, b, f, h, m = 2, 2, 3, 5000, 4
    args = _gru_layer_args(rng, cuda, t, b, f, h)
    outs, h_n = gk.gru_layer_bidir_fused(*args)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="shared memory"):
        gk.gru_layer_bidir_fused_bwd(*args, outs, None, h_n)
    dargs = _gru_decoder_args(rng, cuda, t, b, f, h, m, m, [2, 1])
    hs = dk.gru_decoder_fused_losses_fwd_plain(*dargs)[3]
    with pytest.raises(ValueError, match="shared memory"):
        dk.gru_decoder_fused_losses_bwd(*dargs, hs, h_n[0].contiguous(),
                                        torch.ones(2, device=cuda))


@pytest.mark.parametrize("leak", [1.0, 0.5])
@pytest.mark.parametrize("shape", [(125, 512, 129, 256), (512, 64, 129, 256),
                                   (7, 5, 9, 40), (9, 11, 129, 1024)])
def test_elman_layer_kernels_match_twins(cuda, shape, leak):
    """The bidirectional Elman layer's forward and backward kernels against
    their twins at the Elman cell's leak (1.0) and an ESN's (0.5, zero
    biases): the training and the served shapes, a partial row tile with a
    hidden size that is not a multiple of 32, and H=1024."""
    from seq2seq_abcd_vae_tpu_torch.ops import elman_kernel as ek
    rng = np.random.default_rng(91)
    t, b, f, h = shape
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[:2] = (t, 0)
    x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32)
                         ).to(cuda)
    w = [_uniform(rng, cuda, 1 / np.sqrt(h), *s)
         for s in ((2, f, h), (2, h), (2, h, h), (2, h))]
    if leak < 1.0:
        w[1].zero_()
        w[3].zero_()
    args = (x, torch.from_numpy(lengths).to(cuda), *w)
    before = ek.rnn_layer_bidir_fused.launches
    got = ek.rnn_layer_bidir_fused(*args, leak)
    want = ek.rnn_layer_bidir_fused_plain(*args, leak)
    torch.cuda.synchronize()
    assert ek.rnn_layer_bidir_fused.launches == before + 1
    # float32 dot products of F + H terms in another order through T steps
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
    outs, h_n = want
    for douts in (None, torch.from_numpy(rng.normal(size=outs.shape).astype(
            np.float32)).to(cuda)):
        dh_n = torch.from_numpy(rng.normal(size=h_n.shape).astype(
            np.float32)).to(cuda)
        before = ek.rnn_layer_bidir_fused_bwd.launches
        g_all = ek.rnn_layer_bidir_fused_bwd(*args, outs, douts, dh_n, leak)
        r_all = ek.rnn_layer_bidir_fused_bwd_plain(*args, outs, douts, dh_n,
                                                   leak)
        torch.cuda.synchronize()
        assert ek.rnn_layer_bidir_fused_bwd.launches == before + 1
        for name, g, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"),
                              g_all, r_all):
            assert g.shape == r.shape, name
            assert _rel_max_err(g, r) <= 1e-4, name


def _rnn_decoder_args(rng, cuda, t, b, f, h, m, mo, lengths, leak):
    lstm = _decoder_args(rng, cuda, t, b, f, h, m, mo, lengths)
    bias = (_uniform(rng, cuda, 2 / np.sqrt(h), h) if leak == 1.0
            else torch.zeros(h, device=cuda))
    return (lstm[:2] + [_uniform(rng, cuda, 1 / np.sqrt(h), h, h + 2 * m),
                        bias] + lstm[4:8]
            + [_uniform(rng, cuda, 1 / np.sqrt(h), f, h)] + lstm[9:15])


@pytest.mark.parametrize("leak", [1.0, 0.5])
@pytest.mark.parametrize("shape", [(125, 512, 129, 256, 256, 256),
                                   (33, 21, 129, 256, 256, 256),
                                   (7, 5, 9, 40, 12, 10),
                                   (6, 11, 129, 1024, 256, 256)])
def test_rnn_decoder_kernels_match_twins(cuda, shape, leak):
    """The Elman / ESN fused-loss decoder's forward and backward kernels
    against their twins; the forward's losses repeat bit for bit."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    rng = np.random.default_rng(101)
    t, b, f, h, m, mo = shape
    lengths = rng.integers(1, t + 1, size=b)
    lengths[:2] = (t, 0)
    args = _rnn_decoder_args(rng, cuda, t, b, f, h, m, mo, lengths, leak)
    before = dk.rnn_decoder_fused_losses_fwd.launches
    got = dk.rnn_decoder_fused_losses_fwd(*args, leak=leak)
    want = dk.rnn_decoder_fused_losses_fwd_plain(*args, leak=leak)
    torch.cuda.synchronize()
    assert dk.rnn_decoder_fused_losses_fwd.launches == before + 1
    # loss sums of many float32 terms: 1e-5 relative
    for g, r in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=0)
    for g, r in zip((got[0], got[3]), (want[0], want[3])):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
    repeat = dk.rnn_decoder_fused_losses_fwd(*args, leak=leak)
    assert (repeat[1].item(), repeat[2].item()) == (got[1].item(),
                                                    got[2].item())
    dlast = torch.from_numpy(rng.normal(size=(b, h)).astype(
        np.float32)).to(cuda)
    gscale = torch.tensor([0.7, 1.3], device=cuda)
    before = dk.rnn_decoder_fused_losses_bwd.launches
    g_all = dk.rnn_decoder_fused_losses_bwd(*args, want[3], dlast, gscale,
                                            leak=leak)
    r_all = dk.rnn_decoder_fused_losses_bwd_plain(*args, want[3], dlast,
                                                  gscale, leak=leak)
    torch.cuda.synchronize()
    assert dk.rnn_decoder_fused_losses_bwd.launches == before + 1
    names = ("dw_cat", "dbias", "db1", "dw2m", "dw2v", "db2", "dw_ih",
             "dwo1", "dbo1", "dwo2", "dbo2", "dh0")
    for name, g, r in zip(names, g_all, r_all):
        assert g.shape == r.shape, name
        assert _rel_max_err(g, r) <= 1e-4, name



def _one_direction_args(rng, cuda, t, b, h, gates, leak=1.0):
    """xp, lengths, w_hh and b_hh of a one-direction layer (zero b_hh at an
    ESN's leak), ragged lengths with a full and an empty row."""
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[:2] = (t, 0)
    xp = torch.from_numpy(rng.normal(size=(t, b, gates * h)).astype(
        np.float32)).to(cuda)
    w_hh = _uniform(rng, cuda, 1 / np.sqrt(h), h, gates * h)
    b_hh = _uniform(rng, cuda, 1 / np.sqrt(h), gates * h)
    if leak < 1.0:
        b_hh.zero_()
    return [xp, torch.from_numpy(lengths).to(cuda), w_hh, b_hh]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell,leak", [("GRU", 1.0), ("RNN", 1.0),
                                       ("RNN", 0.5)])
@pytest.mark.parametrize("shape", [(125, 512, 256), (7, 5, 40),
                                   (9, 11, 1024)])
def test_one_direction_layer_kernels_match_twins(cuda, shape, cell, leak,
                                                 reverse):
    """The one-direction GRU and Elman / ESN layers over a projected input
    (``gru_layer``, ``rnn_layer``), forward and backward, against their
    twins in both span directions: the training shape, a partial row tile
    with a hidden size that is not a multiple of 32, and H=1024."""
    from seq2seq_abcd_vae_tpu_torch.ops import elman_kernel as ek
    from seq2seq_abcd_vae_tpu_torch.ops import gru_kernel as gk
    rng = np.random.default_rng(111)
    t, b, h = shape
    args = _one_direction_args(rng, cuda, t, b, h, 3 if cell == "GRU" else 1,
                               leak)
    if cell == "GRU":
        fwd, fwd_plain, bwd, bwd_plain, extra = (
            gk.gru_layer, gk.gru_layer_plain, gk.gru_layer_bwd,
            gk.gru_layer_bwd_plain, (reverse,))
    else:
        fwd, fwd_plain, bwd, bwd_plain, extra = (
            ek.rnn_layer, ek.rnn_layer_plain, ek.rnn_layer_bwd,
            ek.rnn_layer_bwd_plain, (reverse, leak))
    before = fwd.launches
    got = fwd(*args, *extra)
    want = fwd_plain(*args, *extra)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    # float32 dot products of H terms in another order through T steps
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
    outs, h_n = want
    for douts in (None, torch.from_numpy(rng.normal(size=outs.shape).astype(
            np.float32)).to(cuda)):
        dh_n = torch.from_numpy(rng.normal(size=h_n.shape).astype(
            np.float32)).to(cuda)
        before = bwd.launches
        g_all = bwd(*args, outs, douts, dh_n, *extra)
        r_all = bwd_plain(*args, outs, douts, dh_n, *extra)
        torch.cuda.synchronize()
        assert bwd.launches == before + 1
        for name, g, r in zip(("dxp", "dw_hh", "db_hh"), g_all, r_all):
            assert g.shape == r.shape, name
            assert _rel_max_err(g, r) <= 1e-4, name


@pytest.mark.parametrize("cell,leak", [("GRU", 1.0), ("RNN", 1.0),
                                       ("RNN", 0.5)])
@pytest.mark.parametrize("shape", [(124, 128, 129, 256, 256),
                                   (7, 5, 9, 40, 12),
                                   (6, 11, 129, 1024, 256)])
def test_cell_decoder_loop_kernels_match_twins(cuda, shape, cell, leak):
    """The GRU and Elman / ESN sampled loops (generative decode): the
    pre-mask outs of every step, with ragged lengths and an empty row, at
    the decode shape, a small one and H=1024."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    rng = np.random.default_rng(121)
    t, b, f, h, m = shape
    lengths = rng.integers(1, t + 1, size=b)
    lengths[:2] = (t, 0)
    if cell == "GRU":
        full = _gru_decoder_args(rng, cuda, t, b, f, h, m, m, lengths)
        args = full[:10] + full[15:]
        fwd, plain, extra = dk.gru_decoder_loop, dk.gru_decoder_loop_plain, {}
    else:
        full = _rnn_decoder_args(rng, cuda, t, b, f, h, m, m, lengths, leak)
        args = full[:9] + full[14:]
        fwd, plain = dk.rnn_decoder_loop, dk.rnn_decoder_loop_plain
        extra = {"leak": leak}
    before = fwd.launches
    got = fwd(*args, **extra)
    want = plain(*args, **extra)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1
    assert got.shape == want.shape == (t, b, h)
    # float32 products in another order through T sampled steps
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def _loop_case(rng, cuda, cell, leak, shape):
    """A sampled loop's forward arguments (``decoder_loop``'s for the LSTM,
    ``gru_decoder_loop``'s, ``rnn_decoder_loop``'s) with ragged lengths and
    an empty row, and (forward, twin, backward, twin, keyword arguments)."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    t, b, f, h, m = shape
    lengths = rng.integers(1, t + 1, size=b)
    lengths[:2] = (t, 0)
    if cell == "LSTM":
        full = _decoder_args(rng, cuda, t, b, f, h, m, m, lengths)
        args, prefix, kw = full[:9] + full[14:], "", {}
    elif cell == "GRU":
        full = _gru_decoder_args(rng, cuda, t, b, f, h, m, m, lengths)
        args, prefix, kw = full[:10] + full[15:], "gru_", {}
    else:
        full = _rnn_decoder_args(rng, cuda, t, b, f, h, m, m, lengths, leak)
        args, prefix, kw = full[:9] + full[14:], "rnn_", {"leak": leak}
    fns = [getattr(dk, prefix + "decoder_loop" + part)
           for part in ("", "_plain", "_bwd", "_bwd_plain")]
    return args, fns, kw


@pytest.mark.parametrize("cell,leak", [("LSTM", 1.0), ("GRU", 1.0),
                                       ("RNN", 1.0), ("RNN", 0.5)])
@pytest.mark.parametrize("shape", [(33, 21, 129, 256, 256),
                                   (7, 5, 9, 40, 12),
                                   (6, 11, 129, 1024, 256)])
def test_decoder_loop_backward_kernels_match_twins(cuda, shape, cell, leak):
    """The sampled loops' backwards (the decoder's stream training path):
    every weight gradient and the initial state's against the twins, from
    the forward kernel's saved carries (themselves against the twin's),
    with the outs' cotangent and, for the LSTM, those of the emission
    streams (slot T-1 never read), at the training shape, a small one and
    H=1024 (its row tile picked at launch)."""
    rng = np.random.default_rng(131)
    args, (fwd, fwd_plain, bwd, bwd_plain), kw = _loop_case(
        rng, cuda, cell, leak, shape)
    t, b, f = args[0].shape
    h = args[2].shape[0]
    params = [a.clone().requires_grad_(True) if i >= 2 else a
              for i, a in enumerate(args)]
    if cell == "LSTM":
        carries = fwd_plain(*args, return_carries=True)[3:]
    else:
        carries = fwd_plain(*args, **kw, return_carries=True)[1:]
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(cuda)
    cots = [normal(t, b, h)] + ([normal(t, b, f), normal(t, b, f)]
                                if cell == "LSTM" else [])
    before = (fwd.launches, bwd.launches)
    out = fwd(*params, **kw)
    outs = out if cell == "LSTM" else (out,)
    grads = torch.autograd.grad(sum((o * c).sum() for o, c in
                                    zip(outs, cots)), params[2:])
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    want = bwd_plain(*args, *carries, *cots, **kw)
    for i, (g, r) in enumerate(zip(grads, want)):
        assert g.shape == r.shape, i
        # sums over T * B rows in another order: 1e-4 of the leaf's max
        assert _rel_max_err(g, r) <= 1e-4, i
    direct = bwd(*args, *carries, *cots, **kw)
    assert all(_rel_max_err(g, r) <= 1e-4 for g, r in zip(direct, want))


@pytest.mark.parametrize("shape", [(33, 21, 129, 256, 256),
                                   (7, 5, 9, 40, 12),
                                   (6, 11, 129, 1024, 256)])
def test_decoder_fused_nll_kernels_match_twins(cuda, shape):
    """The LSTM loop with the emission NLL fused (decoder_loop_fused_nll):
    outs, nll and the saved carries, then every gradient, against the
    twins; two forward runs give the same bits."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    rng = np.random.default_rng(141)
    t, b, f, h, m = shape
    lengths = rng.integers(1, t + 1, size=b)
    lengths[:2] = (t, 0)
    full = _decoder_args(rng, cuda, t, b, f, h, m, m, lengths)
    args = full[:10] + full[14:]
    before = dk.decoder_fused_nll_fwd.launches
    got = dk.decoder_fused_nll_fwd(*args)
    want = dk.decoder_fused_nll_fwd_plain(*args)
    again = dk.decoder_fused_nll_fwd(*args)
    torch.cuda.synchronize()
    assert dk.decoder_fused_nll_fwd.launches == before + 2
    assert again[1].item() == got[1].item()
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    for g, r in zip((got[0],) + got[2:], (want[0],) + want[2:]):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
    douts = torch.from_numpy(rng.normal(size=(t, b, h)).astype(
        np.float32)).to(cuda)
    gscale = torch.tensor([0.7], device=cuda)
    before = dk.decoder_fused_nll_bwd.launches
    g_all = dk.decoder_fused_nll_bwd(*args, want[2], want[3], douts, gscale)
    r_all = dk.decoder_fused_nll_bwd_plain(*args, want[2], want[3], douts,
                                           gscale)
    torch.cuda.synchronize()
    assert dk.decoder_fused_nll_bwd.launches == before + 1
    for i, (g, r) in enumerate(zip(g_all, r_all)):
        assert g.shape == r.shape, i
        assert _rel_max_err(g, r) <= 1e-4, i


def test_stream_kernels_take_their_row_tiles_at_hidden_1024(cuda):
    """The new kinds' shared memory at F=129, H=1024, m=256 fits a block
    of this card at the row tile picked: 4 rows for the LSTM and GRU loop
    backwards and the fused-NLL backward, 8 for the rest."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    lib = _build.load("decoder")
    for kind, rows in ((9, 4), (10, 4), (11, 8), (12, 8), (13, 4)):
        assert lib.abcd_decoder_rows(kind, 129, 1024, 256, 0) == rows, kind
        assert (lib.abcd_decoder_smem_bytes(kind, rows, 129, 1024, 256, 0)
                <= min(232448, lib.abcd_decoder_smem_limit(kind, rows)))


# ---------------------------------------------------------------------------
# in-kernel decoder noise (the JAX package's SEQ2SEQ_KERNEL_RNG): the dump
# kernel, and the fused-loss kernels' seed mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(125, 512, 129), (7, 5, 9)])
def test_noise_dump_kernel_matches_twin(cuda, shape):
    """The dump kernel's 24-bit integers equal the twin's, its normals are
    within 2e-6 (logf / cosf against torch's, a few float32 ulps of |eps|
    <= 5.9), their mean and variance within 5 standard errors of 0 and 1;
    two seeds and two slots differ."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    t, b, f = shape
    seed = torch.tensor([[4242.0]], device=cuda)
    before = dk.decoder_noise_dump.launches
    out, bits = dk.decoder_noise_dump(seed, t, b, f, with_bits=True)
    want, want_bits = dk.decoder_noise_dump_plain(seed, t, b, f,
                                                  with_bits=True)
    torch.cuda.synchronize()
    assert dk.decoder_noise_dump.launches == before + 1
    assert torch.equal(bits, want_bits)
    assert (out - want).abs().max().item() <= 2e-6
    n = out.numel()
    assert abs(out.double().mean().item()) <= 5.0 / np.sqrt(n)
    assert abs(out.double().var().item() - 1.0) <= 5.0 * np.sqrt(2.0 / n)
    assert not torch.equal(out, dk.decoder_noise_dump(seed + 1.0, t, b, f))
    assert not torch.equal(out[0], out[1])


_SEED_FNS = {"LSTM": ("decoder_fused_losses_fwd", "decoder_fused_losses_bwd"),
             "GRU": ("gru_decoder_fused_losses_fwd",
                     "gru_decoder_fused_losses_bwd"),
             "RNN": ("rnn_decoder_fused_losses_fwd",
                     "rnn_decoder_fused_losses_bwd")}


@pytest.mark.parametrize("cell,leak", [("LSTM", 1.0), ("GRU", 1.0),
                                       ("RNN", 1.0), ("RNN", 0.5)])
@pytest.mark.parametrize("shape", [(33, 21, 129, 256, 256, 256),
                                   (6, 11, 129, 1024, 256, 256)])
def test_seed_mode_kernels_match_dump_fed_kernels(cuda, shape, cell, leak):
    """Each fused-loss kernel in seed mode (a (1, 1) seed in place of the
    noise) draws what the dump holds: forward and backward equal the same
    kernels fed the dump (expected bit for bit; held to 1e-6), and the
    twins fed the dump within the fused kernels' 1e-4; the seed-mode
    launches count on the ``seed`` counters only; each seed kind takes its
    stream kind's row tile (at H=1024 too)."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    rng = np.random.default_rng(151)
    t, b, f, h, m, mo = shape
    lengths = rng.integers(1, t + 1, size=b)
    lengths[:2] = (t, 0)
    if cell == "LSTM":
        args = _decoder_args(rng, cuda, t, b, f, h, m, mo, lengths)
    elif cell == "GRU":
        args = _gru_decoder_args(rng, cuda, t, b, f, h, m, mo, lengths)
    else:
        args = _rnn_decoder_args(rng, cuda, t, b, f, h, m, mo, lengths,
                                 leak)
    kw = {"leak": leak} if cell == "RNN" else {}
    fwd, bwd = (getattr(dk, name) for name in _SEED_FNS[cell])
    seed = torch.tensor([[float(rng.integers(0, 1 << 24))]], device=cuda)
    dump = dk.decoder_noise_dump(seed, t, b, f)
    seeded, fed = [seed] + args[1:], [dump] + args[1:]
    counts = (fwd.launches, fwd.seed.launches)
    got = fwd(*seeded, **kw)
    torch.cuda.synchronize()
    assert (fwd.launches, fwd.seed.launches) == (counts[0], counts[1] + 1)
    same = fwd(*fed, **kw)
    plain = getattr(dk, _SEED_FNS[cell][0] + "_plain")(*fed, **kw)
    for g, s_, p in zip(got[1:3], same[1:3], plain[1:3]):
        torch.testing.assert_close(g, s_, rtol=1e-6, atol=0)
        torch.testing.assert_close(g, p, rtol=1e-5, atol=0)
    for g, s_, p in zip((got[0],) + got[3:], (same[0],) + same[3:],
                        (plain[0],) + plain[3:]):
        assert _rel_max_err(g, s_) <= 1e-6
        torch.testing.assert_close(g, p, rtol=0, atol=1e-4)
    saved = list(plain[3:])
    dlast = torch.from_numpy(rng.normal(size=(b, h)).astype(
        np.float32)).to(cuda)
    gscale = torch.tensor([0.7, 1.3], device=cuda)
    counts = (bwd.launches, bwd.seed.launches)
    g_all = bwd(*seeded, *saved, dlast, gscale, **kw)
    torch.cuda.synchronize()
    assert (bwd.launches, bwd.seed.launches) == (counts[0], counts[1] + 1)
    s_all = bwd(*fed, *saved, dlast, gscale, **kw)
    p_all = getattr(dk, _SEED_FNS[cell][1] + "_plain")(*fed, *saved, dlast,
                                                       gscale, **kw)
    for i, (g, s_, p) in enumerate(zip(g_all, s_all, p_all)):
        assert _rel_max_err(g, s_) <= 1e-6, i
        assert _rel_max_err(g, p) <= 1e-4, i
    # the seed kinds (14-19) take their stream kinds' row tiles
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    lib = _build.load("decoder")
    pairs = {"LSTM": ((14, 0), (15, 1)), "GRU": ((16, 3), (17, 4)),
             "RNN": ((18, 5), (19, 6))}[cell]
    for seed_kind, kind in pairs:
        assert (lib.abcd_decoder_rows(seed_kind, f, h, m, mo)
                == lib.abcd_decoder_rows(kind, f, h, m, mo))


@pytest.mark.parametrize("h,with_douts", [(256, False), (256, True),
                                          (1024, False)])
def test_lstm_layer_bidir_kernels_match_twins(cuda, h, with_douts):
    """Both directions over xp in one launch (lstm_pallas.lstm_layer_bidir):
    forward with the saved cell states and backward, against the twins,
    with ragged lengths and an empty row, and through the autograd
    Function; H=1024 takes a smaller row tile."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    rng = np.random.default_rng(h + 4 * with_douts)
    t, b = (37, 21) if h == 256 else (5, 6)
    xp = torch.from_numpy(rng.normal(size=(t, 2, b, 4 * h)).astype(
        np.float32)).to(cuda)
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[:2] = (t, 0)
    lengths = torch.from_numpy(lengths).to(cuda)
    w_hh = _uniform(rng, cuda, 1 / np.sqrt(h), 2, h, 4 * h)
    b_hh = _uniform(rng, cuda, 1 / np.sqrt(h), 2, 4 * h)
    before = lk.lstm_layer_bidir.launches
    got = lk.lstm_layer_bidir(xp, lengths, w_hh, b_hh, return_cs=True)
    want = lk.lstm_layer_bidir_plain(xp, lengths, w_hh, b_hh,
                                     return_cs=True)
    torch.cuda.synchronize()
    assert lk.lstm_layer_bidir.launches == before + 1
    # float32 dot products of H terms in another order through T steps
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
    outs, h_n, c_n, cs = want
    normal = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda)
    douts = normal(outs.shape) if with_douts else None
    bwd = (xp, lengths, w_hh, b_hh, outs, cs, douts, normal(h_n.shape),
           normal(c_n.shape))
    before = lk.lstm_layer_bidir_bwd.launches
    g_all = lk.lstm_layer_bidir_bwd(*bwd)
    r_all = lk.lstm_layer_bidir_bwd_plain(*bwd)
    torch.cuda.synchronize()
    assert lk.lstm_layer_bidir_bwd.launches == before + 1
    for name, g, r in zip(("dxp", "dw_hh", "db_hh"), g_all, r_all):
        assert g.shape == r.shape, name
        assert _rel_max_err(g, r) <= 1e-4, name
    # the autograd Function: one forward and one backward launch
    args = [a.clone().requires_grad_(True) for a in (xp, w_hh, b_hh)]
    before = (lk.lstm_layer_bidir.launches, lk.lstm_layer_bidir_bwd.launches)
    o, hn, cn = lk.lstm_layer_bidir_train(args[0], lengths, *args[1:])
    (hn.square().sum() + cn.sin().sum()
     + (o.sum() if with_douts else 0.0)).backward()
    torch.cuda.synchronize()
    assert (lk.lstm_layer_bidir.launches,
            lk.lstm_layer_bidir_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert all(torch.isfinite(a.grad).all() for a in args)


def test_plain_vae_step_on_the_card_matches_cpu_twins(cuda):
    """One training loss of the plain Gaussian VAE (bidirectional LSTM
    encoder, Gaussian head, fused-loss LSTM decoder) and every gradient,
    on the kernels (card) against the twins (CPU), same weights, inputs,
    normals and decoder noise."""
    from seq2seq_abcd_vae_tpu_torch.configs import (DecoderConfig,
                                                    EncoderConfig,
                                                    GaussianSamplerConfig)
    from seq2seq_abcd_vae_tpu_torch.models import vae
    from seq2seq_abcd_vae_tpu_torch.tree import tree_leaves, tree_map
    rng = np.random.default_rng(16)
    t, f, h, feat = 37, 129, 256, 16
    lens = rng.integers(1, t + 1, size=21).astype(np.int32)
    lens[:2] = (t, 0)
    b = len(lens)
    enc = EncoderConfig(f, h)
    cfg = vae.ModelConfig(
        enc, GaussianSamplerConfig(enc.hidden_size_total, 256, feat),
        DecoderConfig(f, h, 256, feat, num_speakers=2, speaker_embed_dim=8))
    params0 = vae.model_init(torch.Generator().manual_seed(3), cfg)
    valid = np.arange(t)[None, :] < lens[:, None]
    inputs = torch.from_numpy((rng.normal(size=(b, t, f))
                               * valid[..., None]).astype(np.float32))
    speakers = torch.from_numpy(rng.integers(0, 2, size=b).astype(np.int32))
    noise = {"normal": torch.from_numpy(rng.normal(size=(b, feat)).astype(
                 np.float32)),
             "decoder": torch.from_numpy(rng.normal(size=(t, b, f)).astype(
                 np.float32))}

    def step(device):
        params = vae.set_trainable(tree_map(
            lambda p: p.detach().to(device).clone(), params0), cfg)
        batch = {"inputs": inputs.to(device),
                 "lengths": torch.from_numpy(lens).to(device),
                 "speakers": speakers.to(device)}
        loss, _ = vae.training_loss(
            params, cfg, batch, {k: v.to(device) for k, v in noise.items()},
            float(b))
        loss.backward()
        return loss.item(), [p.grad.cpu() for p in tree_leaves(params)]

    card, cpu = step(cuda), step(torch.device("cpu"))
    assert abs(card[0] - cpu[0]) <= 1e-5 * abs(cpu[0])
    for g, r in zip(card[1], cpu[1]):
        assert _rel_max_err(g, r) <= 1e-4


# ---------------------------------------------------------------------------
# the redesigned kernels: the LSTM forward's cluster design and shape rule,
# the STFT's FFT route and its DFT route
# ---------------------------------------------------------------------------

def _bidir_args(rng, cuda, t, b, f, h, lens=None):
    x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32))
    if lens is None:
        lens = rng.integers(1, t + 1, size=b).astype(np.int32)
        lens[:2] = (t, 0)[:b]
    w = [_uniform(rng, cuda, 1 / np.sqrt(h), *s)
         for s in ((2, f, 4 * h), (2, 4 * h), (2, h, 4 * h), (2, 4 * h))]
    return (x.to(cuda), torch.from_numpy(np.asarray(lens, np.int32)).to(cuda),
            *w)


@pytest.mark.parametrize("shape", [(512, 64, 129), (125, 512, 129),
                                   (37, 21, 129), (64, 13, 65)])
def test_lstm_cluster_forward_matches_twin(cuda, shape):
    """The cluster design at the served (B=64, T=512) and training (B=512,
    T=125) shapes, with ragged lengths, a row of length 0 and B not a
    multiple of the tile's 8 rows: outs, the final states and the saved
    cell states against the twin, and against the per-tile kernel on the
    same inputs; the public function launches the design the shape rule
    names, once."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    t, b, f = shape
    rng = np.random.default_rng(t + b)
    args = _bidir_args(rng, cuda, t, b, f, 256)
    lib = _build.load("lstm")
    active = lib.abcd_lstm_cluster_max_active(f, 256)
    pair = {r: lib.abcd_lstm_pair_cluster_max_active(256, r)
            for r in lk.PROJ_CLUSTER_TILES}
    design = getattr(lk.lstm_layer_bidir_fused,
                     lk.forward_design(active, b, pair))
    before = (lk.lstm_layer_bidir_fused.launches, design.launches)
    lk.lstm_layer_bidir_fused(*args)
    torch.cuda.synchronize()
    assert (lk.lstm_layer_bidir_fused.launches,
            design.launches) == (before[0] + 1, before[1] + 1)
    got = lk.lstm_layer_bidir_fused_on("cluster", *args, return_cs=True)
    want = lk.lstm_layer_bidir_fused_plain(*args, return_cs=True)
    tile = lk.lstm_layer_bidir_fused_on("tile", *args, return_cs=True)
    torch.cuda.synchronize()
    # float32 dot products of F + H terms in another order through T steps
    # against the twin; the per-tile kernel's own order of operations
    for g, r, p in zip(got, want, tile):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
        torch.testing.assert_close(g, p, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(7, 5, 9, 40), (3, 1, 9, 40),
                                   (6, 9, 33, 64), (1, 8, 129, 256)])
def test_lstm_cluster_forward_edge_shapes(cuda, shape):
    """Edges of the cluster design, forced: a batch smaller than one tile,
    the only row of length 0 (every CTA still reaches every cluster
    barrier), a slice that leaves idle lanes (H / 8 units not filling a
    warp), one step."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    t, b, f, h = shape
    rng = np.random.default_rng(sum(shape))
    lens = [0] if b == 1 else None
    args = _bidir_args(rng, cuda, t, b, f, h, lens)
    got = lk.lstm_layer_bidir_fused_on("cluster", *args, return_cs=True)
    want = lk.lstm_layer_bidir_fused_plain(*args, return_cs=True)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)


def test_lstm_cluster_cs_feeds_the_backward(cuda):
    """The cluster forward's saved cell states are what the unchanged
    backward kernel (kind 1) needs: the backward run on them gives the
    backward twin's gradients on the twin's states."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    rng = np.random.default_rng(31)
    t, b, f, h = 125, 64, 129, 256
    args = _bidir_args(rng, cuda, t, b, f, h)
    outs, h_n, c_n, cs = lk.lstm_layer_bidir_fused_on("cluster", *args,
                                                      return_cs=True)
    want = lk.lstm_layer_bidir_fused_plain(*args, return_cs=True)
    normal = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda)
    cot = (normal(outs.shape), normal(h_n.shape), normal(c_n.shape))
    got = lk.lstm_layer_bidir_fused_bwd(*args, outs, cs, *cot)
    ref = lk.lstm_layer_bidir_fused_bwd_plain(*args, want[0], want[3], *cot)
    torch.cuda.synchronize()
    for name, g, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"), got,
                          ref):
        assert _rel_max_err(g, r) <= 1e-4, name


@pytest.mark.parametrize("f,h,design", [(129, 1024, "tile"),
                                        (512, 256, "proj")])
def test_lstm_forward_rule_keeps_wide_shapes_per_tile(cuda, f, h, design):
    """H=1024 and a second layer's F = 2H: the raw cluster's slices do not
    fit and the card reports no resident cluster for it; the shape rule
    sends F = 2H at H=256 to the "proj" design and H=1024, which no
    cluster takes, to the per-tile kernel, each matching its twin."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    lib = _build.load("lstm")
    assert lib.abcd_lstm_cluster_max_active(f, h) == 0
    assert lib.abcd_lstm_cluster_max_active(129, 256) > 0
    rng = np.random.default_rng(f + h)
    args = _bidir_args(rng, cuda, 5, 6, f, h)
    counter = getattr(lk.lstm_layer_bidir_fused, design)
    before = counter.launches
    got = lk.lstm_layer_bidir_fused(*args)
    want = lk.lstm_layer_bidir_fused_plain(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    with pytest.raises(RuntimeError, match="launch failed"):
        lk.lstm_layer_bidir_fused_on("cluster", *args)


def _stft_case(cuda, fs, b=64, t=512, seed=0):
    rng = np.random.default_rng(seed + fs)
    frame = int(0.008 * fs)
    step = frame // 2
    audio = torch.from_numpy(rng.integers(
        -3000, 3000, size=(b, t * step + frame)).astype(np.float32)).to(cuda)
    audio[-2:] = 0.0  # silent padding rows
    cos_b, sin_b = stft.basis_tensors(frame, "hann_window", cuda)
    return (audio, cos_b, sin_b, frame, step, t, 2.0 ** -15, 11.0)


@pytest.mark.parametrize("fs", [16000, 32000])
def test_stft_fft_route_matches_twin_and_rfft(cuda, fs):
    """The FFT route at the publication's rates against the twin (the DFT
    by products) and against torch.fft.rfft (the ``fft`` method), silent
    rows included."""
    args = _stft_case(cuda, fs)
    before = stft_kernel.log_spectrogram_kernel.fft.launches
    got = stft_kernel.log_spectrogram_kernel(*args)
    torch.cuda.synchronize()
    assert stft_kernel.log_spectrogram_kernel.fft.launches == before + 1
    want = stft_kernel.log_spectrogram_plain(*args)
    audio, _, _, frame, step, t, eps, norm = args
    rfft = stft.log_spectrogram(audio, frame, step, t, eps, norm,
                                method="fft")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    torch.testing.assert_close(got, rfft, rtol=0, atol=1e-3)
    torch.testing.assert_close(got[-2:], want[-2:], rtol=0, atol=0)


@pytest.mark.parametrize("fs", [26000, 27250])
def test_stft_dft_route_at_other_frames(cuda, fs):
    """A frame whose half has a prime factor above 11 (208 at 26 kHz, half
    8 * 13; 218 at 27.25 kHz, half 109) reaches the DFT route."""
    args = _stft_case(cuda, fs, t=64)
    before = stft_kernel.log_spectrogram_kernel.dft.launches
    got = stft_kernel.log_spectrogram_kernel(*args)
    torch.cuda.synchronize()
    assert stft_kernel.log_spectrogram_kernel.dft.launches == before + 1
    torch.testing.assert_close(got, stft_kernel.log_spectrogram_plain(*args),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("fs,b,t", [(44100, 64, 512), (48000, 64, 512),
                                    (22050, 64, 512), (11025, 5, 33),
                                    (96000, 4, 40), (24000, 3, 9)])
def test_stft_mixed_radix_route_matches_twin_and_rfft(cuda, fs, b, t):
    """The FFT route's mixed-radix passes (352 at 44.1 kHz: 4, 4, 11; 384
    at 48 kHz: 4, 4, 4, 3; 176, 88, 768, 192) against the twin and against
    a float64 torch.fft.rfft of the same windowed frames, silent rows
    included.  The passes give the complex bins, held to the float64
    answer at the twin's tolerance; DC and Nyquist are float32 sums of the
    basis's columns, the twin's and the TPU kernel's own arithmetic, which
    at the rare frames whose sum nearly cancels is off the float64 answer
    by more than that after the log, so they get the JAX package's bound
    for its kernel against rfft (tests/test_stft_pallas.py)."""
    args = _stft_case(cuda, fs, b=b, t=t)
    assert stft_kernel.route(args[3]) == "mixed"
    before = stft_kernel.log_spectrogram_kernel.mixed.launches
    got = stft_kernel.log_spectrogram_kernel(*args)
    torch.cuda.synchronize()
    assert stft_kernel.log_spectrogram_kernel.mixed.launches == before + 1
    want = stft_kernel.log_spectrogram_plain(*args)
    audio, cos_b, _, frame, step, t, eps, norm = args
    frames = audio.double().unfold(-1, frame, step)[..., :t, :]
    amp = torch.fft.rfft(frames * cos_b[:, 0].double(), dim=-1).abs()
    exact = (torch.log(amp + eps) / norm).float()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    torch.testing.assert_close(got[..., 1:-1], exact[..., 1:-1], rtol=0,
                               atol=1e-3)
    torch.testing.assert_close(got[..., [0, -1]], exact[..., [0, -1]],
                               rtol=5e-3, atol=5e-3)
    torch.testing.assert_close(got[-2:], want[-2:], rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(512, 64, 177), (125, 512, 177),
                                   (512, 64, 193), (64, 13, 512),
                                   (7, 5, 9, 40), (3, 1, 9, 40),
                                   (6, 9, 33, 64), (1, 8, 177, 256)])
def test_lstm_proj_forward_matches_twin(cuda, shape):
    """Row 2's "proj" design (the input projection of every active
    row-step, then both directions' recurrence in one cluster launch), at
    44.1 and 48 kHz's F=177 and 193 (B=64, T=512; B=512, T=125), a second
    layer's F = 2H, a batch smaller than a tile, the only row of length 0,
    idle lanes (H / 8 units not filling a warp) and one step: outs, the
    final states and the saved cell states against the twin, and against
    the per-tile kernel; the public function launches the design the rule
    names."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    t, b, f, h = (*shape, 256)[:4]
    rng = np.random.default_rng(sum(shape) + 1)
    args = _bidir_args(rng, cuda, t, b, f, h, [0] if b == 1 else None)
    got = lk.lstm_layer_bidir_fused_on("proj", *args, return_cs=True)
    want = lk.lstm_layer_bidir_fused_plain(*args, return_cs=True)
    tile = lk.lstm_layer_bidir_fused_on("tile", *args, return_cs=True)
    torch.cuda.synchronize()
    for g, r, p in zip(got, want, tile):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
        torch.testing.assert_close(g, p, rtol=0, atol=1e-5)
    if h == 256 and f > 129:
        before = lk.lstm_layer_bidir_fused.proj.launches
        lk.lstm_layer_bidir_fused(*args)
        torch.cuda.synchronize()
        assert lk.lstm_layer_bidir_fused.proj.launches == before + 1


def test_lstm_proj_forward_repeats_and_marks_its_parts(cuda):
    """Two runs agree bit for bit, and ``marks`` gets the three events
    around the projection and the recurrence."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    rng = np.random.default_rng(5)
    args = _bidir_args(rng, cuda, 40, 21, 177, 256)
    marks = []
    first = lk.lstm_layer_bidir_fused_on("proj", *args, marks=marks)
    second = lk.lstm_layer_bidir_fused_on("proj", *args)
    torch.cuda.synchronize()
    assert len(marks) == 3
    assert all(marks[i].elapsed_time(marks[i + 1]) >= 0 for i in range(2))
    for g, r in zip(first, second):
        assert torch.equal(g, r)


def test_lstm_proj_cs_feeds_the_backward(cuda):
    """The "proj" design's saved cell states are what the backward needs:
    the backward run on them gives the backward twin's gradients on the
    twin's states (F=177, the 44.1 kHz training path)."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    rng = np.random.default_rng(37)
    t, b, f, h = 125, 64, 177, 256
    args = _bidir_args(rng, cuda, t, b, f, h)
    outs, h_n, c_n, cs = lk.lstm_layer_bidir_fused_on("proj", *args,
                                                      return_cs=True)
    want = lk.lstm_layer_bidir_fused_plain(*args, return_cs=True)
    normal = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(cuda)
    cot = (normal(outs.shape), normal(h_n.shape), normal(c_n.shape))
    got = lk.lstm_layer_bidir_fused_bwd(*args, outs, cs, *cot)
    ref = lk.lstm_layer_bidir_fused_bwd_plain(*args, want[0], want[3], *cot)
    torch.cuda.synchronize()
    for name, g, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"), got,
                          ref):
        assert _rel_max_err(g, r) <= 1e-4, name


@pytest.mark.parametrize("h", [1024, 36])
def test_lstm_proj_forward_refuses_widths_it_does_not_take(cuda, h):
    """H=1024 and H=36 (not a multiple of 8): no resident cluster of the
    pair recurrence, so the rule keeps the per-tile kernel and a forced
    "proj" call raises before any launch."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    lib = _build.load("lstm")
    assert all(lib.abcd_lstm_pair_cluster_max_active(h, rows) == 0
               for rows in lk.PROJ_CLUSTER_TILES)
    rng = np.random.default_rng(h + 3)
    args = _bidir_args(rng, cuda, 4, 3, 177, h)
    before = lk.lstm_layer_bidir_fused.proj.launches
    with pytest.raises(RuntimeError, match="refused"):
        lk.lstm_layer_bidir_fused_on("proj", *args)
    assert lk.lstm_layer_bidir_fused.proj.launches == before


def test_lstm_proj_forward_takes_unaligned_weights(cuda):
    """Weights at an odd float offset (not 16-byte aligned): the projection
    loads W_ih a float at a time and still matches the twin."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    rng = np.random.default_rng(23)
    x, lengths, *w = _bidir_args(rng, cuda, 23, 19, 177, 256)

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    args = (x, lengths, *(unaligned(t) for t in w))
    got = lk.lstm_layer_bidir_fused_on("proj", *args)
    want = lk.lstm_layer_bidir_fused_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the redesigned LSTM kernels of rows 2b and 3: the raw backward's cluster
# route (gate recompute, recurrence in a cluster, dx) and the one-direction
# forward's cluster route, each against the twin and the per-tile kernel
# ---------------------------------------------------------------------------

def _bwd_args(rng, cuda, t, b, f, h, with_douts):
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    args = _bidir_args(rng, cuda, t, b, f, h)
    outs, _, _, cs = lk.lstm_layer_bidir_fused_plain(*args, return_cs=True)
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(cuda)
    douts = normal(t, 2, b, h) if with_douts else None
    return (*args, outs, cs, douts, normal(2, b, h), normal(2, b, h))


@pytest.mark.parametrize("with_douts", [False, True])
@pytest.mark.parametrize("shape", [(125, 512, 129), (37, 13, 129),
                                   (33, 21, 129), (17, 21, 512)])
def test_lstm_cluster_backward_matches_twin(cuda, shape, with_douts):
    """Row 2b's cluster route at the training shape, at batches below one
    tile's worth of clusters and at a second layer's F = 2H (which it
    takes), ragged with a row of length 0: every gradient against the twin
    and the per-tile route; the public wrapper takes the route its rule
    names, once, with the same result."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    t, b, f = shape
    rng = np.random.default_rng(t * b + f + with_douts)
    args = _bwd_args(rng, cuda, t, b, f, 256, with_douts)
    lib = _build.load("lstm")
    assert lk.backward_design(lib.abcd_lstm_bwd_cluster_max_active(
        256, lk.BWD_CLUSTER_ROWS)) == "cluster"
    before = (lk.lstm_layer_bidir_fused_bwd.launches,
              lk.lstm_layer_bidir_fused_bwd.cluster.launches)
    picked = lk.lstm_layer_bidir_fused_bwd(*args)
    torch.cuda.synchronize()
    assert (lk.lstm_layer_bidir_fused_bwd.launches,
            lk.lstm_layer_bidir_fused_bwd.cluster.launches) == (
                before[0] + 1, before[1] + 1)
    got = lk.lstm_layer_bidir_fused_bwd_on("cluster", *args)
    tile = lk.lstm_layer_bidir_fused_bwd_on("tile", *args)
    want = lk.lstm_layer_bidir_fused_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, g, p, r, q in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"),
                                got, tile, want, picked):
        assert _rel_max_err(g, r) <= 1e-4, name
        assert _rel_max_err(g, p) <= 1e-4, name
        torch.testing.assert_close(g, q, rtol=0, atol=0)   # runs repeat


def test_lstm_cluster_backward_marks_its_parts(cuda):
    """The timing hook records an event before (a) and after (a), (b), (c)
    and (d), in order."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    rng = np.random.default_rng(9)
    args = _bwd_args(rng, cuda, 9, 11, 129, 256, False)
    marks = []
    lk.lstm_layer_bidir_fused_bwd_on("cluster", *args, marks=marks)
    torch.cuda.synchronize()
    assert len(marks) == 5
    assert all(marks[i].elapsed_time(marks[i + 1]) >= 0 for i in range(4))


@pytest.mark.parametrize("h", [1024, 200])
def test_lstm_cluster_backward_refuses_widths_it_does_not_take(cuda, h):
    """H=1024 (the slice does not fit) and H=200 (not a multiple of 32):
    the card reports no resident cluster, the rule keeps the per-tile
    route, and a forced cluster launch is refused before any launch."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    lib = _build.load("lstm")
    assert lib.abcd_lstm_bwd_cluster_max_active(h, lk.BWD_CLUSTER_ROWS) == 0
    rng = np.random.default_rng(h)
    args = _bwd_args(rng, cuda, 5, 6, 9, h, False)
    before = lk.lstm_layer_bidir_fused_bwd.tile.launches
    got = lk.lstm_layer_bidir_fused_bwd(*args)
    want = lk.lstm_layer_bidir_fused_bwd_plain(*args)
    torch.cuda.synchronize()
    assert lk.lstm_layer_bidir_fused_bwd.tile.launches == before + 1
    for g, r in zip(got, want):
        assert _rel_max_err(g, r) <= 1e-4
    with pytest.raises(RuntimeError, match="refused"):
        lk.lstm_layer_bidir_fused_bwd_on("cluster", *args)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(125, 512), (512, 64), (37, 13), (1, 3)])
def test_lstm_layer_cluster_matches_twin(cuda, shape, reverse):
    """Row 3's cluster route at the training (B=512, T=125) and served
    (B=64, T=512) shapes, a small batch and one step, both span
    directions, ragged with a row of length 0: outs, the final states and
    the saved cell states against the twin and the per-tile kernel; the
    public wrapper launches the route its rule names, once."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    t, b = shape
    rng = np.random.default_rng(t + b + reverse)
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[:2] = (t, 0)[:b]
    lengths = torch.from_numpy(lens).to(cuda)
    xp = torch.from_numpy(rng.normal(size=(t, b, 1024)).astype(np.float32)
                          ).to(cuda)
    w_hh, b_hh = _uniform(rng, cuda, 1 / 16, 256, 1024), _uniform(
        rng, cuda, 1 / 16, 1024)
    before = (lk.lstm_layer.launches, lk.lstm_layer.cluster.launches)
    lk.lstm_layer(xp, lengths, w_hh, b_hh, reverse)
    torch.cuda.synchronize()
    assert (lk.lstm_layer.launches, lk.lstm_layer.cluster.launches) == (
        before[0] + 1, before[1] + 1)
    got = lk.lstm_layer_on("cluster", xp, lengths, w_hh, b_hh, reverse, True)
    tile = lk.lstm_layer_on("tile", xp, lengths, w_hh, b_hh, reverse, True)
    want = lk.lstm_layer_plain(xp, lengths, w_hh, b_hh, reverse, True)
    torch.cuda.synchronize()
    for g, p, r in zip(got, tile, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)
        torch.testing.assert_close(g, p, rtol=0, atol=1e-5)
    for rows in lk.PROJ_CLUSTER_TILES:   # each tile forced: the same sums
        other = lk.lstm_layer_on("cluster", xp, lengths, w_hh, b_hh, reverse,
                                 True, rows=rows)
        for g, o in zip(got, other):
            torch.testing.assert_close(g, o, rtol=0, atol=0)


@pytest.mark.parametrize("h", [1024, 36])
def test_lstm_layer_cluster_refuses_widths_it_does_not_take(cuda, h):
    """H=1024 and H=36 (not a multiple of 8): no resident cluster, the
    per-tile route, and a forced cluster launch raises."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    lib = _build.load("lstm")
    assert all(lib.abcd_lstm_fwd_cluster_max_active(h, rows) == 0
               for rows in lk.PROJ_CLUSTER_TILES)
    assert lib.abcd_lstm_fwd_cluster_max_active(256, 36) > 0
    rng = np.random.default_rng(h)
    lengths = torch.tensor([5, 0, 3, 1, 5, 2], dtype=torch.int32,
                           device=cuda)
    xp = torch.from_numpy(rng.normal(size=(5, 6, 4 * h)).astype(np.float32)
                          ).to(cuda)
    w_hh, b_hh = _uniform(rng, cuda, 1 / 16, h, 4 * h), _uniform(
        rng, cuda, 1 / 16, 4 * h)
    before = lk.lstm_layer.tile.launches
    got = lk.lstm_layer(xp, lengths, w_hh, b_hh)
    want = lk.lstm_layer_plain(xp, lengths, w_hh, b_hh)
    torch.cuda.synchronize()
    assert lk.lstm_layer.tile.launches == before + 1
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    with pytest.raises(RuntimeError, match="launch failed"):
        lk.lstm_layer_on("cluster", xp, lengths, w_hh, b_hh)


def test_lstm_cluster_backward_takes_unaligned_weights(cuda):
    """Weights that are contiguous views at an odd float offset (not 16-byte
    aligned): the gate recompute loads them a float at a time, and the
    gradients still match the twin."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    rng = np.random.default_rng(17)
    x, lengths, *w, outs, cs, douts, dh_n, dc_n = _bwd_args(
        rng, cuda, 23, 19, 129, 256, True)

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    args = (x, lengths, *(unaligned(t) for t in w), outs, cs, douts, dh_n,
            dc_n)
    got = lk.lstm_layer_bidir_fused_bwd_on("cluster", *args)
    want = lk.lstm_layer_bidir_fused_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, g, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"), got,
                          want):
        assert _rel_max_err(g, r) <= 1e-4, name


# ---------------------------------------------------------------------------
# the LSTM backwards' grid design (design "tile": rows 2b and 3b where the
# cluster recurrence does not take H) and row 3b's cluster route, each
# against the twin, the other design and itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_douts", [False, True])
@pytest.mark.parametrize("shape", [(125, 512, 129, 1024), (37, 21, 129, 200),
                                   (17, 70, 33, 1024), (9, 13, 129, 256)])
def test_lstm_grid_backward_matches_twin(cuda, shape, with_douts):
    """Row 2b's grid route at the wide training shape (H=1024), at H=200
    (not a multiple of 32), at a batch past one row tile and forced at
    H=256 (where the rule keeps the cluster route, against which it is
    held too): every gradient against the twin; runs repeat bit for bit;
    the public wrapper launches the route its rule names, once."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    t, b, f, h = shape
    rng = np.random.default_rng(t * b + h + with_douts)
    args = _bwd_args(rng, cuda, t, b, f, h, with_douts)
    design = lk.backward_design_for(_build.load("lstm"), 0, h)
    assert design == ("cluster" if h == 256 else "tile")
    route = getattr(lk.lstm_layer_bidir_fused_bwd, design)
    before = (lk.lstm_layer_bidir_fused_bwd.launches, route.launches)
    picked = lk.lstm_layer_bidir_fused_bwd(*args)
    torch.cuda.synchronize()
    assert (lk.lstm_layer_bidir_fused_bwd.launches, route.launches) == (
        before[0] + 1, before[1] + 1)
    got = lk.lstm_layer_bidir_fused_bwd_on("tile", *args)
    again = lk.lstm_layer_bidir_fused_bwd_on("tile", *args)
    want = lk.lstm_layer_bidir_fused_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, g, a, p, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"),
                                got, again, picked, want):
        assert _rel_max_err(g, r) <= 1e-4, name
        assert _rel_max_err(g, p) <= 1e-4, name
        torch.testing.assert_close(g, a, rtol=0, atol=0)   # runs repeat


def _layer_bwd_args(rng, cuda, t, b, h, reverse, with_douts):
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[:2] = (t, 0)[:b]
    lengths = torch.from_numpy(lens).to(cuda)
    xp = torch.from_numpy(rng.normal(size=(t, b, 4 * h)).astype(np.float32)
                          ).to(cuda)
    w_hh = _uniform(rng, cuda, 1 / np.sqrt(h), h, 4 * h)
    b_hh = _uniform(rng, cuda, 1 / np.sqrt(h), 4 * h)
    outs, _, _, cs = lk.lstm_layer_plain(xp, lengths, w_hh, b_hh, reverse,
                                         True)
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(cuda)
    return (xp, lengths, w_hh, b_hh, outs, cs,
            normal(t, b, h) if with_douts else None, normal(b, h),
            normal(b, h), reverse)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(125, 512, 256), (125, 512, 1024),
                                   (37, 13, 256), (1, 3, 256), (5, 6, 200),
                                   (7, 5, 20)])
def test_lstm_layer_backward_routes_match_twin(cuda, shape, reverse):
    """Row 3b by both designs: the cluster route at H=256 (the
    ``--unidirectional_encoder`` training width; the grid route forced
    beside it) and the grid route at H=1024, H=200 and H=20, both span
    directions, with douts on the reversed ones: (dxp, dW_hh, db_hh)
    against the twin; runs repeat bit for bit; the public wrapper launches
    the route its rule names, once."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    t, b, h = shape
    rng = np.random.default_rng(t + b + h + reverse)
    args = _layer_bwd_args(rng, cuda, t, b, h, reverse, reverse)
    design = lk.backward_design_for(_build.load("lstm"), 0, h)
    assert design == ("cluster" if h == 256 else "tile")
    route = getattr(lk.lstm_layer_bwd, design)
    before = (lk.lstm_layer_bwd.launches, route.launches)
    picked = lk.lstm_layer_bwd(*args)
    torch.cuda.synchronize()
    assert (lk.lstm_layer_bwd.launches, route.launches) == (
        before[0] + 1, before[1] + 1)
    want = lk.lstm_layer_bwd_plain(*args)
    designs = ("cluster", "tile") if h == 256 else ("tile",)
    for d in designs:
        got = lk.lstm_layer_bwd_on(d, *args)
        again = lk.lstm_layer_bwd_on(d, *args)
        torch.cuda.synchronize()
        for name, g, a, r in zip(("dxp", "dw_hh", "db_hh"), got, again, want):
            assert _rel_max_err(g, r) <= 1e-4, (d, name)
            torch.testing.assert_close(g, a, rtol=0, atol=0)
        if d == design:
            for g, p in zip(got, picked):
                torch.testing.assert_close(g, p, rtol=0, atol=0)


def test_lstm_layer_backward_marks_and_refusals(cuda):
    """The timing hook records an event before (a) and after (a), (b) and
    (d), in order; the cluster route refuses H=1024 before any launch."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    rng = np.random.default_rng(3)
    args = _layer_bwd_args(rng, cuda, 9, 11, 256, False, False)
    for design in ("cluster", "tile"):
        marks = []
        lk.lstm_layer_bwd_on(design, *args, marks=marks)
        torch.cuda.synchronize()
        assert len(marks) == 4
        assert all(marks[i].elapsed_time(marks[i + 1]) >= 0
                   for i in range(3))
    wide = _layer_bwd_args(rng, cuda, 5, 6, 1024, False, False)
    with pytest.raises(RuntimeError, match="refused"):
        lk.lstm_layer_bwd_on("cluster", *wide)
