"""The FFT route of the STFT kernel (``csrc/stft.cu``,
``log_spectrogram_fft_kernel``), checked on the CPU: a plain PyTorch copy
of the kernel's decomposition (the same twiddle table, radix-4 then
radix-2 Stockham passes with the same index arithmetic, the same
real-split step, the real bins summed directly from the basis), written
here for the tests only, held to the JAX package's ``log_spectrogram``
(``jnp.fft.rfft``) and to its Pallas kernel in interpret mode; and the
wrapper's choice between the FFT and DFT routes and the shape rule of the
LSTM forward's two designs."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.ops import stft as jax_stft
from seq2seq_abcd_vae_tpu.ops import stft_pallas
from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel, stft_kernel
from seq2seq_abcd_vae_tpu_torch.ops import stft as port_stft
from torch_port_fixtures import EPS, NORMALIZER, few_torch_threads_fixture

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)


def _cmul(a, w):
    (ar, ai), (wr, wi) = a, w
    return ar * wr - ai * wi, ar * wi + ai * wr


def fft_route_plain(audio, cos_b, sin_b, frame, step, num_frames, eps,
                    normalizer):
    """The FFT route's arithmetic in PyTorch, frame by frame in parallel:
    window (column 0 of the basis), pack M = N / 2 complex points, Stockham
    passes (radix 4 while two bits are left, then radix 2; pass (R, p),
    butterfly i, k = i mod p: inputs z[i + r M / R] times the table's
    W_N^(2 r k M / (p R)), an R-point DFT, outputs at (i - k) R + k + q p),
    the real split X[k] = (E - i W_N^k O) / 2 for 0 < k < M, the real bins
    (k = 0, M) summed directly from the basis's columns, log(|X| + eps) /
    N."""
    m = frame // 2
    win = cos_b[:, 0]
    frames = audio.unfold(-1, frame, step)[..., :num_frames, :]
    re = frames[..., 0::2] * win[0::2]
    im = frames[..., 1::2] * win[1::2]
    tw = torch.from_numpy(stft_kernel.fft_twiddle_table(frame))
    p, rem = 1, int(math.log2(m))
    while rem > 0:
        radix = 4 if rem >= 2 else 2
        nb = m // radix
        i = torch.arange(nb)
        k = i & (p - 1)
        v = []
        for r in range(radix):
            a = (re[..., i + r * nb], im[..., i + r * nb])
            if r > 0:
                w = tw[r * k * (2 * (m // (p * radix)))]
                a = _cmul(a, (w[:, 0], w[:, 1]))
            v.append(a)
        if radix == 4:
            a = (v[0][0] + v[2][0], v[0][1] + v[2][1])
            b = (v[0][0] - v[2][0], v[0][1] - v[2][1])
            c = (v[1][0] + v[3][0], v[1][1] + v[3][1])
            e = (v[1][0] - v[3][0], v[1][1] - v[3][1])
            ys = [(a[0] + c[0], a[1] + c[1]), (b[0] + e[1], b[1] - e[0]),
                  (a[0] - c[0], a[1] - c[1]), (b[0] - e[1], b[1] + e[0])]
        else:
            ys = [(v[0][0] + v[1][0], v[0][1] + v[1][1]),
                  (v[0][0] - v[1][0], v[0][1] - v[1][1])]
        j = (i - k) * radix + k
        re, im = torch.empty_like(re), torch.empty_like(im)
        for q, (yr, yi) in enumerate(ys):
            re[..., j + q * p] = yr
            im[..., j + q * p] = yi
        p *= radix
        rem -= 2 if radix == 4 else 1
    kk = torch.arange(m + 1)
    ar, ai = re[..., kk % m], im[..., kk % m]
    br, bi = re[..., (m - kk) % m], im[..., (m - kk) % m]
    e = (ar + br, ai - bi)
    o = (ar - br, ai + bi)
    w = tw[kk]
    wo = _cmul(o, (w[:, 0], w[:, 1]))
    xr = 0.5 * (e[0] + wo[1])
    xi = 0.5 * (e[1] - wo[0])
    edges = [0, m]
    xr[..., edges] = torch.matmul(frames, cos_b[:, edges])
    xi[..., edges] = torch.matmul(frames, sin_b[:, edges])
    return torch.log(torch.sqrt(xr * xr + xi * xi) + eps) * (1.0 / normalizer)


def _audio(rng, frame, t_frames, rows=3, scale=100.0):
    n = (t_frames - 1) * (frame // 2) + frame
    audio = (rng.normal(size=(rows, n)) * scale).astype(np.float32)
    audio[-1] = 0.0              # a silent padding row
    audio[-2, n // 2:] = 0.0     # a quiet tail
    return audio


# frame 16 / 64 / 256: M = 8, 32, 128 take a final radix-2 pass; 32 / 128
# (the 16 kHz frame) do not
@pytest.mark.parametrize("frame", [16, 32, 64, 128, 256])
def test_fft_decomposition_matches_jax_rfft(rng, frame):
    t_frames = 9
    audio = _audio(rng, frame, t_frames)
    step = frame // 2
    cos_b, sin_b = port_stft.basis_tensors(frame, "hann_window",
                                           torch.device("cpu"))
    got = fft_route_plain(torch.from_numpy(audio), cos_b, sin_b, frame, step,
                          t_frames, EPS, NORMALIZER)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_stft.log_spectrogram(
            jnp.asarray(audio), frame, step, t_frames, EPS, NORMALIZER,
            method="fft"))
    assert got.shape == want.shape == (3, t_frames, frame // 2 + 1)
    # two float32 FFTs of O(log N) rounding each; the silent row exactly
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[-1].numpy(), want[-1])


@pytest.mark.parametrize("frame", [128, 256])
def test_fft_decomposition_matches_pallas_interpret(rng, frame):
    """What the TPU kernel computes (its window-folded basis, by products),
    at the two frames of the publication's rates (16 and 32 kHz)."""
    t_frames = 7
    audio = _audio(rng, frame, t_frames)
    step = frame // 2
    with jax.default_matmul_precision("highest"):
        want = np.asarray(stft_pallas.log_spectrogram_pallas(
            jnp.asarray(audio), frame, step, t_frames, EPS, NORMALIZER,
            interpret=True))
    cos_b, sin_b = port_stft.basis_tensors(frame, "hann_window",
                                           torch.device("cpu"))
    got = fft_route_plain(torch.from_numpy(audio), cos_b, sin_b, frame, step,
                          t_frames, EPS, NORMALIZER)
    # the DFT by float32 products against the FFT: the products' rounding
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_window_is_column_zero_of_the_basis():
    """The FFT route reads the window from the windowed basis: cos 0 = 1
    leaves it exact, for every window the CLIs name."""
    for name in ("hann_window", "hamming_window", "blackman_window",
                 "bartlett_window", "kaiser_window"):
        cos_b, _ = port_stft.dft_basis(256, port_stft.get_window(name, 256))
        np.testing.assert_array_equal(cos_b[:, 0],
                                      port_stft.get_window(name, 256))


def test_twiddle_table_rounds_float64_once():
    tw = stft_kernel.fft_twiddle_table(256)
    ang = 2.0 * np.pi * np.arange(256) / 256
    assert tw.dtype == np.float32 and tw.shape == (256, 2)
    np.testing.assert_array_equal(tw[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], (-np.sin(ang)).astype(np.float32))


@pytest.mark.parametrize("fs,route", [(16000, True), (32000, True),
                                      (22050, True), (44100, True),
                                      (48000, True), (128000, True),
                                      (11025, True), (24000, True),
                                      (96000, True), (26000, False)])
def test_route_by_frame_length(fs, route):
    """Frames whose half factors over 2, 3, 5, 7 and 11 take the FFT route:
    the publication's 16 and 32 kHz (powers of two), and 176 at 22.05 kHz,
    352 at 44.1 kHz or 384 at 48 kHz (mixed radix); 208 at 26 kHz (half 8
    * 13) the DFT route."""
    frame = int(0.008 * fs)
    assert stft_kernel.fft_route(frame) is route
    assert stft_kernel.supports(frame, frame // 2)


def test_lstm_forward_shape_rule():
    """The cluster design where it fits and its grid runs in few waves of
    resident clusters; else the "proj" design where its pair recurrence
    takes H; the per-tile kernel otherwise."""
    rule = lstm_kernel.forward_design
    rows = lstm_kernel.CLUSTER_ROWS
    pair = dict.fromkeys(lstm_kernel.PROJ_CLUSTER_TILES, 15)
    none = dict.fromkeys(lstm_kernel.PROJ_CLUSTER_TILES, 0)
    assert rule(16, 64, pair) == "cluster"      # 16 clusters, one wave
    assert rule(0, 64, pair) == "proj"          # the slices do not fit
    assert rule(0, 64, none) == "tile"          # nor does the pair's
    most = 16 * lstm_kernel.CLUSTER_MAX_WAVES * rows // 2
    assert rule(16, most, pair) == "cluster"
    assert rule(16, most + 1, pair) == "proj"
    assert rule(16, most + 1, none) == "tile"
    assert rule(1, 1, none) == "cluster"        # a partial tile
