"""The FFT route's mixed-radix passes (``csrc/stft.cu``,
``log_spectrogram_fft_kernel<true>``), checked on the CPU: a plain PyTorch
copy of the kernel's decomposition (the passes of
``stft_kernel.fft_radices``, radix 4 while two factors of 2 are left, then
2, 3, 5, 7 and 11; the same twiddle table and index arithmetic; an odd
radix's R-point DFT pairing outputs q and R - q; the same real-split step
and the real bins summed directly from the basis), written here for the
tests only, held to the JAX package's ``log_spectrogram`` (``jnp.fft.rfft``)
and to its Pallas kernel in interpret mode; and the frames each route
takes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seq2seq_abcd_vae_tpu.ops import stft as jax_stft
from seq2seq_abcd_vae_tpu.ops import stft_pallas
from seq2seq_abcd_vae_tpu_torch.ops import stft_kernel
from seq2seq_abcd_vae_tpu_torch.ops import stft as port_stft
from torch_port_fixtures import EPS, NORMALIZER, few_torch_threads_fixture

few_torch_threads = pytest.fixture(autouse=True)(few_torch_threads_fixture)


def _cmul(a, w):
    (ar, ai), (wr, wi) = a, w
    return ar * wr - ai * wi, ar * wi + ai * wr


def _butterfly(v, radix, tw, n):
    """The R-point DFT of one pass's inputs ``v`` (R complex pairs), as the
    kernel forms it: radix 4 and 2 by their sums and differences; an odd
    radix by y_q, y_{R-q} = v_0 + sum_r c a_r -/+ i sum_r s b_r, a_r =
    v_r + v_{R-r}, b_r = v_r - v_{R-r}, c and s of 2 pi (r q mod R) / R
    read from the table at W_N^{(r q mod R) N / R}."""
    if radix == 4:
        a = (v[0][0] + v[2][0], v[0][1] + v[2][1])
        b = (v[0][0] - v[2][0], v[0][1] - v[2][1])
        c = (v[1][0] + v[3][0], v[1][1] + v[3][1])
        e = (v[1][0] - v[3][0], v[1][1] - v[3][1])
        return [(a[0] + c[0], a[1] + c[1]), (b[0] + e[1], b[1] - e[0]),
                (a[0] - c[0], a[1] - c[1]), (b[0] - e[1], b[1] + e[0])]
    if radix == 2:
        return [(v[0][0] + v[1][0], v[0][1] + v[1][1]),
                (v[0][0] - v[1][0], v[0][1] - v[1][1])]
    half = (radix - 1) // 2
    cos = [tw[j * (n // radix), 0] for j in range(half + 1)]
    sin = [-tw[j * (n // radix), 1] for j in range(half + 1)]
    a = [None] + [(v[r][0] + v[radix - r][0], v[r][1] + v[radix - r][1])
                  for r in range(1, half + 1)]
    b = [None] + [(v[r][0] - v[radix - r][0], v[r][1] - v[radix - r][1])
                  for r in range(1, half + 1)]
    ys = [None] * radix
    y0 = v[0]
    for r in range(1, half + 1):
        y0 = (y0[0] + a[r][0], y0[1] + a[r][1])
    ys[0] = y0
    for q in range(1, half + 1):
        ac, bs = v[0], (0.0, 0.0)
        for r in range(1, half + 1):
            m = r * q % radix
            c = cos[m] if m <= half else cos[radix - m]
            s = sin[m] if m <= half else -sin[radix - m]
            ac = (ac[0] + c * a[r][0], ac[1] + c * a[r][1])
            bs = (bs[0] + s * b[r][0], bs[1] + s * b[r][1])
        ys[q] = (ac[0] + bs[1], ac[1] - bs[0])
        ys[radix - q] = (ac[0] - bs[1], ac[1] + bs[0])
    return ys


def mixed_route_plain(audio, cos_b, sin_b, frame, step, num_frames, eps,
                      normalizer):
    """The FFT route's arithmetic in PyTorch, frame by frame in parallel:
    window (column 0 of the basis), pack M = N / 2 complex points, the
    Stockham passes of ``fft_radices(M)`` (pass (R, p), butterfly i, k = i
    mod p: inputs z[i + r M / R] times the table's W_N^(r k N / (p R)), an
    R-point DFT, outputs at (i - k) R + k + q p), the real split X[k] =
    (E - i W_N^k O) / 2 for 0 < k < M, the real bins (k = 0, M) summed
    directly from the basis's columns, log(|X| + eps) / N."""
    m = frame // 2
    win = cos_b[:, 0]
    frames = audio.unfold(-1, frame, step)[..., :num_frames, :]
    re = frames[..., 0::2] * win[0::2]
    im = frames[..., 1::2] * win[1::2]
    tw = torch.from_numpy(stft_kernel.fft_twiddle_table(frame))
    p = 1
    for radix in stft_kernel.fft_radices(m):
        nb = m // radix
        i = torch.arange(nb)
        k = i % p
        v = []
        for r in range(radix):
            a = (re[..., i + r * nb], im[..., i + r * nb])
            if r > 0:
                w = tw[r * k * (frame // (p * radix))]
                a = _cmul(a, (w[:, 0], w[:, 1]))
            v.append(a)
        j = (i - k) * radix + k
        re, im = torch.empty_like(re), torch.empty_like(im)
        for q, (yr, yi) in enumerate(_butterfly(v, radix, tw, frame)):
            re[..., j + q * p] = yr
            im[..., j + q * p] = yi
        p *= radix
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


# 88 (11.025 kHz: 4, 11), 176 (22.05 kHz: 4, 2, 11), 352 (44.1 kHz: 4, 4,
# 11), 384 (48 kHz: 4, 4, 4, 3), 160 (4, 4, 5), 112 (4, 2, 7) and 90 (an
# odd half, 45: 3, 3, 5)
@pytest.mark.parametrize("frame", [88, 176, 352, 384, 160, 112, 90])
def test_mixed_radix_decomposition_matches_jax_rfft(rng, frame):
    t_frames = 9
    audio = _audio(rng, frame, t_frames)
    step = frame // 2
    cos_b, sin_b = port_stft.basis_tensors(frame, "hann_window",
                                           torch.device("cpu"))
    got = mixed_route_plain(torch.from_numpy(audio), cos_b, sin_b, frame,
                            step, t_frames, EPS, NORMALIZER)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_stft.log_spectrogram(
            jnp.asarray(audio), frame, step, t_frames, EPS, NORMALIZER,
            method="fft"))
    assert got.shape == want.shape == (3, t_frames, frame // 2 + 1)
    # two float32 FFTs of O(log N) rounding each; the silent row exactly
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[-1].numpy(), want[-1])


def test_mixed_radix_decomposition_matches_pallas_interpret(rng):
    """What the TPU kernel computes (its window-folded basis, by products)
    at 44.1 kHz's 352-sample frame."""
    frame, t_frames = 352, 5
    audio = _audio(rng, frame, t_frames)
    step = frame // 2
    with jax.default_matmul_precision("highest"):
        want = np.asarray(stft_pallas.log_spectrogram_pallas(
            jnp.asarray(audio), frame, step, t_frames, EPS, NORMALIZER,
            interpret=True))
    cos_b, sin_b = port_stft.basis_tensors(frame, "hann_window",
                                           torch.device("cpu"))
    got = mixed_route_plain(torch.from_numpy(audio), cos_b, sin_b, frame,
                            step, t_frames, EPS, NORMALIZER)
    # the DFT by float32 products against the FFT: the products' rounding
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("frame,route,radices", [
    (88, "mixed", (4, 11)), (176, "mixed", (4, 2, 11)),
    (352, "mixed", (4, 4, 11)), (384, "mixed", (4, 4, 4, 3)),
    (160, "mixed", (4, 4, 5)), (112, "mixed", (4, 2, 7)),
    (90, "mixed", (3, 3, 5)), (256, "fft", (4, 4, 4, 2)),
    (16, "fft", (4, 2)), (1024, "fft", (4, 4, 4, 4, 2)),
    (208, "dft", None), (26, "dft", None), (351, "dft", (5, 5, 7)),
    (1056, "dft", (4, 4, 3, 11)), (8, "dft", (4,))])
def test_routes_and_passes_by_frame(frame, route, radices):
    """The route each frame takes and the FFT's passes: 208 (26 kHz, half
    8 * 13), a prime half (26: 13) and an odd frame (351) take the DFT
    route, as does a frame outside 16..1024 whatever its factors."""
    assert stft_kernel.route(frame) == route
    assert stft_kernel.fft_route(frame) is (route != "dft")
    assert stft_kernel.fft_radices(frame // 2) == radices
