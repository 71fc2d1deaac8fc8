"""Fused log-spectrogram frontend: the CUDA kernels ``csrc/stft.cu`` and
their plain PyTorch twin.

Replaces seq2seq_abcd_vae_tpu/ops/stft_pallas.py:log_spectrogram_pallas.
The kernels compute, for centred audio rows and the windowed DFT basis of
``ops/stft.dft_basis``, ``log(|frames @ (cos - i sin)| + eps) / N`` in one
pass in float32.  Two routes, chosen by ``fft_route`` from the frame
length before the launch: a shared-memory FFT for every even frame from 16
to 1024 whose half factors over 2, 3, 5, 7 and 11, and a direct DFT for
any other.  The FFT route has two instances, counted apart: radix-4/2
passes for a power-of-two frame (``.fft``) and mixed-radix passes for the
others (``.mixed``).  With the 8 ms frame, 11.025 kHz (88), 22.05 (176),
24 (192), 44.1 (352), 48 (384) and 96 kHz (768) take the mixed-radix
passes, 16 (128) and 32 kHz (256, the publication config) the radix-4/2
ones, and 26 kHz (208 = 2 * 8 * 13) or a frame whose half is prime the
DFT route; see the source for the designs.  The wrapper launches a kernel
for CUDA tensors and takes the twin only for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

FFT_MIN_FRAME, FFT_MAX_FRAME = 16, 1024
FFT_RADICES = (4, 2, 3, 5, 7, 11)


def supports(frame_length: int, step_size: int) -> bool:
    """Geometry the kernel takes: frame == 2 * step, as the TPU kernel."""
    return frame_length == 2 * step_size


@functools.lru_cache(maxsize=None)
def fft_radices(points: int):
    """The Stockham passes of a ``points``-point FFT, first pass first
    (csrc/stft.cu:fft_plan): radix 4 while two factors of 2 are left, then
    one radix 2, then radix 3, 5, 7 and 11; None when ``points`` has
    another prime factor."""
    if points < 2:
        return None
    passes = []
    for radix in FFT_RADICES:
        while points % radix == 0 and (radix != 2 or 2 not in passes):
            passes.append(radix)
            points //= radix
    return tuple(passes) if points == 1 else None


def fft_route(frame_length: int) -> bool:
    """Whether the FFT route takes this frame: even, from 16 to 1024, its
    half factoring over 2, 3, 5, 7 and 11 (csrc/stft.cu:fft_frame_ok
    refuses any other); the DFT route takes every other."""
    return (FFT_MIN_FRAME <= frame_length <= FFT_MAX_FRAME
            and frame_length % 2 == 0
            and fft_radices(frame_length // 2) is not None)


def route(frame_length: int) -> str:
    """The kernel that takes this frame: ``"fft"`` (radix-4/2 passes, a
    power-of-two frame), ``"mixed"`` (the FFT route's mixed-radix passes)
    or ``"dft"``."""
    if not fft_route(frame_length):
        return "dft"
    return "fft" if frame_length & (frame_length - 1) == 0 else "mixed"


def fft_twiddle_table(frame_length: int) -> np.ndarray:
    """(N, 2) float32 W_N^j = exp(-2 pi i j / N) as (cos, -sin), j < N:
    computed in float64 and rounded once, as ``ops/stft.dft_basis`` rounds
    the basis.  The FFT route's passes read W_M^a = W_N^(2a) from it and
    its real-split step W_N^k."""
    ang = 2.0 * np.pi * np.arange(frame_length, dtype=np.float64) / (
        frame_length)
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def fft_twiddles(frame_length: int, device: torch.device) -> torch.Tensor:
    """``fft_twiddle_table`` on ``device``, made once per frame length."""
    return torch.from_numpy(fft_twiddle_table(frame_length)).to(device)


def log_spectrogram_plain(audio: torch.Tensor, cos_b: torch.Tensor,
                          sin_b: torch.Tensor, frame_length: int,
                          step_size: int, num_frames: int, epsilon: float,
                          normalizer: float) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: same signature, same result."""
    frames = audio.unfold(-1, frame_length, step_size)[..., :num_frames, :]
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    return torch.log(torch.sqrt(re * re + im * im) + epsilon) * (
        1.0 / normalizer)


def _check(audio, cos_b, sin_b, frame_length, step_size, num_frames):
    if not supports(frame_length, step_size):
        raise ValueError("the STFT kernel requires frame == 2 * step "
                         f"(got frame {frame_length}, step {step_size})")
    bins = frame_length // 2 + 1
    for name, t, shape in (("audio", audio, None),
                           ("cos_b", cos_b, (frame_length, bins)),
                           ("sin_b", sin_b, (frame_length, bins))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != audio.device:
            raise ValueError(f"{name} is on {t.device}, audio on "
                             f"{audio.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if audio.dim() != 2:
        raise ValueError(f"audio must be (B, L), got {tuple(audio.shape)}")
    if num_frames < 1:
        raise ValueError("num_frames must be at least 1")
    need = (num_frames - 1) * step_size + frame_length
    if audio.shape[1] < need:
        raise ValueError(f"audio rows hold {audio.shape[1]} samples; "
                         f"{num_frames} frames need {need}")
    if audio.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {audio.device}")


def log_spectrogram_kernel(audio: torch.Tensor, cos_b: torch.Tensor,
                           sin_b: torch.Tensor, frame_length: int,
                           step_size: int, num_frames: int, epsilon: float,
                           normalizer: float) -> torch.Tensor:
    """(B, L) centred float32 audio -> (B, num_frames, bins) float32.

    CUDA tensors launch the FFT route's kernel when ``fft_route`` takes the
    frame, else the DFT route's, on the current stream (and count one
    launch, on the wrapper and on ``.fft``, ``.mixed`` or ``.dft``, as
    ``route`` names it); CPU tensors take
    ``log_spectrogram_plain``.  The FFT route reads the window from column
    0 of ``cos_b`` (cos 0 = 1) and sums the real bins (DC and Nyquist) from
    the basis's columns 0 and N / 2, as the DFT route does.  The 8 ms
    frame of 16 and 32 kHz takes the radix-4/2 passes; of 11.025, 22.05,
    24, 44.1, 48 and 96 kHz the mixed-radix ones; of 26 kHz the DFT route.
    """
    _check(audio, cos_b, sin_b, frame_length, step_size, num_frames)
    if audio.device.type == "cpu":
        return log_spectrogram_plain(audio, cos_b, sin_b, frame_length,
                                     step_size, num_frames, epsilon,
                                     normalizer)
    batch, row_len = audio.shape
    if batch > 65535:
        raise ValueError(f"the kernel takes at most 65535 rows, got {batch}")
    lib = _build.load("stft")
    bins = cos_b.shape[1]
    out = torch.empty((batch, num_frames, bins), dtype=torch.float32,
                      device=audio.device)
    if batch == 0:
        return out
    kernel = route(frame_length)
    tables = (audio.data_ptr(), row_len, cos_b.data_ptr(), sin_b.data_ptr())
    if kernel != "dft":
        launch = lib.abcd_log_spectrogram_fft
        tables += (fft_twiddles(frame_length, audio.device).data_ptr(),)
    else:
        launch = lib.abcd_log_spectrogram
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(*tables, out.data_ptr(), batch, frame_length, step_size,
                     num_frames, bins, float(epsilon),
                     1.0 / float(normalizer), stream)
    _build.check(lib, err, f"log_spectrogram ({kernel})")
    log_spectrogram_kernel.launches += 1
    getattr(log_spectrogram_kernel, kernel).launches += 1
    return out


log_spectrogram_kernel.launches = 0
log_spectrogram_kernel.fft = _build.Launches()
log_spectrogram_kernel.mixed = _build.Launches()
log_spectrogram_kernel.dft = _build.Launches()
