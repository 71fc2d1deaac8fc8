#!/usr/bin/env python3
"""Time the LSTM and STFT kernels of a checkout on one NVIDIA card.

    PYTHONPATH=CHECKOUT python3 chip_ab_lstm.py LABEL

run from the checkout's root (``PYTHONPATH`` names it, because Python
puts this script's own directory on the path).  Builds ``csrc/lstm.cu``,
``csrc/wgrad.cu`` and ``csrc/stft.cu``, then times with CUDA events, three
times each:

- ``lstm_layer_bidir_fused`` forward (row 2) at the served shape (B=64,
  T=512) and the training shape (B=512, T=125), F=129, H=256, held to its
  twin first, beside cuDNN's bidirectional LSTM on a packed sequence
  (``nn.LSTM``, the yardstick the port never calls); where the checkout
  has both designs (``lstm_layer_bidir_fused_on``), each design forced,
  and the card's resident clusters (``abcd_lstm_cluster_max_active``);
- ``log_spectrogram_kernel`` (row 1) at B=64, T=512, fs=32000 and 16000,
  held to its twin, beside ``torch.stft`` + abs + log;
- ``lstm_layer`` forward and backward (one direction over xp) and, where
  the checkout has it, ``lstm_layer_bidir`` forward and backward (both
  directions in one launch, held to its twins first), at B=512, T=125,
  H=256;

all with ragged lengths (row 2 with no empty row, which cuDNN's packed
sequence refuses; the others with one).  Prints one JSON line and
ptxas's register report.  To compare two checkouts, run both in one call
on one card, in turns (A, B, B, A).
"""

import json
import sys
import time

import numpy as np
import torch

from seq2seq_abcd_vae_tpu_torch.ops import _build
from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
from seq2seq_abcd_vae_tpu_torch.ops import stft, stft_kernel

EPSILON, NORMALIZER = 2.0 ** -15, 11.0


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_err(got, want):
    return max((g - r).abs().max().item() for g, r in zip(got, want))


def row2(out, rng, dev, name, b, t, f=129, h=256):
    """Row 2's forward at one shape: error, times, cuDNN's time."""
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[0] = t  # cuDNN's packed sequence takes no empty row
    lengths = torch.from_numpy(lens).to(dev)
    bound = 1 / np.sqrt(h)
    x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32)
                         ).to(dev)
    w = [torch.from_numpy(rng.uniform(-bound, bound, size=s).astype(
        np.float32)).to(dev)
        for s in ((2, f, 4 * h), (2, 4 * h), (2, h, 4 * h), (2, 4 * h))]
    args = (x, lengths, *w)
    want = lk.lstm_layer_bidir_fused_plain(*args)
    out[f"row2_{name}_err"] = max_err(lk.lstm_layer_bidir_fused(*args),
                                      want)
    out[f"row2_{name}_ms"] = [
        cuda_ms(lambda: lk.lstm_layer_bidir_fused(*args), iters=5)
        for _ in range(3)]
    lstm = torch.nn.LSTM(f, h, bidirectional=True).to(dev)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            getattr(lstm, "weight_ih_l0" + sfx).copy_(w[0][d].T)
            getattr(lstm, "bias_ih_l0" + sfx).copy_(w[1][d])
            getattr(lstm, "weight_hh_l0" + sfx).copy_(w[2][d].T)
            getattr(lstm, "bias_hh_l0" + sfx).copy_(w[3][d])

    @torch.no_grad()
    def library():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x, torch.from_numpy(lens), enforce_sorted=False)
        return lstm(packed)[1]

    out[f"row2_{name}_nn_lstm_ms"] = [cuda_ms(library, iters=5)
                                      for _ in range(3)]
    if not hasattr(lk, "lstm_layer_bidir_fused_on"):
        return
    lib = _build.load("lstm")
    for design in ("cluster", "tile"):
        out[f"row2_{name}_{design}_err"] = max_err(
            lk.lstm_layer_bidir_fused_on(design, *args), want)
        out[f"row2_{name}_{design}_ms"] = [
            cuda_ms(lambda: lk.lstm_layer_bidir_fused_on(design, *args),
                    iters=5) for _ in range(3)]
    out[f"row2_{name}_max_active_clusters"] = \
        lib.abcd_lstm_cluster_max_active(f, h)


def row1(out, rng, dev, fs, b=64, t=512):
    """Row 1 at one rate: error (silent rows included), times, the
    library's time."""
    frame = int(0.008 * fs)
    step = frame // 2
    audio = torch.from_numpy(rng.integers(
        -3000, 3000, size=(b, t * step + frame)).astype(np.float32)).to(dev)
    audio[-2:] = 0.0
    cos_b, sin_b = stft.basis_tensors(frame, "hann_window", dev)
    args = (audio, cos_b, sin_b, frame, step, t, EPSILON, NORMALIZER)
    want = stft_kernel.log_spectrogram_plain(*args)
    out[f"row1_fs{fs}_err"] = max_err(
        [stft_kernel.log_spectrogram_kernel(*args)], [want])
    out[f"row1_fs{fs}_ms"] = [
        cuda_ms(lambda: stft_kernel.log_spectrogram_kernel(*args))
        for _ in range(3)]
    used = audio[:, :(t - 1) * step + frame].contiguous()
    window = torch.hann_window(frame, device=dev)

    def library():
        spec = torch.stft(used, frame, step, window=window, center=False,
                          return_complex=True)
        return torch.log(spec.abs() + EPSILON) / NORMALIZER

    out[f"row1_fs{fs}_torch_stft_ms"] = [cuda_ms(library) for _ in range(3)]


def projected(out, rng, dev, b=512, t=125, h=256):
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[0], lens[-1] = t, 0
    lengths = torch.from_numpy(lens).to(dev)
    bound = 1 / np.sqrt(h)

    def uniform(*shape):
        return torch.from_numpy(rng.uniform(-bound, bound, size=shape)
                                .astype(np.float32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    xp, w_hh, b_hh = normal(t, b, 4 * h), uniform(h, 4 * h), uniform(4 * h)
    ref = lk.lstm_layer_plain(xp, lengths, w_hh, b_hh, False, True)
    bwd = (xp, lengths, w_hh, b_hh, ref[0], ref[3], normal(t, b, h),
           normal(b, h), normal(b, h))
    out["lstm_layer_fwd_ms"] = [
        cuda_ms(lambda: lk.lstm_layer(xp, lengths, w_hh, b_hh))
        for _ in range(3)]
    out["lstm_layer_bwd_ms"] = [cuda_ms(lambda: lk.lstm_layer_bwd(*bwd))
                                for _ in range(3)]
    if hasattr(lk, "lstm_layer_bidir"):
        xp2, w2, b2 = normal(t, 2, b, 4 * h), uniform(2, h, 4 * h), \
            uniform(2, 4 * h)
        got = lk.lstm_layer_bidir(xp2, lengths, w2, b2, return_cs=True)
        want = lk.lstm_layer_bidir_plain(xp2, lengths, w2, b2,
                                         return_cs=True)
        out["pair_fwd_err"] = max_err(got, want)
        bwd2 = (xp2, lengths, w2, b2, want[0], want[3], normal(t, 2, b, h),
                normal(2, b, h), normal(2, b, h))
        out["pair_bwd_rel"] = max(
            ((g - r).abs().max() / r.abs().max()).item()
            for g, r in zip(lk.lstm_layer_bidir_bwd(*bwd2),
                            lk.lstm_layer_bidir_bwd_plain(*bwd2)))
        out["pair_fwd_ms"] = [
            cuda_ms(lambda: lk.lstm_layer_bidir(xp2, lengths, w2, b2))
            for _ in range(3)]
        out["pair_bwd_ms"] = [
            cuda_ms(lambda: lk.lstm_layer_bidir_bwd(*bwd2))
            for _ in range(3)]


def main(label: str) -> int:
    if not torch.cuda.is_available():
        print("chip_ab_lstm: no CUDA device", file=sys.stderr)
        return 2
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    report = _build.build(("lstm", "wgrad", "stft"))
    out = {"label": label, "build_s": time.perf_counter() - t0}
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    row2(out, rng, dev, "serve", 64, 512)
    row2(out, rng, dev, "train", 512, 125)
    for fs in (32000, 16000):
        row1(out, rng, dev, fs)
    projected(out, rng, dev)
    print(json.dumps(out))
    for name in ("lstm", "stft"):
        for line in report.get(name, "").splitlines():
            if "registers" in line or "Compiling" in line or "spill" in line:
                print(label, name, line.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "run"))
