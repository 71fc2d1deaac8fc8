#!/usr/bin/env python3
"""Time the LSTM and STFT kernels of a checkout on one NVIDIA card.

    python3 chip_ab_lstm.py LABEL

with this file copied into the checkout's root and run from there: Python
puts the script's own directory first on the path, so the checkout it
sits in is the one it times.  Builds ``csrc/lstm.cu``,
``csrc/wgrad.cu`` and ``csrc/stft.cu``, then times with CUDA events, three
times each:

- ``lstm_layer_bidir_fused`` forward (row 2) at the served shape (B=64,
  T=512) and the training shape (B=512, T=125), F=129, H=256, and at
  44.1 kHz's F=177 (B=64, T=512), held to its twin first, beside cuDNN's
  bidirectional LSTM on a packed sequence (``nn.LSTM``, the yardstick the
  port never calls); where the checkout has several designs
  (``lstm_layer_bidir_fused_on``), each design that takes the shape
  forced (the "proj" design also by its two parts, where the checkout has
  it), the design the shape rule picked, and the card's resident clusters
  (``abcd_lstm_cluster_max_active``);
- ``log_spectrogram_kernel`` (row 1) at B=64, T=512, fs=32000, 16000 and
  44100, held to its twin, beside ``torch.stft`` + abs + log, with the
  route the frame took;
- ``lstm_layer`` forward and backward (one direction over xp) and, where
  the checkout has it, ``lstm_layer_bidir`` forward and backward (both
  directions in one launch, held to its twins first), at B=512, T=125,
  H=256;
- ``lstm_layer_bidir_fused_bwd`` (row 2b) and ``lstm_layer`` forward (row
  3) at the training shape (B=512, T=125) and the served shape (B=64,
  T=512), held to their twins, beside cuDNN (forward + backward for row
  2b, forward for row 3); where the checkout has both designs
  (``lstm_layer_bidir_fused_bwd_on``, ``lstm_layer_on``), each design
  forced, and row 2b's cluster route split into its four parts;
- the backwards at their wide training path's H=1024 (B=512, T=125, F=129):
  ``lstm_layer_bidir_fused_bwd`` (row 2b) and ``lstm_layer_bwd`` (row 3b),
  by the public wrappers, held to their twins, beside cuDNN's forward +
  backward; where the checkout has ``lstm_layer_bwd_on``, row 3b at H=256
  and H=1024 by each design that takes the shape, split into its parts;

all with ragged lengths (row 2 with no empty row, which cuDNN's packed
sequence refuses; the others with one).  Prints one JSON line (with the
path of the ``lstm_kernel`` module it timed) and ptxas's register report.  To compare two checkouts, run both in one call
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
    designs = [d for d in ("cluster", "proj", "tile")
               if hasattr(lk.lstm_layer_bidir_fused, d)]
    if lib.abcd_lstm_cluster_max_active(f, h) <= 0:
        designs.remove("cluster")
    before = {d: getattr(lk.lstm_layer_bidir_fused, d).launches
              for d in designs}
    lk.lstm_layer_bidir_fused(*args)
    out[f"row2_{name}_rule"] = [d for d in designs if getattr(
        lk.lstm_layer_bidir_fused, d).launches > before[d]]
    for design in designs:
        out[f"row2_{name}_{design}_err"] = max_err(
            lk.lstm_layer_bidir_fused_on(design, *args), want)
        out[f"row2_{name}_{design}_ms"] = [
            cuda_ms(lambda: lk.lstm_layer_bidir_fused_on(design, *args),
                    iters=5) for _ in range(3)]
    if "proj" in designs:
        splits = []
        for _ in range(3):
            marks = []
            lk.lstm_layer_bidir_fused_on("proj", *args, marks=marks)
            torch.cuda.synchronize()
            splits.append([marks[i].elapsed_time(marks[i + 1])
                           for i in range(2)])
        out[f"row2_{name}_proj_split_ms"] = splits
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
    route = getattr(stft_kernel, "route", None)
    out[f"row1_fs{fs}_route"] = (route(frame) if route else "fft" if
                                 stft_kernel.fft_route(frame) else "dft")
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


def _ragged(rng, dev, b, t):
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[0] = t
    return lens, torch.from_numpy(lens).to(dev)


def row2b(out, rng, dev, name, b, t, f=129, h=256):
    """Row 2b (the raw backward) at one shape: error, times, cuDNN's
    forward + backward."""
    lens, lengths = _ragged(rng, dev, b, t)
    bound = 1 / np.sqrt(h)
    x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32)
                         ).to(dev)
    w = [torch.from_numpy(rng.uniform(-bound, bound, size=s).astype(
        np.float32)).to(dev)
        for s in ((2, f, 4 * h), (2, 4 * h), (2, h, 4 * h), (2, 4 * h))]
    outs, _, _, cs = lk.lstm_layer_bidir_fused_plain(x, lengths, *w,
                                                     return_cs=True)
    dh_n, dc_n = (torch.from_numpy(rng.normal(size=(2, b, h)).astype(
        np.float32)).to(dev) for _ in range(2))
    args = (x, lengths, *w, outs, cs, None, dh_n, dc_n)
    want = lk.lstm_layer_bidir_fused_bwd_plain(*args)

    def rel(got):
        return max(((g - r).abs().max() / r.abs().max()).item()
                   for g, r in zip(got, want))

    out[f"row2b_{name}_rel"] = rel(lk.lstm_layer_bidir_fused_bwd(*args))
    out[f"row2b_{name}_ms"] = [
        cuda_ms(lambda: lk.lstm_layer_bidir_fused_bwd(*args), iters=3)
        for _ in range(3)]
    lstm = torch.nn.LSTM(f, h, bidirectional=True).to(dev)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            getattr(lstm, "weight_ih_l0" + sfx).copy_(w[0][d].T)
            getattr(lstm, "bias_ih_l0" + sfx).copy_(w[1][d])
            getattr(lstm, "weight_hh_l0" + sfx).copy_(w[2][d].T)
            getattr(lstm, "bias_hh_l0" + sfx).copy_(w[3][d])
    x_lib = x.clone().requires_grad_(True)

    def library():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x_lib, torch.from_numpy(lens), enforce_sorted=False)
        _, (hh, cc) = lstm(packed)
        torch.autograd.backward((hh, cc), (dh_n, dc_n))

    out[f"row2b_{name}_nn_lstm_ms"] = [cuda_ms(library, iters=3)
                                       for _ in range(3)]
    if not hasattr(lk, "lstm_layer_bidir_fused_bwd_on"):
        return
    for design in ("cluster", "tile"):
        out[f"row2b_{name}_{design}_rel"] = rel(
            lk.lstm_layer_bidir_fused_bwd_on(design, *args))
        out[f"row2b_{name}_{design}_ms"] = [
            cuda_ms(lambda: lk.lstm_layer_bidir_fused_bwd_on(design, *args),
                    iters=3) for _ in range(3)]
    for design in ("cluster", "tile"):
        splits = []
        for _ in range(3):
            marks = []
            lk.lstm_layer_bidir_fused_bwd_on(design, *args, marks=marks)
            torch.cuda.synchronize()
            splits.append([marks[i].elapsed_time(marks[i + 1])
                           for i in range(len(marks) - 1)])
        out[f"row2b_{name}_{design}_split_ms"] = splits


def row3(out, rng, dev, name, b, t, h=256):
    """Row 3 (the one-direction forward over xp) at one shape: error,
    times, cuDNN's forward."""
    lens, lengths = _ragged(rng, dev, b, t)
    bound = 1 / np.sqrt(h)
    xp = torch.from_numpy(rng.normal(size=(t, b, 4 * h)).astype(np.float32)
                          ).to(dev)
    w_hh, b_hh = (torch.from_numpy(rng.uniform(-bound, bound, size=s).astype(
        np.float32)).to(dev) for s in ((h, 4 * h), (4 * h,)))
    want = lk.lstm_layer_plain(xp, lengths, w_hh, b_hh)
    out[f"row3_{name}_err"] = max_err(lk.lstm_layer(xp, lengths, w_hh, b_hh),
                                      want)
    out[f"row3_{name}_ms"] = [
        cuda_ms(lambda: lk.lstm_layer(xp, lengths, w_hh, b_hh), iters=5)
        for _ in range(3)]
    lstm = torch.nn.LSTM(129, h).to(dev)
    with torch.no_grad():
        lstm.weight_hh_l0.copy_(w_hh.T)
        lstm.bias_hh_l0.copy_(b_hh)
    x = torch.from_numpy(rng.normal(size=(t, b, 129)).astype(np.float32)
                         ).to(dev)

    @torch.no_grad()
    def library():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x, torch.from_numpy(lens), enforce_sorted=False)
        return lstm(packed)[1]

    out[f"row3_{name}_nn_lstm_ms"] = [cuda_ms(library, iters=5)
                                      for _ in range(3)]
    if not hasattr(lk, "lstm_layer_on"):
        return
    for design in ("cluster", "tile"):
        out[f"row3_{name}_{design}_err"] = max_err(
            lk.lstm_layer_on(design, xp, lengths, w_hh, b_hh), want)
        out[f"row3_{name}_{design}_ms"] = [
            cuda_ms(lambda: lk.lstm_layer_on(design, xp, lengths, w_hh,
                                             b_hh), iters=5)
            for _ in range(3)]


def wide_bwd(out, rng, dev, t=125, b=512, f=129, h=1024):
    """Rows 2b and 3b at H=1024 (and row 3b's designs at H=256): errors,
    times, cuDNN's forward + backward."""
    lens, lengths = _ragged(rng, dev, b, t)
    bound = 1 / np.sqrt(h)

    def uniform(*shape):
        return torch.from_numpy(rng.uniform(-bound, bound, size=shape)
                                .astype(np.float32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    def rel(got, want):
        return max(((g - r).abs().max() / r.abs().max()).item()
                   for g, r in zip(got, want))

    x = normal(t, b, f)
    w = [uniform(*s) for s in ((2, f, 4 * h), (2, 4 * h), (2, h, 4 * h),
                               (2, 4 * h))]
    outs, _, _, cs = lk.lstm_layer_bidir_fused_plain(x, lengths, *w,
                                                     return_cs=True)
    dh_n, dc_n = normal(2, b, h), normal(2, b, h)
    args = (x, lengths, *w, outs, cs, None, dh_n, dc_n)
    out["row2b_h1024_rel"] = rel(lk.lstm_layer_bidir_fused_bwd(*args),
                                 lk.lstm_layer_bidir_fused_bwd_plain(*args))
    out["row2b_h1024_ms"] = [
        cuda_ms(lambda: lk.lstm_layer_bidir_fused_bwd(*args), iters=1,
                warmup=1) for _ in range(3)]
    lstm = torch.nn.LSTM(f, h, bidirectional=True).to(dev)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            getattr(lstm, "weight_ih_l0" + sfx).copy_(w[0][d].T)
            getattr(lstm, "bias_ih_l0" + sfx).copy_(w[1][d])
            getattr(lstm, "weight_hh_l0" + sfx).copy_(w[2][d].T)
            getattr(lstm, "bias_hh_l0" + sfx).copy_(w[3][d])
    x_lib = x.clone().requires_grad_(True)

    def library():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x_lib, torch.from_numpy(lens), enforce_sorted=False)
        _, (hh, cc) = lstm(packed)
        torch.autograd.backward((hh, cc), (dh_n, dc_n))

    out["row2b_h1024_nn_lstm_ms"] = [cuda_ms(library, iters=3)
                                     for _ in range(3)]
    del args, outs, cs, lstm, x_lib
    for hh in (1024, 256):
        bound = 1 / np.sqrt(hh)
        xp, w_hh, b_hh = normal(t, b, 4 * hh), uniform(hh, 4 * hh), \
            uniform(4 * hh)
        ref = lk.lstm_layer_plain(xp, lengths, w_hh, b_hh, False, True)
        bwd = (xp, lengths, w_hh, b_hh, ref[0], ref[3], None,
               normal(b, hh), normal(b, hh))
        name = f"row3b_h{hh}"
        out[name + "_rel"] = rel(lk.lstm_layer_bwd(*bwd),
                                 lk.lstm_layer_bwd_plain(*bwd))
        out[name + "_ms"] = [cuda_ms(lambda: lk.lstm_layer_bwd(*bwd),
                                     iters=1 if hh == 1024 else 5, warmup=1)
                             for _ in range(3)]
        uni = torch.nn.LSTM(f, hh).to(dev)
        with torch.no_grad():
            uni.weight_hh_l0.copy_(w_hh.T)
            uni.bias_hh_l0.copy_(b_hh)
        keep = torch.from_numpy(lens > 0).to(dev)
        xk = normal(t, b, f)[:, keep].clone().requires_grad_(True)
        dh_lib = normal(1, int(keep.sum()), hh)

        def uni_library():
            packed = torch.nn.utils.rnn.pack_padded_sequence(
                xk, torch.from_numpy(lens[lens > 0]), enforce_sorted=False)
            _, (h_l, c_l) = uni(packed)
            torch.autograd.backward((h_l, c_l), (dh_lib, dh_lib))

        out[name + "_nn_lstm_ms"] = [cuda_ms(uni_library, iters=3)
                                     for _ in range(3)]
        if not hasattr(lk, "lstm_layer_bwd_on"):
            continue
        for design in (("cluster", "tile") if hh == 256 else ("tile",)):
            out[f"{name}_{design}_ms"] = [
                cuda_ms(lambda: lk.lstm_layer_bwd_on(design, *bwd),
                        iters=1 if hh == 1024 else 5, warmup=1)
                for _ in range(3)]
            splits = []
            for _ in range(3):
                marks = []
                lk.lstm_layer_bwd_on(design, *bwd, marks=marks)
                torch.cuda.synchronize()
                splits.append([marks[i].elapsed_time(marks[i + 1])
                               for i in range(3)])
            out[f"{name}_{design}_split_ms"] = splits


def main(label: str) -> int:
    if not torch.cuda.is_available():
        print("chip_ab_lstm: no CUDA device", file=sys.stderr)
        return 2
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    report = _build.build(("lstm", "wgrad", "stft"))
    out = {"label": label, "module": lk.__file__,
           "build_s": time.perf_counter() - t0}
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    row2(out, rng, dev, "serve", 64, 512)
    row2(out, rng, dev, "train", 512, 125)
    row2(out, rng, dev, "serve44k", 64, 512, f=177)
    for fs in (32000, 16000, 44100):
        row1(out, rng, dev, fs)
    projected(out, rng, dev)
    for name, b, t in (("train", 512, 125), ("serve", 64, 512)):
        row2b(out, rng, dev, name, b, t)
        row3(out, rng, dev, name, b, t)
    wide_bwd(out, rng, dev)
    print(json.dumps(out))
    for name in ("lstm", "stft"):
        for line in report.get(name, "").splitlines():
            if "registers" in line or "Compiling" in line or "spill" in line:
                print(label, name, line.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "run"))
