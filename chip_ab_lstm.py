#!/usr/bin/env python3
"""Time the projected-input LSTM kernels of a checkout on one NVIDIA card.

    PYTHONPATH=CHECKOUT python3 chip_ab_lstm.py LABEL

run from the checkout's root (``PYTHONPATH`` names it, because Python
puts this script's own directory on the path).  Builds ``csrc/lstm.cu``
and ``csrc/wgrad.cu``, then times with CUDA events, three times each,
``lstm_layer`` forward and backward (one direction over xp) and, where
the checkout has it, ``lstm_layer_bidir`` forward and backward (both
directions in one launch, held to its twins first), at B=512, T=125,
H=256 with ragged lengths and one empty row; prints one JSON line and
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


def main(label: str) -> int:
    if not torch.cuda.is_available():
        print("chip_ab_lstm: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    report = _build.build(("lstm", "wgrad"))
    out = {"label": label, "build_s": time.perf_counter() - t0}
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    b, t, h = 512, 125, 256
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
        out["pair_fwd_err"] = max((g - r).abs().max().item()
                                  for g, r in zip(got, want))
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
    print(json.dumps(out))
    for line in report.get("lstm", "").splitlines():
        if "registers" in line or "Compiling" in line or "spill" in line:
            print(label, line.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "run"))
