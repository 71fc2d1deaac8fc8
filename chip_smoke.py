#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

run from the repository root.  It

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel library from ``seq2seq_abcd_vae_tpu_torch/
   csrc``, one nvcc per source, all started together;
3. makes publication-width weights from ``--seed`` with numpy, in the JAX
   package's layout (bidirectional LSTM encoder, 1 layer, hidden 256; ABCD
   head with K=128, f=256, MLP hidden 256), and writes them as v2
   ``checkpoint.pt`` files with the port's writer;
4. drives the serving path: ``serve_main`` on Unix sockets at ``-b 64``
   with ``--stft_method pallas``, answering requests of varied lengths
   across the buckets at fs=32000 (probs), the fixture's wav spans at
   fs=16000 (logits), a few requests in features mode, a few at fs=44100
   (probs; frame 352, 177 bins: the STFT's FFT route by its mixed-radix
   passes and the LSTM forward's "proj" design, where 32 and 16 kHz take
   the radix-4/2 passes and the raw cluster design) and a few at
   fs=26000 (frame 208: the STFT's DFT route), from concurrent clients;
5. trains: writes a synthetic corpus (1024 segments of 8 classes, 0.10 to
   0.50 s, fs=32000, two speakers, in four wav files) and runs the
   training CLI ``seq2seq_abcd_vae_tpu_torch.cli.learning_main`` at the
   publication config (batch 512, ``--speaker_embed_dim 256``,
   ``--stft_method pallas``) for 2 epochs with 1 of pretraining, then
   again with ``-e 3`` to resume, once with the bidirectional encoder and
   once with ``--unidirectional_encoder``; checks history.log and that
   each kernel ran exactly for the steps that use it (forwards once per
   training and evaluation step, backwards once per training step, the
   other encoder's kernels never; at B=512 the LSTM backward and the
   one-direction forward by their cluster routes); the LSTM model with
   encoder hidden size 1024, bidirectional and unidirectional, one epoch
   each, where the LSTM kernels take their per-tile routes;
6. encodes the corpus with the encode CLI (``cli/encode_main.main``) in
   probs, logits and features modes, as CSV and as npz, from both trained
   checkpoints, on the card and on the CPU's twins: rows = segments x
   width, probabilities summing to 1, the npz values equal to the CSV's
   parsed back bit for bit, card and CPU CSVs equal outside the values and
   the values within tolerance;
7. decodes the validation segments' features generatively with
   ``infer/decode.decode_features`` on the unidirectional checkpoint, in
   sample mode (one ``decoder_loop`` launch) and mean mode, against the
   same calls on the card's twins and on the CPU with the same noise, and
   serves that checkpoint (32 requests, 4 clients; the one-direction LSTM
   forward by its cluster route);
8. trains the GRU model (``-R GRU``: bidirectional GRU encoder, GRU
   decoder) through the same CLI at the same config, 2 epochs then
   resumed to 3, where no LSTM kernel may run; encodes the corpus from
   its checkpoint with the encode CLI (probs and features, CSV, card vs
   CPU) and serves it through ``serve_main`` (probs at fs=32000, frame
   counts up to 512);
9. trains the Elman RNN model (``-R RNN``) and the echo-state model
   (``-R ESN --esn_leak 0.5``) the same way, where only the Elman layer
   and the Elman / ESN decoder kernels run (the ESN's frozen reservoir
   launches no layer backward, and its tensors in the resumed run's
   checkpoint equal the first run's bit for bit); encodes the corpus from
   both checkpoints (probs CSV, card vs CPU) and serves the ESN one;
10. trains the same three cells with ``--unidirectional_encoder`` (``-R
    GRU``, ``-R RNN``, ``-R ESN --esn_leak 0.5``), where only the
    one-direction layer kernels (``gru_layer``, ``rnn_layer``) run for the
    encoder (no layer backward for the ESN, no bidirectional kernel);
    encodes the corpus from the three checkpoints (probs CSV, card vs
    CPU), serves the GRU one, and decodes the validation segments'
    features from the GRU and ESN ones (``gru_decoder_loop``,
    ``rnn_decoder_loop``: one launch in sample mode, none in mean mode;
    card vs twins vs CPU);
11. trains the decoder's stream path through the same CLI (2 epochs, 1 of
    pretraining) with the JAX package's switch in the environment:
    ``SEQ2SEQ_NLL_FUSION=0 -R LSTM``, ``SEQ2SEQ_FUSED_CELLS= -R GRU`` and
    ``SEQ2SEQ_FUSED_CELLS=GRU,RNN -R ESN --esn_leak 0.5``, where the
    cell's sampled loop runs once per step and its backward once per
    training step, and no fused-loss kernel; and runs the LSTM decoder's
    loss-only call without offset targets (``decoder_losses(...,
    with_offset=False)``, the fused-NLL loop forward and backward) on the
    trained checkpoint's validation segments, against the fused-losses
    call on the card and the same call on the CPU's twins; every main
    path (4-11, 13-14) runs with all launch counters set to 0 just before
    and read just after, and every kernel must have run on one;
12. holds each kernel against its plain PyTorch twin on the card at the
    main paths' shapes (ragged lengths, one row of length 0), the Elman
    kernels at leak 1.0 and 0.5, the one-direction layers in both span
    directions, the recurrent kernels also at hidden size 1024 (the LSTM
    encoder's per-tile routes, forward and backward, at their wide
    training paths' B=512, T=125), and one whole training step (each LSTM encoder, the GRU, RNN and ESN models
    with either encoder; the LSTM, GRU and ESN models on the decoder's
    stream path, also against the fused path's step on the card) on the
    kernels (card) against the same step on the twins (CPU): loss, every
    gradient and the parameters after the SGD step;
13. drives this slice's paths: (a) holds the launch-cost probe kernel
    (``csrc/probe.cu``) to its twin, prints the marginal cost of a launch
    and checks that a selector on the card chooses the kernels; (c) trains
    through the CLI with ``SEQ2SEQ_KERNEL_RNG=1 -R LSTM`` (2 epochs, 1 of
    pretraining), where the decoder's fused-loss kernels run in seed mode
    only and the probe twice, with one ``Kernel backend:`` and one ``Kernel
    backend decision:`` line in history.log; (b) runs the JAX package's
    kernel-RNG check on the LSTM, GRU, RNN and ESN checkpoints
    (``decoder_losses`` with a seed equals it fed the seed's dump, and the
    CPU's twins), holds the dump kernel to its twin at the training shape
    (the uniforms' integers exactly, the normals' moments) and each
    fused-loss kernel's seed mode to the same kernel fed the dump and to
    the twins, at hidden 256 and 1024;
14. drives the plain Gaussian VAE through the port's entry points: trains
    it with the training CLI's plain variant (``-f 16``, 2 epochs, then
    resumed to 3; no pretraining, no speaker_coding.json; the LSTM encoder
    and fused-loss decoder kernels only), encodes the corpus in ``params``
    mode (``-p mean,log_variance``; CSV and npz on the card, CSV on the
    CPU's twins: equal outside the values), serves it (``serve_main --mode
    params``, 32 requests from 4 clients) and decodes the validation
    segments' posterior means (sample and mean modes); holds one plain-VAE
    training step on the kernels (card) to the twins (CPU); and reaches
    ``lstm_layer_bidir`` (both directions over xp in one launch, the TPU
    kernel no path calls) by a direct call of its differentiable public
    function, counted, then holds it forward and backward to its twins at
    B=512, T=125, H=256 and at H=1024;
15. times each kernel, its twin and one library call computing the same
    function (a yardstick the port never calls) with CUDA events, and
    prints one ``{"kernels": [...]}`` line (43 entries: each route of the
    STFT, FFT by radix-4/2 or mixed-radix passes and DFT, of the LSTM's
    raw forward (cluster, "proj", per-tile) and backward and of its
    one-direction forward, cluster and per-tile, on its own, with the
    launches the shape gave it; the raw backward's cluster route with its
    time split into the gate recompute, the recurrence, dx and the weight
    gradients, and the raw forward's "proj" design split into the input
    projection and the recurrence, each also printed on a line of its own;
    the per-tile LSTM routes at H=1024 beside cuDNN at that width) with
    launches, times,
    the bound and the largest error, after the serve latencies,
    the time of one served batch (at fs=32000, and at fs=44100 with the
    routes its launches took) and of one training step by stage (the
    stream path's beside the fused path's), the training and encode
    throughputs;
16. ends with ``{"ok": true, "device": {...}}`` as its last line.

Any failed phase raises, so the script exits non-zero and prints no
result.  Without a card it exits 2 before doing anything.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import re
import socket
import subprocess
import sys
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

HIDDEN = 256          # encoder_rnn_hidden_size (publication config)
WIDE_HIDDEN = 1024    # the widest encoder the JAX CLI takes
MLP_HIDDEN = 256      # mlp_hidden_size
K = 128               # num_feature_categories
FEATURE_DIM = 256     # feature_dim
NORMALIZER = 11.0     # -N
EPSILON = 2.0 ** -15
BATCH = 64            # serve -b default
BUCKETS = (16, 32, 64, 96, 128, 192, 256, 384, 512)

# Tolerances, each with its reason:
# - STFT kernel vs twin: the same float32 basis and products, summed in
#   another order (FMA chain vs cuBLAS); differences are a few ulps of the
#   amplitude, which the log maps to well under 1e-3.
STFT_ATOL = 1e-3
# - LSTM kernel vs twin: float32 dot products of F + H terms per gate in
#   another order, carried through up to 512 recurrent steps; |h| <= 1 and
#   the LSTM is contractive at these weights.
LSTM_ATOL = 1e-4
# - encode_step on the card's kernels vs the twins on the CPU: the above,
#   then the head's float32 products (1024 -> 256 -> 256 -> 128) on two
#   different BLAS libraries.
STEP_ATOL = {"probs": 1e-5, "logits": 1e-4, "features": 1e-4}
# - training kernels vs twins, and a training step on the card's kernels vs
#   the twins on the CPU: loss sums of up to B * T * F float32 terms in
#   another order, 1e-5 relative; each gradient to 1e-4 of the leaf's
#   largest magnitude, since a leaf sums the products of every step and
#   row in another order; each parameter after the SGD step to 1e-4 of the
#   leaf's largest update plus 4 float32 ulps of its largest value (the
#   rounding of p + update).
LOSS_RTOL = 1e-5
GRAD_FRACTION = 1e-4
# - decode_features on the card's kernel vs the card's twins and the CPU:
#   float32 products in another order, carried through up to 125 sampled
#   steps whose fed-back sample passes each step's rounding on (emission
#   parameters and samples are O(1)-O(10) in magnitude).
DECODE_ATOL = 1e-3

# the keys of every entry of the kernels line
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}

# training phase: the corpus and the CLI's publication config
TRAIN_FS = 32000
TRAIN_SEGMENTS = 1024
TRAIN_BATCH = 512
SPEAKER_EMBED = 256
PLAIN_FEATURE = 16    # the plain VAE's -f/--feature_size default


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# weights and checkpoints
# ---------------------------------------------------------------------------

def make_checkpoint(save_dir: str, input_size: int, seed: int) -> str:
    """Publication-width random weights in the JAX layout, written with the
    port's v2 writer (torch-like initial ranges)."""
    from seq2seq_abcd_vae_tpu_torch.configs import (ABCDSamplerConfig,
                                                    DecoderConfig,
                                                    EncoderConfig)
    from seq2seq_abcd_vae_tpu_torch.train import checkpoint as ckpt

    rng = np.random.default_rng(seed)

    def uni(fan, *shape):
        b = 1.0 / np.sqrt(fan)
        return rng.uniform(-b, b, size=shape).astype(np.float32)

    enc = EncoderConfig(input_size, HIDDEN)
    lat = ABCDSamplerConfig(enc.hidden_size_total, MLP_HIDDEN, K,
                            FEATURE_DIM)
    dec = DecoderConfig(input_size, HIDDEN, MLP_HIDDEN, FEATURE_DIM)
    g = 4 * HIDDEN
    direction = lambda: {"w_ih": uni(HIDDEN, input_size, g),
                         "w_hh": uni(HIDDEN, HIDDEN, g),
                         "b_ih": uni(HIDDEN, g), "b_hh": uni(HIDDEN, g)}
    din = enc.hidden_size_total
    payload = {
        "epoch": 1,
        "latent_type": "abcd",
        "encoder": {"layers": [{"fwd": direction(), "bwd": direction()}]},
        "encoder_init_parameters": enc.pack_init_parameters(),
        "feature_sampler": {
            "to_code_like": {
                "lin1": {"w": uni(din, din, MLP_HIDDEN),
                         "b": uni(din, MLP_HIDDEN)},
                "lin2": {"w": uni(MLP_HIDDEN, MLP_HIDDEN, FEATURE_DIM),
                         "b": uni(MLP_HIDDEN, FEATURE_DIM)}},
            "posterior_shape_logits": rng.normal(size=K).astype(np.float32),
            "codebook": rng.normal(size=(FEATURE_DIM, K)).astype(np.float32),
        },
        "feature_sampler_init_parameters": lat.pack_init_parameters(),
        "decoder_init_parameters": dec.pack_init_parameters(),
        "gradient_clip": 1.0,
    }
    os.makedirs(save_dir, exist_ok=True)
    return ckpt.save_checkpoint(save_dir, payload)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class Client:
    def __init__(self, path: str):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(path)
        self.rfile = self.sock.makefile("rb")

    def call(self, msg: dict) -> dict:
        self.sock.sendall(json.dumps(msg).encode() + b"\n")
        line = self.rfile.readline()
        if not line:
            raise RuntimeError("server closed the connection")
        return json.loads(line)

    def close(self):
        self.rfile.close()
        self.sock.close()


def run_service(argv: list, socket_path: str, client_fn, timeout=600.0):
    """Start ``serve_main.main(argv)`` in a thread, wait for its socket,
    run ``client_fn(socket_path)``, shut the server down, join it."""
    from seq2seq_abcd_vae_tpu_torch.cli import serve_main

    failure = []

    def target():
        try:
            serve_main.main(argv + ["--socket", socket_path])
        except BaseException as e:  # reported by the main thread
            failure.append(e)

    thread = threading.Thread(target=target, name="serve_main")
    thread.start()
    t0 = time.monotonic()
    while True:
        if failure:
            raise RuntimeError("serve_main failed") from failure[0]
        if os.path.exists(socket_path):
            try:
                Client(socket_path).close()
                break
            except OSError:
                pass
        if time.monotonic() - t0 > timeout:
            raise TimeoutError("serve_main did not open its socket")
        time.sleep(0.05)
    try:
        result = client_fn(socket_path)
        c = Client(socket_path)
        ping = c.call({"cmd": "ping"})
        c.close()
    finally:
        c = Client(socket_path)
        c.call({"cmd": "shutdown"})
        c.close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise RuntimeError("serve_main did not stop")
    if failure:
        raise RuntimeError("serve_main failed") from failure[0]
    return result, ping


def random_requests(rng, fs: int, count: int) -> list:
    """PCM16-valued segments whose frame counts spread over the buckets."""
    step = int(0.004 * fs)
    frames = rng.integers(4, BUCKETS[-1] + 1, size=count)
    reqs = []
    for f in frames:
        n = int((f - 1) * step + rng.integers(0, step))
        n = max(n, int(0.008 * fs) // 2 + 2)
        reqs.append(rng.integers(-3000, 3000, size=n).astype(np.float32))
    return reqs


def concurrent_clients(socket_path: str, reqs: list, fs: int,
                       clients: int = 4):
    """Send ``reqs`` from ``clients`` connections at once; returns the
    responses in request order and each request's latency in ms."""
    out = [None] * len(reqs)
    lat = [None] * len(reqs)
    errors = []

    def worker(w):
        c = Client(socket_path)
        try:
            for i in range(w, len(reqs), clients):
                t0 = time.perf_counter()
                out[i] = c.call({"id": i, "samples": reqs[i].tolist(),
                                 "fs": fs})
                lat[i] = (time.perf_counter() - t0) * 1e3
        except BaseException as e:  # reported below
            errors.append(e)
        finally:
            c.close()

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"client failed: {errors}")
    return out, lat


def check_answers(answers, mode: str, width: int):
    for a in answers:
        if "error" in a:
            raise RuntimeError(f"request {a.get('id')} failed: {a['error']}")
        v = np.asarray(a["values"], np.float64)
        if v.shape != (width,) or not np.all(np.isfinite(v)):
            raise RuntimeError(f"bad {mode} answer shape {v.shape}")
        if mode == "probs" and (abs(v.sum() - 1.0) > 1e-5 or v.min() < 0):
            raise RuntimeError(f"probs sum to {v.sum()}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms_by_kernel(fn, iters: int = 3) -> dict:
    """Device time per call of ``fn`` by CUDA kernel name, from
    ``torch.profiler`` (CUPTI); "not measured: ..." when the profiler
    records no device time on this machine."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0.0)
            if us > 0:
                times[ev.key[:60]] = us / 1000.0 / iters
    except Exception as e:  # a diagnostic: the run goes on without it
        return {"not measured": repr(e)[:200]}
    return times or {"not measured": "no device time recorded"}


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def max_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    return (a.float().cpu() - b.float().cpu()).abs().max().item()


def stft_phase(dev, rng, launches):
    """The STFT's three kernels against the twin: the FFT route's radix-4/2
    passes at fs=32000 and 16000 (B=64 and 512), its mixed-radix passes at
    fs=44100, 48000 and 22050 (frames 352, 384, 176), the DFT route at
    fs=26000 (frame 208, whose half is 8 * 13), silent rows included; each
    rate but 16 kHz timed at the served shape (B=64, T=512) beside the twin
    and torch.stft + abs + log.  ``launches`` maps each route (``fft``,
    ``mixed``, ``dft``) to its main paths' count; each route's entry is
    timed at its first rate."""
    from seq2seq_abcd_vae_tpu_torch.ops import stft, stft_kernel
    checks = {"fft": {}, "mixed": {}, "dft": {}}
    times = {}
    entries = {}
    for fs, b, t in ((32000, BATCH, 512), (16000, BATCH, 512),
                     (32000, 512, 512), (44100, BATCH, 512),
                     (48000, BATCH, 512), (22050, BATCH, 512),
                     (26000, BATCH, 512)):
        frame = int(0.008 * fs)
        step = frame // 2
        route = stft_kernel.route(frame)
        counter = getattr(stft_kernel.log_spectrogram_kernel, route)
        row = t * step + frame
        audio = torch.from_numpy(rng.integers(
            -3000, 3000, size=(b, row)).astype(np.float32)).to(dev)
        audio[-2:] = 0.0  # silent padding rows, as a served batch has
        cos_b, sin_b = stft.basis_tensors(frame, "hann_window", dev)
        args = (audio, cos_b, sin_b, frame, step, t, EPSILON, NORMALIZER)
        before = counter.launches
        got = stft_kernel.log_spectrogram_kernel(*args)
        want = stft_kernel.log_spectrogram_plain(*args)
        torch.cuda.synchronize()
        if counter.launches != before + 1:
            raise AssertionError(f"fs={fs} did not take the {route} route")
        err = max_err(got, want)
        checks[route][f"fs{fs}_B{b}_T{t}"] = err
        if not err <= STFT_ATOL:
            raise AssertionError(f"STFT {route} route vs twin at fs={fs} "
                                 f"B={b} T={t}: {err} > {STFT_ATOL}")
        if b != BATCH or fs == 16000:
            continue
        bins = frame // 2 + 1
        used = audio[:, :(t - 1) * step + frame].contiguous()
        window = torch.hann_window(frame, device=dev)

        def library():
            spec = torch.stft(used, frame, step, window=window,
                              center=False, return_complex=True)
            return torch.log(spec.abs() + EPSILON) / NORMALIZER

        lib_out = library().transpose(1, 2)
        # the least work of the function, whatever the route: per frame the
        # window (frame multiplies) and a real FFT (about 2.5 * frame *
        # log2(frame) operations), then per bin the magnitude (2
        # multiplies, an add, a sqrt) and the log (an add of eps, a log, a
        # multiply by 1/N)
        flops = b * t * (frame + 2.5 * frame * math.log2(frame)
                         + 7.0 * bins)
        nbytes = 4.0 * (b * ((t - 1) * step + frame) + b * t * bins
                        + 2 * frame * bins)
        at = {"route": route,
              "ms": cuda_ms(lambda: stft_kernel.log_spectrogram_kernel(
                  *args)),
              "plain_ms": cuda_ms(lambda: stft_kernel.log_spectrogram_plain(
                  *args)),
              "library_ms": cuda_ms(library),
              "bound": bound_ms(flops, nbytes),
              "library_max_abs_err": max_err(lib_out, want),
              "kernel_vs_library_max_abs_err": max_err(got, lib_out)}
        times[f"fs{fs}"] = at
        if route in entries:
            continue
        entries[route] = {
            "name": f"log_spectrogram_{route}",
            "route": "cuda",
            "source": "seq2seq_abcd_vae_tpu_torch/csrc/stft.cu",
            "replaces": "seq2seq_abcd_vae_tpu/ops/stft_pallas.py:78",
            "launches": launches[route],
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound"][0], "bound_by": at["bound"][1],
            "library_ms": at["library_ms"],
            "library_call": "torch.stft + abs + log",
            "library_max_abs_err": at["library_max_abs_err"],
            "kernel_vs_library_max_abs_err":
                at["kernel_vs_library_max_abs_err"],
            "shape": f"B={b} T={t} frame={frame} bins={bins} (fs={fs})",
            "tolerance": STFT_ATOL}
    for route, entry in entries.items():
        entry["max_abs_err"] = max(checks[route].values())
        entry["checks"] = checks[route]
        entry["ms_by_rate"] = {k: v for k, v in times.items()
                               if v["route"] == route}
    return [entries[r] for r in ("fft", "mixed", "dft")]


def _bidir_inputs(dev, rng, f, b, t, h=HIDDEN):
    x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(
        np.float32)).to(dev)
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    bound = 1.0 / np.sqrt(h)
    w = [torch.from_numpy(rng.uniform(-bound, bound, size=s).astype(
        np.float32)).to(dev)
        for s in ((2, f, 4 * h), (2, 4 * h), (2, h, 4 * h), (2, 4 * h))]
    return (x, torch.from_numpy(lens).to(dev), *w)


def _nn_lstm_module(w_ih, b_ih, w_hh, b_hh):
    """cuDNN's bidirectional LSTM (the yardstick the port never calls)
    holding the layer's weights, given in the port's layout."""
    f, h = w_ih.shape[1], w_hh.shape[1]
    lstm = torch.nn.LSTM(f, h, bidirectional=True).to(w_ih.device)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            getattr(lstm, "weight_ih_l0" + sfx).copy_(w_ih[d].T)
            getattr(lstm, "bias_ih_l0" + sfx).copy_(b_ih[d])
            getattr(lstm, "weight_hh_l0" + sfx).copy_(w_hh[d].T)
            getattr(lstm, "bias_hh_l0" + sfx).copy_(b_hh[d])
    return lstm


def _nn_lstm(args):
    """The yardstick's forward on a packed sequence of the layer's inputs;
    returns its call."""
    x, lengths, *w = args
    lstm = _nn_lstm_module(*w)
    lengths_cpu = lengths.cpu()

    @torch.no_grad()
    def library():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x, lengths_cpu, enforce_sorted=False)
        return lstm(packed)[1]

    return library


LSTM_DESIGNS = ("cluster", "proj", "tile")


def lstm_phase(dev, rng, launches):
    """Row 2's forward, its three designs, against the twin: at the served
    shapes (F=129 and 65 at B=64, T=512, which the shape rule gives the raw
    cluster design; F=177 at fs=44100, which it gives the "proj" design),
    at B=512, T=512, at the training shape (B=512, T=125; F=177 there with
    the saved cell states) and at a second layer's F = 2H = 512; every
    design that takes a shape is held there (the per-tile kernel forced
    everywhere), and each timed beside the twin and cuDNN at the served
    and training shapes, at F=177 and at F=512, the "proj" design also by
    its two parts.  ``launches`` maps each design to its main paths'
    count."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build, lstm_kernel as lk
    h = HIDDEN
    checks = {d: {} for d in LSTM_DESIGNS}
    times = {}
    lib = _build.load("lstm")
    active = lib.abcd_lstm_cluster_max_active(129, h)
    pair_active = {r: lib.abcd_lstm_pair_cluster_max_active(h, r)
                   for r in lk.PROJ_CLUSTER_TILES}
    lib_errs = {}
    timed = ((129, BATCH, 512), (129, 512, 125), (177, BATCH, 512),
             (177, 512, 125), (512, BATCH, 512))
    for f, b, t in ((129, BATCH, 512), (65, BATCH, 512), (129, 512, 512),
                    (129, 512, 125), (177, BATCH, 512), (177, 512, 125),
                    (512, BATCH, 512)):
        args = _bidir_inputs(dev, rng, f, b, t)
        with_cs = (f, b, t) == (177, 512, 125)
        counters = {d: getattr(lk.lstm_layer_bidir_fused, d)
                    for d in LSTM_DESIGNS}
        before = {d: c.launches for d, c in counters.items()}
        got = lk.lstm_layer_bidir_fused(*args, return_cs=with_cs)
        picked = [d for d in LSTM_DESIGNS
                  if counters[d].launches == before[d] + 1]
        want = lk.lstm_layer_bidir_fused_plain(*args, return_cs=with_cs)
        designs = [d for d in LSTM_DESIGNS if d != "cluster"
                   or lib.abcd_lstm_cluster_max_active(f, h) > 0]
        outs = {d: (got if d == picked[0]
                    else lk.lstm_layer_bidir_fused_on(d, *args,
                                                      return_cs=with_cs))
                for d in designs}
        torch.cuda.synchronize()
        shape = f"F{f}_B{b}_T{t}" + ("_cs" if with_cs else "")
        for d, out in outs.items():
            err = max_err(out, want)
            checks[d][shape] = err
            if not err <= LSTM_ATOL:
                raise AssertionError(f"LSTM {d} design vs twin at {shape}: "
                                     f"{err} > {LSTM_ATOL}")
        checks.setdefault("rule", {})[shape] = picked[0]
        if (f, b, t) not in timed:
            continue
        library = _nn_lstm(args)
        lib_h, lib_c = library()
        lib_errs[shape] = max(max_err(lib_h, want[1]),
                              max_err(lib_c, want[2]))
        times[shape] = {d: cuda_ms(lambda: lk.lstm_layer_bidir_fused_on(
            d, *args), iters=5) for d in designs}
        marks = []
        lk.lstm_layer_bidir_fused_on("proj", *args, marks=marks)
        torch.cuda.synchronize()
        times[shape]["proj_split_ms"] = {
            "a_projection": marks[0].elapsed_time(marks[1]),
            "b_recurrence": marks[1].elapsed_time(marks[2])}
        times[shape]["plain"] = cuda_ms(
            lambda: lk.lstm_layer_bidir_fused_plain(*args), iters=2,
            warmup=1)
        times[shape]["library"] = cuda_ms(library, iters=5)
        steps = int(args[1].sum().item())  # active row-steps a direction
        flops = 2 * steps * 2.0 * (f + h) * 4 * h
        nbytes = 4.0 * (t * b * f + 2 * (f + h + 2) * 4 * h
                        + t * 2 * b * h + 2 * 2 * b * h) + 4 * b
        times[shape]["bound"] = bound_ms(flops, nbytes)
        times[shape]["rule"] = picked[0]
    entries = []
    for design, shape in (("cluster", f"F129_B{BATCH}_T512"),
                          ("proj", f"F177_B{BATCH}_T512"),
                          ("tile", f"F177_B{BATCH}_T512")):
        at = times[shape]
        entries.append({
            "name": f"lstm_layer_bidir_fused_{design}",
            "route": "cuda",
            "source": "seq2seq_abcd_vae_tpu_torch/csrc/lstm.cu",
            "replaces": "seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:776",
            "launches": launches[design],
            "max_abs_err": max(checks[design].values()),
            "ms": at[design], "plain_ms": at["plain"],
            "bound_ms": at["bound"][0], "bound_by": at["bound"][1],
            "library_ms": at["library"],
            "library_call": "nn.LSTM(bidirectional) on a packed sequence",
            "library_max_abs_err": lib_errs[shape],
            "shape": shape.replace("_", " "),
            "ms_by_shape": times, "max_active_clusters": active,
            "pair_max_active_clusters": pair_active,
            "tolerance": LSTM_ATOL, "checks": checks,
        })
    entries[1]["ms_by_part"] = times[f"F177_B{BATCH}_T512"]["proj_split_ms"]
    print(f"row 2's \"proj\" design at B={BATCH} T=512 F=177, ms by part "
          + json.dumps(entries[1]["ms_by_part"]), flush=True)
    return entries


def step_phase(dev, ckpt_path, rng, fs=32000,
               modes=("probs", "logits", "features")):
    """encode_step on the kernels (card) vs on the twins (CPU), and where
    the time of one served batch at the largest bucket goes (ms), at the
    checkpoint's rate ``fs``; with the routes that one encode_step's
    launches took."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel, stft_kernel
    from seq2seq_abcd_vae_tpu_torch.data import audio as audio_mod
    from seq2seq_abcd_vae_tpu_torch.data.batching import FrontendSpec
    from seq2seq_abcd_vae_tpu_torch.infer.encode import Encoder, encode_step
    from seq2seq_abcd_vae_tpu_torch.models.abcd import abcd_logits
    from seq2seq_abcd_vae_tpu_torch.models.encoder import encoder_apply
    from seq2seq_abcd_vae_tpu_torch.ops import stft as stft_ops

    bucket = 512
    spec = FrontendSpec(int(0.008 * fs), int(0.004 * fs))
    reqs = random_requests(rng, fs, BATCH - 3)  # 3 padding rows
    audio = np.zeros((BATCH, spec.buffer_len(bucket)), np.float32)
    frames = np.zeros(BATCH, np.int32)
    for i, r in enumerate(reqs):
        audio_mod.center_pad_segment(r, spec.pad, audio[i])
        frames[i] = spec.frames_for_samples(r.shape[0])
    errs = {}
    enc = Encoder(ckpt_path, device="cuda", stft_method="pallas")
    st = enc.statics(spec, EPSILON, NORMALIZER)
    audio_d = torch.from_numpy(audio).to(dev)
    frames_d = torch.from_numpy(frames).to(dev)
    with torch.inference_mode():
        feats = stft_ops.log_spectrogram(audio_d, spec.frame_length,
                                         spec.step_size, bucket, EPSILON,
                                         NORMALIZER, method="pallas")
        hidden = encoder_apply(enc.params["encoder"], st.encoder, feats,
                               frames_d)
        head = enc.params["feature_sampler"]
        breakdown = {
            "frontend": cuda_ms(lambda: stft_ops.log_spectrogram(
                audio_d, spec.frame_length, spec.step_size, bucket, EPSILON,
                NORMALIZER, method="pallas")),
            "encoder": cuda_ms(lambda: encoder_apply(
                enc.params["encoder"], st.encoder, feats, frames_d), 5),
            "head": cuda_ms(lambda: torch.softmax(
                abcd_logits(head, hidden), -1)),
            "encode_step": cuda_ms(lambda: encode_step(
                enc.params, audio_d, frames_d, st, bucket, "probs"), 5),
        }

        def served_batch():  # host batch in, host answers out
            out = encode_step(enc.params, torch.from_numpy(audio).to(dev),
                              torch.from_numpy(frames).to(dev), st, bucket,
                              "probs")
            return out.cpu().numpy()

        served_batch()
        t0 = time.perf_counter()
        for _ in range(5):
            served_batch()
        breakdown["host_batch_wall"] = (time.perf_counter() - t0) / 5 * 1e3
        routes = {f"log_spectrogram_{r}": getattr(
            stft_kernel.log_spectrogram_kernel, r)
            for r in ("fft", "mixed", "dft")}
        routes.update({f"lstm_layer_bidir_fused_{d}": getattr(
            lstm_kernel.lstm_layer_bidir_fused, d) for d in LSTM_DESIGNS})
        before = {k: c.launches for k, c in routes.items()}
        encode_step(enc.params, audio_d, frames_d, st, bucket, "probs")
        torch.cuda.synchronize()
        breakdown["launches_by_route"] = {
            k: c.launches - before[k] for k, c in routes.items()
            if c.launches > before[k]}
    for mode in modes:
        outs = []
        for device in ("cuda", "cpu"):
            enc = Encoder(ckpt_path, device=device, stft_method="pallas")
            st = enc.statics(spec, EPSILON, NORMALIZER)
            out = encode_step(enc.params,
                              torch.from_numpy(audio).to(enc.device),
                              torch.from_numpy(frames).to(enc.device),
                              st, bucket, mode)
            outs.append(out.cpu())
        if not torch.isfinite(outs[0]).all():
            raise AssertionError(f"{mode}: non-finite values on the card")
        errs[mode] = max_err(outs[0], outs[1])
        if not errs[mode] <= STEP_ATOL[mode]:
            raise AssertionError(f"encode_step {mode}: kernels vs twins "
                                 f"{errs[mode]} > {STEP_ATOL[mode]}")
    return errs, breakdown



# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def write_corpus(root: str, seed: int) -> str:
    """1024 segments of 8 classes (harmonic tones with an envelope and
    noise), durations uniform over 0.10-0.50 s, at fs=32000 in four PCM16
    wav files, two speakers; every 8th segment is validation data.
    Returns the annotation CSV's path."""
    import scipy.io.wavfile as spw
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    files = 4
    per_file = TRAIN_SEGMENTS // files
    rows = []
    gap = int(0.05 * TRAIN_FS)
    for fi in range(files):
        parts, pos = [np.zeros(gap, np.float32)], gap
        for j in range(per_file):
            i = fi * per_file + j
            label = int(rng.integers(0, 8))
            n = int(rng.uniform(0.10, 0.50) * TRAIN_FS)
            tt = np.arange(n) / TRAIN_FS
            f0 = 500.0 * (1 + label) * (1.0 + 0.05 * rng.normal())
            tone = sum(np.sin(2 * np.pi * f0 * h * tt) / h
                       for h in (1, 2, 3))
            env = np.sin(np.pi * np.arange(n) / n)
            seg = (6000 * env * tone + 300 * rng.normal(size=n))
            parts += [seg.astype(np.float32), np.zeros(gap, np.float32)]
            rows.append((pos / TRAIN_FS, (pos + n) / TRAIN_FS,
                         f"synth{fi}.wav",
                         "valid" if i % 8 == 7 else "train",
                         f"spk{fi % 2}", f"c{label}"))
            pos += n + gap
        audio = np.clip(np.concatenate(parts), -32768, 32767)
        spw.write(os.path.join(root, f"synth{fi}.wav"), TRAIN_FS,
                  audio.astype(np.int16))
    path = os.path.join(root, "annotation.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["onset", "offset", "input_path", "data_type", "speaker",
                    "label"])
        for on, off, wav, dtype, spk, label in rows:
            w.writerow([f"{on:.6f}", f"{off:.6f}", wav, dtype, spk, label])
    return path


# The two routes of a wrapper with two hand-written kernels, each counted
# on its own (the wrapper's count is their sum).  The shape picks the route,
# so a path's check takes the split as the run made it and holds its sum
# to the wrapper's count (``expected``).
ROUTES = {"log_spectrogram_fft": ("log_spectrogram", "fft"),
          "log_spectrogram_mixed": ("log_spectrogram", "mixed"),
          "log_spectrogram_dft": ("log_spectrogram", "dft"),
          "lstm_layer_bidir_fused_cluster": ("lstm_layer_bidir_fused",
                                             "cluster"),
          "lstm_layer_bidir_fused_proj": ("lstm_layer_bidir_fused", "proj"),
          "lstm_layer_bidir_fused_tile": ("lstm_layer_bidir_fused", "tile"),
          "lstm_layer_bidir_fused_bwd_cluster": (
              "lstm_layer_bidir_fused_bwd", "cluster"),
          "lstm_layer_bidir_fused_bwd_tile": ("lstm_layer_bidir_fused_bwd",
                                              "tile"),
          "lstm_layer_cluster": ("lstm_layer", "cluster"),
          "lstm_layer_tile": ("lstm_layer", "tile"),
          "lstm_layer_bwd_cluster": ("lstm_layer_bwd", "cluster"),
          "lstm_layer_bwd_tile": ("lstm_layer_bwd", "tile")}


def with_routes(counters: dict) -> dict:
    """``counters`` and the route counters of the wrappers among them."""
    for name, (total, route) in ROUTES.items():
        if total in counters:
            counters[name] = getattr(counters[total], route)
    return counters


def training_counters():
    from seq2seq_abcd_vae_tpu_torch.ops import (decoder_kernel, lstm_kernel,
                                                stft_kernel)
    return with_routes({
        "log_spectrogram": stft_kernel.log_spectrogram_kernel,
        "lstm_layer_bidir_fused": lstm_kernel.lstm_layer_bidir_fused,
        "lstm_layer_bidir_fused_bwd": lstm_kernel.lstm_layer_bidir_fused_bwd,
        "decoder_loop_fused_losses_fwd":
            decoder_kernel.decoder_fused_losses_fwd,
        "decoder_loop_fused_losses_bwd":
            decoder_kernel.decoder_fused_losses_bwd})


def ran(launches: dict) -> set:
    """The wrappers that launched (their routes aside)."""
    return {k for k, n in launches.items() if n and k not in ROUTES}


def check_history(path: str, resumed: bool, pretraining: bool = True):
    """history.log's end, resume and (for the ABCD-VAE) pretraining lines,
    finite losses; without ``pretraining`` (the plain VAE) no pretraining
    line at all."""
    with open(path) as f:
        log = f.read()
    for needle in (("END OF PRETRAINING.",) if pretraining else ()) + (
            "END OF TRAINING",) + (
            ("LEARNING RETRIEVED.",
             "To be restarted from the beginning of epoch #: 3")
            if resumed else ()):
        if needle not in log:
            raise AssertionError(f"history.log lacks {needle!r}")
    if not pretraining and "PRETRAINING" in log.upper():
        raise AssertionError("the plain VAE's history.log mentions "
                             "pretraining")
    values = [float(v) for v in re.findall(
        r"(?:mean loss|\(per string\)): (-?[0-9]+\.[0-9]+|-?nan|-?inf)",
        log)]
    if not values or not all(math.isfinite(v) for v in values):
        raise AssertionError("history.log has a non-finite loss")
    return len(values)


def train_phase(dev, work: str, seed: int):
    """The training main path through the CLI, counted, then resumed."""
    from seq2seq_abcd_vae_tpu_torch.cli import learning_main
    corpus_dir = os.path.join(work, "corpus")
    t0 = time.perf_counter()
    csv_path = write_corpus(corpus_dir, seed)
    corpus_s = time.perf_counter() - t0
    argv = [corpus_dir, csv_path, "-S", work, "-j", "train", "-b",
            str(TRAIN_BATCH), "--pretrain_epochs", "1", "--stft_method",
            "pallas", "-d", dev.type, "-N", str(NORMALIZER), "-s", str(seed),
            "--encoder_rnn_hidden_size", str(HIDDEN),
            "--decoder_rnn_hidden_size", str(HIDDEN),
            "--mlp_hidden_size", str(MLP_HIDDEN), "-K", str(K),
            "-f", str(FEATURE_DIM), "--speaker_embed_dim", str(SPEAKER_EMBED)]
    counters = zero_counters()
    t0 = time.perf_counter()
    first = learning_main.main(argv + ["-e", "2"])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    run_dir = os.path.join(work, "train")
    lines = check_history(os.path.join(run_dir, "history.log"), False)
    if not os.path.isfile(os.path.join(run_dir, "checkpoint.pt")):
        raise AssertionError("no checkpoint.pt after training")
    t0 = time.perf_counter()
    second = learning_main.main(argv + ["-e", "3"])
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    check_history(os.path.join(run_dir, "history.log"), True)
    launches = {name: fn.launches for name, fn in counters.items()}
    train_steps = first.steps["train"] + second.steps["train"]
    eval_steps = first.steps["eval"] + second.steps["eval"]
    want = expected(counters,
                    log_spectrogram=train_steps + eval_steps,
                    lstm_layer_bidir_fused=train_steps + eval_steps,
                    lstm_layer_bidir_fused_bwd=train_steps,
                    decoder_loop_fused_losses_fwd=train_steps + eval_steps,
                    decoder_loop_fused_losses_bwd=train_steps)
    print(f"training main path: {train_steps} training + {eval_steps} "
          f"evaluation steps in {first_s:.2f} + {second_s:.2f} s (corpus "
          f"written in {corpus_s:.2f} s); launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if launches["lstm_layer_bidir_fused_bwd_cluster"] != train_steps:
        raise AssertionError("the LSTM backward at B=512 did not take its "
                             f"cluster route every step: {launches}")

    # the trained checkpoint encodes on the card
    from seq2seq_abcd_vae_tpu_torch.data.annotations import AnnotationParser
    from seq2seq_abcd_vae_tpu_torch.data.batching import (DataLoader,
                                                          FrontendSpec)
    from seq2seq_abcd_vae_tpu_torch.infer.encode import Encoder, encode_step
    spec = FrontendSpec(int(0.008 * TRAIN_FS), int(0.004 * TRAIN_FS))
    valid = AnnotationParser(corpus_dir, csv_path).get_data("valid")
    batch = next(iter(DataLoader(valid, spec, batch_size=128)))
    enc = Encoder(os.path.join(run_dir, "checkpoint.pt"), device=dev.type,
                  stft_method="pallas")
    probs = encode_step(enc.params, torch.from_numpy(batch.audio).to(dev),
                        torch.from_numpy(batch.num_frames).to(dev),
                        enc.statics(spec, EPSILON, NORMALIZER),
                        batch.bucket_frames, "probs").cpu()
    if not (torch.isfinite(probs).all()
            and (probs.sum(-1) - 1).abs().max() < 1e-5):
        raise AssertionError("the trained checkpoint's probs do not sum "
                             "to 1")
    epochs = first.epoch_seconds + second.epoch_seconds
    throughput = {"epochs": [{"epoch": e, "train_s": sec,
                              "segments_per_s": n / sec}
                             for e, sec, n in epochs],
                  "history_loss_values": lines}
    later = [n / sec for e, sec, n in epochs[1:]]
    throughput["segments_per_s_after_first_epoch"] = (
        sum(later) / len(later) if later else None)
    return {"launches": launches, "train_steps": train_steps,
            "eval_steps": eval_steps, "corpus_dir": corpus_dir,
            "csv": csv_path, "throughput": throughput}


def largest_batch(corpus_dir: str, csv_path: str):
    """The corpus's longest 511 training segments as one batch of 512 rows
    (the last a padding row of length 0) at the largest bucket."""
    from seq2seq_abcd_vae_tpu_torch.data.annotations import AnnotationParser
    from seq2seq_abcd_vae_tpu_torch.data.batching import (DataLoader,
                                                          FrontendSpec)
    spec = FrontendSpec(int(0.008 * TRAIN_FS), int(0.004 * TRAIN_FS))
    ds = AnnotationParser(corpus_dir, csv_path).get_data("train")
    loader = DataLoader(ds, spec, batch_size=TRAIN_BATCH,
                        pad_to_batch_size=True)
    longest = np.argsort(-ds.lengths_np, kind="stable")[:TRAIN_BATCH - 1]
    return loader.make_batch(longest), spec, ds


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def _ragged(rng, dev, b, t):
    """(numpy, device) lengths: ragged, the first row full, the last empty
    (when there are two)."""
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[0] = t
    if b > 1:
        lens[-1] = 0
    return lens, torch.from_numpy(lens).to(dev)


def _bwd_case(dev, rng, t, b, f, h, with_douts):
    """A raw backward's arguments from the forward twin's saved states (a
    zero-length row included)."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    lens, lengths = _ragged(rng, dev, b, t)
    x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32)
                         ).to(dev)
    w = _lstm_weights(rng, dev, h, (2, f, 4 * h), (2, 4 * h), (2, h, 4 * h),
                      (2, 4 * h))
    outs, _, _, cs = lk.lstm_layer_bidir_fused_plain(x, lengths, *w,
                                                     return_cs=True)
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(dev)
    douts = normal(t, 2, b, h) if with_douts else None
    return lens, (x, lengths, *w, outs, cs, douts, normal(2, b, h),
                  normal(2, b, h))


def _bwd_bound(lens, t, b, f, h):
    """Row 2b's bound: the gates recomputed (its inputs hold no gates),
    dz @ [W_ih | W_hh]^T and the weight gradients, three times the
    forward's products over the active row-steps; each input read and
    each output written once."""
    steps = int(lens.sum())  # active row-steps per direction
    flops = 2 * steps * 3 * 2.0 * (f + h) * 4 * h
    nbytes = 4.0 * (t * b * f + 2 * (f + h + 2) * 4 * h      # x, weights
                    + 2 * t * 2 * b * h + 2 * 2 * b * h       # outs, cs, dh, dc
                    + t * b * f + 2 * (f + h + 2) * 4 * h) + 4 * b  # outputs
    return bound_ms(flops, nbytes)


def lstm_train_phase(dev, rng, t, launches_cluster, launches_tile):
    """Row 2b, the LSTM layer's raw backward, by both routes against the
    twin and against each other: at the training shape (B=512, T=125,
    F=129), at B=13 and 21, at a second layer's F = 2H (which the cluster
    route takes), each with and without douts, ragged with a row of length
    0; the public wrapper takes the route its rule names; H=1024 and H=200
    (not a multiple of 32), forced to the cluster route, raise, and the
    public wrapper takes the grid route (``"tile"``) there, bit for bit
    across calls.  Each route timed beside the twin and cuDNN's forward +
    backward: the cluster route at the training shape, its time split into
    (a) the gate recompute, (b) the recurrence, (c) dx, (d) the weight
    gradients; the grid route at its main path's H=1024 (split the same
    way), and forced at H=256.  Row 2's per-tile forward (saving cs) is
    held to its twin and timed at H=1024 too, and the forward with saved
    cs at the training shape."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    b, f, h = TRAIN_BATCH, 129, HIDDEN
    checks = {"cluster": {}, "tile": {}, "cluster_vs_tile": {}}
    abs_errs = {"cluster": 0.0, "tile": 0.0}
    rel = {}
    lib = _build.load("lstm")
    active = lib.abcd_lstm_bwd_cluster_max_active(h, lk.BWD_CLUSTER_ROWS)
    timed = None
    for tt, bb, ff in ((t, b, f), (t, 13, f), (t, 21, f), (37, 21, 2 * h)):
        for with_douts in (False, True):
            lens, args = _bwd_case(dev, rng, tt, bb, ff, h, with_douts)
            design = lk.backward_design(active)
            route = getattr(lk.lstm_layer_bidir_fused_bwd, design)
            before = route.launches
            picked = lk.lstm_layer_bidir_fused_bwd(*args)
            if route.launches != before + 1:
                raise AssertionError(f"row 2b at B={bb} did not take the "
                                     f"{design} route")
            want = lk.lstm_layer_bidir_fused_bwd_plain(*args)
            got = {d: lk.lstm_layer_bidir_fused_bwd_on(d, *args)
                   for d in ("cluster", "tile")}
            torch.cuda.synchronize()
            shape = f"T{tt}_B{bb}_F{ff}_douts{int(with_douts)}"
            for d, out in got.items():
                errs = {n: rel_err(g, r) for n, g, r in zip(
                    ("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"), out, want)}
                checks[d][shape] = max(errs.values())
                abs_errs[d] = max(abs_errs[d], max_err(out, want))
                if d == design:
                    rel[shape] = errs
                    if max_err(picked, out) != 0.0:
                        raise AssertionError(f"row 2b {d} route differs "
                                             f"between calls at {shape}")
                if max(errs.values()) > GRAD_FRACTION:
                    raise AssertionError(f"row 2b {d} route vs twin at "
                                         f"{shape}: {errs}")
            across = max(rel_err(g, r) for g, r in zip(got["cluster"],
                                                       got["tile"]))
            checks["cluster_vs_tile"][shape] = across
            if across > GRAD_FRACTION:
                raise AssertionError(f"row 2b cluster vs per-tile at {shape}:"
                                     f" {across}")
            if (tt, bb, ff, with_douts) == (t, b, f, False):
                timed = (lens, args)
    refused = {}
    for hh in (WIDE_HIDDEN, 200):
        _, args = _bwd_case(dev, rng, 5, 6, 9, hh, False)
        try:
            lk.lstm_layer_bidir_fused_bwd_on("cluster", *args)
            torch.cuda.synchronize()
        except RuntimeError as e:
            refused[f"H{hh}"] = str(e)[:100]
        else:
            raise AssertionError(f"row 2b's cluster route took H={hh}")
    # the grid route where the rule gives it: H=200 (correctness only)
    for with_douts in (False, True):
        _, args = _bwd_case(dev, rng, 37, 21, f, 200, with_douts)
        before = lk.lstm_layer_bidir_fused_bwd.tile.launches
        got = lk.lstm_layer_bidir_fused_bwd(*args)
        if lk.lstm_layer_bidir_fused_bwd.tile.launches != before + 1:
            raise AssertionError("row 2b at H=200 did not take the grid "
                                 "route")
        want = lk.lstm_layer_bidir_fused_bwd_plain(*args)
        torch.cuda.synchronize()
        shape = f"T37_B21_F{f}_H200_douts{int(with_douts)}"
        checks["tile"][shape] = max(rel_err(g, r) for g, r in zip(got, want))
        abs_errs["tile"] = max(abs_errs["tile"], max_err(got, want))
        if checks["tile"][shape] > GRAD_FRACTION:
            raise AssertionError(f"row 2b grid route vs twin at {shape}: "
                                 f"{checks['tile'][shape]}")
    lens, args = timed
    times = {d: cuda_ms(lambda: lk.lstm_layer_bidir_fused_bwd_on(d, *args),
                        iters=5) for d in ("cluster", "tile")}
    split = []
    for _ in range(3):
        marks = []
        lk.lstm_layer_bidir_fused_bwd_on("cluster", *args, marks=marks)
        torch.cuda.synchronize()
        split.append([marks[i].elapsed_time(marks[i + 1]) for i in range(4)])
    split_ms = dict(zip(("a_gates", "b_recurrence", "c_dx", "d_wgrad"),
                        np.median(np.asarray(split), axis=0).tolist()))
    print("row 2b cluster route at the training shape, ms by part "
          + json.dumps(split_ms), flush=True)
    plain_ms = cuda_ms(lambda: lk.lstm_layer_bidir_fused_bwd_plain(*args),
                       iters=2, warmup=1)
    x, lengths, *w = args[:6]
    fwd = lk.lstm_layer_bidir_fused(x, lengths, *w, return_cs=True)
    fwd_ref = lk.lstm_layer_bidir_fused_plain(x, lengths, *w,
                                              return_cs=True)
    fwd_err = max_err(fwd, fwd_ref)
    if not fwd_err <= LSTM_ATOL:
        raise AssertionError(f"LSTM forward (with cs) vs twin: {fwd_err}")
    fwd_ms = cuda_ms(lambda: lk.lstm_layer_bidir_fused(x, lengths, *w,
                                                       return_cs=True),
                     iters=5)
    # the yardstick: cuDNN's bidirectional LSTM, forward and backward, on
    # packed sequences of the same shape (the zero-length row dropped)
    dh_n, dc_n = args[-2], args[-1]
    lstm = _nn_lstm_module(*w)
    keep = lens > 0
    x_lib = x[:, torch.from_numpy(keep).to(dev)].clone().requires_grad_(True)
    lens_lib = torch.from_numpy(lens[keep].astype(np.int64))

    def library():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x_lib, lens_lib, enforce_sorted=False)
        _, (hh, cc) = lstm(packed)
        torch.autograd.backward((hh, cc), (dh_n[:, keep.nonzero()[0]],
                                           dc_n[:, keep.nonzero()[0]]))

    library_ms = cuda_ms(library, iters=5)
    bms, by = _bwd_bound(lens, t, b, f, h)
    # the per-tile routes at their main path's width (the wide training
    # path): row 2's forward, saving cs, and row 2b
    wlens, wargs = _bwd_case(dev, rng, t, b, f, WIDE_HIDDEN, False)
    wx, wlengths, *ww = wargs[:6]
    wouts, wcs = wargs[6], wargs[7]
    before = lk.lstm_layer_bidir_fused.tile.launches
    wide_fwd = lk.lstm_layer_bidir_fused(wx, wlengths, *ww, return_cs=True)
    torch.cuda.synchronize()
    if lk.lstm_layer_bidir_fused.tile.launches != before + 1:
        raise AssertionError(f"row 2 at H={WIDE_HIDDEN} did not take the "
                             "per-tile route")
    # the twin's outs hold the carry after each step: h_n, c_n are the last
    wide_fwd_err = max_err(wide_fwd, (wouts, wouts[-1], wcs[-1], wcs))
    if not wide_fwd_err <= LSTM_ATOL:
        raise AssertionError(f"row 2 per-tile route at H={WIDE_HIDDEN}: "
                             f"{wide_fwd_err}")
    wide_fwd_ms = cuda_ms(lambda: lk.lstm_layer_bidir_fused(
        wx, wlengths, *ww, return_cs=True), iters=2, warmup=1)
    steps = int(wlens.sum())  # active row-steps a direction
    hh = WIDE_HIDDEN
    wide_fwd_bound = bound_ms(
        2 * steps * 2.0 * (f + hh) * 4 * hh,
        4.0 * (t * b * f + 2 * (f + hh + 2) * 4 * hh      # x, weights
               + 2 * t * 2 * b * hh + 2 * 2 * b * hh) + 4 * b)  # outs, cs
    _, dargs = _bwd_case(dev, rng, t, b, f, WIDE_HIDDEN, True)
    for with_douts, cargs in ((False, wargs), (True, dargs)):
        before = lk.lstm_layer_bidir_fused_bwd.tile.launches
        wide_got = lk.lstm_layer_bidir_fused_bwd(*cargs)
        if lk.lstm_layer_bidir_fused_bwd.tile.launches != before + 1:
            raise AssertionError(f"row 2b at H={WIDE_HIDDEN} did not take "
                                 "the grid route")
        again = lk.lstm_layer_bidir_fused_bwd(*cargs)
        wide_want = lk.lstm_layer_bidir_fused_bwd_plain(*cargs)
        torch.cuda.synchronize()
        if max_err(wide_got, again) != 0.0:
            raise AssertionError(f"row 2b grid route differs between calls "
                                 f"at H={WIDE_HIDDEN}")
        wide_rel = max(rel_err(g, r) for g, r in zip(wide_got, wide_want))
        shape = f"T{t}_B{b}_F{f}_H{WIDE_HIDDEN}_douts{int(with_douts)}"
        checks["tile"][shape] = wide_rel
        abs_errs["tile"] = max(abs_errs["tile"], max_err(wide_got, wide_want))
        if wide_rel > GRAD_FRACTION:
            raise AssertionError(f"row 2b grid route at H={WIDE_HIDDEN}: "
                                 f"{wide_rel}")
    del dargs, again
    wide_ms = cuda_ms(lambda: lk.lstm_layer_bidir_fused_bwd(*wargs), iters=3,
                      warmup=1)
    wide_plain_ms = cuda_ms(
        lambda: lk.lstm_layer_bidir_fused_bwd_plain(*wargs), iters=1,
        warmup=0)
    split = []
    for _ in range(3):
        marks = []
        lk.lstm_layer_bidir_fused_bwd_on("tile", *wargs, marks=marks)
        torch.cuda.synchronize()
        split.append([marks[i].elapsed_time(marks[i + 1]) for i in range(4)])
    wide_split = dict(zip(("a_gates", "b_recurrence", "c_dx", "d_wgrad"),
                          np.median(np.asarray(split), axis=0).tolist()))
    print(f"row 2b grid route at H={WIDE_HIDDEN}, ms by part "
          + json.dumps(wide_split), flush=True)
    # cuDNN at the same width (the yardstick the per-tile routes' ranking
    # reads): forward, and forward + backward, packed, the empty row dropped
    wlstm = _nn_lstm_module(*ww)
    wkeep = torch.from_numpy(wlens > 0).to(dev)
    wx_lib = wx[:, wkeep].clone().requires_grad_(True)
    wlens_lib = torch.from_numpy(wlens[wlens > 0].astype(np.int64))
    wdh = torch.from_numpy(rng.normal(size=(2, len(wlens_lib), hh)).astype(
        np.float32)).to(dev)

    def wide_library(backward):
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            wx_lib, wlens_lib, enforce_sorted=False)
        if not backward:
            with torch.no_grad():
                return wlstm(packed)[1]
        _, (h_l, c_l) = wlstm(packed)
        torch.autograd.backward((h_l, c_l), (wdh, wdh))

    wide_lib_fwd_ms = cuda_ms(lambda: wide_library(False), iters=2, warmup=1)
    wide_lib_ms = cuda_ms(lambda: wide_library(True), iters=2, warmup=1)
    common = {
        "route": "cuda",
        "source": "seq2seq_abcd_vae_tpu_torch/csrc/lstm.cu",
        "helper_source": "seq2seq_abcd_vae_tpu_torch/csrc/wgrad.cu",
        "replaces": "seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:682",
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": library_ms,
        "library_call": "nn.LSTM(bidirectional) forward + backward, packed",
        "shape": f"T={t} B={b} F={f} H={h} (douts zero)",
        "tolerance": f"{GRAD_FRACTION} of each leaf's max |value|",
        "checks": checks, "refused_by_the_cluster_route": refused,
        "max_active_clusters": active}
    entries = [
        dict(common, name="lstm_layer_bidir_fused_bwd_cluster",
             launches=launches_cluster, max_abs_err=abs_errs["cluster"],
             max_rel_err=max(checks["cluster"].values()),
             rel_errs_by_leaf=rel, ms=times["cluster"], split_ms=split_ms),
        dict(common, name="lstm_layer_bidir_fused_bwd_tile",
             launches=launches_tile, max_abs_err=abs_errs["tile"],
             max_rel_err=max(checks["tile"].values()), ms=wide_ms,
             plain_ms=wide_plain_ms,
             bound_ms=_bwd_bound(wlens, t, b, f, WIDE_HIDDEN)[0],
             bound_by=_bwd_bound(wlens, t, b, f, WIDE_HIDDEN)[1],
             library_ms=wide_lib_ms,
             shape=f"T={t} B={b} F={f} H={WIDE_HIDDEN} (douts zero)",
             split_ms=wide_split, ms_forced_at_training_shape=times["tile"])]
    wide_forward = {"main_path_shape": f"T={t} B={b} F={f} H={hh} "
                                       "(return_cs)",
                    "main_path_shape_ms": wide_fwd_ms,
                    "main_path_shape_bound_ms": wide_fwd_bound[0],
                    "main_path_shape_library_ms": wide_lib_fwd_ms,
                    "main_path_shape_max_abs_err": wide_fwd_err}
    return entries, {"forward_with_cs_ms": fwd_ms,
                     "forward_with_cs_err": fwd_err,
                     "per_tile_forward_at_h1024": wide_forward}


def _decoder_kernel_args(dev, rng, t, b, h=HIDDEN, cell="LSTM", leak=1.0):
    """The fused-loss decoder's arguments (the LSTM's; the GRU loop's: b_ih
    and b_hh apart, no c0; the Elman / ESN loop's: one bias, zero below
    leak 1, no c0) and the rows' lengths."""
    m, f = MLP_HIDDEN, 129
    gh = {"LSTM": 4, "GRU": 3, "RNN": 1}[cell] * h
    lens = rng.integers(1, t + 1, size=b)
    lens[0], lens[-1] = t, 0

    def uni(bound, *shape):
        return torch.from_numpy(rng.uniform(-bound, bound, size=shape)
                                .astype(np.float32)).to(dev)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32)).to(dev)

    # drawn in argument order (the LSTM's as in earlier runs)
    args = [normal(t, b, f), torch.from_numpy(lens.astype(np.int32)).to(dev),
            uni(1 / np.sqrt(h), h, gh + 2 * m)]
    if cell == "GRU":
        args += [uni(1 / np.sqrt(h), gh), uni(1 / np.sqrt(h), gh)]
    else:
        args.append(uni(2 / np.sqrt(h), gh) if leak == 1.0
                    else torch.zeros(gh, device=dev))
    args += [uni(1 / np.sqrt(h), 2 * m), uni(1 / np.sqrt(m), m, f),
             uni(1 / np.sqrt(m), m, f), uni(1 / np.sqrt(m), 2 * f),
             uni(1 / np.sqrt(h), f, gh), normal(t, b, f),
             uni(1 / np.sqrt(h), h, m), uni(1 / np.sqrt(h), m),
             uni(1 / np.sqrt(m), m), uni(1 / np.sqrt(m), 1)]
    args += [normal(b, h, scale=0.5)
             for _ in range(2 if cell == "LSTM" else 1)]
    return args, lens


def _decoder_pair(cell, leak=1.0):
    """The fused-loss decoder's (forward, twin, backward, twin) for
    ``cell``; the Elman / ESN loop's with ``leak`` bound."""
    import functools
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    prefix = {"LSTM": "", "GRU": "gru_", "RNN": "rnn_"}[cell]
    fns = [getattr(dk, f"{prefix}decoder_fused_losses_{part}")
           for part in ("fwd", "fwd_plain", "bwd", "bwd_plain")]
    if cell == "RNN":
        fns = [functools.partial(fn, leak=leak) for fn in fns]
    return fns


def _decoder_check(dev, rng, t, b, cell, leak=1.0, h=HIDDEN):
    """One fused-loss decoder's kernels against their twins: (args, the
    twin's forward, the backward's args, the kernels' and the twins'
    gradients, the errors); raises past the tolerances or when the
    forward's losses do not repeat bit for bit."""
    fwd, fwd_plain, bwd, bwd_plain = _decoder_pair(cell, leak)
    args, lens = _decoder_kernel_args(dev, rng, t, b, h=h, cell=cell,
                                      leak=leak)
    n_state = 2 if cell == "LSTM" else 1   # h (and the LSTM's c)
    got = fwd(*args)
    want = fwd_plain(*args)
    torch.cuda.synchronize()
    loss_err = max(abs(g.item() - r.item()) / abs(r.item())
                   for g, r in zip(got[1:3], want[1:3]))
    states = (0,) + tuple(range(3, 3 + n_state))
    state_err = max_err(tuple(got[i] for i in states),
                        tuple(want[i] for i in states))
    if not (loss_err <= LOSS_RTOL and state_err <= LSTM_ATOL):
        raise AssertionError(f"{cell} decoder forward (leak {leak}) vs "
                             f"twin: losses {loss_err}, states {state_err}")
    repeat = fwd(*args)
    if (repeat[1].item(), repeat[2].item()) != (got[1].item(),
                                                got[2].item()):
        raise AssertionError("decoder forward losses differ between runs")
    dlast = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)
                             ).to(dev)
    gscale = torch.tensor([1.0 / 511, 1.0 / 511], device=dev)
    bwd_args = (*args, *want[3:3 + n_state], dlast, gscale)
    g_all = bwd(*bwd_args)
    r_all = bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    names = (("dw_cat", "db_ih", "db_hh") if cell == "GRU"
             else ("dw_cat", "dbias")) + (
        "db1", "dw2m", "dw2v", "db2", "dw_ih", "dwo1", "dbo1", "dwo2",
        "dbo2") + (("dh0", "dc0") if cell == "LSTM" else ("dh0",))
    errs = {n: rel_err(g, r) for n, g, r in zip(names, g_all, r_all)}
    if max(errs.values()) > GRAD_FRACTION:
        raise AssertionError(f"{cell} decoder backward (leak {leak}) vs "
                             f"twin: {errs}")
    return (args, lens, got, want, loss_err, state_err, bwd_args, g_all,
            r_all, errs)


def decoder_train_phase(dev, rng, t, launches_fwd, launches_bwd,
                        cell="LSTM"):
    """The fused-loss decoder kernels of ``cell`` (LSTM, GRU, or the Elman
    loop, also checked at the ESN's leak 0.5) vs twins at the training
    shape, with their times and bounds (no single library call computes
    this loop: the sample it feeds back depends on the step before)."""
    b, h, m, f = TRAIN_BATCH, HIDDEN, MLP_HIDDEN, 129
    fwd, fwd_plain, bwd, bwd_plain = _decoder_pair(cell)
    (args, lens, got, want, loss_err, state_err, bwd_args, g_all, r_all,
     errs) = _decoder_check(dev, rng, t, b, cell)
    n_state = 2 if cell == "LSTM" else 1
    extra = {}
    if cell == "RNN":
        esn = _decoder_check(dev, rng, t, b, cell, leak=0.5)
        extra["esn_leak_0.5"] = {"loss_rel_err": esn[4],
                                 "states_max_abs_err": esn[5],
                                 "grad_max_rel_err": max(esn[9].values())}
    fwd_ms = cuda_ms(lambda: fwd(*args), iters=5)
    fwd_plain_ms = cuda_ms(lambda: fwd_plain(*args), iters=2, warmup=1)
    bwd_ms = cuda_ms(lambda: bwd(*bwd_args), iters=3)
    bwd_plain_ms = cuda_ms(lambda: bwd_plain(*bwd_args), iters=2, warmup=1)
    # per row-step: h @ w_cat, the emission's second layer (mean and
    # logvar), the fed-back x @ w_ih and the offset MLP's first layer
    gh = {"LSTM": 4, "GRU": 3, "RNN": 1}[cell] * h
    per = 2.0 * (h * (gh + 2 * m) + 2 * m * f + f * gh + h * m)
    steps = int(lens.sum())  # row-steps the losses depend on
    weights = (h * (gh + 2 * m) + (2 if cell == "GRU" else 1) * gh + 2 * m
               + 2 * m * f + 2 * f + f * gh + h * m + 2 * m + 1)
    fwd_bytes = 4.0 * (2 * t * b * f + weights + n_state * b * h  # inputs
                       + b * h + 2 + n_state * t * b * h) + 4 * b  # outputs
    bwd_bytes = 4.0 * (2 * t * b * f + weights + n_state * b * h
                       + n_state * t * b * h + b * h + 2 + weights
                       + n_state * b * h) + 4 * b
    f_bms, f_by = bound_ms(steps * per, fwd_bytes)
    # recompute plus the adjoint products and the weight gradients
    b_bms, b_by = bound_ms(3 * steps * per, bwd_bytes)
    prefix = {"LSTM": "", "GRU": "gru_", "RNN": "rnn_"}[cell]
    lines = {"LSTM": (1983, 2042), "GRU": (898, 937),
             "RNN": (1503, 1543)}[cell]
    common = {"route": "cuda",
              "source": "seq2seq_abcd_vae_tpu_torch/csrc/decoder.cu",
              "library_ms": None,
              "library_call": "none: no single PyTorch call runs this loop",
              "shape": f"T={t} B={b} F={f} H={h} m={m} Mo={m}"}
    fwd_entry = dict(common, **{
        "name": prefix + "decoder_loop_fused_losses",
        "replaces": f"seq2seq_abcd_vae_tpu/ops/decoder_pallas.py:{lines[0]}",
        "launches": launches_fwd,
        "max_abs_err": max(state_err, max(abs(g.item() - r.item()) for g, r
                                          in zip(got[1:3], want[1:3]))),
        "loss_rel_err": loss_err, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
        "bound_ms": f_bms, "bound_by": f_by,
        "tolerance": f"losses {LOSS_RTOL} relative, states {LSTM_ATOL}"})
    bwd_entry = dict(common, **{
        "name": prefix + "decoder_loop_fused_losses_bwd",
        "helper_source": "seq2seq_abcd_vae_tpu_torch/csrc/wgrad.cu",
        "replaces": f"seq2seq_abcd_vae_tpu/ops/decoder_pallas.py:{lines[1]}",
        "launches": launches_bwd,
        "max_abs_err": max(max_err(g, r) for g, r in zip(g_all, r_all)),
        "max_rel_err": max(errs.values()), "rel_errs": errs,
        "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": b_bms,
        "bound_by": b_by,
        "tolerance": f"{GRAD_FRACTION} of each leaf's max |value|"})
    if extra:
        fwd_entry["checks"] = bwd_entry["checks"] = extra
    return fwd_entry, bwd_entry


def step_on(device, params0, cfg, batch, spec, noise, n_data,
            fused_cells=None):
    """One training step (loss, gradients, SGD with clip 1.0, lr 1.0) on
    ``device`` from copies of ``params0``, the decoder on the fused-loss
    kernels unless ``fused_cells`` leaves its cell out; the gradients of
    the trainable leaves (all but a frozen ESN reservoir) and every leaf
    after the step."""
    from seq2seq_abcd_vae_tpu_torch.models import vae
    from seq2seq_abcd_vae_tpu_torch.train import learner as L
    from seq2seq_abcd_vae_tpu_torch.train import optim
    from seq2seq_abcd_vae_tpu_torch.tree import tree_leaves, tree_map
    params = vae.set_trainable(tree_map(
        lambda p: p.detach().to(device).clone(), params0), cfg)
    statics = L.StepStatics(cfg, spec.frame_length, spec.step_size,
                            spec.window, EPSILON, NORMALIZER, "pallas",
                            *(() if fused_cells is None else (fused_cells,)))
    noise = {k: v.to(device) for k, v in noise.items()}
    loss, metrics = L.losses_and_metrics(
        params, statics, torch.from_numpy(batch.audio).to(device),
        torch.from_numpy(batch.num_frames).to(device),
        torch.from_numpy(batch.speakers).to(device), noise, n_data, 1.0,
        False, batch.bucket_frames)
    leaves = tree_leaves(params)
    trainable = [p for p in leaves if p.requires_grad]
    opt = optim.make_optimizer(trainable, 1.0, 0.0)
    loss.backward()
    grads = [p.grad.detach().clone() for p in trainable]
    optim.clip_and_step(opt, trainable, 1.0)
    return loss.detach(), metrics, grads, [p.detach() for p in leaves]


def whole_step_phase(dev, corpus_dir, csv_path, seed, bidirectional=True,
                     rnn_type="LSTM", esn_leak=1.0, fused_cells=None,
                     latent="abcd"):
    """One training step on the kernels (card) against the same step on
    the twins (CPU), with the bidirectional or the unidirectional LSTM
    encoder, or the model of another cell (``rnn_type`` GRU, RNN or ESN:
    its bidirectional encoder and its decoder; the ESN's reservoir frozen,
    unchanged bit for bit); with ``fused_cells`` leaving the cell out, the
    decoder on its stream path, also held on the card to the fused path's
    step on the same weights and noise; with ``latent="gaussian"`` the
    plain VAE (its Gaussian head, feature size ``PLAIN_FEATURE``).  Returns
    the checks and the step's inputs."""
    from seq2seq_abcd_vae_tpu_torch.configs import (ABCDSamplerConfig,
                                                    DecoderConfig,
                                                    EncoderConfig,
                                                    GaussianSamplerConfig)
    from seq2seq_abcd_vae_tpu_torch.models import vae
    from seq2seq_abcd_vae_tpu_torch.train import learner as L
    from seq2seq_abcd_vae_tpu_torch.tree import tree_leaves, tree_map
    batch, spec, ds = largest_batch(corpus_dir, csv_path)
    f = spec.num_bins
    enc = EncoderConfig(f, HIDDEN, rnn_type=rnn_type,
                        bidirectional=bidirectional, esn_leak=esn_leak)
    if latent == "abcd":
        head, width = ABCDSamplerConfig(enc.hidden_size_total, MLP_HIDDEN,
                                        K, FEATURE_DIM), FEATURE_DIM
    else:
        head, width = GaussianSamplerConfig(
            enc.hidden_size_total, MLP_HIDDEN, PLAIN_FEATURE), PLAIN_FEATURE
    cfg = vae.ModelConfig(
        enc, head,
        DecoderConfig(f, HIDDEN, MLP_HIDDEN, width, rnn_type=rnn_type,
                      esn_leak=esn_leak, num_speakers=2,
                      speaker_embed_dim=SPEAKER_EMBED))
    params0 = vae.model_init(torch.Generator().manual_seed(seed), cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = {k: v.cpu() for k, v in L.draw_noise(
        gen, cfg, len(batch.num_frames), batch.bucket_frames, dev).items()}
    n_data = float(len(ds))
    card = step_on(dev, params0, cfg, batch, spec, noise, n_data, fused_cells)
    cpu = step_on(torch.device("cpu"), params0, cfg, batch, spec, noise,
                  n_data, fused_cells)
    loss_err = abs(card[0].item() - cpu[0].item()) / abs(cpu[0].item())
    grad_err = max(rel_err(g, r) for g, r in zip(card[2], cpu[2]))
    p0 = tree_leaves(params0)
    # parameters after the step: the updates' difference within
    # GRAD_FRACTION of the leaf's largest update, plus the float32
    # rounding of p + update (a few ulps of the leaf's largest value)
    upd_err = 0.0
    for pc, pr, a in zip(card[3], cpu[3], p0):
        allowed = (GRAD_FRACTION * (pr - a).abs().max()
                   + 4 * torch.finfo(torch.float32).eps * a.abs().max())
        upd_err = max(upd_err, ((pc.cpu() - pr).abs().max()
                                / allowed.clamp_min(1e-30)).item())
    # a frozen reservoir leaves the step exactly as it entered
    frozen = vae.set_trainable(tree_map(lambda p: p.clone(), params0), cfg)
    still = [i for i, p in enumerate(tree_leaves(frozen))
             if not p.requires_grad]
    moved = [i for i in still if not (torch.equal(card[3][i].cpu(), p0[i])
                                      and torch.equal(cpu[3][i], p0[i]))]
    if not (loss_err <= LOSS_RTOL and grad_err <= GRAD_FRACTION
            and upd_err <= 1.0 and not moved):
        raise AssertionError(f"training step, kernels vs twins: loss "
                             f"{loss_err}, gradients {grad_err}, updates "
                             f"{upd_err}, frozen leaves moved {moved}")
    checks = {"loss_rel_err": loss_err, "grad_max_rel_err": grad_err,
              "param_err_over_allowed": upd_err, "loss": card[0].item(),
              "leaves": len(p0), "frozen_leaves_unchanged": len(still)}
    if fused_cells is not None and rnn_type not in fused_cells:
        # the stream path against the fused path, both on the card
        fused = step_on(dev, params0, cfg, batch, spec, noise, n_data)
        vs_loss = abs(card[0].item() - fused[0].item()) / abs(
            fused[0].item())
        vs_grad = max(rel_err(g, r) for g, r in zip(card[2], fused[2]))
        if not (vs_loss <= LOSS_RTOL and vs_grad <= GRAD_FRACTION):
            raise AssertionError(f"training step, stream vs fused path on "
                                 f"the card: loss {vs_loss}, gradients "
                                 f"{vs_grad}")
        checks.update(vs_fused_loss_rel_err=vs_loss,
                      vs_fused_grad_max_rel_err=vs_grad)
    return checks, (params0, cfg, batch, spec, noise, n_data)


def train_step_breakdown(dev, params0, cfg, batch, spec, noise, n_data,
                         fused_cells=None):
    """The card's training step by stage, CUDA events around each (the
    decoder on its stream path when ``fused_cells`` leaves its cell
    out)."""
    from seq2seq_abcd_vae_tpu_torch.models import abcd as abcd_mod
    from seq2seq_abcd_vae_tpu_torch.models import decoder as dec_mod
    from seq2seq_abcd_vae_tpu_torch.models import encoder as enc_mod
    from seq2seq_abcd_vae_tpu_torch.models import sampler as sampler_mod
    from seq2seq_abcd_vae_tpu_torch.models import vae
    from seq2seq_abcd_vae_tpu_torch.train import learner as L
    from seq2seq_abcd_vae_tpu_torch.train import optim
    from seq2seq_abcd_vae_tpu_torch.tree import tree_leaves, tree_map
    params = vae.set_trainable(tree_map(
        lambda p: p.detach().to(dev).clone(), params0), cfg)
    leaves = [p for p in tree_leaves(params) if p.requires_grad]
    opt = optim.make_optimizer(leaves, 1.0, 0.0)
    statics = L.StepStatics(cfg, spec.frame_length, spec.step_size,
                            spec.window, EPSILON, NORMALIZER, "pallas")
    audio = torch.from_numpy(batch.audio).to(dev)
    frames = torch.from_numpy(batch.num_frames).to(dev)
    speakers = torch.from_numpy(batch.speakers).to(dev)
    noise_d = {k: v.to(dev) for k, v in noise.items()}
    stages = ("frontend", "encoder_forward", "head", "decoder_forward",
              "backward", "optimiser")
    totals = {s: 0.0 for s in stages}
    reps = 3
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        inputs = L.frontend(statics, audio, batch.bucket_frames)
        ev[1].record()
        hidden = enc_mod.encoder_apply(params["encoder"], cfg.encoder,
                                       inputs, frames)
        ev[2].record()
        head = params["feature_sampler"]
        row_mask = (frames > 0).float()
        if cfg.latent_type == "abcd":
            logits = abcd_mod.abcd_logits(head, hidden)
            feats = abcd_mod.abcd_sample(head, logits, 1.0,
                                         noise_d["gumbel"])
            kl = abcd_mod.abcd_kl(head, cfg.latent, logits, n_data,
                                  row_mask=row_mask)
        else:
            name = cfg.latent.distribution_name
            pair = tuple(p * row_mask[:, None] for p in
                         sampler_mod.sampler_apply(head, hidden))
            feats = sampler_mod.sampler_sample(noise_d["normal"], pair, name)
            kl = sampler_mod.sampler_kl(pair, name, mask=row_mask[:, None])
        ev[3].record()
        em, off = dec_mod.decoder_losses(
            params["decoder"], cfg.decoder, feats, frames, inputs,
            noise_d["decoder"], speakers,
            **({} if fused_cells is None else {"fused_cells": fused_cells}))
        loss = (em + off + kl) / (frames > 0).sum()
        ev[4].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ev[5].record()
        optim.clip_and_step(opt, leaves, 1.0)
        ev[6].record()
        torch.cuda.synchronize()
        if rep:  # the first repetition warms up
            for i, s in enumerate(stages):
                totals[s] += ev[i].elapsed_time(ev[i + 1]) / reps
    totals["step"] = sum(totals[s] for s in stages)
    shape = {"B": len(batch.num_frames), "T": batch.bucket_frames,
             "real_rows": batch.num_real,
             "real_frames": int(batch.num_frames.sum())}
    return totals, shape

# ---------------------------------------------------------------------------
# the unidirectional slice: training, the offline encode CLI, decoding
# ---------------------------------------------------------------------------

def all_counters():
    """Every kernel wrapper's counter, by the name in the kernels line (the
    fused-loss kernels' seed mode on counters of their own).  The
    launch-cost probe is counted apart (``probe_kernel.add_one``): every
    Learner, Encoder and server on the card probes when it starts."""
    from seq2seq_abcd_vae_tpu_torch.ops import (decoder_kernel, elman_kernel,
                                                gru_kernel, lstm_kernel)
    return with_routes(dict(
                training_counters(),
                lstm_layer=lstm_kernel.lstm_layer,
                lstm_layer_bwd=lstm_kernel.lstm_layer_bwd,
                lstm_layer_bidir=lstm_kernel.lstm_layer_bidir,
                lstm_layer_bidir_bwd=lstm_kernel.lstm_layer_bidir_bwd,
                decoder_loop=decoder_kernel.decoder_loop,
                gru_layer_bidir_fused=gru_kernel.gru_layer_bidir_fused,
                gru_layer_bidir_fused_bwd=gru_kernel.gru_layer_bidir_fused_bwd,
                gru_decoder_loop_fused_losses_fwd=(
                    decoder_kernel.gru_decoder_fused_losses_fwd),
                gru_decoder_loop_fused_losses_bwd=(
                    decoder_kernel.gru_decoder_fused_losses_bwd),
                rnn_layer_bidir_fused=elman_kernel.rnn_layer_bidir_fused,
                rnn_layer_bidir_fused_bwd=(
                    elman_kernel.rnn_layer_bidir_fused_bwd),
                rnn_decoder_loop_fused_losses_fwd=(
                    decoder_kernel.rnn_decoder_fused_losses_fwd),
                rnn_decoder_loop_fused_losses_bwd=(
                    decoder_kernel.rnn_decoder_fused_losses_bwd),
                gru_layer=gru_kernel.gru_layer,
                gru_layer_bwd=gru_kernel.gru_layer_bwd,
                rnn_layer=elman_kernel.rnn_layer,
                rnn_layer_bwd=elman_kernel.rnn_layer_bwd,
                gru_decoder_loop=decoder_kernel.gru_decoder_loop,
                rnn_decoder_loop=decoder_kernel.rnn_decoder_loop,
                decoder_loop_bwd=decoder_kernel.decoder_loop_bwd,
                gru_decoder_loop_bwd=decoder_kernel.gru_decoder_loop_bwd,
                rnn_decoder_loop_bwd=decoder_kernel.rnn_decoder_loop_bwd,
                decoder_loop_fused_nll_fwd=(
                    decoder_kernel.decoder_fused_nll_fwd),
                decoder_loop_fused_nll_bwd=(
                    decoder_kernel.decoder_fused_nll_bwd),
                decoder_noise_dump=decoder_kernel.decoder_noise_dump,
                decoder_loop_fused_losses_seed_fwd=(
                    decoder_kernel.decoder_fused_losses_fwd.seed),
                decoder_loop_fused_losses_seed_bwd=(
                    decoder_kernel.decoder_fused_losses_bwd.seed),
                gru_decoder_loop_fused_losses_seed_fwd=(
                    decoder_kernel.gru_decoder_fused_losses_fwd.seed),
                gru_decoder_loop_fused_losses_seed_bwd=(
                    decoder_kernel.gru_decoder_fused_losses_bwd.seed),
                rnn_decoder_loop_fused_losses_seed_fwd=(
                    decoder_kernel.rnn_decoder_fused_losses_fwd.seed),
                rnn_decoder_loop_fused_losses_seed_bwd=(
                    decoder_kernel.rnn_decoder_fused_losses_bwd.seed)))


def expected(counters: dict, **launches) -> dict:
    """Every counter 0 but the ones named, and each route as the run split
    it, after checking that the routes of a wrapper sum to its count."""
    want = dict({name: 0 for name in counters}, **launches)
    for total in {t for t, _ in ROUTES.values()} & set(counters):
        split = {n: counters[n].launches for n, (t, _) in ROUTES.items()
                 if t == total}
        if sum(split.values()) != counters[total].launches:
            raise AssertionError(f"{total}: routes {split} do not sum to "
                                 f"{counters[total].launches}")
        want.update(split)
    return want


def zero_counters() -> dict:
    counters = all_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def uni_train_phase(dev, work: str, corpus_dir: str, csv_path: str,
                    seed: int):
    """The unidirectional encoder trained through the CLI on the synthetic
    corpus (2 epochs, 1 of pretraining, then resumed to 3), counted: the
    one-direction LSTM kernels run, the bidirectional ones do not."""
    from seq2seq_abcd_vae_tpu_torch.cli import learning_main
    argv = [corpus_dir, csv_path, "-S", work, "-j", "uni", "-b",
            str(TRAIN_BATCH), "--pretrain_epochs", "1", "--stft_method",
            "pallas", "-d", dev.type, "-N", str(NORMALIZER), "-s", str(seed),
            "--unidirectional_encoder",
            "--encoder_rnn_hidden_size", str(HIDDEN),
            "--decoder_rnn_hidden_size", str(HIDDEN),
            "--mlp_hidden_size", str(MLP_HIDDEN), "-K", str(K),
            "-f", str(FEATURE_DIM), "--speaker_embed_dim", str(SPEAKER_EMBED)]
    counters = zero_counters()
    t0 = time.perf_counter()
    first = learning_main.main(argv + ["-e", "2"])
    second = learning_main.main(argv + ["-e", "3"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    run_dir = os.path.join(work, "uni")
    check_history(os.path.join(run_dir, "history.log"), True)
    train_steps = first.steps["train"] + second.steps["train"]
    eval_steps = first.steps["eval"] + second.steps["eval"]
    steps = train_steps + eval_steps
    want = expected(counters, log_spectrogram=steps,
                    decoder_loop_fused_losses_fwd=steps,
                    decoder_loop_fused_losses_bwd=train_steps,
                    lstm_layer=steps, lstm_layer_bwd=train_steps)
    print(f"unidirectional training main path: {train_steps} training + "
          f"{eval_steps} evaluation steps in {wall:.2f} s; launches "
          f"{launches}", flush=True)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if launches["lstm_layer_cluster"] != steps:
        raise AssertionError("the one-direction LSTM forward at B=512 did "
                             f"not take its cluster route: {launches}")
    if launches["lstm_layer_bwd_cluster"] != train_steps:
        raise AssertionError("the one-direction LSTM backward at H=256 did "
                             f"not take its cluster route: {launches}")
    epochs = first.epoch_seconds + second.epoch_seconds
    later = [n / sec for _, sec, n in epochs[1:]]
    return {"launches": launches, "train_steps": train_steps,
            "eval_steps": eval_steps,
            "checkpoint": os.path.join(run_dir, "checkpoint.pt"),
            "segments_per_s_after_first_epoch":
                sum(later) / len(later) if later else None,
            "epochs": [{"epoch": e, "train_s": sec, "segments": n}
                       for e, sec, n in epochs]}


def wide_train_phase(dev, work: str, corpus_dir: str, csv_path: str,
                     seed: int, unidirectional: bool):
    """The LSTM model at encoder hidden size 1024 (the widest the JAX CLI
    takes), bidirectional or with ``--unidirectional_encoder``, trained
    through the CLI for one epoch (no pretraining, no resume: depth cut),
    counted: the cluster designs do not take H=1024, so the LSTM encoder's
    forward runs by its per-tile route once per step and its backward by
    the grid design (``"tile"``) once per training step."""
    from seq2seq_abcd_vae_tpu_torch.cli import learning_main
    job = "wide-uni" if unidirectional else "wide"
    argv = [corpus_dir, csv_path, "-S", work, "-j", job, "-b",
            str(TRAIN_BATCH), "--pretrain_epochs", "0", "--stft_method",
            "pallas", "-d", dev.type, "-N", str(NORMALIZER), "-s", str(seed),
            *(("--unidirectional_encoder",) if unidirectional else ()),
            "--encoder_rnn_hidden_size", str(WIDE_HIDDEN),
            "--decoder_rnn_hidden_size", str(HIDDEN),
            "--mlp_hidden_size", str(MLP_HIDDEN), "-K", str(K),
            "-f", str(FEATURE_DIM), "--speaker_embed_dim", str(SPEAKER_EMBED),
            "-e", "1"]
    counters = zero_counters()
    t0 = time.perf_counter()
    run = learning_main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(work, job, "history.log")) as f:
        log = f.read()
    losses = [float(v) for v in re.findall(
        r"(?:mean loss|\(per string\)): (-?[0-9]+\.[0-9]+|-?nan|-?inf)",
        log)]
    if ("END OF TRAINING" not in log or not losses
            or not all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"{job}: history.log lacks the end of training "
                             "or has a non-finite loss")
    launches = {name: fn.launches for name, fn in counters.items()}
    train, steps = run.steps["train"], run.steps["train"] + run.steps["eval"]
    layer = "lstm_layer" if unidirectional else "lstm_layer_bidir_fused"
    want = expected(counters, log_spectrogram=steps,
                    decoder_loop_fused_losses_fwd=steps,
                    decoder_loop_fused_losses_bwd=train,
                    **{layer: steps, layer + "_bwd": train})
    print(f"{job} training main path (encoder hidden {WIDE_HIDDEN}): "
          f"{train} training + {run.steps['eval']} evaluation steps in "
          f"{wall:.2f} s; launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    tiles = {layer + "_tile": steps, layer + "_bwd_tile": train}
    if any(launches[k] != n for k, n in tiles.items()):
        raise AssertionError(f"{job}: the per-tile routes did not run: "
                             f"{launches}")
    return {"launches": launches, "train_steps": train,
            "eval_steps": run.steps["eval"], "wall_s": wall}


def read_long_csv(path: str):
    """(header, [(data_ix, var, rest)], value texts) of a long CSV."""
    with open(path) as f:
        lines = f.read().splitlines()
    rows = [line.split(",", 3) for line in lines[1:]]
    return (lines[0], [(r[0], r[1], r[3] if len(r) > 3 else None)
                       for r in rows], [r[2] for r in rows])


def encode_cli_phase(dev, work: str, corpus_dir: str, csv_path: str,
                     checkpoints: dict,
                     modes=("probs", "logits", "features"),
                     formats=("csv", "npz")):
    """The encode CLI (``encode_main.main``) in ``modes`` on each
    checkpoint, in each of ``formats``, on the card (counted) and as CSV on
    the CPU's twins: rows, probabilities, npz = CSV values bit for bit,
    card CSV = CPU CSV (values within tolerance, other bytes equal)."""
    from seq2seq_abcd_vae_tpu_torch.cli import encode_main
    common = [corpus_dir, csv_path, str(NORMALIZER), "-b", str(TRAIN_BATCH),
              "--stft_method", "pallas"]
    out_dir = os.path.join(work, "encoded")
    os.makedirs(out_dir, exist_ok=True)
    counters = zero_counters()
    card = {}
    for name, ckpt in checkpoints.items():
        for mode in modes:
            for fmt in formats:
                path = os.path.join(out_dir, f"{name}-{mode}.{fmt}")
                t0 = time.perf_counter()
                encode_main.main(mode, [ckpt] + common + [
                    "-S", path, "-d", dev.type, "--save_format", fmt])
                torch.cuda.synchronize()
                card[(name, mode, fmt)] = (path, time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in counters.items()}
    checks, segments = {}, None
    for name, ckpt in checkpoints.items():
        for mode in modes:
            head, keys, texts = read_long_csv(card[(name, mode, "csv")][0])
            width = FEATURE_DIM if mode == "features" else K
            ixs = list(dict.fromkeys(k[0] for k in keys))
            segments = len(ixs)
            if len(keys) != segments * width:
                raise AssertionError(f"{name} {mode}: {len(keys)} rows for "
                                     f"{segments} segments")
            vals = np.asarray(texts, np.float32)
            if not np.all(np.isfinite(vals)):
                raise AssertionError(f"{name} {mode}: non-finite values")
            if mode == "probs":
                per = {}
                for (ix, _, _), v in zip(keys, vals):
                    per[ix] = per.get(ix, 0.0) + float(v)
                worst = max(abs(v - 1.0) for v in per.values())
                if worst > 1e-5:
                    raise AssertionError(f"{name} probs sum off by {worst}")
            if "npz" in formats:
                check_npz(card[(name, mode, "npz")][0], keys, vals, mode,
                          (segments, width))
            cpu_path = os.path.join(out_dir, f"{name}-{mode}-cpu.csv")
            encode_main.main(mode, [ckpt] + common + ["-S", cpu_path, "-d",
                                                      "cpu"])
            c_head, c_keys, c_texts = read_long_csv(cpu_path)
            if c_head != head or c_keys != keys:
                raise AssertionError(f"{name} {mode}: card and CPU CSVs "
                                     "differ outside the values")
            err = float(np.abs(vals.astype(np.float64) - np.asarray(
                c_texts, np.float64)).max())
            checks[f"{name}_{mode}"] = err
            if not err <= STEP_ATOL[mode]:
                raise AssertionError(f"encode CLI {name} {mode}: card vs "
                                     f"CPU {err} > {STEP_ATOL[mode]}")
    throughput = {f"{n}_{m}_{f}": segments / sec
                  for (n, m, f), (_, sec) in card.items()}
    return {"launches": launches, "segments": segments,
            "card_vs_cpu_max_abs_err": checks,
            "segments_per_s": throughput}


def check_npz(path: str, keys, vals, mode: str, shape):
    """The npz sidecar holds the CSV's values bit for bit."""
    with np.load(path) as z:
        data_ix, values, zmode = z["data_ix"], z["values"], z["mode"]
    if str(zmode) != mode or values.shape != shape:
        raise AssertionError(f"{path}: npz {values.shape}")
    parsed = {(int(k[0]), int(k[1])): v for k, v in zip(keys, vals)}
    back = np.asarray([[parsed[(int(ix), j)] for j in range(shape[1])]
                       for ix in data_ix], np.float32)
    if back.tobytes() != values.tobytes():
        raise AssertionError(f"{path}: npz values differ from the CSV's")


def swap_twin(module, name: str, twin):
    """Context: ``module.name`` is ``twin`` inside (the card's twins in a
    whole call), restored after."""
    import contextlib

    @contextlib.contextmanager
    def swapped():
        kernel = getattr(module, name)
        setattr(module, name, twin)
        try:
            yield
        finally:
            setattr(module, name, kernel)
    return swapped()


def decode_phase(dev, ckpt_path: str, corpus_dir: str, csv_path: str,
                 seed: int, loop: str = "decoder_loop"):
    """``decode_features`` on a checkpoint from the features of the
    corpus's validation segments at their lengths (an ABCD head's codes,
    or a plain VAE's Gaussian means): ``sample`` mode on the
    decoder cell's loop kernel ``loop`` (``decoder_loop``,
    ``gru_decoder_loop`` or ``rnn_decoder_loop``), counted: one launch, and
    none in ``mean`` mode; each mode against the same call on the card's
    twins (sample) and on the CPU, with the same noise."""
    from seq2seq_abcd_vae_tpu_torch.data.annotations import AnnotationParser
    from seq2seq_abcd_vae_tpu_torch.data.batching import (DataLoader,
                                                          FrontendSpec)
    from seq2seq_abcd_vae_tpu_torch.infer.decode import (decode_features,
                                                         load_model)
    from seq2seq_abcd_vae_tpu_torch.infer.encode import Encoder, encode_step
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel
    spec = FrontendSpec(int(0.008 * TRAIN_FS), int(0.004 * TRAIN_FS))
    parser = AnnotationParser(corpus_dir, csv_path)
    valid = parser.get_data("valid")
    batch = next(iter(DataLoader(valid, spec, batch_size=len(valid))))
    enc = Encoder(ckpt_path, device=dev.type, stft_method="pallas")
    gaussian = enc.latent_type == "gaussian"
    feats = encode_step(enc.params, torch.from_numpy(batch.audio).to(dev),
                        torch.from_numpy(batch.num_frames).to(dev),
                        enc.statics(spec, EPSILON, NORMALIZER),
                        batch.bucket_frames,
                        "params" if gaussian else "features")
    if gaussian:
        feats = feats[0]  # the posterior means
    models = {d: load_model(ckpt_path, d.type)
              for d in (dev, torch.device("cpu"))}
    lengths = torch.from_numpy(batch.num_frames)
    speakers = torch.from_numpy(batch.speakers)
    t = batch.bucket_frames
    cfg = models[dev][1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((t, len(lengths), cfg.decoder.output_size),
                        generator=gen, device=dev)

    def run(device, mode, twin=False):
        args = (models[device][0], cfg, feats.to(device),
                lengths.to(device), t)
        kw = dict(noise=noise.to(device), speaker=speakers.to(device),
                  emission_mode=mode)
        if twin:
            with swap_twin(decoder_kernel, loop,
                           getattr(decoder_kernel, loop + "_plain")):
                return decode_features(*args, **kw)
        return decode_features(*args, **kw)

    counters = zero_counters()
    card, by_mode = {}, {}
    for mode in ("sample", "mean"):
        before = {k: fn.launches for k, fn in counters.items()}
        card[mode] = run(dev, mode)
        torch.cuda.synchronize()
        by_mode[mode] = {k: fn.launches - before[k]
                         for k, fn in counters.items()}
    launches = {k: fn.launches for k, fn in counters.items()}
    for mode, want in (("sample", expected(counters, **{loop: 1})),
                       ("mean", expected(counters))):
        if by_mode[mode] != want:
            raise AssertionError(f"decode ({mode}) launched {by_mode[mode]}, "
                                 f"expected {want}")
    errs = {}
    for mode, got in card.items():
        refs = {"cpu": run(torch.device("cpu"), mode)}
        if mode == "sample":
            refs["card_twins"] = run(dev, mode, twin=True)
        for where, ref in refs.items():
            streams = (("out", got.out, ref.out),
                       ("mean", got.emission_params[0],
                        ref.emission_params[0]),
                       ("logvar", got.emission_params[1],
                        ref.emission_params[1]),
                       ("offset", got.offset_weights, ref.offset_weights))
            for name, g, r in streams:
                if not torch.isfinite(g).all():
                    raise AssertionError(f"decode {mode}: non-finite {name}")
                errs[f"{mode}_{name}_vs_{where}"] = max_err(g, r)
    worst = max(errs.values())
    if not worst <= DECODE_ATOL:
        raise AssertionError(f"decode_features: {errs}")
    ms = {mode: cuda_ms(lambda m=mode: run(dev, m), iters=3, warmup=1)
          for mode in ("sample", "mean")}
    return {"launches": launches, "cell": cfg.decoder.rnn_type,
            "latent": cfg.latent_type, "rows": len(lengths), "T": t,
            "max_abs_err": errs, "ms": ms}


def _lstm_weights(rng, dev, h, *shapes):
    bound = 1.0 / np.sqrt(h)
    return [torch.from_numpy(rng.uniform(-bound, bound, size=s).astype(
        np.float32)).to(dev) for s in shapes]


def lstm_layer_phase(dev, rng, launches_cluster, launches_tile,
                     launches_bwd):
    """Row 3, the one-direction LSTM forward, by both routes against the
    twin and against each other (ragged lengths, one empty row, both span
    directions) at the training shape B=512, T=125, at the served B=64,
    T=512 and at B=13; the public wrapper takes the route its rule names;
    H=1024 and H=36 (not a multiple of 8), forced to the cluster route,
    raise.  Each route timed at both shapes beside the twin and cuDNN's
    LSTM, the per-tile route also at its main path's H=1024.  Row 3b, the
    backward, by both designs vs its twin at the same shapes (the public
    wrapper takes the cluster route at H=256, bit for bit across calls;
    the grid route forced beside it) and at H=1024 (its wide main path's
    width: the grid route, with and without douts, both span directions),
    each timed at its width beside the twin and cuDNN's forward +
    backward, the cluster route split into (a) gates, (b) recurrence, (d)
    weight gradients.  ``launches_bwd`` maps ``lstm_layer_bwd`` and its
    two routes to their main paths' launches."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    h, f = HIDDEN, 129
    lib = _build.load("lstm")
    active = {rows: lib.abcd_lstm_fwd_cluster_max_active(h, rows)
              for rows in lk.PROJ_CLUSTER_TILES}
    checks = {"cluster": {}, "tile": {}, "cluster_vs_tile": {}, "bwd": {},
              "bwd_tile": {}}
    picked_rows = {}
    inputs = {}
    bwd_abs = {"cluster": 0.0, "tile": 0.0}
    for b, t in ((TRAIN_BATCH, 125), (BATCH, 512), (13, 37)):
        lens, lengths = _ragged(rng, dev, b, t)
        xp = torch.from_numpy(rng.normal(size=(t, b, 4 * h)).astype(
            np.float32)).to(dev)
        w_hh, b_hh = _lstm_weights(rng, dev, h, (h, 4 * h), (4 * h,))
        design, rows = lk.layer_design(active, b)
        picked_rows[f"B{b}"] = (design, rows)
        for reverse in (False, True):
            route = getattr(lk.lstm_layer, design)
            before = route.launches
            lk.lstm_layer(xp, lengths, w_hh, b_hh, reverse, True)
            if route.launches != before + 1:
                raise AssertionError(f"row 3 at B={b} did not take the "
                                     f"{design} route")
            ref = lk.lstm_layer_plain(xp, lengths, w_hh, b_hh, reverse, True)
            got = {d: lk.lstm_layer_on(d, xp, lengths, w_hh, b_hh, reverse,
                                       True) for d in ("cluster", "tile")}
            torch.cuda.synchronize()
            shape = f"B{b}_T{t}_rev{int(reverse)}"
            for d, out in got.items():
                err = max_err(out, ref)
                checks[d][shape] = err
                if not err <= LSTM_ATOL:
                    raise AssertionError(f"row 3 {d} route vs twin at "
                                         f"{shape}: {err}")
            checks["cluster_vs_tile"][shape] = max_err(got["cluster"],
                                                       got["tile"])
            outs, h_n, c_n, cs = ref
            normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
                np.float32)).to(dev)
            bwd = (xp, lengths, w_hh, b_hh, outs, cs, None, normal(b, h),
                   normal(b, h), reverse)
            before = lk.lstm_layer_bwd.cluster.launches
            got_b = lk.lstm_layer_bwd(*bwd)
            if lk.lstm_layer_bwd.cluster.launches != before + 1:
                raise AssertionError(f"row 3b at B={b} did not take the "
                                     "cluster route")
            again = lk.lstm_layer_bwd(*bwd)
            tile_b = lk.lstm_layer_bwd_on("tile", *bwd)
            want_b = lk.lstm_layer_bwd_plain(*bwd)
            torch.cuda.synchronize()
            if max_err(got_b, again) != 0.0:
                raise AssertionError(f"row 3b cluster route differs between "
                                     f"calls at {shape}")
            for key, got_d in (("bwd", got_b), ("bwd_tile", tile_b)):
                relb = {n: rel_err(g, r) for n, g, r in zip(
                    ("dxp", "dw_hh", "db_hh"), got_d, want_b)}
                checks[key][shape] = max(relb.values())
                route = "cluster" if key == "bwd" else "tile"
                bwd_abs[route] = max(bwd_abs[route], max_err(got_d, want_b))
                if max(relb.values()) > GRAD_FRACTION:
                    raise AssertionError(f"lstm_layer backward ({route}) vs "
                                         f"twin at {shape}: {relb}")
            if not reverse:
                inputs[(b, t)] = (lens, xp, lengths, w_hh, b_hh, bwd)
    refused = {}
    for hh in (WIDE_HIDDEN, 36):
        lens_r, lengths_r = _ragged(rng, dev, 6, 5)
        w_hh, b_hh = _lstm_weights(rng, dev, hh, (hh, 4 * hh), (4 * hh,))
        xp = torch.from_numpy(rng.normal(size=(5, 6, 4 * hh)).astype(
            np.float32)).to(dev)
        try:
            lk.lstm_layer_on("cluster", xp, lengths_r, w_hh, b_hh)
            torch.cuda.synchronize()
        except RuntimeError as e:
            refused[f"H{hh}"] = str(e)[:100]
        else:
            raise AssertionError(f"row 3's cluster route took H={hh}")

    def library_for(lens, w_hh, b_hh, t, b):
        # cuDNN's unidirectional LSTM on the same recurrent weights over
        # packed sequences (the zero-length row dropped); it also computes
        # the input projection, which the kernel is handed
        h = w_hh.shape[0]
        lstm = torch.nn.LSTM(f, h).to(dev)
        with torch.no_grad():
            lstm.weight_hh_l0.copy_(w_hh.T)
            lstm.bias_hh_l0.copy_(b_hh)
        keep = torch.from_numpy(lens > 0).to(dev)
        x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32)
                             ).to(dev)
        x_lib = x[:, keep].clone().requires_grad_(True)
        lens_lib = torch.from_numpy(lens[lens > 0].astype(np.int64))
        dh_lib = torch.from_numpy(rng.normal(size=(1, len(lens_lib), h))
                                  .astype(np.float32)).to(dev)

        def fwd():
            with torch.no_grad():
                packed = torch.nn.utils.rnn.pack_padded_sequence(
                    x_lib, lens_lib, enforce_sorted=False)
                return lstm(packed)[1]

        def fwd_bwd():
            packed = torch.nn.utils.rnn.pack_padded_sequence(
                x_lib, lens_lib, enforce_sorted=False)
            _, (hh, cc) = lstm(packed)
            torch.autograd.backward((hh, cc), (dh_lib, dh_lib))

        return fwd, fwd_bwd

    def fwd_bytes(t, b, hh):
        return 4.0 * (t * b * 4 * hh + hh * 4 * hh + 4 * hh       # xp, W, b
                      + t * b * hh + 2 * b * hh) + 4 * b       # outs, h_n, c_n

    def bwd_bytes(t, b, hh):
        return 4.0 * (t * b * 4 * hh + hh * 4 * hh + 4 * hh      # xp, W, b
                      + 2 * t * b * hh + 2 * b * hh        # outs, cs, dh, dc
                      + t * b * 4 * hh + hh * 4 * hh + 4 * hh) + 4 * b

    times = {}
    for (b, t), (lens, xp, lengths, w_hh, b_hh, bwd) in inputs.items():
        if b == 13:
            continue
        at = {d: cuda_ms(lambda: lk.lstm_layer_on(d, xp, lengths, w_hh,
                                                  b_hh), 5)
              for d in ("cluster", "tile")}
        at["plain"] = cuda_ms(lambda: lk.lstm_layer_plain(xp, lengths, w_hh,
                                                          b_hh), 2, 1)
        lib_fwd, lib_fwd_bwd = library_for(lens, w_hh, b_hh, t, b)
        at["library"] = cuda_ms(lib_fwd, 5)
        at["bound"] = bound_ms(int(lens.sum()) * 2.0 * h * 4 * h,
                               fwd_bytes(t, b, h))
        if b == TRAIN_BATCH:
            at["bwd"] = cuda_ms(lambda: lk.lstm_layer_bwd(*bwd), 5)
            at["bwd_tile"] = cuda_ms(lambda: lk.lstm_layer_bwd_on("tile",
                                                                  *bwd), 5)
            split = []
            for _ in range(3):
                marks = []
                lk.lstm_layer_bwd_on("cluster", *bwd, marks=marks)
                torch.cuda.synchronize()
                split.append([marks[i].elapsed_time(marks[i + 1])
                              for i in range(3)])
            at["bwd_split_ms"] = dict(zip(
                ("a_gates", "b_recurrence", "d_wgrad"),
                np.median(np.asarray(split), axis=0).tolist()))
            at["bwd_plain"] = cuda_ms(lambda: lk.lstm_layer_bwd_plain(*bwd),
                                      2, 1)
            at["bwd_library"] = cuda_ms(lib_fwd_bwd, 5)
            # gates recomputed, dz @ W_hh^T and h_prev^T dz: three times the
            # forward's products
            at["bwd_bound"] = bound_ms(3 * int(lens.sum()) * 2.0 * h * 4 * h,
                                       bwd_bytes(t, b, h))
        times[f"B{b}_T{t}"] = at
    # the per-tile routes at their main path's width (the wide
    # unidirectional training path): the forward, saving cs, and row 3b
    t, b, hh = 125, TRAIN_BATCH, WIDE_HIDDEN
    wlens, wlengths = _ragged(rng, dev, b, t)
    w_hh, b_hh = _lstm_weights(rng, dev, hh, (hh, 4 * hh), (4 * hh,))
    xp = torch.from_numpy(rng.normal(size=(t, b, 4 * hh)).astype(
        np.float32)).to(dev)
    ref = lk.lstm_layer_plain(xp, wlengths, w_hh, b_hh, False, True)
    wide_err = max_err(lk.lstm_layer(xp, wlengths, w_hh, b_hh, False, True),
                       ref)
    checks["tile"][f"B{b}_T{t}_H{hh}"] = wide_err
    if not wide_err <= LSTM_ATOL:
        raise AssertionError(f"row 3 per-tile route at H={hh}: {wide_err}")
    wide_ms = cuda_ms(lambda: lk.lstm_layer(xp, wlengths, w_hh, b_hh, False,
                                            True), 2, 1)
    wide_bound = bound_ms(int(wlens.sum()) * 2.0 * hh * 4 * hh,
                          fwd_bytes(t, b, hh))[0]
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(dev)
    for reverse in (False, True):
        outs, _, _, cs = (ref if not reverse else lk.lstm_layer_plain(
            xp, wlengths, w_hh, b_hh, True, True))
        for douts in (None, normal(t, b, hh)):
            wide_bwd = (xp, wlengths, w_hh, b_hh, outs, cs, douts,
                        normal(b, hh), normal(b, hh), reverse)
            before = lk.lstm_layer_bwd.tile.launches
            got_b = lk.lstm_layer_bwd(*wide_bwd)
            if lk.lstm_layer_bwd.tile.launches != before + 1:
                raise AssertionError(f"row 3b at H={hh} did not take the "
                                     "grid route")
            want_b = lk.lstm_layer_bwd_plain(*wide_bwd)
            torch.cuda.synchronize()
            relb = {n: rel_err(g, r) for n, g, r in zip(
                ("dxp", "dw_hh", "db_hh"), got_b, want_b)}
            shape = (f"B{b}_T{t}_H{hh}_rev{int(reverse)}_douts"
                     f"{int(douts is not None)}")
            checks["bwd_tile"][shape] = max(relb.values())
            bwd_abs["tile"] = max(bwd_abs["tile"], max_err(got_b, want_b))
            if max(relb.values()) > GRAD_FRACTION:
                raise AssertionError(f"lstm_layer backward vs twin at "
                                     f"{shape}: {relb}")
    again = lk.lstm_layer_bwd(*wide_bwd)
    torch.cuda.synchronize()
    if max_err(got_b, again) != 0.0:
        raise AssertionError(f"row 3b grid route differs between calls at "
                             f"H={hh}")
    wide_bwd_ms = cuda_ms(lambda: lk.lstm_layer_bwd(*wide_bwd), 3, 1)
    wide_bwd_plain_ms = cuda_ms(lambda: lk.lstm_layer_bwd_plain(*wide_bwd),
                                1, 0)
    split = []
    for _ in range(3):
        marks = []
        lk.lstm_layer_bwd_on("tile", *wide_bwd, marks=marks)
        torch.cuda.synchronize()
        split.append([marks[i].elapsed_time(marks[i + 1]) for i in range(3)])
    wide_bwd_split = dict(zip(("a_gates", "b_recurrence", "d_wgrad"),
                              np.median(np.asarray(split), axis=0).tolist()))
    wide_lib_fwd, wide_lib_fwd_bwd = library_for(wlens, w_hh, b_hh, t, b)
    wide_lib_ms = cuda_ms(wide_lib_fwd, 2, 1)
    wide_lib_bwd_ms = cuda_ms(wide_lib_fwd_bwd, 2, 1)
    wide_bwd_bound = bound_ms(3 * int(wlens.sum()) * 2.0 * hh * 4 * hh,
                              bwd_bytes(t, b, hh))[0]
    train = times[f"B{TRAIN_BATCH}_T125"]
    served = times[f"B{BATCH}_T512"]
    common = {"route": "cuda",
              "source": "seq2seq_abcd_vae_tpu_torch/csrc/lstm.cu",
              "replaces": "seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:149",
              "plain_ms": train["plain"], "bound_ms": train["bound"][0],
              "bound_by": train["bound"][1], "library_ms": train["library"],
              "library_call": "nn.LSTM (unidirectional) forward, packed",
              "shape": f"T=125 B={TRAIN_BATCH} H={h} (xp given; ragged, "
                       "one empty row)",
              "ms_by_shape": times, "tolerance": LSTM_ATOL,
              "checks": checks, "refused_by_the_cluster_route": refused,
              "max_active_clusters": active, "rule": picked_rows}
    fwd_entries = [
        dict(common, name="lstm_layer_cluster", launches=launches_cluster,
             max_abs_err=max(checks["cluster"].values()),
             ms=train["cluster"], served_shape_ms=served["cluster"]),
        dict(common, name="lstm_layer_tile", launches=launches_tile,
             max_abs_err=max(checks["tile"].values()), ms=train["tile"],
             served_shape_ms=served["tile"],
             main_path_shape=f"T=125 B={TRAIN_BATCH} H={WIDE_HIDDEN}",
             main_path_shape_ms=wide_ms,
             main_path_shape_bound_ms=wide_bound,
             main_path_shape_library_ms=wide_lib_ms)]
    bwd_entry = {
        "name": "lstm_layer_bwd", "route": "cuda",
        "source": "seq2seq_abcd_vae_tpu_torch/csrc/lstm.cu",
        "replaces": "seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:192",
        "launches": launches_bwd["lstm_layer_bwd"],
        "max_abs_err": max(bwd_abs.values()),
        "max_rel_err": max(max(checks["bwd"].values()),
                           max(checks["bwd_tile"].values())),
        "ms": train["bwd"], "plain_ms": train["bwd_plain"],
        "bound_ms": train["bwd_bound"][0], "bound_by": train["bwd_bound"][1],
        "library_ms": train["bwd_library"],
        "library_call": "nn.LSTM (unidirectional) forward + backward, "
                        "packed",
        "shape": common["shape"],
        "main_path_shape": f"T=125 B={TRAIN_BATCH} H={WIDE_HIDDEN}",
        "main_path_shape_ms": wide_bwd_ms,
        "main_path_shape_bound_ms": wide_bwd_bound,
        "main_path_shape_library_ms": wide_lib_bwd_ms,
        "tolerance": f"{GRAD_FRACTION} of each leaf's max |value|"}
    # the two designs apart, each at the width whose main path takes it
    bwd_common = {k: bwd_entry[k] for k in ("route", "source", "replaces",
                                            "library_call", "tolerance")}
    bwd_routes = [
        dict(bwd_common, name="lstm_layer_bwd_cluster",
             launches=launches_bwd["lstm_layer_bwd_cluster"],
             max_abs_err=bwd_abs["cluster"],
             max_rel_err=max(checks["bwd"].values()), ms=train["bwd"],
             plain_ms=train["bwd_plain"], bound_ms=train["bwd_bound"][0],
             bound_by=train["bwd_bound"][1],
             library_ms=train["bwd_library"], shape=common["shape"],
             split_ms=train["bwd_split_ms"],
             grid_route_ms_same_shape=train["bwd_tile"]),
        dict(bwd_common, name="lstm_layer_bwd_tile",
             launches=launches_bwd["lstm_layer_bwd_tile"],
             max_abs_err=bwd_abs["tile"],
             max_rel_err=max(checks["bwd_tile"].values()), ms=wide_bwd_ms,
             plain_ms=wide_bwd_plain_ms, bound_ms=wide_bwd_bound,
             bound_by=bound_ms(3 * int(wlens.sum()) * 2.0 * hh * 4 * hh,
                               bwd_bytes(t, b, hh))[1],
             library_ms=wide_lib_bwd_ms,
             shape=f"T=125 B={TRAIN_BATCH} H={WIDE_HIDDEN} (xp given; "
                   "ragged, one empty row)",
             split_ms=wide_bwd_split)]
    return fwd_entries, [bwd_entry, *bwd_routes]


def decoder_loop_phase(dev, rng, launches):
    """The plain sampled decoder loop vs its twin at B=128, T=125 (the
    corpus's validation segments) and B=64, T=512, timed at the first."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    h, m, f = HIDDEN, MLP_HIDDEN, 129
    checks, timed = {}, None
    for b, t in ((128, 125), (BATCH, 512)):
        full, lens = _decoder_kernel_args(dev, rng, t, b)
        args = full[:9] + full[14:]
        got = dk.decoder_loop(*args)
        want = dk.decoder_loop_plain(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        checks[f"B{b}_T{t}"] = err
        if not err <= LSTM_ATOL:
            raise AssertionError(f"decoder_loop vs twin B={b} T={t}: {err}")
        if timed is None:
            timed = (b, t, lens, args)
    b, t, lens, args = timed
    ms = cuda_ms(lambda: dk.decoder_loop(*args), 5)
    plain_ms = cuda_ms(lambda: dk.decoder_loop_plain(*args), 2, 1)
    # per row-step: h @ w_cat, the emission's second layer (mean and
    # logvar) and the fed-back x @ w_ih; every step of every row runs
    per = 2.0 * (h * (4 * h + 2 * m) + 2 * m * f + f * 4 * h)
    weights = (h * (4 * h + 2 * m) + 4 * h + 2 * m + 2 * m * f + 2 * f
               + f * 4 * h)
    nbytes = 4.0 * (t * b * f + weights + 2 * b * h          # inputs
                    + t * b * h + 2 * t * b * f) + 4 * b      # outputs
    bms, by = bound_ms(t * b * per, nbytes)
    return {"name": "decoder_loop", "route": "cuda",
            "source": "seq2seq_abcd_vae_tpu_torch/csrc/decoder.cu",
            "replaces": "seq2seq_abcd_vae_tpu/ops/decoder_pallas.py:298",
            "launches": launches, "max_abs_err": max(checks.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None,
            "library_call": "none: no single PyTorch call runs the sampled "
                            "loop",
            "shape": f"T={t} B={b} F={f} H={h} m={m} (ragged, one empty "
                     "row)",
            "tolerance": LSTM_ATOL, "checks": checks}


# ---------------------------------------------------------------------------
# the GRU slice: training, encoding and serving a GRU model
# ---------------------------------------------------------------------------

def _reservoir(c: dict) -> list:
    """The ESN tensors (encoder layers, either direction, and the decoder's
    cell) of a loaded checkpoint."""
    return ([layer[d][k] for layer in c["encoder"]["layers"]
             for d in sorted(layer) for k in ("w_ih", "w_hh")]
            + [c["decoder"]["rnn_cell"][k] for k in ("w_ih", "w_hh")])


def cell_train_phase(dev, work: str, corpus_dir: str, csv_path: str,
                     seed: int, cell: str, kernels: dict, extra=(),
                     unidirectional: bool = False):
    """The model of another cell (``-R cell``: its bidirectional encoder,
    or with ``unidirectional`` its one-direction encoder, and, as
    ``--decoder_rnn_type`` follows ``-R``, its decoder) trained through the
    CLI on the synthetic corpus (2 epochs, 1 of pretraining, then resumed
    to 3), counted: each of ``kernels`` ran once per training and
    evaluation step (``"steps"``) or per training step (``"train"``), no
    other kernel ran.  For the ESN, the reservoir in the resumed run's
    checkpoint must equal the first run's bit for bit (it is frozen)."""
    from seq2seq_abcd_vae_tpu_torch.cli import learning_main
    from seq2seq_abcd_vae_tpu_torch.train import checkpoint as ckpt
    job = ("uni-" if unidirectional else "") + cell.lower()
    argv = [corpus_dir, csv_path, "-S", work, "-j", job, "-b",
            str(TRAIN_BATCH), "--pretrain_epochs", "1", "--stft_method",
            "pallas", "-d", dev.type, "-N", str(NORMALIZER), "-s", str(seed),
            "-R", cell, *extra,
            *(("--unidirectional_encoder",) if unidirectional else ()),
            "--encoder_rnn_hidden_size", str(HIDDEN),
            "--decoder_rnn_hidden_size", str(HIDDEN),
            "--mlp_hidden_size", str(MLP_HIDDEN), "-K", str(K),
            "-f", str(FEATURE_DIM), "--speaker_embed_dim", str(SPEAKER_EMBED)]
    counters = zero_counters()
    t0 = time.perf_counter()
    first = learning_main.main(argv + ["-e", "2"])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    run_dir = os.path.join(work, job)
    path = os.path.join(run_dir, "checkpoint.pt")
    check_history(os.path.join(run_dir, "history.log"), False)
    before = ckpt.load_checkpoint(path)
    t0 = time.perf_counter()
    second = learning_main.main(argv + ["-e", "3"])
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    check_history(os.path.join(run_dir, "history.log"), True)
    launches = {name: fn.launches for name, fn in counters.items()}
    train_steps = first.steps["train"] + second.steps["train"]
    eval_steps = first.steps["eval"] + second.steps["eval"]
    steps = train_steps + eval_steps
    want = expected(counters, log_spectrogram=steps, **{
        name: steps if when == "steps" else train_steps
        for name, when in kernels.items()})
    print(f"{job} training main path: {train_steps} training + "
          f"{eval_steps} evaluation steps in {first_s:.2f} + "
          f"{second_s:.2f} s; launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    c = ckpt.load_checkpoint(path)
    cells = (c["encoder_init_parameters"]["rnn_type"],
             c["decoder_init_parameters"]["rnn_type"])
    if cells != (cell, cell):
        raise AssertionError(f"the {cell} checkpoint holds cells {cells}")
    if c["encoder_init_parameters"]["bidirectional"] == unidirectional:
        raise AssertionError(f"the {job} checkpoint's encoder direction")
    frozen = None
    if cell == "ESN":
        pairs = list(zip(_reservoir(before), _reservoir(c), strict=True))
        if not all(a.tobytes() == b.tobytes() for a, b in pairs):
            raise AssertionError("the ESN reservoir changed in training")
        frozen = len(pairs)
    epochs = first.epoch_seconds + second.epoch_seconds
    later = [n / sec for _, sec, n in epochs[1:]]
    return {"launches": launches, "train_steps": train_steps,
            "eval_steps": eval_steps, "checkpoint": path,
            "reservoir_tensors_unchanged": frozen,
            "segments_per_s_after_first_epoch":
                sum(later) / len(later) if later else None,
            "epochs": [{"epoch": e, "train_s": sec, "segments": n}
                       for e, sec, n in epochs]}


def cell_serve_phase(work: str, ckpt_path: str, rng, cell: str,
                     layer_kernel: str):
    """A checkpoint of another cell served through ``serve_main`` (probs
    at fs=32000, frame counts up to 512, 4 clients), counted: the
    encoder's kernel ``layer_kernel`` and the frontend run, no other
    kernel does."""
    counters = zero_counters()
    reqs = random_requests(rng, 32000, 32)
    (answers, latency), ping = run_service(
        [ckpt_path, str(NORMALIZER), "32000", "--mode", "probs", "-b",
         str(BATCH), "--stft_method", "pallas", "-d", "cuda"],
        os.path.join(work, f"{cell.lower()}.sock"),
        lambda path: concurrent_clients(path, reqs, 32000))
    check_answers(answers, "probs", K)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    if ran(launches) != {"log_spectrogram", layer_kernel}:
        raise AssertionError(f"{cell} serving launched {launches}")
    lat = np.asarray(latency)
    return {"launches": launches, "requests": len(lat),
            "batches": ping["stats"]["batches"],
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p90": float(np.percentile(lat, 90)),
            "latency_ms_max": float(lat.max())}


def _gru_library(dev, f, h, w):
    """The yardstick: cuDNN's bidirectional GRU with the same weights."""
    gru = torch.nn.GRU(f, h, bidirectional=True).to(dev)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            getattr(gru, "weight_ih_l0" + sfx).copy_(w[0][d].T)
            getattr(gru, "bias_ih_l0" + sfx).copy_(w[1][d])
            getattr(gru, "weight_hh_l0" + sfx).copy_(w[2][d].T)
            getattr(gru, "bias_hh_l0" + sfx).copy_(w[3][d])
    return gru


def gru_layer_phase(dev, rng, t_train, launches_fwd, launches_bwd):
    """The bidirectional GRU layer's kernels vs twins (ragged lengths, one
    empty row): the forward at the served shape B=64, T=512 and at the
    training shape B=512, T=``t_train``, the backward at the training
    shape; timed beside cuDNN's GRU on packed sequences (the empty row
    dropped)."""
    from seq2seq_abcd_vae_tpu_torch.ops import gru_kernel as gk
    f, h = 129, HIDDEN
    checks, cases = {}, {}
    for b, t in ((BATCH, 512), (TRAIN_BATCH, t_train)):
        lens = rng.integers(1, t + 1, size=b).astype(np.int32)
        lens[0], lens[-1] = t, 0
        x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32)
                             ).to(dev)
        w = _lstm_weights(rng, dev, h, (2, f, 3 * h), (2, 3 * h),
                          (2, h, 3 * h), (2, 3 * h))
        args = (x, torch.from_numpy(lens).to(dev), *w)
        got = gk.gru_layer_bidir_fused(*args)
        want = gk.gru_layer_bidir_fused_plain(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        checks[f"fwd_B{b}_T{t}"] = err
        if not err <= LSTM_ATOL:
            raise AssertionError(f"GRU forward vs twin at B={b} T={t}: "
                                 f"{err} > {LSTM_ATOL}")
        cases[b] = (t, lens, args, want)
    # the backward at the training shape
    t, lens, args, (outs, h_n) = cases[TRAIN_BATCH]
    dh_n = torch.from_numpy(rng.normal(size=h_n.shape).astype(np.float32)
                            ).to(dev)
    bwd = (*args, outs, None, dh_n)
    got = gk.gru_layer_bidir_fused_bwd(*bwd)
    want = gk.gru_layer_bidir_fused_bwd_plain(*bwd)
    torch.cuda.synchronize()
    errs = {n: rel_err(g, r) for n, g, r in zip(
        ("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"), got, want)}
    if max(errs.values()) > GRAD_FRACTION:
        raise AssertionError(f"GRU backward vs twin: {errs}")
    bwd_abs = max(max_err(g, r) for g, r in zip(got, want))
    bwd_ms = cuda_ms(lambda: gk.gru_layer_bidir_fused_bwd(*bwd), iters=5)
    bwd_plain_ms = cuda_ms(lambda: gk.gru_layer_bidir_fused_bwd_plain(*bwd),
                           iters=2, warmup=1)
    train_fwd_ms = cuda_ms(lambda: gk.gru_layer_bidir_fused(*args), iters=5)
    keep = lens > 0
    keep_dev = torch.from_numpy(keep).to(dev)
    gru = _gru_library(dev, f, h, args[2:])
    x_lib = args[0][:, keep_dev].clone().requires_grad_(True)
    lens_lib = torch.from_numpy(lens[keep].astype(np.int64))
    dh_lib = dh_n[:, keep_dev]

    def library_fwd_bwd():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x_lib, lens_lib, enforce_sorted=False)
        torch.autograd.backward(gru(packed)[1], dh_lib)

    lib_bwd_ms = cuda_ms(library_fwd_bwd, iters=5)
    steps = int(lens.sum())      # active row-steps per direction
    per = 2.0 * (f + h) * 3 * h  # one direction's gate products per row-step
    weights = 2 * (f + h + 2) * 3 * h
    # gates recomputed, dxp @ W_ih^T, dhg @ W_hh^T and the weight
    # gradients: three times the forward's products
    b = TRAIN_BATCH
    bwd_bytes = 4.0 * (t * b * f + weights + t * 2 * b * h     # x, W, outs
                       + 2 * b * h                              # dh_n
                       + t * b * f + weights) + 4 * b           # dx, dW
    b_bms, b_by = bound_ms(2 * steps * 3 * per, bwd_bytes)

    # the forward's entry at the served shape
    t, lens, args, want = cases[BATCH]
    b = BATCH
    fwd_ms = cuda_ms(lambda: gk.gru_layer_bidir_fused(*args), iters=5)
    fwd_plain_ms = cuda_ms(lambda: gk.gru_layer_bidir_fused_plain(*args),
                           iters=2, warmup=1)
    keep = lens > 0
    keep_dev = torch.from_numpy(keep).to(dev)
    gru = _gru_library(dev, f, h, args[2:])
    x_lib = args[0][:, keep_dev].contiguous()
    lens_lib = torch.from_numpy(lens[keep].astype(np.int64))

    @torch.no_grad()
    def library_fwd():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x_lib, lens_lib, enforce_sorted=False)
        return gru(packed)[1]

    lib_err = max_err(library_fwd(), want[1][:, keep_dev])
    lib_fwd_ms = cuda_ms(library_fwd, iters=5)
    steps = int(lens.sum())
    fwd_bytes = 4.0 * (t * b * f + weights + t * 2 * b * h
                       + 2 * b * h) + 4 * b
    f_bms, f_by = bound_ms(2 * steps * per, fwd_bytes)
    common = {"route": "cuda",
              "source": "seq2seq_abcd_vae_tpu_torch/csrc/gru.cu"}
    fwd_entry = dict(common, **{
        "name": "gru_layer_bidir_fused",
        "replaces": "seq2seq_abcd_vae_tpu/ops/gru_pallas.py:484",
        "launches": launches_fwd,
        "max_abs_err": max(v for k, v in checks.items()),
        "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": f_bms,
        "bound_by": f_by, "library_ms": lib_fwd_ms,
        "library_call": "nn.GRU(bidirectional) on a packed sequence",
        "library_max_abs_err": lib_err,
        "ms_at_training_shape": train_fwd_ms,
        "shape": f"T={t} B={b} F={f} H={h} (ragged, one empty row)",
        "tolerance": LSTM_ATOL, "checks": checks})
    bwd_entry = dict(common, **{
        "name": "gru_layer_bidir_fused_bwd",
        "helper_source": "seq2seq_abcd_vae_tpu_torch/csrc/wgrad.cu",
        "replaces": "seq2seq_abcd_vae_tpu/ops/gru_pallas.py:395",
        "launches": launches_bwd, "max_abs_err": bwd_abs,
        "max_rel_err": max(errs.values()), "rel_errs": errs,
        "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": b_bms,
        "bound_by": b_by, "library_ms": lib_bwd_ms,
        "library_call": "nn.GRU(bidirectional) forward + backward, packed",
        "shape": f"T={t_train} B={TRAIN_BATCH} F={f} H={h} (douts zero)",
        "tolerance": f"{GRAD_FRACTION} of each leaf's max |value|"})
    return fwd_entry, bwd_entry


def _rnn_library(dev, f, h, w):
    """The yardstick: cuDNN's bidirectional tanh RNN with the same
    weights."""
    rnn = torch.nn.RNN(f, h, nonlinearity="tanh", bidirectional=True).to(dev)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            getattr(rnn, "weight_ih_l0" + sfx).copy_(w[0][d].T)
            getattr(rnn, "bias_ih_l0" + sfx).copy_(w[1][d])
            getattr(rnn, "weight_hh_l0" + sfx).copy_(w[2][d].T)
            getattr(rnn, "bias_hh_l0" + sfx).copy_(w[3][d])
    return rnn


def elman_layer_phase(dev, rng, t_train, launches_fwd, launches_bwd):
    """The bidirectional Elman layer's kernels vs twins (ragged lengths,
    one empty row): the forward at the served shape B=64, T=512 and at the
    training shape B=512, T=``t_train``, each at leak 1.0 (the Elman cell)
    and 0.5 (an ESN's, zero biases); the backward at the training shape at
    both leaks; timed (leak 1.0) beside cuDNN's tanh RNN on packed
    sequences (the empty row dropped)."""
    from seq2seq_abcd_vae_tpu_torch.ops import elman_kernel as ek
    f, h = 129, HIDDEN
    checks, cases = {}, {}
    for b, t in ((BATCH, 512), (TRAIN_BATCH, t_train)):
        lens = rng.integers(1, t + 1, size=b).astype(np.int32)
        lens[0], lens[-1] = t, 0
        x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32)
                             ).to(dev)
        w = _lstm_weights(rng, dev, h, (2, f, h), (2, h), (2, h, h), (2, h))
        args = (x, torch.from_numpy(lens).to(dev), *w)
        zero_b = (x, args[1], w[0], torch.zeros_like(w[1]), w[2],
                  torch.zeros_like(w[3]))
        for leak, a in ((1.0, args), (0.5, zero_b)):
            got = ek.rnn_layer_bidir_fused(*a, leak)
            want = ek.rnn_layer_bidir_fused_plain(*a, leak)
            torch.cuda.synchronize()
            err = max_err(got, want)
            checks[f"fwd_B{b}_T{t}_leak{leak}"] = err
            if not err <= LSTM_ATOL:
                raise AssertionError(f"Elman forward vs twin at B={b} T={t} "
                                     f"leak {leak}: {err} > {LSTM_ATOL}")
            cases[(b, leak)] = (t, lens, a, want)
    # the backward at the training shape, both leaks
    bwd_errs = {}
    for leak in (0.5, 1.0):
        t, lens, args, (outs, h_n) = cases[(TRAIN_BATCH, leak)]
        dh_n = torch.from_numpy(rng.normal(size=h_n.shape).astype(
            np.float32)).to(dev)
        bwd = (*args, outs, None, dh_n, leak)
        got = ek.rnn_layer_bidir_fused_bwd(*bwd)
        want = ek.rnn_layer_bidir_fused_bwd_plain(*bwd)
        torch.cuda.synchronize()
        errs = {n: rel_err(g, r) for n, g, r in zip(
            ("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"), got, want)}
        if max(errs.values()) > GRAD_FRACTION:
            raise AssertionError(f"Elman backward vs twin, leak {leak}: "
                                 f"{errs}")
        bwd_errs[leak] = (errs, max(max_err(g, r)
                                    for g, r in zip(got, want)))
    errs, bwd_abs = bwd_errs[1.0]
    checks["bwd_leak0.5_max_rel_err"] = max(bwd_errs[0.5][0].values())
    bwd_ms = cuda_ms(lambda: ek.rnn_layer_bidir_fused_bwd(*bwd), iters=5)
    bwd_plain_ms = cuda_ms(
        lambda: ek.rnn_layer_bidir_fused_bwd_plain(*bwd), iters=2, warmup=1)
    train_fwd_ms = cuda_ms(lambda: ek.rnn_layer_bidir_fused(*args), iters=5)
    keep = lens > 0
    keep_dev = torch.from_numpy(keep).to(dev)
    rnn = _rnn_library(dev, f, h, args[2:])
    x_lib = args[0][:, keep_dev].clone().requires_grad_(True)
    lens_lib = torch.from_numpy(lens[keep].astype(np.int64))
    dh_lib = dh_n[:, keep_dev]

    def library_fwd_bwd():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x_lib, lens_lib, enforce_sorted=False)
        torch.autograd.backward(rnn(packed)[1], dh_lib)

    lib_bwd_ms = cuda_ms(library_fwd_bwd, iters=5)
    steps = int(lens.sum())      # active row-steps per direction
    per = 2.0 * (f + h) * h      # one direction's products per row-step
    weights = 2 * (f + h + 2) * h
    # u recomputed, dpre @ W_ih^T, dpre @ W_hh^T and the weight
    # gradients: three times the forward's products
    b = TRAIN_BATCH
    bwd_bytes = 4.0 * (t * b * f + weights + t * 2 * b * h     # x, W, outs
                       + 2 * b * h                              # dh_n
                       + t * b * f + weights) + 4 * b           # dx, dW
    b_bms, b_by = bound_ms(2 * steps * 3 * per, bwd_bytes)

    # the forward's entry at the served shape, leak 1.0
    t, lens, args, want = cases[(BATCH, 1.0)]
    b = BATCH
    fwd_ms = cuda_ms(lambda: ek.rnn_layer_bidir_fused(*args), iters=5)
    fwd_plain_ms = cuda_ms(lambda: ek.rnn_layer_bidir_fused_plain(*args),
                           iters=2, warmup=1)
    esn_ms = cuda_ms(lambda: ek.rnn_layer_bidir_fused(
        *cases[(BATCH, 0.5)][2], 0.5), iters=5)
    keep = lens > 0
    keep_dev = torch.from_numpy(keep).to(dev)
    rnn = _rnn_library(dev, f, h, args[2:])
    x_lib = args[0][:, keep_dev].contiguous()
    lens_lib = torch.from_numpy(lens[keep].astype(np.int64))

    @torch.no_grad()
    def library_fwd():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x_lib, lens_lib, enforce_sorted=False)
        return rnn(packed)[1]

    lib_err = max_err(library_fwd(), want[1][:, keep_dev])
    lib_fwd_ms = cuda_ms(library_fwd, iters=5)
    steps = int(lens.sum())
    fwd_bytes = 4.0 * (t * b * f + weights + t * 2 * b * h
                       + 2 * b * h) + 4 * b
    f_bms, f_by = bound_ms(2 * steps * per, fwd_bytes)
    common = {"route": "cuda",
              "source": "seq2seq_abcd_vae_tpu_torch/csrc/elman.cu"}
    fwd_entry = dict(common, **{
        "name": "rnn_layer_bidir_fused",
        "replaces": "seq2seq_abcd_vae_tpu/ops/elman_pallas.py:457",
        "launches": launches_fwd,
        "max_abs_err": max(checks[k] for k in checks if k.startswith("fwd")),
        "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": f_bms,
        "bound_by": f_by, "library_ms": lib_fwd_ms,
        "library_call": "nn.RNN(tanh, bidirectional) on a packed sequence",
        "library_max_abs_err": lib_err,
        "ms_at_training_shape": train_fwd_ms, "ms_at_leak_0.5": esn_ms,
        "shape": f"T={t} B={b} F={f} H={h} (ragged, one empty row)",
        "tolerance": LSTM_ATOL, "checks": checks})
    bwd_entry = dict(common, **{
        "name": "rnn_layer_bidir_fused_bwd",
        "helper_source": "seq2seq_abcd_vae_tpu_torch/csrc/wgrad.cu",
        "replaces": "seq2seq_abcd_vae_tpu/ops/elman_pallas.py:368",
        "launches": launches_bwd, "max_abs_err": bwd_abs,
        "max_rel_err": max(errs.values()), "rel_errs": errs,
        "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": b_bms,
        "bound_by": b_by, "library_ms": lib_bwd_ms,
        "library_call":
            "nn.RNN(tanh, bidirectional) forward + backward, packed",
        "shape": f"T={t_train} B={TRAIN_BATCH} F={f} H={h} (douts zero)",
        "tolerance": f"{GRAD_FRACTION} of each leaf's max |value|"})
    return fwd_entry, bwd_entry


# ---------------------------------------------------------------------------
# the unidirectional GRU / Elman / ESN slice: one-direction layers over a
# projected input and the GRU and Elman / ESN sampled loops
# ---------------------------------------------------------------------------

def _one_direction_fns(cell):
    """(forward, twin, backward, twin, extra arguments by leak) of the
    one-direction layer of ``cell`` (GRU, or RNN for the Elman / ESN
    layer)."""
    from seq2seq_abcd_vae_tpu_torch.ops import elman_kernel as ek
    from seq2seq_abcd_vae_tpu_torch.ops import gru_kernel as gk
    if cell == "GRU":
        return (gk.gru_layer, gk.gru_layer_plain, gk.gru_layer_bwd,
                gk.gru_layer_bwd_plain, lambda leak: ())
    return (ek.rnn_layer, ek.rnn_layer_plain, ek.rnn_layer_bwd,
            ek.rnn_layer_bwd_plain, lambda leak: (leak,))


def _library_layer(dev, cell, f, h, w_ih, b_ih, w_hh, b_hh):
    """The yardstick: cuDNN's unidirectional GRU or tanh RNN with the same
    weights (it also computes the input projection, which the kernel is
    handed)."""
    if cell == "GRU":
        net = torch.nn.GRU(f, h).to(dev)
    else:
        net = torch.nn.RNN(f, h, nonlinearity="tanh").to(dev)
    with torch.no_grad():
        net.weight_ih_l0.copy_(w_ih.T)
        net.bias_ih_l0.copy_(b_ih)
        net.weight_hh_l0.copy_(w_hh.T)
        net.bias_hh_l0.copy_(b_hh)
    return net


def one_direction_layer_phase(dev, rng, t_train, cell, launches_fwd,
                              launches_bwd):
    """The one-direction GRU or Elman / ESN layer's kernels over a projected
    input (``gru_layer``, ``rnn_layer``) vs twins at the training shape
    B=512, T=``t_train`` (ragged lengths, one empty row), in both span
    directions (xp flipped for ``reverse``, as models/rnn does), the Elman
    layer at leak 1.0 and 0.5 (zero biases); the backward without an outs
    cotangent (the main path's single layer) and with one; timed (forward
    span, leak 1.0, no outs cotangent) beside cuDNN's unidirectional layer
    on packed sequences (the empty row dropped)."""
    fwd, fwd_plain, bwd, bwd_plain, extra = _one_direction_fns(cell)
    f, h, b, t = 129, HIDDEN, TRAIN_BATCH, t_train
    g = (3 if cell == "GRU" else 1) * h
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[0], lens[-1] = t, 0
    lengths = torch.from_numpy(lens).to(dev)
    x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32)
                         ).to(dev)
    w_ih, b_ih, w_hh, b_hh = _lstm_weights(rng, dev, h, (f, g), (g,), (h, g),
                                           (g,))
    checks, timed = {}, None
    for leak in ((1.0,) if cell == "GRU" else (1.0, 0.5)):
        bi, bh = ((b_ih, b_hh) if leak == 1.0
                  else (torch.zeros_like(b_ih), torch.zeros_like(b_hh)))
        xp = torch.matmul(x, w_ih) + bi      # the hoisted projection
        for reverse in (False, True):
            args = (xp.flip(0).contiguous() if reverse else xp.contiguous(),
                    lengths, w_hh, bh)
            got = fwd(*args, reverse, *extra(leak))
            want = fwd_plain(*args, reverse, *extra(leak))
            torch.cuda.synchronize()
            key = f"rev{int(reverse)}_leak{leak}"
            checks["fwd_" + key] = max_err(got, want)
            if not checks["fwd_" + key] <= LSTM_ATOL:
                raise AssertionError(f"{cell} one-direction layer vs twin "
                                     f"{key}: {checks['fwd_' + key]}")
            outs, h_n = want
            dh_n = torch.from_numpy(rng.normal(size=(b, h)).astype(
                np.float32)).to(dev)
            douts = (torch.from_numpy(rng.normal(size=(t, b, h)).astype(
                np.float32)).to(dev) if reverse else None)
            bwd_args = (*args, outs, douts, dh_n, reverse, *extra(leak))
            g_all = bwd(*bwd_args)
            r_all = bwd_plain(*bwd_args)
            torch.cuda.synchronize()
            rel = {n: rel_err(a, r) for n, a, r in zip(
                ("dxp", "dw_hh", "db_hh"), g_all, r_all)}
            checks["bwd_" + key] = max(rel.values())
            if checks["bwd_" + key] > GRAD_FRACTION:
                raise AssertionError(f"{cell} one-direction backward vs twin "
                                     f"{key}: {rel}")
            if (leak, reverse) == (1.0, False):
                timed = (args, want, bwd_args, max(
                    max_err(a, r) for a, r in zip(g_all, r_all)))
    args, want, bwd_args, bwd_abs = timed
    fwd_ms = cuda_ms(lambda: fwd(*args), iters=5)
    fwd_plain_ms = cuda_ms(lambda: fwd_plain(*args), iters=2, warmup=1)
    bwd_ms = cuda_ms(lambda: bwd(*bwd_args), iters=5)
    bwd_plain_ms = cuda_ms(lambda: bwd_plain(*bwd_args), iters=2, warmup=1)
    # where the backward's time goes: the reverse-time kernel vs the
    # weight-gradient reductions and copies around it
    bwd_by_kernel = device_ms_by_kernel(lambda: bwd(*bwd_args))
    net = _library_layer(dev, cell, f, h, w_ih, b_ih, w_hh, b_hh)
    keep = lens > 0
    keep_dev = torch.from_numpy(keep).to(dev)
    x_lib = x[:, keep_dev].contiguous()
    x_grad = x_lib.clone().requires_grad_(True)
    lens_lib = torch.from_numpy(lens[keep].astype(np.int64))
    dh_lib = bwd_args[6][keep_dev][None]

    @torch.no_grad()
    def library_fwd():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x_lib, lens_lib, enforce_sorted=False)
        return net(packed)[1]

    def library_fwd_bwd():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x_grad, lens_lib, enforce_sorted=False)
        torch.autograd.backward(net(packed)[1], dh_lib)

    lib_err = max_err(library_fwd()[0], want[1][keep_dev])
    lib_fwd_ms = cuda_ms(library_fwd, iters=5)
    lib_bwd_ms = cuda_ms(library_fwd_bwd, iters=5)
    steps = int(lens.sum())  # active row-steps
    per = 2.0 * h * g        # h @ W_hh per row-step
    fwd_bytes = 4.0 * (t * b * g + h * g + g                  # xp, W, b
                       + t * b * h + b * h) + 4 * b           # outs, h_n
    bwd_bytes = 4.0 * (t * b * g + h * g + g + t * b * h      # xp, W, b, outs
                       + b * h                                # dh_n
                       + t * b * g + h * g + g) + 4 * b       # dxp, dW, db
    f_bms, f_by = bound_ms(steps * per, fwd_bytes)
    # gates recomputed, the adjoint's product with W_hh^T and h_prev^T dhg:
    # three times the forward's products
    b_bms, b_by = bound_ms(3 * steps * per, bwd_bytes)
    name = "gru_layer" if cell == "GRU" else "rnn_layer"
    source, lines = (("gru.cu", (146, 180)) if cell == "GRU"
                     else ("elman.cu", (111, 146)))
    pallas = "gru_pallas.py" if cell == "GRU" else "elman_pallas.py"
    library = "nn.GRU" if cell == "GRU" else "nn.RNN(tanh)"
    common = {"route": "cuda",
              "source": f"seq2seq_abcd_vae_tpu_torch/csrc/{source}",
              "shape": f"T={t} B={b} H={h} (xp given; ragged, one empty "
                       "row)"}
    fwd_entry = dict(common, **{
        "name": name,
        "replaces": f"seq2seq_abcd_vae_tpu/ops/{pallas}:{lines[0]}",
        "launches": launches_fwd,
        "max_abs_err": max(v for k, v in checks.items()
                           if k.startswith("fwd")),
        "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": f_bms,
        "bound_by": f_by, "library_ms": lib_fwd_ms,
        "library_call": f"{library} (unidirectional) forward, packed",
        "library_max_abs_err": lib_err,
        "tolerance": LSTM_ATOL, "checks": checks})
    bwd_entry = dict(common, **{
        "name": name + "_bwd",
        "helper_source": "seq2seq_abcd_vae_tpu_torch/csrc/wgrad.cu",
        "replaces": f"seq2seq_abcd_vae_tpu/ops/{pallas}:{lines[1]}",
        "launches": launches_bwd, "max_abs_err": bwd_abs,
        "max_rel_err": max(v for k, v in checks.items()
                           if k.startswith("bwd")),
        "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": b_bms,
        "bound_by": b_by, "library_ms": lib_bwd_ms,
        "library_call": f"{library} (unidirectional) forward + backward, "
                        "packed",
        "device_ms_by_kernel": bwd_by_kernel,
        "tolerance": f"{GRAD_FRACTION} of each leaf's max |value|"})
    return fwd_entry, bwd_entry


def _loop_args(full, cell):
    """The sampled loop's arguments from the fused-loss decoder's (the
    targets and the offset MLP dropped)."""
    return full[:10] + full[15:] if cell == "GRU" else full[:9] + full[14:]


def cell_loop_phase(dev, rng, cell, launches):
    """The GRU or Elman / ESN sampled decoder loop (``gru_decoder_loop``,
    ``rnn_decoder_loop``) vs its twin at the decode shape B=128, T=124
    (the corpus's validation segments) and B=64, T=512, the Elman loop at
    leak 1.0 and 0.5 (a zero bias); timed at the decode shape, leak 1.0."""
    import functools
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    h, m, f = HIDDEN, MLP_HIDDEN, 129
    name = "gru_decoder_loop" if cell == "GRU" else "rnn_decoder_loop"
    checks, timed = {}, None
    for b, t in ((128, 124), (BATCH, 512)):
        for leak in ((1.0,) if cell == "GRU" else (1.0, 0.5)):
            full, lens = _decoder_kernel_args(dev, rng, t, b, cell=cell,
                                              leak=leak)
            args = _loop_args(full, cell)
            fwd, plain = getattr(dk, name), getattr(dk, name + "_plain")
            if cell == "RNN":
                fwd = functools.partial(fwd, leak=leak)
                plain = functools.partial(plain, leak=leak)
            got = fwd(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            key = f"B{b}_T{t}_leak{leak}"
            checks[key] = max_err(got, want)
            if not checks[key] <= LSTM_ATOL:
                raise AssertionError(f"{name} vs twin {key}: {checks[key]}")
            if timed is None:
                timed = (b, t, fwd, plain, args)
    b, t, fwd, plain, args = timed
    ms = cuda_ms(lambda: fwd(*args), iters=5)
    plain_ms = cuda_ms(lambda: plain(*args), iters=2, warmup=1)
    # per row-step: h @ w_cat, the emission's second layer (mean and
    # logvar) and the fed-back x @ w_ih; every step of every row runs
    gh = (3 if cell == "GRU" else 1) * h
    per = 2.0 * (h * (gh + 2 * m) + 2 * m * f + f * gh)
    weights = (h * (gh + 2 * m) + (2 if cell == "GRU" else 1) * gh + 2 * m
               + 2 * m * f + 2 * f + f * gh)
    nbytes = 4.0 * (t * b * f + weights + b * h               # inputs
                    + t * b * h) + 4 * b                      # outs
    bms, by = bound_ms(t * b * per, nbytes)
    line = 582 if cell == "GRU" else 1205
    return {"name": name, "route": "cuda",
            "source": "seq2seq_abcd_vae_tpu_torch/csrc/decoder.cu",
            "replaces": f"seq2seq_abcd_vae_tpu/ops/decoder_pallas.py:{line}",
            "launches": launches, "max_abs_err": max(checks.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None,
            "library_call": "none: no single PyTorch call runs the sampled "
                            "loop",
            "shape": f"T={t} B={b} F={f} H={h} m={m} (ragged, one empty "
                     "row)",
            "tolerance": LSTM_ATOL, "checks": checks}


# ---------------------------------------------------------------------------
# the stream slice: the decoder's unfused training path, the sampled loops'
# backwards and the fused-NLL LSTM loop
# ---------------------------------------------------------------------------

# the CLI runs of the stream path: the cell, the JAX package's switch in the
# environment, the extra flags
STREAM_RUNS = (("LSTM", {"SEQ2SEQ_NLL_FUSION": "0"}, ()),
               ("GRU", {"SEQ2SEQ_FUSED_CELLS": ""}, ()),
               ("ESN", {"SEQ2SEQ_FUSED_CELLS": "GRU,RNN"},
                ("--esn_leak", "0.5")))
# each cell's bidirectional encoder layer and sampled decoder loop
LAYER_OF = {"LSTM": "lstm_layer_bidir_fused", "GRU": "gru_layer_bidir_fused",
            "RNN": "rnn_layer_bidir_fused", "ESN": "rnn_layer_bidir_fused"}
LOOP_OF = {"LSTM": "decoder_loop", "GRU": "gru_decoder_loop",
           "RNN": "rnn_decoder_loop", "ESN": "rnn_decoder_loop"}


def environment(env: dict):
    """Context: ``os.environ`` holds ``env`` inside, restored after."""
    import contextlib

    @contextlib.contextmanager
    def scoped():
        before = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            yield
        finally:
            for k, v in before.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return scoped()


def stream_train_phase(dev, work: str, corpus_dir: str, csv_path: str,
                       seed: int, cell: str, env: dict, extra=()):
    """The training CLI with the JAX package's switch ``env`` in the
    environment (``-R cell``: its bidirectional encoder and decoder; 2
    epochs, 1 of pretraining), counted: the frontend and the encoder layer
    once per step (its backward per training step, none under the ESN's
    frozen reservoir), the cell's sampled loop once per step and its
    backward once per training step; no fused-loss kernel."""
    from seq2seq_abcd_vae_tpu_torch.cli import learning_main
    job = f"stream-{cell.lower()}"
    argv = [corpus_dir, csv_path, "-S", work, "-j", job, "-b",
            str(TRAIN_BATCH), "--pretrain_epochs", "1", "--stft_method",
            "pallas", "-d", dev.type, "-N", str(NORMALIZER), "-s", str(seed),
            "-R", cell, *extra, "-e", "2",
            "--encoder_rnn_hidden_size", str(HIDDEN),
            "--decoder_rnn_hidden_size", str(HIDDEN),
            "--mlp_hidden_size", str(MLP_HIDDEN), "-K", str(K),
            "-f", str(FEATURE_DIM), "--speaker_embed_dim", str(SPEAKER_EMBED)]
    counters = zero_counters()
    t0 = time.perf_counter()
    with environment(env):
        run = learning_main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_history(os.path.join(work, job, "history.log"), False)
    launches = {name: fn.launches for name, fn in counters.items()}
    train_steps, eval_steps = run.steps["train"], run.steps["eval"]
    steps = train_steps + eval_steps
    layer, loop = LAYER_OF[cell], LOOP_OF[cell]
    want = expected(counters, log_spectrogram=steps, **{
        layer: steps, loop: steps, loop + "_bwd": train_steps},
        **({} if cell == "ESN" else {layer + "_bwd": train_steps}))
    print(f"{job} training main path ({env}): {train_steps} training + "
          f"{eval_steps} evaluation steps in {wall:.2f} s; launches "
          f"{launches}", flush=True)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    later = [n / sec for _, sec, n in run.epoch_seconds[1:]]
    return {"launches": launches, "env": env, "train_steps": train_steps,
            "eval_steps": eval_steps,
            "segments_per_s_after_first_epoch":
                sum(later) / len(later) if later else None,
            "epochs": [{"epoch": e, "train_s": sec, "segments": n}
                       for e, sec, n in run.epoch_seconds]}


def nll_phase(dev, ckpt_path: str, corpus_dir: str, csv_path: str,
              seed: int):
    """The LSTM decoder's loss-only call without offset targets (the JAX
    package's ``decoder_apply(loss_only=True, ground_truth_offset=None)``:
    ``models/decoder.decoder_losses(..., with_offset=False)``) on a trained
    checkpoint, over the corpus's validation segments (their features from
    the encoder, their spectrograms as targets), with the gradient of the
    emission NLL plus the caller's offset BCE of the returned logits;
    counted: one fused-NLL forward and one backward launch, nothing else.
    Held on the card to the fused-losses call (the offset BCE in-kernel) on
    the same weights and noise, and to the same call on the CPU's twins."""
    from seq2seq_abcd_vae_tpu_torch.data.annotations import AnnotationParser
    from seq2seq_abcd_vae_tpu_torch.data.batching import (DataLoader,
                                                          FrontendSpec)
    from seq2seq_abcd_vae_tpu_torch.infer.decode import load_model
    from seq2seq_abcd_vae_tpu_torch.infer.encode import Encoder, encode_step
    from seq2seq_abcd_vae_tpu_torch.models import decoder as dec_mod
    from seq2seq_abcd_vae_tpu_torch.train import learner as L
    from seq2seq_abcd_vae_tpu_torch.tree import tree_leaves, tree_map
    spec = FrontendSpec(int(0.008 * TRAIN_FS), int(0.004 * TRAIN_FS))
    valid = AnnotationParser(corpus_dir, csv_path).get_data("valid")
    batch = next(iter(DataLoader(valid, spec, batch_size=len(valid))))
    enc = Encoder(ckpt_path, device=dev.type, stft_method="pallas")
    statics = enc.statics(spec, EPSILON, NORMALIZER)
    audio = torch.from_numpy(batch.audio).to(dev)
    lengths = torch.from_numpy(batch.num_frames).to(dev)
    t = batch.bucket_frames
    feats = encode_step(enc.params, audio, lengths, statics, t, "features")
    inputs = L.frontend(statics, audio, t)
    params, cfg = load_model(ckpt_path, dev.type)
    speakers = torch.from_numpy(batch.speakers).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((t, len(lengths), cfg.decoder.output_size),
                        generator=gen, device=dev)
    steps = torch.arange(t, device=dev)[None, :]
    mask = (steps < lengths[:, None]).float()
    y = (steps == lengths[:, None] - 1).float()

    def run(device, with_offset):
        dec = tree_map(lambda p: p.detach().to(device).clone()
                       .requires_grad_(True), params["decoder"])
        em, z = dec_mod.decoder_losses(
            dec, cfg.decoder, feats.to(device), lengths.to(device),
            inputs.to(device), noise.to(device), speakers.to(device),
            with_offset=with_offset)
        if not with_offset:  # the caller's BCE of the offset logits
            per = (torch.clamp(z, min=0.0) - z * y.to(device)
                   + torch.log1p(torch.exp(-torch.abs(z))))
            z = (per * mask.to(device)).sum()
        loss = em + z
        loss.backward()
        return loss.detach(), [p.grad for p in tree_leaves(dec)]

    counters = zero_counters()
    card = run(dev, False)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    want = expected(counters, decoder_loop_fused_nll_fwd=1,
                    decoder_loop_fused_nll_bwd=1)
    if launches != want:
        raise AssertionError(f"loss-only call launched {launches}, expected "
                             f"{want}")
    errs = {}
    for where, (loss, grads) in (("fused_losses_card", run(dev, True)),
                                 ("cpu_twins", run(torch.device("cpu"),
                                                   False))):
        errs[f"loss_rel_vs_{where}"] = abs(
            card[0].item() - loss.item()) / abs(loss.item())
        errs[f"grad_max_rel_vs_{where}"] = max(
            rel_err(g, r) for g, r in zip(card[1], grads))
    bad = {k: v for k, v in errs.items()
           if v > (LOSS_RTOL if k.startswith("loss") else GRAD_FRACTION)}
    if bad or not math.isfinite(card[0].item()):
        raise AssertionError(f"loss-only call without offsets: {errs}")
    ms = cuda_ms(lambda: run(dev, False), iters=3, warmup=1)
    return {"launches": launches, "rows": len(lengths), "T": t,
            "loss": card[0].item(), "errors": errs,
            "ms_forward_and_backward": ms}


def _loop_fns(cell):
    """(forward with saved carries, its twin, backward, its twin) of the
    sampled loop of ``cell`` (LSTM, GRU or the Elman loop)."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    loop = LOOP_OF[cell]
    return (getattr(dk, loop + "_fwd"), getattr(dk, loop + "_plain"),
            getattr(dk, loop + "_bwd"), getattr(dk, loop + "_bwd_plain"))


def _loop_backward_check(dev, rng, t, b, cell, leak=1.0, h=HIDDEN):
    """A sampled loop's forward kernel (saving the carries) and backward
    kernel against their twins, with ragged lengths and one empty row:
    (backward arguments, lengths, carries' error, gradients' errors, the
    gradients of both); raises past the tolerances."""
    fwd, fwd_plain, bwd, bwd_plain = _loop_fns(cell)
    full, lens = _decoder_kernel_args(dev, rng, t, b, h=h, cell=cell,
                                      leak=leak)
    args = _loop_args(full, cell)
    kw = {"leak": leak} if cell == "RNN" else {}
    got = fwd(*args, **kw)
    want = fwd_plain(*args, **kw, return_carries=True)
    if cell == "LSTM":
        got = got[:1] + got[3:]  # outs, hs, cs (the streams are checked
        want = want[:1] + want[3:]  # by decoder_loop_phase)
    carry_err = max_err(tuple(got), tuple(want))
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(dev)
    f = args[0].shape[2]
    cots = [normal(t, b, h)] + ([normal(t, b, f), normal(t, b, f)]
                                if cell == "LSTM" else [])
    bwd_args = (*args, *want[1:], *cots)
    g_all = bwd(*bwd_args, **kw)
    r_all = bwd_plain(*bwd_args, **kw)
    torch.cuda.synchronize()
    errs = [rel_err(g, r) for g, r in zip(g_all, r_all)]
    if not (carry_err <= LSTM_ATOL and max(errs) <= GRAD_FRACTION):
        raise AssertionError(f"{cell} loop backward (leak {leak}) vs twin: "
                             f"carries {carry_err}, gradients {errs}")
    return bwd_args, lens, carry_err, errs, g_all, r_all


def loop_backward_phase(dev, rng, t, cell, launches):
    """The sampled loop's backward of ``cell`` (LSTM, GRU, or the Elman
    loop, also checked at the ESN's leak 0.5) vs its twin at the training
    shape, from the forward kernel's saved carries (held to the twin's),
    with its time and bound (no single library call runs the loop's
    adjoint: each step's input is the sample the step before fed back)."""
    import functools
    b, h, m, f = TRAIN_BATCH, HIDDEN, MLP_HIDDEN, 129
    bwd_args, lens, carry_err, errs, g_all, r_all = _loop_backward_check(
        dev, rng, t, b, cell)
    checks = {"saved_carries_max_abs_err": carry_err}
    if cell == "RNN":
        esn = _loop_backward_check(dev, rng, t, b, cell, leak=0.5)
        checks["esn_leak_0.5"] = {"saved_carries_max_abs_err": esn[2],
                                  "grad_max_rel_err": max(esn[3])}
    _, _, bwd, bwd_plain = _loop_fns(cell)
    if cell == "RNN":
        bwd = functools.partial(bwd, leak=1.0)
        bwd_plain = functools.partial(bwd_plain, leak=1.0)
    ms = cuda_ms(lambda: bwd(*bwd_args), iters=3)
    plain_ms = cuda_ms(lambda: bwd_plain(*bwd_args), iters=2, warmup=1)
    by_kernel = device_ms_by_kernel(lambda: bwd(*bwd_args))
    # per row-step: h @ w_cat, the emission's second layer and the fed-back
    # x @ w_ih, recomputed, then their adjoint products and the weight
    # gradients (three times the forward's products)
    gh = {"LSTM": 4, "GRU": 3, "RNN": 1}[cell] * h
    n_state = 2 if cell == "LSTM" else 1
    per = 2.0 * (h * (gh + 2 * m) + 2 * m * f + f * gh)
    weights = (h * (gh + 2 * m) + (2 if cell == "GRU" else 1) * gh + 2 * m
               + 2 * m * f + 2 * f + f * gh)
    nbytes = 4.0 * (t * b * f + weights + n_state * b * h     # inputs
                    + n_state * t * b * h + t * b * h         # carries, douts
                    + (2 * t * b * f if cell == "LSTM" else 0)
                    + weights + n_state * b * h) + 4 * b      # gradients
    bms, by = bound_ms(3 * int(lens.sum()) * per, nbytes)
    line = {"LSTM": 337, "GRU": 606, "RNN": 1229}[cell]
    return {"name": LOOP_OF[cell] + "_bwd", "route": "cuda",
            "source": "seq2seq_abcd_vae_tpu_torch/csrc/decoder.cu",
            "helper_source": "seq2seq_abcd_vae_tpu_torch/csrc/wgrad.cu",
            "replaces": f"seq2seq_abcd_vae_tpu/ops/decoder_pallas.py:{line}",
            "launches": launches,
            "max_abs_err": max(max_err(g, r) for g, r in zip(g_all, r_all)),
            "max_rel_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "library_call": "none: no single PyTorch call runs the sampled "
                            "loop's adjoint",
            "shape": f"T={t} B={b} F={f} H={h} m={m} (ragged, one empty "
                     "row)",
            "tolerance": f"{GRAD_FRACTION} of each leaf's max |value|; "
                         f"carries {LSTM_ATOL}", "checks": checks,
            "device_ms_by_kernel": by_kernel}


def _fused_nll_check(dev, rng, t, b, h=HIDDEN):
    """The fused-NLL forward and backward kernels against their twins:
    (forward args, backward args, lengths, forward errors, gradient
    errors, the gradients of both); raises past the tolerances or when
    the forward's nll does not repeat bit for bit."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    full, lens = _decoder_kernel_args(dev, rng, t, b, h=h)
    args = full[:10] + full[14:]  # no offset MLP
    got = dk.decoder_fused_nll_fwd(*args)
    want = dk.decoder_fused_nll_fwd_plain(*args)
    again = dk.decoder_fused_nll_fwd(*args)
    torch.cuda.synchronize()
    fwd_errs = {"nll_rel_err": abs(got[1].item() - want[1].item())
                / abs(want[1].item()),
                "outs_carries_max_abs_err": max_err(
                    (got[0],) + got[2:], (want[0],) + want[2:])}
    if not (fwd_errs["nll_rel_err"] <= LOSS_RTOL
            and fwd_errs["outs_carries_max_abs_err"] <= LSTM_ATOL
            and again[1].item() == got[1].item()):
        raise AssertionError(f"fused-NLL forward vs twin: {fwd_errs}, "
                             f"repeat {again[1].item()} vs {got[1].item()}")
    douts = torch.from_numpy(rng.normal(size=(t, b, h)).astype(
        np.float32)).to(dev)
    bwd_args = (*args, want[2], want[3], douts,
                torch.tensor([1.0 / 511], device=dev))
    g_all = dk.decoder_fused_nll_bwd(*bwd_args)
    r_all = dk.decoder_fused_nll_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    errs = [rel_err(g, r) for g, r in zip(g_all, r_all)]
    if max(errs) > GRAD_FRACTION:
        raise AssertionError(f"fused-NLL backward vs twin: {errs}")
    return args, bwd_args, lens, fwd_errs, errs, g_all, r_all, got, want


def fused_nll_kernel_phase(dev, rng, t, launches_fwd, launches_bwd):
    """The LSTM loop with the emission NLL fused (decoder_loop_fused_nll)
    vs its twins at the training shape, forward and backward, with their
    times and bounds."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    b, h, m, f = TRAIN_BATCH, HIDDEN, MLP_HIDDEN, 129
    args, bwd_args, lens, fwd_errs, errs, g_all, r_all, got, want = (
        _fused_nll_check(dev, rng, t, b))
    fwd_ms = cuda_ms(lambda: dk.decoder_fused_nll_fwd(*args), iters=5)
    fwd_plain_ms = cuda_ms(lambda: dk.decoder_fused_nll_fwd_plain(*args),
                           iters=2, warmup=1)
    bwd_ms = cuda_ms(lambda: dk.decoder_fused_nll_bwd(*bwd_args), iters=3)
    bwd_plain_ms = cuda_ms(lambda: dk.decoder_fused_nll_bwd_plain(
        *bwd_args), iters=2, warmup=1)
    by_kernel = device_ms_by_kernel(lambda: dk.decoder_fused_nll_bwd(
        *bwd_args))
    gh = 4 * h
    per = 2.0 * (h * (gh + 2 * m) + 2 * m * f + f * gh)
    steps = int(lens.sum())
    weights = (h * (gh + 2 * m) + gh + 2 * m + 2 * m * f + 2 * f + f * gh)
    fwd_bytes = 4.0 * (2 * t * b * f + weights + 2 * b * h      # inputs
                       + 3 * t * b * h + 1) + 4 * b             # outs, carries
    bwd_bytes = 4.0 * (2 * t * b * f + weights + 2 * b * h + 3 * t * b * h
                       + 1 + weights + 2 * b * h) + 4 * b
    f_bms, f_by = bound_ms(steps * per, fwd_bytes)
    b_bms, b_by = bound_ms(3 * steps * per, bwd_bytes)
    common = {"route": "cuda",
              "source": "seq2seq_abcd_vae_tpu_torch/csrc/decoder.cu",
              "library_ms": None,
              "library_call": "none: no single PyTorch call runs this loop",
              "shape": f"T={t} B={b} F={f} H={h} m={m} (ragged, one empty "
                       "row)"}
    fwd_entry = dict(common, **{
        "name": "decoder_loop_fused_nll",
        "replaces": "seq2seq_abcd_vae_tpu/ops/decoder_pallas.py:2129",
        "launches": launches_fwd,
        "max_abs_err": max(fwd_errs["outs_carries_max_abs_err"],
                           abs(got[1].item() - want[1].item())),
        "checks": fwd_errs, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
        "bound_ms": f_bms, "bound_by": f_by,
        "tolerance": f"nll {LOSS_RTOL} relative, outs and carries "
                     f"{LSTM_ATOL}"})
    bwd_entry = dict(common, **{
        "name": "decoder_loop_fused_nll_bwd",
        "helper_source": "seq2seq_abcd_vae_tpu_torch/csrc/wgrad.cu",
        "replaces": "seq2seq_abcd_vae_tpu/ops/decoder_pallas.py:2147",
        "launches": launches_bwd,
        "max_abs_err": max(max_err(g, r) for g, r in zip(g_all, r_all)),
        "max_rel_err": max(errs), "ms": bwd_ms, "plain_ms": bwd_plain_ms,
        "bound_ms": b_bms, "bound_by": b_by, "device_ms_by_kernel": by_kernel,
        "tolerance": f"{GRAD_FRACTION} of each leaf's max |value|"})
    return fwd_entry, bwd_entry


def wide_hidden_phase(dev, rng):
    """Hidden size 1024 (the widest the JAX CLI takes) through every
    recurrent kernel with the row tile its shared memory allows, against
    the twins, at small B and T."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    from seq2seq_abcd_vae_tpu_torch.ops import elman_kernel as ek
    from seq2seq_abcd_vae_tpu_torch.ops import gru_kernel as gk
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    h, f, m, b, t = 1024, 129, MLP_HIDDEN, 24, 16
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[0], lens[-1] = t, 0
    lengths = torch.from_numpy(lens).to(dev)
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(dev)
    errs = {}
    w = _lstm_weights(rng, dev, h, (2, f, 4 * h), (2, 4 * h), (2, h, 4 * h),
                      (2, 4 * h))
    x = normal(t, b, f)
    got = lk.lstm_layer_bidir_fused(x, lengths, *w, return_cs=True)
    ref = lk.lstm_layer_bidir_fused_plain(x, lengths, *w, return_cs=True)
    errs["bidir_fwd"] = max_err(got, ref)
    bwd = (x, lengths, *w, ref[0], ref[3], None, normal(2, b, h),
           normal(2, b, h))
    errs["bidir_bwd_rel"] = max(rel_err(g, r) for g, r in zip(
        lk.lstm_layer_bidir_fused_bwd(*bwd),
        lk.lstm_layer_bidir_fused_bwd_plain(*bwd)))
    w_hh, b_hh = _lstm_weights(rng, dev, h, (h, 4 * h), (4 * h,))
    xp = normal(t, b, 4 * h)
    got = lk.lstm_layer(xp, lengths, w_hh, b_hh, False, True)
    ref = lk.lstm_layer_plain(xp, lengths, w_hh, b_hh, False, True)
    errs["uni_fwd"] = max_err(got, ref)
    bwd = (xp, lengths, w_hh, b_hh, ref[0], ref[3], None, normal(b, h),
           normal(b, h))
    errs["uni_bwd_rel"] = max(rel_err(g, r) for g, r in zip(
        lk.lstm_layer_bwd(*bwd), lk.lstm_layer_bwd_plain(*bwd)))
    args, _ = _decoder_kernel_args(dev, rng, t, b, h=h)
    got = dk.decoder_fused_losses_fwd(*args)
    ref = dk.decoder_fused_losses_fwd_plain(*args)
    errs["decoder_fwd_loss_rel"] = max(
        abs(g.item() - r.item()) / abs(r.item())
        for g, r in zip(got[1:3], ref[1:3]))
    errs["decoder_fwd_states"] = max_err((got[0], got[3], got[4]),
                                         (ref[0], ref[3], ref[4]))
    bwd = (*args, ref[3], ref[4], normal(b, h),
           torch.tensor([0.5, 0.5], device=dev))
    errs["decoder_bwd_rel"] = max(rel_err(g, r) for g, r in zip(
        dk.decoder_fused_losses_bwd(*bwd),
        dk.decoder_fused_losses_bwd_plain(*bwd)))
    loop = args[:9] + args[14:]
    errs["decoder_loop"] = max_err(dk.decoder_loop(*loop),
                                   dk.decoder_loop_plain(*loop))
    w = _lstm_weights(rng, dev, h, (2, f, 3 * h), (2, 3 * h), (2, h, 3 * h),
                      (2, 3 * h))
    got = gk.gru_layer_bidir_fused(x, lengths, *w)
    ref = gk.gru_layer_bidir_fused_plain(x, lengths, *w)
    errs["gru_fwd"] = max_err(got, ref)
    bwd = (x, lengths, *w, ref[0], normal(*ref[0].shape), normal(2, b, h))
    errs["gru_bwd_rel"] = max(rel_err(g, r) for g, r in zip(
        gk.gru_layer_bidir_fused_bwd(*bwd),
        gk.gru_layer_bidir_fused_bwd_plain(*bwd)))
    args, _ = _decoder_kernel_args(dev, rng, t, b, h=h, cell="GRU")
    got = dk.gru_decoder_fused_losses_fwd(*args)
    ref = dk.gru_decoder_fused_losses_fwd_plain(*args)
    errs["gru_decoder_fwd_loss_rel"] = max(
        abs(g.item() - r.item()) / abs(r.item())
        for g, r in zip(got[1:3], ref[1:3]))
    errs["gru_decoder_fwd_states"] = max_err((got[0], got[3]),
                                             (ref[0], ref[3]))
    bwd = (*args, ref[3], normal(b, h), torch.tensor([0.5, 0.5], device=dev))
    errs["gru_decoder_bwd_rel"] = max(rel_err(g, r) for g, r in zip(
        dk.gru_decoder_fused_losses_bwd(*bwd),
        dk.gru_decoder_fused_losses_bwd_plain(*bwd)))
    w = _lstm_weights(rng, dev, h, (2, f, h), (2, h), (2, h, h), (2, h))
    for leak in (1.0, 0.5):
        wl = w if leak == 1.0 else [w[0], torch.zeros_like(w[1]), w[2],
                                    torch.zeros_like(w[3])]
        got = ek.rnn_layer_bidir_fused(x, lengths, *wl, leak)
        ref = ek.rnn_layer_bidir_fused_plain(x, lengths, *wl, leak)
        errs[f"elman_fwd_leak{leak}"] = max_err(got, ref)
        bwd = (x, lengths, *wl, ref[0], normal(*ref[0].shape),
               normal(2, b, h), leak)
        errs[f"elman_bwd_rel_leak{leak}"] = max(rel_err(g, r) for g, r in zip(
            ek.rnn_layer_bidir_fused_bwd(*bwd),
            ek.rnn_layer_bidir_fused_bwd_plain(*bwd)))
        fwd_d, fwd_p, bwd_d, bwd_p = _decoder_pair("RNN", leak)
        args, _ = _decoder_kernel_args(dev, rng, t, b, h=h, cell="RNN",
                                       leak=leak)
        got, ref = fwd_d(*args), fwd_p(*args)
        errs[f"rnn_decoder_fwd_loss_rel_leak{leak}"] = max(
            abs(g.item() - r.item()) / abs(r.item())
            for g, r in zip(got[1:3], ref[1:3]))
        errs[f"rnn_decoder_fwd_states_leak{leak}"] = max_err(
            (got[0], got[3]), (ref[0], ref[3]))
        bwd = (*args, ref[3], normal(b, h),
               torch.tensor([0.5, 0.5], device=dev))
        errs[f"rnn_decoder_bwd_rel_leak{leak}"] = max(
            rel_err(g, r) for g, r in zip(bwd_d(*bwd), bwd_p(*bwd)))
        loop = _loop_args(args, "RNN")
        errs[f"rnn_decoder_loop_leak{leak}"] = max_err(
            dk.rnn_decoder_loop(*loop, leak=leak),
            dk.rnn_decoder_loop_plain(*loop, leak=leak))
    args, _ = _decoder_kernel_args(dev, rng, t, b, h=h, cell="GRU")
    loop = _loop_args(args, "GRU")
    errs["gru_decoder_loop"] = max_err(dk.gru_decoder_loop(*loop),
                                       dk.gru_decoder_loop_plain(*loop))
    # the one-direction layers over a projected input, both span
    # directions, the Elman layer at both leaks
    for cell, leak in (("GRU", 1.0), ("RNN", 1.0), ("RNN", 0.5)):
        fwd, fwd_p, bwd_d, bwd_p, extra = _one_direction_fns(cell)
        g = (3 if cell == "GRU" else 1) * h
        w_hh, b_hh = _lstm_weights(rng, dev, h, (h, g), (g,))
        if leak < 1.0:
            b_hh = torch.zeros_like(b_hh)
        xp = normal(t, b, g)
        name = "gru_layer" if cell == "GRU" else f"rnn_layer_leak{leak}"
        for reverse in (False, True):
            args = (xp, lengths, w_hh, b_hh)
            got = fwd(*args, reverse, *extra(leak))
            ref = fwd_p(*args, reverse, *extra(leak))
            errs[f"{name}_fwd_rev{int(reverse)}"] = max_err(got, ref)
            bwd = (*args, ref[0], None if reverse else normal(t, b, h),
                   normal(b, h), reverse, *extra(leak))
            errs[f"{name}_bwd_rel_rev{int(reverse)}"] = max(
                rel_err(g_, r_) for g_, r_ in zip(bwd_d(*bwd), bwd_p(*bwd)))
    # the stream slice: the sampled loops' backwards (the Elman loop at both
    # leaks) and the fused-NLL loop
    for cell, leak in (("LSTM", 1.0), ("GRU", 1.0), ("RNN", 1.0),
                       ("RNN", 0.5)):
        out = _loop_backward_check(dev, rng, t, b, cell, leak=leak, h=h)
        errs[f"{LOOP_OF[cell]}_carries_leak{leak}"] = out[2]
        errs[f"{LOOP_OF[cell]}_bwd_rel_leak{leak}"] = max(out[3])
    out = _fused_nll_check(dev, rng, t, b, h=h)
    errs["decoder_fused_nll_fwd_nll_rel"] = out[3]["nll_rel_err"]
    errs["decoder_fused_nll_fwd_states"] = out[3]["outs_carries_max_abs_err"]
    errs["decoder_fused_nll_bwd_rel"] = max(out[4])
    torch.cuda.synchronize()
    lib = _build.load("lstm")
    glib = _build.load("gru")
    elib = _build.load("elman")
    dlib = _build.load("decoder")
    rows = {"lstm_bidir_fwd": lib.abcd_lstm_rows(0, f, h),
            "lstm_bidir_bwd": lib.abcd_lstm_rows(1, f, h),
            "lstm_fwd": lib.abcd_lstm_rows(2, 0, h),
            "lstm_bwd": lib.abcd_lstm_rows(3, 0, h),
            "decoder_fused_fwd": dlib.abcd_decoder_rows(0, f, h, m, m),
            "decoder_fused_bwd": dlib.abcd_decoder_rows(1, f, h, m, m),
            "decoder_loop": dlib.abcd_decoder_rows(2, f, h, m, 0),
            "gru_fwd": glib.abcd_gru_rows(0, f, h),
            "gru_bwd": glib.abcd_gru_rows(1, f, h),
            "gru_decoder_fused_fwd": dlib.abcd_decoder_rows(3, f, h, m, m),
            "gru_decoder_fused_bwd": dlib.abcd_decoder_rows(4, f, h, m, m),
            "elman_fwd": elib.abcd_elman_rows(0, f, h),
            "elman_bwd": elib.abcd_elman_rows(1, f, h),
            "rnn_decoder_fused_fwd": dlib.abcd_decoder_rows(5, f, h, m, m),
            "rnn_decoder_fused_bwd": dlib.abcd_decoder_rows(6, f, h, m, m),
            "gru_layer_fwd": glib.abcd_gru_rows(2, 0, h),
            "gru_layer_bwd": glib.abcd_gru_rows(3, 0, h),
            "rnn_layer_fwd": elib.abcd_elman_rows(2, 0, h),
            "rnn_layer_bwd": elib.abcd_elman_rows(3, 0, h),
            "gru_decoder_loop": dlib.abcd_decoder_rows(7, f, h, m, 0),
            "rnn_decoder_loop": dlib.abcd_decoder_rows(8, f, h, m, 0),
            "decoder_loop_bwd": dlib.abcd_decoder_rows(9, f, h, m, 0),
            "gru_decoder_loop_bwd": dlib.abcd_decoder_rows(10, f, h, m, 0),
            "rnn_decoder_loop_bwd": dlib.abcd_decoder_rows(11, f, h, m, 0),
            "decoder_fused_nll_fwd": dlib.abcd_decoder_rows(12, f, h, m, 0),
            "decoder_fused_nll_bwd": dlib.abcd_decoder_rows(13, f, h, m, 0)}
    limits = {"bidir_fwd": LSTM_ATOL, "uni_fwd": LSTM_ATOL,
              "decoder_fwd_states": LSTM_ATOL, "decoder_loop": LSTM_ATOL,
              "decoder_fwd_loss_rel": LOSS_RTOL,
              "bidir_bwd_rel": GRAD_FRACTION, "uni_bwd_rel": GRAD_FRACTION,
              "decoder_bwd_rel": GRAD_FRACTION, "gru_fwd": LSTM_ATOL,
              "gru_bwd_rel": GRAD_FRACTION,
              "gru_decoder_fwd_loss_rel": LOSS_RTOL,
              "gru_decoder_fwd_states": LSTM_ATOL,
              "gru_decoder_bwd_rel": GRAD_FRACTION}
    for leak in (1.0, 0.5):
        limits.update({f"elman_fwd_leak{leak}": LSTM_ATOL,
                       f"elman_bwd_rel_leak{leak}": GRAD_FRACTION,
                       f"rnn_decoder_fwd_loss_rel_leak{leak}": LOSS_RTOL,
                       f"rnn_decoder_fwd_states_leak{leak}": LSTM_ATOL,
                       f"rnn_decoder_bwd_rel_leak{leak}": GRAD_FRACTION,
                       f"rnn_decoder_loop_leak{leak}": LSTM_ATOL})
    limits["gru_decoder_loop"] = LSTM_ATOL
    for name in ("gru_layer", "rnn_layer_leak1.0", "rnn_layer_leak0.5"):
        for rev in (0, 1):
            limits[f"{name}_fwd_rev{rev}"] = LSTM_ATOL
            limits[f"{name}_bwd_rel_rev{rev}"] = GRAD_FRACTION
    for name in errs:
        if name.startswith(tuple(LOOP_OF.values())):
            limits[name] = GRAD_FRACTION if "_bwd_rel" in name else LSTM_ATOL
    limits.update(decoder_fused_nll_fwd_nll_rel=LOSS_RTOL,
                  decoder_fused_nll_fwd_states=LSTM_ATOL,
                  decoder_fused_nll_bwd_rel=GRAD_FRACTION)
    bad = {k: v for k, v in errs.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"H=1024 kernels vs twins: {bad}")
    return {"H": h, "B": b, "T": t, "errors": errs, "row_tiles": rows}


# ---------------------------------------------------------------------------
# the training CLI's accelerator-only switches: the launch-cost probe and
# backend selector, and the decoder's in-kernel noise (SEQ2SEQ_KERNEL_RNG)
# ---------------------------------------------------------------------------

# - the noise dump's normals vs the twin's: the same 24-bit integers (held
#   exactly) through the card's logf / cosf against torch's log / cos, a
#   few float32 ulps of |eps| <= 5.9.
NOISE_ATOL = 2e-6
# - a seed-mode kernel vs the same kernel fed the dump of its seed: the
#   same draws, so the same arithmetic; expected bit for bit, held to 1e-6
#   (the losses relative, each output and gradient of its largest value).
SEED_RTOL = 1e-6
# Operations of one in-kernel draw: Philox4x32-10's 10 rounds of 2
# multiply-high, 2 multiply-low and 4 xor plus 9 key bumps of 2 adds (98
# integer operations), then 2 shifts, 2 conversions, 5 multiplies and adds
# and the log, cos and sqrt of Box-Muller (about 22).  The bound counts them
# at the float32 rate of the card's table, which lists no integer rate.
NOISE_OPS = 120.0
KERNEL_RNG_ENV = {"SEQ2SEQ_KERNEL_RNG": "1"}


def probe_phase(dev):
    """(a) The launch-cost probe kernel against its twin on the probe's
    (8, 128) float32 tensor, the marginal cost of one launch, and a fresh
    selector on the card, which must choose the kernels (``pallas``)."""
    from seq2seq_abcd_vae_tpu_torch.ops import probe_kernel as pk
    from seq2seq_abcd_vae_tpu_torch.utils import backend_select
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(
        pk.PROBE_SHAPE) * 0.25
    err = max_err(pk.add_one(x), pk.add_one_plain(x))
    if err != 0.0:
        raise AssertionError(f"probe kernel vs twin: {err}")
    marginal = pk.marginal_launch_ms(dev)
    selector = backend_select.for_device(dev)
    choice = selector.current()
    print(f"launch-cost probe: marginal launch {marginal:.6f} ms; selector "
          f"decisions {selector.decisions}", flush=True)
    if choice != "pallas":
        raise AssertionError(f"the selector chose {choice!r} on the card: "
                             f"{selector.report()}")
    return {"max_abs_err": err, "marginal_launch_ms": marginal,
            "report": selector.report()}


def probe_entry(dev, launches, probe):
    """The probe's kernels-line entry: its time, its twin's and torch's own
    ``x + 1`` (the library call) on (8, 128), and its byte bound."""
    from seq2seq_abcd_vae_tpu_torch.ops import probe_kernel as pk
    x = torch.zeros(pk.PROBE_SHAPE, dtype=torch.float32, device=dev)
    ms = cuda_ms(lambda: pk.add_one(x), iters=200, warmup=5)
    plain_ms = cuda_ms(lambda: pk.add_one_plain(x), iters=200, warmup=5)
    library_ms = cuda_ms(lambda: torch.add(x, 1.0), iters=200, warmup=5)
    n = x.numel()
    bms, by = bound_ms(n, 8.0 * n)
    return {"name": "launch_cost_probe", "route": "cuda",
            "source": "seq2seq_abcd_vae_tpu_torch/csrc/probe.cu",
            "replaces": "seq2seq_abcd_vae_tpu/utils/backend_select.py:74",
            "launches": launches, "max_abs_err": probe["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "library_call": "torch.add(x, 1.0)",
            "marginal_launch_ms": probe["marginal_launch_ms"],
            "shape": "(8, 128) float32", "tolerance": "exact"}


def noise_dump_phase(dev, launches, t=125, b=TRAIN_BATCH, f=129):
    """(b) The dump kernel against its twin at the training shape: the
    uniforms' 24-bit integers exactly, the normals within NOISE_ATOL, their
    mean and variance within 5 standard errors of 0 and 1, two seeds and
    two slots different; its time, its twin's, torch.randn's (the same
    work, other bits) and its bound."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    seed = torch.tensor([[123457.0]], device=dev)
    out, bits = dk.decoder_noise_dump(seed, t, b, f, with_bits=True)
    want, want_bits = dk.decoder_noise_dump_plain(seed, t, b, f,
                                                  with_bits=True)
    torch.cuda.synchronize()
    err = max_err(out, want)
    n = out.numel()
    mean, var = out.double().mean().item(), out.double().var().item()
    other_seed = dk.decoder_noise_dump(seed + 1.0, t, b, f)
    checks = {"bits_equal": bool(torch.equal(bits, want_bits)),
              "max_abs_err": err,
              "mean_in_5_se": abs(mean) <= 5.0 / math.sqrt(n),
              "var_in_5_se": abs(var - 1.0) <= 5.0 * math.sqrt(2.0 / n),
              "seeds_differ": not torch.equal(out, other_seed),
              "slots_differ": not torch.equal(out[0], out[1])}
    print(f"noise dump vs twin at T={t} B={b} F={f}: {checks}, mean {mean}, "
          f"variance {var}", flush=True)
    if not (all(v for k, v in checks.items() if k != "max_abs_err")
            and err <= NOISE_ATOL):
        raise AssertionError(f"noise dump vs twin: {checks}")
    ms = cuda_ms(lambda: dk.decoder_noise_dump(seed, t, b, f), iters=20)
    plain_ms = cuda_ms(lambda: dk.decoder_noise_dump_plain(seed, t, b, f),
                       iters=3, warmup=1)
    library_ms = cuda_ms(lambda: torch.randn((t, b, f), device=dev),
                         iters=20)
    bms, by = bound_ms(NOISE_OPS * n, 4.0 * n + 4)
    return {"name": "decoder_noise_dump", "route": "cuda",
            "source": "seq2seq_abcd_vae_tpu_torch/csrc/decoder.cu",
            "replaces": "seq2seq_abcd_vae_tpu/ops/decoder_pallas.py:1729",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms,
            "library_call": "torch.randn((T, B, F)) (the same work, other "
                            "bits)",
            "checks": checks, "shape": f"T={t} B={b} F={f}",
            "tolerance": f"integers exact, normals {NOISE_ATOL}"}


SEED_COUNTERS = {"LSTM": "decoder_loop_fused_losses_seed",
                 "GRU": "gru_decoder_loop_fused_losses_seed",
                 "RNN": "rnn_decoder_loop_fused_losses_seed"}


def _seed_check(dev, rng, t, b, cell, leak=1.0, h=HIDDEN):
    """One fused-loss decoder's seed mode: the kernels with a (1, 1) seed
    against the same kernels fed the dump of that seed (SEED_RTOL) and
    against the twins in seed mode, the dump's twin then the stream twin
    (the fused kernels' tolerances).  Returns (seeded args, dump-fed args,
    backward's extra args, errors)."""
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    fwd, fwd_plain, bwd, bwd_plain = _decoder_pair(cell, leak)
    args, lens = _decoder_kernel_args(dev, rng, t, b, h=h, cell=cell,
                                      leak=leak)
    f = args[0].shape[2]
    seed = torch.tensor([[float(rng.integers(0, 1 << 24))]], device=dev)
    seeded = [seed] + args[1:]
    fed = [dk.decoder_noise_dump(seed, t, b, f)] + args[1:]
    twin = [dk.decoder_noise_dump_plain(seed, t, b, f)] + args[1:]
    n_state = 2 if cell == "LSTM" else 1
    got, same, want = fwd(*seeded), fwd(*fed), fwd_plain(*twin)
    torch.cuda.synchronize()
    states = (0,) + tuple(range(3, 3 + n_state))
    errs = {"fwd_loss_rel_vs_dump_fed": max(
                abs(g.item() - s.item()) / abs(s.item())
                for g, s in zip(got[1:3], same[1:3])),
            "fwd_states_rel_vs_dump_fed": max(
                rel_err(got[i], same[i]) for i in states),
            "fwd_loss_rel_vs_twin": max(
                abs(g.item() - r.item()) / abs(r.item())
                for g, r in zip(got[1:3], want[1:3])),
            "fwd_states_vs_twin": max_err(tuple(got[i] for i in states),
                                          tuple(want[i] for i in states))}
    dlast = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)
                             ).to(dev)
    gscale = torch.tensor([1.0 / 511, 1.0 / 511], device=dev)
    extra = (*want[3:3 + n_state], dlast, gscale)
    g_all, s_all = bwd(*seeded, *extra), bwd(*fed, *extra)
    r_all = bwd_plain(*twin, *extra)
    torch.cuda.synchronize()
    errs["bwd_rel_vs_dump_fed"] = max(rel_err(g, s)
                                      for g, s in zip(g_all, s_all))
    errs["bwd_rel_vs_twin"] = max(rel_err(g, r) for g, r in zip(g_all, r_all))
    limits = {"fwd_loss_rel_vs_dump_fed": SEED_RTOL,
              "fwd_states_rel_vs_dump_fed": SEED_RTOL,
              "bwd_rel_vs_dump_fed": SEED_RTOL,
              "fwd_loss_rel_vs_twin": LOSS_RTOL,
              "fwd_states_vs_twin": LSTM_ATOL,
              "bwd_rel_vs_twin": GRAD_FRACTION}
    bad = {k: v for k, v in errs.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"{cell} decoder seed mode (leak {leak}, H={h}):"
                             f" {errs}")
    return seeded, fed, extra, lens, errs


def seed_kernel_phase(dev, rng, t, cell, launches_fwd, launches_bwd):
    """(b) The seed mode of a fused-loss decoder (the LSTM, GRU, or the
    Elman loop also at the ESN's leak 0.5) at the training shape and at
    hidden size 1024 (its row tiles equal the stream mode's), with the
    seed-mode times beside the same kernels' stream-mode times."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    b, h, m, f = TRAIN_BATCH, HIDDEN, MLP_HIDDEN, 129
    fwd, _, bwd, bwd_plain = _decoder_pair(cell)
    seeded, fed, extra, lens, errs = _seed_check(dev, rng, t, b, cell)
    checks = {"H256": errs}
    if cell == "RNN":
        checks["H256_esn_leak_0.5"] = _seed_check(dev, rng, t, b, cell,
                                                  leak=0.5)[4]
    for leak in ((1.0, 0.5) if cell == "RNN" else (1.0,)):
        checks[f"H1024_leak{leak}"] = _seed_check(dev, rng, 16, 24, cell,
                                                  leak=leak, h=1024)[4]
    lib = _build.load("decoder")
    base = {"LSTM": (0, 1), "GRU": (3, 4), "RNN": (5, 6)}[cell]
    rows = {}
    for kind in base:
        for hh in (h, 1024):
            pair = (lib.abcd_decoder_rows(dk._SEED_KIND[kind], f, hh, m, m),
                    lib.abcd_decoder_rows(kind, f, hh, m, m))
            if pair[0] != pair[1]:
                raise AssertionError(f"seed kind of {kind} at H={hh} takes "
                                     f"{pair[0]} rows, stream kind {pair[1]}")
            rows[f"kind{kind}_H{hh}"] = pair[0]
    fwd_plain_seed = _decoder_pair(cell)[1]
    twin_fwd = lambda: fwd_plain_seed(
        dk.decoder_noise_dump_plain(seeded[0], t, b, f), *seeded[1:])
    fwd_ms = cuda_ms(lambda: fwd(*seeded), iters=5)
    stream_fwd_ms = cuda_ms(lambda: fwd(*fed), iters=5)
    bwd_ms = cuda_ms(lambda: bwd(*seeded, *extra), iters=3)
    stream_bwd_ms = cuda_ms(lambda: bwd(*fed, *extra), iters=3)
    plain_fwd_ms = cuda_ms(twin_fwd, iters=2, warmup=1)
    plain_bwd_ms = cuda_ms(lambda: bwd_plain(
        dk.decoder_noise_dump_plain(seeded[0], t, b, f), *seeded[1:],
        *extra), iters=2, warmup=1)
    gh = {"LSTM": 4, "GRU": 3, "RNN": 1}[cell] * h
    n_state = 2 if cell == "LSTM" else 1
    per = 2.0 * (h * (gh + 2 * m) + 2 * m * f + f * gh + h * m)
    steps = int(lens.sum())
    draws = steps * f  # position t-1's noise at every step it is fed back
    weights = (h * (gh + 2 * m) + (2 if cell == "GRU" else 1) * gh + 2 * m
               + 2 * m * f + 2 * f + f * gh + h * m + 2 * m + 1)
    fwd_bytes = 4.0 * (1 + t * b * f + weights + n_state * b * h
                       + b * h + 2 + n_state * t * b * h) + 4 * b
    bwd_bytes = 4.0 * (1 + t * b * f + weights + n_state * b * h
                       + n_state * t * b * h + b * h + 2 + weights
                       + n_state * b * h) + 4 * b
    f_bms, f_by = bound_ms(steps * per + NOISE_OPS * draws, fwd_bytes)
    b_bms, b_by = bound_ms(3 * steps * per + NOISE_OPS * draws, bwd_bytes)
    lines = {"LSTM": (1983, 2042), "GRU": (898, 937),
             "RNN": (1503, 1543)}[cell]
    name = SEED_COUNTERS[cell]
    common = {"route": "cuda",
              "source": "seq2seq_abcd_vae_tpu_torch/csrc/decoder.cu",
              "library_ms": None,
              "library_call": "none: no single PyTorch call runs this loop",
              "shape": f"T={t} B={b} F={f} H={h} m={m} Mo={m}, (1, 1) seed",
              "checks": checks, "row_tiles": rows}
    fwd_entry = dict(common, **{
        "name": name,
        "replaces": f"seq2seq_abcd_vae_tpu/ops/decoder_pallas.py:{lines[0]}",
        "launches": launches_fwd, "max_abs_err": errs["fwd_states_vs_twin"],
        "ms": fwd_ms, "stream_mode_ms": stream_fwd_ms,
        "plain_ms": plain_fwd_ms, "bound_ms": f_bms, "bound_by": f_by,
        "tolerance": f"vs the dump-fed kernel {SEED_RTOL}; vs the twins "
                     f"losses {LOSS_RTOL} relative, states {LSTM_ATOL}"})
    bwd_entry = dict(common, **{
        "name": name + "_bwd",
        "helper_source": "seq2seq_abcd_vae_tpu_torch/csrc/wgrad.cu",
        "replaces": f"seq2seq_abcd_vae_tpu/ops/decoder_pallas.py:{lines[1]}",
        "launches": launches_bwd, "max_abs_err": max(
            max_err(g, r) for g, r in zip(bwd(*seeded, *extra),
                                          bwd(*fed, *extra))),
        "max_rel_err": errs["bwd_rel_vs_twin"], "ms": bwd_ms,
        "stream_mode_ms": stream_bwd_ms, "plain_ms": plain_bwd_ms,
        "bound_ms": b_bms, "bound_by": b_by,
        "tolerance": f"vs the dump-fed kernel {SEED_RTOL} of each leaf's "
                     f"max; vs the twins {GRAD_FRACTION}"})
    return fwd_entry, bwd_entry


def kernel_rng_train_phase(dev, work: str, corpus_dir: str, csv_path: str,
                           seed: int):
    """(c) The training CLI with ``SEQ2SEQ_KERNEL_RNG=1 -R LSTM`` (2
    epochs, 1 of pretraining), counted: the LSTM decoder's fused-loss
    kernels in seed mode once per step (the backward per training step),
    in stream mode never; the launch-cost probe at the start and at the
    second epoch (1 + 3 x 8 launches each); history.log with finite losses,
    one ``Kernel backend:`` line and one ``Kernel backend decision:``
    line for the kernels."""
    from seq2seq_abcd_vae_tpu_torch.cli import learning_main
    from seq2seq_abcd_vae_tpu_torch.ops import probe_kernel as pk
    job = "kernel-rng"
    argv = [corpus_dir, csv_path, "-S", work, "-j", job, "-b",
            str(TRAIN_BATCH), "--pretrain_epochs", "1", "--stft_method",
            "pallas", "-d", dev.type, "-N", str(NORMALIZER), "-s", str(seed),
            "-R", "LSTM", "-e", "2",
            "--encoder_rnn_hidden_size", str(HIDDEN),
            "--decoder_rnn_hidden_size", str(HIDDEN),
            "--mlp_hidden_size", str(MLP_HIDDEN), "-K", str(K),
            "-f", str(FEATURE_DIM), "--speaker_embed_dim", str(SPEAKER_EMBED)]
    counters = zero_counters()
    pk.add_one.launches = 0
    t0 = time.perf_counter()
    with environment(KERNEL_RNG_ENV):
        run_ = learning_main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    probes = pk.add_one.launches
    log_path = os.path.join(work, job, "history.log")
    check_history(log_path, False)
    with open(log_path) as f_:
        log = f_.read().splitlines()
    start = [line for line in log if "Kernel backend: " in line]
    decisions = [line for line in log if "Kernel backend decision: " in line]
    train_steps, eval_steps = run_.steps["train"], run_.steps["eval"]
    steps = train_steps + eval_steps
    want = expected(counters, log_spectrogram=steps,
                    lstm_layer_bidir_fused=steps,
                    lstm_layer_bidir_fused_bwd=train_steps,
                    decoder_loop_fused_losses_seed_fwd=steps,
                    decoder_loop_fused_losses_seed_bwd=train_steps)
    print(f"{job} training main path ({KERNEL_RNG_ENV}): {train_steps} "
          f"training + {eval_steps} evaluation steps in {wall:.2f} s; "
          f"launches {launches}, probe launches {probes}; "
          f"{start + decisions}", flush=True)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if probes != 2 * (1 + 3 * 8):
        raise AssertionError(f"{probes} probe launches, expected 2 probes "
                             "of 25")
    if (len(start) != 1 or len(decisions) != 1
            or "'rnn_backend': 'pallas'" not in start[0]
            or "decision: pallas" not in decisions[0]):
        raise AssertionError(f"history.log's backend lines: {start} "
                             f"{decisions}")
    later = [n / sec for _, sec, n in run_.epoch_seconds[1:]]
    return {"launches": dict(launches, launch_cost_probe=probes),
            "train_steps": train_steps, "eval_steps": eval_steps,
            "backend_lines": start + decisions,
            "segments_per_s_after_first_epoch":
                sum(later) / len(later) if later else None,
            "epochs": [{"epoch": e, "train_s": sec, "segments": n}
                       for e, sec, n in run_.epoch_seconds]}


def kernel_rng_parity_phase(dev, checkpoints: dict, corpus_dir: str,
                            csv_path: str, seed: int):
    """(b) The JAX package's kernel-RNG check (scripts/decoder_kernel_
    parity.py:kernel_rng_check) through ``models/decoder.decoder_losses``
    on each trained checkpoint's validation segments: the loss and its
    gradients with a (1, 1) seed equal those with the seed's dump as the
    noise stream (SEED_RTOL) and the same call on the CPU's twins (the
    training tolerances); counted per cell: the seed-mode forward and
    backward once, the dump once, the stream-mode forward and backward
    once (the dump-fed call), nothing else."""
    from seq2seq_abcd_vae_tpu_torch.data.annotations import AnnotationParser
    from seq2seq_abcd_vae_tpu_torch.data.batching import (DataLoader,
                                                          FrontendSpec)
    from seq2seq_abcd_vae_tpu_torch.infer.decode import load_model
    from seq2seq_abcd_vae_tpu_torch.infer.encode import Encoder, encode_step
    from seq2seq_abcd_vae_tpu_torch.models import decoder as dec_mod
    from seq2seq_abcd_vae_tpu_torch.ops import decoder_kernel as dk
    from seq2seq_abcd_vae_tpu_torch.train import learner as L
    from seq2seq_abcd_vae_tpu_torch.tree import tree_leaves, tree_map
    spec = FrontendSpec(int(0.008 * TRAIN_FS), int(0.004 * TRAIN_FS))
    valid = AnnotationParser(corpus_dir, csv_path).get_data("valid")
    batch = next(iter(DataLoader(valid, spec, batch_size=len(valid))))
    audio = torch.from_numpy(batch.audio).to(dev)
    lengths = torch.from_numpy(batch.num_frames).to(dev)
    speakers = torch.from_numpy(batch.speakers).to(dev)
    t = batch.bucket_frames
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for cell, path in checkpoints.items():
        enc = Encoder(path, device=dev.type, stft_method="pallas")
        statics = enc.statics(spec, EPSILON, NORMALIZER)
        feats = encode_step(enc.params, audio, lengths, statics, t,
                            "features")
        inputs = L.frontend(statics, audio, t)
        params, cfg = load_model(path, dev.type)
        key = torch.randint(0, 1 << 24, (1, 1), generator=gen, device=dev,
                            dtype=torch.int64).to(torch.float32)

        def run(device, noise):
            dec = tree_map(lambda p: p.detach().to(device).clone()
                           .requires_grad_(True), params["decoder"])
            em, bce = dec_mod.decoder_losses(
                dec, cfg.decoder, feats.to(device), lengths.to(device),
                inputs.to(device), noise.to(device), speakers.to(device))
            loss = em + bce
            loss.backward()
            return loss.detach(), [p.grad for p in tree_leaves(dec)]

        counters = zero_counters()
        card = run(dev, key)
        dumped = run(dev, dk.decoder_noise_dump(key, t, len(lengths),
                                                cfg.decoder.output_size))
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        name = SEED_COUNTERS["RNN" if cell == "ESN" else cell]
        stream = name.replace("_seed", "")
        want = expected(counters, decoder_noise_dump=1,
                        **{name + "_fwd": 1, name + "_bwd": 1,
                           stream + "_fwd": 1, stream + "_bwd": 1})
        if launches != want:
            raise AssertionError(f"{cell} kernel-RNG check launched "
                                 f"{launches}, expected {want}")
        errs = {}
        for where, (loss, grads) in (("dump_fed", dumped),
                                     ("cpu_twins", run(torch.device("cpu"),
                                                       key))):
            errs[f"loss_rel_vs_{where}"] = abs(
                card[0].item() - loss.item()) / abs(loss.item())
            errs[f"grad_max_rel_vs_{where}"] = max(
                rel_err(g, r) for g, r in zip(card[1], grads)
                if r is not None)
        limits = {"loss_rel_vs_dump_fed": SEED_RTOL,
                  "grad_max_rel_vs_dump_fed": SEED_RTOL,
                  "loss_rel_vs_cpu_twins": LOSS_RTOL,
                  "grad_max_rel_vs_cpu_twins": GRAD_FRACTION}
        bad = {k: v for k, v in errs.items() if not v <= limits[k]}
        if bad or not math.isfinite(card[0].item()):
            raise AssertionError(f"{cell} kernel-RNG check: {errs}")
        out[cell] = {"launches": launches, "loss": card[0].item(),
                     "errors": errs}
    print(f"kernel-RNG check on the trained checkpoints (B={len(lengths)}, "
          f"T={t}): " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the plain Gaussian VAE slice, and the two-direction LSTM layer over xp
# (lstm_pallas.lstm_layer_bidir, which no path of either package calls)
# ---------------------------------------------------------------------------

PARAMS_ATOL = 1e-4    # encoder + Gaussian head, card vs CPU: O(1) sums


def plain_train_phase(dev, work: str, corpus_dir: str, csv_path: str,
                      seed: int):
    """The plain VAE trained through the training CLI's plain variant
    (``learning_main.main(argv, variant="plain")``, what
    ``python -m seq2seq_abcd_vae_tpu_torch.cli.plain_learning`` runs) on
    the synthetic corpus at ``-b 512 --speaker_embed_dim 256 -f 16``, 2
    epochs then resumed to 3, counted: the bidirectional LSTM encoder's
    and the fused-loss decoder's kernels run once per step (backwards once
    per training step), nothing else; no pretraining and no
    speaker_coding.json, a Gaussian checkpoint."""
    from seq2seq_abcd_vae_tpu_torch.cli import learning_main
    from seq2seq_abcd_vae_tpu_torch.train import checkpoint as ckpt
    argv = [corpus_dir, csv_path, "-S", work, "-j", "plain", "-b",
            str(TRAIN_BATCH), "--stft_method", "pallas", "-d", dev.type,
            "-N", str(NORMALIZER), "-s", str(seed),
            "-f", str(PLAIN_FEATURE),
            "--encoder_rnn_hidden_size", str(HIDDEN),
            "--decoder_rnn_hidden_size", str(HIDDEN),
            "--mlp_hidden_size", str(MLP_HIDDEN),
            "--speaker_embed_dim", str(SPEAKER_EMBED)]
    counters = zero_counters()
    t0 = time.perf_counter()
    first = learning_main.main(argv + ["-e", "2"], variant="plain")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    run_dir = os.path.join(work, "plain")
    path = os.path.join(run_dir, "checkpoint.pt")
    check_history(os.path.join(run_dir, "history.log"), False, False)
    t0 = time.perf_counter()
    second = learning_main.main(argv + ["-e", "3"], variant="plain")
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    lines = check_history(os.path.join(run_dir, "history.log"), True, False)
    launches = {name: fn.launches for name, fn in counters.items()}
    train_steps = first.steps["train"] + second.steps["train"]
    eval_steps = first.steps["eval"] + second.steps["eval"]
    steps = train_steps + eval_steps
    want = expected(counters, log_spectrogram=steps,
                    lstm_layer_bidir_fused=steps,
                    lstm_layer_bidir_fused_bwd=train_steps,
                    decoder_loop_fused_losses_fwd=steps,
                    decoder_loop_fused_losses_bwd=train_steps)
    print(f"plain VAE training main path: {train_steps} training + "
          f"{eval_steps} evaluation steps in {first_s:.2f} + "
          f"{second_s:.2f} s; launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if os.path.exists(os.path.join(run_dir, "speaker_coding.json")):
        raise AssertionError("the plain VAE wrote speaker_coding.json")
    c = ckpt.load_checkpoint(path)
    head = c["feature_sampler_init_parameters"]
    if (c["latent_type"] != "gaussian"
            or head["output_size"] != PLAIN_FEATURE
            or set(c["feature_sampler"]) != {"to_parameters"}):
        raise AssertionError(f"the plain checkpoint holds {c['latent_type']}"
                             f" {head}")
    epochs = first.epoch_seconds + second.epoch_seconds
    later = [n / sec for _, sec, n in epochs[1:]]
    return {"launches": launches, "train_steps": train_steps,
            "eval_steps": eval_steps, "checkpoint": path,
            "history_loss_values": lines,
            "segments_per_s_after_first_epoch":
                sum(later) / len(later) if later else None,
            "epochs": [{"epoch": e, "train_s": sec, "segments": n}
                       for e, sec, n in epochs]}


def plain_encode_phase(dev, work: str, corpus_dir: str, csv_path: str,
                       ckpt_path: str):
    """The encode CLI in ``params`` mode (``-p mean,log_variance``) on the
    plain checkpoint, to CSV and npz on the card (counted) and to CSV on
    the CPU's twins: segments x 2 x f rows sorted by (data_ix, name,
    dimension), the npz's ``mean`` / ``log_variance`` = the CSV's values
    bit for bit, the card's CSV = the CPU's outside the values, and the
    values within ``PARAMS_ATOL``."""
    from seq2seq_abcd_vae_tpu_torch.cli import encode_main
    names = ("mean", "log_variance")
    common = [ckpt_path, corpus_dir, csv_path, str(NORMALIZER), "-b",
              str(TRAIN_BATCH), "--stft_method", "pallas", "-p",
              ",".join(names)]
    out_dir = os.path.join(work, "encoded")
    os.makedirs(out_dir, exist_ok=True)
    paths = {fmt: os.path.join(out_dir, f"plain-params.{fmt}")
             for fmt in ("csv", "npz")}
    counters = zero_counters()
    secs = {}
    for fmt, path in paths.items():
        t0 = time.perf_counter()
        encode_main.main("params", common + ["-S", path, "-d", dev.type,
                                             "--save_format", fmt])
        torch.cuda.synchronize()
        secs[fmt] = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    if ran(launches) != {"log_spectrogram", "lstm_layer_bidir_fused"}:
        raise AssertionError(f"params encoding launched {launches}")

    def rows(path):
        with open(path) as f:
            lines = f.read().splitlines()
        cells = [line.split(",", 4) for line in lines[1:]]
        return lines[0], [(c[0], c[1], c[2], c[4]) for c in cells], [
            c[3] for c in cells]

    head, keys, texts = rows(paths["csv"])
    vals = np.asarray(texts, np.float32)
    segments = len(dict.fromkeys(k[0] for k in keys))
    order = [(int(ix), name, int(dim)) for ix, name, dim, _ in keys]
    if (len(keys) != segments * 2 * PLAIN_FEATURE or order != sorted(order)
            or not np.all(np.isfinite(vals))):
        raise AssertionError(f"params CSV: {len(keys)} rows for {segments} "
                             "segments, or unsorted, or non-finite")
    with np.load(paths["npz"]) as z:
        ixs, arrays = z["data_ix"], {n: z[n] for n in names}
        if str(z["mode"]) != "params":
            raise AssertionError("params npz mode")
    parsed = {(int(ix), name, int(dim)): v
              for (ix, name, dim, _), v in zip(keys, vals)}
    for name in names:
        back = np.asarray([[parsed[(int(ix), name, j)]
                            for j in range(PLAIN_FEATURE)] for ix in ixs],
                          np.float32)
        if back.tobytes() != arrays[name].tobytes():
            raise AssertionError(f"params npz {name} differs from the CSV")
    cpu_path = os.path.join(out_dir, "plain-params-cpu.csv")
    encode_main.main("params", common + ["-S", cpu_path, "-d", "cpu"])
    c_head, c_keys, c_texts = rows(cpu_path)
    if c_head != head or c_keys != keys:
        raise AssertionError("params CSV: card and CPU differ outside the "
                             "values")
    err = float(np.abs(vals.astype(np.float64)
                       - np.asarray(c_texts, np.float64)).max())
    if not err <= PARAMS_ATOL:
        raise AssertionError(f"params CSV card vs CPU {err} > {PARAMS_ATOL}")
    return {"launches": launches, "segments": segments, "rows": len(keys),
            "card_vs_cpu_max_abs_err": err,
            "segments_per_s": {f"params_{fmt}": segments / sec
                               for fmt, sec in secs.items()}}


def plain_serve_phase(work: str, ckpt_path: str, rng):
    """The plain checkpoint served through ``serve_main --mode params``
    (fs=32000, frame counts up to 512, 32 requests from 4 clients),
    counted: the frontend and the bidirectional LSTM encoder run, nothing
    else; every answer is ``{"id", "params": [mean, log_variance]}`` of
    finite values, ``PLAIN_FEATURE`` each."""
    counters = zero_counters()
    reqs = random_requests(rng, 32000, 32)
    (answers, latency), ping = run_service(
        [ckpt_path, str(NORMALIZER), "32000", "--mode", "params", "-b",
         str(BATCH), "--stft_method", "pallas", "-d", "cuda"],
        os.path.join(work, "plain.sock"),
        lambda path: concurrent_clients(path, reqs, 32000))
    for a in answers:
        if "error" in a or set(a) != {"id", "params"}:
            raise RuntimeError(f"params request failed: {a}")
        v = np.asarray(a["params"], np.float64)
        if v.shape != (2, PLAIN_FEATURE) or not np.all(np.isfinite(v)):
            raise RuntimeError(f"bad params answer shape {v.shape}")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    if ran(launches) != {"log_spectrogram", "lstm_layer_bidir_fused"}:
        raise AssertionError(f"params serving launched {launches}")
    lat = np.asarray(latency)
    return {"launches": launches, "requests": len(lat),
            "batches": ping["stats"]["batches"],
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p90": float(np.percentile(lat, 90)),
            "latency_ms_max": float(lat.max())}


def lstm_pair_path(dev, rng):
    """The two-direction layer over xp reached by a direct call of its
    public differentiable function (``lstm_layer_bidir_train``, forward
    and backward through autograd) at B=512, T=125, H=256, counted: one
    launch of each kernel and nothing else."""
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    args = _pair_inputs(dev, rng, TRAIN_BATCH, 125, HIDDEN)
    counters = zero_counters()
    leaves = [a.clone().requires_grad_(True)
              for a in (args["xp"], args["w_hh"], args["b_hh"])]
    outs, h_n, c_n = lk.lstm_layer_bidir_train(leaves[0], args["lengths"],
                                               *leaves[1:])
    (outs.sum() + h_n.square().sum() + c_n.sin().sum()).backward()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = expected(counters, lstm_layer_bidir=1, lstm_layer_bidir_bwd=1)
    if launches != want or not all(torch.isfinite(a.grad).all()
                                   for a in leaves):
        raise AssertionError(f"lstm_layer_bidir direct call launched "
                             f"{launches}, expected {want}")
    return {"launches": launches}


def _pair_inputs(dev, rng, b, t, h):
    """xp (T, 2, B, 4H), lengths (a full row, a short one, an empty one,
    the rest ragged), w_hh, b_hh and the backward's cotangents."""
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[0], lens[1], lens[-1] = t, 1, 0
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(dev)
    w_hh, b_hh = _lstm_weights(rng, dev, h, (2, h, 4 * h), (2, 4 * h))
    return {"xp": normal(t, 2, b, 4 * h), "lens": lens,
            "lengths": torch.from_numpy(lens).to(dev), "w_hh": w_hh,
            "b_hh": b_hh, "douts": normal(t, 2, b, h),
            "dh_n": normal(2, b, h), "dc_n": normal(2, b, h)}


def lstm_pair_phase(dev, rng, launches_fwd, launches_bwd):
    """Row 4 (lstm_pallas.lstm_layer_bidir, both directions over xp in one
    launch), forward with the saved cs and backward (with and without an
    outs cotangent), against the twins at B=512, T=125, H=256 and at
    H=1024 (B=24, T=16, a smaller row tile); timed at the first beside
    cuDNN's bidirectional LSTM on a packed sequence, whose final states it
    must match given xp = x @ W_ih + b_ih (direction 1 flipped in
    time)."""
    from seq2seq_abcd_vae_tpu_torch.ops import _build
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel as lk
    checks, rows = {}, {}
    for b, t, h in ((TRAIN_BATCH, 125, HIDDEN), (24, 16, 1024)):
        a = _pair_inputs(dev, rng, b, t, h)
        fwd = (a["xp"], a["lengths"], a["w_hh"], a["b_hh"])
        got = lk.lstm_layer_bidir(*fwd, return_cs=True)
        ref = lk.lstm_layer_bidir_plain(*fwd, return_cs=True)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        checks[f"fwd_B{b}_T{t}_H{h}"] = err
        if not err <= LSTM_ATOL:
            raise AssertionError(f"lstm_layer_bidir vs twin B={b} T={t} "
                                 f"H={h}: {err}")
        for douts in (None, a["douts"]):  # the timed one last
            bwd = (*fwd, ref[0], ref[3], douts, a["dh_n"], a["dc_n"])
            g_all = lk.lstm_layer_bidir_bwd(*bwd)
            r_all = lk.lstm_layer_bidir_bwd_plain(*bwd)
            torch.cuda.synchronize()
            rel = max(rel_err(g, r) for g, r in zip(g_all, r_all))
            key = f"bwd_B{b}_T{t}_H{h}_douts{int(douts is not None)}"
            checks[key] = rel
            if rel > GRAD_FRACTION:
                raise AssertionError(f"lstm_layer_bidir backward vs twin "
                                     f"{key}: {rel}")
        lib = _build.load("lstm")
        rows[f"H{h}"] = {"fwd": lib.abcd_lstm_rows(4, 0, h),
                         "bwd": lib.abcd_lstm_rows(5, 0, h)}
        if h == HIDDEN:
            timed = (b, t, h, a, fwd, bwd, max_err(g_all, r_all))
    b, t, h, a, fwd, bwd, bwd_abs = timed
    fwd_ms = cuda_ms(lambda: lk.lstm_layer_bidir(*fwd), 5)
    fwd_plain_ms = cuda_ms(lambda: lk.lstm_layer_bidir_plain(*fwd), 2, 1)
    bwd_ms = cuda_ms(lambda: lk.lstm_layer_bidir_bwd(*bwd), 5)
    bwd_plain_ms = cuda_ms(lambda: lk.lstm_layer_bidir_bwd_plain(*bwd), 2, 1)
    # the yardstick: cuDNN's bidirectional LSTM over packed sequences (the
    # empty row dropped) of raw x; it also computes the input projection,
    # which the kernel is handed
    f = 129
    lstm = torch.nn.LSTM(f, h, bidirectional=True).to(dev)
    x = torch.from_numpy(rng.normal(size=(t, b, f)).astype(np.float32)
                         ).to(dev)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            getattr(lstm, "weight_hh_l0" + sfx).copy_(a["w_hh"][d].T)
            getattr(lstm, "bias_hh_l0" + sfx).copy_(a["b_hh"][d])
        w_ih = torch.stack([lstm.weight_ih_l0.T, lstm.weight_ih_l0_reverse.T])
        b_ih = torch.stack([lstm.bias_ih_l0, lstm.bias_ih_l0_reverse])
        xs = torch.stack([x, x.flip(0)], dim=1)               # (T, 2, B, F)
        xp = (torch.matmul(xs, w_ih[None]) + b_ih[None, :, None]
              ).contiguous()
    lens = a["lens"]
    keep = torch.from_numpy(lens > 0).to(dev)
    x_lib = x[:, keep].clone().requires_grad_(True)
    lens_lib = torch.from_numpy(lens[lens > 0].astype(np.int64))
    dh_lib = a["dh_n"][:, keep]

    def library_fwd():
        with torch.no_grad():
            packed = torch.nn.utils.rnn.pack_padded_sequence(
                x_lib, lens_lib, enforce_sorted=False)
            return lstm(packed)[1]

    def library_fwd_bwd():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x_lib, lens_lib, enforce_sorted=False)
        _, (hh, cc) = lstm(packed)
        torch.autograd.backward((hh, cc), (dh_lib, dh_lib))

    lib_h, lib_c = library_fwd()
    _, k_h, k_c = lk.lstm_layer_bidir(xp, a["lengths"], a["w_hh"],
                                      a["b_hh"])
    lib_err = max(max_err(lib_h, k_h[:, keep]), max_err(lib_c, k_c[:, keep]))
    lib_fwd_ms = cuda_ms(library_fwd, 5)
    lib_bwd_ms = cuda_ms(library_fwd_bwd, 5)
    steps = 2 * int(lens.sum())   # active row-steps of both directions
    per = 2.0 * h * 4 * h         # h @ W_hh per row-step
    fwd_bytes = 4.0 * (t * 2 * b * 4 * h + 2 * h * 4 * h + 2 * 4 * h
                       + t * 2 * b * h + 2 * 2 * b * h) + 4 * b
    bwd_bytes = 4.0 * (2 * t * 2 * b * 4 * h + 2 * (2 * h * 4 * h + 2 * 4 * h)
                       + 3 * t * 2 * b * h + 2 * 2 * b * h) + 4 * b
    f_bms, f_by = bound_ms(steps * per, fwd_bytes)
    # gates recomputed, dz @ W_hh^T and h_prev^T dz: three times the
    # forward's products
    b_bms, b_by = bound_ms(3 * steps * per, bwd_bytes)
    common = {"route": "cuda",
              "source": "seq2seq_abcd_vae_tpu_torch/csrc/lstm.cu",
              "shape": f"T={t} B={b} H={h} (xp given, both directions in "
                       "one launch; ragged, one empty row)",
              "row_tiles": rows}
    fwd_entry = dict(common, **{
        "name": "lstm_layer_bidir",
        "replaces": "seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:406",
        "launches": launches_fwd,
        "max_abs_err": max(v for k, v in checks.items()
                           if k.startswith("fwd")),
        "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": f_bms,
        "bound_by": f_by, "library_ms": lib_fwd_ms,
        "library_call": "nn.LSTM (bidirectional) forward, packed",
        "library_max_abs_err": lib_err,
        "tolerance": LSTM_ATOL, "checks": checks})
    bwd_entry = dict(common, **{
        "name": "lstm_layer_bidir_bwd",
        "helper_source": "seq2seq_abcd_vae_tpu_torch/csrc/wgrad.cu",
        "replaces": "seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:435",
        "launches": launches_bwd, "max_abs_err": bwd_abs,
        "max_rel_err": max(v for k, v in checks.items()
                           if k.startswith("bwd")),
        "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": b_bms,
        "bound_by": b_by, "library_ms": lib_bwd_ms,
        "library_call": "nn.LSTM (bidirectional) forward + backward, "
                        "packed",
        "tolerance": f"{GRAD_FRACTION} of each leaf's max |value|"})
    return fwd_entry, bwd_entry


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "seq2seq_abcd_vae_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    from seq2seq_abcd_vae_tpu_torch.ops import _build

    smi = smi_line()
    print(smi, flush=True)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False  # the yardstick in float32
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)

    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"nvcc {name}: {line.strip()}")
    print(f"built {sorted(reports) or 'nothing (cached)'} in "
          f"{build_s:.2f} s", flush=True)

    work = tempfile.mkdtemp(prefix="abcd-smoke-")
    if len(work) > 80:  # a Unix socket path holds at most 107 bytes
        shutil.rmtree(work)
        work = tempfile.mkdtemp(prefix="abcd-smoke-", dir="/tmp")
    try:
        return run(args, root, dev, rng, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(args, root, dev, rng, work) -> int:
    from seq2seq_abcd_vae_tpu_torch.ops import lstm_kernel, stft_kernel

    ckpt32 = make_checkpoint(os.path.join(work, "fs32000"), 129, args.seed)
    ckpt16 = make_checkpoint(os.path.join(work, "fs16000"), 65,
                             args.seed + 1)
    # fs=44100: frame 352, 177 bins, which take the STFT's mixed-radix FFT
    # passes and, too wide for the raw cluster's shared memory, the LSTM's
    # "proj" design; fs=26000: frame 208 (half 8 * 13), the DFT route
    ckpt44 = make_checkpoint(os.path.join(work, "fs44100"), 177,
                             args.seed + 2)
    ckpt26 = make_checkpoint(os.path.join(work, "fs26000"), 105,
                             args.seed + 3)
    common = ["-b", str(BATCH), "--stft_method", "pallas", "-d", "cuda"]

    # ---- the main path, counted -------------------------------------
    zero_counters()
    t_serve = time.perf_counter()

    reqs32 = random_requests(rng, 32000, 96)

    def probs_clients(path):
        return concurrent_clients(path, reqs32, 32000)

    (answers, latency), ping_probs = run_service(
        [ckpt32, str(NORMALIZER), "32000", "--mode", "probs"] + common,
        os.path.join(work, "probs.sock"), probs_clients)
    check_answers(answers, "probs", K)

    fixture = os.path.join(root, "fixtures", "toy_data")
    with open(os.path.join(
            fixture, "annotation_20170806-080002_89.2-94.22.csv")) as f:
        spans = list(csv.DictReader(f))

    def wav_clients(path):
        c = Client(path)
        try:
            return [c.call({"id": i, "wav": os.path.join(
                fixture, s["input_path"]), "onset": float(s["onset"]),
                "offset": float(s["offset"])}) for i, s in enumerate(spans)]
        finally:
            c.close()

    wav_answers, ping_logits = run_service(
        [ckpt16, str(NORMALIZER), "16000", "--mode", "logits"] + common,
        os.path.join(work, "logits.sock"), wav_clients)
    check_answers(wav_answers, "logits", K)

    reqs_feat = random_requests(rng, 32000, 8)
    (feat_answers, _), ping_feat = run_service(
        [ckpt32, str(NORMALIZER), "32000", "--mode", "features"] + common,
        os.path.join(work, "features.sock"),
        lambda path: concurrent_clients(path, reqs_feat, 32000, clients=2))
    check_answers(feat_answers, "features", FEATURE_DIM)

    reqs44 = random_requests(rng, 44100, 16)
    (answers44, _), ping44 = run_service(
        [ckpt44, str(NORMALIZER), "44100", "--mode", "probs"] + common,
        os.path.join(work, "probs44.sock"),
        lambda path: concurrent_clients(path, reqs44, 44100, clients=2))
    check_answers(answers44, "probs", K)

    reqs26 = random_requests(rng, 26000, 8)
    (answers26, _), ping26 = run_service(
        [ckpt26, str(NORMALIZER), "26000", "--mode", "probs"] + common,
        os.path.join(work, "probs26.sock"),
        lambda path: concurrent_clients(path, reqs26, 26000, clients=2))
    check_answers(answers26, "probs", K)

    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    # the per-tile forward's main path is the widest encoder's training
    launches = {name: fn.launches for name, fn in training_counters().items()
                if name.startswith(("log_spectrogram",
                                    "lstm_layer_bidir_fused"))
                and "_bwd" not in name
                and name != "lstm_layer_bidir_fused_tile"}
    expected(training_counters())  # each wrapper's routes sum to its count
    batches = sum(p["stats"]["batches"]
                  for p in (ping_probs, ping_logits, ping_feat, ping44,
                            ping26))
    print(f"main path: {len(reqs32)} probs + {len(spans)} wav logits + "
          f"{len(reqs_feat)} features requests + {len(reqs44)} probs at "
          f"fs=44100 + {len(reqs26)} probs at fs=26000, {batches} batches "
          f"(warm-up included) in {serve_s:.2f} s; launches {launches}",
          flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    lat = np.asarray(latency)
    serve = {"requests": len(lat), "clients": 4,
             "latency_ms_p50": float(np.percentile(lat, 50)),
             "latency_ms_p90": float(np.percentile(lat, 90)),
             "latency_ms_max": float(lat.max()),
             "batches": batches,
             "launches_per_batch": {k: v / batches
                                    for k, v in launches.items()}}
    print("serve " + json.dumps(serve), flush=True)

    # ---- the training main path, counted ----------------------------
    train = train_phase(dev, work, args.seed)
    print("training throughput " + json.dumps(train["throughput"]),
          flush=True)

    # ---- the unidirectional slice's main paths, each counted ---------
    corpus_dir, csv_path = train["corpus_dir"], train["csv"]
    uni = uni_train_phase(dev, work, corpus_dir, csv_path, args.seed)
    print("unidirectional training throughput " + json.dumps(
        {k: uni[k] for k in ("segments_per_s_after_first_epoch",
                             "epochs")}), flush=True)
    enc_cli = encode_cli_phase(
        dev, work, corpus_dir, csv_path,
        {"uni": uni["checkpoint"],
         "bidir": os.path.join(work, "train", "checkpoint.pt")})
    print("encode CLI " + json.dumps(enc_cli), flush=True)
    decode = decode_phase(dev, uni["checkpoint"], corpus_dir, csv_path,
                          args.seed)
    print("decode_features " + json.dumps(decode), flush=True)
    uni_lstm_serve = cell_serve_phase(work, uni["checkpoint"], rng,
                                      "uni-LSTM", "lstm_layer")
    if uni_lstm_serve["launches"]["lstm_layer_cluster"] <= 0:
        raise AssertionError("serving the unidirectional LSTM did not take "
                             "row 3's cluster route")
    print("unidirectional LSTM serve " + json.dumps(uni_lstm_serve),
          flush=True)
    # the per-tile routes of the LSTM encoder's kernels, on their main
    # paths: the widest encoder, which the cluster designs do not take
    wide = {u: wide_train_phase(dev, work, corpus_dir, csv_path, args.seed,
                                u) for u in (False, True)}

    # ---- the GRU slice's main paths, each counted ---------------------
    gru = cell_train_phase(dev, work, corpus_dir, csv_path, args.seed, "GRU",
                           {"gru_layer_bidir_fused": "steps",
                            "gru_layer_bidir_fused_bwd": "train",
                            "gru_decoder_loop_fused_losses_fwd": "steps",
                            "gru_decoder_loop_fused_losses_bwd": "train"})
    print("GRU training throughput " + json.dumps(
        {k: gru[k] for k in ("segments_per_s_after_first_epoch",
                             "epochs")}), flush=True)
    gru_enc = encode_cli_phase(dev, work, corpus_dir, csv_path,
                               {"gru": gru["checkpoint"]},
                               modes=("probs", "features"),
                               formats=("csv",))
    print("GRU encode CLI " + json.dumps(gru_enc), flush=True)
    gru_serve = cell_serve_phase(work, gru["checkpoint"], rng, "GRU",
                                 "gru_layer_bidir_fused")
    print("GRU serve " + json.dumps(gru_serve), flush=True)

    # ---- the Elman / ESN slice's main paths, each counted -------------
    elman = {"rnn_layer_bidir_fused": "steps",
             "rnn_decoder_loop_fused_losses_fwd": "steps",
             "rnn_decoder_loop_fused_losses_bwd": "train"}
    rnn = cell_train_phase(dev, work, corpus_dir, csv_path, args.seed, "RNN",
                           dict(elman, rnn_layer_bidir_fused_bwd="train"))
    print("RNN training throughput " + json.dumps(
        {k: rnn[k] for k in ("segments_per_s_after_first_epoch",
                             "epochs")}), flush=True)
    # the ESN's frozen reservoir takes no backward kernel
    esn = cell_train_phase(dev, work, corpus_dir, csv_path, args.seed, "ESN",
                           elman, extra=("--esn_leak", "0.5"))
    print("ESN training throughput " + json.dumps(
        {k: esn[k] for k in ("segments_per_s_after_first_epoch", "epochs",
                             "reservoir_tensors_unchanged")}), flush=True)
    elman_enc = encode_cli_phase(dev, work, corpus_dir, csv_path,
                                 {"rnn": rnn["checkpoint"],
                                  "esn": esn["checkpoint"]},
                                 modes=("probs",), formats=("csv",))
    print("RNN / ESN encode CLI " + json.dumps(elman_enc), flush=True)
    esn_serve = cell_serve_phase(work, esn["checkpoint"], rng, "ESN",
                                 "rnn_layer_bidir_fused")
    print("ESN serve " + json.dumps(esn_serve), flush=True)

    # ---- the unidirectional GRU / Elman / ESN slice's main paths, each
    # counted: only the one-direction layer kernels (no layer backward
    # under the ESN's frozen reservoir), never a bidirectional one
    elman_dec = {"rnn_decoder_loop_fused_losses_fwd": "steps",
                 "rnn_decoder_loop_fused_losses_bwd": "train"}
    uni_cells = {}
    for cell, kernels_, extra in (
            ("GRU", {"gru_layer": "steps", "gru_layer_bwd": "train",
                     "gru_decoder_loop_fused_losses_fwd": "steps",
                     "gru_decoder_loop_fused_losses_bwd": "train"}, ()),
            ("RNN", dict(elman_dec, rnn_layer="steps", rnn_layer_bwd="train"),
             ()),
            ("ESN", dict(elman_dec, rnn_layer="steps"),
             ("--esn_leak", "0.5"))):
        uni_cells[cell] = cell_train_phase(
            dev, work, corpus_dir, csv_path, args.seed, cell, kernels_,
            extra=extra, unidirectional=True)
        print(f"unidirectional {cell} training throughput " + json.dumps(
            {k: uni_cells[cell][k] for k in (
                "segments_per_s_after_first_epoch", "epochs",
                "reservoir_tensors_unchanged")}), flush=True)
    uni_enc = encode_cli_phase(
        dev, work, corpus_dir, csv_path,
        {f"uni_{cell.lower()}": r["checkpoint"]
         for cell, r in uni_cells.items()},
        modes=("probs",), formats=("csv",))
    print("unidirectional GRU / RNN / ESN encode CLI " + json.dumps(uni_enc),
          flush=True)
    uni_serve = cell_serve_phase(work, uni_cells["GRU"]["checkpoint"], rng,
                                 "uni-GRU", "gru_layer")
    print("unidirectional GRU serve " + json.dumps(uni_serve), flush=True)
    uni_decode = {cell: decode_phase(dev, uni_cells[cell]["checkpoint"],
                                     corpus_dir, csv_path, args.seed,
                                     loop=loop)
                  for cell, loop in (("GRU", "gru_decoder_loop"),
                                     ("ESN", "rnn_decoder_loop"))}
    for cell, result in uni_decode.items():
        print(f"decode_features ({cell} decoder) " + json.dumps(result),
              flush=True)

    # ---- the stream slice's main paths, each counted: the training CLI
    # with the JAX package's switch (the sampled loops and their
    # backwards, no fused-loss kernel), and the LSTM's loss-only call
    # without offset targets (the fused-NLL loop)
    stream = {}
    for cell, env, extra in STREAM_RUNS:
        stream[cell] = stream_train_phase(dev, work, corpus_dir, csv_path,
                                          args.seed, cell, env, extra)
        print(f"stream-path {cell} training throughput " + json.dumps(
            {k: stream[cell][k] for k in (
                "env", "segments_per_s_after_first_epoch", "epochs")}),
              flush=True)
    nll = nll_phase(dev, os.path.join(work, "train", "checkpoint.pt"),
                    corpus_dir, csv_path, args.seed)
    print("loss-only call without offset targets (LSTM) " + json.dumps(nll),
          flush=True)

    # ---- this slice's main paths, each counted: the launch-cost probe and
    # selector (checked first), training with SEQ2SEQ_KERNEL_RNG=1, and the
    # kernel-RNG check on the trained checkpoints of every cell
    probe = probe_phase(dev)
    rng_train = kernel_rng_train_phase(dev, work, corpus_dir, csv_path,
                                       args.seed)
    print("kernel-RNG training throughput " + json.dumps(
        {k: rng_train[k] for k in ("segments_per_s_after_first_epoch",
                                   "epochs")}), flush=True)
    rng_check = kernel_rng_parity_phase(
        dev, {"LSTM": os.path.join(work, "train", "checkpoint.pt"),
              "GRU": gru["checkpoint"], "RNN": rnn["checkpoint"],
              "ESN": esn["checkpoint"]}, corpus_dir, csv_path, args.seed)
    rng_check_launches = {}
    for result in rng_check.values():
        for k, n in result["launches"].items():
            rng_check_launches[k] = rng_check_launches.get(k, 0) + n

    # ---- this slice's main paths, each counted: the plain Gaussian VAE
    # trained, encoded in params mode, served and decoded through the
    # port's entry points, and the two-direction layer over xp (row 4) by
    # a direct call of its public function
    plain = plain_train_phase(dev, work, corpus_dir, csv_path, args.seed)
    print("plain VAE training throughput " + json.dumps(
        {k: plain[k] for k in ("segments_per_s_after_first_epoch",
                               "epochs")}), flush=True)
    plain_enc = plain_encode_phase(dev, work, corpus_dir, csv_path,
                                   plain["checkpoint"])
    print("plain VAE encode CLI (params) " + json.dumps(plain_enc),
          flush=True)
    plain_serve = plain_serve_phase(work, plain["checkpoint"], rng)
    print("plain VAE serve (params) " + json.dumps(plain_serve), flush=True)
    plain_decode = decode_phase(dev, plain["checkpoint"], corpus_dir,
                                csv_path, args.seed)
    print("decode_features (plain VAE) " + json.dumps(plain_decode),
          flush=True)
    pair = lstm_pair_path(dev, rng)
    print("lstm_layer_bidir direct call " + json.dumps(pair), flush=True)

    paths = {"serve": launches, "train": train["launches"],
             "uni_train": uni["launches"], "encode_cli": enc_cli["launches"],
             "decode": decode["launches"],
             "uni_lstm_serve": uni_lstm_serve["launches"],
             "wide_lstm_train": wide[False]["launches"],
             "wide_uni_lstm_train": wide[True]["launches"],
             "gru_train": gru["launches"],
             "gru_encode_cli": gru_enc["launches"],
             "gru_serve": gru_serve["launches"],
             "rnn_train": rnn["launches"], "esn_train": esn["launches"],
             "elman_encode_cli": elman_enc["launches"],
             "esn_serve": esn_serve["launches"],
             "uni_gru_train": uni_cells["GRU"]["launches"],
             "uni_rnn_train": uni_cells["RNN"]["launches"],
             "uni_esn_train": uni_cells["ESN"]["launches"],
             "uni_cells_encode_cli": uni_enc["launches"],
             "uni_gru_serve": uni_serve["launches"],
             "uni_gru_decode": uni_decode["GRU"]["launches"],
             "uni_esn_decode": uni_decode["ESN"]["launches"],
             "stream_lstm_train": stream["LSTM"]["launches"],
             "stream_gru_train": stream["GRU"]["launches"],
             "stream_esn_train": stream["ESN"]["launches"],
             "nll_loss_only": nll["launches"],
             "kernel_rng_train": rng_train["launches"],
             "kernel_rng_check": rng_check_launches,
             "plain_train": plain["launches"],
             "plain_encode_cli": plain_enc["launches"],
             "plain_serve": plain_serve["launches"],
             "plain_decode": plain_decode["launches"],
             "lstm_layer_bidir_direct_call": pair["launches"]}

    def by_path(name):
        return {p: counts.get(name, 0) for p, counts in paths.items()}

    def total(name):
        return sum(by_path(name).values())

    # ---- kernels vs twins, times ------------------------------------
    kernels = [*stft_phase(dev, rng, {r: total(f"log_spectrogram_{r}")
                                      for r in ("fft", "mixed", "dft")}),
               *lstm_phase(dev, rng, {
                   d: total(f"lstm_layer_bidir_fused_{d}")
                   for d in LSTM_DESIGNS})]
    step_errs, breakdown = step_phase(dev, ckpt32, rng)
    print("encode_step kernels vs twins " + json.dumps(step_errs),
          flush=True)
    print(f"served batch B={BATCH} T=512 fs=32000, ms "
          + json.dumps(breakdown), flush=True)
    # the 44.1 kHz served batch: the STFT's mixed-radix passes and row 2's
    # "proj" design
    step44_errs, breakdown44 = step_phase(dev, ckpt44, rng, fs=44100,
                                          modes=("probs",))
    print("encode_step at fs=44100, kernels vs twins "
          + json.dumps(step44_errs), flush=True)
    print(f"served batch B={BATCH} T=512 fs=44100, ms "
          + json.dumps(breakdown44), flush=True)
    if set(breakdown44["launches_by_route"]) != {
            "log_spectrogram_mixed", "lstm_layer_bidir_fused_proj"}:
        raise AssertionError("the 44.1 kHz served batch took the routes "
                             f"{breakdown44['launches_by_route']}")

    checks, step_inputs = whole_step_phase(dev, corpus_dir, csv_path,
                                           args.seed)
    stages, shape = train_step_breakdown(dev, *step_inputs)
    uni_checks, uni_inputs = whole_step_phase(dev, corpus_dir, csv_path,
                                              args.seed, bidirectional=False)
    uni_stages, uni_shape = train_step_breakdown(dev, *uni_inputs)
    t_train = shape["T"]
    lstm_bwds, lstm_fwd_cs = lstm_train_phase(
        dev, rng, t_train, total("lstm_layer_bidir_fused_bwd_cluster"),
        total("lstm_layer_bidir_fused_bwd_tile"))
    # row 2's per-tile route at its training path's width, beside its
    # served shape
    row2_tile = next(e for e in kernels
                     if e["name"] == "lstm_layer_bidir_fused_tile")
    wide_fwd = lstm_fwd_cs.pop("per_tile_forward_at_h1024")
    row2_tile.update(wide_fwd, max_abs_err=max(
        row2_tile["max_abs_err"], wide_fwd["main_path_shape_max_abs_err"]))
    dec_fwd, dec_bwd = decoder_train_phase(
        dev, rng, t_train, total("decoder_loop_fused_losses_fwd"),
        total("decoder_loop_fused_losses_bwd"))
    uni_fwds, uni_bwds = lstm_layer_phase(
        dev, rng, total("lstm_layer_cluster"), total("lstm_layer_tile"),
        {k: total(k) for k in ("lstm_layer_bwd", "lstm_layer_bwd_cluster",
                               "lstm_layer_bwd_tile")})
    loop = decoder_loop_phase(dev, rng, total("decoder_loop"))
    gru_checks, gru_inputs = whole_step_phase(dev, corpus_dir, csv_path,
                                              args.seed, rnn_type="GRU")
    gru_stages, gru_shape = train_step_breakdown(dev, *gru_inputs)
    gru_fwd, gru_bwd = gru_layer_phase(
        dev, rng, t_train, total("gru_layer_bidir_fused"),
        total("gru_layer_bidir_fused_bwd"))
    gru_dec_fwd, gru_dec_bwd = decoder_train_phase(
        dev, rng, t_train, total("gru_decoder_loop_fused_losses_fwd"),
        total("gru_decoder_loop_fused_losses_bwd"), cell="GRU")
    rnn_checks, rnn_inputs = whole_step_phase(dev, corpus_dir, csv_path,
                                              args.seed, rnn_type="RNN")
    rnn_stages, rnn_shape = train_step_breakdown(dev, *rnn_inputs)
    esn_checks, esn_inputs = whole_step_phase(dev, corpus_dir, csv_path,
                                              args.seed, rnn_type="ESN",
                                              esn_leak=0.5)
    esn_stages, esn_shape = train_step_breakdown(dev, *esn_inputs)
    elman_fwd, elman_bwd = elman_layer_phase(
        dev, rng, t_train, total("rnn_layer_bidir_fused"),
        total("rnn_layer_bidir_fused_bwd"))
    rnn_dec_fwd, rnn_dec_bwd = decoder_train_phase(
        dev, rng, t_train, total("rnn_decoder_loop_fused_losses_fwd"),
        total("rnn_decoder_loop_fused_losses_bwd"), cell="RNN")
    uni_steps = {}
    for cell, leak in (("GRU", 1.0), ("RNN", 1.0), ("ESN", 0.5)):
        checks_, inputs_ = whole_step_phase(
            dev, corpus_dir, csv_path, args.seed, bidirectional=False,
            rnn_type=cell, esn_leak=leak)
        uni_steps[cell] = (checks_, *train_step_breakdown(dev, *inputs_))
    gru_uni_fwd, gru_uni_bwd = one_direction_layer_phase(
        dev, rng, t_train, "GRU", total("gru_layer"), total("gru_layer_bwd"))
    rnn_uni_fwd, rnn_uni_bwd = one_direction_layer_phase(
        dev, rng, t_train, "RNN", total("rnn_layer"), total("rnn_layer_bwd"))
    gru_loop = cell_loop_phase(dev, rng, "GRU", total("gru_decoder_loop"))
    rnn_loop = cell_loop_phase(dev, rng, "RNN", total("rnn_decoder_loop"))
    loop_bwds = [loop_backward_phase(dev, rng, t_train, cell,
                                     total(LOOP_OF[cell] + "_bwd"))
                 for cell in ("LSTM", "GRU", "RNN")]
    nll_fwd, nll_bwd = fused_nll_kernel_phase(
        dev, rng, t_train, total("decoder_loop_fused_nll_fwd"),
        total("decoder_loop_fused_nll_bwd"))
    stream_steps = {}
    for cell, leak in (("LSTM", 1.0), ("GRU", 1.0), ("ESN", 0.5)):
        checks_, inputs_ = whole_step_phase(
            dev, corpus_dir, csv_path, args.seed, rnn_type=cell,
            esn_leak=leak, fused_cells=())
        stream_steps[cell] = (checks_, *train_step_breakdown(
            dev, *inputs_, fused_cells=()))
    wide = wide_hidden_phase(dev, rng)
    plain_checks, plain_inputs = whole_step_phase(
        dev, corpus_dir, csv_path, args.seed, latent="gaussian")
    plain_stages, plain_shape = train_step_breakdown(dev, *plain_inputs)
    pair_entries = lstm_pair_phase(dev, rng, total("lstm_layer_bidir"),
                                   total("lstm_layer_bidir_bwd"))
    seed_entries = []
    for cell in ("LSTM", "GRU", "RNN"):
        name = SEED_COUNTERS[cell]
        seed_entries += seed_kernel_phase(dev, rng, t_train, cell,
                                          total(name + "_fwd"),
                                          total(name + "_bwd"))
    kernels += [*lstm_bwds, dec_fwd, dec_bwd, *uni_fwds, *uni_bwds, loop,
                gru_fwd,
                gru_bwd, gru_dec_fwd, gru_dec_bwd, elman_fwd, elman_bwd,
                rnn_dec_fwd, rnn_dec_bwd, gru_uni_fwd, gru_uni_bwd,
                rnn_uni_fwd, rnn_uni_bwd, gru_loop, rnn_loop, *loop_bwds,
                nll_fwd, nll_bwd,
                probe_entry(dev, total("launch_cost_probe"), probe),
                noise_dump_phase(dev, total("decoder_noise_dump"), t=t_train),
                *seed_entries, *pair_entries]
    counter_names = set(all_counters()) | {"launch_cost_probe"}
    for entry in kernels:
        key = entry["name"]
        if key not in counter_names:  # a forward's counter
            key += "_fwd"
        entry["launches_by_path"] = by_path(key)
        if entry["launches"] <= 0:
            raise AssertionError(f"kernel {entry['name']} was launched on "
                                 "no main path")
        lacking = KERNEL_KEYS - set(entry)
        if lacking:
            raise AssertionError(f"kernel {entry['name']} lacks {lacking}")
    if len(kernels) != 45:
        raise AssertionError(f"{len(kernels)} kernel entries, expected 45")
    print("training step, kernels (card) vs twins (CPU) "
          + json.dumps(checks), flush=True)
    print("unidirectional training step, kernels (card) vs twins (CPU) "
          + json.dumps(uni_checks), flush=True)
    print("LSTM forward with saved cs at the training shape "
          + json.dumps(lstm_fwd_cs), flush=True)
    print(f"training step {json.dumps(shape)}, ms " + json.dumps(stages),
          flush=True)
    print(f"unidirectional training step {json.dumps(uni_shape)}, ms "
          + json.dumps(uni_stages), flush=True)
    print("GRU training step, kernels (card) vs twins (CPU) "
          + json.dumps(gru_checks), flush=True)
    print(f"GRU training step {json.dumps(gru_shape)}, ms "
          + json.dumps(gru_stages), flush=True)
    for cell, checks_, shape_, stages_ in (
            ("RNN", rnn_checks, rnn_shape, rnn_stages),
            ("ESN", esn_checks, esn_shape, esn_stages)):
        print(f"{cell} training step, kernels (card) vs twins (CPU) "
              + json.dumps(checks_), flush=True)
        print(f"{cell} training step {json.dumps(shape_)}, ms "
              + json.dumps(stages_), flush=True)
    for cell, (checks_, stages_, shape_) in uni_steps.items():
        print(f"unidirectional {cell} training step, kernels (card) vs twins "
              "(CPU) " + json.dumps(checks_), flush=True)
        print(f"unidirectional {cell} training step {json.dumps(shape_)}, ms "
              + json.dumps(stages_), flush=True)
    fused_steps = {"LSTM": (shape, stages), "GRU": (gru_shape, gru_stages),
                   "ESN": (esn_shape, esn_stages)}
    for cell, (checks_, stages_, shape_) in stream_steps.items():
        print(f"stream-path {cell} training step, kernels (card) vs twins "
              "(CPU) and vs the fused path (card) " + json.dumps(checks_),
              flush=True)
        print(f"stream-path {cell} training step {json.dumps(shape_)}, ms "
              + json.dumps(stages_) + "; fused path, ms "
              + json.dumps(fused_steps[cell][1]), flush=True)
    print("hidden size 1024, kernels vs twins " + json.dumps(wide),
          flush=True)
    print("plain VAE training step, kernels (card) vs twins (CPU) "
          + json.dumps(plain_checks), flush=True)
    print(f"plain VAE training step {json.dumps(plain_shape)}, ms "
          + json.dumps(plain_stages), flush=True)
    print("launch-cost probe and selector " + json.dumps(probe), flush=True)

    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
