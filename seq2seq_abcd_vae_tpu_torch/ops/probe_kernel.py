"""The launch-cost probe: the CUDA kernel ``csrc/probe.cu`` (y = x + 1),
its plain twin, and the marginal cost of one hand-written launch.

Replaces seq2seq_abcd_vae_tpu/utils/backend_select.py:_measure_concrete
(its ``probe`` ``pallas_call``).  :func:`marginal_launch_ms` keeps that
function's method: one warm launch of the kernel and of torch's own
``x + 1`` on an (8, 128) float32 tensor, then 3 samples, each of 8
pipelined launches of torch's ``x + 1`` and then of the kernel, each run
closed by ``utils.sync.wait``; a sample is max(0, kernel ms - torch ms)
per launch, and the result is their median.  A first sample above 10x the
limit (``SEQ2SEQ_PALLAS_DISPATCH_MS_MAX``, default 20 ms) decides alone.
Nothing is caught: a probe that fails to build or launch raises.
"""

from __future__ import annotations

import os
import statistics
import time

import torch

from . import _build
from ..utils import sync

DEFAULT_MAX_MS = 20.0
PROBE_SHAPE = (8, 128)
SAMPLES = 3
PIPELINED = 8


def dispatch_limit_ms() -> float:
    """The selector's limit: ``SEQ2SEQ_PALLAS_DISPATCH_MS_MAX``, default
    20 ms (the JAX package's)."""
    return float(os.environ.get("SEQ2SEQ_PALLAS_DISPATCH_MS_MAX",
                                DEFAULT_MAX_MS))


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the probe kernel."""
    return x + 1.0


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 for a contiguous float32 tensor.  CUDA tensors launch the
    kernel (one count); CPU tensors take ``add_one_plain``."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the probe takes a contiguous float32 tensor")
    if x.device.type == "cpu":
        return add_one_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = _build.load("probe")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.abcd_probe_add_one(x.data_ptr(), y.data_ptr(), x.numel(),
                                     stream)
    _build.check(lib, err, "launch-cost probe")
    add_one.launches += 1
    return y


add_one.launches = 0


def _per_launch_ms(fn, x: torch.Tensor) -> float:
    t0 = time.perf_counter()
    y = x
    for _ in range(PIPELINED):
        y = fn(y)
    sync.wait(y)
    return (time.perf_counter() - t0) * 1e3 / PIPELINED


def marginal_launch_ms(device) -> float:
    """The marginal cost of one launch of a hand-written kernel over one of
    PyTorch's own, in ms, on ``device`` (a CUDA device; on the CPU both
    sides are the same torch operation)."""
    x = torch.zeros(PROBE_SHAPE, dtype=torch.float32, device=device)
    sync.wait(add_one(x))       # the build and the first launch
    sync.wait(add_one_plain(x))
    limit = dispatch_limit_ms()
    samples = []
    for _ in range(SAMPLES):
        base_ms = _per_launch_ms(add_one_plain, x)
        kernel_ms = _per_launch_ms(add_one, x)
        samples.append(max(0.0, kernel_ms - base_ms))
        if samples[0] > 10.0 * limit:
            break  # one sample that far above the limit decides
    return statistics.median(samples)
