"""Weight-gradient reductions of the backward kernels: the CUDA kernel
``csrc/wgrad.cu`` and its plain twin.

The TPU backward kernels accumulate ``dW += a_t^T dz_t`` in VMEM across
their sequential grid.  The port's recurrent backward kernels write the
per-step operands and cotangents as (T, B, .) streams instead, and
:func:`at_b` reduces them over all T * B rows in a fixed order (no
atomics).  Only the backward wrappers of ``lstm_kernel`` and
``decoder_kernel`` call it, on CUDA tensors; their plain twins use
:func:`at_b_plain`.
"""

from __future__ import annotations

import torch

from . import _build


def at_b_plain(a, b):
    """``a^T b`` over the rows of two (R, K) / (R, N) views; ``a=None``
    means a column of ones (a bias gradient: the column sums of ``b``)."""
    if a is None:
        return b.sum(0, keepdim=True)
    return a.transpose(0, 1) @ b


def _rows(t: torch.Tensor):
    """(rows, row stride) of a 2-D view whose last dim is contiguous."""
    if t.dim() != 2 or t.stride(1) != 1:
        raise ValueError("expected a 2-D view with contiguous rows")
    return t.shape[0], t.stride(0)


def at_b(a, b):
    """``a^T b`` by the CUDA kernel (float32, CUDA tensors, views whose
    rows are contiguous); ``a=None`` gives the column sums of ``b``."""
    lib = _build.load("wgrad")
    r, ldb = _rows(b)
    n = b.shape[1]
    if a is None:
        k, lda, a_ptr = 1, 1, None
    else:
        ra, lda = _rows(a)
        if ra != r:
            raise ValueError(f"row counts differ: {ra} vs {r}")
        k, a_ptr = a.shape[1], a.data_ptr()
    out = torch.empty((k, n), dtype=torch.float32, device=b.device)
    splits = lib.abcd_wgrad_splits(r, k, n)
    ws = (torch.empty((splits, k, n), dtype=torch.float32, device=b.device)
          if splits > 1 else None)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    err = lib.abcd_wgrad(a_ptr, lda, b.data_ptr(), ldb, out.data_ptr(), r,
                         k, n, splits, None if ws is None else ws.data_ptr(),
                         stream)
    _build.check(lib, err, "wgrad")
    return out


def add2(a, b):
    """``a + b`` by the same library (the two directions' dx)."""
    lib = _build.load("wgrad")
    out = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.abcd_add2(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                        a.numel(), stream)
    _build.check(lib, err, "add2")
    return out
