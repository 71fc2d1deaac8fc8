"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
library lands in ``build/kernels/`` at the repository root (git-ignored),
named by a hash of its source and flags, so a changed source rebuilds and
an unchanged one is built once per checkout.  Nothing is built at import:
the first launch builds, or :func:`build` builds every kernel at once,
one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"stft": _PKG / "csrc" / "stft.cu",
           "lstm": _PKG / "csrc" / "lstm.cu",
           "gru": _PKG / "csrc" / "gru.cu",
           "elman": _PKG / "csrc" / "elman.cu",
           "decoder": _PKG / "csrc" / "decoder.cu",
           "wgrad": _PKG / "csrc" / "wgrad.cu",
           "probe": _PKG / "csrc" / "probe.cu"}
BUILD_DIR = _PKG.parent / "build" / "kernels"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# argument types of each library's entry points, pointers and the stream
# as c_void_p so that ctypes never cuts them to 32 bits
SIGNATURES = {
    "stft": {"abcd_log_spectrogram":
             [_P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
             "abcd_log_spectrogram_fft":
             [_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P]},
    "lstm": {"abcd_lstm_bidir_fwd": [_P] * 10 + [_I] * 5 + [_P],
             "abcd_lstm_bidir_fwd_cluster": [_P] * 10 + [_I] * 4 + [_P],
             "abcd_lstm_cluster_max_active": [_I] * 2,
             "abcd_lstm_fwd_cluster": [_P] * 8 + [_I] * 5 + [_P],
             "abcd_lstm_fwd_cluster_max_active": [_I] * 2,
             "abcd_lstm_pair_cluster_max_active": [_I] * 2,
             "abcd_lstm_bidir_xp": [_P] * 5 + [_I] * 4 + [_P],
             "abcd_lstm_bidir_fwd_proj": [_P] * 8 + [_I] * 4 + [_P],
             "abcd_lstm_bwd_cluster_max_active": [_I] * 2,
             "abcd_lstm_span_prefix": [_P, _P, _I, _I, _P],
             "abcd_lstm_bidir_gates": [_P] * 9 + [_I] * 4 + [_P],
             "abcd_lstm_bidir_bwd_cluster": [_P] * 7 + [_I] * 4 + [_P],
             "abcd_lstm_bwd_cluster": [_P] * 7 + [_I] * 5 + [_P],
             "abcd_lstm_bidir_dx": [_P] * 4 + [_I] * 4 + [_P],
             "abcd_lstm_layer_gates": [_P] * 6 + [_I] * 4 + [_P],
             "abcd_lstm_bwd_grid": [_P] * 10 + [_I] * 5 + [_P],
             "abcd_lstm_wgrad_splits": [_I] * 5,
             "abcd_lstm_wgrad": [_P] * 8 + [_I] * 7 + [_P],
             "abcd_lstm_fwd": [_P] * 8 + [_I] * 5 + [_P],
             "abcd_lstm_bidir_proj_fwd": [_P] * 8 + [_I] * 4 + [_P],
             "abcd_lstm_bidir_proj_bwd": [_P] * 12 + [_I] * 4 + [_P],
             "abcd_lstm_rows": [_I] * 3,
             "abcd_lstm_smem_bytes": [_I] * 4,
             "abcd_lstm_smem_limit": [_I] * 2},
    "gru": {"abcd_gru_bidir_fwd": [_P] * 8 + [_I] * 5 + [_P],
            "abcd_gru_fwd": [_P] * 6 + [_I] * 5 + [_P],
            "abcd_gru_bidir_bwd": [_P] * 15 + [_I] * 5 + [_P],
            "abcd_gru_bwd": [_P] * 11 + [_I] * 5 + [_P],
            "abcd_gru_rows": [_I] * 3,
            "abcd_gru_smem_bytes": [_I] * 4,
            "abcd_gru_smem_limit": [_I] * 2},
    "elman": {"abcd_elman_bidir_fwd": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
              "abcd_elman_fwd": [_P] * 6 + [_I] * 3 + [_F, _I, _I, _P],
              "abcd_elman_bidir_bwd": [_P] * 14 + [_I] * 4 + [_F, _I, _P],
              "abcd_elman_bwd": [_P] * 10 + [_I] * 3 + [_F, _I, _I, _P],
              "abcd_elman_rows": [_I] * 3,
              "abcd_elman_smem_bytes": [_I] * 4,
              "abcd_elman_smem_limit": [_I] * 2},
    "decoder": {"abcd_decoder_fwd": [_P] * 21 + [_I] * 8 + [_P],
                "abcd_decoder_loop_fwd": [_P] * 16 + [_I] * 6 + [_P],
                "abcd_gru_decoder_loop_fwd": [_P] * 13 + [_I] * 6 + [_P],
                "abcd_rnn_decoder_loop_fwd":
                    [_P] * 12 + [_I] * 5 + [_F, _I, _P],
                "abcd_decoder_bwd": [_P] * 36 + [_I] * 8 + [_P],
                "abcd_gru_decoder_fwd": [_P] * 20 + [_I] * 8 + [_P],
                "abcd_gru_decoder_bwd": [_P] * 35 + [_I] * 8 + [_P],
                "abcd_rnn_decoder_fwd":
                    [_P] * 19 + [_I] * 6 + [_F, _I, _I, _P],
                "abcd_rnn_decoder_bwd":
                    [_P] * 33 + [_I] * 6 + [_F, _I, _I, _P],
                "abcd_decoder_loop_bwd": [_P] * 27 + [_I] * 6 + [_P],
                "abcd_gru_decoder_loop_bwd": [_P] * 24 + [_I] * 6 + [_P],
                "abcd_rnn_decoder_loop_bwd":
                    [_P] * 22 + [_I] * 5 + [_F, _I, _P],
                "abcd_decoder_nll_fwd": [_P] * 17 + [_I] * 6 + [_P],
                "abcd_decoder_nll_bwd": [_P] * 27 + [_I] * 6 + [_P],
                "abcd_decoder_noise_dump": [_P, _P, _P, _I, _I, _I, _P],
                "abcd_decoder_rows": [_I] * 5,
                "abcd_decoder_smem_bytes": [_I] * 6,
                "abcd_decoder_smem_limit": [_I] * 2},
    "wgrad": {"abcd_wgrad": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P],
              "abcd_wgrad_splits": [_I, _I, _I],
              "abcd_add2": [_P, _P, _P, _L, _P]},
    "probe": {"abcd_probe_add_one": [_P, _P, _L, _P]},
}
# entry points that return a byte count; every other one returns an int
_LONG_RESULTS = {"abcd_lstm_smem_bytes", "abcd_lstm_smem_limit",
                 "abcd_gru_smem_bytes", "abcd_gru_smem_limit",
                 "abcd_elman_smem_bytes", "abcd_elman_smem_limit",
                 "abcd_decoder_smem_bytes", "abcd_decoder_smem_limit"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Launches:
    """A launch count beside a wrapper's own: the decoder kernels' seed
    mode (counted here only), or one route of a wrapper with two kernels
    (counted here and on the wrapper)."""

    def __init__(self):
        self.launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit on the machine with the card")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=tuple(SOURCES)) -> dict[str, str]:
    """Compile every named kernel that is not built yet, in parallel.

    Returns ``{name: ptxas report}`` for the kernels compiled by this call
    (register and shared-memory use from ``-Xptxas -v``).  Raises with the
    compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        # unique temporary name, then an atomic rename: concurrent
        # builders (two processes, two threads) never see a partial file
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (built first if missing)."""
    path = library_path(name)
    if not path.exists():
        build((name,))
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = _L if fn_name in _LONG_RESULTS else ctypes.c_int
    lib.abcd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.abcd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def row_tile(lib: ctypes.CDLL, family: str, kind: int, dims, what: str) -> int:
    """The row tile (8, 4 or 2 batch rows per block) that the library picks
    for kernel ``kind`` of ``family`` (``lstm``, ``gru``, ``elman`` or
    ``decoder``) at
    the widths ``dims``: the largest whose shared memory fits the card.
    Raises ValueError when even 2 rows need more shared memory than a
    block may have."""
    rows = getattr(lib, f"abcd_{family}_rows")(kind, *dims)
    if rows == 0:
        need = getattr(lib, f"abcd_{family}_smem_bytes")(kind, 2, *dims)
        limit = getattr(lib, f"abcd_{family}_smem_limit")(kind, 2)
        raise ValueError(
            f"{what} at widths {tuple(dims)} needs {need} bytes of shared "
            f"memory per block even at 2 rows a block; this card admits "
            f"{limit}")
    return rows


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.abcd_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")
