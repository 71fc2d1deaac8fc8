"""Reader and writer of the v2 ``checkpoint.pt`` container (own copy of the
JAX package's ``train/checkpoint.py`` format, zip + numpy only).

A v2 checkpoint is a zip archive: one ``meta.json`` entry (the format
version and every JSON-safe payload value, with placeholders for arrays)
and one ``.npy`` entry per array.  No pickle is written, and v2 loading
reads none.  The optimizer state is stored as its flat leaf list and
comes back as :class:`OptimizerLeaves`.

A round-1 checkpoint is a pickle of the payload dict.  The port reads it
with a restricted unpickler that admits only numpy's array and scalar
reconstructors, plain builtin containers and the JAX package's
``OptimizerLeaves`` (mapped to this module's, without importing that
package); any other name raises :class:`UnsupportedPickle`.  A plain
``pickle.load`` would import whatever the pickle names, jax included.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import tempfile
import zipfile
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

CHECKPOINT_NAME = "checkpoint.pt"
FORMAT_VERSION = 2

_ARRAY_MARKER = "__array__"
_OPT_MARKER = "__optimizer_leaves__"


@dataclass
class OptimizerLeaves:
    """Flat leaf list of a saved optimizer state."""
    leaves: list


def _encode(value, arrays: dict):
    """Payload value -> JSON-safe structure; arrays are pulled out into
    ``arrays`` and referenced by name."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    if isinstance(value, (np.ndarray, np.generic)):
        name = "a%d" % len(arrays)
        arrays[name] = np.asarray(value)
        return {_ARRAY_MARKER: name}
    if isinstance(value, dict):
        return {str(k): _encode(v, arrays) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode(v, arrays) for v in value]
    raise TypeError("checkpoint payload value of unsupported type "
                    "%r" % type(value))


def _decode(value, arrays):
    if isinstance(value, dict):
        if set(value) == {_ARRAY_MARKER}:
            return arrays[value[_ARRAY_MARKER]]
        if set(value) == {_OPT_MARKER}:
            n = value[_OPT_MARKER]
            return OptimizerLeaves([arrays["opt%d" % i] for i in range(n)])
        return {k: _decode(v, arrays) for k, v in value.items()}
    if isinstance(value, list):
        return [_decode(v, arrays) for v in value]
    return value


def save_checkpoint(save_dir: str, payload: dict[str, Any]) -> str:
    """Write ``payload`` atomically as ``save_dir/checkpoint.pt``."""
    path = os.path.join(save_dir, CHECKPOINT_NAME)
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {"format_version": FORMAT_VERSION}
    for k, v in payload.items():
        if k == "optimizer" and isinstance(v, OptimizerLeaves):
            for i, leaf in enumerate(v.leaves):
                arrays["opt%d" % i] = np.asarray(leaf)
            meta[k] = {_OPT_MARKER: len(v.leaves)}
        else:
            meta[k] = _encode(v, arrays)

    fd, tmp = tempfile.mkstemp(dir=save_dir, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as z:
                z.writestr("meta.json", json.dumps(meta))
                for name, arr in arrays.items():
                    buf = io.BytesIO()
                    np.save(buf, arr, allow_pickle=False)
                    z.writestr(name + ".npy", buf.getvalue())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


class UnsupportedPickle(pickle.UnpicklingError):
    """A round-1 checkpoint names something beyond numpy and builtins."""


# (module, name) pairs a round-1 checkpoint may name: numpy's array and
# scalar reconstructors (both numpy 1 and numpy 2 module paths) and plain
# builtin containers
_PICKLE_NUMPY = {"_reconstruct", "scalar", "_frombuffer", "ndarray",
                 "dtype"}
_PICKLE_NUMPY_MODULES = {"numpy", "numpy.core.multiarray",
                         "numpy._core.multiarray", "numpy.core.numeric",
                         "numpy._core.numeric"}
_PICKLE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int",
                    "float", "complex", "bool", "str", "bytes", "bytearray",
                    "slice", "range"}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _PICKLE_NUMPY_MODULES and name in _PICKLE_NUMPY:
            return super().find_class(module, name)
        if module == "builtins" and name in _PICKLE_BUILTINS:
            return super().find_class(module, name)
        if (module == "seq2seq_abcd_vae_tpu.train.checkpoint"
                and name == "OptimizerLeaves"):
            return OptimizerLeaves
        raise UnsupportedPickle(
            f"the round-1 checkpoint names {module}.{name}; the port reads "
            "only numpy arrays and builtin containers from a pickle (re-save "
            "the checkpoint in the v2 format with the JAX package)")


def _load_pickle(path: str) -> dict[str, Any]:
    try:
        with open(path, "rb") as f:
            return _RestrictedUnpickler(f).load()
    except UnsupportedPickle:
        raise
    except (pickle.UnpicklingError, EOFError) as e:
        raise ValueError(f"{path} is not a v2 (zip) checkpoint and does not "
                         f"read as a round-1 pickle ({e})") from e


def load_checkpoint(path: str) -> dict[str, Any]:
    """Read a checkpoint (v2, or a round-1 pickle) into dicts, lists and
    numpy arrays."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic != b"PK":
        return _load_pickle(path)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        arrays = {}
        for info in z.infolist():
            if info.filename.endswith(".npy"):
                arrays[info.filename[:-4]] = np.load(
                    io.BytesIO(z.read(info.filename)), allow_pickle=False)
    version = meta.pop("format_version", None)
    if version is None or version > FORMAT_VERSION:
        raise ValueError("unsupported checkpoint format version: %r "
                         "(this build reads <= %d)" % (version,
                                                       FORMAT_VERSION))
    return {k: _decode(v, arrays) for k, v in meta.items()}
