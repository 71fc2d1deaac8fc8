"""Carry parameter trees between the JAX package's layout and the port's.

The JAX package stores each recurrent layer per direction, with (in, out)
matrices: ``encoder.layers[l].{fwd,bwd}.{w_ih (F, gH), w_hh (H, gH),
b_ih (gH,), b_hh (gH,)}`` with g = 4 gates for the LSTM, 3 for the GRU
and 1 for the Elman RNN, and the echo-state (ESN) reservoir's
``{w_ih (F, H), w_hh (H, H)}`` without biases (the decoder's ESN cell
likewise); the ABCD head as ``feature_sampler.{to_code_like.{lin1,lin2}.{w, b},
codebook (f, K), posterior_shape_logits (K,)}``, the plain VAE's Gaussian
head as ``feature_sampler.to_parameters.{lin1,lin2}.{w, b}`` (k-stacked);
and the decoder as
``decoder.
{feature2hidden, rnn_cell, emission_sampler.to_parameters (k-stacked),
offset_predictor[, embed_speaker]}``.  The port keeps every layout but
one: it stacks the two directions of each bidirectional encoder layer on
a leading axis, since the kernels' public functions take
``w_ih (2, F, gH)``, ``w_hh (2, H, gH)`` and ``b_ih`` / ``b_hh (2, gH)``;
a unidirectional layer (``"fwd"`` only) keeps the JAX shapes.

The encoder loads tolerantly, as the JAX package's ``retrieve_model``
loads it (the reference's ``strict=False``): a key the checkpoint lacks
keeps its fresh initialisation and a key it has beyond the config's is
dropped, each with a logged warning.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs import DecoderConfig, EncoderConfig, check_served
from ..models.encoder import NUM_GATES, encoder_init
from ..tree import tree_map
from .logging_utils import logger

# the ABCD head's keys, and the plain VAE's Gaussian head's
_HEAD_KEYS = ("to_code_like", "codebook", "posterior_shape_logits",
              "to_parameters")


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _cell_shapes(rnn_type: str, in_size: int, hidden: int) -> dict:
    """One direction's recurrent tensors: the ESN's reservoir has no
    biases."""
    g = NUM_GATES[rnn_type] * hidden
    shapes = {"w_ih": (in_size, g), "w_hh": (hidden, g)}
    if rnn_type != "ESN":
        shapes.update(b_ih=(g,), b_hh=(g,))
    return shapes


def _decoder_shapes(cfg: DecoderConfig) -> dict:
    h, m, f = cfg.rnn_hidden_size, cfg.mlp_hidden_size, cfg.output_size
    feat = cfg.feature_size + (cfg.speaker_embed_dim
                               if cfg.has_speaker_embedding else 0)
    shapes = {
        "feature2hidden": {"w": (feat, cfg.hidden_size_total),
                           "b": (cfg.hidden_size_total,)},
        "rnn_cell": _cell_shapes(cfg.rnn_type, f, h),
        "emission_sampler": {"to_parameters": {
            "lin1": {"w": (2, h, m), "b": (2, m)},
            "lin2": {"w": (2, m, f), "b": (2, f)}}},
        "offset_predictor": {"lin1": {"w": (h, m), "b": (m,)},
                             "lin2": {"w": (m, 1), "b": (1,)}},
    }
    if cfg.has_speaker_embedding:
        shapes["embed_speaker"] = (cfg.num_speakers, cfg.speaker_embed_dim)
    return shapes


def _checked(tree, shapes, device, path="decoder") -> dict:
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            raise ValueError(f"{path} holds {sorted(tree)}, the config "
                             f"expects {sorted(shapes)}")
        return {k: _checked(tree[k], shapes[k], device, f"{path}.{k}")
                for k in shapes}
    arr = np.asarray(tree)
    if arr.shape != shapes:
        raise ValueError(f"{path} has shape {arr.shape}, the config "
                         f"expects {shapes}")
    return _tensor(arr, device)


def _flatten_paths(tree, prefix=""):
    """Leaves by "/"-joined dict path (a list is a leaf, as in the JAX
    package's overlay)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten_paths(v, prefix + "/" + str(k)))
    return out


def overlay_params(template: dict, loaded: dict, module_name: str) -> dict:
    """``loaded`` laid over ``template`` by path, tolerantly (the JAX
    package's ``checkpoint.overlay_params(..., strict=False)``): a path
    ``loaded`` lacks keeps the template's value, a path it has beyond the
    template's is dropped, each with a warning."""
    t_flat = _flatten_paths(template)
    l_flat = _flatten_paths(loaded)
    for k in sorted(set(t_flat) - set(l_flat)):
        logger.warning("%s: checkpoint lacks %s; keeping fresh init",
                       module_name, k)
    for k in sorted(set(l_flat) - set(t_flat)):
        logger.warning("%s: dropping unexpected checkpoint entry %s",
                       module_name, k)

    def rebuild(tmpl, path=""):
        if isinstance(tmpl, dict):
            return {k: rebuild(v, path + "/" + str(k))
                    for k, v in tmpl.items()}
        return l_flat.get(path, tmpl)

    return rebuild(template)


def _fresh_encoder(cfg: EncoderConfig) -> dict:
    """A freshly initialised encoder in the JAX layout (the template of
    the tolerant load)."""
    return _encoder_to_jax(encoder_init(torch.Generator().manual_seed(0),
                                        cfg))


def _directions(cfg: EncoderConfig) -> tuple:
    return ("fwd", "bwd") if cfg.bidirectional else ("fwd",)


def params_from_jax(tree: dict, cfg: EncoderConfig, device="cpu",
                    decoder_cfg: DecoderConfig | None = None) -> dict:
    """JAX parameter tree (numpy arrays, as ``load_checkpoint`` returns it)
    -> the port's float32 tensors on ``device``.

    Returns ``{"encoder": [layer, ...], "feature_sampler": head}`` where
    each layer is ``{"w_ih", "b_ih", "w_hh", "b_hh"}`` (the ESN's
    ``{"w_ih", "w_hh"}``), stacked over the two directions when the
    encoder is bidirectional, the encoder loaded
    tolerantly (see the module docstring), and ``head`` keeps the JAX
    head's nesting (its
    ``posterior_shape_logits`` when the tree has them); with
    ``decoder_cfg`` also ``"decoder"``, in the JAX nesting, its shapes
    checked against the config.
    """
    check_served(cfg)
    dirs = _directions(cfg)
    encoder = overlay_params(_fresh_encoder(cfg), tree["encoder"],
                             "encoder")
    layers = []
    for index, layer in enumerate(encoder["layers"]):
        in_size = (cfg.input_size if index == 0
                   else len(dirs) * cfg.rnn_hidden_size)
        want = _cell_shapes(cfg.rnn_type, in_size, cfg.rnn_hidden_size)
        if set(layer) != set(dirs):
            raise ValueError(f"encoder layer {index} holds {sorted(layer)}, "
                             f"the config expects {sorted(dirs)}")
        stacked = {}
        for name, shape in want.items():
            per_dir = [np.asarray(layer[d][name]) for d in dirs]
            for arr in per_dir:
                if arr.shape != shape:
                    raise ValueError(
                        f"encoder layer {index} {name} has shape "
                        f"{arr.shape}, the config expects {shape}")
            stacked[name] = _tensor(np.stack(per_dir) if len(dirs) == 2
                                    else per_dir[0], device)
        layers.append(stacked)
    if len(layers) != cfg.rnn_layers:
        raise ValueError(f"checkpoint holds {len(layers)} encoder layers, "
                         f"the config says {cfg.rnn_layers}")
    head = tree["feature_sampler"]
    out = {
        "encoder": layers,
        "feature_sampler": {k: tree_map(lambda a: _tensor(a, device),
                                        head[k])
                            for k in _HEAD_KEYS if k in head},
    }
    if decoder_cfg is not None:
        out["decoder"] = _checked(tree["decoder"],
                                  _decoder_shapes(decoder_cfg), device)
    return out


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _encoder_to_jax(layers: list) -> dict:
    """The port's encoder layers -> the JAX ``{"layers": [{"fwd"[, "bwd"]}
    ...]}`` tree (a stacked layer split back into its two directions)."""
    out = []
    for layer in layers:
        if layer["w_hh"].dim() == 3:
            out.append({d: {k: _to_np(v[i]) for k, v in layer.items()}
                        for i, d in enumerate(("fwd", "bwd"))})
        else:
            out.append({"fwd": {k: _to_np(v) for k, v in layer.items()}})
    return {"layers": out}


def params_to_jax(params: dict) -> dict:
    """The port's parameters -> the JAX package's tree of float32 numpy
    arrays (each bidirectional encoder layer split back into its two
    directions)."""
    out = {"encoder": _encoder_to_jax(params["encoder"]),
           "feature_sampler": tree_map(_to_np, params["feature_sampler"])}
    if "decoder" in params:
        out["decoder"] = tree_map(_to_np, params["decoder"])
    return out
