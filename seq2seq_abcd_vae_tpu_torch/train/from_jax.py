"""Carry parameter trees between the JAX package's layout and the port's.

The JAX package stores each recurrent layer per direction, with (in, out)
matrices: ``encoder.layers[l].{fwd,bwd}.{w_ih (F, 4H), w_hh (H, 4H),
b_ih (4H,), b_hh (4H,)}``; the ABCD head as ``feature_sampler.
{to_code_like.{lin1,lin2}.{w, b}, codebook (f, K),
posterior_shape_logits (K,)}``; and the decoder as ``decoder.
{feature2hidden, rnn_cell, emission_sampler.to_parameters (k-stacked),
offset_predictor[, embed_speaker]}``.  The port keeps every layout but
one: it stacks the two directions of each encoder layer on a leading
axis, since the kernel's public function takes ``w_ih (2, F, 4H)``,
``w_hh (2, H, 4H)`` and ``b_ih`` / ``b_hh (2, 4H)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs import DecoderConfig, EncoderConfig, check_served
from ..tree import tree_map

_HEAD_KEYS = ("to_code_like", "codebook", "posterior_shape_logits")


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _decoder_shapes(cfg: DecoderConfig) -> dict:
    h, m, f = cfg.rnn_hidden_size, cfg.mlp_hidden_size, cfg.output_size
    feat = cfg.feature_size + (cfg.speaker_embed_dim
                               if cfg.has_speaker_embedding else 0)
    shapes = {
        "feature2hidden": {"w": (feat, cfg.hidden_size_total),
                           "b": (cfg.hidden_size_total,)},
        "rnn_cell": {"w_ih": (f, 4 * h), "w_hh": (h, 4 * h),
                     "b_ih": (4 * h,), "b_hh": (4 * h,)},
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


def params_from_jax(tree: dict, cfg: EncoderConfig, device="cpu",
                    decoder_cfg: DecoderConfig | None = None) -> dict:
    """JAX parameter tree (numpy arrays, as ``load_checkpoint`` returns it)
    -> the port's float32 tensors on ``device``.

    Returns ``{"encoder": [layer, ...], "feature_sampler": head}`` where
    each layer is ``{"w_ih", "b_ih", "w_hh", "b_hh"}`` stacked over the two
    directions and ``head`` keeps the JAX head's nesting (its
    ``posterior_shape_logits`` when the tree has them); with
    ``decoder_cfg`` also ``"decoder"``, in the JAX nesting, its shapes
    checked against the config.
    """
    check_served(cfg)
    gates = 4 * cfg.rnn_hidden_size
    layers = []
    for index, layer in enumerate(tree["encoder"]["layers"]):
        in_size = cfg.input_size if index == 0 else 2 * cfg.rnn_hidden_size
        want = {"w_ih": (in_size, gates), "w_hh": (cfg.rnn_hidden_size,
                                                   gates),
                "b_ih": (gates,), "b_hh": (gates,)}
        stacked = {}
        for name, shape in want.items():
            pair = [np.asarray(layer[d][name]) for d in ("fwd", "bwd")]
            for arr in pair:
                if arr.shape != shape:
                    raise ValueError(
                        f"encoder layer {index} {name} has shape "
                        f"{arr.shape}, the config expects {shape}")
            stacked[name] = _tensor(np.stack(pair), device)
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


def params_to_jax(params: dict) -> dict:
    """The port's parameters -> the JAX package's tree of float32 numpy
    arrays (each encoder layer split back into its two directions)."""
    to_np = lambda t: t.detach().cpu().numpy().astype(np.float32)
    layers = [{d: {k: to_np(v[i]) for k, v in layer.items()}
               for i, d in enumerate(("fwd", "bwd"))}
              for layer in params["encoder"]]
    out = {"encoder": {"layers": layers},
           "feature_sampler": tree_map(to_np, params["feature_sampler"])}
    if "decoder" in params:
        out["decoder"] = tree_map(to_np, params["decoder"])
    return out
