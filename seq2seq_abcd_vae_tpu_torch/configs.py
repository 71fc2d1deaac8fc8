"""Module configuration dataclasses (own copy of the JAX package's
``configs.py``, as far as serving and training need).

Each config is rebuilt from the ``*_init_parameters`` dict stored beside
its module's weights in ``checkpoint.pt``, which is what makes a
checkpoint self-describing.  The port serves the LSTM, GRU, Elman RNN and
echo-state (ESN) encoders (one or both directions) with the ABCD head or
the plain VAE's Gaussian head, trains them with the unidirectional LSTM,
GRU, RNN or ESN decoder (isotropic-Gaussian emission, sampled
self-feedback) and decodes those decoders; ``check_served`` and
``check_decoder`` name the configurations that wait for later slices.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class EncoderConfig:
    """RNN_Variational_Encoder config."""
    input_size: int
    rnn_hidden_size: int
    rnn_type: str = "LSTM"
    rnn_layers: int = 1
    hidden_dropout: float = 0.0
    bidirectional: bool = True
    esn_leak: float = 1.0

    @property
    def hidden_size_total(self) -> int:
        """Flattened final-state width:
        layers * hidden * (2 if bidirectional) * (2 if LSTM)."""
        total = self.rnn_layers * self.rnn_hidden_size
        if self.bidirectional:
            total *= 2
        if self.rnn_type == "LSTM":
            total *= 2
        return total

    def pack_init_parameters(self) -> dict[str, Any]:
        p = {
            "input_size": self.input_size,
            "rnn_hidden_size": self.rnn_hidden_size,
            "rnn_type": self.rnn_type,
            "rnn_layers": self.rnn_layers,
            "hidden_dropout": self.hidden_dropout,
            "bidirectional": self.bidirectional,
        }
        if self.rnn_type == "ESN":
            p["esn_leak"] = self.esn_leak
        return p

    @classmethod
    def from_init_parameters(cls, p: dict[str, Any]) -> "EncoderConfig":
        return cls(**p)


@dataclass(frozen=True)
class DecoderConfig:
    """RNN_Variational_Decoder config."""
    output_size: int
    rnn_hidden_size: int
    mlp_hidden_size: int
    feature_size: int
    emission_distr_name: str = "isotropic_gaussian"
    rnn_type: str = "LSTM"
    rnn_layers: int = 1
    input_dropout: float = 0.0
    self_feedback: bool = True
    bidirectional: bool = False
    right2left_weight: float = 0.5
    esn_leak: float = 1.0
    num_speakers: Optional[int] = None
    speaker_embed_dim: Optional[int] = None

    def __post_init__(self):
        if self.rnn_layers != 1:
            raise ValueError("Only rnn_layers=1 is currently supported.")
        if not self.self_feedback:
            object.__setattr__(self, "input_dropout", 1.0)

    @property
    def has_speaker_embedding(self) -> bool:
        return (self.num_speakers is not None
                and self.speaker_embed_dim is not None)

    @property
    def hidden_size_total(self) -> int:
        total = self.rnn_layers * self.rnn_hidden_size
        if self.rnn_type == "LSTM":
            total *= 2
        if self.bidirectional:
            total *= 2
        return total

    def pack_init_parameters(self) -> dict[str, Any]:
        p = {
            "output_size": self.output_size,
            "rnn_hidden_size": self.rnn_hidden_size,
            "mlp_hidden_size": self.mlp_hidden_size,
            "feature_size": self.feature_size,
            "emission_distr_name": self.emission_distr_name,
            "rnn_type": self.rnn_type,
            "rnn_layers": 1,
            "input_dropout": self.input_dropout,
            "bidirectional": self.bidirectional,
        }
        if self.rnn_type == "ESN":
            p["esn_leak"] = self.esn_leak
        if (self.num_speakers is not None
                and self.speaker_embed_dim is not None):
            p["num_speakers"] = self.num_speakers
            p["speaker_embed_dim"] = self.speaker_embed_dim
        if self.bidirectional:
            p["right2left_weight"] = self.right2left_weight
        return p

    @classmethod
    def from_init_parameters(cls, p: dict[str, Any]) -> "DecoderConfig":
        return cls(**p)


@dataclass(frozen=True)
class ABCDSamplerConfig:
    """ABCDSampler config, including the temperature-anneal state."""
    input_size: int
    mlp_hidden_size: int
    num_categories: int
    feature_dim: int
    prior_concentration: float = 1.0
    min_temperature: float = 1.0
    epoch_init_iter_counts: int = 0
    temperature_update_freq: int = 1000
    temperature_anneal_rate: float = 1e-5

    def pack_init_parameters(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_init_parameters(cls, p: dict[str, Any]) -> "ABCDSamplerConfig":
        return cls(**p)


@dataclass(frozen=True)
class GaussianSamplerConfig:
    """The plain VAE's latent head (the reference's generic Sampler): an
    MLP_To_k_Vecs giving the parameters of ``distribution_name``."""
    input_size: int
    mlp_hidden_size: int
    output_size: int
    distribution_name: str = "isotropic_gaussian"

    def pack_init_parameters(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_init_parameters(cls, p: dict[str, Any]) -> "GaussianSamplerConfig":
        return cls(**p)


LATENT_CONFIGS = {"abcd": ABCDSamplerConfig,
                  "gaussian": GaussianSamplerConfig}


def latent_config(latent_type: str, init_parameters: dict):
    """The latent head's config of a checkpoint's ``latent_type`` from its
    ``feature_sampler_init_parameters``."""
    if latent_type not in LATENT_CONFIGS:
        raise ValueError(f"unknown latent type {latent_type!r} (known: "
                         f"{', '.join(LATENT_CONFIGS)})")
    return LATENT_CONFIGS[latent_type].from_init_parameters(
        dict(init_parameters))


def check_served(encoder: EncoderConfig, latent_type: str = "abcd",
                 decoder: Optional[DecoderConfig] = None) -> None:
    """Raise NotImplementedError for what the port does not serve or train
    yet: encoders of another cell than the LSTM, GRU, RNN and ESN, a latent
    head other than the ABCD head and the plain VAE's Gaussian, and (with a
    ``decoder``, the training path) encoder dropout and every decoder
    ``check_decoder`` refuses for training."""
    if encoder.rnn_type not in ("LSTM", "GRU", "RNN", "ESN"):
        raise NotImplementedError(
            f"the {encoder.rnn_type!r} encoder is not ported")
    if latent_type not in LATENT_CONFIGS:
        raise NotImplementedError(
            f"latent type {latent_type!r} is not a latent of the port (the "
            f"JAX package's: {', '.join(LATENT_CONFIGS)})")
    if decoder is None:
        return
    if encoder.hidden_dropout > 0.0:
        raise NotImplementedError(
            "encoder inter-layer dropout is not ported yet (multi-layer "
            "dropout comes with a later slice)")
    check_decoder(decoder)


def check_decoder(decoder: DecoderConfig, training: bool = True) -> None:
    """Raise NotImplementedError for every decoder the port does not run
    yet.  Training takes the unidirectional LSTM, GRU, RNN or ESN decoder
    with isotropic-Gaussian emission and sampled self-feedback, without
    input dropout.  Generative decoding (``training=False``) takes the
    same four cells and is deterministic, as the JAX package's
    ``decode_features`` is: input dropout and the greedy decoder act only
    in training, so their checkpoints decode on the sampled loop."""
    if decoder.rnn_type not in ("LSTM", "GRU", "RNN", "ESN"):
        raise NotImplementedError(
            f"the {decoder.rnn_type!r} decoder is not ported")
    if decoder.bidirectional:
        raise NotImplementedError(
            "the bidirectional decoder is not ported yet")
    if training and decoder.input_dropout >= 1.0:
        raise NotImplementedError(
            "training the greedy decoder (no self-feedback) is not ported "
            "yet")
    if training and decoder.input_dropout > 0.0:
        raise NotImplementedError(
            "training with decoder input dropout is not ported yet")
    if decoder.emission_distr_name != "isotropic_gaussian":
        raise NotImplementedError(
            f"emission {decoder.emission_distr_name!r} is not ported; the "
            "port has the isotropic Gaussian only")
