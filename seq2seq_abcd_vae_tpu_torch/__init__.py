"""seq2seq_abcd_vae_tpu_torch — the PyTorch/CUDA port of
``seq2seq_abcd_vae_tpu`` for one NVIDIA H100.

The JAX package beside it stays the reference; this package imports
torch, never jax, and nothing of the JAX package.  Each Pallas kernel on
a ported path becomes a CUDA kernel written by hand for Hopper
(``csrc/``), with a plain PyTorch twin of the same signature that the
wrapper takes for CPU tensors.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

Ported so far: the encode server (``cli/serve_main.py`` ->
``serve/server.py`` -> ``infer/encode.encode_step``) for the LSTM, GRU,
Elman RNN or echo-state (ESN) encoder, bidirectional or unidirectional,
with the ABCD head or the plain VAE's Gaussian head; ABCD-VAE and plain
Gaussian VAE training (``cli/learning_main.py``, ``cli/plain_learning.py``
-> ``train/learner.py`` -> ``models/vae.py``) with the unidirectional
LSTM, GRU, RNN or ESN decoder; the offline encode CLI
(``cli/encode_main.py`` -> ``infer/encode.Encoder``, CSV and npz, every
mode); generative decoding of those decoders
(``infer/decode.decode_features``); and ``ops/lstm_kernel.
lstm_layer_bidir``, the one TPU kernel no path calls.
"""

__version__ = "0.1.0"
