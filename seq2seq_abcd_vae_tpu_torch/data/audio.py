"""Wav reading with per-file caching, segment bounds and host-side
reflection centring (PyTorch port's own copy of the serve-path parts of
seq2seq_abcd_vae_tpu/data/audio.py; scipy reader only).

"Centring" is the reflect padding torch.stft(center=True) applies.  Rows
of a padded batch differ in length, so the reflection is written on the
host into each row's buffer and the device frontend does pure
fixed-shape framing.
"""

from __future__ import annotations

import os.path

import numpy as np
import scipy.io.wavfile as spw


class WavCache:
    """Decode each wav once; hand out one channel of it.  PCM16 stays
    int16 (an exact cast to float32 happens later); other formats become
    float32."""

    def __init__(self, input_root: str):
        self.input_root = input_root
        self._cache: dict[tuple[str, int], np.ndarray] = {}
        self._fs: dict[str, int] = {}

    def read(self, input_path: str, channel: int = 0) -> np.ndarray:
        key = (input_path, channel)
        if key not in self._cache:
            fs, data = spw.read(os.path.join(self.input_root, input_path))
            if data.ndim > 1:
                data = data[:, channel]
            self._fs[input_path] = fs
            dtype = np.int16 if data.dtype == np.int16 else np.float32
            self._cache[key] = np.ascontiguousarray(data, dtype=dtype)
        return self._cache[key]

    def sample_freq(self, input_path: str) -> int:
        if input_path not in self._fs:
            self.read(input_path)
        return self._fs[input_path]


def segment_sample_bounds(onset_sec, offset_sec, fs):
    """Seconds -> sample indices, rounding half to even as the
    reference's pandas ``.round()`` does."""
    onset_ix = np.round(np.asarray(onset_sec, np.float64) * fs).astype(int)
    offset_ix = np.round(np.asarray(offset_sec, np.float64) * fs).astype(int)
    return onset_ix, offset_ix


def center_pad_segment(x: np.ndarray, pad: int, out: np.ndarray) -> None:
    """Write [reflect(pad) | x | reflect(pad)] into out[:len(x)+2*pad].

    Torch reflect padding: the left side mirrors x[1..pad], the right
    side x[-2..-(pad+1)].
    """
    n = x.shape[0]
    if n <= pad:
        raise ValueError(
            f"segment of {n} samples is too short to reflect-pad by {pad}; "
            "use --fft_no_centering or longer segments")
    out[:pad] = x[pad:0:-1]
    out[pad:pad + n] = x
    stop = n - 2 - pad
    out[pad + n: 2 * pad + n] = x[n - 2: (None if stop < 0 else stop):-1]


class SegmentDataset:
    """Variable-length audio segments from annotation rows.

    ``rows`` is a list of (index label, row dict) pairs; segment bounds are
    computed once, and raw samples come from the shared WavCache.
    """

    def __init__(self, rows, wav_cache: WavCache, channel: int = 0,
                 speaker2ix: dict | None = None):
        self.rows = [row for _, row in rows]
        self.wav_cache = wav_cache
        self.channel = channel
        self.speaker2ix = speaker2ix
        n = len(rows)
        self.index_labels = np.asarray([ix for ix, _ in rows], np.int64)
        self.onsets_np = np.zeros(n, np.int64)
        self.offsets_np = np.zeros(n, np.int64)
        self.paths = [row["input_path"] for row in self.rows]
        ref_fs = None
        for path in dict.fromkeys(self.paths):
            fs = wav_cache.sample_freq(path)
            if ref_fs is None:
                ref_fs = fs
            elif fs != ref_fs:
                import warnings
                warnings.warn(
                    f"{path} has fs={fs} but the corpus was set up for "
                    f"fs={ref_fs}; STFT geometry will be wrong for this "
                    "file", stacklevel=2)
            pos = [i for i, p in enumerate(self.paths) if p == path]
            on, off = segment_sample_bounds(
                [float(self.rows[i]["onset"]) for i in pos],
                [float(self.rows[i]["offset"]) for i in pos], fs)
            self.onsets_np[pos] = on
            self.offsets_np[pos] = off
        self.lengths_np = self.offsets_np - self.onsets_np
        if speaker2ix is None:
            self.speakers_np = np.full(n, -1, np.int32)
        else:
            self.speakers_np = np.asarray(
                [speaker2ix[str(row["speaker"])] for row in self.rows],
                np.int32)

    def segment_raw_pos(self, pos: int) -> np.ndarray:
        """Raw samples by positional index."""
        wav = self.wav_cache.read(self.paths[pos], self.channel)
        return wav[self.onsets_np[pos]:self.offsets_np[pos]]

    def __len__(self) -> int:
        return len(self.rows)
