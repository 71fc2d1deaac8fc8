"""Bucketed padded batching (the port's copy of
seq2seq_abcd_vae_tpu/data/batching.py, single process).

Every batch is a (B, L_bucket) float32 audio buffer with the reflection
centring already written, plus frame counts; padding rows have length 0
and are masked out of every loss.  The bucket edges follow the
bucket-shuffled composition (the band maxes of the sorted frame counts,
``chunk_optimal_bucket_edges``), so a corpus has few distinct padded
lengths.  The JAX loader's bucket-policy overrides
(``SEQ2SEQ_BUCKET_POLICY``, ``SEQ2SEQ_NUM_BUCKETS``) are not ported: the
port refuses to run with either set rather than batch differently.  The shuffle uses an explicit numpy Generator with the JAX
package's default seed, so both packages compose the same batches.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from ..ops import stft as stft_ops
from .audio import SegmentDataset, center_pad_segment


# the JAX loader's environment overrides of its bucket edges
UNPORTED_ENV = ("SEQ2SEQ_BUCKET_POLICY", "SEQ2SEQ_NUM_BUCKETS")


@dataclass
class FrontendSpec:
    """Static STFT frontend geometry, in samples."""
    frame_length: int
    step_size: int
    centering: bool = True
    window: str = "hann_window"

    @property
    def pad(self) -> int:
        return (stft_ops.center_pad_amount(self.frame_length)
                if self.centering else 0)

    def frames_for_samples(self, num_samples: int) -> int:
        return stft_ops.stft_num_frames(num_samples, self.frame_length,
                                        self.step_size, self.centering)

    def buffer_len(self, bucket_frames: int) -> int:
        # A segment with exactly bucket_frames frames can be up to step-1
        # samples longer than (bucket-1)*step + frame (the count floors);
        # size the row for the worst case so assembly never writes past it.
        return bucket_frames * self.step_size + self.frame_length

    @property
    def num_bins(self) -> int:
        return stft_ops.num_freq_bins(self.frame_length)


def default_bucket_fn(num_frames: int, min_bucket: int = 32) -> int:
    """The next power of two >= num_frames (and >= min_bucket)."""
    b = min_bucket
    while b < num_frames:
        b *= 2
    return b


def optimal_bucket_edges(frame_counts: np.ndarray, num_buckets: int = 6,
                         min_bucket: int = 32,
                         multiple: int = 8) -> list[int]:
    """Edges (each rounded up to ``multiple``) minimising the total padded
    frames over the rows, by dynamic programming over the unique counts."""
    counts = np.asarray(frame_counts)
    counts = counts[counts > 0]
    if counts.size == 0:
        return [min_bucket]
    uniq, freq = np.unique(counts, return_counts=True)
    roundup = np.maximum(min_bucket,
                         -(-uniq // multiple) * multiple).astype(np.int64)
    m = len(uniq)
    w_prefix = np.concatenate([[0], np.cumsum(freq * uniq)])
    n_prefix = np.concatenate([[0], np.cumsum(freq)])

    def seg_cost(i, j):  # rows of counts uniq[i..j] under edge roundup[j]
        rows = n_prefix[j + 1] - n_prefix[i]
        real = w_prefix[j + 1] - w_prefix[i]
        return roundup[j] * rows - real

    k_max = max(1, min(num_buckets, m))
    inf = float("inf")
    dp = [[inf] * m for _ in range(k_max)]
    arg = [[0] * m for _ in range(k_max)]
    for j in range(m):
        dp[0][j] = seg_cost(0, j)
    for k in range(1, k_max):
        for j in range(k, m):
            best, bi = inf, k
            for i in range(k, j + 1):
                c = dp[k - 1][i - 1] + seg_cost(i, j)
                if c < best:
                    best, bi = c, i
            dp[k][j], arg[k][j] = best, bi
    k_best = min(range(k_max), key=lambda k: dp[k][m - 1])
    edges, j = [], m - 1
    for k in range(k_best, -1, -1):
        edges.append(int(roundup[j]))
        j = arg[k][j] - 1 if k > 0 else -1
    return sorted(set(edges))


def chunk_optimal_bucket_edges(frame_counts: np.ndarray, batch_size: int,
                               num_buckets: int = 16,
                               min_bucket: int = 32) -> list[int]:
    """Edges matched to the bucket-shuffled composition: the max frame
    count of each batch-wide rank band of the sorted counts, unrounded,
    merged by ``optimal_bucket_edges`` when there are more than
    ``num_buckets`` bands."""
    counts = np.asarray(frame_counts)
    counts = counts[counts > 0]
    if counts.size == 0:
        return [min_bucket]
    s = np.sort(counts)
    band_max = np.maximum(s[np.minimum(
        np.arange(batch_size - 1, s.size + batch_size - 1, batch_size),
        s.size - 1)], min_bucket)
    edges = sorted(set(int(e) for e in band_max))
    if len(edges) > num_buckets:
        bands = np.repeat(band_max,
                          np.diff(np.concatenate(
                              [np.arange(0, s.size, batch_size), [s.size]])))
        edges = optimal_bucket_edges(bands, num_buckets=num_buckets,
                                     min_bucket=min_bucket, multiple=1)
    return edges


@dataclass
class RawBatch:
    """Host-side batch: centred raw audio and its bookkeeping.

    audio: (B, L_bucket) float32 (or int16 when every segment is PCM16);
    num_frames: (B,) int32 frame counts (0 marks padding rows);
    speakers: (B,) int32 (-1 without speakers); ixs: index labels of the
    real rows; bucket_frames: the static T of the batch.
    """
    audio: np.ndarray
    num_frames: np.ndarray
    speakers: np.ndarray
    ixs: list
    bucket_frames: int

    @property
    def num_real(self) -> int:
        return len(self.ixs)


class DataLoader:
    """Iterates RawBatches over a SegmentDataset.

    batching_mode: 'bucket_shuffled' (the training default: rows shuffled
    within their length bucket, bucket-homogeneous batches in shuffled
    order), 'length_sorted' (a global sort with a random tie-break) or
    'uniform' (a uniform shuffle, batches consumed from the end, as the
    reference draws them).  Each __iter__ reshuffles.
    """

    def __init__(self, dataset: SegmentDataset, frontend: FrontendSpec,
                 batch_size: int = 1, shuffle: bool = False,
                 seed: int = 1111, pad_to_batch_size: bool = False,
                 min_bucket: int = 32, batching_mode: str = "uniform",
                 num_buckets: int = 16):
        if batching_mode not in ("uniform", "bucket_shuffled",
                                 "length_sorted"):
            raise ValueError(f"unknown batching mode {batching_mode!r}")
        for name in UNPORTED_ENV:
            if os.environ.get(name):
                raise NotImplementedError(
                    f"{name}={os.environ[name]!r} is set: the JAX loader's "
                    "bucket-policy override is not ported (the port always "
                    "uses the 'chunk' edges); unset it")
        self.dataset = dataset
        self.frontend = frontend
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.pad_to_batch_size = pad_to_batch_size
        self.min_bucket = min_bucket
        self.batching_mode = batching_mode
        self._rng = np.random.default_rng(seed)
        self.bucket_edges = chunk_optimal_bucket_edges(
            self.frames_for_lengths(dataset.lengths_np),
            batch_size=batch_size, num_buckets=num_buckets,
            min_bucket=min_bucket)

    def frames_for_lengths(self, lengths: np.ndarray) -> np.ndarray:
        fe = self.frontend
        padded = np.asarray(lengths) + (2 * fe.pad if fe.centering else 0)
        return np.where(padded >= fe.frame_length,
                        1 + (padded - fe.frame_length) // fe.step_size,
                        0).astype(np.int32)

    def bucket_for(self, max_frames: int) -> int:
        for edge in self.bucket_edges:
            if edge >= max_frames:
                return edge
        return default_bucket_fn(max_frames, self.min_bucket)

    def get_num_batches(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[RawBatch]:
        n = len(self.dataset)
        if self.batching_mode == "bucket_shuffled":
            frames = self.frames_for_lengths(self.dataset.lengths_np)
            edges = np.asarray(self.bucket_edges)
            assign = np.minimum(np.searchsorted(edges, frames, side="left"),
                                len(edges) - 1)
            parts = []
            for e in np.unique(assign):
                members = np.flatnonzero(assign == e)
                parts.append(self._rng.permutation(members)
                             if self.shuffle else members)
            order = np.concatenate(parts)
            batches = [order[i:i + self.batch_size]
                       for i in range(0, n, self.batch_size)]
            if self.shuffle:
                self._rng.shuffle(batches)
            for positional in batches:
                yield self.make_batch(positional)
            return
        if self.batching_mode == "length_sorted":
            jitter = self._rng.random(n) if self.shuffle else 0.0
            order = np.argsort(self.dataset.lengths_np + jitter)
        else:
            order = (self._rng.permutation(n) if self.shuffle
                     else np.arange(n))
        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.batching_mode == "length_sorted" and self.shuffle:
            self._rng.shuffle(batches)
            for positional in batches:
                yield self.make_batch(positional)
            return
        for positional in reversed(batches):  # consumed from the end
            yield self.make_batch(positional)

    def make_batch(self, positional_ixs: Sequence[int]) -> RawBatch:
        ds, fe = self.dataset, self.frontend
        pos = np.asarray(positional_ixs, np.int64)
        # length-descending within the batch, as the reference sorts
        pos = pos[np.argsort(-ds.lengths_np[pos], kind="stable")]
        ixs = [int(ds.index_labels[p]) for p in pos]
        frames = self.frames_for_lengths(ds.lengths_np[pos])
        bucket = self.bucket_for(int(frames.max()))
        b = self.batch_size if self.pad_to_batch_size else len(ixs)
        segs = [ds.segment_raw_pos(p) for p in pos]
        dtype = (np.int16 if all(s.dtype == np.int16 for s in segs)
                 else np.float32)
        audio = np.zeros((b, fe.buffer_len(bucket)), dtype)
        for i, seg in enumerate(segs):
            seg = seg.astype(dtype, copy=False)
            if fe.centering:
                center_pad_segment(seg, fe.pad, audio[i])
            else:
                audio[i, :len(seg)] = seg
        num_frames = np.zeros((b,), np.int32)
        num_frames[:len(pos)] = frames
        speakers = np.full((b,), -1, np.int32)
        speakers[:len(pos)] = ds.speakers_np[pos]
        return RawBatch(audio, num_frames, speakers, ixs, bucket)
