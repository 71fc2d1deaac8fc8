"""Persistent encode server (PyTorch port of
seq2seq_abcd_vae_tpu/serve/server.py).

- **Fixed shapes per bucket.**  Every request goes to the smallest
  frame-count bucket that holds it and is padded to the service's fixed
  batch size, so the kernels see ``len(buckets)`` shapes.  ``warmup()``
  runs each once (which also builds the CUDA kernels) before serving.
- **Dynamic micro-batching.**  Requests land in a queue; one batcher
  thread drains whatever is pending (with a bounded wait for stragglers),
  groups it by bucket and runs one ``encode_step`` per group, so
  concurrent clients share launches.
- **Same numerics as batch encode.**  Segments are reflect-centred into
  bucket rows with the loader's layout (``data/audio.center_pad_segment``
  and ``FrontendSpec.buffer_len``), and the device function is
  ``infer/encode.encode_step``.
"""

from __future__ import annotations

import json
import os
import queue
import socketserver
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from ..data import audio as audio_mod
from ..data.batching import FrontendSpec
from ..infer.encode import Encoder, check_mode, encode_step

DEFAULT_BUCKETS = (16, 32, 64, 96, 128, 192, 256, 384, 512)


@dataclass
class _Request:
    samples: np.ndarray          # raw mono segment, float32
    future: Future
    bucket: int
    num_frames: int


@dataclass
class ServiceStats:
    requests: int = 0
    batches: int = 0
    rows_real: int = 0
    rows_padded: int = 0
    errors: int = 0
    per_bucket: dict = field(default_factory=dict)


class EncodeService:
    """Resident encoder with request batching.

    Args:
      model_path: a ``checkpoint.pt`` (self-describing, either package;
        an LSTM, GRU, Elman RNN or ESN encoder, bidirectional or
        unidirectional).
      data_normalizer: the log-amplitude divisor ``N`` used in training.
      sample_freq: the service's fixed sampling rate; requests carrying a
        different ``fs`` are rejected, not resampled.
      device: ``"cuda"`` (default) or ``"cpu"``.
      fft_frame_length / fft_step_size: seconds.
      mode: probs | logits | features (an ABCD checkpoint) or params (a
        plain Gaussian VAE's: the (mean, log_variance) pair).
      buckets: ascending frame-count buckets; longer requests are
        rejected.
      batch_size: fixed batch size per bucket.
      max_wait_ms: after the first queued request, how long the batcher
        keeps draining for companions before it runs the batch.
      autostart: start the batcher thread now (tests stage batches by
        hand with ``drain_once``).
    """

    def __init__(self, model_path: str, data_normalizer: float,
                 sample_freq: int, *, device: str = "cuda",
                 mode: str = "probs", fft_frame_length: float = 0.008,
                 fft_step_size: float = 0.004,
                 window: str = "hann_window", epsilon: float = 2.0 ** -15,
                 centering: bool = True, stft_method: str = "fft",
                 buckets=DEFAULT_BUCKETS, batch_size: int = 64,
                 max_wait_ms: float = 5.0, autostart: bool = True):
        check_mode(mode)
        self.mode = mode
        self.fs = int(sample_freq)
        self.normalizer = float(data_normalizer)
        self.epsilon = float(epsilon)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._encoder = Encoder(model_path, device=device,
                                stft_method=stft_method)
        self._encoder.check_mode(mode)
        # the kernel backend was resolved once by the encoder's own
        # selector (utils/backend_select.py)
        self.device = self._encoder.device
        self.frontend = FrontendSpec(
            int(np.floor(fft_frame_length * self.fs)),
            int(np.floor(fft_step_size * self.fs)),
            centering=centering, window=window)
        self._statics = self._encoder.statics(
            self.frontend, self.epsilon, self.normalizer)
        self._queue: queue.Queue = queue.Queue()
        self.stats = ServiceStats()
        self._stats_lock = threading.Lock()
        self._wav_cache = None  # rooted at the first wav request's dir
        self._closed = threading.Event()
        self._thread = None
        if autostart:
            self.start()

    # ------------------------------------------------------------- API
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._batcher, daemon=True, name="encode-batcher")
            self._thread.start()

    def close(self) -> None:
        self._closed.set()
        if self._thread is not None:
            self._queue.put(None)  # wake the batcher
            self._thread.join(timeout=10)

    def submit(self, samples: np.ndarray) -> Future:
        """Queue one raw segment; resolves to the mode's value array
        (probs: (K,) summing to 1; logits (K,); features (f,)), or in
        params mode to the pair (mean (f,), log_variance (f,))."""
        fut: Future = Future()
        try:
            req = self._admit(samples, fut)
        except ValueError as e:
            fut.set_exception(e)
            with self._stats_lock:
                self.stats.errors += 1
            return fut
        self._queue.put(req)
        return fut

    def encode(self, samples: np.ndarray, fs: int | None = None):
        """Blocking single-segment convenience."""
        if fs is not None and int(fs) != self.fs:
            raise ValueError(
                f"service runs at fs={self.fs}, request has fs={fs}")
        return self.submit(samples).result()

    def encode_wav(self, wav_path: str, onset: float, offset: float,
                   channel: int = 0):
        """Blocking encode of one annotated span of a wav on disk, with the
        training pipeline's bounds (``segment_sample_bounds``)."""
        root = os.path.dirname(os.path.abspath(wav_path)) or "."
        name = os.path.basename(wav_path)
        if self._wav_cache is None or self._wav_cache.input_root != root:
            self._wav_cache = audio_mod.WavCache(root)
        fs = self._wav_cache.sample_freq(name)
        if fs != self.fs:
            raise ValueError(
                f"service runs at fs={self.fs}, {name} has fs={fs}")
        wav = self._wav_cache.read(name, channel=channel)
        on, off = audio_mod.segment_sample_bounds(onset, offset, fs)
        return self.submit(wav[on:off]).result()

    def warmup(self) -> None:
        """Run every (bucket, batch_size) shape once before serving."""
        step = self.frontend.step_size
        for bucket in self.buckets:
            # shortest segment that still lands in this bucket and is
            # long enough to reflect-pad
            n = max((bucket - 1) * step + 1, 2 * self.frontend.pad + 2)
            self.submit(np.zeros(n, np.float32)).result()

    # -------------------------------------------------------- internals
    def _admit(self, samples, fut) -> _Request:
        x = np.asarray(samples, np.float32).reshape(-1)
        if self.frontend.centering and x.shape[0] <= self.frontend.pad:
            raise ValueError(
                f"segment of {x.shape[0]} samples is too short to "
                f"reflect-pad by {self.frontend.pad}")
        frames = self.frontend.frames_for_samples(x.shape[0])
        for bucket in self.buckets:
            if frames <= bucket:
                return _Request(x, fut, bucket, frames)
        raise ValueError(
            f"segment spans {frames} frames; largest configured bucket "
            f"is {self.buckets[-1]}")

    def _batcher(self) -> None:
        while not self._closed.is_set():
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if first is None:
                continue
            pending = [first]
            t0 = time.monotonic()
            while True:
                left = self.max_wait_s - (time.monotonic() - t0)
                try:
                    item = (self._queue.get(timeout=left) if left > 0
                            else self._queue.get_nowait())
                except queue.Empty:
                    break
                if item is not None:
                    pending.append(item)
            self._dispatch_pending(pending)

    def drain_once(self) -> None:
        """Synchronously run everything queued right now."""
        pending = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                pending.append(item)
        self._dispatch_pending(pending)

    def _dispatch_pending(self, pending) -> None:
        by_bucket: dict[int, list[_Request]] = {}
        for r in pending:
            by_bucket.setdefault(r.bucket, []).append(r)
        for bucket in sorted(by_bucket):
            reqs = by_bucket[bucket]
            for i in range(0, len(reqs), self.batch_size):
                self._run_batch(bucket, reqs[i:i + self.batch_size])

    def _run_batch(self, bucket: int, reqs) -> None:
        n = len(reqs)
        b = self.batch_size
        pad = self.frontend.pad
        audio = np.zeros((b, self.frontend.buffer_len(bucket)), np.float32)
        num_frames = np.zeros((b,), np.int32)
        for i, r in enumerate(reqs):
            if self.frontend.centering:
                audio_mod.center_pad_segment(r.samples, pad, audio[i])
            else:
                audio[i, :r.samples.shape[0]] = r.samples
            num_frames[i] = r.num_frames
        try:
            out = encode_step(self._encoder.params,
                              torch.from_numpy(audio).to(self.device),
                              torch.from_numpy(num_frames).to(self.device),
                              self._statics, bucket, self.mode)
            if self.mode == "params":
                host = tuple(p.cpu().numpy() for p in out)
                results = [tuple(p[i] for p in host) for i in range(n)]
            else:
                host = out.cpu().numpy()
                results = [host[i] for i in range(n)]
        except Exception as e:  # the batcher keeps serving; callers see it
            for r in reqs:
                r.future.set_exception(e)
            with self._stats_lock:
                self.stats.errors += n
            return
        for r, val in zip(reqs, results):
            r.future.set_result(val)
        with self._stats_lock:
            self.stats.requests += n
            self.stats.batches += 1
            self.stats.rows_real += n
            self.stats.rows_padded += b - n
            self.stats.per_bucket[bucket] = (
                self.stats.per_bucket.get(bucket, 0) + 1)


# ---------------------------------------------------------------------------
# NDJSON-over-Unix-socket transport
# ---------------------------------------------------------------------------
# Request lines:
#   {"id": any, "samples": [f32...], "fs": int}
#   {"id": any, "wav": path, "onset": sec, "offset": sec, "channel": 0}
#   {"cmd": "ping"} -> {"ok": true, "mode": ..., "fs": ..., "stats": {...}}
#   {"cmd": "shutdown"} -> server exits after responding {"ok": true}
# Response lines:
#   {"id": any, "values": [...]} (params mode: {"id", "params": [[...]...]})
#   {"id": any, "error": "message"}

def _handle_line(service: EncodeService, line: bytes, shutdown) -> bytes:
    try:
        msg = json.loads(line)
    except json.JSONDecodeError as e:
        return json.dumps({"error": f"bad json: {e}"}).encode() + b"\n"
    if msg.get("cmd") == "ping":
        with service._stats_lock:
            stats = {"requests": service.stats.requests,
                     "batches": service.stats.batches,
                     "errors": service.stats.errors}
        return json.dumps({
            "ok": True, "mode": service.mode, "fs": service.fs,
            "buckets": list(service.buckets), "stats": stats,
        }).encode() + b"\n"
    if msg.get("cmd") == "shutdown":
        shutdown()
        return b'{"ok": true}\n'
    rid = msg.get("id")
    try:
        if "wav" in msg:
            val = service.encode_wav(msg["wav"], float(msg["onset"]),
                                     float(msg["offset"]),
                                     int(msg.get("channel", 0)))
        elif "samples" in msg:
            val = service.encode(np.asarray(msg["samples"], np.float32),
                                 fs=msg.get("fs"))
        else:
            raise ValueError("request needs 'samples' or 'wav'")
        if service.mode == "params":
            body = {"id": rid, "params": [np.asarray(p).tolist()
                                          for p in val]}
        else:
            body = {"id": rid, "values": np.asarray(val).tolist()}
    except Exception as e:  # per-request isolation
        body = {"id": rid, "error": str(e)}
    return json.dumps(body).encode() + b"\n"


def serve_forever(service: EncodeService, socket_path: str,
                  ready: threading.Event | None = None) -> None:
    """Blocking NDJSON server on a Unix domain socket.

    One handler thread per connection; requests from all connections
    funnel into the service's batcher, so concurrent clients share
    launches.  ``ready`` is set once the socket accepts connections.
    """
    if os.path.exists(socket_path):
        os.unlink(socket_path)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                resp = _handle_line(service, line, server_shutdown)
                self.wfile.write(resp)
                self.wfile.flush()

    class Server(socketserver.ThreadingUnixStreamServer):
        daemon_threads = True
        allow_reuse_address = True

    srv = Server(socket_path, Handler)

    def server_shutdown():
        threading.Thread(target=srv.shutdown, daemon=True).start()

    if ready is not None:
        ready.set()
    try:
        srv.serve_forever(poll_interval=0.1)
    finally:
        srv.server_close()
        if os.path.exists(socket_path):
            os.unlink(socket_path)
