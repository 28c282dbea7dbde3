"""Audio streams + features — the pull-stream layer under streaming speech.

An own copy of the JAX package's ``io/audio.py``, verbatim apart from
module paths.

Reference: ``cognitive/.../AudioStreams.scala`` — ``WavStream`` (:16) and
``CompressedStream`` (:84) implement the Speech SDK's PullAudioInputStream
(chunked ``read(buf)`` over wav/compressed bytes), and
``BlockingQueueIterator`` (SpeechToTextSDK.scala:42) bridges the SDK's
callback-push world into Spark's iterator-pull world.

TPU-native: the same three pieces, dependency-free — pull streams over
bytes/files, a blocking queue bridge, and the acoustic front end (framed
log-mel filterbanks, numpy) that turns PCM chunks into the (T, n_mels)
feature matrices the streaming encoder consumes on device.
"""
from __future__ import annotations

import io
import queue
import struct
import threading
from typing import Iterator, Optional

import numpy as np


class PullAudioStream:
    """Chunked pull over mono float32 PCM in [-1, 1]."""

    def __init__(self, samples: np.ndarray, sample_rate: int):
        self.samples = np.asarray(samples, np.float32).reshape(-1)
        self.sample_rate = sample_rate
        self._pos = 0

    def read(self, n: int) -> np.ndarray:
        """Next <=n samples; empty array at end of stream."""
        chunk = self.samples[self._pos:self._pos + n]
        self._pos += len(chunk)
        return chunk

    def chunks(self, chunk_samples: int) -> Iterator[np.ndarray]:
        while True:
            c = self.read(chunk_samples)
            if len(c) == 0:
                return
            yield c


def parse_wav(data: bytes) -> PullAudioStream:
    """Minimal RIFF/WAVE PCM parser (``WavStream`` analogue): 16-bit or
    32-bit-float PCM, any channel count (downmixed to mono)."""
    buf = io.BytesIO(data)
    if buf.read(4) != b"RIFF":
        raise ValueError("not a RIFF file")
    buf.read(4)
    if buf.read(4) != b"WAVE":
        raise ValueError("not a WAVE file")
    fmt = None
    while True:
        hdr = buf.read(8)
        if len(hdr) < 8:
            raise ValueError("no data chunk in wav")
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            fmt = buf.read(size)
        elif cid == b"data":
            raw = buf.read(size)
            break
        else:
            buf.read(size + (size & 1))
    if fmt is None:
        raise ValueError("no fmt chunk in wav")
    audio_fmt, channels, rate = struct.unpack("<HHI", fmt[:8])
    bits = struct.unpack("<H", fmt[14:16])[0]
    if audio_fmt == 1 and bits == 16:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif audio_fmt == 3 and bits == 32:
        x = np.frombuffer(raw, "<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported wav encoding fmt={audio_fmt} bits={bits}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return PullAudioStream(x, rate)


def write_wav(samples: np.ndarray, sample_rate: int) -> bytes:
    """16-bit PCM wav bytes (tests/mocks)."""
    pcm = np.round(np.clip(np.asarray(samples, np.float32), -1, 1)
                   * 32767).astype("<i2")
    data = pcm.tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, sample_rate, sample_rate * 2, 2, 16)
    out = b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE"
    out += b"fmt " + struct.pack("<I", len(fmt)) + fmt
    out += b"data" + struct.pack("<I", len(data)) + data
    return out


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resample (adequate for speech front ends)."""
    if sr_in == sr_out:
        return np.asarray(x, np.float32)
    n_out = int(round(len(x) * sr_out / sr_in))
    pos = np.arange(n_out) * (len(x) - 1) / max(n_out - 1, 1)
    return np.interp(pos, np.arange(len(x)), x).astype(np.float32)


def audio_stream(payload, sample_rate: int = 16000,
                 audio_format: str = "wav") -> PullAudioStream:
    """Column cell -> PullAudioStream: wav bytes, raw float arrays, or an
    existing stream."""
    if isinstance(payload, PullAudioStream):
        return payload
    if audio_format == "wav" and isinstance(payload, (bytes, bytearray)):
        return parse_wav(bytes(payload))
    return PullAudioStream(np.asarray(payload, np.float32), sample_rate)


class BlockingQueueIterator:
    """Push-to-pull bridge (reference ``SpeechToTextSDK.scala:42``): a
    producer (recognition callback) ``put``s results, the consumer iterates;
    ``close()`` ends iteration after the queue drains.  Producer errors
    pushed via ``put_error`` re-raise in the consumer."""

    _DONE = object()

    class _Error:
        __slots__ = ("exc",)

        def __init__(self, exc):
            self.exc = exc

    def __init__(self, maxsize: int = 0):
        self._q: "queue.Queue" = queue.Queue(maxsize)
        self._closed = threading.Event()

    def put(self, item) -> None:
        if self._closed.is_set():
            raise RuntimeError("put() after close()")
        self._q.put(item)

    def put_error(self, exc: BaseException) -> None:
        if not self._closed.is_set():
            self._q.put(self._Error(exc))

    def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, self._Error):
            raise item.exc
        return item


# --------------------------------------------------------------------------
# acoustic front end
# --------------------------------------------------------------------------

def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """(n_mels, n_fft//2+1) triangular mel filter matrix."""
    fmax = fmax or sr / 2
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)
    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)
    pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    bins = np.floor((n_fft + 1) * pts / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        l, c, r = bins[i], bins[i + 1], bins[i + 2]
        for b in range(l, c):
            if c > l:
                fb[i, b] = (b - l) / (c - l)
        for b in range(c, r):
            if r > c:
                fb[i, b] = (r - b) / (r - c)
    return fb


def log_mel(signal: np.ndarray, sr: int = 16000, n_mels: int = 40,
            frame_ms: float = 25.0, hop_ms: float = 10.0) -> np.ndarray:
    """(T, n_mels) log-mel features — framed hann-windowed power spectra
    through a mel filterbank.  Pure numpy; chunk-sized inputs stay cheap on
    host while the encoder runs on device."""
    frame = int(sr * frame_ms / 1000)
    hop = int(sr * hop_ms / 1000)
    x = np.asarray(signal, np.float32).reshape(-1)
    if len(x) < frame:
        x = np.pad(x, (0, frame - len(x)))
    n_frames = 1 + (len(x) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx] * np.hanning(frame).astype(np.float32)
    n_fft = int(2 ** np.ceil(np.log2(frame)))
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2
    fb = mel_filterbank(sr, n_fft, n_mels)
    return np.log(spec @ fb.T + 1e-6).astype(np.float32)
