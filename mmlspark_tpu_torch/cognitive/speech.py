"""Streaming speech recognition — the SpeechToTextSDK/ConversationTranscription
equivalents (the port of ``mmlspark_tpu/cognitive/speech.py``).

Reference: ``cognitive/.../SpeechToTextSDK.scala`` — streaming recognition
through the native Speech SDK: a pull audio stream feeds the recognizer
(:419), recognition events are bridged into a row iterator by
``BlockingQueueIterator`` (:42), and ``ConversationTranscription`` (:491)
adds speaker attribution.  The equivalent here is CHUNKED STREAMING
INFERENCE through a PyTorch acoustic model on the card:

- audio arrives as a pull stream (``io/audio.py``), chunked at
  ``chunk_s`` seconds;
- each chunk becomes log-mel features on the host and one encoder step on
  the device — ``StreamingEncoder``, two stacked unidirectional LSTM
  layers (one ``nn.LSTM``, cuDNN on the card) and a linear head to the
  alphabet's symbols, whose per-layer ``(c, h)`` carries persist across
  chunks, so a session is one fixed-shape step reused for the whole
  stream (latency = one chunk).  The carry keeps flax's ``(c, h)`` order
  per layer, the JAX package's; ``nn.LSTM`` takes and returns ``(h, c)``
  stacked over layers, and the encoder converts at its edge.  Float32 runs
  with TF32 off (``_device.float32_exact``);
- greedy CTC decoding collapses each chunk's symbol posteriors into an
  incremental hypothesis ("Recognizing" events), with a final
  "Recognized" event at end of stream — mirroring the SDK's event model;
- ``ConversationTranscription`` adds online speaker attribution by
  cosine-matching chunk feature centroids ("Guest-N" ids, the SDK's
  conversation semantics).

An ``apply_fn(variables, carry, feats)`` with ``hidden_shapes`` replaces
the encoder (an imported ONNX LSTM, ``dl/onnx_import.py``); the JAX
package's encoder variables drive the port's encoder through
``convert.streaming_encoder_state_dict_from_flax`` (``variables=`` takes
either form).  ``device``: unset = the card (an error without one),
``"cpu"`` = the host.

``SpeechServingModel`` bridges the same recognizer into the serving
engine: POST chunks with a session id, receive incremental hypotheses —
streaming recognition as a web service.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .._device import DeviceLike, float32_exact, resolve_device
from ..core import ComplexParam, DataFrame, HasInputCol, HasOutputCol, Param, Transformer
from ..core.schema import ColumnType
from ..io.audio import BlockingQueueIterator, audio_stream, log_mel

DEFAULT_ALPHABET = "_abcdefghijklmnopqrstuvwxyz '"  # index 0 = CTC blank


class StreamingEncoder(nn.Module):
    """Unidirectional stacked-LSTM acoustic encoder whose call signature is
    ``(carry, feats) -> (carry, logits)``: ``carry`` is ``((c, h),) *
    layers``, each ``(batch, hidden)``; ``feats`` ``(batch, time,
    n_mels)``; ``logits`` ``(batch, time, symbols)``.  The streaming
    variant of ``models/bilstm.py`` (online audio can't see the future, so
    no backward pass).  Weights are flax's initializers drawn from
    ``generator``: ``lecun_normal`` input and head kernels, orthogonal
    hidden kernels, zero biases."""

    def __init__(self, n_mels: int = 40, hidden_size: int = 128,
                 layers: int = 2, symbols: int = len(DEFAULT_ALPHABET),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from ..models.bilstm import _reset_lstm
        self.hidden_size, self.layers = int(hidden_size), int(layers)
        self.lstm = nn.LSTM(n_mels, hidden_size, num_layers=layers,
                            batch_first=True)
        self.head = nn.Linear(hidden_size, symbols)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        with torch.no_grad():
            _reset_lstm(self.lstm, gen)
            t = torch.empty(self.head.weight.shape)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            self.head.weight.copy_(t * math.sqrt(1.0 / hidden_size)
                                   / 0.87962566103423978)
            self.head.bias.zero_()

    def forward(self, carry, feats: torch.Tensor):
        c0 = torch.stack([c for c, _ in carry])
        h0 = torch.stack([h for _, h in carry])
        with float32_exact(feats.is_cuda):
            y, (hn, cn) = self.lstm(feats, (h0, c0))
            logits = self.head(y)
        return tuple((cn[i], hn[i]) for i in range(self.layers)), logits


def streaming_encoder(hidden: int = 128, num_layers: int = 2,
                      num_symbols: int = len(DEFAULT_ALPHABET),
                      n_mels: int = 40,
                      generator: Optional[torch.Generator] = None
                      ) -> StreamingEncoder:
    """The recognizer's default acoustic encoder (``StreamingEncoder``)."""
    return StreamingEncoder(n_mels, hidden, num_layers, num_symbols,
                            generator)


@dataclasses.dataclass
class RecognitionState:
    """Per-stream state carried across chunks."""
    carry: Any
    prev_id: int = 0
    text: str = ""
    frames_seen: int = 0
    speaker_centroids: List[np.ndarray] = dataclasses.field(default_factory=list)
    speaker: str = "Guest-1"
    pending: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32))
    # unframed sample tail kept so chunk-boundary frames see the SAME
    # windows a single full-utterance pass would (window > hop)
    lookback: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32))


class StreamingRecognizer:
    """Chunk-at-a-time recognition over one encoder step on ``device``."""

    def __init__(self, module=None, variables=None,
                 apply_fn: Optional[Callable] = None,
                 alphabet: str = DEFAULT_ALPHABET, sample_rate: int = 16000,
                 n_mels: int = 40, chunk_s: float = 0.5, seed: int = 0,
                 hidden_shapes: Optional[List[int]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.alphabet = alphabet
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.chunk_samples = int(chunk_s * sample_rate)
        # single source of truth for the acoustic framing; passed through to
        # log_mel so window/hop can never drift apart
        self.frame_ms, self.hop_ms = 25.0, 10.0
        self.frame = int(sample_rate * self.frame_ms / 1000)
        self.hop = int(sample_rate * self.hop_ms / 1000)
        self._module_route = apply_fn is None
        self._variables = None
        if apply_fn is not None:
            self.module = module
            self._apply = apply_fn
            self._variables = self._placed(variables)
            self._hidden_shapes = hidden_shapes
        else:
            if module is None:
                module = streaming_encoder(
                    num_symbols=len(alphabet), n_mels=n_mels,
                    generator=torch.Generator().manual_seed(seed))
            self.module = module.to(self.device).eval()
            self._apply = lambda v, c, f: self.module(c, f)
            self._hidden_shapes = hidden_shapes or \
                [self.module.hidden_size] * self.module.layers
            if variables is not None:
                self.variables = variables

    def _placed(self, variables):
        """A dict of arrays -> the same keys as tensors on the device, moved
        once (an ``apply_fn`` is handed them every step)."""
        if isinstance(variables, Mapping):
            return {k: torch.tensor(np.asarray(v), device=self.device)
                    if isinstance(v, np.ndarray) else v
                    for k, v in variables.items()}
        return variables

    @property
    def variables(self):
        """The encoder's ``state_dict`` (its ``apply_fn`` variables on that
        route).  Set it to a ``state_dict``, to the JAX package's flax
        encoder variables, or, on the ``apply_fn`` route, to that
        function's variables."""
        if self._module_route:
            return self.module.state_dict()
        return self._variables

    @variables.setter
    def variables(self, value) -> None:
        if not self._module_route:
            self._variables = self._placed(value)
            return
        if isinstance(value, Mapping) and "params" in value:
            from ..convert import streaming_encoder_state_dict_from_flax
            value = streaming_encoder_state_dict_from_flax(value, self.module)
        self.module.load_state_dict(value)

    # ---------------------------------------------------------------- state
    def init_carry(self, batch: int = 1):
        if self._hidden_shapes is None:
            raise ValueError(
                "carry shapes unknown for an apply_fn-based recognizer: pass "
                "hidden_shapes=[h1, h2, ...] or override init_carry")
        return tuple((torch.zeros((batch, h), dtype=torch.float32,
                                  device=self.device),
                      torch.zeros((batch, h), dtype=torch.float32,
                                  device=self.device))
                     for h in self._hidden_shapes)

    def new_state(self) -> RecognitionState:
        return RecognitionState(carry=self.init_carry(1))

    # --------------------------------------------------------------- decode
    def _ctc_append(self, state: RecognitionState, ids: np.ndarray) -> None:
        prev = state.prev_id
        out = []
        for i in ids:
            i = int(i)
            if i != prev and i != 0:
                out.append(self.alphabet[i])
            prev = i
        state.prev_id = prev
        state.text += "".join(out)

    def _frame_chunk(self, state: RecognitionState,
                     samples: np.ndarray) -> Optional[np.ndarray]:
        """Buffered EXACT framing: prepend the unconsumed sample tail so the
        feature sequence is identical to a single full-utterance pass no
        matter how the audio was chunked (window > hop means boundary frames
        straddle chunks).  Returns (T, n_mels) features or None if fewer
        than one window is buffered."""
        buf = np.concatenate([state.lookback, np.asarray(samples, np.float32)])
        if len(buf) < self.frame:
            state.lookback = buf
            return None
        n_frames = 1 + (len(buf) - self.frame) // self.hop
        used = buf[: (n_frames - 1) * self.hop + self.frame]
        state.lookback = buf[n_frames * self.hop:]
        return log_mel(used, self.sample_rate, self.n_mels,
                       frame_ms=self.frame_ms, hop_ms=self.hop_ms)

    def _step(self, state: RecognitionState, feats: np.ndarray) -> None:
        x = torch.from_numpy(np.ascontiguousarray(feats[None], np.float32))
        with torch.inference_mode(), \
                float32_exact(self.device.type == "cuda"):
            state.carry, logits = self._apply(self._variables, state.carry,
                                              x.to(self.device))
            ids = logits[0].argmax(dim=-1).cpu().numpy()
        self._ctc_append(state, ids)
        state.frames_seen += feats.shape[0]

    def process_chunk(self, state: RecognitionState, samples: np.ndarray,
                      speaker_hook: Optional[Callable] = None) -> Dict[str, Any]:
        """One chunk -> one device step -> incremental hypothesis event.
        ``speaker_hook(state, feats)`` runs after featurization and before
        the event is built (ConversationTranscription's diarization)."""
        offset_s = state.frames_seen * self.hop / self.sample_rate
        feats = self._frame_chunk(state, samples)
        if feats is None:
            return {"status": "Buffering", "text": state.text,
                    "offset": offset_s, "duration": 0.0,
                    "speaker": state.speaker}
        if speaker_hook is not None:
            speaker_hook(state, feats)
        self._step(state, feats)
        return {"status": "Recognizing", "text": state.text,
                "offset": offset_s,
                "duration": feats.shape[0] * self.hop / self.sample_rate,
                "speaker": state.speaker}

    def finish(self, state: RecognitionState) -> Dict[str, Any]:
        """Flush: a stream shorter than one window still yields one padded
        frame (matching batch log_mel's pad-if-short behavior); a longer
        stream's sub-window tail is dropped exactly as batch framing drops
        it."""
        if state.frames_seen == 0 and len(state.lookback):
            feats = log_mel(state.lookback, self.sample_rate, self.n_mels,
                            frame_ms=self.frame_ms, hop_ms=self.hop_ms)
            self._step(state, feats)
        state.lookback = np.zeros(0, np.float32)
        return {"status": "Recognized", "text": state.text, "offset": 0.0,
                "duration": state.frames_seen * self.hop / self.sample_rate,
                "speaker": state.speaker}

    # ------------------------------------------------------------ streaming
    def transcribe_stream(self, stream, events: Optional[BlockingQueueIterator] = None):
        """Pull-stream in, event iterator out (the SDK bridge pattern:
        producer thread pushes recognition events, consumer iterates).
        Producer errors propagate to the consumer via the queue."""
        events = events or BlockingQueueIterator()

        def produce():
            try:
                state = self.new_state()
                for chunk in stream.chunks(self.chunk_samples):
                    events.put(self.process_chunk(state, chunk))
                events.put(self.finish(state))
            except Exception as e:  # noqa: BLE001
                events.put_error(e)
            finally:
                events.close()

        threading.Thread(target=produce, daemon=True).start()
        return events


def _speaker_attribute(state: RecognitionState, feats_mean: np.ndarray,
                       threshold: float = 0.97) -> None:
    """Online diarization: cosine-match the chunk's mel centroid against
    known speaker centroids; a poor match opens a new 'Guest-N'."""
    v = feats_mean / (np.linalg.norm(feats_mean) + 1e-8)
    best, best_i = -1.0, -1
    for i, c in enumerate(state.speaker_centroids):
        sim = float(v @ c / (np.linalg.norm(c) + 1e-8))
        if sim > best:
            best, best_i = sim, i
    if best_i < 0 or best < threshold:
        state.speaker_centroids.append(v.copy())
        best_i = len(state.speaker_centroids) - 1
    else:
        c = state.speaker_centroids[best_i]
        state.speaker_centroids[best_i] = 0.9 * c + 0.1 * v
    state.speaker = f"Guest-{best_i + 1}"


class SpeechToTextSDK(Transformer, HasInputCol, HasOutputCol):
    """Streaming recognition transformer: an audio column (wav bytes or raw
    float PCM) -> a column of recognition events (list of dicts with
    status/text/offset/duration), plus a ``<output>_text`` column holding
    the final transcript.  Reference ``SpeechToTextSDK.scala:419``."""

    recognizer = ComplexParam("recognizer", "StreamingRecognizer (model bundle)")
    sample_rate = Param("sample_rate", "PCM sample rate for raw arrays", "int",
                        default=16000)
    audio_format = Param("audio_format", "wav | pcm", "string", default="wav")
    chunk_s = Param("chunk_s", "seconds of audio per streamed chunk", "float",
                    default=0.5)
    detailed = Param("detailed", "keep intermediate Recognizing events",
                     "bool", default=True)
    device = Param("device", "where a recognizer this transformer makes "
                   "runs: unset = the CUDA card (an error without one), "
                   "'cpu' = the host", "string", default=None)

    def __init__(self, uid: Optional[str] = None, **kwargs):
        super().__init__(uid)
        if kwargs:
            self.set_params(**kwargs)

    def _get_recognizer(self) -> StreamingRecognizer:
        rec = self.get("recognizer")
        if rec is None:
            rec = StreamingRecognizer(sample_rate=self.get("sample_rate"),
                                      chunk_s=self.get("chunk_s"),
                                      device=self.get("device"))
            self.set("recognizer", rec)
        return rec

    def _stream_for(self, rec: StreamingRecognizer, cell):
        from ..io.audio import PullAudioStream, resample
        stream = audio_stream(cell, self.get("sample_rate"),
                              self.get("audio_format"))
        if stream.sample_rate != rec.sample_rate:
            # wav headers carry their own rate — resample to the model's
            # so the filterbank and offset math stay correct
            stream = PullAudioStream(resample(stream.samples,
                                              stream.sample_rate,
                                              rec.sample_rate),
                                     rec.sample_rate)
        return stream

    def _events_for(self, rec: StreamingRecognizer, cell) -> List[Dict]:
        # direct synchronous loop — the BlockingQueueIterator thread bridge
        # is only for the truly streaming transcribe_stream() API
        stream = self._stream_for(rec, cell)
        state = rec.new_state()
        events = [rec.process_chunk(state, chunk)
                  for chunk in stream.chunks(rec.chunk_samples)]
        events.append(rec.finish(state))
        if not self.get("detailed"):
            events = [e for e in events if e["status"] == "Recognized"]
        return events

    def _transform(self, df: DataFrame) -> DataFrame:
        in_col = self.get_or_fail("input_col")
        out_col = self.get_or_fail("output_col")
        rec = self._get_recognizer()

        def per_part(p):
            n = len(p[in_col])
            ev_col = np.empty(n, dtype=object)
            text_col = np.empty(n, dtype=object)
            for i in range(n):
                events = self._events_for(rec, p[in_col][i])
                ev_col[i] = events
                text_col[i] = events[-1]["text"] if events else ""
            return {**p, out_col: ev_col, f"{out_col}_text": text_col}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        schema.require(self.get_or_fail("input_col"))
        schema = schema.add(self.get_or_fail("output_col"), ColumnType.STRUCT)
        return schema.add(f"{self.get_or_fail('output_col')}_text",
                          ColumnType.STRING)


class ConversationTranscription(SpeechToTextSDK):
    """SpeechToTextSDK + online speaker attribution: each event carries a
    ``speaker`` id assigned by cosine-matching chunk feature centroids.
    Reference ``SpeechToTextSDK.scala:491`` (ConversationTranscription)."""

    def _events_for(self, rec: StreamingRecognizer, cell) -> List[Dict]:
        stream = self._stream_for(rec, cell)
        state = rec.new_state()
        events = []

        def hook(st, feats):  # features computed once, inside process_chunk
            _speaker_attribute(st, feats.mean(axis=0))

        for chunk in stream.chunks(rec.chunk_samples):
            events.append(rec.process_chunk(state, chunk, speaker_hook=hook))
        events.append(rec.finish(state))
        if not self.get("detailed"):
            events = [e for e in events if e["status"] == "Recognized"]
        return events


class SpeechServingModel(Transformer):
    """Serving-engine bridge: stateful sessions over the streaming source.

    Each request is ``{"session": id, "chunk": [floats], "final": bool}``;
    the reply is the incremental hypothesis for that session.  Drop this
    into ``PipelineServer``/``read_stream().transform_with(...)`` and the
    serving engine becomes a streaming transcription endpoint.  Without a
    ``recognizer``, one is made on ``device`` (unset: the card).
    """

    def __init__(self, recognizer: Optional[StreamingRecognizer] = None,
                 input_col: str = "request", reply_col: str = "reply",
                 session_ttl_s: float = 300.0, uid: Optional[str] = None,
                 device: DeviceLike = None):
        super().__init__(uid)
        self.recognizer = recognizer or StreamingRecognizer(device=device)
        self.input_col, self.reply_col = input_col, reply_col
        self._sessions: Dict[str, Tuple[float, RecognitionState,
                                        threading.Lock]] = {}
        self._lock = threading.Lock()
        self.session_ttl_s = session_ttl_s

    def _state(self, sid: str) -> Tuple[RecognitionState, threading.Lock]:
        """Returns the session's state AND its lock — callers mutate the
        state (pending buffer, LSTM carry, CTC prev_id) under the session
        lock so concurrent requests for one session serialize instead of
        corrupting the transcript."""
        import time
        with self._lock:
            now = time.monotonic()
            for k in [k for k, (t, _, _) in self._sessions.items()
                      if now - t > self.session_ttl_s]:
                del self._sessions[k]
            if sid not in self._sessions:
                self._sessions[sid] = (now, self.recognizer.new_state(),
                                       threading.Lock())
            t, st, lk = self._sessions[sid]
            self._sessions[sid] = (now, st, lk)
            return st, lk

    def _transform(self, df: DataFrame) -> DataFrame:
        def per_part(p):
            n = len(p[self.input_col])
            out = np.empty(n, dtype=object)
            for i in range(n):
                req = p[self.input_col][i]
                sid = str(req.get("session", "default"))
                state, session_lock = self._state(sid)
                rec = self.recognizer
                with session_lock:
                    # buffer client chunks into fixed device-step sizes so
                    # the compiled shape never changes mid-session (pad
                    # frames would otherwise pollute the LSTM carry)
                    incoming = np.asarray(req.get("chunk", []), np.float32)
                    state.pending = np.concatenate([state.pending, incoming])
                    ev = None
                    while len(state.pending) >= rec.chunk_samples:
                        full, state.pending = (state.pending[:rec.chunk_samples],
                                               state.pending[rec.chunk_samples:])
                        ev = rec.process_chunk(state, full)
                    if req.get("final"):
                        if len(state.pending):
                            rec.process_chunk(state, state.pending)
                            state.pending = np.zeros(0, np.float32)
                        ev = rec.finish(state)
                        with self._lock:
                            self._sessions.pop(sid, None)
                    elif ev is None:  # not enough buffered for a step yet
                        ev = {"status": "Buffering", "text": state.text,
                              "offset": state.frames_seen * rec.hop
                              / rec.sample_rate,
                              "duration": 0.0, "speaker": state.speaker}
                out[i] = ev
            return {**p, self.reply_col: out}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        return schema.add(self.reply_col, ColumnType.STRUCT)
