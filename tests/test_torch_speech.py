"""Streaming speech in the port (``mmlspark_tpu_torch.cognitive.speech``,
``mmlspark_tpu_torch.io.audio``) against the JAX package, on the CPU: the
audio plane bit for bit (host copies); the encoder on the JAX recognizer's
converted variables within 1e-5 of the flax module's logits; streamed
chunks = one full-utterance pass for any chunking, and the text, frame
counts and durations equal to the JAX recognizer's; the transformers'
events, the speaker turns and the serving sessions equal to the JAX
package's; an ONNX LSTM through ``dl/onnx_import.py`` drives the
recognizer with the JAX package's ONNX route's text; a crafted
``apply_fn`` threads its carry across chunks."""
import json
import urllib.request

import numpy as np
import pytest
import torch

import mmlspark_tpu.cognitive as jcog
import mmlspark_tpu.core as jcore
import mmlspark_tpu.io.audio as jaudio
import mmlspark_tpu_torch.cognitive as tcog
import mmlspark_tpu_torch.core as tcore
import mmlspark_tpu_torch.io.audio as taudio
from mmlspark_tpu_torch.cognitive.speech import (DEFAULT_ALPHABET,
                                                 StreamingEncoder)
from mmlspark_tpu_torch.convert import streaming_encoder_state_dict_from_flax

SR = 16000
LOGIT_ATOL = 1e-5


def _tone(freq, seconds, sr=SR, amp=0.4):
    t = np.arange(int(seconds * sr)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


AUDIO = np.concatenate([_tone(300, 0.4), _tone(1200, 0.4), _tone(500, 0.4)])


def _pair(seed=3, chunk_s=0.25):
    """A JAX recognizer (its variables initialised) and a port recognizer on
    the CPU holding the same weights."""
    j = jcog.StreamingRecognizer(chunk_s=chunk_s, seed=seed)
    j.new_state()
    t = tcog.StreamingRecognizer(chunk_s=chunk_s, device="cpu")
    t.variables = j.variables
    return j, t


def _stream(rec, audio):
    state = rec.new_state()
    events = [rec.process_chunk(state, c)
              for c in taudio.PullAudioStream(audio, SR).chunks(
                  rec.chunk_samples)]
    events.append(rec.finish(state))
    return events, state


def test_audio_plane_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.5, 0.5, SR // 2).astype(np.float32)
    wav = taudio.write_wav(x, SR)
    assert wav == jaudio.write_wav(x, SR)
    np.testing.assert_array_equal(taudio.parse_wav(wav).samples,
                                  jaudio.parse_wav(wav).samples)
    np.testing.assert_array_equal(taudio.resample(x, SR, 8000),
                                  jaudio.resample(x, SR, 8000))
    np.testing.assert_array_equal(taudio.mel_filterbank(SR, 512, 40),
                                  jaudio.mel_filterbank(SR, 512, 40))
    for n in (100, SR // 3, SR):
        np.testing.assert_array_equal(taudio.log_mel(x[:n], SR, 40),
                                      jaudio.log_mel(x[:n], SR, 40))
    s = taudio.audio_stream(np.ones(100, np.float32), 8000, "pcm")
    assert s.sample_rate == 8000 and [len(c) for c in s.chunks(40)] == \
        [40, 40, 20]
    q = taudio.BlockingQueueIterator()
    q.put(1)
    q.put(2)
    q.close()
    assert list(q) == [1, 2]
    with pytest.raises(RuntimeError):
        q.put(3)


def test_encoder_converts_from_flax():
    import jax.numpy as jnp
    j, t = _pair()
    sd = streaming_encoder_state_dict_from_flax(j.variables)
    assert set(sd) == set(t.module.state_dict())
    assert t.module.lstm.num_layers == 2 and t.module.hidden_size == 128
    assert t.module.head.out_features == len(DEFAULT_ALPHABET)
    feats = jaudio.log_mel(AUDIO, SR, 40)
    carry_j, lj = j.module.apply(j.variables, j.init_carry(1),
                                 jnp.asarray(feats[None]))
    with torch.no_grad():
        carry_t, lt = t.module(t.init_carry(1), torch.from_numpy(feats[None]))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_ATOL)
    for (cj, hj), (ct, ht) in zip(carry_j, carry_t):     # flax's (c, h)
        # a constant tone drives the cells' c to ~100
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="do not fit"):
        streaming_encoder_state_dict_from_flax(
            j.variables, StreamingEncoder(hidden_size=64))
    with pytest.raises(KeyError):
        streaming_encoder_state_dict_from_flax({"params": {"dense": {}}})


@pytest.mark.parametrize("chunk_s", [0.25, 0.13])
def test_streaming_equals_batch_and_jax(chunk_s):
    j, t = _pair(chunk_s=chunk_s)
    t_events, t_state = _stream(t, AUDIO)
    j_events, j_state = _stream(j, AUDIO)
    assert [e["text"] for e in t_events] == [e["text"] for e in j_events]
    assert [e["status"] for e in t_events] == [e["status"] for e in j_events]
    assert t_state.frames_seen == j_state.frames_seen
    assert t_events[-1]["duration"] == j_events[-1]["duration"]
    big = tcog.StreamingRecognizer(chunk_s=10.0, device="cpu")
    big.variables = t.variables
    whole, w_state = _stream(big, AUDIO)
    assert whole[-1]["text"] == t_events[-1]["text"]
    assert w_state.frames_seen == t_state.frames_seen
    assert len(t_events[-1]["text"]) > 0


def test_short_stream_and_hypotheses_grow():
    j, t = _pair(seed=1, chunk_s=0.2)
    short = _tone(440, 0.02)                        # under one window
    assert _stream(t, short)[0][-1]["text"] == _stream(j, short)[0][-1][
        "text"]
    audio = np.concatenate([_tone(200, 0.3), _tone(900, 0.5),
                            _tone(450, 0.4)])
    events = list(t.transcribe_stream(taudio.PullAudioStream(audio, SR)))
    assert events[-1]["status"] == "Recognized"
    texts = [e["text"] for e in events]
    for a, b in zip(texts, texts[1:]):
        assert b.startswith(a)
    assert texts == [e["text"] for e in j.transcribe_stream(
        jaudio.PullAudioStream(audio, SR))]


def test_crafted_apply_fn_threads_its_carry():
    def apply_fn(variables, carry, feats):
        (count,) = carry
        t = feats.shape[1]
        idx = (count + torch.arange(t)) // 2 % 3 + 1
        logits = torch.zeros((1, t, 29))
        logits[0, torch.arange(t), idx] = 10.0
        return (count + t,), logits

    rec = tcog.StreamingRecognizer(apply_fn=apply_fn, variables={},
                                   chunk_s=0.1, device="cpu")
    rec.init_carry = lambda batch=1: (torch.zeros((), dtype=torch.int64),)
    final = _stream(rec, np.zeros(int(0.35 * SR), np.float32))[0][-1]
    assert set(final["text"]) <= {"a", "b", "c"}
    assert "aa" not in final["text"] and "bb" not in final["text"]
    assert len(final["text"]) >= 10
    with pytest.raises(ValueError, match="hidden_shapes"):
        tcog.StreamingRecognizer(apply_fn=apply_fn, device="cpu").new_state()

    def broken(v, c, f):
        raise ValueError("boom")

    rec = tcog.StreamingRecognizer(apply_fn=broken, variables={}, chunk_s=0.1,
                                   device="cpu", hidden_shapes=[4])
    with pytest.raises(ValueError, match="boom"):
        list(rec.transcribe_stream(taudio.PullAudioStream(
            np.zeros(SR, np.float32), SR)))


def _wav_frame(core, clips, sr=SR):
    col = np.empty(len(clips), dtype=object)
    for i, c in enumerate(clips):
        col[i] = taudio.write_wav(c, sr)
    return core.DataFrame.from_dict({"audio": col})


@pytest.mark.parametrize("cls", ["SpeechToTextSDK",
                                 "ConversationTranscription"])
def test_transformers_equal_jax(cls):
    j, t = _pair(seed=5, chunk_s=0.25)
    two_voices = np.concatenate([_tone(150, 1.0), _tone(3000, 1.0)])
    clips = [two_voices, _tone(800, 0.3), _tone(400, 0.6)]
    out = {}
    for name, pkg, core, rec in (("j", jcog, jcore, j), ("t", tcog, tcore, t)):
        stage = getattr(pkg, cls)(input_col="audio", output_col="ev",
                                  chunk_s=0.25)
        stage.set("recognizer", rec)
        out[name] = stage.transform(_wav_frame(core, clips)).collect()
    for a, b in zip(out["t"]["ev"], out["j"]["ev"]):
        assert a == b
    assert list(out["t"]["ev_text"]) == list(out["j"]["ev_text"])
    if cls == "ConversationTranscription":
        turns = [e["speaker"] for e in out["t"]["ev"][0]
                 if e["status"] == "Recognizing"]
        assert turns[0] != turns[-1]
    # an 8 kHz wav is resampled to the model's rate
    stage = tcog.SpeechToTextSDK(input_col="audio", output_col="ev",
                                 chunk_s=0.25, detailed=False)
    stage.set("recognizer", t)
    ev = stage.transform(_wav_frame(tcore, [_tone(300, 1.0, 8000)], 8000)) \
        .collect()["ev"][0]
    assert [e["status"] for e in ev] == ["Recognized"]
    assert abs(ev[0]["duration"] - 1.0) < 0.05


def test_serving_sessions_equal_offline():
    from mmlspark_tpu_torch.serving import PipelineServer
    _, rec = _pair(seed=6, chunk_s=0.2)
    model = tcog.SpeechServingModel(rec)
    srv = PipelineServer(model, port=0, mode="continuous").start()
    try:
        def post(payload):
            req = urllib.request.Request(
                srv.address, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read().decode())

        audio = np.concatenate([_tone(600, 0.45), _tone(1500, 0.3)])
        cs = rec.chunk_samples
        r = post({"session": "s1", "chunk": audio[:cs // 2].tolist()})
        assert r["status"] == "Buffering"
        r = post({"session": "s1", "chunk": audio[cs // 2: 2 * cs].tolist()})
        assert r["status"] == "Recognizing"
        r2 = post({"session": "s2", "chunk": audio[:cs].tolist()})
        assert r2["status"] == "Recognizing" and r2["offset"] == 0.0
        final = post({"session": "s1", "chunk": audio[2 * cs:].tolist(),
                      "final": True})
        assert final["status"] == "Recognized"
        assert final["text"] == _stream(rec, audio)[0][-1]["text"]
    finally:
        srv.stop()


def test_onnx_lstm_drives_the_recognizer():
    """A torch LSTM + head in ONNX wire format (the JAX package's test's
    graph) through the port's ``onnx_to_jax`` is the recognizer's
    ``apply_fn``; streamed text = the torch module's full-utterance argmax
    decode = the JAX package's ONNX route's text."""
    import torch.nn as tnn
    from mmlspark_tpu.dl.onnx_import import onnx_to_jax as j_onnx
    from mmlspark_tpu_torch.dl.onnx_import import onnx_to_jax as t_onnx
    from mmlspark_tpu_torch.dl.onnx_wire import build_model, encode_node

    n_mels, hidden, n_sym = 40, 16, 29
    torch.manual_seed(0)
    lstm = tnn.LSTM(input_size=n_mels, hidden_size=hidden).eval()
    head = tnn.Linear(hidden, n_sym).eval()

    def reorder(w):  # torch ifgo -> ONNX iofc
        i, f, g, o = np.split(w.detach().numpy(), 4, axis=0)
        return np.concatenate([i, o, f, g], axis=0)

    init = {
        "W": reorder(lstm.weight_ih_l0)[None].astype(np.float32),
        "R": reorder(lstm.weight_hh_l0)[None].astype(np.float32),
        "B": np.concatenate([reorder(lstm.bias_ih_l0[:, None])[:, 0],
                             reorder(lstm.bias_hh_l0[:, None])[:, 0]])[None]
        .astype(np.float32),
        "hw": head.weight.detach().numpy(), "hb": head.bias.detach().numpy(),
        "shape2d": np.asarray([-1, hidden], np.int64)}
    nodes = [
        encode_node("LSTM", ["x", "W", "R", "B", "", "h0", "c0"],
                    ["Y", "Y_h", "Y_c"], hidden_size=hidden),
        encode_node("Squeeze", ["Y"], ["Ys"], axes=[1]),
        encode_node("Reshape", ["Ys", "shape2d"], ["Ys_2d"]),
        encode_node("Gemm", ["Ys_2d", "hw", "hb"], ["logits2d"], transB=1)]
    data = build_model(nodes, init,
                       [("x", [8, 1, n_mels]), ("h0", [1, 1, hidden]),
                        ("c0", [1, 1, hidden])],
                       [("logits2d", [8, n_sym]), ("Y_h", [1, 1, hidden]),
                        ("Y_c", [1, 1, hidden])])
    onnx_fn, onnx_vars = t_onnx(data, device="cpu")

    def apply_fn(variables, carry, feats):
        h0, c0 = carry
        logits2d, yh, yc = onnx_fn(variables, feats.transpose(0, 1), h0, c0)
        return (yh, yc), logits2d[None]

    rec = tcog.StreamingRecognizer(apply_fn=apply_fn, variables=onnx_vars,
                                   chunk_s=0.2, device="cpu")
    rec.init_carry = lambda batch=1: (torch.zeros((1, 1, hidden)),
                                      torch.zeros((1, 1, hidden)))
    audio = np.concatenate([_tone(250, 0.45), _tone(1100, 0.45)])
    streamed = _stream(rec, audio)[0][-1]["text"]

    feats_full = taudio.log_mel(audio, SR, n_mels)
    with torch.no_grad():
        y, _ = lstm(torch.from_numpy(feats_full[:, None, :]))
        ids = head(y[:, 0]).argmax(dim=1).numpy()
    prev, out = 0, []
    for i in ids:
        if i != prev and i != 0:
            out.append(DEFAULT_ALPHABET[i])
        prev = int(i)
    assert streamed == "".join(out) and len(streamed) > 0

    import jax.numpy as jnp
    jfn, jvars = j_onnx(data)

    def j_apply(variables, carry, feats):
        h0, c0 = carry
        logits2d, yh, yc = jfn(variables, jnp.transpose(feats, (1, 0, 2)),
                               h0, c0)
        return (yh, yc), logits2d[None]

    jrec = jcog.StreamingRecognizer(apply_fn=j_apply, variables=jvars,
                                    chunk_s=0.2)
    jrec.init_carry = lambda batch=1: (jnp.zeros((1, 1, hidden)),
                                       jnp.zeros((1, 1, hidden)))
    assert _stream(jrec, audio)[0][-1]["text"] == streamed


def test_recognizer_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcog.StreamingRecognizer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcog.SpeechServingModel()
    stage = tcog.SpeechToTextSDK(input_col="audio", output_col="ev")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stage.transform(_wav_frame(tcore, [_tone(300, 0.2)])).collect()
    stage.set_params(device="cpu")
    assert stage.transform(_wav_frame(tcore, [_tone(300, 0.2)])).collect()[
        "ev"][0][-1]["status"] == "Recognized"
