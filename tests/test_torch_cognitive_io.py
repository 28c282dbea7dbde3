"""The cognitive services and the rest of ``io/`` in the port against the
JAX package, on the CPU, against one local mock server on 127.0.0.1.

Every service transformer of ``cognitive/services.py`` is built by both
packages from the same case (``tests/resources/cognitive_requests.json``:
the service, its params, the columns it reads) over the same frame; the
requests the mock receives (method, path and query, the headers the
transformer sets, the body) are equal between the packages and equal to
the recorded ones, which ``chip_smoke.py`` holds the port to on the card's
host.  A 500 fills the error column in both.  ``AzureSearchWriter`` and
the PowerBI writer send equal batches.  The io copies (binary files and
their stream, images, the parsers, the CSV reader on the native parser,
the shared singletons, port forwarding) give equal frames; decoded images
feed the port's ``ImageFeaturizer``."""
import base64
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import mmlspark_tpu.cognitive as jcog
import mmlspark_tpu.core as jcore
import mmlspark_tpu.io as jio
import mmlspark_tpu_torch.cognitive as tcog
import mmlspark_tpu_torch.core as tcore
import mmlspark_tpu_torch.io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDED = os.path.join(ROOT, "tests", "resources",
                        "cognitive_requests.json")
#: headers the HTTP stack (not the transformer) writes
TRANSPORT_HEADERS = {"host", "user-agent", "accept-encoding", "connection",
                     "content-length"}
#: the trace context (ids of the ambient span, when there is one; the
#: tracing plane's own tests hold it)
TRACE_HEADERS = {"traceparent", "x-mmlspark-trace-id"}


class MockService:
    """JSON echo server on 127.0.0.1 recording each request; a path ending
    in ``/fail`` answers 500."""

    def __init__(self):
        owner = self
        self.requests = []

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                owner.requests.append(normalize(self.command, self.path,
                                                dict(self.headers), body))
                if self.path.split("?")[0].endswith("/fail"):
                    self.send_response(500)
                    self.end_headers()
                    return
                try:
                    payload = json.loads(body or b"null")
                except ValueError:
                    payload = {"raw_len": len(body)}
                resp = json.dumps({"echo": payload, "path": self.path}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(resp)))
                self.end_headers()
                self.wfile.write(resp)

            do_GET = do_POST

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.httpd.server_port}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def normalize(method, path, headers, body):
    """One received request as plain data: the transformer's own headers
    (transport and trace headers dropped, names lower-cased), the body as
    JSON where it parses, else base64."""
    try:
        parsed = {"json": json.loads(body)} if body else {"json": None}
    except ValueError:
        parsed = {"b64": base64.b64encode(body).decode()}
    return {"method": method, "path": path,
            "headers": {k.lower(): v for k, v in sorted(headers.items())
                        if k.lower() not in TRANSPORT_HEADERS | TRACE_HEADERS},
            "body": parsed}


def frame_columns(spec):
    """The recorded frame spec -> numpy columns (bytes from base64, lists
    and dicts as object cells)."""
    cols = {}
    for name, col in spec.items():
        vals = col["values"]
        if col["kind"] == "b64":
            vals = [base64.b64decode(v) for v in vals]
        arr = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            arr[i] = v
        cols[name] = arr
    return cols


def build(cog, case, url):
    svc = getattr(cog, case["service"])(output_col="out")
    svc.set("url", url + case["path"])
    for k, v in case["params"].items():
        svc.set(k, v)
    for k, col in case["cols"].items():
        svc.set_col(k, col)
    return svc


def drive(cog, core, recorded, url, requests):
    """Each case through ``cog``'s transformer; -> {service: sorted received
    requests}, and the outputs."""
    frame = core.DataFrame.from_dict(frame_columns(recorded["frame"]))
    got, outs = {}, {}
    for case in recorded["cases"]:
        del requests[:]
        outs[case["name"]] = build(cog, case, url).transform(frame).collect()
        got[case["name"]] = sorted(requests, key=json.dumps)
    return got, outs


@pytest.fixture()
def mock():
    s = MockService()
    yield s
    s.close()


def _recorded():
    with open(RECORDED) as f:
        return json.load(f)


def test_every_service_is_recorded():
    names = {c["service"] for c in _recorded()["cases"]}
    assert names == set(jcog.services.__dict__) & {
        n for n in jcog.__all__ if n not in (
            "CognitiveServicesBase", "AzureSearchWriter", "SpeechToTextSDK",
            "ConversationTranscription", "StreamingRecognizer",
            "SpeechServingModel")}
    assert set(tcog.__all__) == set(jcog.__all__)
    assert set(tio.__all__) >= set(jio.__all__)


def test_service_requests_equal_jax_and_the_recorded(mock):
    recorded = _recorded()
    jgot, jout = drive(jcog, jcore, recorded, mock.url, mock.requests)
    tgot, tout = drive(tcog, tcore, recorded, mock.url, mock.requests)
    want = {c["name"]: c["requests"] for c in recorded["cases"]}
    assert jgot == want
    assert tgot == want
    for name in want:
        for a, b in zip(tout[name]["out"], jout[name]["out"]):
            assert a == b
        assert list(tout[name]["error"]) == list(jout[name]["error"])


def test_error_column_fills_on_a_500(mock):
    recorded = _recorded()
    case = dict(recorded["cases"][0], path="/fail")
    for cog, core in ((jcog, jcore), (tcog, tcore)):
        frame = core.DataFrame.from_dict(frame_columns(recorded["frame"]))
        out = build(cog, case, mock.url).transform(frame).collect()
        assert all(v is None for v in out["out"])
        assert [e["status_code"] for e in out["error"]] == [500, 500]


def test_search_and_powerbi_writers_equal_jax(mock):
    from mmlspark_tpu.io import powerbi as jpbi
    from mmlspark_tpu_torch.io import powerbi as tpbi
    sent = {}
    for name, cog, core, pbi in (("j", jcog, jcore, jpbi),
                                 ("t", tcog, tcore, tpbi)):
        df = core.DataFrame.from_dict({
            "id": np.array([str(i) for i in range(5)], dtype=object),
            "score": np.arange(5) / 4.0,
            "act": np.array(["upload", "merge"] * 2 + ["delete"],
                            dtype=object)})
        del mock.requests[:]
        assert cog.AzureSearchWriter.write(
            df, "svc", "idx", "key", action_col="act", batch_size=2,
            url_override=mock.url + "/search") == [200, 200, 200]
        assert pbi.write(df, mock.url + "/powerbi", batch_size=3) == [200,
                                                                      200]
        sent[name] = sorted(mock.requests, key=json.dumps)
    assert sent["t"] == sent["j"]
    docs = [d for r in sent["t"] if r["path"] == "/search"
            for d in r["body"]["json"]["value"]]
    assert sorted(d["@search.action"] for d in docs) == sorted(
        ["upload", "merge"] * 2 + ["delete"])
    assert tcog.AzureSearchWriter._endpoint("s", "i") == \
        jcog.AzureSearchWriter._endpoint("s", "i")


def _tree(tmp_path):
    from PIL import Image
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.bin").write_bytes(b"hello")
    (tmp_path / "sub" / "b.bin").write_bytes(b"world!")
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (6 + i, 5, 3), np.uint8)).save(
            tmp_path / f"img{i}.png")
    (tmp_path / "broken.png").write_bytes(b"not a png")


def test_binary_and_image_io_equal_jax(tmp_path):
    _tree(tmp_path)
    for kw in ({"pattern": "*.bin"}, {"pattern": "*.bin", "recursive": False},
               {}):
        a = tio.read_binary_files(str(tmp_path), **kw).collect()
        b = jio.read_binary_files(str(tmp_path), **kw).collect()
        assert list(a["path"]) == list(b["path"])
        assert list(a["bytes"]) == list(b["bytes"])
    assert tio.list_files(str(tmp_path)) == jio.list_files(str(tmp_path))
    a = tio.read_images(str(tmp_path), pattern="*.png").collect()
    b = jio.read_images(str(tmp_path), pattern="*.png").collect()
    assert list(a["path"]) == list(b["path"]) and len(a["path"]) == 3
    for x, y in zip(a["image"], b["image"]):
        np.testing.assert_array_equal(x, y)
    kept = tio.read_images(str(tmp_path), pattern="*.png",
                           drop_invalid=False).collect()
    assert sum(v is None for v in kept["image"]) == 1
    back = tio.images_to_bytes_column(tio.read_images(
        str(tmp_path), pattern="*.png")).collect()
    np.testing.assert_array_equal(tio.decode_image(back["bytes"][0]),
                                  a["image"][0])


def test_decoded_images_feed_the_image_featurizer(tmp_path):
    """``read_images``' HWC uint8 arrays through the port's
    ``ImageFeaturizer`` (resize on the device, a module's features) on the
    CPU = the same module on the same resized input."""
    import torch
    from mmlspark_tpu_torch.dl import ImageFeaturizer
    from mmlspark_tpu_torch.ops import image as image_ops
    from PIL import Image
    rng = np.random.default_rng(1)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (9, 7, 3), np.uint8)).save(
            tmp_path / f"i{i}.png")
    df = tio.read_images(str(tmp_path))
    torch.manual_seed(0)
    module = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(
        8 * 8 * 3, 5))

    class Logits(torch.nn.Module):
        def forward(self, x, features=False):
            return module(x)

    feat = ImageFeaturizer(device="cpu", input_col="image", output_col="f",
                           height=8, width=8, auto_convert=False,
                           cut_output_layers=0, batch_size=2).set_model(
                               module=Logits())
    out = feat.transform(df).collect()["f"]
    imgs = df.collect()["image"]
    assert len(out) == 4
    with torch.no_grad():
        for img, got in zip(imgs, out):
            x = image_ops.resize(torch.tensor(img[None]).float(), 8, 8)
            # one row here against a padded batch there: float32 sums of
            # 192 products of ~70 in another order
            np.testing.assert_allclose(got, module(x)[0].numpy(), rtol=1e-5,
                                       atol=1e-4)


def test_binary_file_stream(tmp_path):
    import time
    (tmp_path / "a.bin").write_bytes(b"alpha")
    stream = tio.BinaryFileStream(str(tmp_path), poll_interval_s=0.05)
    assert [p.split("/")[-1] for p in stream.get_batch().collect()["path"]] \
        == ["a.bin"]
    assert stream.get_batch() is None
    got = []
    handle = stream.for_each_batch(
        lambda df: got.extend(bytes(b) for b in df.collect()["bytes"]))
    (tmp_path / "b.bin").write_bytes(b"beta")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not got:
        time.sleep(0.05)
    handle.stop()
    assert got == [b"beta"] and handle.last_error is None


def test_parsers_equal_jax(mock):
    from mmlspark_tpu.io import parsers as jp
    from mmlspark_tpu_torch.io import parsers as tp
    outs = {}
    for name, p, core, io in (("j", jp, jcore, jio), ("t", tp, tcore, tio)):
        cells = np.empty(3, dtype=object)
        cells[0], cells[1], cells[2] = {"a": 1}, None, [1, 2]
        df = core.DataFrame.from_dict({"x": cells})
        req = p.JSONInputParser().set_params(
            input_col="x", output_col="req", url=mock.url + "/p",
            headers={"K": "v"}).transform(df)
        resp = io.HTTPTransformer().set_params(
            input_col="req", output_col="resp").transform(req)
        parsed = p.JSONOutputParser().set_params(
            input_col="resp", output_col="out").transform(resp)
        custom = p.CustomOutputParser().set_params(
            input_col="resp", output_col="code")
        custom.set("udf", lambda r: r.status_code)
        cin = p.CustomInputParser().set_params(input_col="x",
                                               output_col="r2")
        cin.set("udf", lambda v: {"wrapped": v})
        out = cin.transform(custom.transform(parsed)).collect()
        outs[name] = (list(out["out"]), list(out["code"]), list(out["r2"]))
    assert outs["t"] == outs["j"]
    assert outs["t"][0][0]["echo"] == {"a": 1} and outs["t"][0][1] is None


def test_shared_singletons_and_port_forwarding(monkeypatch):
    from mmlspark_tpu_torch.io import port_forwarding, shared
    built = []
    v = shared.SharedVariable(lambda: built.append(1) or len(built))
    assert v.get() == 1 and v.get() == 1 and built == [1]
    a = shared.SharedSingleton.get_or_create("k", lambda: object())
    assert shared.SharedSingleton.get_or_create("k", lambda: None) is a
    shared.SharedSingleton.reset()
    assert shared.SharedSingleton.get_or_create("k", lambda: 5) == 5
    shared.SharedSingleton.reset()
    monkeypatch.setattr(port_forwarding.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ssh"):
        port_forwarding.PortForwarding.forward_port_to_remote(
            "u", "h", 1, 2)
    port_forwarding.PortForwarding.stop_all()


def test_read_csv_native_equals_the_python_route_and_jax(tmp_path):
    from mmlspark_tpu.io.csv import read_csv as jread
    from mmlspark_tpu_torch.io.csv import read_csv as tread
    rng = np.random.default_rng(2)
    X = np.round(rng.normal(size=(400, 6)), 4)
    path = tmp_path / "m.csv"
    np.savetxt(path, X, delimiter=",", header=",".join(
        f"f{j}" for j in range(6)), comments="", fmt="%.4f")
    nat = tread(str(path), numeric_only=True).collect()
    py = tread(str(path)).collect()
    ref = jread(str(path), numeric_only=True).collect()
    for j in range(6):
        c = f"f{j}"
        np.testing.assert_array_equal(nat[c], ref[c])
        # the native parser rounds each cell to float32
        np.testing.assert_array_equal(nat[c], py[c].astype(np.float32))


def record(path: str = RECORDED) -> None:
    """Write the recorded cases: every service's requests as the JAX
    package sends them to the mock (``python -m
    tests.test_torch_cognitive_io``)."""
    from mmlspark_tpu.io.audio import write_wav
    img = bytes(range(256)) * 3
    wav = write_wav(np.sin(np.arange(800) / 7.0).astype(np.float32), 16000)
    frame = {
        "text": {"kind": "json", "values": ["great product", "terrible"]},
        "txt2": {"kind": "json", "values": ["hola", "bonjour le monde"]},
        "img_url": {"kind": "json", "values": [
            "http://images.example/a.png", "http://images.example/b.jpg"]},
        "img": {"kind": "b64", "values": [
            base64.b64encode(img).decode(),
            base64.b64encode(img[::-1]).decode()]},
        "series": {"kind": "json", "values": [
            [{"timestamp": f"2024-01-0{i + 1}T00:00:00Z", "value": float(i)}
             for i in range(5)],
            [{"timestamp": f"2024-02-0{i + 1}T00:00:00Z",
              "value": float(i * i)} for i in range(6)]]},
        "body": {"kind": "json", "values": [
            {"faceId1": "a", "faceId2": "b"},
            {"faceIds": ["x", "y"], "personGroupId": "g"}]},
        "audio": {"kind": "b64", "values": [
            base64.b64encode(wav).decode(),
            base64.b64encode(wav[:200]).decode()]},
        "q": {"kind": "json", "values": ["cats", "dogs & mice"]},
    }
    key = {"subscription_key": "fake-key"}
    url_img, bytes_img = {"image_url": "img_url"}, {"image_bytes": "img"}
    specs = [
        ("TextSentiment", key, {"text": "text"}),
        ("LanguageDetector", key, {"text": "text"}),
        ("EntityDetector", {**key, "language": "es"}, {"text": "text"}),
        ("NER", key, {"text": "text"}),
        ("PII", key, {"text": "text"}),
        ("KeyPhraseExtractor", key, {"text": "text"}),
        ("OCR", {**key, "detect_orientation": False}, url_img),
        ("AnalyzeImage", {**key, "visual_features": ["Tags", "Faces"]},
         bytes_img),
        ("DescribeImage", {**key, "max_candidates": 3}, url_img),
        ("TagImage", key, bytes_img),
        ("RecognizeText", key, url_img),
        ("RecognizeDomainSpecificContent", {**key, "model": "landmarks"},
         url_img),
        ("GenerateThumbnails", {**key, "width": 32, "height": 48,
                                "smart_cropping": False}, bytes_img),
        ("DetectFace", {**key, "return_face_attributes": ["age", "gender"]},
         url_img),
        ("VerifyFaces", key, {"body": "body"}),
        ("GroupFaces", key, {"body": "body"}),
        ("IdentifyFaces", key, {"body": "body"}),
        ("FindSimilarFace", key, {"body": "body"}),
        ("DetectLastAnomaly", {**key, "granularity": "hourly",
                               "sensitivity": 95}, {"series": "series"}),
        ("DetectAnomalies", key, {"series": "series"}),
        ("Translate", {**key, "to_language": ["fr", "de"],
                       "subscription_region": "westus2"}, {"text": "txt2"}),
        ("Transliterate", key, {"text": "txt2"}),
        ("BreakSentence", key, {"text": "txt2"}),
        ("Detect", key, {"text": "txt2"}),
        ("AnalyzeLayout", key, url_img),
        ("AnalyzeReceipts", key, bytes_img),
        ("AnalyzeBusinessCards", key, url_img),
        ("AnalyzeInvoices", key, bytes_img),
        ("AnalyzeIDDocuments", key, url_img),
        ("SpeechToText", {**key, "language": "de-DE", "format": "detailed"},
         {"audio_data": "audio"}),
        ("BingImageSearch", {**key, "count": 5, "offset": 2},
         {"query": "q"}),
    ]
    cases = []
    for service, params, cols in specs:
        svc_path = getattr(jcog, service)._url_path
        if not isinstance(svc_path, str):       # a property of the instance
            svc_path = "/vision/v3.2/models/landmarks/analyze"
        cases.append({"name": service, "service": service,
                      "path": svc_path, "params": params, "cols": cols})
    recorded = {"frame": frame, "cases": cases}
    srv = MockService()
    try:
        got, _ = drive(jcog, jcore, recorded, srv.url, srv.requests)
    finally:
        srv.close()
    for case in cases:
        case["requests"] = got[case["name"]]
    with open(path, "w") as f:
        json.dump(recorded, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    record()
