"""Concrete cognitive-service transformers.

An own copy of the JAX package's ``cognitive/services.py``, verbatim apart
from module paths.

Reference: one transformer per API under ``cognitive/src/main/scala/.../
cognitive/`` (SURVEY.md §2.8): TextAnalytics (sentiment/NER/key-phrase/
language), ComputerVision (OCR/analyze/describe/tag/thumbnail), Face,
SpeechToText, AnomalyDetector, TextTranslator, FormRecognizer,
BingImageSearch.  Schemas follow the public Azure REST contracts; this
environment is zero-egress so tests exercise them against a local mock.
"""
from __future__ import annotations

import base64
import json
from typing import Any, Optional

from ..core import Param, ServiceParam
from ..core.dataframe import Row
from ..io.http import HTTPRequestData
from .base import CognitiveServicesBase


# ---------------------------------------------------------------------------
# Text Analytics (reference TextAnalytics.scala; v3 document batch contract)
# ---------------------------------------------------------------------------

class _TextAnalyticsBase(CognitiveServicesBase):
    text = ServiceParam("text", "document text", required=True)
    language = ServiceParam("language", "document language", default="en")

    def _build_request(self, row: Row) -> Optional[HTTPRequestData]:
        text = self._resolve_service("text", row)
        if text is None:
            return None
        lang = self._resolve_service("language", row, "en")
        texts = text if isinstance(text, (list, tuple)) else [text]
        langs = lang if isinstance(lang, (list, tuple)) else [lang] * len(texts)
        docs = [{"id": str(i), "text": t, "language": l}
                for i, (t, l) in enumerate(zip(texts, langs))]
        return HTTPRequestData.post_json(self._base_url(),
                                         {"documents": docs},
                                         self._headers(row))


class TextSentiment(_TextAnalyticsBase):
    _url_path = "/text/analytics/v3.0/sentiment"


class LanguageDetector(_TextAnalyticsBase):
    _url_path = "/text/analytics/v3.0/languages"


class EntityDetector(_TextAnalyticsBase):
    _url_path = "/text/analytics/v3.0/entities/linking"


class NER(_TextAnalyticsBase):
    _url_path = "/text/analytics/v3.0/entities/recognition/general"


class PII(_TextAnalyticsBase):
    _url_path = "/text/analytics/v3.0/entities/recognition/pii"


class KeyPhraseExtractor(_TextAnalyticsBase):
    _url_path = "/text/analytics/v3.0/keyPhrases"


# ---------------------------------------------------------------------------
# Computer Vision (reference ComputerVision.scala)
# ---------------------------------------------------------------------------

class _ImageServiceBase(CognitiveServicesBase):
    image_url = ServiceParam("image_url", "public image url")
    image_bytes = ServiceParam("image_bytes", "raw image bytes")

    def _image_request(self, row: Row, url: str) -> Optional[HTTPRequestData]:
        img_url = self._resolve_service("image_url", row)
        img_bytes = self._resolve_service("image_bytes", row)
        headers = self._headers(row)
        if img_url is not None:
            return HTTPRequestData.post_json(url, {"url": img_url}, headers)
        if img_bytes is not None:
            headers["Content-Type"] = "application/octet-stream"
            return HTTPRequestData(url=url, method="POST", headers=headers,
                                   entity=bytes(img_bytes))
        return None

    def _build_request(self, row: Row) -> Optional[HTTPRequestData]:
        return self._image_request(row, self._full_url(row))

    def _full_url(self, row: Row) -> str:
        return self._base_url()


class OCR(_ImageServiceBase):
    _url_path = "/vision/v3.2/ocr"
    detect_orientation = Param("detect_orientation", "detect text orientation", "bool", default=True)

    def _full_url(self, row):
        return f"{self._base_url()}?detectOrientation={str(self.get('detect_orientation')).lower()}"


class AnalyzeImage(_ImageServiceBase):
    _url_path = "/vision/v3.2/analyze"
    visual_features = Param("visual_features", "features to extract", "list",
                            default=["Categories", "Tags", "Description"])

    def _full_url(self, row):
        return f"{self._base_url()}?visualFeatures={','.join(self.get('visual_features'))}"


class DescribeImage(_ImageServiceBase):
    _url_path = "/vision/v3.2/describe"
    max_candidates = Param("max_candidates", "caption candidates", "int", default=1)

    def _full_url(self, row):
        return f"{self._base_url()}?maxCandidates={self.get('max_candidates')}"


class TagImage(_ImageServiceBase):
    _url_path = "/vision/v3.2/tag"


class RecognizeText(_ImageServiceBase):
    _url_path = "/vision/v3.2/read/analyze"


class RecognizeDomainSpecificContent(_ImageServiceBase):
    """Domain-model image analysis (celebrities/landmarks) — reference
    ``RecognizeDomainSpecificContent`` (Celebrity Quote Analysis notebook).
    The domain model is part of the endpoint path; the URL is resolved at
    request-build time, so ``model`` and ``set_location`` may be set in any
    order."""
    model = Param("model", "domain model name (celebrities|landmarks)",
                  "string", default="celebrities")

    @property
    def _url_path(self) -> str:  # type: ignore[override]
        return f"/vision/v3.2/models/{self.get('model')}/analyze"


class GenerateThumbnails(_ImageServiceBase):
    _url_path = "/vision/v3.2/generateThumbnail"
    width = Param("width", "thumbnail width", "int", default=64)
    height = Param("height", "thumbnail height", "int", default=64)
    smart_cropping = Param("smart_cropping", "smart crop", "bool", default=True)

    def _full_url(self, row):
        return (f"{self._base_url()}?width={self.get('width')}"
                f"&height={self.get('height')}&smartCropping="
                f"{str(self.get('smart_cropping')).lower()}")

    def _parse_response(self, resp):
        return base64.b64encode(resp.entity or b"").decode()


# ---------------------------------------------------------------------------
# Face (reference Face.scala)
# ---------------------------------------------------------------------------

class DetectFace(_ImageServiceBase):
    _url_path = "/face/v1.0/detect"
    return_face_attributes = Param("return_face_attributes", "attributes", "list", default=[])

    def _full_url(self, row):
        attrs = ",".join(self.get("return_face_attributes") or [])
        suffix = f"?returnFaceAttributes={attrs}" if attrs else ""
        return self._base_url() + suffix


class _JsonBodyService(CognitiveServicesBase):
    """Services posting an explicit JSON body from a column."""
    body = ServiceParam("body", "JSON request body", required=True)

    def _build_request(self, row):
        body = self._resolve_service("body", row)
        if body is None:
            return None
        return HTTPRequestData.post_json(self._base_url(), body,
                                         self._headers(row))


class VerifyFaces(_JsonBodyService):
    _url_path = "/face/v1.0/verify"


class GroupFaces(_JsonBodyService):
    _url_path = "/face/v1.0/group"


class IdentifyFaces(_JsonBodyService):
    _url_path = "/face/v1.0/identify"


class FindSimilarFace(_JsonBodyService):
    _url_path = "/face/v1.0/findsimilars"


# ---------------------------------------------------------------------------
# Anomaly Detector (reference AnomalyDetection.scala)
# ---------------------------------------------------------------------------

class _AnomalyBase(CognitiveServicesBase):
    series = ServiceParam("series", "list of {timestamp, value} points", required=True)
    granularity = ServiceParam("granularity", "series granularity", default="daily")
    sensitivity = ServiceParam("sensitivity", "detection sensitivity 0-99")

    def _build_request(self, row):
        series = self._resolve_service("series", row)
        if series is None:
            return None
        body = {"series": [dict(p) for p in series],
                "granularity": self._resolve_service("granularity", row, "daily")}
        sens = self._resolve_service("sensitivity", row)
        if sens is not None:
            body["sensitivity"] = sens
        return HTTPRequestData.post_json(self._base_url(), body,
                                         self._headers(row))


class DetectLastAnomaly(_AnomalyBase):
    _url_path = "/anomalydetector/v1.0/timeseries/last/detect"


class DetectAnomalies(_AnomalyBase):
    _url_path = "/anomalydetector/v1.0/timeseries/entire/detect"


# ---------------------------------------------------------------------------
# Translator (reference TextTranslator.scala; global endpoint)
# ---------------------------------------------------------------------------

class _TranslatorBase(CognitiveServicesBase):
    _service = "cognitive.microsofttranslator.com"
    text = ServiceParam("text", "text(s) to process", required=True)
    to_language = ServiceParam("to_language", "target language(s)", default="en")
    subscription_region = ServiceParam("subscription_region", "resource region")

    def _headers(self, row):
        h = super()._headers(row)
        region = self._resolve_service("subscription_region", row)
        if region:
            h["Ocp-Apim-Subscription-Region"] = str(region)
        return h

    def _body(self, row):
        text = self._resolve_service("text", row)
        texts = text if isinstance(text, (list, tuple)) else [text]
        return [{"Text": t} for t in texts]

    def _build_request(self, row):
        if self._resolve_service("text", row) is None:
            return None
        return HTTPRequestData.post_json(self._full_url(row), self._body(row),
                                         self._headers(row))

    def _full_url(self, row):
        return self._base_url()


class Translate(_TranslatorBase):
    _url_path = "/translate?api-version=3.0"

    def _full_url(self, row):
        to = self._resolve_service("to_language", row, "en")
        tos = to if isinstance(to, (list, tuple)) else [to]
        return self._base_url() + "".join(f"&to={t}" for t in tos)


class Transliterate(_TranslatorBase):
    _url_path = "/transliterate?api-version=3.0"


class BreakSentence(_TranslatorBase):
    _url_path = "/breaksentence?api-version=3.0"


class Detect(_TranslatorBase):
    _url_path = "/detect?api-version=3.0"


# ---------------------------------------------------------------------------
# Form Recognizer (reference FormRecognizer.scala)
# ---------------------------------------------------------------------------

class _FormRecognizerBase(_ImageServiceBase):
    pass


class AnalyzeLayout(_FormRecognizerBase):
    _url_path = "/formrecognizer/v2.1/layout/analyze"


class AnalyzeReceipts(_FormRecognizerBase):
    _url_path = "/formrecognizer/v2.1/prebuilt/receipt/analyze"


class AnalyzeBusinessCards(_FormRecognizerBase):
    _url_path = "/formrecognizer/v2.1/prebuilt/businessCard/analyze"


class AnalyzeInvoices(_FormRecognizerBase):
    _url_path = "/formrecognizer/v2.1/prebuilt/invoice/analyze"


class AnalyzeIDDocuments(_FormRecognizerBase):
    _url_path = "/formrecognizer/v2.1/prebuilt/idDocument/analyze"


# ---------------------------------------------------------------------------
# Speech-to-text (reference SpeechToText.scala REST path; the streaming SDK
# variant SpeechToTextSDK is N/A without the native Speech SDK — the REST
# short-audio contract is provided)
# ---------------------------------------------------------------------------

class SpeechToText(CognitiveServicesBase):
    _service = "stt.speech.microsoft.com"
    _url_path = "/speech/recognition/conversation/cognitiveservices/v1"
    audio_data = ServiceParam("audio_data", "wav bytes", required=True)
    language = ServiceParam("language", "recognition language", default="en-US")
    format = ServiceParam("format", "simple|detailed", default="simple")

    def _build_request(self, row):
        audio = self._resolve_service("audio_data", row)
        if audio is None:
            return None
        lang = self._resolve_service("language", row, "en-US")
        fmt = self._resolve_service("format", row, "simple")
        headers = self._headers(row)
        headers["Content-Type"] = "audio/wav; codecs=audio/pcm; samplerate=16000"
        url = f"{self._base_url()}?language={lang}&format={fmt}"
        return HTTPRequestData(url=url, method="POST", headers=headers,
                               entity=bytes(audio))


# ---------------------------------------------------------------------------
# Bing image search (reference BingImageSearch.scala)
# ---------------------------------------------------------------------------

class BingImageSearch(CognitiveServicesBase):
    _service = "api.bing.microsoft.com"
    _url_path = "/v7.0/images/search"
    query = ServiceParam("query", "search query", required=True)
    count = Param("count", "results per query", "int", default=10)
    offset = Param("offset", "result offset", "int", default=0)

    def _build_request(self, row):
        q = self._resolve_service("query", row)
        if q is None:
            return None
        import urllib.parse
        url = (f"{self._base_url()}?q={urllib.parse.quote(str(q))}"
               f"&count={self.get('count')}&offset={self.get('offset')}")
        return HTTPRequestData(url=url, method="GET", headers=self._headers(row))

    @staticmethod
    def download_from_urls(df, url_col: str, bytes_col: str = "image_bytes",
                           concurrency: int = 8):
        """Reference BingImageSearch.downloadFromUrls helper."""
        from ..io.http import AsyncHTTPClient, HTTPRequestData as Req
        import numpy as np

        def per_part(p):
            client = AsyncHTTPClient(concurrency=concurrency)
            reqs = [None if u is None else Req(url=str(u)) for u in p[url_col]]
            resps = client.send_all(reqs)
            out = np.empty(len(reqs), dtype=object)
            for i, r in enumerate(resps):
                out[i] = r.entity if r is not None and r.status_code == 200 else None
            return {**p, bytes_col: out}

        return df.map_partitions(per_part)
