"""Request/response parsers for the HTTP stack.

An own copy of the JAX package's ``io/parsers.py``, verbatim apart from
module paths.

Reference: ``io/http/Parsers.scala`` (HTTPInputParser / JSONOutputParser /
CustomInputParser / CustomOutputParser).  These are the named building blocks
``SimpleHTTPTransformer`` composes; exposed here with the reference's names
so pipelines can declare parsing stages explicitly.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Optional

import numpy as np

from ..core import DataFrame, HasInputCol, HasOutputCol, Param, Transformer
from ..core.params import ComplexParam
from .http import HTTPRequestData, HTTPResponseData, RESPONSE_BINDING


class JSONInputParser(Transformer, HasInputCol, HasOutputCol):
    """Cell -> HTTPRequestData POSTing the cell as JSON (reference
    JSONInputParser)."""
    url = Param("url", "target endpoint", "string")
    method = Param("method", "HTTP method", "string", default="POST")
    headers = Param("headers", "extra headers", "object", default=None)

    def _transform(self, df: DataFrame) -> DataFrame:
        url = self.get_or_fail("url")
        headers = self.get("headers") or {}
        in_col, out_col = self.get_or_fail("input_col"), self.get_or_fail("output_col")

        def per_part(p):
            out = np.empty(len(p[in_col]), dtype=object)
            for i, v in enumerate(p[in_col]):
                out[i] = None if v is None else \
                    HTTPRequestData.post_json(url, v, headers)
            return {**p, out_col: out}

        return df.map_partitions(per_part)


class JSONOutputParser(Transformer, HasInputCol, HasOutputCol):
    """HTTPResponseData -> parsed JSON cell (reference JSONOutputParser)."""

    def _transform(self, df: DataFrame) -> DataFrame:
        in_col, out_col = self.get_or_fail("input_col"), self.get_or_fail("output_col")

        def per_part(p):
            out = np.empty(len(p[in_col]), dtype=object)
            for i, v in enumerate(p[in_col]):
                if v is None:
                    out[i] = None
                    continue
                resp = v if isinstance(v, HTTPResponseData) else \
                    RESPONSE_BINDING._decode(HTTPResponseData, v)
                try:
                    out[i] = resp.json()
                except (ValueError, AttributeError):
                    out[i] = None
            return {**p, out_col: out}

        return df.map_partitions(per_part)


class CustomInputParser(Transformer, HasInputCol, HasOutputCol):
    """Cell -> HTTPRequestData via a user function (reference CustomInputParser)."""
    udf = ComplexParam("udf", "cell -> HTTPRequestData function")

    def _transform(self, df: DataFrame) -> DataFrame:
        fn: Callable = self.get_or_fail("udf")
        in_col, out_col = self.get_or_fail("input_col"), self.get_or_fail("output_col")

        def per_part(p):
            out = np.empty(len(p[in_col]), dtype=object)
            for i, v in enumerate(p[in_col]):
                out[i] = None if v is None else fn(v)
            return {**p, out_col: out}

        return df.map_partitions(per_part)


class CustomOutputParser(Transformer, HasInputCol, HasOutputCol):
    """HTTPResponseData -> cell via a user function (reference CustomOutputParser)."""
    udf = ComplexParam("udf", "HTTPResponseData -> cell function")

    def _transform(self, df: DataFrame) -> DataFrame:
        fn: Callable = self.get_or_fail("udf")
        in_col, out_col = self.get_or_fail("input_col"), self.get_or_fail("output_col")

        def per_part(p):
            out = np.empty(len(p[in_col]), dtype=object)
            for i, v in enumerate(p[in_col]):
                if v is None:
                    out[i] = None
                    continue
                resp = v if isinstance(v, HTTPResponseData) else \
                    RESPONSE_BINDING._decode(HTTPResponseData, v)
                out[i] = fn(resp)
            return {**p, out_col: out}

        return df.map_partitions(per_part)
