"""Cognitive-service transformer base.

An own copy of the JAX package's ``cognitive/base.py``, verbatim apart from
module paths.

Reference: ``cognitive/.../CognitiveServiceBase.scala`` —
``HasServiceParams`` (:29, value-or-column duality), ``HasCognitiveServiceInput``
(:155, URL/header/body assembly), ``HasInternalJsonOutputParser`` (:210),
``CognitiveServicesBase`` (:258: internally composes Lambda -> SimpleHTTP
Transformer -> DropColumns pipeline).

Same architecture here: subclasses declare ServiceParams and implement
``_build_request(row)``; the base resolves params per-row, posts through the
async retrying client, parses JSON into the output column with an error
column for failures.  ``set_location`` fills the standard Azure URL template;
``set_linked_service`` is accepted for API parity (resolves to url+key).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

import numpy as np

from ..core import (DataFrame, HasOutputCol, Param, ServiceParam, Transformer)
from ..core.dataframe import Row, _part_len
from ..core.schema import ColumnType
from ..io.http import AsyncHTTPClient, HTTPRequestData, HTTPResponseData


class CognitiveServicesBase(Transformer, HasOutputCol):
    subscription_key = ServiceParam("subscription_key", "API key (value or column)")
    url = Param("url", "full endpoint URL", "string")
    location = Param("location", "Azure region; endpoint URL is resolved from "
                     "it at request-build time", "string")
    error_col = Param("error_col", "error output column", "string", default="error")
    concurrency = Param("concurrency", "max in-flight requests", "int", default=4)
    timeout = Param("timeout", "per-request timeout seconds", "float", default=60.0)
    breaker = Param("breaker", "shared CircuitBreaker guarding this service "
                    "endpoint (utils/resilience.py); open circuit -> "
                    "synthetic 503 rows in error_col, no network calls",
                    "object", default=None)

    _url_path: str = ""          # subclass: path under the location endpoint
    _service: str = "api.cognitive.microsoft.com"

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid)
        for k, v in kwargs.items():
            if k.endswith("_col") and isinstance(type(self)._params.get(k.replace("_col", "")), ServiceParam):
                self.set_col(k.replace("_col", ""), v)
            else:
                self.set(k, v)

    # ------------------------------------------------------------- url setup
    def set_location(self, location: str):
        """Reference HasSetLocation (:244): region -> standard endpoint.

        Only the region is stored; the URL is resolved lazily by
        ``_base_url`` so params that feed ``_url_path`` (e.g.
        RecognizeDomainSpecificContent.model) can be set in any order."""
        self.set("location", location)
        return self

    def _base_url(self) -> str:
        """Endpoint resolved at request-build time: an explicitly set ``url``
        wins; otherwise it is recomputed from location + the CURRENT
        ``_url_path`` so param-set order cannot leave a stale endpoint."""
        url = self.get("url")
        if url is not None:
            return url
        loc = self.get("location")
        if loc is not None:
            return f"https://{loc}.{self._service}{self._url_path}"
        return self.get_or_fail("url")  # raises the standard missing-param error

    def set_linked_service(self, name: str):
        """Accepted for parity (reference HasSetLinkedService:223 resolves
        Synapse linked services; here it must be pre-resolved)."""
        raise NotImplementedError(
            "linked services are a Synapse-only concept; call set_location + "
            "set_subscription_key instead")

    # ------------------------------------------------------------- request
    def _headers(self, row: Row) -> Dict[str, str]:
        headers = {"Content-Type": "application/json"}
        key = self.get("subscription_key")
        if key is not None:
            headers["Ocp-Apim-Subscription-Key"] = str(key.resolve(row))
        return headers

    def _build_request(self, row: Row) -> Optional[HTTPRequestData]:
        """Subclasses build the request; None skips the row (reference
        emits null outputs for rows with missing required params)."""
        raise NotImplementedError

    def _parse_response(self, resp: HTTPResponseData) -> Any:
        return resp.json()

    def _resolve_service(self, param_name: str, row: Row, default=None):
        v = self.get(param_name)
        if v is None:
            return default
        return v.resolve(row) if hasattr(v, "resolve") else v

    # ------------------------------------------------------------- transform
    def _transform(self, df: DataFrame) -> DataFrame:
        out_col = self.get_or_fail("output_col")
        err_col = self.get("error_col")

        def per_part(p):
            n = _part_len(p)
            rows = [Row({k: p[k][i] for k in p}) for i in range(n)]
            reqs = [self._build_request(r) for r in rows]
            client = AsyncHTTPClient(concurrency=self.get("concurrency"),
                                     timeout_s=self.get("timeout"),
                                     breaker=self.get("breaker"))
            resps = client.send_all(reqs)
            out = np.empty(n, dtype=object)
            errs = np.empty(n, dtype=object)
            for i, r in enumerate(resps):
                if r is None:
                    out[i], errs[i] = None, None
                elif 200 <= r.status_code < 300:
                    try:
                        out[i], errs[i] = self._parse_response(r), None
                    except Exception as e:  # noqa: BLE001
                        out[i], errs[i] = None, f"parse: {e}"
                else:
                    out[i] = None
                    errs[i] = {"status_code": r.status_code, "reason": r.reason,
                               "body": (r.entity or b"")[:500].decode("utf-8", "replace")}
            res = {**p, out_col: out}
            if err_col:
                res[err_col] = errs
            return res

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        s = schema.add(self.get_or_fail("output_col"), ColumnType.STRUCT)
        if self.get("error_col"):
            s = s.add(self.get("error_col"), ColumnType.STRUCT)
        return s
