"""AzureSearchWriter — push frames into Azure Cognitive Search indexes.

An own copy of the JAX package's ``cognitive/search.py``, verbatim apart
from module paths.

Reference: ``cognitive/.../AzureSearch.scala:142,:332-345`` (index
auto-creation via ``AzureSearchAPI.scala``, batched document upload through
the HTTP stack).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from ..core import DataFrame
from ..io.http import AsyncHTTPClient, HTTPRequestData


class AzureSearchWriter:
    API_VERSION = "2019-05-06"

    @staticmethod
    def _endpoint(service_name: str, index_name: str, path: str = "/docs/index") -> str:
        return (f"https://{service_name}.search.windows.net/indexes/{index_name}"
                f"{path}?api-version={AzureSearchWriter.API_VERSION}")

    @staticmethod
    def create_index(service_name: str, key: str, index_json: str) -> int:
        """Reference createIndex (AzureSearchAPI.scala)."""
        spec = json.loads(index_json)
        url = (f"https://{service_name}.search.windows.net/indexes"
               f"?api-version={AzureSearchWriter.API_VERSION}")
        client = AsyncHTTPClient(concurrency=1)
        resp = client.send(HTTPRequestData.post_json(url, spec, {"api-key": key}))
        return resp.status_code

    @staticmethod
    def write(df: DataFrame, service_name: str, index_name: str, key: str,
              action_col: Optional[str] = None, batch_size: int = 100,
              url_override: Optional[str] = None) -> List[int]:
        """Upload rows as search documents; returns per-batch status codes."""
        url = url_override or AzureSearchWriter._endpoint(service_name, index_name)
        client = AsyncHTTPClient(concurrency=4)
        statuses: List[int] = []
        rows = list(df.iter_rows())
        for s in range(0, len(rows), batch_size):
            docs = []
            for r in rows[s:s + batch_size]:
                doc = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                       for k, v in r.items()}
                doc["@search.action"] = doc.pop(action_col, "mergeOrUpload") \
                    if action_col else "mergeOrUpload"
                docs.append(doc)
            resp = client.send(HTTPRequestData.post_json(
                url, {"value": docs}, {"api-key": key}))
            statuses.append(resp.status_code)
        return statuses
