"""Text featurization (the port's own copy of
``mmlspark_tpu/featurize/text.py``; host).

Reference: ``core/.../featurize/text/``: ``TextFeaturizer`` (tokenize ->
n-grams -> hashing-TF -> IDF pipeline), ``MultiNGram`` (several n-gram widths
concatenated), ``PageSplitter`` (split long strings into page-sized chunks).
"""
from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from ..core import (DataFrame, Estimator, HasInputCol, HasOutputCol, Model,
                    Param, Transformer)
from ..core.schema import vector_column
from ..vw.murmur import StringHashCache


def _tokenize(s: str, pattern: str, gaps: bool, min_len: int, lower: bool) -> List[str]:
    if lower:
        s = s.lower()
    toks = re.split(pattern, s) if gaps else re.findall(pattern, s)
    return [t for t in toks if len(t) >= min_len]


def _ngrams(tokens: List[str], n: int) -> List[str]:
    if n <= 1:
        return list(tokens)
    return [" ".join(tokens[i:i + n]) for i in range(len(tokens) - n + 1)]


class _TextFeaturizerParams(HasInputCol, HasOutputCol):
    use_tokenizer = Param("use_tokenizer", "tokenize input", "bool", default=True)
    tokenizer_pattern = Param("tokenizer_pattern", "regex", "string", default=r"\s+")
    tokenizer_gaps = Param("tokenizer_gaps", "pattern matches gaps", "bool", default=True)
    min_token_length = Param("min_token_length", "min token chars", "int", default=0)
    to_lower_case = Param("to_lower_case", "lowercase", "bool", default=True)
    use_stop_words_remover = Param("use_stop_words_remover", "drop stopwords", "bool", default=False)
    stop_words = Param("stop_words", "stopword list", "list", default=None)
    use_ngram = Param("use_ngram", "emit n-grams", "bool", default=False)
    n = Param("n", "n-gram width", "int", default=2)
    num_features = Param("num_features", "hash dims", "int", default=1 << 18)
    binary = Param("binary", "binary TF", "bool", default=False)
    use_idf = Param("use_idf", "apply IDF weighting", "bool", default=True)
    min_doc_freq = Param("min_doc_freq", "min docs for IDF", "int", default=1)

    _DEFAULT_STOPS = {"a", "an", "the", "and", "or", "of", "to", "in", "is",
                      "it", "this", "that", "for", "on", "with", "as", "at"}


class TextFeaturizer(Estimator, _TextFeaturizerParams):
    """tokenize -> stopwords -> n-grams -> hashing TF -> IDF
    (reference ``TextFeaturizer.scala`` pipeline assembly)."""

    def _terms(self, s: str) -> List[str]:
        toks = _tokenize(str(s), self.get("tokenizer_pattern"),
                         self.get("tokenizer_gaps"), self.get("min_token_length"),
                         self.get("to_lower_case")) if self.get("use_tokenizer") else [str(s)]
        if self.get("use_stop_words_remover"):
            stops = set(self.get("stop_words") or self._DEFAULT_STOPS)
            toks = [t for t in toks if t not in stops]
        if self.get("use_ngram"):
            toks = _ngrams(toks, self.get("n"))
        return toks

    def _fit(self, df):
        dims = self.get("num_features")
        hasher = StringHashCache()
        col = df.collect()[self.get_or_fail("input_col")]
        n_docs = len(col)
        df_counts = np.zeros(dims, np.float64)
        for s in col:
            idxs = {hasher(t) % dims for t in self._terms(s)}
            for j in idxs:
                df_counts[j] += 1
        idf = np.log((n_docs + 1.0) / (df_counts + 1.0)) + 1.0 if self.get("use_idf") else None
        if idf is not None and self.get("min_doc_freq") > 1:
            idf = np.where(df_counts >= self.get("min_doc_freq"), idf, 0.0)
        m = TextFeaturizerModel()
        m._paramMap.update(self._paramMap)
        m.set("idf", idf.tolist() if idf is not None else None)
        return m


class TextFeaturizerModel(Model, _TextFeaturizerParams):
    idf = Param("idf", "IDF weights", "object")

    _terms = TextFeaturizer._terms

    def _transform(self, df):
        dims = self.get("num_features")
        binary = self.get("binary")
        idf = self.get("idf")
        idf_arr = np.asarray(idf) if idf is not None else None
        hasher = StringHashCache()
        in_col, out_col = self.get_or_fail("input_col"), self.get_or_fail("output_col")

        def per_part(p):
            out = np.empty(len(p[in_col]), dtype=object)
            for i, s in enumerate(p[in_col]):
                vec = {}
                for t in self._terms(s):
                    j = hasher(t) % dims
                    vec[j] = 1.0 if binary else vec.get(j, 0.0) + 1.0
                idxs = np.asarray(sorted(vec), np.int64)
                vals = np.asarray([vec[j] for j in idxs], np.float64)
                if idf_arr is not None and len(idxs):
                    vals = vals * idf_arr[idxs]
                out[i] = {"indices": idxs.astype(np.int32),
                          "values": vals.astype(np.float32), "size": dims}
            return {**p, out_col: out}

        return df.map_partitions(per_part)


class MultiNGram(Transformer, HasInputCol, HasOutputCol):
    """Concatenate n-grams of several widths (reference ``MultiNGram.scala``)."""
    lengths = Param("lengths", "n-gram widths", "list", default=[1, 2, 3])

    def _transform(self, df):
        lengths = self.get("lengths")
        in_col, out_col = self.get_or_fail("input_col"), self.get_or_fail("output_col")

        def per_part(p):
            out = np.empty(len(p[in_col]), dtype=object)
            for i, toks in enumerate(p[in_col]):
                toks = list(toks)
                grams: List[str] = []
                for n in lengths:
                    grams.extend(_ngrams(toks, int(n)))
                out[i] = grams
            return {**p, out_col: out}

        return df.map_partitions(per_part)


class PageSplitter(Transformer, HasInputCol, HasOutputCol):
    """Split strings into page-sized chunks on whitespace boundaries
    (reference ``PageSplitter.scala``)."""
    maximum_page_length = Param("maximum_page_length", "max chars per page", "int", default=5000)
    minimum_page_length = Param("minimum_page_length", "min chars before a "
                                "whitespace split is taken", "int", default=4500)

    def _transform(self, df):
        max_len = self.get("maximum_page_length")
        min_len = self.get("minimum_page_length")
        in_col, out_col = self.get_or_fail("input_col"), self.get_or_fail("output_col")

        def split_one(s: str) -> List[str]:
            pages = []
            s = str(s)
            while len(s) > max_len:
                cut = max_len
                ws = [m.start() for m in re.finditer(r"\s", s[min_len:max_len])]
                if ws:
                    cut = min_len + ws[-1]
                pages.append(s[:cut])
                s = s[cut:]
            pages.append(s)
            return pages

        def per_part(p):
            out = np.empty(len(p[in_col]), dtype=object)
            for i, s in enumerate(p[in_col]):
                out[i] = split_one(s)
            return {**p, out_col: out}

        return df.map_partitions(per_part)
