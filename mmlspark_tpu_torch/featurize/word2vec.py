"""Word2Vec — skip-gram with negative sampling, trained on the card.

The port of ``mmlspark_tpu/featurize/word2vec.py``.  Reference surface: the
Amazon Book Reviews notebook pairs Spark MLlib's ``Word2Vec`` with
mmlspark's ``TrainClassifier``/``FindBestModel`` (``notebooks/TextAnalytics
- Amazon Book Reviews with Word2Vec.ipynb``).

The host part is the JAX package's, call for call on numpy's generator:
tokens, the frequency-capped vocabulary, the (center, context) pairs with
word2vec's dynamic window, the unigram^0.75 negative table, the initial
``W_in`` drawn after the pairs and each epoch's ``rng.permutation``.  The
JAX package runs an epoch as one ``instrumented_jit`` program,
``featurize.word2vec_epoch`` (a ``lax.scan`` of the steps), built anew in
each fit; the port books an epoch under the same name and signature
count (an ``instrumented_call`` built anew in each fit, so two same-shape
fits book twice, as the reference's do) and runs its steps in blocks of
``BLOCK_STEPS`` (``sgns_block``): one unbooked program
(``observability.compute.captured``) per fit, which on the card captures
a block once per length, with ``W_in``/``W_out`` donated, and replays it
over the epoch's slices (the remainder is a capture of its own length);
on the CPU the blocks run eagerly.  Nothing inside an epoch waits for the
card: the permuted pairs and the epoch's negatives go to the device once
per epoch, the negatives are drawn before any block (a generator draw is
never inside a graph), and ``W_in`` comes back once, after the last
epoch.  Each epoch is also a ``torch.profiler`` range of its name.

Negatives are drawn as ``jax.random.choice(..., p=)`` draws them
(``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))``, left side, float32),
on uniforms from a ``torch.Generator`` on the device seeded with
``seed + epoch``; ``Word2Vec(negative_uniforms=[...])`` (a constructor
keyword, not a param) passes each epoch's ``(steps, batch, negatives)``
uniforms in instead.  The cumulative table is summed on the host in
float32 in XLA's blocked order (``cumsum_blocked``), so every device
draws the index JAX draws from the same uniform.

``index_add_`` on a CUDA device adds in atomic order: a card fit equals a
CPU fit within a tolerance, never bit for bit, and a replayed fit equals
an eager one within a tolerance too.

``Word2VecModel.transform`` averages word vectors per document (exactly
MLlib's document-embedding semantics); ``find_synonyms`` does a cosine
top-k over the table.  Both are the JAX package's, on the host.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..observability.compute import (captured, device_put,
                                     instrumented_call)
from ..core import (DataFrame, Estimator, HasInputCol, HasOutputCol, Model,
                    Param)
from ..core.schema import vector_column


class _W2VParams(HasInputCol, HasOutputCol):
    vector_size = Param("vector_size", "embedding width", "int", default=64)
    min_count = Param("min_count", "min token occurrences", "int", default=2)
    window_size = Param("window_size", "context window", "int", default=5)
    num_negatives = Param("num_negatives", "negative samples per pair",
                          "int", default=5)
    max_iter = Param("max_iter", "epochs over the pair set", "int", default=1)
    step_size = Param("step_size", "SGD learning rate", "float",
                      default=0.25)
    batch_size = Param("batch_size", "pairs per jitted step", "int",
                       default=512)
    max_vocab = Param("max_vocab", "vocabulary cap (by frequency)", "int",
                      default=1 << 16)
    seed = Param("seed", "rng seed", "int", default=42)
    device = Param("device", "where training runs: unset = the CUDA card "
                   "(an error without one), 'cpu' = the host", "string",
                   default=None)


def _tokens_of(col) -> List[List[str]]:
    out = []
    for doc in col:
        if isinstance(doc, (list, tuple, np.ndarray)):
            out.append([str(t) for t in doc])
        else:
            out.append(str(doc).lower().split())
    return out


def cumsum_blocked(x: np.ndarray, base: int = 16) -> np.ndarray:
    """The float32 prefix sums ``jnp.cumsum`` gives on XLA's CPU and GPU
    backends, bit for bit: XLA rewrites a long cumulative sum into blocks
    of ``base`` summed in order, the blocks' totals scanned the same way
    (recursively), and each block's exclusive prefix added to its sums.
    A plain sequential float32 sum drifts from it by ~n ulps, enough to
    move 70% of the draws at a 65,536-word vocabulary."""
    x = np.asarray(x, np.float32)
    n = len(x)
    if n <= base:
        return np.cumsum(x, dtype=np.float32)
    m = -(-n // base)
    padded = np.zeros(m * base, np.float32)
    padded[:n] = x
    rows = np.cumsum(padded.reshape(m, base), axis=1, dtype=np.float32)
    totals = cumsum_blocked(rows[:, -1], base)
    before = np.concatenate([np.zeros(1, np.float32), totals[:-1]])
    return (rows + before[:, None]).reshape(-1)[:n]


def draw_negatives(cum: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, V, u.shape, p=p)`` given its uniforms ``u``
    and ``cum = cumsum(p)`` (float32): the index of the first cumulative
    entry >= ``cum[-1] * (1 - u)``."""
    return torch.searchsorted(cum, cum[-1] * (1.0 - u))


def sgns_step(W_in: torch.Tensor, W_out: torch.Tensor, c_ids: torch.Tensor,
              o_ids: torch.Tensor, negs: torch.Tensor, lr: float,
              ones_b: torch.Tensor, ones_bk: torch.Tensor) -> None:
    """One SGD step of skip-gram with negative sampling, in place: the JAX
    package's ``step`` (``mmlspark_tpu/featurize/word2vec.py:109-136``).
    Every read (``vc``, ``vo``, ``vn``) is taken from the tables before the
    step and every update is computed from those reads; ``W_out`` takes two
    scatter-adds (contexts, then negatives), both normalised by the
    word's count among the step's contexts and negatives."""
    V, D = W_in.shape
    vc = W_in[c_ids]                                     # (B, D)
    vo = W_out[o_ids]                                    # (B, D)
    vn = W_out[negs]                                     # (B, K, D)
    pos_logit = torch.sum(vc * vo, dim=1)
    neg_logit = torch.einsum("bd,bkd->bk", vc, vn)
    g_pos = torch.sigmoid(pos_logit) - 1.0               # (B,)
    g_neg = torch.sigmoid(neg_logit)                     # (B, K)
    d_vc = g_pos[:, None] * vo + torch.einsum("bk,bkd->bd", g_neg, vn)
    d_vo = g_pos[:, None] * vc
    d_vn = g_neg[:, :, None] * vc[:, None, :]
    # a word repeated in the batch would accumulate that many scatter adds
    # from stale reads; each word's update is divided by its multiplicity
    negs_f = negs.reshape(-1)
    cnt_in = torch.zeros(V, dtype=W_in.dtype, device=W_in.device) \
        .index_add_(0, c_ids, ones_b)
    cnt_out = torch.zeros(V, dtype=W_in.dtype, device=W_in.device) \
        .index_add_(0, o_ids, ones_b).index_add_(0, negs_f, ones_bk)
    W_in.index_add_(0, c_ids, -lr * d_vc / cnt_in[c_ids][:, None])
    W_out.index_add_(0, o_ids, -lr * d_vo / cnt_out[o_ids][:, None])
    W_out.index_add_(0, negs_f,
                     -lr * d_vn.reshape(-1, D) / cnt_out[negs_f][:, None])


#: SGD steps a captured block runs (the last block of an epoch runs the
#: remainder): a replay enqueues the block's ~30 kernels a step at once
BLOCK_STEPS = 32


def sgns_block(W_in: torch.Tensor, W_out: torch.Tensor, cen: torch.Tensor,
               ctx: torch.Tensor, negs: torch.Tensor, lr: float) -> None:
    """``len(cen)`` SGD steps in place, step ``s`` on ``cen[s]``,
    ``ctx[s]`` and ``negs[s]`` (``(L, B)``, ``(L, B)``, ``(L, B, K)``)."""
    L, B, K = negs.shape
    ones_b = torch.ones(B, dtype=W_in.dtype, device=W_in.device)
    ones_bk = torch.ones(B * K, dtype=W_in.dtype, device=W_in.device)
    for s in range(L):
        sgns_step(W_in, W_out, cen[s], ctx[s], negs[s], lr, ones_b, ones_bk)


class Word2Vec(Estimator, _W2VParams):
    """Fit skip-gram/negative-sampling embeddings over a text (or
    pre-tokenized list) column."""

    def __init__(self, uid: Optional[str] = None,
                 negative_uniforms: Optional[Sequence] = None, **kwargs):
        super().__init__(uid)
        #: per epoch, the ``(steps, batch, negatives)`` float32 uniforms of
        #: the negative draw (tests pass JAX's); ``None`` draws them
        self.negative_uniforms = negative_uniforms
        if kwargs:
            self.set_params(**kwargs)

    def _fit(self, df: DataFrame) -> "Word2VecModel":
        dev = resolve_device(self.get("device"))
        t_host = time.perf_counter()
        rng = np.random.default_rng(self.get("seed"))
        docs = _tokens_of(df.collect()[self.get_or_fail("input_col")])

        # ---- vocab (host): frequency-capped, unigram^0.75 negative table
        from collections import Counter
        counts = Counter(t for d in docs for t in d)
        vocab = [w for w, c in counts.most_common(self.get("max_vocab"))
                 if c >= self.get("min_count")]
        if not vocab:
            raise ValueError("Word2Vec: empty vocabulary "
                             "(min_count too high or empty input)")
        index = {w: i for i, w in enumerate(vocab)}
        V, D = len(vocab), self.get("vector_size")

        # ---- (center, context) pairs with random window shrink (word2vec's
        # dynamic window) — bounded memory: indices only
        win = self.get("window_size")
        centers, contexts = [], []
        for d in docs:
            ids = [index[t] for t in d if t in index]
            for i, c in enumerate(ids):
                w = int(rng.integers(1, win + 1))
                for j in range(max(0, i - w), min(len(ids), i + w + 1)):
                    if j != i:
                        centers.append(c)
                        contexts.append(ids[j])
        if not centers:
            raise ValueError("Word2Vec: no training pairs "
                             "(documents shorter than 2 in-vocab tokens)")
        centers = np.asarray(centers, np.int32)
        contexts = np.asarray(contexts, np.int32)

        freq = np.asarray([counts[w] for w in vocab], np.float64) ** 0.75
        neg_table = (freq / freq.sum()).astype(np.float32)
        pairs_s = time.perf_counter() - t_host

        K = int(self.get("num_negatives"))
        lr = float(self.get("step_size"))
        n_pairs = len(centers)
        B = min(int(self.get("batch_size")), n_pairs)  # tiny corpora
        steps_per_epoch = max(1, n_pairs // B)
        used = steps_per_epoch * B

        scale = 0.5 / D
        W_in = torch.from_numpy(rng.uniform(-scale, scale, (V, D))
                                .astype(np.float32)).to(dev)
        W_out = torch.zeros((V, D), dtype=torch.float32, device=dev)
        cum = torch.from_numpy(cumsum_blocked(neg_table)).to(dev)
        gen = torch.Generator(device=dev)
        # the reference's wrapper is built per fit, so is the port's: both
        # book one compile per fit and shape, and leave the report after it
        epoch = instrumented_call(self._epoch,
                                  name="featurize.word2vec_epoch")
        block = captured(sgns_block, name="featurize.word2vec_block",
                         donate_argnums=(0, 1), static_argnums=(5,))
        t_train = time.perf_counter()
        for ep in range(self.get("max_iter")):
            perm = rng.permutation(n_pairs)[:used]
            epoch(ep, W_in, W_out, centers[perm].reshape(-1, B),
                  contexts[perm].reshape(-1, B), cum, gen, K, lr, block)
        vectors = W_in.cpu().numpy()
        train_s = time.perf_counter() - t_train

        m = Word2VecModel()
        m._paramMap.update(self._paramMap)
        m.set("vocab", list(vocab))
        m.set("vectors", vectors.tolist())
        #: host seconds to the pairs, seconds of training (the epochs and the
        #: table's copy back), pairs and steps of each epoch; the block
        #: program's captures, re-captures, replays and capture seconds
        snap = block.snapshot()
        m.fit_stats = {"pairs_s": pairs_s, "train_s": train_s,
                       "pairs": used, "steps": steps_per_epoch,
                       "epochs": int(self.get("max_iter")), "vocab": V,
                       "captures": snap["captures"],
                       "recaptures": snap["recaptures"],
                       "replays": snap["replays"],
                       "capture_s": [c for c in snap["capture_seconds"]
                                     if c is not None]}
        return m

    def _epoch(self, ep: int, W_in: torch.Tensor, W_out: torch.Tensor,
               centers: np.ndarray, contexts: np.ndarray, cum: torch.Tensor,
               gen: torch.Generator, K: int, lr: float, block) -> None:
        """One epoch over the permuted ``(steps, batch)`` pairs, in place on
        the tables' device.  Nothing here waits for the card: the pairs
        (and given uniforms) go over in one non-blocking copy each, the
        negatives are drawn for the whole epoch at once, then ``block``
        runs the steps ``BLOCK_STEPS`` at a time."""
        dev = W_in.device
        S, B = centers.shape
        with torch.profiler.record_function("featurize.word2vec_epoch"):
            cen, ctx = device_put((centers.astype(np.int64),
                                   contexts.astype(np.int64)), dev,
                                  site="featurize.word2vec_pairs",
                                  non_blocking=True)
            if self.negative_uniforms is not None:
                u = device_put(np.array(self.negative_uniforms[ep],
                                          np.float32), dev,
                               site="featurize.word2vec_pairs",
                               non_blocking=True)
            else:
                gen.manual_seed(int(self.get("seed")) + ep)
                u = torch.rand((S, B, K), generator=gen, device=dev)
            negs = draw_negatives(cum, u)
            del u
            for s0 in range(0, S, BLOCK_STEPS):
                s1 = min(s0 + BLOCK_STEPS, S)
                block(W_in, W_out, cen[s0:s1], ctx[s0:s1], negs[s0:s1], lr)


class Word2VecModel(Model, _W2VParams):
    vocab = Param("vocab", "vocabulary (index order)", "list")
    vectors = Param("vectors", "(V, D) embedding table", "object")

    def __init__(self, uid: Optional[str] = None, **kwargs):
        super().__init__(uid)
        if kwargs:
            self.set_params(**kwargs)

    def _table(self):
        return (np.asarray(self.get("vectors"), np.float32),
                {w: i for i, w in enumerate(self.get("vocab"))})

    def _transform(self, df: DataFrame) -> DataFrame:
        vec, index = self._table()
        D = vec.shape[1]
        in_col = self.get_or_fail("input_col")
        out_col = self.get_or_fail("output_col")

        def per_part(p):
            docs = _tokens_of(p[in_col])
            out = np.empty(len(docs), dtype=object)
            for i, d in enumerate(docs):
                ids = [index[t] for t in d if t in index]
                out[i] = vec[ids].mean(axis=0) if ids \
                    else np.zeros(D, np.float32)
            return {**p, out_col: vector_column(list(out))}

        return df.map_partitions(per_part)

    def transform_schema(self, schema):
        out = dict(schema)
        out[self.get_or_fail("output_col")] = "vector"
        return out

    def find_synonyms(self, word: str, num: int = 5):
        """Cosine top-k neighbours of ``word`` -> [(token, similarity)]."""
        vec, index = self._table()
        if word not in index:
            raise KeyError(f"{word!r} not in Word2Vec vocabulary")
        q = vec[index[word]]
        norms = np.linalg.norm(vec, axis=1) * (np.linalg.norm(q) + 1e-12)
        sims = vec @ q / np.maximum(norms, 1e-12)
        sims[index[word]] = -np.inf
        top = np.argsort(-sims)[:num]
        vocab = self.get("vocab")
        return [(vocab[i], float(sims[i])) for i in top]
