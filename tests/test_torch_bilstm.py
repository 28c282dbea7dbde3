"""Port parity for the BiLSTM tagger (``mmlspark_tpu_torch/models/
bilstm.py``), its converter, the zoo's ``"BiLSTM"`` and ``JaxModel`` on
token columns, against the JAX package on the CPU; and
``examples/bilstm_entity_extraction.py``'s trained tagger (60 Adam steps
in JAX, as the example trains it) carried across: the port's token
predictions equal the JAX package's on the example's 64 test sequences.

Tolerances: float32 logits within atol 1e-5 (measured ~1e-7: the same
gates, summed in another order); the trained tagger's argmax exactly;
bfloat16 within atol 0.05 of the JAX package's on logits of magnitude
~1 (both round the embedding and the head to bfloat16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JaxDataFrame
from mmlspark_tpu.dl import JaxModel as JaxJaxModel
from mmlspark_tpu.dl import ModelDownloader as JaxDownloader
from mmlspark_tpu.models import bilstm as jax_bilstm
from mmlspark_tpu_torch.convert import (bilstm_state_dict_from_flax,
                                        lstm_weights_from_flax)
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.dl import JaxModel, ModelDownloader, ModelRepo
from mmlspark_tpu_torch.models import bilstm

ATOL = 1e-5


def pair(seed=0, jdtype=jnp.float32, tdtype=torch.float32, **kw):
    cfg = {**dict(vocab_size=30, num_tags=4, embed_dim=8, hidden=6,
                  num_layers=2), **kw}
    ref = jax_bilstm.BiLSTMTagger(**cfg, dtype=jdtype)
    variables = ref.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 5), jnp.int32))
    port = bilstm.BiLSTMTagger(**cfg, dtype=tdtype)
    port.load_state_dict(bilstm_state_dict_from_flax(variables, port))
    return ref, variables, port


def tokens(shape, seed=1, vocab=30):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("features", [False, True])
@pytest.mark.parametrize("layers", [1, 2, 3])
def test_tagger_equals_flax(layers, features):
    ref, variables, port = pair(seed=layers, num_layers=layers)
    x = tokens((4, 11), seed=layers)
    apply = jax.jit(ref.apply, static_argnames="features")
    want = np.asarray(apply(variables, x, features=features))
    with torch.no_grad():
        got = port(torch.from_numpy(x), features=features).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_tagger_bfloat16_follows_flax():
    ref, variables, port = pair(jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    x = tokens((3, 9), seed=2)
    want = np.asarray(jax.jit(ref.apply)(variables, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=0.05)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_equals_flax(reverse):
    ref = jax_bilstm.LSTMLayer(7, reverse=reverse)
    xs = np.random.default_rng(3).normal(size=(2, 9, 5)).astype(np.float32)
    variables = ref.init(jax.random.PRNGKey(4), xs)
    want = np.asarray(ref.apply(variables, xs))
    port = bilstm.LSTMLayer(5, 7, reverse=reverse)
    w = lstm_weights_from_flax(variables["params"]["OptimizedLSTMCell_0"])
    port.lstm.load_state_dict({k + "_l0": v for k, v in w.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_converter_rejects_foreign_and_misfit_variables():
    _, variables, port = pair()
    with pytest.raises(KeyError, match="lstm_0"):
        bilstm_state_dict_from_flax(
            {"params/lstm_0/kernel": np.zeros((2, 2), np.float32)})
    one = bilstm.BiLSTMTagger(30, 4, embed_dim=8, hidden=6, num_layers=1)
    with pytest.raises(ValueError, match="unexpected"):
        bilstm_state_dict_from_flax(variables, one)


def _column(rows):
    col = np.empty(len(rows), dtype=object)
    for i, r in enumerate(rows):
        col[i] = r
    return col


def test_jax_model_scores_int32_token_columns_as_the_reference():
    ref, variables, port = pair(seed=5)
    x = tokens((7, 10), seed=6)
    col = _column(x)
    want = JaxJaxModel().set_model(module=ref, variables=variables)
    want.set_params(input_col="tokens", output_col="tags", batch_size=4,
                    input_dtype="int32")
    want = np.stack(list(want.transform(JaxDataFrame.from_dict(
        {"tokens": col}, num_partitions=2)).collect()["tags"]))
    jm = JaxModel(input_col="tokens", output_col="tags", batch_size=4,
                  input_dtype="int32", device="cpu").set_model(module=port)
    got = np.stack(list(jm.transform(DataFrame.from_dict(
        {"tokens": col}, num_partitions=2)).collect()["tags"]))
    assert got.shape == (7, 10, 4)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert jm.runner().bucket_calls == {4: 2}     # chunks 4 + 3 -> 4


def test_zoo_builds_the_tagger_and_the_repo_reads_both_packages(tmp_path):
    payload = ModelDownloader().download_by_name(
        "BiLSTM", device="cpu", vocab_size=50, num_tags=5)
    assert isinstance(payload.module, bilstm.BiLSTMTagger)
    assert payload.module.embed.weight.shape == (50, 128)
    with torch.no_grad():
        out = payload.module(torch.from_numpy(tokens((2, 7), vocab=50)))
    assert out.shape == (2, 7, 5) and torch.isfinite(out).all()
    # a port-written checkpoint loads from module.json
    root = str(tmp_path / "port")
    ModelDownloader(local_cache=root).download_by_name(
        "BiLSTM", seed=3, device="cpu", vocab_size=50, num_tags=5)
    loaded = ModelRepo(root).load_model("BiLSTM").module
    fresh = ModelDownloader().download_by_name(
        "BiLSTM", seed=3, device="cpu", vocab_size=50, num_tags=5).module
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)
    # a JAX-written one (a pickled flax module beside variables.npz) from
    # its variables alone, sizes inferred from the shapes
    jroot = str(tmp_path / "jax")
    jpayload = JaxDownloader(local_cache=jroot).download_by_name(
        "BiLSTM", vocab_size=40, num_tags=3, hidden=16, embed_dim=8)
    port = ModelRepo(jroot).load_model("BiLSTM").module
    assert (port.vocab_size, port.num_tags, port.hidden, port.embed_dim,
            port.num_layers) == (40, 3, 16, 8, 2)
    x = tokens((2, 6), vocab=40)
    want = np.asarray(jpayload.apply(x))
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want,
                                   atol=ATOL)


def test_the_examples_trained_tagger_predicts_as_the_reference():
    """``examples/bilstm_entity_extraction.py``: the tagger trained for 60
    Adam steps in JAX on synthetic DRUG/DOSE patterns, its weights carried
    across; the port's per-token predictions on the example's 64 test
    sequences equal the JAX package's, and its accuracy is the
    example's."""
    import optax
    V, T, L = 200, 3, 24
    rng = np.random.default_rng(0)

    def make_batch(n):
        toks = rng.integers(10, V, (n, L))
        tags = np.zeros((n, L), np.int32)
        for i in range(n):
            j = rng.integers(0, L - 2)
            toks[i, j] = 1
            tags[i, j] = 1
            toks[i, j + 1] = 2
            tags[i, j + 1] = 2
        return toks.astype(np.int32), tags

    module = jax_bilstm.BiLSTMTagger(vocab_size=V, num_tags=T, embed_dim=32,
                                     hidden=64, num_layers=1)
    toks, tags = make_batch(256)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(toks))
    tx = optax.adam(3e-3)
    opt_state = tx.init(variables["params"])

    @jax.jit
    def step(params, opt_state, toks, tags):
        def loss_fn(p):
            logits = module.apply({"params": p}, toks)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, tags).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    params = variables["params"]
    for _ in range(60):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(toks),
                                       jnp.asarray(tags))
    test_toks, test_tags = make_batch(64)
    want = np.asarray(module.apply({"params": params}, test_toks)).argmax(-1)
    port = bilstm.BiLSTMTagger(V, T, embed_dim=32, hidden=64, num_layers=1)
    port.load_state_dict(bilstm_state_dict_from_flax({"params": params},
                                                     port))
    jm = JaxModel(input_col="tokens", output_col="tag_logits", batch_size=32,
                  input_dtype="int32", device="cpu").set_model(module=port)
    out = jm.transform(DataFrame.from_dict({"tokens": _column(test_toks)},
                                           num_partitions=2))
    got = np.stack([np.argmax(v, -1)
                    for v in out.collect()["tag_logits"]])
    np.testing.assert_array_equal(got, want)
    assert float((got == test_tags).mean()) == \
        float((want == test_tags).mean())
