"""Port parity for the transformer encoder (``mmlspark_tpu_torch/models/
transformer.py``), blockwise attention (``parallel/ring_attention.py``) and
the flax -> ``state_dict`` converter against the JAX package's flax
modules, on the CPU.

Weights: a flax ``init`` from a seeded PRNG key (every parameter is live:
LayerNorm scales 1, biases 0, the rest drawn), carried across by
``convert.transformer_state_dict_from_flax``.  Inputs from numpy seeds.

Tolerances: float32 outputs within atol 1e-5 on logits of magnitude ~1
(measured up to 1.7e-6: the same products summed in another order, and
flax's one-pass LayerNorm variance); blockwise attention within 1e-5
(measured ~3e-7); caches written by both packages within 1e-5 (the k/v
are the same projections); bfloat16 within atol 0.1 of the JAX package's
jitted bfloat16 on logits of magnitude ~2 (both round every layer's
output to bfloat16, at places that differ where XLA fuses).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import transformer as jax_tf
from mmlspark_tpu.parallel import ring_attention as jax_ra
from mmlspark_tpu_torch.convert import transformer_state_dict_from_flax
from mmlspark_tpu_torch.models import transformer
from mmlspark_tpu_torch.parallel import ring_attention as ra

ATOL = 1e-5
SMALL = dict(vocab_size=30, num_classes=5, embed_dim=16, num_heads=2,
             num_layers=2, mlp_dim=32, max_len=64)


def pair(seed=0, L=4, jdtype=jnp.float32, tdtype=torch.float32, **kw):
    """The same encoder in both packages, holding the flax init's
    weights."""
    cfg = {**SMALL, **kw}
    ref = jax_tf.TransformerEncoder(**cfg, dtype=jdtype)
    variables = ref.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, L), jnp.int32))
    port = transformer.TransformerEncoder(**cfg, dtype=tdtype)
    port.load_state_dict(transformer_state_dict_from_flax(variables, port))
    return ref, variables, port


def tokens(shape, seed=1, vocab=SMALL["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("block", [8, 16, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_attention_equals_jax_at_a_ragged_length(causal, block):
    rng = np.random.default_rng(block)
    q, k, v = (rng.normal(size=(2, 3, 37, 8)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_ra.blockwise_attention(q, k, v, block, causal))
    got = ra.blockwise_attention(*map(torch.from_numpy, (q, k, v)), block,
                                 causal).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # and both are plain softmax attention
    s = q @ k.swapaxes(-1, -2) / np.sqrt(8)
    if causal:
        s = np.where(np.tril(np.ones((37, 37), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    np.testing.assert_allclose(got, (p / p.sum(-1, keepdims=True)) @ v,
                               atol=ATOL)


def test_ring_attention_is_not_ported():
    q = torch.zeros(1, 1, 4, 2)
    with pytest.raises(NotImplementedError, match="item 10"):
        ra.ring_attention(q, q, q)
    with pytest.raises(NotImplementedError, match="item 10"):
        ra.make_ring_attention_fn()


@pytest.mark.parametrize("pool", ["mean", "none"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["dense", "blockwise", "ring"])
def test_encoder_equals_flax_in_every_mode(mode, causal, pool):
    ref, variables, port = pair(attention_mode=mode, causal=causal,
                                pool=pool)
    x = tokens((3, 21))
    want = np.asarray(jax.jit(ref.apply)(variables, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_encoder_features_and_long_blockwise_sequences():
    """``features=True`` returns per-token embeddings; blockwise at a
    length spanning several 512-key blocks (the MultiHeadAttention
    default), ragged."""
    ref, variables, port = pair(attention_mode="blockwise", causal=True,
                                max_len=1200, embed_dim=8, num_heads=2,
                                num_layers=1)
    x = tokens((1, 1100), seed=3)
    apply = jax.jit(ref.apply, static_argnames="features")
    want = np.asarray(apply(variables, x, features=True))
    with torch.no_grad():
        got = port(torch.from_numpy(x), features=True).numpy()
    assert got.shape == (1, 1100, 8)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_encoder_bfloat16_follows_flax():
    ref, variables, port = pair(jdtype=jnp.bfloat16, tdtype=torch.bfloat16,
                                pool="none", causal=True)
    x = tokens((2, 12), seed=4)
    want = np.asarray(jax.jit(ref.apply)(variables, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=0.1)


def _jax_cached(ref, variables, toks, positions, cache, table=None):
    kw = {} if table is None else {"page_table": jnp.asarray(table)}
    logits, cache = ref.apply(variables, jnp.asarray(toks),
                              positions=jnp.asarray(positions),
                              kv_cache=cache, **kw)
    return np.asarray(logits), cache


def _port_cached(port, toks, positions, cache, table=None):
    kw = {} if table is None else {"page_table": torch.from_numpy(table)}
    with torch.no_grad():
        logits, cache = port(torch.from_numpy(toks),
                             positions=torch.from_numpy(positions),
                             kv_cache=cache, **kw)
    return logits.numpy(), cache


def _same_cache(port_cache, jax_cache):
    for (pk, pv), (jk, jv) in zip(port_cache, jax_cache):
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("offset", [0, 5])
def test_dense_cached_prefill_and_step_equal_flax(offset):
    """Prefill at per-row positions (ragged frontiers, an offset prefill
    starting past 0), then one single-token step: logits and every cache
    slot equal the reference's."""
    ref, variables, port = pair(causal=True, pool="none")
    B, P, S = 3, 6, 16
    toks = tokens((B, P), seed=5)
    pos = (offset + np.arange(P))[None, :].repeat(B, 0)
    jcache = ref.init_cache(B, S)
    pcache = port.init_cache(B, S)
    want, jcache = _jax_cached(ref, variables, toks, pos, jcache)
    got, pcache = _port_cached(port, toks, pos, pcache)
    np.testing.assert_allclose(got, want, atol=ATOL)
    _same_cache(pcache, jcache)
    step_tok = tokens((B, 1), seed=6)
    step_pos = np.asarray([[offset + P], [offset + 3], [offset + 1]])
    want, jcache = _jax_cached(ref, variables, step_tok, step_pos, jcache)
    got, pcache = _port_cached(port, step_tok, step_pos, pcache)
    np.testing.assert_allclose(got, want, atol=ATOL)
    _same_cache(pcache, jcache)


@pytest.mark.parametrize("offset", [0, 5])
def test_paged_cached_prefill_step_and_trash_routing_equal_flax(offset):
    """The paged update and read: a page table with unallocated (trash)
    entries, an offset prefill, positions whose logical page lies PAST the
    table's width (routed to page 0, never clamped onto column W-1), and
    a step.  Logits and the pool slabs equal the reference's; the live
    pages' slots equal the dense cache's at the same positions."""
    ref, variables, port = pair(causal=True, pool="none")
    B, P, ps, W, pages = 2, 8, 4, 3, 8
    toks = tokens((B, P), seed=7)
    pos = (offset + np.arange(P))[None, :].repeat(B, 0)   # up to 12 >= W*ps
    table = np.asarray([[3, 5, 1], [2, 0, 0]], np.int64)
    jcache = ref.init_paged_cache(pages, ps)
    pcache = port.init_paged_cache(pages, ps)
    want, jcache = _jax_cached(ref, variables, toks, pos, jcache,
                               table.astype(np.int32))
    got, pcache = _port_cached(port, toks, pos, pcache, table)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # page 0 takes several writes per slot, in any order: compare the
    # pages a sequence owns
    live = [1, 2, 3, 5]
    for (pk, pv), (jk, jv) in zip(pcache, jcache):
        np.testing.assert_allclose(pk.numpy()[live], np.asarray(jk)[live],
                                   atol=ATOL)
        np.testing.assert_allclose(pv.numpy()[live], np.asarray(jv)[live],
                                   atol=ATOL)
    # row 0's positions past 3 * 4 = 12 went to the trash page, not page 1
    dense = port.init_cache(B, 16)
    _port_cached(port, toks, pos, dense)
    k_dense = dense[0][0].numpy()
    for j, page in enumerate(table[0]):
        lo, hi = j * ps, (j + 1) * ps
        want_slots = [p for p in range(lo, hi) if offset <= p < offset + P]
        for p in want_slots:
            np.testing.assert_allclose(pcache[0][0].numpy()[page, p - lo],
                                       k_dense[0, p], atol=ATOL)
    step_tok = tokens((B, 1), seed=8)
    step_pos = np.asarray([[11], [3]])
    want, jcache = _jax_cached(ref, variables, step_tok, step_pos, jcache,
                               table.astype(np.int32))
    got, pcache = _port_cached(port, step_tok, step_pos, pcache, table)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_cache_validation_errors():
    ref, _, port = pair(causal=True, pool="none")
    for mod in (ref, port):
        with pytest.raises(ValueError, match="exceeds max_len"):
            mod.init_cache(2, 65)
        with pytest.raises(ValueError, match="trash page"):
            mod.init_paged_cache(1, 4)
        with pytest.raises(ValueError, match="page_size"):
            mod.init_paged_cache(4, 0)
    x = torch.zeros(1, 2, dtype=torch.int32)
    blockwise = transformer.TransformerEncoder(**SMALL,
                                               attention_mode="blockwise")
    with pytest.raises(ValueError, match="attention_mode='dense'"):
        blockwise(x, positions=torch.zeros(1, 2, dtype=torch.int64),
                  kv_cache=blockwise.init_cache(1, 4))
    with pytest.raises(ValueError, match="explicit positions"):
        port.blocks[0].attn(torch.zeros(1, 2, 16),
                            kv_cache=port.init_cache(1, 4)[0])
    # the port raises where the reference's take would fill: no clamping
    with pytest.raises(ValueError, match="max_len"):
        port(x, positions=torch.tensor([[0, 64]]),
             kv_cache=port.init_cache(1, 64))
    with pytest.raises(ValueError, match="max_len"):
        port(torch.zeros(1, 65, dtype=torch.int32))


def test_converter_rejects_foreign_and_misfit_variables():
    _, variables, port = pair()
    flat = {"params/block_0/Foo_0/kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="Foo_0"):
        transformer_state_dict_from_flax(flat)
    small = transformer.TransformerEncoder(**{**SMALL, "num_layers": 1})
    with pytest.raises(ValueError, match="unexpected"):
        transformer_state_dict_from_flax(variables, small)
    # a state_dict round trip keeps the model's config
    clone = transformer.TransformerEncoder.from_config(port.config())
    clone.load_state_dict(port.state_dict())
    x = torch.from_numpy(tokens((2, 5)))
    with torch.no_grad():
        torch.testing.assert_close(clone(x), port(x), rtol=0, atol=0)


def test_jax_model_saves_and_loads_the_encoder(tmp_path):
    """A ``JaxModel`` holding the encoder persists its config and weights
    (``module.json`` + ``variables.npz``) and scores the same after a
    load, as the flax module scores through the reference's."""
    from mmlspark_tpu_torch.core import DataFrame, load, save
    from mmlspark_tpu_torch.dl import JaxModel
    ref, variables, port = pair(attention_mode="blockwise", pool="mean")
    x = tokens((5, 9), seed=9)
    col = np.empty(5, dtype=object)
    for i in range(5):
        col[i] = x[i]
    jm = JaxModel(input_col="t", output_col="y", batch_size=4,
                  input_dtype="int32", device="cpu").set_model(module=port)
    save(jm, str(tmp_path / "m"))
    back = load(str(tmp_path / "m"))
    assert back.get("model").module.attention_mode == "blockwise"
    df = DataFrame.from_dict({"t": col})
    got = np.stack(list(back.transform(df).collect()["y"]))
    np.testing.assert_array_equal(
        got, np.stack(list(jm.transform(df).collect()["y"])))
    np.testing.assert_allclose(got, np.asarray(ref.apply(variables, x)),
                               atol=ATOL)
