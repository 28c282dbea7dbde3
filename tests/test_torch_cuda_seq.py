"""The sequence models on the card against the port on the CPU.  Marked
``cuda``: without a CUDA device every test skips (the CPU tier-1 run holds
the same modules against the JAX package in ``test_torch_transformer.py``,
``test_torch_bilstm.py`` and ``test_torch_decode.py``).  On the card:

    python -m pytest tests/test_torch_cuda_seq.py -q -m cuda --noconftest

Tolerances, as ``chip_smoke.py``'s seq phase states them: float32 on the
card (TF32 off) within 1e-4 of the outputs' largest magnitude; decode
logits within the reference's ``DECODE_ATOL`` of 1e-4; greedy tokens
equal, except from a step where the CPU's two largest logits lie within
1e-4 of each other (a near-tie, where the order of a sum decides).
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.dl import JaxModel
from mmlspark_tpu_torch.models import (BiLSTMTagger, ModelRunner,
                                       SlotsExhausted, TransformerEncoder)

pytestmark = pytest.mark.cuda

REL = 1e-4
DECODE_ATOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel(a, b) -> float:
    a, b = torch.as_tensor(a).float().cpu(), torch.as_tensor(b).float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _column(rows):
    col = np.empty(len(rows), dtype=object)
    for i, r in enumerate(rows):
        col[i] = r
    return col


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["dense", "blockwise", "ring"])
def test_encoder_on_the_card_equals_cpu(dev, mode, causal):
    cpu = TransformerEncoder(100, num_classes=3, embed_dim=64, num_heads=4,
                             num_layers=2, mlp_dim=128, max_len=2048,
                             attention_mode=mode, causal=causal,
                             generator=torch.Generator().manual_seed(1))
    card = TransformerEncoder.from_config(cpu.config())
    card.load_state_dict(cpu.state_dict())
    x = np.random.default_rng(2).integers(0, 100, (4, 1100)).astype(
        np.int32)
    jm = JaxModel(input_col="t", output_col="y", batch_size=4,
                  input_dtype="int32").set_model(module=card.to(dev))
    got = np.stack(list(jm.transform(DataFrame.from_dict(
        {"t": _column(x)})).collect()["y"]))
    with torch.no_grad():
        want = cpu(torch.from_numpy(x))
    assert jm.runner().device.type == "cuda"
    assert rel(got, want) <= REL


def test_tagger_on_the_card_equals_cpu(dev):
    cpu = BiLSTMTagger(200, 3, generator=torch.Generator().manual_seed(3))
    card = BiLSTMTagger.from_config(cpu.config())
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev)
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 200, (16, 48)).astype(np.int32))
    with torch.inference_mode():
        got = card(x.to(dev))
        want = cpu(x)
    assert got.device.type == "cuda" and rel(got, want) <= REL


def _first_divergence(a: np.ndarray, b: np.ndarray):
    bad = np.nonzero(a != b)[0]
    return int(bad[0]) if len(bad) else None


@pytest.mark.parametrize("layout", [{}, {"kv_layout": "paged",
                                         "page_size": 16}])
def test_decode_on_the_card_equals_cpu(dev, layout):
    lm = TransformerEncoder(512, num_classes=512, embed_dim=128,
                            num_heads=4, num_layers=2, mlp_dim=256,
                            max_len=512, causal=True, pool="none",
                            generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    lengths = rng.integers(8, 33, 6).astype(np.int32)
    prompts = rng.integers(0, 512, (6, 32)).astype(np.int32)
    kw = dict(lengths=lengths, max_new_tokens=24, collect_logits=True,
              **layout)
    card = ModelRunner(module=lm, name="cuda.seq").decode(prompts, **kw)
    cpu = ModelRunner(module=lm, name="cpu.seq", device="cpu").decode(
        prompts, **kw)
    fused = ModelRunner(module=lm, name="cuda.fused").decode(
        prompts, lengths=lengths, max_new_tokens=24, **layout)
    np.testing.assert_array_equal(fused.tokens, card.tokens)
    for b in range(6):
        t = _first_divergence(card.tokens[b], cpu.tokens[b])
        stop = card.tokens.shape[1] if t is None else t + 1
        np.testing.assert_allclose(card.logits[b, :stop],
                                   cpu.logits[b, :stop], atol=DECODE_ATOL)
        if t is not None:
            top2 = np.sort(cpu.logits[b, t])[-2:]
            assert top2[1] - top2[0] <= DECODE_ATOL, (b, t, top2)


def test_a_module_on_the_card_is_placed_once_and_pools_share_it(dev):
    """``ModelRunner`` copies a module only when it lies elsewhere: one
    already on the card is used as it is (its device is ``cuda:0``, the
    runner's ``cuda`` resolves to the same), so a ``PagePool`` built from
    it serves the runner's paged decode."""
    from mmlspark_tpu_torch.models import PagePool
    lm = TransformerEncoder(64, num_classes=64, embed_dim=32, num_heads=2,
                            num_layers=1, mlp_dim=64, max_len=64,
                            causal=True, pool="none").to(dev)
    runner = ModelRunner(module=lm, name="cuda.placed")
    assert runner.module is lm and runner.device == lm.pos_embed.device
    pool = PagePool(lm, num_pages=16, page_size=4)
    res = runner.decode(np.zeros((2, 5), np.int32) + 3, max_new_tokens=6,
                        pool=pool)
    assert res.tokens.shape == (2, 6) and pool.pages_in_use() == 0


def test_the_continuous_engine_on_the_card_equals_one_shot(dev):
    """The continuous engine's threads on the card: requests submitted to
    a started engine equal one-shot paged decodes of their prompts on the
    card (the near-tie rule above), a stall abort racing the engine thread
    resolves every request and returns every page, and the rebuilt
    engine's first request equals one-shot again."""
    lm = TransformerEncoder(vocab_size=48, num_classes=48, embed_dim=32,
                            num_heads=2, num_layers=2, mlp_dim=64,
                            max_len=256, causal=True, pool="none",
                            generator=torch.Generator().manual_seed(3))
    runner = ModelRunner(module=lm, name="cuda.cont")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 48, int(n)).astype(np.int32)
               for n in rng.integers(2, 9, 12)]

    def check(p, toks):
        ref = runner.decode(p[None], max_new_tokens=len(toks),
                            kv_layout="paged", page_size=4,
                            collect_logits=True)
        bad = np.nonzero(np.asarray(toks) != ref.tokens[0])[0]
        if len(bad):
            top2 = np.sort(ref.logits[0, bad[0]])[-2:]
            assert top2[1] - top2[0] <= DECODE_ATOL, (p, toks, ref.tokens)

    dec = runner.decode_stream(slots=4, prompt_bucket=8, max_new_tokens=9,
                               page_size=4).start()
    hs = []
    for p in prompts:
        while True:
            try:
                hs.append(dec.submit(p))
                break
            except SlotsExhausted:            # backpressure: next leave
                assert hs[-4].done.wait(10)
    for p, h in zip(prompts, hs):
        assert h.done.wait(30) and h.status == "ok"
        check(p, h.tokens)
    dec.close()
    race = runner.decode_stream(slots=4, prompt_bucket=8,
                                max_new_tokens=200, page_size=4).start()
    live = [race.submit(p) for p in prompts[:4]]
    while race._live < 4:
        live[0].done.wait(0.001)
    race._stall_abort("dispatch", 99.0)
    assert all(h.done.wait(30) for h in live)
    assert race.pool.pages_in_use() == 0 and race.pool._cache is None
    again = runner.decode_stream(slots=4, prompt_bucket=8, max_new_tokens=9,
                                 page_size=4).start()
    h = again.submit(prompts[0])
    assert h.done.wait(30) and h.status == "ok"
    check(prompts[0], h.tokens)
    again.close()
