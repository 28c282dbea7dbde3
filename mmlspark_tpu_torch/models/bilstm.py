"""BiLSTM sequence tagger — the medical-entity-extraction model family, as
``torch.nn`` modules.  The port of ``mmlspark_tpu/models/bilstm.py``.

Reference capability: ``notebooks/DeepLearning - BiLSTM Medical Entity
Extraction.ipynb`` evaluates a pretrained CNTK BiLSTM per row
(``BASELINE.json`` config 5, ``examples/bilstm_entity_extraction.py``).

flax's ``OptimizedLSTMCell`` is torch's LSTM cell: gates i, f, g, o in that
order, input kernels without bias, hidden kernels with one, no forget-gate
offset, ``c' = f*c + i*g`` and ``h' = o*tanh(c')`` from a zero carry.  So
``weight_ih = cat(ii, if, ig, io).T``, ``weight_hh = cat(hi, hf, hg,
ho).T``, ``bias_ih = 0`` and ``bias_hh = cat(hi, hf, hg, ho biases)``
(``convert.bilstm_state_dict_from_flax``).  The reference's stack — per
layer a forward and a reversed ``nn.RNN`` over the same input, outputs in
the input's order, layer k+1 reading ``concat(fwd, bwd)`` — is exactly
``nn.LSTM(bidirectional=True, num_layers=L)``, one cuDNN call on the card.
Neither side masks padding.

Float32 on the card is float32: cuDNN's RNNs default to TF32, so each
forward runs with it off (``_device.float32_exact``).  With
``dtype=torch.bfloat16`` the embedding's output and the head compute in
bfloat16 while the recurrence runs in float32, as flax promotes the
bfloat16 inputs to its float32 cell parameters; logits come out float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from .._device import float32_exact


def _reset_lstm(lstm: nn.LSTM, gen: torch.Generator) -> None:
    """flax's cell initializers: truncated-normal ``lecun_normal`` input
    kernels, orthogonal hidden kernels (per gate), zero biases."""
    H = lstm.hidden_size
    for name, p in lstm.named_parameters():
        if name.startswith("weight_ih"):
            fan_in = p.shape[1]
            t = torch.empty(p.shape)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            p.copy_(t * math.sqrt(1.0 / fan_in) / 0.87962566103423978)
        elif name.startswith("weight_hh"):
            for g in range(4):
                t = torch.empty(H, H)
                nn.init.orthogonal_(t, generator=gen)
                p[g * H:(g + 1) * H] = t.T
        else:
            p.zero_()


class LSTMLayer(nn.Module):
    """One directional LSTM over (batch, time, feat); ``reverse`` runs it
    from the last step to the first and returns outputs in the input's
    order (flax's ``nn.RNN(reverse=True, keep_order=True)``).
    ``in_features`` is the input width, which flax infers."""

    def __init__(self, in_features: int, hidden: int, reverse: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden, self.reverse = int(hidden), bool(reverse)
        self.lstm = nn.LSTM(in_features, hidden, batch_first=True)
        with torch.no_grad():
            _reset_lstm(self.lstm, generator if generator is not None
                        else torch.Generator().manual_seed(0))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        with float32_exact(xs.is_cuda):
            if self.reverse:
                return self.lstm(xs.flip(1))[0].flip(1)
            return self.lstm(xs)[0]


class BiLSTMTagger(nn.Module):
    """Embedding -> stacked BiLSTM -> per-token classification head.
    ``forward(tokens)`` takes (batch, time) integer tokens and returns
    (batch, time, num_tags) float32 logits; ``features=True`` the
    (batch, time, 2 * hidden) BiLSTM outputs."""

    def __init__(self, vocab_size: int, num_tags: int, embed_dim: int = 128,
                 hidden: int = 256, num_layers: int = 2,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.vocab_size, self.num_tags = int(vocab_size), int(num_tags)
        self.embed_dim, self.hidden = int(embed_dim), int(hidden)
        self.num_layers = int(num_layers)
        self.dtype = dtype
        self.embed = nn.Embedding(self.vocab_size, self.embed_dim)
        self.lstm = nn.LSTM(self.embed_dim, self.hidden, self.num_layers,
                            batch_first=True, bidirectional=True)
        self.head = nn.Linear(2 * self.hidden, self.num_tags, dtype=dtype)
        self.reset_parameters(generator)
        self.eval()

    def config(self) -> dict:
        """Constructor arguments, as ``dl.jax_model`` saves them."""
        return {"vocab_size": self.vocab_size, "num_tags": self.num_tags,
                "embed_dim": self.embed_dim, "hidden": self.hidden,
                "num_layers": self.num_layers,
                "dtype": str(self.dtype).replace("torch.", "")}

    @classmethod
    def from_config(cls, config: dict) -> "BiLSTMTagger":
        cfg = dict(config)
        cfg["dtype"] = getattr(torch, cfg["dtype"])
        return cls(**cfg)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers from ``generator`` (seed 0 if None): the
        embedding N(0, 1 / embed_dim), the cells as ``_reset_lstm``, a
        ``lecun_normal`` head with a zero bias."""
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.embed.weight.normal_(generator=gen).mul_(
            math.sqrt(1.0 / self.embed_dim))
        _reset_lstm(self.lstm, gen)
        t = torch.empty(self.head.weight.shape)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        self.head.weight.copy_(t * math.sqrt(1.0 / self.head.in_features)
                               / 0.87962566103423978)
        self.head.bias.zero_()

    def forward(self, tokens: torch.Tensor, train: bool = False,
                features: bool = False) -> torch.Tensor:
        dev = self.embed.weight.device
        with float32_exact(dev.type == "cuda"):
            x = self.embed(tokens.to(dev)).to(self.dtype).float()
            x = self.lstm(x)[0]
            if features:
                return x
            return self.head(x.to(self.dtype)).float()
