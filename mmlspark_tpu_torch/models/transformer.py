"""Transformer encoder — the long-context model family and the decode
engine's model, as ``torch.nn`` modules.  The port of
``mmlspark_tpu/models/transformer.py``.

The modules compute what the flax modules compute, on the same weights
(``convert.transformer_state_dict_from_flax`` carries them across):

- attention runs ``dense`` (the plain einsum, a ``-1e30`` causal mask and
  a softmax in the scores' dtype, not ``scaled_dot_product_attention``),
  ``blockwise`` (``parallel.ring_attention.blockwise_attention``, float32
  online softmax over KV blocks of 512) or ``ring``, which outside a
  sequence-parallel group runs blockwise, as the reference falls back
  when the ``seq`` axis is unbound (the port has no such group yet:
  ROADMAP.md §1 item 10);
- the ``qkv`` projection is one ``nn.Linear`` whose output axis is laid
  out ``(3, H, D)``, as flax's ``reshape(B, L, 3, H, D)`` reads it;
- LayerNorm with flax's epsilon 1e-6 (statistics in float32), GELU in
  flax's default tanh form;
- ``pos_embed`` is a ``(1, max_len, E)`` parameter read at ``positions``
  when they are given; a position ``>= max_len`` raises (the reference's
  ``take`` would fill), it is never clamped.

**KV-cached calls** (``positions`` + ``kv_cache``, dense attention only)
keep the reference's cache math exactly.  A dense cache is ``num_layers``
pairs of ``(B, S, H, D)`` slots (``init_cache``); a paged cache is pool
slabs of ``(num_pages, page_size, H, D)`` (``init_paged_cache``) read
through a ``(B, W)`` ``page_table``.  A call scatters its k/v at each
token's absolute position (``_cache_update`` / ``_paged_cache_update``),
then attends over every slot ``s`` with ``s <= positions[b, l]`` — the
paged read gathers each sequence's pages back into position order, so
gathered slot ``s`` is absolute position ``s`` and the admissibility test
is the dense one.  Logical pages past the table's width go to page 0, the
reserved trash page, explicitly; duplicate writes land only there.
Where the reference's jitted steps donate the cache, the port updates the
cache tensors **in place** and returns the same tensors.

Float32 on the card is float32: each forward runs with TF32 off
(``_device.float32_exact``).  ``dtype=torch.bfloat16`` holds the dense
weights in bfloat16 and computes in it, as flax's ``dtype`` does; the
LayerNorm statistics stay float32 and the logits come out float32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import float32_exact
from ..parallel import ring_attention as ra

KVCache = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]

#: the masked score, as the reference writes it (not -inf)
MASK_VALUE = -1e30


def _cache_update(cache_kv, k_new, v_new, positions):
    """Scatter this call's per-token k/v into the dense cache slots, in
    place.

    ``cache_kv`` = (k, v) each (B, S, H, D); ``k_new``/``v_new`` (B, L, H,
    D); ``positions`` (B, L) absolute slot per token — per-sequence, so
    ragged batches write each sequence at its own frontier."""
    ck, cv = cache_kv
    bidx = torch.arange(ck.shape[0], device=ck.device)[:, None]   # (B, 1)
    ck[bidx, positions] = k_new.to(ck.dtype)
    cv[bidx, positions] = v_new.to(cv.dtype)
    return ck, cv


def _paged_cache_update(cache_kv, k_new, v_new, positions, page_table):
    """Scatter this call's per-token k/v into shared POOL pages, in place.

    ``cache_kv`` = (k, v) each (num_pages, page_size, H, D); ``page_table``
    (B, W) int maps a sequence's logical page j (absolute positions
    [j*page_size, (j+1)*page_size)) to its physical pool page.
    Unallocated table entries are 0, the reserved trash page.  Positions
    whose logical page falls PAST the table's width go to the trash page
    explicitly (a raw gather would clamp them to column W-1, whose page
    may be live).  Several writes to one trash slot land in any order:
    the trash page is never admissible."""
    ck, cv = cache_kv
    page_size = ck.shape[1]
    W = page_table.shape[1]
    logical = torch.div(positions, page_size, rounding_mode="floor")
    phys = torch.where(logical < W,
                       page_table.gather(1, logical.clamp(max=W - 1)),
                       torch.zeros_like(logical))
    slot = positions % page_size
    ck[phys, slot] = k_new.to(ck.dtype)
    cv[phys, slot] = v_new.to(cv.dtype)
    return ck, cv


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=...)``: statistics in float32, the output
    in the input's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Self-attention with a fused ``qkv`` projection.  The reference's
    fields and defaults; ``embed_dim`` (the input width, which flax infers
    at its first call) defaults to ``num_heads * head_dim``."""

    def __init__(self, num_heads: int, head_dim: int,
                 attention_mode: str = "dense", causal: bool = False,
                 block_size: int = 512, seq_axis: str = "seq",
                 dtype: torch.dtype = torch.float32,
                 embed_dim: Optional[int] = None):
        super().__init__()
        if attention_mode not in ("dense", "blockwise", "ring"):
            raise ValueError("attention_mode must be dense|blockwise|ring, "
                             f"got {attention_mode!r}")
        self.num_heads, self.head_dim = int(num_heads), int(head_dim)
        self.attention_mode = attention_mode
        self.causal = bool(causal)
        self.block_size = int(block_size)
        self.seq_axis = seq_axis
        self.dtype = dtype
        E = int(embed_dim or num_heads * head_dim)
        HD = self.num_heads * self.head_dim
        self.qkv = nn.Linear(E, 3 * HD, dtype=dtype)
        self.proj = nn.Linear(HD, E, dtype=dtype)

    def forward(self, x: torch.Tensor, positions=None, kv_cache=None,
                page_table=None):
        B, L, _ = x.shape
        H, D = self.num_heads, self.head_dim
        qkv = self.qkv(x)
        if kv_cache is not None:
            # KV-cached path (prefill when L = prompt bucket, decode when
            # L = 1).  Dense only: blockwise/ring tile over the query axis
            # and cannot address per-sequence cache slots.
            if self.attention_mode != "dense":
                raise ValueError(
                    "kv_cache requires attention_mode='dense' (got "
                    f"{self.attention_mode!r}); blockwise/ring serve the "
                    "full-sequence paths only")
            if positions is None:
                raise ValueError("kv_cache requires explicit positions")
            q, k, v = qkv.view(B, L, 3, H, D).unbind(2)     # (B, L, H, D)
            if page_table is not None:
                ck, cv = _paged_cache_update(kv_cache, k, v, positions,
                                             page_table)
                W, page_size = page_table.shape[1], ck.shape[1]
                keys = ck[page_table].reshape(B, W * page_size, H, D)
                vals = cv[page_table].reshape(B, W * page_size, H, D)
            else:
                ck, cv = _cache_update(kv_cache, k, v, positions)
                keys, vals = ck, cv
            s = torch.einsum("blhd,bshd->bhls", q, keys) / math.sqrt(D)
            # slot s serves query l iff s <= positions[b, l]: every step
            # writes its token at the frontier before attending, so the
            # admissible slots are always freshly written
            key_pos = torch.arange(keys.shape[1], device=x.device)
            admissible = key_pos[None, None, None, :] <= \
                positions[:, None, :, None]
            s = torch.where(admissible, s, MASK_VALUE)
            out = torch.einsum("bhls,bshd->blhd", torch.softmax(s, dim=-1),
                               vals.to(s.dtype))
            return self.proj(out.reshape(B, L, H * D)), (ck, cv)
        q, k, v = qkv.view(B, L, 3, H, D).permute(2, 0, 3, 1, 4)  # (B,H,L,D)
        if self.attention_mode in ("ring", "blockwise"):
            # ring: no sequence-parallel group in the port, so blockwise,
            # the reference's fallback outside shard_map
            out = ra.blockwise_attention(q, k, v, self.block_size,
                                         self.causal)
        else:
            s = (q @ k.transpose(-1, -2)) / math.sqrt(D)
            if self.causal:
                mask = torch.ones(L, L, dtype=torch.bool,
                                  device=x.device).tril()
                s = torch.where(mask, s, MASK_VALUE)
            out = torch.softmax(s, dim=-1) @ v
        out = out.transpose(1, 2).reshape(B, L, H * D)
        return self.proj(out)


class EncoderBlock(nn.Module):
    """Pre-norm block: x + attn(ln(x)), then x + mlp(ln(x))."""

    def __init__(self, num_heads: int, head_dim: int, mlp_dim: int,
                 attention_mode: str = "dense", causal: bool = False,
                 dtype: torch.dtype = torch.float32,
                 embed_dim: Optional[int] = None):
        super().__init__()
        E = int(embed_dim or num_heads * head_dim)
        self.mlp_dim = int(mlp_dim)
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(E, eps=1e-6)
        self.attn = MultiHeadAttention(num_heads, head_dim, attention_mode,
                                       causal, dtype=dtype, embed_dim=E)
        self.ln2 = nn.LayerNorm(E, eps=1e-6)
        self.dense1 = nn.Linear(E, mlp_dim, dtype=dtype)
        self.dense2 = nn.Linear(mlp_dim, E, dtype=dtype)

    def forward(self, x, positions=None, kv_cache=None, page_table=None):
        h = _layer_norm(self.ln1, x)
        if kv_cache is not None:
            h, kv_cache = self.attn(h, positions=positions,
                                    kv_cache=kv_cache, page_table=page_table)
        else:
            h = self.attn(h)
        x = x + h
        h = self.dense2(F.gelu(self.dense1(_layer_norm(self.ln2, x)),
                               approximate="tanh"))
        x = x + h
        return (x, kv_cache) if kv_cache is not None else x


class TransformerEncoder(nn.Module):
    """Token transformer; ``features=True`` returns per-token embeddings.
    As a causal LM (``causal=True, pool="none", num_classes=vocab``) it is
    ``models.runner.ModelRunner.decode``'s model.  Weights are drawn from
    ``generator`` (seed 0 if None) with flax's initializers."""

    def __init__(self, vocab_size: int, num_classes: int = 2,
                 embed_dim: int = 256, num_heads: int = 4,
                 num_layers: int = 4, mlp_dim: int = 512,
                 max_len: int = 32768, attention_mode: str = "dense",
                 causal: bool = False, pool: str = "mean",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        if pool not in ("mean", "none"):
            raise ValueError(f"pool must be mean|none, got {pool!r}")
        self.vocab_size, self.num_classes = int(vocab_size), int(num_classes)
        self.embed_dim, self.num_heads = int(embed_dim), int(num_heads)
        self.num_layers, self.mlp_dim = int(num_layers), int(mlp_dim)
        self.max_len = int(max_len)
        self.attention_mode, self.causal, self.pool = \
            attention_mode, bool(causal), pool
        self.dtype = dtype
        head_dim = self.embed_dim // self.num_heads
        self.embed = nn.Embedding(self.vocab_size, self.embed_dim)
        self.pos_embed = nn.Parameter(torch.empty(1, self.max_len,
                                                  self.embed_dim))
        self.blocks = nn.ModuleList([
            EncoderBlock(self.num_heads, head_dim, self.mlp_dim,
                         attention_mode, self.causal, dtype=dtype,
                         embed_dim=self.embed_dim)
            for _ in range(self.num_layers)])
        self.ln_f = nn.LayerNorm(self.embed_dim, eps=1e-6)
        self.head = nn.Linear(self.embed_dim, self.num_classes, dtype=dtype)
        self.reset_parameters(generator)
        self.eval()

    def config(self) -> dict:
        """Constructor arguments, as ``dl.jax_model`` saves them."""
        return {"vocab_size": self.vocab_size,
                "num_classes": self.num_classes,
                "embed_dim": self.embed_dim, "num_heads": self.num_heads,
                "num_layers": self.num_layers, "mlp_dim": self.mlp_dim,
                "max_len": self.max_len,
                "attention_mode": self.attention_mode,
                "causal": self.causal, "pool": self.pool,
                "dtype": str(self.dtype).replace("torch.", "")}

    @classmethod
    def from_config(cls, config: dict) -> "TransformerEncoder":
        cfg = dict(config)
        cfg["dtype"] = getattr(torch, cfg["dtype"])
        return cls(**cfg)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers, drawn from ``generator`` (seed 0 if None):
        truncated-normal ``lecun_normal`` dense kernels, zero biases, the
        embedding N(0, 1 / embed_dim), ``pos_embed`` N(0, 0.02^2), unit
        LayerNorm scales."""
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)

        def normal(p, std, truncated):
            t = torch.empty(p.shape, dtype=torch.float32)
            if truncated:
                nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
                std /= 0.87962566103423978
            else:
                t.normal_(generator=gen)
            p.copy_(t * std)

        normal(self.embed.weight, math.sqrt(1.0 / self.embed_dim), False)
        normal(self.pos_embed, 0.02, False)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                normal(m.weight, math.sqrt(1.0 / m.in_features), True)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def _check_positions(self, positions: torch.Tensor) -> None:
        # an out-of-range index on the card is a device-side assert that
        # ends the CUDA context, so the bound is checked on the host
        hi = int(positions.max()) if positions.numel() else 0
        if hi >= self.max_len or (positions.numel()
                                  and int(positions.min()) < 0):
            raise ValueError(f"positions must lie in [0, max_len = "
                             f"{self.max_len}), got max {hi}")

    def forward(self, tokens: torch.Tensor, train: bool = False,
                features: bool = False, positions=None, kv_cache=None,
                page_table=None):
        dev = self.pos_embed.device
        with float32_exact(self.dtype == torch.float32
                           and dev.type == "cuda"):
            B, L = tokens.shape
            x = self.embed(tokens.to(dev)).to(self.dtype)
            if positions is not None:
                # explicit global positions (KV-cached decode: each
                # sequence's token sits at its own frontier); checked
                # while they are still on the host when they come from it
                self._check_positions(positions)
                positions = positions.to(dev)
                x = x + self.pos_embed[0][positions].to(self.dtype)
            else:
                if L > self.max_len:
                    raise ValueError(f"sequence length {L} exceeds max_len "
                                     f"{self.max_len}")
                x = x + self.pos_embed[:, :L].to(self.dtype)
            if page_table is not None:
                page_table = page_table.to(dev)
            new_cache = []
            for i, block in enumerate(self.blocks):
                if kv_cache is not None:
                    x, layer_kv = block(x, positions=positions,
                                        kv_cache=kv_cache[i],
                                        page_table=page_table)
                    new_cache.append(layer_kv)
                else:
                    x = block(x)
            x = _layer_norm(self.ln_f, x)
            if features:
                x = x.float()
                return (x, tuple(new_cache)) if kv_cache is not None else x
            if self.pool == "mean" and kv_cache is None:
                x = x.mean(dim=1)
            logits = self.head(x).float()   # (B, C) / (B, L, C) pool="none"
            return (logits, tuple(new_cache)) if kv_cache is not None \
                else logits

    def _cache_shape(self, n: int, slots: int):
        return (n, slots, self.num_heads, self.embed_dim // self.num_heads)

    def init_cache(self, batch: int, cache_len: int,
                   device=None) -> KVCache:
        """Zeroed KV cache: ``num_layers`` pairs of ``(batch, cache_len,
        heads, head_dim)`` slots on ``device`` (the module's by default).
        ``cache_len`` bounds prompt + generated tokens."""
        if cache_len > self.max_len:
            raise ValueError(f"cache_len {cache_len} exceeds max_len "
                             f"{self.max_len} (positional table bound)")
        return self._zeros(self._cache_shape(batch, cache_len), device)

    def init_paged_cache(self, num_pages: int, page_size: int,
                         device=None) -> KVCache:
        """Zeroed PAGED KV cache: ``num_layers`` pairs of ``(num_pages,
        page_size, heads, head_dim)`` pool slabs shared by every sequence
        through a per-sequence page table (``models.runner.PagePool``).
        Page 0 is the reserved trash page, so a usable pool needs
        ``num_pages >= 2``."""
        if num_pages < 2:
            raise ValueError(f"num_pages {num_pages} < 2: page 0 is the "
                             "reserved trash page, so a usable pool needs "
                             "at least one allocatable page")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        return self._zeros(self._cache_shape(num_pages, page_size), device)

    def _zeros(self, shape: Sequence[int], device) -> KVCache:
        dev = device if device is not None else self.pos_embed.device
        return tuple((torch.zeros(shape, dtype=self.dtype, device=dev),
                      torch.zeros(shape, dtype=self.dtype, device=dev))
                     for _ in range(self.num_layers))
