"""Decoder-only transformer (llama-style) — counterpart of
tf_yarn_tpu/models/transformer.py, for serving.

Architecture: RMSNorm pre-norm, interleaved-pair RoPE, GQA, SwiGLU MLP.
Parameter names mirror the flax tree (`models/weights.py` maps one onto
the other); Dense kernels keep the JAX ``[in, out]`` layout so
``y = x @ kernel`` is the JAX ``einsum("...d,df->...f")``.

Two decode paths, both over an int8 KV cache (the JAX package's
``kv_cache_dtype="int8"``; the bf16 cache is still to port):

* `Transformer.prefill` — the dense-cache int8 prefill
  (transformer.py:227-315 with s > 1): K/V are quantized into the
  prompt's cache rows, and attention runs over the DEQUANTIZED rows, so
  the prompt attends through its own quantized copy.
* `Transformer.paged_decode` — the fused paged path
  (`Attention._fused_paged_decode`, transformer.py:323-394): rope at
  per-slot positions, quantize, scatter into the block pool (in place),
  then `paged_int8_window_attention` reads the pool directly.

Weights live in the compute dtype (the JAX package casts its f32 params
to it at every use); RMSNorm scales stay f32, as the kernel reads them.
Layers are a plain list (`scan_layers` has no counterpart) and there is
no remat: serving has no backward. The non-decode training forward,
LoRA adapters, MoE and the bf16 KV cache are still to port (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from tf_yarn_tpu_torch._device import resolve_device
from tf_yarn_tpu_torch.ops.attention import xla_attention
from tf_yarn_tpu_torch.ops.decode_attention import paged_int8_window_attention
from tf_yarn_tpu_torch.ops.quantize import dequantize_int8, quantize_int8
from tf_yarn_tpu_torch.ops.rmsnorm import rmsnorm


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def llama3_8b(cls, **overrides) -> "TransformerConfig":
        return cls(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, d_ff=14336, max_seq_len=8192,
                   rope_theta=500000.0, **overrides)

    @classmethod
    def tiny(cls, **overrides) -> "TransformerConfig":
        defaults = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_ff=128, max_seq_len=128)
        defaults.update(overrides)
        return cls(**defaults)


@dataclasses.dataclass
class PagedKVPool:
    """The int8 KV block pool, all layers stacked: values
    ``[L, NB, bs, Hkv, D]`` int8 and per-row scales ``[L, NB, bs, Hkv, 1]``
    f32. Block 0 is the trash block. The JAX package keeps one pool leaf
    per layer with a vestigial batch-1 axis (``[1, NB, bs, Hkv, *]``);
    here the layer axis leads and there is no batch axis. Updated in
    place by `Transformer.paged_decode` and `DecodeEngine.pack_prefill`."""

    key: torch.Tensor
    value: torch.Tensor
    key_scale: torch.Tensor
    value_scale: torch.Tensor

    @property
    def block_size(self) -> int:
        return self.key.shape[2]

    @property
    def num_blocks(self) -> int:
        return self.key.shape[1]

    def layer(self, i: int) -> Tuple[torch.Tensor, ...]:
        return self.key[i], self.value[i], self.key_scale[i], self.value_scale[i]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.key, self.value, self.key_scale, self.value_scale))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of x [B, S, H, D] at integer
    positions [B, S]. Pairs are INTERLEAVED — (x[..., 0::2], x[..., 1::2])
    — not rotate-half, as in the JAX package."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions[:, :, None, None].float() * freqs  # [B, S, 1, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        self.scale = nn.Parameter(
            torch.ones(config.d_model, dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return rmsnorm(x, self.scale, cfg.norm_eps).to(cfg.dtype)


class Dense(nn.Module):
    """The JAX `LoraDense` with ``lora_rank=0``: y = x @ kernel, kernel
    ``[in, out]`` in the compute dtype."""

    def __init__(self, features_in: int, features_out: int,
                 config: TransformerConfig, device=None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(features_in, features_out, dtype=config.dtype,
                        device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel


class Attention(nn.Module):
    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        kv = cfg.n_kv_heads * cfg.head_dim
        self.wq = Dense(cfg.d_model, cfg.n_heads * cfg.head_dim, cfg, device)
        self.wk = Dense(cfg.d_model, kv, cfg, device)
        self.wv = Dense(cfg.d_model, kv, cfg, device)
        self.wo = Dense(cfg.n_heads * cfg.head_dim, cfg.d_model, cfg, device)

    def _project(self, x):
        cfg = self.config
        b, s, _ = x.shape
        return (self.wq(x).reshape(b, s, cfg.n_heads, cfg.head_dim),
                self.wk(x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim),
                self.wv(x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim))

    def _out(self, out):
        b, s = out.shape[:2]
        return self.wo(out.reshape(b, s, -1))

    def prefill(self, x: torch.Tensor):
        """Dense-cache int8 prefill from an empty cache: returns the
        block output and this layer's cache rows (k_q, k_s, v_q, v_s),
        each [B, S, Hkv, *]."""
        cfg = self.config
        b, s, _ = x.shape
        q, k, v = self._project(x)
        positions = torch.arange(s, device=x.device).expand(b, s)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        k_q, k_s = quantize_int8(k.float())
        v_q, v_s = quantize_int8(v.float())
        # The prompt attends through its own quantized copy, as the JAX
        # package's one-shot dequant of the whole cache does. Cache
        # positions past the prompt carry exactly zero weight there, so
        # attending over the prompt's rows alone gives the same result.
        out = xla_attention(q, dequantize_int8(k_q, k_s, cfg.dtype),
                            dequantize_int8(v_q, v_s, cfg.dtype),
                            causal=True, segment_offset=0)
        return self._out(out), (k_q, k_s, v_q, v_s)

    def paged_decode(self, x, layer_pool, tables, lengths):
        """The fused paged step (the JAX `_fused_paged_decode`): rows of
        x are slots, its sequence axis the window. Rope at positions
        ``lengths[:, None] + arange(W)``, quantize, scatter the rows into
        the pool IN PLACE (rows past a slot's table go to trash block 0),
        then attend straight off the pool."""
        cfg = self.config
        key_pool, value_pool, key_scale, value_scale = layer_pool
        q, k, v = self._project(x)
        slots, width = q.shape[:2]
        positions = lengths[:, None] + torch.arange(
            width, dtype=lengths.dtype, device=x.device)[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        k_q, k_s = quantize_int8(k.float())
        v_q, v_s = quantize_int8(v.float())
        block_size = key_pool.shape[1]
        max_blocks = tables.shape[1]
        logical = (positions // block_size).long()
        blocks = torch.gather(tables, 1, logical.clamp(0, max_blocks - 1))
        blocks = torch.where(logical < max_blocks, blocks,
                             torch.zeros_like(blocks)).reshape(-1).long()
        offsets = (positions % block_size).reshape(-1).long()
        rows = slots * width
        key_pool[blocks, offsets] = k_q.reshape(rows, *k_q.shape[2:])
        value_pool[blocks, offsets] = v_q.reshape(rows, *v_q.shape[2:])
        key_scale[blocks, offsets] = k_s.reshape(rows, *k_s.shape[2:])
        value_scale[blocks, offsets] = v_s.reshape(rows, *v_s.shape[2:])
        out = paged_int8_window_attention(
            q, key_pool, key_scale, value_pool, value_scale, tables, lengths)
        return self._out(out)


class SwiGLU(nn.Module):
    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        cfg = config
        self.w_gate = Dense(cfg.d_model, cfg.d_ff, cfg, device)
        self.w_up = Dense(cfg.d_model, cfg.d_ff, cfg, device)
        self.w_down = Dense(cfg.d_ff, cfg.d_model, cfg, device)

    def forward(self, x):
        return self.w_down(nn.functional.silu(self.w_gate(x)) * self.w_up(x))


class Block(nn.Module):
    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(config, device)
        self.attn = Attention(config, device)
        self.mlp_norm = RMSNorm(config, device)
        self.mlp = SwiGLU(config, device)

    def _mlp(self, x):
        return x + self.mlp(self.mlp_norm(x))

    def prefill(self, x):
        out, cache = self.attn.prefill(self.attn_norm(x))
        return self._mlp(x + out), cache

    def paged_decode(self, x, layer_pool, tables, lengths):
        x = x + self.attn.paged_decode(self.attn_norm(x), layer_pool,
                                       tables, lengths)
        return self._mlp(x)


class Transformer(nn.Module):
    """tokens -> f32 logits, over the two int8 decode paths (module
    docstring). Built on CUDA unless ``device="cpu"`` is passed; the
    weights are uninitialised until `init_weights` or a state dict
    (`models/weights.py`) fills them."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embedding = nn.Parameter(
            torch.empty(config.vocab_size, config.d_model, dtype=config.dtype,
                        device=device), requires_grad=False)
        self.layers = nn.ModuleList(
            [Block(config, device) for _ in range(config.n_layers)])
        self.final_norm = RMSNorm(config, device)
        self.lm_head = nn.Parameter(
            torch.empty(config.d_model, config.vocab_size, dtype=config.dtype,
                        device=device), requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Transformer":
        """Random weights from `generator` (on the model's device):
        embedding and head N(0, 0.02), Dense kernels N(0, 1/fan_in) — the
        JAX package's lecun-normal scale — and unit norm scales."""
        for name, param in self.named_parameters():
            if name.endswith("scale"):
                param.fill_(1.0)
            elif name in ("embedding", "lm_head"):
                param.normal_(0.0, 0.02, generator=generator)
            else:
                param.normal_(0.0, param.shape[0] ** -0.5, generator=generator)
        return self

    def _head(self, x):
        x = self.final_norm(x)
        return (x @ self.lm_head).float()

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """tokens [B, F] -> (last-position logits [B, V] f32, cache):
        cache is a dict of int8 rows ``key``/``value`` [L, B, F, Hkv, D]
        and f32 ``key_scale``/``value_scale`` [L, B, F, Hkv, 1]."""
        x = self.embedding[tokens]
        rows: List[Tuple[torch.Tensor, ...]] = []
        for block in self.layers:
            x, cache = block.prefill(x)
            rows.append(cache)
        names = ("key", "key_scale", "value", "value_scale")
        cache = {name: torch.stack([r[i] for r in rows])
                 for i, name in enumerate(names)}
        return self._head(x[:, -1]), cache

    @torch.no_grad()
    def paged_decode(self, tokens: torch.Tensor, pool: PagedKVPool,
                     tables: torch.Tensor, lengths: torch.Tensor
                     ) -> torch.Tensor:
        """tokens [S, W] (slots x window) -> logits [S, W, V] f32, with
        the window's K/V rows written into `pool` in place. `tables`
        [S, MB] and `lengths` [S] are int32 on the model's device."""
        x = self.embedding[tokens]
        for i, block in enumerate(self.layers):
            x = block.paged_decode(x, pool.layer(i), tables, lengths)
        return self._head(x)


def make_model(config: TransformerConfig, seed: Optional[int] = 0,
               device=None) -> Transformer:
    """A `Transformer` on `device` (CUDA by default) with random weights
    from a `torch.Generator` seeded with `seed`."""
    model = Transformer(config, device=device)
    generator = torch.Generator(device=model.device)
    generator.manual_seed(int(seed))
    return model.init_weights(generator)
