"""Decoder-only transformer (llama-style) — counterpart of
tf_yarn_tpu/models/transformer.py, for training and serving.

Architecture: RMSNorm pre-norm, interleaved-pair RoPE, GQA, SwiGLU MLP,
LoRA adapters on every dense projection (`LoraDense`). Parameter names
mirror the flax tree (`models/weights.py` maps one onto the other);
Dense kernels keep the JAX ``[in, out]`` layout so ``y = x @ kernel`` is
the JAX ``einsum("...d,df->...f")``.

Paths:

* `Transformer.forward(tokens, return_hidden=False, head=None)` — the
  training forward (transformer.py:490-533): attention through
  `ops.attention` (``attention_impl`` "xla" or "flash", the hand-written
  kernels, or under ``sp`` "ring", "ulysses" and "ulysses_flash"), every
  norm through `ops.rmsnorm` (the kernel for CUDA tensors, its plain f32
  version for CPU ones), and, with ``remat``, each block recomputed in
  the backward by ``torch.utils.checkpoint`` — the port recomputes the
  whole block where the JAX package keeps the dots
  (``checkpoint_dots_with_no_batch_dims``); the numbers are identical.
  Under sequence parallelism (``sp`` set by the train loop) the rank
  computes its contiguous block of the sequence through the whole model
  — embedding, norms, MLP and LoRA are per position, RoPE takes the
  block's global positions, and only attention crosses ranks
  (`ops.attention.sequence_sharded_attention`); the loss
  (`models.common`) takes its targets from the whole row. Under the
  pipeline (``pp`` set by `parallel.pipeline.parallelize`) the rank holds
  one contiguous stage of the layers and runs them in the GPipe schedule
  with ``gpipe_microbatches`` microbatches (1 when it is 0: JAX's
  layer-sharded scan), remat per layer (transformer.py:535-610); the
  embedding, the final norm and the head stay on every stage.
* `Transformer.prefill` — the dense-cache prefill (transformer.py:
  217-315 from an empty cache): with ``kv_cache_dtype="int8"`` K/V are
  quantized into the prompt's cache rows and attention runs over the
  DEQUANTIZED rows, so the prompt attends through its own quantized
  copy; with ``"bf16"`` (the default) the rows are stored in the
  compute dtype and never quantized.
* `Transformer.decode` — the dense-cache decode branch (transformer.py:
  217-315) over a `DenseKVCache` whose rows sit at independent
  positions (a per-row ``index``): append the window's K/V at each
  row's index, then attend. A single token over an int8 cache goes to
  `int8_decode_attention` (the hand-written kernel); a window, or a
  cache in the compute dtype, to `xla_attention` over the live prefix
  with a per-row causal offset. `DecodeEngine`'s gather mode runs the
  same branch over a view gathered from the block pool.
* `Transformer.paged_decode` — the fused paged path
  (`Attention._fused_paged_decode`, transformer.py:323-394): rope at
  per-slot positions, quantize, scatter into the block pool (in place),
  then `paged_int8_window_attention` reads the pool directly. It needs
  ``kv_cache_dtype="int8"``.

Under tensor parallelism (``tp`` set by `tp_lib.shard`) the serving
paths run on the rank's heads, as the training forward does: the
prefill, decode and gather paths attend with the rank's query and kv
heads, the caches (`make_cache`, the engine's pool) hold `kv_heads`,
``wo`` and the MLP's down projection are summed over tp, and the logits
leave the head gathered whole.

Parameter dtypes. The JAX package keeps f32 params and casts them to the
compute dtype at every use. Here a parameter the optimizer trains (built
with ``trainable=True``: every parameter without LoRA, only the
``lora_*`` adapters with it) is an f32 master (``param_dtype``) cast at
every use, as in JAX. A parameter nothing trains — the frozen base of a
LoRA fine-tune, or every weight of a served model — is stored once in
the compute dtype: casting once gives the same bits as casting at every
use, and at Llama-3-8B widths the base takes 16.1 GB instead of 32.1 GB.
RMSNorm scales stay f32 either way (the kernel reads f32). Layers are a
plain list, annotated as the ``"layers"`` stack that `parallel.sharding`
places over ``pp``. ``scan_layers`` keeps its JAX meaning where a
computation reads whole flax leaves: the GPipe check, and adafactor's
block RMS (`models.adafactor`), which takes a stacked leaf (every
layer's tensor of one name) under ``scan_layers=True`` and each layer's
tensor alone under ``False``.

With ``moe_experts > 0`` each block's MLP is the Switch `models.moe.
MoEMlp` (transformer.py:420-425), its parameters ``moe.router``,
``moe.w_gate``, ``moe.w_up`` and ``moe.w_down``; the losses of
`models.common` fold its aux loss in. MoE trains; serving an MoE decoder
(`prefill`, `decode`, `paged_decode`, and so `DecodeEngine` and
`generate`) raises NotImplementedError (ROADMAP.md Queue 1 item 8e).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tf_yarn_tpu_torch._device import resolve_device
from tf_yarn_tpu_torch.models.moe import MoEMlp
from tf_yarn_tpu_torch.ops.attention import (
    IMPLS,
    attention,
    sequence_sharded_attention,
    xla_attention,
)
from tf_yarn_tpu_torch.ops.decode_attention import (
    int8_decode_attention,
    paged_int8_window_attention,
)
from tf_yarn_tpu_torch.ops.quantize import dequantize_int8, quantize_int8
from tf_yarn_tpu_torch.ops.rmsnorm import rmsnorm
from tf_yarn_tpu_torch.parallel import pipeline, sharding
from tf_yarn_tpu_torch.parallel import tensor_parallel as tp_lib
from tf_yarn_tpu_torch.parallel.sharding import EMBED, HEADS, KV, MLP, VOCAB


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
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "xla"  # xla | flash | ring | ulysses | ulysses_flash
    scan_layers: bool = True  # the JAX leaf layout: GPipe, adafactor
    remat: bool = True
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # The Switch MoE (transformer.py:51-56, models/moe.py): experts per
    # block (0: the dense SwiGLU), each expert's slots per token routed to
    # it on average, and the aux loss's weight in the LM losses.
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # The GPipe schedule over the pp mesh dim (transformer.py:67-72): > 0
    # sets the microbatch count; needs scan_layers=True and xla attention.
    gpipe_microbatches: int = 0
    # Accepted so JAX configs carry over, and ignored: every norm runs
    # through ops.rmsnorm, whose numbers are the plain f32 norm's.
    fused_norms: bool = True
    # KV-cache storage for decode: "bf16" keeps K/V in the compute dtype
    # (`dtype`, so f32 in an f32 model) and never quantizes; "int8"
    # stores per-row symmetric int8 with f32 scales (ops/quantize.py).
    kv_cache_dtype: str = "bf16"

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
    """The KV block pool, all layers stacked: values ``[L, NB, bs, Hkv,
    D]`` — int8 with per-row scales ``[L, NB, bs, Hkv, 1]`` f32, or in the
    compute dtype with no scales (``kv_cache_dtype="bf16"``, the gather
    mode only). Block 0 is the trash block. The JAX package keeps one
    pool leaf per layer with a vestigial batch-1 axis (``[1, NB, bs, Hkv,
    *]``); here the layer axis leads and there is no batch axis. Updated
    in place by `Transformer.paged_decode`, `Transformer.decode` over a
    gathered view, and `DecodeEngine.pack_prefill`."""

    key: torch.Tensor
    value: torch.Tensor
    key_scale: Optional[torch.Tensor]
    value_scale: Optional[torch.Tensor]

    @property
    def block_size(self) -> int:
        return self.key.shape[2]

    @property
    def num_blocks(self) -> int:
        return self.key.shape[1]

    def layer(self, i: int) -> Tuple[torch.Tensor, ...]:
        return self.key[i], self.value[i], self.key_scale[i], self.value_scale[i]

    def nbytes(self, tp: int = 1) -> int:
        """Resident bytes; with `tp`, those of the whole pool whose heads
        this one holds 1/tp of (a tp rank's pool)."""
        return tp * sum(t.numel() * t.element_size()
                        for t in (self.key, self.value, self.key_scale,
                                  self.value_scale) if t is not None)


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


def int8_kv_cache(config: TransformerConfig) -> bool:
    """Whether the decode cache is int8; raises on an unknown
    ``kv_cache_dtype`` (transformer.py:227-231)."""
    if config.kv_cache_dtype not in ("bf16", "int8"):
        raise ValueError(
            f"kv_cache_dtype={config.kv_cache_dtype!r}: expected 'bf16' or "
            "'int8'"
        )
    return config.kv_cache_dtype == "int8"


def require_int8_pool(config: TransformerConfig) -> None:
    """The fused paged path reads an int8 pool (transformer.py:334-339)."""
    if not int8_kv_cache(config):
        raise ValueError(
            "the fused paged decode path reads an int8 pool "
            "(paged_int8_window_attention); it requires kv_cache_dtype='int8'"
        )


KV_NAMES = ("key", "value", "key_scale", "value_scale")


def zeroed_kv(config: TransformerConfig, lead: Tuple[int, ...],
              device, kv_heads: Optional[int] = None
              ) -> Dict[str, Optional[torch.Tensor]]:
    """Zeroed KV leaves ``lead + (Hkv, D)`` in the cache's storage: int8
    values with f32 per-row scales ``lead + (Hkv, 1)``, or values in the
    compute dtype and no scales. ``Hkv`` is `kv_heads` (a tp rank's), by
    default the config's ``n_kv_heads``."""
    int8 = int8_kv_cache(config)
    rows = tuple(lead) + (config.n_kv_heads if kv_heads is None
                          else kv_heads,)
    values = torch.int8 if int8 else config.dtype
    zeros = lambda tail, dtype: torch.zeros(rows + (tail,), dtype=dtype,
                                            device=device)
    return dict(key=zeros(config.head_dim, values),
                value=zeros(config.head_dim, values),
                key_scale=zeros(1, torch.float32) if int8 else None,
                value_scale=zeros(1, torch.float32) if int8 else None)


@dataclasses.dataclass
class DenseKVCache:
    """The dense decode cache, all layers stacked: K/V ``[L, B, S, Hkv,
    D]`` in int8 with per-row f32 scales ``[L, B, S, Hkv, 1]``, or in the
    compute dtype with no scales (``kv_cache_dtype="bf16"``), and
    ``index [B]`` int32 — each row's next position (the JAX cache's
    ``cache_index``, one per row: the dense slot grid's rows sit at
    independent positions). `Transformer.decode` appends in place and
    advances ``index``."""

    key: torch.Tensor
    value: torch.Tensor
    key_scale: Optional[torch.Tensor]
    value_scale: Optional[torch.Tensor]
    index: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.key.shape[2]

    def nbytes(self, tp: int = 1) -> int:
        """Resident bytes, as the JAX cache counts them: it keeps one
        ``[B]`` index per layer where this cache shares one. With `tp`,
        those of the whole cache whose heads this one holds 1/tp of (a
        tp rank's grid): the head leaves tp times, the index once."""
        n_layers = self.key.shape[0]
        return tp * sum(t.numel() * t.element_size()
                        for t in (self.key, self.value, self.key_scale,
                                  self.value_scale) if t is not None) + \
            n_layers * self.index.numel() * self.index.element_size()

    def insert(self, rows: Mapping[str, torch.Tensor],
               slot: Optional[int] = None) -> None:
        """Splice prefill rows (`Transformer.prefill`'s dict, ``[L, b, F,
        Hkv, *]``) into batch row `slot` (b = 1), or into every row:
        positions [0, F) take the rows, the rest of those rows is zeroed
        and their index set to F — a fresh prefill cache, index
        included."""
        at = slice(None) if slot is None else slice(slot, slot + 1)
        for name in KV_NAMES:
            leaf = getattr(self, name)
            if leaf is None:
                continue
            src = rows[name]
            leaf[:, at] = 0
            leaf[:, at, :src.shape[2]] = src
        self.index[at] = rows["key"].shape[2]

    def evict(self, slot: int) -> None:
        """Zero batch row `slot`: K/V, scales and index."""
        for name in KV_NAMES:
            leaf = getattr(self, name)
            if leaf is not None:
                leaf[:, slot] = 0
        self.index[slot] = 0

    def advance(self, lengths: Sequence[int]) -> None:
        """Move each row's index on by its entry of `lengths`."""
        self.index = self.index + torch.as_tensor(
            lengths, dtype=self.index.dtype, device=self.index.device)

    def live_span(self, width: int) -> int:
        """Positions a `width`-token window attends over: up to the
        longest row's end (one device read)."""
        return min(int(self.index.max()) + width, self.capacity)

    def append(self, layer: int, rows: Sequence[Optional[torch.Tensor]],
               positions: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
        """Write a window's rows ``(k, v, k_scale, v_scale)``, each ``[B,
        W, Hkv, *]``, at ``positions [B, W]`` of layer `layer`; returns
        the layer's (key, value, key_scale, value_scale) to attend over.
        Positions past the capacity (rows no valid length can reach)
        land on the last row."""
        batch = torch.arange(positions.shape[0],
                             device=positions.device)[:, None]
        positions = positions.clamp(max=self.capacity - 1).long()
        out = []
        for name, row in zip(KV_NAMES, rows):
            leaf = getattr(self, name)
            if leaf is None:
                out.append(None)
                continue
            leaf = leaf[layer]
            leaf[batch, positions] = row.to(leaf.dtype)
            out.append(leaf)
        return tuple(out)


def pool_rows(tables: torch.Tensor, positions: torch.Tensor,
              block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where positions ``[S, W]`` of each slot live in the block pool:
    (block, offset) per row, flattened to ``[S * W]``. A position past
    the slot's table (a rejected-draft row past its reservation) routes
    to the trash block 0."""
    max_blocks = tables.shape[1]
    logical = (positions // block_size).long()
    blocks = torch.gather(tables, 1, logical.clamp(0, max_blocks - 1))
    blocks = torch.where(logical < max_blocks, blocks, torch.zeros_like(blocks))
    offsets = positions % block_size
    return blocks.reshape(-1).long(), offsets.reshape(-1).long()


def _param(shape, trainable: bool, config: TransformerConfig, device,
           dtype: Optional[torch.dtype] = None) -> nn.Parameter:
    """An uninitialised parameter: an f32 master (``param_dtype``) when
    the optimizer trains it, else stored in the compute dtype (module
    docstring)."""
    if dtype is None:
        dtype = config.param_dtype if trainable else config.dtype
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device),
                        requires_grad=trainable)


def vocab_index(ids: torch.Tensor, size: int) -> torch.Tensor:
    """Ids made rows of a `size`-row table as the JAX package's gather
    reads them: a negative id counts once from the end (``id + size``),
    then the result is clamped to ``[0, size - 1]``. So an id outside the
    vocabulary reads the first or last row, where a bare index would
    raise on the CPU and assert on the card. Tensor arithmetic on the
    ids' device, with no host sync."""
    return torch.where(ids < 0, ids + size, ids).clamp(0, size - 1)


def is_lora_param(name: str) -> bool:
    """The JAX `lora_label_tree` predicate: a parameter is an adapter
    iff some component of its name starts with ``lora_``."""
    return any(part.startswith("lora_") for part in name.split("."))


class RMSNorm(nn.Module):
    def __init__(self, config: TransformerConfig, device=None,
                 trainable: bool = False):
        super().__init__()
        self.config = config
        self.scale = _param((config.d_model,), trainable, config, device,
                            dtype=torch.float32)
        sharding.annotate(self, scale=(None,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return rmsnorm(x, self.scale, cfg.norm_eps).to(cfg.dtype)


class LoraDense(nn.Module):
    """Dense with an optional LoRA adapter (transformer.py:145-190):
    ``y = x @ kernel + (alpha / rank) · (x @ lora_a) @ lora_b [+ bias]``,
    every factor cast to the compute dtype; kernel ``[in, out]``, lora_a
    ``[in, rank]`` (N(0, 0.02) at init), lora_b ``[rank, out]`` (zeros),
    with ``use_bias`` a ``[out]`` bias (zeros) added in the compute dtype.
    `config` is any config with ``dtype``, ``param_dtype``, ``lora_rank``
    and ``lora_alpha`` (the encoder families' too).

    ``axes`` are the kernel's logical axes (`sharding.annotate`). Under
    tensor parallelism (``tp`` set by `tp_lib.shard`) they give the
    layer its share (`parallel.tensor_parallel`): an ``(embed, heads)``
    or ``(embed, mlp)`` kernel is column-parallel, the output features
    of a replicated input from a kernel already cut to them; an
    ``(embed, kv)`` kernel is read in part, at the kv heads of the
    rank's query heads; a ``(heads, embed)`` or ``(mlp, embed)`` kernel
    is row-parallel, the partial product of the rank's input features,
    summed over tp; any other kernel computes whole. The LoRA factors
    and the bias stay replicated: a factor or bias a rank reads in part
    is sliced at its use, whose backward sums its gradient over tp;
    ``lora_a`` of a column layer, read whole, gets its partial gradient
    summed too, and a row layer sums ``x @ lora_a`` before ``lora_b``,
    which then sees whole activations, as does the row layer's bias,
    added after the sum."""

    def __init__(self, features_in: int, features_out: int,
                 config: TransformerConfig, device=None,
                 trainable: bool = False, use_bias: bool = False,
                 axes: Optional[Tuple[Optional[str], ...]] = None):
        super().__init__()
        self.config = config
        self.features = (features_in, features_out)
        lora = config.lora_rank > 0
        self.kernel = _param((features_in, features_out),
                             trainable and not lora, config, device)
        if lora:
            self.lora_a = _param((features_in, config.lora_rank), trainable,
                                 config, device)
            self.lora_b = _param((config.lora_rank, features_out), trainable,
                                 config, device)
        self.bias = (_param((features_out,), trainable and not lora, config,
                            device) if use_bias else None)
        if axes is not None:
            sharding.annotate(self, kernel=axes)
        self.tp = None

    def _tp_role(self) -> Optional[Tuple[str, int, int, bool]]:
        """(role, start, length, slice_kernel) of the rank's share, from
        the kernel's logical axes (class docstring); None: whole."""
        axes = getattr(self, "logical_axes", {}).get("kernel")
        if self.tp is None or axes is None:
            return None
        dim = sharding.tp_dim(sharding.logical_to_spec(axes))
        if dim is not None:
            start, length = self.tp.span(self.features[dim], "features")
            return ("column" if dim == 1 else "row"), start, length, False
        if sharding.KV in axes:
            cfg = self.config
            first, count = tp_lib.kv_span(
                cfg.n_heads, getattr(cfg, "n_kv_heads", cfg.n_heads), self.tp)
            return "column", first * cfg.head_dim, count * cfg.head_dim, True
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        role = self._tp_role()
        if role is not None:
            return self._sharded(x, *role)
        y = x @ self.kernel.to(cfg.dtype)
        if cfg.lora_rank > 0:
            scale = cfg.lora_alpha / cfg.lora_rank
            y = y + scale * ((x @ self.lora_a.to(cfg.dtype))
                             @ self.lora_b.to(cfg.dtype))
        if self.bias is not None:
            y = y + self.bias.to(cfg.dtype)
        return y

    def _sharded(self, x: torch.Tensor, role: str, start: int, length: int,
                 slice_kernel: bool) -> torch.Tensor:
        """The tp forward; `x` is the replicated input (through
        `tp_lib.copy_in`) of a column layer, the rank's input features of
        a row layer."""
        cfg, tp = self.config, self.tp
        cut = lambda param, dim: tp_lib.slice_replicated(param, dim, start,
                                                         length, tp)
        scale = cfg.lora_alpha / cfg.lora_rank if cfg.lora_rank > 0 else 0.0
        if role == "column":
            kernel = cut(self.kernel, 1) if slice_kernel else self.kernel
            y = x @ kernel.to(cfg.dtype)
            if cfg.lora_rank > 0:
                lora_a = tp_lib.copy_in(self.lora_a, tp, "grad_lora_a")
                y = y + scale * ((x @ lora_a.to(cfg.dtype))
                                 @ cut(self.lora_b, 1).to(cfg.dtype))
            if self.bias is not None:
                y = y + cut(self.bias, 0).to(cfg.dtype)
            return y
        y = tp_lib.reduce_out(x @ self.kernel.to(cfg.dtype), tp)
        if cfg.lora_rank > 0:
            low = tp_lib.reduce_out(x @ cut(self.lora_a, 0).to(cfg.dtype), tp,
                                    "reduce_lora")
            y = y + scale * (low @ self.lora_b.to(cfg.dtype))
        if self.bias is not None:
            y = y + self.bias.to(cfg.dtype)
        return y


class Attention(nn.Module):
    def __init__(self, config: TransformerConfig, device=None,
                 trainable: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        kv = cfg.n_kv_heads * cfg.head_dim
        dense = lambda i, o, axes: LoraDense(i, o, cfg, device, trainable,
                                             axes=axes)
        self.wq = dense(cfg.d_model, cfg.n_heads * cfg.head_dim,
                        (EMBED, HEADS))
        self.wk = dense(cfg.d_model, kv, (EMBED, KV))
        self.wv = dense(cfg.d_model, kv, (EMBED, KV))
        self.wo = dense(cfg.n_heads * cfg.head_dim, cfg.d_model,
                        (HEADS, EMBED))
        # Set under tp: the rank attends on its own heads (the widths of
        # its wq and wk say how many), its input entering through
        # `tp_lib.copy_in`. Set under sp: its positions are a block of
        # the sequence, and attention crosses the sp group.
        self.tp = None
        self.sp = None

    def _project(self, x):
        cfg = self.config
        b, s, _ = x.shape
        if self.tp is not None:
            x = tp_lib.copy_in(x, self.tp)
        return (self.wq(x).reshape(b, s, -1, cfg.head_dim),
                self.wk(x).reshape(b, s, -1, cfg.head_dim),
                self.wv(x).reshape(b, s, -1, cfg.head_dim))

    def _out(self, out):
        b, s = out.shape[:2]
        return self.wo(out.reshape(b, s, -1))

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """The training path: rope at `positions` [B, S], causal
        attention through the configured backend (on the rank's heads
        under tp)."""
        cfg = self.config
        q, k, v = self._project(x)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if self.sp is not None:
            return self._out(sequence_sharded_attention(
                q, k, v, impl=cfg.attention_impl, group=self.sp.group))
        return self._out(attention(q, k, v, impl=cfg.attention_impl,
                                   causal=True))

    def _cache_rows(self, k, v):
        """This window's cache rows (k, v, k_scale, v_scale): int8 codes
        and f32 scales for an int8 cache, else k and v in the compute
        dtype and no scales."""
        if int8_kv_cache(self.config):
            k_q, k_s = quantize_int8(k)
            v_q, v_s = quantize_int8(v)
            return k_q, v_q, k_s, v_s
        dtype = self.config.dtype
        return k.to(dtype), v.to(dtype), None, None

    def _stored(self, rows, span: Optional[int] = None):
        """K and V as attention reads them from cache rows: int8 rows
        dequantized to the compute dtype (the JAX package's one-shot
        dequant), the first `span` positions."""
        key, value, k_s, v_s = (None if t is None else t[:, :span]
                                for t in rows)
        if k_s is None:
            return key, value
        dtype = self.config.dtype
        return (dequantize_int8(key, k_s, dtype),
                dequantize_int8(value, v_s, dtype))

    def prefill(self, x: torch.Tensor):
        """Dense-cache prefill from an empty cache: returns the block
        output and this layer's cache rows (k, v, k_scale, v_scale), each
        [B, S, Hkv, *] (the scales None for a cache in the compute
        dtype)."""
        cfg = self.config
        b, s, _ = x.shape
        q, k, v = self._project(x)
        positions = torch.arange(s, device=x.device).expand(b, s)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        rows = self._cache_rows(k, v)
        # The prompt attends through its cache rows (an int8 cache: its
        # own quantized copy, as the JAX package's one-shot dequant of
        # the whole cache does). Cache positions past the prompt carry
        # exactly zero weight there, so attending over the prompt's rows
        # alone gives the same result.
        key, value = self._stored(rows)
        out = xla_attention(q, key, value, causal=True, segment_offset=0)
        return self._out(out), rows

    def decode(self, x: torch.Tensor, cache, layer: int,
               span: Optional[int]) -> torch.Tensor:
        """The dense-cache decode branch (transformer.py:255-315): rope at
        ``cache.index[:, None] + arange(W)``, append the window's rows
        to layer `layer` of `cache` (`DenseKVCache` or the engine's
        gathered view), then attend. One token over an int8 cache: the
        `int8_decode_attention` kernel reads the int8 rows directly,
        ``index + 1`` positions per row. Otherwise `xla_attention` over
        the first `span` positions (the longest row's end) with each
        row's causal offset at its own index; later positions carry
        exactly zero weight in the JAX package's whole-cache attention,
        so the live prefix gives the same result."""
        cfg = self.config
        q, k, v = self._project(x)
        width = q.shape[1]
        index = cache.index
        positions = index[:, None] + torch.arange(
            width, dtype=index.dtype, device=x.device)[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        stored = cache.append(layer, self._cache_rows(k, v), positions)
        if width == 1 and stored[2] is not None:
            out = int8_decode_attention(
                q[:, 0], stored[0], stored[2], stored[1], stored[3],
                index + 1)[:, None]
        else:
            key, value = self._stored(stored, span)
            out = xla_attention(q, key, value, causal=True,
                                segment_offset=index)
        return self._out(out)

    def paged_decode(self, x, layer_pool, tables, lengths):
        """The fused paged step (the JAX `_fused_paged_decode`): rows of
        x are slots, its sequence axis the window. Rope at positions
        ``lengths[:, None] + arange(W)``, quantize, scatter the rows into
        the pool IN PLACE (rows past a slot's table go to trash block 0),
        then attend straight off the pool."""
        cfg = self.config
        require_int8_pool(cfg)
        key_pool, value_pool, key_scale, value_scale = layer_pool
        q, k, v = self._project(x)
        slots, width = q.shape[:2]
        positions = lengths[:, None] + torch.arange(
            width, dtype=lengths.dtype, device=x.device)[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        k_q, k_s = quantize_int8(k)
        v_q, v_s = quantize_int8(v)
        blocks, offsets = pool_rows(tables, positions, key_pool.shape[1])
        rows = slots * width
        key_pool[blocks, offsets] = k_q.reshape(rows, *k_q.shape[2:])
        value_pool[blocks, offsets] = v_q.reshape(rows, *v_q.shape[2:])
        key_scale[blocks, offsets] = k_s.reshape(rows, *k_s.shape[2:])
        value_scale[blocks, offsets] = v_s.reshape(rows, *v_s.shape[2:])
        out = paged_int8_window_attention(
            q, key_pool, key_scale, value_pool, value_scale, tables, lengths)
        return self._out(out)


class SwiGLU(nn.Module):
    def __init__(self, config: TransformerConfig, device=None,
                 trainable: bool = False):
        super().__init__()
        cfg = self.config = config
        dense = lambda i, o, axes: LoraDense(i, o, cfg, device, trainable,
                                             axes=axes)
        self.w_gate = dense(cfg.d_model, cfg.d_ff, (EMBED, MLP))
        self.w_up = dense(cfg.d_model, cfg.d_ff, (EMBED, MLP))
        self.w_down = dense(cfg.d_ff, cfg.d_model, (MLP, EMBED))
        self.tp = None

    def forward(self, x):
        if self.tp is not None:
            x = tp_lib.copy_in(x, self.tp)
        return self.w_down(nn.functional.silu(self.w_gate(x)) * self.w_up(x))


class Block(nn.Module):
    def __init__(self, config: TransformerConfig, device=None,
                 trainable: bool = False):
        super().__init__()
        norm_trainable = trainable and config.lora_rank == 0
        self.attn_norm = RMSNorm(config, device, norm_trainable)
        self.attn = Attention(config, device, trainable)
        self.mlp_norm = RMSNorm(config, device, norm_trainable)
        if config.moe_experts > 0:
            # Not LoraDense in JAX: frozen under LoRA.
            self.moe = MoEMlp(config, device, norm_trainable)
        else:
            self.mlp = SwiGLU(config, device, trainable)

    def _mlp(self, x):
        mlp = self.moe if hasattr(self, "moe") else self.mlp
        return x + mlp(self.mlp_norm(x))

    def forward(self, x, positions):
        return self._mlp(x + self.attn(self.attn_norm(x), positions))

    def prefill(self, x):
        out, cache = self.attn.prefill(self.attn_norm(x))
        return self._mlp(x + out), cache

    def decode(self, x, cache, layer: int, span: Optional[int]):
        x = x + self.attn.decode(self.attn_norm(x), cache, layer, span)
        return self._mlp(x)

    def paged_decode(self, x, layer_pool, tables, lengths):
        x = x + self.attn.paged_decode(self.attn_norm(x), layer_pool,
                                       tables, lengths)
        return self._mlp(x)


class Transformer(nn.Module):
    """tokens -> f32 logits, for training (`forward`) and over the decode
    paths (module docstring). Built on CUDA unless
    ``device="cpu"`` is passed. ``trainable=True`` builds the parameters
    an optimizer trains as f32 masters with ``requires_grad`` (all of
    them, or only the LoRA adapters when ``lora_rank > 0``); the default
    builds a frozen model in the compute dtype, as serving wants. The
    weights are uninitialised until `init_weights` or a state dict
    (`models/weights.py`) fills them."""

    def __init__(self, config: TransformerConfig, device=None,
                 trainable: bool = False):
        super().__init__()
        if config.attention_impl not in IMPLS:
            raise ValueError(f"unknown attention_impl {config.attention_impl!r}; "
                             f"use {' | '.join(IMPLS)}")
        device = resolve_device(device)
        self.config = config
        dense_trainable = trainable and config.lora_rank == 0
        self.embedding = _param((config.vocab_size, config.d_model),
                                dense_trainable, config, device)
        self.layers = nn.ModuleList(
            [Block(config, device, trainable) for _ in range(config.n_layers)])
        self.final_norm = RMSNorm(config, device, dense_trainable)
        self.lm_head = _param((config.d_model, config.vocab_size),
                              dense_trainable, config, device)
        sharding.annotate(self, embedding=(VOCAB, EMBED),
                          lm_head=(EMBED, VOCAB))
        sharding.annotate_stack(self, layers="layers")
        self.tp = None
        # Set by the train loop: the sp group (the rank computes a block
        # of the sequence) and the pipeline stage (the layers it holds).
        self.sp = None
        self.pp = None
        # What only the first stage reads: its gradient is summed over pp.
        self.pipeline_inputs = ("embedding",)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    @property
    def kv_heads(self) -> int:
        """The kv heads this model's caches hold: ``n_kv_heads``, or under
        tp the rank's (`tp_lib.kv_span`)."""
        cfg = self.config
        if self.tp is None:
            return cfg.n_kv_heads
        return tp_lib.kv_span(cfg.n_heads, cfg.n_kv_heads, self.tp)[1]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Transformer":
        """Random weights from `generator` (on the model's device):
        embedding, head and MoE router N(0, 0.02), Dense kernels and
        expert weights N(0, 1/fan_in) with flax's fan_in (every dim but the
        last: an expert's ``[E, in, out]`` has E·in) — the JAX package's
        lecun-normal scale — unit norm scales, LoRA ``lora_a`` N(0, 0.02)
        and ``lora_b`` zeros."""
        for name, param in self.named_parameters():
            if name.endswith("scale"):
                param.fill_(1.0)
            elif name.endswith("lora_b"):
                param.zero_()
            elif name in ("embedding", "lm_head") or name.endswith(
                    ("lora_a", "router")):
                param.normal_(0.0, 0.02, generator=generator)
            else:
                fan_in = param.numel() // param.shape[-1]
                param.normal_(0.0, fan_in ** -0.5, generator=generator)
        return self

    def _embed(self, tokens):
        cfg = self.config
        ids = vocab_index(tokens, cfg.vocab_size)
        if self.tp is not None:
            return tp_lib.vocab_embed(self.embedding, ids, cfg.vocab_size,
                                      self.tp, cfg.dtype)
        return self.embedding[ids].to(cfg.dtype)

    def _head(self, x):
        x = self.final_norm(x)
        if self.tp is None:
            return (x @ self.lm_head.to(self.config.dtype)).float()
        # Gathered in the compute dtype, then cast: the f32 logits are
        # the one-device ones bit for bit, at half the bytes in bf16.
        start, _ = self.tp.span(self.config.vocab_size, "vocab_size")
        local = tp_lib.copy_in(x, self.tp) @ self.lm_head.to(self.config.dtype)
        return tp_lib.gather_last(local, start, self.config.vocab_size,
                                  self.tp).float()

    def head_input(self, hidden: torch.Tensor) -> torch.Tensor:
        """`forward`'s ``return_hidden`` output as `head_chunk` reads it:
        itself, or under tp the replicated input of the vocab-parallel
        head (its gradient summed over tp)."""
        return hidden if self.tp is None else tp_lib.copy_in(hidden, self.tp)

    def head_chunk(self, hidden: torch.Tensor, base: int,
                   width: int) -> torch.Tensor:
        """f32 logits ``[N, width]`` of vocabulary columns ``[base, base +
        width)`` for hidden rows ``[N, d]`` (`head_input`'s), zeros past
        the vocabulary — the chunked loss's head. Under tp a rank computes
        its columns of the chunk and the chunk is gathered whole, in the
        compute dtype before the cast (the same f32 values)."""
        cfg = self.config
        if self.tp is None:
            w = self.lm_head[:, base:base + width]
            if w.shape[1] < width:  # the padded tail chunk
                w = nn.functional.pad(w, (0, width - w.shape[1]))
            return (hidden @ w.to(hidden.dtype)).float()
        start, length = self.tp.span(cfg.vocab_size, "vocab_size")
        # The rank's columns of the chunk, maybe none: every rank still
        # reads `hidden`, so the ranks' backward graphs, and the order of
        # their collectives, are the same.
        lo = min(max(base - start, 0), length)
        hi = max(min(base + width - start, length), lo)
        local = hidden @ self.lm_head[:, lo:hi].to(hidden.dtype)
        return tp_lib.gather_last(local, min(max(start + lo - base, 0), width),
                                  width, self.tp).float()

    def sequence_block(self, length: int) -> Tuple[int, int]:
        """(start, length) of the positions of a `length`-token row this
        rank computes: the whole row, or under sp its contiguous block (a
        ValueError when sp does not divide the row)."""
        if self.sp is None:
            return 0, length
        if length % self.sp.size:
            raise ValueError(f"seq_len {length} does not split over "
                             f"sp={self.sp.size}")
        block = length // self.sp.size
        return self.sp.rank * block, block

    def _check_gpipe(self) -> None:
        """The JAX package's refusals of a GPipe config
        (transformer.py:544-549)."""
        cfg = self.config
        if not cfg.scan_layers:
            raise ValueError("gpipe_microbatches requires scan_layers=True")
        if cfg.moe_experts or cfg.attention_impl != "xla":
            raise ValueError(
                "gpipe_microbatches supports dense blocks with xla attention"
            )

    def _blocks(self, x, positions, blocks) -> torch.Tensor:
        """`x` through `blocks`, each recomputed in the backward with
        ``remat``. Under sp a block's collectives run again in its
        recompute, so the recompute runs whole on every rank (no early
        stop: the ranks' graphs differ where the ring skips a block)."""
        recompute = self.config.remat and torch.is_grad_enabled()
        for block in blocks:
            if recompute:
                x = checkpoint(block, x, positions, use_reentrant=False,
                               early_stop=self.sp is None)
            else:
                x = block(x, positions)
        return x

    def _pipeline(self, x, positions) -> torch.Tensor:
        """The rank's stage of the layers in the GPipe schedule, with
        ``gpipe_microbatches`` microbatches (1 when 0). One row of
        positions serves every microbatch."""
        stage = self.pp
        blocks = [self.layers[i] for i in stage.layers()]
        row = positions[:1]

        def stage_fn(h):
            return self._blocks(h, row.expand(h.shape[0], -1), blocks)

        return pipeline.pipeline_schedule(
            stage_fn, x, stage, max(self.config.gpipe_microbatches, 1),
            stage.data_shards)

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False,
                head=None) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V] f32, or with
        ``return_hidden=True`` the final-norm hidden states [B, S, d] in
        the compute dtype (the chunked loss's seam), or with `head` what
        it makes of them (``head(hidden)``: the chunked loss, run inside
        the forward so a wrapper sees the head it reads). Under sp the
        positions are the rank's block (`sequence_block`) of the whole
        rows `tokens`."""
        cfg = self.config
        if cfg.gpipe_microbatches > 0:
            self._check_gpipe()
        start, length = self.sequence_block(tokens.shape[1])
        x = self._embed(tokens[:, start:start + length])
        positions = torch.arange(start, start + length, device=tokens.device)
        positions = positions.expand(tokens.shape[0], length)
        if self.pp is not None:
            x = self._pipeline(x, positions)
        else:
            x = self._blocks(x, positions, self.layers)
        if head is not None:
            return head(self.final_norm(x))
        if return_hidden:
            return self.final_norm(x)
        return self._head(x)

    def require_dense(self, what: str) -> None:
        """Refuse a serving path of an MoE decoder (ROADMAP.md Queue 1
        item 8e): JAX's dense grid routes one token at a time, its paged
        grid a slot batch, so their capacities differ."""
        if self.config.moe_experts > 0:
            raise NotImplementedError(
                f"{what} of an MoE decoder (moe_experts="
                f"{self.config.moe_experts}) is not ported yet (ROADMAP.md "
                "Queue 1 item 8e); MoE trains")

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """tokens [B, F] -> (last-position logits [B, V] f32, rows): rows
        is a dict of the prompt's cache rows ``key``/``value`` [L, B, F,
        Hkv, D] (int8, or the compute dtype) and, for an int8 cache, f32
        ``key_scale``/``value_scale`` [L, B, F, Hkv, 1]."""
        self.require_dense("prefill")
        int8_kv_cache(self.config)
        x = self._embed(tokens)
        layers: List[Tuple[torch.Tensor, ...]] = []
        for block in self.layers:
            x, rows = block.prefill(x)
            layers.append(rows)
        rows = {name: torch.stack([r[i] for r in layers])
                for i, name in enumerate(KV_NAMES) if layers[0][i] is not None}
        # The last position of each row: a strided view once B > 1, and
        # the norm kernel reads contiguous rows.
        return self._head(x[:, -1].contiguous()), rows

    def make_cache(self, batch: int, capacity: Optional[int] = None
                   ) -> DenseKVCache:
        """A zeroed `DenseKVCache` for `batch` rows of `capacity`
        positions (default ``max_seq_len``, the JAX cache's size) at the
        model's kv heads (`kv_heads`) on its device, index 0."""
        cfg = self.config
        capacity = cfg.max_seq_len if capacity is None else int(capacity)
        return DenseKVCache(
            **zeroed_kv(cfg, (cfg.n_layers, batch, capacity), self.device,
                        self.kv_heads),
            index=torch.zeros(batch, dtype=torch.int32, device=self.device),
        )

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, cache) -> torch.Tensor:
        """tokens [B, W] -> logits [B, W, V] f32: the window appended to
        `cache` (a `DenseKVCache`, or the engine's gathered pool view) at
        each row's index, which then advances by W."""
        self.require_dense("decode")
        width = tokens.shape[1]
        span = None
        if width > 1 or not int8_kv_cache(self.config):
            span = cache.live_span(width)
        x = self._embed(tokens)
        for i, block in enumerate(self.layers):
            x = block.decode(x, cache, i, span)
        cache.index = cache.index + width
        return self._head(x)

    @torch.no_grad()
    def paged_decode(self, tokens: torch.Tensor, pool: PagedKVPool,
                     tables: torch.Tensor, lengths: torch.Tensor
                     ) -> torch.Tensor:
        """tokens [S, W] (slots x window) -> logits [S, W, V] f32, with
        the window's K/V rows written into `pool` in place. `tables`
        [S, MB] and `lengths` [S] are int32 on the model's device."""
        self.require_dense("paged_decode")
        x = self._embed(tokens)
        for i, block in enumerate(self.layers):
            x = block.paged_decode(x, pool.layer(i), tables, lengths)
        return self._head(x)


def make_model(config: TransformerConfig, seed: Optional[int] = 0,
               device=None, trainable: bool = False) -> Transformer:
    """A `Transformer` on `device` (CUDA by default) with random weights
    from a `torch.Generator` seeded with `seed`."""
    model = Transformer(config, device=device, trainable=trainable)
    generator = torch.Generator(device=model.device)
    generator.manual_seed(int(seed))
    return model.init_weights(generator)


def lora_label_tree(model: nn.Module) -> Dict[str, str]:
    """``{parameter name: "lora" | "frozen"}`` — the JAX label tree
    (transformer.py:612-623) over the module's parameter names."""
    return {name: "lora" if is_lora_param(name) else "frozen"
            for name, _ in model.named_parameters()}


def merge_lora(state_dict: Mapping[str, torch.Tensor],
               config: TransformerConfig) -> Dict[str, torch.Tensor]:
    """Fold trained adapters into the base kernels (transformer.py:
    626-658): every ``kernel`` with a ``lora_a``/``lora_b`` beside it
    becomes ``kernel + (alpha/rank)·A@B`` (in f32, cast back to the
    kernel's dtype) and the factors are dropped, so the result loads
    into the same architecture with ``lora_rank=0``."""
    if config.lora_rank <= 0:
        return dict(state_dict)
    scale = config.lora_alpha / config.lora_rank
    out: Dict[str, torch.Tensor] = {}
    for name, value in state_dict.items():
        if is_lora_param(name):
            continue
        prefix = name[:-len("kernel")] if name.endswith("kernel") else None
        if prefix is not None and f"{prefix}lora_a" in state_dict:
            a = state_dict[f"{prefix}lora_a"].float()
            b = state_dict[f"{prefix}lora_b"].float()
            value = (value.float() + scale * (a @ b)).to(value.dtype)
        out[name] = value
    return out


def make_lora_optimizer(learning_rate: float = 1e-4, inner=None):
    """The frozen-base LoRA optimizer (transformer.py:661-672): a factory
    ``model -> optimizer`` that freezes every parameter but the
    ``lora_*`` adapters (``requires_grad=False``, the counterpart of
    optax's set_to_zero) and hands the model to `inner` (an optimizer
    factory over the parameters that require grad, default
    `common.adamw_with_decay_mask`)."""
    from tf_yarn_tpu_torch.models import common

    inner = inner or common.adamw_with_decay_mask(learning_rate)

    def make(model: nn.Module) -> torch.optim.Optimizer:
        for name, param in model.named_parameters():
            if not is_lora_param(name):
                param.requires_grad_(False)
        return inner(model)

    return make


def make_experiment(config: Optional[TransformerConfig] = None,
                    model_dir: Optional[str] = None, train_steps: int = 100,
                    batch_size: int = 8, seq_len: Optional[int] = None,
                    learning_rate: float = 3e-4, mesh_spec=None,
                    input_fn=None, loss_chunk_size: Optional[int] = None,
                    optimizer=None, **train_param_overrides):
    """Causal-LM experiment (transformer.py:675-746): synthetic tokens
    unless `input_fn` is given; LoRA configs get the frozen-base
    optimizer; vocabularies of 65536 or more get the chunked loss with
    ``chunk_size=16384``; both losses fold in an MoE decoder's aux loss.
    `optimizer` is None, ``"adamw"``, ``"adafactor"`` (optax's,
    `models.adafactor`) or a factory ``model -> torch.optim.Optimizer``.
    The model is built by `train_and_evaluate` on its device
    (``init_fn``), with random weights from ``train_params.seed``."""
    import functools

    from tf_yarn_tpu_torch.experiment import TorchExperiment, TrainParams
    from tf_yarn_tpu_torch.models import adafactor, common

    config = config or TransformerConfig.tiny()
    seq_len = seq_len or config.max_seq_len
    if loss_chunk_size is None and config.vocab_size >= 65536:
        loss_chunk_size = 16384
    loss_fn = (functools.partial(common.lm_loss_chunked,
                                 chunk_size=loss_chunk_size)
               if loss_chunk_size else common.lm_loss)
    if optimizer == "adamw":
        optimizer = common.adamw_with_decay_mask(learning_rate)
    elif optimizer == "adafactor":
        optimizer = adafactor.adafactor(learning_rate)
    elif isinstance(optimizer, str):
        raise ValueError(f"unknown optimizer {optimizer!r}; use 'adamw', "
                         "'adafactor', or pass an optimizer factory")
    if config.lora_rank > 0:
        optimizer = make_lora_optimizer(learning_rate, inner=optimizer)
    elif optimizer is None:
        optimizer = common.adamw_with_decay_mask(learning_rate)
    defaults = dict(train_steps=train_steps,
                    log_every_steps=max(1, train_steps // 10))
    defaults.update(train_param_overrides)
    return TorchExperiment(
        model=None,
        optimizer=optimizer,
        loss_fn=loss_fn,
        train_input_fn=input_fn or (lambda: common.synthetic_token_iter(
            batch_size, seq_len, config.vocab_size)),
        train_params=TrainParams(**defaults),
        model_dir=model_dir,
        init_fn=lambda device, seed: make_model(config, seed, device,
                                                trainable=True),
        mesh_spec=mesh_spec,
    )
