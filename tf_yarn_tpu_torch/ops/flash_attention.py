"""Flash attention, forward and backward — counterpart of
tf_yarn_tpu/ops/flash_attention.py.

`flash_attention(q, k, v)` keeps the JAX contract at its public
surface: q ``[B, S, H, D]``, k/v ``[B, Skv, Hkv, D]``, GQA without
repeating K/V, `_check_blocks` folding with a ValueError on indivisible
lengths, zeros for empty inputs, top-left causal alignment when
``Skv != S``. It is a `torch.autograd.Function` over three kernels of
csrc/flash_attention.cu — forward (replacing `_fwd_kernel`), dq
(`_dq_kernel`) and dk/dv (`_dkv_kernel`) — with ``delta = rowsum(dO·O)``
in f32 computed in torch between them, as the JAX package leaves it to
XLA. The forward saves q, k, v, o and the LSE (``[B·H, S]`` f32) for the
backward; under `torch.utils.checkpoint` it simply runs again.

Each wrapper (`flash_fwd`, `flash_dq`, `flash_dkv`) dispatches on the
tensor's device: CUDA tensors launch the kernel — bf16 or f32 at
head_dim 64 or 128, anything else raises ValueError — and count it in
``<wrapper>.launches``; CPU tensors take the plain versions beside them,
which round at the kernels' four bf16 points (p and ds cast to the
operand dtype before each product) and mask with −1e30.

`block_q`/`block_k` are validated as in the JAX package, but the kernels
tile by their own rows whatever they are (Hopper's shared memory and
registers, not the TPU's VMEM, set the tile: 128 q rows and 128-row K/V
tiles for the bf16 forward, 128 q rows and 64-row K/V tiles for bf16 dq,
128 kv rows and 64-row Q/dO tiles for bf16 dk/dv, one row a warp for
f32) and mask their own tails. The three bf16 kernels read their
operands through TMA tensor maps, which need 16-byte aligned bases
(`_operand` copies a tensor that is not). bf16 dk/dv
splits each kv tile's work over two blocks whose f32 partials meet in
scratch that `flash_dkv` allocates (the kernels allocate nothing).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tf_yarn_tpu_torch.ops import _build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
# kv rows of a bf16 dk/dv block (csrc/flash_attention.cu kDkvRows).
DKV_TILE_ROWS = 128


def _check_blocks(s_q: int, s_kv: int, block_q: int, block_k: int):
    """The JAX package's block folding (flash_attention.py:140-155)."""
    block_q = min(block_q, s_q)
    block_k = min(block_k, s_kv)
    while block_q >= 256 and s_q % block_q:
        block_q //= 2
    while block_k >= 256 and s_kv % block_k:
        block_k //= 2
    if s_q % block_q or s_kv % block_k:
        raise ValueError(
            f"flash attention needs seq lengths divisible by blocks: "
            f"s_q={s_q} % {block_q}, s_kv={s_kv} % {block_k}"
        )
    return block_q, block_k


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _grouped(q, k, v):
    """q -> [B, Hkv, G, S, D]; k, v -> [B, Hkv, 1, Skv, D] (views that
    broadcast over the group: nothing is repeated)."""
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, s, n_kv, h // n_kv, d).permute(0, 2, 3, 1, 4)
    kg = k.permute(0, 2, 1, 3)[:, :, None]
    vg = v.permute(0, 2, 1, 3)[:, :, None]
    return qg, kg, vg


def _ungroup(x):
    """[B, Hkv, G, S, D] -> [B, S, H, D]."""
    b, n_kv, group, s, d = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, s, n_kv * group, d)


def _logits(qg, kg, causal: bool, scale: float):
    """f32 logits of bf16 or f32 operands (products exact in f32, f32
    sums — the kernels' preferred_element_type), scaled after the dot,
    masked logits −1e30."""
    logits = torch.matmul(qg.float(), kg.float().transpose(-1, -2)) * scale
    if causal:
        s_q, s_kv = logits.shape[-2:]
        q_pos = torch.arange(s_q, device=logits.device)[:, None]
        k_pos = torch.arange(s_kv, device=logits.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits,
                             torch.full((), NEG_INF, device=logits.device))
    return logits


def flash_fwd_reference(q, k, v, causal: bool = True,
                        softmax_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, S, H, D] in q's dtype, lse [B·H, S] f32). One softmax over
    the whole row; p is cast to V's dtype before P·V and the normaliser
    is floored at 1e-30, as in `_fwd_kernel`."""
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    qg, kg, vg = _grouped(q, k, v)
    logits = _logits(qg, kg, causal, scale)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), vg.float()) / l
    lse = (m + torch.log(l)).reshape(q.shape[0] * q.shape[2], q.shape[1])
    return _ungroup(o).to(q.dtype), lse


def _probs_and_ds(q, k, v, dout, lse, delta, causal, scale):
    qg, kg, vg = _grouped(q, k, v)
    dog = _grouped(dout, k, v)[0]
    b, s, h, _ = q.shape
    n_kv = k.shape[2]
    stat = (b, n_kv, h // n_kv, s, 1)
    p = torch.exp(_logits(qg, kg, causal, scale) - lse.reshape(stat))
    dp = torch.matmul(dog.float(), vg.float().transpose(-1, -2))
    ds = p * (dp - delta.reshape(stat))
    return qg, kg, dog, p, ds


def flash_dq_reference(q, k, v, dout, lse, delta, causal: bool = True,
                       softmax_scale: Optional[float] = None) -> torch.Tensor:
    """dq = scale · ds·K with p recomputed from the LSE and
    ds = p·(dp − delta); ds cast to K's dtype (`_dq_kernel`)."""
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    _, kg, _, _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, scale)
    dq = torch.matmul(ds.to(k.dtype).float(), kg.float()) * scale
    return _ungroup(dq).to(q.dtype)


def flash_dkv_reference(q, k, v, dout, lse, delta, causal: bool = True,
                        softmax_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, Skv, Hkv, D], summed over each kv head's group in f32;
    p cast to dO's dtype for dv, ds to q's dtype for dk (`_dkv_kernel`)."""
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    qg, _, dog, p, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, scale)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                      dog.float()).sum(2)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      qg.float()).sum(2) * scale
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_kernel_args(q, k, v, *rest) -> None:
    """Refuse what the kernels are not built for, before any launch."""
    for name, t in (("query", q), ("key", k), ("value", v)) + rest:
        _build.require_cuda(name, t, (torch.bfloat16, torch.float32))
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must have the query's dtype {q.dtype}, "
                             f"got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, s, h, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"key/value must be [B, Skv, Hkv, {d}] with B={b}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernels are built for head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if h % k.shape[2]:
        raise ValueError(f"n_heads {h} must be a multiple of n_kv_heads "
                         f"{k.shape[2]}")
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h} exceeds the kernels' grid")


def _dims(q, k):
    b, s_q, h, d = q.shape
    return b, s_q, k.shape[1], h, k.shape[2], d


def flash_fwd(q, k, v, causal: bool = True,
              softmax_scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) — the kernel on CUDA, `flash_fwd_reference` on the CPU."""
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_fwd_reference(q, k, v, causal, scale)
    _check_kernel_args(q, k, v)
    b, s_q, s_kv, h, n_kv, d = _dims(q, k)
    o = torch.empty_like(q)
    lse = torch.empty(b * h, s_q, dtype=torch.float32, device=q.device)
    status = _build.load_library().tyt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, s_q, s_kv, h, n_kv, d, float(scale), int(causal),
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device))
    _build.check(status, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def _check_stats(q, lse, delta) -> None:
    shape = (q.shape[0] * q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        _build.require_cuda(name, t, (torch.float32,))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} f32, got {tuple(t.shape)}")


def flash_dq(q, k, v, dout, lse, delta, causal: bool = True,
             softmax_scale: Optional[float] = None) -> torch.Tensor:
    """dq — the kernel on CUDA, `flash_dq_reference` on the CPU."""
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_dq_reference(q, k, v, dout, lse, delta, causal, scale)
    _check_kernel_args(q, k, v, ("dout", dout))
    _check_stats(q, lse, delta)
    b, s_q, s_kv, h, n_kv, d = _dims(q, k)
    dq = torch.empty_like(q)
    status = _build.load_library().tyt_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        b, s_q, s_kv, h, n_kv, d, float(scale), int(causal),
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device))
    _build.check(status, "flash_dq")
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, dout, lse, delta, causal: bool = True,
              softmax_scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) — the kernel on CUDA, `flash_dkv_reference` on the CPU."""
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_dkv_reference(q, k, v, dout, lse, delta, causal, scale)
    _check_kernel_args(q, k, v, ("dout", dout))
    _check_stats(q, lse, delta)
    b, s_q, s_kv, h, n_kv, d = _dims(q, k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    scratch = (None, None)  # f32 takes none
    if q.dtype == torch.bfloat16:
        # The two blocks of each 128-row kv tile meet through f32 partials
        # of dk and dv and a zeroed [ticket, flag] pair.
        tiles = b * n_kv * -(-s_kv // DKV_TILE_ROWS)
        partial = torch.empty(tiles * DKV_TILE_ROWS * d * 2,
                              dtype=torch.float32, device=q.device)
        tickets = torch.zeros(tiles * 2, dtype=torch.int32, device=q.device)
        scratch = (partial.data_ptr(), tickets.data_ptr())
    status = _build.load_library().tyt_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *scratch, b, s_q, s_kv, h, n_kv, d, float(scale), int(causal),
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device))
    _build.check(status, "flash_dkv")
    flash_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


def flash_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO·O) in f32, as ``[B·H, S]`` (flash_attention.py:359)."""
    b, s, h, _ = out.shape
    delta = (dout.float() * out.float()).sum(-1)  # [B, S, H]
    return delta.permute(0, 2, 1).reshape(b * h, s).contiguous()


def _operand(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.is_cuda and t.data_ptr() % 16 else t


class _FlashAttention(torch.autograd.Function):
    """The JAX `_flash` custom_vjp: forward saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = _operand(q), _operand(k), _operand(v)
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = _operand(dout.to(q.dtype))
        delta = flash_delta(out, dout)
        dq = flash_dq(q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, *, causal: bool = True,
                    softmax_scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Blockwise (flash) attention, differentiable: q [B, S, H, D], k/v
    [B, Skv, Hkv, D] -> [B, S, H, D] in q's dtype."""
    if softmax_scale is None:
        softmax_scale = query.shape[-1] ** -0.5
    if query.numel() == 0 or key.numel() == 0:
        # Nothing to attend over: zeros, as the JAX package defines it.
        return torch.zeros(query.shape, dtype=query.dtype, device=query.device)
    _check_blocks(query.shape[1], key.shape[1], block_q, block_k)
    return _FlashAttention.apply(query, key, value, causal, float(softmax_scale))
