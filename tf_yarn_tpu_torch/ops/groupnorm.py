"""Fused GroupNorm over NHWC slabs, forward and backward — counterpart of
tf_yarn_tpu/ops/groupnorm.py (the norm of ResNet).

x is ``[B, ..., C]`` with the channels last (``[B, H, W, C]`` or
``[B, L, C]``); each (image, group) is normalised over its spatial
positions and its ``C / groups`` channels, as flax's ``nn.GroupNorm``.
`groupnorm` is differentiable through a `torch.autograd.Function`: the
forward is the hand-written kernel of csrc/groupnorm.cu (replacing the
TPU kernel `_groupnorm_kernel`), which also returns each group's (mean,
inv) so the backward does not recompute them. The backward,
`groupnorm_backward`, gives dx, dscale = Σ g·norm and dbias = Σ g from
the kernels of the same file (replacing `_groupnorm_bwd_dx_kernel` and
the XLA sums the JAX package leaves beside it): dx's reduction keeps its
sums per channel, and those are each image's share of dscale and dbias,
which a second launch sums over the images. CUDA tensors launch the
kernels (counted in ``groupnorm.launches`` and
``groupnorm_backward.launches``, one a call), CPU tensors take the plain
versions the tests hold against the JAX package.

`groupnorm_plan`, a pure function of the shape and the direction, picks
how a call covers a slab. Where a span of whole groups, a multiple of 32
bytes wide, fits a thread-block cluster of at most 8 blocks of 227 KB
(every ResNet-50 shape, in bf16 and f32, forward and backward), the
cluster holds the span's rows in shared memory (the backward: x's and
g's) and reads them from device memory once: the forward is one launch,
the backward one launch for dx and the per-image sums and one for
dscale and dbias. Otherwise (a slab as large as ``[1, 256², 64]``, or
channels no 32-byte span divides) a reduction and an apply pass read
the slab twice, and the backward adds its parameter sums. Nothing gives
way to the plain version on a CUDA tensor.

Layout: the kernels read x as contiguous ``[B, HW, C]``. A channels-last
NCHW tensor seen as NHWC (``x.permute(0, 2, 3, 1)``) is contiguous and is
taken as it is; a contiguous NCHW tensor seen that way is not, and the
wrapper raises rather than read it as garbage. The JAX package falls
back to its XLA reference for a slab over 8 MiB (its VMEM budget); the
card kernels serve every slab size, and both compute the same function
to f32 rounding.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from tf_yarn_tpu_torch.ops import _build

# Per-group sums live in the reduction kernel's shared memory (2·G f32).
MAX_GROUPS = 4096
# The one-pass kernel's limits on the H100 (csrc/groupnorm.cu).
MAX_CLUSTER = 8          # the portable cluster size
MAX_SMEM = 232448        # 227 KB of shared memory a block
_SMS = 132
# Its tiles (the backward's two together): ~32 KB a block where the
# cluster has room, so several blocks share an SM and one's loads overlap
# another's arithmetic; up to ~100 KB where a span of _SPAN_BYTES (128
# bytes: whole DRAM lines of each row) needs them. Tiles under 16 KB
# widen their span while the grid keeps four blocks an SM. A block of 48
# KB or more runs 256 threads, else 128.
_TILE_TARGET = 32 * 1024
_TILE_MAX = 100 * 1024
_SPAN_BYTES = 128
_TILE_MIN = 16 * 1024
_MIN_BLOCKS = 4 * _SMS
_LARGE_TILE = 48 * 1024
BLOCKS = (128, 256)
# The two-launch path: elements of a slab each block covers.
_CHUNK_ELEMENTS = 65536


class GroupNormPlan(NamedTuple):
    """How a forward (or, with ``backward``, a backward) call covers a
    ``[B, HW, C]`` slab.

    One pass (``chunks == 0``): a cluster of ``cluster`` blocks of
    ``threads`` threads owns one (image, ``span`` channels); each block
    holds ``rows`` rows of the span (the backward: of x and of g) in
    ``smem`` bytes of shared memory. Two launches (``chunks > 0``):
    blocks of 256 threads over ``rows`` rows, ``chunks`` an image
    (``span`` is C, ``cluster`` 1, ``smem`` 0)."""
    span: int
    cluster: int
    rows: int
    chunks: int
    threads: int
    smem: int
    backward: bool = False

    @property
    def one_pass(self) -> bool:
        return self.chunks == 0

    @property
    def launches(self) -> int:
        """CUDA launches of a call: the pass (or the reduction and the
        apply pass), and for the backward the dscale/dbias sums, which a
        call that wants neither skips."""
        return (1 if self.one_pass else 2) + self.backward


def _spans(c: int, cg: int, itemsize: int) -> List[int]:
    """Channel spans the one-pass kernels take, narrowest first: whole
    groups, dividing C, a multiple of 32 bytes, and a power-of-two count
    of 16-byte vectors no larger than a block."""
    out = []
    for span in range(cg, c + 1, cg):
        nbytes = span * itemsize
        nv = nbytes // 16
        if (c % span == 0 and nbytes % 32 == 0 and nv <= min(BLOCKS)
                and nv & (nv - 1) == 0):
            out.append(span)
    return out


def one_pass_smem(rows: int, span: int, cg: int, itemsize: int,
                  threads: int, backward: bool = False) -> int:
    """Shared memory a one-pass block uses (csrc/groupnorm.cu:
    one_pass_smem). Forward: its [rows, span] tile, the reduction's
    per-channel partials and four per-group f32 vectors. Backward: the
    tiles of x and g, two quantities' partials, scale times the cluster's
    two per-channel sums, and two per-group means."""
    nv = span * itemsize // 16
    slots = threads // 32 if nv < 32 else threads // nv
    tile = rows * span * itemsize
    if not backward:
        return tile + (slots * span + 4 * (span // cg)) * 4
    return 2 * tile + (2 * slots * span + 2 * span + 2 * (span // cg)) * 4


def groupnorm_plan(b: int, hw: int, c: int, groups: int, itemsize: int,
                   backward: bool = False) -> GroupNormPlan:
    """The plan for x ``[b, hw, c]`` (hw >= 1) of `itemsize` bytes an
    element, from the shape and the direction alone; the backward's
    blocks hold two tiles (x and g) where the forward's hold one. The
    narrowest span, widened while it is under 128 bytes and 8 blocks of
    ~100 KB hold the wider one's tiles, or while its tiles are under 16
    KB and the grid keeps four blocks an SM; as many blocks a cluster as
    ~32 KB of tiles a block need, at most 8; one pass when a block's
    share fits 227 KB, else two launches."""
    cg = c // groups
    tiles = 2 if backward else 1
    spans = _spans(c, cg, itemsize)
    if spans:
        span = spans[0]
        for wider in spans[1:]:
            narrow = (span * itemsize < _SPAN_BYTES
                      and tiles * hw * wider * itemsize
                      <= MAX_CLUSTER * _TILE_MAX)
            small = (tiles * hw * span * itemsize < _TILE_MIN
                     and b * (c // wider) >= _MIN_BLOCKS)
            if not (narrow or small):
                break
            span = wider
        tile = tiles * hw * span * itemsize
        cluster = min(MAX_CLUSTER, max(1, -(-tile // _TILE_TARGET)))
        rows = -(-hw // cluster)
        threads = BLOCKS[tiles * rows * span * itemsize >= _LARGE_TILE]
        smem = one_pass_smem(rows, span, cg, itemsize, threads, backward)
        if smem <= MAX_SMEM:
            return GroupNormPlan(span, -(-hw // rows), rows, 0, threads, smem,
                                 backward)
    rows = max(1, min(hw, _CHUNK_ELEMENTS // c))
    return GroupNormPlan(c, 1, rows, -(-hw // rows), 256, 0, backward)


def _check_groups(x: torch.Tensor, groups: int) -> None:
    if x.shape[-1] % groups:
        raise ValueError(
            f"channels ({x.shape[-1]}) must divide into groups ({groups})")


def _grouped(x: torch.Tensor, groups: int) -> torch.Tensor:
    """x as f32 [B, HW, G, C/G]."""
    b, c = x.shape[0], x.shape[-1]
    return x.float().reshape(b, -1, groups, c // groups)


def groupnorm_stats_reference(x: torch.Tensor, groups: int,
                              eps: float = 1e-5) -> torch.Tensor:
    """Each (image, group)'s (mean, rsqrt(var + eps)), the variance
    two-pass, as f32 [B, G, 2] (groupnorm.py:38-48)."""
    _check_groups(x, groups)
    xg = _grouped(x, groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    b = x.shape[0]
    return torch.stack([mean.reshape(b, groups),
                        torch.rsqrt(var + eps).reshape(b, groups)], -1)


def _normalize(x: torch.Tensor, stats: torch.Tensor, groups: int) -> torch.Tensor:
    """(x − mean)·inv in f32, x's shape."""
    b = x.shape[0]
    mean = stats[..., 0].reshape(b, 1, groups, 1)
    inv = stats[..., 1].reshape(b, 1, groups, 1)
    return ((_grouped(x, groups) - mean) * inv).reshape(x.shape)


def _affine(x, stats, scale, bias, groups: int) -> torch.Tensor:
    norm = _normalize(x, stats, groups)
    return (norm * scale.float() + bias.float()).to(x.dtype)


def groupnorm_reference(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, groups: int,
                        eps: float = 1e-5) -> torch.Tensor:
    """flax nn.GroupNorm over [B, ..., C] in f32, returned in x's dtype
    (groupnorm.py:51-60); raises ValueError when C % groups."""
    return _affine(x, groupnorm_stats_reference(x, groups, eps), scale, bias,
                   groups)


def groupnorm_bwd_reference(x: torch.Tensor, g: torch.Tensor,
                            scale: torch.Tensor, stats: torch.Tensor,
                            groups: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) of `groupnorm` for the cotangent g, from the
    forward's `stats` [B, G, 2], in f32: dx = inv·(gs − mean_g(gs) −
    norm·mean_g(gs·norm)), gs = g·scale, per (image, group), returned in
    x's dtype (groupnorm.py:150-164); dscale = Σ g·norm and dbias = Σ g
    over images and positions, f32 [C] (groupnorm.py:224-230)."""
    b, c = x.shape[0], x.shape[-1]
    norm = _grouped(_normalize(x, stats, groups), groups)
    g32 = _grouped(g, groups)
    gs = _grouped(g.float() * scale.float(), groups)
    m1 = gs.mean(dim=(1, 3), keepdim=True)
    m2 = (gs * norm).mean(dim=(1, 3), keepdim=True)
    inv = stats[..., 1].reshape(b, 1, groups, 1)
    dx = (inv * (gs - m1 - norm * m2)).reshape(x.shape).to(x.dtype)
    dscale = (g32 * norm).reshape(-1, c).sum(0)
    dbias = g32.reshape(-1, c).sum(0)
    return dx, dscale, dbias


def _slab(x: torch.Tensor) -> Tuple[int, int, int]:
    b, c = x.shape[0], x.shape[-1]
    return b, (x.numel() // (b * c) if b * c else 0), c


def _check_cuda(x: torch.Tensor, groups: int, **vectors: torch.Tensor):
    """The kernel's preconditions; returns (B, HW, C) and the [C] vectors
    as contiguous f32."""
    _check_groups(x, groups)
    _build.require_cuda("x", x, _build.DTYPE_CODES)
    if x.dim() < 2:
        raise ValueError(f"x must be [B, ..., C], got shape {tuple(x.shape)}")
    b, hw, c = _slab(x)
    if not 0 < groups <= MAX_GROUPS:
        raise ValueError(f"groups must be in 1..{MAX_GROUPS}, got {groups}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel grid's 65535 images")
    out = []
    for name, v in vectors.items():
        if v.shape != (c,):
            raise ValueError(f"{name} must have shape ({c},), got {tuple(v.shape)}")
        v = v.detach().float().contiguous()
        _build.require_cuda(name, v, (torch.float32,))
        out.append(v)
    return (b, hw, c), out


def groupnorm_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      groups: int, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, stats): the normalised x in x's dtype and each (image, group)'s
    (mean, inv) as f32 [B, G, 2]. CUDA tensors launch the kernel, CPU
    tensors take `groupnorm_reference`'s arithmetic."""
    if not x.is_cuda:
        stats = groupnorm_stats_reference(x, groups, eps)
        return _affine(x, stats, scale, bias, groups), stats
    (b, hw, c), (scale, bias) = _check_cuda(x, groups, scale=scale, bias=bias)
    y = torch.empty_like(x)
    stats = torch.empty(b, groups, 2, dtype=torch.float32, device=x.device)
    if hw == 0:
        return y, stats.zero_()
    plan = groupnorm_plan(b, hw, c, groups, x.element_size())
    partials = None
    if not plan.one_pass:
        partials = torch.empty(b, plan.chunks, groups, 2, dtype=torch.float32,
                               device=x.device)
    elif x.data_ptr() % 16:
        x = x.clone()  # the 16-byte loads need an aligned slab
    lib = _build.load_library()
    status = lib.tyt_groupnorm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        stats.data_ptr(), None if partials is None else partials.data_ptr(),
        b, hw, c, groups, plan.span, plan.cluster, plan.rows, plan.chunks,
        plan.threads, plan.smem, float(eps), _build.DTYPE_CODES[x.dtype],
        _build.stream_handle(x.device),
    )
    _build.check(status, "groupnorm")
    groupnorm.launches += 1
    return y, stats


def groupnorm_backward(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                       stats: torch.Tensor, groups: int, dx: bool = True,
                       dscale: bool = True, dbias: bool = True
                       ) -> Tuple[Optional[torch.Tensor], ...]:
    """(dx, dscale, dbias) of `groupnorm` for the cotangent g (x's shape,
    cast to x's dtype), from the forward's `stats`: dx in x's dtype,
    dscale and dbias f32 [C]; each None where its flag is False. CUDA
    tensors launch the backward's kernels (``plan.launches``, less the
    parameter sums when neither dscale nor dbias is wanted), CPU tensors
    take `groupnorm_bwd_reference`."""
    wanted = (dx, dscale, dbias)
    g = g.to(x.dtype)
    if not x.is_cuda:
        out = groupnorm_bwd_reference(x, g, scale, stats, groups)
        return tuple(t if want else None for t, want in zip(out, wanted))
    if not any(wanted):
        raise ValueError("groupnorm_backward needs dx, dscale or dbias")
    g = g.contiguous()
    (b, hw, c), (scale,) = _check_cuda(x, groups, scale=scale)
    _build.require_cuda("g", g, _build.DTYPE_CODES)
    if g.shape != x.shape:
        raise ValueError(f"g must have x's shape {tuple(x.shape)}, "
                         f"got {tuple(g.shape)}")
    _build.require_cuda("stats", stats, (torch.float32,))
    if stats.shape != (b, groups, 2):
        raise ValueError(f"stats must have shape {(b, groups, 2)}, "
                         f"got {tuple(stats.shape)}")
    f32 = dict(dtype=torch.float32, device=x.device)
    out = (torch.empty_like(x) if dx else None,
           torch.empty(c, **f32) if dscale else None,
           torch.empty(c, **f32) if dbias else None)
    if hw == 0:
        for t in out[1:]:
            if t is not None:
                t.zero_()
        return out
    plan = groupnorm_plan(b, hw, c, groups, x.element_size(), backward=True)
    partials = None
    if not plan.one_pass:
        partials = torch.empty(b, plan.chunks, c, 2, **f32)
    else:
        if dscale or dbias:
            partials = torch.empty(b, c, 2, **f32)
        # The 16-byte loads need aligned slabs.
        x, g = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, g))
    out_dx, out_dscale, out_dbias = (None if t is None else t.data_ptr()
                                     for t in out)
    lib = _build.load_library()
    status = lib.tyt_groupnorm_bwd(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(), stats.data_ptr(),
        out_dx, None if partials is None else partials.data_ptr(),
        out_dscale, out_dbias, b, hw, c, groups, plan.span, plan.cluster,
        plan.rows, plan.chunks, plan.threads, plan.smem,
        _build.DTYPE_CODES[x.dtype],
        _build.stream_handle(x.device),
    )
    _build.check(status, "groupnorm_backward")
    groupnorm_backward.launches += 1
    return out


class _GroupNorm(torch.autograd.Function):
    """The JAX `_groupnorm` custom_vjp (groupnorm.py:206-235), with the
    forward's statistics saved for the backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        y, stats = groupnorm_forward(x, scale, bias, groups, eps)
        ctx.save_for_backward(x, scale, stats)
        ctx.groups, ctx.bias_dtype = groups, bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, stats = ctx.saved_tensors
        dx, dscale, dbias = groupnorm_backward(
            x, g, scale, stats, ctx.groups, *ctx.needs_input_grad[:3])
        if dscale is not None:
            dscale = dscale.to(scale.dtype)
        if dbias is not None:
            dbias = dbias.to(ctx.bias_dtype)
        return dx, dscale, dbias, None, None


def groupnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over x [B, ..., C] (channels last) with [C] scale and
    bias (read as f32); output in x's dtype; differentiable in x, scale
    and bias. An empty batch returns x; C % groups raises ValueError."""
    if x.shape[0] == 0:
        return x
    _check_groups(x, groups)
    return _GroupNorm.apply(x, scale, bias, groups, eps)


groupnorm.launches = 0
groupnorm_backward.launches = 0
