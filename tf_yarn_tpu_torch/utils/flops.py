"""Model FLOPs and MFU — counterpart of tf_yarn_tpu/utils/flops.py:73-159.

`transformer_train_flops` is the JAX package's analytic count (matmul
FLOPs only, forward plus twice that for the backward, the causal
quadratic term at S²/2); `model_train_flops` takes it for the decoder
family. For every other model the JAX package reads XLA's cost analysis
of the compiled step; the port's counterpart is `count_flops`, which runs
one step under `torch.utils.flop_counter.FlopCounterMode`. Like the cost
analysis, which sees no FLOPs inside Pallas kernels, it sees none inside
the hand-written kernels (they run behind ctypes): it counts the matrix
products and convolutions. `mfu` divides the achieved model FLOP/s by
the card's peak: 989 TFLOP/s dense bf16 for an H100 (NVIDIA's data
sheet, SXM part, at its 700 W limit).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Tuple

# Peak dense bf16 FLOP/s by device name (lowercased substring).
_PEAK_BF16_FLOPS = (("h100", 989e12),)


def peak_flops_per_device(device_name: str) -> Optional[float]:
    """Peak bf16 FLOP/s of the named card, or None when unknown (the
    CPU included)."""
    name = device_name.lower()
    for pattern, flops in _PEAK_BF16_FLOPS:
        if pattern in name:
            return flops
    return None


def transformer_train_flops(config, batch_size: int, seq_len: int,
                            causal: bool = True) -> float:
    """Analytic model FLOPs of ONE training step of the decoder (the
    PaLM-appendix accounting, as in the JAX package)."""
    d, hd = config.d_model, config.head_dim
    attn_params = (d * config.n_heads * hd
                   + 2 * d * config.n_kv_heads * hd
                   + config.n_heads * hd * d)
    # A Switch MoE layer routes each token through one expert of the
    # dense MLP's shape: the same FLOPs per token (the router's d·E are
    # left out, as JAX flops.py:93-96 leaves them).
    mlp_params = 3 * d * config.d_ff
    dense_params = config.n_layers * (attn_params + mlp_params)
    dense_params += d * config.vocab_size  # untied lm_head
    tokens = batch_size * seq_len
    fwd = 2.0 * tokens * dense_params
    quad = 4.0 * batch_size * float(seq_len) ** 2 * d * config.n_layers
    if causal:
        quad /= 2.0
    return 3.0 * (fwd + quad)


TOKEN_KEYS = ("tokens", "input_ids", "token_ids")


def batch_counts(batch: Mapping[str, Any]
                 ) -> Tuple[Optional[int], Optional[int]]:
    """(samples, tokens) of a batch (flops.py:126-152): samples is the
    leading dim of its first entry; tokens is B·S of a conventionally
    named token-id entry ("tokens", "input_ids", "token_ids": shape
    alone cannot tell token ids from integer features), else None."""
    samples = None
    for value in batch.values():
        shape = getattr(value, "shape", None)
        if shape:
            samples = int(shape[0])
            break
    for key in TOKEN_KEYS:
        shape = getattr(batch.get(key), "shape", None)
        if shape is not None and len(shape) >= 2:
            return samples, int(shape[0]) * int(shape[1])
    return samples, None


def model_train_flops(model, batch: Mapping[str, Any]) -> Optional[float]:
    """The analytic FLOPs of one train step for the decoder family
    (flops.py:107-123), else None: `count_flops` measures the others."""
    cfg = getattr(model, "config", None)
    if cfg is not None and hasattr(cfg, "scan_layers") \
            and hasattr(cfg, "n_kv_heads"):
        samples, tokens = batch_counts(batch)
        if samples and tokens:
            return transformer_train_flops(cfg, samples, tokens // samples)
    return None


def count_flops(fn: Callable, *args) -> Tuple[Any, float]:
    """``(fn(*args), FLOPs)``: the FLOPs `FlopCounterMode` counts while
    `fn` runs, backward included (none inside the hand-written kernels)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return out, float(counter.get_total_flops())


def mfu(flops_per_step: Optional[float], steps_per_sec: float,
        peak: Optional[float]) -> Optional[float]:
    """Per-device MFU: model FLOP/s over the device's peak."""
    if not flops_per_step or not peak:
        return None
    return flops_per_step * steps_per_sec / peak
