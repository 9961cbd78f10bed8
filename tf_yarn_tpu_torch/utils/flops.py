"""Model FLOPs and MFU — counterpart of tf_yarn_tpu/utils/flops.py:73-159.

`transformer_train_flops` is the JAX package's analytic count (matmul
FLOPs only, forward plus twice that for the backward, the causal
quadratic term at S²/2). `mfu` divides the achieved model FLOP/s by the
card's peak: 989 TFLOP/s dense bf16 for an H100 (NVIDIA's data sheet,
SXM part, at its 700 W limit).
"""

from __future__ import annotations

from typing import Optional

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
    mlp_params = 3 * d * config.d_ff
    dense_params = config.n_layers * (attn_params + mlp_params)
    dense_params += d * config.vocab_size  # untied lm_head
    tokens = batch_size * seq_len
    fwd = 2.0 * tokens * dense_params
    quad = 4.0 * batch_size * float(seq_len) ** 2 * d * config.n_layers
    if causal:
        quad /= 2.0
    return 3.0 * (fwd + quad)


def mfu(flops_per_step: Optional[float], steps_per_sec: float,
        peak: Optional[float]) -> Optional[float]:
    """Per-device MFU: model FLOP/s over the device's peak."""
    if not flops_per_step or not peak:
        return None
    return flops_per_step * steps_per_sec / peak
