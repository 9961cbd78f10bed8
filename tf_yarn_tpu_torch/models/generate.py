"""Token sampling — counterpart of tf_yarn_tpu/models/generate.py:_sample.

Greedy is `argmax`. Temperature, top-k and top-p filter the logits
exactly as the JAX package does (values below the cut become -1e30) and
draw from an explicit `torch.Generator`. The draws cannot match
`jax.random` bit for bit; greedy streams and the filter masks can, and
the tests hold both. `generate` and `generate_legacy` are still to port
(ROADMAP.md Queue 1, decode engine).
"""

from __future__ import annotations

from typing import Optional

import torch

MASKED_LOGIT = -1e30


def filter_logits(logits: torch.Tensor, temperature: float,
                  top_k: Optional[int], top_p: Optional[float]) -> torch.Tensor:
    """logits [B, V] scaled by 1/temperature, with the top-k and nucleus
    cuts applied (masked entries set to -1e30)."""
    logits = logits / temperature
    if top_k is None and top_p is None:
        return logits
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    if top_k is not None:
        k = max(1, min(int(top_k), logits.shape[-1]))
        kth = sorted_desc[:, k - 1:k]
        logits = torch.where(logits < kth, MASKED_LOGIT, logits)
        # Mirror the cut in sorted space so top-p renormalises over the
        # top-k-filtered distribution (ties at the threshold survive).
        sorted_desc = torch.where(sorted_desc < kth, MASKED_LOGIT, sorted_desc)
    if top_p is not None:
        probs = torch.softmax(sorted_desc, dim=-1)
        cumulative = torch.cumsum(probs, dim=-1)
        in_nucleus = cumulative - probs < top_p
        cutoff_idx = torch.clamp(in_nucleus.sum(dim=-1) - 1, min=0)
        cutoff = torch.gather(sorted_desc, 1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, MASKED_LOGIT, logits)
    return logits


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: Optional[int],
            top_p: Optional[float] = None) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits.float(), temperature, top_k,
                                        top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
