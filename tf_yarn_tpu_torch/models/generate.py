"""Autoregressive generation over the dense KV cache — counterpart of
tf_yarn_tpu/models/generate.py.

`generate` routes through the shared `DecodeEngine` of the model
(`decode_engine.get_engine`): batch buckets, a floor-bucketed prefill
and a teacher-forced replay of the prompt's remainder. `generate_legacy`
is the plain loop — a prefill of the whole prompt, then one decode step
per token — that the engine must reproduce. Both run the token loop
`sample_tokens` on the host, one `Transformer.decode` per token, and
read the eos flags once per step (the JAX engine's on-device while loop
has no counterpart in eager PyTorch).

Sampling: greedy is `argmax`. Temperature, top-k and top-p filter the
logits exactly as the JAX package does (values below the cut become
-1e30) and draw from an explicit `torch.Generator` seeded with ``seed``,
advanced once per sampled step. The draws cannot match `jax.random` bit
for bit; greedy streams and the filter masks can, and the tests hold
both.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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


def sample_tokens(model, cache, first: torch.Tensor, max_new_tokens: int,
                  generator: Optional[torch.Generator], temperature: float,
                  top_k: Optional[int], top_p: Optional[float],
                  eos_token: Optional[int]) -> torch.Tensor:
    """The token loop: `first` [B] then ``max_new_tokens - 1`` decode
    steps over `cache`, each sampling once. With an eos, a row that
    emitted it repeats it, and the loop stops (the rest filled with eos)
    once every row has — one host read per step. Returns [B,
    max_new_tokens] int64."""
    tokens = [first]
    finished = None if eos_token is None else torch.zeros_like(first,
                                                              dtype=torch.bool)
    for i in range(max_new_tokens - 1):
        logits = model.decode(tokens[-1][:, None], cache)[:, -1]
        token = _sample(logits, generator, temperature, top_k, top_p)
        if eos_token is not None:
            finished = finished | (tokens[-1] == eos_token)
            token = torch.where(finished, eos_token, token)
            if bool(finished.all()):
                tokens.extend([torch.full_like(first, eos_token)]
                              * (max_new_tokens - 1 - i))
                break
        tokens.append(token)
    return torch.stack(tokens[:max_new_tokens], dim=1)


def as_prompt(prompt_tokens, device: torch.device) -> torch.Tensor:
    """A [B, P] prompt (array, list or tensor) as int64 on `device`."""
    if isinstance(prompt_tokens, torch.Tensor):
        return prompt_tokens.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(prompt_tokens, np.int64), device=device)


def check_length(model, prompt_len: int, max_new_tokens: int) -> None:
    limit = model.config.max_seq_len
    if prompt_len + max_new_tokens > limit:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds config.max_seq_len ({limit}) — the KV cache size"
        )


def generate(model, prompt_tokens, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, seed: int = 0,
             eos_token: Optional[int] = None) -> torch.Tensor:
    """Extend `prompt_tokens` [B, P] by `max_new_tokens`: returns [B, P +
    max_new_tokens] int32 on the model's device (positions after an
    eos_token repeat it). All prompts of a batch share length P.

    The model (a `Transformer`) holds its weights, so there is no
    ``params`` argument. Calls route through the shared `DecodeEngine`
    of the model; when the batch is padded up to a bucket, sampled
    (temperature > 0) draws for the real rows differ from an unpadded
    call's, as in the JAX package."""
    from tf_yarn_tpu_torch.models.decode_engine import get_engine

    return get_engine(model).generate(
        prompt_tokens, max_new_tokens, temperature=temperature, top_k=top_k,
        top_p=top_p, seed=seed, eos_token=eos_token)


@torch.no_grad()
def generate_legacy(model, prompt_tokens, max_new_tokens: int,
                    temperature: float = 0.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None, seed: int = 0,
                    eos_token: Optional[int] = None) -> torch.Tensor:
    """The plain loop `generate` must reproduce: a prefill of the whole
    prompt, its last logits sampled, then `sample_tokens`."""
    prompt = as_prompt(prompt_tokens, model.device)
    batch, prompt_len = prompt.shape
    check_length(model, prompt_len, max_new_tokens)
    if max_new_tokens == 0:
        return prompt.int()
    generator = torch.Generator(device=model.device)
    generator.manual_seed(int(seed))
    logits, rows = model.prefill(prompt)
    cache = model.make_cache(batch, prompt_len + max_new_tokens)
    cache.insert(rows)
    first = _sample(logits, generator, temperature, top_k, top_p)
    out = sample_tokens(model, cache, first, max_new_tokens, generator,
                        temperature, top_k, top_p, eos_token)
    return torch.cat([prompt, out], dim=1).int()
