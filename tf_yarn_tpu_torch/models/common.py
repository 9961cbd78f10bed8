"""Losses, the optimizer recipe and synthetic data — counterpart of
tf_yarn_tpu/models/common.py.

Loss contract of the port (`experiment.py`): ``loss_fn(model, batch,
train=True) -> (loss, aux)`` with ``batch`` a dict of tensors on the
model's device; the parameters live in the module, so the JAX
``params`` argument has no counterpart, and a model with dropout draws
its masks from its own ``torch.Generator`` where the JAX package takes
``rng``.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _trained(model: torch.nn.Module):
    return [param for param in model.parameters() if param.requires_grad]


def adamw(learning_rate: float, weight_decay: float = 1e-4):
    """``optax.adamw``: decoupled weight decay on every parameter (the
    BERT and ViT recipes, bert.py:224 and vit.py:144). A factory ``model
    -> torch.optim.AdamW`` over the parameters that require grad."""

    def make(model: torch.nn.Module) -> torch.optim.Optimizer:
        return torch.optim.AdamW(_trained(model), lr=learning_rate,
                                 weight_decay=weight_decay)

    return make


def sgd(learning_rate: float, momentum: float = 0.9):
    """``optax.sgd(lr, momentum)`` — the ResNet recipe (resnet.py:191):
    the trace ``t = g + momentum·t`` then ``p −= lr·t``, which is
    torch's SGD with no dampening and no Nesterov term."""

    def make(model: torch.nn.Module) -> torch.optim.Optimizer:
        return torch.optim.SGD(_trained(model), lr=learning_rate,
                               momentum=momentum)

    return make


# optax.adagrad's defaults: each sum of squared gradients starts here,
# and eps is added to it under the root.
ADAGRAD_INITIAL_ACCUMULATOR = 0.1
ADAGRAD_EPS = 1e-7


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad``: ``scale_by_rss`` then ``-lr``. Each parameter's
    sum of squared gradients starts at 0.1; the update is ``g ·
    rsqrt(acc + 1e-7)``, and ``p −= lr · update``. `torch.optim.Adagrad`
    is another rule (the sum starts at 0, the step divides by
    ``sqrt(acc) + 1e-10``), so this is the port's own. A row that no
    batch touched has a zero gradient: its parameters and its sum stay
    as they were. optax takes the root only where ``acc > 0``; from 0.1
    the sum never is 0, so the step has no such guard (one temporary
    the size of the parameter, and no pass to build a mask)."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for param in group["params"]:
                if param.grad is None:
                    continue
                state = self.state[param]
                if not state:
                    state["sum_of_squares"] = torch.full_like(
                        param, ADAGRAD_INITIAL_ACCUMULATOR,
                        memory_format=torch.preserve_format)
                acc = state["sum_of_squares"]
                grad = param.grad
                acc.addcmul_(grad, grad)
                update = (acc + ADAGRAD_EPS).rsqrt_().mul_(grad)
                param.add_(update, alpha=-group["lr"])
        return loss


def adagrad(learning_rate: float):
    """``optax.adagrad(learning_rate)`` — the DLRM recipe (dlrm.py:190).
    A factory ``model -> Adagrad`` over the parameters that require
    grad."""

    def make(model: torch.nn.Module) -> torch.optim.Optimizer:
        return Adagrad(_trained(model), lr=learning_rate)

    return make


def adamw_with_decay_mask(learning_rate: float, weight_decay: float = 1e-4):
    """AdamW that skips weight decay on 1-D parameters (norm scales,
    biases) — common.py:14-24. Returns a factory ``model ->
    torch.optim.AdamW`` over the parameters that require grad, in two
    groups: ``ndim > 1`` decays by `weight_decay`, the rest by 0. optax's decoupled decay
    ``p − lr·(adam + wd·p)`` and torch's ``p·(1 − lr·wd) − lr·adam`` are
    the same update; betas (0.9, 0.999) and eps 1e-8 are both defaults."""

    def make(model: torch.nn.Module) -> torch.optim.Optimizer:
        decay, no_decay = [], []
        for param in model.parameters():
            if param.requires_grad:
                (decay if param.ndim > 1 else no_decay).append(param)
        groups = [{"params": decay, "weight_decay": weight_decay},
                  {"params": no_decay, "weight_decay": 0.0}]
        return torch.optim.AdamW([g for g in groups if g["params"]],
                                 lr=learning_rate)

    return make


def classification_loss(model, batch: Dict, train: bool = True):
    """Softmax cross-entropy and accuracy for models mapping x -> logits
    (common.py:27-36); ``train=False`` turns dropout off."""
    logits = model(batch["x"], deterministic=not train)
    labels = batch["y"].long()
    loss = F.cross_entropy(logits, labels)
    accuracy = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": accuracy}


def binary_logistic_loss(model, batch: Dict, train: bool = True):
    """Sigmoid cross-entropy and accuracy for models mapping x -> one
    logit (common.py:39-47): the mean of optax's
    ``sigmoid_binary_cross_entropy``; ``train=False`` turns dropout
    off."""
    logits = model(batch["x"], deterministic=not train).squeeze(-1)
    labels = batch["y"].float()
    loss = F.binary_cross_entropy_with_logits(logits, labels)
    accuracy = ((logits > 0) == (labels > 0.5)).float().mean()
    return loss, {"accuracy": accuracy}


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 − rate
    and scale it by 1 / (1 − rate); the identity when deterministic or
    rate is 0. The mask is drawn from `generator` (on x's device), so its
    bits are the port's own, not ``jax.random``'s."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)


@torch.no_grad()
def init_weights(model: torch.nn.Module,
                 generator: torch.Generator) -> torch.nn.Module:
    """Random weights for the encoder and vision families from
    `generator` (on the model's device), at flax's initialisers' scales:
    norm scales 1, biases and ``cls_token`` 0, embeddings N(0, 0.02),
    Dense and conv kernels N(0, 1/fan_in) (lecun normal; a conv kernel
    ``[out, in, kh, kw]`` has fan_in = in·kh·kw)."""
    for name, param in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            param.fill_(1.0)
        elif leaf in ("bias", "cls_token"):
            param.zero_()
        elif leaf.endswith("embedding"):
            param.normal_(0.0, 0.02, generator=generator)
        else:
            fan_in = param[0].numel() if param.dim() == 4 else param.shape[0]
            param.normal_(0.0, fan_in ** -0.5, generator=generator)
    return model


def _masked_mean(per_token: torch.Tensor, batch: Dict) -> torch.Tensor:
    if "mask" in batch:
        mask = batch["mask"][:, 1:].float()
        return (per_token * mask).sum() / mask.sum().clamp_min(1.0)
    return per_token.mean()


def _next_tokens(decoder, batch: Dict, length: int):
    """The next-token targets of the `length` positions the decoder
    computed of each row (`sequence_block`: the whole row, or under sp
    the rank's block): (n, targets [B, n], weights [B, n] or None, the
    whole batch's weight). The targets come from the whole row, so a
    block's last position predicts the next block's first token; the
    row's last position has none."""
    tokens = batch["tokens"]
    start, _ = decoder.sequence_block(tokens.shape[1])
    n = min(length, tokens.shape[1] - 1 - start)
    targets = tokens[:, start + 1:start + 1 + n]
    if "mask" in batch:
        mask = batch["mask"].float()
        return (n, targets, mask[:, start + 1:start + 1 + n],
                mask[:, 1:].sum().clamp_min(1.0))
    return n, targets, None, tokens.shape[0] * (tokens.shape[1] - 1)


def _sequence_loss(decoder, per_token: torch.Tensor, weights, count):
    """The loss of a rank's block of the sequence: its share of the
    batch's mean (its tokens' sum over the whole batch's count), summed
    over the sp group forward (`collectives.reduce_value`) so every rank
    holds the batch's loss, while each rank's gradient is its share's;
    the train loop sums those over sp."""
    from tf_yarn_tpu_torch.parallel import collectives

    total = (per_token if weights is None else per_token * weights).sum()
    return collectives.reduce_value(total / count, decoder.sp.group)


def _decoder(model):
    return getattr(model, "module", model)


def _apply_moe_aux(decoder, moe_losses, loss, aux):
    """Fold an MoE decoder's aux losses into the task loss (common.py:
    75-90): their sum, times ``moe_aux_weight``, added to the loss, and
    reported as ``moe_aux_loss`` when there is an MoE layer and the
    weight is nonzero."""
    weight = getattr(getattr(decoder, "config", None), "moe_aux_weight", 0.0)
    if moe_losses and weight:
        total = sum(moe_losses)
        loss = loss + weight * total
        aux["moe_aux_loss"] = total.detach()
    return loss, aux


def lm_loss(model, batch: Dict, train: bool = True):
    """Next-token cross-entropy (common.py:50-72): batch "tokens" [B, S];
    loss over positions 0..S-2 predicting 1..S-1, averaged under the
    optional "mask" [B, S], plus an MoE decoder's weighted aux loss
    (`_apply_moe_aux`; perplexity is taken before it). Under sp each
    rank's logits are its block of the positions (`_sequence_loss`)."""
    from tf_yarn_tpu_torch.models import moe

    tokens = batch["tokens"]
    decoder = _decoder(model)
    with moe.collecting() as moe_losses:
        logits = model(tokens)  # f32
    if getattr(decoder, "sp", None) is None:
        logits = logits[:, :-1]
        targets = tokens[:, 1:]
        per_token = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                    targets.reshape(-1).long(),
                                    reduction="none")
        loss = _masked_mean(per_token.reshape(targets.shape), batch)
    else:
        n, targets, weights, count = _next_tokens(decoder, batch,
                                                  logits.shape[1])
        logits = logits[:, :n]
        per_token = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                    targets.reshape(-1).long(),
                                    reduction="none")
        loss = _sequence_loss(decoder, per_token.reshape(targets.shape),
                              weights, count)
    return _apply_moe_aux(decoder, moe_losses, loss,
                          {"perplexity": torch.exp(loss.detach())})


def _chunk_step(m, l, tgt, h2, t2, base: int, chunk: int, vocab: int,
                head_chunk):
    """One vocab chunk of the online log-sum-exp (the body of the JAX
    scan, common.py:123-143): logits of the chunk in f32 (`head_chunk`),
    padded columns −1e30, running max and sum, the target's logit where
    it falls here."""
    logits = head_chunk(h2, base, chunk)
    if base + chunk > vocab:
        col = torch.arange(chunk, device=logits.device)[None, :] + base
        logits = torch.where(col < vocab, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(-1))
    l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
    local = t2 - base
    in_range = (local >= 0) & (local < chunk)
    picked = torch.gather(logits, 1, local.clamp(0, chunk - 1)[:, None])[:, 0]
    return m_new, l, torch.where(in_range, picked, tgt)


def lm_loss_chunked(model, batch: Dict, train: bool = True,
                    chunk_size: int = 8192):
    """`lm_loss` without the [B, S, vocab] logits (common.py:93-164):
    hidden states come out of the model once; the head matmul and the
    log-sum-exp run per vocab chunk (the decoder's `head_chunk`: the
    head cast to the hidden dtype, the logits f32, each chunk gathered
    whole under tensor parallelism). Each chunk runs under
    `torch.utils.checkpoint`, so the backward recomputes its logits and
    no [B·S, V] activation stays live. The loss runs inside the model's
    forward, as its ``head``: a wrapper that watches the forward
    (DistributedDataParallel, whose ``module`` is the decoder) sees the
    head read there, the MoE aux loss included (`_apply_moe_aux`, folded
    in by the head). Under sp the hidden states are the rank's block of
    the positions."""
    from tf_yarn_tpu_torch.models import moe

    tokens = batch["tokens"]
    decoder = _decoder(model)
    aux = {}

    def head(hidden):  # [B, S, D], the final-norm hidden states
        loss = _chunked_loss(decoder, hidden, batch, chunk_size)
        aux["perplexity"] = torch.exp(loss.detach())
        return _apply_moe_aux(decoder, moe_losses, loss, aux)[0]

    with moe.collecting() as moe_losses:
        loss = model(tokens, head=head)
    return loss, aux


def _chunked_loss(decoder, hidden, batch: Dict, chunk_size: int):
    """`lm_loss_chunked`'s loss of the decoder's `hidden` states."""
    vocab = decoder.config.vocab_size
    n_chunks = -(-vocab // chunk_size)
    n, targets, weights, count = _next_tokens(decoder, batch, hidden.shape[1])
    h = hidden[:, :n]
    b, s, d = h.shape
    h2 = decoder.head_input(h.reshape(b * s, d))
    t2 = targets.reshape(b * s).long()
    m = torch.full((b * s,), NEG_INF, dtype=torch.float32, device=h2.device)
    l = torch.zeros((b * s,), dtype=torch.float32, device=h2.device)
    tgt = torch.zeros((b * s,), dtype=torch.float32, device=h2.device)
    recompute = torch.is_grad_enabled()
    for c in range(n_chunks):
        args = (m, l, tgt, h2, t2, c * chunk_size, chunk_size, vocab,
                decoder.head_chunk)
        if recompute:
            m, l, tgt = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            m, l, tgt = _chunk_step(*args)
    logsumexp = m + torch.log(l.clamp_min(1e-30))
    per_token = (logsumexp - tgt).reshape(b, s)
    if getattr(decoder, "sp", None) is None:
        return _masked_mean(per_token, batch)
    return _sequence_loss(decoder, per_token, weights, count)


def synthetic_classification_iter(batch_size: int, feature_dim: int,
                                  num_classes: int, seed: int = 0
                                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless seeded batches {"x": f32 [B, F], "y": int32 [B]} (common.py:
    167-177): the same numpy stream as the JAX package's."""
    rng = np.random.RandomState(seed)
    weights = rng.randn(feature_dim, num_classes).astype(np.float32)
    while True:
        x = rng.randn(batch_size, feature_dim).astype(np.float32)
        y = np.argmax(x @ weights + 0.1 * rng.randn(batch_size, num_classes),
                      axis=-1)
        yield {"x": x, "y": y.astype(np.int32)}


def synthetic_token_iter(batch_size: int, seq_len: int, vocab: int,
                         seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless seeded token batches {"tokens": int32 [B, S]} (common.py:
    181-186): the same numpy stream as the JAX package's."""
    rng = np.random.RandomState(seed)
    while True:
        yield {"tokens": rng.randint(0, vocab, (batch_size, seq_len),
                                     dtype=np.int32)}
