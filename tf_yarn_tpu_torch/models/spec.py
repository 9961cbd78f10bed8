"""Speculative decoding: the self-drafter, the window planner and the
accept/reject pass — counterpart of tf_yarn_tpu/models/spec.py.

* Host side: `ngram_propose` / `NGramDrafter`, a prompt-lookup
  self-drafter over each request's own token history, `make_drafter`
  (``"ngram"``, a callable ``(context, k) -> tokens``, or ``None``) and
  `plan_window`, which turns a slot's state into the window the step
  consumes.
* `verify_window`: the accept/reject pass over one slot's window logits.
  Acceptance is the JAX package's token matching — a draft is kept iff
  it equals the token the target itself emits there under the slot's
  own sampling chain — so every emitted token is the target's own and
  the streams equal the exact path's. The JAX package traces it on the
  device; here it runs on the host over the slot's logits.

The fused paged tick runs the windowed program even without drafts, at
width 1: a slot replaying its prompt feeds one known token (no
emission), a decoding slot feeds its last token and emits one.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from tf_yarn_tpu_torch.models.generate import _sample

DrafterFn = Callable[[Sequence[int], int], Sequence[int]]


def ngram_propose(context: Sequence[int], k: int, max_ngram: int = 3,
                  min_ngram: int = 1) -> List[int]:
    """Prompt lookup: find the most recent earlier occurrence of the
    context's trailing n-gram (longest n first) and copy the ``k`` tokens
    that followed it — up to ``k`` tokens, possibly none."""
    if k <= 0:
        return []
    n_ctx = len(context)
    context = list(context)
    for n in range(min(max_ngram, n_ctx - 1), min_ngram - 1, -1):
        suffix = context[n_ctx - n:]
        for start in range(n_ctx - n - 1, -1, -1):
            if context[start:start + n] == suffix:
                follow = context[start + n:start + n + k]
                if follow:
                    return [int(t) for t in follow]
    return []


class NGramDrafter:
    """The default self-drafter: `ngram_propose` with fixed n-gram
    bounds; stateless, safe to share across slots."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{min_ngram}, {max_ngram}]"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def __call__(self, context: Sequence[int], k: int) -> List[int]:
        return ngram_propose(context, k, max_ngram=self.max_ngram,
                             min_ngram=self.min_ngram)


def make_drafter(spec: Union[str, DrafterFn, None]) -> Optional[DrafterFn]:
    """``"ngram"`` -> `NGramDrafter`, a callable -> itself (the
    draft-model hook), ``None`` -> no drafting."""
    if spec is None:
        return None
    if callable(spec):
        return spec
    if spec == "ngram":
        return NGramDrafter()
    raise ValueError(
        f"spec_draft must be 'ngram', a callable (context, k) -> tokens, "
        f"or None; got {spec!r}"
    )


def plan_window(pending: Sequence[int], last_token: int, width: int,
                max_emit: int, context: Sequence[int], drafter,
                *, max_drafts: Optional[int] = None
                ) -> Tuple[List[int], int, int]:
    """One slot's window inputs: ``(tokens, n_known, n_proposed)`` —
    ``width`` tokens (replay prefix, then drafts, then -1 fill), how many
    positions have known successors, and how many drafts were
    proposed. The same layout as the JAX package's `plan_window`."""
    p = len(pending)
    if p > 0:
        take = min(p, width)
        tokens = [int(t) for t in list(pending)[:take]]
        n_known = min(p - 1, width)
    else:
        tokens = [int(last_token)]
        n_known = 0
    draft_room = width - 1 - n_known
    n_drafts = max(0, min(draft_room, max_emit - 1))
    if max_drafts is not None:
        n_drafts = min(n_drafts, max(0, int(max_drafts)))
    proposals: List[int] = []
    if drafter is not None and n_drafts > 0:
        proposals = [int(t) for t in drafter(context, n_drafts)][:n_drafts]
        tokens.extend(proposals)
    tokens.extend([-1] * (width - len(tokens)))
    return tokens, n_known, len(proposals)


def verify_window(logits: torch.Tensor, tokens: Sequence[int], n_known: int,
                  eos_id: int, generator: Optional[torch.Generator],
                  active: bool, temperature: float, top_k, top_p
                  ) -> Tuple[List[int], int]:
    """Accept/reject over one slot's window logits [W, V] (host side).

    Position ``n_known`` always emits; a later position emits while the
    chain is alive — every earlier draft equalled the target's own
    emission and no emitted token was eos. Returns ``(emitted, count)``:
    ``width`` ints packed from index 0 (zeros past ``count``). The
    generator advances once per EMITTED token (greedy draws none), the
    per-request sampling contract of the JAX package."""
    width = logits.shape[0]
    emitted = [0] * width
    count = 0
    if not active or n_known >= width:
        return emitted, count
    greedy = (torch.argmax(logits, dim=-1).tolist()
              if temperature == 0.0 else None)
    out_prev = None
    for i in range(n_known, width):
        if i > n_known and not (tokens[i] == out_prev and out_prev != eos_id):
            break
        if greedy is not None:
            out_prev = int(greedy[i])
        else:
            out_prev = int(_sample(logits[i][None], generator, temperature,
                                   top_k, top_p)[0])
        emitted[count] = out_prev
        count += 1
    return emitted, count
