"""The decode window: host-side planning and the accept/reject pass —
counterpart of tf_yarn_tpu/models/spec.py (`plan_window`,
`verify_window`).

The fused paged tick runs the windowed program even without drafts, at
width 1: a slot replaying its prompt feeds one known token (no
emission), a decoding slot feeds its last token and emits one. The
acceptance rule is the JAX package's token matching, so when drafts do
arrive (a later slice) every emitted token is the target's own.
Self-drafting (`NGramDrafter`) is still to port (ROADMAP.md Queue 1,
decode engine); `make_drafter` takes only ``None``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from tf_yarn_tpu_torch.models.generate import _sample


def make_drafter(spec):
    """``None`` -> no drafting (the spec_k = 0 tick). Drafters are still
    to port."""
    if spec is None:
        return None
    raise NotImplementedError(
        "speculative drafters (spec_k > 0) are still to port "
        "(ROADMAP.md Queue 1, decode engine)"
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
