"""Shared LM loss — the counterpart of ``repro.models.losses``.

The reference picks the gold logit with a one-hot ``where`` over the
vocab axis (so vocab-sharded logits reduce locally).  On one card that
one-hot is a ``[b, s, vocab]`` fp32 copy (4.3 GB for gemma3-1b at 4 x
1024 tokens); a ``gather`` of the gold logit gives the same value: the
one-hot sum adds exact zeros to that one logit.
"""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels) -> torch.Tensor:
    """Mean CE over positions with label >= 0, in fp32.  logits [b, s, v]
    (any dtype), labels [b, s] int (-1 = ignore).  A label >= v matches
    no vocab entry, as in the reference: its gold logit is 0."""
    lg = logits.float()
    labels = torch.as_tensor(labels, device=lg.device)
    v = lg.shape[-1]
    logz = torch.logsumexp(lg, dim=-1)
    in_vocab = (labels >= 0) & (labels < v)
    gold = torch.gather(lg, -1, labels.clamp(0, v - 1).long()[..., None]
                        )[..., 0]
    gold = torch.where(in_vocab, gold, torch.zeros((), device=lg.device))
    mask = labels >= 0
    ce = torch.where(mask, logz - gold, torch.zeros((), device=lg.device))
    return ce.sum() / mask.sum().clamp(min=1)
