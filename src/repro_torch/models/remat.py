"""Rematerialisation of a layer body — the counterpart of the reference's
``jax.remat(body, policy=...)``.

``remat(fn, policy)`` wraps a layer body so that a backward pass
recomputes what the forward did not keep:

  ``full`` — ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``:
             only the body's inputs are kept (``jax.remat`` with no policy);
  ``dots`` — selective checkpointing: the outputs of ``aten.mm`` (the
             projections, products with no batch dims) are kept and
             ``bmm`` and everything else is recomputed
             (``dots_with_no_batch_dims_saveable``);
  ``none`` — the body as it is.

The wrapper checkpoints only while autograd records a graph through the
call (grad mode on and some tensor argument requiring grad), so prefill,
decode and scoring run the body unchanged.
"""
from __future__ import annotations

import functools

import torch

POLICIES = ("full", "dots", "none")


def _records_graph(args) -> bool:
    if not torch.is_grad_enabled():
        return False
    stack = list(args)
    while stack:
        a = stack.pop()
        if isinstance(a, torch.Tensor):
            if a.requires_grad:
                return True
        elif isinstance(a, dict):
            stack.extend(a.values())
        elif isinstance(a, (list, tuple)):
            stack.extend(a)
    return False


def _dots_context():
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def remat(fn, policy: str):
    """``fn`` checkpointed by ``policy`` (one of :data:`POLICIES`)."""
    if policy not in POLICIES:
        raise ValueError(f"remat policy {policy!r}, expected one of "
                         f"{POLICIES}")
    if policy == "none":
        return fn

    @functools.wraps(fn)
    def run(*args):
        if not _records_graph(args):
            return fn(*args)
        from torch.utils.checkpoint import checkpoint
        extra = {"context_fn": _dots_context} if policy == "dots" else {}
        return checkpoint(fn, *args, use_reentrant=False, **extra)

    return run
