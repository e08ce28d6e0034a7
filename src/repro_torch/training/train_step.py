"""Training step factory: microbatched gradient accumulation + AdamW —
the counterpart of ``repro.training.train_step``.

``make_train_step(model, opt_cfg, accum_steps)`` returns
``train_step(state, batch) -> (state, metrics)``.  Gradients come from
``torch.autograd`` on detached copies of the parameter leaves (sharing
their storage), and AdamW then updates the parameters and moments in
place.  With ``accum_steps > 1`` the batch is split along axis 0 into
microbatches, run one after another in a Python loop (the reference's
``lax.scan``), their gradients summed into fp32 zeros, and the loss and
gradients divided by ``accum_steps``; with one step the gradients keep
the parameters' dtype, as ``jax.value_and_grad`` gives them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..distributed.hints import constrain, dp_axes
from .optimizer import OptConfig, adamw_update, init_opt_state
from .tree import leaves, unflatten_like

TrainState = Dict[str, Any]        # {params, opt: {m, v, step}}


def init_train_state(params) -> TrainState:
    return {"params": params, "opt": init_opt_state(params)}


def loss_and_grads(model, params, batch) -> Tuple[torch.Tensor, Any]:
    """``(loss, grads)`` of ``model.loss`` at ``params``: the loss
    detached, the gradients a tree like ``params`` in its dtypes (zeros
    for a leaf the loss does not reach, as JAX gives them)."""
    ps = leaves(params)
    live = [p.detach().requires_grad_() for p in ps]
    loss = model.loss(unflatten_like(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), unflatten_like(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)])


def _microbatches(batch, accum_steps: int):
    n = len(next(iter(batch.values())))
    if n % accum_steps:
        raise ValueError(f"a batch of {n} rows does not split into "
                         f"{accum_steps} microbatches")
    dp = dp_axes()
    micro = {k: constrain(v.reshape((accum_steps, n // accum_steps)
                                    + tuple(v.shape[1:])), None, dp)
             for k, v in batch.items()}
    return [{k: v[i] for k, v in micro.items()} for i in range(accum_steps)]


def make_train_step(model, opt_cfg: OptConfig, accum_steps: int = 1):
    """Build the train step (see the module docstring)."""

    def train_step(state: TrainState, batch: Dict[str, Any]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state["params"]
        if accum_steps == 1:
            loss, grads = loss_and_grads(model, params, batch)
        else:
            ps = leaves(params)
            # zeros_like keeps a DTensor parameter's placements
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
            loss = torch.zeros((), dtype=torch.float32, device=ps[0].device)
            for mb in _microbatches(batch, accum_steps):
                l, g = loss_and_grads(model, params, mb)
                loss = loss + l
                for a, gi in zip(acc, leaves(g)):
                    a.add_(gi.float())
                del g
            loss = loss / accum_steps
            grads = unflatten_like(params, [a / accum_steps for a in acc])
        new_params, opt, om = adamw_update(params, grads, state["opt"],
                                           opt_cfg)
        metrics = {"loss": loss, **om}
        return {"params": new_params, "opt": opt}, metrics

    return train_step
