"""Optimizer substrate: AdamW with cosine / WSD (warmup-stable-decay,
MiniCPM) / constant schedules and global-norm gradient clipping — the
counterpart of ``repro.training.optimizer``.

State is ``{"m", "v", "step"}``: ``m`` and ``v`` are fp32 trees matching
the parameters, ``step`` an int32 scalar, all on the parameters' device.
The rounding points are the reference's: the schedule and the bias
corrections ``1 - b ** step`` are fp32 tensor arithmetic on the int32
step, the clip scales in fp32 and casts back to the gradient's dtype,
and the update runs in fp32 and casts to the parameter's dtype.
Divisions by a schedule constant divide by an fp32 tensor: on a CUDA
tensor torch turns a division by a Python scalar into a multiplication
by its reciprocal, which rounds differently.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from .tree import leaves, tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"          # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    wsd_decay_frac: float = 0.1       # MiniCPM: final 10% exponential decay
    min_lr_ratio: float = 0.1


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def schedule_lr(step, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor or int), an fp32
    scalar tensor on the step's device."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / _f32(max(cfg.warmup_steps, 1), s), max=1.0)
    if cfg.schedule == "const":
        post = _f32(1.0, s)
    elif cfg.schedule == "cosine":
        frac = torch.clamp((s - cfg.warmup_steps)
                           / _f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                                  s), 0.0, 1.0)
        post = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "wsd":
        decay_start = cfg.total_steps * (1 - cfg.wsd_decay_frac)
        frac = torch.clamp((s - decay_start)
                           / _f32(max(cfg.total_steps - decay_start, 1), s),
                           0.0, 1.0)
        post = torch.exp(torch.log(_f32(max(cfg.min_lr_ratio, 1e-6), s))
                         * frac)
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * post


def init_opt_state(params: Params) -> Dict[str, Any]:
    """Zero fp32 moments beside every parameter and an int32 step."""
    first = leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def abstract_opt_state(param_specs: Params) -> Dict[str, Any]:
    """The optimizer state's shapes and dtypes without memory: tensors on
    the ``meta`` device, from parameter specs or tensors (anything with
    a ``shape``)."""
    meta = lambda p: torch.empty(tuple(p.shape), dtype=torch.float32,
                                 device="meta")
    return {"m": tree_map(meta, param_specs),
            "v": tree_map(meta, param_specs),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    gn = global_norm(grads)
    scale = torch.clamp(_f32(max_norm, gn) / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: Dict[str, Any],
                 cfg: OptConfig
                 ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  ``params`` and the moments are updated in place;
    returns ``(params, {"m", "v", "step"}, {"lr", "grad_norm"})`` as the
    reference does.  Weight decay applies to every leaf."""
    step = state["step"] + 1
    lr = schedule_lr(step, cfg)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.float()
    bc1 = 1 - b1 ** sf
    bc2 = 1 - b2 ** sf
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        gf = g.float()
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf * gf)
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
