"""Mixture-of-Experts layer: top-k routing with sort-based capacity
dispatch — the counterpart of ``repro.models.moe``.

Token -> expert assignments are sorted by expert id (a stable sort, so
the capacity drops pick the same assignments as the reference's
``jnp.argsort``), each assignment's position within its expert is its
rank minus the start of its expert's group, assignments past the
capacity are dropped, the kept tokens land in a dense ``[E, cap, d]``
buffer, the experts run as one batched ``torch.matmul`` over it (the
reference leaves this product to XLA, outside any Pallas kernel), and the
results gather back weighted by the renormalized router gates.  Shared
experts (qwen2-moe: 4 shared + 60 routed top-4) are one plain MLP of
``n_shared_experts * d_expert`` width added on top, and the Switch-style
auxiliary load-balancing loss comes back beside the output.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .common import ArchConfig, Spec
from .layers import mlp, mlp_specs, silu

Params = Dict[str, torch.Tensor]


def moe_specs(cfg: ArchConfig) -> Params:
    d, fe = cfg.d_model, cfg.d_expert
    dt = cfg.compute_dtype
    out = {
        "router": Spec((d, cfg.n_experts), torch.float32),
        "w_gate": Spec((cfg.n_experts, d, fe), dt),
        "w_up": Spec((cfg.n_experts, d, fe), dt),
        "w_down": Spec((cfg.n_experts, fe, d), dt),
    }
    if cfg.n_shared_experts:
        out["shared"] = mlp_specs(cfg,
                                  d_ff=cfg.n_shared_experts * cfg.d_expert)
    return out


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)           # round up to 8


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """The routing of ``xt [t, d]``: ``(expert_ids [t, k], gates [t, k],
    probs [t, E], kept, slot)`` (``kept`` and ``slot`` as
    :func:`dispatch` gives them)."""
    probs = torch.softmax(torch.matmul(xt.float(), router), dim=-1)
    gates, ids = torch.topk(probs, cfg.top_k, dim=-1)   # [t, k]
    gates = gates / gates.sum(-1, keepdim=True)
    return (ids, gates, probs) + dispatch(ids, cfg)


def dispatch(ids: torch.Tensor, cfg: ArchConfig):
    """The capacity dispatch of ``expert_ids [t, k]``: ``(kept, slot)``.
    ``kept`` lists the assignments the capacity keeps (flat index
    ``token * k + j``) in expert order, stable within an expert; ``slot``
    is each one's row in its expert's buffer."""
    t, k = ids.shape
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.bincount(se, minlength=cfg.n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=ids.device) - starts[se]
    keep = pos_in_e < _capacity(t, cfg)                 # capacity drop
    return order[keep], pos_in_e[keep]


def moe(x: torch.Tensor, p: Params, cfg: ArchConfig
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, s, d] -> (y [b, s, d], aux_loss scalar fp32)."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.top_k, cfg.n_experts
    xt = x.reshape(t, d)
    ids, gates, probs, kept, slot = route(xt, p["router"], cfg)

    # Switch-style aux loss: E * sum_e f_e * p_e
    ce = torch.bincount(ids.reshape(-1), minlength=e).float() / (t * k)
    aux = e * torch.sum(probs.mean(0) * ce)

    # --- dispatch the kept assignments into [E, cap, d] ------------------
    se = ids.reshape(-1)[kept]
    stok = kept // k
    buf = torch.zeros((e, _capacity(t, cfg), d), dtype=x.dtype,
                      device=x.device)
    buf[se, slot] = xt[stok]

    # --- batched expert FFN ----------------------------------------------
    h = silu(torch.matmul(buf, p["w_gate"]))
    h = h * torch.matmul(buf, p["w_up"])
    out_buf = torch.matmul(h, p["w_down"])

    # --- gather back, weighted by the gates ------------------------------
    vals = out_buf[se, slot].float() * gates.reshape(-1)[kept, None]
    yt = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    yt.index_add_(0, stok, vals)
    y = yt.to(x.dtype).reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + mlp(x, p["shared"])
    return y, aux


def moe_local(x: torch.Tensor, p: Params, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's block-local dispatch falls back to :func:`moe`
    without a data-parallel mesh (``repro.models.moe.moe_local``); on one
    card that is the call.  The block-local form needs the training
    slice's mesh utilities (ROADMAP Queue A item 13d)."""
    return moe(x, p, cfg)
