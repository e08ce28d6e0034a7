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

Plain tensors (serving, training on one card) take the kept assignments
of :func:`dispatch`, a boolean mask.  A ``DTensor`` or a fake tensor (a
step on a mesh, the dry run) cannot hold that data-dependent size, so it
takes the reference's fixed-shape form (:func:`local_dispatch`): a
dropped assignment adds zeros at row 0 of expert 0 and gathers back
masked to zero.  :func:`moe_local` sorts each data-parallel block's
assignments alone, in the fixed-shape form.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..distributed.hints import constrain, dp_axes, mesh_axis_size
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


def _router(xt: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """``(expert_ids [..., k], gates [..., k], probs [..., E])`` of ``xt
    [..., d]``, the gates renormalized over the top k."""
    probs = torch.softmax(torch.matmul(xt.float(), router), dim=-1)
    gates, ids = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    return ids, gates, probs


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """The routing of ``xt [t, d]``: ``(expert_ids [t, k], gates [t, k],
    probs [t, E], kept, slot)`` (``kept`` and ``slot`` as
    :func:`dispatch` gives them)."""
    ids, gates, probs = _router(xt, router, cfg)
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


def local_dispatch(ids: torch.Tensor, gates: torch.Tensor, cap: int,
                   n_experts: int):
    """The fixed-shape capacity dispatch of ``expert_ids [nb, tb, k]``,
    block by block: each block's assignments sorted by expert (stably),
    ``(se, sg, stok, keep, pos)`` each ``[nb, tb * k]`` in that order:
    the expert, the gate, the token within the block, whether the
    capacity ``cap`` keeps it and its row in its expert's buffer."""
    nb, tb, k = ids.shape
    flat_e = ids.reshape(nb, tb * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    sg = torch.gather(gates.reshape(nb, tb * k), 1, order)
    stok = order // k
    counts = torch.zeros((nb, n_experts), dtype=torch.long,
                         device=ids.device).scatter_add(
        1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 1) - counts
    pos = torch.arange(tb * k, device=ids.device)[None, :] \
        - torch.gather(starts, 1, se)
    return se, sg, stok, pos < cap, pos


def _fixed_shapes(x: torch.Tensor) -> bool:
    """Whether ``x`` needs the fixed-shape dispatch: a ``DTensor`` or a
    fake tensor, neither of which takes a boolean-mask index."""
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(x):
        return True
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def moe(x: torch.Tensor, p: Params, cfg: ArchConfig
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, s, d] -> (y [b, s, d], aux_loss scalar fp32)."""
    if _fixed_shapes(x):
        return _moe_blocks(x, p, cfg, 1)
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
    """Block-local dispatch (the reference's ``localdisp`` variant): the
    token -> expert sort runs independently inside each of the ``nb``
    data-parallel blocks of the registered mesh, so routing needs only the
    expert-parallel exchange of the dispatch buffers, not a global sort
    over the ``t * k`` token ids.

    Semantics vs :func:`moe`: the same routing, the same auxiliary loss;
    the capacity ``_capacity(t / nb)`` is enforced per block, which drops
    more tokens under skewed routing.  Without a data-parallel mesh of
    ``nb > 1`` blocks dividing ``t = b * s`` it is :func:`moe`, as in the
    reference."""
    b, s, _ = x.shape
    dp = dp_axes()
    nb = mesh_axis_size(dp) if dp is not None else 1
    if (b * s) % nb != 0 or nb <= 1:
        return moe(x, p, cfg)
    return _moe_blocks(x, p, cfg, nb)


def _moe_blocks(x: torch.Tensor, p: Params, cfg: ArchConfig, nb: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fixed-shape MoE over ``nb`` blocks of ``x [b, s, d]`` (``nb``
    divides ``b * s``), each block dispatched alone with the capacity of
    its ``b * s / nb`` tokens: the reference's ``moe`` at ``nb = 1``, its
    ``moe_local`` above."""
    b, s, d = x.shape
    tb = b * s // nb
    e = cfg.n_experts
    dp = dp_axes()
    xt = x.reshape(nb, tb, d)
    if nb > 1:
        xt = constrain(xt, dp, None, None)
        spec = (dp, None, None, None)
    elif dp is not None and e % mesh_axis_size(dp) == 0:
        # EP: experts over the dp axes when they divide E, else capacity
        # over 'data'
        spec = (None, dp, None, None)
    else:
        spec = (None, None, "data", None)
    ids, gates, probs = _router(xt, p["router"], cfg)
    flat = ids.reshape(-1)
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=x.device)) / flat.numel()
    aux = e * torch.sum(probs.reshape(-1, e).mean(0) * ce)

    cap = _capacity(tb, cfg)
    se, sg, stok, keep, pos = local_dispatch(ids, gates, cap, e)
    blk = torch.arange(nb, device=x.device)[:, None].expand_as(se)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    # a dropped assignment adds zeros at row 0 of its block's expert 0
    buf = torch.zeros((nb, e, cap, d), dtype=x.dtype, device=x.device
                      ).index_put((blk, se * keep, pos * keep),
                                  torch.where(keep[..., None],
                                              xt[blk, stok], zero),
                                  accumulate=True)
    buf = constrain(buf, *spec)

    # expert FFN, [nb, E, cap, d] against the [E, d, f] stacks
    h = silu(torch.matmul(buf, p["w_gate"]))
    h = h * torch.matmul(buf, p["w_up"])
    out_buf = torch.matmul(h, p["w_down"])

    vals = torch.where(keep[..., None],
                       out_buf[blk, se * keep, pos * keep].float(),
                       torch.zeros((), device=x.device))
    yt = torch.zeros((nb * tb, d), dtype=torch.float32, device=x.device
                     ).index_add(0, (blk * tb + stok).reshape(-1),
                                 (vals * sg[..., None]).reshape(-1, d))
    y = yt.to(x.dtype).reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + mlp(x, p["shared"])
    return y, aux
