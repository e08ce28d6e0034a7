"""Per-architecture sharding rules (DP / TP / EP / SP) for the production
meshes — the counterpart of ``repro.distributed.sharding``.

The rules are the reference's, rule for rule: ``(param path, shape)`` ->
a partition spec, one entry per tensor dimension (a mesh-dimension name,
a tuple of names, or None = replicated), sharding a dimension only when
the mesh axis size divides it.  Conventions:

* batch-like leading dims     -> ('pod', 'data') [dp axes]
* vocab/embedding rows        -> 'model'
* attention q/kv projections  -> output (head) dim over 'model', whole
  heads only
* attention/mlp output projs  -> input dim over 'model' (Megatron pairing)
* MoE expert stacks [L,E,D,F] -> E over the dp axes when divisible (EP), F
  over 'model' (TP within an expert)
* mamba channel dims (d_inner)-> 'model' (channel-parallel SSM)
* caches                      -> batch over dp; kv-heads over 'model' when
  asked (``decode_shard="heads"``), else the longest axis (SP)

A spec is a plain tuple (the reference's ``PartitionSpec`` entries).
``to_placements`` maps it to the ``DTensor`` placements of a
``DeviceMesh``: a tensor dim named by a mesh dimension is ``Shard(dim)``
there, a tuple ``("pod", "data")`` is one ``Shard(dim)`` on each of those
mesh dimensions (pod-major, as a ``PartitionSpec`` splits it), and every
other mesh dimension is ``Replicate()``.  A mesh argument is a
``DeviceMesh`` or a mapping ``{name: size}`` (the counterpart of JAX's
``AbstractMesh``: the rules read only the axis sizes).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from ..models.common import ArchConfig
from ..training.tree import leaves_with_paths, tree_map, unflatten_like

Params = Any
PSpec = Tuple[Any, ...]

# The port's K/V caches are [L, b, n_kv, smax, hd]: kv-heads sit third from
# the end, where the reference's [L, b, smax, n_kv, hd] has them second.
PORT_KV_HEADS_AXIS = -3
_KV_LEAVES = ("k", "v", "xk", "xv")


def axis_sizes(mesh) -> Dict[str, int]:
    """``{name: size}`` of a ``DeviceMesh`` or a mapping, in mesh order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def _axis_size(mesh, name) -> int:
    sizes = axis_sizes(mesh)
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= sizes[n]
        return out
    return sizes[name]


def dp_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axis names (with 'pod' when present)."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _fits(dim: int, mesh, axis) -> bool:
    return dim % _axis_size(mesh, axis) == 0


def _maybe(dim: int, mesh, axis):
    """axis if it divides dim else None (replicate)."""
    return axis if _fits(dim, mesh, axis) else None


def _expert_axes(e: int, mesh):
    """Largest dp-axis combination that divides the expert count."""
    if "pod" in axis_sizes(mesh):
        cands = [("pod", "data"), ("data",), ("pod",)]
    else:
        cands = [("data",)]
    for c in cands:
        if _fits(e, mesh, c):
            return c if len(c) > 1 else c[0]
    return None


def _none(n: int) -> list:
    return [None] * n


def param_pspec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
                cfg: ArchConfig) -> PSpec:
    """Pattern-matched partition spec for one parameter leaf."""
    name = path[-1]
    shape = tuple(shape)

    # ---- embeddings: vocab over model ------------------------------------
    if name in ("embedding", "unembed"):
        return (_maybe(shape[0], mesh, "model"), None)

    # ---- MoE ---------------------------------------------------------------
    if "ffn" in path and name == "router":
        return tuple(_none(len(shape)))
    if "ffn" in path and name in ("w_gate", "w_up", "w_down") \
            and len(shape) == 4:
        # [L, E, D, F] (w_down: [L, E, F, D])
        e_ax = _expert_axes(shape[1], mesh)
        if name == "w_down":
            return (None, e_ax, _maybe(shape[2], mesh, "model"), None)
        return (None, e_ax, None, _maybe(shape[3], mesh, "model"))

    # ---- attention: whole heads only (a head split across devices makes
    # the softmax contraction partial); replicate when heads don't divide --
    if name in ("wq", "wk", "wv"):
        heads = cfg.n_kv if name in ("wk", "wv") else cfg.n_heads
        ax = "model" if (heads % _axis_size(mesh, "model") == 0
                         and _fits(shape[-1], mesh, "model")) else None
        return tuple(_none(len(shape) - 2) + [None, ax])
    if name == "wo":
        ax = "model" if (cfg.n_heads % _axis_size(mesh, "model") == 0
                         and _fits(shape[-2], mesh, "model")) else None
        return tuple(_none(len(shape) - 2) + [ax, None])

    # ---- dense / shared-expert MLP -----------------------------------------
    if name in ("w_gate", "w_up", "in_proj", "dt_proj", "conv_w"):
        return tuple(_none(len(shape) - 2)
                     + [None, _maybe(shape[-1], mesh, "model")])
    if name in ("w_down", "x_proj", "out_proj"):
        return tuple(_none(len(shape) - 2)
                     + [_maybe(shape[-2], mesh, "model"), None])

    # ---- SSM per-channel vectors (channel-parallel over d_inner) ------------
    if name in ("conv_b", "dt_bias", "d_skip") and shape[-1] >= 128:
        return tuple(_none(len(shape) - 1)
                     + [_maybe(shape[-1], mesh, "model")])
    if name == "a_log" and len(shape) >= 2 and shape[-2] >= 128:
        return tuple(_none(len(shape) - 2)
                     + [_maybe(shape[-2], mesh, "model"), None])

    # ---- norms / scalars: replicated ----------------------------------------
    return tuple(_none(len(shape)))


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape)


def spec_at(specs: Params, path: Tuple) -> PSpec:
    """The spec at ``path`` of a spec tree (its leaves are tuples, so the
    tree is walked by the path of the tensor tree it mirrors)."""
    for k in path:
        specs = specs[k]
    return specs


def params_shardings(specs: Params, mesh, cfg: ArchConfig) -> Params:
    """Partition specs for a parameter tree (of ``Spec``s or tensors) by
    the ``param_pspec`` rules."""
    flat = leaves_with_paths(specs)
    return unflatten_like(specs, [
        param_pspec(tuple(str(k) for k in path), _shape(leaf), mesh, cfg)
        for path, leaf in flat])


def _used(pspec) -> set:
    used = set()
    for s in pspec:
        if s is not None:
            used.update(s if isinstance(s, tuple) else (s,))
    return used


def opt_state_shardings(param_shardings: Params, mesh,
                        param_specs: Params) -> Params:
    """AdamW m/v: the parameter's spec plus ZeRO-1 — shard the largest
    still-replicated dimension over the data axes, skipping leaves that
    already use a dp axis (an axis may appear in a spec only once).  The
    moments are touched only inside the update, so the extra split costs
    one reduce-scatter / all-gather pair per step and cuts fp32 m/v memory
    by the dp degree."""
    dp = dp_axes(mesh)
    dp_name = dp if len(dp) > 1 else dp[0]
    dp_size = _axis_size(mesh, dp)

    def zero1(spec, leaf):
        shape = _shape(leaf)
        pspec = list(spec) + [None] * (len(shape) - len(spec))
        if _used(pspec) & set(dp):
            return tuple(spec)
        cands = [i for i in range(len(shape))
                 if pspec[i] is None and shape[i] % dp_size == 0
                 and shape[i] >= dp_size]
        if cands:
            best = max(cands, key=lambda i: shape[i])
            pspec[best] = dp_name
        return tuple(pspec)

    mv = unflatten_like(param_specs, [
        zero1(spec_at(param_shardings, path), leaf)
        for path, leaf in leaves_with_paths(param_specs)])
    return {"m": mv, "v": mv, "step": ()}


def batch_shardings(mesh, batch_spec: Params) -> Params:
    """Batch tree specs: leading dim over the dp axes when it divides,
    replicated otherwise."""
    dp = dp_axes(mesh)
    dp_name = dp if len(dp) > 1 else dp[0]

    def one(leaf):
        shape = _shape(leaf)
        if shape and shape[0] % _axis_size(mesh, dp) == 0:
            return (dp_name,) + tuple(_none(len(shape) - 1))
        return tuple(_none(len(shape)))

    return tree_map(one, batch_spec)


def cache_shardings(mesh, cache_spec: Params, cfg: ArchConfig,
                    kv_heads_axis: int = -2) -> Params:
    """KV / state caches: batch over dp, then heads or the longest axis
    over 'model'.  The batch axis is the reference's: the first axis at or
    after 1 that the dp size divides.  ``kv_heads_axis`` is where the
    K/V leaves (``k``, ``v``, ``xk``, ``xv``) hold their kv-heads, counted
    from the end: -2 on the reference's ``[., B, S, KV, HD]``,
    ``PORT_KV_HEADS_AXIS`` on the port's ``[., B, KV, S, HD]``; any other
    leaf of four or more dims uses -2, as the reference does."""
    dp = dp_axes(mesh)
    dp_name = dp if len(dp) > 1 else dp[0]
    dp_size = _axis_size(mesh, dp)
    model = _axis_size(mesh, "model")

    def one(path, leaf):
        shape = _shape(leaf)
        spec = [None] * len(shape)
        for i in range(1, len(shape)):
            if shape[i] % dp_size == 0 and shape[i] >= dp_size:
                spec[i] = dp_name
                break
        cand = [i for i in range(1, len(shape))
                if spec[i] is None and shape[i] % model == 0
                and shape[i] >= model]
        if cand:
            heads = len(shape) + (kv_heads_axis if path
                                  and path[-1] in _KV_LEAVES else -2)
            if cfg.decode_shard == "heads" and len(shape) >= 4 \
                    and heads in cand:
                big = heads
            else:                              # auto/seq: the largest axis
                big = max(cand, key=lambda i: shape[i])
            spec[big] = "model"
        return tuple(spec)

    flat = leaves_with_paths(cache_spec)
    return unflatten_like(cache_spec, [one(p, leaf) for p, leaf in flat])


def replicated(mesh, spec: Params) -> Params:
    """Fully replicated specs for every leaf of ``spec``."""
    return tree_map(lambda leaf: tuple(_none(len(_shape(leaf)))), spec)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------
def to_placements(spec: PSpec, mesh) -> tuple:
    """The ``DTensor`` placements, one per mesh dimension of the
    ``DeviceMesh`` ``mesh``, that realise the partition spec ``spec``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    seen = set()
    for dim, s in enumerate(spec):
        if s is None:
            continue
        for a in (s if isinstance(s, tuple) else (s,)):
            if a in seen:
                raise ValueError(f"mesh axis {a!r} appears twice in {spec}")
            seen.add(a)
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def distribute_tree(tree: Params, specs: Params, mesh) -> Params:
    """``tree``'s tensors as ``DTensor``s on ``mesh``, each placed by its
    partition spec in ``specs`` (a tree of the same structure).  On a
    real mesh each rank keeps its shard of the tensor it was given; under
    ``FakeTensorMode`` the shards are fake."""
    from torch.distributed.tensor import distribute_tensor
    return unflatten_like(tree, [
        distribute_tensor(t, mesh, to_placements(spec_at(specs, path), mesh))
        for path, t in leaves_with_paths(tree)])

