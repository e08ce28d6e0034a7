"""Multi-pod dry run: run every (architecture x input shape x mesh) cell
of the production meshes — (data=16, model=16) single pod and (pod=2,
data=16, model=16) = 512 ranks — on fake devices, and record memory,
cost, collectives and the roofline.  The counterpart of
``repro.launch.dryrun``.

Where the reference compiles a cell for 512 faked XLA devices, the port
runs it once, eagerly, in one process on a ``fake`` process group of the
mesh's world size, under ``FakeTensorMode``, so nothing is allocated:

* parameters, optimizer state, batch and cache are ``DTensor``s placed
  by ``distributed/sharding.py`` on a ``DeviceMesh`` of the fake group;
* the port's model and training code runs unchanged under
  ``implicit_replication()`` (tensors it makes inside — positions, masks,
  MoE buffers — count as replicated) with ``use_mesh_hints`` active;
* ``hlo_analysis.CostCounter`` sees the local ops and collectives one
  rank runs, and the live bytes of its local shards.

Where ``DTensor`` has no usable sharding rule for an op under fake
tensors, this layer alone gives it one for the duration of a cell
(``_dryrun_strategies``; the model's math is untouched): ``gather`` on a
sharded dim and ``index_put`` into a sharded indexed dim; views, pads
and scatters that need a redistribution get the exact fallbacks of
``dtensor_fallbacks``, as GSPMD reshards (a ``DTensor`` step on a real
mesh uses those too).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k --mesh pod1
  python -m repro_torch.launch.dryrun --all          # every cell, one subprocess each
  python -m repro_torch.launch.dryrun --all --filter train_4k
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict

import torch

from ..configs import ARCH_IDS, SHAPES, cell_supported, get_config
from ..configs.shapes import ShapeSpec
from ..distributed import hints
from ..distributed.hlo_analysis import (CostCounter, collective_bytes,
                                        depth_delta, flops_and_bytes,
                                        roofline_terms)
from ..distributed.sharding import (PORT_KV_HEADS_AXIS, batch_shardings,
                                    cache_shardings, distribute_tree,
                                    opt_state_shardings, params_shardings)
from ..models import build_model
from ..models.common import ArchConfig, init_params
from ..training.optimizer import OptConfig
from ..training.train_step import make_train_step
from .mesh import HW, make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# The dry run's tensors are fake and live on the host's fake device: the
# models' plain twins run there (B5's decode attention included), by
# design, not as a fallback.
DEVICE = "cpu"


# ---------------------------------------------------------------------------
def with_depth(cfg: ArchConfig, units: int) -> ArchConfig:
    """Same width, reduced depth (for the depth-delta roofline method)."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=units * cfg.attn_every)
    if cfg.family in ("encdec", "audio"):
        return dataclasses.replace(cfg, n_layers=units, n_enc_layers=units)
    return dataclasses.replace(cfg, n_layers=units)


def depth_units(cfg: ArchConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def input_specs(cfg: ArchConfig, shape: ShapeSpec, model) -> Dict[str, Any]:
    """Every model input as a tensor (fake under ``FakeTensorMode``)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    n_tok = s - (cfg.n_patches or 0)
    zeros = lambda *sh, dt=torch.float32: torch.zeros(sh, dtype=dt)  # noqa: E731
    extra = None
    if cfg.family in ("audio", "encdec"):
        extra = zeros(b, cfg.n_frames, cfg.d_model)
    elif cfg.n_patches:
        extra = zeros(b, cfg.n_patches, cfg.d_model)
    if shape.kind == "train":
        batch = {"tokens": zeros(b, n_tok, dt=i32),
                 "labels": zeros(b, n_tok, dt=i32)}
        if extra is not None:
            batch["frames" if cfg.family in ("audio", "encdec")
                  else "patches"] = extra
        return {"batch": batch}
    cache = model.init_cache(b, s, device=DEVICE)
    if shape.kind == "prefill":
        out = {"tokens": zeros(b, n_tok, dt=i32), "cache": cache}
        if extra is not None:
            out["extra"] = extra
        return out
    # decode: one new token against a seq_len KV cache
    return {"token": zeros(b, 1, dt=i32), "cache": cache,
            "pos": zeros(b, dt=i32)}


# ---------------------------------------------------------------------------
# DTensor: views that need a redistribution
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def swap_strategies(table: Dict[Any, Any], static_from: Dict[Any, int] = None):
    """For the with-block, give each ``aten`` op in ``table`` the sharding
    strategy ``table[op](op_schema) -> OpStrategy`` in place of
    ``DTensor``'s own (an op-level or a single-mesh-dim rule), and clear
    the propagation cache on both sides, so no other ``DTensor`` code
    sees the swap.  ``static_from[op]`` is the first argument that keys
    the cache (the dims of a flip, the widths of a pad) where ``DTensor``
    registers none."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    prop = DTensor._op_dispatcher.sharding_propagator
    single = getattr(prop, "op_single_dim_strategy_funcs", {})
    saved = {op: (prop.op_strategy_funcs.get(op), single.get(op),
                  prop.op_to_schema_info.get(op)) for op in table}
    for op, fn in table.items():
        prop.op_strategy_funcs[op] = fn
        single.pop(op, None)
        if op in (static_from or {}) and op not in prop.op_to_schema_info:
            prop.op_to_schema_info[op] = RuntimeSchemaInfo(static_from[op])
    prop.propagate_op_sharding.cache_clear()
    try:
        yield
    finally:
        for op, (func, one, info) in saved.items():
            prop.op_strategy_funcs.pop(op, None)
            prop.op_to_schema_info.pop(op, None)
            if func is not None:
                prop.op_strategy_funcs[op] = func
            if one is not None:
                single[op] = one
            if info is not None:
                prop.op_to_schema_info[op] = info
        prop.propagate_op_sharding.cache_clear()


def _reshards(err: RuntimeError) -> bool:
    """Whether DTensor's view rule refused ``err`` for want of a
    redistribution."""
    msg = str(err)
    return "unevenly" in msg or "redistribut" in msg


def _view_strategy(native):
    """A view or reshape that would split a sharded dim unevenly (heads
    sharded 4 ways regrouped as 2 kv-heads x g), or of an input with one
    dim sharded over several mesh dims, or a strict view (``view``,
    ``_unsafe_view`` in some torch versions) that would flatten a sharded
    dim: the offending mesh dims replicate the input first, last mesh dim
    first, as GSPMD reshards.  ``DTensor``'s own rule raises on the first
    and the last and gives a wrong local shape on the second."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import (OpSchema, OpSpec,
                                                     OpStrategy)
    from torch.distributed.tensor._ops.utils import (
        generate_redistribute_costs)

    def strategy(op_schema):
        inp = op_schema.args_schema[0]
        src = inp.strategies[0].output_spec
        pl = list(src.placements)
        shards = [p.dim for p in pl if isinstance(p, Shard)]
        err = None
        if len(shards) == len(set(shards)):
            try:
                return native(op_schema)
            except RuntimeError as e:
                if not _reshards(e):
                    raise
                err = e
        for i in reversed(range(len(pl))):
            if isinstance(pl[i], Replicate):
                continue
            pl[i] = Replicate()
            cand = OpStrategy([OpSpec(DTensorSpec(
                src.mesh, tuple(pl), tensor_meta=src.tensor_meta))])
            schema = OpSchema(op_schema.op,
                              (cand,) + tuple(op_schema.args_schema[1:]),
                              op_schema.kwargs_schema)
            try:
                out = native(schema)
            except RuntimeError as e:
                if not _reshards(e):
                    raise
                continue
            for spec in out.strategies:
                spec.redistribute_cost = [generate_redistribute_costs(
                    inp, spec.input_specs[0])]
            return out
        raise err or RuntimeError(f"no layout for {op_schema}")
    return strategy


def index_put_strategy(op_schema, masked: bool = False):
    """``index_put`` (and its in-place forms) on any placements: the index
    tensors replicate, a dim that is sharded and indexed replicates (kept
    sharded when ``masked``: the dry run's masked local write), and the
    values follow the written tensor's shards on its non-indexed dims, by
    advanced indexing's layout (the index dims replace a contiguous block
    of indexed dims in place, else go first).  ``DTensor``'s own rule
    fails on a negative values offset in some torch versions."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import (
        generate_redistribute_costs)
    inp, idx, vals = op_schema.args_schema[:3]
    children = list(getattr(idx, "children", idx))
    index_st = [c for c in children if c is not None]
    indexed = [i for i, c in enumerate(children) if c is not None]
    non_indexed = [d for d in range(inp.ndim) if d not in indexed]
    nb = len(torch.broadcast_shapes(*[c.shape for c in index_st]))
    contiguous = indexed == list(range(indexed[0], indexed[-1] + 1))
    src = inp.strategies[0].output_spec
    mesh = src.mesh
    v_spec = vals.strategies[0].output_spec
    rep = [DTensorSpec(mesh, (Replicate(),) * mesh.ndim,
                       tensor_meta=c.strategies[0].output_spec.tensor_meta)
           for c in index_st]
    out = OpStrategy([])
    for spec in inp.strategies:
        pl, v_pl = [], []
        for p in spec.output_spec.placements:
            if isinstance(p, Shard) and p.dim in non_indexed:
                if contiguous:
                    vd = p.dim if p.dim < indexed[0] else \
                        p.dim - len(indexed) + nb
                else:
                    vd = nb + non_indexed.index(p.dim)
                vd -= nb + len(non_indexed) - v_spec.ndim
                pl.append(p)
                v_pl.append(Shard(vd) if vd >= 0 and v_spec.shape[vd] > 1
                            else Replicate())
            elif isinstance(p, Shard) and masked:
                pl.append(p)
                v_pl.append(Replicate())
            else:
                pl.append(Replicate())
                v_pl.append(Replicate())
        in_tgt = DTensorSpec(mesh, tuple(pl), tensor_meta=src.tensor_meta)
        v_tgt = DTensorSpec(mesh, tuple(v_pl), tensor_meta=v_spec.tensor_meta)
        costs = [generate_redistribute_costs(inp, in_tgt)]
        costs += [generate_redistribute_costs(c, r)
                  for c, r in zip(index_st, rep)]
        costs.append(generate_redistribute_costs(vals, v_tgt))
        out.strategies.append(OpSpec(
            output_specs=DTensorSpec(mesh, tuple(pl),
                                     tensor_meta=src.tensor_meta),
            input_specs=(in_tgt, *rep, v_tgt), redistribute_cost=costs))
    return out


def _dims_replicated(op_schema, dims):
    """A one-input op whose ``dims`` must not be sharded: those replicate,
    the others keep their shards, a partial sum replicates."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import (
        generate_redistribute_costs)
    inp = op_schema.args_schema[0]
    src = inp.strategies[0].output_spec
    out = OpStrategy([])
    for spec in inp.strategies:
        pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims
                   or not isinstance(p, Shard) else p
                   for p in spec.output_spec.placements)
        tgt = DTensorSpec(src.mesh, pl, tensor_meta=src.tensor_meta)
        out.strategies.append(OpSpec(
            output_specs=DTensorSpec(src.mesh, pl), input_specs=(tgt,),
            redistribute_cost=[generate_redistribute_costs(inp, tgt)]))
    return out


def _pad_strategy(op_schema):
    """``constant_pad_nd``: the padded dims replicate (``DTensor``'s own
    plan fails in some torch versions)."""
    inp, pad = op_schema.args_schema[:2]
    return _dims_replicated(op_schema, {inp.ndim - 1 - i // 2
                                        for i, v in enumerate(pad) if v})


def _flip_strategy(op_schema):
    """``flip``: the flipped dims replicate (some torch versions have no
    rule for it)."""
    inp, dims = op_schema.args_schema[:2]
    return _dims_replicated(op_schema, {d % inp.ndim for d in dims})


@contextlib.contextmanager
def dtensor_fallbacks():
    """For the with-block, ``DTensor`` ops the port's models run that
    ``DTensor`` refuses, or places wrongly, in some torch versions get an
    exact layout that redistributes their inputs, as GSPMD reshards:
    views and reshapes (``_view_strategy``: the attention regroups
    sharded heads), ``index_put`` (``index_put_strategy``: the embedding's
    and the MoE dispatch's scatters), ``constant_pad_nd`` (the SSM's
    causal conv) and ``flip`` (the SSM scans' backward)."""
    from torch.distributed.tensor import DTensor
    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator
    table = {op: _view_strategy(prop.op_strategy_funcs[op])
             for op in (aten.view.default, aten._unsafe_view.default,
                        aten.reshape.default)}
    for op in (aten.index_put.default, aten.index_put_.default,
               aten._index_put_impl_.default):
        table[op] = index_put_strategy
    table[aten.constant_pad_nd.default] = _pad_strategy
    table[aten.flip.default] = _flip_strategy
    with swap_strategies(table, {aten.constant_pad_nd.default: 1,
                                 aten.flip.default: 1}):
        yield


# ---------------------------------------------------------------------------
def _gather_strategy(op_schema):
    """``gather`` over a dim its input is sharded on: a local gather whose
    output is a ``Partial`` sum (each rank's out-of-shard picks count 0 on
    a real run).  DTensor's own rule marks it ``_MaskPartial``, whose
    mask buffer cannot be compared or applied under ``FakeTensorMode``;
    the cost — a local gather, then an all-reduce where a consumer needs
    the value — is the same."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy, normalize_dim)
    mesh = op_schema.get_mesh_from_args()
    inp, dim, index = op_schema.args_schema[:3]
    dim = normalize_dim(dim, inp.ndim)
    rows = [[Replicate()] * 3, [Shard(dim), Replicate(), Shard(dim)],
            [Partial(), Shard(dim), Replicate()]]
    if len(inp.shape) == len(index.shape):
        rows += [[Shard(d)] * 3 for d in range(len(inp.shape)) if d != dim]
    return expand_to_full_mesh_op_strategy(mesh, op_schema, rows,
                                           input_index=1)


def _masked_index_put(op_schema):
    """``index_put`` into a dim that is sharded and indexed (a decode
    step's write of one position into a sequence- or batch-sharded cache):
    each rank writes its shard in place from replicated indices and values
    — a masked local write, which moves no shard (a real run would also
    drop the positions outside the rank's shard; a fake run cannot tell).
    ``DTensor`` cannot shard an indexed dim, and an in-place op may not
    change its input's placements."""
    return index_put_strategy(op_schema, masked=True)


@contextlib.contextmanager
def _dryrun_strategies():
    """The exact fallbacks of ``dtensor_fallbacks``, and on top
    of them the dry run's ``gather`` and masked ``index_put`` (above), for
    the with-block."""
    aten = torch.ops.aten
    table = {aten.gather.default: _gather_strategy}
    for op in (aten.index_put.default, aten.index_put_.default,
               aten._index_put_impl_.default):
        table[op] = _masked_index_put
    with dtensor_fallbacks(), swap_strategies(table):
        yield


@contextlib.contextmanager
def _host_strided_offsets():
    """``DTensor``'s ``_StridedShard`` (a sharded dim merged with another
    by a reshape) computes its local offsets from a small host
    ``torch.arange`` and ``.tolist()``; under ``FakeTensorMode`` that
    tensor would be fake and the ``.tolist()`` data-dependent, so the dry
    run computes it with fake mode suspended.  Shapes and placements are
    unchanged."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard
    orig = _StridedShard.local_shard_size_and_offset

    def host(self, *args, **kwargs):
        with unset_fake_temporarily():
            return orig(self, *args, **kwargs)

    _StridedShard.local_shard_size_and_offset = host
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, accum: int = 1):
    """``(fn, args)``: the cell's function and its ``DTensor`` arguments,
    made under the caller's ``FakeTensorMode``."""
    model = build_model(cfg)
    specs = model.param_specs()
    pspec = params_shardings(specs, mesh, cfg)
    params = distribute_tree(init_params(specs, 0, device=DEVICE), pspec,
                             mesh)
    inp = input_specs(cfg, shape, model)

    if shape.kind == "train":
        step = make_train_step(model, OptConfig(total_steps=1000),
                               accum_steps=accum)
        ospec = opt_state_shardings(pspec, mesh, specs)
        f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32)  # noqa: E731
        from ..training.tree import tree_map
        opt = {"m": tree_map(f32, specs), "v": tree_map(f32, specs),
               "step": torch.zeros((), dtype=torch.int32)}
        state = {"params": params, "opt": distribute_tree(opt, ospec, mesh)}
        batch = distribute_tree(inp["batch"],
                                batch_shardings(mesh, inp["batch"]), mesh)
        return step, (state, batch)

    cache = distribute_tree(inp["cache"], cache_shardings(
        mesh, inp["cache"], cfg, kv_heads_axis=PORT_KV_HEADS_AXIS), mesh)
    if shape.kind == "prefill":
        tokens = distribute_tree({"t": inp["tokens"]}, batch_shardings(
            mesh, {"t": inp["tokens"]}), mesh)["t"]
        if "extra" in inp:
            extra = distribute_tree({"e": inp["extra"]}, batch_shardings(
                mesh, {"e": inp["extra"]}), mesh)["e"]
            return model.prefill, (params, tokens, cache, extra)
        return model.prefill, (params, tokens, cache)

    # decode
    small = {"t": inp["token"], "p": inp["pos"]}
    small = distribute_tree(small, batch_shardings(mesh, small), mesh)
    return model.decode_step, (params, small["t"], cache, small["p"])


def compile_cell(cfg: ArchConfig, shape: ShapeSpec, mesh,
                 accum: int = 1) -> Dict[str, Any]:
    """Run one cell on fake local shards and record, per device, its
    memory, cost and collectives (the reference's record, key for key;
    the name is the reference's, though nothing is compiled).

    Memory, from the live fake local shards (``CostCounter``):
    ``argument_bytes`` the arguments' shards; ``output_bytes`` the
    outputs' shards; ``alias_bytes`` the outputs that are arguments' own
    storage (an in-place optimizer update, the cache written in place);
    ``peak_per_device_bytes`` the peak of live bytes while the cell ran,
    arguments included; ``temp_bytes`` what the peak holds beyond the
    arguments and the new outputs, so that the reference's formula
    ``argument + temp + output - alias`` gives the peak."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.perf_counter()
    with _host_strided_offsets(), _dryrun_strategies(), \
            FakeTensorMode() as fake:
        fn, args = build_cell(cfg, shape, mesh, accum=accum)
        counter = CostCounter(fake)
        arg_bytes = counter.track(args)
        arg_keys = {_key(t) for t in _unique(args)}
        counter.peak = counter.live
        t1 = time.perf_counter()
        with hints.use_mesh_hints(mesh), implicit_replication(), counter:
            out = fn(*args)
        out_bytes = sum(_local_bytes(t) for t in _unique(out))
        alias = sum(_local_bytes(t) for t in _unique(out)
                    if _key(t) in arg_keys)
    t2 = time.perf_counter()
    peak = counter.peak
    temp = max(peak - arg_bytes - (out_bytes - alias), 0)
    rec = {
        "lower_s": round(t1 - t0, 2), "compile_s": round(t2 - t1, 2),
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(temp),
            "alias_bytes": int(alias),
            "peak_per_device_bytes": int(arg_bytes + temp + out_bytes
                                         - alias),
        },
        "cost": flops_and_bytes(counter),
        "collectives": collective_bytes(counter.collectives),
    }
    rec["memory"]["fits_hbm"] = rec["memory"]["peak_per_device_bytes"] \
        <= HW.HBM_BYTES
    return rec


def _local(t):
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _key(t) -> int:
    return id(_local(t).untyped_storage())


def _local_bytes(t) -> int:
    return _local(t).untyped_storage().nbytes()


def _unique(tree) -> list:
    """The tensors of ``tree``, one per storage."""
    from ..distributed.hlo_analysis import _tensors
    seen, out = set(), []
    for t in _tensors(tree):
        k = _key(t)
        if k not in seen:
            seen.add(k)
            out.append(t)
    return out


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    n_act = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch            # decode: one token


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks (this
    process is rank 0) for the with-block; collectives on it move
    nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def roofline(cfg: ArchConfig, shape: ShapeSpec, mesh, chips: int,
             accum: int = 1) -> Dict[str, Any]:
    """``delta`` and ``roofline`` of a cell by the two-depth method
    (depth 1 and 2), as the reference records them."""
    c1 = compile_cell(with_depth(cfg, 1), shape, mesh, accum=accum)
    c2 = compile_cell(with_depth(cfg, 2), shape, mesh, accum=accum)
    d = depth_delta(c1["cost"], c2["cost"], c1["collectives"],
                    c2["collectives"], 1, depth_units(cfg))
    terms = roofline_terms(d["flops"], d["bytes"], d["collective_bytes"],
                           chips, HW.PEAK_BF16_FLOPS, HW.HBM_BW, HW.ICI_BW)
    mf = model_flops(cfg, shape)
    terms["model_flops"] = mf
    terms["hlo_flops_total"] = d["flops"] * chips
    terms["useful_ratio"] = (mf / (d["flops"] * chips) if d["flops"]
                             else 0.0)
    return {"delta": d, "roofline": terms}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             skip_delta: bool = False) -> Dict[str, Any]:
    """One production cell, recorded; a cell that fails is recorded as
    data (``status`` / ``error``).  Needs a default process group of at
    least the mesh's size (``fake_world``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    chips = 512 if mesh_kind == "pod2" else 256
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "chips": chips}
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    dp = 32 if mesh_kind == "pod2" else 16
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "pod2"),
                                    device_type=DEVICE)
        # auto-microbatching: escalate grad-accum until the step fits HBM
        # (production launcher behaviour; per-token costs are unchanged)
        accum_tried = []
        accum = 1
        max_accum = 16
        while True:
            full = compile_cell(cfg, shape, mesh, accum=accum)
            accum_tried.append(
                {"accum": accum,
                 "temp_gb": round(full["memory"]["temp_bytes"] / 1e9, 2),
                 "fits": full["memory"]["fits_hbm"]})
            if shape.kind != "train" or full["memory"]["fits_hbm"]:
                break
            # jump straight to the overshoot-implied accumulation level
            over = full["memory"]["peak_per_device_bytes"] / HW.HBM_BYTES
            nxt = accum
            while nxt < over * accum and nxt < max_accum:
                nxt *= 2
            nxt = max(nxt, accum * 2)
            if nxt > max_accum or shape.global_batch % (nxt * dp) != 0:
                break
            accum = nxt
        rec["accum"] = accum_tried
        rec["full"] = full
        if not skip_delta:
            rec.update(roofline(cfg, shape, mesh, chips))
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record cell failures as data
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    return rec


# ---------------------------------------------------------------------------
def cell_path(arch, shape, mesh_kind):
    os.makedirs(OUT_DIR, exist_ok=True)
    safe = arch.replace("/", "_").replace(".", "_")
    return os.path.join(OUT_DIR, f"{safe}__{shape}__{mesh_kind}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("pod1", "pod2"), default="pod1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--filter", default="",
                    help="substring filter on '<arch>__<shape>__<mesh>'")
    ap.add_argument("--skip-existing", action="store_true", default=True)
    ap.add_argument("--no-skip-existing", dest="skip_existing",
                    action="store_false")
    ap.add_argument("--skip-delta", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s, m) for a in ARCH_IDS for s in SHAPES
                 for m in ("pod1", "pod2")]
        cells = [c for c in cells
                 if args.filter in f"{c[0]}__{c[1]}__{c[2]}"]
        for arch, shape, mesh_kind in cells:
            path = cell_path(arch, shape, mesh_kind)
            if args.skip_existing and os.path.exists(path):
                print(f"[skip-existing] {path}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_kind]
            if args.skip_delta or mesh_kind == "pod2":
                # the roofline is single-pod; pod2 cells only need the
                # memory and collective record
                cmd.append("--skip-delta")
            print(">>", " ".join(cmd), flush=True)
            r = subprocess.run(cmd, cwd=os.getcwd())
            if r.returncode != 0:
                print(f"[subprocess failed] {arch} {shape} {mesh_kind}")
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    with fake_world(512 if args.mesh == "pod2" else 256):
        rec = run_cell(args.arch, args.shape, args.mesh,
                       skip_delta=args.skip_delta)
    path = cell_path(args.arch, args.shape, args.mesh)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("full", "delta")}, indent=1))
    if rec["status"] == "ok":
        m = rec["full"]["memory"]
        print(f"memory/device: args={m['argument_bytes']/1e9:.2f}GB "
              f"temp={m['temp_bytes']/1e9:.2f}GB fits_hbm={m['fits_hbm']}")
        if "roofline" in rec:
            print("roofline:", json.dumps(rec["roofline"]))
    return 0 if rec["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
