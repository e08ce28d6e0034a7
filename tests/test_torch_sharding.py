"""The port's sharding rules against the reference's, for every
architecture at its published width.

The reference's rules run on a ``jax.sharding.AbstractMesh`` (no
devices), the port's on the same axis sizes given as a mapping; the
parameter, optimizer-state (ZeRO-1), batch and cache specs must be equal
entry for entry, on the meshes (16, 16), (2, 16, 16) and (2, 4), with the
default ``decode_shard`` and with ``"heads"``.  The caches are held on
the reference's layout (its ``cache_specs``); the port's own K/V layout
moves the kv-heads axis, which ``kv_heads_axis`` names.  Then
``to_placements`` on a fake (2, 4) process group: each ``DTensor``'s
local shard has the shape the spec implies.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsh
from repro.models import abstract_params, build_model as jax_build_model
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.models import build_model

torch.set_num_threads(1)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


def _ref_tree(tree):
    """A reference NamedSharding tree as a dict of spec tuples."""
    return jax.tree.map(lambda ns: tuple(ns.spec), tree,
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.NamedSharding))


def _flat(tree, prefix=()):
    """A port spec tree (dicts with tuple leaves) as ``{path: spec}``."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (str(k),)))
    return out


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): v
            for p, v in flat}


def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def input_specs(cfg, shape, model):
    """The reference dry run's input stand-ins (``repro.launch.dryrun.
    input_specs``; that module sets a 512-device ``XLA_FLAGS`` when
    imported, so its shapes are rebuilt here)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = jnp.int32
    n_tok = s - (cfg.n_patches or 0)
    if shape.kind == "train":
        batch = {"tokens": jax.ShapeDtypeStruct((b, n_tok), i32),
                 "labels": jax.ShapeDtypeStruct((b, n_tok), i32)}
        if cfg.family in ("audio", "encdec"):
            batch["frames"] = jax.ShapeDtypeStruct(
                (b, cfg.n_frames, cfg.d_model), jnp.float32)
        if cfg.n_patches:
            batch["patches"] = jax.ShapeDtypeStruct(
                (b, cfg.n_patches, cfg.d_model), jnp.float32)
        return {"batch": batch}
    if shape.kind == "prefill":
        return {"tokens": jax.ShapeDtypeStruct((b, n_tok), i32),
                "cache": model.cache_specs(b, s)}
    return {"token": jax.ShapeDtypeStruct((b, 1), i32),
            "cache": model.cache_specs(b, s)}


def _port_shapes(jtree):
    """A reference ShapeDtypeStruct tree as nested dicts of shapes."""
    return jax.tree.map(lambda s: _Shape(s.shape), jtree)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(arch, mesh_id):
    shape, names = MESHES[mesh_id]
    amesh = jax.sharding.AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    for variant in ({}, {"decode_shard": "heads"}):
        jcfg = dataclasses.replace(jax_get_config(arch), **variant)
        cfg = dataclasses.replace(get_config(arch), **variant)
        jmodel = jax_build_model(jcfg)
        jspecs = abstract_params(jmodel.param_specs())
        tspecs = build_model(cfg).param_specs()
        # parameters
        jp = jsh.params_shardings(jspecs, amesh, jcfg)
        tp = tsh.params_shardings(tspecs, sizes, cfg)
        ref, got = _ref_flat(_ref_tree(jp)), _flat(tp)
        assert set(ref) == set(got)
        for k in ref:
            assert _pad(got[k], len(ref[k])) == ref[k], (k, got[k], ref[k])
        # optimizer state (ZeRO-1)
        jo = _ref_flat(_ref_tree(jsh.opt_state_shardings(jp, amesh, jspecs)))
        to = tsh.opt_state_shardings(tp, sizes, tspecs)
        go = {("m",) + k: v for k, v in _flat(to["m"]).items()}
        go.update({("v",) + k: v for k, v in _flat(to["v"]).items()})
        go[("step",)] = to["step"]
        assert set(jo) == set(go)
        for k in jo:
            assert _pad(go[k], len(jo[k])) == jo[k], (k, go[k], jo[k])
        # batch and caches at the production shapes
        for sname, spec in JAX_SHAPES.items():
            inp = input_specs(jcfg, spec, jmodel)
            for key in ("batch", "cache"):
                if key not in inp:
                    continue
                if key == "batch":
                    jr = jsh.batch_shardings(amesh, inp[key])
                    tr = tsh.batch_shardings(sizes, _port_shapes(inp[key]))
                else:
                    jr = jsh.cache_shardings(amesh, inp[key], jcfg)
                    tr = tsh.cache_shardings(sizes, _port_shapes(inp[key]),
                                             cfg)
                ref, got = _ref_flat(_ref_tree(jr)), _flat(tr)
                assert set(ref) == set(got), (sname, key)
                for k in ref:
                    assert _pad(got[k], len(ref[k])) == ref[k], \
                        (sname, key, k, got[k], ref[k])
            if "token" in inp:
                jr = jsh.batch_shardings(amesh, {"t": inp["token"]})["t"]
                tr = tsh.batch_shardings(sizes, {"t": _Shape(
                    inp["token"].shape)})["t"]
                assert _pad(tr, 2) == tuple(jr.spec)
        # replicated
        jr = _ref_flat(_ref_tree(jsh.replicated(amesh, jspecs)))
        tr = _flat(tsh.replicated(sizes, tspecs))
        for k in jr:
            assert _pad(tr[k], len(jr[k])) == jr[k]


def test_port_kv_layout_heads_axis():
    """On the port's [L, b, n_kv, smax, hd] K/V layout, ``decode_shard=
    "heads"`` with ``PORT_KV_HEADS_AXIS`` shards the same semantic axis
    (kv-heads) the reference shards on its own layout."""
    cfg = dataclasses.replace(get_config("codeqwen1.5-7b"),
                              decode_shard="heads")
    jcfg = dataclasses.replace(jax_get_config("codeqwen1.5-7b"),
                               decode_shard="heads")
    sizes = {"data": 2, "model": 4}
    amesh = jax.sharding.AbstractMesh((2, 4), ("data", "model"))
    ref = jsh.cache_shardings(amesh, jax_build_model(jcfg).cache_specs(
        8, 64), jcfg)["k"].spec
    port = tsh.cache_shardings(sizes, {"k": _Shape(
        (cfg.n_layers, 8, cfg.n_kv, 64, cfg.hd))}, cfg,
        kv_heads_axis=tsh.PORT_KV_HEADS_AXIS)["k"]
    # reference [L, b, S, KV, HD] -> port [L, b, KV, S, HD]
    assert port == (ref[0], ref[1], ref[3], ref[2], ref[4])


PLACEMENT_SCRIPT = r"""
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.distributed.sharding import distribute_tree, to_placements

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
try:
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    assert to_placements((None, "model"), mesh) == (Replicate(), Shard(1))
    assert to_placements(("data", None, "model"), mesh) == (Shard(0),
                                                            Shard(2))
    try:
        to_placements(("data", "data"), mesh)
        raise SystemExit("a repeated axis was accepted")
    except ValueError:
        pass
    pod = init_device_mesh("cpu", (2, 2, 2),
                           mesh_dim_names=("pod", "data", "model"))
    assert to_placements((("pod", "data"), "model"), pod) == (
        Shard(0), Shard(0), Shard(1))
    with FakeTensorMode():
        tree = {"a": torch.zeros(16, 12), "b": {"c": torch.zeros(6, 8, 4)},
                "d": torch.zeros(3)}
        specs = {"a": ("data", "model"), "b": {"c": (None, "data", "model")},
                 "d": (None,)}
        out = distribute_tree(tree, specs, mesh)
        assert tuple(out["a"].to_local().shape) == (8, 3)
        assert tuple(out["b"]["c"].to_local().shape) == (6, 4, 1)
        assert tuple(out["d"].to_local().shape) == (3,)
        assert tuple(out["a"].shape) == (16, 12)
        p = distribute_tree({"w": torch.zeros(8, 5)},
                            {"w": (("pod", "data"), None)}, pod)
        assert tuple(p["w"].to_local().shape) == (2, 5)
    print("PLACEMENTS OK")
finally:
    dist.destroy_process_group()
"""


def test_to_placements_local_shapes():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    r = subprocess.run([sys.executable, "-c", PLACEMENT_SCRIPT],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "PLACEMENTS OK" in r.stdout
