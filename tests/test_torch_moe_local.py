"""The block-local MoE dispatch and the mesh hints in ``DecoderLM``: the
port against the reference on a (4, 2) ("data", "model") mesh.

One subprocess runs both packages (so the test worker keeps one JAX
device and no process group): the reference on 8 host devices
(``--xla_force_host_platform_device_count=8``) under ``use_mesh_hints``,
the port with a (4, 2) ``DeviceMesh`` of a fake process group registered
by its ``use_mesh_hints``, on the same fp32 weights (the reference's,
carried by ``params_from_jax``) and inputs (numpy draws from a seed).

- ``moe_local`` under skewed routing: block 0's tokens all pick expert 0,
  the other blocks never do, so the per-block capacity (16) drops 16 of
  block 0's assignments that the global capacity (48) keeps.  Outputs
  within 1e-5 x max|reference|, the aux loss within 1e-6 relative, and
  the kept sets equal (the reference's dispatch lines rerun on its own
  expert ids against the port's ``local_dispatch``).
- ``DecoderLM`` logits of qwen2-moe's smoke model with
  ``moe_local_dispatch=True``, of gemma3's with ``seq_parallel=True``
  and of qwen2-moe with both: within 1e-4 x max|reference|.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

OUT_TOL = 1e-5          # of max|reference output|
AUX_RTOL = 1e-6
LOGIT_TOL = 1e-4        # of max|reference logits|

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import numpy as np
import jax
jax.devices()
import jax.numpy as jnp
from jax.sharding import Mesh
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh

from repro.configs import get_config as jget
from repro.distributed import hints as jh
from repro.models import build_model as jbuild, init_params as jinit
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.distributed import hints as th
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)
jmesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
tmesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
out = {}

def f32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", **kw)

# ---- moe_local under skewed routing ---------------------------------------
jcfg = f32(jget("qwen2-moe-a2.7b", smoke=True))
cfg = f32(get_config("qwen2-moe-a2.7b", smoke=True))
p = jinit(jmoe.moe_specs(jcfg), jax.random.key(0))
rng = np.random.default_rng(3)
router = (rng.normal(size=(jcfg.d_model, jcfg.n_experts)) * 0.1
          ).astype(np.float32)
router[0, :] = 0.0
router[0, 0] = 1.0
p = dict(p, router=jnp.asarray(router))
x = rng.normal(size=(4, 32, jcfg.d_model)).astype(np.float32)
x[0, :, 0] = 8.0           # block 0 (the first 32 tokens): expert 0
x[1:, :, 0] = -8.0         # blocks 1-3: never expert 0
with jh.use_mesh_hints(jmesh):
    jy, jaux = jax.jit(lambda x, p: jmoe.moe_local(x, p, jcfg))(
        jnp.asarray(x), p)
    gy, gaux = jax.jit(lambda x, p: jmoe.moe(x, p, jcfg))(jnp.asarray(x), p)
np_p = jax.tree.map(np.asarray, p)
tp = {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict) else
          {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()})
      for k, v in np_p.items()}
with th.use_mesh_hints(tmesh):
    ty, taux = tmoe.moe_local(torch.from_numpy(x), tp, cfg)
# the reference's dispatch lines (repro/models/moe.py:128-155) on its ids
nb, tb, k, e = 4, 32, jcfg.top_k, jcfg.n_experts
cap = jmoe._capacity(tb, jcfg)
xt = jnp.asarray(x).reshape(nb, tb, -1)
probs = jax.nn.softmax(jnp.einsum("ntd,de->nte", xt, p["router"]), axis=-1)
gv, ids = jax.lax.top_k(probs, k)
flat_e = ids.reshape(nb, tb * k)
order = jnp.argsort(flat_e, axis=1)
se = jnp.take_along_axis(flat_e, order, axis=1)
flat_tok = jnp.tile(jnp.repeat(jnp.arange(tb), k)[None], (nb, 1))
stok = jnp.take_along_axis(flat_tok, order, axis=1)
blk = jnp.broadcast_to(jnp.arange(nb)[:, None], se.shape)
counts = jnp.zeros((nb, e), jnp.int32).at[blk, se].add(1)
starts = jnp.concatenate([jnp.zeros((nb, 1), jnp.int32),
                          jnp.cumsum(counts, axis=1)[:, :-1]], axis=1)
pos = jnp.arange(tb * k)[None, :] - starts[blk, se]
keep = np.asarray(pos < cap)
ref_kept = sorted((int(b), int(s), int(t)) for b, s, t in zip(
    np.asarray(blk)[keep], np.asarray(se)[keep], np.asarray(stok)[keep]))
tprobs = torch.softmax(torch.from_numpy(np.asarray(xt)) @ tp["router"], -1)
tg, tids = torch.topk(tprobs, k, dim=-1)
tse, tsg, tstok, tkeep, tpos = tmoe.local_dispatch(tids, tg, cap, e)
tblk = torch.arange(nb)[:, None].expand_as(tse)
port_kept = sorted(zip(tblk[tkeep].tolist(), tse[tkeep].tolist(),
                       tstok[tkeep].tolist()))
gcap = jmoe._capacity(nb * tb, jcfg)
out["moe_local"] = {
    "max_ref": float(np.abs(np.asarray(jy)).max()),
    "max_diff": float(np.abs(ty.numpy() - np.asarray(jy)).max()),
    "aux_ref": float(jaux), "aux_port": float(taux),
    "kept_equal": ref_kept == port_kept, "n_kept": len(ref_kept),
    "n_assign": nb * tb * k, "cap_local": cap, "cap_global": gcap,
    "global_vs_local_max_diff": float(np.abs(np.asarray(gy)
                                             - np.asarray(jy)).max()),
    "block0_expert0": int(np.asarray(counts)[0, 0]),
}

# ---- DecoderLM logits with the hints -----------------------------------------
def logits_case(arch, **kw):
    jc = f32(jget(arch, smoke=True), **kw)
    tc = f32(get_config(arch, smoke=True), **kw)
    jm, tm = jbuild(jc), build_model(tc)
    jp = jinit(jm.param_specs(), jax.random.key(1))
    tpp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    toks = np.random.default_rng(5).integers(0, jc.vocab, size=(4, 8)
                                             ).astype(np.int32)
    with jh.use_mesh_hints(jmesh):
        jl, jaux = jax.jit(jm.logits)(jp, jnp.asarray(toks))
    with th.use_mesh_hints(tmesh):
        tl, taux = tm.logits(tpp, torch.from_numpy(toks))
    return {"max_ref": float(np.abs(np.asarray(jl)).max()),
            "max_diff": float(np.abs(tl.detach().numpy()
                                     - np.asarray(jl)).max()),
            "aux_ref": float(jaux), "aux_port": float(taux)}

out["moe_localdisp"] = logits_case("qwen2-moe-a2.7b", moe_local_dispatch=True)
out["dense_sp"] = logits_case("gemma3-1b", seq_parallel=True)
out["moe_sp_localdisp"] = logits_case("qwen2-moe-a2.7b",
                                      moe_local_dispatch=True,
                                      seq_parallel=True)
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def results():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def test_moe_local_skewed_matches_reference(results):
    r = results["moe_local"]
    # the skew is real: block 0 sends all 32 tokens to expert 0, over the
    # per-block capacity but within the global one
    assert r["block0_expert0"] == 32
    assert r["cap_local"] < 32 <= r["cap_global"]
    assert r["n_kept"] < r["n_assign"]
    assert r["global_vs_local_max_diff"] > 1e-3
    assert r["kept_equal"]
    assert r["max_diff"] <= OUT_TOL * r["max_ref"], r
    assert abs(r["aux_port"] - r["aux_ref"]) <= AUX_RTOL * abs(r["aux_ref"])


@pytest.mark.parametrize("case", ["moe_localdisp", "dense_sp",
                                  "moe_sp_localdisp"])
def test_decoder_logits_with_mesh_hints(results, case):
    r = results[case]
    assert r["max_diff"] <= LOGIT_TOL * r["max_ref"], r
    assert abs(r["aux_port"] - r["aux_ref"]) <= \
        AUX_RTOL * max(abs(r["aux_ref"]), 1e-30) + 1e-7, r
