"""int8 gradient compression with error feedback: the port's
``repro_torch.training.compression`` against ``repro.training.compression``.

- ``quantize_int8``, ``dequantize_int8`` and ``compress_residual`` equal
  the reference's bit for bit on seeded numpy draws, among them the
  float32 rounding case ROADMAP Queue C records (``seed=600,
  scale=55.2546``, where the reference misses a half-step bound), an
  all-zero tensor and exact halves (round half to even).
- ``compressed_psum`` over a one-rank gloo group equals the reference's
  ``shard_map`` over a (1,) mesh bit for bit, over three steps of error
  feedback.
- Over four gloo ranks (spawned processes) it equals the reference over
  four host devices (a subprocess with
  ``--xla_force_host_platform_device_count=4``) on the same per-replica
  gradients and errors: the residuals bit for bit; the mean bit for bit
  the reference's formula with the summed scale within 1 ulp of the
  reference's (the two sum the four scales in their own order).

Process groups are initialised only in subprocesses, so no state is left
in a test worker.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compression as jc
from repro_torch.training import compression as tc

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _draw(seed, scale, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


CASES = {
    "queue_c": lambda: _draw(600, 55.2546, (64,)),
    "zeros": lambda: np.zeros((5, 7), np.float32),
    "halves": lambda: np.asarray([127.0, 63.5, -63.5, 0.5, 1.5, 2.5, -2.5,
                                  -0.5, 3.5, 0.0], np.float32),
    "small": lambda: _draw(1, 1e-3, (3, 33, 17)),
    "wide": lambda: _draw(2, 7.0, (257, 129)),
    "tiny": lambda: _draw(3, 1e-35, (16,)),
}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("case", list(CASES))
def test_quantize_and_residual_bit_for_bit(case):
    g = CASES[case]()
    jq, js = jc.quantize_int8(jnp.asarray(g))
    tq, ts = tc.quantize_int8(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert _bits(np.float32(ts.item())) == _bits(np.float32(js))
    np.testing.assert_array_equal(
        _bits(tc.dequantize_int8(tq, ts).numpy()),
        _bits(jc.dequantize_int8(jq, js)))
    jq2, js2, jr = jc.compress_residual(jnp.asarray(g))
    tq2, ts2, tr = tc.compress_residual(torch.from_numpy(g))
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(_bits(tr.numpy()), _bits(jr))


def test_halves_round_to_even():
    q, s = tc.quantize_int8(torch.from_numpy(CASES["halves"]()))
    assert float(s) == 1.0
    assert q.tolist() == [127, 64, -64, 0, 2, 2, -2, 0, 4, 0]


def test_init_error_state_zeros_fp32():
    params = {"a": torch.ones(3, 4, dtype=torch.bfloat16),
              "b": {"c": torch.ones(5)}}
    e = tc.init_error_state(params)
    assert e["a"].dtype == torch.float32 and e["a"].shape == (3, 4)
    assert float(e["b"]["c"].abs().sum()) == 0.0


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(32,)).astype(np.float32),
            "blk": {"a": (rng.normal(size=(6, 10)) * 3).astype(np.float32),
                    "b": (rng.normal(size=(4,)) * 1e-4).astype(np.float32)}}


def _ref_psum_steps(trees, n_dev):
    """The reference: ``compressed_psum`` in ``shard_map`` over a
    ``(n_dev,)`` mesh, for consecutive gradient trees (each leaf stacked
    [n_dev, ...], one slice per replica), errors fed back."""
    from jax.sharding import Mesh, PartitionSpec as P
    shard_map = jax.shard_map
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("data",))

    def f(g, e):
        g = jax.tree.map(lambda x: x[0], g)
        e = jax.tree.map(lambda x: x[0], e)
        out, ne = jc.compressed_psum(g, e, "data")
        return (jax.tree.map(lambda x: x[None], out),
                jax.tree.map(lambda x: x[None], ne))

    fn = shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data")))
    errs = jax.tree.map(lambda x: jnp.zeros_like(jnp.asarray(x)), trees[0])
    outs = []
    for g in trees:
        avg, errs = fn(jax.tree.map(jnp.asarray, g), errs)
        outs.append((jax.tree.map(np.asarray, avg),
                     jax.tree.map(np.asarray, errs)))
    return outs


PORT_SCRIPT = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch.training.compression import compressed_psum, init_error_state
from repro_torch.training.tree import leaves_with_paths

def run(rank, world, store_path, inputs_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store_path,
                            rank=rank, world_size=world)
    try:
        data = np.load(inputs_path, allow_pickle=False)
        steps = sorted({int(k.split("/")[0]) for k in data.files})
        names = sorted({k.split("/", 1)[1] for k in data.files})
        def tree(step):
            out = {}
            for name in names:
                node = out
                parts = name.split(".")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = torch.from_numpy(
                    np.ascontiguousarray(data[f"{step}/{name}"][rank]))
            return out
        errs = init_error_state(tree(0))
        res = {}
        for s in steps:
            avg, errs = compressed_psum(tree(s), errs)
            for tag, t in (("avg", avg), ("err", errs)):
                for path, leaf in leaves_with_paths(t):
                    res[f"{s}/{tag}/" + ".".join(path)] = leaf.numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()

if __name__ == "__main__":
    world, inputs_path, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    store = os.path.join(out_dir, "store")
    if world == 1:
        run(0, 1, store, inputs_path, out_dir)
    else:
        mp.start_processes(run, args=(world, store, inputs_path, out_dir),
                           nprocs=world, start_method="spawn")
    print("PORT OK")
"""


def _flat_np(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _port_psum_steps(trees, world, tmp_path):
    """The port: ``compressed_psum`` on ``world`` gloo ranks (spawned;
    one rank runs in the subprocess itself),
    one slice of each stacked leaf per rank; rank 0's results and each
    rank's errors."""
    inputs = {f"{s}/{name}": leaf for s, t in enumerate(trees)
              for name, leaf in _flat_np(t).items()}
    ipath = str(tmp_path / "inputs.npz")
    np.savez(ipath, **inputs)
    script = tmp_path / "port_psum.py"
    script.write_text(PORT_SCRIPT)
    r = subprocess.run([sys.executable, str(script), str(world), ipath,
                        str(tmp_path)], capture_output=True, text=True,
                       env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return [dict(np.load(tmp_path / f"rank{i}.npz")) for i in range(world)]


def test_compressed_psum_one_rank_bit_for_bit(tmp_path):
    trees = [jax.tree.map(lambda x: x[None], _tree(s)) for s in range(3)]
    ref = _ref_psum_steps(trees, 1)
    port = _port_psum_steps(trees, 1, tmp_path)[0]
    for s, (avg, err) in enumerate(ref):
        for name, v in _flat_np(avg).items():
            np.testing.assert_array_equal(
                _bits(port[f"{s}/avg/{name}"]), _bits(v[0]), err_msg=name)
        for name, v in _flat_np(err).items():
            np.testing.assert_array_equal(
                _bits(port[f"{s}/err/{name}"]), _bits(v[0]), err_msg=name)


REF4_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.devices()
import numpy as np
sys.path.insert(0, %(tests)r)
import test_torch_compression as t
trees = [t._stack4(s) for s in range(3)]
out = t._ref_psum_steps(trees, 4)
res = {}
for s, (avg, err) in enumerate(out):
    for tag, tree in (("avg", avg), ("err", err)):
        for name, v in t._flat_np(tree).items():
            res[f"{s}/{tag}/{name}"] = v
np.savez(%(out)r, **res)
print("REF OK")
"""


def _stack4(step):
    """Four replicas' gradients for one step: each leaf [4, ...]."""
    reps = [_tree(100 * step + r) for r in range(4)]
    return jax.tree.map(lambda *xs: np.stack(xs), *reps)


def _candidates(trees, ref, step, name, n=4):
    """The means ``qsum * (m / n) / n`` (fp32, the reference's formula)
    for ``m`` the reference's sum of the four replicas' scales and its
    two fp32 neighbours: one ulp either way of the summed scale."""
    g = trees[step][name]
    if step:
        g = g + ref[f"{step - 1}/err/{name}"]
    qs, ss = zip(*(jc.quantize_int8(jnp.asarray(g[r])) for r in range(n)))
    qsum = np.sum([np.asarray(q, np.int32) for q in qs], axis=0)
    ssum = np.float32(np.sum(np.asarray(ss, np.float32)))
    nf = np.float32(n)
    return [qsum.astype(np.float32) * (m / nf) / nf
            for m in (np.nextafter(ssum, np.float32(-np.inf)), ssum,
                      np.nextafter(ssum, np.float32(np.inf)))]


def test_compressed_psum_four_ranks(tmp_path):
    out = str(tmp_path / "ref4.npz")
    r = subprocess.run(
        [sys.executable, "-c", REF4_SCRIPT % {
            "tests": os.path.dirname(os.path.abspath(__file__)),
            "out": out}],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = dict(np.load(out))
    trees = [_stack4(s) for s in range(3)]
    flat = [_flat_np(t) for t in trees]
    port = _port_psum_steps(trees, 4, tmp_path)
    for key, v in ref.items():
        step, tag, name = key.split("/")
        if tag == "err":
            # each replica's own residual: local arithmetic, bit for bit
            for rank in range(4):
                np.testing.assert_array_equal(
                    _bits(port[rank][key]), _bits(v[rank]), err_msg=key)
            continue
        # the mean: the same on every rank, and the reference's formula
        # with a summed scale within 1 ulp of the reference's (the four
        # scales are summed in gloo's order and in XLA's)
        cands = [_bits(c) for c in _candidates(flat, ref, int(step), name)]
        assert any(np.array_equal(_bits(v[0]), c) for c in cands), key
        for rank in range(4):
            got = _bits(port[rank][key])
            np.testing.assert_array_equal(got, _bits(port[0][key]))
            assert any(np.array_equal(got, c) for c in cands), key
