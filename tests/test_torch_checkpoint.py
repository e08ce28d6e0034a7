"""The port's checkpoints, data pipeline, fault policies and training
launcher (``repro_torch.training.checkpoint``, ``repro_torch.data``,
``repro_torch.training.fault_tolerance``, ``repro_torch.launch.train``)
against the reference's: ports of ``tests/test_checkpoint.py`` and
``tests/test_fault_tolerance.py``, batches equal bit for bit, checkpoints
restored across the two packages in both directions (bf16 and fp32
leaves, equal bytes), and the launcher's resume equal bit for bit to an
uninterrupted run on the CPU.
"""
import gc
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokenPipeline as JPipeline
from repro.training.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.data import (DataConfig, PrefetchingLoader,
                              SyntheticTokenPipeline)
from repro_torch.launch import train as launch_train
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault_tolerance import (FaultTolerantRunner,
                                                  HeartbeatConfig,
                                                  HeartbeatMonitor,
                                                  plan_elastic_mesh)
from repro_torch.training.tree import leaves, leaves_with_paths

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_clean():
    """Release the reference's compiled executables after each test."""
    yield
    jax.clear_caches()
    gc.collect()


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(16, 8, generator=g),
                       "b": torch.zeros(8),
                       "h": torch.randn(5, 3, generator=g).bfloat16()},
            "opt": {"m": torch.ones(16, 8),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _bits(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


# ---------------------------------------------------------------------------
# ports of tests/test_checkpoint.py
# ---------------------------------------------------------------------------
def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    st = _state()
    cm.save(10, st, extra={"data_step": 10})
    restored, manifest = cm.restore(st)
    assert manifest["step"] == 10
    assert manifest["extra"]["data_step"] == 10
    for a, b in zip(leaves(st), leaves(restored)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
    assert restored["opt"]["step"].dtype == torch.int32
    assert int(restored["opt"]["step"]) == 7
    assert manifest["leaves"]["params/h"]["dtype"] == "bfloat16"


def test_keeps_latest_and_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    st = _state()
    for s in (1, 2, 3, 4):
        cm.save(s, st)
    assert cm.available_steps() == [3, 4]


def test_corruption_falls_back(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=5)
    st = _state()
    cm.save(1, st)
    cm.save(2, st)
    cdir = os.path.join(str(tmp_path), "step_00000002")
    manifest = json.load(open(os.path.join(cdir, "manifest.json")))
    victim = list(manifest["leaves"].values())[0]["file"]
    with open(os.path.join(cdir, victim), "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef")
    restored, m = cm.restore(st)
    assert m["step"] == 1                         # fell back to valid step
    assert cm.restore(st, step=2) == (None, None)


def test_no_partial_checkpoint_visible(tmp_path):
    """A .tmp directory (simulated crash mid-save) is never restorable."""
    cm = CheckpointManager(str(tmp_path))
    cm.save(5, _state())
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert cm.available_steps() == [5]


def test_restore_onto_another_dtype_and_device(tmp_path):
    """The template decides each leaf's device and dtype (the reference's
    reshard-on-restore); a template of another shape is refused."""
    cm = CheckpointManager(str(tmp_path))
    st = _state()
    cm.save(3, st)
    tmpl = {"params": {"w": torch.empty(16, 8, dtype=torch.bfloat16),
                       "b": torch.empty(8, dtype=torch.float64),
                       "h": torch.empty(5, 3)},
            "opt": {"m": torch.empty(16, 8),
                    "step": torch.empty((), dtype=torch.int64)}}
    restored, _ = cm.restore(tmpl)
    assert all(a.device.type == "cpu" for a in leaves(restored))
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["w"],
                       st["params"]["w"].bfloat16())
    assert torch.equal(restored["params"]["h"], st["params"]["h"].float())
    assert restored["opt"]["step"].dtype == torch.int64
    bad = {"params": {"w": torch.empty(8, 16), "b": torch.empty(8),
                      "h": torch.empty(5, 3)},
           "opt": {"m": torch.empty(16, 8), "step": torch.empty(())}}
    with pytest.raises(ValueError, match="params/w"):
        cm.restore(bad)


def test_data_resume_bit_identical():
    cfg = DataConfig(vocab=97, seq_len=16, global_batch=4, seed=3)
    p1 = SyntheticTokenPipeline(cfg)
    ref = [p1.batch(s) for s in range(10)]
    p2 = SyntheticTokenPipeline(cfg)              # "restarted job"
    for s in (5, 6, 9):
        np.testing.assert_array_equal(p2.batch(s)["tokens"],
                                      ref[s]["tokens"])


def test_host_sharded_pipeline_partitions():
    full = SyntheticTokenPipeline(DataConfig(vocab=31, seq_len=8,
                                             global_batch=8, seed=4))
    parts = [SyntheticTokenPipeline(DataConfig(vocab=31, seq_len=8,
                                               global_batch=8, seed=4,
                                               n_hosts=4, host_id=h))
             for h in range(4)]
    want = full.batch(2)["tokens"]
    got = np.concatenate([p.batch(2)["tokens"] for p in parts], axis=0)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("learnable", [True, False])
@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (4, 0), (4, 3)])
def test_pipeline_batches_equal_reference(learnable, n_hosts, host_id):
    kw = dict(vocab=262_144, seq_len=24, global_batch=8, seed=5,
              learnable=learnable, n_hosts=n_hosts, host_id=host_id)
    port = SyntheticTokenPipeline(DataConfig(**kw))
    ref = JPipeline(JDataConfig(**kw))
    for step in (0, 1, 17, 1000):
        a, b = port.batch(step), ref.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()


def test_prefetching_loader_resumes_at_its_cursor():
    pipe = SyntheticTokenPipeline(DataConfig(vocab=53, seq_len=8,
                                             global_batch=2, seed=6))
    loader = PrefetchingLoader(pipe, start_step=7)
    try:
        got = [next(loader) for _ in range(3)]
    finally:
        loader.close()
    assert not loader._thread.is_alive()
    assert [s for s, _ in got] == [7, 8, 9] and loader.step == 10
    for s, b in got:
        np.testing.assert_array_equal(b["tokens"], pipe.batch(s)["tokens"])


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------
def _mixed(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    e = rng.normal(size=(3, 5)).astype(np.float32)
    return w, e


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    w, e = _mixed(7)
    jstate = {"params": {"w": jnp.asarray(w),
                         "e": jnp.asarray(e).astype(jnp.bfloat16)},
              "opt": {"step": jnp.int32(12)}}
    JCheckpointManager(str(tmp_path)).save(12, jstate,
                                           extra={"data_step": 13})
    tmpl = {"params": {"w": torch.empty(6, 4),
                       "e": torch.empty(3, 5, dtype=torch.bfloat16)},
            "opt": {"step": torch.empty((), dtype=torch.int32)}}
    restored, manifest = CheckpointManager(str(tmp_path)).restore(tmpl)
    assert manifest["extra"] == {"data_step": 13}
    assert restored["params"]["e"].dtype == torch.bfloat16
    assert _bits(restored["params"]["e"]) == np.asarray(
        jstate["params"]["e"]).tobytes()
    assert _bits(restored["params"]["w"]) == w.tobytes()
    assert int(restored["opt"]["step"]) == 12


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    w, e = _mixed(8)
    state = {"params": {"w": torch.as_tensor(w),
                        "e": torch.as_tensor(e).bfloat16()},
             "opt": {"step": torch.tensor(4, dtype=torch.int32)}}
    CheckpointManager(str(tmp_path)).save(4, state, extra={"data_step": 5})
    tmpl = {"params": {"w": jnp.zeros((6, 4)),
                       "e": jnp.zeros((3, 5), jnp.bfloat16)},
            "opt": {"step": jnp.int32(0)}}
    restored, manifest = JCheckpointManager(str(tmp_path)).restore(tmpl)
    assert manifest["step"] == 4
    assert manifest["leaves"]["params/e"]["dtype"] == "bfloat16"
    assert restored["params"]["e"].tobytes() == _bits(state["params"]["e"])
    assert restored["params"]["w"].tobytes() == w.tobytes()
    assert int(restored["opt"]["step"]) == 4
    # the files are the reference's, byte for byte: the same bf16 leaf
    # saved by it
    ref_dir = tmp_path / "ref"
    e_bf16 = np.frombuffer(_bits(state["params"]["e"]),
                           ml_dtypes.bfloat16).reshape(3, 5)
    JCheckpointManager(str(ref_dir)).save(4, {
        "params": {"w": jnp.asarray(w), "e": jnp.asarray(e_bf16)},
        "opt": {"step": jnp.int32(4)}}, extra={"data_step": 5})
    ours = json.load(open(tmp_path / "step_00000004" / "manifest.json"))
    theirs = json.load(open(ref_dir / "step_00000004" / "manifest.json"))
    assert ours == theirs
    for meta in ours["leaves"].values():
        assert (tmp_path / "step_00000004" / meta["file"]).read_bytes() == \
            (ref_dir / "step_00000004" / meta["file"]).read_bytes()


# ---------------------------------------------------------------------------
# ports of tests/test_fault_tolerance.py
# ---------------------------------------------------------------------------
def test_dead_host_detection():
    cfg = HeartbeatConfig(interval_s=1.0, miss_threshold=3)
    mon = HeartbeatMonitor(hosts=range(4), cfg=cfg)
    now = 100.0
    for h in range(4):
        mon.beat(h, now=now)
    mon.beat(0, now=now + 10)
    mon.beat(1, now=now + 10)
    mon.beat(2, now=now + 10)
    assert mon.dead_hosts(now=now + 10) == [3]


def test_straggler_detection():
    mon = HeartbeatMonitor(hosts=range(4))
    for step in range(10):
        for h in range(4):
            mon.beat(h, step_time_s=1.0 if h != 2 else 3.5)
    assert mon.stragglers() == [2]


def test_no_false_stragglers():
    mon = HeartbeatMonitor(hosts=range(8))
    rng = np.random.default_rng(0)
    for step in range(20):
        for h in range(8):
            mon.beat(h, step_time_s=1.0 + 0.05 * rng.random())
    assert mon.stragglers() == []


def test_elastic_plan_shrinks_data_axis():
    p = plan_elastic_mesh(256, model_parallel=16)
    assert p.mesh_shape == (16, 16)
    p = plan_elastic_mesh(224, model_parallel=16)
    assert p.mesh_shape == (8, 16)
    assert p.axis_names == ("data", "model")
    p = plan_elastic_mesh(512, model_parallel=16, pods=2)
    assert p.mesh_shape == (2, 16, 16)
    p = plan_elastic_mesh(480, model_parallel=16, pods=2)
    assert p.mesh_shape == (2, 8, 16)


def test_runner_checkpoints_and_flags(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    mon = HeartbeatMonitor(hosts=range(2),
                           cfg=HeartbeatConfig(interval_s=10.0))
    runner = FaultTolerantRunner(cm, mon, ckpt_every=5)
    state = {"w": np.ones(4)}
    for step in range(1, 11):
        runner.maybe_checkpoint(step, state, data_step=step)
    assert cm.available_steps() == [5, 10]
    mon.beat(1, now=200.0)
    mon.beat(0, now=290.0)
    status = runner.check_cluster(now=300.0)
    assert status["dead"] == [1]
    assert status["action"] == "elastic_restart"


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
SMOKE = ["--smoke", "--device", "cpu", "--steps", "12", "--batch", "4",
         "--seq", "16", "--log-every", "100"]


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "gemma3-1b"])
def test_launch_train_resumes_bit_for_bit(arch, tmp_path):
    """12 steps with a checkpoint every 4, then a second run from the
    latest checkpoint (step 8, data cursor 9) to 12: it consumes the same
    batches, reaches the same losses and ends with parameters and
    optimizer state equal bit for bit to the uninterrupted run's (bf16
    smoke weights, restored through the manifest's dtype)."""
    argv = SMOKE + ["--arch", arch, "--ckpt-every", "4",
                    "--ckpt-dir", str(tmp_path)]
    first = launch_train.main(argv)
    assert first["resumed_from"] is None and len(first["losses"]) == 12
    assert CheckpointManager(str(tmp_path)).available_steps() == [4, 8]
    assert all(np.isfinite(v) for v in first["losses"].values())
    assert first["losses"][11] < first["losses"][0]
    second = launch_train.main(argv)
    assert second["resumed_from"] == 8
    assert sorted(second["losses"]) == [9, 10, 11]
    for s in (9, 10, 11):
        assert second["batches"][s] == first["batches"][s]
        assert second["losses"][s] == first["losses"][s]
    a, b = leaves_with_paths(first["state"]), leaves_with_paths(
        second["state"])
    assert [p for p, _ in a] == [p for p, _ in b]
    assert first["state"]["params"]["final_norm"].dtype == torch.bfloat16
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and _bits(x) == _bits(y), path


def test_launch_train_accumulates():
    out = launch_train.main(SMOKE + ["--steps", "3", "--accum", "2"])
    assert sorted(out["losses"]) == [0, 1, 2]
    assert int(out["state"]["opt"]["step"]) == 3


def test_launch_train_defaults_to_the_card():
    """Without ``--device`` and without a card the launcher raises
    instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_train.main(["--smoke", "--steps", "1"])
