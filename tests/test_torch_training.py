"""The port's training substrate (``repro_torch.models.losses``,
``repro_torch.training``) against the reference's (``repro.training``).

Tolerances, fp32 unless a test says otherwise: the cross entropy within
1e-6 relative (the two frameworks sum the logsumexp in different
orders); the schedules within 1e-6 relative (``cos`` and ``pow`` differ
in the last bit); AdamW's fp32 leaves within fp32 rounding (``rtol``
1e-6 on parameters, moments and the gradient norm) and its bf16 leaves
within one bf16 ulp; the train step's losses within 1e-4 relative over
five steps.  Parameters after several steps are held to ``0.1 x`` the
summed learning rate: AdamW moves each element by about the learning
rate whatever its gradient's size, so an element whose gradient is
rounding noise may step the other way in the other framework.  Remat
(``full``, ``dots``, ``none``) changes what is kept, not what is
computed: the gradients are equal bit for bit.
"""
import dataclasses
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokenPipeline as JPipeline
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models.losses import cross_entropy as jax_cross_entropy
from repro.training import optimizer as jopt
from repro.training.train_step import init_train_state as jax_init_state
from repro.training.train_step import make_train_step as jax_make_step
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.models import build_model, init_params, params_from_jax
from repro_torch.models.losses import cross_entropy
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import (init_train_state,
                                             loss_and_grads, make_train_step)
from repro_torch.training.tree import leaves, leaves_with_paths

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_clean():
    """Release the reference's compiled executables after each test."""
    yield
    jax.clear_caches()
    gc.collect()


def _models(arch, **over):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jm = jax_build_model(jcfg)
    jp = jax.jit(functools.partial(jax_init_params, jm.param_specs()))(
        jax.random.key(0))
    return cfg, jm, jp, build_model(cfg)


def _port_params(jp, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(3)
    v = 97
    logits = (rng.normal(size=(3, 11, v)) * 4).astype(np.float32)
    labels = rng.integers(0, v, size=(3, 11)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 5] = -1
    tl = torch.as_tensor(logits).to(getattr(torch, dtype))
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    got = float(cross_entropy(tl, torch.as_tensor(labels)))
    want = float(jax_cross_entropy(jl, jnp.asarray(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_cross_entropy_with_every_label_ignored_is_zero():
    logits = torch.randn(2, 5, 13, generator=torch.Generator().manual_seed(0))
    labels = torch.full((2, 5), -1)
    assert float(cross_entropy(logits, labels)) == 0.0
    assert float(jax_cross_entropy(jnp.asarray(logits.numpy()),
                                   jnp.asarray(labels.numpy()))) == 0.0


def test_cross_entropy_gradient_matches_reference():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(2, 9, 31)) * 3).astype(np.float32)
    labels = rng.integers(-1, 31, size=(2, 9)).astype(np.int32)
    want = np.asarray(jax.grad(jax_cross_entropy)(jnp.asarray(logits),
                                                  jnp.asarray(labels)))
    t = torch.as_tensor(logits).requires_grad_()
    cross_entropy(t, torch.as_tensor(labels)).backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# schedules, clipping, AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sched", ["cosine", "wsd", "const"])
@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 37), (100, 10_000)])
def test_schedule_lr_matches_reference(sched, warmup, total):
    kw = dict(lr=1e-3, warmup_steps=warmup, total_steps=total,
              schedule=sched)
    steps = sorted(set(range(0, min(total, 130))) | set(
        np.linspace(0, total + 20, 60).astype(int)))
    for s in steps:
        want = float(jopt.schedule_lr(jnp.int32(s), jopt.OptConfig(**kw)))
        got = opt.schedule_lr(torch.tensor(s, dtype=torch.int32),
                              opt.OptConfig(**kw))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * abs(want), (s, got, want)


def _pair_tree(rng):
    """The same random tree for both packages: fp32 and bf16 leaves."""
    raw = {"a": rng.normal(size=(5, 7)), "b": {
        "c": rng.normal(size=(33,)) * 3, "d": rng.normal(size=(4, 4))},
        "e": rng.normal(size=(2, 3, 2))}
    bf16 = {("b", "c"), ("e",)}
    port, ref = {}, {}
    for path, a in leaves_with_paths(raw):
        a = a.astype(np.float32)
        is_bf16 = path in bf16
        t = torch.as_tensor(a).to(torch.bfloat16 if is_bf16 else
                                  torch.float32)
        j = jnp.asarray(a).astype(jnp.bfloat16 if is_bf16 else jnp.float32)
        for tree, val in ((port, t), (ref, j)):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = val
    return port, ref


def _assert_leaf_close(got: torch.Tensor, want):
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        # within one bf16 ulp: adjacent bit patterns (same sign)
        g = got.view(torch.int16).numpy().astype(np.int32)
        w = want.view(np.int16).astype(np.int32)
        assert np.abs(g - w).max() <= 1, np.abs(g - w).max()
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("grad_clip", [1.0, 0.0, 50.0])
def test_adamw_matches_reference_over_three_steps(grad_clip):
    rng = np.random.default_rng(5)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=grad_clip)
    pp, jp = _pair_tree(rng)
    ps, js = opt.init_opt_state(pp), jopt.init_opt_state(jp)
    for _ in range(3):
        pg, jg = _pair_tree(rng)
        jp, js, jm = jopt.adamw_update(jp, jg, js, jopt.OptConfig(**kw))
        pp2, ps, pm = opt.adamw_update(pp, pg, ps, opt.OptConfig(**kw))
        assert pp2 is pp                                   # in place
        assert abs(float(pm["lr"]) - float(jm["lr"])) <= 1e-6 * float(
            jm["lr"])
        assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-6 * float(jm["grad_norm"])
    assert int(ps["step"]) == 3 and ps["step"].dtype == torch.int32
    for got, want in zip(leaves(pp), jax.tree.leaves(jp)):
        assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                             else torch.float32)
        _assert_leaf_close(got, want)
    for key in ("m", "v"):
        for got, want in zip(leaves(ps[key]), jax.tree.leaves(js[key])):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9)


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(6)
    pg, jg = _pair_tree(rng)
    want_n = float(jopt.global_norm(jg))
    assert abs(float(opt.global_norm(pg)) - want_n) <= 1e-6 * want_n
    jc, jn = jopt.clip_by_global_norm(jg, 0.5)
    pc, pn = opt.clip_by_global_norm(pg, 0.5)
    assert abs(float(pn) - float(jn)) <= 1e-6 * float(jn)
    for got, want in zip(leaves(pc), jax.tree.leaves(jc)):
        _assert_leaf_close(got, want)


def test_grad_clip():
    """Port of ``tests/test_training.py::test_grad_clip``."""
    g = {"a": torch.ones(10) * 100.0}
    clipped, gn = opt.clip_by_global_norm(g, 1.0)
    assert float(gn) > 100
    assert abs(float(opt.global_norm(clipped)) - 1.0) < 1e-5


@pytest.mark.parametrize("sched", ["cosine", "wsd", "const"])
def test_schedules(sched):
    """Port of ``tests/test_training.py::test_schedules``."""
    cfg = opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                        schedule=sched)
    lrs = [float(opt.schedule_lr(torch.tensor(s, dtype=torch.int32), cfg))
           for s in range(0, 101, 5)]
    assert lrs[0] < cfg.lr                       # warmup
    assert max(lrs) <= cfg.lr + 1e-9
    if sched in ("cosine", "wsd"):
        assert lrs[-1] < 0.35 * cfg.lr           # decayed at the end
    if sched == "wsd":
        mid = lrs[4:16]
        assert max(mid) - min(mid) < 1e-9


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        opt.schedule_lr(torch.tensor(3), opt.OptConfig(schedule="linear"))


def test_abstract_opt_state_matches_the_real_one():
    cfg = get_config("gemma3-1b", smoke=True)
    model = build_model(cfg)
    real = opt.init_opt_state(init_params(model.param_specs(), seed=0,
                                          device="cpu"))
    abstract = opt.abstract_opt_state(model.param_specs())
    for (pa, a), (pr, r) in zip(leaves_with_paths(abstract),
                                leaves_with_paths(real)):
        assert pa == pr and a.device.type == "meta"
        assert (a.shape, a.dtype) == (r.shape, r.dtype)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _lr_sum(kw, n):
    return sum(float(jopt.schedule_lr(jnp.int32(s), jopt.OptConfig(**kw)))
               for s in range(1, n + 1))


@pytest.mark.parametrize("arch,accum", [("gemma3-1b", 1),
                                        ("qwen2-moe-a2.7b", 1),
                                        ("gemma3-1b", 2),
                                        ("gemma3-1b", 4)])
def test_train_step_tracks_reference(arch, accum):
    """Five steps of the port's train step against the reference's jitted
    ``make_train_step`` (fp32, the same weights and batches): losses
    within 1e-4 relative, the gradient norm within 1e-4 relative, the
    parameters within 0.1 x the summed learning rate (module docstring),
    the moments' step equal."""
    n = 5
    cfg, jm, jp, pm = _models(arch, dtype="float32")
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    jstate = jax_init_state(jp)
    pstate = init_train_state(_port_params(jp, cfg))
    jstep = jax.jit(jax_make_step(jm, jopt.OptConfig(**kw), accum))
    pstep = make_train_step(pm, opt.OptConfig(**kw), accum)
    pipe = JPipeline(JDataConfig(vocab=cfg.vocab, seq_len=16,
                                 global_batch=4, seed=1))
    for i in range(n):
        b = pipe.batch(i)
        jstate, jmet = jstep(jstate, _jax_batch(b))
        pstate, pmet = pstep(pstate, _torch_batch(b))
        for key in ("loss", "grad_norm"):
            want = float(jmet[key])
            assert abs(float(pmet[key]) - want) <= 1e-4 * abs(want), \
                (i, key, float(pmet[key]), want)
    assert int(pstate["opt"]["step"]) == n
    bound = 0.1 * _lr_sum(kw, n)
    for got, want in zip(leaves(pstate["params"]),
                         jax.tree.leaves(jstate["params"])):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= bound


def test_grad_accum_matches_full_batch():
    """Port of ``tests/test_training.py::test_grad_accum_matches_full_batch``
    (bf16 minicpm smoke, accum 4 against 1, the reference's bounds)."""
    cfg = get_config("minicpm-2b", smoke=True)
    model = build_model(cfg)
    pipe = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16,
                                             global_batch=8, seed=2))
    batch = _torch_batch(pipe.batch(0))
    oc = opt.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                       schedule="const")
    out = {}
    for accum in (1, 4):
        state = init_train_state(init_params(model.param_specs(), seed=0,
                                             device="cpu"))
        out[accum] = make_train_step(model, oc, accum)(state, batch)
    (s1, m1), (s4, m4) = out[1], out[4]
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 2e-2
    d = max(float((a.float() - b.float()).abs().max())
            for a, b in zip(leaves(s1["params"]), leaves(s4["params"])))
    assert d < 5e-2


def test_accum_splits_rows_in_order_and_refuses_a_ragged_split():
    cfg = dataclasses.replace(get_config("codeqwen1.5-7b", smoke=True),
                              dtype="float32")
    model = build_model(cfg)
    params = init_params(model.param_specs(), seed=0, device="cpu")
    pipe = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=8,
                                             global_batch=6, seed=0))
    b = _torch_batch(pipe.batch(0))
    # the mean of the two halves' losses is the accum-2 step's loss
    halves = [float(loss_and_grads(model, params, {
        k: v[i * 3:(i + 1) * 3] for k, v in b.items()})[0]) for i in (0, 1)]
    step = make_train_step(model, opt.OptConfig(), 2)
    _, m = step(init_train_state(params), b)
    assert float(m["loss"]) == pytest.approx(sum(halves) / 2, rel=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, opt.OptConfig(), 4)(init_train_state(params),
                                                   b)


def test_grads_keep_the_parameter_dtype():
    """accum 1 hands AdamW bf16 gradients for bf16 parameters (as
    ``jax.value_and_grad``); unused leaves get zeros."""
    cfg = get_config("internvl2-2b", smoke=True)       # bf16
    model = build_model(cfg)
    params = init_params(model.param_specs(), seed=0, device="cpu")
    pipe = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=8,
                                             global_batch=2, seed=0))
    loss, grads = loss_and_grads(model, params, _torch_batch(pipe.batch(0)))
    assert loss.dtype == torch.float32 and not loss.requires_grad
    for p, g in zip(leaves(params), leaves(grads)):
        assert g.dtype == p.dtype and g.shape == p.shape
    # no patches in the batch: the projector gets a zero gradient
    assert not grads["patch_proj"].any()
    assert any(bool(g.any()) for g in leaves(grads["layers"]))


def test_loss_decreases_end_to_end():
    """Port of ``tests/test_training.py::test_loss_decreases_end_to_end``."""
    cfg = get_config("codeqwen1.5-7b", smoke=True)
    model = build_model(cfg)
    state = init_train_state(init_params(model.param_specs(), seed=0,
                                         device="cpu"))
    pipe = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                             global_batch=8, seed=1))
    step = make_train_step(model, opt.OptConfig(
        lr=3e-3, warmup_steps=5, total_steps=60, schedule="cosine"))
    losses = []
    for i in range(45):
        state, metrics = step(state, _torch_batch(pipe.batch(i)))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses[::10]
    assert np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
def _batch_for(cfg, seed=7):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, size=(2, 12)),
         "labels": rng.integers(-1, cfg.vocab, size=(2, 12))}
    if cfg.n_enc_layers:
        b["frames"] = rng.normal(size=(2, cfg.n_frames, cfg.d_model)
                                 ).astype(np.float32)
    if cfg.n_patches:
        b["patches"] = rng.normal(size=(2, cfg.n_patches, cfg.d_model)
                                  ).astype(np.float32)
    return _torch_batch(b)


def _layer_calls(cfg) -> int:
    """Checkpointed layer bodies in one forward."""
    if cfg.family == "hybrid":
        return cfg.n_layers                      # the Mamba-2 layers only
    return cfg.n_layers + cfg.n_enc_layers


@pytest.mark.parametrize("arch,policy", [
    ("gemma3-1b", "full"), ("gemma3-1b", "dots"),
    ("qwen2-moe-a2.7b", "full"), ("qwen2-moe-a2.7b", "dots"),
    ("internvl2-2b", "dots"), ("falcon-mamba-7b", "full"),
    ("zamba2-2.7b", "full"), ("whisper-medium", "full")])
def test_remat_gradients_equal_without_remat(arch, policy, monkeypatch):
    """A rematerialised step's loss and gradients equal, bit for bit, the
    same step without remat, and every layer body went through
    ``torch.utils.checkpoint`` (once per layer); scoring under
    ``no_grad`` checkpoints nothing."""
    import torch.utils.checkpoint as tuc
    calls = []
    real = tuc.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw.get("context_fn") is not None)
        return real(fn, *args, **kw)

    monkeypatch.setattr(tuc, "checkpoint", counting)
    base = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = init_params(build_model(base).param_specs(), seed=0,
                         device="cpu")
    batch = _batch_for(base)
    out = {}
    for remat, pol in ((False, "full"), (True, policy)):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=pol)
        calls.clear()
        out[remat] = loss_and_grads(build_model(cfg), params, batch)
        if not remat:
            assert calls == []
            continue
        assert len(calls) == _layer_calls(cfg)
        # the selective policy runs only where the reference reads it
        assert all(calls) == (pol == "dots" and cfg.family in
                              ("dense", "moe", "vlm"))
    (l0, g0), (l1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)
    calls.clear()
    with torch.no_grad():
        build_model(dataclasses.replace(base, remat=True)).loss(params,
                                                                batch)
    assert calls == []


def test_remat_none_policy_checkpoints_nothing(monkeypatch):
    import torch.utils.checkpoint as tuc
    monkeypatch.setattr(tuc, "checkpoint", lambda *a, **k: pytest.fail(
        "checkpointed under remat_policy='none'"))
    cfg = dataclasses.replace(get_config("gemma3-1b", smoke=True),
                              remat=True, remat_policy="none")
    model = build_model(cfg)
    params = init_params(model.param_specs(), seed=0, device="cpu")
    loss, _ = loss_and_grads(model, params, _batch_for(cfg))
    assert torch.isfinite(loss)
