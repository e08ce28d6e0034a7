"""The training loss and its gradients for every architecture's smoke
model: the port's ``model.loss`` through ``torch.autograd`` against
``jax.value_and_grad(model.loss)`` of the reference, in fp32 on the same
weights (drawn by the reference, carried by ``params_from_jax``) and the
same batch (numpy draws from a seed; some labels -1, so the mask is
exercised; frames for whisper, patches for internvl2, whose patch
positions carry label -1 in both), with and without remat.

Tolerances: the loss within 1e-5 relative; each gradient leaf within
``1e-4 x max|reference leaf|`` (the two frameworks sum in different
orders; nothing else differs).  The MoE smoke models route the same
experts in both packages here, so no routing is forced.
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
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.training.train_step import loss_and_grads
from repro_torch.training.tree import leaves_with_paths

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4          # of the reference leaf's largest magnitude


@pytest.fixture(autouse=True)
def _jax_clean():
    """Release the reference's compiled executables after each test."""
    yield
    jax.clear_caches()
    gc.collect()


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, size=(2, 16)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, size=(2, 16)).astype(np.int32)}
    b["labels"][0, :3] = -1
    b["labels"][1, 7] = -1
    if cfg.n_enc_layers:
        b["frames"] = rng.normal(size=(2, cfg.n_frames, cfg.d_model)
                                 ).astype(np.float32)
    if cfg.n_patches:
        b["patches"] = rng.normal(size=(2, cfg.n_patches, cfg.d_model)
                                  ).astype(np.float32)
    return b


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch, remat):
    """fp32; with ``remat`` both packages rematerialise each layer body
    (``jax.remat`` against ``torch.utils.checkpoint``, policy ``full``)."""
    over = dict(dtype="float32", remat=remat)
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jm = jax_build_model(jcfg)
    jp = jax.jit(functools.partial(jax_init_params, jm.param_specs()))(
        jax.random.key(0))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    batch = _batch(cfg)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(build_model(cfg), pp, {
        k: torch.as_tensor(v) for k, v in batch.items()})
    assert np.isfinite(float(loss))
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jg)))
    got = leaves_with_paths(grads)
    assert [p for p, _ in got] == sorted(want)
    nonzero = 0
    for path, g in got:
        w = want[path]
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        scale = float(np.abs(w).max())
        diff = float(np.abs(g.numpy() - w).max())
        assert diff <= GRAD_RTOL * scale, (path, diff, scale)
        nonzero += scale > 0
    assert nonzero == len(got)               # every leaf reached
