"""The port's decoder LM (``repro_torch.models``) against the reference's
(``repro.models``) on the same weights.

Weights are drawn by the reference and handed over with
``params_from_jax``; token ids are numpy draws from a seed.  The smoke
configs of ``internvl2-2b`` (``n_patches`` 0 and 8), ``codeqwen1.5-7b``,
``starcoder2-15b`` (GELU MLP, GQA group 4) and ``minicpm-2b`` run with
``dtype="float32"``: logits, prefill (last logits and the filled cache)
and decode steps with ragged positions (through kernel B5's twin) agree
within ``1e-4`` absolute and relative — the two frameworks sum in
different orders, nothing else differs.  One ``bfloat16`` case is held
to ``6e-2``, the reference's own bf16 decode-vs-forward bound
(``tests/test_serving.py``): bf16 keeps 8 bits, and the port's decode
attention runs in fp32 where the reference rounds scores and
probabilities to bf16.  The port's cache is ``[L, b, n_kv, smax, hd]``
and is permuted to the reference's ``[L, b, smax, n_kv, hd]`` for the
comparison.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import (build_model, count_params, init_params,
                                params_from_jax)
from repro_torch.models.common import iter_specs

torch.set_num_threads(1)

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)

CASES = {
    "internvl2-text": ("internvl2-2b", dict(n_patches=0, dtype="float32")),
    "internvl2-patches": ("internvl2-2b", dict(dtype="float32")),
    "codeqwen": ("codeqwen1.5-7b", dict(dtype="float32")),
    "starcoder2": ("starcoder2-15b", dict(dtype="float32")),
    "minicpm": ("minicpm-2b", dict(dtype="float32")),
    "internvl2-bf16": ("internvl2-2b", dict(n_patches=0)),
}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    arch, over = CASES[request.param]
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jm = jax_build_model(jcfg)
    jp = jax_init_params(jm.param_specs(), jax.random.key(0))
    pm = build_model(cfg)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tol = BF16_TOL if cfg.dtype == "bfloat16" else FP32_TOL
    rng = np.random.default_rng(1)
    patches = (rng.normal(size=(2, cfg.n_patches, cfg.d_model))
               .astype(np.float32) if cfg.n_patches else None)
    return dict(cfg=cfg, jm=jm, jp=jp, pm=pm, pp=pp, tol=tol,
                patches=patches)


def _patches(pair, lib):
    p = pair["patches"]
    if p is None:
        return None
    return jnp.asarray(p) if lib == "jax" else torch.as_tensor(p)


def test_logits_match_reference(pair):
    cfg, tol = pair["cfg"], pair["tol"]
    toks = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 9))
    jl, _ = pair["jm"].logits(pair["jp"], jnp.asarray(toks, jnp.int32),
                              _patches(pair, "jax"))
    pl, aux = pair["pm"].logits(pair["pp"], toks, _patches(pair, "torch"))
    assert pl.shape == (2, 9 + cfg.n_patches * (pair["patches"] is not None),
                        cfg.vocab)
    assert pl.dtype == cfg.compute_dtype and float(aux) == 0.0
    np.testing.assert_allclose(_f32(pl), _f32(jl), **tol)


def test_prefill_and_ragged_decode_match_reference(pair):
    """prefill, then three decode steps at ragged per-row positions (row 1
    skips ahead, so the two rows hand B5 different lengths); the logits
    and the whole cache agree after every step."""
    cfg, tol, jm, pm = pair["cfg"], pair["tol"], pair["jm"], pair["pm"]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(2, 7)).astype(np.int32)
    smax = 24
    jc = jm.init_cache(2, smax)
    pc = pm.init_cache(2, smax, device="cpu")
    assert pc["k"].shape == (cfg.n_layers, 2, cfg.n_kv, smax, cfg.hd)
    jl, jc = jm.prefill(pair["jp"], jnp.asarray(toks), jc,
                        _patches(pair, "jax"))
    pl, pc2 = pm.prefill(pair["pp"], toks, pc, _patches(pair, "torch"))
    assert pc2 is pc                                 # written in place
    np.testing.assert_allclose(_f32(pl), _f32(jl), **tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(_f32(pc[name].permute(0, 1, 3, 2, 4)),
                                   _f32(jc[name]), **tol)
    filled = toks.shape[1] + (cfg.n_patches if pair["patches"] is not None
                              else 0)
    pos = np.asarray([filled, filled + 3], np.int32)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        jd, jc = jm.decode_step(pair["jp"], jnp.asarray(tok), jc,
                                jnp.asarray(pos))
        pd, pc = pm.decode_step(pair["pp"], tok, pc, torch.as_tensor(pos))
        assert pd.shape == (2, 1, cfg.vocab)
        np.testing.assert_allclose(_f32(pd), _f32(jd), **tol)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                _f32(pc[name].permute(0, 1, 3, 2, 4)), _f32(jc[name]), **tol)
        pos = pos + 1


def test_chunked_prefill_matches_reference():
    """A prompt that is a multiple of ``attn_q_chunk`` takes the query-
    block chunked attention in both packages; it agrees with the
    reference and with the port's own unchunked attention."""
    over = dict(dtype="float32", attn_q_chunk=4)
    jcfg = dataclasses.replace(jax_get_config("codeqwen1.5-7b", smoke=True),
                               **over)
    cfg = dataclasses.replace(get_config("codeqwen1.5-7b", smoke=True),
                              **over)
    jm = jax_build_model(jcfg)
    jp = jax_init_params(jm.param_specs(), jax.random.key(1))
    pm = build_model(cfg)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 12))
    jc = jm.init_cache(2, 16)
    pc = pm.init_cache(2, 16, device="cpu")
    jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32), jc)
    pl, pc = pm.prefill(pp, toks, pc)
    np.testing.assert_allclose(_f32(pl), _f32(jl), **FP32_TOL)
    np.testing.assert_allclose(_f32(pc["k"].permute(0, 1, 3, 2, 4)),
                               _f32(jc["k"]), **FP32_TOL)
    whole = build_model(dataclasses.replace(cfg, attn_q_chunk=1024))
    chunked, _ = pm.logits(pp, toks)
    unchunked, _ = whole.logits(pp, toks)
    np.testing.assert_allclose(_f32(chunked), _f32(unchunked), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(arch, smoke):
    assert ARCH_IDS == JAX_ARCH_IDS
    mine = dataclasses.asdict(get_config(arch, smoke=smoke))
    theirs = dataclasses.asdict(jax_get_config(arch, smoke=smoke))
    assert mine == theirs


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_param_count_matches_reference(arch):
    cfg = get_config(arch)
    assert cfg.n_params() == jax_get_config(arch).n_params()
    assert count_params(build_model(cfg).param_specs()) == cfg.n_params()


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_every_config_builds_with_the_reference_tree(arch):
    """Every family builds, and its spec tree has the reference's paths,
    shapes and dtypes leaf for leaf (what ``params_from_jax`` relies
    on)."""
    from repro.models.common import Spec as JaxSpec
    cfg = get_config(arch, smoke=True)
    mine = dict(iter_specs(build_model(cfg).param_specs()))
    theirs = jax.tree_util.tree_flatten_with_path(
        jax_build_model(jax_get_config(arch, smoke=True)).param_specs(),
        is_leaf=lambda v: isinstance(v, JaxSpec))[0]
    theirs = {".".join(k.key for k in path): sp for path, sp in theirs}
    assert set(mine) == set(theirs)
    for path, sp in mine.items():
        assert sp.shape == theirs[path].shape, path
        assert str(sp.dtype).split(".")[-1] == \
            jnp.dtype(theirs[path].dtype).name, path
        assert sp.init == theirs[path].init, path


def test_init_params_scale_rule_and_seed():
    cfg = get_config("internvl2-2b", smoke=True)
    specs = build_model(cfg).param_specs()
    a = init_params(specs, seed=0, device="cpu")
    b = init_params(specs, seed=0, device="cpu")
    c = init_params(specs, seed=1, device="cpu")
    assert torch.equal(a["embed"]["embedding"], b["embed"]["embedding"])
    assert not torch.equal(a["embed"]["embedding"], c["embed"]["embedding"])
    assert a["layers"]["attn"]["wq"].shape == (cfg.n_layers, cfg.d_model,
                                               cfg.n_heads * cfg.hd)
    assert a["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert torch.equal(a["layers"]["ln1"],
                       torch.ones_like(a["layers"]["ln1"]))
    # std = 1/sqrt(shape[-2]): [vocab, d] embeddings get 1/sqrt(vocab)
    emb = a["embed"]["embedding"].float()
    assert abs(emb.std().item() * math.sqrt(cfg.vocab) - 1.0) < 0.05
    w = a["layers"]["ffn"]["w_down"].float()
    assert abs(w.std().item() * math.sqrt(cfg.d_ff) - 1.0) < 0.05


def test_params_from_jax_rejects_a_wrong_shape():
    cfg = dataclasses.replace(get_config("codeqwen1.5-7b", smoke=True),
                              dtype="float32")
    jcfg = dataclasses.replace(jax_get_config("codeqwen1.5-7b", smoke=True),
                               dtype="float32")
    jm = jax_build_model(jcfg)
    npp = jax.tree.map(np.asarray,
                       jax_init_params(jm.param_specs(), jax.random.key(0)))
    npp["final_norm"] = npp["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(npp, cfg, device="cpu")


def test_model_entry_points_default_to_the_card():
    """Without a card the default device raises instead of falling back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("codeqwen1.5-7b", smoke=True)
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        init_params(model.param_specs())
