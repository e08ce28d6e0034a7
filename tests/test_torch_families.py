"""The port's generation families against the reference's on the same
weights: gemma3's sliding window, the MoE decoders, Mamba-1
(falcon-mamba), the Mamba-2 hybrid (zamba2) and the audio
encoder-decoder (whisper).

Weights are drawn by the reference and handed over with
``params_from_jax``; tokens and frames are numpy draws from a seed.  Each
family is checked three ways: logits over a sequence, prefill (its last
logits equal the reference's prefill logits, and its cache equals the
reference's cache after replaying ``decode_step`` over the prompt from a
zero state: the reference's SSM, hybrid and enc-dec prefills leave the
states the port fills at zero), and decode steps at ragged positions
from there.  fp32 cases agree within ``1e-4`` absolute and relative (the
frameworks sum in different orders); one bf16 case per family
(``tests/test_torch_families_bf16.py``) is held to ``6e-2``, the
reference's own bf16 decode-vs-forward bound (``tests/test_serving.py``).  gemma3's smoke window is 8, and its
prompts and decode positions run past it.  The port's caches are
compared in the reference's layout: K/V ``[.., n_kv, s, hd]`` swapped to
``[.., s, n_kv, hd]``, the hybrid's ``[L, b, ..]`` states split to
``[n_groups, attn_every, b, ..]``.
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
from repro.models import moe as jax_moe
from repro.models.transformer import window_pattern as jax_window_pattern
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import moe as port_moe
from repro_torch.models.transformer import window_pattern
from repro_torch.serving import ContinuousBatcher, Request, generate

torch.set_num_threads(1)

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
F32 = dict(dtype="float32")

CASES = {
    "gemma3": "gemma3-1b",
    "qwen2-moe": "qwen2-moe-a2.7b",
    "qwen3-moe": "qwen3-moe-235b-a22b",
    "falcon-mamba": "falcon-mamba-7b",
    "zamba2": "zamba2-2.7b",
    "whisper": "whisper-medium",
}
PROMPT = 14             # past gemma3's smoke window of 8
SMAX = 24


@pytest.fixture(autouse=True)
def _jax_clean():
    """Release the reference's compiled executables after each test."""
    yield
    jax.clear_caches()
    gc.collect()


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _models(arch, over, seed=0):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jm = jax_build_model(jcfg)
    jp = jax.jit(functools.partial(jax_init_params, jm.param_specs()))(
        jax.random.key(seed))
    pm = build_model(cfg)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jm, jp, pm, pp


def answers(arch: str, over: dict) -> dict:
    """One family case and the reference's answers on it, computed once:
    logits over ``prompt``; prefill logits over it and the cache
    the prompt leaves (the decoder families' prefill fills it; the SSM,
    hybrid and enc-dec prefills leave their states zero, so those are
    filled by replaying ``decode_step`` over the prompt, from the cache
    the prefill returns with whisper's cross K/V in it); then three
    decode steps at ragged positions ``pos`` (row 1 three ahead of row
    0; the skipped positions stay zero in both caches) with their logits
    and caches.  fp32 cases run the reference jitted; bf16 cases run it
    op by op (``jax.disable_jit``): XLA's fusion of the jitted layer body
    keeps some bf16 intermediates at higher precision, which moves the
    reference's own bf16 logits (by 0.19 on the qwen2-moe smoke
    config), while the port rounds where the reference's source says."""
    cfg, jm, jp, pm, pp = _models(arch, over)
    rng = np.random.default_rng(1)
    f = dict(cfg=cfg, pm=pm, pp=pp,
             tol=BF16_TOL if cfg.dtype == "bfloat16" else FP32_TOL,
             frames=(rng.normal(size=(2, cfg.n_frames, cfg.d_model))
                     .astype(np.float32) if cfg.n_enc_layers else None),
             prompt=rng.integers(0, cfg.vocab, size=(2, PROMPT)
                                 ).astype(np.int32),
             steps=rng.integers(0, cfg.vocab, size=(3, 2, 1)
                                ).astype(np.int32))
    extra = _extra(f, "jax")
    op_by_op = cfg.dtype == "bfloat16"
    jit = (lambda fn: fn) if op_by_op else jax.jit
    with jax.disable_jit(op_by_op):
        jl, jaux = jit(jm.logits)(jp, jnp.asarray(f["prompt"]), *extra)
        f["logits"] = (_f32(jl), float(jaux))
        pl, jc = jit(jm.prefill)(jp, jnp.asarray(f["prompt"]),
                                 jm.init_cache(2, SMAX), *extra)
        step = jit(jm.decode_step)
        if cfg.family not in ("dense", "moe", "vlm"):
            for t in range(PROMPT):
                _, jc = step(jp, jnp.asarray(f["prompt"][:, t:t + 1]), jc,
                             jnp.full((2,), t, jnp.int32))
        f["prefill"] = (_f32(pl), jax.tree.map(np.asarray, jc))
        pos = np.asarray([PROMPT, PROMPT + 3], np.int32)
        f["decode"] = []
        for t in range(3):
            jd, jc = step(jp, jnp.asarray(f["steps"][t]), jc,
                          jnp.asarray(pos))
            f["decode"].append((pos, _f32(jd), jax.tree.map(np.asarray, jc)))
            pos = pos + 1
    return f


def _extra(fam, lib):
    f = fam["frames"]
    if f is None:
        return ()
    return (jnp.asarray(f),) if lib == "jax" else (torch.as_tensor(f),)


def _ref_layout(fam, name, a: np.ndarray) -> np.ndarray:
    """A port cache entry in the reference's layout."""
    if name in ("k", "v", "xk", "xv"):
        return np.swapaxes(a, 2, 3)
    if fam["cfg"].family == "hybrid":
        g = fam["cfg"].n_layers // fam["cfg"].attn_every
        return a.reshape(g, -1, *a.shape[1:])
    return a


def _port_cache(fam, jc) -> dict:
    """A reference cache in the port's layout and dtypes."""
    cache = fam["pm"].init_cache(2, SMAX, device="cpu")
    for name, t in cache.items():
        a = np.array(jc[name], np.float32)
        if name in ("k", "v", "xk", "xv"):
            a = np.swapaxes(a, 2, 3)
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)).reshape(t.shape))
    return cache


def _assert_cache(fam, pc, jc, names=None):
    assert set(pc) == set(jc)
    for name in (pc if names is None else names):
        np.testing.assert_allclose(_ref_layout(fam, name, _f32(pc[name])),
                                   _f32(jc[name]), **fam["tol"],
                                   err_msg=name)


def check_logits(fam):
    cfg, tol = fam["cfg"], fam["tol"]
    pl, aux = fam["pm"].logits(fam["pp"], fam["prompt"],
                               *_extra(fam, "torch"))
    assert pl.shape == (2, PROMPT, cfg.vocab)
    assert pl.dtype == cfg.compute_dtype
    np.testing.assert_allclose(_f32(pl), fam["logits"][0], **tol)
    np.testing.assert_allclose(float(aux), fam["logits"][1], **tol)


def check_prefill(fam):
    """Prefill overwrites a reused slot's stale state (the cache is
    filled with 3.0 first) with what the prompt leaves in the reference.
    In bf16 the cache is held where the reference's prefill fills it
    itself (the decoder families' K/V, whisper's cross K/V): the states
    its decode replay leaves come from another path, whose bf16 rounding
    points differ from the forward's (the forward rounds the conv output
    and the SSM's projections to bf16 where the decode step keeps fp32;
    zamba2's states then differ by more than 6e-2 at a few entries);
    fp32 holds every entry to 1e-4."""
    cfg = fam["cfg"]
    jl, jc = fam["prefill"]
    pc = fam["pm"].init_cache(2, SMAX, device="cpu")
    for t in pc.values():
        t.fill_(3.0)
    pl, pc2 = fam["pm"].prefill(fam["pp"], fam["prompt"], pc,
                                *_extra(fam, "torch"))
    assert pc2 is pc
    np.testing.assert_allclose(_f32(pl), jl, **fam["tol"])
    if "k" in pc:                          # positions past the prompt
        assert bool((pc["k"][:, :, :, PROMPT:] == 3.0).all())
        for name in ("k", "v"):
            pc[name][:, :, :, PROMPT:] = 0.0
    names = None
    if cfg.dtype == "bfloat16":
        names = [n for n in ("k", "v", "xk", "xv") if n in pc
                 and (n[0] == "x" or cfg.family in ("dense", "moe"))]
    _assert_cache(fam, pc, jc, names)


def check_decode(fam):
    """From the reference's cache after the prompt, three decode steps at
    ragged positions: logits and the whole cache agree after every
    step."""
    cfg, pm = fam["cfg"], fam["pm"]
    pc = _port_cache(fam, fam["prefill"][1])
    for tok, (pos, jd, jc) in zip(fam["steps"], fam["decode"]):
        pd, pc = pm.decode_step(fam["pp"], tok, pc, torch.as_tensor(pos))
        assert pd.shape == (2, 1, cfg.vocab)
        np.testing.assert_allclose(_f32(pd), jd, **fam["tol"])
        _assert_cache(fam, pc, jc)


@pytest.fixture(scope="module", params=list(CASES))
def fam(request):
    return answers(CASES[request.param], F32)


def test_logits_match_reference(fam):
    check_logits(fam)


def test_prefill_fills_the_states_a_decode_replay_leaves(fam):
    check_prefill(fam)


def test_ragged_decode_matches_reference(fam):
    check_decode(fam)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_window_pattern_matches_reference(arch):
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        np.testing.assert_array_equal(
            window_pattern(cfg),
            jax_window_pattern(jax_get_config(arch, smoke=smoke)))
    if arch == "gemma3-1b":                # layers 6, 12, 18, 24 global
        w = window_pattern(get_config(arch))
        assert np.flatnonzero(w < 0).tolist() == [5, 11, 17, 23]
        assert int((w == 512).sum()) == 22


def test_decode_hands_b5_each_layers_window():
    cfg, _, _, pm, pp = _models("gemma3-1b", F32)
    seen = []
    real = fd.flash_decode_call

    def spy(q, k, v, lengths, window=-1):
        seen.append(window)
        return real(q, k, v, lengths, window)
    cache = pm.init_cache(1, SMAX, device="cpu")
    pm.prefill(pp, np.arange(2, 12)[None], cache)
    fd.flash_decode_call = spy
    try:
        pm.decode_step(pp, [[5]], cache, torch.as_tensor([10]))
    finally:
        fd.flash_decode_call = real
    assert seen == window_pattern(cfg).tolist() == [8, 8, -1, 8, 8, -1]


def _reference_routing(x, router, cfg):
    """The reference's routing lines (``repro.models.moe.moe``): expert
    ids and the kept mask in the flat assignment order."""
    t, k, e = x.shape[0], cfg.top_k, cfg.n_experts
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    flat_e = ids.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    counts = jnp.zeros(e, jnp.int32).at[se].add(1)
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(counts)[:-1]])
    keep_sorted = (jnp.arange(t * k) - starts[se]) < jax_moe._capacity(t,
                                                                      cfg)
    keep = np.zeros(t * k, bool)
    keep[np.asarray(order)] = np.asarray(keep_sorted)
    return np.asarray(ids), keep


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_moe_routing_and_capacity_drops_match_reference(arch):
    """64 tokens leaning on expert 0, so its capacity drops most of them:
    the expert ids and the kept mask equal the reference's before the
    outputs and the aux loss are compared."""
    cfg, _, jp, _, _ = _models(arch, F32)
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **F32)
    rng = np.random.default_rng(5)
    d, e = cfg.d_model, cfg.n_experts
    x = (rng.normal(size=(1, 64, d)) + 1.0).astype(np.float32)
    p = jax.tree.map(lambda a: np.array(a[0]), jp["layers"]["ffn"])
    p["router"] = (rng.normal(size=(d, e)) * 0.1).astype(np.float32)
    p["router"][:, 0] += 0.2
    ids, keep = _reference_routing(x[0], p["router"], jcfg)
    tp = jax.tree.map(torch.as_tensor, p)
    got_ids, _, _, kept, slot = port_moe.route(torch.as_tensor(x[0]),
                                               tp["router"], cfg)
    got_keep = np.zeros(64 * cfg.top_k, bool)
    got_keep[kept.numpy()] = True
    np.testing.assert_array_equal(got_ids.numpy(), ids)
    np.testing.assert_array_equal(got_keep, keep)
    assert 0 < keep.sum() < keep.size                 # something dropped
    assert slot.max() < port_moe._capacity(64, cfg)
    jy, jaux = jax_moe.moe(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                           jcfg)
    y, aux = port_moe.moe(torch.as_tensor(x), tp, cfg)
    np.testing.assert_allclose(_f32(y), _f32(jy), **FP32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **FP32_TOL)
    y2, _ = port_moe.moe_local(torch.as_tensor(x), tp, cfg)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("block", ["mamba1", "mamba2"])
def test_ssm_blocks_match_reference_across_chunks(block):
    """One Mamba block over 14 positions in chunks of 4: the chunked scans
    carry their state across chunk boundaries (and the last, padded
    chunk) as the reference's do; fp32."""
    from repro.models import ssm as jax_ssm
    from repro_torch.models import ssm as port_ssm
    arch = "falcon-mamba-7b" if block == "mamba1" else "zamba2-2.7b"
    cfg, _, jp, _, pp = _models(arch, F32)
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **F32)
    if block == "mamba1":
        jpb = jax.tree.map(lambda a: a[0], jp["layers"]["ssm"])
        ppb = {k: v[0] for k, v in pp["layers"]["ssm"].items()}
    else:
        jpb = jax.tree.map(lambda a: a[0, 0], jp["ssm_layers"]["ssm"])
        ppb = {k: v[0, 0] for k, v in pp["ssm_layers"]["ssm"].items()}
    x = np.random.default_rng(8).normal(size=(2, PROMPT, cfg.d_model)
                                        ).astype(np.float32)
    want = getattr(jax_ssm, block)(jnp.asarray(x), jpb, jcfg, chunk=4)
    got = getattr(port_ssm, block)(torch.as_tensor(x), ppb, cfg, chunk=4)
    np.testing.assert_allclose(_f32(got), _f32(want), **FP32_TOL)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["gemma3-1b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "qwen2-moe-a2.7b"])
def test_batcher_reuses_slots_and_matches_generate(arch):
    """Five requests through two slots: each reused slot's prefill
    overwrites what its last occupant left (K/V, conv and SSM states),
    so every request's tokens equal ``generate`` on it alone."""
    cfg, _, _, pm, pp = _models(arch, F32)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, cfg.vocab, size=int(n)).astype(np.int32)
               for n in (12, 3, 9, 14, 5)]
    batcher = ContinuousBatcher(pm, pp, n_slots=2, max_len=SMAX + 8,
                                eos_id=-1)
    for i, p in enumerate(prompts):
        batcher.submit(Request(req_id=i, prompt=p, max_new=5))
    done = {r.req_id: r.output for r in batcher.run_until_drained()}
    for i, p in enumerate(prompts):
        want = generate(pm, pp, p[None], max_new=5, max_len=SMAX + 8)
        assert done[i] == want[0].tolist(), i


@pytest.mark.parametrize("arch", ["whisper-medium", "falcon-mamba-7b",
                                  "zamba2-2.7b"])
def test_generate_equals_greedy_forward(arch):
    """``generate`` (prefill, then decode steps through B5's twin, with
    whisper's frames as ``extra``) picks the argmax of the full forward
    over prompt + generated tokens at every step."""
    cfg, _, _, pm, pp = _models(arch, F32)
    rng = np.random.default_rng(7)
    prompt = rng.integers(2, cfg.vocab, size=(2, 6)).astype(np.int32)
    frames = (torch.as_tensor(rng.normal(size=(2, cfg.n_frames, cfg.d_model))
                              .astype(np.float32))
              if cfg.n_enc_layers else None)
    out = generate(pm, pp, prompt, max_new=6, extra=frames)
    full = np.concatenate([prompt, out[:, :-1].numpy()], axis=1)
    lg, _ = pm.logits(pp, full, *(() if frames is None else (frames,)))
    np.testing.assert_array_equal(out.numpy(),
                                  lg[:, 5:].argmax(-1).numpy())
