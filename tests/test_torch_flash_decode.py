"""Kernel B5 (fused single-token GQA decode attention): the port's wrapper
on CPU tensors (its plain twin) against the reference's Pallas kernel in
interpret mode and against the reference oracle.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference's own (``tests/test_kernels.py``): fp32
``2e-4`` and bf16 ``5e-2`` (absolute and relative): the twin computes in
fp32 and rounds the output once to bf16, the Pallas kernel rounds its
probabilities to the value dtype before the second product.  The
reference kernel has no window: the windowed twin is held to a numpy
brute force and, inside a decode layer, to the reference's
``attention_decode`` at the same window.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode_kernel_call
from repro.kernels.ref import flash_decode_ref as jax_flash_decode_ref
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels.ref import flash_decode_ref

torch.set_num_threads(1)


def _inputs(bkv, g, smax, hd, seed, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bkv, g, hd)).astype(np.float32)
    k = rng.normal(size=(bkv, smax, hd)).astype(np.float32)
    v = rng.normal(size=(bkv, smax, hd)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, smax, size=bkv)
    return q, k, v, np.asarray(lengths, np.int32)


def _port(q, k, v, lengths, dtype=torch.float32, window=-1):
    t = [torch.as_tensor(a).to(dtype) for a in (q, k, v)]
    return fd.flash_decode_call(*t, torch.as_tensor(lengths), window)


# (bkv, g, smax, hd, ts): the reference's own shapes, then g = 1 and g = 2
# (the reference kernel runs them in interpret mode), lengths 0 and
# smax - 1 included.
@pytest.mark.parametrize("bkv,g,smax,hd,ts,lengths", [
    (4, 8, 512, 128, 128, None),
    (2, 16, 1024, 128, 256, None),
    (8, 8, 256, 256, 128, None),
    (3, 1, 256, 64, 128, [0, 255, 100]),
    (4, 2, 384, 128, 128, [0, 383, 1, 200]),
])
def test_flash_decode_twin_matches_reference_fp32(bkv, g, smax, hd, ts,
                                                  lengths):
    q, k, v, ln = _inputs(bkv, g, smax, hd, bkv * 100 + g, lengths)
    got = _port(q, k, v, ln).numpy()
    kern = np.asarray(flash_decode_kernel_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln),
        ts=ts))
    want = np.asarray(jax_flash_decode_ref(q, k, v, jnp.asarray(ln)))
    np.testing.assert_allclose(got, kern, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("g,lengths", [(8, [100, 255]), (2, [0, 255]),
                                       (1, [255, 7])])
def test_flash_decode_twin_matches_reference_bf16(g, lengths):
    rng = np.random.default_rng(7)
    q = jnp.asarray(rng.normal(size=(2, g, 128)), jnp.bfloat16)
    k = jnp.asarray(rng.normal(size=(2, 256, 128)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(2, 256, 128)), jnp.bfloat16)
    ln = jnp.asarray(lengths, jnp.int32)
    kern = np.asarray(flash_decode_kernel_call(q, k, v, ln, ts=128),
                      np.float32)
    want = np.asarray(jax_flash_decode_ref(q, k, v, ln), np.float32)
    # the same bf16 values reach the port (bf16 -> fp32 is exact)
    got = _port(*(np.asarray(a, np.float32) for a in (q, k, v)),
                np.asarray(lengths, np.int32), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, kern, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_flash_decode_length_zero_is_first_value_row():
    """lengths = 0 attends to column 0 alone: the output is V[:, 0]."""
    q, k, v, _ = _inputs(3, 2, 33, 64, 11)
    got = _port(q, k, v, np.zeros(3, np.int32)).numpy()
    np.testing.assert_allclose(got, np.broadcast_to(v[:, :1], got.shape),
                               rtol=1e-6, atol=1e-6)


def test_flash_decode_ignores_columns_past_the_prefix():
    """Whatever lies past lengths[r] (stale K/V of an earlier slot
    occupant) does not change the answer."""
    q, k, v, ln = _inputs(4, 2, 97, 64, 12, [3, 96, 50, 0])
    a = _port(q, k, v, ln).numpy()
    k2, v2 = k.copy(), v.copy()
    for r, n in enumerate(ln):
        k2[r, n + 1:] = 1e4
        v2[r, n + 1:] = -1e4
    b = _port(q, k2, v2, ln).numpy()
    np.testing.assert_array_equal(a, b)


def test_flash_decode_cpu_runs_twin_and_counts_no_launch():
    q, k, v, ln = _inputs(2, 4, 64, 64, 13)
    before = fd.launch_count()
    got = _port(q, k, v, ln)
    want = flash_decode_ref(*(torch.as_tensor(a) for a in (q, k, v)),
                            torch.as_tensor(ln))
    assert torch.equal(got, want)
    assert fd.launch_count() == before


@pytest.mark.parametrize("case", ["rank", "cache_shape", "lengths_shape",
                                  "dtype_mix", "lengths_dtype"])
def test_flash_decode_rejects_bad_inputs(case):
    q, k, v, ln = (torch.as_tensor(a) for a in _inputs(2, 2, 16, 64, 14))
    args = {
        "rank": (q[0], k, v, ln),
        "cache_shape": (q, k[:, :, :32], v, ln),
        "lengths_shape": (q, k, v, ln[:1]),
        "dtype_mix": (q, k.to(torch.bfloat16), v, ln),
        "lengths_dtype": (q, k, v, ln.long()),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        fd.flash_decode_call(*args)


# ---------------------------------------------------------------------------
# The sliding window: row r reads columns max(0, lengths[r] - window) ..
# lengths[r] (src/repro/models/layers.py::attention_decode)
# ---------------------------------------------------------------------------
def _brute(q, k, v, lengths, window):
    """numpy, one row and head at a time, over the window's columns."""
    out = np.zeros(q.shape, np.float64)
    for r in range(q.shape[0]):
        hi = int(lengths[r])
        lo = 0 if window < 0 else max(0, hi - window)
        kk, vv = k[r, lo:hi + 1].astype(np.float64), v[r, lo:hi + 1]
        for h in range(q.shape[1]):
            s = kk @ q[r, h].astype(np.float64) / np.sqrt(q.shape[2])
            p = np.exp(s - s.max())
            out[r, h] = p @ vv / p.sum()
    return out


# window 0, a window starting inside a 64-key tile, one longer than the
# prefix, global; lengths 0 and smax - 1 in every case
@pytest.mark.parametrize("window", [0, 5, 100, 1000, -1])
@pytest.mark.parametrize("hd", [64, 80])
def test_flash_decode_window_matches_brute_force(window, hd):
    q, k, v, ln = _inputs(6, 2, 300, hd, 15, [0, 299, 70, 130, 3, 200])
    got = _port(q, k, v, ln, window=window).numpy()
    np.testing.assert_allclose(got, _brute(q, k, v, ln, window), rtol=1e-5,
                               atol=1e-5)


def test_flash_decode_window_ignores_columns_outside_it():
    """Keys before the window and past the prefix do not change the
    answer."""
    q, k, v, ln = _inputs(4, 4, 97, 80, 16, [3, 96, 50, 0])
    a = _port(q, k, v, ln, window=7).numpy()
    k2, v2 = k.copy(), v.copy()
    for r, n in enumerate(ln):
        k2[r, n + 1:], v2[r, n + 1:] = 1e4, -1e4
        k2[r, :max(0, n - 7)], v2[r, :max(0, n - 7)] = -1e4, 1e4
    np.testing.assert_array_equal(a, _port(q, k2, v2, ln, window=7).numpy())


@pytest.mark.parametrize("window", [0, 3, 8, -1])
def test_windowed_decode_layer_matches_reference(window):
    """One decode step of one layer through the port's ``attention_decode``
    (B5's twin at the layer's window) against the reference's
    ``attention_decode`` at the same window: smoke gemma3 widths in fp32,
    positions before, at and past the window."""
    import dataclasses
    from repro.configs import get_config as jax_get_config
    from repro.models.layers import attention_decode as jax_attention_decode
    from repro_torch.configs import get_config
    from repro_torch.models.layers import attention_decode
    cfg = dataclasses.replace(get_config("gemma3-1b", smoke=True),
                              dtype="float32")
    jcfg = dataclasses.replace(jax_get_config("gemma3-1b", smoke=True),
                               dtype="float32")
    rng = np.random.default_rng(17)
    b, smax, hd, d = 3, 20, cfg.hd, cfg.d_model
    p = {name: (rng.normal(size=shape) / np.sqrt(shape[0])).astype(
        np.float32) for name, shape in (
            ("wq", (d, cfg.n_heads * hd)), ("wk", (d, cfg.n_kv * hd)),
            ("wv", (d, cfg.n_kv * hd)), ("wo", (cfg.n_heads * hd, d)))}
    x = rng.normal(size=(b, 1, d)).astype(np.float32)
    ck = rng.normal(size=(b, smax, cfg.n_kv, hd)).astype(np.float32)
    cv = rng.normal(size=(b, smax, cfg.n_kv, hd)).astype(np.float32)
    pos = np.asarray([2, 8, 17], np.int32)
    want, jk, _ = jax_attention_decode(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in p.items()}, jcfg,
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
        jnp.int32(window))
    tk = torch.as_tensor(ck.transpose(0, 2, 1, 3).copy())
    tv = torch.as_tensor(cv.transpose(0, 2, 1, 3).copy())
    lengths = torch.as_tensor(pos).repeat_interleave(cfg.n_kv)
    got = attention_decode(torch.as_tensor(x),
                           {n: torch.as_tensor(a) for n, a in p.items()},
                           cfg, tk, tv, torch.as_tensor(pos).long(),
                           lengths, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tk.numpy().transpose(0, 2, 1, 3),
                               np.asarray(jk), rtol=1e-6, atol=1e-6)


def test_flash_decode_checks_the_window_and_the_twin_counts_nothing():
    q, k, v, ln = (torch.as_tensor(a) for a in _inputs(2, 2, 16, 64, 18))
    with pytest.raises(ValueError):
        fd.flash_decode_call(q, k, v, ln, window=-2)
    with pytest.raises(TypeError):
        fd.flash_decode_call(q, k, v, ln, window=1.5)
    before = (fd.launch_count(), fd.windowed_launch_count())
    fd.flash_decode_call(q, k, v, ln, window=4)           # the twin
    assert (fd.launch_count(), fd.windowed_launch_count()) == before
