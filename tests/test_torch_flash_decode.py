"""Kernel B5 (fused single-token GQA decode attention): the port's wrapper
on CPU tensors (its plain twin) against the reference's Pallas kernel in
interpret mode and against the reference oracle.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference's own (``tests/test_kernels.py``): fp32
``2e-4`` and bf16 ``5e-2`` (absolute and relative): the twin computes in
fp32 and rounds the output once to bf16, the Pallas kernel rounds its
probabilities to the value dtype before the second product.
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


def _port(q, k, v, lengths, dtype=torch.float32):
    t = [torch.as_tensor(a).to(dtype) for a in (q, k, v)]
    return fd.flash_decode_call(*t, torch.as_tensor(lengths))


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
