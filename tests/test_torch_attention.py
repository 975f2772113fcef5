"""Port parity: masked attention in gtsfm_tpu_torch.ops.attention against the
JAX package's Pallas flash kernel (interpret mode on the CPU) and its einsum
reference. The CUDA kernel's own tests are in test_torch_kernels.py.

Tolerance: atol = rtol = 1e-5 (both sides are float32 with O(1) inputs;
sums run in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.ops.pallas_kernels import attention as jax_attention
from gtsfm_tpu_torch.ops import attention

torch.set_num_threads(2)

CPU_TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(rng, BH, Kq, Kkv, Dh):
    q = rng.standard_normal((BH, Kq, Dh)).astype(np.float32)
    k = rng.standard_normal((BH, Kkv, Dh)).astype(np.float32)
    v = rng.standard_normal((BH, Kkv, Dh)).astype(np.float32)
    return q, k, v


def _numpy_attention(q, k, v, mask):
    """float64 reference with the package's semantics (masked keys -> -1e9)."""
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    s = np.einsum("bqd,bkd->bqk", q, k) / np.sqrt(q.shape[-1])
    s = np.where(mask[:, None, :] > 0, s, -1e9)
    s = s - s.max(-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bqk,bkd->bqd", p, v)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("mask_kind", ["none", "tail", "fully_masked_row"])
def test_plain_matches_jax(rng, mask_kind):
    q, k, v = _qkv(rng, 3, 256, 256, 64)
    mask = np.ones((3, 256), np.float32)
    if mask_kind in ("tail", "fully_masked_row"):
        mask[:, 200:] = 0.0
        mask[1, ::3] = 0.0
    if mask_kind == "fully_masked_row":
        mask[2] = 0.0  # every key masked: the mean of v over the real keys
    want_flash = np.asarray(jax_attention.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v, mask)), interpret=True))
    want_ref = np.asarray(jax_attention.reference_attention(
        *(jnp.asarray(a) for a in (q, k, v, mask))))
    got = attention.masked_attention(*_torch(q, k, v, mask)).numpy()
    np.testing.assert_allclose(got, want_flash, **CPU_TOL)
    np.testing.assert_allclose(got, want_ref, **CPU_TOL)
    if mask_kind == "fully_masked_row":
        np.testing.assert_allclose(got[2], np.broadcast_to(v[2].mean(0), got[2].shape), **CPU_TOL)


def test_masked_keys_are_inert(rng):
    q, k, v = _qkv(rng, 2, 128, 128, 32)
    mask = np.ones((2, 128), np.float32)
    mask[:, 90:] = 0.0
    out = attention.masked_attention(*_torch(q, k, v, mask)).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[:, 90:] = 99.0
    v2[:, 90:] = -99.0
    out2 = attention.masked_attention(*_torch(q, k2, v2, mask)).numpy()
    np.testing.assert_allclose(out, out2, atol=1e-6)


@pytest.mark.parametrize("Kq,Kkv,Dh", [(40, 72, 64), (77, 30, 32), (5, 300, 128)])
def test_ragged_lengths_match_numpy(rng, Kq, Kkv, Dh):
    """Kq != Kkv (the adaptive LightGlue path's cross-attention) against a
    float64 numpy reference."""
    q, k, v = _qkv(rng, 2, Kq, Kkv, Dh)
    mask = (rng.random((2, Kkv)) > 0.2).astype(np.float32)
    got = attention.masked_attention(*_torch(q, k, v, mask)).numpy()
    np.testing.assert_allclose(got, _numpy_attention(q, k, v, mask), **CPU_TOL)


def test_cpu_wrapper_takes_plain_version(rng):
    """On CPU tensors the kernel wrapper computes the plain version and
    counts no launch."""
    q, k, v = _qkv(rng, 2, 64, 64, 64)
    mask = np.ones((2, 64), np.float32)
    before = attention.flash_attention.launches
    got = attention.flash_attention(*_torch(q, k, v, mask))
    want = attention.reference_attention(*_torch(q, k, v, mask))
    assert attention.flash_attention.launches == before
    np.testing.assert_array_equal(got.numpy(), want.numpy())
