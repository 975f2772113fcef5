"""Port parity: masked attention in gtsfm_tpu_torch.ops.attention against the
JAX package's Pallas flash kernel (interpret mode on the CPU) and its einsum
reference. The CUDA kernel's own tests are in test_torch_kernels.py.

Tolerance: atol = rtol = 1e-5 (both sides are float32 with O(1) inputs;
sums run in different orders).

The precision decision of the CUDA kernel (3xTF32 on the tensor cores) is
held here on the CPU by a numpy emulation of its arithmetic.
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


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mma(acc, terms):
    """acc += sum of a @ b^T over terms as the tensor core does it: each
    product of TF32 operands exact, one float32 rounding per k8 step."""
    for a, b in terms:
        for c in range(0, a.shape[-1], 8):
            part = np.einsum("bik,bjk->bij", a[..., c:c + 8].astype(np.float64),
                             b[..., c:c + 8].astype(np.float64))
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _emulate_kernel(q, k, v, mask, three_terms, bkv=64):
    """The CUDA kernel's arithmetic in numpy: 3xTF32 products (lo.hi +
    hi.lo + hi.hi) or single-pass TF32 (hi.hi), online softmax in the log2
    domain over bkv-key tiles in float32."""
    BH, Kq, Dh = q.shape
    scale_log2 = np.float32(1 / np.sqrt(Dh)) * np.float32(np.log2(np.e))
    qh, ql = _split(q)
    kh, kl = _split(k)
    vh, vl = (np.swapaxes(a, 1, 2) for a in _split(v))  # v^T, K-major
    m = np.full((BH, Kq, 1), -np.inf, np.float32)
    l = np.zeros((BH, Kq, 1), np.float32)
    o = np.zeros((BH, Kq, Dh), np.float32)
    for c0 in range(0, k.shape[1], bkv):
        t = slice(c0, c0 + bkv)
        terms = [(ql, kh[:, t]), (qh, kl[:, t]), (qh, kh[:, t])] if three_terms else [(qh, kh[:, t])]
        s = _mma(np.zeros((BH, Kq, kh[:, t].shape[1]), np.float32), terms)
        s = np.where(mask[:, None, t] > 0, s * scale_log2,
                     np.float32(NEG_LOG2)).astype(np.float32)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        corr = np.exp2(m - m_new).astype(np.float32)
        p = np.exp2(s - m_new).astype(np.float32)
        l = (l * corr + p.sum(-1, keepdims=True, dtype=np.float32)).astype(np.float32)
        m = m_new
        ph, pl = _split(p)
        terms = [(pl, vh[:, :, t]), (ph, vl[:, :, t]), (ph, vh[:, :, t])] if three_terms else [(ph, vh[:, :, t])]
        o = _mma((o * corr).astype(np.float32), terms)
    return o / np.maximum(l, np.float32(1e-20))


NEG_LOG2 = -1e9 * np.log2(np.e)


@pytest.mark.parametrize("three_terms", [True, False], ids=["3xtf32", "1xtf32"])
def test_kernel_precision_3xtf32(rng, three_terms):
    """At a LightGlue-like shape (Dh 64, K 512, logits up to about +-30) the
    kernel's 3xTF32 arithmetic stays within 1e-5 of float64; single-pass
    TF32 on the same inputs misses the kernel's 1e-4 tolerance, which is
    why the kernel pays for three products."""
    q, k, v = _qkv(rng, 2, 512, 512, 64)
    q, k = 2.5 * q, 2.5 * k
    mask = (rng.random((2, 512)) >= 0.1).astype(np.float32)
    logits = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k) / 8.0
    assert 25.0 < np.abs(logits).max() < 40.0
    err = np.abs(_emulate_kernel(q, k, v, mask, three_terms) - _numpy_attention(q, k, v, mask)).max()
    if three_terms:
        assert err < 1e-5
    else:
        assert err > 1e-4
