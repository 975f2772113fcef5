"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and their refusals (no quiet fallback). Every test here needs an
NVIDIA card and skips without one.

This file imports torch and the port only (no JAX), so it also runs on a
machine without JAX, without the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerance: 1e-4 absolute on attention outputs of order 1 (online softmax
over kv tiles vs one-shot softmax, FMA contraction).
"""

import numpy as np
import pytest
import torch

from gtsfm_tpu_torch.ops import attention

CUDA_ATOL = 1e-4


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, BH, Kq, Kkv, Dh, masked, dev):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((BH, Kq, Dh), (BH, Kkv, Dh), (BH, Kkv, Dh))]
    mask = np.ones((BH, Kkv), np.float32)
    if masked:
        mask[rng.random((BH, Kkv)) < 0.1] = 0.0
        mask[0] = 0.0  # a fully masked row: the mean of v over the real keys
    return [torch.from_numpy(a).to(dev) for a in (*arrays, mask)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "BH,Kq,Kkv,Dh,masked",
    [(8, 1000, 1536, 64, True), (4, 77, 300, 32, False), (4, 200, 130, 128, True),
     (16, 2048, 2048, 64, True)],
)
def test_flash_attention_matches_plain(cuda, BH, Kq, Kkv, Dh, masked):
    q, k, v, mask = _inputs(0, BH, Kq, Kkv, Dh, masked, cuda)
    before = attention.flash_attention.launches
    got = attention.masked_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    want = attention.reference_attention(q, k, v, mask)
    assert float((got - want).abs().max()) < CUDA_ATOL


@pytest.mark.gpu
def test_flash_attention_refuses_what_it_does_not_take(cuda):
    """An unsupported head dim, dtype or layout raises on the card instead of
    computing the plain version."""
    q, k, v, mask = _inputs(1, 2, 64, 64, 48, False, cuda)
    with pytest.raises(ValueError, match="head dim"):
        attention.masked_attention(q, k, v, mask)
    q, k, v, mask = _inputs(2, 2, 64, 64, 64, False, cuda)
    with pytest.raises(ValueError, match="float32"):
        attention.flash_attention(q.double(), k, v, mask)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, mask)
