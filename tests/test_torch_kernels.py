"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and their refusals (no quiet fallback). Every test here needs an
NVIDIA card and skips without one.

This file imports torch and the port only (no JAX), so it also runs on a
machine without JAX, without the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerance: 1e-4 absolute on attention outputs of order 1 (online softmax
over kv tiles vs one-shot softmax; the kernel's 3xTF32 products are of
float32 grade, see test_torch_attention.py::test_kernel_precision_3xtf32).
"""

import numpy as np
import pytest
import torch

from gtsfm_tpu_torch.ops import attention, cuda_build

CUDA_ATOL = 1e-4


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, BH, Kq, Kkv, Dh, masked, dev, qk_scale=1.0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((BH, Kq, Dh), (BH, Kkv, Dh), (BH, Kkv, Dh))]
    arrays[0] *= qk_scale
    arrays[1] *= qk_scale
    mask = np.ones((BH, Kkv), np.float32)
    if masked:
        mask[rng.random((BH, Kkv)) < 0.1] = 0.0
        mask[0] = 0.0  # a fully masked row: the mean of v over the real keys
    return [torch.from_numpy(a).to(dev) for a in (*arrays, mask)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "BH,Kq,Kkv,Dh,masked",
    [(8, 1000, 1536, 64, True), (4, 77, 300, 32, False), (4, 200, 130, 128, True),
     (16, 2048, 2048, 64, True),
     # head dims off the main path at its length, and Kq below one query tile
     (4, 2048, 2048, 32, True), (4, 2048, 2048, 128, True), (4, 5, 777, 64, True),
     # ragged Kkv one past a kv tile (64 keys; 32 for Dh 128)
     (4, 100, 65, 64, True), (4, 100, 129, 128, True), (4, 33, 65, 32, False),
     # adaptive LightGlue's cross-attention after pruning (tokens compacted
     # to multiples of 128, never below 512): Kq != Kkv both ways
     (8, 640, 2048, 64, True), (8, 2048, 512, 64, True), (8, 1152, 512, 64, True)],
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
def test_flash_attention_superglue_chunk_shape(cuda):
    """SuperGlue's shape at a 512-pair chunk: BH = 2048, K = 2048, Dh 64,
    held against the plain version 128 heads at a time (the plain version's
    score matrix for all 2048 heads would be 34 GB)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(2048, 2048, 64, device=cuda, generator=gen) for _ in range(3))
    mask = (torch.rand(2048, 2048, device=cuda, generator=gen) >= 0.1).float()
    got = attention.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    err = max(float((got[s:s + 128] - attention.reference_attention(
        q[s:s + 128], k[s:s + 128], v[s:s + 128], mask[s:s + 128])).abs().max()) for s in range(0, 2048, 128))
    assert err < CUDA_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_flash_attention_large_logits(cuda, Dh):
    """q and k scaled so that the logits reach about +-30 (LightGlue's
    range): the 3xTF32 products keep float32 accuracy there."""
    q, k, v, mask = _inputs(3, 4, 1024, 1024, Dh, True, cuda, qk_scale=2.5)
    logits = torch.einsum("bqd,bkd->bqk", q, k) / Dh**0.5
    assert 20.0 < float(logits.abs().max()) < 60.0
    got = attention.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    want = attention.reference_attention(q, k, v, mask)
    assert float((got - want).abs().max()) < CUDA_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_flash_attention_accumulates_at_float32_grade(cuda, Dh):
    """Near-uniform attention over 2048 keys whose values share an offset of
    8 (as SuperGlue's deep layers): the output is a mean of 2048 values, and
    the kernel stays at least as close to a float64 evaluation as the plain
    float32 version. Accumulating P.V for a whole row in the tensor cores'
    accumulator (they do not round each addition to nearest) was 8x further
    off than the plain version here; the kernel now adds each kv tile's P.V
    on the CUDA cores."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k = (0.1 * torch.randn(8, 2048, Dh, device=cuda, generator=gen) for _ in range(2))
    v = 8.0 + torch.randn(8, 2048, Dh, device=cuda, generator=gen)
    mask = (torch.rand(8, 2048, device=cuda, generator=gen) >= 0.1).float()
    got = attention.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    plain = attention.reference_attention(q, k, v, mask)
    exact = attention.reference_attention(q.double(), k.double(), v.double(), mask.double())
    assert float((got.double() - exact).abs().max()) <= float((plain.double() - exact).abs().max())
    assert float((got - plain).abs().max()) < CUDA_ATOL


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


def test_build_key_covers_headers(tmp_path, monkeypatch):
    """The library's file name changes with the kernel source and with every
    csrc/*.cuh header, so an edited header never reuses a stale build."""
    (tmp_path / "k.cu").write_text("// kernel")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    first = cuda_build.library_path("k")
    (tmp_path / "common.cuh").write_text("// header")
    second = cuda_build.library_path("k")
    (tmp_path / "common.cuh").write_text("// header, edited")
    third = cuda_build.library_path("k")
    (tmp_path / "k.cu").write_text("// kernel, edited")
    assert len({first, second, third, cuda_build.library_path("k")}) == 4
    assert first.parent == cuda_build.BUILD_DIR and first.name.startswith("libk-")


def test_timing_time_fn_on_the_card(cuda):
    """common/timing.py: CUDA-event seconds of a 4096^3 float32 matmul
    (137 GFLOP: at least 2 ms at the card's 67 TFLOP/s; asked: over 1 ms
    and under a second)."""
    from gtsfm_tpu_torch.common import timing

    x = torch.ones(4096, 4096, device=cuda)
    seconds = timing.time_fn(torch.matmul, x, x, n=3)
    timing.sync()
    assert 1e-3 < seconds < 1.0
