"""Masked attention: the hand-written Hopper flash-attention kernel, its
plain PyTorch version, and the dispatch the matchers call.

Port of gtsfm_tpu/ops/pallas_kernels/attention.py. The kernel
(``csrc/flash_attention.cu``) computes softmax(q k^T / sqrt(Dh) with masked
keys set to -1e9) v without materializing the score matrix, and goes beyond
the Pallas kernel's limits: Kq != Kkv and ragged lengths are allowed (key
slots past Kkv carry weight 0). It runs on the tensor cores at float32
accuracy (3xTF32 products), after a split pass into a workspace that the
wrapper allocates.

Layout: q is (BH, Kq, Dh); k, v are (BH, Kkv, Dh); kv_mask is (BH, Kkv) with
0 = masked key. Returns (BH, Kq, Dh) float32.

Dispatch: a CUDA tensor always goes through the kernel (any K, no size gate,
no fallback); a CPU tensor uses the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from gtsfm_tpu_torch.ops import cuda_build

NEG = -1e9
SUPPORTED_HEAD_DIMS = (32, 64, 128)


def reference_attention(q, k, v, kv_mask):
    """Plain einsum attention (the kernel's plain version; CPU path)."""
    Dh = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q, k) / (Dh**0.5)
    s = torch.where(kv_mask[:, None, :] > 0, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v)


def _kernel():
    """The built library's (launch, workspace_bytes) C functions."""
    lib = cuda_build.load("flash_attention")
    fn, ws = lib.gtsfm_flash_attention_f32, lib.gtsfm_flash_attention_workspace_bytes
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        ws.argtypes = [ctypes.c_int] * 3
        ws.restype = ctypes.c_longlong
    return fn, ws


def flash_attention(q, k, v, kv_mask):
    """Kernel wrapper. CUDA tensors launch ``csrc/flash_attention.cu`` (and
    raise on anything it does not take); CPU tensors take the plain version.

    CUDA inputs must be contiguous float32, 16-byte aligned, on one device,
    with Dh in SUPPORTED_HEAD_DIMS. Counts its launches in
    ``flash_attention.launches``.
    """
    if q.device.type == "cpu":
        return reference_attention(q, k, v, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3 or kv_mask.ndim != 2:
        raise ValueError("flash_attention: expected q/k/v (BH, K, Dh) and kv_mask (BH, Kkv)")
    BH, Kq, Dh = q.shape
    Kkv = k.shape[1]
    if k.shape != (BH, Kkv, Dh) or v.shape != (BH, Kkv, Dh) or kv_mask.shape != (BH, Kkv):
        raise ValueError(
            f"flash_attention: shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} mask{tuple(kv_mask.shape)}"
        )
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {Dh} not in {SUPPORTED_HEAD_DIMS}")
    if Kkv == 0:
        raise ValueError("flash_attention: needs at least one key")
    if BH > 65535:
        raise ValueError(f"flash_attention: BH={BH} exceeds the grid limit 65535")
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_mask", kv_mask)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"flash_attention: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    out = torch.empty((BH, Kq, Dh), dtype=torch.float32, device=q.device)
    if BH == 0 or Kq == 0:
        return out
    launch, workspace_bytes = _kernel()
    # scratch for the kernel's split pass: hi/lo (3xTF32) copies of k and v^T
    workspace = torch.empty(workspace_bytes(BH, Kkv, Dh) // 4, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(), out.data_ptr(),
            workspace.data_ptr(), BH, Kq, Kkv, Dh, 1.0 / (Dh**0.5), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (cudaError {err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _kernel_ready(t):
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def masked_attention(q, k, v, kv_mask):
    """Dispatch: the flash kernel for every CUDA input, the plain version on
    the CPU. (The TPU gate of the JAX package — K >= 2048, K % 256 == 0 — is
    a TPU tiling rule and has no counterpart here.)"""
    if q.device.type == "cuda":
        return flash_attention(*(_kernel_ready(t) for t in (q, k, v, kv_mask)))
    return reference_attention(q, k, v, kv_mask)
