"""gtsfm_tpu_torch — the PyTorch/CUDA port of gtsfm_tpu for NVIDIA Hopper.

The port mirrors ``gtsfm_tpu``'s relative module paths and public names, so
``gtsfm_tpu.X.f`` has its counterpart at ``gtsfm_tpu_torch.X.f``. Plain tensor
code is PyTorch; every Pallas kernel of the JAX package becomes a kernel
written by hand for Hopper (sources under ``csrc/``, built with nvcc at first
use). The package imports torch, numpy and scipy only — never jax.

Entry points take an explicit ``device`` that defaults to ``"cuda"``; with no
card they raise (no silent CPU fallback). Tests pass ``device="cpu"``.
"""

import torch

# SfM geometry is accuracy-critical and the JAX package computes everything
# at full f32 ("highest" matmul precision, gtsfm_tpu/__init__.py). cuDNN
# convolutions default to TF32 (~3 decimal digits), which would silently
# degrade SuperPoint; float32 matmuls are pinned to full precision too.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device: "str | torch.device") -> torch.device:
    """The torch.device for an entry point's ``device`` argument. A CUDA
    device with no card raises: the port never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
