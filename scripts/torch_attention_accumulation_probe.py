#!/usr/bin/env python3
"""The port's flash-attention kernel against float64 on an NVIDIA card:
per case, the largest difference of the kernel and of the plain float32
version from a float64 evaluation, and the kernel's time at the main path's
shape (BH 120, K 2048, Dh 64; CUDA events, mean of 20 calls). The offset
cases (q, k at 0.1, v = 8 + N(0, 1)) are near-uniform attention over values
with a shared offset, as in SuperGlue's deep layers.

Run from the repository root on a machine with a card and the CUDA toolkit:

    python3 scripts/torch_attention_accumulation_probe.py [CSRC_DIR]

CSRC_DIR, if given, holds another flash_attention.cu to build and measure
in place of gtsfm_tpu_torch/csrc/ (for instance an earlier commit's, from
``git show <commit>:gtsfm_tpu_torch/csrc/flash_attention.cu``).
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from gtsfm_tpu_torch.ops import attention, cuda_build  # noqa: E402

CASES = (("offset_v8", 8, 2048, 64, 0.1, 8.0), ("offset_v8_dh32", 8, 2048, 32, 0.1, 8.0),
         ("offset_v8_dh128", 8, 2048, 128, 0.1, 8.0), ("offset_v8_k512", 8, 512, 64, 0.1, 8.0),
         ("random", 8, 2048, 64, 1.0, 0.0), ("large_logits", 8, 2048, 64, 2.5, 0.0), ("path", 120, 2048, 64, 1.0, 0.0))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    if len(sys.argv) > 1:
        cuda_build.CSRC_DIR = Path(sys.argv[1]).resolve()
    attention._kernel()
    info = cuda_build.BUILD_LOG["flash_attention"]
    print(f"{info['path']}: nvcc {info['seconds']:.1f} s")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, bh, K, dh, qk, off in CASES:
        q = qk * torch.randn(bh, K, dh, device=dev, generator=gen)
        k = qk * torch.randn(bh, K, dh, device=dev, generator=gen)
        v = off + torch.randn(bh, K, dh, device=dev, generator=gen)
        mask = (torch.rand(bh, K, device=dev, generator=gen) >= 0.1).float()
        got = attention.flash_attention(q, k, v, mask)
        parts = [(attention.reference_attention(*(t[i:i + 8] for t in (q, k, v, mask))),
                  attention.reference_attention(*(t[i:i + 8].double() for t in (q, k, v, mask))))
                 for i in range(0, bh, 8)]
        plain, exact = torch.cat([p for p, _ in parts]), torch.cat([e for _, e in parts])
        line = (f"{name}: kernel-f64 {float((got.double() - exact).abs().max()):.2e} "
                f"plain-f64 {float((plain.double() - exact).abs().max()):.2e} max|out| {float(exact.abs().max()):.2f}")
        if name == "path":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            attention.flash_attention(q, k, v, mask)
            start.record()
            for _ in range(20):
                attention.flash_attention(q, k, v, mask)
            end.record()
            torch.cuda.synchronize()
            line += f" kernel {start.elapsed_time(end) / 20:.4f} ms"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
