#!/usr/bin/env python3
"""Per-convolution time and peak memory of the port's LoFTR backbone on an
NVIDIA card, at one survey pair (2 x 384 x 512, seeded weights), under
cuDNN's default plan, without cuDNN (PyTorch's own im2col convolution) and
with channels-last tensors; then a whole pair with and without cuDNN. The
port runs the backbone without cuDNN because of what this prints for the
196-channel 3x3 convolutions at 1/4 scale.

Run from the repository root on a machine with a card:

    python3 scripts/torch_loftr_conv_probe.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from gtsfm_tpu_torch.common.image import to_grayscale  # noqa: E402
from gtsfm_tpu_torch.frontend.deep import loftr  # noqa: E402
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader  # noqa: E402


def ms(fn, n=3):
    """Mean ms of fn() after one warm-up, and the peak GB allocated."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3, torch.cuda.max_memory_allocated() / 1e9


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    loader = SyntheticAerialLoader(num_images=2, rows=1)
    g = [torch.as_tensor(to_grayscale(loader.get_image(i)[0].value_array), device=dev) for i in range(2)]
    model = loftr.LoFTR(max_matches=4096, device=dev).init_random()
    bb = model.net.backbone
    x = torch.stack(g)[:, None].contiguous()
    with torch.no_grad():
        x0 = torch.relu(bb.conv1(x))
        x1 = bb.layer1_1(bb.layer1_0(x0))
        x2 = bb.layer2_1(bb.layer2_0(x1))
        x3 = bb.layer3_1(bb.layer3_0(x2))
        x2o = bb.layer2_outconv(x2) + loftr._up2(bb.layer3_outconv(x3), x2.shape[2:])
        x2a = torch.nn.functional.leaky_relu(bb.layer2_outconv2_0(x2o))
        x1o = bb.layer1_outconv(x1) + loftr._up2(bb.layer2_outconv2_1(x2a), x1.shape[2:])
        x1a = torch.nn.functional.leaky_relu(bb.layer1_outconv2_0(x1o))
        convs = {"conv1": (bb.conv1, x), "layer1_0.conv1": (bb.layer1_0.conv1, x0),
                 "layer2_0.conv1": (bb.layer2_0.conv1, x1), "layer2_0.conv2": (bb.layer2_0.conv2, x2),
                 "layer3_0.conv1": (bb.layer3_0.conv1, x2), "layer3_0.conv2": (bb.layer3_0.conv2, x3),
                 "layer2_outconv2_0": (bb.layer2_outconv2_0, x2o), "layer2_outconv2_1": (bb.layer2_outconv2_1, x2a),
                 "layer1_outconv2_0": (bb.layer1_outconv2_0, x1o), "layer1_outconv2_1": (bb.layer1_outconv2_1, x1a)}
        for name, (conv, inp) in convs.items():
            a = ms(lambda: conv(inp))
            with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
                b = ms(lambda: conv(inp))
            icl = inp.contiguous(memory_format=torch.channels_last)
            conv.to(memory_format=torch.channels_last)
            c = ms(lambda: conv(icl))
            conv.to(memory_format=torch.contiguous_format)
            print(f"{name} {tuple(inp.shape)}: cudnn {a[0]:.2f} ms {a[1]:.2f} GB | no cudnn {b[0]:.2f} ms "
                  f"{b[1]:.2f} GB | channels_last {c[0]:.2f} ms {c[1]:.2f} GB", flush=True)
        print("whole pair (the port: backbone without cuDNN): %.2f ms, %.2f GB" % ms(lambda: model(g[0], g[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
