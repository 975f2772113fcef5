"""Operations the algorithms need, counted from their shapes, and the
chip's published peaks. The counts are the algorithm's, whatever computes
it: a multiply-add is two operations, once, however many passes an
implementation makes to reach float32 accuracy."""

from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W): TF32
# tensor-core rate, the fastest at which float32-grade matching still holds
# its check; float32 outside the tensor cores; HBM bandwidth.
PEAKS = {
    "H100": {"tf32_flops": 495e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def attention_flops(bh: int, kq: int, kkv: int, dh: int) -> float:
    """softmax(q k^T) v: q k^T and p v, 2 * Kq * Kkv * Dh each per head."""
    return 4.0 * bh * kq * kkv * dh


def attention_bytes(bh: int, kq: int, kkv: int, dh: int) -> float:
    """float32 q, k, v and the key mask read once, the output written once."""
    return 4.0 * (2 * bh * kq * dh + 2 * bh * kkv * dh + bh * kkv)


def linear_flops(rows: int, n_in: int, n_out: int) -> float:
    return 2.0 * rows * n_in * n_out


def superglue_pair_flops(k0: int, k1: int, d: int = 256, layers: int = 9,
                         encoder=(3, 32, 64, 128, 256)) -> float:
    """SuperGlue's forward operations for one pair of images with k0 and
    k1 keypoints: the keypoint encoder, per attentional layer and side the
    q, k, v and merge projections, attention over the source's keys, the
    two-layer MLP on [x, message], the final projection of both sides and
    the score matrix. The Sinkhorn iterations are element-wise and not
    counted."""
    enc = sum(linear_flops(k0 + k1, encoder[i], encoder[i + 1]) for i in range(len(encoder) - 1))
    total = enc
    for kind in ("self", "cross"):
        for k_q, k_src in ((k0, k0 if kind == "self" else k1), (k1, k1 if kind == "self" else k0)):
            proj = linear_flops(k_q, d, d) * 2 + linear_flops(k_src, d, d) * 2  # q, merge; k, v
            attn = attention_flops(1, k_q, k_src, d)  # all heads together: 4 Kq Kkv D
            mlp = linear_flops(k_q, 2 * d, 2 * d) + linear_flops(k_q, 2 * d, d)
            total += layers * (proj + attn + mlp)
    total += linear_flops(k0 + k1, d, d)  # final projection
    total += 2.0 * k0 * k1 * d  # scores
    return total
