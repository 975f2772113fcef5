#!/usr/bin/env python3
"""KAZE's FED step order and float32 rounding, on the CPU: per evolution
level of one 384 x 512 synthetic survey image, the largest |value| of the
JAX package's level (steps in index order), its largest difference from the
same cycles in float64 (gtsfm_tpu_torch's kappa-cycle order, whose exact
result every order shares), the port's float32 difference from float64,
how many of the JAX package's 4096 keypoints each level supplies, and the
worst rounding-error growth through the level's FED cycle in index order
and in the port's order (``kaze._fed_amplification``).

Run from the repository root (about a minute):

    python scripts/torch_kaze_fed_order.py
"""

from __future__ import annotations

import math
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from gtsfm_tpu.frontend import kaze as jk  # noqa: E402
from gtsfm_tpu.frontend import sift as js  # noqa: E402
from gtsfm_tpu_torch.common.image import to_grayscale  # noqa: E402
from gtsfm_tpu_torch.frontend import kaze  # noqa: E402
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader  # noqa: E402


def jax_levels(image: np.ndarray, sigmas) -> list[np.ndarray]:
    """The JAX package's scale space (gtsfm_tpu/frontend/kaze.py:80-114)."""
    sigma0 = 1.6

    @jax.jit
    def run(img):
        L = js._blur(img, js._gaussian_kernel1d(math.sqrt(max(sigma0**2 - 0.25, 1e-3))))
        gx0, gy0 = jk._grad(js._blur(img, js._gaussian_kernel1d(1.0)))
        k2 = jnp.maximum(jnp.percentile(jnp.sqrt(gx0**2 + gy0**2), 70.0), 1e-6) ** 2
        out, t_prev = [], 0.5 * sigma0 * sigma0
        for sig in sigmas:
            t = 0.5 * sig * sig
            if t - t_prev > 0:
                gx, gy = jk._grad(js._blur(L, js._gaussian_kernel1d(1.0)))
                g = 1.0 / (1.0 + (gx**2 + gy**2) / k2)
                for tau in jk._fed_tau_steps(t - t_prev):
                    L = jk._diffusion_step(L, g, tau)
            t_prev = t
            out.append(L)
        return out

    return [np.asarray(a, np.float64) for a in run(jnp.asarray(image))]


def main() -> int:
    img = to_grayscale(SyntheticAerialLoader(num_images=8, rows=2).get_image(0)[0].value_array)
    port32, sigmas = kaze._evolution(torch.as_tensor(img)[None], 4, 4)
    port64, _ = kaze._evolution(torch.as_tensor(img, dtype=torch.float64)[None], 4, 4)
    levels = jax_levels(img, sigmas)
    feats = jk.detect_and_describe(jnp.asarray(img), max_keypoints=4096)
    scale = np.asarray(feats.scale)[np.asarray(feats.mask) > 0]
    print(f"image {img.shape}; level sigma steps max|L_jax| max|L_jax - L64| max|L_port32 - L64| jax_keypoints "
          "growth_index_order growth_port_order")
    t_prev = 0.5 * 1.6**2
    for i, sig in enumerate(sigmas):
        dt = 0.5 * sig * sig - t_prev
        t_prev = 0.5 * sig * sig
        taus = kaze._fed_tau_steps(dt) if dt > 0 else []
        growth = [kaze._fed_amplification(taus, order) if taus else 1.0
                  for order in (range(len(taus)), kaze._fed_order(len(taus)) if taus else ())]
        ref = port64[i][0].numpy()
        print(f"{i} {sig:.2f} {len(taus)} {np.abs(levels[i]).max():.4g} {np.abs(levels[i] - ref).max():.3e} "
              f"{np.abs(port32[i][0].double().numpy() - ref).max():.3e} "
              f"{int(np.sum(np.abs(scale - sig) < 1e-3))} {growth[0]:.3g} {growth[1]:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
