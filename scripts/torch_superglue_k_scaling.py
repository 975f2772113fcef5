#!/usr/bin/env python3
"""How the CPU difference between the two packages' SuperGlue grows with the
keypoint count K: gtsfm_tpu's Flax SuperGlue (plain einsum attention on the
CPU) against gtsfm_tpu_torch's on the CPU, the same seeded weights
(``params_from_jax``) and inputs, one pair, K = 64 ... 2048.

Prints, per K, the largest difference of the scores (the final projections'
inner products) and of the log assignment after 20 Sinkhorn sweeps, each on
live entries and beside the largest magnitude. Run from the repository root:

    python scripts/torch_superglue_k_scaling.py [K ...]

It runs on the CPU only (about a minute at K 2048 with 8 threads).
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from gtsfm_tpu.frontend.deep import superglue as jax_sg  # noqa: E402
from gtsfm_tpu_torch.frontend.deep import superglue  # noqa: E402

SIZE = 512.0


def inputs(K: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((2, 1, K, superglue.D_MODEL)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kp = (rng.uniform(0, SIZE, (2, 1, K, 2)).astype(np.float32) - SIZE / 2) / (SIZE * 0.7)
    sc = rng.random((2, 1, K)).astype(np.float32)
    m = np.ones((2, 1, K), np.float32)
    m[1, 0, int(0.9 * K):] = 0.0  # ragged: image 1 keeps 90% of its slots
    return d[0], d[1], kp[0], kp[1], sc[0], sc[1], m[0], m[1]


def main(ks) -> int:
    jm = jax_sg.SuperGlue().init_random(k=64, seed=0)
    port = superglue.SuperGlue(params=superglue.params_from_jax(jm.params), device="cpu")
    print("K  max|d scores|  max|scores|  max|d log_assign|  max|log_assign|")
    for K in ks:
        args = inputs(K)
        want = np.asarray(jm.net.apply({"params": jm.params}, *(jnp.asarray(a) for a in args)))
        la_j = np.asarray(jax_sg.log_sinkhorn(jnp.asarray(want), jnp.asarray(args[6]), jnp.asarray(args[7]),
                                              jm._bin_score))
        with torch.no_grad():
            got = port.net(*(torch.from_numpy(a) for a in args))
            la_p = superglue.log_sinkhorn(got, torch.from_numpy(args[6]), torch.from_numpy(args[7]),
                                          port.bin_score).numpy()
        live = np.ones(la_j.shape, bool)
        live[:, :-1] &= args[6][:, :, None] > 0
        live[:, :, :-1] &= args[7][:, None, :] > 0
        ds = np.abs(got.numpy() - want)[live[:, :-1, :-1]]
        dl = np.abs(la_p - la_j)[live]
        print(f"{K} {ds.max():.3e} {np.abs(want)[live[:, :-1, :-1]].max():.3e} {dl.max():.3e} "
              f"{np.abs(la_j)[live].max():.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main([int(k) for k in sys.argv[1:]] or [64, 256, 1024, 2048]))
