"""Multi-GPU execution over torch.distributed (port of gtsfm_tpu/parallel):
the mesh of ranks, pair-sharded two-view verification and distributed
bundle adjustment."""

from gtsfm_tpu_torch.parallel.distributed import (  # noqa: F401
    distributed_ba_gn_step,
    make_mesh,
    pair_sharded_verify,
)
