"""Distributed stages over a mesh of ranks (torch.distributed).

Port of gtsfm_tpu/parallel/distributed.py (the reference's Dask
scatter/submit/gather, SURVEY.md section 2.1). One process per GPU; each
rank computes its shard on its own device and the ranks meet in
collectives:

  * two-view RANSAC: the pairs axis is split across the ranks, one
    all_gather of the results;
  * detection: the image batch is split across the ranks, one all_gather
    per output field;
  * triangulation: tracks split, cameras replicated, one all_gather;
  * bundle adjustment: the single-card LM loop and solvers of
    ``bundle/ba.py`` with a mesh. Each rank builds the Jacobian blocks of
    its measurement rows, the Schur terms and the cost are summed with
    all_reduce, and the reduced camera solve is replicated on summed (so
    identical) inputs. The track-sharded step (each rank owns a contiguous
    block of tracks) needs one all_reduce per step, of (Hcc, S_red, v),
    plus one all_gather of the point updates; the measurement-sharded step
    reduces (Hcc, Hpp, bc, bp) once and then two vectors per PCG matvec.
    Rotation and translation averaging stay replicated, as in the JAX
    package.

Without a process group ``make_mesh()`` is a mesh of one rank whose
collectives do nothing, as JAX's ``make_mesh()`` works without
``jax.distributed``. The distributed BA steps keep the camera-point coupling
in float32, as the JAX package's do (no bfloat16 rounding), and
``run_ba_with_filtering_distributed`` runs its final stage in float64 to
``ba._REL_TOL`` as the single-card ``run_ba_with_filtering`` does.
Camera banding is a TPU layout the port leaves out: the banded step raises.
The functions below keep the JAX package's names.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

from gtsfm_tpu_torch.bundle import ba
from gtsfm_tpu_torch.common.scene import SceneData
from gtsfm_tpu_torch.ops import ransac
from gtsfm_tpu_torch.parallel import multihost
from gtsfm_tpu_torch.parallel.multihost import Mesh, P

logger = logging.getLogger("gtsfm_tpu_torch")

# Rank r of a sharded random stage seeds its generator with seed + r * stride
# (rank 0 draws what the unsharded stage draws).
_SHARD_SEED_STRIDE = 1_000_003


def make_mesh(n_devices: int | None = None, axis_name: str = "data",
              device: str | torch.device | None = None) -> Mesh:
    """The mesh over the default process group's ranks (``n_devices`` must be
    its size, or select the first ``n_devices`` ranks; 1 in a larger group
    gives every rank a mesh of its own), on ``device`` (default: this rank's, see
    ``multihost.local_device``). With no process group, a mesh of one rank on
    ``device`` (default "cuda") whose collectives do nothing."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh({n_devices}) needs a process group of that size (multihost.initialize)")
        return Mesh(device if device is not None else multihost.local_device(), None, axis_name)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh({n_devices}) on a process group of {world} ranks")
    dev = device if device is not None else multihost.local_device()
    if n == world:
        return Mesh(dev, dist.group.WORLD, axis_name)
    if n == 1:
        return Mesh(dev, None, axis_name)
    group = dist.new_group(list(range(n)))  # a collective call: every rank makes it
    if dist.get_rank() >= n:
        raise ValueError(f"rank {dist.get_rank()} is not among the first {n} ranks of make_mesh({n})")
    return Mesh(dev, group, axis_name)


def _shard_generator(seed: int, mesh: Mesh, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) + _SHARD_SEED_STRIDE * mesh.rank)


def pair_sharded_verify(
    mesh: Mesh,
    seed: int,
    x1: torch.Tensor,  # (P, N, 2) normalized coords, P divisible by the mesh size
    x2: torch.Tensor,
    mask: torch.Tensor,
    threshold,
    num_hypotheses: int = 256,
    min_inliers: int = 15,
    min_inlier_ratio: float = 0.1,
    samples: tuple | None = None,
) -> ransac.TwoViewResult:
    """Two-view RANSAC with the pairs axis split across the ranks: rank r
    verifies its contiguous block of pairs with its own generator (seed + r *
    _SHARD_SEED_STRIDE) and the results are all-gathered. ``samples`` (the
    (idx5, idx4, sub_idx) draws of ``ransac.verify_essential_batched`` for
    all P pairs) replaces the generators' draws, so a test can pass the JAX
    package's per-shard draws. The inlier gates are passed through (the JAX
    package's sharded call drops them and runs at its defaults)."""
    n = x1.shape[0]
    if n % mesh.size != 0:
        raise ValueError(f"{n} pairs: pad the pairs to a multiple of the mesh size {mesh.size}")
    thr = torch.as_tensor(threshold, dtype=x1.dtype, device=x1.device).expand(n)
    spec = P(mesh.axis_names[0])
    x1l, x2l, ml, thl, sl = multihost.shard_inputs(mesh, spec, (x1, x2, mask, thr, samples))
    out = ransac.verify_essential_batched(
        _shard_generator(seed, mesh, x1.device), x1l, x2l, ml, thl, num_hypotheses=num_hypotheses,
        min_inliers=min_inliers, min_inlier_ratio=min_inlier_ratio, samples=sl)
    return multihost.gather_outputs(mesh, spec, out)


def track_sharded_triangulate(
    mesh: Mesh,
    wRi: torch.Tensor,  # (N, 3, 3), replicated
    wti: torch.Tensor,
    cal: torch.Tensor,
    cam_idx: torch.Tensor,  # (T, L), T divisible by the mesh size
    uv: torch.Tensor,  # (T, L, 2)
    mask: torch.Tensor,  # (T, L)
    reproj_thresh_px: float = 10.0,
    max_hypotheses: int = 128,
    samples: torch.Tensor | None = None,
    seed: int = 0,
):
    """Robust triangulation with the tracks axis split across the ranks and
    the cameras replicated; no collective but the final all_gather.
    ``samples`` ((T, K2, 2) uniform draws for tracks with more than
    ``max_hypotheses`` pairs) replaces rank r's generator (seed + r *
    _SHARD_SEED_STRIDE)."""
    from gtsfm_tpu_torch.multiview import data_association as da

    if cam_idx.shape[0] % mesh.size != 0:
        raise ValueError(f"{cam_idx.shape[0]} tracks: pad the tracks to a multiple of the mesh size {mesh.size}")
    spec = P(mesh.axis_names[0])
    cam_l, uv_l, mask_l, samples_l = multihost.shard_inputs(mesh, spec, (cam_idx, uv, mask, samples))
    out = da.triangulate_tracks_robust(
        wRi, wti, cal, cam_l, uv_l, mask_l, reproj_thresh_px=reproj_thresh_px, max_hypotheses=max_hypotheses,
        samples=samples_l, generator=_shard_generator(seed, mesh, uv.device))
    return multihost.gather_outputs(mesh, spec, out)


def image_sharded_detect(mesh: Mesh, detect_fn, images, batch: int | None = None):
    """Feature detection with a shape-uniform image batch (B, H, W), B
    divisible by the mesh size, split across the ranks: each rank runs the
    batched ``detect_fn`` on its contiguous block, ``batch`` images per call
    (default: the whole block), and every output field (a NamedTuple of
    tensors with a leading image axis, padded to one keypoint count) is
    all-gathered. Returns the fields for all B images."""
    if images.shape[0] % mesh.size != 0:
        raise ValueError(f"{images.shape[0]} images: pad the batch to a multiple of the mesh size {mesh.size}")
    spec = P(mesh.axis_names[0])
    (local,) = multihost.shard_inputs(mesh, spec, (images,))
    step = max(1, int(batch)) if batch else max(1, local.shape[0])
    parts = [detect_fn(local[s:s + step]) for s in range(0, local.shape[0], step)]
    out = type(parts[0])(*(torch.cat(fields) for fields in zip(*parts)))
    return multihost.gather_outputs(mesh, spec, out)


# ---------------------------------------------------------------------------
# Bundle adjustment
# ---------------------------------------------------------------------------


def _priors_here(scene: SceneData, priors, cfg: ba.BAConfig):
    """The between factors' blocks at the scene's cameras, or None."""
    if priors is None:
        return None
    D = ba.CAM_DIM if cfg.optimize_calibration else ba.POSE_DIM
    return ba._prior_blocks(scene, ba._priors_as(priors, scene.wti.dtype), ba._gauge_free(scene), D)


def distributed_ba_gn_step(
    mesh: Mesh, scene: SceneData, lam: float = 1e-4, cfg: ba.BAConfig = ba.BAConfig(),
    priors: ba.RelativePosePriors | None = None,
) -> SceneData:
    """One damped Gauss-Newton BA step with measurement-sharded Jacobians:
    rank r builds the blocks of its contiguous block of measurement rows
    and ``ba._schur_solve_pcg`` sums them over the mesh (one all_reduce of
    Hcc/Hpp/bc/bp, then two a PCG matvec). Returns the updated scene, the
    same on every rank."""
    (lo, hi), _ = ba._rank_rows(scene, mesh, dense=False)
    rows = ba._rows(scene, lo, hi)
    blocks, _ = ba._build_blocks(rows, cfg, ba._gauge_free(scene), rows.meas_mask)
    dc, dp, _ = ba._schur_solve_pcg(*blocks, rows, lam, cfg, False, _priors_here(scene, priors, cfg), mesh)
    return ba._update_scene(scene, dc, dp)


def distributed_ba_gn_step_tracksharded(
    mesh: Mesh,
    scene: SceneData,
    bucket_l: int,
    lam: float = 1e-4,
    cfg: ba.BAConfig = ba.BAConfig(),
    priors: ba.RelativePosePriors | None = None,
) -> SceneData:
    """One damped Gauss-Newton step with the tracks split across the ranks:
    the measurements sorted by (track, camera) as the single-card solve
    sorts them, rank r owns a contiguous block of T / size tracks (slots at
    or past ``bucket_l`` leave the solve) and ``ba._schur_solve_dense``
    makes one all_reduce of O((N D)^2) floats, whatever the measurement
    count, and one all_gather of the point updates. Returns the updated
    scene with its measurements so sorted, the same on every rank."""
    sc, active = ba._sorted_measurements(scene, bucket_l)
    (lo, hi), tracks = ba._rank_rows(sc, mesh, dense=True)
    rows = ba._rows(sc, lo, hi)
    blocks, _ = ba._build_blocks(rows, cfg, ba._gauge_free(sc), active[lo:hi])
    return ba._update_scene(sc, *ba._schur_solve_dense(*blocks, rows, lam, cfg, False,
                                                        _priors_here(sc, priors, cfg), mesh, tracks))


def distributed_ba_gn_step_banded(mesh: Mesh, scene: SceneData, bucket_l: int, band: tuple, band_plan,
                                  lam: float = 1e-4, cfg: ba.BAConfig = ba.BAConfig(), priors=None) -> SceneData:
    """The JAX package's camera-banded row-sharded step: a TPU layout the
    port leaves out (as ``ba.lm_optimize`` does for ``BAConfig.band``)."""
    raise NotImplementedError("camera-banded BA: a TPU layout the port leaves out (ROADMAP North star)")


def distributed_lm_optimize(
    mesh: Mesh,
    scene: SceneData,
    cfg: ba.BAConfig = ba.BAConfig(),
    band_plan=None,
    priors: ba.RelativePosePriors | None = None,
) -> tuple[SceneData, dict]:
    """Levenberg-Marquardt over the mesh (``ba.lm_optimize`` with ``mesh``):
    with ``cfg.bucket_l`` each iteration is the track-sharded step while the
    single-card size guard (``ba._use_dense_schur``) takes the dense solve,
    otherwise the measurement-sharded PCG step. Returns (scene, stats)."""
    dense = cfg.bucket_l is not None and ba._use_dense_schur(scene)
    res = ba.lm_optimize(scene, cfg, priors=priors, band_plan=band_plan, mesh=mesh, dense=dense)
    return res.scene, dict(initial_cost=float(res.initial_cost), final_cost=float(res.final_cost),
                           iterations=res.iterations, accepted=res.accepted, pcg_iterations=res.pcg_iterations)


def run_ba_with_filtering_distributed(
    mesh: Mesh,
    scene: SceneData,
    reproj_thresholds_px: tuple = (10.0, 5.0, 3.0),
    cfg: ba.BAConfig = ba.BAConfig(),
    priors: ba.RelativePosePriors | None = None,
) -> tuple[SceneData, list[dict]]:
    """Multi-stage BA over the mesh: ``ba.run_ba_with_filtering`` with
    ``mesh`` (the single-card choice of solve, a float64 final stage to
    ``ba._REL_TOL``, tracks padded to a multiple of the mesh size; the stats
    add ``devices`` and the stage's collectives)."""
    return ba.run_ba_with_filtering(scene, reproj_thresholds_px, cfg, priors=priors, mesh=mesh)
