"""gtsfm_tpu_torch.parallel on two gloo ranks on the CPU, with no JAX.

The rank bodies live here: ``spawn_ranks`` starts ``world`` processes (spawn
context) that join one gloo process group through a FileStore, each runs
``compute`` on its mesh over the inputs the test wrote, and writes its
outputs. ``compute`` on a mesh of one rank (no process group) in the test
process is the one-rank result. tests/test_torch_parallel.py spawns the same
bodies on the JAX package's problems. Every spawn has a timeout on its
collectives and on its join, so a hung rendezvous fails its test.

This file holds the two-rank results against the one-rank ones (detection,
triangulation, BA steps and LM, RANSAC, the runner's whole pipeline with
--multihost), the ranks against each other, the
collectives a track-sharded step makes, the layout checks (indivisible
axes, the banded step) and ``initialize``'s refusal to run without a card
unless asked for the CPU.
"""

import multiprocessing
import os
import traceback

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from chip_smoke import rot_errors_deg  # noqa: E402
from gtsfm_tpu_torch.bundle import ba  # noqa: E402
from gtsfm_tpu_torch.common import scene as scene_mod  # noqa: E402
from gtsfm_tpu_torch.frontend import sift  # noqa: E402
from gtsfm_tpu_torch.geometry import cameras, lie  # noqa: E402
from gtsfm_tpu_torch.ops import ransac  # noqa: E402
from gtsfm_tpu_torch.parallel import distributed, multihost  # noqa: E402

WORLD = 2
GROUP_TIMEOUT_S = 120.0  # every collective of the spawned group
JOIN_TIMEOUT_S = 240.0  # each rank's process
SCENE_FIELDS = ("wRi", "wti", "cal", "camera_mask", "points", "track_mask", "meas_cam", "meas_track", "meas_uv",
                "meas_mask")
LAM = 1e-4
LM_ITERATIONS = 25
FILTER_THRESHOLDS = (10.0, 5.0, 3.0)
DETECT_KEYPOINTS = 128
PIPE_IMAGES = 6
PCG64_ITERATIONS = 500  # the float64 stages' PCG cap (ba._FLOAT64_PCG_ITERATIONS)


# ------------------------------------------------------------------ inputs


def scene_arrays(prefix: str, sc) -> dict:
    """A scene's fields (port or JAX package) as numpy arrays under prefix."""
    return {f"{prefix}{f}": np.asarray(getattr(sc, f)) for f in SCENE_FIELDS}


def scene_from(z: dict, prefix: str, dtype=torch.float32) -> scene_mod.SceneData:
    return scene_mod.SceneData(**{f: torch.as_tensor(np.array(z[f"{prefix}{f}"])).to(
        torch.int64 if f in ("meas_cam", "meas_track") else dtype) for f in SCENE_FIELDS})


def priors_from(z: dict) -> ba.RelativePosePriors:
    return ba.RelativePosePriors(*(torch.as_tensor(z[f"pr_{k}"]) for k in ba.RelativePosePriors._fields))


def arc_problem(seed: int = 0, n_cams: int = 4, n_tracks: int = 40):
    """The JAX BA tests' problem (tests/bundle/test_ba.py::make_ba_problem:
    cameras on an arc, every track seen by every camera, 0.3 px noise),
    perturbed (1 deg, 0.05, 0.05), built with the port alone."""
    rng = np.random.default_rng(seed)
    cal = np.tile(np.asarray([500.0, -0.05, 0.01, 320.0, 240.0], np.float32), (n_cams, 1))
    wRi, wti = [], []
    for a in np.linspace(-0.5, 0.5, n_cams):
        c = np.asarray([8 * np.sin(a), 0.5 * np.sin(2 * a), -8 * np.cos(a)], np.float32)
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        wRi.append(np.stack([x, np.cross(z, x), z], -1).astype(np.float32))
        wti.append(c)
    wRi, wti = np.stack(wRi), np.stack(wti)
    X = rng.uniform(-2, 2, size=(n_tracks, 3)).astype(np.float32)
    uv, _ = cameras.project_bundler(*(torch.as_tensor(a)[:, None] for a in (wRi, wti, cal)), torch.as_tensor(X)[None])
    uv = uv.numpy() + 0.3 * rng.normal(size=uv.shape).astype(np.float32)
    sc = scene_mod.make_scene(wRi, wti, cal, [[(i, uv[i, j]) for i in range(n_cams)] for j in range(n_tracks)],
                              device="cpu")
    dw = rng.normal(size=(n_cams, 3))
    dw *= np.deg2rad(1.0) / np.linalg.norm(dw, axis=-1, keepdims=True)
    dw[0] = 0
    dt = rng.normal(size=(n_cams, 3)) * 0.05
    dt[0] = 0
    pts = np.zeros((sc.num_tracks_padded, 3), np.float32)
    pts[:n_tracks] = X + 0.05 * rng.normal(size=X.shape)
    return sc.replace(wRi=lie.so3_exp(torch.as_tensor(dw, dtype=torch.float32)) @ sc.wRi,
                      wti=sc.wti + torch.as_tensor(dt, dtype=torch.float32), points=torch.as_tensor(pts)), (wRi, wti)


def sequential_priors(wRi: np.ndarray, wti: np.ndarray, weight: float = 50.0) -> dict:
    """Between factors (i, i + 1) at the true relative poses, as
    tests/bundle/test_ba_priors.py::_sequential_priors."""
    a = np.arange(len(wRi) - 1)
    b = a + 1
    aRb = np.einsum("eji,ejk->eik", wRi[a], wRi[b])
    atb = np.einsum("eji,ej->ei", wRi[a], wti[b] - wti[a])
    return dict(pr_edges_a=a, pr_edges_b=b, pr_aRb=aRb.astype(np.float32), pr_atb=atb.astype(np.float32),
                pr_weight=np.full(len(a), weight, np.float32))


def two_view_pairs(seed: int = 0, n_pairs: int = 8, n_pts: int = 64):
    """n_pairs synthetic two-view problems (normalized coordinates, 3e-4
    noise): x1, x2 (P, N, 2) and the true i2Ri1 (P, 3, 3)."""
    rng = np.random.default_rng(seed)
    x1s, x2s, Rs = [], [], []
    for _ in range(n_pairs):
        R = lie.so3_exp(torch.as_tensor(rng.uniform(-0.3, 0.3, 3), dtype=torch.float32)).numpy()
        t = rng.normal(size=3)
        X = np.stack([rng.uniform(-1.5, 1.5, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(4, 8, n_pts)], -1)
        X2 = X @ R.T + t / np.linalg.norm(t)
        x1s.append(X[:, :2] / X[:, 2:] + 3e-4 * rng.normal(size=(n_pts, 2)))
        x2s.append(X2[:, :2] / X2[:, 2:] + 3e-4 * rng.normal(size=(n_pts, 2)))
        Rs.append(R)
    return tuple(np.stack(a).astype(np.float32) for a in (x1s, x2s, Rs))


def triangulation_inputs(sc, seed: int = 0, n_tracks: int = 32, L: int = 4) -> dict:
    """tests/parallel/test_distributed.py's triangulation problem: T tracks of
    L random cameras of the scene, exact projections of random points."""
    rng = np.random.default_rng(seed)
    n = sc.num_cameras_padded
    X = rng.uniform(-2, 2, size=(n_tracks, 3)).astype(np.float32)
    cam = rng.integers(0, n, size=(n_tracks, L))
    uv, _ = cameras.project_bundler(sc.wRi[cam], sc.wti[cam], sc.cal[cam], torch.as_tensor(X)[:, None, :])
    return dict(tri_wRi=sc.wRi.numpy(), tri_wti=sc.wti.numpy(), tri_cal=sc.cal.numpy(), tri_cam=cam,
                tri_uv=uv.numpy(), tri_mask=np.ones((n_tracks, L), np.float32), tri_X=X)


def detection_images(seed: int = 0, n: int = 4, h: int = 96, w: int = 128) -> np.ndarray:
    """Smooth random grey images in [0, 1] (blurred noise: blobs at many
    scales for SIFT)."""
    rng = np.random.default_rng(seed)
    img = torch.as_tensor(rng.random((n, 1, h, w)), dtype=torch.float32)
    k = torch.exp(-0.5 * (torch.arange(-6, 7, dtype=torch.float32) / 2.5) ** 2)
    k = (k / k.sum())
    img = torch.nn.functional.conv2d(img, k.view(1, 1, 1, -1), padding=(0, 6))
    img = torch.nn.functional.conv2d(img, k.view(1, 1, -1, 1), padding=(6, 0))[:, 0]
    img = (img - img.amin((1, 2), keepdim=True)) / (img.amax((1, 2), keepdim=True) - img.amin((1, 2), keepdim=True))
    return img.numpy()


# ------------------------------------------------------------- the bodies


def compute(mesh, z: dict) -> dict:
    """Every distributed function on the mesh, over the input groups z
    holds (ba_: a scene; pr_: its priors; pv_: RANSAC pairs with draws;
    tri_: triangulation; det_: images; agree_flags: one row of flags a
    rank; pipe_: a survey folder for the runner, run twice on more than one
    rank). Returns numpy outputs."""
    out = {}
    if "agree_flags" in z:
        calls0 = mesh.collective_calls["all_reduce"]
        out.update(agree_any=mesh.any_rank(z["agree_flags"][mesh.rank]).numpy(),
                   agree_calls=np.asarray(mesh.collective_calls["all_reduce"] - calls0))
    if "ba_wRi" in z:
        sc = scene_from(z, "ba_")
        L = ba.auto_bucket_l(sc)
        cfg = ba.BAConfig(schur_bf16=False)
        step = distributed.distributed_ba_gn_step(mesh, sc, LAM, cfg)
        out.update(meas_wti=step.wti.numpy(), meas_points=step.points.numpy())
        m = distributed.make_mesh(device="cpu") if mesh.size == 1 else distributed.make_mesh()
        step = distributed.distributed_ba_gn_step_tracksharded(m, sc, L, LAM, cfg)
        out.update(track_wti=step.wti.numpy(), track_points=step.points.numpy(), track_meas_cam=step.meas_cam.numpy(),
                   track_meas_track=step.meas_track.numpy(),
                   track_calls=np.asarray([m.collective_calls["all_reduce"], m.collective_calls["all_gather"]]))
        runs = dict(lm_track=(ba.BAConfig(max_iterations=LM_ITERATIONS, bucket_l=L, schur_bf16=False), None),
                    lm_meas=(ba.BAConfig(max_iterations=LM_ITERATIONS), None))
        if "pr_weight" in z:
            runs["lm_priors"] = (ba.BAConfig(max_iterations=LM_ITERATIONS, bucket_l=L, schur_bf16=False),
                                 priors_from(z))
            runs["lm_meas_priors"] = (ba.BAConfig(max_iterations=LM_ITERATIONS), priors_from(z))
        for name, (c, priors) in runs.items():
            final, st = distributed.distributed_lm_optimize(mesh, sc, c, priors=priors)
            out.update({f"{name}_wRi": final.wRi.numpy(), f"{name}_wti": final.wti.numpy(),
                        f"{name}_points": final.points.numpy(), f"{name}_cost": np.asarray(
                            [st["initial_cost"], st["final_cost"]]), f"{name}_iterations": st["iterations"]})
        # the float64 PCG LM as lm_optimize_float64 runs it, on the PCG solve
        calls0 = mesh.collective_calls["all_reduce"]
        res = ba.lm_optimize(ba._cast(sc, torch.float64), ba.BAConfig(
            max_iterations=LM_ITERATIONS, pcg_iterations=PCG64_ITERATIONS, schur_bf16=False), mesh=mesh, dense=False)
        out.update(pcg64_cost=np.asarray([float(res.initial_cost), float(res.final_cost)]),
                   pcg64_counts=np.asarray([res.iterations, res.pcg_iterations,
                                            mesh.collective_calls["all_reduce"] - calls0]))
        final, stats = distributed.run_ba_with_filtering_distributed(
            mesh, sc, FILTER_THRESHOLDS, ba.BAConfig(max_iterations=LM_ITERATIONS, bucket_l=L))
        out.update(filter_wRi=final.wRi.numpy(), filter_stats=np.asarray(
            [[s["tracks"], s["measurements"], s["final_cost"], s["devices"]] for s in stats]))
    if "pv_x1" in z:
        samples = (z["pv_idx5"], z["pv_idx4"], None) if "pv_idx5" in z else None
        res = distributed.pair_sharded_verify(mesh, 0, *(torch.as_tensor(z[f"pv_{k}"]) for k in ("x1", "x2", "mask")),
                                              float(z["pv_thr"]), num_hypotheses=int(z["pv_hyp"]), samples=samples)
        out.update({f"pv_{k}": v.numpy() for k, v in res._asdict().items()})
    if "tri_cam" in z:
        t = {k: torch.as_tensor(z[f"tri_{k}"]) for k in ("wRi", "wti", "cal", "cam", "uv", "mask")}
        res = distributed.track_sharded_triangulate(mesh, t["wRi"], t["wti"], t["cal"], t["cam"], t["uv"], t["mask"],
                                                    reproj_thresh_px=5.0)
        out.update({f"tri_{k}": v.numpy() for k, v in res._asdict().items()})
    if "pipe_data" in z:
        root = os.path.join(str(z["pipe_out"]), f"world{mesh.size}")
        out.update(run_pipeline(mesh, str(z["pipe_data"]), root))
        if mesh.size > 1:
            # Again on the same group, each rank with a cache directory of its
            # own: the first rank's is the warm one of the first run, the
            # others' are empty (hosts that share no cache_dir).
            rerun = root + "_rerun"
            cache = os.path.join(root, "cache") if mesh.rank == 0 else os.path.join(rerun, f"cache_rank{mesh.rank}")
            out.update({f"rerun_{k}": v for k, v in run_pipeline(mesh, str(z["pipe_data"]), rerun, cache).items()})
    if "det_images" in z:
        kw = {k[len("det_kw_"):]: int(v) for k, v in z.items() if k.startswith("det_kw_")}
        detect = lambda g: sift.detect_and_describe(torch.as_tensor(g), **kw)  # noqa: E731
        res = distributed.image_sharded_detect(mesh, detect, z["det_images"], batch=1)
        out.update({f"det_{k}": v.numpy() for k, v in res._asdict().items()})
    return out


def run_pipeline(mesh, data: str, out: str, cache: str | None = None) -> dict:
    """The runner with --multihost on an Olsson folder, in this rank's group
    (no group on one rank: the single-card run), at 1024 SIFT keypoints,
    with the feature and two-view caches on: every rank runs the whole
    pipeline, the sharded stages split across the ranks, into one output
    root and one cache directory (``cache``, default out/cache), which the
    first rank alone writes.
    Returns this rank's own scene (its rotations), its BA stages' devices,
    all_reduce calls and LM iterations, its rotation errors against the
    ground truth, how many times it saved the reports, and the files in
    the output root once every rank is done."""
    import contextlib
    import io

    import torch.distributed as dist

    from gtsfm_tpu_torch.loader.colmap import ColmapLoader
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer
    from gtsfm_tpu_torch.runner import __main__ as runner

    argv = ["--dataset_root", data, "--output_root", out, "--cache_dir", cache or os.path.join(out, "cache"),
            "--override", "frontend.max_keypoints=1024", "--override", "save_plots=false"]
    results, saves = [], []
    run, save_reports = SceneOptimizer.run, SceneOptimizer._save_reports
    SceneOptimizer.run = lambda self, *a, **k: results.append(run(self, *a, **k)) or results[-1]
    SceneOptimizer._save_reports = lambda self, *a, **k: saves.append(save_reports(self, *a, **k))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            # in a process group initialize() finds it and leaves it to its maker
            runner.main(argv + (["--multihost"] if mesh.group is not None else []), device="cpu")
    finally:
        SceneOptimizer.run, SceneOptimizer._save_reports = run, save_reports
    if mesh.group is not None:
        dist.barrier(mesh.group)  # the first rank has written everything
    groups = {g.name: {m.name: m.data for m in g.metrics} for g in results[-1].metrics}
    ba_metrics = groups["bundle_adjustment_metrics"]
    rot_err = groups["ba_pose_error_metrics"]["rotation_angle_error_deg"]
    stages = [[ba_metrics.get(f"stage{i}_{k}", 0) for k in ("devices", "all_reduce_calls", "iterations")]
              for i in range(3)]
    model = ColmapLoader(os.path.join(out, "ba_output"))
    files = sorted(os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out) for f in fs)
    return dict(pipe_R=results[-1].scene.wRi[results[-1].scene.camera_mask > 0].numpy(),
                pipe_model_R=np.stack([np.asarray(model.get_camera_pose(i)[0]) for i in range(len(model))]),
                pipe_ba_stages=np.asarray(stages, np.float64),
                pipe_rot_err_deg=np.asarray([np.max(rot_err), np.median(rot_err)]),
                pipe_saved_reports=np.asarray(len(saves)), pipe_files=np.asarray(files))


def rank_body(rank: int, world: int, store: str, inputs: str, outputs: str) -> None:
    """One spawned rank: join the gloo group, compute, check the layout
    errors on the two-rank mesh, write rank{r}.npz (a traceback to
    rank{r}.err on failure)."""
    try:
        torch.set_num_threads(1)
        multihost.initialize("file://" + store, world, rank, device="cpu", timeout_s=GROUP_TIMEOUT_S)
        try:
            mesh = distributed.make_mesh()
            with np.load(inputs) as f:
                z = {k: f[k] for k in f.files}
            out = compute(mesh, z)
            out["mesh"] = np.asarray([mesh.size, mesh.rank])
            try:
                multihost.shard_inputs(mesh, multihost.P("data"), (torch.zeros(world + 1),))
                out["indivisible_raised"] = np.asarray(False)
            except ValueError:
                out["indivisible_raised"] = np.asarray(True)
            np.savez(os.path.join(outputs, f"rank{rank}.npz"), **out)
        finally:
            multihost.shutdown()
    except BaseException:
        with open(os.path.join(outputs, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def spawn_ranks(tmp_dir, inputs: dict, world: int = WORLD) -> list[dict]:
    """Writes the inputs, runs ``world`` rank_body processes and returns
    their outputs in rank order; a rank that fails or outlives its join
    timeout fails the caller."""
    tmp_dir = str(tmp_dir)
    path = os.path.join(tmp_dir, "inputs.npz")
    np.savez(path, **inputs)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_body, args=(r, world, os.path.join(tmp_dir, "store"), path, tmp_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
    finally:
        hung = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    errors = []
    for r in range(world):
        err = os.path.join(tmp_dir, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as fh:
                errors.append(f"rank {r}:\n{fh.read()}")
    assert not hung and not errors and all(p.exitcode == 0 for p in procs), \
        (hung, [p.exitcode for p in procs], "\n".join(errors))
    outs = []
    for r in range(world):
        with np.load(os.path.join(tmp_dir, f"rank{r}.npz")) as f:
            outs.append({k: f[k] for k in f.files})
    return outs


def one_rank(inputs: dict) -> dict:
    """compute on a mesh of one rank (no process group), in this process."""
    return compute(distributed.make_mesh(device="cpu"), inputs)


# ------------------------------------------------------------------- tests


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from chip_smoke import write_olsson_folder
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader

    tmp = tmp_path_factory.mktemp("ranks")
    data = write_olsson_folder(str(tmp / "survey"), SyntheticAerialLoader(num_images=PIPE_IMAGES, rows=2),
                               range(PIPE_IMAGES))
    sc, (wRi, wti) = arc_problem()
    x1, x2, _ = two_view_pairs()
    inputs = dict(scene_arrays("ba_", sc), **sequential_priors(wRi, wti), **triangulation_inputs(sc),
                  agree_flags=np.asarray([[True, False, True], [False, False, True]]),
                  pv_x1=x1, pv_x2=x2, pv_mask=np.ones(x1.shape[:2], np.float32), pv_thr=np.float32(4e-3),
                  pv_hyp=np.int64(64), det_images=detection_images(), det_kw_max_keypoints=np.int64(DETECT_KEYPOINTS),
                  pipe_data=np.str_(data), pipe_out=np.str_(str(tmp / "pipeline")))
    ranks = spawn_ranks(tmp, inputs)
    return dict(inputs=inputs, ranks=ranks, one=one_rank(inputs), truth=two_view_pairs()[2])


def test_ranks_agree(runs):
    """Both ranks hold the same full outputs (replicated solves, gathered
    shards), on a mesh of two."""
    r0, r1 = runs["ranks"]
    assert r0["mesh"].tolist() == [2, 0] and r1["mesh"].tolist() == [2, 1]
    for k in r0:
        if k not in ("mesh", "pipe_saved_reports", "rerun_pipe_saved_reports"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_track_sharded_ba_equals_one_rank(runs):
    """The track-sharded step and LM on two ranks against one rank: the
    same measurement order, points and cameras to float32 rounding of the
    summed Schur terms; one all_reduce and one all_gather per step."""
    got, want = runs["ranks"][0], runs["one"]
    np.testing.assert_array_equal(got["track_meas_cam"], want["track_meas_cam"])
    np.testing.assert_array_equal(got["track_meas_track"], want["track_meas_track"])
    np.testing.assert_allclose(got["track_wti"], want["track_wti"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["track_points"], want["track_points"], rtol=1e-3, atol=2e-4)
    assert got["track_calls"].tolist() == [1, 1] and want["track_calls"].tolist() == [0, 0]
    for name in ("lm_track", "lm_priors"):
        c, c1 = got[f"{name}_cost"], want[f"{name}_cost"]
        assert c[1] < 0.05 * c[0]
        assert abs(c[1] - c1[1]) <= 1e-3 * c1[1], (name, c, c1)
    # the multi-stage BA: the same survivors per stage, float64 final stage
    s, s1 = got["filter_stats"], want["filter_stats"]
    np.testing.assert_array_equal(s[:, :2], s1[:, :2])
    np.testing.assert_allclose(s[:, 2], s1[:, 2], rtol=1e-3)
    assert s[:, 3].tolist() == [2] * len(s) and s1[:, 3].tolist() == [1] * len(s)


def test_meas_sharded_ba_equals_one_rank(runs):
    """The measurement-sharded step and LM (PCG), without and with priors,
    on two ranks against one rank."""
    got, want = runs["ranks"][0], runs["one"]
    np.testing.assert_allclose(got["meas_wti"], want["meas_wti"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["meas_points"], want["meas_points"], rtol=1e-3, atol=1e-4)
    for name in ("lm_meas", "lm_meas_priors"):
        c, c1 = got[f"{name}_cost"], want[f"{name}_cost"]
        assert c[1] < 0.05 * c[0] and abs(c[1] - c1[1]) <= 1e-3 * c1[1], (name, c, c1)


def test_pair_sharded_verify_recovers_poses(runs):
    """Each rank verifies its 4 pairs with its own generator; every pair
    verifies, within 1.5 deg of the truth (the bar of
    tests/parallel/test_distributed.py::test_pair_sharded_verify)."""
    got = runs["ranks"][0]
    assert got["pv_success"].all()
    err = np.degrees(lie.rotation_angular_distance(torch.as_tensor(got["pv_i2Ri1"]),
                                                   torch.as_tensor(runs["truth"])).numpy())
    assert err.max() < 1.5, err


def test_pair_sharded_verify_one_rank_is_unsharded(runs):
    """On one rank the sharded call is the unsharded verify with the same
    seed."""
    z = runs["inputs"]
    want = ransac.verify_essential_batched(torch.Generator().manual_seed(0), *(torch.as_tensor(z[f"pv_{k}"]) for k in (
        "x1", "x2", "mask")), threshold=float(z["pv_thr"]), num_hypotheses=int(z["pv_hyp"]))
    for k, v in want._asdict().items():
        np.testing.assert_array_equal(runs["one"][f"pv_{k}"], v.numpy(), err_msg=k)


def test_track_sharded_triangulate_equals_one_rank(runs):
    got, want = runs["ranks"][0], runs["one"]
    for k in ("points", "inlier_mask", "exit_codes", "best_num_inliers"):
        np.testing.assert_array_equal(got[f"tri_{k}"], want[f"tri_{k}"], err_msg=k)
    # tracks seen by two cameras or more come back at their points
    z = runs["inputs"]
    seen = np.asarray([len(set(c)) >= 2 for c in z["tri_cam"]])
    assert seen.sum() >= 30 and np.abs(got["tri_points"] - z["tri_X"])[seen].max() < 1e-2


def test_image_sharded_detect_equals_one_rank(runs):
    """SIFT on 4 images, 2 a rank, one image per call: the one-rank
    detection, field for field."""
    got, want = runs["ranks"][0], runs["one"]
    assert got["det_mask"].shape == (4, DETECT_KEYPOINTS) and got["det_mask"].sum() > 100
    for k in ("uv", "scale", "response", "descriptor", "mask"):
        np.testing.assert_array_equal(got[f"det_{k}"], want[f"det_{k}"], err_msg=k)


def test_pipeline_on_two_ranks(runs):
    """The runner with --multihost on two ranks (6 survey renders) sharing
    one output root and one cache directory, the caches on: each rank
    detects 3 images and verifies half of each chunk's pairs, and global BA
    runs distributed ("auto" with two ranks: per LM iteration one
    all_reduce of the step and one of the cost, plus the first cost); both
    ranks end with the same scene (test_ranks_agree), the first rank alone
    saves the reports and writes the model of that scene, and the caches
    hold one file a feature set and one for the two-view results. Every
    camera is placed, within run_sift's bars of the ground truth after
    Sim(3) (max 1 deg, median 0.1 deg), as in the single-card run. Rank 1
    draws its RANSAC samples from its own generator, so the two runs verify
    its pairs with other samples: their relative rotations agree within 0.1
    deg (0.056 deg on this scene), not to rounding."""
    got, want = runs["ranks"][0], runs["one"]
    stages = got["pipe_ba_stages"]
    assert np.all(stages[:, 0] == 2) and np.all(stages[:, 1] == 2 * stages[:, 2] + 1) and np.all(stages[:, 2] > 0)
    assert np.all(want["pipe_ba_stages"][:, :2] == 0)  # one rank: the single-card BA
    assert [int(r["pipe_saved_reports"]) for r in runs["ranks"]] == [1, 0] and int(want["pipe_saved_reports"]) == 1
    for r in (got, want):
        files = [str(f) for f in r["pipe_files"]]
        assert "ba_output/cameras.txt" in files and not [f for f in files if "tmp" in f], files
        assert len([f for f in files if f.startswith("cache/features/")]) == PIPE_IMAGES
        assert len([f for f in files if f.startswith("cache/two_view/")]) == 1
        assert r["pipe_R"].shape == (PIPE_IMAGES, 3, 3)
        assert r["pipe_rot_err_deg"][0] <= 1.0 and r["pipe_rot_err_deg"][1] <= 0.1, r["pipe_rot_err_deg"]
    rel = lambda R: np.einsum("ji,njk->nik", R[0], R.astype(np.float64))  # noqa: E731
    # the model on disk is the first rank's scene (up to the export's rigid alignment)
    assert rot_errors_deg(rel(got["pipe_model_R"]), rel(got["pipe_R"])).max() < 1e-3
    assert rot_errors_deg(rel(got["pipe_R"]), rel(want["pipe_R"])).max() < 0.1


def test_pipeline_rerun_with_separate_caches(runs):
    """A second run of the runner on the same group, each rank with a cache
    directory of its own: the first rank's warm from the first run, the
    second rank's empty (hosts that share no cache_dir). The ranks agree on
    what any of them missed, so both detect every image and verify every
    pair again and finish within GROUP_TIMEOUT_S (without the agreement the
    first rank skips the sharded stages the second waits in) with equal
    scenes (test_ranks_agree), the first run's cameras bit for bit, at
    run_sift's bars; the first rank alone saves the reports."""
    r0, r1 = runs["ranks"]
    np.testing.assert_array_equal(r1["rerun_pipe_R"], r0["rerun_pipe_R"])
    np.testing.assert_array_equal(r0["rerun_pipe_R"], r0["pipe_R"])
    assert [int(r["rerun_pipe_saved_reports"]) for r in (r0, r1)] == [1, 0]
    files = [str(f) for f in r0["rerun_pipe_files"]]
    assert "ba_output/cameras.txt" in files and not [f for f in files if f.startswith("cache")], files
    assert r0["rerun_pipe_rot_err_deg"][0] <= 1.0 and r0["rerun_pipe_rot_err_deg"][1] <= 0.1
    assert np.all(r0["rerun_pipe_ba_stages"][:, 0] == 2)


def test_float64_pcg_stops_at_tolerance_on_two_ranks(runs):
    """lm_optimize in float64 on the PCG solve with the float64 stages' cap
    of 500 PCG iterations: on two ranks the PCG stops at pcg_tol as on one
    rank (the same PCG iterations a LM iteration, within 2), the ranks
    deciding each stop in a matvec's all_reduce. Per LM iteration: the
    normal equations, the right-hand side, the first matvec (2), 2 a PCG
    iteration, the matvec that carried the stop (2, unless the cap ended
    the PCG), the back-substitution and the cost; plus the first cost. So
    well under 2 x 500 all_reduces a LM iteration, and the final cost
    within 1e-3 of one rank's. (At the optimum the last LM iteration's PCG
    reaches the cap on one rank too: its right-hand side is left in the
    weakly damped scale of the gauge.)"""
    got, want = runs["ranks"][0], runs["one"]
    (it, pcg, calls), (it1, pcg1, calls1) = got["pcg64_counts"], want["pcg64_counts"]
    assert it > 0 and calls1 == 0
    assert pcg < it * PCG64_ITERATIONS and abs(pcg / it - pcg1 / it1) <= 2, (it, pcg, it1, pcg1)
    assert 1 + 6 * it + 2 * pcg <= calls <= 1 + 8 * it + 2 * pcg, (it, pcg, calls)
    assert calls / it < 0.5 * 2 * PCG64_ITERATIONS, (it, pcg, calls)
    c, c1 = got["pcg64_cost"], want["pcg64_cost"]
    assert c[1] < 0.05 * c[0] and abs(c[1] - c1[1]) <= 1e-3 * c1[1], (c, c1)


def test_any_rank_ors_the_ranks_flags(runs, tmp_path):
    """Mesh.any_rank with rank-dependent flags (rank 0 [T, F, T], rank 1
    [F, F, T]): both ranks get [T, F, T] from exactly one all_reduce. A
    mesh of one rank returns its flags with no call: without a process
    group, and in a process group of one rank."""
    for r in runs["ranks"]:
        assert r["agree_any"].tolist() == [True, False, True] and int(r["agree_calls"]) == 1
    assert runs["one"]["agree_any"].tolist() == [True, False, True] and int(runs["one"]["agree_calls"]) == 0
    multihost.initialize("file://" + str(tmp_path / "store"), 1, 0, device="cpu", timeout_s=GROUP_TIMEOUT_S)
    try:
        mesh = distributed.make_mesh()
        assert mesh.group is not None and mesh.size == 1
        assert mesh.any_rank([False, True]).tolist() == [False, True]
        assert mesh.collective_calls["all_reduce"] == 0
    finally:
        multihost.shutdown()


def test_layout_errors(runs):
    """An indivisible sharded axis raises on two ranks (shard_inputs), and
    on one rank every axis divides; the banded step raises as the
    single-card BA's band does."""
    assert all(bool(r["indivisible_raised"]) for r in runs["ranks"])
    mesh = distributed.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.axis_names) == (1, 0, None, ("data",))
    x = torch.arange(3)
    assert torch.equal(multihost.shard_inputs(mesh, multihost.P("data"), (x,))[0], x)
    with pytest.raises(ValueError, match="process group"):
        distributed.make_mesh(2, device="cpu")
    sc, _ = arc_problem()
    with pytest.raises(NotImplementedError, match="TPU layout"):
        distributed.distributed_ba_gn_step_banded(mesh, sc, 4, (1, 1, 1, 1, 1), None)


def test_one_rank_mesh_is_the_single_card_loop():
    """lm_optimize with a mesh of one rank is the single-card LM without the
    bfloat16 coupling, bit for bit, with priors, for both solves."""
    sc, (wRi, wti) = arc_problem(seed=1)
    priors = priors_from(sequential_priors(wRi, wti))
    mesh = distributed.make_mesh(device="cpu")
    cfg = ba.BAConfig(max_iterations=LM_ITERATIONS, bucket_l=ba.auto_bucket_l(sc), schur_bf16=False)
    for dense in (True, False):
        want = ba.lm_optimize(sc, cfg, priors=priors, dense=dense)
        got = ba.lm_optimize(sc, cfg, priors=priors, dense=dense, mesh=mesh)
        assert got.iterations == want.iterations and got.accepted == want.accepted > 0
        for f in ("wRi", "wti", "points"):
            assert torch.equal(getattr(got.scene, f), getattr(want.scene, f)), (dense, f)


class _Rank:
    """A mesh's size and rank, for the layout helpers."""

    def __init__(self, size: int, rank: int):
        self.size, self.rank = size, rank


def test_rank_rows_split_tracks_and_measurements():
    """The dense step gives each rank T / size whole tracks and their rows
    (measurements sorted by track), the PCG step contiguous rows, uneven
    when the rows do not divide."""
    sc, _ = arc_problem(n_tracks=30)
    s, _ = ba._sorted_measurements(sc, None)
    M, T = s.meas_cam.shape[0], s.num_tracks_padded
    live = s.meas_mask > 0
    assert T % 4 == 0 and M % 3 != 0
    for size in (2, 4, 3):
        pcg = [ba._rank_rows(s, _Rank(size, r), dense=False) for r in range(size)]
        assert [r for r, _ in pcg] == [(r * M // size, (r + 1) * M // size) for r in range(size)]
        assert all(t is None for _, t in pcg)
        if T % size:
            with pytest.raises(ValueError, match="pad the tracks"):
                ba._rank_rows(s, _Rank(size, 0), dense=True)
            continue
        rows = [ba._rank_rows(s, _Rank(size, r), dense=True) for r in range(size)]
        assert [t for _, t in rows] == [(r * T // size, (r + 1) * T // size) for r in range(size)]
        assert rows[0][0][0] == 0 and all(rows[r][0][1] == rows[r + 1][0][0] for r in range(size - 1))
        for (lo, hi), (t0, t1) in rows:
            mt = s.meas_track[lo:hi][live[lo:hi]]
            assert bool(((mt >= t0) & (mt < t1)).all())
    assert ba._rank_rows(s, None, dense=True) == ((0, M), None)


def test_initialize_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """No fallback: a CUDA device without a card raises before any process
    group exists, and without a coordinator initialize says how to launch."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: initialize binds to it")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        multihost.initialize("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        multihost.initialize(device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        multihost.initialize("127.0.0.1:1", 1, 0, device="cpu", backend="nccl")
    assert not torch.distributed.is_initialized()
