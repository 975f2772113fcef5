"""The port's runner CLI (gtsfm_tpu_torch.runner) against the JAX package's:
the same argparse options and defaults, presets resolved against the port's
configs/, and main() reconstructing an Olsson-format folder that the test
writes (6 survey renders as JPG and data.mat with P = K [R | t]) on the CPU
with the default configuration (SIFT at 4096 keypoints, mutual-NN, plots).
The COLMAP model it writes is then read by both packages' ColmapLoader
(equal names, poses, calibrations, sizes, images and pairs) and
reconstructed again through ``--loader colmap``. ``--loader hilti`` runs on
a folder of synthetic fisheye rig renders in the Hilti layout. The
multi-GPU options (distributed BA, ``--multihost``, ``--coordinator_address``)
run at world size 1 over gloo.
"""

import contextlib
import io
import os
import socket

import numpy as np
import pytest
import torch

from chip_smoke import rot_errors_deg, write_hilti_folder, write_olsson_folder
from gtsfm_tpu.loader.colmap import ColmapLoader as JaxColmapLoader
from gtsfm_tpu.runner import __main__ as jax_runner
from gtsfm_tpu_torch.loader.colmap import ColmapLoader
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.runner import __main__ as runner

torch.set_num_threads(2)

NUM_IMAGES = 6
MODEL_FILES = ("ba_output/cameras.txt", "ba_output/images.txt", "ba_output/points3D.txt", "viewer.html",
               "result_metrics/summary.json", "plots/process_graph.dot", "plots/scene_3d.png")


def _main(argv):
    """runner.main on the CPU: (return code, its DONE lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = runner.main(argv, device="cpu")
    return rc, [line for line in buf.getvalue().splitlines() if line.startswith("DONE:")]


def _check_model(rc, done, out):
    assert rc == 0
    assert len(done) == 1 and done[0].startswith(f"DONE: {NUM_IMAGES} cameras,") and done[0].endswith(f"{out}/")
    for f in MODEL_FILES:
        assert os.path.isfile(os.path.join(out, f)), f
    with open(os.path.join(out, "ba_output", "points3D.txt")) as fh:
        assert sum(1 for line in fh if not line.startswith("#")) >= 100


@pytest.fixture(scope="module")
def olsson_run(tmp_path_factory):
    """main() once on the Olsson folder the test writes."""
    tmp = tmp_path_factory.mktemp("runner")
    data = write_olsson_folder(str(tmp / "survey"), SyntheticAerialLoader(num_images=NUM_IMAGES, rows=2),
                               range(NUM_IMAGES))
    out = str(tmp / "results")
    rc, done = _main(["--dataset_root", data, "--output_root", out, "--cache_dir", str(tmp / "cache")])
    return dict(tmp=tmp, data=data, out=out, rc=rc, done=done)


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, tuple(a.choices or ()), a.required, a.type, a.nargs,
                     a.const) for a in parser._actions}


def test_parser_matches_jax_runner():
    assert _options(runner.build_parser()) == _options(jax_runner.build_parser())
    args = ["--dataset_root", "d", "--override", "a.b=1", "--override", "c=2", "--no_cache"]
    assert vars(runner.build_parser().parse_args(args)) == vars(jax_runner.build_parser().parse_args(args))


def test_presets_resolve_to_the_port_configs():
    for name in ("sift_front_end", "deep_front_end.yaml"):
        path = runner.resolve_config_path(name)
        assert os.path.dirname(path).endswith(os.path.join("gtsfm_tpu_torch", "configs"))
        with open(path) as fh, open(jax_runner.resolve_config_path(name)) as jfh:
            assert fh.read() == jfh.read()
    with pytest.raises(FileNotFoundError):
        runner.resolve_config_path("no_such_preset")


def test_main_reconstructs_an_olsson_folder(olsson_run):
    _check_model(olsson_run["rc"], olsson_run["done"], olsson_run["out"])


@pytest.mark.parametrize("with_images", [False, True])
def test_colmap_loader_matches_jax(olsson_run, with_images):
    """Both packages' ColmapLoader on the model main() wrote, with and
    without the images folder."""
    model = os.path.join(olsson_run["out"], "ba_output")
    images_dir = os.path.join(olsson_run["data"], "images") if with_images else None
    port, ref = ColmapLoader(model, images_dir=images_dir), JaxColmapLoader(model, images_dir=images_dir)
    assert len(port) == len(ref) == NUM_IMAGES
    assert port.image_filenames() == ref.image_filenames() == [f"image_{k:03d}.jpg" for k in range(NUM_IMAGES)]
    for i in range(NUM_IMAGES):
        for a, b in zip(port.get_camera_pose(i), ref.get_camera_pose(i)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(port.get_camera_intrinsics_full_res(i), ref.get_camera_intrinsics_full_res(i))
        (pimg, pcal), (rimg, rcal) = port.get_image(i), ref.get_image(i)
        np.testing.assert_array_equal(pcal, rcal)
        assert (pimg.width, pimg.height) == (rimg.width, rimg.height)
        np.testing.assert_array_equal(pimg.value_array, np.asarray(rimg.value_array))
        assert pimg.value_array.any() == with_images
    assert all(port.is_valid_pair(a, b) == ref.is_valid_pair(a, b)
               for a in range(NUM_IMAGES) for b in range(NUM_IMAGES))
    for a, b in zip(port.get_all_poses(), ref.get_all_poses()):
        np.testing.assert_array_equal(a, b)


def test_main_reconstructs_a_colmap_model(olsson_run):
    """--loader colmap on the model of the Olsson run and its images."""
    tmp = olsson_run["tmp"]
    out = str(tmp / "results_colmap")
    rc, done = _main(["--loader", "colmap", "--dataset_root", os.path.join(olsson_run["out"], "ba_output"),
                      "--images_dir", os.path.join(olsson_run["data"], "images"), "--output_root", out,
                      "--cache_dir", str(tmp / "cache")])
    _check_model(rc, done, out)


def test_main_reconstructs_a_hilti_rig(tmp_path):
    """--loader hilti on a 3-rig folder of fisheye renders (15 images at
    720 x 540, read at 480 x 360, 1024 SIFT keypoints, the rig window
    regime): every camera placed and the COLMAP cameras written as
    OPENCV_FISHEYE at the rescaled resolution."""
    data = write_hilti_folder(str(tmp_path / "hilti"), 3, render=True)
    out = str(tmp_path / "results")
    rc, done = _main(["--loader", "hilti", "--dataset_root", data, "--output_root", out, "--no_cache",
                      "--max_resolution", "360", "--override", "retriever.regime=sequential_hilti",
                      "--override", "frontend.max_keypoints=1024", "--override", "save_plots=false"])
    assert rc == 0 and len(done) == 1 and done[0].startswith("DONE: 15 cameras,")
    with open(os.path.join(out, "ba_output", "cameras.txt")) as fh:
        lines = [line.split() for line in fh if not line.startswith("#")]
    assert len(lines) == 15 and all(ln[1:4] == ["OPENCV_FISHEYE", "480", "360"] for ln in lines)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _relative_rotations(model: str) -> np.ndarray:
    """R_0^T R_i of the model's cameras (free of the export's global frame)."""
    loader = ColmapLoader(model)
    R = np.stack([np.asarray(loader.get_camera_pose(i)[0], np.float64) for i in range(len(loader))])
    return R[0].T @ R


@pytest.mark.parametrize("argv", [["--override", "multi_view.distributed_ba=on"], ["--multihost"],
                                  ["--coordinator_address", "localhost:{port}"]],
                         ids=["distributed_ba", "multihost", "coordinator_address"])
def test_multi_gpu_options_run(argv, olsson_run, monkeypatch):
    """The multi-GPU options at world size 1 on the CPU (gloo): distributed
    BA over a mesh of one rank, and the process group joined from torchrun's
    variables or from --coordinator_address. Each writes the model, with the
    single-card run's cameras (relative rotations within 1e-2 deg)."""
    port = _free_port()
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0",
                     LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    out = str(olsson_run["tmp"] / f"multi_gpu_{argv[0].strip('-')}")
    try:
        rc, done = _main(["--dataset_root", olsson_run["data"], "--output_root", out, "--no_cache"]
                         + [a.format(port=port) for a in argv])
        assert not torch.distributed.is_initialized()  # main() destroys the group it made
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    _check_model(rc, done, out)
    got = _relative_rotations(os.path.join(out, "ba_output"))
    want = _relative_rotations(os.path.join(olsson_run["out"], "ba_output"))
    assert rot_errors_deg(got, want).max() < 1e-2


def test_main_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() runs on it")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        runner.main(["--dataset_root", str(tmp_path), "--output_root", str(tmp_path / "out")])
