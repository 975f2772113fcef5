"""Port parity for the host loaders and the COLMAP binary readers, against
the JAX package on the CPU.

Each loader reads a folder that ``chip_smoke.write_loader_folder`` writes
in its layout from 5 renders of the synthetic survey (MobileBrick,
1DSfM with EXIF focal lengths plus one image without EXIF, YFCC-IMB with
h5 calibrations, Argoverse with a log of ring-camera frames and ego
poses). Compared: file names, images, calibrations and GT poses (exact
where both packages run the same numpy; the Argoverse poses within 1e-6),
and the is_valid_pair table, under the constructor options each loader
has. The COLMAP binary readers run on handcrafted files with every camera
model the Cal3Bundler conversion takes and an image with no points.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from chip_smoke import write_colmap_bin, write_loader_folder
from gtsfm_tpu.io import colmap_bin as jax_colmap_bin
from gtsfm_tpu.loader.argoverse import ArgoverseLoader as JaxArgoverseLoader
from gtsfm_tpu.loader.mobilebrick import MobilebrickLoader as JaxMobilebrickLoader
from gtsfm_tpu.loader.one_d_sfm import OneDSFMLoader as JaxOneDSFMLoader
from gtsfm_tpu.loader.yfcc_imb import YfccImbLoader as JaxYfccImbLoader
from gtsfm_tpu_torch.io import colmap_bin
from gtsfm_tpu_torch.loader.argoverse import ArgoverseLoader
from gtsfm_tpu_torch.loader.mobilebrick import MobilebrickLoader
from gtsfm_tpu_torch.loader.one_d_sfm import OneDSFMLoader
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.loader.yfcc_imb import YfccImbLoader

torch.set_num_threads(2)

NUM_IMAGES = 5


@pytest.fixture(scope="module")
def survey():
    return SyntheticAerialLoader(num_images=NUM_IMAGES, rows=1)


def _same_loaders(port, ref, poses_atol=0.0):
    assert len(port) == len(ref)
    assert port.image_filenames() == ref.image_filenames()
    n = len(port)
    for i in range(n):
        np.testing.assert_array_equal(port.get_image_full_res(i).value_array, ref.get_image_full_res(i).value_array)
        cp, cr = port.get_camera_intrinsics_full_res(i), ref.get_camera_intrinsics_full_res(i)
        assert (cp is None) == (cr is None)
        if cp is not None:
            np.testing.assert_array_equal(cp, cr)
        pp, pr = port.get_camera_pose(i), ref.get_camera_pose(i)
        assert (pp is None) == (pr is None)
        if pp is not None:
            for a, b in zip(pp, pr):
                np.testing.assert_allclose(a, b, rtol=0, atol=poses_atol)
    table = [[port.is_valid_pair(i, j) for j in range(n)] for i in range(n)]
    assert table == [[ref.is_valid_pair(i, j) for j in range(n)] for i in range(n)]
    return table


def _gt_close(loader, survey, atol):
    """The loader's poses are the survey's GT poses (up to float32)."""
    for i in range(len(loader)):
        for a, b in zip(loader.get_camera_pose(i), survey.get_camera_pose(i)):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("lookahead", [5, 2])
def test_mobilebrick_matches(survey, tmp_path, lookahead):
    root = write_loader_folder("mobilebrick", str(tmp_path / "mb"), survey, range(NUM_IMAGES))
    for gt_intrinsics in (True, False):
        port = MobilebrickLoader(root, use_gt_intrinsics=gt_intrinsics, max_frame_lookahead=lookahead)
        ref = JaxMobilebrickLoader(root, use_gt_intrinsics=gt_intrinsics, max_frame_lookahead=lookahead)
        table = _same_loaders(port, ref)
    assert sum(map(sum, table)) == sum(NUM_IMAGES - d for d in range(1, min(lookahead, NUM_IMAGES - 1) + 1))
    _gt_close(port, survey, 1e-6)
    np.testing.assert_allclose(MobilebrickLoader(root).get_camera_intrinsics_full_res(0),
                               survey.get_camera_intrinsics_full_res(0), rtol=1e-6)


def test_one_d_sfm_matches(survey, tmp_path):
    root = write_loader_folder("onedsfm", str(tmp_path / "1dsfm"), survey, range(NUM_IMAGES))
    # an internet photo without EXIF: skipped unless enable_no_exif
    PILImage.fromarray(np.full((300, 200, 3), 90, np.uint8)).save(os.path.join(root, "images", "zz_noexif.png"))
    for no_exif in (False, True):
        kwargs = dict(enable_no_exif=no_exif, default_focal_length_factor=1.5)
        table = _same_loaders(OneDSFMLoader(root, **kwargs), JaxOneDSFMLoader(root, **kwargs))
        assert len(table) == NUM_IMAGES + int(no_exif)
    port = OneDSFMLoader(root, enable_no_exif=True, default_focal_length_factor=1.5)
    np.testing.assert_allclose(port.get_camera_intrinsics_full_res(0), survey.get_camera_intrinsics_full_res(0),
                               rtol=1e-4)
    np.testing.assert_allclose(port.get_camera_intrinsics_full_res(NUM_IMAGES), [450.0, 0, 0, 100.0, 150.0])
    with pytest.raises(RuntimeError, match="no usable images"):
        OneDSFMLoader(str(tmp_path))


def test_yfcc_imb_matches(survey, tmp_path):
    root = write_loader_folder("yfcc", str(tmp_path / "yfcc"), survey, range(NUM_IMAGES))
    # an image without its calibration file is left out
    PILImage.fromarray(np.zeros((8, 8, 3), np.uint8)).save(os.path.join(root, "images", "uncalibrated.jpg"))
    port, ref = YfccImbLoader(root), JaxYfccImbLoader(root)
    _same_loaders(port, ref)
    assert len(port) == NUM_IMAGES
    _gt_close(port, survey, 1e-5)


@pytest.mark.parametrize("kwargs", [{}, dict(stride=10, max_num_imgs=2, max_lookahead_sec=0.2),
                                    dict(stride=1, max_num_imgs=7)])
def test_argoverse_matches(survey, tmp_path, kwargs):
    """Poses within 1e-6 (both packages' float64 numpy, then float32); with
    the default stride of 5 the loader takes one frame of each 5, which are
    the survey's images, at the survey's poses re-anchored to the first."""
    root = write_loader_folder("argoverse", str(tmp_path / "argo"), survey, range(NUM_IMAGES))
    port, ref = ArgoverseLoader(root, **kwargs), JaxArgoverseLoader(root, **kwargs)
    _same_loaders(port, ref, poses_atol=1e-6)
    if not kwargs:
        assert len(port) == NUM_IMAGES
        R0, t0 = (np.asarray(a, np.float64) for a in survey.get_camera_pose(0))
        for i in range(NUM_IMAGES):
            R, t = (np.asarray(a, np.float64) for a in survey.get_camera_pose(i))
            np.testing.assert_allclose(port.get_camera_pose(i)[0], R0.T @ R, atol=1e-5)
            np.testing.assert_allclose(port.get_camera_pose(i)[1], R0.T @ (t - t0), atol=1e-5)
    with pytest.raises(FileNotFoundError):
        ArgoverseLoader(str(tmp_path))


def _handcrafted_model(root):
    """One camera of each model colmap_camera_to_cal3bundler takes, an
    image per camera (the third with no points), and 3 points."""
    params = {0: [500.0, 320.0, 240.0], 1: [500.0, 510.0, 320.0, 240.0], 2: [480.0, 320.0, 240.0, -0.02],
              3: [470.0, 320.0, 240.0, -0.03, 0.004], 4: [500.0, 490.0, 320.0, 240.0, -0.1, 0.02, 1e-3, 2e-3],
              6: [500.0, 490.0, 320.0, 240.0, -0.1, 0.02, 1e-3, 2e-3, 0.001, 0.0, 0.0, 0.0]}
    cams = [(k + 1, model, 640, 480, p) for k, (model, p) in enumerate(params.items())]
    rng = np.random.default_rng(3)
    imgs = []
    for k in range(len(cams)):
        q = rng.normal(size=4)
        n = 0 if k == 2 else 4 + k
        imgs.append((10 + k, q / np.linalg.norm(q), rng.normal(size=3), k + 1, f"img_{5 - k}.jpg",
                     rng.uniform(0, 640, (n, 2)), np.where(np.arange(n) % 2, -1, np.arange(n) // 2 + 1)))
    points = [(j + 1, rng.normal(size=3), (j, 2 * j, 3 * j), 0.25 * j, [(10, 2 * j), (11, 2 * j)]) for j in range(3)]
    write_colmap_bin(root, cams, imgs, points)
    return cams, imgs, points


def test_colmap_bin_readers_match(tmp_path):
    """cameras.bin, images.bin and points3D.bin: the same values as the JAX
    readers and as written, the image without points keeping its entry."""
    root = str(tmp_path)
    cams, imgs, points = _handcrafted_model(root)
    pc, jc = (m.read_cameras_bin(os.path.join(root, "cameras.bin")) for m in (colmap_bin, jax_colmap_bin))
    assert sorted(pc) == sorted(jc) == [c[0] for c in cams]
    for cam_id, model_id, w, h, p in cams:
        name, pw, ph, params = pc[cam_id]
        assert (name, pw, ph) == (colmap_bin.CAMERA_MODELS[model_id][0], w, h) == jc[cam_id][:3]
        np.testing.assert_array_equal(params, p)
        np.testing.assert_array_equal(params, jc[cam_id][3])
        np.testing.assert_array_equal(colmap_bin.colmap_camera_to_cal3bundler(name, params),
                                      jax_colmap_bin.colmap_camera_to_cal3bundler(name, params))
    pi, ji = (m.read_images_bin(os.path.join(root, "images.bin")) for m in (colmap_bin, jax_colmap_bin))
    assert sorted(pi) == sorted(ji) == [im[0] for im in imgs]
    for img_id, q, t, cam_id, name, xys, ids in imgs:
        got = pi[img_id]
        assert got[2:4] == (cam_id, name) == ji[img_id][2:4]
        for a, b, ref in zip(got[:2] + got[4:], ji[img_id][:2] + ji[img_id][4:], (q, t, xys, ids)):
            np.testing.assert_array_equal(a, ref)
            np.testing.assert_array_equal(a, b)
    assert pi[12][4].shape == (0, 2) and pi[12][5].shape == (0,)
    pp, jp = (m.read_points3d_bin(os.path.join(root, "points3D.bin")) for m in (colmap_bin, jax_colmap_bin))
    for a, b in zip(pp[:4], jp[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert pp[4] == jp[4] == [p[4] for p in points]
    np.testing.assert_array_equal(pp[1], np.stack([p[1] for p in points]))
    with pytest.raises(ValueError, match="unsupported COLMAP model"):
        colmap_bin.colmap_camera_to_cal3bundler("FOV", np.ones(5))
