"""Port parity for the GT-mesh correspondence classification
(gtsfm_tpu_torch/evaluation/mesh_metrics.py) against the JAX package, on
the CPU, on a patch of the synthetic survey's terrain meshed on a 33 x 33
vertex grid (2,048 triangles).

Tolerances, as each test states:
  * read_ply_mesh on ascii, binary (with an extra vertex property) and
    quad-fan files: the same arrays, exactly;
  * backproject_rays: directions within 1e-6 (the JAX package's matmul
    against the port's column sums);
  * _min_hit_t_for_faces and ray_mesh_first_hit at F <= face_chunk and at
    F > face_chunk (face_chunk 300: 7 tiles, the last one padded): hit
    masks identical except for rays whose u, v or u + v lies within 1e-5
    of a bound of some face they reach (XLA:CPU contracts a * b + c into
    fused multiply-adds, torch rounds each operation); points within 1e-4
    of the terrain's units (its extent is about 34);
  * mesh_inlier_correspondences with a radial k1 (bundler_calibrate's 10
    fixed-point steps): is_inlier identical, reproj_err within 3e-4 px
    where finite, and within 1e-5 px at the median (a hit point's float32
    step at the terrain's coordinates of ~30 is 2e-6, 7.6e-5 px through a
    camera 10 units away at f = 380; the two packages' hit points differ by
    a few steps, up to 1.2e-4 px on this data), the same NaN pattern
    (correspondences with a ray near a bound excepted, as above);
  * mesh_inlier_correspondences_batched: each pair's result equal, bit for
    bit, to the port's per-pair call.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import survey_mesh
from gtsfm_tpu.evaluation import mesh_metrics as jax_mesh
from gtsfm_tpu_torch.evaluation import mesh_metrics
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader

torch.set_num_threads(2)

B_EPS = 1e-4
NEAR_BOUND = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps the JIT code of every compiled program mapped for the
    life of the process; the programs this file compiled are dropped when
    it ends."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def terrain():
    loader = SyntheticAerialLoader(num_images=6, rows=2)
    verts, faces = survey_mesh(loader, 33)
    return loader, verts, faces


def _rays(loader, index, n, seed=0, k1=0.0):
    """n random pixel rays of survey camera ``index`` (numpy, float32)."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform([0.0, 0.0], [512.0, 384.0], (n, 2)).astype(np.float32)
    cal = loader.get_camera_intrinsics_full_res(index).copy()
    cal[1] = k1
    wRi, wti = loader.get_camera_pose(index)
    return uv, cal, wRi, wti


def _near_bound(origins, dirs, verts, faces, eps=1e-7):
    """(N,) bool, in float64: the ray reaches (t > eps, inside the tolerant
    bounds grown by NEAR_BOUND) some face at whose u, v or u + v bound it
    lies within NEAR_BOUND."""
    o, d = origins.astype(np.float64), dirs.astype(np.float64)
    v0 = verts[faces[:, 0]].astype(np.float64)
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0
    h = np.cross(d[:, None], e2[None])
    a = np.sum(e1[None] * h, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = 1.0 / a
        s = o[:, None] - v0[None]
        u = f * np.sum(s * h, -1)
        q = np.cross(s, e1[None])
        v = f * np.sum(d[:, None] * q, -1)
        t = f * np.sum(e2[None] * q, -1)
    lo, hi = -B_EPS - NEAR_BOUND, 1.0 + B_EPS + NEAR_BOUND
    reach = (np.abs(a) >= eps) & (t > eps) & (u >= lo) & (u <= hi) & (v >= lo) & (u + v <= hi)
    near = np.zeros_like(reach)
    for x, bounds in ((u, (-B_EPS, 1.0 + B_EPS)), (v, (-B_EPS,)), (u + v, (1.0 + B_EPS,))):
        for b in bounds:
            near |= np.abs(x - b) < NEAR_BOUND
    return np.any(reach & near, axis=1)


def _write_ply(path, fmt):
    """A small PLY: a unit square as 2 triangles (ascii / binary with an
    extra uchar vertex property) or as one quad and one pentagon (fan)."""
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 1.5, 0.25]], np.float32)
    faces = [[0, 1, 2], [0, 2, 3]] if fmt != "fan" else [[0, 1, 2, 3], [3, 2, 4, 0, 1]]
    head = ["ply", f"format {'ascii' if fmt == 'ascii' else 'binary_little_endian'} 1.0",
            f"element vertex {len(verts)}", "property float x", "property float y", "property float z"]
    if fmt == "binary":
        head.append("property uchar red")
    head += [f"element face {len(faces)}", "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as fh:
        fh.write(("\n".join(head) + "\n").encode())
        if fmt == "ascii":
            fh.write("".join(" ".join(map(str, v)) + "\n" for v in verts).encode())
            fh.write("".join(f"{len(fc)} " + " ".join(map(str, fc)) + "\n" for fc in faces).encode())
            return
        for k, v in enumerate(verts):
            fh.write(np.asarray(v, "<f4").tobytes() + (bytes([k]) if fmt == "binary" else b""))
        for fc in faces:
            fh.write(bytes([len(fc)]) + np.asarray(fc, "<i4").tobytes())


@pytest.mark.parametrize("fmt", ["ascii", "binary", "fan"])
def test_read_ply_mesh_matches(tmp_path, fmt):
    """Exact: the same vertices and (fan-triangulated) faces, dtypes too."""
    path = str(tmp_path / f"{fmt}.ply")
    _write_ply(path, fmt)
    v, f = mesh_metrics.read_ply_mesh(path)
    vj, fj = jax_mesh.read_ply_mesh(path)
    assert v.dtype == vj.dtype and f.dtype == fj.dtype
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(f, fj)
    assert f.shape == ((2, 3) if fmt != "fan" else (5, 3))


def test_read_ply_mesh_survey_terrain(tmp_path, terrain):
    """The binary triangle block read in one view: the same arrays as the
    JAX reader's face-by-face loop, and as written."""
    from chip_smoke import write_ply_mesh

    _, verts, faces = terrain
    path = str(tmp_path / "terrain.ply")
    write_ply_mesh(path, verts, faces)
    v, f = mesh_metrics.read_ply_mesh(path)
    vj, fj = jax_mesh.read_ply_mesh(path)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(f, fj)
    np.testing.assert_array_equal(f, faces)


def test_backproject_rays_match(terrain):
    loader, _, _ = terrain
    uv, cal, wRi, wti = _rays(loader, 1, 256, k1=-0.05)
    o, d = mesh_metrics.backproject_rays(*(torch.as_tensor(x) for x in (uv, cal, wRi, wti)))
    oj, dj = jax_mesh.backproject_rays(*(jnp.asarray(x) for x in (uv, cal, wRi, wti)))
    np.testing.assert_array_equal(o.numpy(), np.asarray(oj))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=0, atol=1e-6)


def _cast_rays(terrain, n=600):
    loader, verts, faces = terrain
    parts = [mesh_metrics.backproject_rays(*(torch.as_tensor(x) for x in _rays(loader, i, n // 3, seed=i)))
             for i in (0, 2, 4)]
    origins = torch.cat([o for o, _ in parts]).contiguous()
    dirs = torch.cat([d for _, d in parts])
    # a few rays aimed at the terrain's outer edge, and upward misses
    dirs[:8, 2] = -dirs[:8, 2]
    return origins, dirs


def test_min_hit_t_for_faces_matches(terrain):
    """One tile of faces: hit (finite t) identical off the bounds, t within
    1e-5 relative."""
    _, verts, faces = terrain
    origins, dirs = _cast_rays(terrain)
    t = mesh_metrics._min_hit_t_for_faces(origins, dirs, torch.as_tensor(verts), torch.as_tensor(faces), 1e-7)
    tj = np.asarray(jax_mesh._min_hit_t_for_faces(jnp.asarray(origins.numpy()), jnp.asarray(dirs.numpy()),
                                                   jnp.asarray(verts), jnp.asarray(faces), 1e-7))
    off = ~_near_bound(origins.numpy(), dirs.numpy(), verts, faces)
    hit = np.isfinite(t.numpy())
    np.testing.assert_array_equal(hit[off], np.isfinite(tj)[off])
    both = hit & np.isfinite(tj)
    assert both.sum() >= 500
    np.testing.assert_allclose(t.numpy()[both], tj[both], rtol=1e-5)


@pytest.mark.parametrize("face_chunk", [8192, 300])
def test_ray_mesh_first_hit_matches(terrain, face_chunk):
    """F <= face_chunk (one tile) and F > face_chunk (7 tiles of 300, the
    last padded with degenerate triangles): hit masks identical off the
    bounds, points within 1e-4."""
    _, verts, faces = terrain
    origins, dirs = _cast_rays(terrain)
    hit, pts = mesh_metrics.ray_mesh_first_hit(origins, dirs, verts, faces, face_chunk=face_chunk)
    hj, pj = jax_mesh.ray_mesh_first_hit(jnp.asarray(origins.numpy()), jnp.asarray(dirs.numpy()),
                                         jnp.asarray(verts), jnp.asarray(faces), face_chunk=face_chunk)
    hj, pj = np.asarray(hj), np.asarray(pj)
    off = ~_near_bound(origins.numpy(), dirs.numpy(), verts, faces)
    hit = hit.numpy()
    np.testing.assert_array_equal(hit[off], hj[off])
    assert 500 <= hit.sum() < len(hit)  # the upward rays miss
    both = hit & hj
    np.testing.assert_allclose(pts.numpy()[both], pj[both], rtol=0, atol=1e-4)


def _correspondences(loader, a, b, n=160, seed=0, k1=-0.05):
    """uv pairs of cameras a and b: terrain points seen by both (with 0.3 px
    noise), 20 of them moved 12-20 px in image b, and 10 rays off the
    terrain patch in image a."""
    rng = np.random.default_rng(seed)
    cams = []
    for i in (a, b):
        cal = loader.get_camera_intrinsics_full_res(i).copy()
        cal[1] = k1
        cams.append((cal, *loader.get_camera_pose(i)))
    (c1, R1, t1), (c2, R2, t2) = cams
    xy = rng.uniform(6.0, loader._world_size - 6.0, (4 * n, 2))
    X = np.concatenate([xy, loader._height(xy[:, 0], xy[:, 1])[:, None]], 1)

    def project(cal, R, t):
        pc = (X - t) @ R
        p = pc[:, :2] / pc[:, 2:]
        return cal[0] * (1 + cal[1] * np.sum(p * p, 1))[:, None] * p + cal[3:5], pc[:, 2]

    (uv1, z1), (uv2, z2) = project(c1, R1, t1), project(c2, R2, t2)
    seen = np.nonzero((z1 > 0) & (z2 > 0) & np.all((uv1 >= 0) & (uv1 < (512, 384)), 1)
                      & np.all((uv2 >= 0) & (uv2 < (512, 384)), 1))[0][:n]
    uv1, uv2 = uv1[seen] + rng.normal(0, 0.3, (len(seen), 2)), uv2[seen] + rng.normal(0, 0.3, (len(seen), 2))
    uv2[:20] += rng.uniform(12.0, 20.0, (20, 2)) * rng.choice([-1.0, 1.0], (20, 2))
    uv1 = np.concatenate([uv1, rng.uniform([-4000.0, -4000.0], [-3000.0, -3000.0], (10, 2))])
    uv2 = np.concatenate([uv2, rng.uniform(0.0, 300.0, (10, 2))])
    return (uv1.astype(np.float32), uv2.astype(np.float32), c1, c2, R1, t1, R2, t2)


def test_mesh_inlier_correspondences_matches(terrain):
    """is_inlier identical, reproj_err within 3e-4 px (1e-5 at the median)
    where finite and the same NaN pattern, on correspondences off the
    bounds; the test's
    construction shows: inliers, the moved ones rejected, the off-patch
    rays unclassified."""
    loader, verts, faces = terrain
    args = _correspondences(loader, 0, 1)
    inl, err = mesh_metrics.mesh_inlier_correspondences(*(torch.as_tensor(x) for x in args), verts, faces)
    inl_j, err_j = jax_mesh.mesh_inlier_correspondences(*(jnp.asarray(x) for x in args), jnp.asarray(verts),
                                                        jnp.asarray(faces))
    inl, err, inl_j, err_j = inl.numpy(), err.numpy(), np.asarray(inl_j), np.asarray(err_j)
    uv1, uv2, c1, c2, R1, t1, R2, t2 = args
    near = np.zeros(len(uv1), bool)
    for uv, cal, R, t in ((uv1, c1, R1, t1), (uv2, c2, R2, t2)):
        o, d = mesh_metrics.backproject_rays(*(torch.as_tensor(x) for x in (uv, cal, R, t)))
        near |= _near_bound(o.numpy(), d.numpy(), verts, faces)
    off = ~near
    assert off.sum() >= len(off) - 2
    np.testing.assert_array_equal(inl[off], inl_j[off])
    np.testing.assert_array_equal(np.isnan(err[off]), np.isnan(err_j[off]))
    fin = off & np.isfinite(err)
    np.testing.assert_allclose(err[fin], err_j[fin], rtol=0, atol=3e-4)
    assert np.median(np.abs(err[fin] - err_j[fin])) <= 1e-5
    assert inl[20:-10].mean() >= 0.95 and not inl[:20].any() and np.isnan(err[-10:]).all()


def test_batched_equals_per_pair(terrain):
    """Four pairs (both sides' rays cast together, 7 tiles of 300 faces; the
    fourth shares one side's rays with the first): every pair's is_inlier and
    reproj_err equal the per-pair call's, bit for bit."""
    loader, verts, faces = terrain
    pairs = [tuple(torch.as_tensor(x) for x in _correspondences(loader, a, b, seed=a))
             for a, b in ((0, 1), (1, 2), (3, 4))]
    # a fourth pair shares the first one's image-1 keypoints (its image-2
    # side moved by 0.5 px): those rays are cast once
    pairs.append(pairs[0][:1] + (pairs[0][1] + 0.5,) + pairs[0][2:])
    batched, info = mesh_metrics.mesh_inlier_correspondences_batched(pairs, verts, faces, face_chunk=300)
    assert info["rays"] == sum(2 * len(p[0]) for p in pairs) and info["faces"] == len(faces)
    assert info["rays_cast"] == info["rays"] - len(pairs[0][0])
    assert 0 < info["ray_triangle_tests"] < info["rays_cast"] * len(faces)
    for p, (inl_b, err_b) in zip(pairs, batched):
        o = [mesh_metrics.backproject_rays(uv, cal, R, t) for uv, cal, R, t in ((p[0], p[2], p[4], p[5]),
                                                                               (p[1], p[3], p[6], p[7]))]
        hits = [mesh_metrics.ray_mesh_first_hit(oo, dd, verts, faces, face_chunk=300) for oo, dd in o]
        inl, err = mesh_metrics._classify(*p, *hits[0], *hits[1], 4.0)
        assert torch.equal(inl, inl_b)
        assert torch.equal(torch.isnan(err), torch.isnan(err_b))
        assert torch.equal(err[~torch.isnan(err)], err_b[~torch.isnan(err_b)])
    inl_default, _ = mesh_metrics.mesh_inlier_correspondences(*pairs[0], verts, faces)
    assert torch.equal(inl_default, batched[0][0])
