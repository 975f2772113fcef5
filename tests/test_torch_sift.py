"""Port parity for the SIFT detector: gtsfm_tpu.frontend.sift against
gtsfm_tpu_torch.frontend.sift on the same images (CPU).

Detection is held by correspondence, not slot identity (blur summation order
and top-k ties may reorder the list): recall is the share of the JAX
package's live keypoints that have a live port keypoint within 0.01 px, and
the live counts agree within 1%. On those pairs: descriptors within 1e-4
(max abs), scale and response within 1e-4 relative. Helpers are held to 1e-5
on shared inputs.

Semantics checked along the way: floor-mod (``%`` / ``torch.remainder``) in
the histogram bins and orientation channels, the first maximum of
``argmax``, the per-keypoint clamp ``Wk - 1.001``, the wrapping ``roll`` of
the Hessian and ``jnp.gradient``'s one-sided edges.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from gtsfm_tpu.frontend import sift as jsift
from gtsfm_tpu_torch.common.image import to_grayscale
from gtsfm_tpu_torch.frontend import sift
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader

torch.set_num_threads(2)

SMALL = dict(max_keypoints=256, num_octaves=3, k_per_level=128)  # tests/frontend/test_sift.py
RENDER = dict(max_keypoints=1024)
UV_TOL_PX = 0.01
DESC_ATOL = 1e-4
REL_TOL = 1e-4
HELPER_ATOL = 1e-5


def _texture(n=160):
    """tests/frontend/test_sift.py's smooth random texture (seed 42)."""
    img = gaussian_filter(np.random.default_rng(42).normal(size=(n, n)).astype(np.float32), 3.0)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


def _render():
    img, _ = SyntheticAerialLoader(num_images=8, rows=2).get_image(0)
    return to_grayscale(img.value_array)


def _jax_features(img, kw):
    return jax.tree.map(np.asarray, jsift.detect_and_describe(jnp.asarray(img), **kw))


def _port_features(imgs, kw):
    out = sift.detect_and_describe(torch.as_tensor(np.asarray(imgs)), **kw)
    return sift.SiftFeatures(*(t.numpy() for t in out))


@pytest.fixture(scope="module", params=["texture_small", "render_384x512"])
def case(request):
    img, kw = (_texture(), SMALL) if request.param == "texture_small" else (_render(), RENDER)
    port = _port_features(img[None], kw)
    return img, kw, _jax_features(img, kw), sift.SiftFeatures(*(a[0] for a in port))


def _correspondence(j, p):
    """For each live JAX keypoint, the nearest live port keypoint."""
    mj, mp = j.mask > 0, p.mask > 0
    d = np.linalg.norm(j.uv[mj][:, None] - p.uv[mp][None], axis=-1)
    return np.nonzero(mj)[0], np.nonzero(mp)[0][d.argmin(1)], d.min(1)


def test_detection_recall_and_count(case):
    _, _, j, p = case
    _, _, dist = _correspondence(j, p)
    recall = float(np.mean(dist <= UV_TOL_PX))
    n_j, n_p = int(j.mask.sum()), int(p.mask.sum())
    assert n_j > 50
    assert recall >= 0.99, recall
    assert abs(n_p - n_j) <= 0.01 * n_j, (n_j, n_p)


def test_descriptor_scale_response(case):
    _, _, j, p = case
    ij, ip, dist = _correspondence(j, p)
    ok = dist <= UV_TOL_PX
    ij, ip = ij[ok], ip[ok]
    assert np.abs(j.descriptor[ij] - p.descriptor[ip]).max() <= DESC_ATOL
    for field in ("scale", "response"):
        a, b = getattr(j, field)[ij], getattr(p, field)[ip]
        assert np.all(np.abs(a - b) <= REL_TOL * np.abs(a)), field
    np.testing.assert_allclose(np.linalg.norm(p.descriptor[p.mask > 0], axis=-1), 1.0, atol=1e-3)
    # pad slots are zero, as in the JAX package
    assert not np.any(p.uv[p.mask == 0]) and not np.any(p.descriptor[p.mask == 0])


def test_batch_equals_single_images():
    """A batch gives each image exactly what it gets alone."""
    base = _texture()
    imgs = np.stack([base, np.roll(base, 12, axis=0), np.rot90(base).copy()])
    batch = _port_features(imgs, SMALL)
    for b in range(len(imgs)):
        single = _port_features(imgs[b:b + 1], SMALL)
        for name, x, y in zip(sift.SiftFeatures._fields, batch, single):
            np.testing.assert_array_equal(x[b], y[0], err_msg=name)


def test_images_per_batch_bounds_memory():
    assert sift.images_per_batch(384, 512) == sift.BATCH_BYTES // (sift.PEAK_BYTES_PER_PIXEL * 384 * 512) == 21
    assert sift.images_per_batch(384, 512) < 128  # a 128-image group is split
    assert sift.images_per_batch(20000, 20000) == 1


# ---------------------------------------------------------------- helpers


@pytest.fixture(scope="module")
def level_maps():
    """One level's blurred image, its gradient and orientation channels, and
    keypoints inside it (some near the border, so the clamp engages)."""
    rng = np.random.default_rng(0)
    H, W, K = 48, 64, 60
    img = rng.random((H, W)).astype(np.float32)
    blurred = np.array(jsift._blur(jnp.asarray(img), jsift._gaussian_kernel1d(2.0)))
    gy, gx = (np.array(g) for g in jnp.gradient(jnp.asarray(blurred)))
    yx = np.concatenate([rng.uniform([4, 4], [H - 4, W - 4], (K - 4, 2)),
                         [[0.2, 0.3], [H - 1.0, W - 1.0], [H - 1.5, 2.0], [3.0, W - 1.2]]]).astype(np.float32)
    sigma = rng.uniform(1.0, 3.0, K).astype(np.float32)
    return dict(H=H, W=W, K=K, img=img, blurred=blurred, gy=gy, gx=gx, yx=yx, sigma=sigma)


def _routing(m):
    """The JAX helpers' single-level routing and the port's."""
    K, H, W = m["K"], m["H"], m["W"]
    hk = np.full((K, 1), H, np.float32)
    wk = np.full((K, 1), W, np.float32)
    jax_r = (jnp.zeros((K, 1), jnp.int32), W, jnp.asarray(hk), jnp.asarray(wk))
    port_r = (torch.zeros(1, K, 1, dtype=torch.long), torch.full((1, K, 1), W, dtype=torch.long),
              torch.as_tensor(hk)[None], torch.as_tensor(wk)[None])
    return jax_r, port_r


@pytest.mark.parametrize("sigma", [0.7, 2.0, 3.8])
def test_blur_and_channel_blur(level_maps, sigma):
    img = level_maps["img"]
    k = jsift._gaussian_kernel1d(sigma)
    want = np.asarray(jax.jit(functools.partial(jsift._blur, kernel=k))(jnp.asarray(img)))
    got = sift._blur(torch.as_tensor(img)[None], k)[0].numpy()
    np.testing.assert_allclose(got, want, atol=HELPER_ATOL)
    ch = np.stack([img, img[::-1]], -1)
    want_ch = np.asarray(jax.jit(functools.partial(jsift._blur_channels, sigma_px=sigma))(jnp.asarray(ch)))
    got_ch = sift._blur_channels(torch.as_tensor(ch).permute(2, 0, 1)[None], sigma)[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got_ch, want_ch, atol=HELPER_ATOL)


def test_gradient_and_orientation_channels(level_maps):
    m = level_maps
    gy_p, gx_p = torch.gradient(torch.as_tensor(m["blurred"])[None], dim=(1, 2))
    np.testing.assert_array_equal(gy_p[0].numpy(), m["gy"])
    np.testing.assert_array_equal(gx_p[0].numpy(), m["gx"])
    want = np.asarray(jax.jit(jsift._orientation_channels)(jnp.asarray(m["gy"]), jnp.asarray(m["gx"])))
    got = sift._orientation_channels(torch.as_tensor(m["gy"])[None], torch.as_tensor(m["gx"])[None])
    np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(), want, atol=HELPER_ATOL)


def test_orientation_and_descriptor(level_maps):
    m = level_maps
    (j_off, j_ws, j_hk, j_wk), (p_off, p_ws, p_hk, p_wk) = _routing(m)
    g2 = np.stack([m["gy"], m["gx"]], -1).reshape(-1, 2)
    theta_j = np.asarray(jax.jit(jsift._orientation, static_argnums=2)(
        jnp.asarray(g2), j_off, j_ws, j_hk, j_wk, jnp.asarray(m["yx"]), jnp.asarray(m["sigma"])))
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a))[None]  # noqa: E731
    theta_p = sift._orientation(T(g2.T), p_off, p_ws, p_hk, p_wk, T(m["yx"]), T(m["sigma"]))[0].numpy()
    np.testing.assert_allclose(theta_p, theta_j, atol=HELPER_ATOL)

    ch = np.asarray(jsift._orientation_channels(jnp.asarray(m["gy"]), jnp.asarray(m["gx"]))).reshape(-1, 8)
    desc_j = np.asarray(jax.jit(jsift._descriptor, static_argnums=2)(
        jnp.asarray(ch), j_off, j_ws, j_hk, j_wk, jnp.asarray(m["yx"]), jnp.asarray(m["sigma"]),
        jnp.asarray(theta_j)))
    desc_p = sift._descriptor(T(ch.T), p_off, p_ws, p_hk, p_wk, T(m["yx"]), T(m["sigma"]), T(theta_j))[0].numpy()
    np.testing.assert_allclose(desc_p, desc_j, atol=HELPER_ATOL)


def test_detect_level(level_maps):
    """Extrema, edge test (wrapping rolls), border, top-k order and the
    subpixel step on one level of a DoG stack."""
    img = _texture()
    stack = np.stack([gaussian_filter(img, s) for s in (1.0, 1.3, 1.6, 2.0, 2.5)])
    dog = (stack[1:] - stack[:-1]).astype(np.float32)
    fn = jax.jit(jsift._detect_level, static_argnums=(1, 2, 3, 4))
    want = [np.asarray(a) for a in fn(jnp.asarray(dog), 2, 64, 0.001, 10.0)]
    got = [t[0].numpy() for t in sift._detect_level(torch.as_tensor(dog)[None], 2, 64, 0.001, 10.0)]
    np.testing.assert_array_equal(got[2], want[2])  # ok
    assert want[2].sum() > 10
    np.testing.assert_array_equal(got[1], want[1])  # response, in the same order
    ok = want[2]
    np.testing.assert_allclose(got[0][ok], want[0][ok], atol=HELPER_ATOL)
    np.testing.assert_allclose(got[3][ok], want[3][ok], atol=HELPER_ATOL)


def test_linspace_matches_jnp():
    for n in (5, 11, 21):
        np.testing.assert_array_equal(sift._linspace(-1.0, 1.0, n, "cpu").numpy(),
                                      np.asarray(jnp.linspace(-1.0, 1.0, n)))
