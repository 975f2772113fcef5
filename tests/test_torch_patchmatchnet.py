"""Port parity for PatchmatchNet (gtsfm_tpu_torch/densify/patchmatchnet.py)
against the JAX package's Flax model, on the CPU.

Every module runs the JAX package's Flax params carried across by
params_from_jax (flax_to_state_dict for submodules), with the offset
convolutions (zero at Flax init) set to non-zero values so the deformable
gathers move, and stage 3's random planes from JAX's own draw
(jax.random.uniform(PRNGKey(0), (48, H, W)), passed as init_uniform).

Tolerances, as each test states: the samplers, warping, deformable
positions, depth weights, FeatureNet (SAME padding (1, 2) at stride 2),
the x2 bilinear upsampling, the transposed convolution and each
PatchMatchStage within 1e-5 (absolute, or relative for depths); the whole
model at 64 x 96 with S = 3: depth within 1e-4 relative and confidence
within 1e-4 on >= 99% of pixels; load_torch_checkpoint against the JAX
converter on one synthetic official-layout checkpoint: state dicts within
1e-6, model outputs as for the whole model; densify_patchmatchnet from
that checkpoint in both packages: point counts within 1%, >= 99% of
points paired within 1e-4 of the extent.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.spatial import cKDTree

from gtsfm_tpu.densify import patchmatchnet as jp
from gtsfm_tpu.densify import plane_sweep as jax_ps
from gtsfm_tpu_torch.densify import patchmatchnet as pmn
from gtsfm_tpu_torch.densify import plane_sweep as ps
from gtsfm_tpu_torch.frontend.deep.weights import flax_to_state_dict
from tests.test_torch_densify import make_plane_scene
from tests.test_torch_fisheye import _to_port

torch.set_num_threads(2)

H, W, S = 64, 96, 3
# Flax settings of each stage (gtsfm_tpu/densify/patchmatchnet.py:484-491).
JAX_STAGES = {
    3: dict(G=8, num_sample=16, interval_scale=0.025, iterations=2, propagate_neighbors=16, dilation=2,
            random_init=True),
    2: dict(G=8, num_sample=8, interval_scale=0.0125, iterations=2, propagate_neighbors=8, dilation=4),
    1: dict(G=4, num_sample=8, interval_scale=0.005, iterations=1, propagate_neighbors=0, dilation=6),
}


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps the JIT code of every compiled program mapped for the
    life of the process; the programs this file compiled are dropped when
    it ends."""
    yield
    jax.clear_caches()
    gc.collect()


def T(a):
    return torch.as_tensor(np.array(a))


def _nonzero_offsets(params, rng):
    """Flax params (numpy) with random offset-conv kernels and biases."""
    params = jax.tree_util.tree_map(np.array, params)
    for stage in params.values():
        for name in ("propa_conv", "eval_conv"):
            if isinstance(stage, dict) and name in stage:
                stage[name]["kernel"] = (rng.normal(size=stage[name]["kernel"].shape) * 0.05).astype(np.float32)
                stage[name]["bias"] = (rng.normal(size=stage[name]["bias"].shape) * 0.5).astype(np.float32)
    return params


def _camera_inputs(rng, h, w, s=S, f=80.0):
    K = np.asarray([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    ang = rng.normal(size=(s, 3)) * 0.02
    sRr = np.stack([_rot(a) for a in ang]).astype(np.float32)
    str_ = (rng.normal(size=(s, 3)) * 0.1).astype(np.float32)
    return K, np.tile(K[None], (s, 1, 1)), sRr, str_


def _rot(a):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(a).as_matrix()


@pytest.fixture(scope="module")
def model():
    """The JAX package's model, its params with non-zero offsets, the port's
    model carrying them, inputs at 64 x 96 with S = 3, and JAX's outputs."""
    rng = np.random.default_rng(0)
    ref = rng.random((H, W, 3)).astype(np.float32)
    srcs = rng.random((S, H, W, 3)).astype(np.float32)
    K, Ks, sRr, str_ = _camera_inputs(rng, H, W)
    args = (ref, srcs, K, Ks, sRr, str_, np.float32(2.0), np.float32(10.0))
    net = jp.PatchmatchNet()
    params = jax.jit(net.init)(jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"]
    assert np.abs(np.asarray(params["patchmatch_3"]["propa_conv"]["kernel"])).max() == 0
    params = _nonzero_offsets(params, rng)
    depth, conf = jax.jit(lambda p, *a: net.apply({"params": p}, *a))(params, *map(jnp.asarray, args))
    port = pmn.PatchmatchNet()
    port.load_state_dict(pmn.params_from_jax(params))
    return dict(params=params, args=args, depth=np.asarray(depth), conf=np.asarray(conf), port=port.eval(),
                uniform=np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (48, H // 8, W // 8))))


def _run_port(port, args, uniform):
    ref, srcs, K, Ks, sRr, str_, d_min, d_max = args
    with torch.no_grad():
        d, c = port(T(ref).permute(2, 0, 1), T(srcs).permute(0, 3, 1, 2), T(K), T(Ks), T(sRr), T(str_), T(d_min),
                    T(d_max), init_uniform=T(uniform))
    return d.numpy(), c.numpy()


def _assert_model_close(depth, conf, jdepth, jconf):
    assert depth.shape == jdepth.shape and np.all(np.isfinite(depth))
    assert np.mean(np.abs(depth - jdepth) <= 1e-4 * np.abs(jdepth)) >= 0.99
    assert np.mean(np.abs(conf - jconf) <= 1e-4) >= 0.99


# ------------------------------------------------------------- samplers


def test_samplers_and_warp_match(rng):
    """bilinear_sample_nhwc (zero padding), _sample_border (upstream's
    border grid_sample quirk) at positions inside and outside the image,
    and warp_src_feature under a general pose: within 1e-5."""
    h, w, c = 13, 17, 5
    img = rng.random((h, w, c)).astype(np.float32)
    u = rng.uniform(-2, w + 1, size=(7, 9)).astype(np.float32)
    v = rng.uniform(-2, h + 1, size=(7, 9)).astype(np.float32)
    np.testing.assert_allclose(pmn.bilinear_sample_nhwc(T(img), T(u), T(v)).numpy(),
                               np.asarray(jp.bilinear_sample_nhwc(*map(jnp.asarray, (img, u, v)))), atol=1e-5)
    np.testing.assert_allclose(pmn._sample_border(T(img), T(u), T(v)).numpy(),
                               np.asarray(jp._sample_border(*map(jnp.asarray, (img, u, v)))), atol=1e-5)
    feat = rng.random((16, 24, 4)).astype(np.float32)
    K, _, sRr, str_ = _camera_inputs(rng, 16, 24, s=1, f=20.0)
    depths = rng.uniform(3, 8, size=(5, 16, 24)).astype(np.float32)
    np.testing.assert_allclose(pmn.warp_src_feature(T(feat), T(K), T(K), T(sRr[0]), T(str_[0]), T(depths)).numpy(),
                               np.asarray(jp.warp_src_feature(*map(jnp.asarray, (feat, K, K, sRr[0], str_[0], depths)))), atol=1e-5)


def test_deform_positions_and_depth_weight_match(rng):
    """Deformable positions (channel 2k = x, 2k + 1 = y, channels-first in
    the port) for both offset tables, and _depth_weight: within 1e-5."""
    h, w = 10, 12
    for base in (pmn._prop_base_offsets(16, 2), pmn._eval_base_offsets(9, 4)):
        assert base == (jp._prop_base_offsets(16, 2) if len(base) == 16 else jp._eval_base_offsets(9, 4))
        learned = rng.normal(size=(h, w, 2 * len(base))).astype(np.float32)
        pos = pmn._deform_positions(base, T(learned).permute(2, 0, 1), h, w)
        np.testing.assert_allclose(pos.numpy(), np.asarray(jp._deform_positions(base, jnp.asarray(learned), h, w)), atol=1e-5)
    samples = rng.uniform(2.0, 10.0, size=(6, h, w)).astype(np.float32)
    ours = pmn._depth_weight(T(samples), T(np.float32(0.1)), T(np.float32(0.5)), pos, 0.025)
    ref = jp._depth_weight(jnp.asarray(samples), np.float32(0.1), np.float32(0.5), jnp.asarray(pos.numpy()), 0.025)
    assert ours.shape == (6, 9, h, w)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


# ------------------------------------------------------------- convolutions


def test_feature_net_same_padding_matches(model):
    """FeatureNet with the stride-2 5x5 convolutions padded (1, 2): every
    stage's features within 1e-5 of Flax's; with symmetric padding 2 (as
    nn.Conv2d(padding=2) would) they are off by far more."""
    ref = model["args"][0]
    jout = jp.FeatureNet().apply({"params": model["params"]["feature"]}, jnp.asarray(ref)[None])
    with torch.no_grad():
        pout = model["port"].feature(T(ref).permute(2, 0, 1)[None])
    for k in ("stage_3", "stage_2", "stage_1"):
        np.testing.assert_allclose(pout[k][0].permute(1, 2, 0).numpy(), np.asarray(jout[k][0]), atol=1e-5)
    assert pmn._same_pad(64, 5, 2, 1) == (1, 2) and pmn._same_pad(63, 5, 2, 1) == (2, 2)
    conv2 = model["port"].feature.conv2.conv
    x = torch.as_tensor(np.random.default_rng(1).random((1, 8, 64, 96)), dtype=torch.float32)
    sym = F.conv2d(x, conv2.weight, conv2.bias, stride=2, padding=2)
    assert (sym - conv2(x)).abs().max() > 1e-2


def test_upsampling_and_transposed_conv_match(rng):
    """up2_bilinear against jax.image.resize(..., "bilinear") at x2; the
    Refinement deconv (TransposeConvBnReLU) against Flax's lhs-dilated
    convolution, with the kernel carried by params_from_jax's rule."""
    for h, w in ((8, 12), (5, 7), (1, 3)):
        x = rng.random((2, 3, h, w)).astype(np.float32)
        ref = jax.image.resize(jnp.asarray(x).transpose(0, 2, 3, 1), (2, 2 * h, 2 * w, 3), "bilinear")
        np.testing.assert_allclose(pmn.up2_bilinear(T(x)).permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5)
    x = rng.random((9, 11, 4)).astype(np.float32)
    jmod = jp.TransposeConvBnReLU(5)
    params = jax.tree_util.tree_map(np.array, jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    params["bias"] = rng.normal(size=5).astype(np.float32)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    sd = flax_to_state_dict({"deconv": params})
    port = pmn.TransposeConvBnReLU(4, 5)
    port.load_state_dict({"weight": torch.flip(sd["deconv.weight"].permute(1, 0, 2, 3), (2, 3)),
                          "bias": sd["deconv.bias"]})
    with torch.no_grad():
        out = port(T(x).permute(2, 0, 1)[None])[0].permute(1, 2, 0).numpy()
    assert out.shape == (18, 22, 5)
    np.testing.assert_allclose(out, ref, atol=1e-5)


# ------------------------------------------------------------- stages


@pytest.mark.parametrize("stage", [3, 2, 1])
def test_patchmatch_stage_matches(stage):
    """One PatchMatchStage on random features at the stage's scale of a 64 x
    96 image (stage 3 from scratch with JAX's uniform draw; stages 2 and 1
    from a given depth and view weights): depth within 1e-5 relative,
    probabilities and view weights within 1e-5."""
    rng = np.random.default_rng(10 + stage)
    ch = pmn.STAGES[stage][0]
    h, w = H >> stage, W >> stage
    rf = rng.normal(size=(h, w, ch)).astype(np.float32)
    sf = rng.normal(size=(S, h, w, ch)).astype(np.float32)
    K, Ks, sRr, str_ = _camera_inputs(rng, h, w, f=80.0 * 0.5**stage)
    inv_min, inv_max = np.float32(1 / 10.0), np.float32(1 / 2.0)
    depth = None if stage == 3 else rng.uniform(3.0, 8.0, size=(h, w)).astype(np.float32)
    vw = None if stage == 3 else rng.uniform(0.2, 1.0, size=(S, h, w, 1)).astype(np.float32)
    jmod = jp.PatchMatchStage(stage=stage, **JAX_STAGES[stage])
    jargs = tuple(None if a is None else jnp.asarray(a) for a in (rf, sf, K, Ks, sRr, str_, inv_min, inv_max, depth, vw))
    params = _nonzero_offsets({"s": jax.jit(jmod.init)(jax.random.PRNGKey(2), *jargs)["params"]}, rng)["s"]
    jd, js, jvw = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a))(params, *jargs)
    port = pmn.PatchMatchStage(stage, *pmn.STAGES[stage])
    port.load_state_dict(flax_to_state_dict(params))
    uniform = T(jax.random.uniform(jax.random.PRNGKey(0), (48, h, w))) if stage == 3 else None
    with torch.no_grad():
        pd, pscore, pvw = port(T(rf).permute(2, 0, 1), T(sf).permute(0, 3, 1, 2), T(K), T(Ks), T(sRr), T(str_),
                               T(inv_min), T(inv_max), None if depth is None else T(depth),
                               None if vw is None else T(vw), init_uniform=uniform)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5)
    np.testing.assert_allclose(pscore.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(pvw.numpy(), np.asarray(jvw), atol=1e-5)


def test_whole_model_matches(model):
    """PatchmatchNet at 64 x 96, S = 3: depth within 1e-4 relative and
    confidence within 1e-4 on >= 99% of pixels."""
    depth, conf = _run_port(model["port"], model["args"], model["uniform"])
    _assert_model_close(depth, conf, model["depth"], model["conf"])


def test_seeded_weights_and_generator():
    """The port's seeded weights are reproducible, keep the offset
    convolutions at zero, and the generator's draw is used when no
    init_uniform is given (same seed, same output)."""
    a, b = pmn.init_random(pmn.PatchmatchNet()), pmn.init_random(pmn.PatchmatchNet())
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert a.patchmatch_3.propa_conv.weight.abs().max() == 0
    rng = np.random.default_rng(4)
    ref, srcs = T(rng.random((3, 32, 48)).astype(np.float32)), T(rng.random((2, 3, 32, 48)).astype(np.float32))
    K, Ks, sRr, str_ = map(T, _camera_inputs(rng, 32, 48, s=2))
    with torch.no_grad():
        d1, _ = a(ref, srcs, K, Ks, sRr, str_, T(np.float32(2.0)), T(np.float32(10.0)))
        d2, _ = a(ref, srcs, K, Ks, sRr, str_, T(np.float32(2.0)), T(np.float32(10.0)))
    assert torch.equal(d1, d2) and torch.isfinite(d1).all()


# ------------------------------------------------------------- checkpoints


def _official_checkpoint(path: str):
    """A synthetic checkpoint in the official PatchmatchNet layout (the
    JAX package's tests/densify/test_patchmatchnet.py builds the same)."""
    gen = torch.Generator().manual_seed(0)
    sd = {}

    def convw(prefix, o, i, k, bias=True, dims=2):
        sd[f"{prefix}.weight"] = torch.randn((o, i) + (k,) * dims, generator=gen) * 0.05
        if bias:
            sd[f"{prefix}.bias"] = torch.randn(o, generator=gen) * 0.01

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = torch.rand(c, generator=gen) + 0.5
        sd[f"{prefix}.bias"] = torch.randn(c, generator=gen) * 0.1
        sd[f"{prefix}.running_mean"] = torch.randn(c, generator=gen) * 0.1
        sd[f"{prefix}.running_var"] = torch.rand(c, generator=gen) + 0.5

    def cbr(prefix, o, i, k):
        convw(f"{prefix}.conv", o, i, k, bias=False)
        bn(f"{prefix}.bn", o)

    specs = [(8, 3, 3), (8, 8, 3), (16, 8, 5), (16, 16, 3), (16, 16, 3), (32, 16, 5), (32, 32, 3), (32, 32, 3),
             (64, 32, 5), (64, 64, 3), (64, 64, 3)]
    for idx, (o, i, k) in enumerate(specs):
        cbr(f"feature.conv{idx}", o, i, k)
    convw("feature.output1", 64, 64, 1, bias=False)
    convw("feature.inner1", 64, 32, 1)
    convw("feature.inner2", 64, 16, 1)
    convw("feature.output2", 32, 64, 1, bias=False)
    convw("feature.output3", 16, 64, 1, bias=False)

    def head3(prefix, G, last):
        convw(f"{prefix}.conv0.conv", 16, G, 1, bias=False, dims=3)
        bn(f"{prefix}.conv0.bn", 16)
        convw(f"{prefix}.conv1.conv", 8, 16, 1, bias=False, dims=3)
        bn(f"{prefix}.conv1.bn", 8)
        convw(f"{prefix}.{last}", 1, 8, 1, dims=3)

    for i, G, feat, pn in ((1, 4, 16, 0), (2, 8, 32, 8), (3, 8, 64, 16)):
        base = f"patchmatch_{i}"
        head3(f"{base}.evaluation.similarity_net", G, "similarity")
        head3(f"{base}.feature_weight_net", G, "similarity")
        if i == 3:
            head3(f"{base}.evaluation.pixel_wise_net", G, "conv2")
        convw(f"{base}.eval_conv", 2 * 9, feat, 3)
        if pn:
            convw(f"{base}.propa_conv", 2 * pn, feat, 3)
    cbr("upsample_net.conv0", 8, 3, 3)
    cbr("upsample_net.conv1", 8, 1, 3)
    cbr("upsample_net.conv2", 8, 8, 3)
    sd["upsample_net.deconv.weight"] = torch.randn(8, 8, 3, 3, generator=gen) * 0.05  # (I, O, kh, kw)
    bn("upsample_net.bn", 8)
    cbr("upsample_net.conv3", 8, 16, 3)
    convw("upsample_net.res", 1, 8, 3, bias=False)
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)


def test_load_torch_checkpoint_matches_jax_converter(model, tmp_path):
    """load_torch_checkpoint and the JAX package's convert_torch_checkpoint
    on one official-layout checkpoint: the state dicts within 1e-6, and the
    two models' outputs as in test_whole_model_matches."""
    path = str(tmp_path / "patchmatchnet.ckpt")
    _official_checkpoint(path)
    ours = pmn.load_torch_checkpoint(path)
    jparams = jp.convert_torch_checkpoint(path)
    carried = pmn.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(ours) == set(carried)
    for k in ours:
        np.testing.assert_allclose(ours[k].numpy(), carried[k].numpy(), atol=1e-6, err_msg=k)
    port = pmn.PatchmatchNet()
    port.load_state_dict(ours)
    args = model["args"]
    jd, jc = jax.jit(lambda p, *a: jp.PatchmatchNet().apply({"params": p}, *a))(jparams, *map(jnp.asarray, args))
    depth, conf = _run_port(port.eval(), args, model["uniform"])
    _assert_model_close(depth, conf, np.asarray(jd), np.asarray(jc))


# ------------------------------------------------------------- densify_patchmatchnet


def test_densify_patchmatchnet_matches(monkeypatch, tmp_path):
    """densify_patchmatchnet on the plane scene (3 cameras, 48 x 64, 2
    sources) in both packages from one official-layout checkpoint, with
    JAX's uniform draw; the confidence gate is set to 0 in both (these
    weights clear no 0.8), so fusion keeps every consistent pixel: counts
    within 1%, >= 99% of points paired within 1e-4 of the extent."""
    images, sc, _ = make_plane_scene(np.random.default_rng(0), n_cams=3, H=48, W=64)
    path = str(tmp_path / "patchmatchnet.ckpt")
    _official_checkpoint(path)
    monkeypatch.setattr(jax_ps, "MIN_CONFIDENCE", 0.0)
    monkeypatch.setattr(ps, "MIN_CONFIDENCE", 0.0)
    rj = jp.densify_patchmatchnet(images, sc, checkpoint_path=path, num_src_views=2)
    uniform = T(jax.random.uniform(jax.random.PRNGKey(0), (48, 6, 8)))
    rp = pmn.densify_patchmatchnet(images, _to_port(sc), checkpoint_path=path, num_src_views=2,
                                   init_uniform=uniform)
    n_j, n_p = rj.points.shape[0], rp.points.shape[0]
    assert n_j > 100 and abs(n_p - n_j) <= 0.01 * n_j
    assert list(rp.metrics) == list(rj.metrics) and rp.rgb.dtype == np.uint8
    tol = 1e-4 * np.linalg.norm(rj.points.max(0) - rj.points.min(0))
    for a, b in ((rp.points, rj.points), (rj.points, rp.points)):
        d, _ = cKDTree(b).query(a)
        assert np.mean(d <= tol) >= 0.99


def test_densify_patchmatchnet_requires_weights():
    images, sc, _ = make_plane_scene(np.random.default_rng(0), n_cams=3, H=48, W=64)
    with pytest.raises(ValueError, match="patchmatchnet"):
        pmn.densify_patchmatchnet(images, _to_port(sc), allow_random_weights=False)
