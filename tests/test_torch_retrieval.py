"""Port parity: retrieval (NetVLAD, the similarity retriever, the rig window
and the three retrieval regimes of SceneOptimizer.generate_pairs) in
gtsfm_tpu_torch against the JAX package.

NetVLAD runs at full width (VGG16 to conv5_3, 64 clusters, 4096-d output) on
64 x 96 images. Tolerances: descriptors within 1e-5 absolute plus 1e-4
relative (float32 through 13 convolutions and the 32768 x 4096 whitening,
sums in different orders; the outputs are unit vectors of 4096 components of
about 0.016); the committed golden at the golden test's own tolerance (atol
2e-3, rtol 1e-3). Pair lists are compared as sets, identical; the
similarity test puts exact ties at the top-K boundary, where both packages
keep the lowest index.
"""

import gc
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend.deep import netvlad as jax_netvlad
from gtsfm_tpu.loader.synthetic import SyntheticAerialLoader as JaxLoader
from gtsfm_tpu.pipeline.config import PipelineConfig as JaxConfig
from gtsfm_tpu.pipeline.scene_optimizer import SceneOptimizer as JaxOptimizer
from gtsfm_tpu.retriever import basic as jax_basic
from gtsfm_tpu.retriever import similarity as jax_similarity
from gtsfm_tpu_torch.frontend.deep import netvlad
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer
from gtsfm_tpu_torch.retriever import basic, similarity

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "frontend"))
import golden_utils  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="function")
def _release_jax_executables():
    """XLA:CPU keeps the JIT code of every compiled program mapped for the
    life of the process; the test workers run many files each, so the
    programs this test compiled are dropped when it ends."""
    yield
    jax.clear_caches()
    gc.collect()


H, W = 64, 96


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("netvlad") / "netvlad.mat")
    golden_utils.build_netvlad(path)
    return path


def test_params_from_jax_parity(rng):
    jm = jax_netvlad.NetVLAD().init_random(h=H, w=W, seed=0)
    port = netvlad.NetVLAD(params=netvlad.params_from_jax(jm.params), device="cpu")
    imgs = rng.random((2, H, W, 3)).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(imgs)))
    got = port(imgs).numpy()
    assert got.shape == (2, netvlad.OUT_DIM)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_converter_matches_jax_and_golden(checkpoint):
    """The port reads the matconvnet layout itself, lands on the JAX
    converter's weights, and reproduces the committed golden
    (tests/data/goldens/netvlad.npz)."""
    port = netvlad.NetVLAD(checkpoint_path=checkpoint, device="cpu")
    via_jax = netvlad.params_from_jax(jax_netvlad.convert_matconvnet_checkpoint(checkpoint))
    assert set(via_jax) == set(port.params)
    for key, val in via_jax.items():
        np.testing.assert_array_equal(port.params[key].numpy(), val.numpy(), err_msg=key)
    imgs = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    golden = np.load(os.path.join(os.path.dirname(__file__), "data", "goldens", "netvlad.npz"))
    np.testing.assert_allclose(port(imgs).numpy()[:, ::64], golden["descriptor_slice"], atol=2e-3, rtol=1e-3)


def test_similarity_retrieval_parity(rng):
    """Top-K retrieval (blocked, on the device), the dense matrix route,
    the window union and the joint regime, identical to JAX; descriptor 7
    duplicates descriptor 3, so queries see exact ties."""
    d = rng.standard_normal((40, 32)).astype(np.float32)
    d[:, :4] += 3.0  # most similarities above min_score
    d[7] = d[3]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for num_matched, min_score, block in ((5, 0.1, 1024), (3, 0.5, 16), (60, 0.0, 7)):
        want = jax_similarity.retrieve_pairs_topk(jnp.asarray(d), num_matched, min_score, block=block)
        got = similarity.retrieve_pairs_topk(torch.from_numpy(d), num_matched, min_score, block=block)
        assert got == want and len(got) > 0
    sim = similarity.similarity_matrix(torch.from_numpy(d), block=16)
    np.testing.assert_allclose(sim, jax_similarity.similarity_matrix(jnp.asarray(d), block=16), atol=1e-6)
    assert similarity.retrieve_pairs(sim, 5, 0.1) == jax_similarity.retrieve_pairs(sim, 5, 0.1)
    pairs = similarity.retrieve_pairs(sim, 2, 0.3)
    assert similarity.union_with_window(pairs, 40, 3) == jax_similarity.union_with_window(pairs, 40, 3)
    assert (similarity.joint_sequential_retrieval_pairs(sim, 4, 3, 0.2)
            == jax_similarity.joint_sequential_retrieval_pairs(sim, 4, 3, 0.2))


@pytest.mark.parametrize("n, lookahead", [(23, 2), (10, 1), (5, 3), (3, 2)])
def test_sequential_hilti_pairs_parity(n, lookahead):
    assert basic.sequential_hilti_pairs(n, lookahead) == jax_basic.sequential_hilti_pairs(n, lookahead)
    assert [r.value for r in basic.ImageMatchingRegime] == [r.value for r in jax_basic.ImageMatchingRegime]


@pytest.mark.parametrize("regime", ["retrieval", "sequential_with_retrieval", "sequential_hilti"])
def test_generate_pairs_parity(regime, checkpoint, tmp_path):
    """Both packages' SceneOptimizer.generate_pairs on 8 synthetic images
    with one NetVLAD checkpoint: the same pairs."""
    loader_kw = dict(num_images=8, height=96, width=128, rows=2)
    out = {}
    for name, cfg, make in (("jax", JaxConfig(compile_cache=False), lambda c: JaxOptimizer(c)),
                            ("port", PipelineConfig(), lambda c: SceneOptimizer(c, device="cpu"))):
        cfg.cache_dir = str(tmp_path / name)
        cfg.retriever.regime = regime
        cfg.retriever.netvlad_checkpoint = checkpoint
        cfg.retriever.max_frame_lookahead = 2
        cfg.retriever.num_matched = 3
        loader = (JaxLoader if name == "jax" else SyntheticAerialLoader)(**loader_kw)
        loader.is_valid_pair = lambda i, j: True  # keep every retrieved pair
        out[name] = make(cfg).generate_pairs(loader)
    assert out["port"] == out["jax"] and len(out["port"]) > 0
