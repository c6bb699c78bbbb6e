"""The whole serving slice: a small JAX TamfPipeline and the port's
TamfPipeline with the same weights (G, R and CLIP through interop/from_jax)
and the same noise (the test replays the JAX chain's key splitting) must
give the same refined poses, verts and joints.

Tolerance: atol 1e-4. float32 matmul/reduction order differs between XLA and
PyTorch on the CPU; the difference passes through every step of the reverse
chain, R's h2o feature and MANO."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oakink2_tamf_tpu.launch.common import SyntheticSegments
from oakink2_tamf_tpu.models.mdm_g import MDMConfig as JMDMConfig
from oakink2_tamf_tpu.models.refine_r import RefineConfig as JRefineConfig
from oakink2_tamf_tpu.serving import TamfPipeline as JTamfPipeline
from oakink2_tamf_tpu_torch.interop import from_jax
from oakink2_tamf_tpu_torch.models.mdm_g import MDMConfig
from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig
from oakink2_tamf_tpu_torch.serving import TamfPipeline

ATOL = 1e-4
SMALL = dict(latent_dim=32, ff_size=64, num_layers=1, num_heads=2, dropout=0.0)
SHAPES = dict(batch_size=2, seq_len=16, max_nobj=2, n_obj_points=64)
STEPS = 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pipes():
    jp = JTamfPipeline.load(
        g_config=JMDMConfig(**SMALL), r_config=JRefineConfig(**SMALL),
        diffusion_steps=STEPS, **SHAPES,
    )
    tp = TamfPipeline.load(
        g_config=MDMConfig(**SMALL), r_config=RefineConfig(**SMALL),
        diffusion_steps=STEPS, device="cpu", **SHAPES,
    )
    tp.g_model.load_state_dict(from_jax.g_state_dict_from_flax(_np_tree(jp.g_params)))
    tp.refine_net.load_state_dict(from_jax.r_state_dict_from_flax(_np_tree(jp.r_params)))
    tp.clip.model.load_state_dict(from_jax.clip_state_dict_from_flax(_np_tree(jp.clip.variables)))
    return jp, tp


def _jax_noise(key, n_chunks, shape):
    """The noise JAX's generate draws: per chunk `key, k = split(key)`, then
    p_sample_loop's `k, k_init = split(k)` and `split(k, T)`."""
    out = []
    for _ in range(n_chunks):
        key, k = jax.random.split(key)
        k, k_init = jax.random.split(k)
        x_t = np.asarray(jax.random.normal(k_init, shape, jnp.float32))
        steps = np.stack([np.asarray(jax.random.normal(kk, shape, jnp.float32))
                          for kk in jax.random.split(k, STEPS)])
        out.append({"noise": torch.from_numpy(x_t.copy()), "step_noise": torch.from_numpy(steps)})
    return out


def test_pipeline_matches_jax(pipes):
    jp, tp = pipes
    segments = [SyntheticSegments(3, seq_len=16, max_nobj=2, n_obj_points=64)[i] for i in range(3)]
    key = jax.random.PRNGKey(7)
    want = jp.generate(segments, key=key)
    got = tp.generate(segments, noise=_jax_noise(key, 2, (2, 16, 99)))
    assert len(got) == len(want) == 3  # 1.5 batches: the last one is padded
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("g_sample_pose_repr", "refine_pose_repr", "verts", "joints"):
            assert g[k].shape == w[k].shape
            np.testing.assert_allclose(g[k], w[k], atol=ATOL, err_msg=k)


def test_pipeline_generator_is_deterministic(pipes):
    _, tp = pipes
    segs = [SyntheticSegments(2, seq_len=16, max_nobj=2, n_obj_points=64)[i] for i in range(2)]
    r1 = tp.generate(segs, generator=torch.Generator().manual_seed(3))
    r2 = tp.generate(segs, generator=torch.Generator().manual_seed(3))
    for a, b in zip(r1, r2):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert np.isfinite(a["verts"]).all()


def test_pipeline_loads_reference_layout_checkpoints(pipes, tmp_path):
    """g_ckpt / r_ckpt are torch state_dicts in the reference key layout;
    extra keys (the reference's clip_model.*) are ignored, missing ones raise."""
    _, tp = pipes
    g_sd = dict(tp.g_model.state_dict(), **{"clip_model.dummy": torch.zeros(1)})
    torch.save(g_sd, tmp_path / "g.pt")
    torch.save(tp.refine_net.state_dict(), tmp_path / "r.pt")
    loaded = TamfPipeline.load(
        str(tmp_path / "g.pt"), str(tmp_path / "r.pt"),
        g_config=MDMConfig(**SMALL), r_config=RefineConfig(**SMALL),
        diffusion_steps=STEPS, device="cpu", seed=9, **SHAPES,
    )
    for a, b in ((loaded.g_model, tp.g_model), (loaded.refine_net, tp.refine_net)):
        for k, v in b.state_dict().items():
            assert torch.equal(a.state_dict()[k], v), k
    torch.save({k: v for k, v in g_sd.items() if "linear1" not in k}, tmp_path / "bad.pt")
    with pytest.raises(KeyError, match="lacks"):
        TamfPipeline.load(str(tmp_path / "bad.pt"), g_config=MDMConfig(**SMALL),
                          r_config=RefineConfig(**SMALL), diffusion_steps=STEPS,
                          device="cpu", **SHAPES)
