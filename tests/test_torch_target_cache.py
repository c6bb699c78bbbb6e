"""The port's GT-geometry caches (data/target_cache.TargetH2OCache and
GTGeomCache) against the JAX package's on the CPU, on the same synthetic
segments, and the launchers that use them.

Tolerances:
- target_h2o: rtol 1e-5 / atol 2e-6 (the h2o module bound; the JAX CPU
  route expands ||x-y||^2, the port takes direct differences);
- gt_h2o and |gt_o2h|: rtol 1e-5 / atol 2e-6 on the real object rows; the
  sign of gt_o2h comes from the nearest hand vertex's normal, and on
  near-ties the two formulations may pick different vertices: at most 0.1%
  of the signs may differ (PR 2's bound for the signed pair);
- cached against inline values in the port: equal (the same computation).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from oakink2_tamf_tpu.core import mano as JM
from oakink2_tamf_tpu.data import target_cache as JTC
from oakink2_tamf_tpu.data.collate import SegmentCollate as JCollate
from oakink2_tamf_tpu.models.refine_r import stack_mano_models as j_stack_mano_models
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.data import target_cache as TC
from oakink2_tamf_tpu_torch.data.collate import SegmentCollate
from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments
from oakink2_tamf_tpu_torch.launch import common, train_g
from oakink2_tamf_tpu_torch.models import losses as LL
from oakink2_tamf_tpu_torch.models.refine_r import stack_mano_models, target_geometry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, NOBJ, P = 20, 2, 64
MAX_SIGN_MISMATCH = 1e-3


def _setup(size=5, seed=0):
    base = SyntheticSegments(size, seq_len=L, max_nobj=NOBJ, n_obj_points=P, seed=seed)
    mano = stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    return base, mano, SegmentCollate(max_nobj=NOBJ, n_obj_points=P)


def _jax_cache(cls, base):
    jmano = j_stack_mano_models(JM.synthetic_mano_model("right"), JM.synthetic_mano_model("left"))
    return cls(base, jmano, JCollate(max_nobj=NOBJ, n_obj_points=P), chunk=64, batch_size=4)


def test_target_h2o_cache_matches_jax():
    base, mano, collate = _setup()
    cache = TC.TargetH2OCache(base, mano, collate, batch_size=2)
    assert cache.precompute() == 5
    assert cache.precompute() == 0  # idempotent
    jcache = _jax_cache(JTC.TargetH2OCache, base)
    jcache.precompute()
    for i in range(5):
        got, want = cache[i]["target_h2o"], jcache[i]["target_h2o"]
        assert got.shape == (L, 778) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


def test_target_h2o_cache_feeds_target_geometry():
    """target_geometry on a batch carrying the cached value equals the
    in-step chamfer (every frame searched)."""
    base, mano, collate = _setup()
    cache = TC.TargetH2OCache(base, mano, collate)
    batch = common.device_batch(collate([cache[i] for i in range(4)]), torch.device("cpu"))
    assert batch["target_h2o"].shape == (4, L, 778)
    cached = target_geometry(mano, batch)
    inline = target_geometry(mano, {k: v for k, v in batch.items() if k != "target_h2o"})
    assert torch.equal(cached["target_h2o_dist"], inline["target_h2o_dist"])


def test_target_h2o_cache_dir_and_fingerprint(tmp_path):
    base, mano, collate = _setup()
    d = str(tmp_path / "t")
    disk = TC.TargetH2OCache(base, mano, collate, cache_dir=d)
    s = disk[2]  # cold miss: computed and stored
    assert disk._has(2) and not disk._has(0)
    assert os.path.isfile(os.path.join(d, "meta.json"))
    mem = TC.TargetH2OCache(base, mano, collate)
    np.testing.assert_array_equal(s["target_h2o"], mem[2]["target_h2o"])
    # the same dataset reopens the dir; another dataset or padding is refused
    again = TC.TargetH2OCache(base, mano, collate, cache_dir=d)
    np.testing.assert_array_equal(again[2]["target_h2o"], s["target_h2o"])
    assert again.precompute() == 4
    with pytest.raises(ValueError, match="different"):
        TC.TargetH2OCache(SyntheticSegments(5, seq_len=L, max_nobj=NOBJ, n_obj_points=P, seed=1),
                          mano, collate, cache_dir=d)
    with pytest.raises(ValueError, match="different"):
        TC.TargetH2OCache(base, mano, SegmentCollate(max_nobj=NOBJ, n_obj_points=2 * P), cache_dir=d)


def test_gt_geom_cache_matches_jax():
    base, mano, collate = _setup(size=4)
    cache = TC.GTGeomCache(base, mano, collate, batch_size=3)
    assert cache.precompute() == 4
    jcache = _jax_cache(JTC.GTGeomCache, base)
    jcache.precompute()
    signs = mismatched = 0
    for i in range(4):
        got, want = cache[i], jcache[i]
        n = base[i]["obj_num"]
        assert got["gt_o2h"].shape == (NOBJ, L, P) and got["gt_h2o"].shape == (NOBJ, L, 778)
        np.testing.assert_allclose(got["gt_h2o"][:n], want["gt_h2o"][:n], rtol=1e-5, atol=2e-6)
        go, wo = got["gt_o2h"][:n], want["gt_o2h"][:n]
        np.testing.assert_allclose(np.abs(go), np.abs(wo), rtol=1e-5, atol=2e-6)
        signs += go.size
        mismatched += int((np.sign(go) != np.sign(wo)).sum())
        assert np.all(got["gt_o2h"][n:] == 0) and np.all(got["gt_h2o"][n:] == 0)  # padded back
    assert mismatched <= MAX_SIGN_MISMATCH * signs, mismatched


def test_gt_geom_cache_feeds_the_extra_loss(tmp_path):
    """extra_loss_gt_geometry takes the cached fields as they are, and the
    disk mode stores the real object rows only."""
    base, mano, collate = _setup(size=4)
    cache = TC.GTGeomCache(base, mano, collate, cache_dir=str(tmp_path / "g"))
    cache.precompute()
    with np.load(cache._path(0)) as z:
        assert z["o2h"].shape[0] == base[0]["obj_num"]
    batch = common.device_batch(collate([cache[i] for i in range(4)]), torch.device("cpu"))
    cached = LL.extra_loss_gt_geometry(mano, batch)
    inline = LL.extra_loss_gt_geometry(mano, {k: v for k, v in batch.items() if k not in ("gt_o2h", "gt_h2o")})
    for b in range(4):
        n = base[b]["obj_num"]
        for k in ("o2h_g", "h2o_g"):
            assert torch.equal(cached[k][b, :n], inline[k][b, :n]), k


def test_train_g_main_with_gt_geom_cache(tmp_path, monkeypatch):
    """train_g with train.data.cache_gt_geom: the cache is precomputed and
    the run takes its steps with finite weights."""
    monkeypatch.chdir(tmp_path)
    argv = ["--cfg", os.path.join(REPO, "config/synthetic_smoke.yml"), "--runtime.device", "cpu",
            "--train.data.cache_gt_geom", "true", "--train.data.gt_geom_cache_dir", str(tmp_path / "gg")]
    state = train_g.main(argv)
    assert state.step == 4
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert len([f for f in os.listdir(tmp_path / "gg") if f.endswith(".npz")]) == 16
