"""R training on the port's cluster route (train.h2o_backend=cluster)
against the JAX package on the CPU, at small sizes, on the same numpy
inputs and (via interop/from_jax.r_state_dict_from_flax) the same weights:
the train step, the multi-object h2o and its certificate, train_r's
val-epoch exactness probe, and the target-h2o cache's exact fallback.

Tolerances, float32 on both sides:
- one whole R train step on a certified batch (the probe reads 0): as
  tests/test_torch_r_train.py holds the exact routes (loss rtol 1e-5, each
  parameter's clipped gradient within 1e-4 of its norm plus 1e-7): with the
  certificate clear the cluster search finds the exact nearest points, and
  the JAX CPU step's route is its exact XLA scan;
- multi-object h2o against the JAX cluster kernel (Pallas interpret mode):
  rtol 1e-5 / atol 2e-6 (the h2o module bound; the TPU kernel expands
  ||x-y||^2, the port takes direct differences);
- overflow counts equal (the same selection formula on the same operands);
- the cache's values after its fallback equal the port's exact route bit
  for bit (certified rows search a superset of each nearest point's cell
  with the same per-pair function; overflowed rows are recomputed there).
"""

import logging
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from oakink2_tamf_tpu.core import mano as JM
from oakink2_tamf_tpu.data.synthetic import synthetic_batch, with_perturbed_sample
from oakink2_tamf_tpu.launch import train_r as JTR
from oakink2_tamf_tpu.models import losses as JLL
from oakink2_tamf_tpu.models import refine_r as JR
from oakink2_tamf_tpu.parallel import train as JPT
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.data import target_cache as TC
from oakink2_tamf_tpu_torch.data.collate import SegmentCollate
from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments
from oakink2_tamf_tpu_torch.interop import from_jax
from oakink2_tamf_tpu_torch.launch import train_r
from oakink2_tamf_tpu_torch.models import losses as LL
from oakink2_tamf_tpu_torch.models import refine_r as R
from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
from oakink2_tamf_tpu_torch.parallel import train as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(latent_dim=32, ff_size=64, num_layers=1, num_heads=4, dropout=0.0)
R_KEYS = ("pose_repr", "sample_pose_repr", "mask", "shape", "hand_side", "obj_traj",
          "obj_embedding", "obj_mask", "obj_points")
LOGGER = "oakink2_tamf_tpu_torch.launch.train_r"


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def manos():
    jst = JR.stack_mano_models(JM.synthetic_mano_model("right"), JM.synthetic_mano_model("left"))
    pst = R.stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    return jst, pst


def _batch(seed, bs=2, L=8, P=256, min_len=5):
    rng = np.random.default_rng(seed)
    b = synthetic_batch(rng, batch_size=bs, seq_len=L, max_nobj=2, n_obj_points=P, min_len=min_len, as_jax=False)
    b = with_perturbed_sample(b, rng)
    b["sample_pose_repr"] = np.asarray(b["sample_pose_repr"])
    return {k: b[k] for k in R_KEYS}


def test_r_train_step_cluster_route_matches_jax(manos):
    """One whole R train step, the port's cluster route on the CPU against
    the JAX package's make_r_train_step (its exact XLA route) on the same
    weights and batch, dropout 0, on a batch the certificate clears for
    every search of the step (sample, refined and target hands)."""
    jst, pst = manos
    b = _batch(4)
    cfg = R.RefineConfig(**SMALL)
    jnet = JR.SegmentRefineNet(JR.RefineConfig(**SMALL))
    cond = {k: b[k] for k in ("hand_side", "shape", "obj_embedding", "obj_traj", "obj_mask")}
    jparams = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0), b["sample_pose_repr"],
                                                 np.zeros(b["mask"].shape + (778,), np.float32), cond))
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u)
    )
    jstep = JPT.make_r_train_step(jnet, capture, jst, JLL.load_contact_assets(), JLL.RefineLossConfig(),
                                  chunk=64, mesh=None)
    jstate, jm = jstep(JPT.init_train_state(jax.tree.map(jnp.asarray, jparams), capture),
                       {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(1))
    jclipped, _ = JPT.per_param_clip(0.1).update(jstate.opt_state, None)

    pb = {k: _t(v) for k, v in b.items()}
    probe = train_r.make_overflow_probe(pst, backend="cluster")
    assert int(probe(pb)) == 0
    for key in ("pose_repr", "sample_pose_repr"):
        verts = R.batch_recover_mano(pst, pb[key], pb["shape"], pb["hand_side"])[0]
        assert int(R.multi_object_h2o_overflow(verts, pb["obj_traj"], pb["obj_points"], pb["obj_mask"],
                                               x_perm=pst.template_perm, backend="cluster").sum()) == 0

    net = R.SegmentRefineNet(cfg)
    net.load_state_dict(from_jax.r_state_dict_from_flax(jparams))
    state = PT.TrainState(net, PT.make_optimizer(net.named_parameters()))
    step = PT.make_r_train_step(pst, LL.load_contact_assets(), LL.RefineLossConfig(), backend="cluster")
    before = [k.launches for k in CC.KERNELS]
    metrics = step(state, pb)
    assert [k.launches for k in CC.KERNELS] == before  # CPU tensors: the plain versions
    for k in ("loss", "rec_joint", "rec_vert", "dist_h"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    want = {k: v.numpy() for k, v in from_jax.r_state_dict_from_flax(jax.tree.map(np.asarray, jclipped)).items()}
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(grads) == set(want) and any(np.abs(g).max() > 0 for g in grads.values())
    for k in grads:
        assert np.linalg.norm(grads[k] - want[k]) <= 1e-4 * np.linalg.norm(want[k]) + 1e-7, k


def _multi_object_scene(P=256, seed=49):
    """max_nobj 3 with one real object (identity rotation) and two padded
    slots (zero clouds and trajectories), 2 frames."""
    rng = np.random.default_rng(seed)
    bs, L, nobj = 1, 2, 3
    hv = (rng.normal(size=(bs, L, 778, 3)) * 0.05).astype(np.float32)
    traj = np.zeros((bs, nobj, L, 9), np.float32)
    traj[:, 0, :, 3:] = [1, 0, 0, 0, 1, 0]
    pts = np.zeros((bs, nobj, P, 3), np.float32)
    pts[:, 0] = rng.normal(size=(bs, P, 3)).astype(np.float32) * 0.05
    om = np.zeros((bs, nobj), bool)
    om[:, 0] = True
    return hv, traj, pts, om


def test_multi_object_h2o_cluster_matches_jax_interpret():
    """multi_object_h2o_dist(backend="cluster") and multi_object_h2o_overflow
    on a multi-object batch with padded slots: padded slots neither poison
    the distances nor count toward the certificate."""
    hv, traj, pts, om = _multi_object_scene()
    jargs = (jnp.asarray(traj), jnp.asarray(pts), jnp.asarray(om))
    perm = M.hand_template_perm(M.synthetic_mano_model("right").v_template)
    want = JR.multi_object_h2o_dist(jnp.asarray(hv), jnp.zeros_like(jnp.asarray(hv)), *jargs,
                                    x_perm=perm, backend="cluster", interpret=True)
    got = R.multi_object_h2o_dist(_t(hv), *(_t(a) for a in (traj, pts, om)), x_perm=perm, backend="cluster")
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-6)
    exact = R.multi_object_h2o_dist(_t(hv), *(_t(a) for a in (traj, pts, om)), backend="exact")
    assert torch.equal(got, exact)  # 2 cells: certified
    ovf = R.multi_object_h2o_overflow(_t(hv), *(_t(a) for a in (traj, pts, om)), x_perm=perm, backend="cluster")
    assert ovf.tolist() == [0]
    assert not R.multi_object_h2o_overflow(_t(hv), *(_t(a) for a in (traj, pts, om)), backend="auto").any()
    # a 2 m shell around the hand at 4096 points (32 cells > 24) overflows
    shell = np.random.default_rng(1).normal(size=(4096, 3))
    shell = (2.0 * shell / np.linalg.norm(shell, axis=1, keepdims=True)).astype(np.float32)
    pts = np.zeros((1, 3, 4096, 3), np.float32)
    pts[:, 0] = shell
    jo = JR.multi_object_h2o_overflow(jnp.asarray(hv), jnp.asarray(traj), jnp.asarray(pts), jnp.asarray(om),
                                      x_perm=perm, backend="cluster")
    po = R.multi_object_h2o_overflow(_t(hv), _t(traj), _t(pts), _t(om), x_perm=perm, backend="cluster")
    assert po.tolist() == np.asarray(jo).tolist() and po.item() > 0


def _probe_batch(obj_points: np.ndarray) -> dict:
    """tests/test_overflow_monitor.py's one-sample batch around a near-rest
    hand; obj_points [1, 1, P, 3]."""
    rng = np.random.default_rng(0)
    L = 2
    pose = np.zeros((1, L, 99), np.float32)
    pose[..., 3:] = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), 16)
    pose += rng.normal(size=pose.shape).astype(np.float32) * 0.01
    traj = np.zeros((1, 1, L, 9), np.float32)
    traj[..., 3:] = np.array([1, 0, 0, 0, 1, 0], np.float32)
    return {"sample_pose_repr": pose, "shape": np.zeros((1, L, 10), np.float32),
            "hand_side": np.zeros((1,), np.int32), "obj_traj": traj,
            "obj_points": obj_points.astype(np.float32), "obj_mask": np.ones((1, 1), bool)}


def _shell(P=4096):
    d = np.random.default_rng(1).normal(size=(P, 3))  # the monitor test's draw
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * 2.0)[None, None]


def _ball(P=2048):
    rng = np.random.default_rng(2)
    return (rng.normal(size=(P, 3)) * 0.03 + np.array([0.0, 0.0, 0.05]))[None, None]


@pytest.mark.parametrize("scene", ["shell", "ball"])
def test_overflow_probe_warns_or_certifies(scene, manos, caplog):
    """The port's make_overflow_probe / report_cluster_overflow on the two
    scenes of tests/test_overflow_monitor.py: the shell overflows (WARNING),
    the 2048-point ball (16 cells) certifies (INFO, 0); the counts equal the
    JAX probe's."""
    jst, pst = manos
    b = _probe_batch(_shell() if scene == "shell" else _ball())
    jcount = JTR.report_cluster_overflow(JTR.make_overflow_probe(jst, backend="cluster"),
                                         {k: jnp.asarray(v) for k, v in b.items()}, "val", 0, None, 0)

    class Writer:
        scalars = {}

        def add_scalar(self, tag, value, step):
            self.scalars[tag] = value

    writer = Writer()
    probe = train_r.make_overflow_probe(pst, backend="cluster")
    with caplog.at_level(logging.INFO, logger=LOGGER):
        count = train_r.report_cluster_overflow(probe, {k: _t(v) for k, v in b.items()}, "val", 0, writer, 3)
    assert count == jcount
    assert writer.scalars == {"val/h2o_cluster_overflow": float(count)}
    if scene == "shell":
        assert count > 0
        assert any(r.levelno == logging.WARNING and "overflow" in r.message for r in caplog.records)
    else:
        assert count == 0
        assert not any(r.levelno >= logging.WARNING for r in caplog.records)
        assert any("certificate ok" in r.message for r in caplog.records)


class _ShellSegments:
    """SyntheticSegments with one object per segment, every trajectory the
    identity; segment 0 holds a 2 m shell around the hand (every one of its
    25 cells qualifies: it overflows the 24-cell budget)."""

    def __init__(self, n=2, L=16, P=3200):
        self.base = SyntheticSegments(n, seq_len=L, max_nobj=1, n_obj_points=P, seed=3)
        self.shell = _shell(P)[0, 0].astype(np.float32)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        d = self.base[i]
        d["obj_traj"] = np.zeros_like(d["obj_traj"])
        d["obj_traj"][..., 3:] = [1, 0, 0, 0, 1, 0]
        if i == 0:
            d["obj_pointcloud"] = self.shell[None]
        return d


def test_target_cache_recomputes_overflowed_samples_exactly(manos, monkeypatch, caplog):
    """TargetH2OCache with its search forced onto the cluster route: samples
    the certificate cannot clear are recomputed on the exact route, so every
    stored value equals the exact route's."""
    _, pst = manos
    base, collate = _ShellSegments(), SegmentCollate(max_nobj=1, n_obj_points=3200)
    calls = []
    dist, overflow = TC.multi_object_h2o_dist, TC.multi_object_h2o_overflow

    def spy(*args, backend="auto", **kw):  # the cache's own "auto" search goes to the cluster route
        backend = "cluster" if backend == "auto" else backend
        calls.append((backend, args[0].shape[0]))
        return dist(*args, backend=backend, **kw)

    def cluster_overflow(*args, backend="auto", **kw):
        assert backend == "auto"
        return overflow(*args, backend="cluster", **kw)

    monkeypatch.setattr(TC, "multi_object_h2o_dist", spy)
    monkeypatch.setattr(TC, "multi_object_h2o_overflow", cluster_overflow)
    cache = TC.TargetH2OCache(base, pst, collate, batch_size=2)
    with caplog.at_level(logging.WARNING, logger="oakink2_tamf_tpu_torch.data.target_cache"):
        assert cache.precompute() == 2
    b = {k: _t(v) for k, v in collate([base[i] for i in range(2)]).items() if k in TC._GEOM_KEYS}
    verts = R.batch_recover_mano(pst, b["pose_repr"], b["shape"], b["hand_side"])[0]
    geom = (verts, b["obj_traj"], b["obj_points"], b["obj_mask"])
    ovf = R.multi_object_h2o_overflow(*geom, x_perm=pst.template_perm, backend="cluster")
    n_bad = int((ovf > 0).sum())
    assert ovf[0] > 0
    assert calls == [("cluster", 2), ("exact", n_bad)]
    assert any("overflow on %d/2 segments" % n_bad in r.getMessage() for r in caplog.records)
    exact = R.multi_object_h2o_dist(*geom, x_perm=pst.template_perm, backend="exact").numpy()
    for i in range(2):
        np.testing.assert_array_equal(cache[i]["target_h2o"], exact[i])


def test_train_r_main_cluster_route_runs_the_certificate(tmp_path, monkeypatch, caplog):
    """train_r.main --train.h2o_backend cluster on the CPU: it trains, and
    the val pass logs the certificate (128 points: one cell, certified)."""
    monkeypatch.chdir(tmp_path)
    argv = ["--cfg", os.path.join(REPO, "config/synthetic_smoke.yml"), "--runtime.device", "cpu",
            "--train.h2o_backend", "cluster", "--train.num_epoch", "1", "--train.val_freq", "1",
            "--train.eval_max_batches", "1"]
    with caplog.at_level(logging.INFO, logger=LOGGER):
        state = train_r.main(argv)
    assert state.step == 2 and all(torch.isfinite(p).all() for p in state.model.parameters())
    assert any("val epoch 0000: cluster-exactness certificate ok" in r.getMessage() for r in caplog.records)
