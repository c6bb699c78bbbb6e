"""R training in the PyTorch port (models/losses.segment_refine_loss,
models/refine_r.target_geometry and refine_forward, parallel/train.
make_r_train_step, data/adaptors, launch/train_r) against the JAX package on
the CPU, at small sizes, on the same numpy inputs and (via
interop/from_jax.r_state_dict_from_flax) the same weights.

Tolerances, float32 on both sides:
- the refine loss on the same outputs: rtol 1e-6 (the same reductions);
- target geometry: MANO atol 2e-6, normals 1e-4, h2o rtol 1e-5 / atol 2e-6
  (the module tests' bounds; the JAX CPU route expands ||x-y||^2);
- one whole R train step: loss rtol 1e-5; each parameter's clipped
  gradient within 1e-4 of its norm plus 1e-7 (a one-layer transformer,
  MANO and the h2o backward summed in another order; the batch's nearest
  hand-object distances are centimetres, where the JAX CPU route's
  expanded-distance error, ~1e-8 m^2 at these coordinates, moves a
  gradient by under 1e-5 of itself); each parameter after the AdamW step,
  where the gradient is resolved (|g| > 1e-5), within 1e-4 of its norm
  (+1e-7) and elementwise atol 2e-6. AdamW's first step moves a weight by
  about lr sign(g), which is noise where the true gradient is 0
  (attention's key bias, which softmax ignores): there the test bounds the
  move by lr;
- the Gaussian-perturb adaptor on the same (seed, epoch, index): atol 1e-6
  (the same numpy draws; the renorm's norms round differently).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from oakink2_tamf_tpu.core import mano as JM
from oakink2_tamf_tpu.data import adaptors as JA
from oakink2_tamf_tpu.data.synthetic import synthetic_batch, with_perturbed_sample
from oakink2_tamf_tpu.models import losses as JLL
from oakink2_tamf_tpu.models import refine_r as JR
from oakink2_tamf_tpu.parallel import train as JPT
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.core import transforms as T
from oakink2_tamf_tpu_torch.data import adaptors as A
from oakink2_tamf_tpu_torch.data import fabricate as F
from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments
from oakink2_tamf_tpu_torch.interop import from_jax
from oakink2_tamf_tpu_torch.launch import common
from oakink2_tamf_tpu_torch.launch import train_r
from oakink2_tamf_tpu_torch.models import losses as LL
from oakink2_tamf_tpu_torch.models import refine_r as R
from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
from oakink2_tamf_tpu_torch.parallel import train as PT
from oakink2_tamf_tpu_torch.runtime.ckpt import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(latent_dim=32, ff_size=64, num_layers=1, num_heads=4, dropout=0.0)
R_KEYS = ("pose_repr", "sample_pose_repr", "mask", "shape", "hand_side", "obj_traj",
          "obj_embedding", "obj_mask", "obj_points")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch single-threaded for this file under pytest-xdist: the workers
    share the cores, and each one's intra-op threads would spin against the
    others' (six concurrent train_r.main smoke runs took ~144 s each at 8
    threads, ~38 s at 1, on an 8-core host). A serial run keeps them all."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _manos():
    jst = JR.stack_mano_models(JM.synthetic_mano_model("right"), JM.synthetic_mano_model("left"))
    pst = R.stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    return jst, pst


def _batch(seed, bs=2, L=8, P=64, min_len=5):
    rng = np.random.default_rng(seed)
    b = synthetic_batch(rng, batch_size=bs, seq_len=L, max_nobj=2, n_obj_points=P, min_len=min_len, as_jax=False)
    b = with_perturbed_sample(b, rng)
    b["sample_pose_repr"] = np.asarray(b["sample_pose_repr"])
    return {k: b[k] for k in R_KEYS}


def test_renormalize_pose_repr_rot6d_matches_jax():
    from oakink2_tamf_tpu.core import transforms as JT

    x = np.random.default_rng(0).normal(size=(3, 5, 99)).astype(np.float32)
    x[0, 0, 3:9] = 0.0  # a zero block stays finite
    np.testing.assert_allclose(T.renormalize_pose_repr_rot6d(_t(x)).numpy(),
                               np.asarray(JT.renormalize_pose_repr_rot6d(jnp.asarray(x))), atol=1e-6)


def test_segment_refine_loss_matches_jax():
    rng = np.random.default_rng(1)
    bs, L = 3, 6
    out = {k: rng.normal(size=(bs, L) + s).astype(np.float32) for k, s in (
        ("refine_hand_joints", (21, 3)), ("target_hand_joints", (21, 3)),
        ("refine_hand_verts", (778, 3)), ("target_hand_verts", (778, 3)),
        ("refine_h2o_dist", (778,)), ("target_h2o_dist", (778,)))}
    mask = (rng.random((bs, L)) > 0.3).astype(np.float32)
    mask[2] = 0.0  # an all-padded sample: mask_coef's floor
    cfg = dict(coef_rec_joint=0.7, coef_rec_vert=1.3, coef_dist_h=0.1)
    jl, jt = JLL.segment_refine_loss(JLL.load_contact_assets(), JLL.RefineLossConfig(**cfg),
                                     {k: jnp.asarray(v) for k, v in out.items()}, {"mask": jnp.asarray(mask)})
    tl, tt = LL.segment_refine_loss(LL.load_contact_assets(), LL.RefineLossConfig(**cfg),
                                    {k: _t(v) for k, v in out.items()}, {"mask": _t(mask)})
    assert set(tt) == set(jt)
    for k in jt:
        np.testing.assert_allclose(float(tt[k]), float(jt[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("with_cached", [False, True])
def test_target_geometry_matches_jax(with_cached):
    """Without `target_h2o` the chamfer runs (all-pairs here); with it, the
    batch's value passes through and only MANO runs. Nothing is
    differentiable."""
    jst, pst = _manos()
    b = _batch(2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    pb = {k: _t(v) for k, v in b.items()}
    if with_cached:
        h = np.random.default_rng(3).random((2, 8, 778)).astype(np.float32)
        jb["target_h2o"], pb["target_h2o"] = jnp.asarray(h), _t(h)
    want = JR.target_geometry(jst, jb, chunk=64)
    pb["pose_repr"].requires_grad_(True)
    got = R.target_geometry(pst, pb, normals=True)
    assert not any(v.requires_grad for v in got.values())
    for k, tol in (("target_hand_verts", 2e-6), ("target_hand_joints", 2e-6), ("target_hand_normals", 1e-4)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=tol, err_msg=k)
    np.testing.assert_allclose(got["target_h2o_dist"].numpy(), np.asarray(want["target_h2o_dist"]),
                               rtol=1e-5, atol=2e-6)
    if with_cached:
        assert got["target_h2o_dist"] is pb["target_h2o"]


def _jax_r_step(b, jparams, cfg):
    """The JAX package's R train step with an optimizer that returns zero
    updates and keeps the gradients as its state; then its real optimizer
    applied to those gradients. -> (metrics, clipped grads, new params)."""
    jnet = JR.SegmentRefineNet(JR.RefineConfig(**cfg))
    jst, _ = _manos()
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u)
    )
    jstep = JPT.make_r_train_step(jnet, capture, jst, JLL.load_contact_assets(), JLL.RefineLossConfig(),
                                  chunk=64, mesh=None)
    jstate, jm = jstep(JPT.init_train_state(jax.tree.map(jnp.asarray, jparams), capture),
                       {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(1))
    jgrads = jstate.opt_state
    jclipped, _ = JPT.per_param_clip(0.1).update(jgrads, None)
    jopt = JPT.make_optimizer()
    upd, _ = jopt.update(jgrads, jopt.init(jparams), jparams)
    return jm, jclipped, optax.apply_updates(jparams, upd)


def _init_r(b, cfg, seed=0):
    jnet = JR.SegmentRefineNet(JR.RefineConfig(**cfg))
    cond = {k: b[k] for k in ("hand_side", "shape", "obj_embedding", "obj_traj", "obj_mask")}
    return jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(seed), b["sample_pose_repr"],
                                              np.zeros(b["mask"].shape + (778,), np.float32), cond))


@pytest.fixture(scope="module")
def jax_r_reference():
    """The batch, the JAX weights and the JAX package's step on them, built
    once for every route of the port."""
    b = _batch(4)
    jparams = _init_r(b, SMALL)
    return b, jparams, _jax_r_step(b, jparams, SMALL)


@pytest.mark.parametrize("backend", ["auto", "cull", "xla"])
def test_r_train_step_matches_jax(backend, jax_r_reference):
    """One whole R train step, port on the CPU vs the JAX package's
    make_r_train_step(mesh=None) on the same weights and batch, dropout 0.
    The JAX CPU route is its exact XLA scan (what h2o_backend "auto" and
    "xla" both take there); the port runs its all-pairs route ("auto" at 64
    points), the culled one, or the same streaming scan ("xla", at JAX's
    chunk of 64 points)."""
    b, jparams, (jm, jclipped, jnew) = jax_r_reference

    net = R.SegmentRefineNet(R.RefineConfig(**SMALL))
    net.load_state_dict(from_jax.r_state_dict_from_flax(jparams))
    state = PT.TrainState(net, PT.make_optimizer(net.named_parameters()))
    _, pst = _manos()
    step = PT.make_r_train_step(pst, LL.load_contact_assets(), LL.RefineLossConfig(), backend=backend, chunk=64)
    kernel = CU.DVEC_KERNEL if backend == "cull" else NN.DVEC_KERNEL
    launches = kernel.launches
    metrics = step(state, {k: _t(v) for k, v in b.items()})
    assert kernel.launches == launches  # CPU tensors: the plain versions
    assert state.step == 1 and net.training
    for k in ("loss", "rec_joint", "rec_vert", "dist_h"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5, err_msg=k)

    def port_tree(tree):
        return {k: v.numpy() for k, v in from_jax.r_state_dict_from_flax(jax.tree.map(np.asarray, tree)).items()}

    want_g, want_p = port_tree(jclipped), port_tree(jnew)
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    new = {k: p.detach().numpy() for k, p in net.named_parameters()}
    assert set(grads) == set(want_g)
    assert any(np.abs(g).max() > 0 for g in grads.values())
    old, lr = port_tree(jparams), state.optimizer.lr
    for k in grads:
        assert np.linalg.norm(grads[k] - want_g[k]) <= 1e-4 * np.linalg.norm(want_g[k]) + 1e-7, k
        resolved = np.abs(want_g[k]) > 1e-5
        diff = (new[k] - want_p[k])[resolved]
        assert np.linalg.norm(diff) <= 1e-4 * np.linalg.norm(want_p[k]) + 1e-7, k
        np.testing.assert_allclose(new[k][resolved], want_p[k][resolved], rtol=0, atol=2e-6, err_msg=k)
        assert np.all(np.abs(new[k] - old[k]) <= lr + 1e-6), k  # + float32 rounding of the weight


def test_r_train_step_cached_target_equals_inline():
    """A batch carrying target_h2o (the cache) gives the step the same loss
    and gradients as the in-step target chamfer."""
    b = {k: _t(v) for k, v in _batch(5).items()}
    _, pst = _manos()
    with torch.no_grad():
        h = R.multi_object_h2o_dist(*(R.batch_recover_mano(pst, b["pose_repr"], b["shape"], b["hand_side"])[:1]),
                                    b["obj_traj"], b["obj_points"], b["obj_mask"], x_perm=pst.template_perm)
    out = []
    for batch in (b, dict(b, target_h2o=h)):
        torch.manual_seed(0)
        net = R.SegmentRefineNet(R.RefineConfig(**SMALL))
        state = PT.TrainState(net, PT.make_optimizer(net.named_parameters()))
        m = PT.make_r_train_step(pst, LL.load_contact_assets(), LL.RefineLossConfig())(state, batch)
        out.append((float(m["loss"]), [p.detach().clone() for p in net.parameters()]))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for a, c in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-7)


def test_refine_forward_eval_matches_jax():
    """The deterministic forward with the target branch (net.eval(), dropout
    0.1 in the config, off here), as the val pass runs it."""
    cfg = dict(SMALL, dropout=0.1)
    b = _batch(6)
    jparams = _init_r(b, cfg)
    jst, pst = _manos()
    want = JR.refine_forward(JR.SegmentRefineNet(JR.RefineConfig(**cfg)), jparams, jst,
                             {k: jnp.asarray(v) for k, v in b.items()}, deterministic=True, chunk=64,
                             loss_frame_mask=jnp.asarray(b["mask"]))
    net = R.SegmentRefineNet(R.RefineConfig(**cfg))
    net.load_state_dict(from_jax.r_state_dict_from_flax(jparams))
    with torch.no_grad():
        got = train_r.refine_forward_eval(net, pst, {k: _t(v) for k, v in b.items()}, normals=True)
    assert not net.training
    assert set(got) == set(want)
    valid = b["mask"] > 0
    for k in want:
        # refined normals: the net's ~1e-5 output difference through the
        # synthetic hand's sliver faces
        tol = {"refine_hand_normals": 1e-3, "sample_hand_normals": 1e-4, "target_hand_normals": 1e-4}.get(k, 2e-5)
        a, w = got[k].numpy(), np.asarray(want[k])
        if k in ("refine_h2o_dist", "target_h2o_dist"):  # culled frames: BIG in the port
            a, w = a[valid], w[valid]
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=tol, err_msg=k)


# ---------------------------------------------------------------------------
# sample adaptors
# ---------------------------------------------------------------------------


def test_gaussian_perturb_adaptor_matches_jax():
    base = SyntheticSegments(5, seq_len=20, max_nobj=2, n_obj_points=32)
    ta = A.GaussianPerturbSampleAdaptor(base, (0.02, 0.1), seed=3)
    ja = JA.GaussianPerturbSampleAdaptor(base, (0.02, 0.1), seed=3)
    for epoch in (0, 2):
        ta.set_epoch(epoch)
        ja.set_epoch(epoch)
        for i in range(5):
            a, w = ta[i], ja[i]
            assert a["sample_info"] == w["sample_info"]
            np.testing.assert_allclose(a["sample_pose_repr"], w["sample_pose_repr"], atol=1e-6)
            n = a["len"]
            assert a["sample_pose_repr"].dtype == np.float32
            assert np.all(a["sample_pose_repr"][n:] == 0.0)  # padded frames stay zero
            assert not np.array_equal(a["sample_pose_repr"][:n], a["pose_repr"][:n])
    ta.set_epoch(0)
    first = ta[1]["sample_pose_repr"]
    ta.set_epoch(1)
    assert not np.array_equal(first, ta[1]["sample_pose_repr"])


def test_generated_identity_and_concat_adaptors_match_jax(tmp_path):
    base = SyntheticSegments(3, seq_len=20, max_nobj=2, n_obj_points=16)
    d = tmp_path / "arch__0001"
    d.mkdir()
    rng = np.random.default_rng(4)
    for i in range(3):
        np.save(d / f"{i}.npy", rng.normal(size=(20, 99)).astype(np.float64))
    tg, jg = A.GeneratedPoseReprSampleAdaptor(base, [str(d)]), JA.GeneratedPoseReprSampleAdaptor(base, [str(d)])
    ti, ji = A.IdentitySampleAdaptor(base), JA.IdentitySampleAdaptor(base)
    tc, jc = A.ConcatDataset([tg, ti]), JA.ConcatDataset([jg, ji])
    assert len(tc) == len(jc) == 6
    for i in range(6):
        a, w = tc[i], jc[i]
        assert a["sample_info"] == w["sample_info"]
        np.testing.assert_array_equal(a["sample_pose_repr"], w["sample_pose_repr"])
    assert tc[0]["sample_pose_repr"].dtype == np.float32
    with pytest.raises(ValueError):
        A.GeneratedPoseReprSampleAdaptor(SyntheticSegments(4, seq_len=20), [str(d)])


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_train_r_main_cpu_smoke_and_checkpoint(tmp_path, monkeypatch):
    """train_r.main on the smoke config on the CPU: two epochs with the
    target cache, a val pass, checkpoints (--commit), and a reload."""
    monkeypatch.chdir(tmp_path)
    argv = ["--cfg", os.path.join(REPO, "config/synthetic_smoke.yml"), "--runtime.device", "cpu",
            "--exp_id", "smoke", "--train.val_freq", "2", "--train.eval_max_batches", "1", "--commit"]
    state = train_r.main(argv)
    assert state.step == 4  # 16 segments / batch 8, drop_last, 2 epochs
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    saved = tmp_path / "common" / "train_r" / "smoke" / "save"
    assert sorted(os.listdir(saved)) == ["model_0000.pt", "model_0001.pt"]
    lines = (tmp_path / "common" / "train_r" / "smoke" / "summary" / "scalars.jsonl").read_text()
    assert "val/loss" in lines and "val/dist_h" in lines
    net = R.SegmentRefineNet(R.RefineConfig(**dict(SMALL, num_layers=2)))
    fresh = PT.TrainState(net, PT.make_optimizer(net.named_parameters(), milestones_steps=[2]))
    load_checkpoint(str(saved / "model_0001.pt"), fresh, strict=True)
    assert fresh.step == 4
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_train_r_main_on_a_fabricated_cache(tmp_path, monkeypatch):
    """train_r.main on real-format data: a cache_dict pickle of 160-frame
    segments (each holding 2 of 3 objects) with its .npy embeddings and .npz
    clouds of 256 points, through build_dataset's real branch, cut to 2
    slots of 128 points; one step on the CPU."""
    paths = F.write_dataset(str(tmp_path), 10, seq_len=160, n_obj=3, n_points=256, seed=2)
    built = []
    build = common.build_dataset
    monkeypatch.setattr(common, "build_dataset", lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    monkeypatch.chdir(tmp_path)
    state = train_r.main([
        "--cfg", os.path.join(REPO, "config/synthetic_smoke.yml"), "--runtime.device", "cpu",
        "--exp_id", "fab", "--runtime.num_worker", "0", "--train.num_epoch", "1",
        "--data.synthetic", "false", "--data.max_nobj", "2", "--data.n_obj_points", "128",
        "--train.cache_dict_filepath", paths["cache_dict"],
        "--data.obj_embedding_prefix", paths["obj_embedding_prefix"],
        "--data.obj_pointcloud_prefix", paths["obj_pointcloud_prefix"],
    ])
    assert [type(d).__name__ for d in built] == ["InteractionSegmentData"] and len(built[0]) == 10
    assert state.step == 1  # 10 segments / batch 8, drop_last
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_train_r_refuses_what_is_not_ported(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["--cfg", os.path.join(REPO, "config/synthetic_smoke.yml"), "--runtime.device", "cpu",
            "--train.num_epoch", "1", "--train.data.cache_target_h2o", "false"]
    # the streaming xla route is ported: the smoke config's step runs on it
    state = train_r.main(base + ["--train.h2o_backend", "xla"])
    assert state.step >= 1 and all(torch.isfinite(p).all() for p in state.model.parameters())
    # real data is ported: without a cache_dict or a toolkit there is nothing to load
    with pytest.raises(ValueError, match="need cache_dict"):
        train_r.main(base + ["--data.synthetic", "false"])
