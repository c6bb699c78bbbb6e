"""G training in the PyTorch port (core/diffusion training loss,
core/schedule_sampler, parallel/train, data/loader, runtime, launch/train_g)
against the JAX package on the CPU, at small sizes, on the same numpy
inputs and (via interop/from_jax) the same weights.

Tolerances, float32 on both sides:
- masked_l2, q_sample and the diffusion loss: rtol 1e-6;
- the optimizer fed the same gradients (clip, AdamW, MultiStepLR): rtol
  1e-6 / atol 1e-9 on the parameters after each of 4 steps;
- one whole G train step (composed route, JAX noise): loss rtol 1e-4;
  clipped gradients rtol 2e-3 / atol 1e-6 (the extra loss's own gradient
  bound, tests/test_chamfer_loss.py, through a transformer whose matmuls
  sum in another order); parameters after the step atol 2e-6 where the
  gradient is resolved (|g| > 1e-5). AdamW's first step moves each weight
  by lr g / (|g| + eps), about lr sign(g): where the true gradient is 0
  (attention's key bias, which softmax ignores) both sides hold rounding
  noise of either sign, and there the test only bounds the move by lr.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from oakink2_tamf_tpu.core import diffusion as JD
from oakink2_tamf_tpu.core import mano as JM
from oakink2_tamf_tpu.core import schedule_sampler as JSS
from oakink2_tamf_tpu.data import loader as JLD
from oakink2_tamf_tpu.data.collate import SegmentCollate as JCollate
from oakink2_tamf_tpu.data.synthetic import synthetic_batch
from oakink2_tamf_tpu.launch import param as JP
from oakink2_tamf_tpu.models import losses as JLL
from oakink2_tamf_tpu.models import mdm_g as JMDM
from oakink2_tamf_tpu.models.refine_r import stack_mano_models as j_stack_mano_models
from oakink2_tamf_tpu.parallel import train as JPT
from oakink2_tamf_tpu.runtime import config as JCFG
from oakink2_tamf_tpu_torch.core import diffusion as D
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.core import schedule_sampler as SS
from oakink2_tamf_tpu_torch.data import loader as LD
from oakink2_tamf_tpu_torch.data.collate import SegmentCollate
from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments
from oakink2_tamf_tpu_torch.interop import from_jax
from oakink2_tamf_tpu_torch.launch import param as P
from oakink2_tamf_tpu_torch.launch import train_g
from oakink2_tamf_tpu_torch.models import losses as LL
from oakink2_tamf_tpu_torch.models import mdm_g as MDM
from oakink2_tamf_tpu_torch.models.refine_r import stack_mano_models
from oakink2_tamf_tpu_torch.parallel import train as PT
from oakink2_tamf_tpu_torch.runtime import config as CFG
from oakink2_tamf_tpu_torch.runtime.ckpt import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(latent_dim=32, ff_size=64, num_layers=1, num_heads=4, dropout=0.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_masked_l2_and_training_losses_same_noise():
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(3, 12, 99)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    mask = (rng.random((3, 12)) > 0.3).astype(np.float32)
    t = np.array([0, 17, 49])
    js, ts = JD.tamf_schedule(50, "cosine", "10"), D.tamf_schedule(50, "cosine", "10")

    def jfn(x, tt):
        return x * 0.3 + tt[:, None, None].astype(jnp.float32) * 1e-3

    def tfn(x, tt):
        return x * 0.3 + tt[:, None, None].to(torch.float32) * 1e-3

    t10 = t % 10
    jmse, jaux = JD.training_losses(jfn, js, jnp.asarray(x0), jnp.asarray(t10), jnp.asarray(mask),
                                    None, noise=jnp.asarray(noise))
    tmse, taux = D.training_losses(tfn, ts, _t(x0), _t(t10), _t(mask), noise=_t(noise))
    np.testing.assert_allclose(tmse.numpy(), np.asarray(jmse), rtol=1e-6)
    np.testing.assert_allclose(taux["x_t"].numpy(), np.asarray(jaux["x_t"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(D.model_timesteps(ts, _t(t10)).numpy(),
                                  np.asarray(JD.model_timesteps(js, jnp.asarray(t10))))
    np.testing.assert_allclose(
        D.masked_l2(_t(x0), _t(noise), _t(mask)).numpy(),
        np.asarray(JD.masked_l2(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(mask))), rtol=1e-6,
    )


def test_schedule_samplers():
    jr, tr = JSS.LossSecondMomentResampler(20, history_per_term=3), SS.LossSecondMomentResampler(20, history_per_term=3)
    rng = np.random.default_rng(1)
    for _ in range(30):
        t = rng.integers(0, 20, size=8)
        losses = rng.random(8)
        jr.update_with_losses(t, losses)
        tr.update_with_losses(_t(t), _t(losses))
    assert tr._warmed_up() and jr._warmed_up()
    np.testing.assert_array_equal(tr.weights(), jr.weights())
    g = torch.Generator().manual_seed(0)
    t, w = tr.sample(4000, generator=g)
    p = tr.weights() / tr.weights().sum()
    np.testing.assert_allclose(w.numpy(), 1.0 / (20 * p[t.numpy()]), rtol=1e-6)
    freq = np.bincount(t.numpy(), minlength=20) / 4000
    assert np.abs(freq - p).max() < 0.03  # a draw from p
    t, w = SS.create_named_schedule_sampler("uniform", 20).sample(64, generator=g)
    assert t.dtype == torch.int64 and 0 <= int(t.min()) and int(t.max()) < 20 and torch.all(w == 1)
    with pytest.raises(NotImplementedError):
        SS.create_named_schedule_sampler("nope", 20)


def test_optimizer_matches_optax_over_milestones():
    """per_param_clip + AdamW + MultiStepLR over 4 steps with milestones at
    steps 1 and 3, fed the same gradients as the JAX package's optimizer."""
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (0.01 if k == "b" else 1.0)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    jopt = JPT.make_optimizer(base_lr=1e-2, grad_clip=0.1, milestones_steps=[1, 3], gamma=0.5)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jopt.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    topt = PT.make_optimizer(tp.values(), base_lr=1e-2, grad_clip=0.1, milestones_steps=[1, 3], gamma=0.5)
    lrs = []
    for g in grads:
        upd, jst = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad()
        for k, p in tp.items():
            p.grad = _t(g[k])
        lrs.append(topt.lr)
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-9)
    assert lrs == pytest.approx([1e-2, 5e-3, 5e-3, 2.5e-3])


def test_cond_mask_hook():
    m = MDM.InteractionSegmentMDM(MDM.MDMConfig(cond_mask_prob=0.5, **SMALL))
    text = torch.ones(64, 512)
    assert torch.equal(m._mask_cond(text, force_mask=True), torch.zeros_like(text))
    m.eval()
    assert torch.equal(m._mask_cond(text, force_mask=False), text)
    m.train()
    torch.manual_seed(0)
    kept = m._mask_cond(text, force_mask=False)[:, 0]
    assert 0 < int(kept.sum()) < 64 and set(kept.tolist()) <= {0.0, 1.0}


def test_g_train_step_matches_jax_composed():
    """One whole G train step, port on the CPU vs the JAX package's
    make_g_train_step(dist_impl="composed", mesh=None): the same weights,
    batch, timesteps and (JAX's own) q_sample noise."""
    rng = np.random.default_rng(3)
    batch = synthetic_batch(rng, batch_size=2, seq_len=8, max_nobj=2, n_obj_points=64, min_len=5, as_jax=False)
    batch["t"] = np.array([3, 41], np.int32)
    batch["t_weights"] = np.array([1.0, 0.5], np.float32)
    jmodel = JMDM.InteractionSegmentMDM(JMDM.MDMConfig(**SMALL))
    cond = JPT.g_cond_from_batch(batch)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), batch["pose_repr"],
                                                  np.zeros((2,), np.int32), cond))
    jmano = j_stack_mano_models(JM.synthetic_mano_model("right"), JM.synthetic_mano_model("left"))
    # an optimizer that returns zero updates and keeps the gradients as its state
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u)
    )
    jsched = JD.tamf_schedule(50)
    jstep = JPT.make_g_train_step(jmodel, jsched, capture, jmano, JLL.load_contact_assets(),
                                  JLL.ExtraLossConfig(), chunk=64, mesh=None, dist_impl="composed")
    key = jax.random.PRNGKey(5)
    jstate, jmetrics = jstep(JPT.init_train_state(jax.tree.map(jnp.asarray, params), capture),
                             {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jgrads = jstate.opt_state
    noise = np.asarray(jax.random.normal(jax.random.split(key, 4)[1], batch["pose_repr"].shape, jnp.float32))
    # the JAX package's optimizer applied to those gradients
    jopt = JPT.make_optimizer()
    jclipped, _ = JPT.per_param_clip(0.1).update(jgrads, None)
    upd, _ = jopt.update(jgrads, jopt.init(params), params)
    jnew = optax.apply_updates(params, upd)

    model = MDM.InteractionSegmentMDM(MDM.MDMConfig(**SMALL))
    model.load_state_dict(from_jax.g_state_dict_from_flax(params))
    state = PT.TrainState(model, PT.make_optimizer(model.named_parameters()))
    mano = stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    step = PT.make_g_train_step(D.tamf_schedule(50), mano, LL.load_contact_assets(),
                                LL.ExtraLossConfig(), dist_impl="composed")
    metrics = step(state, {k: _t(v) for k, v in batch.items()}, noise=_t(noise))
    assert state.step == 1
    for k in ("loss", "diffusion_loss", "extra/dist_o", "extra/dist_h", "extra/rec_vert"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(metrics["per_sample_t"].numpy(), batch["t"])

    def port_tree(tree):
        return {k: v.numpy() for k, v in from_jax.g_state_dict_from_flax(jax.tree.map(np.asarray, tree)).items()}

    want_g, want_p, old = port_tree(jclipped), port_tree(jnew), port_tree(params)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    new = {k: p.detach().numpy() for k, p in model.named_parameters()}
    assert set(grads) == set(want_g)
    lr = state.optimizer.lr
    for k in grads:
        np.testing.assert_allclose(grads[k], want_g[k], rtol=2e-3, atol=1e-6, err_msg=k)
        resolved = np.abs(want_g[k]) > 1e-5
        np.testing.assert_allclose(new[k][resolved], want_p[k][resolved], rtol=0, atol=2e-6, err_msg=k)
        assert np.all(np.abs(new[k] - old[k]) <= lr + 1e-6), k  # + float32 rounding of the weight


def test_vertex_normals_operators_cached_in_inference_mode_serve_autograd():
    """Serving builds the cached normal operators under inference_mode; a
    training step that reuses them must still be able to backpropagate."""
    from oakink2_tamf_tpu_torch.core import geometry as G

    faces = np.array([[0, 1, 2], [0, 2, 3], [1, 2, 4]], np.int32) + 100  # a key no other test uses
    v = torch.randn(2, 105, 3)
    with torch.inference_mode():
        G.vertex_normals(v, faces)
    vg = v.clone().requires_grad_(True)
    G.vertex_normals(vg, faces).sum().backward()
    assert torch.isfinite(vg.grad).all()


def test_loader_matches_jax_epochs():
    ds = SyntheticSegments(11, seq_len=20, max_nobj=2, n_obj_points=40)
    kw = dict(batch_size=3, shuffle=True, drop_last=True, seed=4, num_workers=2)
    tl = LD.DataLoader(ds, collate_fn=SegmentCollate(2, 40), **kw)
    jl = JLD.DataLoader(ds, collate_fn=JCollate(2, 40), num_shards=1, shard_index=0, **kw)
    assert len(tl) == len(jl) == 3
    for epoch in (0, 1):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        np.testing.assert_array_equal(tl._epoch_indices(), jl._epoch_indices())
        for a, b in zip(tl, jl):
            np.testing.assert_array_equal(a["pose_repr"], b["pose_repr"])
            np.testing.assert_array_equal(a["obj_points"], b["obj_points"])
    tl.set_epoch(0)
    first = tl._epoch_indices().copy()
    tl.set_epoch(1)
    assert not np.array_equal(first, tl._epoch_indices())


def test_config_registry_matches_jax():
    argv = ["--cfg", os.path.join(REPO, "config/synthetic_smoke.yml"), "--train.lr", "3e-4",
            "--train.scheduler_milestone", "2,5", "--exp_id", "x"]
    out = []
    for cfg_mod, param_mod in ((JCFG, JP), (CFG, P)):
        reg = cfg_mod.ConfigRegistry("train_g")
        for fn in (param_mod.reg_base_param, param_mod.reg_model_param, param_mod.reg_train_param):
            fn(reg)
        import argparse

        parser = argparse.ArgumentParser()
        reg.hook(parser)
        reg.parse(parser, argv)
        out.append(reg)
    j, t = out
    assert t.select("runtime")["device"] == "cuda"
    tv = dict(t.values)
    tv.pop("runtime.device")
    assert tv == j.values


def test_train_g_main_cpu_smoke_and_checkpoint(tmp_path, monkeypatch):
    """The entry point on the CPU, two epochs of the smoke config with
    --commit (checkpoints) and a val pass; a reload restores the state."""
    monkeypatch.chdir(tmp_path)
    argv = ["--cfg", os.path.join(REPO, "config/synthetic_smoke.yml"), "--runtime.device", "cpu",
            "--exp_id", "smoke", "--train.val_freq", "2", "--train.eval_max_batches", "1", "--commit"]
    state = train_g.main(argv)
    assert state.step == 4  # 16 segments / batch 8, drop_last, 2 epochs
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    saved = tmp_path / "common" / "train_g" / "smoke" / "save"
    assert sorted(os.listdir(saved)) == ["model_0000.pt", "model_0001.pt"]
    assert (tmp_path / "common" / "train_g" / "smoke" / "summary" / "scalars.jsonl").exists()
    model = MDM.InteractionSegmentMDM(MDM.MDMConfig(**dict(SMALL, num_layers=2)))
    fresh = PT.TrainState(model, PT.make_optimizer(model.named_parameters(), milestones_steps=[2]))
    load_checkpoint(str(saved / "model_0001.pt"), fresh, strict=True)
    assert fresh.step == 4
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert fresh.optimizer.lr == state.optimizer.lr


def test_train_g_refuses_what_is_not_ported(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["--cfg", os.path.join(REPO, "config/synthetic_smoke.yml"), "--runtime.device", "cpu"]
    with pytest.raises(NotImplementedError, match="segment.py"):
        train_g.main(base + ["--data.synthetic", "false"])
