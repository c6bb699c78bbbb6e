"""The port's region-culled fused distance loss (G's dist_impl "fused_cull":
oakink2_tamf_tpu_torch.ops.chamfer_loss region_cull_mask / plain_cull, and
models/losses.py) against the JAX package on the CPU: the mask flag for
flag against `_region_cull_mask`, `chamfer_dist_loss(region_cull=True)`
against the JAX function in Pallas interpret mode, the extra loss against
the port's fused route (against the JAX one: a case of
tests/test_torch_dist_loss.py::test_extra_loss_matches_jax), the G train
step against the JAX one on the same route, and the entry point.

Tolerances are those of tests/test_torch_dist_loss.py (the JAX package's
own for these functions): per-frame sums rtol 2e-4, x-gradients rtol 2e-3 /
atol 1e-4; the whole extra loss rtol 1e-4, its gradient with respect to the
model output rtol 2e-3 / atol 1e-5. The port's distances are direct
differences where the TPU kernel expands them, and it sums in another
order. The mask is compared exactly: both sides evaluate the same bounds in
full float32, and no flag of these scenes lies within rounding of its
threshold.
"""

import os
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from oakink2_tamf_tpu.core import diffusion as JD
from oakink2_tamf_tpu.core import geometry as JG
from oakink2_tamf_tpu.core import mano as JM
from oakink2_tamf_tpu.data.synthetic import synthetic_batch
from oakink2_tamf_tpu.models import losses as JLL
from oakink2_tamf_tpu.models import mdm_g as JMDM
from oakink2_tamf_tpu.models.refine_r import stack_mano_models as j_stack_mano_models
from oakink2_tamf_tpu.ops import chamfer_loss as JCL
from oakink2_tamf_tpu.parallel import train as JPT
from oakink2_tamf_tpu_torch.core import diffusion as D
from oakink2_tamf_tpu_torch.core import geometry as G
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.interop import from_jax
from oakink2_tamf_tpu_torch.launch import train_g
from oakink2_tamf_tpu_torch.models import losses as LL
from oakink2_tamf_tpu_torch.models import mdm_g as MDM
from oakink2_tamf_tpu_torch.models.refine_r import stack_mano_models
from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
from oakink2_tamf_tpu_torch.parallel import train as PT
from test_torch_dist_loss import _extra_loss_inputs

SUM_RTOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-4
LOSS_RTOL = 1e-4
LOSS_GRAD_RTOL, LOSS_GRAD_ATOL = 2e-3, 1e-5
REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(latent_dim=32, ff_size=64, num_layers=1, num_heads=4, dropout=0.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _gt_fields(rng, x, n, y, y_valid, y_group):
    """GT o2h / h2o from an independent nearby hand over the same clouds
    (JAX XLA route)."""
    xg = x + (rng.normal(size=x.shape) * 0.01).astype(np.float32)
    yv = None if y_valid is None else jnp.asarray(np.repeat(y_valid, y_group, axis=0))
    og, hg, _ = JG.point2point_signed(
        jnp.asarray(xg), jnp.asarray(np.repeat(y, y_group, axis=0)), x_normals=jnp.asarray(n),
        y_valid=yv, backend="xla", chunk=512, grad_y=False,
    )
    return np.asarray(og), np.asarray(hg)


def _unit(rng, shape):
    n = rng.normal(size=shape)
    return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)


def _scene(rng, F, P1, P2, G_, scale=0.02):
    """Hand-scale scene whose distances straddle the 5 mm / 10 mm bands."""
    x = (rng.normal(size=(F, P1, 3)) * scale).astype(np.float32)
    y = (rng.normal(size=(G_, P2, 3)) * scale + 0.005).astype(np.float32)
    return x, _unit(rng, (F, P1, 3)), y


def _separated_scene(rng, F, P1, P2, G_):
    """tests/test_chamfer_loss.py's grasp-and-far scene: a finger-like rod
    of spatially sorted rows (compact 128-row regions) and a cloud with a
    near half off its tip and a far half: the mask must cull."""
    x0 = np.stack([rng.uniform(-0.2, 0.2, P1), rng.normal(size=P1) * 0.012,
                   rng.normal(size=P1) * 0.012], axis=1)
    x0 = x0[np.argsort(x0[:, 0])]
    x = (x0[None] + rng.normal(size=(F, P1, 3)) * 0.002).astype(np.float32)
    y_near = rng.normal(size=(G_, P2 // 2, 3)) * 0.02 + np.array([0.26, 0.0, 0.0])
    y_far = rng.normal(size=(G_, P2 // 2, 3)) * 0.03 + np.array([0.6, 0.0, 0.0])
    y = np.concatenate([y_near, y_far], axis=1).astype(np.float32)
    return x, _unit(rng, (F, P1, 3)), y


def _hand_scene(rng, G_, L, P2):
    """778 rows (R = 7) in seven compact clusters, one per region, near a
    cloud of G_ groups: group 1 ragged, group 2 all-invalid; every third
    frame x_valid=False."""
    F = G_ * L
    centers = rng.normal(scale=0.05, size=(F, 7, 3))
    x = centers[:, np.minimum(np.arange(778) // 128, 6)] + rng.normal(scale=0.01, size=(F, 778, 3))
    y = rng.normal(scale=0.06, size=(G_, P2, 3))
    yv = np.ones((G_, P2), bool)
    yv[1, P2 // 3:] = False
    yv[2] = False
    xv = np.ones(F, bool)
    xv[::3] = False
    return x.astype(np.float32), _unit(rng, (F, 778, 3)), y.astype(np.float32), yv, xv


@pytest.mark.parametrize("chunk,p2", [(2048, 8192), (2048, 256), (64, 64), (1000, 5000), (4096, 2000)])
def test_clamp_tile_matches_jax(chunk, p2):
    assert G._clamp_tile(chunk, p2) == JG._clamp_tile(chunk, p2)


@pytest.mark.parametrize("scene", ["separated", "hand778"])
def test_region_cull_mask_matches_jax(scene):
    """Flag for flag against `_region_cull_mask`; on the separated scene
    the mask must cull (else the parity tests below are vacuous)."""
    rng = np.random.default_rng(12)
    if scene == "separated":
        L, tile = 4, 256
        x, _, y = _separated_scene(rng, 8, 500, 1024, 2)
        yv, xv = None, np.array([1, 1, 0, 1, 1, 0, 1, 1], bool)
    else:
        L, tile = 4, 512
        x, _, y, yv, xv = _hand_scene(rng, 3, L, 2048)
    P1p = -(-x.shape[1] // 128) * 128
    want = np.asarray(JCL._region_cull_mask(
        jnp.asarray(x), jnp.asarray(y), None if yv is None else jnp.asarray(yv), tile, L, P1p,
        jnp.asarray(xv)))
    got = CL.region_cull_mask(_t(x), _t(y), None if yv is None else _t(yv), tile, L, _t(xv))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    live = got.numpy()[xv]
    assert (got.numpy()[~xv] == 0).all()
    assert set(np.unique(live)) <= {0, 1, 3}
    if scene == "separated":
        assert (live != 0).mean() <= 0.8 and (live[:, 0] < 2).all()  # the palm end is no candidate
        assert (live >= 2).any(axis=1).all()  # every tile keeps a candidate region
    else:
        assert (got.numpy()[2 * L : 3 * L] == 0).all()  # the all-invalid cloud runs nothing


@pytest.mark.parametrize(
    "F,P1,P2,y_group,tile,use_valid,use_perm,separated",
    [
        (4, 13, 300, 1, 512, False, False, False),  # single tile, pad rows
        (8, 13, 1100, 4, 512, False, True, False),  # several tiles, shared clouds
        (4, 150, 1024, 2, 256, True, True, False),  # two regions, ragged clouds
        (4, 778, 1024, 2, 512, True, False, False),  # seven regions
        (4, 778, 1024, 2, 512, False, True, False),
        (8, 300, 1024, 4, 256, False, False, True),  # a scene the mask culls
    ],
)
def test_region_cull_matches_jax_values_and_grads(F, P1, P2, y_group, tile, use_valid, use_perm, separated):
    rng = np.random.default_rng(5)
    x, n, y = (_separated_scene if separated else _scene)(rng, F, P1, P2, F // y_group)
    yv = rng.random((F // y_group, P2)) > 0.3 if use_valid else None
    og, hg = _gt_fields(rng, x, n, y, yv, y_group)
    vw2 = rng.random(P1).astype(np.float32)
    perm = rng.permutation(P1) if use_perm else None
    a = rng.normal(size=F).astype(np.float32)
    b = rng.normal(size=F).astype(np.float32)

    def jloss(xx):
        do_f, dh_f = JCL.chamfer_dist_loss(
            xx, jnp.asarray(n), jnp.asarray(y), jnp.asarray(og), jnp.asarray(hg), jnp.asarray(vw2),
            None if yv is None else jnp.asarray(yv), y_group=y_group, tile=tile, interpret=True,
            region_cull=True, x_perm=perm,
        )
        return jnp.sum(a * do_f) + jnp.sum(b * dh_f), (do_f, dh_f)

    (_, (jdo, jdh)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))

    before = (CL.KERNEL.launches, CL.CULL_KERNEL.launches)
    xt = _t(x).requires_grad_(True)
    do_f, dh_f = CL.chamfer_dist_loss(xt, _t(n), _t(y), _t(og), _t(hg), _t(vw2),
                                      None if yv is None else _t(yv), y_group=y_group, tile=tile,
                                      region_cull=True, x_perm=perm)
    ((_t(a) * do_f).sum() + (_t(b) * dh_f).sum()).backward()
    assert (CL.KERNEL.launches, CL.CULL_KERNEL.launches) == before  # CPU tensors: plain versions
    np.testing.assert_allclose(do_f.detach().numpy(), np.asarray(jdo), rtol=SUM_RTOL)
    np.testing.assert_allclose(dh_f.detach().numpy(), np.asarray(jdh), rtol=SUM_RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_plain_cull_applies_the_mask():
    """plain_cull skips what the mask skips: on the separated scene (the
    mask culls) it equals the all-pairs plain version bit for bit on live
    frames; an all-invalid cloud gives dh = 0 and a zero gradient row
    (the TPU's hdone), where the all-pairs version gives dh != 0; blocks
    forced off the mask change the result."""
    rng = np.random.default_rng(13)
    F, P1, P2, L, tile = 12, 300, 1024, 4, 256
    x, n, y = _separated_scene(rng, F, P1, P2, 3)
    yv = np.ones((3, P2), bool)
    yv[2] = False
    xv = np.ones(F, bool)
    xv[[1, 6]] = False
    og = (rng.normal(size=(F, P2)) * 0.01).astype(np.float32)
    hg = np.abs(rng.normal(size=(F, P1)) * 0.01).astype(np.float32)
    vw = rng.random(P1).astype(np.float32)
    ops = CL.prepare(_t(x), _t(n), _t(y), _t(og), _t(hg), _t(vw), _t(yv), _t(xv), L)
    mask = CL.region_cull_mask(_t(x), _t(y), _t(yv), tile, L, _t(xv))
    assert 0 < float((mask[_t(xv)] != 0).float().mean()) < 0.8
    got = CL.plain_cull(*ops, mask, L, tile)
    want = CL.plain(*ops, L)
    live = _t(xv) & _t(yv).any(dim=1).repeat_interleave(L)
    for a, b in zip(got, want):
        assert torch.equal(a[live], b[live])
    dead = _t(xv) & ~live  # live frames of the all-invalid cloud
    assert bool(dead.any())
    assert torch.all(got[1][dead] == 0) and torch.all(got[3][dead] == 0) and torch.all(got[0][dead] == 0)
    assert torch.all(want[1][dead] > 0)
    assert all(torch.all(t[~_t(xv)] == 0) for t in got)
    off = mask.clone()
    off[:, :, 0] = 0  # drop the first tile: the rows near it lose their minima
    moved = CL.plain_cull(*ops, off, L, tile)
    assert not torch.equal(moved[1], got[1])


def test_region_cull_degenerate_padded_slot_is_zero_and_finite():
    """The all-zero collate padding through the culled route: zero sums and
    a finite, zero gradient, as the JAX package's test of the same name."""
    F, P1, P2 = 2, 13, 256
    x = torch.zeros((F, P1, 3), requires_grad=True)
    do_f, dh_f = CL.chamfer_dist_loss(
        x, torch.zeros((F, P1, 3)), torch.zeros((F, P2, 3)), torch.zeros((F, P2)),
        torch.zeros((F, P1)), torch.ones(P1), tile=256, region_cull=True,
    )
    v = do_f.sum() + dh_f.sum()
    v.backward()
    assert float(v.detach()) == 0.0
    assert torch.all(torch.isfinite(x.grad)) and torch.all(x.grad == 0)


def _port_extra_loss(dist_impl):
    batch, model_output = _extra_loss_inputs()
    mano = stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    mo = _t(model_output).requires_grad_(True)
    v, terms = LL.interaction_segment_extra_loss(mano, LL.load_contact_assets(), LL.ExtraLossConfig(), mo,
                                                 {k: _t(v) for k, v in batch.items()}, dist_impl=dist_impl)
    v.backward()
    return float(v), mo.grad.numpy()


def test_extra_loss_fused_cull_matches_fused():
    """The port's culled and all-pairs fused routes: the same loss, the rows
    only reordered (tests/test_models.py holds the JAX routes alike; the
    fused_cull route against the JAX one is a case of
    tests/test_torch_dist_loss.py::test_extra_loss_matches_jax)."""
    v_cull, g_cull = _port_extra_loss("fused_cull")
    v_fused, g_fused = _port_extra_loss("fused")
    np.testing.assert_allclose(v_cull, v_fused, rtol=LOSS_RTOL)
    np.testing.assert_allclose(g_cull, g_fused, rtol=LOSS_GRAD_RTOL, atol=LOSS_GRAD_ATOL)


def test_g_train_step_matches_jax_fused_cull(monkeypatch):
    """One whole G train step on dist_impl="fused_cull", port on the CPU
    against the JAX package's make_g_train_step(mesh=None) with the culled
    kernel in interpret mode: the same weights, batch, timesteps and (JAX's
    own) q_sample noise; loss terms rtol 1e-4, gradients rtol 2e-3 / atol
    1e-6 (tests/test_torch_train_g.py's bounds for the composed step)."""
    jextra = JLL.interaction_segment_extra_loss
    monkeypatch.setattr(JLL, "interaction_segment_extra_loss",
                        lambda *a, **k: jextra(*a, **k, interpret=True))
    rng = np.random.default_rng(3)
    batch = synthetic_batch(rng, batch_size=2, seq_len=8, max_nobj=2, n_obj_points=64, min_len=5, as_jax=False)
    batch["t"] = np.array([3, 41], np.int32)
    batch["t_weights"] = np.array([1.0, 0.5], np.float32)
    jmodel = JMDM.InteractionSegmentMDM(JMDM.MDMConfig(**SMALL))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), batch["pose_repr"],
                                                  np.zeros((2,), np.int32), JPT.g_cond_from_batch(batch)))
    jmano = j_stack_mano_models(JM.synthetic_mano_model("right"), JM.synthetic_mano_model("left"))
    # an optimizer that returns zero updates and keeps the gradients as its state
    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u)
    )
    jstep = JPT.make_g_train_step(jmodel, JD.tamf_schedule(50), capture, jmano, JLL.load_contact_assets(),
                                  JLL.ExtraLossConfig(), chunk=64, mesh=None, dist_impl="fused_cull")
    key = jax.random.PRNGKey(5)
    jstate, jmetrics = jstep(JPT.init_train_state(jax.tree.map(jnp.asarray, params), capture),
                             {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jclipped, _ = JPT.per_param_clip(0.1).update(jstate.opt_state, None)
    noise = np.asarray(jax.random.normal(jax.random.split(key, 4)[1], batch["pose_repr"].shape, jnp.float32))

    model = MDM.InteractionSegmentMDM(MDM.MDMConfig(**SMALL))
    model.load_state_dict(from_jax.g_state_dict_from_flax(params))
    state = PT.TrainState(model, PT.make_optimizer(model.named_parameters()))
    mano = stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    step = PT.make_g_train_step(D.tamf_schedule(50), mano, LL.load_contact_assets(),
                                LL.ExtraLossConfig(), chunk=64, dist_impl="fused_cull")
    calls = []
    plain_cull = CL.plain_cull
    monkeypatch.setattr(CL, "plain_cull", lambda *a: calls.append(1) or plain_cull(*a))
    metrics = step(state, {k: _t(v) for k, v in batch.items()}, noise=_t(noise))
    assert state.step == 1 and len(calls) == 1
    for k in ("loss", "diffusion_loss", "extra/dist_o", "extra/dist_h", "extra/rec_vert"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    want = {k: v.numpy() for k, v in
            from_jax.g_state_dict_from_flax(jax.tree.map(np.asarray, jclipped)).items()}
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(grads) == set(want)
    for k in grads:
        np.testing.assert_allclose(grads[k], want[k], rtol=2e-3, atol=1e-6, err_msg=k)


def test_train_g_main_cpu_smoke_fused_cull(tmp_path, monkeypatch):
    """The entry point on the CPU with --train.dist_impl fused_cull: two
    epochs of the smoke config through the culled route's plain version."""
    monkeypatch.chdir(tmp_path)
    calls = []
    plain_cull = CL.plain_cull
    monkeypatch.setattr(CL, "plain_cull", lambda *a: calls.append(a[-1]) or plain_cull(*a))
    before = (CL.KERNEL.launches, CL.CULL_KERNEL.launches)
    state = train_g.main(["--cfg", os.path.join(REPO, "config/synthetic_smoke.yml"), "--runtime.device", "cpu",
                          "--exp_id", "smoke_cull", "--train.dist_impl", "fused_cull"])
    assert state.step == 4
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    # one culled pass per step, its mask tiled at _clamp_tile(train.chunk, P)
    assert calls == [G._clamp_tile(2048, 128)] * 4
    assert (CL.KERNEL.launches, CL.CULL_KERNEL.launches) == before
