"""The port's fused distance loss (oakink2_tamf_tpu_torch.ops.chamfer_loss)
and G's extra loss (models/losses.py) against the JAX package on the CPU:
`chamfer_dist_loss` in Pallas interpret mode with sel_impl="mxu" (the
all-HIGHEST oracle; the default "mxu2" rounds its select at ~2^-17), and
`interaction_segment_extra_loss` on both dist routes.

Tolerances are the JAX package's own for these functions
(tests/test_chamfer_loss.py): per-frame sums rtol 2e-4, x-gradients rtol
2e-3 / atol 1e-4; the whole extra loss rtol 1e-4, its gradient with respect
to the model output rtol 2e-3 / atol 1e-5. The port differs from the TPU in
its distance formulation (direct differences, not the expansion) and in
summation order; a near-tie can also move an o2h argmin to a row with
another normal and flip that column's sign and weight (chamfer_loss.py:14-21).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oakink2_tamf_tpu.core import geometry as JG
from oakink2_tamf_tpu.core import mano as JM
from oakink2_tamf_tpu.models import losses as JLL
from oakink2_tamf_tpu.models.refine_r import stack_mano_models as j_stack_mano_models
from oakink2_tamf_tpu.ops import chamfer_loss as JCL
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.models import losses as LL
from oakink2_tamf_tpu_torch.models.refine_r import stack_mano_models
from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL

SUM_RTOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-4
LOSS_RTOL = 1e-4
LOSS_GRAD_RTOL, LOSS_GRAD_ATOL = 2e-3, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(rng, F, P1, P2, G, scale=0.02):
    """Hand-scale scene whose distances straddle the 5 mm / 10 mm band
    thresholds, with GT fields from an independent nearby hand pose over
    the same clouds (JAX XLA route)."""
    x = (rng.normal(size=(F, P1, 3)) * scale).astype(np.float32)
    n = rng.normal(size=(F, P1, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    y = (rng.normal(size=(G, P2, 3)) * scale + 0.005).astype(np.float32)
    xg = x + (rng.normal(size=x.shape) * 0.01).astype(np.float32)
    og, hg, _ = JG.point2point_signed(
        jnp.asarray(xg), jnp.asarray(np.repeat(y, F // G, axis=0)), x_normals=jnp.asarray(n),
        backend="xla", chunk=512, grad_y=False,
    )
    vw2 = rng.random(P1).astype(np.float32)
    return x, n, y, np.asarray(og), np.asarray(hg), vw2


@pytest.mark.parametrize("F,P1,P2,y_group", [(4, 13, 300, 1), (8, 13, 1100, 4), (4, 778, 700, 2)])
def test_plain_matches_pallas_interpret_values_and_grads(F, P1, P2, y_group):
    rng = np.random.default_rng(0)
    x, n, y, og, hg, vw2 = _scene(rng, F, P1, P2, F // y_group)
    a = rng.normal(size=F).astype(np.float32)
    b = rng.normal(size=F).astype(np.float32)

    def jloss(xx):
        do_f, dh_f = JCL.chamfer_dist_loss(
            xx, jnp.asarray(n), jnp.asarray(y), jnp.asarray(og), jnp.asarray(hg), jnp.asarray(vw2),
            y_group=y_group, tile=512, interpret=True, sel_impl="mxu",
        )
        return jnp.sum(a * do_f) + jnp.sum(b * dh_f), (do_f, dh_f)

    (_, (jdo, jdh)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))

    before = CL.KERNEL.launches
    xt = _t(x).requires_grad_(True)
    do_f, dh_f = CL.chamfer_dist_loss(xt, _t(n), _t(y), _t(og), _t(hg), _t(vw2), y_group=y_group)
    ((_t(a) * do_f).sum() + (_t(b) * dh_f).sum()).backward()
    assert CL.KERNEL.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(do_f.detach().numpy(), np.asarray(jdo), rtol=SUM_RTOL)
    np.testing.assert_allclose(dh_f.detach().numpy(), np.asarray(jdh), rtol=SUM_RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_x_valid_frames_are_zero_and_others_unchanged():
    rng = np.random.default_rng(1)
    F, P1, P2, L = 8, 13, 600, 4
    x, n, y, og, hg, vw2 = _scene(rng, F, P1, P2, F // L)
    xv = np.array([True, False, True, True, False, False, True, True])
    args = (_t(n), _t(y), _t(og), _t(hg), _t(vw2))
    x1 = _t(x).requires_grad_(True)
    do1, dh1 = CL.chamfer_dist_loss(x1, *args, y_group=L, x_valid=_t(xv))
    (do1.sum() + dh1.sum()).backward()
    x2 = _t(x).requires_grad_(True)
    do2, dh2 = CL.chamfer_dist_loss(x2, *args, y_group=L)
    (do2.sum() + dh2.sum()).backward()
    assert torch.all(do1[~_t(xv)] == 0) and torch.all(dh1[~_t(xv)] == 0)
    assert torch.all(x1.grad[~_t(xv)] == 0)
    assert torch.equal(do1[_t(xv)], do2[_t(xv)]) and torch.equal(dh1[_t(xv)], dh2[_t(xv)])
    assert torch.equal(x1.grad[_t(xv)], x2.grad[_t(xv)])
    # the JAX kernel zeroes the same frames
    jdo, jdh = JCL.chamfer_dist_loss(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(y), jnp.asarray(og), jnp.asarray(hg),
        jnp.asarray(vw2), y_group=L, tile=512, interpret=True, sel_impl="mxu", x_valid=jnp.asarray(xv),
    )
    np.testing.assert_allclose(do1.detach().numpy(), np.asarray(jdo), rtol=SUM_RTOL)
    np.testing.assert_allclose(dh1.detach().numpy(), np.asarray(jdh), rtol=SUM_RTOL)


def test_fused_degenerate_padded_slot_is_zero_and_finite():
    """A fully padded object slot (x = 0 from R = 0, t = 0; zero cloud; zero
    GT fields): exactly 0 with finite, zero gradients (the max(dist, 1e-12)
    guards), as the JAX package's test of the same name requires."""
    F, P1, P2 = 2, 13, 256
    x = torch.zeros((F, P1, 3), requires_grad=True)
    do_f, dh_f = CL.chamfer_dist_loss(
        x, torch.zeros((F, P1, 3)), torch.zeros((F, P2, 3)), torch.zeros((F, P2)),
        torch.zeros((F, P1)), torch.ones(P1),
    )
    v = do_f.sum() + dh_f.sum()
    v.backward()
    assert float(v.detach()) == 0.0
    assert torch.all(torch.isfinite(x.grad)) and torch.all(x.grad == 0)


def test_y_valid_masks_points():
    rng = np.random.default_rng(2)
    F, P1, P2 = 4, 13, 700
    x, n, y, og, hg, vw2 = _scene(rng, F, P1, P2, F)
    yv = rng.random((F, P2)) > 0.3
    jdo, jdh = JCL.chamfer_dist_loss(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(y), jnp.asarray(og), jnp.asarray(hg),
        jnp.asarray(vw2), jnp.asarray(yv), tile=512, interpret=True, sel_impl="mxu",
    )
    do_f, dh_f = CL.chamfer_dist_loss(_t(x), _t(n), _t(y), _t(og), _t(hg), _t(vw2), _t(yv))
    np.testing.assert_allclose(do_f.numpy(), np.asarray(jdo), rtol=SUM_RTOL)
    np.testing.assert_allclose(dh_f.numpy(), np.asarray(jdh), rtol=SUM_RTOL)


def _extra_loss_inputs():
    rng = np.random.default_rng(3)
    BS, NOBJ, L, P = 2, 2, 4, 256
    batch = {
        "pose_repr": rng.normal(size=(BS, L, 99)).astype(np.float32),
        "shape": rng.normal(size=(BS, L, 10)).astype(np.float32),
        "hand_side": np.array([0, 1], np.int32),
        "obj_traj": rng.normal(size=(BS, NOBJ, L, 9)).astype(np.float32),
        "obj_mask": np.array([[True, False], [True, True]]),
        "obj_points": rng.normal(size=(BS, NOBJ, P, 3)).astype(np.float32),
        "mask": (rng.random((BS, L)) > 0.2).astype(np.float32),
    }
    batch["obj_points"][0, 1] = 0.0  # the padded slot's cloud, as collate pads it
    batch["obj_traj"][0, 1] = 0.0
    model_output = rng.normal(size=(BS, L, 99)).astype(np.float32)
    return batch, model_output


@pytest.mark.parametrize("dist_impl", ["fused", "composed", "fused_cull"])
def test_extra_loss_matches_jax(dist_impl):
    """interaction_segment_extra_loss, value and gradient with respect to the
    model output, against the JAX function on the same route (fused and
    fused_cull in interpret mode; both packages permute the rows by the same
    template permutation and tile the mask at 512 points), with masked
    frames and a padded object slot."""
    batch, model_output = _extra_loss_inputs()
    j_mano = j_stack_mano_models(JM.synthetic_mano_model("right"), JM.synthetic_mano_model("left"))
    j_assets = JLL.load_contact_assets()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jf(mo):
        return JLL.interaction_segment_extra_loss(
            j_mano, j_assets, JLL.ExtraLossConfig(), mo, jb, chunk=256,
            dist_impl=dist_impl, interpret=True,
        )

    (jv, jterms), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(model_output))

    mano = stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    assets = LL.load_contact_assets()
    np.testing.assert_array_equal(assets.vpe.numpy(), np.asarray(j_assets.vpe))
    np.testing.assert_array_equal(assets.v_weights2.numpy(), np.asarray(j_assets.v_weights2))
    tb = {k: _t(v) for k, v in batch.items()}
    mo = _t(model_output).requires_grad_(True)
    v, terms = LL.interaction_segment_extra_loss(mano, assets, LL.ExtraLossConfig(), mo, tb,
                                                 dist_impl=dist_impl)
    v.backward()
    for k in ("rec_joint", "rec_vert", "edge_len", "dist_h", "dist_o", "loss"):
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(mo.grad.numpy(), np.asarray(jg), rtol=LOSS_GRAD_RTOL, atol=LOSS_GRAD_ATOL)


def test_extra_loss_fused_matches_composed():
    """The port's two routes: the same math in another summation order."""
    batch, model_output = _extra_loss_inputs()
    mano = stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    assets = LL.load_contact_assets()
    tb = {k: _t(v) for k, v in batch.items()}
    out = {}
    for impl in ("fused", "composed"):
        mo = _t(model_output).requires_grad_(True)
        v, _ = LL.interaction_segment_extra_loss(mano, assets, LL.ExtraLossConfig(), mo, tb, dist_impl=impl)
        v.backward()
        out[impl] = (float(v), mo.grad.numpy())
    np.testing.assert_allclose(out["fused"][0], out["composed"][0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["fused"][1], out["composed"][1], rtol=LOSS_GRAD_RTOL, atol=LOSS_GRAD_ATOL)
