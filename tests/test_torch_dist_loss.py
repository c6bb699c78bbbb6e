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


def _tie_scene(seed, F=4, P1=300, P2=4200, y_group=2):
    """Minima that tie exactly in both directions, at the seams of the
    bidirectional kernel (256 threads x 4 columns per pass, rows in groups
    of 8): every 7th point has an exact copy at +1, +32, +256, +1024, +2048
    or +4096; rows i + 128 copy rows i in alternate 128-row blocks, every
    16th row is copied to the next one and every 32nd to the one 8 on
    (the next group). Each row keeps its own normal, so which of two equal rows
    wins a column shows in its sign (v) and in the row gx_do lands on. Two
    equal points give a row the same dh and gx_dh whichever wins, so the
    h2o tie shows only through the search itself. GT fields of hand scale,
    every 3rd frame x_valid=False."""
    rng = np.random.default_rng(seed)
    y = rng.normal(scale=0.05, size=(F // y_group, P2, 3))
    for k, off in enumerate((1, 32, 256, 1024, 2048, 4096)):
        j = np.arange(k, max(P2 - off, 0), 7)
        y[:, j + off] = y[:, j]
    x = rng.normal(scale=0.03, size=(F, P1, 3)) + rng.normal(scale=0.02, size=(F, 1, 3))
    i = np.arange(max(P1 - 128, 0))
    i = i[(i // 128) % 2 == 0]
    x[:, i + 128] = x[:, i]
    i = np.arange(5, P1 - 1, 16)
    x[:, i + 1] = x[:, i]
    i = np.arange(2, P1 - 8, 32)
    x[:, i + 8] = x[:, i]
    n = rng.normal(size=(F, P1, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    og = rng.normal(size=(F, P2)) * 0.01
    hg = np.abs(rng.normal(size=(F, P1))) * 0.01
    xv = np.arange(F) % 3 != 0
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(x), f32(n), f32(y), f32(og), f32(hg), f32(rng.random(P1)), xv


def _fma3_np(a0, b0, a1, b1, a2, b2):
    s = (a0 * b0).astype(np.float64)
    s = (a1.astype(np.float64) * b1 + s).astype(np.float32).astype(np.float64)
    return (a2.astype(np.float64) * b2 + s).astype(np.float32)


def _loss_reference(x, n, y4, ctr, og, hg, vw, xv, y_group):
    """(v, dh, gx_do, gx_dh) in numpy on prepared operands: the pinned pair
    arithmetic, np.argmin (the first minimum) both ways, the kernels'
    per-point formulas in float32 (gx_do summed in float64); and the rows
    that copy an earlier row, which can never be a column's first minimum."""
    F, P1, _ = x.shape
    xc = x - np.repeat(ctr, y_group, axis=0)[:, None, :]
    yf = np.repeat(y4[..., :3], y_group, axis=0)
    d = xc[:, :, None, :] - yf[:, None, :, :]
    d2 = _fma3_np(d[..., 0], d[..., 0], d[..., 1], d[..., 1], d[..., 2], d[..., 2])
    frames = np.arange(F)[:, None]
    i_o, j_h = np.argmin(d2, axis=1), np.argmin(d2, axis=2)
    dist = np.sqrt(d2.min(axis=1))
    dy = yf - xc[frames, i_o]
    nr = n[frames, i_o]
    sgn = np.sign(_fma3_np(nr[..., 0], dy[..., 0], nr[..., 1], dy[..., 1], nr[..., 2], dy[..., 2]))
    o = dist * sgn
    w = np.where(o < 0, np.float32(1.5), np.where((og < 0.01) & (og > -0.005), np.float32(1.0), np.float32(0.1)))
    diff = o - og
    v = np.abs(diff) * w
    coef = w * np.sign(diff) * sgn / np.maximum(dist, np.float32(1e-12))
    gx_do = np.zeros((F, P1, 3))
    np.add.at(gx_do, (np.broadcast_to(frames, i_o.shape), i_o), coef[..., None] * -dy)
    hd = np.sqrt(d2.min(axis=2))
    dh = np.abs(hd - np.abs(hg)) * vw
    cfh = vw * np.sign(hd - np.abs(hg)) / np.maximum(hd, np.float32(1e-12))
    gx_dh = cfh[..., None] * (xc - yf[frames, j_h])
    live = xv.astype(bool)
    out = [np.where(live[:, None], v, 0), np.where(live[:, None], dh, 0),
           np.where(live[:, None, None], gx_do, 0), np.where(live[:, None, None], gx_dh, 0)]
    later_copy = np.zeros((F, P1), bool)
    for f in range(F):
        _, first = np.unique(x[f], axis=0, return_index=True)
        later_copy[f] = True
        later_copy[f, first] = False
    o2h_ties = (((d2 == d2.min(axis=1, keepdims=True)).sum(axis=1) > 1) & live[:, None]).sum()
    return out, later_copy & live[:, None], o2h_ties


def _assert_loss_reference(got, want, later_copy):
    v, dh, gx_do, gx_dh = (t.cpu().numpy() for t in got)
    np.testing.assert_allclose(v, want[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dh, want[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gx_dh, want[3], rtol=1e-6, atol=1e-7)
    err = np.linalg.norm((gx_do - want[2]).reshape(len(v), -1), axis=1)
    assert np.all(err <= 1e-5 * np.linalg.norm(want[2].reshape(len(v), -1), axis=1) + 1e-6), err
    assert np.all(gx_do[later_copy] == 0)  # no column's first minimum is a later copy


@pytest.mark.parametrize("chunk_points", [None, 100])
def test_plain_takes_the_first_minimum_on_exact_ties(monkeypatch, chunk_points):
    """The plain loss against a numpy reference built on np.argmin, on
    _tie_scene: a column whose nearest rows tie takes the first one's sign
    and sends its gradient row there; across the plain search's chunks of
    points too (chunk_points=100)."""
    x, n, y, og, hg, vw, xv = _tie_scene(8)
    if chunk_points is not None:
        monkeypatch.setattr(CL.NN, "_PLAIN_CHUNK_ELEMS", x.shape[0] * x.shape[1] * 3 * chunk_points)
    ops = CL.prepare(_t(x), _t(n), _t(y), _t(og), _t(hg), _t(vw), None, _t(xv), 2)
    want, later_copy, o2h_ties = _loss_reference(*(t.numpy() for t in ops), 2)
    assert o2h_ties > 100  # live columns whose nearest rows tie
    _assert_loss_reference(CL.plain(*ops, 2), want, later_copy)


@pytest.mark.cuda
def test_cuda_kernel_takes_the_first_minimum_on_exact_ties():
    """The kernel on _tie_scene against the same numpy reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    x, n, y, og, hg, vw, xv = _tie_scene(8)
    ops = CL.prepare(*(_t(a).cuda() for a in (x, n, y, og, hg, vw)), None, _t(xv).cuda(), 2)
    want, later_copy, _ = _loss_reference(*(t.cpu().numpy() for t in ops), 2)
    _assert_loss_reference(CL.launch(*ops, 2), want, later_copy)
