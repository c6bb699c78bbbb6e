"""The port's differentiable h2o route (ops.chamfer_nn.h2o_nn_dvec,
ops.chamfer_cull.h2o_cull_dvec, ops.chamfer_h2o_bwd and
core.geometry.point2point_h2o under autograd) against the JAX kernels and
VJPs it replaces, run as the JAX package's own tests run them on the CPU
(Pallas interpret mode).

Tolerances:
- distances rtol 1e-5 / atol 1e-6 (metres): the TPU kernels form
  ||x-y||^2 by expansion, the port by direct differences; after centring
  both are within this bound (the h2o slice's bound);
- dvec atol 1e-6 on live rows: both are x - y* of centred coordinates at
  the same first minimum (the centre is a mean, summed in another order);
  rows of all-invalid clouds or culled frames are arbitrary on the TPU and
  0 in the port, and are compared where the port defines them;
- the backward (#5) on identical argmins and cotangent rows as the TPU's
  `_nn_h2o_backward`: rtol 1e-5 / atol 1e-7 (the same products; gy sums
  in another order);
- gradients end to end vs jax.grad: rtol 1e-4 / atol 1e-6 plus the TPU
  distances' own error: its expanded ||x-y||^2 carries up to ~4e-10 m^2 of
  absolute error at these scales, and a term c (x-y)/d inherits
  |c| D2_ERR / (2 d^2) of it, with D2_ERR = 1e-9 m^2 (PR 2's bound).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oakink2_tamf_tpu.core import geometry as JG
from oakink2_tamf_tpu.ops import chamfer_cull as JCU
from oakink2_tamf_tpu.ops import chamfer_pallas as JCP
from oakink2_tamf_tpu_torch.core import geometry as TG
from oakink2_tamf_tpu_torch.core.mano import hand_template_perm, synthetic_mano_model
from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
from oakink2_tamf_tpu_torch.ops import chamfer_h2o_bwd as HB
from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

RTOL, ATOL = 1e-5, 1e-6
DVEC_ATOL = 1e-6
BWD_RTOL, BWD_ATOL = 1e-5, 1e-7
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
D2_ERR = 1e-9


def _scene(seed, F=4, P1=778, P2=640, y_group=2, ragged=True, all_invalid=True):
    """Hand-like 128-row clusters near an object cloud; group 0 ragged, the
    last group all-invalid (a padded object slot)."""
    rng = np.random.default_rng(seed)
    G = F // y_group
    y = (rng.normal(size=(G, P2, 3)) * 0.05).astype(np.float32)
    centers = rng.normal(size=(F, (P1 + 127) // 128, 3)) * 0.05
    x = (centers[:, np.arange(P1) // 128] + rng.normal(size=(F, P1, 3)) * 0.01).astype(np.float32)
    yv = np.ones((G, P2), bool)
    if ragged:
        yv[0, P2 // 3:] = False
    if all_invalid and G > 1:
        yv[-1] = False
    return x, y, yv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dist(d2):
    return np.sqrt(np.maximum(np.asarray(d2, np.float64), 0.0))


def _dvec_jax(dvec, P1):
    """The TPU layout [F, 3, P1p] -> [F, P1, 3]."""
    return np.swapaxes(np.asarray(dvec), 1, 2)[:, :P1]


@pytest.mark.parametrize("y_group", [1, 2])
def test_plain_dvec_matches_nn_h2o_dvec_forward_interpret(y_group):
    x, y, yv = _scene(0, y_group=y_group, all_invalid=y_group > 1)
    jd, jdvec = JCP._nn_h2o_dvec_forward(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv), 512, True, y_group)
    before = NN.DVEC_KERNEL.launches
    d2, dvec = NN.h2o_nn_dvec(_t(x), _t(y), _t(yv), y_group)
    assert NN.DVEC_KERNEL.launches == before  # CPU tensors: the plain version
    live = np.repeat(yv.any(1), y_group)
    np.testing.assert_allclose(_dist(d2)[live], _dist(jd)[live], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dvec.numpy()[live], _dvec_jax(jdvec, 778)[live], rtol=0, atol=DVEC_ATOL)
    # the same minimum as the forward-only kernel #1, bit for bit
    d2_1, idx = NN.h2o_nn(_t(x), _t(y), _t(yv), y_group)
    assert torch.equal(d2, d2_1)
    # an all-invalid cloud: BIG, and dvec 0 (never the offset to a FAR point)
    assert np.all(d2.numpy()[~live] == np.float32(NN.BIG))
    assert np.all(dvec.numpy()[~live] == 0.0)


def test_plain_cull_dvec_matches_cull_forward_interpret():
    x, y, yv = _scene(1, F=6, P2=1024, y_group=3)
    xv = np.array([True, False, True, True, True, False])
    jd, jdvec = JCU._cull_forward(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv), jnp.asarray(xv),
                                  512, True, 3, True)
    before = CU.DVEC_KERNEL.launches
    d2, dvec = CU.h2o_cull_dvec(_t(x), _t(y), _t(yv), tile=512, y_group=3, x_valid=_t(xv))
    assert CU.DVEC_KERNEL.launches == before
    live = np.repeat(yv.any(1), 3) & xv
    np.testing.assert_allclose(_dist(d2)[live], _dist(jd)[live], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dvec.numpy()[live], _dvec_jax(jdvec, 778)[live], rtol=0, atol=DVEC_ATOL)
    # culled frames and all-invalid clouds: BIG with dvec 0
    assert np.all(d2.numpy()[~live] == np.float32(CU.BIG))
    assert np.all(dvec.numpy()[~live] == 0.0)
    # values equal the forward-only culled kernel's; dvec equals the
    # all-pairs dvec on live frames (the culled tiles hold no minimum)
    assert torch.equal(d2, CU.h2o_cull(_t(x), _t(y), _t(yv), tile=512, y_group=3, x_valid=_t(xv)))
    _, dvec_all = NN.h2o_nn_dvec(_t(x), _t(y), _t(yv), 3)
    assert torch.equal(dvec[live], dvec_all[live])


@pytest.mark.parametrize("grad_y,y_group", [(True, 1), (False, 1), (False, 2)])
def test_backward_plain_matches_nn_h2o_backward_interpret(grad_y, y_group):
    """#5's plain version on the same first-min indices and cotangent rows
    as the TPU's `_nn_h2o_backward` (both variants)."""
    x, y, yv = _scene(2, F=4, P2=600, y_group=y_group, all_invalid=y_group > 1)
    _, idx = NN.h2o_nn(_t(x), _t(y), _t(yv), y_group)
    xr = (np.random.default_rng(3).normal(size=(4, 778)) * 10).astype(np.float32)
    xr[:, ::5] = 0.0  # zero cotangents contribute nothing
    jgx, jgy = JCP._nn_h2o_backward(jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx.numpy()),
                                    jnp.asarray(xr), 512, True, grad_y, y_group)
    before = HB.KERNEL.launches
    gx, gy = HB.h2o_backward(_t(x), _t(y), idx, _t(xr), grad_y=grad_y, y_group=y_group)
    assert HB.KERNEL.launches == before
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=BWD_RTOL, atol=BWD_ATOL)
    if grad_y:
        np.testing.assert_allclose(gy.numpy(), np.asarray(jgy), rtol=BWD_RTOL, atol=BWD_ATOL)
    else:
        assert gy is None and jgy is None


def test_backward_shared_cloud_requires_grad_y_false():
    x, y, yv = _scene(2, F=4, P2=64, y_group=2)
    _, idx = NN.h2o_nn(_t(x), _t(y), _t(yv), 2)
    with pytest.raises(NotImplementedError):
        HB.h2o_backward(_t(x), _t(y), idx, torch.ones(4, 778), grad_y=True, y_group=2)


def _assert_close_with_err(got, want, err):
    """|got - want| <= atol + rtol |want| + err (err per row [F, P1])."""
    bound = GRAD_ATOL + GRAD_RTOL * np.abs(want) + err[..., None]
    over = np.abs(got - want) > bound
    assert not over.any(), (np.argwhere(over)[:5], got[over][:5], want[over][:5])


def _row_err(w, d2, live):
    """Each row's share of the TPU distances' error: |w| D2_ERR / (2 d^2)."""
    return np.where(live[:, None], np.abs(w) * D2_ERR / (2 * np.maximum(d2, 1e-30)), 0.0)


ROUTES = [
    # (port backend, P2, y_group, grad_y, x_perm, x_valid): the culled route
    # through "auto" at CULL_MIN_P2 and forced below it, the all-pairs
    # route through "auto" and "exact", and the grad_y route
    ("auto", 4096, 2, False, True, True),
    ("cull", 1024, 2, False, True, False),
    ("auto", 640, 2, False, False, False),
    ("exact", 4096, 2, False, False, False),
    ("auto", 640, 1, True, False, False),
]


@pytest.mark.parametrize("backend,P2,y_group,grad_y,use_perm,use_xv", ROUTES)
def test_autograd_matches_jax_grad(backend, P2, y_group, grad_y, use_perm, use_xv):
    """torch.autograd.grad of point2point_h2o vs jax.grad of the JAX route
    it replaces (interpret mode): `_cull_core` for the culled route,
    `point2point_h2o_pallas` for the all-pairs and grad_y routes."""
    F = 4
    x, y, yv = _scene(5, F=F, P2=P2, y_group=y_group, all_invalid=y_group > 1)
    w = np.random.default_rng(6).normal(size=(F, 778)).astype(np.float32)
    perm = hand_template_perm(synthetic_mano_model("right").v_template) if use_perm else None
    xv = np.array([True, False, True, True]) if use_xv else None
    cull = backend == "cull" or (backend == "auto" and not grad_y and P2 >= TG.CULL_MIN_P2)

    def jloss(xx, yy):
        if cull:
            d = JG.point2point_h2o(xx, yy, jnp.asarray(yv), backend="cull", x_perm=perm, grad_y=False,
                                   y_group=y_group, x_valid=None if xv is None else jnp.asarray(xv),
                                   interpret=True)
        else:
            d = JCP.point2point_h2o_pallas(xx, yy, jnp.asarray(yv), tile=512, interpret=True,
                                           grad_y=grad_y, y_group=y_group)
        return jnp.sum(jnp.asarray(w) * jnp.where(jnp.isfinite(d) & (d < 1e10), d, 0.0))

    jgx, jgy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))

    xt = _t(x).requires_grad_(True)
    yt = _t(y).requires_grad_(grad_y)
    before = (NN.DVEC_KERNEL.launches, CU.DVEC_KERNEL.launches, HB.KERNEL.launches)
    d = TG.point2point_h2o(xt, yt, _t(yv), backend=backend, x_perm=perm, grad_y=grad_y,
                           y_group=y_group, x_valid=None if xv is None else _t(xv))
    assert d.requires_grad
    tv = (_t(w) * torch.where(d < 1e10, d, 0.0)).sum()
    gx, *gy = torch.autograd.grad(tv, [xt, yt] if grad_y else [xt])
    assert (NN.DVEC_KERNEL.launches, CU.DVEC_KERNEL.launches, HB.KERNEL.launches) == before

    d2, idx = NN.h2o_nn(_t(x), _t(y), _t(yv), y_group)
    live = np.repeat(yv.any(1), y_group)
    if xv is not None and cull:
        live &= xv
    err = _row_err(w, d2.numpy(), live)
    _assert_close_with_err(gx.numpy(), np.asarray(jgx), err)
    # rows that took no point get no gradient at all
    assert np.all(gx.numpy()[~np.repeat(yv.any(1), y_group)] == 0.0)
    if grad_y:
        err_y = np.zeros(y.shape[:2])
        np.add.at(err_y, (np.broadcast_to(np.arange(F)[:, None], idx.shape), idx.numpy()), err)
        _assert_close_with_err(gy[0].numpy(), np.asarray(jgy), err_y)
    else:
        np.testing.assert_array_equal(np.asarray(jgy), 0.0)


def test_autograd_matches_gather_formulation():
    """Both backward formulas equal torch autograd through the gather
    formulation with the argmin held constant: dist = ||x - y[idx]||."""
    x, y, _ = _scene(7, F=2, P1=300, P2=200, y_group=1, ragged=False, all_invalid=False)
    _, idx = NN.h2o_nn(_t(x), _t(y), None, 1)
    w = _t(np.random.default_rng(8).normal(size=(2, 300)).astype(np.float32))
    xg, yg = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    y_at = torch.gather(yg, 1, idx.long()[..., None].expand(2, 300, 3))
    (w * (xg - y_at).norm(dim=-1)).sum().backward()
    for grad_y in (False, True):
        xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(grad_y)
        (w * TG.point2point_h2o(xt, yt, grad_y=grad_y, backend="exact")).sum().backward()
        torch.testing.assert_close(xt.grad, xg.grad, rtol=1e-5, atol=1e-6)
        if grad_y:
            torch.testing.assert_close(yt.grad, yg.grad, rtol=1e-5, atol=1e-6)


def test_forward_only_without_grad_launches_no_dvec_kernel():
    """Without autograd (serving, the target and sample geometry) the
    forward-only kernels run: the result carries no graph."""
    x, y, yv = _scene(9, F=2, P2=256, y_group=2, all_invalid=False)
    xt = _t(x).requires_grad_(True)
    with torch.no_grad():
        d = TG.point2point_h2o(xt, _t(y), _t(yv), grad_y=False, y_group=2)
    assert not d.requires_grad
    d2 = TG.point2point_h2o(_t(x), _t(y), _t(yv), grad_y=False, y_group=2)
    assert not d2.requires_grad and torch.equal(d, d2)
