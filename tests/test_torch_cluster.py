"""The port's cluster-pruned chamfer (oakink2_tamf_tpu_torch.ops.
chamfer_cluster and the backend="cluster" routes of core.geometry) against
the JAX module it replaces, oakink2_tamf_tpu/ops/chamfer_cluster.py, run as
the JAX package's own tests run it on the CPU (Pallas interpret mode), and
its selection stage against the JAX stage (XLA).

Tolerances:
- distances rtol 1e-5 / atol 1e-6 (metres): the TPU kernels form
  ||x-y||^2 by expansion, the port by direct differences; after centring
  both are within this bound (the h2o slice's bound);
- candidate sets and overflow counts equal: both stages evaluate the same
  formula on the same centred operands;
- where the certificate is clear the port's values equal its own exact
  all-pairs search (ops/chamfer_nn) bit for bit: both go through one
  per-pair function, and the candidate cells hold every nearest point;
- gradients end to end vs jax.grad: rtol 1e-4 / atol 1e-6 plus the TPU
  distances' own error, |cotangent| D2_ERR / (2 d^2) per pair with
  D2_ERR = 1e-9 m^2 (tests/test_torch_h2o_grad.py's bound);
- the signed pair's o2h indices may differ on near-ties, which the two
  formulations break differently: they are compared through the distance
  they select, at the distance tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oakink2_tamf_tpu.core import geometry as JG
from oakink2_tamf_tpu.ops import chamfer_cluster as JC
from oakink2_tamf_tpu_torch.core import geometry as TG
from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS
from oakink2_tamf_tpu_torch.utils.pc_util import spatial_sort_indices

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
D2_ERR = 1e-9


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scene(F=2, P1=200, P2=700, seed=0, spread=0.2):
    """tests/test_chamfer_cluster.py's scene: x and a loose cloud, 15% of
    the points invalid."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(F, P1, 3)) * 0.1).astype(np.float32)
    y = (rng.normal(size=(F, P2, 3)) * spread + rng.normal(size=(F, 1, 3)) * 0.1).astype(np.float32)
    yv = rng.random((F, P2)) > 0.15
    return x, y, yv


def _hand_scene(F=2, P1=140, P2=500, seed=0):
    """Hand-scale rows (128-row clusters, 1 cm spread) near a 5 cm cloud,
    15% of the points invalid: the scale at which D2_ERR bounds the TPU
    kernels' expanded distances (tests/test_torch_h2o_grad.py's scene)."""
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=(F, P2, 3)) * 0.05).astype(np.float32)
    centers = rng.normal(size=(F, (P1 + 127) // 128, 3)) * 0.05
    x = (centers[:, np.arange(P1) // 128] + rng.normal(size=(F, P1, 3)) * 0.01).astype(np.float32)
    return x, y, rng.random((F, P2)) > 0.15


def _grasp_scene(F=2, P1=256, P2=1024, seed=13):
    """A compact x blob just outside a spatially sorted object surface (the
    JAX suite's grasp scene at P2 = 1024)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(P2, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    obj = (v * 0.08 * (1 + 0.2 * rng.random((P2, 1)))).astype(np.float32)
    obj = obj[spatial_sort_indices(obj)]
    y = obj[None].repeat(F, 0) + rng.normal(scale=0.02, size=(F, 1, 3)).astype(np.float32)
    x = (y[:, :1] * 1.1 + rng.normal(scale=0.012, size=(F, P1, 3))).astype(np.float32)
    return x, y, np.ones((F, P2), bool)


def _normals(x, seed):
    n = np.random.default_rng(seed + 100).normal(size=x.shape).astype(np.float32)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def _exact_d2(x, y, yv, y_group=1):
    return NN.h2o_nn(_t(x), _t(y), None if yv is None else _t(yv), y_group)[0]


def _dist(d2):
    return np.sqrt(np.maximum(np.asarray(d2, np.float64), 0.0))


def _assert_close_with_err(got, want, err):
    """|got - want| <= atol + rtol |want| + err (err per row, broadcast over xyz)."""
    bound = GRAD_ATOL + GRAD_RTOL * np.abs(want) + err[..., None]
    over = np.abs(got - want) > bound
    assert not over.any(), (np.argwhere(over)[:5], got[over][:5], want[over][:5])


# ---------------------------------------------------------------------------
# the h2o route
# ---------------------------------------------------------------------------


def test_forward_matches_jax_interpret():
    """point2point_h2o_cluster against the JAX kernel given yT, with P1 and
    P2 off the 128 multiple, at a budget that overflows: the port gives the
    JAX kernel's values, overestimates included. The port takes y; a
    transposed view of yT is the same cloud and gives the same bits."""
    x, y, yv = _scene(F=3, P1=131, P2=300, seed=5)
    yT = np.ascontiguousarray(np.swapaxes(y, 1, 2))
    jd = JC.point2point_h2o_cluster(jnp.asarray(x), yT=jnp.asarray(yT), y_valid=jnp.asarray(yv),
                                    k_cells=2, interpret=True)
    before = CC.H2O_KERNEL.launches
    got = CC.point2point_h2o_cluster(_t(x), _t(yT).transpose(1, 2), _t(yv), k_cells=2)
    assert CC.H2O_KERNEL.launches == before  # CPU tensors: the plain version
    assert torch.equal(got, CC.point2point_h2o_cluster(_t(x), _t(y), _t(yv), k_cells=2))
    np.testing.assert_allclose(got.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    ovf = CC.h2o_cluster_overflow(_t(x), _t(y), _t(yv), k_cells=2)
    jovf = JC.h2o_cluster_overflow(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv), k_cells=2)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    assert ovf.sum() > 0  # the budget is below the cell count: the values above overestimate
    assert np.all(got.numpy() >= _dist(_exact_d2(x, y, yv)) - ATOL)  # never below exact


def test_all_invalid_frame_is_big():
    x, y, yv = _scene(F=2, P1=130, P2=256, seed=9)
    yv[1] = False
    got = CC.point2point_h2o_cluster(_t(x), _t(y), _t(yv)).numpy()
    assert np.all(got[1] == np.float32(np.sqrt(np.float32(CC.BIG))))  # BIG, never inf
    ref = np.asarray(JG.point2point_h2o(jnp.asarray(x), jnp.asarray(y), y_valid=jnp.asarray(yv), backend="xla"))
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL, atol=ATOL)
    d2, idx = CC.h2o_cluster_forward(_t(x), _t(y), _t(yv))
    assert torch.equal(d2, _exact_d2(x, y, yv))  # 2 cells: certified, and BIG on frame 1
    assert bool((idx[1] == 0).all())


def test_template_perm_and_morton_match_jax():
    """The static permutation and the Morton fallback are the JAX package's
    permutations, and both routes give the exact values on a certified
    grasp scene."""
    x, y, yv = _grasp_scene(seed=31)
    perm = CC.template_perm(x[0])
    np.testing.assert_array_equal(perm, JC.template_perm(x[0]))
    jm = np.asarray(JC._morton_perm(jnp.swapaxes(jnp.asarray(x), 1, 2)))
    np.testing.assert_array_equal(CC.morton_perm(_t(x)).numpy(), jm)
    exact = _exact_d2(x, y, yv)
    for p in (perm, None):
        assert CC.h2o_cluster_overflow(_t(x), _t(y), _t(yv), x_perm=p, k_cells=4).sum() == 0
        d = CC.point2point_h2o_cluster(_t(x), _t(y), _t(yv), x_perm=p, k_cells=4)
        assert torch.equal(d, torch.sqrt(exact))
    with pytest.raises(ValueError):
        CC.point2point_h2o_cluster(_t(x), _t(y), x_perm=np.zeros(x.shape[1], np.int64))


def test_shared_cloud_matches_jax_interpret():
    """y_group > 1 (one cloud per group of frames, grad_y=False): values and
    gx against the JAX kernel and its VJP; y gets a zero gradient."""
    rng = np.random.default_rng(3)
    x, y, yv = _hand_scene(F=4, P1=150, P2=500, seed=3)
    y, yv = y[:2], yv[:2]
    w = rng.normal(size=(4, 150)).astype(np.float32)

    def jloss(xx):
        d = JC.point2point_h2o_cluster(xx, jnp.asarray(y), jnp.asarray(yv), k_cells=3, interpret=True,
                                       grad_y=False, y_group=2)
        return jnp.sum(jnp.asarray(w) * d), d

    (_, jd), jgx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    d = CC.point2point_h2o_cluster(xt, yt, _t(yv), k_cells=3, grad_y=False, y_group=2)
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    (_t(w) * d).sum().backward()
    err = np.abs(w) * D2_ERR / (2 * np.maximum(d.detach().numpy() ** 2, 1e-30))
    _assert_close_with_err(xt.grad.numpy(), np.asarray(jgx), err)
    assert torch.equal(yt.grad, torch.zeros_like(yt))
    with pytest.raises(NotImplementedError):
        CC.point2point_h2o_cluster(_t(x), _t(y), y_group=2)


def test_gradients_match_jax_grad_interpret():
    """gx and gy (grad_y=True) through the autograd.Function vs jax.grad of
    the JAX route's custom VJP."""
    x, y, yv = _hand_scene(seed=11)
    w = np.random.default_rng(12).normal(size=(2, 140)).astype(np.float32)

    def jloss(xx, yy):
        return jnp.sum(jnp.asarray(w) * JC.point2point_h2o_cluster(xx, yy, jnp.asarray(yv), interpret=True))

    jgx, jgy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    d = TG.point2point_h2o(xt, yt, _t(yv), backend="cluster")
    (_t(w) * d).sum().backward()
    d2, idx = _exact_d2(x, y, yv), NN.h2o_nn(_t(x), _t(y), _t(yv))[1]
    err = np.abs(w) * D2_ERR / (2 * d2.numpy())
    _assert_close_with_err(xt.grad.numpy(), np.asarray(jgx), err)
    err_y = np.zeros(y.shape[:2])
    np.add.at(err_y, (np.broadcast_to(np.arange(2)[:, None], idx.shape), idx.numpy()), err)
    _assert_close_with_err(yt.grad.numpy(), np.asarray(jgy), err_y)


def test_grad_y_false_gives_equal_gx_and_zero_gy():
    x, y, yv = _scene(F=2, P1=140, P2=500, seed=17)
    grads = []
    for grad_y in (True, False):
        xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
        (CC.point2point_h2o_cluster(xt, yt, _t(yv), grad_y=grad_y) ** 2).sum().backward()
        grads.append((xt.grad, yt.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert bool((grads[0][1] != 0).any()) and torch.equal(grads[1][1], torch.zeros_like(grads[1][1]))


def test_small_budget_exact_when_certificate_clear():
    """A budget below the cell count on a grasp scene: the certificate is
    clear in both packages, and the result is the exact search's, bit for
    bit."""
    x, y, yv = _grasp_scene(seed=13)
    ovf = CC.h2o_cluster_overflow(_t(x), _t(y), _t(yv), k_cells=4)
    jovf = JC.h2o_cluster_overflow(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv), k_cells=4)
    assert ovf.sum() == 0 and np.asarray(jovf).sum() == 0
    d2, idx = CC.h2o_cluster_forward(_t(x), _t(y), _t(yv), k_cells=4)
    e2, eidx = NN.h2o_nn(_t(x), _t(y), _t(yv))
    assert torch.equal(d2, e2)
    assert bool((idx >= 0).all() and (idx < y.shape[1]).all())
    np.testing.assert_allclose(_dist(d2), np.asarray(JG.point2point_h2o(
        jnp.asarray(x), jnp.asarray(y), y_valid=jnp.asarray(yv), backend="xla")), rtol=RTOL, atol=ATOL)


def _adversarial(name):
    """The adversarial scenes of tests/test_chamfer_cluster.py (two far
    blobs, a degenerate one-point cloud, a shell around the hand at 4096 and
    2048 points, a full-size hand against a 4096-point surface)."""
    rng = np.random.default_rng({"two_blobs": 41, "one_point": 43, "shell_4096": 45,
                                 "shell_2048": 45, "full_hand": 47}[name])
    if name == "two_blobs":
        a = rng.normal(size=(2048, 3)) * 0.04 + [-0.3, 0, 0]
        b = rng.normal(size=(2048, 3)) * 0.04 + [0.3, 0, 0]
        y = np.concatenate([a, b]).astype(np.float32)
        y = y[spatial_sort_indices(y)][None].repeat(2, 0)
        x = (rng.normal(size=(2, 300, 3)) * 0.05).astype(np.float32)
    elif name == "one_point":
        y = (rng.normal(size=(2, 4096, 3)) * 5e-4 + [0.2, 0.0, 0.1]).astype(np.float32)
        x = (rng.normal(size=(2, 300, 3)) * 0.05).astype(np.float32)
    elif name.startswith("shell"):
        x = (rng.normal(size=(2, 300, 3)) * 0.05).astype(np.float32)
        if name == "shell_2048":
            rng.normal(size=(4096, 3))  # the JAX suite draws the 4096 shell first
        d = rng.normal(size=(int(name[-4:]), 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        y = (d * 2.0).astype(np.float32)
        y = y[spatial_sort_indices(y)][None].repeat(2, 0)
    else:
        v = rng.normal(size=(4096, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        obj = (v * 0.08 * (1 + 0.2 * rng.random((4096, 1)))).astype(np.float32)
        y = obj[spatial_sort_indices(obj)][None].repeat(2, 0)
        x = (rng.normal(size=(2, 778, 3)) * 0.05 + [0.0, 0.0, 0.1]).astype(np.float32)
    return x, y


@pytest.mark.parametrize("name,flags", [("two_blobs", None), ("one_point", True), ("shell_4096", True),
                                        ("shell_2048", False), ("full_hand", True)])
def test_certificate_on_adversarial_scenes(name, flags):
    """Exact where the certificate is clear, never below the exact value,
    flagged where the JAX suite flags, and the same count as the JAX
    certificate."""
    x, y = _adversarial(name)
    ovf = CC.h2o_cluster_overflow(_t(x), _t(y))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(JC.h2o_cluster_overflow(jnp.asarray(x), jnp.asarray(y))))
    d2, _ = CC.h2o_cluster_forward(_t(x), _t(y))
    exact = _exact_d2(x, y, None)
    assert bool((d2 >= exact).all())  # a subset search never underestimates
    clear = ovf == 0
    assert torch.equal(d2[clear], exact[clear])
    if flags is not None:
        assert bool(ovf.sum() > 0) == flags


@pytest.mark.parametrize("y_group", [1, 2])
def test_candidate_sets_and_overflow_match_jax_select(y_group):
    """The selection stage per tile: the same candidate sets and overflow
    bits as the JAX `_h2o_select`, with the static permutation and shared
    clouds; and the o2h stage's per cell at k_tiles 1."""
    x, y, yv = _grasp_scene(F=4, P1=300, P2=1024, seed=7)
    x[2:] += 0.05  # a second pose per cloud
    y, yv = y[: 4 // y_group], yv[: 4 // y_group]
    perm = CC.template_perm(x[0])
    for k in (3, 8):
        cidx, ovf = CC.h2o_candidates(_t(x), _t(y), _t(yv), x_perm=perm, k_cells=k, y_group=y_group)
        xTs, _, x_valid = JC._apply_perm_pad(jnp.asarray(x), perm)
        _, _, xTc, _, _, c, r, p, ne, _ = JC._prep_cluster_operands(
            xTs, jnp.swapaxes(jnp.asarray(y), 1, 2), jnp.asarray(yv), y_group)
        c, r, p, ne = (jnp.repeat(a, y_group, axis=0) for a in (c, r, p, ne))
        jc, jo = JC._h2o_select(xTc, x_valid, c, r, p, ne, k)
        np.testing.assert_array_equal(np.sort(cidx.numpy(), -1), np.sort(np.asarray(jc), -1))
        np.testing.assert_array_equal(ovf.numpy(), np.asarray(jo))
    if y_group == 1:
        xs, _, ctr = NN.prepare(CC.XPerm(_t(x), perm).apply(_t(x)), _t(y), _t(yv), 1)
        xc, xv, yc, yvp = CC.selection_operands(xs, _t(y), _t(yv), ctr, 1)
        cy, oy = CC.o2h_select(yc, yvp, *CC.x_tile_stats(xc, xv), 1)
        _, _, _, yTc, yv_pad, *_ = JC._prep_cluster_operands(xTs, jnp.swapaxes(jnp.asarray(y), 1, 2),
                                                             jnp.asarray(yv))
        jcy, joy = JC._o2h_select(yTc, yv_pad, *JC._x_tile_stats(xTc, x_valid), 1)
        np.testing.assert_array_equal(cy.numpy(), np.asarray(jcy))
        np.testing.assert_array_equal(oy.numpy(), np.asarray(joy))


# ---------------------------------------------------------------------------
# the signed route
# ---------------------------------------------------------------------------


def _d_at(x, y, idx):
    """||y_j - x_idx[j]|| [F, P2]."""
    return np.linalg.norm(y - np.take_along_axis(x, idx[..., None].astype(np.int64), axis=1), axis=-1)


@pytest.mark.parametrize("k_tiles", [0, 1])
def test_signed_forward_matches_jax_interpret(k_tiles):
    """y2x_signed, x2y and the o2h index (through the distance it selects)
    against the JAX kernels at k_tiles 0 (exact o2h) and 1 (overflowing);
    and the overflow counts."""
    x, y, yv = _scene(F=2, P1=200, P2=700, seed=21)
    n = _normals(x, 21)
    perm = CC.template_perm(x[0])
    jy2x, jx2y, jidx = (np.asarray(a) for a in JC.point2point_signed_cluster(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(n), jnp.asarray(yv), x_perm=perm, k_cells=3,
        k_tiles=k_tiles, interpret=True))
    before = (CC.H2O_KERNEL.launches, CC.O2H_KERNEL.launches)
    y2x, x2y, idx = (t.numpy() for t in TG.point2point_signed(
        _t(x), _t(y), _t(n), _t(yv), backend="cluster", x_perm=perm, k_cells=3, k_tiles=k_tiles))
    assert (CC.H2O_KERNEL.launches, CC.O2H_KERNEL.launches) == before
    np.testing.assert_allclose(x2y, jx2y, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y2x, jy2x, rtol=RTOL, atol=ATOL)
    assert np.all(y2x[~yv] == 0.0)
    np.testing.assert_allclose(_d_at(x, y, idx)[yv], _d_at(x, y, jidx)[yv], rtol=RTOL, atol=ATOL)
    got = [a.numpy() for a in CC.signed_cluster_overflow(_t(x), _t(y), _t(yv), x_perm=perm, k_cells=3,
                                                         k_tiles=k_tiles)]
    want = JC.signed_cluster_overflow(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv), x_perm=perm,
                                      k_cells=3, k_tiles=k_tiles)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (got[1].sum() > 0) == (k_tiles == 1)


def test_signed_exact_o2h_equals_the_signed_pair():
    """k_tiles = 0 searches every tile: the o2h outputs equal the all-pairs
    signed pair's (ops/chamfer_signed) bit for bit, in the caller's order."""
    x, y, yv = _scene(F=2, P1=200, P2=700, seed=22)
    n = _normals(x, 22)
    _, _, o2h_d, o2h_i, o2h_dot = CC.signed_cluster_forward(_t(x), _t(y), _t(n), _t(yv),
                                                            x_perm=CC.template_perm(x[0]))
    _, _, e_d, e_i, e_dot = CS.nn_signed(_t(x), _t(y), _t(n), _t(yv), 1)
    valid = _t(yv)
    assert torch.equal(o2h_d, e_d) and torch.equal(o2h_i[valid], e_i[valid])
    assert torch.equal(o2h_dot[valid], e_dot[valid])


@pytest.mark.parametrize("k_tiles", [0, 2])
def test_signed_gradients_match_jax_grad_interpret(k_tiles):
    """gx and gy (grad_y=True) of a weighted sum of both outputs vs jax.grad
    of the JAX route's custom VJP."""
    x, y, yv = _hand_scene(seed=25)
    n = _normals(x, 25)
    rng = np.random.default_rng(26)
    a = rng.normal(size=(2, 500)).astype(np.float32)
    b = rng.normal(size=(2, 140)).astype(np.float32)

    def jloss(xx, yy):
        y2x, x2y, _ = JC.point2point_signed_cluster(xx, yy, jnp.asarray(n), jnp.asarray(yv),
                                                    k_tiles=k_tiles, interpret=True)
        return jnp.sum(jnp.asarray(a) * y2x) + jnp.sum(jnp.asarray(b) * x2y)

    jgx, jgy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    y2x, x2y, idx = CC.point2point_signed_cluster(xt, yt, _t(n), _t(yv), k_tiles=k_tiles)
    assert not idx.requires_grad
    ((_t(a) * y2x).sum() + (_t(b) * x2y).sum()).backward()
    h2o_d, h2o_i, o2h_d, o2h_i, _ = (t.numpy() for t in CS.nn_signed(_t(x), _t(y), _t(n), _t(yv), 1))
    e_row = np.abs(b) * D2_ERR / (2 * h2o_d)
    e_col = np.where(yv, np.abs(a) * D2_ERR / (2 * o2h_d), 0.0)
    frames = np.broadcast_to(np.arange(2)[:, None], o2h_i.shape)
    err_x = e_row.copy()
    np.add.at(err_x, (frames, o2h_i), e_col)
    _assert_close_with_err(xt.grad.numpy(), np.asarray(jgx), err_x)
    err_y = e_col.copy()
    np.add.at(err_y, (np.broadcast_to(np.arange(2)[:, None], h2o_i.shape), h2o_i), e_row)
    _assert_close_with_err(yt.grad.numpy(), np.asarray(jgy), err_y)


def test_signed_grad_y_false_gives_equal_gx_and_zero_gy():
    x, y, yv = _scene(F=2, P1=150, P2=400, seed=19)
    n = _normals(x, 19)
    grads = []
    for grad_y in (True, False):
        xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
        y2x, x2y, _ = CC.point2point_signed_cluster(xt, yt, _t(n), _t(yv), grad_y=grad_y)
        ((y2x ** 2).sum() + (x2y ** 2).sum()).backward()
        grads.append((xt.grad, yt.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert bool((grads[0][1] != 0).any()) and torch.equal(grads[1][1], torch.zeros_like(grads[1][1]))


# ---------------------------------------------------------------------------
# routes, refusals, launches
# ---------------------------------------------------------------------------


def test_geometry_routes_and_refusals():
    x, y, yv = _scene(F=2, P1=130, P2=300, seed=27)
    n = _normals(x, 27)
    assert torch.equal(TG.point2point_h2o(_t(x), _t(y), _t(yv), backend="cluster", k_cells=2),
                       CC.point2point_h2o_cluster(_t(x), _t(y), _t(yv), k_cells=2))
    assert torch.equal(TG.point2point_h2o_overflow(_t(x), _t(y), _t(yv), backend="cluster", k_cells=1),
                       CC.h2o_cluster_overflow(_t(x), _t(y), _t(yv), k_cells=1))
    for backend in ("auto", "exact", "cull"):  # exact routes: nothing to certify
        assert not TG.point2point_h2o_overflow(_t(x), _t(y), _t(yv), backend=backend, k_cells=1).any()
    with pytest.raises(ValueError, match="y_normals"):
        TG.point2point_signed(_t(x), _t(y), _t(n), backend="cluster", y_normals=_t(y))
    with pytest.raises(NotImplementedError, match="y_group"):
        TG.point2point_signed(_t(x), _t(y[:1]), _t(n), backend="cluster", grad_y=False, y_group=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TG.point2point_signed(_t(x), _t(y), backend="xla")
    with pytest.raises(ValueError):
        CC.point2point_h2o_cluster(_t(x), _t(y), k_cells=0)


def test_cpu_wrappers_of_the_cluster_kernels_launch_nothing():
    """All four wrappers on CPU tensors run their plain versions, also
    under autograd: values come back, the counts stay put."""
    x, y, yv = _scene(F=2, P1=130, P2=300, seed=29)
    n = _normals(x, 29)
    before = [k.launches for k in CC.KERNELS]
    xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    d = CC.point2point_h2o_cluster(xt, yt, _t(yv))
    y2x, x2y, _ = CC.point2point_signed_cluster(xt, yt, _t(n), _t(yv), k_tiles=1)
    (d.sum() + y2x.sum() + x2y.sum()).backward()
    assert [k.launches for k in CC.KERNELS] == before
    assert torch.isfinite(xt.grad).all() and torch.isfinite(yt.grad).all()
