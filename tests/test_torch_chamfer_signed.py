"""The port's signed bidirectional chamfer (oakink2_tamf_tpu_torch.ops.
chamfer_signed and core.geometry.point2point_signed) against the JAX
kernels it replaces, `_nn_forward` / `point2point_signed_pallas`, run as the
JAX package's own tests run them on the CPU (Pallas interpret mode).

Tolerances:
- distances rtol 1e-5 / atol 1e-6 (metres): the TPU kernel forms ||x-y||^2
  by expansion, the port by direct differences; after centring both are
  within this bound of each other (the h2o slice's bound);
- h2o indices equal; o2h indices may differ on near-ties, which the two
  formulations break differently: at most 0.1% of the valid columns;
- the backward on identical inputs (argmins and cotangent rows) as the
  TPU's `_nn_backward`: rtol 1e-4 / atol 1e-6, sums in another order;
- gradients end to end vs jax.grad: rtol 1e-4 / atol 1e-6 plus the TPU
  distances' own error. The TPU kernel's expanded ||x-y||^2 carries an
  absolute error up to ~4e-10 m^2 at these scales (measured against the
  port's direct differences), and a gradient term c (x-y)/d, of size |c|,
  inherits |c| delta / (2 d^2) of it: ~3e-4 |c| at 0.5 mm.
  Each element's bound adds that term for every pair it takes part in,
  with delta = D2_ERR = 1e-9 m^2.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oakink2_tamf_tpu.ops import chamfer_pallas as JCP
from oakink2_tamf_tpu_torch.core import geometry as TG
from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
D2_ERR = 1e-9  # bound on the TPU kernel's squared-distance error, m^2
MAX_O2H_MISMATCH = 1e-3


def _scene(seed, F=4, P1=778, P2=700, y_group=2, ragged=True, all_invalid=True):
    """Hand-like 128-row clusters with unit normals near an object cloud;
    group 0 ragged, the last group all-invalid (a padded object slot)."""
    rng = np.random.default_rng(seed)
    G = F // y_group
    y = (rng.normal(size=(G, P2, 3)) * 0.05).astype(np.float32)
    centers = rng.normal(size=(F, (P1 + 127) // 128, 3)) * 0.05
    x = (centers[:, np.arange(P1) // 128] + rng.normal(size=(F, P1, 3)) * 0.01).astype(np.float32)
    n = rng.normal(size=(F, P1, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    yv = np.ones((G, P2), bool)
    if ragged:
        yv[0, P2 // 3:] = False
    if all_invalid and G > 1:
        yv[-1] = False
    return x, n, y, yv


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dist(d2):
    return np.sqrt(np.maximum(np.asarray(d2, np.float64), 0.0))


@pytest.mark.parametrize("y_group", [1, 2])
def test_plain_forward_matches_nn_forward_interpret(y_group):
    x, n, y, yv = _scene(0, y_group=y_group, all_invalid=y_group > 1)
    want = [np.asarray(a) for a in JCP._nn_forward(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv), jnp.asarray(n), 512, True, y_group
    )]
    before = (CS.KERNEL.launches, CS.BWD_KERNEL.launches)
    got = [a.numpy() for a in CS.nn_signed(_t(x), _t(y), _t(n), _t(yv), y_group)]
    assert (CS.KERNEL.launches, CS.BWD_KERNEL.launches) == before  # CPU: plain, no launch
    live = np.repeat(yv.any(1), y_group)
    np.testing.assert_allclose(_dist(got[0])[live], _dist(want[0])[live], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1][live], want[1][live])
    # an all-invalid cloud gives BIG (1e30 squared), never inf
    assert np.all(got[0][~live] == np.float32(CS.BIG))

    valid = np.repeat(yv, y_group, axis=0)
    np.testing.assert_allclose(_dist(got[2])[valid], _dist(want[2])[valid], rtol=RTOL, atol=ATOL)
    same = got[3] == want[3]
    assert (~same & valid).sum() <= MAX_O2H_MISMATCH * valid.sum(), (~same & valid).sum()
    # the sign numerator at the same nearest row: one dot product, two roundings
    both = same & valid
    np.testing.assert_allclose(got[4][both], want[4][both], rtol=1e-4, atol=1e-6)
    # invalid columns: (BIG, row 0), masked by every caller
    assert np.all(got[2][~valid] == np.float32(CS.BIG)) and np.all(got[3][~valid] == 0)


@pytest.mark.parametrize("y_group", [1, 2])
def test_signed_chamfer_matches_pallas_interpret(y_group):
    x, n, y, yv = _scene(1, y_group=y_group, all_invalid=y_group > 1)
    want = [np.asarray(a) for a in JCP.point2point_signed_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(n), jnp.asarray(yv), tile=512,
        interpret=True, grad_y=False, y_group=y_group,
    )]
    got = [a.numpy() for a in TG.point2point_signed(
        _t(x), _t(y), _t(n), _t(yv), grad_y=False, y_group=y_group
    )]
    valid = np.repeat(yv, y_group, axis=0)
    live = np.repeat(yv.any(1), y_group)
    same = (got[2] == want[2]) | ~valid
    assert (~same).sum() <= MAX_O2H_MISMATCH * valid.sum()
    np.testing.assert_allclose(got[0][same], want[0][same], rtol=RTOL, atol=ATOL)
    assert np.all(got[0][~valid] == 0.0)
    np.testing.assert_allclose(got[1][live], want[1][live], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grad_y,y_group", [(False, 1), (True, 1), (False, 2)])
def test_backward_matches_nn_backward_interpret(grad_y, y_group):
    """The backward (kernel #7's function) on the same argmins and cotangent
    rows as the TPU's `_nn_backward`."""
    x, n, y, yv = _scene(2, F=4, P2=600, y_group=y_group, all_invalid=y_group > 1)
    _, h2o_i, _, o2h_i, _ = CS.nn_signed(_t(x), _t(y), _t(n), _t(yv), y_group)
    rng = np.random.default_rng(3)
    xr = rng.normal(size=(4, 778)).astype(np.float32) * 10
    yc = rng.normal(size=(4, 600)).astype(np.float32) * 10
    yc[~np.repeat(yv, y_group, axis=0)] = 0.0  # invalid columns carry no cotangent
    jgx, jgy = JCP._nn_backward(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(h2o_i.numpy()), jnp.asarray(o2h_i.numpy()),
        jnp.asarray(xr), jnp.asarray(yc), 512, True, grad_y, y_group,
    )
    before = CS.BWD_KERNEL.launches
    gx, gy = CS.nn_signed_backward(_t(x), _t(y), h2o_i, o2h_i, _t(xr), _t(yc), grad_y, y_group)
    assert CS.BWD_KERNEL.launches == before
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if grad_y:
        np.testing.assert_allclose(gy.numpy(), np.asarray(jgy), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    else:
        assert gy is None and jgy is None


def _assert_close_with_err(got, want, err):
    """|got - want| <= atol + rtol |want| + err (err per row/point [F, P])."""
    bound = GRAD_ATOL + GRAD_RTOL * np.abs(want) + err[..., None]
    over = np.abs(got - want) > bound
    assert not over.any(), (np.argwhere(over)[:5], got[over][:5], want[over][:5])


@pytest.mark.parametrize("grad_y,y_group", [(False, 1), (True, 1), (False, 2)])
def test_autograd_matches_jax_grad_of_pallas_interpret(grad_y, y_group):
    """gx (and gy) through the autograd.Function vs jax.grad of the TPU
    kernel pair's custom VJP, on a weighted sum of both outputs."""
    x, n, y, yv = _scene(2, F=4, P2=600, y_group=y_group, all_invalid=y_group > 1)
    rng = np.random.default_rng(3)
    a = rng.normal(size=(4, 600)).astype(np.float32)
    b = rng.normal(size=(4, 778)).astype(np.float32)

    def jloss(xx, yy):
        y2x, x2y, _ = JCP.point2point_signed_pallas(
            xx, yy, jnp.asarray(n), jnp.asarray(yv), tile=512, interpret=True,
            grad_y=grad_y, y_group=y_group,
        )
        return jnp.sum(jnp.asarray(a) * y2x) + jnp.sum(jnp.asarray(b) * x2y)

    jv, (jgx, jgy) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))

    xt = _t(x).requires_grad_(True)
    yt = _t(y).requires_grad_(grad_y)
    y2x, x2y, idx = TG.point2point_signed(xt, yt, _t(n), _t(yv), grad_y=grad_y, y_group=y_group)
    assert not idx.requires_grad
    tv = (_t(a) * y2x).sum() + (_t(b) * x2y).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=GRAD_RTOL)

    # each pair's share of the TPU distances' error: |cotangent| D2_ERR / (2 d^2)
    h2o_d, h2o_i, o2h_d, o2h_i, _ = (t.numpy() for t in CS.nn_signed(_t(x), _t(y), _t(n), _t(yv), y_group))
    valid = np.repeat(yv, y_group, axis=0)
    live = np.repeat(yv.any(1), y_group)[:, None]
    e_row = np.where(live, np.abs(b) * D2_ERR / (2 * h2o_d), 0.0)
    e_col = np.where(valid, np.abs(a) * D2_ERR / (2 * o2h_d), 0.0)
    err_x = e_row.copy()
    frames = np.arange(4)[:, None]
    np.add.at(err_x, (np.broadcast_to(frames, o2h_i.shape), o2h_i), e_col)
    _assert_close_with_err(xt.grad.numpy(), np.asarray(jgx), err_x)
    if grad_y:
        err_y = e_col.copy()
        np.add.at(err_y, (np.broadcast_to(frames, h2o_i.shape), h2o_i), e_row)
        _assert_close_with_err(yt.grad.numpy(), np.asarray(jgy), err_y)
    else:
        assert yt.grad is None
        np.testing.assert_array_equal(np.asarray(jgy), 0.0)


def test_backward_plain_matches_autograd_of_gather_formulation():
    """The backward's plain version equals torch autograd through the
    gather formulation with the argmins held constant (the reference's CUDA
    chamfer + gather convention), grad_y both ways."""
    x, n, y, _ = _scene(4, F=2, P1=300, P2=200, y_group=1, ragged=False, all_invalid=False)
    h2o_d, h2o_i, o2h_d, o2h_i, _ = CS.nn_signed(_t(x), _t(y), _t(n), None, 1)
    xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    y_at = torch.gather(yt, 1, h2o_i.long()[..., None].expand(-1, -1, 3))
    x_at = torch.gather(xt, 1, o2h_i.long()[..., None].expand(-1, -1, 3))
    x2y = torch.linalg.vector_norm(xt - y_at, dim=-1)
    y2x = torch.linalg.vector_norm(yt - x_at, dim=-1)
    rng = np.random.default_rng(5)
    a, b = _t(rng.normal(size=y2x.shape).astype(np.float32)), _t(rng.normal(size=x2y.shape).astype(np.float32))
    ((a * y2x).sum() + (b * x2y).sum()).backward()
    xr = b / torch.clamp_min(x2y.detach(), CS.DIST_EPS)
    yc = a / torch.clamp_min(y2x.detach(), CS.DIST_EPS)
    gx, gy = CS.backward_plain(_t(x), _t(y), h2o_i, o2h_i, xr, yc, True, 1)
    np.testing.assert_allclose(gx.numpy(), xt.grad.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(gy.numpy(), yt.grad.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    gx2, gy2 = CS.backward_plain(_t(x), _t(y), h2o_i, o2h_i, xr, yc, False, 1)
    assert gy2 is None and torch.equal(gx2, gx)


def test_padded_slot_all_zero_geometry_is_finite():
    """A padded object slot: zero cloud, zero (canonical) hand rows. Every
    distance is 0 exactly; the max(dist, 1e-12) guards keep the gradient
    finite, and the zero sign makes the signed field 0."""
    x = torch.zeros((3, 778, 3), requires_grad=True)
    y = torch.zeros((1, 256, 3))
    n = torch.zeros((3, 778, 3))
    y2x, x2y, _ = TG.point2point_signed(x, y, n, grad_y=False, y_group=3)
    assert torch.all(y2x == 0) and torch.all(x2y == 0)
    (y2x.sum() + x2y.sum()).backward()
    assert torch.all(torch.isfinite(x.grad)) and torch.all(x.grad == 0)


def test_shared_cloud_requires_grad_y_false():
    x = torch.zeros((4, 10, 3))
    y = torch.zeros((2, 20, 3))
    with pytest.raises(NotImplementedError):
        TG.point2point_signed(x, y, grad_y=True, y_group=2)


def _tie_scene(seed, F=4, P1=300, P2=4200, y_group=2):
    """Minima that tie exactly in both directions, at the seams of the
    bidirectional kernel (256 threads x 4 columns per pass, rows in groups
    of 8): every 7th point has an exact copy at +1 (the next lane), +32
    (the next warp), +256 (the thread's next column), +1024 (the next
    pass), +2048 or +4096; rows i + 128 copy rows i in alternate 128-row
    blocks, every 16th row is copied to the next one (the same group) and
    every 32nd to the one 8 on (the next group). Each row keeps its own
    random normal, so the sign numerator shows which of two equal rows
    won."""
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
    return x.astype(np.float32), n.astype(np.float32), y.astype(np.float32)


def _fma3_np(a0, b0, a1, b1, a2, b2):
    """fma(a2, b2, fma(a1, b1, fl(a0 b0))) in float32, each fma formed
    exactly in float64 and rounded once."""
    s = (a0 * b0).astype(np.float64)
    s = (a1.astype(np.float64) * b1 + s).astype(np.float32).astype(np.float64)
    return (a2.astype(np.float64) * b2 + s).astype(np.float32)


def _first_min_reference(x, n, y4, ctr, y_group):
    """The forward's outputs in numpy on prepared operands: the pinned pair
    arithmetic, then np.argmin (the first minimum) in both directions."""
    xc = x - np.repeat(ctr, y_group, axis=0)[:, None, :]
    yf = np.repeat(y4[..., :3], y_group, axis=0)
    d = xc[:, :, None, :] - yf[:, None, :, :]
    d2 = _fma3_np(d[..., 0], d[..., 0], d[..., 1], d[..., 1], d[..., 2], d[..., 2])  # [F, P1, P2]
    h2o_i, o2h_i = np.argmin(d2, axis=2), np.argmin(d2, axis=1)
    frames = np.arange(x.shape[0])[:, None]
    dy = yf - xc[frames, o2h_i]
    nr = n[frames, o2h_i]
    dot = _fma3_np(nr[..., 0], dy[..., 0], nr[..., 1], dy[..., 1], nr[..., 2], dy[..., 2])
    ties = ((d2 == d2.min(axis=2, keepdims=True)).sum(axis=2) > 1).sum(), \
        ((d2 == d2.min(axis=1, keepdims=True)).sum(axis=1) > 1).sum()
    return (d2.min(axis=2), h2o_i, d2.min(axis=1), o2h_i, dot), ties


def _assert_first_min(got, want):
    for name, a, b in zip(("h2o_d", "h2o_i", "o2h_d", "o2h_i", "o2h_dot"), got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b, err_msg=name)


@pytest.mark.parametrize("chunk_points", [None, 100])
def test_plain_takes_the_first_minimum_on_exact_ties(monkeypatch, chunk_points):
    """The plain forward against np.argmin on _tie_scene: equal values, and
    on every exact tie the smallest index, in both directions and across
    the plain version's chunks of points (chunk_points=100 puts every
    copy's pair in another chunk than its original)."""
    x, n, y = _tie_scene(7)
    if chunk_points is not None:
        monkeypatch.setattr(CS.NN, "_PLAIN_CHUNK_ELEMS", x.shape[0] * x.shape[1] * 3 * chunk_points)
    ops = CS.prepare(_t(x), _t(y), _t(n), None, 2)
    want, ties = _first_min_reference(*(t.numpy() for t in ops), 2)
    assert min(ties) > 100, ties  # the scene really ties, both ways
    _assert_first_min(CS.plain(*ops, 2), want)


@pytest.mark.cuda
def test_cuda_kernel_takes_the_first_minimum_on_exact_ties():
    """The kernel on _tie_scene against np.argmin, both directions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    x, n, y = _tie_scene(7)
    ops = CS.prepare(_t(x).cuda(), _t(y).cuda(), _t(n).cuda(), None, 2)
    want, _ = _first_min_reference(*(t.cpu().numpy() for t in ops), 2)
    _assert_first_min(CS.launch(*ops, 2), want)
