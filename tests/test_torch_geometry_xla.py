"""The port's streaming "xla" route (core/geometry.point2point_signed and
point2point_h2o with backend="xla", nearest_neighbor on frames) and
vertex_normals' scatter route, against the JAX package's XLA code on the
CPU, on the same numpy inputs.

Tolerances, float32 on both sides:
- distances rtol 1e-5, or squared distances within 4 float32 ulps of
  |x|^2 + |y|^2 (both sides expand |x - y|^2 = |x|^2 + |y|^2 - 2 x.y, and
  XLA's dot rounds x.y differently from torch's matmul: 3.7e-9 m^2 seen at
  these coordinates, which is 5e-4 of a 1 mm distance); +-inf, and the
  signs, where JAX has them; indices exactly (the scenes have no ties,
  apart from the seam scene's exact copies, where the first minimum must
  win on both sides);
- gradients (gx, gy) within 1e-4 of their norms: both sides take
  (x - y*) / dist at the same pair, rounded in another order (the
  uncentred expansion's error is the same on both sides);
- vertex normals on the scatter route atol 1e-5 (the same sums over a
  vertex's faces in another order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oakink2_tamf_tpu.core import geometry as JG
from oakink2_tamf_tpu_torch.core import geometry as TG

RTOL, GRAD_REL = 1e-5, 1e-4


def _scene(seed, G=2, y_group=1, P1=150, P2=300, ragged=True, all_invalid=True):
    """Hand-like clusters near object clouds: cloud 0 ragged (a third
    valid), the last cloud all-invalid (a padded object slot) when G > 1."""
    rng = np.random.default_rng(seed)
    F = G * y_group
    y = (rng.normal(size=(G, P2, 3)) * 0.05).astype(np.float32)
    centers = rng.normal(size=(F, (P1 + 31) // 32, 3)) * 0.05
    x = (centers[:, np.arange(P1) // 32] + rng.normal(size=(F, P1, 3)) * 0.01).astype(np.float32)
    yv = np.ones((G, P2), bool)
    if ragged:
        yv[0, P2 // 3:] = False
    if all_invalid and G > 1:
        yv[-1] = False
    xn = rng.normal(size=(F, P1, 3)).astype(np.float32)
    yn = rng.normal(size=(F, P2, 3)).astype(np.float32)
    return x, y, yv, xn, yn


def _t(a, grad=False):
    return None if a is None else torch.from_numpy(np.array(a)).requires_grad_(grad)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _assert_values(got, want, what, *clouds):
    """`clouds`: the point sets searched, for the expansion's rounding
    bound 4 eps (max |x|^2 + max |y|^2)."""
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)  # +-inf and nan where JAX has them
    g, w = got[fin].astype(np.float64), want[fin].astype(np.float64)
    np.testing.assert_array_equal(np.sign(g), np.sign(w), err_msg=what)
    d2_atol = 4 * np.finfo(np.float32).eps * sum(float(np.max(np.sum(c.astype(np.float64) ** 2, -1)))
                                                 for c in clouds)
    ok = (np.abs(g - w) <= RTOL * np.abs(w)) | (np.abs(g * g - w * w) <= d2_atol)
    assert ok.all(), f"{what}: {np.count_nonzero(~ok)} of {ok.size} beyond both bounds, e.g. {g[~ok][:4]} vs {w[~ok][:4]}"


def _assert_grad(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), what
    assert np.linalg.norm(got - want) <= GRAD_REL * np.linalg.norm(want) + 1e-9, what


def _weights(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("normals", ["none", "x", "y", "both"])
@pytest.mark.parametrize("y_group,grad_y", [(1, True), (1, False), (3, False)])
def test_signed_xla_matches_jax(normals, y_group, grad_y):
    """Values, indices and gradients of point2point_signed(backend="xla")
    against JAX's, with a ragged and an all-invalid cloud, and a chunk
    (128) smaller than P2 (300) with a ragged tail."""
    x, y, yv, xn, yn = _scene(1, y_group=y_group)
    xn = xn if normals in ("x", "both") else None
    yn = yn if normals in ("y", "both") else None
    F, P1, P2 = x.shape[0], x.shape[1], y.shape[1]
    w1, w2 = _weights(2, (F, P2), (F, P1))

    def jloss(jx, jy):
        y2x, x2y, _ = JG.point2point_signed(jx, jy, _j(xn), _j(yn), jnp.asarray(yv), chunk=128, backend="xla",
                                            grad_y=grad_y, y_group=y_group)
        return jnp.sum(jnp.where(jnp.isfinite(y2x), y2x, 0.0) * w1) + jnp.sum(
            jnp.where(jnp.isfinite(x2y), x2y, 0.0) * w2)

    want = JG.point2point_signed(jnp.asarray(x), jnp.asarray(y), _j(xn), _j(yn), jnp.asarray(yv), chunk=128,
                                 backend="xla", grad_y=grad_y, y_group=y_group)
    jgx, jgy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))

    tx, ty = _t(x, True), _t(y, True)
    got = TG.point2point_signed(tx, ty, _t(xn), _t(yv), backend="xla", grad_y=grad_y, y_group=y_group,
                                y_normals=_t(yn), chunk=128)
    for g, w, name in zip(got, want, ("y2x", "x2y")):
        _assert_values(g.detach().numpy(), w, name, x, y)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].dtype == torch.int32
    # the all-invalid cloud: x2y is +inf (signed with y_normals), y2x 0
    dead = np.repeat(~yv.any(1), y_group)
    x2y_dead = got[1].detach().numpy()[dead]
    assert np.isinf(x2y_dead).sum() + np.isnan(x2y_dead).sum() == x2y_dead.size
    if yn is None:
        assert np.all(x2y_dead == np.inf)
    assert np.all(got[0].detach().numpy()[dead] == 0.0)

    loss = torch.sum(torch.where(torch.isfinite(got[0]), got[0], 0.0) * _t(w1)) + torch.sum(
        torch.where(torch.isfinite(got[1]), got[1], 0.0) * _t(w2))
    loss.backward()
    _assert_grad(tx.grad.numpy(), jgx, "gx")
    if grad_y:
        _assert_grad(ty.grad.numpy(), jgy, "gy")
    else:
        assert ty.grad is None  # grad_y=False detaches y
        assert not np.asarray(jgy).any()


@pytest.mark.parametrize("y_group,grad_y", [(1, True), (1, False), (4, False)])
def test_h2o_xla_matches_jax(y_group, grad_y):
    x, y, yv, _, _ = _scene(3, G=3, y_group=y_group, P2=260)
    (w,) = _weights(4, x.shape[:2])

    def jloss(jx, jy):
        d = JG.point2point_h2o(jx, jy, jnp.asarray(yv), chunk=100, backend="xla", grad_y=grad_y, y_group=y_group)
        return jnp.sum(jnp.where(jnp.isfinite(d), d, 0.0) * w)

    want = JG.point2point_h2o(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv), chunk=100, backend="xla",
                              grad_y=grad_y, y_group=y_group)
    jgx, jgy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = _t(x, True), _t(y, True)
    got = TG.point2point_h2o(tx, ty, _t(yv), backend="xla", grad_y=grad_y, y_group=y_group, chunk=100)
    _assert_values(got.detach().numpy(), want, "h2o", x, y)
    assert np.all(got.detach().numpy()[np.repeat(~yv.any(1), y_group)] == np.inf)
    torch.sum(torch.where(torch.isfinite(got), got, 0.0) * _t(w)).backward()
    _assert_grad(tx.grad.numpy(), jgx, "gx")
    if grad_y:
        _assert_grad(ty.grad.numpy(), jgy, "gy")
    else:
        assert ty.grad is None


def test_xla_route_ignores_x_valid_and_runs_no_kernel(monkeypatch):
    """Padded frames (x_valid False) get real distances, as in JAX; the
    route calls nothing of ops/."""
    x, y, yv, xn, _ = _scene(5, G=2, y_group=2, all_invalid=False)

    def refuse(*a, **k):
        raise AssertionError("the xla route called a kernel wrapper")

    for mod, names in ((TG.chamfer_nn, ("h2o_nn", "h2o_nn_dvec")), (TG.chamfer_cull, ("h2o_cull", "h2o_cull_dvec")),
                       (TG.chamfer_signed, ("signed_chamfer",)), (TG.chamfer_h2o_bwd, ("h2o_backward",))):
        for n in names:
            monkeypatch.setattr(mod, n, refuse)
    xv = torch.tensor([True, False, True, False])
    got = TG.point2point_h2o(_t(x, True), _t(y), _t(yv), backend="xla", grad_y=False, y_group=2, x_valid=xv)
    want = JG.point2point_h2o(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv), backend="xla", grad_y=False,
                              y_group=2, x_valid=jnp.asarray(xv.numpy()))
    _assert_values(got.detach().numpy(), want, "h2o", x, y)
    assert np.isfinite(got.detach().numpy()).all()
    TG.point2point_signed(_t(x), _t(y), _t(xn), _t(yv), backend="xla", grad_y=False, y_group=2)


def test_first_minimum_wins_across_a_tile_seam():
    """Exact copies of points on both sides of a tile seam (chunk 64):
    JAX's scan keeps the earlier tile's, and so does the port, in both
    directions; a zero distance (a hand vert on an object point) too."""
    rng = np.random.default_rng(6)
    y = (rng.normal(size=(1, 200, 3)) * 0.05).astype(np.float32)
    y[0, 64:70] = y[0, 58:64]  # copies straddling the seam at 64
    y[0, 128] = y[0, 5]  # and a copy two tiles later
    x = (rng.normal(size=(1, 100, 3)) * 0.05).astype(np.float32)
    x[0, :6] = y[0, 58:64] + 1e-3  # nearest to the copied pairs
    x[0, 6] = y[0, 5]  # exactly on a copied point: distance 0
    x[0, 64:67] = x[0, 0:3]  # copies in x too, across the y2x search's seam
    yv = np.ones((1, 200), bool)
    want = JG.point2point_signed(jnp.asarray(x), jnp.asarray(y), y_valid=jnp.asarray(yv), chunk=64, backend="xla")
    got = TG.point2point_signed(_t(x), _t(y), None, _t(yv), backend="xla", chunk=64)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _assert_values(got[0].numpy(), want[0], "y2x", x, y)
    _assert_values(got[1].numpy(), want[1], "x2y", x, y)
    d2, idx = TG.nearest_neighbor(_t(x), _t(y), _t(yv), 64)
    jd, ji = JG.nearest_neighbor(jnp.asarray(x[0]), jnp.asarray(y[0]), jnp.asarray(yv[0]), chunk=64)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ji))
    assert set(idx[0, :7].tolist()) <= set(range(64))  # the earlier copies
    assert float(d2[0, 6]) == 0.0 and float(got[1][0, 6]) == 0.0
    _assert_values(np.sqrt(d2[0].numpy()), np.sqrt(np.asarray(jd)), "nearest_neighbor", x, y)


@pytest.mark.parametrize("tile_bytes", [1, 4 * 64 * 200, 4 * 64 * 1000, 1 << 30])
def test_nearest_neighbor_does_not_depend_on_the_grouping(tile_bytes):
    """Clouds and rows grouped down to the least tile (128 rows, below
    which the BLAS rounds x.y otherwise), a cloud split into rows, several
    clouds per tile and all at once: bitwise the same."""
    x, y, yv, _, _ = _scene(7, G=3, y_group=2)
    want = TG.nearest_neighbor(_t(x), _t(y), _t(yv), 64, y_group=2)
    got = TG.nearest_neighbor(_t(x), _t(y), _t(yv), 64, y_group=2, tile_bytes=tile_bytes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_routing_of_y_normals():
    """"auto" with y_normals takes the xla route; "pallas" and "cluster"
    refuse them; "auto" without them stays on the kernels' route."""
    x, y, yv, xn, yn = _scene(8, G=1)
    args = (_t(x), _t(y), _t(xn), _t(yv))
    auto = TG.point2point_signed(*args, y_normals=_t(yn), chunk=128)
    xla = TG.point2point_signed(*args, backend="xla", y_normals=_t(yn), chunk=128)
    for a, b in zip(auto, xla):
        assert torch.equal(a, b)
    for backend in ("pallas", "cluster"):
        with pytest.raises(ValueError, match="y_normals"):
            TG.point2point_signed(*args, backend=backend, y_normals=_t(yn))
    want = JG.point2point_signed(*(jnp.asarray(a) for a in (x, y, xn, yn, yv)), chunk=128)
    _assert_values(auto[1].numpy(), want[1], "x2y", x, y)
    with pytest.raises(ValueError):
        TG.point2point_signed(*args, backend="nope")


def _heightfield(n=55, seed=9):
    """A bumpy n x n grid surface: n^2 verts, 2 (n-1)^2 faces."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    z = 0.1 * np.sin(6 * u) * np.cos(4 * v) + 0.01 * rng.normal(size=u.shape)
    verts = np.stack([u, v, z], -1).reshape(-1, 3).astype(np.float32)
    i = np.arange(n - 1)
    a = (i[:, None] * n + i[None, :]).reshape(-1)
    faces = np.concatenate([np.stack([a, a + n, a + 1], 1), np.stack([a + 1, a + n, a + n + 1], 1)]).astype(np.int32)
    return verts, faces


def test_vertex_normals_scatter_route_matches_jax():
    """The port's one route (corner gathers, a scatter-add) against both of
    the JAX package's: its scatter route (V*F of 3025 x 5832 above its
    limit), for a batch of two meshes under autograd, and its dense-operator route on a
    sub-mesh under the limit."""
    verts, faces = _heightfield()
    assert verts.shape[0] * faces.shape[0] > JG._VN_DENSE_MAX
    vb = np.stack([verts, verts[:, [1, 0, 2]] * 1.3])
    want = np.asarray(JG.vertex_normals(jnp.asarray(vb), faces))
    tv = _t(vb, True)
    got = TG.vertex_normals(tv, faces)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    got.sum().backward()
    assert torch.isfinite(tv.grad).all()
    # JAX's dense route (V*F under its limit) on a sub-mesh: the same normals
    sub = faces[:2000]
    used = np.unique(sub)
    remap = np.full(verts.shape[0], -1)
    remap[used] = np.arange(used.size)
    small_v, small_f = verts[used], remap[sub].astype(np.int32)
    assert small_v.shape[0] * small_f.shape[0] <= JG._VN_DENSE_MAX
    dense = np.asarray(JG.vertex_normals(jnp.asarray(small_v), small_f))
    scatter = TG.vertex_normals(_t(small_v), small_f).numpy()
    np.testing.assert_allclose(scatter, dense, rtol=0, atol=1e-5)
