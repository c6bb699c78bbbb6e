"""The o2h scatters of kernels #7 (`nn_signed_bwd`, its o2h side) and #13
(`o2h_topk_bwd`), which share the warp-aggregated scatter of
oakink2_tamf_tpu_torch/ops/csrc/o2h_scatter_common.cuh, on contention
scenes: each frame sends its points' terms -yc_j (y_j - x_{i*}) onto the
hand rows in a pattern that stresses one part of the scatter.

Frames of the scene (778 rows; P2 points per cloud):
0. every point on one row (and, for #7's h2o side, every row on one point);
1. two rows on alternating lanes;
2. all rows distinct within any 778 consecutive points;
3. pairs of coincident points with cotangents c and -c on runs of 64
   points per row: each row's terms cancel exactly;
4. half the cotangents zero, and indices outside [0, P1) (and, on #7's h2o
   side, outside [0, P2)) with nonzero cotangents: skipped;
5. a padded, all-invalid slot: every cotangent zero.

Tolerance: the float32 sum bound. Each element of gx (and of #7's gy) is a
sum of n terms, each one rounded difference and one rounded product of
float32 operands, so any float32 summation order lies within (n + 2) u M of
the float64 sum of the same terms, u = 2^-24 and M the sum of the terms'
magnitudes; an element with no term is exactly 0. Every side (the plain
versions, the JAX package in Pallas interpret mode, the kernels) is held to
that bound against the float64 sum. JAX's #13 (`_signed_cluster_backward`)
centres y and x on the cloud's f32 mean first: two more roundings per term,
of |y - ctr| and |x - ctr|, which its bound adds (twice, to cover the f32
mean). #13's gy (one product per element) is bit-equal between the kernel
and its plain version.

Where an o2h index lies outside [0, P1) the TPU kernels' one-hot gather
reads x as 0 and their gy_j is yc_j y_j; the port's kernels skip the point
(gy_j gets no o2h term), a case no forward produces. gy is compared with
JAX on the other points, and held to the port's contract on those.

JAX is imported inside the JAX tests: the card's machine has none.
"""

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch import _device
from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

P1 = 778
U = 2.0 ** -24
BAD_O2H = (-1, P1, P1 + 100, 2**30, -(2**31))


def _scene(seed=0, P2=2000, y_group=1):
    """(x [6, P1, 3], y [6 / y_group, P2, 3], o2h_i [6, P2], yc [6, P2],
    h2o_i [6, P1], xr [6, P1]) as numpy float32 / int32: the frames of the
    module note."""
    rng = np.random.default_rng(seed)
    F = 6
    y = rng.normal(scale=0.05, size=(F // y_group, P2, 3))
    x = rng.normal(scale=0.05, size=(F, P1, 3))
    j = np.arange(P2)
    o2h = np.stack([np.full(P2, 5), 100 + j % 2, (37 * j) % P1, (j // 64) % P1,
                    np.sort(rng.integers(0, P1, P2)), (j // 16) % P1])
    yc = rng.normal(size=(F, P2))
    half = P2 // 2
    y[3 // y_group, 1 : 2 * half : 2] = y[3 // y_group, 0 : 2 * half : 2]
    yc[3, 1 : 2 * half : 2] = -yc[3, 0 : 2 * half : 2]
    yc[4, rng.random(P2) < 0.5] = 0.0
    bad = rng.choice(P2, len(BAD_O2H), replace=False)
    o2h[4, bad] = BAD_O2H
    yc[4, bad] = 1.0 + rng.random(len(BAD_O2H))
    yc[5] = 0.0
    h2o = rng.integers(0, P2, (F, P1))
    h2o[0] = 7
    xr = rng.normal(size=(F, P1))
    xr[:, ::7] = 0.0
    h2o[4, [3, 10]] = (-1, 2**30)
    xr[4, [3, 10]] = 1.5
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    i32 = lambda a: np.ascontiguousarray(a, np.int32)  # noqa: E731
    return f32(x), f32(y), i32(o2h), f32(yc), i32(h2o), f32(xr)


def _exact(x, y, o2h_i, yc, h2o_i=None, xr=None, y_group=1):
    """float64 (sum, magnitude, count) of every element of gx [F, P1, 3] and
    gy [F, P2, 3]: the o2h terms, and with h2o_i the h2o terms of #7."""
    F, P2 = yc.shape
    xf, yf = x.astype(np.float64), np.repeat(y, y_group, axis=0).astype(np.float64)
    gx, gy = [np.zeros((F, P1, 3)) for _ in range(3)], [np.zeros((F, P2, 3)) for _ in range(3)]

    def add(acc, f, k, t):
        np.add.at(acc[0], (f, k), t)
        np.add.at(acc[1], (f, k), np.abs(t))
        np.add.at(acc[2], (f, k), 1.0)

    f, j = np.nonzero((yc != 0) & (o2h_i >= 0) & (o2h_i < P1))
    i = o2h_i[f, j]
    t = yc[f, j, None].astype(np.float64) * (yf[f, j] - xf[f, i])
    add(gx, f, i, -t)
    add(gy, f, j, t)
    if h2o_i is not None:
        f, i = np.nonzero((xr != 0) & (h2o_i >= 0) & (h2o_i < P2))
        j = h2o_i[f, i]
        v = xr[f, i, None].astype(np.float64) * (xf[f, i] - yf[f, j])
        add(gx, f, i, v)
        add(gy, f, j, -v)
    return tuple(gx), tuple(gy)


def _assert_sum_bound(got, exact, extra=0.0, where=None):
    """|got - sum| <= (n + 2) u M (+ extra) elementwise, on `where` points."""
    s, m, n = exact
    err = np.abs(np.asarray(got, np.float64) - s)
    over = err > (n + 2) * U * m + extra
    if where is not None:
        over &= where[..., None]
    assert not over.any(), (np.argwhere(over)[:5], err[over][:5], m[over][:5])


def _t(a):
    return torch.from_numpy(a)


def _centring_extra(x, y, o2h_i, yc):
    """2 u sum |yc_j| (|y_j - ctr| + |x_{i*} - ctr|) per element of gx and of
    gy: the two centring roundings of each term of JAX's cluster backward."""
    F, P2 = yc.shape
    xf, yf = x.astype(np.float64), y.astype(np.float64)
    ctr = yf.mean(axis=1, keepdims=True)
    f, j = np.nonzero((yc != 0) & (o2h_i >= 0) & (o2h_i < P1))
    i = o2h_i[f, j]
    e = 2 * U * np.abs(yc[f, j, None]) * (np.abs(yf[f, j] - ctr[f, 0]) + np.abs(xf[f, i] - ctr[f, 0]))
    ex, ey = np.zeros((F, P1, 3)), np.zeros((F, P2, 3))
    np.add.at(ex, (f, i), e)
    ey[f, j] = e
    return ex, ey


@pytest.mark.parametrize("P2", [100, 2000, 8192])
def test_plain_nn_signed_backward_within_the_sum_bound(P2):
    """#7's plain version (the CPU path of nn_signed_backward, no launch) at
    grad_y True and False, y_group 1 and 2: gx and gy within the float32
    sum bound of the float64 sums, out-of-range indices skipped."""
    before = CS.BWD_KERNEL.launches
    for grad_y, y_group in ((False, 1), (True, 1), (False, 2)):
        x, y, o2h, yc, h2o, xr = _scene(P2, P2=P2, y_group=y_group)
        gx, gy = CS.nn_signed_backward(*map(_t, (x, y, h2o, o2h, xr, yc)), grad_y, y_group)
        ex, ey = _exact(x, y, o2h, yc, h2o, xr, y_group)
        _assert_sum_bound(gx.numpy(), ex)
        if grad_y:
            _assert_sum_bound(gy.numpy(), ey)
        else:
            assert gy is None
    assert CS.BWD_KERNEL.launches == before


@pytest.mark.parametrize("P2", [100, 2000, 8192])
def test_plain_o2h_backward_within_the_sum_bound(P2):
    """#13's plain version (the CPU path of o2h_topk_backward, no launch):
    gx within the float32 sum bound, gy the one rounded product per point
    (0 where the cotangent is 0 or the index out of range)."""
    before = CC.O2H_BWD_KERNEL.launches
    x, y, o2h, yc, _, _ = _scene(P2 + 1, P2=P2)
    for grad_y in (False, True):
        gx, gy = CC.o2h_topk_backward(_t(x), _t(y), _t(o2h), _t(yc), grad_y)
        ex, _ = _exact(x, y, o2h, yc)
        _assert_sum_bound(gx.numpy(), ex)
        if grad_y:
            ok = ((yc != 0) & (o2h >= 0) & (o2h < P1))[..., None]
            at = np.where(ok[..., 0], o2h, 0)
            want = np.where(ok, yc[..., None] * (y - np.take_along_axis(x, at[..., None], 1)), 0.0)
            np.testing.assert_array_equal(gy.numpy(), want.astype(np.float32))
        else:
            assert gy is None
    assert CC.O2H_BWD_KERNEL.launches == before


@pytest.mark.parametrize("grad_y,y_group", [(False, 1), (True, 1), (False, 2)])
def test_plain_nn_signed_backward_matches_nn_backward_interpret(grad_y, y_group):
    """#7's plain version and the TPU's `_nn_backward` (interpret mode) on
    the contention scene: both within the float32 sum bound of the float64
    sums; gy compared where the o2h index is in range (module note)."""
    import jax.numpy as jnp

    from oakink2_tamf_tpu.ops import chamfer_pallas as JCP

    x, y, o2h, yc, h2o, xr = _scene(11, y_group=y_group)
    jgx, jgy = JCP._nn_backward(*map(jnp.asarray, (x, y, h2o, o2h, xr, yc)), 512, True, grad_y, y_group)
    gx, gy = CS.backward_plain(*map(_t, (x, y, h2o, o2h, xr, yc)), grad_y, y_group)
    ex, ey = _exact(x, y, o2h, yc, h2o, xr, y_group)
    _assert_sum_bound(np.asarray(jgx), ex)
    _assert_sum_bound(gx.numpy(), ex)
    if not grad_y:
        assert gy is None and jgy is None
        return
    in_range = ~((yc != 0) & ((o2h < 0) | (o2h >= P1)))
    _assert_sum_bound(np.asarray(jgy), ey, where=in_range)
    _assert_sum_bound(gy.numpy(), ey)
    assert (~in_range).sum() == len(BAD_O2H)


@pytest.mark.parametrize("grad_y", [False, True])
def test_plain_o2h_backward_matches_signed_cluster_backward_interpret(grad_y):
    """#13's plain version and the TPU's `_signed_cluster_backward`
    (interpret mode; the h2o side given zero cotangents, every x tile a
    candidate of every cell, the rows in the caller's order) on the
    contention scene: gx and gy within the float32 sum bound, JAX's with its
    centring term; gy compared where the index is in range (module note)."""
    import jax.numpy as jnp

    from oakink2_tamf_tpu.ops import chamfer_cluster as JC

    x, y, o2h, yc, _, _ = _scene(12)
    F, P2 = yc.shape
    P1p, C = -(-P1 // 128) * 128, -(-P2 // CC.S_CELL)
    T = P1p // 128
    xT = np.pad(x.transpose(0, 2, 1), ((0, 0), (0, 0), (0, P1p - P1)))
    cidx = np.zeros((F, T, 1), np.int32)
    cidx_y = np.ascontiguousarray(np.broadcast_to(np.arange(T, dtype=np.int32), (F, C, T)))
    jgx, jgy = JC._signed_cluster_backward(
        jnp.asarray(xT), jnp.asarray(y.transpose(0, 2, 1)), jnp.asarray(cidx), jnp.asarray(cidx_y),
        jnp.zeros((F, P1p), jnp.int32), jnp.asarray(o2h), jnp.zeros((F, P1p), jnp.float32),
        jnp.asarray(yc), True, grad_y)
    gx, gy = CC.plain_o2h_backward(*map(_t, (x, y, o2h, yc)), grad_y)
    ex, ey = _exact(x, y, o2h, yc)
    cx, cy = _centring_extra(x, y, o2h, yc)
    _assert_sum_bound(gx.numpy(), ex)
    _assert_sum_bound(np.asarray(jgx).transpose(0, 2, 1)[:, :P1], ex, extra=cx)
    if not grad_y:
        assert gy is None and jgy is None
        return
    in_range = ~((yc != 0) & ((o2h < 0) | (o2h >= P1)))
    _assert_sum_bound(gy.numpy(), ey)
    _assert_sum_bound(np.asarray(jgy).transpose(0, 2, 1), ey, extra=cy, where=in_range)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _device.set_fp32_precision()


@pytest.mark.cuda
@pytest.mark.parametrize("P2", [100, 2000, 8192])
def test_cuda_nn_signed_backward_on_contention_scenes(P2):
    """Kernel #7 on the card against its plain version (on the card) on the
    contention scene at grad_y True and False, y_group 1 and 2: both within
    the float32 sum bound of the float64 sums; one launch per call."""
    _cuda_or_skip()
    for grad_y, y_group in ((False, 1), (True, 1), (False, 2)):
        x, y, o2h, yc, h2o, xr = _scene(P2 + 2, P2=P2, y_group=y_group)
        ops = [_t(a).cuda() for a in (x, y, h2o, o2h, xr, yc)]
        before = CS.BWD_KERNEL.launches
        gx, gy = CS.backward_launch(*ops, grad_y, y_group)
        assert CS.BWD_KERNEL.launches == before + 1
        px, py = CS.backward_plain(*ops, grad_y, y_group)
        ex, ey = _exact(x, y, o2h, yc, h2o, xr, y_group)
        for a in (gx, px):
            _assert_sum_bound(a.cpu().numpy(), ex)
        if grad_y:
            for a in (gy, py):
                _assert_sum_bound(a.cpu().numpy(), ey)
        else:
            assert gy is None


@pytest.mark.cuda
@pytest.mark.parametrize("P2", [100, 2000, 8192])
def test_cuda_o2h_backward_on_contention_scenes(P2):
    """Kernel #13 on the card against its plain version (on the card) on the
    contention scene: gx within the float32 sum bound, gy bit-equal; one
    launch per call."""
    _cuda_or_skip()
    x, y, o2h, yc, _, _ = _scene(P2 + 3, P2=P2)
    ops = [_t(a).cuda() for a in (x, y, o2h, yc)]
    ex, _ = _exact(x, y, o2h, yc)
    for grad_y in (False, True):
        before = CC.O2H_BWD_KERNEL.launches
        gx, gy = CC.launch_o2h_backward(*ops, grad_y)
        assert CC.O2H_BWD_KERNEL.launches == before + 1
        px, py = CC.plain_o2h_backward(*ops, grad_y)
        for a in (gx, px):
            _assert_sum_bound(a.cpu().numpy(), ex)
        if grad_y:
            assert torch.equal(gy, py)
        else:
            assert gy is None
