"""The port's h2o nearest-neighbour paths (oakink2_tamf_tpu_torch.ops and
core.geometry.point2point_h2o) against the JAX routes they replace, run as
the JAX package's own tests run them on the CPU (Pallas interpret mode).

Tolerance: the TPU kernels form ||x-y||^2 by the expansion
||x||^2 + ||y||^2 - 2 x.y, the port by direct differences; after centring
both are within rtol 1e-5 / atol 1e-6 (metres) of each other, the bound the
JAX package's own tests hold its kernels to against a direct oracle
(tests/test_chamfer_cull.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from oakink2_tamf_tpu.core import geometry as JG
from oakink2_tamf_tpu.ops import chamfer_cull as JCU
from oakink2_tamf_tpu.ops import chamfer_pallas as JCP
from oakink2_tamf_tpu_torch.core import geometry as TG
from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

RTOL, ATOL = 1e-5, 1e-6


def _scene(seed, F=4, P1=778, P2=640, y_group=2, ragged=True, all_invalid=True):
    """Hand-like 128-row clusters near an object cloud; group 0 ragged,
    the last group all-invalid (a padded object slot)."""
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


def _dist(d2):
    return np.sqrt(np.maximum(np.asarray(d2, np.float64), 0.0))


@pytest.mark.parametrize("y_group", [1, 2])
def test_plain_all_pairs_matches_pallas_interpret(y_group):
    x, y, yv = _scene(0, y_group=y_group, all_invalid=y_group > 1)
    want = np.asarray(JCP.point2point_h2o_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv), tile=512, interpret=True,
        grad_y=False, y_group=y_group,
    ))
    d2, idx = NN.h2o_nn(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(yv), y_group)
    got = _dist(d2)
    live = np.repeat(yv.any(1), y_group)
    np.testing.assert_allclose(got[live], want[live], rtol=RTOL, atol=ATOL)
    # an all-invalid cloud gives BIG (1e30 squared), never inf
    assert np.all(d2.numpy()[~live] == np.float32(NN.BIG))
    # first-min indices agree with the TPU kernel's
    _, jidx = JCP._nn_h2o_forward(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv), 512, True, y_group
    )
    np.testing.assert_array_equal(idx.numpy()[live], np.asarray(jidx)[live])


def test_plain_cull_matches_pallas_interpret():
    x, y, yv = _scene(1, F=6, P2=1024, y_group=3)
    xv = np.array([True, False, True, True, True, False])
    want = np.asarray(JCU.point2point_h2o_cull(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv), tile=512, y_group=3,
        x_valid=jnp.asarray(xv), interpret=True,
    ))
    d2 = CU.h2o_cull(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(yv),
                     tile=512, y_group=3, x_valid=torch.from_numpy(xv))
    got = _dist(d2)
    live = np.repeat(yv.any(1), 3) & xv
    np.testing.assert_allclose(got[live], want[live], rtol=RTOL, atol=ATOL)
    # culled frames and all-invalid clouds come out BIG on both sides
    assert np.all(d2.numpy()[~live] == np.float32(CU.BIG))
    np.testing.assert_allclose(want[~live], np.sqrt(1e30), rtol=1e-6)


def test_cull_mask_matches_jax():
    x, y, yv = _scene(2, F=6, P2=1536, y_group=2)
    xv = np.array([True, True, False, True, True, True])
    want = np.asarray(JCU._cull_mask(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv), 512, 2, 896, jnp.asarray(xv)
    ))
    got = CU.cull_mask(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(yv), 512, 2,
                       torch.from_numpy(xv)).numpy()
    assert got.shape == want.shape == (6, 7, 3)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1  # the scene actually culls something


def test_plain_cull_bit_identical_to_plain_all_pairs():
    x, y, yv = _scene(3, F=4, P2=2048, y_group=2, all_invalid=False)
    # a far object: most tiles cull, the values must not move
    y = y + np.float32([0.3, 0.0, 0.0])
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(yv))
    mask = CU.cull_mask(*args, 256, 2)
    assert mask.float().mean() < 1
    dc = CU.h2o_cull(*args, tile=256, y_group=2)
    da, _ = NN.h2o_nn(*args, 2)
    assert torch.equal(dc, da)


@pytest.mark.parametrize("P2", [512, 4096])
def test_point2point_h2o_routes_match_jax(P2):
    """The routed entry point with the template permutation: all-pairs below
    CULL_MIN_P2, culled at and above it. JAX runs its culled kernel in
    interpret mode at P2 >= 4096 and its exact XLA route below (its
    all-pairs Pallas route has no interpret switch there)."""
    from oakink2_tamf_tpu_torch.core.mano import hand_template_perm, synthetic_mano_model

    x, y, yv = _scene(4, F=2, P2=P2, y_group=2, all_invalid=False)
    perm = hand_template_perm(synthetic_mano_model("right").v_template)
    backend = "cull" if P2 >= TG.CULL_MIN_P2 else "xla"
    want = np.asarray(JG.point2point_h2o(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv), backend=backend, x_perm=perm,
        grad_y=False, y_group=2, interpret=True,
    ))
    got = TG.point2point_h2o(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(yv),
                             x_perm=perm, grad_y=False, y_group=2).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_point2point_h2o_is_forward_only(monkeypatch):
    """Without autograd the routed entry point stays forward only on both
    routes: it runs the min-only searches (#1/#2), never the dvec kernels of
    the differentiated route, and returns no graph."""
    x, y, yv = _scene(12, F=4, P2=640, y_group=2)

    def refuse(*args, **kwargs):
        raise AssertionError("a dvec kernel ran without autograd")

    monkeypatch.setattr(TG.chamfer_nn, "h2o_nn_dvec", refuse)
    monkeypatch.setattr(TG.chamfer_cull, "h2o_cull_dvec", refuse)
    xt = torch.from_numpy(x).requires_grad_(True)
    for backend in ("cull", "exact"):
        with torch.no_grad():
            d = TG.point2point_h2o(xt, torch.from_numpy(y), torch.from_numpy(yv),
                                   backend=backend, grad_y=False, y_group=2)
        assert d.grad_fn is None and not d.requires_grad
        assert torch.isfinite(d[:2]).all()  # group 0 is ragged, group 1 all-invalid


def test_point2point_h2o_refuses_unported_backends():
    """What the routed entry point refuses: an unknown backend, a gradient
    for a shared cloud and the culled route with grad_y
    (tests/test_torch_h2o_grad.py holds the gradients). The "xla" backend
    is ported (tests/test_torch_geometry_xla.py) and takes a shared cloud
    without grad_y: here every point is at the origin, so distance 0 and a
    zero gradient."""
    x = torch.zeros(2, 4, 3, requires_grad=True)
    y = torch.zeros(1, 8, 3)
    d = TG.point2point_h2o(x, y, backend="xla", grad_y=False, y_group=2)
    assert torch.equal(d, torch.zeros(2, 4))
    d.sum().backward()
    assert torch.equal(x.grad, torch.zeros(2, 4, 3))
    with pytest.raises(ValueError):
        TG.point2point_h2o(x, y, backend="nope", grad_y=False, y_group=2)
    with pytest.raises(NotImplementedError):
        TG.point2point_h2o(x, y, y_group=2)  # grad_y=True with a shared cloud
    with pytest.raises(NotImplementedError):
        TG.point2point_h2o(x.detach(), y, y_group=2)
    with pytest.raises(NotImplementedError):
        TG.point2point_h2o(x[:1], y, backend="cull", grad_y=True)
    with pytest.raises(ValueError):
        TG.point2point_h2o(x[:1], y, backend="nope")
