"""The frozen reference agrees with the port's plain CPU path at a tiny size,
and its searches with a float64 brute force."""

import pytest
import torch

from benchmark.reference import geometry as RG
from benchmark.tests.tiny import CELLS, run_tiny

# At 16 frames of 256 points one nearest-point tie decided otherwise by the
# port's exact-arithmetic search and the reference's expanded-form search
# moves a loss by ~1e-5 of itself; at the cells' sizes such a point weighs
# 500x less. Every other difference is float32 rounding.
TINY_TOL = 2e-4


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(cell):
    checks = run_tiny(cell)["checks"]
    for name, c in checks.items():
        assert c["value"] <= TINY_TOL, (cell, name, c["value"])


def _brute(x, y, y_group):
    """float64 nearest distances both ways, frame f against cloud f // y_group."""
    yf = y.double()[torch.arange(x.shape[0]) // y_group]
    d = torch.cdist(x.double(), yf)
    return d.min(dim=2), d.min(dim=1)


def test_reference_searches_against_float64():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 50, 3, generator=g) * 0.1
    y = torch.randn(3, 70, 3, generator=g) * 0.1
    n = torch.nn.functional.normalize(torch.randn(6, 50, 3, generator=g), dim=-1)
    live = torch.tensor([True, True, False, True, True, True])
    (h_min, h_arg), (o_min, o_arg) = _brute(x, y, 2)
    h2o = RG.h2o(x, y, None, 2, live)
    o2h, h2o_s = RG.signed(x, y, n, None, 2, live)
    assert torch.allclose(h2o[live].double(), h_min[live], atol=1e-6)
    assert torch.allclose(h2o_s[live].double(), h_min[live], atol=1e-6)
    assert torch.allclose(o2h[live].abs().double(), o_min[live], atol=1e-6)
    assert (h2o[~live] == 0).all() and (o2h[~live] == 0).all()
    yf = y[torch.arange(6) // 2]
    sign = torch.sign(((yf - x[torch.arange(6)[:, None], o_arg]) * n[torch.arange(6)[:, None], o_arg]).sum(-1))
    assert torch.equal(torch.sign(o2h[live]), sign[live].float())


def test_reference_pair_gradient_is_the_unit_offset():
    a = torch.tensor([[0.3, 0.4, 0.0], [1.0, 1.0, 1.0]], requires_grad=True)
    b = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    RG.pair_dist(a, b).sum().backward()
    assert torch.allclose(a.grad, torch.tensor([[0.6, 0.8, 0.0], [0.0, 0.0, 0.0]]))
