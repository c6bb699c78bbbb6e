"""The all-pairs h2o searches (oakink2_tamf_tpu_torch.ops.chamfer_nn: `h2o_nn`
and `h2o_nn_dvec`, kernels #1 and #4, csrc/h2o_nn.cu and csrc/h2o_nn_dvec.cu
on the cell search of csrc/h2o_cells_common.cuh) on a tie scene.

The kernels list the 128-point cells of each cloud that hold a valid point
(`cell_flags`) and search only those, ascending; the plain versions search
every point. Skipping a cell of invalid points is exact (its points sit at
FAR, d ~ 3e30 > BIG, and never lower a row), so values, first-min indices
and dvec must not move. The scene holds what can break that: 778 rows (a
10-row last region), 2000 points (an 80-point last cell), y_group 3; exact
copies of every 7th point at +1 (the same cell), +128 and +256 (the next
cells) in clouds 0 and 3, so minima tie across cells and the first copy in
ascending order must win; a ragged cloud (1), an all-invalid cloud (2), a
cloud (3) whose middle cell is all-invalid with valid cells after it (a
copy there is skipped and the next valid one must win), and x_valid=False
frames, which the all-pairs route searches like the others.

Tolerances: the plain versions against each other and the kernels against
the plain versions are bit-equal (one pinned pair function, the same first
minimum); against the JAX kernels (Pallas interpret mode) the bounds of
tests/test_torch_h2o.py and tests/test_torch_h2o_grad.py: distances rtol
1e-5 / atol 1e-6, dvec atol 1e-6 (the TPU forms ||x-y||^2 by expansion).
"""

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
from oakink2_tamf_tpu_torch.utils.pc_util import spatial_sort_indices

RTOL, ATOL = 1e-5, 1e-6
DVEC_ATOL = 1e-6
MID_CELL = 7  # cloud 3's all-invalid middle cell (points 896..1023)


def _scene(seed=0, G=4, L=3, P1=778, P2=2000):
    """(x, y, y_valid, x_valid, y_group) on the CPU: hand-sized 128-row
    clusters near spatially sorted clouds. Clouds 0 and 3 have exact copies
    of every 7th point at +1, +128 and +256; cloud 1 is ragged; cloud 2
    all-invalid; cloud 3's cell MID_CELL all-invalid. Frames 1 and 10 are
    x_valid=False."""
    rng = np.random.default_rng(seed)
    y = rng.normal(scale=0.05, size=(G, P2, 3))
    for g in range(G):
        y[g] = y[g][spatial_sort_indices(y[g])]
    j = np.arange(0, P2 - 256, 7)
    for off in (1, 128, 256):
        for g in (0, 3):
            y[g, j + off] = y[g, j]
    F = G * L
    centers = rng.normal(scale=0.05, size=(F, 7, 3))
    x = centers[:, np.minimum(np.arange(P1) // 128, 6)] + rng.normal(scale=0.01, size=(F, P1, 3))
    yv = np.ones((G, P2), bool)
    yv[1, P2 // 3 :] = False
    yv[2] = False
    yv[3, MID_CELL * 128 : (MID_CELL + 1) * 128] = False
    xv = np.ones(F, bool)
    xv[[1, 10]] = False
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    return t(x), t(y), torch.from_numpy(yv), torch.from_numpy(xv), L


def _took(yv, L):
    """Frames whose cloud has a valid point (x_valid plays no part)."""
    return yv.any(dim=1).repeat_interleave(L)


def _flags_oracle(yv: np.ndarray) -> np.ndarray:
    """[G, C] uint8 in numpy: a cell holds a valid point."""
    G, P2 = yv.shape
    C = -(-P2 // 128)
    return np.array([[yv[g, 128 * c : 128 * (c + 1)].any() for c in range(C)] for g in range(G)], np.uint8)


@pytest.fixture(scope="module")
def plain():
    """(d, idx, d4, dvec) of the plain versions on the scene, through the
    wrappers on CPU tensors."""
    x, y, yv, _, L = _scene()
    before = (NN.KERNEL.launches, NN.DVEC_KERNEL.launches)
    out = (*NN.h2o_nn(x, y, yv, L), *NN.h2o_nn_dvec(x, y, yv, L))
    assert (NN.KERNEL.launches, NN.DVEC_KERNEL.launches) == before  # CPU tensors: no kernel
    return out


def test_plain_scene_ties_skips_and_edges(plain):
    """The scene does what it is for: live rows tie across cells, the flags
    drop cloud 3's middle cell and all of cloud 2, and some row's minimum
    reaches a copy of a point past the invalid cell; rows against the
    all-invalid cloud come out (BIG, 0, dvec 0); x_valid=False frames are
    searched like the others; #1 and #4 agree bit for bit."""
    x, y, yv, xv, L = _scene()
    d, idx, d4, dvec = plain
    took = _took(yv, L)
    xs, y4, ctr = NN.prepare(x, y, yv, L)
    d2 = NN.sq_norm_rn(NN.centred_x(xs, ctr, L)[:, :, None, :] - y4[..., :3].repeat_interleave(L, 0)[:, None])
    ties = (d2 == d[..., None]).sum(-1) > 1
    assert int(ties[took].sum()) > 100
    flags = NN.cell_flags(y4)
    assert flags[3, MID_CELL] == 0 and int(flags[3].sum()) == flags.shape[1] - 1 and int(flags[2].sum()) == 0
    cloud3 = slice(3 * L, 4 * L)
    assert bool((idx[cloud3] >= (MID_CELL + 1) * 128).any())
    assert bool((d[~took] == NN.BIG).all() and (idx[~took] == 0).all() and (dvec[~took] == 0).all())
    assert bool((d[~xv & took] < 1.0).all())  # searched: a real minimum, not BIG
    assert torch.equal(d, d4)


def test_plain_first_min_is_the_first_valid_copy(plain):
    """Each live row's index is the first point in ascending order at the
    row's minimum among the valid points (the contract the kernels keep by
    listing cells ascending and re-scanning the winning segment)."""
    x, y, yv, _, L = _scene()
    d, idx, _, _ = plain
    xs, y4, ctr = NN.prepare(x, y, yv, L)
    d2 = NN.sq_norm_rn(NN.centred_x(xs, ctr, L)[:, :, None, :] - y4[..., :3].repeat_interleave(L, 0)[:, None])
    took = _took(yv, L)
    first = torch.argmax((d2 == d[..., None]).to(torch.uint8), dim=-1)  # argmax returns the first maximum
    assert torch.equal(idx[took].long(), first[took])


@pytest.mark.parametrize("tile", [128, 2048])
def test_plain_all_pairs_equals_plain_cull_at_an_all_ones_mask(tile):
    """The plain all-pairs search is bit-equal to the plain culled search
    under a mask that keeps every block, on live frames (x_valid and a valid
    point): #4's values and dvec are #3's with nothing culled."""
    x, y, yv, xv, L = _scene()
    ops = NN.prepare(x, y, yv, L)
    F, P1, _ = x.shape
    mask = torch.ones((F, -(-P1 // 128), -(-y.shape[1] // tile)), dtype=torch.int32)
    d3, dvec3 = CU.plain_dvec(*ops, mask, L, tile)
    d2 = CU.plain(*ops, mask, L, tile)
    d4, dvec4 = NN.plain_dvec(*ops, L)
    d1, _ = NN.plain(*ops, L)
    live = xv & _took(yv, L)
    assert torch.equal(d4[live], d3[live]) and torch.equal(dvec4[live], dvec3[live])
    assert torch.equal(d1[live], d2[live])


@pytest.mark.parametrize("kernel", ["h2o_nn", "h2o_nn_dvec"])
def test_plain_all_pairs_matches_pallas_interpret(kernel):
    """#1 / #4's plain versions against the JAX forwards `_nn_h2o_forward` /
    `_nn_h2o_dvec_forward` (interpret mode, tile 512) on the frames of
    clouds 2 (all-invalid) and 3 (ties, an invalid middle cell), x_valid
    ignored on both sides: distances rtol 1e-5 / atol 1e-6, first-min
    indices equal (#1), dvec atol 1e-6 (#4). JAX is imported here: the
    card's machine, which runs this file's cuda tests, has none."""
    import jax.numpy as jnp

    from oakink2_tamf_tpu.ops import chamfer_pallas as JCP

    x, y, yv, _, L = _scene()
    frames = slice(2 * L, 4 * L)
    x, y, yv = x[frames], y[2:4].contiguous(), yv[2:4]
    jx, jy, jyv = jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), jnp.asarray(yv.numpy())
    took = _took(yv, L).numpy()
    dist = lambda d: np.sqrt(np.maximum(np.asarray(d, np.float64), 0.0))  # noqa: E731
    if kernel == "h2o_nn":
        jd, jidx = JCP._nn_h2o_forward(jx, jy, jyv, 512, True, L)
        d, idx = NN.h2o_nn(x, y, yv, L)
        np.testing.assert_array_equal(idx.numpy()[took], np.asarray(jidx)[took])
    else:
        jd, jdvec = JCP._nn_h2o_dvec_forward(jx, jy, jyv, 512, True, L)
        d, dvec = NN.h2o_nn_dvec(x, y, yv, L)
        jdv = np.swapaxes(np.asarray(jdvec), 1, 2)[:, : x.shape[1]]
        np.testing.assert_allclose(dvec.numpy()[took], jdv[took], rtol=0, atol=DVEC_ATOL)
        assert np.all(dvec.numpy()[~took] == 0.0)
    np.testing.assert_allclose(dist(d)[took], dist(jd)[took], rtol=RTOL, atol=ATOL)
    assert np.all(d.numpy()[~took] == np.float32(NN.BIG))


@pytest.mark.parametrize("P2", [1, 127, 128, 129, 2000])
def test_cell_flags_match_a_numpy_oracle(P2):
    """cell_flags of prepared clouds against the flags read off y_valid in
    numpy, at ragged and whole last cells; chamfer_cluster keeps the name."""
    rng = np.random.default_rng(P2)
    G = 5
    yv = rng.random((G, P2)) < 0.02  # sparse: some cells hold no valid point
    yv[0] = True
    yv[1] = False
    yv[2, -1] = True  # a valid point only in the last cell
    y = torch.from_numpy(rng.normal(size=(G, P2, 3)).astype(np.float32))
    _, y4, _ = NN.prepare(torch.zeros(G, 3, 3), y, torch.from_numpy(yv), 1)
    flags = NN.cell_flags(y4)
    assert flags.dtype == torch.uint8
    np.testing.assert_array_equal(flags.numpy(), _flags_oracle(yv))
    assert CC.cell_flags is NN.cell_flags


@pytest.mark.parametrize("launch", ["launch", "launch_dvec"])
def test_launch_refuses_cpu_tensors(launch):
    """The launchers take CUDA tensors only: on CPU operands they raise
    before launching (only the public wrappers choose the plain version,
    from the tensors' device), and count nothing."""
    ops = NN.prepare(torch.zeros(2, 130, 3), torch.ones(1, 300, 3), None, 2)
    before = (NN.KERNEL.launches, NN.DVEC_KERNEL.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(NN, launch)(*ops, 2)
    assert (NN.KERNEL.launches, NN.DVEC_KERNEL.launches) == before


def _cuda_scene(y_group):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from oakink2_tamf_tpu_torch import _device

    _device.set_fp32_precision()
    x, y, yv, xv, L = _scene()
    if y_group == 1:  # one cloud per frame
        y, yv, L = y.repeat_interleave(L, 0), yv.repeat_interleave(L, 0), 1
    return x.cuda(), y.cuda(), yv.cuda(), xv.cuda(), L


@pytest.mark.cuda
@pytest.mark.parametrize("y_group", [3, 1])
def test_cuda_all_pairs_kernels_match_plain_versions(y_group):
    """#1 and #4 on the scene: values, first-min indices and dvec bit-equal
    to the plain versions (the full search); #4's values equal #1's."""
    x, y, yv, _, L = _cuda_scene(y_group)
    ops = NN.prepare(x, y, yv, L)
    d, idx = NN.launch(*ops, L)
    d4, dvec = NN.launch_dvec(*ops, L)
    pd, pidx = NN.plain(*ops, L)
    pd4, pdvec = NN.plain_dvec(*ops, L)
    assert torch.equal(d, pd) and torch.equal(idx, pidx)
    assert torch.equal(d4, pd4) and torch.equal(dvec, pdvec)
    assert torch.equal(d, d4)


@pytest.mark.cuda
def test_cuda_all_pairs_dvec_equals_cull_dvec_on_live_frames():
    """#4 equals #3 (its cull mask at the default tile) on live frames, and
    the wrappers on CUDA tensors launch the kernels."""
    x, y, yv, xv, L = _cuda_scene(3)
    before = (NN.KERNEL.launches, NN.DVEC_KERNEL.launches)
    d4, dvec4 = NN.h2o_nn_dvec(x, y, yv, L)
    d1, _ = NN.h2o_nn(x, y, yv, L)
    assert (NN.KERNEL.launches, NN.DVEC_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    d3, dvec3 = CU.h2o_cull_dvec(x, y, yv, y_group=L, x_valid=xv)
    live = xv & _took(yv, L)
    assert torch.equal(d4[live], d3[live]) and torch.equal(dvec4[live], dvec3[live]) and torch.equal(d1, d4)
