"""The culled h2o searches (oakink2_tamf_tpu_torch.ops.chamfer_cull: `h2o_cull`
and `h2o_cull_dvec`, kernels #2 and #3, csrc/h2o_cull.cu and
csrc/h2o_cull_dvec.cu on the cell search of csrc/h2o_cells_common.cuh) at
the mask tiles the port may run: the default 128 points, one 128-point
cell per mask entry, and coarser tiles up to the JAX kernel's 2048.

The mask is exact at any tile: a culled block's pairs are strictly farther
than each row's minimum, so neither the values nor the first-min indices
(hence dvec) may move with the tile. The scene holds what can break that:
778 rows (a 10-row last region), 4000 points (a 32-point last cell), y_group
3, a ragged cloud, an all-invalid cloud, a far cloud (its mask keeps few
blocks), x_valid=False frames, and a cloud whose every 7th point has exact
copies at +1 (the same cell), +128 and +256 (the next cells), so that
minima tie across cells and the first copy in ascending order must win.

The mask kernel (csrc/h2o_cull_mask.cu, `launch_mask`) writes the flags
that `plain_mask` computes, from the same region statistics, by the direct
difference instead of the expansion: its flags may differ only on blocks
whose margin lies within rounding of the threshold, held here at 1e-5 m of
the float64 margin, on scenes at y_group 1 and 160 with 4000 points (a
ragged last tile at every tile tried).

Tolerances: the plain versions at two tiles and the kernels against the
plain versions are bit-equal (one pinned pair function, the same first
minimum); against the JAX kernel (Pallas interpret mode) the bounds of
tests/test_torch_h2o.py and tests/test_torch_h2o_grad.py: distances rtol
1e-5 / atol 1e-6, dvec atol 1e-6 (the TPU forms ||x-y||^2 by expansion).
"""

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
from oakink2_tamf_tpu_torch.utils.pc_util import spatial_sort_indices

TILES = (128, 512, 2048)
CUDA_TILES = (128, 640, 2048)
RTOL, ATOL = 1e-5, 1e-6
DVEC_ATOL = 1e-6


def _scene(seed=0, G=4, L=3, P1=778, P2=4000):
    """(x, y, y_valid, x_valid, y_group) on the CPU: hand-sized 128-row
    clusters near spatially sorted clouds. Cloud 0 has exact copies of every
    7th point at +1, +128 and +256; cloud 1 is ragged; cloud 2 all-invalid;
    cloud 3 sits 0.3 m away. Frames 1 and 7 are x_valid=False."""
    rng = np.random.default_rng(seed)
    y = rng.normal(scale=0.05, size=(G, P2, 3))
    for g in range(G):
        y[g] = y[g][spatial_sort_indices(y[g])]
    j = np.arange(0, P2 - 256, 7)
    for off in (1, 128, 256):
        y[0, j + off] = y[0, j]
    y[3] += np.array([0.3, 0.0, 0.0])
    F = G * L
    centers = rng.normal(scale=0.05, size=(F, 7, 3))
    x = centers[:, np.minimum(np.arange(P1) // 128, 6)] + rng.normal(scale=0.01, size=(F, P1, 3))
    yv = np.ones((G, P2), bool)
    yv[1, P2 // 3 :] = False
    yv[2] = False
    xv = np.ones(F, bool)
    xv[[1, 7]] = False
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    return t(x), t(y), torch.from_numpy(yv), torch.from_numpy(xv), L


def _live(yv, xv, L):
    return xv & yv.any(dim=1).repeat_interleave(L)


def _ties(x, y, yv, xv, L, d):
    """Rows of live frames whose minimum two valid points reach exactly."""
    xs, y4, ctr = NN.prepare(x, y, yv, L)
    d2 = NN.sq_norm_rn(NN.centred_x(xs, ctr, L)[:, :, None, :] - y4[..., :3].repeat_interleave(L, 0)[:, None])
    live = _live(yv, xv, L).to(d.device)
    return int(((d2 == d[..., None]).sum(-1) > 1)[live].sum())


def _drop_mask(F, P1, P2, tile, seed):
    """[F, R, T] int32 flags 0/1/3 that drop ~40% of the blocks at random,
    region 1 of frame 3 everywhere and every block of frame 4."""
    rng = np.random.default_rng(seed)
    m = rng.choice(np.array([0, 1, 3], np.int32), size=(F, -(-P1 // 128), -(-P2 // tile)), p=[0.4, 0.3, 0.3])
    m[3, 1] = 0
    m[4] = 0
    return torch.from_numpy(m)


@pytest.fixture(scope="module")
def plain_by_tile():
    """{tile: (h2o_cull d, h2o_cull_dvec d, dvec)} of the plain versions on
    the scene (the wrappers on CPU tensors)."""
    x, y, yv, xv, L = _scene()
    out = {}
    for tile in TILES:
        kw = dict(tile=tile, y_group=L, x_valid=xv)
        out[tile] = (CU.h2o_cull(x, y, yv, **kw), *CU.h2o_cull_dvec(x, y, yv, **kw))
    return out


@pytest.mark.parametrize("tile", TILES[1:])
def test_plain_cull_is_the_same_at_every_tile(plain_by_tile, tile):
    """Values and dvec (the first minimum) of both plain versions at tile
    512 and 2048 equal those at tile 128, and h2o_cull's values equal
    h2o_cull_dvec's."""
    d, d3, dvec = plain_by_tile[tile]
    d128, d3_128, dvec128 = plain_by_tile[128]
    assert torch.equal(d, d128) and torch.equal(d3, d3_128) and torch.equal(dvec, dvec128)
    assert torch.equal(d3, d)


def test_plain_cull_scene_ties_culls_and_masks(plain_by_tile):
    """The scene does what it is for: minima tie across cells, the mask at
    tile 128 keeps fewer blocks than at 2048, and rows of x_valid=False
    frames and the all-invalid cloud come out (BIG, 0); live rows equal the
    all-pairs search's values and first-min dvec."""
    x, y, yv, xv, L = _scene()
    d, _, dvec = plain_by_tile[128]
    live = _live(yv, xv, L)
    assert _ties(x, y, yv, xv, L, d) > 100
    share = {t: CU.cull_mask(x, y, yv, t, L, xv)[live].float().mean().item() for t in (128, 2048)}
    assert 0 < share[128] < share[2048]
    assert bool((d[~live] == CU.BIG).all()) and bool((dvec[~live] == 0).all())
    da, dva = NN.h2o_nn_dvec(x, y, yv, L)
    assert torch.equal(d[live], da[live]) and torch.equal(dvec[live], dva[live])


def test_plain_cull_at_tile_128_matches_pallas_interpret():
    """h2o_cull and h2o_cull_dvec at the default tile (128) against the JAX
    culled kernels at their tile 512, interpret mode, on
    test_plain_cull_matches_pallas_interpret's scene (tests/test_torch_h2o.py)."""
    import jax.numpy as jnp

    from oakink2_tamf_tpu.ops import chamfer_cull as JCU

    rng = np.random.default_rng(1)
    F, P1, P2, L = 6, 778, 1024, 3
    y = (rng.normal(size=(2, P2, 3)) * 0.05).astype(np.float32)
    centers = rng.normal(size=(F, 7, 3)) * 0.05
    x = (centers[:, np.arange(P1) // 128] + rng.normal(size=(F, P1, 3)) * 0.01).astype(np.float32)
    yv = np.ones((2, P2), bool)
    yv[0, P2 // 3 :] = False
    yv[1] = False
    xv = np.array([True, False, True, True, True, False])
    jx, jy, jyv, jxv = (jnp.asarray(a) for a in (x, y, yv, xv))
    want = np.asarray(JCU.point2point_h2o_cull(jx, jy, jyv, tile=512, y_group=L, x_valid=jxv, interpret=True))
    jd, jdvec = JCU._cull_forward(jx, jy, jyv, jxv, 512, True, L, True)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    assert CU.DEFAULT_TILE == 128
    d2 = CU.h2o_cull(t(x), t(y), t(yv), y_group=L, x_valid=t(xv))
    d3, dvec = CU.h2o_cull_dvec(t(x), t(y), t(yv), y_group=L, x_valid=t(xv))
    live = np.repeat(yv.any(1), L) & xv
    dist = lambda d: np.sqrt(np.maximum(np.asarray(d, np.float64), 0.0))  # noqa: E731
    np.testing.assert_allclose(dist(d2)[live], want[live], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dist(d3)[live], dist(jd)[live], rtol=RTOL, atol=ATOL)
    jdv = np.swapaxes(np.asarray(jdvec), 1, 2)[:, :P1]
    np.testing.assert_allclose(dvec.numpy()[live], jdv[live], rtol=0, atol=DVEC_ATOL)
    assert np.all(d2.numpy()[~live] == np.float32(CU.BIG)) and np.all(dvec.numpy()[~live] == 0.0)
    np.testing.assert_allclose(want[~live], np.sqrt(1e30), rtol=1e-6)


@pytest.mark.parametrize("tile", [0, 64, 200, 2000])
def test_launch_refuses_a_tile_that_is_not_a_multiple_of_128(tile):
    L = 2
    ops = NN.prepare(torch.zeros(2, 130, 3), torch.ones(1, 300, 3), None, L)
    mask = torch.ones((2, 2, 1), dtype=torch.int32)
    before = (CU.KERNEL.launches, CU.DVEC_KERNEL.launches)
    with pytest.raises(ValueError, match="multiple of 128"):
        CU.launch(*ops, mask, L, tile)
    with pytest.raises(ValueError, match="multiple of 128"):
        CU.launch_dvec(*ops, mask, L, tile)
    assert (CU.KERNEL.launches, CU.DVEC_KERNEL.launches) == before


def _cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from oakink2_tamf_tpu_torch import _device

    _device.set_fp32_precision()
    return tuple(t.cuda() if torch.is_tensor(t) else t for t in _scene())


def _assert_kernels_match_plain(ops, mask, L, tile):
    d = CU.launch(*ops, mask, L, tile)
    d3, dvec = CU.launch_dvec(*ops, mask, L, tile)
    assert torch.equal(d, CU.plain(*ops, mask, L, tile))
    pd, pdvec = CU.plain_dvec(*ops, mask, L, tile)
    assert torch.equal(d3, pd) and torch.equal(dvec, pdvec)
    return d, d3, dvec


@pytest.mark.cuda
@pytest.mark.parametrize("tile", CUDA_TILES)
def test_cuda_cull_kernels_match_plain_versions(tile):
    """#2 and #3 on the scene under its own mask: bit-equal to the plain
    versions, and at every tile to #3 at tile 2048 and to #4 (the
    all-pairs dvec search) on live frames."""
    x, y, yv, xv, L = _cuda_scene()
    ops = NN.prepare(x, y, yv, L)
    d, d3, dvec = _assert_kernels_match_plain(ops, CU.cull_mask(x, y, yv, tile, L, xv), L, tile)
    ref = CU.launch_dvec(*ops, CU.cull_mask(x, y, yv, 2048, L, xv), L, 2048)
    assert torch.equal(d3, ref[0]) and torch.equal(dvec, ref[1]) and torch.equal(d, d3)
    live = _live(yv, xv, L)
    da, dva = NN.launch_dvec(*ops, L)
    assert torch.equal(d3[live], da[live]) and torch.equal(dvec[live], dva[live])
    assert _ties(x, y, yv, xv, L, d) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("tile", CUDA_TILES)
def test_cuda_cull_kernels_under_cell_dropping_masks(tile):
    """#2 and #3 under masks that drop ~40% of the blocks at random (the
    kernels only skip what they are told): bit-equal to the plain versions;
    rows whose every block is dropped come out (BIG, 0)."""
    x, y, yv, xv, L = _cuda_scene()
    ops = NN.prepare(x, y, yv, L)
    mask = _drop_mask(x.shape[0], x.shape[1], y.shape[1], tile, seed=tile).cuda()
    d, _, dvec = _assert_kernels_match_plain(ops, mask, L, tile)
    assert bool((d[4] == CU.BIG).all()) and bool((dvec[4] == 0).all())


def _mask_operands(**bad):
    """Operands of `launch_mask` on the CPU (L = 2, R = 2, 300 points), with
    the named ones replaced."""
    cg, rr, yc = CU.region_stats(torch.zeros(4, 130, 3), torch.ones(2, 300, 3))
    ops = dict(cg=cg, rr=rr, y=yc, y_valid=torch.ones(2, 300, dtype=torch.bool),
               x_valid=torch.ones(4, dtype=torch.bool))
    ops.update(bad)
    return ops


@pytest.mark.parametrize("tile", [0, 64, 200, 2000])
def test_launch_mask_refuses_a_tile_that_is_not_a_multiple_of_128(tile):
    before = CU.MASK_KERNEL.launches
    with pytest.raises(ValueError, match="multiple of 128"):
        CU.launch_mask(**_mask_operands(), tile=tile, y_group=2)
    assert CU.MASK_KERNEL.launches == before


@pytest.mark.parametrize("case", ["cpu", "cg_float64", "rr_int32", "y_valid_uint8", "x_valid_float",
                                  "y_strided", "x_valid_strided"])
def test_launch_mask_refuses_operands_it_does_not_take(case):
    """A CPU tensor, a wrong dtype or a non-contiguous operand raises before
    any launch."""
    ops = _mask_operands()
    bad, match = {
        "cpu": ({}, "must be a CUDA tensor"),
        "cg_float64": (dict(cg=ops["cg"].double()), "cg is torch.float64"),
        "rr_int32": (dict(rr=ops["rr"].to(torch.int32)), "rr is torch.int32"),
        "y_valid_uint8": (dict(y_valid=ops["y_valid"].to(torch.uint8)), "y_valid is torch.uint8"),
        "x_valid_float": (dict(x_valid=ops["x_valid"].float()), "x_valid is torch.float32"),
        "y_strided": (dict(y=ops["y"].transpose(0, 1).contiguous().transpose(0, 1)), "y must be contiguous"),
        "x_valid_strided": (dict(x_valid=torch.ones(8, dtype=torch.bool)[::2]), "x_valid must be contiguous"),
    }[case]
    before = CU.MASK_KERNEL.launches
    with pytest.raises(ValueError, match=match):
        CU.launch_mask(**_mask_operands(**bad), tile=128, y_group=2)
    assert CU.MASK_KERNEL.launches == before


@pytest.mark.parametrize("tile", TILES)
def test_cull_mask_on_cpu_is_the_plain_version(tile):
    """On CPU tensors `cull_mask` is `plain_mask` on `region_stats`' outputs
    and launches nothing; its flags are 0/1, 0 on x_valid=False frames and
    the all-invalid cloud."""
    x, y, yv, xv, L = _scene()
    before = CU.MASK_KERNEL.launches
    got = CU.cull_mask(x, y, yv, tile, L, xv)
    assert CU.MASK_KERNEL.launches == before
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], 7, -(-y.shape[1] // tile))
    assert torch.equal(got, CU.plain_mask(*CU.region_stats(x, y), yv, xv, tile, L))
    assert set(got.unique().tolist()) == {0, 1} and bool((got[~_live(yv, xv, L)] == 0).all())


MASK_LENGTHS = (160, 97, 40, 123)  # live frames per cloud at y_group 160; the rest mask-padded


def _cuda_mask_scene(L: int):
    """(x, y, y_valid, x_valid) on the card: `_scene`'s clouds at y_group L
    (1: 8 clouds, 160: 4 clouds whose frames past MASK_LENGTHS are
    x_valid=False), 4000 points."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from oakink2_tamf_tpu_torch import _device

    _device.set_fp32_precision()
    x, y, yv, xv, _ = _scene(G=8 if L == 1 else 4, L=L)
    if L > 1:
        for g, n in enumerate(MASK_LENGTHS):
            xv[g * L + n : (g + 1) * L] = False
    return x.cuda(), y.cuda(), yv.cuda(), xv.cuda()


def _margins(cg, rr, yc, yv, tile: int, L: int):
    """The float64 margin of every block [F, R, T]: (dmin + rr + 1e-3) -
    (d_t - rr) from the exact distances of the same centred operands (NaN
    or -inf where d_t is inf)."""
    G, P2, _ = yc.shape
    F, R = rr.shape
    T = -(-P2 // tile)
    d = ((cg.double()[:, :, None] - yc.double()[:, None]) ** 2).sum(-1).sqrt()  # [G, L*R, P2]
    d = d.masked_fill(~yv[:, None], float("inf"))
    d = torch.nn.functional.pad(d, (0, T * tile - P2), value=float("inf"))
    d = d.reshape(G, L * R, T, tile).amin(-1).reshape(F, R, T)
    r = rr.double()[:, :, None]
    return (d.amin(-1, keepdim=True) + r + 1e-3) - (d - r)


@pytest.mark.cuda
@pytest.mark.parametrize("L", (1, 160))
@pytest.mark.parametrize("tile", CUDA_TILES)
def test_cuda_mask_kernel_matches_plain_version(tile, L):
    """The mask kernel's flags equal `plain_mask`'s on every block whose
    float64 margin lies more than 1e-5 m from the threshold (the blocks that
    differ are counted and printed); x_valid=False frames and the
    all-invalid cloud come out all-zero; on a CUDA tensor `cull_mask`
    launches the kernel once."""
    x, y, yv, xv = _cuda_mask_scene(L)
    cg, rr, yc = CU.region_stats(x, y)
    got = CU.launch_mask(cg, rr, yc, yv, xv, tile, L)
    want = CU.plain_mask(cg, rr, yc, yv, xv, tile, L)
    differ = got != want
    near = _margins(cg, rr, yc, yv, tile, L).abs() <= 1e-5
    print(f"tile {tile} y_group {L}: {int(differ.sum())} of {got.numel()} blocks differ from the plain version, "
          f"{int(near.sum())} lie within 1e-5 m of the threshold")
    assert not bool((differ & ~near).any())
    assert set(got.unique().tolist()) == {0, 1}
    assert bool((got[~_live(yv, xv, L)] == 0).all())
    before = CU.MASK_KERNEL.launches
    assert torch.equal(CU.cull_mask(x, y, yv, tile, L, xv), got)
    assert CU.MASK_KERNEL.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("L", (1, 160))
@pytest.mark.parametrize("tile", CUDA_TILES)
def test_cuda_culled_searches_on_the_mask_kernel_equal_all_pairs(tile, L):
    """#2 and #3 under the mask kernel's flags (the wrappers on CUDA
    tensors): values and dvec bit-equal to h2o_nn / h2o_nn_dvec on live
    frames, (BIG, 0) elsewhere."""
    x, y, yv, xv = _cuda_mask_scene(L)
    before = CU.MASK_KERNEL.launches
    d = CU.h2o_cull(x, y, yv, tile=tile, y_group=L, x_valid=xv)
    d3, dvec = CU.h2o_cull_dvec(x, y, yv, tile=tile, y_group=L, x_valid=xv)
    assert CU.MASK_KERNEL.launches == before + 2
    live = _live(yv, xv, L)
    da, _ = NN.h2o_nn(x, y, yv, L)
    da3, dva = NN.h2o_nn_dvec(x, y, yv, L)
    assert torch.equal(d[live], da[live]) and torch.equal(d3[live], da3[live]) and torch.equal(dvec[live], dva[live])
    assert bool((d[~live] == CU.BIG).all()) and bool((dvec[~live] == 0).all())
