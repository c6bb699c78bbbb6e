"""The region-culled fused distance loss (oakink2_tamf_tpu_torch.ops.
chamfer_loss: `plain_cull` and kernel #9, csrc/dist_loss_cull.cu) on exact
ties, against a numpy reference built on np.argmin over the kept blocks
only. No JAX: the reference is the contract itself.

The scene ties minima in both directions at the seams of the kernel's
single-pass search (256 threads x 4 columns per pass, rows in groups of 8,
regions of 128 rows): exact copies of points at +1, +32, +1024 and +2048,
of rows at +1, +8 and +128. Masks drop blocks at random (the kernel does
not know whether a mask is exact; it only skips what it is told), whole
regions, and everything of one live frame; one cloud is all-invalid and
one frame x_valid=False. Tiles 2048 (the G main path), 512 and 640 (the
kernel's 1024-column passes end at each tile's last column). Rows and
columns that searched nothing must come out zero.

Tolerances are the all-pairs kernel's own checks (tests/test_torch_dist_loss.py):
v, dh and gx_dh rtol 1e-6 / atol 1e-7 (the same float32 operations; one
ulp of a sqrt may differ), gx_do per frame 1e-5 of its norm (a scatter
summed in another order).
"""

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL

TILES = (2048, 512, 640)
BIG = 1e30


def _t(a):
    return torch.from_numpy(np.array(a))


def _tie_scene(seed, F=6, P1=300, P2=4200, y_group=2):
    """Rows, normals, clouds, GT fields, contact weights, y_valid and x_valid
    whose minima tie exactly: every 7th point has a copy at +1, +32, +1024
    or +2048; rows i + 128 copy rows i in alternate 128-row blocks, every
    16th row is copied to the next one and every 32nd to the one 8 on.
    Each row keeps its own normal, so which of two equal rows wins a column
    shows in its sign. Cloud 2 (of 3) is all-invalid, frame 1 x_valid=False."""
    rng = np.random.default_rng(seed)
    G = F // y_group
    y = rng.normal(scale=0.05, size=(G, P2, 3))
    for k, off in enumerate((1, 32, 1024, 2048)):
        j = np.arange(k, P2 - off, 7)
        y[:, j + off] = y[:, j]
    x = rng.normal(scale=0.03, size=(F, P1, 3)) + rng.normal(scale=0.02, size=(F, 1, 3))
    i = np.arange(P1 - 128)
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
    yv = np.ones((G, P2), bool)
    yv[2] = False
    xv = np.ones(F, bool)
    xv[1] = False
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(x), f32(n), f32(y), f32(og), f32(hg), f32(rng.random(P1)), yv, xv


def _mask(seed, F, P1, P2, tile):
    """[F, R, T] int32 flags 0/1/3 that drop ~40% of the blocks at random,
    region 1 of frame 2 everywhere, and every block of frame 3 (both frames
    live, on cloud 1)."""
    rng = np.random.default_rng(seed)
    R, T = -(-P1 // 128), -(-P2 // tile)
    m = rng.choice(np.array([0, 1, 3], np.int32), size=(F, R, T), p=[0.4, 0.3, 0.3])
    m[2, 1] = 0
    m[3] = 0
    return m


def _fma3_np(a0, b0, a1, b1, a2, b2):
    s = (a0 * b0).astype(np.float64)
    s = (a1.astype(np.float64) * b1 + s).astype(np.float32).astype(np.float64)
    return (a2.astype(np.float64) * b2 + s).astype(np.float32)


def _cull_reference(x, n, y4, ctr, og, hg, vw, xv, mask, y_group, tile):
    """(v, dh, gx_do, gx_dh) in numpy on prepared operands: the pinned pair
    arithmetic with the pairs of dropped blocks removed, np.argmin (the
    first minimum) both ways over what is left; a column or a row without a
    pair below BIG searched nothing and gives zeros (as do x_valid=False
    frames); the kernels' per-point formulas in float32, gx_do summed in
    float64. Also returns the masks of columns and rows that searched
    nothing on x_valid frames, and the count of columns whose nearest kept
    rows tie."""
    F, P1, _ = x.shape
    P2 = y4.shape[1]
    xc = x - np.repeat(ctr, y_group, axis=0)[:, None, :]
    yf = np.repeat(y4[..., :3], y_group, axis=0)
    d = xc[:, :, None, :] - yf[:, None, :, :]
    d2 = _fma3_np(d[..., 0], d[..., 0], d[..., 1], d[..., 1], d[..., 2], d[..., 2])
    kept = mask[:, np.arange(P1) // 128][:, :, np.arange(P2) // tile] != 0  # [F, P1, P2]
    d2 = np.where(kept, d2, np.inf)
    frames = np.arange(F)[:, None]
    i_o, j_h = np.argmin(d2, axis=1), np.argmin(d2, axis=2)
    m_o, m_h = d2.min(axis=1), d2.min(axis=2)
    live = xv.astype(bool)
    col = (m_o < BIG) & (y4[..., 0] < 5e14).repeat(y_group, axis=0) & live[:, None]
    row = (m_h < BIG) & live[:, None]
    dist = np.sqrt(np.where(col, m_o, 0)).astype(np.float32)
    dy = yf - xc[frames, i_o]
    nr = n[frames, i_o]
    sgn = np.sign(_fma3_np(nr[..., 0], dy[..., 0], nr[..., 1], dy[..., 1], nr[..., 2], dy[..., 2]))
    o = dist * sgn
    w = np.where(o < 0, np.float32(1.5), np.where((og < 0.01) & (og > -0.005), np.float32(1.0), np.float32(0.1)))
    diff = o - og
    v = np.where(col, np.abs(diff) * w, 0)
    coef = np.where(col, w * np.sign(diff) * sgn / np.maximum(dist, np.float32(1e-12)), 0)
    gx_do = np.zeros((F, P1, 3))
    np.add.at(gx_do, (np.broadcast_to(frames, i_o.shape), i_o), coef[..., None] * -dy)
    hd = np.sqrt(np.where(row, m_h, 0)).astype(np.float32)
    dh = np.where(row, np.abs(hd - np.abs(hg)) * vw, 0)
    cfh = vw * np.sign(hd - np.abs(hg)) / np.maximum(hd, np.float32(1e-12))
    gx_dh = np.where(row[..., None], cfh[..., None] * (xc - yf[frames, j_h]), 0)
    ties = int((((d2 == m_o[:, None, :]).sum(axis=1) > 1) & col).sum())
    return (v, dh, gx_do, gx_dh), ~col & live[:, None], ~row & live[:, None], ties


def _case(tile, device):
    x, n, y, og, hg, vw, yv, xv = _tie_scene(7)
    F, P1, _ = x.shape
    mask = _mask(tile, F, P1, y.shape[1], tile)
    ops = CL.prepare(*(_t(a).to(device) for a in (x, n, y, og, hg, vw, yv, xv)), 2)
    want, no_col, no_row, ties = _cull_reference(*(t.cpu().numpy() for t in ops), mask, 2, tile)
    assert ties > 100  # live columns whose nearest kept rows tie
    return ops, _t(mask).to(device), want, no_col, no_row


def _assert_reference(got, want, no_col, no_row):
    v, dh, gx_do, gx_dh = (t.cpu().numpy() for t in got)
    np.testing.assert_allclose(v, want[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dh, want[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gx_dh, want[3], rtol=1e-6, atol=1e-7)
    err = np.linalg.norm((gx_do - want[2]).reshape(len(v), -1), axis=1)
    assert np.all(err <= 1e-5 * np.linalg.norm(want[2].reshape(len(v), -1), axis=1) + 1e-6), err
    # what searched nothing is zero: whole frames (x_valid=False, every block
    # dropped, the all-invalid cloud), a dropped region's rows, lone columns
    assert no_col.sum() > 0 and no_row.sum() > 0
    assert np.all(v[no_col] == 0) and np.all(dh[no_row] == 0) and np.all(gx_dh[no_row] == 0)
    for f in (1, 3):  # x_valid=False; every block dropped
        assert all(np.all(a[f] == 0) for a in (v, dh, gx_do, gx_dh))


@pytest.mark.parametrize("tile", TILES)
def test_plain_cull_takes_the_first_minimum_over_kept_blocks(tile):
    """plain_cull against the numpy reference: a column whose nearest kept
    rows tie takes the first one's sign and sends its gradient row there;
    a row takes the first kept point; dropped blocks are never searched."""
    ops, mask, want, no_col, no_row = _case(tile, "cpu")
    _assert_reference(CL.plain_cull(*ops, mask, 2, tile), want, no_col, no_row)


@pytest.mark.parametrize("tile", TILES)
def test_plain_cull_with_every_block_kept_is_the_all_pairs_loss(tile):
    """A mask that keeps every block reduces plain_cull to plain on the
    frames that are x_valid and whose cloud has a valid point, bit for bit;
    the all-invalid cloud's frames are zero (nothing below BIG)."""
    ops, _, _, _, _ = _case(tile, "cpu")
    F, P1, _ = ops[0].shape
    ones = torch.ones((F, -(-P1 // 128), -(-ops[2].shape[1] // tile)), dtype=torch.int32)
    got, want = CL.plain_cull(*ops, ones, 2, tile), CL.plain(*ops, 2)
    live = ops[7].bool() & (ops[2][..., 0] < CL.INVALID_Y).any(dim=1).repeat_interleave(2)
    assert bool(live.any()) and not bool(live.all())
    for a, b in zip(got, want):
        assert torch.equal(a[live], b[live])
    assert all(bool((a[~live] == 0).all()) for a in got)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TILES)
def test_cuda_cull_kernel_takes_the_first_minimum_over_kept_blocks(tile):
    """Kernel #9 on the same scenes against the same reference and against
    plain_cull."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    ops, mask, want, no_col, no_row = _case(tile, "cuda")
    got = CL.launch_cull(*ops, mask, 2, tile)
    _assert_reference(got, want, no_col, no_row)
    plain = CL.plain_cull(*ops, mask, 2, tile)
    for i in (0, 1, 3):
        torch.testing.assert_close(got[i], plain[i], rtol=1e-6, atol=1e-7)
