"""Kernel #12 of the cluster route (oakink2_tamf_tpu_torch.ops.chamfer_cluster:
`plain_o2h_topk` and csrc/o2h_topk.cu) on exact ties, against a numpy
reference of its contract.

The contract: each object point of a 128-point cell takes the minimum of
the pinned pair distance over the rows of its cell's candidate tiles (128
rows each), visiting the tiles in list order with a strict <, then each
tile's rows in ascending order; rows past P1 never win and a list id
outside [0, T) is skipped. It returns the first row reaching the minimum
and the sign numerator n_i . (y_j - x_i) at that row; a point that finds
nothing keeps (BIG, 0) and the numerator at row 0.

The tie scenes copy hand rows inside one 32-row segment (+1), across
segments of one tile (+34) and into the next tile (+131, which a reversed
list visits first); the normals are not copied, so the numerator tells the
copies apart. They come at ragged sizes, P1 778 (a 10-row last tile) and
P2 1000 (a 104-point last cell), or P1 300 (44 rows) and P2 700 (60
points), with an all-invalid cell (2) in every frame and an all-invalid
frame (1), and with two kinds of lists: every tile in order (k_tiles 0)
and 4 tiles in reversed order, rotated by (frame + cell). Values, indices and numerators must be bit-equal (one pair function,
one numerator).

JAX is imported inside the JAX test: the card's machine has none.
`chip_smoke.check_o2h_topk_edges` runs these scenes on the card.
"""

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch import _device
from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

S = CC.S_CELL
LISTS = ("every", "four")
SIZES = ((778, 1000), (300, 700))  # (P1, P2)


def _fma3_np(a0, b0, a1, b1, a2, b2):
    s = (a0 * b0).astype(np.float64)
    s = (a1.astype(np.float64) * b1 + s).astype(np.float32).astype(np.float64)
    return (a2.astype(np.float64) * b2 + s).astype(np.float32)


def o2h_scene(lists: str, P1: int = 778, P2: int = 1000, F: int = 3, seed: int = 0):
    """((xs, ns, y4, ctr, cidx_y) prepared as the wrapper takes them, on the
    CPU; (x, n, y, y_valid) as numpy): the tie scene of the module note with
    `lists` "every" (0..T-1) or "four" (4 tiles, reversed and rotated)."""
    rng = np.random.default_rng(seed + P1 + (lists == "four"))
    x = rng.normal(scale=0.05, size=(F, P1, 3)).astype(np.float32)
    src = np.arange(0, P1 - 131, 8)
    for off in (1, 34, 131):  # sources = 0 mod 8, copies 1, 2, 3 mod 8: no overlap
        x[:, src + off] = x[:, src]
    n = rng.normal(size=(F, P1, 3)).astype(np.float32)
    y = rng.normal(scale=0.05, size=(F, P2, 3)).astype(np.float32)
    yv = np.ones((F, P2), bool)
    yv[:, 2 * S : 3 * S] = False
    yv[1] = False
    T, C = -(-P1 // S), -(-P2 // S)
    if lists == "every":
        cidx = np.broadcast_to(np.arange(T, dtype=np.int32), (F, C, T))
    else:
        rev = np.arange(T)[::-1]
        cidx = np.array([[np.roll(rev, f + c)[:4] for c in range(C)] for f in range(F)], np.int32)
    xs, y4, ctr = NN.prepare(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(yv), 1)
    ops = (xs, torch.from_numpy(n), y4, ctr, torch.from_numpy(np.ascontiguousarray(cidx)))
    return ops, (x, n, y, yv)


def o2h_reference(xs, ns, y4, ctr, cidx):
    """(o2h_d, o2h_i, o2h_dot [F, P2], ties) of the contract in numpy: the
    pinned pair arithmetic, per listed tile its first minimum over its real
    rows (np.argmin), a strict < across the list in order from BIG, ids
    outside [0, T) skipped, the numerator at the winner (row 0 where none
    wins). `ties` counts the points whose minimum more than one listed row
    reaches."""
    xs, ns, y4, ctr, cidx = (t.cpu().numpy() for t in (xs, ns, y4, ctr, cidx))
    F, P1, _ = xs.shape
    P2 = y4.shape[1]
    C, K = cidx.shape[1:]
    T = -(-P1 // S)
    xc = xs - ctr[:, None, :]
    tiles = np.concatenate([xc, np.zeros((F, T * S - P1, 3), np.float32)], axis=1).reshape(F, T, S, 3)
    row_ok = (np.arange(T * S) < P1).reshape(T, S)
    pts = np.concatenate([y4[..., :3], np.full((F, C * S - P2, 3), 1e15, np.float32)], axis=1)
    cells = pts.reshape(F, C, 1, S, 3)
    fr = np.arange(F)[:, None]
    best = np.full((F, C, S), 1e30, np.float32)
    best_i = np.zeros((F, C, S), np.int64)
    count = np.zeros((F, C, S), np.int64)
    for k in range(K):
        t = cidx[:, :, k]
        ok = (t >= 0) & (t < T)
        tt = np.where(ok, t, 0)
        d = tiles[fr, tt][:, :, :, None, :] - cells  # [F, C, rows, points, 3]
        d2 = _fma3_np(d[..., 0], d[..., 0], d[..., 1], d[..., 1], d[..., 2], d[..., 2])
        d2 = np.where((row_ok[tt] & ok[..., None])[..., None], d2, np.inf)
        m, a = d2.min(axis=2), d2.argmin(axis=2)
        upd = m < best
        hits = (d2 == m[:, :, None, :]).sum(axis=2)
        count = np.where(upd, hits, count + (m == best) * hits)
        best = np.where(upd, m, best)
        best_i = np.where(upd, tt[..., None] * S + a, best_i)
    best, best_i, count = (a.reshape(F, -1)[:, :P2] for a in (best, best_i, count))
    xw = np.take_along_axis(xc, best_i[..., None], axis=1)
    nw = np.take_along_axis(ns, best_i[..., None], axis=1)
    dd = pts[:, :P2] - xw
    dot = _fma3_np(nw[..., 0], dd[..., 0], nw[..., 1], dd[..., 1], nw[..., 2], dd[..., 2])
    ties = int(((count > 1) & (best < 1e30)).sum())
    return best, best_i.astype(np.int32), dot, ties


def _assert_reference(got, want, y4):
    for a, b in zip(got, want[:3]):
        np.testing.assert_array_equal(a.cpu().numpy(), b)
    d, i, dot = (a.cpu() for a in got)
    dead = y4[..., 0].cpu() >= CC.FAR / 2
    assert bool(dead[1].all()) and bool(dead[:, 2 * S : 3 * S].all())
    assert bool((d[dead] == CC.BIG).all() and (i[dead] == 0).all())


@pytest.mark.parametrize("P1,P2", SIZES)
@pytest.mark.parametrize("lists", LISTS)
def test_plain_o2h_topk_takes_the_first_minimum_in_candidate_order(lists, P1, P2):
    """Also at P1 300 (a 44-row last tile) and P2 700 (a 60-point last cell)."""
    ops, _ = o2h_scene(lists, P1=P1, P2=P2)
    want = o2h_reference(*ops)
    assert want[3] > 50  # points whose minimum more than one listed row reaches
    _assert_reference(CC.plain_o2h_topk(*ops), want, ops[2])


def test_plain_o2h_topk_every_tile_equals_the_signed_pair():
    """With every tile listed (k_tiles 0), #12's plain version is the o2h
    half of #6's (ops/chamfer_signed.plain) bit for bit on the tie scene,
    dead points included."""
    (xs, ns, y4, ctr, cidx), _ = o2h_scene("every")
    got = CC.plain_o2h_topk(xs, ns, y4, ctr, cidx)
    for a, b in zip(got, CS.plain(xs, ns, y4, ctr, 1)[2:]):
        assert torch.equal(a, b)


def test_plain_o2h_topk_matches_signed_cluster_forward_interpret():
    """#12's plain version against the TPU's `_signed_cluster_forward`
    (interpret mode, k_tiles 2: the selection's lists, which are not in
    index order) on a tie scene at P1 300 (a 44-row last tile), P2 700, on
    the lists JAX selected. JAX expands the distance (|x|^2 + |y|^2 - 2 x.y)
    and the numerator (n.y - n.x): values within 1e-6, indices equal on
    every valid point whose minimum no row at another position comes within
    1e-7 of (a tie between copies is exact in both forms)."""
    import jax.numpy as jnp

    from oakink2_tamf_tpu.ops import chamfer_cluster as JC

    P1, P2 = 300, 700
    ops, (x, n, y, yv) = o2h_scene("every", P1=P1, P2=P2, seed=5)
    P1p = -(-P1 // S) * S
    xT, nT = (np.pad(a.transpose(0, 2, 1), ((0, 0), (0, 0), (0, P1p - P1))) for a in (x, n))
    out = JC._signed_cluster_forward(jnp.asarray(xT), np.arange(P1p) < P1, jnp.asarray(nT),
                                     jnp.asarray(y.transpose(0, 2, 1)), jnp.asarray(yv), 2, 2, True)
    jd, ji, js = (np.asarray(a)[:, :P2] for a in out[2:5])
    cidx = torch.from_numpy(np.asarray(out[6]).astype(np.int32))
    assert not bool((cidx == torch.arange(cidx.shape[2])).all())
    xs, ns, y4, ctr, _ = ops
    d, i, dot, ties = o2h_reference(xs, ns, y4, ctr, cidx)
    got = [a.numpy() for a in CC.plain_o2h_topk(xs, ns, y4, ctr, cidx)]
    np.testing.assert_array_equal(got[0], d)
    np.testing.assert_array_equal(got[1], i)
    np.testing.assert_array_equal(got[2], dot)
    assert ties > 50
    # the nearest listed row at another position than the winner's
    xc = (xs - ctr[:, None]).numpy()
    d2 = ((xc[:, None, :, :] - y4[..., None, :3].numpy()) ** 2).sum(-1)  # [F, P2, P1]
    listed = np.zeros(d2.shape, bool)
    tile = np.arange(P1) // S
    for k in range(cidx.shape[2]):
        listed |= tile[None, None, :] == np.repeat(cidx[:, :, k].numpy(), S, axis=1)[:, :P2, None]
    same = (xc[:, None, :, :] == np.take_along_axis(xc, i[..., None].astype(np.int64), 1)[:, :, None, :]).all(-1)
    gap = np.where(listed & ~same, d2, np.inf).min(-1) - d
    sep = yv & (gap > 1e-7)
    tied = sep & ((listed & same).sum(-1) > 1)  # copies of the winner: an exact tie in both forms
    assert tied.sum() > 50 and sep.sum() > 0.9 * yv.sum()
    np.testing.assert_array_equal(ji[sep], i[sep])
    np.testing.assert_allclose(jd[yv], d[yv], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(js[yv], dot[yv], rtol=1e-5, atol=1e-6)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _device.set_fp32_precision()


@pytest.mark.cuda
@pytest.mark.parametrize("P1,P2", SIZES)
@pytest.mark.parametrize("lists", LISTS)
def test_cuda_o2h_topk_takes_the_first_minimum_in_candidate_order(lists, P1, P2):
    """Kernel #12 on the same scenes against the reference and its plain
    version (one launch per call); then with ids out of range in the lists,
    which the kernel skips (the selection never writes one), against the
    reference."""
    _cuda_or_skip()
    ops, _ = o2h_scene(lists, P1=P1, P2=P2)
    ops = [t.cuda() for t in ops]
    before = CC.O2H_KERNEL.launches
    got = CC.launch_o2h_topk(*ops)
    assert CC.O2H_KERNEL.launches == before + 1
    _assert_reference(got, o2h_reference(*ops), ops[2])
    for a, b in zip(got, CC.plain_o2h_topk(*ops)):
        assert torch.equal(a, b)
    oor = ops[4].clone()
    oor[:, :, 0] = -1
    oor[:, 1::2, 1] = CC._cdiv(ops[0].shape[1], S) + 3
    _assert_reference(CC.launch_o2h_topk(*ops[:4], oor), o2h_reference(*ops[:4], oor), ops[2])
