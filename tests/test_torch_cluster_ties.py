"""Kernel #10 of the cluster route (oakink2_tamf_tpu_torch.ops.chamfer_cluster:
`plain_h2o_topk` and csrc/h2o_topk.cu) on exact ties, against a numpy
reference of its contract. No JAX: the reference is the contract itself.

The contract: each row of a 128-row tile takes the minimum over its tile's K
candidate cells (128 consecutive points each), visited in candidate order
with a strict <, then ascending within a cell; a row that finds nothing
keeps (BIG, 0). Candidate order is not index order, so on a tie the first
cell in candidate order wins, and the first point inside it. The scenes
list the cells in reversed and rotated order, copy points inside a cell
(+1) and into the next one (+128, which the reversed list visits earlier),
hold an all-invalid cell inside the lists and an all-invalid cloud, and
come at ragged sizes: P2 1000 (a 104-point last cell) and P1 778 (a
10-row last tile), y_group 1 and 4. Values must be bit-equal (one pair
function), indices equal.
"""

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

S = CC.S_CELL


def _fma3_np(a0, b0, a1, b1, a2, b2):
    s = (a0 * b0).astype(np.float64)
    s = (a1.astype(np.float64) * b1 + s).astype(np.float32).astype(np.float64)
    return (a2.astype(np.float64) * b2 + s).astype(np.float32)


def _scene(y_group, G=3, P1=778, P2=1000, K=6, seed=0):
    """Prepared operands (xs, y4, ctr) and candidate lists cidx [F, T, K]:
    hand-scale rows near clouds whose every 5th point has a copy at +1 and
    at +128; cell 2 all-invalid (it sits in every list), cloud 1 (of G)
    all-invalid; each tile's list is the cells in reversed order rotated by
    (frame + tile)."""
    rng = np.random.default_rng(seed + y_group)
    F = G * y_group
    y = rng.normal(scale=0.05, size=(G, P2, 3))
    j = np.arange(0, P2 - S, 5)
    y[:, j + 1] = y[:, j]
    y[:, j + S] = y[:, j]
    x = rng.normal(scale=0.05, size=(F, P1, 3))
    yv = np.ones((G, P2), bool)
    yv[:, 2 * S : 3 * S] = False
    yv[1] = False
    xs, y4, ctr = NN.prepare(torch.from_numpy(x).float(), torch.from_numpy(y).float(), torch.from_numpy(yv), y_group)
    T, C = -(-P1 // S), -(-P2 // S)
    rev = np.arange(C)[::-1]
    cidx = np.array([[np.roll(rev, f + t)[:K] for t in range(T)] for f in range(F)], np.int32)
    cidx[:, :, K // 2] = 2  # the empty cell inside every list
    return xs, y4, ctr, torch.from_numpy(cidx), yv


def _topk_reference(xs, y4, ctr, cidx, y_group):
    """(d [F, P1], idx [F, P1]) of the contract in numpy: the pinned pair
    arithmetic, per candidate its first minimum (np.argmin), a strict <
    across candidates in list order from BIG; an id outside [0, C) is
    skipped. Also the count of rows whose minimum is reached by more than
    one point of their candidate cells."""
    xs, y4, ctr, cidx = (t.cpu().numpy() for t in (xs, y4, ctr, cidx))
    F, P1, _ = xs.shape
    G, P2, _ = y4.shape
    T, K = cidx.shape[1:]
    C = -(-P2 // S)
    xc = xs - np.repeat(ctr, y_group, axis=0)[:, None, :]
    xc = np.concatenate([xc, np.zeros((F, T * S - P1, 3), np.float32)], axis=1).reshape(F, T, S, 1, 3)
    cells = np.concatenate([y4[..., :3], np.full((G, C * S - P2, 3), 1e15, np.float32)], axis=1)
    cells = cells.reshape(G, C, 1, S, 3)
    g = (np.arange(F) // y_group)[:, None]
    best = np.full((F, T, S), 1e30, np.float32)
    best_j = np.zeros((F, T, S), np.int64)
    count = np.zeros((F, T, S), np.int64)
    for k in range(K):
        c = cidx[:, :, k]
        ok = (c >= 0) & (c < C)
        d = xc - cells[g, np.where(ok, c, 0)]
        d2 = _fma3_np(d[..., 0], d[..., 0], d[..., 1], d[..., 1], d[..., 2], d[..., 2])
        d2 = np.where(ok[..., None, None], d2, np.inf)
        m, a = d2.min(axis=-1), d2.argmin(axis=-1)
        upd = m < best
        count = np.where(upd, (d2 == m[..., None]).sum(-1), count + (m == best) * (d2 == m[..., None]).sum(-1))
        best = np.where(upd, m, best)
        best_j = np.where(upd, c[..., None] * S + a, best_j)
    ties = int(((count > 1) & (best < 1e30)).reshape(F, -1)[:, :P1].sum())
    return best.reshape(F, -1)[:, :P1], best_j.reshape(F, -1)[:, :P1].astype(np.int32), ties


def _assert_reference(d, idx, want_d, want_i, y4, y_group):
    np.testing.assert_array_equal(d.cpu().numpy(), want_d)
    np.testing.assert_array_equal(idx.cpu().numpy(), want_i)
    dead = (y4[..., 0] >= CC.FAR / 2).all(dim=1).repeat_interleave(y_group).cpu()
    assert bool(dead.any())
    assert bool((d.cpu()[dead] == CC.BIG).all() and (idx.cpu()[dead] == 0).all())


@pytest.mark.parametrize("y_group", [1, 4])
def test_plain_h2o_topk_takes_the_first_minimum_in_candidate_order(y_group):
    xs, y4, ctr, cidx, _ = _scene(y_group)
    want_d, want_i, ties = _topk_reference(xs, y4, ctr, cidx, y_group)
    assert ties > 50  # rows whose minimum more than one candidate point reaches
    d, idx = CC.plain_h2o_topk(xs, y4, ctr, cidx, y_group)
    _assert_reference(d, idx, want_d, want_i, y4, y_group)


@pytest.mark.parametrize("y_group", [1, 4])
def test_cell_flags_agree_with_the_selection_stats(y_group):
    """The wrapper's per-cell flags (derived from the kernel's operand y4)
    are the selection stage's `nonempty` on the same clouds: ragged last
    cell, an empty cell, an all-invalid cloud."""
    xs, y4, ctr, _, yv = _scene(y_group)
    y = y4[..., :3] + ctr[:, None]
    flags = CC.cell_flags(y4)
    _, _, yc, yvp = CC.selection_operands(xs, y, torch.from_numpy(yv), ctr, y_group)
    nonempty = CC.cell_stats(yc, yvp)[3]
    assert flags.dtype == torch.uint8 and torch.equal(flags.bool(), nonempty)
    assert not bool(flags[:, 2].any()) and not bool(flags[1].any()) and bool(flags[0, -1])


@pytest.mark.cuda
@pytest.mark.parametrize("y_group", [1, 4])
def test_cuda_h2o_topk_takes_the_first_minimum_in_candidate_order(y_group):
    """Kernel #10 on the same scenes against the reference and the plain
    version; then with ids out of range in the lists, which the kernel
    skips (the selection never writes one; the plain version takes none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    xs, y4, ctr, cidx, _ = (t.cuda() if torch.is_tensor(t) else t for t in _scene(y_group))
    want_d, want_i, _ = _topk_reference(xs, y4, ctr, cidx, y_group)
    d, idx = CC.launch_h2o_topk(xs, y4, ctr, cidx, y_group)
    _assert_reference(d, idx, want_d, want_i, y4, y_group)
    pd, pi = CC.plain_h2o_topk(xs, y4, ctr, cidx, y_group)
    assert torch.equal(d, pd) and torch.equal(idx, pi)
    oor = cidx.clone()
    oor[:, :, 0] = -1
    oor[:, 1::2, 1] = CC._cdiv(y4.shape[1], S) + 3
    want_d, want_i, _ = _topk_reference(xs, y4, ctr, oor, y_group)
    _assert_reference(*CC.launch_h2o_topk(xs, y4, ctr, oor, y_group), want_d, want_i, y4, y_group)
