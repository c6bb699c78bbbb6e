"""MANO on each row's own hand side (models/refine_r.batch_recover_mano,
core/mano.mano_forward with `side`) and the normals by corner gathers
(core/geometry.vertex_normals), against the computation they replaced, kept
here as the oracle: both sides on every row and then the row's side
selected, the per-vertex 3x3 products as einsums, the 4x4 chain one joint
at a time, the normals as dense {0, +-1} operators. Then the normals only
where a loss reads them: R's step gives the same loss and gradients
without them, G's step still computes both of its sets."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch.core import diffusion as D
from oakink2_tamf_tpu_torch.core import geometry as G
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.core import transforms as T
from oakink2_tamf_tpu_torch.data.collate import SegmentCollate
from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments, synthetic_batch, with_perturbed_sample
from oakink2_tamf_tpu_torch.launch import common
from oakink2_tamf_tpu_torch.models import losses as LL
from oakink2_tamf_tpu_torch.models import mdm_g as MDM
from oakink2_tamf_tpu_torch.models import refine_r as R
from oakink2_tamf_tpu_torch.parallel import train as PT
from oakink2_tamf_tpu_torch.runtime import profiler as P

SMALL = dict(latent_dim=32, ff_size=64, num_layers=1, num_heads=4, dropout=0.0)
SIDES = {"mixed": [0, 1, 1, 0], "all_rh": [0, 0, 0, 0], "all_lh": [1, 1, 1, 1]}
ZERO_ROW = 2  # fully masked: pose_repr and shape all zero


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch single-threaded for this file under pytest-xdist (the workers share the cores)."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(dtype=torch.float32):
    st = R.stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    return dataclasses.replace(st, **{f.name: getattr(st, f.name).to(dtype) for f in dataclasses.fields(st)
                                      if isinstance(getattr(st, f.name), torch.Tensor)
                                      and getattr(st, f.name).is_floating_point()})


# ---------------------------------------------------------------------------
# The oracle: the replaced computation
# ---------------------------------------------------------------------------


def _old_mano_forward(st, s, pose_quat, betas, center_idx=0):
    """One side s of the stacked model, as core/mano.mano_forward computed it
    before: einsums for the blend shapes and the per-vertex products, a 4x4
    transform per joint composed one joint at a time."""
    lead = pose_quat.shape[:-2]
    B = int(np.prod(lead))
    q = pose_quat.reshape(B, 16, 4)
    b = torch.broadcast_to(betas, lead + (10,)).reshape(B, 10)
    rot = T.quat_to_rotmat(q)
    v_shaped = st.v_template[s][None] + torch.einsum("vcs,bs->bvc", st.shapedirs[s], b)
    j_rest = torch.einsum("jv,bvc->bjc", st.j_regressor[s], v_shaped)
    eye = torch.eye(3, dtype=rot.dtype)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", st.posedirs[s], (rot[:, 1:] - eye).reshape(B, 135))
    glob = [T.assemble_T(j_rest[:, 0], rot[:, 0])]
    for k in range(1, 16):
        p = M.PARENTS[k]
        glob.append(torch.matmul(glob[p], T.assemble_T(j_rest[:, k] - j_rest[:, p], rot[:, k])))
    Gm = torch.stack(glob, dim=1)
    t_corr = Gm[..., :3, 3] - torch.einsum("bkij,bkj->bki", Gm[..., :3, :3], j_rest)
    R_blend = torch.einsum("vk,bkij->bvij", st.skin_weights[s], Gm[..., :3, :3])
    t_blend = torch.einsum("vk,bki->bvi", st.skin_weights[s], t_corr)
    verts = torch.einsum("bvij,bvj->bvi", R_blend, v_posed) + t_blend
    joints = torch.cat((Gm[..., :3, 3], verts[:, list(M.TIP_VERT_IDS)]), dim=1)[:, list(M.JOINT_REORDER)]
    if center_idx is not None:
        center = joints[:, center_idx : center_idx + 1]
        verts, joints = verts - center, joints - center
    return verts.reshape(lead + (778, 3)), joints.reshape(lead + (21, 3))


def _dense_normals(verts, faces):
    """The dense-operator route: corner differences and the face->vertex sum
    as {0, +-1} matrices applied by matmul."""
    faces = np.asarray(faces)
    F, V = faces.shape[0], verts.shape[-2]
    d1, d2, a = np.zeros((F, V)), np.zeros((F, V)), np.zeros((V, F))
    r = np.arange(F)
    np.add.at(d1, (r, faces[:, 1]), 1.0)
    np.add.at(d1, (r, faces[:, 0]), -1.0)
    np.add.at(d2, (r, faces[:, 2]), 1.0)
    np.add.at(d2, (r, faces[:, 0]), -1.0)
    for i in range(3):
        np.add.at(a, (faces[:, i], r), 1.0)

    def apply(op, v):
        op = torch.from_numpy(op).to(v.dtype)
        lead = v.shape[:-2]
        flat = v.reshape(-1, v.shape[-2], 3).permute(1, 0, 2).reshape(v.shape[-2], -1)
        return (op @ flat).reshape(op.shape[0], -1, 3).permute(1, 0, 2).reshape(lead + (op.shape[0], 3))

    acc = apply(a, torch.linalg.cross(apply(d1, verts), apply(d2, verts), dim=-1))
    return acc * torch.rsqrt(torch.clamp_min(torch.sum(acc * acc, dim=-1, keepdim=True), 1e-24))


def _old_batch_recover(st, pose_repr, shape, hand_side):
    """Both sides on every row, then each row's side selected."""
    tsl, quat = T.pose_repr_to_quat(pose_repr)
    rh = (hand_side == 0)[:, None, None, None]
    per_side = [_old_mano_forward(st, s, quat, shape) for s in range(2)]
    verts = torch.where(rh, per_side[0][0], per_side[1][0]) + tsl[..., None, :]
    joints = torch.where(rh, per_side[0][1], per_side[1][1]) + tsl[..., None, :]
    normals = torch.where(rh, _dense_normals(verts, st.faces[0]), _dense_normals(verts, st.faces[1]))
    return verts, joints, normals


def _poses(dtype=torch.float32, bs=4, L=6, seed=0):
    """Random poses (rot6d of random rotations, translations ~0.1 m, betas
    ~N(0, 1)); row ZERO_ROW zero-padded throughout, as a fully masked row."""
    g = torch.Generator().manual_seed(seed)
    rot = T.rotmat_to_rot6d(T.quat_to_rotmat(torch.randn(bs, L, 16, 4, generator=g, dtype=torch.float64)))
    pr = torch.cat([0.1 * torch.randn(bs, L, 3, generator=g, dtype=torch.float64), rot.reshape(bs, L, 96)], -1)
    shape = torch.randn(bs, L, 10, generator=g, dtype=torch.float64)
    if bs > ZERO_ROW:
        pr[ZERO_ROW] = 0.0
        shape[ZERO_ROW] = 0.0
    return pr.to(dtype), shape.to(dtype)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


# ---------------------------------------------------------------------------
# batch_recover_mano against both sides, then select
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sides", list(SIDES))
def test_verts_and_joints_match_both_sides_then_select(sides):
    """Within 1e-6 of the largest value, and so are the gradients with
    respect to pose_repr and shape (row by row: the zero row's reach 1e12
    through rot6d's normalisation of a zero vector)."""
    st = _stack()
    side = torch.tensor(SIDES[sides])
    pr, shape = _poses()
    got = R.batch_recover_mano(st, pr, shape, side)
    want = _old_batch_recover(st, pr, shape, side)
    assert got[2] is None
    for a, w in zip(got[:2], want[:2]):
        assert a.shape == w.shape and _rel(a, w) < 1e-6
    g = torch.Generator().manual_seed(1)
    cot = [torch.randn(w.shape, generator=g) for w in want[:2]]
    grads = []
    for fn in (lambda p, s: R.batch_recover_mano(st, p, s, side)[:2],
               lambda p, s: _old_batch_recover(st, p, s, side)[:2]):
        p, s = pr.clone().requires_grad_(True), shape.clone().requires_grad_(True)
        sum((o * c).sum() for o, c in zip(fn(p, s), cot)).backward()
        grads.append((p.grad, s.grad))
    for a, w in zip(*grads):
        for row in range(len(side)):
            assert _rel(a[row], w[row]) < 1e-6, row


@pytest.mark.parametrize("sides", list(SIDES))
def test_normals_per_row_match_dense_operators(sides):
    """Each row's normals on its own side's faces. On the same verts in
    float64, where the two routes are the same sums in another order,
    within 1e-6 of the dense route. In float32 no farther from the float64
    normals than the replaced computation (both lie ~2e-5 from them: the
    synthetic hand's random sliver faces amplify rounding where normalised)."""
    side = torch.tensor(SIDES[sides])
    rh = (side == 0)[:, None, None, None]
    st, (pr, shape) = _stack(torch.float64), _poses(torch.float64)
    verts, _, got = R.batch_recover_mano(st, pr, shape, side, normals=True)
    oracle = torch.where(rh, _dense_normals(verts, st.faces[0]), _dense_normals(verts, st.faces[1]))
    assert float((got - oracle).abs().max()) < 1e-6
    truth = _old_batch_recover(st, pr, shape, side)[2]
    st, (pr, shape) = _stack(), _poses()
    err_new = float((R.batch_recover_mano(st, pr, shape, side, normals=True)[2].double() - truth).abs().max())
    err_old = float((_old_batch_recover(st, pr, shape, side)[2].double() - truth).abs().max())
    assert err_new <= 1.5 * err_old + 1e-6, (err_new, err_old)


@pytest.mark.parametrize("case", ["rh", "lh", "rh_degenerate", "lh_degenerate"])
def test_vertex_normals_and_gradient_match_dense_operators(case):
    """core/geometry.vertex_normals on one side's face set, shared by every
    mesh of a batch, against the dense route in float64: values and the
    gradient with respect to the verts within 1e-6. The degenerate cases
    collapse faces to zero area, one vertex's every face among them (its
    normal is 0, its gradient finite)."""
    st = _stack(torch.float64)
    s = 0 if case.startswith("rh") else 1
    faces = st.faces[s]
    pr, shape = _poses(torch.float64, bs=1, L=3)
    verts = M.recover_mano_from_pose_repr(st, pr[0], shape[0], side=torch.tensor([s]).expand(3))[0]
    if case.endswith("degenerate"):
        verts = verts.detach().clone()
        for f in faces[:40]:  # zero area: the second corner onto the first
            verts[:, f[1]] = verts[:, f[0]]
        lone = np.flatnonzero(np.bincount(faces.reshape(-1), minlength=778) == 1)[0]
        (k,) = np.flatnonzero((faces == lone).any(1))
        verts[:, faces[k]] = verts[:, lone : lone + 1]  # the vertex's only face collapses to a point
    cot = torch.randn(verts.shape, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    out = []
    for fn in (G.vertex_normals, _dense_normals):
        v = verts.detach().clone().requires_grad_(True)
        n = fn(v, faces)
        (n * cot).sum().backward()
        out.append((n.detach(), v.grad))
    (n_new, g_new), (n_old, g_old) = out
    assert torch.isfinite(g_new).all() and float((n_new - n_old).abs().max()) < 1e-6
    assert _rel(g_new, g_old) < 1e-6
    if case.endswith("degenerate"):
        assert float(n_new[:, lone].abs().max()) == 0.0


@pytest.mark.parametrize("center_idx", [0, None, 3])
def test_one_side_mano_forward_matches_the_einsum_chain(center_idx):
    """mano_forward on a one-side model (compute_score's and the tests'
    use) within 1e-6 of the replaced einsum forward, at each centring."""
    st = _stack()
    q = torch.randn(3, 5, 16, 4, generator=torch.Generator().manual_seed(3))
    b = torch.randn(3, 5, 10, generator=torch.Generator().manual_seed(4))
    v, j = M.mano_forward(st.side(1), q, b, center_idx=center_idx)
    wv, wj = _old_mano_forward(st, 1, q, b, center_idx)
    assert _rel(v, wv) < 1e-6 and _rel(j, wj) < 1e-6


def test_side_of_a_stack_equals_the_side_built_alone():
    """The derived arrays of a stacked model's side are those of the side
    built alone, bit for bit."""
    st = _stack()
    for s, name in enumerate(("right", "left")):
        alone = M.ManoTensors.from_model(M.synthetic_mano_model(name), "cpu")
        part = st.side(s)
        assert part.template_perm is None
        for f in dataclasses.fields(alone):
            a, b = getattr(alone, f.name), getattr(part, f.name)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), f.name
            elif a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f.name)


# ---------------------------------------------------------------------------
# Normals only where a loss reads them
# ---------------------------------------------------------------------------


def test_r_step_without_normals_gives_the_same_loss_and_gradients():
    """R's refine pass and loss with and without the hand normals: the same
    loss and parameter gradients, bit for bit, and the normals' keys only
    where asked for."""
    torch.manual_seed(0)
    mano = R.stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    net = R.SegmentRefineNet(R.RefineConfig(**SMALL))
    collate = SegmentCollate(max_nobj=2, n_obj_points=128)
    segs = SyntheticSegments(3, seq_len=16, max_nobj=2, n_obj_points=128, seed=5)
    batch = with_perturbed_sample(collate([segs[i] for i in range(3)]), np.random.default_rng(0))
    batch = common.device_batch(batch, torch.device("cpu"))
    assert set(batch["hand_side"].tolist()) == {0, 1}
    got = []
    for normals in (True, False):
        net.zero_grad()
        out = R.refine_forward(net, mano, batch, loss_frame_mask=batch["mask"], normals=normals)
        keys = {k for k in out if k.endswith("_hand_normals")}
        assert keys == ({"sample_hand_normals", "refine_hand_normals", "target_hand_normals"} if normals else set())
        loss, _ = LL.segment_refine_loss(LL.load_contact_assets(), LL.RefineLossConfig(), out, batch)
        loss.backward()
        got.append((loss.detach(), {k: p.grad.clone() for k, p in net.named_parameters()}))
    (l_on, g_on), (l_off, g_off) = got
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(g_on[k], g_off[k]) for k in g_on)


def test_g_step_builds_both_normals_and_two_normals_spans(monkeypatch):
    """G's step asks for the GT and the predicted normals (the signed
    searches read them) and gets them, under two `mano.normals` spans."""
    calls = []

    def recorded(*args, **kw):
        out = R.batch_recover_mano(*args, **kw)
        calls.append((kw.get("normals"), out[2]))
        return out

    monkeypatch.setattr(LL, "batch_recover_mano", recorded)
    torch.manual_seed(0)
    model = MDM.InteractionSegmentMDM(MDM.MDMConfig(**SMALL))
    state = PT.TrainState(model, PT.make_optimizer(model.named_parameters()))
    mano = R.stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    step = PT.make_g_train_step(D.tamf_schedule(50), mano, LL.load_contact_assets(), LL.ExtraLossConfig())
    batch = synthetic_batch(np.random.default_rng(0), batch_size=2, seq_len=8, max_nobj=2, n_obj_points=128,
                            min_len=4)
    batch = common.device_batch(batch, torch.device("cpu"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, batch, generator=torch.Generator().manual_seed(0))
    rep = P.report()
    assert rep.spans["mano.recover"].n == 2 and rep.spans["mano.normals"].n == 2
    assert [flag for flag, _ in calls] == [True, True]
    assert all(n is not None and n.shape == (2, 8, 778, 3) and torch.isfinite(n).all() for _, n in calls)
