"""Module parity of the PyTorch port (oakink2_tamf_tpu_torch) against the
JAX package on the CPU, at small sizes, on the same numpy inputs and (via
interop/from_jax) the same weights.

Tolerances, float32 on both sides:
- elementwise math (transforms, schedule-driven steps): atol 1e-6;
- MANO LBS (einsum order differs): atol 2e-6 on metre-scale verts;
- vertex normals: atol 1e-4 on unit vectors (the synthetic hand's random
  faces include slivers whose tiny cross products amplify rounding when
  normalized);
- transformer forwards (matmul and reduction order differ): atol 2e-5;
- schedule arrays: exactly equal (both cast the same float64 numpy).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oakink2_tamf_tpu.core import diffusion as JD
from oakink2_tamf_tpu.core import geometry as JG
from oakink2_tamf_tpu.core import mano as JM
from oakink2_tamf_tpu.core import transforms as JT
from oakink2_tamf_tpu.data import collate as JC
from oakink2_tamf_tpu.interop import torch_port as TP
from oakink2_tamf_tpu.launch.common import SyntheticSegments as JSyntheticSegments
from oakink2_tamf_tpu.models import clip_text as JCLIP
from oakink2_tamf_tpu.models import mdm_g as JMDM
from oakink2_tamf_tpu.models import refine_r as JR
from oakink2_tamf_tpu.utils import pc_util as JPC
from oakink2_tamf_tpu_torch.core import diffusion as D
from oakink2_tamf_tpu_torch.core import geometry as G
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.core import transforms as T
from oakink2_tamf_tpu_torch.data import collate as C
from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments
from oakink2_tamf_tpu_torch.interop import from_jax
from oakink2_tamf_tpu_torch.models import clip_text as CLIP
from oakink2_tamf_tpu_torch.models import mdm_g as MDM
from oakink2_tamf_tpu_torch.models import refine_r as R
from oakink2_tamf_tpu_torch.utils import pc_util as PC

ATOL_ELEM = 1e-6
ATOL_MANO = 2e-6
ATOL_NORMAL = 1e-4
ATOL_NET = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a)


def _tree_to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _rot6d(rng, shape):
    from oakink2_tamf_tpu.data.synthetic import _random_rot6d

    return _random_rot6d(rng, shape)


# ---------------------------------------------------------------------------
# helpers shared with the JAX package
# ---------------------------------------------------------------------------


def test_spatial_sort_same_permutation():
    pts = np.random.default_rng(0).normal(size=(1000, 3)).astype(np.float32)
    np.testing.assert_array_equal(PC.spatial_sort_indices(pts), JPC.spatial_sort_indices(pts))


def test_synthetic_segments_and_collate_match_jax():
    port, ref = SyntheticSegments(3, seq_len=20, max_nobj=2, n_obj_points=300), \
        JSyntheticSegments(3, seq_len=20, max_nobj=2, n_obj_points=300)
    segs_p, segs_j = [port[i] for i in range(3)], [ref[i] for i in range(3)]
    for a, b in zip(segs_p, segs_j):
        for k, v in a.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]), err_msg=k)
    bp = C.SegmentCollate(max_nobj=2, n_obj_points=256)(segs_j)
    bj = JC.SegmentCollate(max_nobj=2, n_obj_points=256)(segs_j)
    for k in ("pose_repr", "mask", "shape", "hand_side", "obj_traj", "obj_embedding",
              "obj_mask", "obj_points", "len"):
        np.testing.assert_array_equal(bp[k], bj[k], err_msg=k)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    d6 = rng.normal(size=(50, 6)).astype(np.float32)
    d6[0] = 0.0  # zero-padded frame: rot6d(0) is the zero matrix
    np.testing.assert_allclose(_np(T.rot6d_to_rotmat(_t(d6))), _np(JT.rot6d_to_rotmat(d6)), atol=ATOL_ELEM)
    rm = _np(JT.rot6d_to_rotmat(_rot6d(rng, (50,))))
    np.testing.assert_allclose(_np(T.rotmat_to_quat(_t(rm))), _np(JT.rotmat_to_quat(rm)), atol=ATOL_ELEM)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    np.testing.assert_allclose(_np(T.quat_to_rotmat(_t(q))), _np(JT.quat_to_rotmat(q)), atol=ATOL_ELEM)
    traj = np.concatenate([rng.normal(size=(7, 3)), _rot6d(rng, (7,))], -1).astype(np.float32)
    np.testing.assert_allclose(_np(T.tslrot6d_to_transf(_t(traj))), _np(JT.tslrot6d_to_transf(traj)),
                               atol=ATOL_ELEM)
    pr = np.concatenate([rng.normal(size=(5, 3)), _rot6d(rng, (5, 16)).reshape(5, 96)], -1).astype(np.float32)
    pr[-1] = 0.0
    for a, b in zip(T.pose_repr_to_quat(_t(pr)), JT.pose_repr_to_quat(pr)):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL_ELEM)


# ---------------------------------------------------------------------------
# diffusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("respacing", ["", "50", "ddim25"])
def test_schedule_arrays_equal(respacing):
    sp = D.tamf_schedule(1000, "cosine", respacing)
    sj = JD.tamf_schedule(1000, "cosine", respacing)
    for f in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
              "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
              "sqrt_recipm1_alphas_cumprod", "posterior_variance",
              "posterior_log_variance_clipped", "posterior_mean_coef1",
              "posterior_mean_coef2", "timestep_map"):
        np.testing.assert_array_equal(_np(getattr(sp, f)), _np(getattr(sj, f)), err_msg=f)


def _toy_model(x, t):
    """A deterministic stand-in denoiser, the same formula in both frameworks."""
    return 0.5 * x + 0.001 * t.reshape((-1, 1, 1))


def test_p_sample_step_same_noise():
    sp, sj = D.tamf_schedule(100), JD.tamf_schedule(100)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 8, 99)).astype(np.float32)
    noise = rng.normal(size=(3, 8, 99)).astype(np.float32)
    t = np.array([99, 50, 0])
    key = jax.random.PRNGKey(5)
    want = JD.p_sample(lambda a, b: _toy_model(a, b), sj, jnp.asarray(x), jnp.asarray(t, jnp.int32), key)
    jnoise = _np(jax.random.normal(key, x.shape, jnp.float32))
    got = D.p_sample(_toy_model, sp, _t(x), _t(t), _t(jnoise))
    np.testing.assert_allclose(_np(got["sample"]), _np(want["sample"]), atol=ATOL_ELEM)
    # the t == 0 row takes no noise
    alt = D.p_sample(_toy_model, sp, _t(x), _t(t), _t(noise))
    np.testing.assert_allclose(_np(alt["sample"])[2], _np(got["sample"])[2], atol=0)
    # the forward process and the posterior it inverts
    np.testing.assert_allclose(_np(D.q_sample(sp, _t(x), _t(t), _t(noise))),
                               _np(JD.q_sample(sj, x, t, noise)), atol=ATOL_ELEM)
    for a, b in zip(D.q_posterior_mean_variance(sp, _t(noise), _t(x), _t(t)),
                    JD.q_posterior_mean_variance(sj, noise, x, t)):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL_ELEM)


def test_p_sample_loop_with_jax_noise():
    """Replay p_sample_loop's key splitting and hand the noise over."""
    sp, sj = D.tamf_schedule(6), JD.tamf_schedule(6)
    shape = (2, 4, 99)
    key = jax.random.PRNGKey(3)
    want = JD.p_sample_loop(_toy_model, sj, shape, key)
    k2, k_init = jax.random.split(key)
    x_t = _np(jax.random.normal(k_init, shape, jnp.float32))
    steps = np.stack([_np(jax.random.normal(k, shape, jnp.float32)) for k in jax.random.split(k2, 6)])
    got = D.p_sample_loop(_toy_model, sp, shape, device="cpu", noise=_t(x_t), step_noise=_t(steps))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL_ELEM)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------


def _cond(rng, bs=2, L=10, nobj=2):
    obj_mask = np.array([[True, False], [True, True]])[:bs]
    return {
        "text_emb": rng.normal(size=(bs, 512)).astype(np.float32),
        "hand_side": np.array([0, 1])[:bs].astype(np.int32),
        "shape": rng.normal(size=(bs, L, 10)).astype(np.float32),
        "obj_traj": rng.normal(size=(bs, nobj, L, 9)).astype(np.float32),
        "obj_embedding": rng.normal(size=(bs, nobj, 768)).astype(np.float32),
        "obj_mask": obj_mask,
    }


def _tcond(c):
    out = {k: _t(v) for k, v in c.items()}
    out["hand_side"] = out["hand_side"].long()
    return out


SMALL = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=4, dropout=0.0)


@pytest.mark.parametrize("activation", ["gelu", "gelu_exact"])
def test_g_forward_and_state_dict_layout(activation):
    rng = np.random.default_rng(0)
    c = _cond(rng)
    x = rng.normal(size=(2, 10, 99)).astype(np.float32)
    t = np.array([3, 999])
    jm = JMDM.InteractionSegmentMDM(JMDM.MDMConfig(activation=activation, **SMALL))
    params = _tree_to_numpy(jm.init(jax.random.PRNGKey(0), x, t, c))
    want = jm.apply(params, x, t, c, deterministic=True)
    pm = MDM.InteractionSegmentMDM(MDM.MDMConfig(activation=activation, **SMALL)).eval()
    pm.load_state_dict(from_jax.g_state_dict_from_flax(params))
    got = pm(_t(x), _t(t), _tcond(c))
    np.testing.assert_allclose(_np(got.detach()), _np(want), atol=ATOL_NET)
    # the port's keys are the reference layout: convert_g_state_dict gives back the flax tree
    back = TP.convert_g_state_dict(pm.state_dict(), num_layers=2, num_heads=4)
    jax.tree.map(np.testing.assert_array_equal, back, params)


@pytest.mark.parametrize("activation", ["gelu", "gelu_exact"])
def test_r_forward_and_state_dict_layout(activation):
    rng = np.random.default_rng(1)
    c = _cond(rng)
    del c["text_emb"]
    x = rng.normal(size=(2, 10, 99)).astype(np.float32)
    h2o = rng.uniform(size=(2, 10, 778)).astype(np.float32)
    jm = JR.SegmentRefineNet(JR.RefineConfig(activation=activation, **SMALL))
    params = _tree_to_numpy(jm.init(jax.random.PRNGKey(1), x, h2o, c))
    want = jm.apply(params, x, h2o, c, deterministic=True)
    pm = R.SegmentRefineNet(R.RefineConfig(activation=activation, **SMALL)).eval()
    pm.load_state_dict(from_jax.r_state_dict_from_flax(params))
    got = pm(_t(x), _t(h2o), _tcond(c))
    np.testing.assert_allclose(_np(got.detach()), _np(want), atol=ATOL_NET)
    back = TP.convert_r_state_dict(pm.state_dict(), num_layers=2, num_heads=4)
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_clip_tokenizer_and_encoder_match_jax():
    texts = ["Pick up the mug, then pour!", "synthetic task 3", "a" * 200]
    np.testing.assert_array_equal(
        CLIP.tokenize_for_tamf(CLIP.ClipTokenizer(None), texts),
        JCLIP.tokenize_for_tamf(JCLIP.ClipTokenizer(None), texts),
    )
    dims = dict(vocab_size=VOCAB, context_length=77, width=64, heads=4, layers=2, embed_dim=32)
    toks = JCLIP.tokenize_for_tamf(JCLIP.ClipTokenizer(None), texts) % VOCAB
    toks[:, 0] = VOCAB - 2  # keep an SOT-like id
    jm = JCLIP.ClipTextEncoder(**dims)
    params = _tree_to_numpy(jm.init(jax.random.PRNGKey(0), jnp.asarray(toks)))
    want = jm.apply(params, jnp.asarray(toks))
    pm = CLIP.ClipTextEncoder(**dims).eval()
    pm.load_state_dict(from_jax.clip_state_dict_from_flax(params))
    got = pm(_t(toks).long())
    np.testing.assert_allclose(_np(got.detach()), _np(want), atol=ATOL_NET)


VOCAB = 1000


def test_frozen_clip_refuse_rules(tmp_path):
    with pytest.raises(FileNotFoundError):
        CLIP.FrozenClipText(checkpoint_path=str(tmp_path / "missing.pt"), device="cpu")
    ckpt = tmp_path / "clip.pt"
    torch.save(CLIP.ClipTextEncoder(layers=1).state_dict(), ckpt)
    with pytest.raises(RuntimeError, match="BPE"):
        CLIP.FrozenClipText(checkpoint_path=str(ckpt), device="cpu")
    with pytest.raises(FileNotFoundError):
        CLIP.FrozenClipText(bpe_path=str(tmp_path / "nope.txt.gz"), device="cpu")


# ---------------------------------------------------------------------------
# MANO and R geometry
# ---------------------------------------------------------------------------


def _mano_pair():
    jst = JR.stack_mano_models(JM.synthetic_mano_model("right"), JM.synthetic_mano_model("left"))
    pst = R.stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    return jst, pst


def test_synthetic_mano_and_forward_match_jax():
    for side in ("right", "left"):
        a, b = M.synthetic_mano_model(side), JM.synthetic_mano_model(side)
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    rng = np.random.default_rng(0)
    model = M.synthetic_mano_model("right")
    q = rng.normal(size=(3, 5, 16, 4)).astype(np.float32)
    betas = rng.normal(size=(3, 5, 10)).astype(np.float32)
    v, j = M.mano_forward(M.ManoTensors.from_model(model, "cpu"), _t(q), _t(betas))
    vj, jj = JM.mano_forward(JM.synthetic_mano_model("right"), q, betas)
    np.testing.assert_allclose(_np(v), _np(vj), atol=ATOL_MANO)
    np.testing.assert_allclose(_np(j), _np(jj), atol=ATOL_MANO)
    np.testing.assert_array_equal(M.hand_template_perm(model.v_template),
                                  JM.hand_template_perm(JM.synthetic_mano_model("right")))


def test_batch_recover_mano_and_normals_match_jax():
    jst, pst = _mano_pair()
    rng = np.random.default_rng(1)
    pr = np.concatenate([rng.normal(size=(2, 6, 3)) * 0.1, _rot6d(rng, (2, 6, 16)).reshape(2, 6, 96)],
                        -1).astype(np.float32)
    pr[0, -2:] = 0.0  # zero-padded frames
    shape = rng.normal(size=(2, 6, 10)).astype(np.float32)
    side = np.array([0, 1], np.int32)
    got = R.batch_recover_mano(pst, _t(pr), _t(shape), _t(side).long(), normals=True)
    want = JR.batch_recover_mano(jst, pr, shape, side)
    for a, b, tol in zip(got, want, (ATOL_MANO, ATOL_MANO, ATOL_NORMAL)):
        np.testing.assert_allclose(_np(a), _np(b), atol=tol)
    faces = JM.synthetic_mano_model("right").faces
    np.testing.assert_allclose(_np(G.vertex_normals(got[0], faces)), _np(JG.vertex_normals(want[0], faces)),
                               atol=ATOL_NORMAL)


def _geom_batch(P, L=6, seed=2):
    """A collated two-sample batch (the JAX synthetic segments) with a
    zero-padded sample pose."""
    ds = JSyntheticSegments(2, seq_len=L + 10, max_nobj=2, n_obj_points=P, seed=seed)
    b = JC.SegmentCollate(max_nobj=2, n_obj_points=P)([ds[0], ds[1]])
    b = {k: b[k][:, :L] if k in ("pose_repr", "mask", "shape") else b[k] for k in b}
    b["obj_traj"] = b["obj_traj"][:, :, :L]
    b["mask"][1, L // 2:] = 0.0
    m = b["mask"]
    b["pose_repr"] = b["pose_repr"] * m[:, :, None]
    b["obj_traj"] = b["obj_traj"] * m[:, None, :, None]
    b["shape"] = b["shape"] * m[:, :, None]
    b["sample_pose_repr"] = b["pose_repr"]
    keys = ("sample_pose_repr", "mask", "shape", "hand_side", "obj_traj", "obj_mask", "obj_points")
    jb = {k: jnp.asarray(b[k]) for k in keys}
    pb = {k: _t(b[k]) for k in keys}
    pb["hand_side"] = pb["hand_side"].long()
    return jb, pb


@pytest.mark.parametrize("P", [64, 4096])
def test_multi_object_h2o_dist_matches_jax(P):
    """All-pairs route at 64 points, culled route at 4096 (frame mask on):
    culled padded frames come out BIG in the port and are compared on the
    valid frames; padded object slots give the 10.0 sentinel on both sides."""
    jst, pst = _mano_pair()
    jb, pb = _geom_batch(P)
    v, _, n = JR.batch_recover_mano(jst, jb["sample_pose_repr"], jb["shape"], jb["hand_side"])
    want = _np(JR.multi_object_h2o_dist(v, n, jb["obj_traj"], jb["obj_points"], jb["obj_mask"],
                                        x_perm=JM.hand_template_perm(jst), frame_mask=jb["mask"]))
    pv, _, _ = R.batch_recover_mano(pst, pb["sample_pose_repr"], pb["shape"], pb["hand_side"])
    got = _np(R.multi_object_h2o_dist(pv, pb["obj_traj"], pb["obj_points"], pb["obj_mask"],
                                      x_perm=pst.template_perm, frame_mask=pb["mask"]))
    valid = _np(jb["mask"]) > 0
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5, atol=2e-6)
    if P < G.CULL_MIN_P2:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)
    else:
        # culled frames: BIG, or the 10.0 sentinel where a padded slot wins the min
        assert np.all(got[~valid] >= 10.0)


def test_sample_geometry_frame_mask_matches_jax():
    """The padded-frame dedup: culled frames take the closed form ||v_i||."""
    jst, pst = _mano_pair()
    jb, pb = _geom_batch(4096, seed=3)
    want = JR.sample_geometry(jst, jb, frame_mask=jb["mask"])
    got = R.sample_geometry(pst, pb, frame_mask=pb["mask"], normals=True)
    for k, tol in (("sample_hand_verts", ATOL_MANO), ("sample_hand_joints", ATOL_MANO),
                   ("sample_hand_normals", ATOL_NORMAL)):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=tol, err_msg=k)
    np.testing.assert_allclose(_np(got["sample_h2o_dist"]), _np(want["sample_h2o_dist"]),
                               rtol=1e-5, atol=2e-6)
