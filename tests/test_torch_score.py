"""The scoring chain of the port against the JAX package, CR, PSKL-J and
FID: eval/metrics, core/geometry.nearest_neighbor / min_cdist (CR's
distance core: kernel #1's plain version on the CPU) and
eval/compute_score, on fabricated real-format data and save_dict trees
(data/fabricate.py, the hand from the port's MANO): the GT itself
(identity) and a perturbed refinement. SIV and the inside-mesh test are in
tests/test_torch_siv.py.

Tolerances:
- CR: each frame's least squared distance at atol 1e-7 m^2 (#1 centres
  each cloud and takes the difference form, JAX expands x^2 + y^2 - 2xy
  uncentred: ~1e-8 m^2 on the CPU), the ratios exactly; a frame within
  1e-5 m of the 5 mm threshold is reported (printed), not re-seeded away;
- PSKL-J: rtol 1e-6;
- FID: rtol 1e-6 with more segments than activation dims (full rank); on
  fewer, where the covariances are singular, rtol 1e-7 on a perturbed
  pair and atol 1e-5 on an identical pair (scipy's sqrtm of a singular
  product against eigh of sqrt(s1) s2 sqrt(s1); measured 5e-9 and 1e-6);
- the encoder activations behind compute_score's FID: atol 1e-5 (float32
  forwards, tests/test_torch_encoder.py), so its FID at rtol 1e-5 (the
  full-rank perturbed tree: measured 2.3e-6).
"""

import argparse
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from oakink2_tamf_tpu.core import geometry as JG
from oakink2_tamf_tpu.core import mano as JM
from oakink2_tamf_tpu.data.segment import InteractionSegmentData as JInteractionSegmentData
from oakink2_tamf_tpu.eval import compute_score as JCS
from oakink2_tamf_tpu.eval import metrics as JME
from oakink2_tamf_tpu.launch import param as jparam
from oakink2_tamf_tpu.models.refine_r import stack_mano_models as j_stack_mano_models
from oakink2_tamf_tpu.runtime.config import ConfigRegistry as JConfigRegistry
from oakink2_tamf_tpu_torch.core import geometry as G
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.data import fabricate as F
from oakink2_tamf_tpu_torch.eval import compute_score as CS
from oakink2_tamf_tpu_torch.eval import metrics as ME
from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "config/synthetic_smoke.yml")
N_SEG = 36  # above the smoke encoder's 32 activation dims
N_PER_FRAME = 12  # segments whose every frame the CR test holds
THRESHOLD = 0.005


def _reference_encoder_pt(path: str, d: int = 32, ff: int = 64, layers: int = 2, scale: float = 0.3) -> str:
    """A SegmentEncoder state_dict in the reference's key layout (what its
    save_state writes, tests/test_compute_score.py), random from a seed; at
    weights of scale 0.3 the perturbed tree's FID is ~1.5 (at 0.1 it was
    ~1e-5, below what float32 forwards resolve)."""
    g = torch.Generator().manual_seed(3)
    sd = {}

    def lin(prefix, i, o):
        sd[f"{prefix}.weight"] = torch.randn(o, i, generator=g) * scale
        sd[f"{prefix}.bias"] = torch.randn(o, generator=g) * 0.1

    lin("hand_shape_process.shape_embed", 10, d)
    lin("obj_embed_process.embedding", 768, d)
    lin("input_process.poseEmbedding", 99, d)
    lin("obj_input_process.poseEmbedding", 9, d)
    lin("input_merge.0", 2 * d, d)
    lin("input_merge.2", d, d)
    for i in range(layers):
        p = f"seqTransEncoder.layers.{i}"
        sd[f"{p}.self_attn.in_proj_weight"] = torch.randn(3 * d, d, generator=g) * scale
        sd[f"{p}.self_attn.in_proj_bias"] = torch.randn(3 * d, generator=g) * 0.1
        lin(f"{p}.self_attn.out_proj", d, d)
        lin(f"{p}.linear1", d, ff)
        lin(f"{p}.linear2", ff, d)
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"] = 1.0 + torch.randn(d, generator=g) * 0.1
            sd[f"{p}.{n}.bias"] = torch.randn(d, generator=g) * 0.1
    lin("output_process.poseFinal.0", d, d)
    lin("output_process.poseFinal.2", d, d)
    lin("output_process.poseFinal.4", d, 70)
    sd["classification_token"] = torch.zeros(1, 1, d)
    torch.save(sd, path)
    return path


def save_dict_trees(root: str, samples) -> dict[str, str]:
    """{"identity": dir, "perturbed": dir} of save_dict trees over `samples`."""
    mano_rh, mano_lh = M.get_mano_model(None, "right"), M.get_mano_model(None, "left")
    stack = CS.stack_mano_models(mano_rh, mano_lh, "cpu")
    faces = {0: M.closed_faces(mano_rh), 1: M.closed_faces(mano_lh)}
    return {k: F.write_save_dicts(os.path.join(root, k), samples, stack, faces,
                                  sigma=0.3 if k == "perturbed" else 0.0, seed=11)
            for k in ("identity", "perturbed")}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("score"))
    paths = F.write_dataset(root, N_SEG, seq_len=160, n_obj=3, n_points=128, min_len=12, max_len=12,
                            seed=7)
    kw = dict(cache_dict_filepath=paths["cache_dict"], obj_embedding_prefix=paths["obj_embedding_prefix"],
              obj_pointcloud_prefix=paths["obj_pointcloud_prefix"])
    jax_ds = JInteractionSegmentData(**kw)
    trees = save_dict_trees(root, [jax_ds[i] for i in range(len(jax_ds))])
    argv = ["--cfg", SMOKE, "--data.synthetic", "false", "--data.max_nobj", "2", "--data.n_obj_points", "128",
            "--test.cache_dict_filepath", paths["cache_dict"],
            "--data.obj_embedding_prefix", paths["obj_embedding_prefix"],
            "--data.obj_pointcloud_prefix", paths["obj_pointcloud_prefix"]]
    return {"root": root, "trees": trees, "argv": argv, "jax_ds": jax_ds,
            "encoder_pt": _reference_encoder_pt(os.path.join(root, "model_0399.pt"))}


def _jax_reg(argv):
    reg = JConfigRegistry("test_score")
    for fn in (jparam.reg_base_param, jparam.reg_mano_param, jparam.reg_model_param, JCS.reg_score_param):
        fn(reg)
    parser = argparse.ArgumentParser()
    reg.hook(parser)
    reg.parse(parser, argv)
    return reg


def _jax_mano():
    return j_stack_mano_models(JM.synthetic_mano_model("right"), JM.synthetic_mano_model("left"))


# ---------------------------------------------------------------------------
# eval/metrics.py, function by function
# ---------------------------------------------------------------------------


def _contact_scene(seed: int, L: int = 12, nobj: int = 2, P: int = 300):
    rng = np.random.default_rng(seed)
    ds = F.make_cache_dict(1, seq_len=L, n_obj=nobj, objs_per_seg=nobj, min_len=L, seed=seed)
    traj = np.stack([np.concatenate([X[:, :3, 3], X[:, :2, :3].reshape(L, 6)], axis=-1)
                     for X in ds["interaction_segment_obj_traj_list"][0].values()]).astype(np.float32)
    clouds = np.stack([F.box_surface_points(oid, P, seed) for oid in F.object_ids(nobj)])
    # a hand-sized blob whose centre drifts past the first object: least
    # distances from contact to a few centimetres
    drift = np.linspace(0.0, 0.12, L)[:, None, None] * np.array([1.0, 0.3, 0.0])
    hand = traj[0, :, None, :3] + drift + rng.normal(scale=0.02, size=(L, 778, 3))
    return clouds, traj, hand.astype(np.float32)


def test_transf_merge_obj_pointcloud_matches_jax():
    clouds, traj, _ = _contact_scene(0)
    got = ME.transf_merge_obj_pointcloud(clouds, traj).numpy()
    want = JME.transf_merge_obj_pointcloud(clouds, traj)
    assert got.shape == want.shape == (12, 600, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contact_min_dists_and_ratio_match_jax(seed):
    clouds, traj, hand = _contact_scene(seed)
    merged = ME.transf_merge_obj_pointcloud(clouds, traj)
    before = NN.KERNEL.launches
    got = ME.contact_min_dists(hand, merged)
    assert NN.KERNEL.launches == before  # CPU tensors: the plain version
    want = JME.contact_min_dists(hand, merged.numpy())
    np.testing.assert_allclose(got.astype(np.float64) ** 2, want.astype(np.float64) ** 2, atol=1e-7, rtol=0)
    print(f"seed {seed}: frames within 1e-5 m of {THRESHOLD} m: {want[np.abs(want - THRESHOLD) < 1e-5]}")
    assert 0.0 < JME.contact_ratio(want) < 1.0
    assert ME.contact_ratio(got) == JME.contact_ratio(want)


def test_nearest_neighbor_and_min_cdist_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(scale=0.1, size=(200, 3)).astype(np.float32)
    y = rng.normal(scale=0.1, size=(700, 3)).astype(np.float32)
    valid = rng.random(700) > 0.3
    for yv in (None, valid):
        d, i = G.nearest_neighbor(torch.from_numpy(x), torch.from_numpy(y),
                                  None if yv is None else torch.from_numpy(yv), chunk=256)
        jd, ji = JG.nearest_neighbor(jnp.asarray(x), jnp.asarray(y), None if yv is None else jnp.asarray(yv),
                                     chunk=256)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-7, rtol=0)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    hv = rng.normal(scale=0.1, size=(5, 778, 3)).astype(np.float32)
    pc = rng.normal(scale=0.1, size=(5, 900, 3)).astype(np.float32)
    got = G.min_cdist(torch.from_numpy(hv), torch.from_numpy(pc)).numpy()
    want = np.asarray(JG.min_cdist(jnp.asarray(hv), jnp.asarray(pc)))
    np.testing.assert_allclose(got.astype(np.float64) ** 2, want.astype(np.float64) ** 2, atol=1e-7, rtol=0)


def test_psklj_functions_match_jax():
    rng = np.random.default_rng(6)
    gt = [np.cumsum(rng.normal(scale=0.01, size=(40, 21, 3)), axis=0) for _ in range(5)]
    md = [g + rng.normal(scale=0.002, size=g.shape) for g in gt]
    np.testing.assert_allclose(ME.joint_power_spectrum(gt[0]), JME.joint_power_spectrum(gt[0]), rtol=1e-12)
    for n in (40, 17):
        np.testing.assert_array_equal(ME.pad_tail_with_last(gt[1], n), JME.pad_tail_with_last(gt[1], n))
    np.testing.assert_allclose(ME.psklj(gt, md), JME.psklj(gt, md), rtol=1e-6)


@pytest.mark.parametrize("n,rtol", [(200, 1e-6), (65, 1e-6), (40, 1e-7), (16, 1e-7)])
def test_frechet_distance_matches_jax(n, rtol):
    """64 activation dims: full rank at n > 64, singular covariances below."""
    rng = np.random.default_rng(n)
    a = rng.normal(size=(n, 64))
    b = a + rng.normal(scale=0.3, size=(n, 64)) + 0.1
    mu, sigma = ME.calculate_activation_statistics(a)
    jmu, jsigma = JME.calculate_activation_statistics(a)
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(sigma, jsigma)
    np.testing.assert_allclose(ME.calculate_fid(a, b), JME.calculate_fid(a, b), rtol=rtol)
    np.testing.assert_allclose(ME.calculate_fid(a, a), JME.calculate_fid(a, a), atol=1e-5 if n < 64 else 1e-9)


# ---------------------------------------------------------------------------
# eval/compute_score.py
# ---------------------------------------------------------------------------


def test_cr_per_frame_distances_match_jax(scene):
    """Every scored frame's least squared distance, of the GT hand and of
    the perturbed tree's, through the runners' own steps, on the first
    N_PER_FRAME segments (the ratios over all are compute_score's test);
    frames near the threshold are reported."""
    tree = "perturbed"
    jax_ds = scene["jax_ds"]
    save_dicts = CS.load_save_dicts(scene["trees"][tree])
    save_dicts = {k: save_dicts[k] for k in sorted(save_dicts)[:N_PER_FRAME]}
    mano = CS.stack_mano_models(M.get_mano_model(None, "right"), M.get_mano_model(None, "left"), "cpu")
    jmano = _jax_mano()
    near, n_frames = [], 0
    for s, sd in CS.iter_eval_pairs(jax_ds, save_dicts):
        n = int(s["len"])
        merged = ME.transf_merge_obj_pointcloud(s["obj_pointcloud"], s["obj_traj"][:, :n])
        jmerged = JME.transf_merge_obj_pointcloud(s["obj_pointcloud"], s["obj_traj"][:, :n])
        gt_verts, _ = CS.gt_hand_geometry(mano, s)
        jgt_verts, _ = JCS.gt_hand_geometry(jmano, s)
        for hv, jhv in ((gt_verts[:n], jgt_verts[:n]), (sd["verts"][:n], sd["verts"][:n])):
            got = ME.contact_min_dists(hv, merged).astype(np.float64)
            want = JME.contact_min_dists(jhv, jmerged).astype(np.float64)
            np.testing.assert_allclose(got ** 2, want ** 2, atol=1e-7, rtol=0)
            near += [(s["info"], float(d)) for d in want if abs(d - THRESHOLD) < 1e-5]
            n_frames += n
    print(f"{tree}: {n_frames} frames, {len(near)} within 1e-5 m of {THRESHOLD} m: {near}")


def _main_pair(scene, which, tree, extra=()):
    argv = [*scene["argv"], "--score.sample_dir", scene["trees"][tree], *extra]
    port = CS.main([which, *argv, "--runtime.device", "cpu"])
    jax_res = JCS.main([which, *argv])
    return port, jax_res


@pytest.mark.parametrize("tree", ["identity", "perturbed"])
def test_compute_score_cr_matches_jax(scene, tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port, jax_res = _main_pair(scene, "cr", tree)
    assert port == jax_res
    assert port["n_frames"] > 0
    if tree == "identity":
        assert port["gt_contact_ratio"] == port["refined_contact_ratio"]


@pytest.mark.parametrize("tree", ["identity", "perturbed"])
def test_compute_score_psklj_matches_jax(scene, tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port, jax_res = _main_pair(scene, "psklj", tree)
    assert port["n_segments"] == jax_res["n_segments"] == N_SEG
    for k in ("psklj_gt_to_model", "psklj_model_to_gt"):
        if tree == "identity":  # both recompute the GT's joints: equal to the tree's up to rounding
            assert abs(port[k]) < 1e-6 and abs(jax_res[k]) < 1e-6
        else:
            np.testing.assert_allclose(port[k], jax_res[k], rtol=1e-6)


@pytest.mark.parametrize("tree", ["identity", "perturbed"])
def test_compute_score_fid_matches_jax(scene, tree, tmp_path, monkeypatch):
    """FID through a reference-layout .pt (run under gelu_exact by both)."""
    monkeypatch.chdir(tmp_path)
    port, jax_res = _main_pair(scene, "fid", tree, ("--score.encoder_filepath", scene["encoder_pt"]))
    assert port["n_segments"] == jax_res["n_segments"] == N_SEG
    if tree == "identity":
        assert abs(port["fid"]) < 1e-3 and abs(jax_res["fid"]) < 1e-3
    else:
        assert port["fid"] > 0.1
        np.testing.assert_allclose(port["fid"], jax_res["fid"], rtol=1e-5)


def test_fid_activations_match_jax_and_give_the_same_fid(scene):
    """The encodings behind run_fid at atol 1e-5; the port's FID of JAX's
    own activations at rtol 1e-6 (full rank: 40 segments, 32 dims)."""
    import jax

    from oakink2_tamf_tpu.interop.torch_port import load_reference_checkpoint
    from oakink2_tamf_tpu.launch.train_encoder import build_encoder as j_build_encoder
    from oakink2_tamf_tpu_torch.data.collate import SegmentCollate
    from oakink2_tamf_tpu_torch.launch import train_encoder
    from oakink2_tamf_tpu_torch.runtime.ckpt import load_model_weights

    argv = [*scene["argv"], "--score.sample_dir", scene["trees"]["perturbed"]]
    jreg = _jax_reg(argv)
    pairs = list(CS.iter_eval_pairs(scene["jax_ds"], CS.load_save_dicts(scene["trees"]["perturbed"])))
    collate = SegmentCollate(max_nobj=2, n_obj_points=128)
    model = train_encoder.build_encoder(jreg, activation="gelu_exact")
    load_model_weights(model, scene["encoder_pt"])
    gt, md = CS.fid_activations(model.eval(), collate, pairs, torch.device("cpu"))

    jmodel = j_build_encoder(jreg, activation="gelu_exact")
    params = load_reference_checkpoint(scene["encoder_pt"], "encoder", num_layers=2, num_heads=4)
    acts = []
    for samples in ([p[0] for p in pairs], [dict(s, pose_repr=sd["refine_pose_repr"]) for s, sd in pairs]):
        b = collate(samples)
        out = jmodel.apply(params, jnp.asarray(b["pose_repr"]),
                           {k: jnp.asarray(b[k]) for k in CS.COND_KEYS})
        acts.append(np.asarray(jax.device_get(out["encoding"])))
    np.testing.assert_allclose(gt, acts[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(md, acts[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(ME.calculate_fid(*acts), JME.calculate_fid(*acts), rtol=1e-6)


def test_compute_score_refuses_a_silent_cpu_run(scene, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CS.main(["cr", *scene["argv"], "--score.sample_dir", scene["trees"]["identity"]])
