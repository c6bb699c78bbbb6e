"""The SIV side of the port's scoring chain against the JAX package:
eval/inside_mesh (the port's own C++ triangle hash, built at first use,
and its numpy version), eval/metrics.object_interior_grid /
solid_intersection_volume, and compute_score siv on fabricated real-format
data with the box toolkit's meshes (data/fabricate.py).

SIV is compared exactly: both packages move the interior grid by the same
float32 transform and run the same C++ test. The synthetic MANO hand has
large triangles, so each containment test spends ~2 s hashing them at the
default 512 cells per axis; the compute_score scene is cut to one segment
of two objects and one scored frame to stay near a minute.
"""

import argparse
import os

import numpy as np
import pytest

from oakink2_tamf_tpu.core import mano as JM
from oakink2_tamf_tpu.data.segment import InteractionSegmentData as JInteractionSegmentData
from oakink2_tamf_tpu.eval import compute_score as JCS
from oakink2_tamf_tpu.eval import inside_mesh as JIM
from oakink2_tamf_tpu.eval import metrics as JME
from oakink2_tamf_tpu.launch import param as jparam
from oakink2_tamf_tpu.models.refine_r import stack_mano_models as j_stack_mano_models
from oakink2_tamf_tpu.runtime.config import ConfigRegistry as JConfigRegistry
from oakink2_tamf_tpu_torch import native
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.data import fabricate as F
from oakink2_tamf_tpu_torch.eval import compute_score as CS
from oakink2_tamf_tpu_torch.eval import inside_mesh as IM
from oakink2_tamf_tpu_torch.eval import metrics as ME

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "config/synthetic_smoke.yml")


def test_inside_mesh_native_and_numpy_match_jax():
    mano = M.synthetic_mano_model("left")
    verts, faces = mano.v_template.astype(np.float64), M.closed_faces(mano)
    rng = np.random.default_rng(9)
    lo, hi = verts.min(0), verts.max(0)
    pts = rng.uniform(lo - 0.01, hi + 0.01, size=(20000, 3))
    got = IM.check_mesh_contains(verts, faces, pts)
    np.testing.assert_array_equal(got, JIM.check_mesh_contains(verts, faces, pts))
    np.testing.assert_array_equal(IM.check_mesh_contains(verts, faces, pts, impl="numpy"),
                                  JIM._inside_mesh_numpy(verts, faces, pts))
    assert 0 < got.sum() < len(pts)
    # off the faces' diagonals, where the +z ray meets two triangles' shared edge
    h = F.box_half_extent("obj_000")
    box = IM.check_mesh_contains(F.box_verts("obj_000"), F.BOX_FACES, np.array([[0.3, -0.2, 0.1], [1.1, 0, 0]]) * h)
    assert box.tolist() == [True, False]
    with pytest.raises(ValueError, match="impl"):
        IM.check_mesh_contains(verts, faces, pts, impl="scipy")


def test_native_library_is_the_ports_own_build():
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.startswith(os.path.dirname(os.path.abspath(native.__file__)))
    lib = native.get_lib()
    assert os.path.realpath(lib._name) == os.path.realpath(path) and os.path.isfile(path)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No silent numpy fallback: a compile that fails raises."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        IM.check_mesh_contains(F.box_verts("obj_000"), F.BOX_FACES, np.zeros((1, 3)))


def test_object_interior_grid_and_siv_match_jax():
    verts, faces = F.box_verts("obj_001"), F.BOX_FACES
    for impl in ("native", "numpy"):
        pts, tick = ME.object_interior_grid(verts, faces, resolution=16, impl=impl)
        jpts, jtick = JME.object_interior_grid(verts, faces, resolution=16)
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(tick, jtick)
    mano = M.synthetic_mano_model("right")
    hand_faces = M.closed_faces(mano)
    rng = np.random.default_rng(2)
    for _ in range(2):
        X = np.eye(4, dtype=np.float32)
        X[:3, 3] = mano.v_template[rng.integers(0, 778)] + rng.normal(scale=0.01, size=3)
        args = (mano.v_template.astype(np.float32), hand_faces, [pts], [tick], [X])
        got = ME.solid_intersection_volume(*args)
        assert got > 0.0
        assert got == JME.solid_intersection_volume(*args)
        assert got == ME.solid_intersection_volume(*args, impl="numpy")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("siv"))
    paths = F.write_dataset(root, 1, seq_len=160, n_obj=3, n_points=64, min_len=8, max_len=12, seed=5)
    jax_ds = JInteractionSegmentData(
        cache_dict_filepath=paths["cache_dict"], obj_pointcloud_prefix=paths["obj_pointcloud_prefix"],
        enable_obj_model=True, toolkit=F.BoxToolkit())
    samples = [jax_ds[i] for i in range(len(jax_ds))]
    mano_rh, mano_lh = M.get_mano_model(None, "right"), M.get_mano_model(None, "left")
    stack = CS.stack_mano_models(mano_rh, mano_lh, "cpu")
    faces = {0: M.closed_faces(mano_rh), 1: M.closed_faces(mano_lh)}
    trees = {k: F.write_save_dicts(os.path.join(root, k), samples, stack, faces,
                                 sigma=0.3 if k == "perturbed" else 0.0, seed=3)
             for k in ("identity", "perturbed")}
    argv = ["--cfg", SMOKE, "--data.synthetic", "false", "--data.enable_obj_model", "true",
            "--test.cache_dict_filepath", paths["cache_dict"],
            "--data.obj_pointcloud_prefix", paths["obj_pointcloud_prefix"],
            "--score.sdf_resolution", "24", "--score.frame_stride", "16"]
    return {"trees": trees, "argv": argv, "jax_ds": jax_ds}


def _jax_reg(argv):
    reg = JConfigRegistry("test_siv")
    for fn in (jparam.reg_base_param, jparam.reg_mano_param, jparam.reg_model_param, JCS.reg_score_param):
        fn(reg)
    parser = argparse.ArgumentParser()
    reg.hook(parser)
    reg.parse(parser, argv)
    return reg


@pytest.mark.parametrize("tree", ["identity", "perturbed"])
def test_compute_score_siv_matches_jax(scene, tree, tmp_path, monkeypatch):
    """The port's main with the box toolkit against the JAX runner on the
    same meshes (JAX's build_dataset takes no toolkit)."""
    monkeypatch.chdir(tmp_path)
    argv = [*scene["argv"], "--score.sample_dir", scene["trees"][tree]]
    port = CS.main(["siv", *argv, "--runtime.device", "cpu"], toolkit=F.BoxToolkit())
    jmano = j_stack_mano_models(JM.synthetic_mano_model("right"), JM.synthetic_mano_model("left"))
    jax_res = JCS.run_siv(_jax_reg(argv), scene["jax_ds"], JCS.load_save_dicts(scene["trees"][tree]), jmano)
    assert port == jax_res
    assert port["n_frames"] == 1
    if tree == "identity":
        assert port["gt_siv_cm3"] == port["refined_siv_cm3"]


def test_compute_score_siv_without_meshes_scores_nothing(scene, tmp_path, monkeypatch):
    """Without the toolkit's meshes each segment is skipped with a warning."""
    monkeypatch.chdir(tmp_path)
    res = CS.main(["siv", *scene["argv"], "--score.sample_dir", scene["trees"]["identity"],
                   "--runtime.device", "cpu"])
    assert res["n_frames"] == 0 and np.isnan(res["gt_siv_cm3"])
