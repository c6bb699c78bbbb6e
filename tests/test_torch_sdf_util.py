"""The port's SDF tools (oakink2_tamf_tpu_torch/eval/sdf_util.py) against the
JAX package's (eval/sdf_util.py), on a sphere and a box at resolution <= 24:
the grids, fields and reconstructions are equal (the same numpy arithmetic
and containment test on both sides), and each side's pickles load in the
other. No tolerance: arrays are compared for equality."""

import dataclasses

import numpy as np
import pytest

from oakink2_tamf_tpu.eval import sdf_util as JS
from oakink2_tamf_tpu_torch.data.fabricate import BOX_FACES, box_verts
from oakink2_tamf_tpu_torch.eval import sdf_util as S

from test_sdf_util import icosphere

MESHES = {
    "sphere": lambda: icosphere(r=0.1, center=(0.3, -0.2, 0.5)),
    "box": lambda: (box_verts("obj_002").astype(np.float64) + [0.05, 0.0, -0.1], BOX_FACES),
}
FIELDS = [f.name for f in dataclasses.fields(JS.SDFData)]


def _assert_same(a, b) -> None:
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)), err_msg=name)


@pytest.fixture(scope="module", params=[("sphere", 20), ("box", 24)], ids=["sphere-20", "box-24"])
def both(request):
    mesh, res = request.param
    verts, faces = MESHES[mesh]()
    return (S.process_sdf(verts, faces, resolution=res, n_surface_samples=2000),
            JS.process_sdf(verts, faces, resolution=res, n_surface_samples=2000))


def test_process_sdf_equals_jax(both):
    got, want = both
    assert [f.name for f in dataclasses.fields(S.SDFData)] == FIELDS
    _assert_same(got, want)
    assert (got.sdf > 0).any() and (got.sdf < 0).any()


def test_reconstruct_sdf_equals_jax(both):
    got, want = both
    rec = S.reconstruct_sdf(got.sdf, got.mesh_center, got.extent_expanded, got.resolution)
    ref = JS.reconstruct_sdf(want.sdf, want.mesh_center, want.extent_expanded, want.resolution)
    assert len(rec.face) > 100
    for name in ("vert", "face", "normal", "value"):
        np.testing.assert_array_equal(getattr(rec, name), getattr(ref, name), err_msg=name)


def test_sphere_sign_and_reconstruction_radius():
    """The JAX package's sphere properties (tests/test_sdf_util.py) on the
    port: positive inside, the surface back at r = 0.1, normals outward."""
    verts, faces = MESHES["sphere"]()
    data = S.process_sdf(verts, faces, resolution=20, n_surface_samples=2000)
    d_center = np.linalg.norm(data.point - data.mesh_center, axis=1)
    assert (data.sdf > 0)[d_center < 0.065].mean() > 0.9 and (data.sdf <= 0)[d_center > 0.135].mean() > 0.9
    rec = S.reconstruct_sdf(data.sdf, data.mesh_center, data.extent_expanded, data.resolution)
    rad = np.linalg.norm(rec.vert - data.mesh_center, axis=1)
    np.testing.assert_allclose(rad, 0.1, atol=0.03)
    np.testing.assert_allclose(np.linalg.norm(rec.normal, axis=1), 1.0, atol=1e-6)
    assert (np.sum(rec.normal * (rec.vert - data.mesh_center) / rad[:, None], axis=1) > 0).mean() > 0.9


def test_reconstruct_sdf_without_a_crossing_is_empty():
    rec = S.reconstruct_sdf(np.ones(8**3), np.zeros(3), np.ones(3), 8)
    assert rec.vert.shape == (0, 3) and rec.face.shape == (0, 3) and rec.value.shape == (0,)


@pytest.mark.parametrize("writer,reader", [(S, JS), (JS, S)], ids=["port-to-jax", "jax-to-port"])
def test_pickles_cross_load(both, tmp_path, writer, reader):
    got, want = both
    path = str(tmp_path / "sdf.pkl")
    writer.save_sdf_data(path, got if writer is S else want)
    back = reader.load_sdf_data(path)
    assert isinstance(back, reader.SDFData)
    _assert_same(back, want)
    assert back["resolution"] == want.resolution and back.get("missing", 7) == 7
