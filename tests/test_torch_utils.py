"""The port's small utilities (oakink2_tamf_tpu_torch/utils/) against the JAX
package's, on the CPU: mesh_io, cast, hash_util, random, registration,
integrity's pins and pc_util.depth_to_pointcloud.

Equal where both sides run the same numpy code (mesh IO, surface samples,
digests, pin files, depth unprojection). The random rotations come from a
torch.Generator and cannot equal JAX's key draws: they are held to the
JAX package's properties (tests/test_utils.py), and the map from uniforms
to quaternions to JAX's on JAX's own uniforms within 1e-6. Kabsch against
JAX's on the same points within 1e-5 (float32) and 1e-10 (float64)."""

import contextlib
import os

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch.utils import cast as UC
from oakink2_tamf_tpu_torch.utils import hash_util as H
from oakink2_tamf_tpu_torch.utils import integrity as I
from oakink2_tamf_tpu_torch.utils import mesh_io as MI
from oakink2_tamf_tpu_torch.utils import pc_util as PC
from oakink2_tamf_tpu_torch.utils import random as UR
from oakink2_tamf_tpu_torch.utils import registration as REG

TETRA = (np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32),
         np.array([[0, 1, 2], [0, 2, 3], [0, 3, 1], [1, 3, 2]], np.int32))


def test_obj_round_trip_and_jax_reads_the_port_file(tmp_path):
    from oakink2_tamf_tpu.utils import mesh_io as JMI

    verts, faces = TETRA
    p = str(tmp_path / "m.obj")
    MI.save_obj(p, verts, faces)
    for load in (MI.load_obj, JMI.load_obj):
        v2, f2 = load(p)
        np.testing.assert_array_equal(v2, verts)
        np.testing.assert_array_equal(f2, faces)
    JMI.save_obj(str(tmp_path / "j.obj"), verts * 0.37, faces)
    MI.save_obj(str(tmp_path / "k.obj"), verts * 0.37, faces)
    assert (tmp_path / "k.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()


def test_load_obj_fan_triangulates_polygons(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("# quad and pentagon\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0\n"
                 "vn 0 0 1\nf 1//1 2//1 3//1 4//1\nf 1/1/1 2/1/1 3/1/1 5/1/1 4/1/1\n")
    v, f = MI.load_obj(str(p))
    assert v.shape == (5, 3) and v.dtype == np.float32 and f.dtype == np.int32
    np.testing.assert_array_equal(f, [[0, 1, 2], [0, 2, 3], [0, 1, 2], [0, 2, 4], [0, 4, 3]])


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_surface_equals_jax(seed):
    from oakink2_tamf_tpu.utils import mesh_io as JMI

    verts, faces = TETRA
    got = MI.sample_surface(verts, faces, 777, seed=seed)
    np.testing.assert_array_equal(got, JMI.sample_surface(verts, faces, 777, seed=seed))
    assert got.dtype == np.float32 and got.shape == (777, 3)
    # on the surface: one coordinate 0, or on the slanted face x + y + z = 1
    on_axis_plane = (np.abs(got) < 1e-7).any(axis=1)
    on_slant = np.abs(got.sum(axis=1) - 1) < 1e-5
    assert (on_axis_plane | on_slant).all()


def test_map_copy_select_to():
    batch = {"a": np.ones((2, 3)), "b": ["x", "y"], "c": np.zeros((2,)), "i": np.arange(3),
             "t": torch.ones(2, dtype=torch.float64)}
    out = UC.map_copy_select_to(batch, select=("a", "i", "t"), dtype=torch.float32, device="cpu")
    assert isinstance(out["a"], torch.Tensor) and out["a"].dtype == torch.float32 and out["a"].shape == (2, 3)
    assert out["i"].dtype == torch.int64  # not floating: not cast
    assert out["t"].dtype == torch.float32
    assert out["b"] == ["x", "y"] and isinstance(out["c"], np.ndarray)
    keep = UC.map_copy_select_to(batch, select=("a",))
    assert keep["a"].dtype == torch.float64 and keep["a"].device.type == "cpu"


def test_md5_equals_jax(tmp_path):
    from oakink2_tamf_tpu.utils import hash_util as JH

    data = np.random.default_rng(0).bytes(3 * 1024 + 17)
    p = tmp_path / "blob.bin"
    p.write_bytes(data)
    assert H.md5_file(str(p), chunk=1000) == H.md5_file(str(p)) == JH.md5_file(str(p)) == H.md5_bytes(data)
    assert H.md5_bytes(b"") == "d41d8cd98f00b204e9800998ecf8427e"


def test_quat_from_uniforms_equals_jax():
    """The port's Shoemake map on the uniforms JAX's random_quat draws
    (its split keys, in its order) gives JAX's quaternions."""
    import jax
    import jax.numpy as jnp

    from oakink2_tamf_tpu.utils import random as JUR

    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    u1 = np.asarray(jax.random.uniform(k1, (64,)))
    u2 = np.asarray(jax.random.uniform(k2, (64,), minval=0.0, maxval=2 * jnp.pi))
    u3 = np.asarray(jax.random.uniform(k3, (64,), minval=0.0, maxval=2 * jnp.pi))
    got = UR.quat_from_uniforms(*(torch.tensor(u) for u in (u1, u2, u3)))
    np.testing.assert_allclose(got.numpy(), np.asarray(JUR.random_quat(key, (64,))), rtol=0, atol=1e-6)


def test_random_quat_and_rotmat_properties():
    """tests/test_utils.py's properties: unit norm, det 1, the mean axis
    roughly isotropic; the same generator state gives the same draws."""
    q = UR.random_quat(torch.Generator().manual_seed(0), (1000,))
    assert q.shape == (1000, 4) and q.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.norm(q, dim=-1).numpy(), 1.0, atol=1e-5)
    R = UR.random_rotmat(torch.Generator().manual_seed(0), (500,))
    assert R.shape == (500, 3, 3)
    np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, atol=1e-4)
    assert float(q.mean(dim=0)[1:].abs().max()) < 0.1
    assert torch.equal(UR.random_quat(torch.Generator().manual_seed(4), (3, 2)),
                       UR.random_quat(torch.Generator().manual_seed(4), (3, 2)))
    assert UR.random_quat().shape == (4,)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5), (np.float64, 1e-10)])
@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch_equals_jax_and_recovers_the_transform(dtype, atol, weighted):
    import jax
    import jax.numpy as jnp

    from oakink2_tamf_tpu.utils import registration as JREG

    rng = np.random.default_rng(0)
    R = UR.random_rotmat(torch.Generator().manual_seed(1)).double().numpy()
    t = rng.normal(size=(3,))
    src = rng.normal(size=(2, 100, 3))
    dst = src @ R.T + t + rng.normal(scale=1e-3, size=src.shape)
    w = rng.uniform(0.1, 1.0, size=(2, 100)) if weighted else None
    args = [a.astype(dtype) for a in (src, dst)] + ([w.astype(dtype)] if weighted else [])
    got = REG.kabsch(*(torch.from_numpy(a) for a in args))
    assert got.shape == (2, 4, 4) and got.dtype == torch.from_numpy(args[0]).dtype
    with jax.enable_x64(True) if dtype == np.float64 else contextlib.nullcontext():
        want = np.asarray(JREG.kabsch(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    np.testing.assert_allclose(got[0, :3, :3].numpy(), R, atol=5e-3)
    np.testing.assert_allclose(got[0, :3, 3].numpy(), t, atol=5e-3)
    np.testing.assert_array_equal(got[:, 3].numpy(), [[0, 0, 0, 1]] * 2)


def test_kabsch_folds_out_the_reflection():
    """A mirrored target: the SVD's best orthogonal map is a reflection;
    kabsch returns a rotation (det +1), as JAX's."""
    src = torch.randn((50, 3), generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    dst = src * torch.tensor([1.0, 1.0, -1.0], dtype=torch.float64)
    X = REG.kabsch(src, dst)
    assert abs(float(torch.linalg.det(X[:3, :3])) - 1.0) < 1e-9


def _write(path, data: bytes) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("header", [None, "# header line one\n# header line two\n"])
def test_record_pin_writes_the_jax_packages_bytes(tmp_path, header):
    from oakink2_tamf_tpu.utils import integrity as JI

    for side in ("port", "jax"):
        _write(str(tmp_path / side / "sub" / "b.bin"), b"bee")
        _write(str(tmp_path / side / "a.bin"), b"ay")
        if header is not None:
            (tmp_path / side / I.PIN_BASENAME).write_text(header)
    for side, mod in (("port", I), ("jax", JI)):
        pin = str(tmp_path / side / I.PIN_BASENAME)
        mod.record_pin(str(tmp_path / side / "sub" / "b.bin"), pin)
        mod.record_pin(str(tmp_path / side / "a.bin"), pin)
        mod.record_pin(str(tmp_path / side / "a.bin"), pin)  # the same pin again: a no-op
    got = (tmp_path / "port" / I.PIN_BASENAME).read_bytes()
    assert got == (tmp_path / "jax" / I.PIN_BASENAME).read_bytes()
    pins = I.load_pins(str(tmp_path / "port" / I.PIN_BASENAME))
    assert pins == JI.load_pins(str(tmp_path / "port" / I.PIN_BASENAME))
    assert sorted(pins) == ["a.bin", "sub/b.bin"] and pins["a.bin"] == I.sha256_file(str(tmp_path / "port" / "a.bin"))


def test_pins_verify_and_refuse_a_changed_pin(tmp_path):
    asset = tmp_path / "grabnet" / "weights.npy"
    _write(str(asset), b"hello-weights")
    pin_file = str(tmp_path / I.PIN_BASENAME)
    I.record_pin(str(asset), pin_file)
    assert I.verify_pinned(str(asset)) is True
    _write(str(asset), b"CORRUPTED!!!")
    with pytest.raises(ValueError, match="integrity pin"):
        I.verify_pinned(str(asset))
    with pytest.raises(ValueError, match="refusing to overwrite"):
        I.record_pin(str(asset), pin_file)


def test_load_pins_reads_the_committed_file():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pins = I.load_pins(os.path.join(here, "asset", I.PIN_BASENAME))
    assert pins["clip/bpe_simple_vocab_16e6.txt.gz"] == (
        "924691ac288e54409236115652ad4aa250f48203de50a9e4722a6ecd48d6804a")


@pytest.mark.parametrize("masked", [False, True])
def test_depth_to_pointcloud_equals_jax(masked):
    from oakink2_tamf_tpu.utils import pc_util as JPC

    rng = np.random.default_rng(5)
    depth = rng.uniform(300, 900, size=(12, 16)).astype(np.uint16)
    depth[rng.random(depth.shape) < 0.2] = 0  # holes
    K = np.array([[520.0, 0, 7.5], [0, 515.0, 5.5], [0, 0, 1]])
    mask = rng.random(depth.shape) < 0.5 if masked else None
    got = PC.depth_to_pointcloud(depth, K, depth_scale=1e-3, mask=mask)
    np.testing.assert_array_equal(got, JPC.depth_to_pointcloud(depth, K, depth_scale=1e-3, mask=mask))
    keep = (depth > 0) & (mask if masked else True)
    assert got.shape == (int(keep.sum()), 3) and got.dtype == np.float32
    np.testing.assert_allclose(got[:, 2], depth[keep] * 1e-3, rtol=1e-6)
