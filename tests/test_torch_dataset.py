"""The real-data dataset of the port against the JAX package: the encode
half of core/transforms, data/slice, data/segment.InteractionSegmentData
(cache_dict pickles, .npy and .pt embeddings, .npz clouds, toolkit meshes
and raw extraction, the reverse augmentation, the cache round trip),
launch/common.build_dataset's real branch and
data/collate.interaction_segment_collate.

Inputs come from numpy seeds (data/fabricate.py for the cache_dict and the
object stores). Tolerance: atol 1e-6 for the codecs (float32 on both
sides); the dataset's samples are compared at atol 1e-6 too (their rot6d
and tslrot6d pass through those codecs), everything else exactly.
"""

import argparse
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch.core import transforms as T
from oakink2_tamf_tpu_torch.data import fabricate as F
from oakink2_tamf_tpu_torch.data.collate import interaction_segment_collate
from oakink2_tamf_tpu_torch.data.segment import InteractionSegmentData
from oakink2_tamf_tpu_torch.data.slice import segment_slice_from_gap
from oakink2_tamf_tpu_torch.launch import common, param
from oakink2_tamf_tpu_torch.runtime.config import ConfigRegistry

import jax.numpy as jnp
from oakink2_tamf_tpu.core import transforms as JT
from oakink2_tamf_tpu.data.collate import interaction_segment_collate as j_collate
from oakink2_tamf_tpu.data.segment import InteractionSegmentData as JInteractionSegmentData
from oakink2_tamf_tpu.data.slice import segment_slice_from_gap as j_slice
from oakink2_tamf_tpu.launch import common as jcommon
from oakink2_tamf_tpu.launch import param as jparam
from oakink2_tamf_tpu.runtime.config import ConfigRegistry as JConfigRegistry

ATOL = 1e-6
L = 160  # the cache arrays' length: build_dataset slices to 160 frames


def _rot(rng, shape):
    q, r = np.linalg.qr(rng.normal(size=shape + (3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
    q[..., :, 0] *= np.linalg.det(q)[..., None]
    return q.astype(np.float32)


def _transf(rng, shape):
    X = np.zeros(shape + (4, 4), np.float32)
    X[..., :3, :3] = _rot(rng, shape)
    X[..., :3, 3] = rng.normal(scale=0.3, size=shape + (3,))
    X[..., 3, 3] = 1.0
    return X


def _quat(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotvec(rng, shape):
    v = rng.normal(size=shape + (3,)).astype(np.float32)
    v[:2] *= 1e-7  # the small-angle series
    return v


CODECS = {
    "rotmat_to_rot6d": lambda r: (_rot(r, (5, 7)),),
    "quat_invert": lambda r: (_quat(r, (5, 7)),),
    "quat_multiply": lambda r: (_quat(r, (5, 7)), _quat(r, (5, 7))),
    "rotvec_to_quat": lambda r: (_rotvec(r, (9,)),),
    "quat_to_rotvec": lambda r: (_quat(r, (9,)),),
    "rotvec_to_rotmat": lambda r: (_rotvec(r, (9,)),),
    "rotmat_to_rotvec": lambda r: (_rot(r, (9,)),),
    "euler_to_rotmat": lambda r: (r.normal(size=(6, 3)).astype(np.float32),),
    "inv_transf": lambda r: (_transf(r, (4, 3)),),
    "transf_point_array": lambda r: (_transf(r, (4,)), r.normal(size=(4, 50, 3)).astype(np.float32)),
    "rotate_point_array": lambda r: (_rot(r, (4,)), r.normal(size=(4, 50, 3)).astype(np.float32)),
    "transf_to_tslrot6d": lambda r: (_transf(r, (4, 3)),),
    "project_point_array": lambda r: (
        np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32),
        (r.normal(scale=0.1, size=(30, 3)) + [0, 0, 0.6]).astype(np.float32),
    ),
    "pose_repr_encode": lambda r: (r.normal(size=(3, 8, 3)).astype(np.float32), _rot(r, (3, 8, 16))),
}


@pytest.mark.parametrize("name", sorted(CODECS))
def test_encode_codecs_match_jax(name):
    args = CODECS[name](np.random.default_rng(sorted(CODECS).index(name)))
    got = getattr(T, name)(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(getattr(JT, name)(*(jnp.asarray(a) for a in args)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if name == "euler_to_rotmat":
        got = T.euler_to_rotmat(torch.from_numpy(args[0]), "ZYX").numpy()
        np.testing.assert_allclose(got, np.asarray(JT.euler_to_rotmat(jnp.asarray(args[0]), "ZYX")), atol=ATOL)


@pytest.mark.parametrize("traj_len,gap,max_len,min_len", [
    (320, 12, 160, 16),  # gap kept
    (40, 12, 160, 16),  # short: the gap shrinks
    (4000, 12, 160, 16),  # long: the gap grows
    (160, 1, 160, 16),  # exact fit
    (37, 2, 20, 4),  # ragged phases
])
def test_segment_slice_matches_jax(traj_len, gap, max_len, min_len):
    traj = np.random.default_rng(traj_len).normal(size=(traj_len, 2, 3)).astype(np.float32)
    got, got_len = segment_slice_from_gap(traj, gap, max_len, min_len)
    want, want_len = j_slice(traj, gap, max_len, min_len)
    assert got_len == want_len
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


def test_segment_slice_refuses_a_segment_too_short():
    with pytest.raises(ValueError, match="outside"):
        segment_slice_from_gap(np.zeros((3, 1)), 1, 8, 4)


def _assert_samples_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = got[k], want[k]
        if k in ("obj_verts", "obj_faces"):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=k)
        else:
            assert a == b, k


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A fabricated cache_dict pickle (10 segments of up to L frames, 4
    objects, 2 per segment) with .npy embeddings, one .pt embedding and .npz
    clouds."""
    root = str(tmp_path_factory.mktemp("stores"))
    return F.write_dataset(root, 10, seq_len=L, n_obj=4, n_points=300, emb_dim=768, seed=3,
                           pt_embeddings=("obj_002",))


def _datasets(stores, **kw):
    args = dict(cache_dict_filepath=stores["cache_dict"], slice_max_len=L,
                obj_embedding_prefix=stores["obj_embedding_prefix"],
                obj_pointcloud_prefix=stores["obj_pointcloud_prefix"], **kw)
    return InteractionSegmentData(**args), JInteractionSegmentData(**args)


def test_segment_data_matches_jax(stores):
    """Every key of every sample, with the toolkit's box meshes."""
    port, jax_ds = _datasets(stores, enable_obj_model=True, toolkit=F.BoxToolkit())
    assert len(port) == len(jax_ds) == 10
    assert port.object_list == jax_ds.object_list
    for i in range(len(port)):
        _assert_samples_equal(port[i], jax_ds[i])
    s = port[0]
    assert s["obj_embedding"].shape == (2, 768) and s["obj_pointcloud"].shape == (2, 300, 3)
    assert len(s["obj_verts"]) == 2 and s["obj_faces"][0].shape == (12, 3)


def test_segment_data_reverse_augmentation_matches_jax(stores):
    port, jax_ds = _datasets(stores, append_reverse_segment=True)
    assert len(port) == len(jax_ds) == 20
    for i in range(len(port)):
        _assert_samples_equal(port[i], jax_ds[i])
    n0 = len(port) // 2
    fwd, rev = port[1], port[n0 + 1]
    n = fwd["len"]
    np.testing.assert_array_equal(rev["pose_repr"][:n], fwd["pose_repr"][:n][::-1])
    np.testing.assert_array_equal(rev["pose_repr"][n:], fwd["pose_repr"][n:])
    assert rev["frame_id"] == fwd["frame_id"][::-1]


def test_segment_data_leaves_the_cache_dict_alone(stores):
    with open(stores["cache_dict"], "rb") as f:
        cache = pickle.load(f)
    n = len(cache["interaction_segment_len_list"])
    ds = InteractionSegmentData(cache_dict=cache, slice_max_len=L, append_reverse_segment=True)
    assert len(ds) == 2 * n and len(cache["interaction_segment_len_list"]) == n


def test_segment_cache_round_trip(stores, tmp_path):
    """save_cache then load: the same samples, for the port and for JAX."""
    port, _ = _datasets(stores, append_reverse_segment=True)
    fp = str(tmp_path / "cache.pkl")
    port.save_cache(fp)
    again = InteractionSegmentData(cache_dict_filepath=fp, slice_max_len=L)
    jax_again = JInteractionSegmentData(cache_dict_filepath=fp, slice_max_len=L)
    assert len(again) == len(jax_again) == len(port)
    assert sorted(port.get_cache()) == sorted(again.get_cache())
    for i in range(len(port)):
        want = {k: v for k, v in port[i].items() if k not in ("obj_embedding", "obj_pointcloud")}
        _assert_samples_equal(again[i], want)
        _assert_samples_equal(jax_again[i], want)


class _Prim(SimpleNamespace):
    """A primitive-task record with oakink2_toolkit's attribute and item access."""

    def __getitem__(self, k):
        return getattr(self, k)


class _Toolkit(F.BoxToolkit):
    """One complex task of three primitives (rh, both hands, an lh one with
    no object, which is skipped) with random quaternions and transforms."""

    RAW = 14

    def _prim(self, hand_involved, obj_ids, beg):
        rng = np.random.default_rng(beg)
        n = self.RAW
        kw = dict(frame_range=(beg, beg + n + 2), hand_involved=hand_involved, task_desc=f"task at {beg}",
                  obj_transf={oid: _transf(rng, (n + 2,)) for oid in obj_ids})
        for hs in ("lh", "rh"):
            kw[f"frame_range_{hs}"] = (beg + 1, beg + 1 + n)
            kw[f"{hs}_obj_list"] = list(obj_ids) if hand_involved in ("bh", hs) else []
            kw[f"{hs}_in_range_mask"] = np.concatenate([np.ones(n, bool), np.zeros(3, bool)])
            kw[f"{hs}_param"] = {"pose_coeffs": _quat(rng, (n + 3, 16)),
                                 "tsl": rng.normal(size=(n + 3, 3)).astype(np.float32),
                                 "betas": rng.normal(size=(n + 3, 10)).astype(np.float32)}
        return _Prim(**kw)

    def load_complex_task(self, seq_key):
        return SimpleNamespace(exec_path=["grip:0001", "place_onto:0002", "hold:0003"])

    def load_primitive_task(self, complex_task_data):
        return [self._prim("rh", ["obj_000"], 100), self._prim("bh", ["obj_000", "obj_001"], 200),
                self._prim("lh", [], 300)]


def test_segment_toolkit_extraction_matches_jax():
    kw = dict(process_range_list=["scene/seq_a"], toolkit=_Toolkit(), target_fps=60.0, slice_min_len=4,
              slice_max_len=8, enable_obj_model=True)
    port, jax_ds = InteractionSegmentData(**kw), JInteractionSegmentData(**kw)
    assert len(port) == len(jax_ds) == 6
    assert port.object_list == jax_ds.object_list == ["obj_000", "obj_001"]
    for i in range(len(port)):
        _assert_samples_equal(port[i], jax_ds[i])


def _registries(argv):
    regs = []
    for Reg, prm in ((ConfigRegistry, param), (JConfigRegistry, jparam)):
        reg = Reg("test_dataset")
        prm.reg_base_param(reg)
        parser = argparse.ArgumentParser()
        reg.hook(parser)
        reg.parse(parser, argv)
        regs.append(reg)
    return regs


def test_build_dataset_real_branch_matches_jax(stores):
    argv = ["--data.obj_embedding_prefix", stores["obj_embedding_prefix"],
            "--data.obj_pointcloud_prefix", stores["obj_pointcloud_prefix"],
            "--data.append_reverse_segment", "true", "--data.enable_obj_model", "true",
            "--train.cache_dict_filepath", stores["cache_dict"],
            "--test.cache_dict_filepath", stores["cache_dict"]]
    reg, jreg = _registries(argv)
    for split in ("train", "test"):
        port, jax_ds = common.build_dataset(reg, split), jcommon.build_dataset(jreg, split)
        assert isinstance(port, InteractionSegmentData)
        assert len(port) == len(jax_ds) == (20 if split == "train" else 10)
        for i in (0, 3, len(port) - 1):
            _assert_samples_equal(port[i], jax_ds[i])
    with_meshes = common.build_dataset(reg, "test", toolkit=F.BoxToolkit())[0]
    assert len(with_meshes["obj_verts"]) == with_meshes["obj_num"]


def test_interaction_segment_collate_matches_jax(stores):
    port, _ = _datasets(stores, enable_obj_model=True, toolkit=F.BoxToolkit())
    samples = [port[i] for i in range(5)]
    got = interaction_segment_collate(samples, max_nobj=3, n_obj_points=128)
    want = j_collate(samples, max_nobj=3, n_obj_points=128)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert len(got[k]) == len(v), k
