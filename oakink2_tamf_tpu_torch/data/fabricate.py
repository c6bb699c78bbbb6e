"""Real-format OakInk2 data made from a seed, for runs without the dataset:
a `cache_dict` in the reference's layout (data/segment._CACHE_KEYS), the
per-object embedding (.npy or .pt) and point-cloud (.npz) stores, a
stand-in toolkit whose `load_affordance(oid).obj_mesh` is a closed box,
and save_dict trees in launch/sample_r's layout for the scoring.

Each object is a box whose surface holds its point cloud, so the mesh
(SIV) and the cloud (CR) describe one solid. Segments are zero-padded past
their length, as data/slice.py pads. Poses are small joint rotations about
a random global orientation; each object sits a few centimetres from the
wrist, so some frames come within the Contact Ratio's 5 mm.
"""

from __future__ import annotations

import os
import pickle
from types import SimpleNamespace

import numpy as np
import torch

from ..core import mano as M
from ..core import transforms as T
from .adaptors import ACTION_LIST, NUM_ACTIONS

BOX_FACES = np.array(
    [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
     [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]],
    np.int32,
)
_BOX_CORNERS = np.array(
    [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
     [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32,
)


def object_ids(n_obj: int) -> list[str]:
    return [f"obj_{j:03d}" for j in range(n_obj)]


def box_half_extent(oid: str) -> np.ndarray:
    """The box of object `oid`: half extents in [0.02, 0.05] m per axis."""
    rng = np.random.default_rng(int(oid.split("_")[-1]) + 1000)
    return rng.uniform(0.02, 0.05, size=3).astype(np.float32)


def box_verts(oid: str) -> np.ndarray:
    return _BOX_CORNERS * box_half_extent(oid)


def box_surface_points(oid: str, n_points: int, seed: int = 0) -> np.ndarray:
    """n_points uniform on the box's surface, [n_points, 3] float32."""
    h = box_half_extent(oid).astype(np.float64)
    rng = np.random.default_rng((seed, int(oid.split("_")[-1])))
    area = np.array([h[1] * h[2], h[0] * h[2], h[0] * h[1]])  # faces normal to x, y, z
    axis = rng.choice(3, size=n_points, p=area / area.sum())
    p = rng.uniform(-1.0, 1.0, size=(n_points, 3))
    p[np.arange(n_points), axis] = rng.choice((-1.0, 1.0), size=n_points)
    return (p * h).astype(np.float32)


def _rotmats(rotvec: np.ndarray) -> np.ndarray:
    return T.rotvec_to_rotmat(torch.from_numpy(rotvec.astype(np.float32))).numpy()


def make_cache_dict(n_seg: int, seq_len: int = 160, n_obj: int = 4, objs_per_seg: int = 2,
                    min_len: int = 16, max_len: int | None = None, seed: int = 0) -> dict:
    """A cache_dict of n_seg segments over n_obj objects, arrays of seq_len
    frames: each segment holds `objs_per_seg` of the objects, its length is
    drawn in [min_len, max_len or seq_len], and its action cycles over
    ACTION_LIST."""
    rng = np.random.default_rng(seed)
    oids = object_ids(n_obj)
    keys = {k: [] for k in ("info", "len", "pose", "tsl", "shape", "hs", "text", "otraj", "fid")}
    for i in range(n_seg):
        n = int(rng.integers(min_len, (max_len or seq_len) + 1))
        glob = rng.normal(scale=1.0, size=3)
        rotvec = np.zeros((seq_len, 16, 3))
        rotvec[:n, 0] = glob + np.cumsum(rng.normal(scale=0.02, size=(n, 3)), axis=0)
        rotvec[:n, 1:] = rng.normal(scale=0.25, size=(1, 15, 3)) + rng.normal(scale=0.02, size=(n, 15, 3))
        pose = _rotmats(rotvec)
        pose[n:] = 0.0
        tsl = np.zeros((seq_len, 3), np.float32)
        tsl[:n] = rng.normal(scale=0.1, size=3) + np.cumsum(rng.normal(scale=0.002, size=(n, 3)), axis=0)
        shape = np.zeros((seq_len, 10), np.float32)
        shape[:n] = rng.normal(scale=0.5, size=10)
        hs = "rh" if i % 2 == 0 else "lh"
        otraj = {}
        for oid in sorted(rng.choice(oids, size=min(objs_per_seg, n_obj), replace=False).tolist()):
            X = np.zeros((seq_len, 4, 4), np.float32)
            X[:n, :3, :3] = _rotmats(rng.normal(size=3) + np.zeros((n, 3)))
            X[:n, :3, 3] = tsl[:n] + rng.normal(scale=0.06, size=3)
            X[:n, 3, 3] = 1.0
            otraj[oid] = X
        keys["info"].append((f"fab/seq_{i // 4:03d}", f"{ACTION_LIST[i % NUM_ACTIONS]}:{i:04d}", hs))
        keys["len"].append(n)
        keys["pose"].append(pose.astype(np.float32))
        keys["tsl"].append(tsl)
        keys["shape"].append(shape)
        keys["hs"].append(hs)
        keys["text"].append(f"{ACTION_LIST[i % NUM_ACTIONS].replace('_', ' ')} the object")
        keys["otraj"].append(otraj)
        keys["fid"].append(list(range(100 * i, 100 * i + n)))
    return {
        "interaction_segment_info_list": keys["info"],
        "interaction_segment_len_list": keys["len"],
        "interaction_segment_pose_list": keys["pose"],
        "interaction_segment_tsl_list": keys["tsl"],
        "interaction_segment_shape_list": keys["shape"],
        "interaction_segment_hand_side_list": keys["hs"],
        "interaction_segment_text_list": keys["text"],
        "interaction_segment_obj_traj_list": keys["otraj"],
        "interaction_segment_frame_id_list": keys["fid"],
        "interaction_object_list": oids,
    }


def write_dataset(root: str, n_seg: int, seq_len: int = 160, n_obj: int = 4, n_points: int = 8192,
                  emb_dim: int = 768, objs_per_seg: int = 2, min_len: int = 16, max_len: int | None = None,
                  seed: int = 0,
                  pt_embeddings: tuple[str, ...] = ()) -> dict[str, str]:
    """Write make_cache_dict's pickle and the object stores under `root`:
    {"cache_dict": path, "obj_embedding_prefix": dir, "obj_pointcloud_prefix": dir}.
    Objects named in `pt_embeddings` store their embedding as a torch .pt."""
    cache = make_cache_dict(n_seg, seq_len, n_obj, objs_per_seg, min_len, max_len, seed)
    paths = {"cache_dict": os.path.join(root, "cache_dict.pkl"),
             "obj_embedding_prefix": os.path.join(root, "obj_embedding"),
             "obj_pointcloud_prefix": os.path.join(root, "obj_pointcloud")}
    os.makedirs(paths["obj_embedding_prefix"], exist_ok=True)
    os.makedirs(paths["obj_pointcloud_prefix"], exist_ok=True)
    with open(paths["cache_dict"], "wb") as f:
        pickle.dump(cache, f)
    rng = np.random.default_rng((seed, 1))
    for oid in cache["interaction_object_list"]:
        emb = rng.normal(size=(emb_dim,)).astype(np.float32)
        if oid in pt_embeddings:
            torch.save(torch.from_numpy(emb), os.path.join(paths["obj_embedding_prefix"], f"{oid}.pt"))
        else:
            np.save(os.path.join(paths["obj_embedding_prefix"], f"{oid}.npy"), emb)
        np.savez(os.path.join(paths["obj_pointcloud_prefix"], f"{oid}.npz"),
                 point=box_surface_points(oid, n_points, seed))
    return paths


class BoxToolkit:
    """oakink2_toolkit's `load_affordance` for fabricated objects: each
    object's mesh is its closed box (`.obj_mesh.vertices`, `.faces`)."""

    def load_affordance(self, oid: str):
        return SimpleNamespace(obj_mesh=SimpleNamespace(vertices=box_verts(oid), faces=BOX_FACES.copy()))


def write_save_dicts(root: str, samples, mano_stack: M.ManoTensors, closed_faces: dict, *,
                     sigma: float = 0.0, seed: int = 0) -> str:
    """One save_dict.pkl per sample under `root`, in launch/sample_r's
    layout and keys: the hand is MANO (models/refine_r.batch_recover_mano on
    the stack's device) of the GT pose_repr plus, with sigma > 0, noise on
    its valid frames as GaussianPerturbSampleAdaptor draws it (sigma on the
    rot6d, re-normalised; sigma / 10 on the wrist). `closed_faces` maps the
    side id (0 = rh) to its faces. Returns `root`."""
    from ..models.refine_r import batch_recover_mano

    pose = np.stack([s["pose_repr"] for s in samples]).astype(np.float32)
    if sigma > 0.0:
        rng = np.random.default_rng(seed)
        for i, s in enumerate(samples):
            n = int(s["len"])
            pose[i, :n, :3] += rng.normal(scale=0.1 * sigma, size=(n, 3))
            pose[i, :n, 3:] += rng.normal(scale=sigma, size=(n, 96))
            pose[i, :n] = T.renormalize_pose_repr_rot6d(torch.from_numpy(pose[i, :n])).numpy()
    hs = np.array([0 if s["hand_side"] == "rh" else 1 for s in samples], np.int64)
    dev = mano_stack.v_template.device
    with torch.inference_mode():
        verts, joints, _ = batch_recover_mano(
            mano_stack, torch.from_numpy(pose).to(dev),
            torch.from_numpy(np.stack([s["shape"] for s in samples])).to(dev), torch.from_numpy(hs).to(dev))
    verts, joints = verts.cpu().numpy(), joints.cpu().numpy()
    for i, s in enumerate(samples):
        info = s["info"]
        d = {"process_key": info[0], "info": info, "hand_side": s["hand_side"], "joints": joints[i],
             "verts": verts[i], "faces": closed_faces[int(hs[i])], "obj_list": s["obj_list"], "len": s["len"],
             "frame_id": s["frame_id"], "refine_pose_repr": pose[i]}
        fp = os.path.join(root, str(info[0]).replace("/", "++"), str(info[1]), str(info[2]), "save_dict.pkl")
        os.makedirs(os.path.dirname(fp), exist_ok=True)
        with open(fp, "wb") as f:
            pickle.dump(d, f)
    return root
