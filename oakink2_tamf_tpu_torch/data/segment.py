"""Interaction-segment dataset, host-side numpy (port of
oakink2_tamf_tpu/data/segment.py; the reference's
dataset/interaction_segment.py).

- Loads the reference's `cache_dict` pickles (script/save_cache_dict.py:
  segment info/len/pose/tsl/shape/hand_side/text/obj_traj/frame_id and the
  object list, under `_CACHE_KEYS`), so an OakInk2-TaMF preprocessing run
  drops straight in.
- Raw OakInk2 extraction walks complex -> primitive tasks through a
  pluggable `toolkit` with oakink2_toolkit's interface
  (load_complex_task / load_primitive_task / load_affordance).
- Reverse-time augmentation (`append_reverse_segment`, ref :160-265).
- Object stores: embeddings (`<oid>.npy`, or `<oid>.pt` read with torch),
  point clouds (`<oid>.npz`, key "point"), and with `enable_obj_model` the
  toolkit's affordance meshes (`load_affordance(oid).obj_mesh`, with
  `.vertices` and `.faces`).
- __getitem__ emits pose_repr [L, 99], tslrot6d obj_traj [nobj, L, 9], mask,
  text, hand_side and the object ids: the reference's keys (ref :389-449).

The rotation codecs are the port's core/transforms, run on CPU tensors.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Any, Optional

import numpy as np
import torch

from ..core import transforms as T
from .slice import SegmentSlice

_logger = logging.getLogger(__name__)

FPS_MOCAP = 120.0
HAND_SIDE = ("lh", "rh")

_CACHE_KEYS = (
    "interaction_segment_info_list",
    "interaction_segment_len_list",
    "interaction_segment_pose_list",
    "interaction_segment_tsl_list",
    "interaction_segment_shape_list",
    "interaction_segment_hand_side_list",
    "interaction_segment_text_list",
    "interaction_segment_obj_traj_list",
    "interaction_segment_frame_id_list",
    "interaction_object_list",
)


def _np_codec(fn, a: np.ndarray) -> np.ndarray:
    return fn(torch.from_numpy(np.ascontiguousarray(a))).numpy()


def _rotmat_to_rot6d_np(a: np.ndarray) -> np.ndarray:
    return _np_codec(T.rotmat_to_rot6d, a)


def _transf_to_tslrot6d_np(a: np.ndarray) -> np.ndarray:
    return _np_codec(T.transf_to_tslrot6d, a)


def _quat_to_rotmat_np(a: np.ndarray) -> np.ndarray:
    return _np_codec(T.quat_to_rotmat, a)


class InteractionSegmentData:
    """Map-style dataset of interaction segments."""

    def __init__(
        self,
        process_range_list: Optional[list[str]] = None,
        data_prefix: Optional[str] = None,
        target_fps: float = 10.0,
        slice_min_len: int = 16,
        slice_max_len: int = 160,
        enable_obj_model: bool = False,
        obj_embedding_prefix: Optional[str] = None,
        obj_pointcloud_prefix: Optional[str] = None,
        cache_dict: Optional[dict] = None,
        cache_dict_filepath: Optional[str] = None,
        append_reverse_segment: bool = False,
        toolkit: Any = None,
    ):
        self.process_range_list = process_range_list or []
        self.data_prefix = data_prefix
        self.origin_fps = FPS_MOCAP
        self.target_fps = target_fps
        self.target_gap = int(self.origin_fps // self.target_fps)
        self.slice_min_len = slice_min_len
        self.slice_max_len = slice_max_len
        self.toolkit = toolkit

        if cache_dict is None and cache_dict_filepath is not None:
            with open(cache_dict_filepath, "rb") as f:
                cache_dict = pickle.load(f)

        if cache_dict is not None:
            # own lists: the reverse augmentation appends to them
            store = tuple(list(cache_dict[k]) for k in _CACHE_KEYS)
        elif toolkit is not None:
            store = self._load_from_toolkit()
        else:
            raise ValueError("need cache_dict(_filepath) or an oakink2 toolkit instance to load data")
        (
            self.info_list,
            self.len_list,
            self.pose_list,
            self.tsl_list,
            self.shape_list,
            self.hand_side_list,
            self.text_list,
            self.obj_traj_list,
            self.frame_id_list,
            self.object_list,
        ) = store

        if append_reverse_segment:
            self._append_reverse()
            _logger.info("load reverse segment")

        self.len = len(self.len_list)
        _logger.info("collect %d segments", self.len)

        self.enable_obj_model = enable_obj_model
        self.obj_store = None
        if enable_obj_model and toolkit is not None:
            self.obj_store = {oid: toolkit.load_affordance(oid).obj_mesh for oid in self.object_list}

        self.obj_embedding_store = None
        if obj_embedding_prefix is not None:
            self.obj_embedding_store = self._load_embeddings(obj_embedding_prefix)

        self.obj_pointcloud_store = None
        if obj_pointcloud_prefix is not None:
            self.obj_pointcloud_store = self._load_pointclouds(obj_pointcloud_prefix)

    # -- raw extraction ----------------------------------------------------

    def _load_from_toolkit(self):
        """Walk OakInk2 complex -> primitive tasks (ref :56-158)."""
        tk = self.toolkit
        info_l, len_l, pose_l, tsl_l, shape_l, hs_l, text_l, objtraj_l, fid_l = (
            [], [], [], [], [], [], [], [], [],
        )
        object_set: set[str] = set()

        def sl(a):
            return SegmentSlice.from_gap(a, self.target_gap, self.slice_max_len, self.slice_min_len)

        for process_key in self.process_range_list:
            complex_task = tk.load_complex_task(seq_key=process_key)
            primitives = tk.load_primitive_task(complex_task_data=complex_task)
            for prim_id, prim in zip(complex_task.exec_path, primitives):
                task_beg = prim.frame_range[0]
                for hand_side in HAND_SIDE:
                    if prim.hand_involved not in ("bh", hand_side):
                        continue
                    seg_beg, seg_end = prim[f"frame_range_{hand_side}"]
                    src_obj_list = prim[f"{hand_side}_obj_list"]
                    if len(src_obj_list) == 0:
                        continue
                    object_set.update(src_obj_list)

                    # object trajectories over the segment window
                    ob, oe = seg_beg - task_beg, seg_end - task_beg
                    obj_store = {oid: prim.obj_transf[oid][ob:oe].astype(np.float32) for oid in src_obj_list}
                    # MANO params (quat -> rotmat)
                    in_mask = prim[f"{hand_side}_in_range_mask"]
                    param = prim[f"{hand_side}_param"]
                    pose = np.asarray(param["pose_coeffs"])[in_mask]
                    tsl = np.asarray(param["tsl"])[in_mask]
                    shape = np.asarray(param["betas"])[in_mask]
                    pose = _quat_to_rotmat_np(pose.astype(np.float32))

                    pose_s, lens = sl(pose.astype(np.float32))
                    tsl_s, _ = sl(tsl.astype(np.float32))
                    shape_s, _ = sl(shape.astype(np.float32))
                    obj_s = {oid: sl(obj_store[oid])[0] for oid in src_obj_list}
                    fids, _ = sl(np.arange(seg_beg, seg_end))

                    for k in range(len(lens)):
                        info_l.append((process_key, prim_id, hand_side))
                        len_l.append(lens[k])
                        pose_l.append(pose_s[k])
                        tsl_l.append(tsl_s[k])
                        shape_l.append(shape_s[k])
                        hs_l.append(hand_side)
                        text_l.append(prim.task_desc)
                        objtraj_l.append({oid: obj_s[oid][k] for oid in src_obj_list})
                        fid_l.append(fids[k][: lens[k]].tolist())
        return (info_l, len_l, pose_l, tsl_l, shape_l, hs_l, text_l, objtraj_l, fid_l, sorted(object_set))

    # -- reverse augmentation ---------------------------------------------

    def _append_reverse(self):
        """Append each segment with its first `len` frames reversed (the
        padded tail stays), frame ids reversed too."""

        def rev_prefix(arr, n):
            out = arr.copy()
            out[:n] = arr[:n][::-1]
            return out

        for i in range(len(self.len_list)):
            n = self.len_list[i]
            self.info_list.append(self.info_list[i])
            self.len_list.append(n)
            self.pose_list.append(rev_prefix(self.pose_list[i], n))
            self.tsl_list.append(rev_prefix(self.tsl_list[i], n))
            self.shape_list.append(rev_prefix(self.shape_list[i], n))
            self.hand_side_list.append(self.hand_side_list[i])
            self.text_list.append(self.text_list[i])
            self.obj_traj_list.append({oid: rev_prefix(v, n) for oid, v in self.obj_traj_list[i].items()})
            self.frame_id_list.append(list(self.frame_id_list[i])[::-1])

    # -- stores ------------------------------------------------------------

    def _load_embeddings(self, prefix: str) -> dict[str, np.ndarray]:
        store = {}
        for oid in self.object_list:
            fp_npy = os.path.join(prefix, f"{oid}.npy")
            fp_pt = os.path.join(prefix, f"{oid}.pt")
            if os.path.isfile(fp_npy):
                store[oid] = np.load(fp_npy).astype(np.float32)
            elif os.path.isfile(fp_pt):
                store[oid] = torch.load(fp_pt, map_location="cpu").numpy().astype(np.float32)
            else:
                raise FileNotFoundError(f"no embedding for object {oid} under {prefix}")
        return store

    def _load_pointclouds(self, prefix: str) -> dict[str, np.ndarray]:
        store = {}
        for oid in self.object_list:
            with np.load(os.path.join(prefix, f"{oid}.npz")) as z:
                store[oid] = z["point"].astype(np.float32)
        return store

    # -- dataset protocol --------------------------------------------------

    def __len__(self) -> int:
        return self.len

    def __getitem__(self, index: int) -> dict[str, Any]:
        pose = self.pose_list[index]  # [L, 16, 3, 3]
        tsl = self.tsl_list[index]  # [L, 3]
        rot6d = _rotmat_to_rot6d_np(pose).reshape(pose.shape[0], 16 * 6)
        pose_repr = np.concatenate([tsl, rot6d], axis=-1).astype(np.float32)

        obj_traj_store = self.obj_traj_list[index]
        obj_list = sorted(obj_traj_store.keys())
        obj_traj = np.stack(
            [_transf_to_tslrot6d_np(obj_traj_store[oid]) for oid in obj_list], axis=0
        ).astype(np.float32)

        seg_len = int(self.len_list[index])
        mask = np.ones((self.slice_max_len,), np.float32)
        mask[seg_len:] = 0.0

        res: dict[str, Any] = {
            "info": self.info_list[index],
            "len": seg_len,
            "mask": mask,
            "pose_repr": pose_repr,
            "shape": self.shape_list[index].astype(np.float32),
            "hand_side": self.hand_side_list[index],
            "text": self.text_list[index],
            "obj_list": obj_list,
            "obj_num": len(obj_list),
            "obj_traj": obj_traj,
            "frame_id": self.frame_id_list[index],
        }
        if self.obj_store is not None:
            res["obj_verts"] = [np.array(self.obj_store[oid].vertices) for oid in obj_list]
            res["obj_faces"] = [np.array(self.obj_store[oid].faces) for oid in obj_list]
        if self.obj_embedding_store is not None:
            res["obj_embedding"] = np.stack([self.obj_embedding_store[oid] for oid in obj_list], axis=0)
        if self.obj_pointcloud_store is not None:
            res["obj_pointcloud"] = np.stack([self.obj_pointcloud_store[oid] for oid in obj_list], axis=0)
        return res

    # -- cache -------------------------------------------------------------

    def get_cache(self) -> dict[str, Any]:
        return dict(zip(_CACHE_KEYS, (
            self.info_list, self.len_list, self.pose_list, self.tsl_list, self.shape_list,
            self.hand_side_list, self.text_list, self.obj_traj_list, self.frame_id_list,
            self.object_list,
        )))

    def save_cache(self, filepath: str) -> None:
        with open(filepath, "wb") as f:
            pickle.dump(self.get_cache(), f)
