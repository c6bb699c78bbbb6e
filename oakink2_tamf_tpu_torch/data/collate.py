"""Static-shape batch collate (copy of oakink2_tamf_tpu/data/collate.py).

Numpy in, numpy out: the object axis pads to a fixed `max_nobj` with a bool
`obj_mask`, per-object clouds are resampled to `n_obj_points` and spatially
sorted into `obj_points` [bs, max_nobj, P, 3], hand_side becomes an int id
(0 = rh, 1 = lh), raw text stays a list.
"""

from __future__ import annotations

import hashlib
from typing import Any, Sequence

import numpy as np

from ..utils.pc_util import spatial_sort_indices

HAND_SIDE_MAP = {"rh": 0, "lh": 1}

DEFAULT_COLLATE_KEY = [
    "pose_repr", "pose_repr_lh", "pose_repr_rh", "shape", "shape_lh", "shape_rh",
    "len", "mask", "obj_num", "sample_pose_repr", "action_label_id", "action_onehot",
    "text_emb", "target_h2o", "gt_o2h", "gt_h2o",
]
NO_COLLATE_KEY = ["text", "obj_list", "info", "obj_faces", "sample_info", "frame_id", "action_label"]
PAD_OBJ_KEY = ["obj_traj", "obj_embedding", "obj_pointcloud", "obj_verts"]


def _pad_axis0(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] >= n:
        return a[:n]
    pad = np.zeros((n - a.shape[0], *a.shape[1:]), dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


class SegmentCollate:
    """Collate per-segment sample dicts to a static-shape numpy batch."""

    SORT_CACHE_MAX = 4096  # distinct canonical clouds kept (FIFO)

    def __init__(self, max_nobj: int = 4, n_obj_points: int = 2048):
        self.max_nobj = max_nobj
        self.n_obj_points = n_obj_points
        # content-keyed spatial-sort permutations: canonical clouds recur
        # every batch, the recursive median split costs ms per cloud
        self._sort_cache: dict[bytes, np.ndarray] = {}

    def _pad_points(self, point_list: Sequence[np.ndarray]) -> np.ndarray:
        """Ragged per-object clouds -> [nobj, n_points, 3], each spatially sorted."""
        n_points = self.n_obj_points
        out = []
        for p in point_list:
            p = np.asarray(p, dtype=np.float32)
            if p.shape[0] >= n_points:
                p = p[np.linspace(0, p.shape[0] - 1, n_points).astype(np.int64)]
            else:
                reps = int(np.ceil(n_points / max(p.shape[0], 1)))
                p = np.tile(p, (reps, 1))[:n_points]
            key = hashlib.md5(np.ascontiguousarray(p).tobytes()).digest()
            perm = self._sort_cache.get(key)
            if perm is None:
                perm = spatial_sort_indices(p)
                if len(self._sort_cache) >= self.SORT_CACHE_MAX:
                    self._sort_cache.pop(next(iter(self._sort_cache)))
                self._sort_cache[key] = perm
            out.append(p[perm])
        return np.stack(out, axis=0)

    def __call__(self, samples: Sequence[dict[str, Any]]) -> dict[str, Any]:
        keys = list(samples[0].keys())
        res: dict[str, Any] = {}
        for key in keys:
            vals = [s[key] for s in samples]
            if key == "hand_side":
                res[key] = np.asarray(
                    [HAND_SIDE_MAP[v] if isinstance(v, str) else int(v) for v in vals], np.int32
                )
            elif key in DEFAULT_COLLATE_KEY:
                res[key] = np.stack([np.asarray(v) for v in vals], axis=0)
            elif key in NO_COLLATE_KEY:
                res[key] = vals
            elif key in ("obj_pointcloud", "obj_verts"):
                # obj_pointcloud wins when both are present
                if key == "obj_verts" and "obj_pointcloud" in keys:
                    continue
                pts = [_pad_axis0(self._pad_points(v), self.max_nobj) for v in vals]
                res["obj_points"] = np.stack(pts, axis=0).astype(np.float32)
            elif key in PAD_OBJ_KEY:
                res[key] = np.stack(
                    [_pad_axis0(np.asarray(v, dtype=np.float32), self.max_nobj) for v in vals], axis=0
                )
            else:
                raise KeyError(f"unexpected key in batch: {key}")
        n_real = np.asarray([min(int(s["obj_num"]), self.max_nobj) for s in samples])
        res["obj_mask"] = np.arange(self.max_nobj)[None, :] < n_real[:, None]
        if "len" in res:
            res["len"] = res["len"].astype(np.int32)
        if "mask" in res:
            res["mask"] = res["mask"].astype(np.float32)
        return res


def interaction_segment_collate(samples, max_nobj: int = 4, n_obj_points: int = 2048):
    return SegmentCollate(max_nobj=max_nobj, n_obj_points=n_obj_points)(samples)
