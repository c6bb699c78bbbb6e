"""Per-sample caches of GT geometry (port of oakink2_tamf_tpu/data/target_cache.py).

- `TargetH2OCache` attaches `target_h2o` [L, 778], the GT hand's h2o
  distances that R's loss compares against (reference
  segment_refine_model.py:219-248), so the R train step skips the target
  chamfer pass (models/refine_r.target_geometry).
- `GTGeomCache` attaches `gt_o2h` [nobj, L, P] and `gt_h2o` [nobj, L, 778],
  the GT side of G's extra loss (models/losses.extra_loss_gt_geometry).

Both wrap the BASE dataset (before the sample adaptors, so every adaptor
view shares one cache) and compute with the same geometry the train step
runs, on the device of the MANO tensors they are given (the run's device),
in batches over the same collate padding. Storage is one file per index
under `cache_dir`, or an in-memory dict. A `cache_dir` records a
fingerprint of the dataset and the shapes in meta.json and refuses to serve
a dataset or config it was not built for.

`TargetH2OCache` also certifies each value against the cluster route's
candidate overflow and recomputes overflowed samples on the exact route
before storing them (JAX target_cache.py:176-230): a persisted value must
be provably exact. As in the JAX package its own search takes the "auto"
backend, an exact route, so the certificate reads 0 there.

A cold miss (an index `precompute` did not cover) is computed inside the
loader's worker thread, on that thread's current CUDA stream; launchers
precompute before the loop.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Any

import numpy as np
import torch

from ..models.losses import extra_loss_gt_geometry
from ..models.refine_r import batch_recover_mano, multi_object_h2o_dist, multi_object_h2o_overflow

_logger = logging.getLogger(__name__)

_GEOM_KEYS = ("pose_repr", "shape", "hand_side", "obj_traj", "obj_points", "obj_mask", "mask")


class TargetH2OCache:
    _log_label = "target_h2o cache"

    def __init__(self, base, mano_stack, collate, *, batch_size: int = 16,
                 cache_dir: str | None = None):
        self.base = base
        self.mano_stack = mano_stack  # models/refine_r.stack_mano_models, on the run's device
        self.device = mano_stack.v_template.device
        self.collate = collate
        self.batch_size = int(batch_size)
        self.cache_dir = cache_dir
        self._mem: dict[int, Any] = {}
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            self._check_fingerprint()

    def _fingerprint(self) -> str:
        """Identity of (dataset, collate shapes, MANO): the pose, shape, hand
        side and object geometry of two probe indices (0 and len-1, which
        also catch same-length permutations) and the first template rows."""
        h = hashlib.md5()
        for idx in {0, len(self.base) - 1}:
            probe = self.base[idx]
            h.update(np.ascontiguousarray(probe["pose_repr"], np.float32).tobytes())
            h.update(np.ascontiguousarray(probe["shape"], np.float32).tobytes())
            h.update(str(probe.get("hand_side", "")).encode())
            h.update(np.ascontiguousarray(probe["obj_traj"], np.float32).tobytes())
            h.update(np.int64(probe.get("obj_num", 0)).tobytes())
            if "obj_pointcloud" in probe:
                h.update(np.ascontiguousarray(probe["obj_pointcloud"], np.float32).tobytes())
            elif "obj_verts" in probe:
                for v in probe["obj_verts"]:
                    h.update(np.ascontiguousarray(v, np.float32).tobytes())
        for leaf in (self.mano_stack.v_template, self.mano_stack.j_regressor):
            h.update(np.ascontiguousarray(leaf.cpu().numpy(), np.float32)[:8].tobytes())
        key = {
            "n": len(self.base),
            "max_nobj": int(self.collate.max_nobj),
            "n_obj_points": int(self.collate.n_obj_points),
            "probe_md5": h.hexdigest(),
        }
        return json.dumps(key, sort_keys=True)

    def _check_fingerprint(self) -> None:
        fp = self._fingerprint()
        meta = os.path.join(self.cache_dir, "meta.json")
        if os.path.isfile(meta):
            with open(meta) as f:
                if f.read() != fp:
                    raise ValueError(
                        f"{self._log_label} {self.cache_dir} was built for a different "
                        "dataset or config (meta.json mismatch): point at a fresh dir or "
                        "delete the stale cache"
                    )
        else:
            tmp = f"{meta}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(fp)
            os.replace(tmp, meta)

    # -- dataset protocol ---------------------------------------------------

    def __len__(self) -> int:
        return len(self.base)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def _get(self, index: int, data: dict[str, Any]):
        got = self._load(index)
        if got is None:  # cold miss: compute this one
            got = self._compute(self.collate([data]))[0]
            self._store(index, got)
        return got

    def __getitem__(self, index: int) -> dict[str, Any]:
        data = self.base[index]
        data["target_h2o"] = self._get(int(index), data)
        return data

    # -- storage --------------------------------------------------------------

    def _path(self, index: int) -> str:
        return os.path.join(self.cache_dir, f"{index:08d}.npy")

    def _load(self, index: int):
        if self.cache_dir:
            p = self._path(index)
            return np.load(p) if os.path.isfile(p) else None
        return self._mem.get(index)

    def _store(self, index: int, val) -> None:
        if self.cache_dir:
            # writer-unique temp, then an atomic rename for concurrent readers
            tmp = self._path(index) + f".{os.getpid()}.tmp.npy"
            np.save(tmp, val)
            os.replace(tmp, self._path(index))
        else:
            self._mem[index] = val

    def _has(self, index: int) -> bool:
        return os.path.isfile(self._path(index)) if self.cache_dir else index in self._mem

    # -- compute --------------------------------------------------------------

    def _device_batch(self, batch: dict[str, Any]) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(batch[k])).to(self.device) for k in _GEOM_KEYS}

    @torch.no_grad()
    def _compute(self, batch: dict[str, Any]) -> list:
        """Per-sample values of a collated batch: target_h2o [L, 778] each,
        from the train step's geometry (no frame mask: every frame is
        searched). Samples whose cluster certificate overflows are
        recomputed on the exact route."""
        b = self._device_batch(batch)
        verts, _, _ = batch_recover_mano(self.mano_stack, b["pose_repr"], b["shape"], b["hand_side"])
        geom = (verts, b["obj_traj"], b["obj_points"], b["obj_mask"])
        perm = self.mano_stack.template_perm
        h2o = multi_object_h2o_dist(*geom, x_perm=perm)
        bad = multi_object_h2o_overflow(*geom, x_perm=perm) > 0
        if bool(bad.any()):
            _logger.warning(
                "target_h2o: cluster NN overflow on %d/%d segments; recomputing those with "
                "the exact all-pairs kernel", int(bad.sum()), bad.numel(),
            )
            exact = multi_object_h2o_dist(*(t[bad] for t in geom), x_perm=perm, backend="exact")
            h2o[bad] = exact
        return list(h2o.cpu().numpy().astype(np.float32))

    def precompute(self, *, force: bool = False) -> int:
        """One batched pass over the base dataset, skipping cached indices;
        returns the number of entries computed."""
        todo = [i for i in range(len(self.base)) if force or not self._has(i)]
        t0 = time.time()
        for lo in range(0, len(todo), self.batch_size):
            idx = todo[lo : lo + self.batch_size]
            for i, val in zip(idx, self._compute(self.collate([self.base[i] for i in idx]))):
                self._store(i, val)
        if todo:
            _logger.info("%s: %d segments precomputed in %.1fs (%s)", self._log_label, len(todo),
                         time.time() - t0, self.cache_dir or "in-memory")
        return len(todo)


class GTGeomCache(TargetH2OCache):
    """Per-sample cache of G's GT-side signed chamfer (`gt_o2h`, `gt_h2o`).

    Both directions are functions of the sample alone, yet the G train step
    would run the signed forward kernel over every GT row each step. Stored
    per index as an .npz of the real (unpadded) object rows only and padded
    back to max_nobj on read (~10.5 MB per segment at 2 objects, 160 frames
    and 8192 points). Fingerprint and storage contract: TargetH2OCache's."""

    _log_label = "gt_geom cache"

    def __getitem__(self, index: int) -> dict[str, Any]:
        data = self.base[index]
        got = self._get(int(index), data)
        o2h, h2o = got["o2h"], got["h2o"]
        pad = int(self.collate.max_nobj) - o2h.shape[0]
        if pad > 0:
            o2h = np.pad(o2h, ((0, pad), (0, 0), (0, 0)))
            h2o = np.pad(h2o, ((0, pad), (0, 0), (0, 0)))
        data["gt_o2h"] = o2h
        data["gt_h2o"] = h2o
        return data

    def _path(self, index: int) -> str:
        return os.path.join(self.cache_dir, f"{index:08d}.npz")

    def _load(self, index: int):
        if self.cache_dir:
            p = self._path(index)
            if not os.path.isfile(p):
                return None
            with np.load(p) as z:
                return {"o2h": z["o2h"], "h2o": z["h2o"]}
        return self._mem.get(index)

    def _store(self, index: int, val) -> None:
        if self.cache_dir:
            tmp = self._path(index) + f".{os.getpid()}.tmp.npz"
            np.savez(tmp, **val)
            os.replace(tmp, self._path(index))
        else:
            self._mem[index] = val

    @torch.no_grad()
    def _compute(self, batch: dict[str, Any]) -> list:
        gg = extra_loss_gt_geometry(self.mano_stack, self._device_batch(batch), with_chamfer=True)
        o2h = gg["o2h_g"].cpu().numpy().astype(np.float32)
        h2o = gg["h2o_g"].cpu().numpy().astype(np.float32)
        nums = np.asarray(batch["obj_num"], np.int64) if "obj_num" in batch else None
        out = []
        for k in range(o2h.shape[0]):
            n = o2h.shape[1] if nums is None else max(1, min(int(nums[k]), o2h.shape[1]))
            out.append({"o2h": o2h[k, :n], "h2o": h2o[k, :n]})
        return out
